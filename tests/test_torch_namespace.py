"""The port's API surface against the reference's: the top-level,
``nn``, ``nn.functional``, ``tensor``, ``metric``, ``fluid``,
``fluid.layers``, ``fluid.optimizer``, ``fluid.io``, ``regularizer``,
``jit``, ``inference``, ``contrib`` and ``contrib.layers`` names of ``paddle_tpu_torch`` against those of
``paddle_tpu``.

The names the port lacks are exactly the frozen lists below, each with
the ROADMAP queue A item that brings it; a later slice shrinks a list.
A name the port has and the reference lacks fails: the port adds no
feature.  The one exception is ``interop``, the module that carries
values across the package boundary for the tests.

The names are read in a fresh interpreter right after each package's
import: a submodule shows up on a package once anything imports it.  In
the fluid spaces and ``regularizer`` a module object is no name (both
packages' modules import ``numpy`` and their own submodules there), nor
in ``fluid.io``.
"""
import os

import numpy as np
import pytest

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn.functional as tF
import paddle_tpu_torch.tensor as ttensor

# the port's names outside the reference's surface, each with its reason
PORT_ONLY = {
    "top-level": {"interop": "carries values across the package boundary "
                             "(the tests' tool, not an API)"},
    "fluid": {"save_vars": "fluid.io's, exported at fluid since the static "
                           "book tier; the tests read it there",
              "load_vars": "as save_vars"},
    "fluid.io": {"atomic_write_bytes": "the archive writer save_vars "
                                       "uses (the reference keeps it in "
                                       "fluid/checkpoint.py, not ported)"},
}

# the reference's names the port lacks: name -> ROADMAP queue A item
# (0: none will, the name is the TPU's)
MISSING = {
    "top-level": {
        "TPUPlace": 0, "XPUPlace": 0,
        "CUDAPinnedPlace": 12,
        "DataParallel": 10, "distributed": 10, "parallel": 10,
        "compat": 12, "dataset": 12, "distribution": 12,
        "incubate": 12, "io": 12, "observability": 12, "onnx": 12,
        "profiler": 12, "reader": 12, "static": 12, "sysconfig": 12,
        "text": 12,
    },
    "nn": {},
    "nn.functional": {},
    "tensor": {},
    "metric": {},
    "fluid": {
        **{n: 0 for n in ("TPUPinnedPlace", "TPUPlace",
            "is_compiled_with_tpu",)},
        **{n: 9 for n in ("CheckpointManager",)},
        **{n: 10 for n in ("ParallelExecutor",)},
        **{n: 11 for n in ("Communicator", "CountFilterEntry", "DataFeedDesc",
            "DistributeTranspiler", "DistributeTranspilerConfig",
            "LargeScaleKV", "ProbabilityEntry", "memory_optimize",
            "release_memory",)},
        **{n: 12 for n in ("DataLoader", "Generator", "LayerHelperBase",
            "WeightedAverage", "cpu_places", "create_lod_tensor",
            "create_random_int_lodtensor", "cuda_pinned_places",
            "is_compiled_with_cuda", "load_op_library", "require_version",)},
    },
    "fluid.layers": {
        **{n: 12 for n in ("ConstantInitializer", "LayerHelper", "Variable",
            "XavierInitializer", "create_py_reader_by_data", "create_tensor",
            "double_buffer", "in_dygraph_mode",
            "py_reader", "read_file", "unique_name",)},
    },
    "fluid.optimizer": {},
    "fluid.io": {},
    "regularizer": {},
    "jit": {},
    "inference": {},
    # the rest of contrib (decoder, mixed precision, reader, utils, the
    # model statistics and the extended optimizers) and contrib.layers'
    # rnn_impl
    "contrib": {n: 12 for n in (
        "AutoMixedPrecisionLists", "BasicGRUUnit", "BasicLSTMUnit",
        "BeamSearchDecoder", "CustomOpLists", "HDFSClient", "InitState",
        "StateCell", "TrainingDecoder", "basic_gru",
        "basic_lstm", "cast_model_to_fp16", "cast_parameters_to_fp16",
        "check_finite_and_unscale", "compiled_memory_stats",
        "convert_dist_to_sparse_program", "decoder", "decorate",
        "distributed_batch_reader", "extend_optimizer",
        "extend_with_decoupled_weight_decay",
        "load_persistables_for_increment",
        "load_persistables_for_inference", "memory_usage",
        "memory_usage_calc", "mixed_precision", "model_stat",
        "multi_download", "multi_upload", "op_freq_statistic",
        "op_frequence", "optimizer", "reader", "summary",
        "update_loss_scaling", "utils")},
    "contrib.layers": {n: 12 for n in (
        "BasicGRUUnit", "BasicLSTMUnit", "basic_gru", "basic_lstm",
        "rnn_impl")},
}

_PROBE = """
import json, sys, types
if sys.argv[1] == "paddle_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
import importlib
root = importlib.import_module(sys.argv[1])
spaces = {"top-level": root}
for space in ("nn", "nn.functional", "tensor", "metric", "fluid",
              "fluid.layers", "fluid.optimizer", "fluid.io", "regularizer",
              "jit", "inference", "contrib", "contrib.layers"):
    spaces[space] = importlib.import_module(sys.argv[1] + "." + space)
no_modules = ("fluid", "fluid.layers", "fluid.optimizer", "fluid.io",
              "regularizer")
print(json.dumps({k: sorted(
    n for n in dir(m) if not n.startswith("_")
    and not (k in no_modules
             and isinstance(getattr(m, n), types.ModuleType)))
    for k, m in spaces.items()}))
"""


@pytest.fixture(scope="module")
def surfaces():
    """Each package's public names right after its import, each in a
    fresh interpreter: a submodule shows up on a package once anything
    imports it, so names read here would depend on the test order."""
    import json
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        r = subprocess.run([sys.executable, "-c", _PROBE, pkg], cwd=root,
                           capture_output=True, text=True, timeout=300,
                           check=True)
        out[pkg] = {k: set(v) for k, v in
                    json.loads(r.stdout.strip().splitlines()[-1]).items()}
    return out


SPACES = ("top-level", "nn", "nn.functional", "tensor", "metric", "fluid",
          "fluid.layers", "fluid.optimizer", "fluid.io", "regularizer", "jit",
          "inference", "contrib", "contrib.layers")


@pytest.mark.parametrize("space", SPACES)
def test_missing_names_are_the_frozen_list(space, surfaces):
    missing = surfaces["paddle_tpu"][space] \
        - surfaces["paddle_tpu_torch"][space]
    assert sorted(missing) == sorted(MISSING[space])


@pytest.mark.parametrize("space", SPACES)
def test_port_adds_no_name(space, surfaces):
    extra = surfaces["paddle_tpu_torch"][space] \
        - surfaces["paddle_tpu"][space]
    assert sorted(extra) == sorted(PORT_ONLY.get(space, {}))


def test_each_missing_name_names_an_item():
    for space, names in MISSING.items():
        for name, item in names.items():
            assert item in (0, 5, 6, 7, 8, 9, 10, 11, 12), (space, name)


def test_the_surface_the_slice_brings():
    """The names a 2.0 program starts from."""
    for name in ("Model", "grad", "to_tensor", "no_grad", "save", "load",
                 "enable_static", "disable_static", "Tensor", "summary",
                 "seed", "CPUPlace", "CUDAPlace", "ParamAttr",
                 "in_dynamic_mode", "set_default_dtype",
                 "get_default_dtype", "nn", "optimizer", "amp", "metric",
                 "vision", "models", "dygraph", "hapi", "tensor", "fluid"):
        assert hasattr(tpaddle, name), name
    assert tpaddle.nn.functional is tF
    assert hasattr(tpaddle.metric, "Accuracy")
    assert hasattr(tpaddle.optimizer, "Adam")
    assert tpaddle.add is ttensor.add


def test_platform_answers_are_the_ports_own():
    import torch
    assert tpaddle.is_compiled_with_cuda() == (torch.version.cuda
                                               is not None)
    assert tpaddle.get_cudnn_version() == torch.backends.cudnn.version()
    tpaddle.set_device("cpu")
    try:
        assert tpaddle.get_device() == "cpu"
        tpaddle.disable_static()
        assert tpaddle.in_dynamic_mode() and tpaddle.get_device() == "cpu"
        tpaddle.enable_static()
        assert not tpaddle.in_dynamic_mode()
    finally:
        from paddle_tpu_torch.fluid.framework import _set_expected_place
        _set_expected_place(None)
    with pytest.raises(ValueError):
        tpaddle.set_device("tpu")


def test_seed_repeats_the_dropout_masks():
    """After seed(n), two runs draw the same dropout masks."""
    import numpy as np
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dygraph import base as tdy

    def masks():
        with tdy.guard(fluid.CPUPlace()):
            tpaddle.seed(123)
            x = tdy.to_variable(np.ones((8, 64), "float32"))
            return [tF.dropout(x, 0.5).numpy() for _ in range(2)]

    a, b = masks(), masks()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], a[1])


def test_default_dtype_round_trip():
    assert tpaddle.get_default_dtype() == "float32"
    tpaddle.set_default_dtype("float64")
    try:
        assert tpaddle.get_default_dtype() == "float64"
    finally:
        tpaddle.set_default_dtype("float32")
    with pytest.raises(TypeError):
        tpaddle.set_default_dtype("int32")


# --- metric and fluid.metrics: the same numbers ------------------------------
def _metrics(metric, fmetrics):
    import numpy as np
    rng = np.random.RandomState(0)
    pred = rng.rand(40, 5).astype("float32")
    label = rng.randint(0, 5, (40, 1))
    scores = rng.rand(400)
    binary = rng.randint(0, 2, 400)
    acc = metric.Accuracy(topk=(1, 2))
    acc.update(acc.compute(pred, label))
    p, r, auc = metric.Precision(), metric.Recall(), metric.Auc()
    for m in (p, r, auc):
        m.update(scores, binary)
    fa, fauc = fmetrics.Accuracy(), fmetrics.Auc()
    fa.update(0.5, 10)
    fa.update(0.8, 30)
    fauc.update(np.stack([1 - scores, scores], 1), binary)
    fp, fr = fmetrics.Precision(), fmetrics.Recall()
    fp.update(scores, binary)
    fr.update(scores, binary)
    chunk = fmetrics.ChunkEvaluator()
    chunk.update(10, 12, 7)
    comp = fmetrics.CompositeMetric()
    comp.add_metric(fmetrics.Precision())
    comp.add_metric(fmetrics.Recall())
    comp.update(scores, binary)
    ed = fmetrics.EditDistance()
    ed.update(np.array([0.0, 2.0, 1.0]), 3)
    dm = fmetrics.DetectionMAP()
    dm.update(0.5, 2)
    dm.update(0.8, 1)
    return [acc.accumulate(), p.accumulate(), r.accumulate(),
            auc.accumulate(), fa.eval(), fauc.eval(), fp.eval(), fr.eval(),
            chunk.eval(), comp.eval(), ed.eval(), dm.eval(), acc.name()]


def test_metrics_match_reference():
    import paddle_tpu.fluid.metrics as jfm
    import paddle_tpu.metric as jm
    import paddle_tpu_torch.fluid.metrics as tfm
    import paddle_tpu_torch.metric as tm
    got, want = _metrics(tm, tfm), _metrics(jm, jfm)
    assert got[-1] == want[-1]
    np.testing.assert_allclose(
        np.hstack([np.ravel(v) for v in got[:-1]]).astype(float),
        np.hstack([np.ravel(v) for v in want[:-1]]).astype(float),
        rtol=1e-12)


def test_the_static_training_surface():
    """The names a Paddle 1.8 static training script reaches."""
    from paddle_tpu_torch import fluid
    for name in ("SGD", "Momentum", "LarsMomentum", "Adam", "AdamW",
                 "Adagrad", "RMSProp", "Lamb", "Ftrl", "Dpsgd", "Adamax",
                 "Adadelta", "DecayedAdagrad", "DGCMomentumOptimizer",
                 "ExponentialMovingAverage", "ModelAverage",
                 "RecomputeOptimizer", "GradientMergeOptimizer",
                 "LookaheadOptimizer", "PipelineOptimizer"):
        assert hasattr(fluid.optimizer, name), name
    for name in ("cond", "while_loop", "Switch", "case", "switch_case",
                 "IfElse", "StaticRNN", "create_array", "array_write",
                 "array_read", "array_length", "Print", "Assert",
                 "autoincreased_step_counter", "exponential_decay",
                 "natural_exp_decay", "inverse_time_decay",
                 "polynomial_decay", "piecewise_decay", "noam_decay",
                 "cosine_decay", "linear_lr_warmup"):
        assert hasattr(fluid.layers, name), name
    assert fluid.layers.control_flow.While is not None
    for name in ("DataFeeder", "ExecutionStrategy", "scope_guard",
                 "name_scope", "in_dygraph_mode", "gradients",
                 "cuda_places", "device_guard", "save_params",
                 "load_params", "embedding", "one_hot", "regularizer"):
        assert hasattr(fluid, name), name
    assert tpaddle.regularizer.L2Decay is fluid.regularizer.L2Decay


def test_the_dygraph_to_static_surface():
    """The names a 2.0 program deploys through, and the op types the
    slice registers: every op type the port registers is one of the
    reference's."""
    import paddle_tpu.ops as jops
    from paddle_tpu_torch.ops import all_ops
    assert tpaddle.jit.to_static is tpaddle.dygraph.declarative
    assert tpaddle.dygraph.TracedLayer is tpaddle.jit.TracedLayer
    for name in ("save", "load", "TranslatedLayer", "ProgramTranslator",
                 "not_to_static", "dy2static"):
        assert hasattr(tpaddle.jit, name), name
    for name in ("decorate", "rewrite_program_bf16", "CustomOpLists",
                 "AutoMixedPrecisionLists"):
        assert hasattr(tpaddle.amp, name), name
    ported = set(all_ops())
    assert {"run_program", "check_finite_and_unscale",
            "update_loss_scaling"} <= ported
    assert ported <= set(jops.builtin_ops())


def test_the_image_layers_surface():
    """The names the image layers bring (ROADMAP item 5's image half):
    the ``nn`` classes, the ``fluid.layers`` builders, the three ``fluid``
    names and the ``dygraph`` classes; their op types are registered."""
    from paddle_tpu_torch import dygraph, fluid
    from paddle_tpu_torch.ops import all_ops
    for name in ("AdaptiveAvgPool1D", "AdaptiveAvgPool3D",
                 "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
                 "AdaptiveMaxPool3D", "AlphaDropout", "AvgPool1D",
                 "AvgPool3D", "BCEWithLogitsLoss", "BatchNorm1D",
                 "BatchNorm3D", "Bilinear", "BilinearTensorProduct",
                 "Conv1D", "Conv1DTranspose", "Conv2DTranspose", "Conv3D",
                 "Conv3DTranspose", "CosineSimilarity", "Dropout2D",
                 "Dropout3D", "GroupNorm", "InstanceNorm1D",
                 "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
                 "LogSoftmax", "MarginRankingLoss", "MaxPool1D",
                 "MaxPool3D", "Maxout", "PRelu", "Pad1D", "Pad2D", "Pad3D",
                 "PairwiseDistance", "PixelShuffle", "RNNCellBase",
                 "SpectralNorm", "SyncBatchNorm", "ThresholdedReLU",
                 "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D"):
        assert hasattr(tpaddle.nn, name), name
    for name in ("affine_grid", "bilinear_tensor_product", "bpr_loss",
                 "brelu", "conv2d_transpose", "conv3d", "conv3d_transpose",
                 "cross_entropy", "grid_sampler", "group_norm",
                 "image_resize", "image_resize_short", "inplace_abn",
                 "instance_norm", "margin_rank_loss", "pad2d",
                 "pixel_shuffle", "pool3d", "prelu", "rank_loss", "relu_",
                 "resize_bilinear", "resize_linear", "resize_nearest",
                 "resize_trilinear", "sigmoid_focal_loss", "smooth_l1",
                 "soft_relu", "spectral_norm",
                 "teacher_student_sigmoid_loss", "unfold"):
        assert hasattr(fluid.layers, name), name
    for name in ("MSRA", "WeightNormParamAttr", "set_global_initializer"):
        assert hasattr(fluid, name), name
    for name in ("PRelu", "Conv2DTranspose", "Conv3D", "Conv3DTranspose",
                 "InstanceNorm", "GroupNorm", "SpectralNorm",
                 "BilinearTensorProduct", "Flatten"):
        assert hasattr(dygraph, name), name
    assert {"conv2d_transpose", "conv3d", "conv3d_transpose",
            "sync_batch_norm", "instance_norm", "group_norm", "norm",
            "nearest_interp", "bilinear_interp", "bicubic_interp",
            "trilinear_interp", "grid_sampler", "affine_channel",
            "temporal_shift", "pad2d", "pad3d", "pixel_shuffle", "unfold",
            "bilinear_tensor_product", "pool3d", "spectral_norm",
            "teacher_student_sigmoid_loss", "dropout_nd",
            "max_pool2d_with_index", "cross_entropy", "smooth_l1_loss",
            "hinge_loss", "rank_loss", "margin_rank_loss", "bpr_loss",
            "affine_grid", "sigmoid_focal_loss", "brelu"} <= set(all_ops())
