"""The port's 2.0 API surface against the reference's: the top-level,
``nn``, ``nn.functional``, ``tensor`` and ``metric`` names of
``paddle_tpu_torch`` against those of ``paddle_tpu``.

The names the port lacks are exactly the frozen lists below, each with
the ROADMAP queue A item that brings it; a later slice shrinks a list.
A name the port has and the reference lacks fails: the port adds no
feature.  The one exception is ``interop``, the module that carries
values across the package boundary for the tests.

The names are read in a fresh interpreter right after each package's
import: a submodule shows up on a package once anything imports it.
"""
import os

import numpy as np
import pytest

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn.functional as tF
import paddle_tpu_torch.tensor as ttensor

# the port's names outside the reference's surface, each with its reason
PORT_ONLY = {"interop": "carries values across the package boundary "
                        "(the tests' tool, not an API)"}

# the reference's names the port lacks: name -> ROADMAP queue A item
# (0: none will, the name is the TPU's)
MISSING = {
    "top-level": {
        "TPUPlace": 0, "XPUPlace": 0,
        "CUDAPinnedPlace": 12,
        "regularizer": 4,
        "jit": 5,
        "inference": 6,
        "DataParallel": 10, "distributed": 10, "parallel": 10,
        "compat": 12, "contrib": 12, "dataset": 12, "distribution": 12,
        "incubate": 12, "io": 12, "observability": 12, "onnx": 12,
        "profiler": 12, "reader": 12, "static": 12, "sysconfig": 12,
        "text": 12,
    },
    "nn": {
        **{n: 5 for n in (
            "AdaptiveAvgPool1D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
            "AdaptiveMaxPool2D", "AdaptiveMaxPool3D", "AlphaDropout",
            "AvgPool1D", "AvgPool3D", "BCEWithLogitsLoss", "BatchNorm1D",
            "BatchNorm3D", "Bilinear", "BilinearTensorProduct", "CTCLoss",
            "Conv1D", "Conv1DTranspose", "Conv2DTranspose", "Conv3D",
            "Conv3DTranspose", "CosineSimilarity", "Dropout2D",
            "Dropout3D", "GroupNorm", "HSigmoidLoss", "InstanceNorm1D",
            "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
            "LogSoftmax", "MarginRankingLoss", "MaxPool1D", "MaxPool3D",
            "Maxout", "PRelu", "Pad1D", "Pad2D", "Pad3D",
            "PairwiseDistance", "PixelShuffle", "RNNCellBase",
            "SpectralNorm", "SyncBatchNorm", "ThresholdedReLU", "Upsample",
            "UpsamplingBilinear2D", "UpsamplingNearest2D")},
        "RowConv": 7, "decode": 7,
    },
    "nn.functional": {},
    "tensor": {},
    "metric": {"auc": 8},
}


_PROBE = """
import json, sys, types
if sys.argv[1] == "paddle_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
import importlib
root = importlib.import_module(sys.argv[1])
spaces = {"top-level": root}
for space, sub in (("nn", "nn"), ("nn.functional", "nn.functional"),
                   ("tensor", "tensor"), ("metric", "metric")):
    spaces[space] = importlib.import_module(sys.argv[1] + "." + sub)
print(json.dumps({k: sorted(n for n in dir(m) if not n.startswith("_"))
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


SPACES = ("top-level", "nn", "nn.functional", "tensor", "metric")


@pytest.mark.parametrize("space", SPACES)
def test_missing_names_are_the_frozen_list(space, surfaces):
    missing = surfaces["paddle_tpu"][space] \
        - surfaces["paddle_tpu_torch"][space]
    assert sorted(missing) == sorted(MISSING[space])


@pytest.mark.parametrize("space", SPACES)
def test_port_adds_no_name(space, surfaces):
    extra = surfaces["paddle_tpu_torch"][space] \
        - surfaces["paddle_tpu"][space]
    assert sorted(extra) == (sorted(PORT_ONLY) if space == "top-level"
                             else [])


def test_each_missing_name_names_an_item():
    for space, names in MISSING.items():
        for name, item in names.items():
            assert item in (0, 4, 5, 6, 7, 8, 10, 12), (space, name)


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
