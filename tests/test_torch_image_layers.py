"""The image layers (ROADMAP queue A item 5's image half) in both
packages, op by op: the op types of transposed, 3-d and grouped
convolution, interpolation, padding, the norms, the sampling grids, the
3-d pools and the plain losses.  ``test_torch_image_builders.py`` holds
the ``fluid.layers`` builders over them, ``test_torch_image_classes.py``
the ``nn`` and ``dygraph`` classes and ``test_torch_cyclegan.py`` a
reduced CycleGAN (the reference's eager ops compile at each new shape,
so the four files run on four workers, each within a minute).

- Ops: forward within rtol 1e-4 of each output's largest value (the op
  sweep's ``assert_outputs_match``) and every input gradient through
  ``generic_grad`` within rtol 1e-3 (``check_generic_grad``; for the
  interpolations in the channel-first layout, whose channel-last twin
  is the same arithmetic transposed), on seeded numpy inputs at the
  cases the sweep's one spec per op type does not reach:
  ``conv2d_transpose``'s asymmetric, ``SAME``, ``output_size``, grouped
  and dilated cases, the three interpolation alignments in both layouts,
  reflection past the side.
- ``dropout_nd`` and the dropout layers are held to the dropout contract
  (ROADMAP ground rule 5), never compared across packages.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jp
from paddle_tpu.dygraph import base as jdy

import paddle_tpu_torch as tp
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.ops import registry as treg

from test_torch_control_flow import run_both as run_static
from test_torch_op_sweep import assert_close, assert_outputs_match, run_both
from test_torch_op_sweep_grad import check_generic_grad

jax.config.update("jax_platforms", "cpu")

FWD_RTOL = 1e-4


def _np(v):
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _r(*shape, seed=0, lo=None):
    rng = np.random.RandomState(seed)
    if lo is not None:
        return rng.uniform(lo, -lo, shape).astype("float32")
    return rng.randn(*shape).astype("float32")


# --- the op types at the cases the sweep does not reach ---------------------
X4 = _r(2, 4, 5, 6, seed=1)
X5 = _r(1, 4, 3, 5, 4, seed=2)
WT = _r(4, 3, 3, 3, seed=3)            # conv2d_transpose's [C_in, C_out, k]
OP_CASES = {
    "conv2d_transpose asymmetric": (
        "conv2d_transpose", {"Input": X4, "Filter": WT},
        {"strides": [2, 2], "paddings": [1, 0, 2, 1]}),
    "conv2d_transpose SAME": (
        "conv2d_transpose", {"Input": X4, "Filter": WT},
        {"strides": [2, 2], "padding_algorithm": "SAME"}),
    "conv2d_transpose SAME k < s": (
        "conv2d_transpose", {"Input": X4, "Filter": _r(4, 2, 2, 2, seed=4)},
        {"strides": [3, 3], "padding_algorithm": "SAME"}),
    "conv2d_transpose VALID": (
        "conv2d_transpose", {"Input": X4, "Filter": WT},
        {"strides": [2, 1], "paddings": [1, 1], "padding_algorithm": "VALID"}),
    "conv2d_transpose output_size": (
        "conv2d_transpose", {"Input": X4, "Filter": WT},
        {"strides": [2, 2], "paddings": [1, 1], "output_size": [10, 12]}),
    "conv2d_transpose output_padding": (
        "conv2d_transpose", {"Input": X4, "Filter": WT},
        {"strides": [2, 2], "paddings": [1, 1], "output_padding": [1, 1]}),
    "conv2d_transpose grouped": (
        "conv2d_transpose", {"Input": X4, "Filter": WT},
        {"strides": [2, 1], "paddings": [1, 1], "groups": 2}),
    "conv2d_transpose dilated": (
        "conv2d_transpose", {"Input": X4, "Filter": WT},
        {"strides": [1, 2], "paddings": [2, 1], "dilations": [2, 1]}),
    "conv3d SAME strided": (
        "conv3d", {"Input": X5, "Filter": _r(3, 4, 3, 2, 3, seed=5)},
        {"strides": [2, 1, 2], "padding_algorithm": "SAME"}),
    "conv3d six paddings, grouped, dilated": (
        "conv3d", {"Input": X5, "Filter": _r(6, 2, 2, 2, 2, seed=6)},
        {"paddings": [1, 0, 0, 2, 1, 1], "groups": 2,
         "dilations": [1, 2, 1]}),
    "conv3d_transpose strided, grouped": (
        "conv3d_transpose", {"Input": X5, "Filter": _r(4, 3, 2, 3, 2, seed=7)},
        {"strides": [2, 1, 2], "paddings": [1, 1, 0],
         "output_padding": [1, 0, 1], "groups": 2, "dilations": [1, 2, 1]}),
    "pad2d reflect": ("pad2d", {"X": X4},
                      {"paddings": [2, 1, 0, 3], "mode": "reflect"}),
    "pad2d reflect past the side": (
        "pad2d", {"X": X4}, {"paddings": [5, 9, 6, 1], "mode": "reflect"}),
    "pad2d edge NHWC": ("pad2d", {"X": X4},
                        {"paddings": [3, 0, 1, 7], "mode": "edge",
                         "data_format": "NHWC"}),
    "pad2d constant": ("pad2d", {"X": X4},
                       {"paddings": [1, 2, 3, 0], "pad_value": 0.5}),
    "pad3d reflect": ("pad3d", {"X": X5},
                      {"paddings": [1, 3, 0, 2, 2, 1], "mode": "reflect"}),
    "pad3d replicate NDHWC": ("pad3d", {"X": X5},
                              {"paddings": [2, 0, 1, 1, 0, 3],
                               "mode": "replicate",
                               "data_format": "NDHWC"}),
    "pad3d circular": ("pad3d", {"X": X5},
                       {"paddings": [4, 1, 2, 0, 1, 2], "mode": "circular"}),
    "pad3d constant": ("pad3d", {"X": X5},
                       {"paddings": [1, 0, 0, 1, 1, 1], "value": -2.0}),
    "grid_sampler outside the image": (
        "grid_sampler", {"X": X4, "Grid": _r(2, 3, 4, 2, seed=8, lo=-1.4)},
        {}),
    "sync_batch_norm training": (
        "sync_batch_norm", {"X": X4, "Scale": _r(4, seed=9),
                            "Bias": _r(4, seed=10), "Mean": _r(4, seed=11),
                            "Variance": np.abs(_r(4, seed=12)) + 0.5},
        {"momentum": 0.8}),
    "sync_batch_norm is_test": (
        "sync_batch_norm", {"X": X4, "Scale": _r(4, seed=9),
                            "Bias": _r(4, seed=10), "Mean": _r(4, seed=11),
                            "Variance": np.abs(_r(4, seed=12)) + 0.5},
        {"is_test": True}),
    "instance_norm N = 1, affine": (
        "instance_norm", {"X": X4[:1], "Scale": _r(4, seed=13),
                          "Bias": _r(4, seed=14)}, {"epsilon": 1e-3}),
    "instance_norm 5-d": ("instance_norm", {"X": X5}, {}),
    "group_norm affine": ("group_norm", {"X": X5, "Scale": _r(4, seed=15),
                                         "Bias": _r(4, seed=16)},
                          {"groups": 2}),
    "temporal_shift": ("temporal_shift", {"X": _r(6, 5, 2, 3, seed=17)},
                       {"seg_num": 3, "shift_ratio": 0.4}),
    "unfold asymmetric": ("unfold", {"X": X4},
                          {"kernel_sizes": [2, 3], "strides": [2, 1],
                           "paddings": [1, 0, 2, 2], "dilations": [1, 2]}),
    "pixel_shuffle": ("pixel_shuffle", {"X": _r(2, 9, 3, 2, seed=18)},
                      {"upscale_factor": 3}),
    "pool3d max padded": ("pool3d", {"X": X5},
                          {"pooling_type": "max", "ksize": [2, 3, 2],
                           "strides": [1, 2, 2], "paddings": [1, 1, 0]}),
    "pool3d avg padded": ("pool3d", {"X": X5},
                          {"pooling_type": "avg", "ksize": [3, 3, 3],
                           "strides": [2, 2, 1], "paddings": [1, 1, 1]}),
    "pool3d global": ("pool3d", {"X": X5},
                      {"pooling_type": "avg", "global_pooling": True}),
    "max_pool2d_with_index padded": (
        "max_pool2d_with_index", {"X": X4},
        {"ksize": [3, 2], "strides": [2, 2], "paddings": [1, 0]}),
    "spectral_norm dim 1, 3 iterations": (
        "spectral_norm", {"Weight": _r(3, 5, 2, 2, seed=19),
                          "U": _r(5, seed=20), "V": _r(12, seed=21)},
        {"dim": 1, "power_iters": 3}),
    "affine_grid": ("affine_grid", {"Theta": _r(2, 2, 3, seed=22)},
                    {"output_shape": [2, 3, 4, 7]}),
    "affine_channel": ("affine_channel",
                       {"X": X4, "Scale": _r(4, seed=23),
                        "Bias": _r(4, seed=24)}, {}),
    "bilinear_tensor_product no bias": (
        "bilinear_tensor_product", {"X": _r(3, 4, seed=25),
                                    "Y": _r(3, 5, seed=26),
                                    "Weight": _r(2, 4, 5, seed=27)}, {}),
    "cross_entropy soft": (
        "cross_entropy", {"X": np.random.RandomState(28).dirichlet(
            np.ones(5), 4).astype("float32"),
            "Label": np.random.RandomState(29).dirichlet(
                np.ones(5), 4).astype("float32")}, {"soft_label": True}),
    "cross_entropy ignore_index": (
        "cross_entropy", {"X": np.random.RandomState(30).dirichlet(
            np.ones(5), 4).astype("float32"),
            "Label": np.array([[1], [3], [0], [3]], "int64")},
        {"ignore_index": 3}),
    "smooth_l1_loss weighted": (
        "smooth_l1_loss", {"X": _r(3, 4, seed=31), "Y": _r(3, 4, seed=32),
                           "InsideWeight": np.abs(_r(3, 4, seed=33)),
                           "OutsideWeight": np.abs(_r(3, 4, seed=34))},
        {"sigma": 2.0}),
    "margin_rank_loss": (
        "margin_rank_loss", {"X1": _r(5, 1, seed=35), "X2": _r(5, 1, seed=36),
                             "Label": np.sign(_r(5, 1, seed=37))},
        {"margin": 0.3}),
    "bpr_loss": ("bpr_loss", {"X": _r(4, 5, seed=38),
                              "Label": np.array([[0], [4], [2], [2]],
                                                "int64")}, {}),
    "teacher_student_sigmoid_loss": (
        "teacher_student_sigmoid_loss",
        {"X": _r(6, 1, seed=39),
         "Label": np.array([[-0.5], [1.0], [0.0], [-3.0], [-1.7], [1.0]],
                           "float32")}, {}),
    "sigmoid_focal_loss": (
        "sigmoid_focal_loss", {"X": _r(5, 3, seed=40),
                               "Label": np.array([[0], [2], [-1], [3], [1]],
                                                 "int64"),
                               "FgNum": np.array([3], "int32")},
        {"gamma": 1.5, "alpha": 0.4}),
    "brelu": ("brelu", {"X": _r(3, 4, seed=41) * 3},
              {"t_min": -1.0, "t_max": 2.5}),
}
for _method in ("nearest", "bilinear", "bicubic"):
    for _corners in (False, True):
        for _mode in ((0, 1) if _method == "bilinear" and not _corners
                      else (1,)):
            for _layout in ("NCHW", "NHWC"):
                _x = X4 if _layout == "NCHW" else X4.transpose(0, 2, 3, 1)
                OP_CASES[f"{_method}_interp corners={_corners} "
                         f"align_mode={_mode} {_layout}"] = (
                    f"{_method}_interp", {"X": _x},
                    {"out_h": 7, "out_w": 4, "align_corners": _corners,
                     "align_mode": _mode, "data_layout": _layout})
for _corners, _mode in ((False, 0), (False, 1), (True, 1)):
    for _layout in ("NCDHW", "NDHWC"):
        _x = X5 if _layout == "NCDHW" else X5.transpose(0, 2, 3, 4, 1)
        OP_CASES[f"trilinear_interp corners={_corners} align_mode={_mode} "
                 f"{_layout}"] = (
            "trilinear_interp", {"X": _x},
            {"out_d": 5, "out_h": 2, "out_w": 6, "align_corners": _corners,
             "align_mode": _mode, "data_layout": _layout})
OP_CASES["bilinear_interp scale"] = ("bilinear_interp", {"X": X4},
                                     {"scale": [1.5, 0.5]})


# the losses and the rest run in test_torch_image_builders.py (a worker of
# their own)
MISC_OP_CASES = {k: OP_CASES.pop(k) for k in [
    k for k in OP_CASES if OP_CASES[k][0] in (
        "temporal_shift", "unfold", "pixel_shuffle", "max_pool2d_with_index",
        "spectral_norm", "affine_grid", "affine_channel",
        "bilinear_tensor_product", "cross_entropy", "smooth_l1_loss",
        "margin_rank_loss", "bpr_loss", "teacher_student_sigmoid_loss",
        "sigmoid_focal_loss", "brelu")]}


def check_op(case, cases):
    op, ins, attrs = cases[case]
    ref, port = run_both(op, ins, attrs)
    assert_outputs_match(ref, port, FWD_RTOL, case)
    if treg.get_op(op).differentiable and "HWC" not in case:
        check_generic_grad(op, ins, attrs)


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    check_op(case, OP_CASES)


def test_reflect_past_the_side_is_the_references():
    """torch's ``F.pad`` refuses a reflection as wide as the side; the
    reference's ``jnp.pad`` reflects again, and so does the port."""
    x = torch.from_numpy(X4)
    with pytest.raises(RuntimeError):
        torch.nn.functional.pad(x, (0, 0, 5, 0), mode="reflect")
    ref, port = run_both("pad2d", {"X": X4},
                         {"paddings": [5, 0, 0, 6], "mode": "reflect"})
    assert port["Out"][0].shape == (2, 4, 10, 12)
    assert_outputs_match(ref, port, 0.0, "pad2d reflect at the side")


def _dropout_nd(x, attrs, seed=0, is_test=False):
    ctx = treg.LoweringContext(base_seed=seed, is_test=is_test)
    return treg.get_op("dropout_nd").fn({"X": [torch.from_numpy(x)]},
                                        dict(attrs), ctx)


def test_dropout_nd_contract():
    """Ground rule 5: whole channels under ``axis=[0, 1]``, the kept
    fraction within 6 sigma of 1 - p, ``Out = X · Mask / (1 - p)``, one
    seed one mask, another seed another, ``is_test`` and rate 0 the
    identity."""
    x = _r(64, 32, 3, 3, seed=42) + 3.0
    attrs = {"dropout_prob": 0.3, "axis": [0, 1], "op_seed": 7}
    out = _dropout_nd(x, attrs)
    o, m = out["Out"][0].numpy(), out["Mask"][0].numpy()
    per = m.reshape(64, 32, -1)
    assert (per == per[..., :1]).all()
    kept = per[..., 0].mean()
    assert abs(kept - 0.7) < 6 * np.sqrt(0.21 / per[..., 0].size)
    np.testing.assert_allclose(o, x * m / np.float32(0.7), rtol=1e-6)
    again = _dropout_nd(x, attrs)["Mask"][0].numpy()
    other = _dropout_nd(x, dict(attrs, op_seed=8))["Mask"][0].numpy()
    assert np.array_equal(again, m) and not np.array_equal(other, m)
    for kw in ({"is_test": True}, {}):
        a = dict(attrs, dropout_prob=0.0) if not kw else attrs
        np.testing.assert_array_equal(
            _dropout_nd(x, a, **kw)["Out"][0].numpy(), x)


def test_dropout_layers_contract():
    """``Dropout2D``, ``Dropout3D`` and ``AlphaDropout``: the identity in
    eval; in training whole channels dropped (2-d, 3-d) at about p, and
    alpha dropout keeping the mean and spread (to 0.05)."""
    tdy.enable_dygraph(tfluid.CPUPlace())
    try:
        ones4 = tdy.to_variable(np.ones((16, 32, 2, 2), "float32"))
        ones5 = tdy.to_variable(np.ones((8, 32, 2, 2, 2), "float32"))
        sel = tdy.to_variable(_r(256, 256, seed=61))
        layers = ((tp.nn.Dropout2D(0.5), ones4), (tp.nn.Dropout3D(0.5), ones5),
                  (tp.nn.AlphaDropout(0.2), sel))
        for layer, x in layers[:2]:
            out = layer(x).numpy().reshape(x.shape[0], x.shape[1], -1)
            assert (out == out[..., :1]).all()
            assert set(np.unique(out)) <= {0.0, 2.0}
            assert 0.35 < (out[..., 0] == 0).mean() < 0.65
        out = layers[2][0](sel).numpy()
        assert abs(out.mean() - sel.numpy().mean()) < 0.05
        assert abs(out.std() - sel.numpy().std()) < 0.05
        for layer, x in layers:     # eval() turns the tracer's training off
            layer.eval()
            np.testing.assert_array_equal(layer(x).numpy(), x.numpy())
        assert issubclass(tp.nn.LSTMCell, tp.nn.RNNCellBase)
    finally:
        tdy.disable_dygraph()


# --- inputs of the class and builder cases -----------------------------------
A = {
    "seq": _r(2, 4, 8, seed=50), "img": _r(2, 4, 6, 8, seed=51),
    "vol": _r(2, 4, 4, 6, 4, seed=52), "vec": _r(3, 4, seed=53),
    "vec2": _r(3, 5, seed=54), "col": _r(3, 1, seed=55),
    "col2": _r(3, 1, seed=56), "sign": np.sign(_r(3, 1, seed=57)),
    "bin": (np.random.RandomState(58).rand(3, 4) > 0.5).astype("float32"),
    "w35": _r(3, 5, seed=59), "img9": _r(2, 9, 3, 4, seed=60),
}


def _data(fluid, name, arr):
    return fluid.data(name, list(arr.shape), dtype=str(arr.dtype))
