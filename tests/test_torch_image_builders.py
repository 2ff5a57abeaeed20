"""The image layers' ``fluid.layers`` builders (ROADMAP queue A item 5's
image half) and the losses and other op types under them
(``test_torch_image_layers.MISC_OP_CASES``, checked as that file checks
its ops) in both packages; each builder in one static program from the
reference's startup (``test_torch_control_flow.run_both``): the output
and the gradients of its input and parameters (``fluid.gradients`` of
the sum of the output's sigmoid: a normalized output's plain sum has no
gradient but rounding) within rtol 1e-4 of each value's largest; and
``dygraph.BatchNorm`` called while a program is built.

Two of the reference's builders drop an argument its op takes:
``nn.functional.conv2d_transpose`` drops ``output_padding`` and
``fluid.layers.conv2d_transpose`` drops ``output_size``; the port passes
both (``test_transposed_conv_arguments_reach_the_op``).
"""
import numpy as np
import pytest

import jax

import paddle_tpu as jp
from paddle_tpu.dygraph import base as jdy

import paddle_tpu_torch as tp
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.dygraph import base as tdy

from test_torch_control_flow import run_both as run_static
from test_torch_image_layers import (A, FWD_RTOL, MISC_OP_CASES, _data, _r,
                                     check_op)
from test_torch_op_sweep import assert_close, run_both

jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("case", sorted(MISC_OP_CASES))
def test_misc_op_matches_reference(case):
    check_op(case, MISC_OP_CASES)


def test_transposed_conv_arguments_reach_the_op():
    """The reference's fault: ``nn.functional.conv2d_transpose`` drops
    ``output_padding`` and ``fluid.layers.conv2d_transpose`` drops
    ``output_size``, so at stride 2, padding 1 and a 3x3 kernel both give
    ``2·in - 1`` rows; the port's give ``2·in`` (the extra row on the
    high edge, equal to the reference's op with the attribute)."""
    x, w = _r(1, 4, 5, 5, seed=43), _r(4, 2, 3, 3, seed=44)
    jdy.enable_dygraph()
    try:
        ref = jp.nn.functional.conv2d_transpose(
            jdy.to_variable(x), jdy.to_variable(w), stride=2, padding=1,
            output_padding=1).numpy()
    finally:
        jdy.disable_dygraph()
    tdy.enable_dygraph(tfluid.CPUPlace())
    try:
        port = tp.nn.functional.conv2d_transpose(
            tdy.to_variable(x), tdy.to_variable(w), stride=2, padding=1,
            output_padding=1).numpy()
    finally:
        tdy.disable_dygraph()
    assert ref.shape == (1, 2, 9, 9) and port.shape == (1, 2, 10, 10)
    want, _ = run_both("conv2d_transpose", {"Input": x, "Filter": w},
                       {"strides": [2, 2], "paddings": [1, 1],
                        "output_padding": [1, 1]})
    assert_close(port, np.asarray(want["Output"][0]), FWD_RTOL, "op")

    def build(fluid):
        xv = fluid.data("x", [1, 4, 5, 5])
        return [fluid.layers.conv2d_transpose(
            xv, 2, output_size=[10, 10], filter_size=3, stride=2,
            padding=1)]
    ref, port, _ = run_static(build, {"x": x})
    assert ref[0][0].shape == (1, 2, 9, 9)
    assert np.asarray(port[0][0]).shape == (1, 2, 10, 10)


def _ints(*rows):
    return np.array(rows, "int64")


BUILDERS = {
    "conv2d_transpose": (lambda L, f, x: L.conv2d_transpose(
        x, 3, filter_size=3, stride=2, padding=1, act="relu"), ["img"]),
    "group_norm": (lambda L, f, x: L.group_norm(x, 2, act="relu"), ["img"]),
    "instance_norm": (lambda L, f, x: L.instance_norm(x), ["img"]),
    "pad2d": (lambda L, f, x: L.pad2d(x, [1, 2, 3, 1], mode="reflect"),
              ["img"]),
    "relu_": (lambda L, f, x: L.relu_(x), ["img"]),
    "unfold": (lambda L, f, x: L.unfold(x, [2, 3], 1, [1, 0, 1, 2]),
               ["img"]),
    "conv3d": (lambda L, f, x: L.conv3d(x, 3, 2, padding=1, act="tanh"),
               ["vol"]),
    "conv3d_transpose": (lambda L, f, x: L.conv3d_transpose(
        x, 2, filter_size=2, stride=2), ["vol"]),
    "pool3d": (lambda L, f, x: L.pool3d(x, 2, "avg", 2, 1), ["vol"]),
    "pool3d global": (lambda L, f, x: L.pool3d(x, global_pooling=True),
                      ["vol"]),
    "affine_grid": (lambda L, f, t: L.affine_grid(t, [2, 4, 3, 5]),
                    ["theta"]),
    "grid_sampler": (lambda L, f, x, g: L.grid_sampler(x, g),
                     ["img", "grid"]),
    "pixel_shuffle": (lambda L, f, x: L.pixel_shuffle(x, 3), ["img9"]),
    "image_resize": (lambda L, f, x: L.image_resize(x, [9, 5]), ["img"]),
    "resize_bilinear": (lambda L, f, x: L.resize_bilinear(
        x, scale=1.5, align_corners=False), ["img"]),
    "resize_nearest": (lambda L, f, x: L.resize_nearest(x, [3, 11]),
                       ["img"]),
    "resize_trilinear": (lambda L, f, x: L.resize_trilinear(
        x, scale=[2.0, 0.5, 1.5]), ["vol"]),
    "image_resize_short": (lambda L, f, x: L.image_resize_short(
        x, 9, resample="BICUBIC"), ["img"]),
    "resize_linear": (lambda L, f, x: L.resize_linear(x, [13]), ["seq"]),
    "prelu": (lambda L, f, x: L.prelu(x, "channel"), ["img"]),
    "soft_relu": (lambda L, f, x: L.soft_relu(x * 30.0, 20.0), ["img"]),
    "spectral_norm": (lambda L, f, w: L.spectral_norm(w, 1, 3), ["w35"]),
    "inplace_abn": (lambda L, f, x: L.inplace_abn(x, act="relu"), ["img"]),
    "bilinear_tensor_product": (lambda L, f, x, y: L.bilinear_tensor_product(
        x, y, 3, act="tanh"), ["vec", "vec2"]),
    "bpr_loss": (lambda L, f, x, i: L.bpr_loss(x, i), ["vec", "ids"]),
    "rank_loss": (lambda L, f, a, b, s: L.rank_loss(s, a, b),
                  ["col", "col2", "bin_col"]),
    "margin_rank_loss": (lambda L, f, a, b, s: L.margin_rank_loss(
        s, a, b, 0.3), ["col", "col2", "sign"]),
    "teacher_student_sigmoid_loss": (
        lambda L, f, x, y: L.teacher_student_sigmoid_loss(x, y),
        ["col", "ts_lbl"]),
    "cross_entropy": (lambda L, f, x, i: L.cross_entropy(L.softmax(x), i),
                      ["vec", "ids"]),
    "smooth_l1": (lambda L, f, x, y: L.smooth_l1(x, y, sigma=0.5),
                  ["vec", "bin"]),
    "sigmoid_focal_loss": (lambda L, f, x, i, n: L.sigmoid_focal_loss(
        x, i, n), ["vec", "ids", "fg"]),
    "brelu": (lambda L, f, x: L.brelu(x, t_min=-0.5, t_max=1.0), ["img"]),
}
B = dict(A, **{"theta": _r(2, 2, 3, seed=62),
          "grid": _r(2, 3, 5, 2, seed=63, lo=-1.2),
          "ids": _ints([1], [3], [0]), "fg": np.array([2], "int32"),
          "bin_col": (np.random.RandomState(64).rand(3, 1) > 0.5)
          .astype("float32"),
          "ts_lbl": np.array([[-0.4], [1.0], [0.0]], "float32")})


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_matches_reference(name):
    """The builder's output and the gradients of its first input and of
    each parameter (``fluid.gradients`` of the sum of the output's
    sigmoid: a normalized output's plain sum has no gradient but
    rounding), both packages from the reference's startup."""
    make, keys = BUILDERS[name]

    def build(fluid):
        ins = [_data(fluid, f"in{i}", B[k]) for i, k in enumerate(keys)]
        ins[0].stop_gradient = False
        out = make(fluid.layers, fluid, *ins)
        params = fluid.default_main_program().global_block() \
            .all_parameters()
        wrt = ([ins[0]] if B[keys[0]].dtype == np.float32 else []) + [
            p for p in params if p.trainable]
        score = fluid.layers.reduce_sum(fluid.layers.sigmoid(out))
        grads = fluid.gradients(score, wrt) \
            if wrt else []
        return [out] + [g for g in grads if g is not None]
    ref, port, _ = run_static(build, {f"in{i}": B[k]
                                      for i, k in enumerate(keys)})
    assert len(ref[0]) == len(port[0])
    for i, (w, g) in enumerate(zip(ref[0], port[0])):
        assert_close(np.asarray(g), np.asarray(w), FWD_RTOL, f"{name} [{i}]")


def test_dygraph_batch_norm_in_a_program():
    """``dygraph.BatchNorm``'s static branch: the moving statistics as
    persistables seeded from the buffers, written back by the op; Y,
    MeanOut and VarianceOut against the reference's."""
    def build(fluid):
        from importlib import import_module
        dy = import_module(fluid.__name__.rsplit(".", 1)[0] + ".dygraph")
        x = _data(fluid, "x", A["img"])
        bn = dy.BatchNorm(4, act="relu", momentum=0.7)
        y = bn(x)
        mean, var = bn._static_stats
        return [y, mean, var]
    ref, port, _ = run_static(build, {"x": A["img"]}, runs=2)
    for r, p in zip(ref, port):
        for i, (w, g) in enumerate(zip(r, p)):
            assert_close(np.asarray(g), np.asarray(w), FWD_RTOL, f"[{i}]")
