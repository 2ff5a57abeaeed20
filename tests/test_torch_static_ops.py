"""The static book tier's ops: paddle_tpu_torch against paddle_tpu, op by op.

``conv2d``, ``pool2d``, ``batch_norm``, ``top_k``, ``accuracy``,
``flatten2``, ``mse_loss``, ``sgd``, the elementwise ops, ``sqrt``,
``square``, ``clip`` and ``clip_by_norm`` run the same numpy inputs (made
from a seed) through the JAX lowering on the CPU and through the port's on
CPU tensors, forward and through ``generic_grad`` (``jax.vjp`` against
``torch.func.vjp`` over the same lowering).  Then the masked answers under
shape bucketing: a context with 5 valid rows padded to 8 in both
packages.

Tolerance: float32 results rtol=atol=1e-5 (the two libraries sum in
different orders, nothing more); ids, counts and masks exactly.  The
max-pool gradient is held on inputs without ties (``lax.reduce_window``
and ``F.max_pool2d`` may route a tied window's gradient to different
elements), the forward also on a tied window.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu  # noqa: F401 — registers the reference lowerings
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid  # noqa: F401 — registers generic_grad
from paddle_tpu_torch.ops import registry as treg

TOL = dict(rtol=1e-5, atol=1e-5)
R = np.random.RandomState(23)


def _f(*shape):
    return np.asarray(R.randn(*shape), "float32")


def _ctx(pkg, valid=None, padded=None, batch_major=None):
    """A lowering context; under bucketing the reference's true row count
    is a traced int32 array (as its executor passes it), the port's a
    host int."""
    ctx = pkg.LoweringContext()
    if valid is not None and pkg is jreg:
        valid = jnp.asarray(valid, jnp.int32)
    ctx.batch_valid, ctx.batch_padded = valid, padded
    ctx.cur_op_batch_major = batch_major
    return ctx


def _run_both(op_type, ins, attrs, bucket=None):
    """The op in both packages: {slot: [(jax, torch), ...]}."""
    j_ins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    t_ins = {s: [torch.from_numpy(np.array(a)) for a in v]
             for s, v in ins.items()}
    bucket = bucket or {}
    j_out = jreg.get_op(op_type).fn(j_ins, dict(attrs),
                                    _ctx(jreg, **bucket))
    t_out = treg.get_op(op_type).fn(t_ins, dict(attrs),
                                    _ctx(treg, **bucket))
    assert set(j_out) == set(t_out), op_type
    return {s: list(zip(j_out[s], t_out[s])) for s in j_out}


def _check(op_type, ins, attrs, bucket=None, skip=()):
    for slot, pairs in _run_both(op_type, ins, attrs, bucket).items():
        if slot in skip:
            continue
        for j, t in pairs:
            j, t = np.asarray(j), t.numpy()
            assert j.shape == t.shape, (op_type, slot, j.shape, t.shape)
            if not np.issubdtype(j.dtype, np.floating):
                assert np.array_equal(t.astype(np.int64),
                                      j.astype(np.int64)), f"{op_type}.{slot}"
                continue
            np.testing.assert_allclose(t.astype(np.float64),
                                       j.astype(np.float64), **TOL,
                                       err_msg=f"{op_type}.{slot}")


def _grad_ins(op_type, ins, attrs, bucket=None):
    """generic_grad's inputs: the forward inputs and one seeded cotangent
    for each float output the reference differentiates."""
    jdef = jreg.get_op(op_type)
    outs = jdef.fn({s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
                   dict(attrs), _ctx(jreg, **(bucket or {})))
    g = {"I_" + s: v for s, v in ins.items()}
    for s, vals in outs.items():
        if s in jdef.nondiff_outputs:
            continue
        if all(np.issubdtype(np.asarray(o).dtype, np.floating)
               for o in vals):
            g["G_" + s] = [_f(*np.shape(o)) for o in vals]
    return g


def _check_grad(op_type, ins, attrs, grad_slots, bucket=None):
    g_ins = _grad_ins(op_type, ins, attrs, bucket)
    _check("generic_grad", g_ins,
           {"fwd_type": op_type, "fwd_attrs": dict(attrs),
            "in_slots": list(ins), "grad_slots": list(grad_slots)},
           bucket)


def _conv(x, w, **attrs):
    return ("conv2d", {"Input": [x], "Filter": [w]}, attrs,
            ("Input", "Filter"))


def _pool(x, **attrs):
    return ("pool2d", {"X": [x]}, attrs, ("X",))


def _bn_ins(x, c):
    return {"X": [x], "Scale": [1 + 0.1 * _f(c)], "Bias": [0.1 * _f(c)],
            "Mean": [0.1 * _f(c)], "Variance": [np.abs(_f(c)) + 0.5]}


def _pred_ids(n, c, k):
    return np.argsort(-_f(n, c), axis=-1)[:, :k].astype("int64")


CASES = {
    # conv2d: stride, dilation, 2- and 4-element padding, SAME at stride
    # 2, VALID, groups 2, NHWC
    "conv2d_stride2": _conv(_f(2, 3, 9, 9), _f(4, 3, 3, 3),
                            strides=[2, 2], paddings=[1, 1]),
    "conv2d_dilation2": _conv(_f(2, 3, 9, 9), _f(4, 3, 3, 3),
                              dilations=[2, 2], paddings=[2, 2]),
    "conv2d_pad2": _conv(_f(2, 3, 8, 7), _f(4, 3, 3, 2), paddings=[1, 2]),
    "conv2d_pad4": _conv(_f(2, 3, 9, 9), _f(4, 3, 3, 3),
                         paddings=[1, 0, 2, 1]),
    "conv2d_same_stride2": _conv(_f(2, 3, 10, 9), _f(4, 3, 4, 3),
                                 strides=[2, 2],
                                 padding_algorithm="SAME"),
    "conv2d_valid": _conv(_f(2, 3, 9, 9), _f(4, 3, 3, 3), paddings=[3, 3],
                          padding_algorithm="VALID"),
    "conv2d_groups2": _conv(_f(2, 4, 8, 8), _f(6, 2, 3, 3), groups=2,
                            paddings=[1, 1]),
    "conv2d_nhwc": _conv(_f(2, 9, 9, 3), _f(4, 3, 3, 3), paddings=[1, 1],
                         data_format="NHWC"),
    # pool2d: max and avg, exclusive with and without padding, SAME,
    # global, NHWC
    "pool2d_max": _pool(_f(2, 3, 8, 8), ksize=[2, 2], strides=[2, 2],
                        pooling_type="max"),
    "pool2d_max_pad": _pool(_f(2, 3, 8, 8), ksize=[3, 3], strides=[2, 2],
                            paddings=[1, 1], pooling_type="max"),
    "pool2d_max_same": _pool(_f(2, 3, 9, 9), ksize=[3, 3], strides=[2, 2],
                             padding_algorithm="SAME", pooling_type="max"),
    "pool2d_avg": _pool(_f(2, 3, 8, 8), ksize=[2, 2], strides=[2, 2],
                        pooling_type="avg"),
    "pool2d_avg_exclusive_pad": _pool(_f(2, 3, 8, 8), ksize=[3, 3],
                                      strides=[2, 2], paddings=[1, 1],
                                      pooling_type="avg", exclusive=True),
    "pool2d_avg_inclusive_pad": _pool(_f(2, 3, 8, 8), ksize=[3, 3],
                                      strides=[2, 2], paddings=[1, 1],
                                      pooling_type="avg", exclusive=False),
    "pool2d_avg_pad4": _pool(_f(2, 3, 8, 8), ksize=[2, 3], strides=[2, 2],
                             paddings=[1, 0, 0, 1], pooling_type="avg"),
    "pool2d_avg_same": _pool(_f(2, 3, 9, 9), ksize=[3, 3], strides=[2, 2],
                             padding_algorithm="SAME", pooling_type="avg"),
    "pool2d_global_max": _pool(_f(2, 3, 5, 5), ksize=[1, 1],
                               global_pooling=True, pooling_type="max"),
    "pool2d_global_avg": _pool(_f(2, 3, 5, 5), ksize=[1, 1],
                               global_pooling=True, pooling_type="avg"),
    "pool2d_nhwc_max": _pool(_f(2, 8, 8, 3), ksize=[2, 2], strides=[2, 2],
                             pooling_type="max", data_format="NHWC"),
    "pool2d_nhwc_avg_pad": _pool(_f(2, 8, 8, 3), ksize=[3, 3],
                                 strides=[2, 2], paddings=[1, 1],
                                 pooling_type="avg", data_format="NHWC"),
    # batch_norm: train and is_test, NCHW and NHWC, every output
    "batch_norm_train_nchw": ("batch_norm", _bn_ins(_f(4, 3, 5, 5), 3),
                              {"momentum": 0.9, "epsilon": 1e-5},
                              ("X", "Scale", "Bias")),
    "batch_norm_train_nhwc": ("batch_norm", _bn_ins(_f(4, 5, 5, 3), 3),
                              {"momentum": 0.5, "data_layout": "NHWC"},
                              ("X", "Scale", "Bias")),
    "batch_norm_train_2d": ("batch_norm", _bn_ins(3 + _f(8, 6), 6),
                            {"momentum": 0.9}, ("X", "Scale", "Bias")),
    "batch_norm_test_nchw": ("batch_norm", _bn_ins(_f(4, 3, 5, 5), 3),
                             {"is_test": True}, ("X", "Scale", "Bias")),
    "batch_norm_test_nhwc": ("batch_norm", _bn_ins(_f(4, 5, 5, 3), 3),
                             {"use_global_stats": True,
                              "data_layout": "NHWC"},
                             ("X", "Scale", "Bias")),
    # the rest of the tier
    "top_k": ("top_k", {"X": [_f(5, 7)]}, {"k": 3}, ("X",)),
    "flatten2_axis1": ("flatten2", {"X": [_f(2, 3, 4, 5)]}, {"axis": 1},
                       ("X",)),
    "flatten2_axis2": ("flatten2", {"X": [_f(2, 3, 4, 5)]}, {"axis": 2},
                       ("X",)),
    "flatten_axis0": ("flatten", {"X": [_f(2, 3, 4)]}, {"axis": 0},
                      ("X",)),
    "mse_loss": ("mse_loss", {"Input": [_f(6, 1)], "Label": [_f(6, 1)]}, {},
                 ("Input",)),
    "elementwise_sub": ("elementwise_sub", {"X": [_f(3, 4)], "Y": [_f(4)]},
                        {"axis": -1}, ("X", "Y")),
    "elementwise_sub_axis0": ("elementwise_sub",
                              {"X": [_f(3, 4, 2)], "Y": [_f(3)]},
                              {"axis": 0}, ("X", "Y")),
    "elementwise_div": ("elementwise_div",
                        {"X": [_f(3, 4)], "Y": [2 + np.abs(_f(3, 4))]},
                        {"axis": -1}, ("X", "Y")),
    "elementwise_max": ("elementwise_max", {"X": [_f(3, 4)], "Y": [_f(4)]},
                        {"axis": -1}, ("X", "Y")),
    "sqrt": ("sqrt", {"X": [0.5 + np.abs(_f(3, 4))]}, {}, ("X",)),
    "square": ("square", {"X": [_f(3, 4)]}, {}, ("X",)),
    "clip": ("clip", {"X": [_f(4, 5)]}, {"min": -0.5, "max": 0.7}, ("X",)),
    "clip_by_norm_clips": ("clip_by_norm", {"X": [_f(4, 5)]},
                           {"max_norm": 1.0}, ("X",)),
    "clip_by_norm_keeps": ("clip_by_norm", {"X": [_f(4, 5)]},
                           {"max_norm": 100.0}, ("X",)),
}

FORWARD_ONLY = {
    "accuracy_k1": ("accuracy",
                    {"Out": [_f(8, 1)], "Indices": [_pred_ids(8, 5, 1)],
                     "Label": [R.randint(0, 5, (8, 1)).astype("int64")]},
                    {}),
    "accuracy_k2": ("accuracy",
                    {"Out": [_f(8, 2)], "Indices": [_pred_ids(8, 5, 2)],
                     "Label": [R.randint(0, 5, (8, 1)).astype("int64")]},
                    {}),
    "sgd": ("sgd", {"Param": [_f(4, 3)], "Grad": [_f(4, 3)],
                    "LearningRate": [np.array([0.1], "float32")]}, {}),
    # ties: the lower index first in both packages
    "top_k_ties": ("top_k",
                   {"X": [np.array([[1, 3, 3, 0, 3], [2, 2, 2, 2, 2]],
                                   "float32")]}, {"k": 3}),
    # a tied window: the forward agrees (the gradient may not)
    "pool2d_max_ties": ("pool2d",
                        {"X": [np.floor(2 * _f(2, 3, 8, 8))]},
                        {"ksize": [2, 2], "strides": [2, 2],
                         "pooling_type": "max"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    op_type, ins, attrs, _ = CASES[case]
    _check(op_type, ins, attrs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_grad_matches_reference(case):
    op_type, ins, attrs, grad_slots = CASES[case]
    _check_grad(op_type, ins, attrs, grad_slots)


@pytest.mark.parametrize("case", sorted(FORWARD_ONLY))
def test_forward_only_op_matches_reference(case):
    _check(*FORWARD_ONLY[case])


def test_accuracy_counts_are_int32():
    op_type, ins, attrs = FORWARD_ONLY["accuracy_k2"]
    outs = _run_both(op_type, ins, attrs)
    for slot in ("Correct", "Total"):
        (j, t), = outs[slot]
        assert np.asarray(j).dtype == np.int32 and t.dtype == torch.int32


def test_pool2d_ceil_mode_is_refused():
    """The reference reads no ceil_mode (floor-sized outputs whatever it
    says); the port refuses it instead of answering under that name."""
    x = torch.from_numpy(_f(1, 2, 7, 7))
    with pytest.raises(NotImplementedError, match="ceil_mode"):
        treg.get_op("pool2d").fn({"X": [x]},
                                 {"ksize": [2, 2], "strides": [2, 2],
                                  "ceil_mode": True}, treg.LoweringContext())


# ---------------------------------------------------------------------------
# shape bucketing: 5 valid rows padded to 8, masked in both packages
# ---------------------------------------------------------------------------

PAD = dict(valid=5, padded=8, batch_major=True)


def _bn_padded():
    x = _f(8, 3, 2, 2)
    x[5:] = 0.0                  # the padded rows, as the executor pads
    return _bn_ins(x, 3)


MASKED = {
    "reduce_sum_dim0": ("reduce_sum", {"X": [_f(8, 3)]}, {"dim": [0]}),
    "reduce_sum_all": ("reduce_sum", {"X": [_f(8, 3)]},
                       {"dim": [0], "reduce_all": True}),
    "reduce_sum_dim1_unmasked": ("reduce_sum", {"X": [_f(8, 3)]},
                                 {"dim": [1]}),
    "reduce_mean_dim0": ("reduce_mean", {"X": [_f(8, 3, 2)]},
                         {"dim": [0, 2]}),
    "mean": ("mean", {"X": [_f(8, 3)]}, {}),
    "sigmoid_xent_normalize": (
        "sigmoid_cross_entropy_with_logits",
        {"X": [_f(8, 2)], "Label": [R.randint(0, 2, (8, 2))
                                    .astype("float32")]},
        {"normalize": True}),
    "accuracy": ("accuracy",
                 {"Out": [_f(8, 1)], "Indices": [_pred_ids(8, 5, 1)],
                  "Label": [R.randint(0, 5, (8, 1)).astype("int64")]}, {}),
    "batch_norm_stats": ("batch_norm", _bn_padded(), {"momentum": 0.5}),
}


@pytest.mark.parametrize("case", sorted(MASKED))
def test_masked_op_matches_reference(case):
    """The padded rows are left out of the reduction in both packages."""
    _check(*MASKED[case], bucket=PAD)


@pytest.mark.parametrize("case", ["mean", "reduce_mean_dim0",
                                  "batch_norm_stats"])
def test_masked_op_grad_matches_reference(case):
    op_type, ins, attrs = MASKED[case]
    slots = ("X", "Scale", "Bias") if op_type == "batch_norm" else ("X",)
    _check_grad(op_type, ins, attrs, slots, bucket=PAD)


def test_masked_mean_equals_unpadded_mean():
    """The padded answer is the answer over the valid rows alone."""
    x = torch.from_numpy(_f(8, 3))
    got = treg.get_op("mean").fn({"X": [x]}, {}, _ctx(treg, **PAD))["Out"][0]
    torch.testing.assert_close(got, x[:5].mean(), rtol=1e-6, atol=1e-7)


def test_persistable_input_is_never_masked():
    """A parameter whose dim 0 equals the bucket (the IR hint says it is
    not batch-major) is reduced whole, in both packages."""
    _check("reduce_mean", {"X": [_f(8, 8)]}, {"dim": [0]},
           bucket=dict(valid=5, padded=8, batch_major=False))
    x = torch.from_numpy(_f(8, 8))
    ctx = _ctx(treg, valid=5, padded=8, batch_major=False)
    assert ctx.batch_mask(8) is None
    got = treg.get_op("reduce_mean").fn({"X": [x]}, {"dim": [0]},
                                        ctx)["Out"][0]
    torch.testing.assert_close(got, x.mean(0))


# ---------------------------------------------------------------------------
# a static NHWC conv2d with a bias, then batch_norm, built and run
# ---------------------------------------------------------------------------

def _conv_bn_program(pkg, layout, x_shape):
    """conv2d 5@3x3 (pad 1, with a bias) then batch_norm in ``layout``,
    every parameter named; returns (main, startup, conv out, bn out)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.data("x", [-1, *x_shape])
        conv = pkg.layers.conv2d(x, 5, 3, padding=1, param_attr="conv_w",
                                 bias_attr="conv_b", data_format=layout)
        bn = pkg.layers.batch_norm(conv, param_attr="bn_s", bias_attr="bn_b",
                                   moving_mean_name="bn_m",
                                   moving_variance_name="bn_v",
                                   data_layout=layout)
    return main, startup, conv, bn


def test_static_nhwc_conv2d_bias_then_batch_norm():
    """The port's NHWC conv2d adds its bias on the channel axis (the last)
    and gives its output a static shape, so a following NHWC batch_norm
    builds; the program runs and agrees with the reference's NCHW program
    on the same weights and input, transposed.  (The reference's static
    layer adds the bias on axis 1 whatever the layout, and its NHWC
    program fails; its dygraph Conv2D uses the channel axis.)"""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid.core import Scope as JScope, scope_guard

    import paddle_tpu_torch.fluid as tfluid
    from paddle_tpu_torch import interop

    rng = np.random.RandomState(31)
    x = rng.randn(2, 3, 6, 7).astype("float32")
    weights = {"conv_w": 0.3 * rng.randn(5, 3, 3, 3).astype("float32"),
               "conv_b": rng.randn(5).astype("float32"),
               "bn_s": (1 + 0.1 * rng.randn(5)).astype("float32"),
               "bn_b": (0.1 * rng.randn(5)).astype("float32"),
               "bn_m": (0.1 * rng.randn(5)).astype("float32"),
               "bn_v": (np.abs(rng.randn(5)) + 0.5).astype("float32")}

    main, startup, conv, bn = _conv_bn_program(jfluid, "NCHW", (3, 6, 7))
    exe = jfluid.Executor()
    with scope_guard(JScope()):
        exe.run(startup)
        scope = jfluid.global_scope()
        for name, a in weights.items():
            scope.set_var(name, jnp.asarray(a))
        want = [np.asarray(o) for o in exe.run(
            main, feed={"x": x}, fetch_list=[conv, bn, "bn_m", "bn_v"])]

    main, startup, conv, bn = _conv_bn_program(tfluid, "NHWC", (6, 7, 3))
    assert tuple(conv.shape) == (-1, 6, 7, 5)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    interop.scope_from_numpy(weights, scope, tfluid.CPUPlace())
    got = exe.run(main, feed={"x": x.transpose(0, 2, 3, 1)},
                  fetch_list=[conv, bn, "bn_m", "bn_v"], scope=scope)
    for i, name in enumerate(("conv2d", "batch_norm")):
        np.testing.assert_allclose(np.asarray(got[i]).transpose(0, 3, 1, 2),
                                   want[i], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    for i, name in ((2, "bn_m"), (3, "bn_v")):
        np.testing.assert_allclose(np.asarray(got[i]), want[i], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
