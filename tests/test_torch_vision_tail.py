"""The vision tail: paddle_tpu_torch against paddle_tpu, VGG and the
MobileNets.

The same numpy inputs (from seeded ``RandomState``s) go through both
packages on the CPU: the ops ``relu6`` and ``depthwise_conv2d`` (forward
and through ``generic_grad``; NCHW, NHWC, stride 2, ``SAME``, a channel
multiplier of 2, dilation), ``nn.ReLU6``, VGG11's eval logits at 224²,
batch 1, and MobileNetV1 and V2 at scale 0.25, 64², batch 2: eval logits
and one functional training step.  Each reference model's
``state_dict()``, buffers included, is carried into the port's by
``interop.layer_from_numpy``.  The reference's jit leaves tracers in its
batch-norm buffers after each call (ROADMAP.md queue C), so every
reference call here puts the buffers' values back after it.

Tolerances, float32: ops rtol 1e-5, atol 1e-6 (the libraries sum in
different orders); eval logits within 1e-5 of the largest |logit|; the
training step's loss rtol 1e-4 and its whole gradient's cosine at least
0.99 with norms within 2% (the ResNet slice's limits: first-step
gradients of a batch-norm net at a few values a channel are
ill-conditioned in float32).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.dygraph import base as jdy
from paddle_tpu.dygraph.functional import functional_loss as j_functional, \
    functionalize as j_functionalize
from paddle_tpu.fluid import layers as JL
from paddle_tpu.nn import layer as jlayer
from paddle_tpu.ops import registry as jreg
from paddle_tpu.vision import models as jmodels

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.dygraph.functional import functional_loss as \
    t_functional, functionalize as t_functionalize
from paddle_tpu_torch.fluid import layers as TL
from paddle_tpu_torch.nn import layer as tlayer
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.vision import models as tmodels

HOST = tfluid.CPUPlace()
CLASSES = 10
R = np.random.RandomState(41)


def _f(*shape):
    return np.asarray(R.randn(*shape), "float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# the two ops, forward and through generic_grad
# ---------------------------------------------------------------------------
def _run_op(pkg, op_type, ins, attrs):
    wrap = jnp.asarray if pkg is jreg else \
        (lambda a: torch.from_numpy(np.array(a)))
    return pkg.get_op(op_type).fn(
        {s: [wrap(a) for a in v] for s, v in ins.items()}, dict(attrs),
        pkg.LoweringContext())


def _check_op(op_type, ins, attrs, grad_slots):
    """Forward outputs, then generic_grad's input gradients for a seeded
    cotangent of every output."""
    j_out = _run_op(jreg, op_type, ins, attrs)
    t_out = _run_op(treg, op_type, ins, attrs)
    assert set(j_out) == set(t_out)
    for s in j_out:
        for j, t in zip(j_out[s], t_out[s]):
            _close(t, j, msg=f"{op_type}.{s}")
    g_ins = {"I_" + s: v for s, v in ins.items()}
    for s, vals in j_out.items():
        g_ins["G_" + s] = [_f(*np.shape(v)) for v in vals]
    attrs = {"fwd_type": op_type, "fwd_attrs": dict(attrs),
             "in_slots": list(ins), "grad_slots": list(grad_slots)}
    j_g = _run_op(jreg, "generic_grad", g_ins, attrs)
    t_g = _run_op(treg, "generic_grad", g_ins, attrs)
    for s in grad_slots:
        _close(t_g["GI_" + s][0], j_g["GI_" + s][0], msg=f"{op_type} d{s}")


@pytest.mark.parametrize("attrs", [{}, {"threshold": 3.0}],
                         ids=["default", "threshold 3"])
def test_relu6_matches_reference(attrs):
    """Values on both sides of both bounds and on the bounds themselves
    (where the gradient is split in half, as jax's is)."""
    x = np.concatenate([4 * _f(200), [0.0, 6.0, 3.0, -0.0]]) \
        .astype("float32").reshape(4, 51)
    _check_op("relu6", {"X": [x]}, attrs, ("X",))


DEPTHWISE_CASES = {
    "nchw": ((2, 4, 7, 7), (4, 1, 3, 3),
             {"paddings": [1, 1]}),
    "nhwc": ((2, 7, 7, 4), (4, 1, 3, 3),
             {"paddings": [1, 1], "data_format": "NHWC"}),
    "stride 2": ((2, 4, 9, 8), (4, 1, 3, 3),
                 {"strides": [2, 2], "paddings": [1, 1]}),
    "same": ((2, 4, 8, 9), (4, 1, 3, 3),
             {"strides": [2, 2], "padding_algorithm": "SAME"}),
    "same nhwc": ((2, 8, 9, 4), (4, 1, 5, 5),
                  {"strides": [2, 2], "padding_algorithm": "SAME",
                   "data_format": "NHWC"}),
    "multiplier 2": ((2, 3, 6, 6), (6, 1, 3, 3), {"paddings": [0, 0]}),
    "dilation 2": ((2, 4, 9, 9), (4, 1, 3, 3),
                   {"dilations": [2, 2], "paddings": [2, 2]}),
    "groups given": ((2, 4, 6, 6), (4, 2, 3, 3),
                     {"groups": 2, "paddings": [1, 1]}),
}


@pytest.mark.parametrize("case", sorted(DEPTHWISE_CASES))
def test_depthwise_conv2d_matches_reference(case):
    xs, ws, attrs = DEPTHWISE_CASES[case]
    _check_op("depthwise_conv2d", {"Input": [_f(*xs)], "Filter": [_f(*ws)]},
              attrs, ("Input", "Filter"))


def test_relu6_layer_matches_reference():
    x = 4 * _f(3, 5, 7)
    with jdy.guard():
        want = jlayer.ReLU6()(jdy.to_variable(jnp.asarray(x))).value()
    with tdy.guard(HOST):
        got = tlayer.ReLU6()(tdy.to_variable(x)).value()
    _close(got, want)


# ---------------------------------------------------------------------------
# VGG11, MobileNetV1 and MobileNetV2
# ---------------------------------------------------------------------------
def _restore_buffers(jm, values):
    for b, v in zip(jm.buffers(), values):
        b._value = v


def _pair(build, seed):
    """(reference model, port model) from the reference's weights."""
    with jdy.guard():
        np.random.seed(seed)
        jm = build(jmodels)
        state = jm.state_dict()
    with tdy.guard(HOST):
        tm = build(tmodels)
        assert list(tm.state_dict()) == list(state)
        interop.layer_from_numpy(tm, state)
    return jm, tm


def _images(batch, size, seed):
    return np.random.RandomState(seed).randn(batch, 3, size, size) \
        .astype("float32")


def _labels(batch, seed):
    return np.random.RandomState(seed).randint(
        0, CLASSES, (batch, 1)).astype("int64")


def _eval_logits(jm, tm, x):
    saved = [b._value for b in jm.buffers()]
    with jdy.guard():
        jm.eval()
        pv, fwd = j_functionalize(jm)
        want = _np(jax.jit(fwd)(pv, jnp.asarray(x)))
    _restore_buffers(jm, saved)
    with tdy.guard(HOST):
        tm.eval()
        pv, fwd = t_functionalize(tm)
        got = fwd(pv, torch.from_numpy(x))
    return got, want


MOBILENETS = {"v1": lambda m: m.mobilenet_v1(scale=0.25,
                                              num_classes=CLASSES),
              "v2": lambda m: m.mobilenet_v2(scale=0.25,
                                              num_classes=CLASSES)}


@pytest.fixture(scope="module")
def mobilenets():
    return {k: _pair(b, 50 + i) for i, (k, b) in
            enumerate(sorted(MOBILENETS.items()))}


def test_vgg11_eval_logits_match_reference():
    jm, tm = _pair(lambda m: m.vgg11(num_classes=CLASSES), 49)
    got, want = _eval_logits(jm, tm, _images(1, 224, 3))
    _close(got, want, rtol=0.0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("version", sorted(MOBILENETS))
def test_mobilenet_eval_logits_match_reference(mobilenets, version):
    jm, tm = mobilenets[version]
    got, want = _eval_logits(jm, tm, _images(2, 64, 4))
    _close(got, want, rtol=0.0, atol=1e-5 * float(np.abs(want).max()))


def _loss(L, model):
    def fn(images, labels):
        return L.nn.mean(L.softmax_with_cross_entropy(model(images), labels))
    return fn


@pytest.mark.parametrize("version", sorted(MOBILENETS))
def test_mobilenet_functional_step_matches_reference(mobilenets, version):
    jm, tm = mobilenets[version]
    x, y = _images(2, 64, 5), _labels(2, 6)
    saved = [b._value for b in jm.buffers()]
    with jdy.guard():
        jm.train()
        pv, lfn = j_functional(jm, _loss(JL, jm))
        j_loss, j_grads = jax.jit(jax.value_and_grad(lfn))(
            pv, jnp.asarray(x), jnp.asarray(y.astype("int32")))
    _restore_buffers(jm, saved)
    with tdy.guard(HOST):
        tm.train()
        pv, lfn = t_functional(tm, _loss(TL, tm))
        t_grads, t_loss = torch.func.grad_and_value(lfn)(
            pv, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)
    g = np.concatenate([_np(a).ravel() for a in t_grads])
    w = np.concatenate([_np(a).ravel() for a in j_grads])
    cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
    assert cos >= 0.99, cos
    assert abs(np.linalg.norm(g) / np.linalg.norm(w) - 1) <= 0.02
