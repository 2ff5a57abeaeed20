"""Dense math, elementwise and activation lowerings (counterpart of
``paddle_tpu/ops/math.py``, the ops this slice runs).

Float32 matrix products run in full float32 on the card: the executor
turns TF32 off (fluid/executor.py).
"""
from __future__ import annotations

import math

import torch

from .registry import register_op


def _x(ins, slot="X", i=0):
    return ins[slot][i]


def _bcast(x, y, axis):
    """elementwise_op_function.h broadcasting: ``axis`` names the dim of
    X at which Y's shape aligns; -1 = trailing alignment."""
    if axis is None or axis == -1 or x.ndim == y.ndim:
        return x, y
    expand = [1] * x.ndim
    for i, d in enumerate(y.shape):
        expand[axis + i] = d
    return x, y.reshape(expand)


def _ew(name, f):
    def lower(ins, attrs, ctx):
        x, y = _bcast(_x(ins), _x(ins, "Y"), attrs.get("axis", -1))
        out = f(x, y)
        scale = attrs.get("scale", None)
        if scale is not None and scale != 1.0:
            out = out * scale
        return {"Out": [out]}
    register_op(name, lower)


_ew("elementwise_add", torch.add)
_ew("elementwise_sub", torch.sub)
_ew("elementwise_mul", torch.mul)
_ew("elementwise_div", torch.div)
_ew("elementwise_max", torch.maximum)


@register_op("sum")  # fluid sum op: variadic add (used for grad fan-in)
def _sum(ins, attrs, ctx):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("relu")
def _relu(ins, attrs, ctx):
    return {"Out": [torch.relu(_x(ins))]}


@register_op("relu6")
def _relu6(ins, attrs, ctx):
    """``clip(x, 0, threshold)`` as the reference spells it,
    ``minimum(maximum(x, 0), threshold)``: at either bound the gradient
    is split in half between the two sides, as jax's is."""
    x = _x(ins)
    lo = x.new_zeros(())
    hi = x.new_full((), attrs.get("threshold", 6.0))
    return {"Out": [torch.minimum(torch.maximum(x, lo), hi)]}


@register_op("gelu")
def _gelu(ins, attrs, ctx):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [torch.nn.functional.gelu(_x(ins),
                                             approximate=approximate)]}


@register_op("tanh")
def _tanh(ins, attrs, ctx):
    return {"Out": [torch.tanh(_x(ins))]}


@register_op("sigmoid")
def _sigmoid(ins, attrs, ctx):
    return {"Out": [torch.sigmoid(_x(ins))]}


@register_op("sqrt")
def _sqrt(ins, attrs, ctx):
    return {"Out": [torch.sqrt(_x(ins))]}


@register_op("square")
def _square(ins, attrs, ctx):
    return {"Out": [torch.square(_x(ins))]}


@register_op("clip")
def _clip(ins, attrs, ctx):
    return {"Out": [torch.clamp(_x(ins), attrs.get("min"), attrs.get("max"))]}


@register_op("clip_by_norm")
def _clip_by_norm(ins, attrs, ctx):
    """x scaled down to ``max_norm`` when its L2 norm is larger."""
    x = _x(ins)
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": [torch.where(norm > max_norm, x * (max_norm / norm), x)]}


@register_op("scale")
def _scale(ins, attrs, ctx):
    x = _x(ins)
    s = ins.get("ScaleTensor")
    scale = s[0] if s else attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


# torch.matmul accumulates half-precision inputs in fp32 and returns
# their own dtype: the contract the TPU package spells out with
# preferred_element_type
@register_op("matmul")
def _matmul(ins, attrs, ctx):
    x, y = _x(ins), _x(ins, "Y")
    if attrs.get("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("mul")  # operators/mul_op.cc: flatten then 2-D matmul
def _mul(ins, attrs, ctx):
    x, y = _x(ins), _x(ins, "Y")
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xn]), -1)
    y2 = y.reshape(math.prod(ys[:yn]), -1)
    return {"Out": [torch.matmul(x2, y2).reshape(xs[:xn] + ys[yn:])]}


# comparisons (operators/controlflow/compare_op.cc): numpy broadcasting,
# a bool result; only the one the decode programs use is ported
@register_op("less_than", differentiable=False)
def _less_than(ins, attrs, ctx):
    return {"Out": [torch.lt(_x(ins), _x(ins, "Y"))]}
