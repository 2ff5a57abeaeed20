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
    """``jnp.clip`` semantics: either bound may be absent, and with
    neither X comes back as it is (``torch.clamp`` refuses that)."""
    lo, hi = attrs.get("min"), attrs.get("max")
    if lo is None and hi is None:
        return {"Out": [_x(ins)]}
    return {"Out": [torch.clamp(_x(ins), lo, hi)]}


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


def _mm(x, y):
    """x @ y in the operands' common dtype, returned in x's, as the
    TPU package's matmuls promote mixed operands (a float32 activation
    times a bfloat16 parameter) and cast the product to x's dtype."""
    if x.dtype == y.dtype:
        return torch.matmul(x, y)
    common = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(common), y.to(common)).to(x.dtype)


@register_op("matmul")
def _matmul(ins, attrs, ctx):
    x, y = _x(ins), _x(ins, "Y")
    if attrs.get("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = _mm(x, y)
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
    return {"Out": [_mm(x2, y2).reshape(xs[:xn] + ys[yn:])]}


# comparisons (operators/controlflow/compare_op.cc): numpy broadcasting,
# a bool result; only the one the decode programs use is ported
@register_op("less_than", differentiable=False)
def _less_than(ins, attrs, ctx):
    return {"Out": [torch.lt(_x(ins), _x(ins, "Y"))]}


# --------------------------------------------------------------------------
# the 2.0 surface (paddle.tensor, nn.functional): the rest of the
# elementwise, activation, linear-algebra, comparison and logical ops
# --------------------------------------------------------------------------
def _trunc_div(a, b):
    """elementwise_floordiv_op.h: C-style division toward zero, not
    Python's floor (they differ for negative operands)."""
    if not a.is_floating_point() and not b.is_floating_point():
        return torch.div(a, b, rounding_mode="trunc")
    return torch.trunc(a / b)


_ew("elementwise_min", torch.minimum)
_ew("elementwise_pow", torch.pow)
_ew("elementwise_mod", torch.remainder)     # the sign of the divisor
_ew("elementwise_floordiv", _trunc_div)


def _clamp(x, lo, hi):
    """``jnp.clip``'s ``minimum(maximum(x, lo), hi)``: at a bound the
    gradient is split between the two sides, as jax's is."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _unary(name, f):
    def lower(ins, attrs, ctx):
        return {"Out": [f(_x(ins), attrs)]}
    register_op(name, lower)


_unary("logsigmoid", lambda x, a: torch.nn.functional.logsigmoid(x))
_unary("tanh_shrink", lambda x, a: x - torch.tanh(x))
_unary("erf", lambda x, a: torch.erf(x))
_unary("exp", lambda x, a: torch.exp(x))
_unary("log", lambda x, a: torch.log(x))
_unary("log2", lambda x, a: torch.log2(x))
_unary("log10", lambda x, a: torch.log10(x))
_unary("log1p", lambda x, a: torch.log1p(x))
_unary("rsqrt", lambda x, a: torch.rsqrt(x))
_unary("abs", lambda x, a: torch.abs(x))
_unary("ceil", lambda x, a: torch.ceil(x))
_unary("floor", lambda x, a: torch.floor(x))
_unary("round", lambda x, a: torch.round(x))    # half to even, as jnp
_unary("reciprocal", lambda x, a: torch.reciprocal(x))
_unary("sign", lambda x, a: torch.sign(x))
_unary("sin", lambda x, a: torch.sin(x))
_unary("cos", lambda x, a: torch.cos(x))
_unary("tan", lambda x, a: torch.tan(x))
_unary("asin", lambda x, a: torch.asin(x))
_unary("acos", lambda x, a: torch.acos(x))
_unary("atan", lambda x, a: torch.atan(x))
_unary("sinh", lambda x, a: torch.sinh(x))
_unary("cosh", lambda x, a: torch.cosh(x))
# activation_op.h: log(1 + exp(beta x)) / beta, linear past the threshold
_unary("softplus", lambda x, a: torch.where(
    a.get("beta", 1.0) * x > a.get("threshold", 20.0), x,
    _softplus(a.get("beta", 1.0) * x) / a.get("beta", 1.0)))
_unary("softsign", lambda x, a: x / (1 + torch.abs(x)))
_unary("softshrink", lambda x, a: torch.where(
    torch.abs(x) > a.get("lambda", 0.5),
    x - torch.sign(x) * a.get("lambda", 0.5), torch.zeros_like(x)))
_unary("hard_shrink", lambda x, a: torch.where(
    torch.abs(x) > a.get("threshold", 0.5), x, torch.zeros_like(x)))
_unary("hard_sigmoid", lambda x, a: _clamp(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_unary("hard_swish", lambda x, a: x * _clamp(
    x + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0))
    / a.get("scale", 6.0))
_unary("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
_unary("mish", lambda x, a: x * torch.tanh(_softplus(x)))
_unary("selu", lambda x, a: a.get("scale", 1.0507009873554805) * torch.where(
    x > 0, x, a.get("alpha", 1.6732632423543772) * (torch.exp(x) - 1)))
_unary("elu", lambda x, a: torch.where(
    x > 0, x, a.get("alpha", 1.0) * (torch.exp(x) - 1)))
_unary("leaky_relu", lambda x, a: torch.where(x > 0, x,
                                              a.get("alpha", 0.02) * x))
_unary("thresholded_relu", lambda x, a: torch.where(
    x > a.get("threshold", 1.0), x, torch.zeros_like(x)))
_unary("stanh", lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 0.67) * x))
_unary("silu", lambda x, a: torch.nn.functional.silu(x))


def _logit(x, a):
    eps = a.get("eps", 1e-6)
    p = _clamp(x, eps, 1 - eps)
    return torch.log(p) - torch.log1p(-p)


_unary("logit", _logit)


@register_op("prelu")
def _prelu(ins, attrs, ctx):
    x, alpha = _x(ins), _x(ins, "Alpha")
    if attrs.get("mode", "all") == "channel" and alpha.ndim < x.ndim:
        shape = [1] * x.ndim
        shape[1] = alpha.numel()
        alpha = alpha.reshape(shape)
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register_op("matmul_v2")
def _matmul_v2(ins, attrs, ctx):
    x, y = _x(ins), _x(ins, "Y")
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    return {"Out": [_mm(x, y)]}


@register_op("dot")
def _dot(ins, attrs, ctx):
    x, y = _x(ins), _x(ins, "Y")
    return {"Out": [torch.sum(x * y, dim=-1, keepdim=x.ndim > 1)]}


@register_op("mv")
def _mv(ins, attrs, ctx):
    return {"Out": [torch.matmul(_x(ins), _x(ins, "Vec"))]}


@register_op("addmm")
def _addmm(ins, attrs, ctx):
    inp, x, y = _x(ins, "Input"), _x(ins), _x(ins, "Y")
    return {"Out": [attrs.get("Beta", 1.0) * inp
                    + attrs.get("Alpha", 1.0) * torch.matmul(x, y)]}


@register_op("kron")
def _kron(ins, attrs, ctx):
    return {"Out": [torch.kron(_x(ins), _x(ins, "Y"))]}


@register_op("cross")
def _cross(ins, attrs, ctx):
    return {"Out": [torch.linalg.cross(_x(ins), _x(ins, "Y"),
                                       dim=attrs.get("dim", -1))]}


@register_op("trace")
def _trace(ins, attrs, ctx):
    return {"Out": [torch.diagonal(
        _x(ins, "Input"), attrs.get("offset", 0), attrs.get("axis1", 0),
        attrs.get("axis2", 1)).sum(-1)]}


@register_op("cholesky")
def _cholesky(ins, attrs, ctx):
    lo = torch.linalg.cholesky(_x(ins))
    return {"Out": [lo.transpose(-1, -2) if attrs.get("upper", False)
                    else lo]}


@register_op("inverse")
def _inverse(ins, attrs, ctx):
    return {"Output": [torch.linalg.inv(_x(ins, "Input"))]}


@register_op("cumsum")
def _cumsum(ins, attrs, ctx):
    x = _x(ins)
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0
    rev = attrs.get("reverse", False)
    if rev:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    if rev:
        out = torch.flip(out, (axis,))
    return {"Out": [out]}


@register_op("p_norm")
def _p_norm(ins, attrs, ctx):
    """The sum over ``axis`` alone, as the reference's lowering takes it
    (``asvector`` is not read there either)."""
    x = _x(ins)
    p = attrs.get("porder", 2.0)
    out = torch.sum(torch.abs(x) ** p, dim=attrs.get("axis", -1),
                    keepdim=attrs.get("keepdim", False)) ** (1.0 / p)
    return {"Out": [out]}


@register_op("dist")
def _dist(ins, attrs, ctx):
    x, y = _x(ins), _x(ins, "Y")
    p = attrs.get("p", 2.0)
    d = torch.abs(x - y)
    if p == float("inf"):
        return {"Out": [torch.max(d)]}
    if p == 0:
        return {"Out": [torch.sum(d != 0).to(x.dtype)]}
    return {"Out": [torch.sum(d ** p) ** (1 / p)]}


@register_op("logsumexp")
def _logsumexp(ins, attrs, ctx):
    x = _x(ins)
    axis = attrs.get("axis", None)
    dims = tuple(axis) if axis else tuple(range(x.ndim))
    return {"Out": [torch.logsumexp(x, dim=dims,
                                    keepdim=attrs.get("keepdim", False))]}


# comparisons and logical ops (operators/controlflow/{compare_op,
# logical_op}.cc): numpy broadcasting, a bool result
def _cmp(name, f):
    def lower(ins, attrs, ctx):
        return {"Out": [f(_x(ins), _x(ins, "Y"))]}
    register_op(name, lower, differentiable=False)


_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)
_cmp("logical_and", torch.logical_and)
_cmp("logical_or", torch.logical_or)
_cmp("logical_xor", torch.logical_xor)
register_op("logical_not",
            lambda ins, a, c: {"Out": [torch.logical_not(_x(ins))]},
            differentiable=False)
register_op("isfinite_v2", lambda ins, a, c: {"Out": [torch.isfinite(_x(ins))]},
            differentiable=False)
register_op("isinf_v2", lambda ins, a, c: {"Out": [torch.isinf(_x(ins))]},
            differentiable=False)
register_op("isnan_v2", lambda ins, a, c: {"Out": [torch.isnan(_x(ins))]},
            differentiable=False)


@register_op("allclose", differentiable=False)
def _allclose(ins, attrs, ctx):
    x, y = _x(ins, "Input"), _x(ins, "Other")
    close = torch.isclose(x, y, rtol=float(attrs.get("rtol", 1e-5)),
                          atol=float(attrs.get("atol", 1e-8)),
                          equal_nan=attrs.get("equal_nan", False))
    return {"Out": [torch.all(close)]}
