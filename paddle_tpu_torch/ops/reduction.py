"""Reduction lowerings (counterpart of ``paddle_tpu/ops/reduction.py``,
the ops the ported slices run).

Under shape bucketing (fluid/executor.py) a reduction that collapses the
padded batch axis masks the padded rows out (``masked_batch_reduce``),
and a mean divides by the true row count, so a padded step gives the
unpadded step's answer.  ``top_k`` breaks ties by the lower index, as
``jax.lax.top_k`` does."""
from __future__ import annotations

import torch

from .registry import register_op


def _axes(attrs, ndim):
    dim = attrs.get("dim", [0])
    if attrs.get("reduce_all", False) or dim is None or len(dim) == 0:
        return tuple(range(ndim))
    return tuple(d % ndim for d in dim)


def masked_batch_reduce(x, ctx, axes, keepdim=False, mean=False):
    """Sum or mean over ``axes`` with the padded batch rows left out, or
    None when masking does not apply (bucketing off, axis 0 not reduced,
    or x does not carry the padded batch dim).  The padded rows hold
    whatever the network computed from zero inputs, not zeros; a mean
    divides by the true row count times the other reduced extents."""
    if x.ndim == 0 or 0 not in axes:
        return None
    mask = ctx.batch_mask(x.shape[0])
    if mask is None:
        return None
    row = mask.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    s = torch.sum(torch.where(row, x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device)),
                  dim=axes, keepdim=keepdim)
    if not mean:
        return s
    count = ctx.batch_valid         # a host int, or a 0-d tensor in an
    for d in axes:                  # exported graph (inference/aot.py)
        if d != 0:
            count = count * x.shape[d]
    return s / count


@register_op("reduce_sum")
def _reduce_sum(ins, attrs, ctx):
    x = ins["X"][0]
    axes = _axes(attrs, x.ndim)
    keep = attrs.get("keep_dim", False)
    if not axes:
        return {"Out": [x.clone()]}
    out = masked_batch_reduce(x, ctx, axes, keep)
    if out is None:
        out = torch.sum(x, dim=axes, keepdim=keep)
    return {"Out": [out]}


def _float_for_mean(x):
    """An integer (or bool) tensor as float32: the mean of integers is a
    float, as ``jnp.mean`` gives it with x64 off."""
    return x if x.is_floating_point() else x.to(torch.float32)


@register_op("reduce_mean")
def _reduce_mean(ins, attrs, ctx):
    x = _float_for_mean(ins["X"][0])
    axes = _axes(attrs, x.ndim)
    keep = attrs.get("keep_dim", False)
    if not axes:
        return {"Out": [x.clone()]}
    out = masked_batch_reduce(x, ctx, axes, keep, mean=True)
    if out is None:
        out = torch.mean(x, dim=axes, keepdim=keep)
    return {"Out": [out]}


@register_op("mean")
def _mean(ins, attrs, ctx):
    x = _float_for_mean(ins["X"][0])
    out = masked_batch_reduce(x, ctx, tuple(range(x.ndim)), mean=True)
    return {"Out": [torch.mean(x) if out is None else out]}


@register_op("top_k", nondiff_outputs=("Indices",))
def _top_k(ins, attrs, ctx):
    """The k largest along the last axis, largest first; among equal
    values the lower index comes first (a stable descending sort)."""
    x = ins["X"][0]
    k = int(ins["K"][0]) if ins.get("K") else attrs["k"]
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


# --------------------------------------------------------------------------
# the 2.0 surface (paddle.tensor): the other reductions, arg-reductions
# and the sort
# --------------------------------------------------------------------------
def _identity(fill, dtype):
    """The reduction's identity element: padded rows become it."""
    if fill == "one":
        return 1
    if dtype == torch.bool:
        return fill == "max"
    info = torch.finfo(dtype) if dtype.is_floating_point \
        else torch.iinfo(dtype)
    return info.min if fill == "min" else info.max


def _extremum(name, f, fill):
    def lower(ins, attrs, ctx):
        x = ins["X"][0]
        axes = _axes(attrs, x.ndim)
        keep = attrs.get("keep_dim", False)
        if x.ndim and 0 in axes:
            mask = ctx.batch_mask(x.shape[0])
            if mask is not None:
                row = mask.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
                x = torch.where(row, x, torch.full(
                    (), _identity(fill, x.dtype), dtype=x.dtype,
                    device=x.device))
        return {"Out": [f(x, axes, keep)]}
    register_op(name, lower)


def _amax(x, axes, keep):
    return torch.amax(x, dim=axes, keepdim=keep)


def _amin(x, axes, keep):
    return torch.amin(x, dim=axes, keepdim=keep)


def _prod(x, axes, keep):
    for d in sorted(axes, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep)
    return x


_extremum("reduce_max", _amax, "min")
_extremum("reduce_min", _amin, "max")
_extremum("reduce_prod", _prod, "one")
register_op("reduce_all", lambda ins, a, c: {"Out": [torch.all(
    ins["X"][0].bool(), dim=_axes(a, ins["X"][0].ndim),
    keepdim=a.get("keep_dim", False))]}, differentiable=False)
register_op("reduce_any", lambda ins, a, c: {"Out": [torch.any(
    ins["X"][0].bool(), dim=_axes(a, ins["X"][0].ndim),
    keepdim=a.get("keep_dim", False))]}, differentiable=False)


def _arg(name, f):
    def lower(ins, attrs, ctx):
        x = ins["X"][0]
        if attrs.get("flatten", False):
            return {"Out": [f(x.reshape(-1), 0)]}
        axis = attrs.get("axis", -1)
        out = f(x, axis)
        if attrs.get("keepdims", False):
            out = out.unsqueeze(axis)
        return {"Out": [out]}
    register_op(name, lower, differentiable=False)


_arg("arg_max", lambda x, d: torch.argmax(x, dim=d))
_arg("arg_min", lambda x, d: torch.argmin(x, dim=d))


@register_op("argsort", nondiff_outputs=("Indices",))
def _argsort(ins, attrs, ctx):
    """A stable sort of x (descending: of -x), as ``jnp.argsort``."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    key = -x if attrs.get("descending", False) else x
    idx = torch.sort(key, dim=axis, stable=True)[1]
    return {"Out": [torch.take_along_dim(x, idx, dim=axis)],
            "Indices": [idx]}


@register_op("max_pool2d_with_index", nondiff_outputs=("Mask",))
def _max_pool2d_with_index(ins, attrs, ctx):
    """The pooled maxima of NCHW x (symmetric ``paddings`` at -inf); the
    reference's ``Mask`` is all zeros (int32), and so is the port's."""
    x = ins["X"][0]
    ks = list(attrs["ksize"])
    st = list(attrs.get("strides", ks))
    pd = list(attrs.get("paddings", [0, 0]))
    xp = torch.nn.functional.pad(x, [pd[1], pd[1], pd[0], pd[0]],
                                 value=float("-inf"))
    out = torch.nn.functional.max_pool2d(xp, ks, st)
    return {"Out": [out], "Mask": [torch.zeros_like(out, dtype=torch.int32)]}


@register_op("top_k_v2", nondiff_outputs=("Indices",))
def _top_k_v2(ins, attrs, ctx):
    """The k largest (or smallest) along ``axis``, in that order; among
    equal values the lower index comes first, as ``lax.top_k`` gives it
    (a stable sort: ``torch.topk`` promises no order among ties)."""
    x = ins["X"][0]
    k = attrs.get("k", 1)
    axis = attrs.get("axis", -1) % x.ndim
    vals, idx = torch.sort(x.movedim(axis, -1), dim=-1, stable=True,
                           descending=attrs.get("largest", True))
    return {"Out": [vals[..., :k].movedim(-1, axis)],
            "Indices": [idx[..., :k].movedim(-1, axis)]}


@register_op("kthvalue", nondiff_outputs=("Indices",))
def _kthvalue(ins, attrs, ctx):
    """The k-th smallest along ``axis`` and its index (a stable sort: the
    lower index among ties)."""
    x = ins["X"][0]
    k, axis = attrs["k"], attrs.get("axis", -1)
    vals, idx = torch.sort(x, dim=axis, stable=True)
    out, idx = vals.select(axis, k - 1), idx.select(axis, k - 1)
    if attrs.get("keepdim", False):
        out, idx = out.unsqueeze(axis), idx.unsqueeze(axis)
    return {"Out": [out], "Indices": [idx]}
