"""Reduction lowerings (counterpart of ``paddle_tpu/ops/reduction.py``,
the ops the ported slices run).

Under shape bucketing the reference masks the padded batch rows out of a
reduction over axis 0; the port refuses such a reduction instead
(``_refuse_padded_batch``), so padded rows are never summed or averaged
in silently."""
from __future__ import annotations

import torch

from .registry import register_op


def _axes(attrs, ndim):
    dim = attrs.get("dim", [0])
    if attrs.get("reduce_all", False) or dim is None or len(dim) == 0:
        return tuple(range(ndim))
    return tuple(d % ndim for d in dim)


def _refuse_padded_batch(op_type, x, axes, ctx):
    """The TPU package masks padded rows out of batch reductions; until
    the port does, averaging them in silently would be wrong."""
    if x.ndim and 0 in axes and ctx.batch_padding_applies(x.shape[0]):
        raise NotImplementedError(
            f"{op_type} over the padded batch axis under shape bucketing "
            f"is not ported yet; run programs that reduce over the batch "
            f"without bucket padding")


@register_op("reduce_sum")
def _reduce_sum(ins, attrs, ctx):
    x = ins["X"][0]
    axes = _axes(attrs, x.ndim)
    _refuse_padded_batch("reduce_sum", x, axes, ctx)
    if not axes:
        return {"Out": [x.clone()]}
    return {"Out": [torch.sum(x, dim=axes,
                              keepdim=attrs.get("keep_dim", False))]}


def _float_for_mean(x):
    """An integer (or bool) tensor as float32: the mean of integers is a
    float, as ``jnp.mean`` gives it with x64 off."""
    return x if x.is_floating_point() else x.to(torch.float32)


@register_op("reduce_mean")
def _reduce_mean(ins, attrs, ctx):
    x = _float_for_mean(ins["X"][0])
    axes = _axes(attrs, x.ndim)
    _refuse_padded_batch("reduce_mean", x, axes, ctx)
    if not axes:
        return {"Out": [x.clone()]}
    return {"Out": [torch.mean(x, dim=axes,
                               keepdim=attrs.get("keep_dim", False))]}


@register_op("mean")
def _mean(ins, attrs, ctx):
    x = _float_for_mean(ins["X"][0])
    _refuse_padded_batch("mean", x, tuple(range(x.ndim)), ctx)
    return {"Out": [torch.mean(x)]}
