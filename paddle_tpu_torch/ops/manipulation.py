"""Tensor manipulation and creation lowerings (counterpart of
``paddle_tpu/ops/manipulation.py``, the ops the ported slices run)."""
from __future__ import annotations

import torch

from ..fluid.framework import torch_dtype
from .registry import register_op


def _x(ins, slot="X", i=0):
    return ins[slot][i]


def _xshape(x):
    # XShape carries no data: an empty tensor of x's dtype, as in the TPU
    # package
    return torch.zeros((0,), dtype=x.dtype, device=x.device)


@register_op("reshape2", nondiff_inputs=("Shape", "ShapeTensor"))
def _reshape2(ins, attrs, ctx):
    x = _x(ins)
    if ins.get("Shape"):
        shape = [int(s) for s in ins["Shape"][0].tolist()]
    else:
        shape = list(attrs["shape"])
    # fluid semantics: 0 copies the input dim at that position; -1 is
    # inferred from the rest
    shape = [x.shape[i] if d == 0 else d for i, d in enumerate(shape)]
    return {"Out": [x.reshape(shape)], "XShape": [_xshape(x)]}


@register_op("transpose2")
def _transpose2(ins, attrs, ctx):
    x = _x(ins)
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [_xshape(x)]}


def _flatten_lead(x, axis):
    """dims [0, axis) collapse into one (1 when axis is 0)."""
    lead = 1
    for d in x.shape[:axis]:
        lead *= d
    return lead


@register_op("flatten2")
def _flatten2(ins, attrs, ctx):
    x = _x(ins)
    lead = _flatten_lead(x, attrs.get("axis", 1))
    return {"Out": [x.reshape(lead, -1)], "XShape": [_xshape(x)]}


@register_op("flatten_contiguous_range")
def _flatten_range(ins, attrs, ctx):
    """Dims ``start_axis`` to ``stop_axis`` (negatives from the end)
    collapse into one, as the reference's reshape to
    ``shape[:start] + (-1,) + shape[stop + 1:]``."""
    x = _x(ins)
    nd = x.ndim
    start = attrs.get("start_axis", 1) % nd
    stop = attrs.get("stop_axis", -1) % nd
    shape = tuple(x.shape[:start]) + (-1,) + tuple(x.shape[stop + 1:])
    return {"Out": [x.reshape(shape)], "XShape": [_xshape(x)]}


@register_op("flatten")
def _flatten(ins, attrs, ctx):
    x = _x(ins)
    return {"Out": [x.reshape(_flatten_lead(x, attrs.get("axis", 1)), -1)]}


@register_op("squeeze2")
def _squeeze2(ins, attrs, ctx):
    """Drop the listed dims of size 1 (every size-1 dim when none is
    listed); a listed dim of another size stays."""
    x = _x(ins)
    axes = [a % x.ndim for a in attrs.get("axes", [])] \
        or [i for i, d in enumerate(x.shape) if d == 1]
    out = x.reshape([d for i, d in enumerate(x.shape)
                     if not (i in axes and d == 1)])
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("unsqueeze2")
def _unsqueeze2(ins, attrs, ctx):
    """Insert a dim of size 1 at each listed axis, in ascending order (a
    negative axis counts from the end of the growing output)."""
    x = _x(ins)
    out = x
    for ax in sorted(attrs["axes"]):
        out = out.unsqueeze(ax if ax >= 0 else ax + out.ndim + 1)
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("slice", nondiff_inputs=("StartsTensor", "EndsTensor"))
def _slice(ins, attrs, ctx):
    """Static starts/ends per axis, clamped to the dim, negatives from the
    end; ``decrease_axis`` dims squeezed."""
    x = _x(ins, "Input")
    index = [slice(None)] * x.ndim
    for ax, s, e in zip(attrs["axes"], attrs.get("starts", []),
                        attrs.get("ends", [])):
        dim = x.shape[ax]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        index[ax] = slice(s, e)
    out = x[tuple(index)]
    for ax in sorted(attrs.get("decrease_axis", []) or [], reverse=True):
        out = out.squeeze(ax)
    return {"Out": [out]}


@register_op("cast")
def _cast(ins, attrs, ctx):
    return {"Out": [_x(ins).to(torch_dtype(attrs["out_dtype"]))]}


@register_op("concat")
def _concat(ins, attrs, ctx):
    axis = int(ins["AxisTensor"][0]) if ins.get("AxisTensor") \
        else attrs.get("axis", 0)
    return {"Out": [torch.cat(list(ins["X"]), dim=axis)]}


@register_op("split")
def _split(ins, attrs, ctx):
    """``num`` equal parts, or ``sections`` (one of them -1: the rest)
    along ``axis``."""
    x = _x(ins)
    axis = attrs.get("axis", 0)
    sections = list(attrs.get("sections", []))
    if not sections:
        num = attrs.get("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {x.shape[axis]} of axis {axis} "
                             f"is not divisible into {num} parts")
        sections = [x.shape[axis] // num] * num
    rest = x.shape[axis] - sum(s for s in sections if s >= 0)
    sections = [rest if s < 0 else s for s in sections]
    return {"Out": list(torch.split(x, sections, dim=axis))}


@register_op("stack")
def _stack(ins, attrs, ctx):
    return {"Y": [torch.stack(list(ins["X"]), dim=attrs.get("axis", 0))]}


@register_op("fill_any_like")
def _fill_any_like(ins, attrs, ctx):
    """``value`` in X's shape, in ``dtype`` (X's when unset or -1)."""
    x = _x(ins)
    dt = attrs.get("dtype", None)
    dtype = torch_dtype(dt) if dt not in (None, -1) else x.dtype
    return {"Out": [torch.full_like(x, attrs.get("value", 0.0),
                                    dtype=dtype)]}


@register_op("fill_zeros_like")
def _fill_zeros_like(ins, attrs, ctx):
    return {"Out": [torch.zeros_like(_x(ins))]}


@register_op("gather", nondiff_inputs=("Index",))
def _gather(ins, attrs, ctx):
    """Rows (or slices along ``axis``) of X at the int32/int64 Index,
    exact copies."""
    x, idx = _x(ins), _x(ins, "Index")
    axis = int(attrs.get("axis", 0))
    axis = axis % x.ndim
    flat = idx.reshape(-1).long()
    out = x.index_select(axis, flat)
    shape = x.shape[:axis] + idx.shape + x.shape[axis + 1:]
    return {"Out": [out.reshape(shape)]}


@register_op("assign")
def _assign(ins, attrs, ctx):
    return {"Out": [_x(ins)]}


def _one_hot_of(x, depth):
    """float32 one-hot of integer ``x`` over ``depth`` classes; an index
    outside ``[0, depth)`` gives a row of zeros (as ``jax.nn.one_hot``).
    Spelled as a comparison so it also runs on ``meta`` tensors."""
    classes = torch.arange(int(depth), device=x.device)
    return (x.long().unsqueeze(-1) == classes).to(torch.float32)


@register_op("one_hot", nondiff_inputs=("X",), differentiable=False)
def _one_hot(ins, attrs, ctx):
    """one_hot (v1): a trailing dim of 1 on X is replaced by the depth."""
    x = _x(ins)
    if x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    return {"Out": [_one_hot_of(x, attrs["depth"])]}


@register_op("one_hot_v2", nondiff_inputs=("X",), differentiable=False)
def _one_hot_v2(ins, attrs, ctx):
    return {"Out": [_one_hot_of(_x(ins), attrs["depth"])]}


@register_op("fill_constant_batch_size_like", differentiable=False)
def _fill_constant_bsl(ins, attrs, ctx):
    """A constant tensor of ``shape`` whose ``output_dim_idx`` dim is
    Input's ``input_dim_idx`` dim, on the run's device."""
    ref = ins["Input"][0]
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ref.device)]}


@register_op("fill_constant", differentiable=False)
def _fill_constant(ins, attrs, ctx):
    shape = attrs.get("shape", [])
    if ins.get("ShapeTensor"):
        shape = [int(d) for d in ins["ShapeTensor"][0].tolist()]
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(list(shape), attrs.get("value", 0.0),
                               dtype=dtype, device=ctx.device)]}


@register_op("lookup_table_v2", nondiff_inputs=("Ids",))
def _lookup_table_v2(ins, attrs, ctx):
    """Embedding (operators/lookup_table_v2_op): rows of W gathered by
    int64 ids; rows at ``padding_idx`` read as zero."""
    w, ids = _x(ins, "W"), _x(ins, "Ids").long()
    out = w.index_select(0, ids.reshape(-1)).reshape(
        tuple(ids.shape) + tuple(w.shape[1:]))
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return {"Out": [out]}


@register_op("lookup_table", nondiff_inputs=("Ids",))
def _lookup_table(ins, attrs, ctx):
    """lookup_table v1: as v2, but ids carry a trailing dim of 1, which
    is squeezed (lookup_table_op's [.., 1] ids)."""
    ids = _x(ins, "Ids")
    if ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    return _lookup_table_v2({"W": ins["W"], "Ids": [ids]}, attrs, ctx)
