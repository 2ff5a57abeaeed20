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
    int64 ids; rows at ``padding_idx`` read as zero.  ``F.embedding``,
    whose gradient on the card adds a row's repeats in a fixed order
    (``index_select``'s adds them by atomics, and two runs of a table
    with few rows, SRL's marks, differ in their last bits)."""
    w, ids = _x(ins, "W"), _x(ins, "Ids").long()
    out = torch.nn.functional.embedding(ids, w.reshape(w.shape[0], -1)) \
        .reshape(tuple(ids.shape) + tuple(w.shape[1:]))
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


# --------------------------------------------------------------------------
# the 2.0 surface (paddle.tensor): indexing, broadcasting, creation
# --------------------------------------------------------------------------
register_op("reshape", lambda ins, a, c: {"Out": [_x(ins).reshape(
    [_x(ins).shape[i] if d == 0 else d for i, d in enumerate(a["shape"])])]})


@register_op("unstack")
def _unstack(ins, attrs, ctx):
    x = _x(ins)
    return {"Y": list(torch.unbind(x, dim=attrs.get("axis", 0)))}


@register_op("unbind")
def _unbind(ins, attrs, ctx):
    return {"Out": list(torch.unbind(_x(ins), dim=attrs.get("axis", 0)))}


@register_op("strided_slice")
def _strided_slice(ins, attrs, ctx):
    x = _x(ins, "Input")
    idx = [slice(None)] * x.ndim
    for ax, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                            attrs["strides"]):
        if st < 0:
            raise NotImplementedError("strided_slice with a negative "
                                      "stride")
        idx[ax] = slice(s, e, st)
    return {"Out": [x[tuple(idx)]]}


def _index_tuple(idx):
    """The last axis of an index tensor as a tuple of int64 index
    tensors (gather_nd / scatter_nd_add addressing)."""
    return tuple(idx.long().movedim(-1, 0))


@register_op("gather_nd", nondiff_inputs=("Index",))
def _gather_nd(ins, attrs, ctx):
    return {"Out": [_x(ins)[_index_tuple(_x(ins, "Index"))]]}


@register_op("scatter", nondiff_inputs=("Ids",))
def _scatter(ins, attrs, ctx):
    x, ids, upd = _x(ins), _x(ins, "Ids").long().reshape(-1), \
        _x(ins, "Updates")
    if attrs.get("overwrite", True):
        return {"Out": [x.index_put((ids,), upd)]}
    zeroed = x.index_put((ids,), torch.zeros_like(upd))
    return {"Out": [zeroed.index_put((ids,), upd, accumulate=True)]}


@register_op("scatter_nd_add", nondiff_inputs=("Index",))
def _scatter_nd_add(ins, attrs, ctx):
    x, idx, upd = _x(ins), _x(ins, "Index"), _x(ins, "Updates")
    return {"Out": [x.index_put(_index_tuple(idx), upd, accumulate=True)]}


@register_op("index_select", nondiff_inputs=("Index",))
def _index_select(ins, attrs, ctx):
    return {"Out": [_x(ins).index_select(attrs.get("dim", 0),
                                         _x(ins, "Index").long())]}


@register_op("index_sample", nondiff_inputs=("Index",))
def _index_sample(ins, attrs, ctx):
    return {"Out": [torch.take_along_dim(_x(ins), _x(ins, "Index").long(),
                                         dim=1)]}


@register_op("masked_select", differentiable=False)
def _masked_select(ins, attrs, ctx):
    """A dynamic output shape: eager only, as in the reference."""
    return {"Y": [_x(ins)[_x(ins, "Mask").bool()]]}


@register_op("where", nondiff_inputs=("Condition",))
def _where(ins, attrs, ctx):
    return {"Out": [torch.where(_x(ins, "Condition").bool(), _x(ins),
                                _x(ins, "Y"))]}


register_op("where_index", lambda ins, a, c:
            {"Out": [torch.nonzero(_x(ins, "Condition"))]},
            differentiable=False)


@register_op("expand")
def _expand(ins, attrs, ctx):
    return {"Out": [_x(ins).repeat(*attrs["expand_times"])]}


def _broadcast(x, shape):
    xs = (1,) * (len(shape) - x.ndim) + tuple(x.shape)
    shape = [xs[i] if d == -1 else d for i, d in enumerate(shape)]
    return x.reshape(xs).expand(shape)


@register_op("expand_v2")
def _expand_v2(ins, attrs, ctx):
    """-1 keeps the input's dim; new leading dims broadcast."""
    return {"Out": [_broadcast(_x(ins), list(attrs["shape"]))]}


@register_op("expand_as_v2")
def _expand_as_v2(ins, attrs, ctx):
    shape = attrs.get("target_shape") or list(ins["Y"][0].shape)
    return {"Out": [_broadcast(_x(ins), list(shape))]}


@register_op("tile")
def _tile(ins, attrs, ctx):
    return {"Out": [torch.tile(_x(ins), tuple(attrs["repeat_times"]))]}


@register_op("flip")
def _flip(ins, attrs, ctx):
    return {"Out": [torch.flip(_x(ins), tuple(attrs["axis"]))]}


@register_op("reverse")
def _reverse(ins, attrs, ctx):
    return {"Out": [torch.flip(_x(ins), tuple(attrs["axis"]))]}


@register_op("roll")
def _roll(ins, attrs, ctx):
    """With no axis the flattened tensor rolls, as ``jnp.roll``."""
    axis = attrs.get("axis", None)
    shifts = attrs["shifts"]
    if not axis:
        x = _x(ins)
        return {"Out": [torch.roll(x.reshape(-1), sum(shifts))
                        .reshape(x.shape)]}
    return {"Out": [torch.roll(_x(ins), tuple(shifts), tuple(axis))]}


@register_op("pad")
def _pad(ins, attrs, ctx):
    """``paddings`` is (before, after) per axis from the first;
    ``F.pad`` takes them from the last."""
    x = _x(ins)
    p = attrs["paddings"]
    flat = []
    for i in reversed(range(x.ndim)):
        flat += [p[2 * i], p[2 * i + 1]]
    return {"Out": [torch.nn.functional.pad(
        x, flat, value=attrs.get("pad_value", 0.0))]}


@register_op("assign_value", differentiable=False)
def _assign_value(ins, attrs, ctx):
    for key in ("fp32_values", "int32_values", "int64_values",
                "bool_values"):
        if attrs.get(key):
            vals = attrs[key]
            break
    else:
        vals = []
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.tensor(vals, dtype=torch.float64
                                 if key == "fp32_values" else None,
                                 device=ctx.device)
                    .reshape(attrs["shape"]).to(dtype)]}


register_op("shape", lambda ins, a, c: {"Out": [torch.tensor(
    list(ins["Input"][0].shape), dtype=torch.int32, device=c.device)]},
    differentiable=False)


@register_op("eye", differentiable=False)
def _eye(ins, attrs, ctx):
    n = attrs["num_rows"]
    m = attrs.get("num_columns") or n
    return {"Out": [torch.eye(n, m if m > 0 else n, device=ctx.device,
                              dtype=torch_dtype(attrs.get("dtype",
                                                          "float32")))]}


def _host_scalar(t):
    """A one-value tensor's value on the host (the op's output shape
    depends on it, so the host must wait for it)."""
    return t.reshape(()).item()


@register_op("linspace", differentiable=False)
def _linspace(ins, attrs, ctx):
    start, stop, num = ins["Start"][0], ins["Stop"][0], ins["Num"][0]
    return {"Out": [torch.linspace(
        _host_scalar(start), _host_scalar(stop), int(_host_scalar(num)),
        dtype=torch_dtype(attrs.get("dtype", "float32")),
        device=start.device)]}


@register_op("range", differentiable=False)
def _range(ins, attrs, ctx):
    s, e, st = ins["Start"][0], ins["End"][0], ins["Step"][0]
    return {"Out": [torch.arange(_host_scalar(s), _host_scalar(e),
                                 _host_scalar(st), dtype=s.dtype,
                                 device=s.device)]}


@register_op("increment")
def _increment(ins, attrs, ctx):
    return {"Out": [_x(ins) + attrs.get("step", 1.0)]}


@register_op("diag_v2", differentiable=False)
def _diag_v2(ins, attrs, ctx):
    x = _x(ins)
    k = attrs.get("offset", 0)
    out = torch.diag(x, k)
    pad = attrs.get("padding_value", 0)
    if x.ndim == 1 and pad:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), k)
        out = torch.where(mask, out, torch.full((), pad, dtype=out.dtype,
                                                device=out.device))
    return {"Out": [out]}


@register_op("meshgrid")
def _meshgrid(ins, attrs, ctx):
    return {"Out": list(torch.meshgrid(*ins["X"], indexing="ij"))}


@register_op("tril_triu")
def _tril_triu(ins, attrs, ctx):
    f = torch.tril if attrs.get("lower", True) else torch.triu
    return {"Out": [f(_x(ins), attrs.get("diagonal", 0))]}


@register_op("shard_index", differentiable=False)
def _shard_index(ins, attrs, ctx):
    x = _x(ins)
    size = (attrs["index_num"] + attrs["nshards"] - 1) // attrs["nshards"]
    mask = torch.div(x, size, rounding_mode="floor") == attrs["shard_id"]
    return {"Out": [torch.where(mask, torch.remainder(x, size),
                                torch.full_like(x, attrs.get(
                                    "ignore_value", -1)))]}


register_op("transpose", lambda ins, a, c:
            {"Out": [_x(ins).permute(*a["axis"])]})
register_op("rank", lambda ins, a, c: {"Out": [torch.tensor(
    ins["Input"][0].ndim, dtype=torch.int32, device=c.device)]},
    differentiable=False)


def _pad_index(n, lo, hi, mode, device):
    """The source index of each position of one axis padded by (lo, hi):
    numpy's ``reflect`` (a triangle wave of period ``2(n - 1)``, so pads
    at or past the side reflect again), ``edge`` (clamped) or ``wrap``
    (periodic), as ``jnp.pad`` gives them."""
    j = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or (mode == "reflect" and n == 1):
        return torch.clamp(j, 0, n - 1)
    if mode == "wrap":
        return torch.remainder(j, n)
    j = torch.remainder(j, 2 * (n - 1))
    return torch.where(j >= n, 2 * (n - 1) - j, j)


def _pad_axis(x, dim, lo, hi, mode):
    """One axis padded by slices of itself: reflected (``flip``), its edge
    repeated (``expand``) or wrapped, then concatenated.  Their backward
    is slicing and sums, deterministic on the card, where torch's own
    reflect and replicate pads add their gradients by atomics; a pad past
    what the slices can give gathers by ``_pad_index``."""
    n = x.shape[dim]
    if (mode == "reflect" and max(lo, hi) >= n) or \
            (mode == "wrap" and max(lo, hi) > n):
        return torch.index_select(x, dim,
                                  _pad_index(n, lo, hi, mode, x.device))
    parts = []
    if lo:
        if mode == "reflect":
            parts.append(x.narrow(dim, 1, lo).flip(dim))
        elif mode == "edge":
            parts.append(x.narrow(dim, 0, 1).expand(
                *[lo if d == dim else -1 for d in range(x.ndim)]))
        else:
            parts.append(x.narrow(dim, n - lo, lo))
    parts.append(x)
    if hi:
        if mode == "reflect":
            parts.append(x.narrow(dim, n - 1 - hi, hi).flip(dim))
        elif mode == "edge":
            parts.append(x.narrow(dim, n - 1, 1).expand(
                *[hi if d == dim else -1 for d in range(x.ndim)]))
        else:
            parts.append(x.narrow(dim, 0, hi))
    return torch.cat(parts, dim) if len(parts) > 1 else x


def _pad_spatial(x, pads, mode, value):
    """Pad the trailing ``len(pads)`` axes of x by ``[(lo, hi), ...]``:
    constant by ``F.pad``, ``reflect``, ``edge`` and ``wrap`` axis by axis
    (``_pad_axis``)."""
    if mode == "constant":
        return torch.nn.functional.pad(
            x, [v for lo, hi in reversed(pads) for v in (lo, hi)],
            value=value)
    first = x.ndim - len(pads)
    for k, (lo, hi) in enumerate(pads):
        x = _pad_axis(x, first + k, lo, hi, mode)
    return x


@register_op("pad2d")
def _pad2d(ins, attrs, ctx):
    """``paddings`` ``[top, bottom, left, right]`` of NCHW or NHWC,
    ``constant`` (``pad_value``), ``reflect`` or ``edge``.  A reflect pad
    at or past the side reflects again, as ``jnp.pad`` does (torch's
    ``F.pad`` refuses it)."""
    x = _x(ins)
    p = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    nhwc = attrs.get("data_format", "NCHW") != "NCHW"
    xc = x.permute(0, 3, 1, 2) if nhwc else x
    out = _pad_spatial(xc, [(p[0], p[1]), (p[2], p[3])], mode,
                       attrs.get("pad_value", 0.0))
    return {"Out": [out.permute(0, 2, 3, 1) if nhwc else out]}


@register_op("pad3d")
def _pad3d(ins, attrs, ctx):
    """``paddings`` ``[left, right, top, bottom, front, back]`` of NCDHW
    or NDHWC, ``constant`` (``value``), ``reflect``, ``replicate`` or
    ``circular``."""
    x = _x(ins)
    p = attrs["paddings"]
    ndhwc = attrs.get("data_format", "NCDHW") != "NCDHW"
    xc = x.permute(0, 4, 1, 2, 3) if ndhwc else x
    mode = {"constant": "constant", "reflect": "reflect",
            "replicate": "edge", "circular": "wrap"}[
        attrs.get("mode", "constant")]
    out = _pad_spatial(xc, [(p[4], p[5]), (p[2], p[3]), (p[0], p[1])],
                       mode, attrs.get("value", 0.0))
    return {"Out": [out.permute(0, 2, 3, 4, 1) if ndhwc else out]}


@register_op("pixel_shuffle")
def _pixel_shuffle(ins, attrs, ctx):
    """``[N, C·r², H, W]`` to ``[N, C, H·r, W·r]`` (NCHW whatever
    ``data_format`` says, as the reference)."""
    x = _x(ins)
    r = attrs["upscale_factor"]
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": [x.reshape(n, c // (r * r), h * r, w * r)]}


@register_op("unfold")
def _unfold(ins, attrs, ctx):
    """im2col: ``[N, C·kh·kw, L]`` (channel-major columns), ``paddings``
    ``[top, left, bottom, right]`` or 2 symmetric."""
    x = _x(ins)
    pd = list(attrs.get("paddings", [0, 0, 0, 0]))
    top, left = pd[0], pd[1]
    bottom = pd[2] if len(pd) > 2 else pd[0]
    right = pd[3] if len(pd) > 3 else pd[1]
    x = torch.nn.functional.pad(x, [left, right, top, bottom])
    return {"Y": [torch.nn.functional.unfold(
        x, list(attrs["kernel_sizes"]),
        dilation=list(attrs.get("dilations", [1, 1])),
        stride=list(attrs.get("strides", [1, 1])))]}


# --- the remainder (reference manipulation.py :81, :94, :384, :448-512) ------
@register_op("squeeze")
def _squeeze(ins, attrs, ctx):
    """The v1 op: drop the listed axes, which must have size 1 (every
    size-1 axis when none is listed)."""
    x = _x(ins)
    axes = [a % x.ndim for a in attrs.get("axes") or []]
    if any(x.shape[a] != 1 for a in axes):
        raise ValueError(f"squeeze: axes {axes} of shape {tuple(x.shape)} "
                         f"are not all of size 1")
    axes = axes or [i for i, d in enumerate(x.shape) if d == 1]
    return {"Out": [x.reshape([d for i, d in enumerate(x.shape)
                               if i not in axes])]}


@register_op("unsqueeze")
def _unsqueeze(ins, attrs, ctx):
    """The v1 op: each listed axis is an axis of the output."""
    x = _x(ins)
    nd = x.ndim + len(attrs["axes"])
    out = x
    for ax in sorted(a % nd for a in attrs["axes"]):
        out = out.unsqueeze(ax)
    return {"Out": [out]}


@register_op("size", differentiable=False)
def _size(ins, attrs, ctx):
    x = ins["Input"][0]
    return {"Out": [torch.tensor(x.numel(), dtype=torch.int64,
                                 device=x.device)]}


@register_op("diag_embed")
def _diag_embed(ins, attrs, ctx):
    """Each last-axis vector on a matrix's diagonal; a 1-d input takes
    ``offset`` (a batched one reads none, nor ``dim1``/``dim2``, as in
    the reference)."""
    x = _x(ins, "Input")
    if x.ndim > 1:
        return {"Out": [torch.diag_embed(x)]}
    return {"Out": [torch.diag(x, attrs.get("offset", 0))]}


@register_op("space_to_depth")
def _space_to_depth(ins, attrs, ctx):
    """[N, C, H, W] -> [N, C·b·b, H/b, W/b], the channel index
    (row offset · b + column offset) · C + c, as the reference orders it."""
    x = _x(ins)
    b = attrs["blocksize"]
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [x.reshape(n, c * b * b, h // b, w // b)]}


@register_op("unique_with_counts", differentiable=False)
def _unique_with_counts(ins, attrs, ctx):
    """The sorted unique values of the input, each element's index among
    them (in the input's shape) and each unique value's count."""
    u, idx, counts = torch.unique(_x(ins), sorted=True,
                                  return_inverse=True, return_counts=True)
    return {"Out": [u], "Index": [idx], "Count": [counts]}
