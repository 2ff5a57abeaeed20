"""Sequence ops beyond ``sequence_pool`` (counterpart of
``paddle_tpu/ops/sequence_extra.py``): ``sequence_conv``,
``sequence_expand_as``, ``sequence_pad``, ``sequence_unpad``,
``sequence_slice``, ``sequence_erase``, ``sequence_enumerate`` and
``sequence_scatter``.

The padded convention of ``fluid/layers/sequence_lod.py``: a batch of
sequences is ``[B, T, D]`` plus a ``Length`` [B]; a ragged output is a
padded tensor with its lengths, not a LoD.
"""
from __future__ import annotations

import torch

from .registry import register_op


def _mask(length, t, ndim=2):
    """[B, T] (then 1s up to ``ndim`` dims): position < the row's length."""
    m = torch.arange(t, device=length.device)[None, :] \
        < length.reshape(-1, 1)
    return m.reshape(m.shape + (1,) * (ndim - 2))


@register_op("sequence_conv", nondiff_inputs=("Length", "PaddingData"))
def _sequence_conv(ins, attrs, ctx):
    """sequence_conv_op.cc: each step's window of ``contextLength`` rows
    from ``contextStart`` on (zeros past either end), rows past the
    length zeroed, contracted with ``Filter`` [ctx · D, out]."""
    x, filt = ins["X"][0], ins["Filter"][0]                 # [B, T, D]
    start = attrs.get("contextStart", -1)
    b, t, d = x.shape
    cols = []
    for k in range(attrs.get("contextLength", 3)):
        off = start + k
        if abs(off) >= t:
            cols.append(torch.zeros_like(x))
        elif off < 0:
            cols.append(torch.cat([x.new_zeros((b, -off, d)), x[:, :t + off]],
                                  dim=1))
        elif off > 0:
            cols.append(torch.cat([x[:, off:], x.new_zeros((b, off, d))],
                                  dim=1))
        else:
            cols.append(x)
    rows = torch.cat(cols, dim=-1)                          # [B, T, ctx·D]
    if ins.get("Length"):
        rows = rows * _mask(ins["Length"][0], t, 3).to(x.dtype)
    return {"Out": [rows @ filt]}


@register_op("sequence_expand_as", nondiff_inputs=("Y", "Length"))
def _sequence_expand_as(ins, attrs, ctx):
    """sequence_expand_as_op.cc, padded: each row of X [B, D] (or its
    first step) repeated over Y's time axis."""
    x, t = ins["X"][0], ins["Y"][0].shape[1]
    if x.ndim == 2:
        return {"Out": [x[:, None, :].expand(x.shape[0], t, x.shape[1])]}
    return {"Out": [x[:, :1].expand((x.shape[0], t) + tuple(x.shape[2:]))]}


@register_op("sequence_pad", nondiff_inputs=("PadValue", "Length"))
def _sequence_pad(ins, attrs, ctx):
    """sequence_pad_op.cc, padded: the time axis cut or extended to
    ``padded_length`` and every position past a row's length set to
    ``PadValue`` (a scalar, or one step's shape); the lengths too."""
    x = ins["X"][0]
    pad = 0.0
    if ins.get("PadValue"):
        pv = ins["PadValue"][0].to(x.dtype)
        pad = pv.reshape(()) if pv.numel() == 1 else pv
    b, t = x.shape[:2]
    length = ins["Length"][0].reshape(-1).long() if ins.get("Length") \
        else torch.full((b,), t, dtype=torch.long, device=x.device)
    target = attrs.get("padded_length", -1)
    target = t if target < 0 else target
    if target > t:
        fill = torch.zeros((b, target - t) + tuple(x.shape[2:]),
                           dtype=x.dtype, device=x.device) + pad
        x = torch.cat([x, fill], dim=1)
    else:
        x = x[:, :target]
    return {"Out": [torch.where(_mask(length, target, x.ndim), x, pad)],
            "Length": [length]}


@register_op("sequence_unpad", nondiff_inputs=("Length",))
def _sequence_unpad(ins, attrs, ctx):
    """sequence_unpad_op.cc, padded: the tensor kept, positions past each
    row's length zeroed."""
    x = ins["X"][0]
    m = _mask(ins["Length"][0], x.shape[1], x.ndim)
    return {"Out": [torch.where(m, x, 0.0)]}


@register_op("sequence_slice", nondiff_inputs=("Offset", "Length"))
def _sequence_slice(ins, attrs, ctx):
    """sequence_slice_op.cc: each row's [offset, offset + length) moved to
    the front, zeros after."""
    x = ins["X"][0]
    off = ins["Offset"][0].reshape(-1).long()
    b, t = x.shape[:2]
    idx = torch.clamp(off[:, None] + torch.arange(t, device=x.device)[None],
                      0, t - 1)
    idx = idx.reshape((b, t) + (1,) * (x.ndim - 2)).expand(x.shape)
    return {"Out": [torch.where(_mask(ins["Length"][0], t, x.ndim),
                                torch.gather(x, 1, idx), 0.0)]}


def _compact(x, keep, pad):
    """Each row's kept entries moved left in order, ``pad`` after; and
    the kept counts."""
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    vals = torch.gather(torch.where(keep, x, pad), 1, order)
    lens = keep.sum(1)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    return torch.where(pos < lens[:, None], vals, pad), lens


@register_op("sequence_erase", differentiable=False)
def _sequence_erase(ins, attrs, ctx):
    """sequence_erase_op.cc: the ids in ``tokens`` dropped, each row
    compacted left and padded with 0; the new lengths."""
    x = ins["X"][0].long()
    tokens = torch.tensor(list(attrs.get("tokens", [])), dtype=torch.long,
                          device=x.device)
    out, lens = _compact(x, ~(x[..., None] == tokens).any(-1), 0)
    return {"Out": [out], "Length": [lens]}


@register_op("sequence_enumerate", differentiable=False)
def _sequence_enumerate(ins, attrs, ctx):
    """sequence_enumerate_op.cc: each step's ``win_size``-gram of ids,
    ``pad_value`` past the end: [B, T, win]."""
    x = ins["X"][0].long()
    win = attrs.get("win_size", 2)
    b, t = x.shape[:2]
    xe = torch.cat([x, torch.full((b, win - 1), attrs.get("pad_value", 0),
                                  dtype=x.dtype, device=x.device)], dim=1)
    return {"Out": [torch.stack([xe[:, k:k + t] for k in range(win)], -1)]}


@register_op("sequence_scatter", nondiff_inputs=("Ids",))
def _sequence_scatter(ins, attrs, ctx):
    """sequence_scatter_op.cc as the reference computes it: ``Updates``
    rows (broadcast to the row width) added into X's rows at ``Ids``
    along the flattened batch-time axis; a negative id counts from the
    end and an id out of range is dropped, as XLA's scatter does."""
    x = ins["X"][0]
    ids = ins["Ids"][0].reshape(-1).long()
    flat = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(-1, 1)
    n = flat.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    keep = (ids >= 0) & (ids < n)
    upd = ins["Updates"][0].reshape(ids.shape[0], -1).to(x.dtype)
    upd = torch.where(keep[:, None], upd, 0.0).expand(-1, flat.shape[1])
    out = flat.index_add(0, torch.where(keep, ids, 0), upd)
    return {"Out": [out.reshape(x.shape)]}
