"""Plumbing lowerings (counterpart of ``paddle_tpu/ops/plumbing_ops.py``:
``is_empty``, the tensor arrays, the rank table, ``print`` and
``assert``)."""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("is_empty", differentiable=False)
def _is_empty(ins, attrs, ctx):
    x = ins["X"][0]
    return {"Out": [torch.tensor(x.numel() == 0, device=x.device)]}


# ---------------------------------------------------------------------------
# tensor arrays: a Python list of tensors in the executor's env.  The
# index is read on the host where the op runs (the values are concrete
# here; the TPU package folds constant index chains at trace time).
# ---------------------------------------------------------------------------

def _index(i) -> int:
    return int(i.reshape(-1)[0].item())


@register_op("write_to_array", differentiable=False)
def _write_to_array(ins, attrs, ctx):
    """Out = Array with X at I; positions past the end up to I are
    filled with None, as the reference's list grows."""
    x, i = ins["X"][0], ins["I"][0]
    arr = list(ins["Array"][0]) if ins.get("Array") else []
    idx = _index(i)
    if idx < 0:
        raise IndexError(f"write_to_array: index {idx} is negative")
    while len(arr) <= idx:
        arr.append(None)
    arr[idx] = x
    return {"Out": [arr]}


@register_op("read_from_array", differentiable=False)
def _read_from_array(ins, attrs, ctx):
    arr = ins["X"][0]
    idx = _index(ins["I"][0])
    if not 0 <= idx < len(arr) or arr[idx] is None:
        raise IndexError(f"read_from_array: index {idx} out of range for "
                         f"an array of {len(arr)} written entries")
    return {"Out": [arr[idx]]}


@register_op("lod_array_length", differentiable=False)
def _lod_array_length(ins, attrs, ctx):
    return {"Out": [torch.tensor([len(ins["X"][0])], dtype=torch.int64,
                                 device=ctx.device)]}


@register_op("lod_rank_table", differentiable=False)
def _lod_rank_table(ins, attrs, ctx):
    """The rank table in the padded layout: every row has the full
    length, so the table is (lengths, original indices)."""
    x = ins["X"][0]
    n = x.shape[0]
    t = x.shape[1] if x.ndim > 1 else 1
    return {"Out": [{"lengths": torch.full((n,), t, dtype=torch.int64,
                                           device=x.device),
                     "index": torch.arange(n, device=x.device)}]}


@register_op("reorder_lod_tensor_by_rank", differentiable=False)
def _reorder_lod_tensor_by_rank(ins, attrs, ctx):
    x, table = ins["X"][0], ins["RankTable"][0]
    return {"Out": [torch.index_select(x, 0, table["index"])]}


# ---------------------------------------------------------------------------
# print and assert: host effects, so each reads its tensor on the host
# ---------------------------------------------------------------------------

@register_op("print")
def _print(ins, attrs, ctx):
    """Identity, printing the message and the first ``summarize``
    values."""
    x = ins["In"][0]
    n = max(attrs.get("summarize", 20), 1)
    if x.device.type != "meta":
        print(attrs.get("message", ""),
              x.detach().reshape(-1)[:n].cpu().tolist())
    return {"Out": [x]}


@register_op("assert", differentiable=False)
def _assert(ins, attrs, ctx):
    cond = ins["Cond"][0]
    if cond.device.type != "meta" and not bool(cond.reshape(-1)[0].item()):
        raise AssertionError(
            f"Assert op failed: {attrs.get('summarize', '')}")
    return {}
