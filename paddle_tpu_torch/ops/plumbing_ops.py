"""Plumbing lowerings (counterpart of ``paddle_tpu/ops/plumbing_ops.py``):
the tensor arrays and the LoD ops in the padded layout, the rank table,
``print`` and ``assert``, ``empty``/``fill``/``fake_init``/``delete_var``,
the file ops (``save``, ``save_combine``, ``load``, ``load_combine``),
the queues, the copy and selected-rows ops,
``uniform_random_batch_size_like`` and the sparse-table ops.

The file, queue and sparse-table ops are host effects.  Every tensor
such an op copies between the card and the host adds one to
``HOST_COPIES`` ("to_host" or "to_card"); a tensor already on the host
crosses nothing and counts nothing.  On the ``meta`` device (shape
inference at build time) they do nothing.
"""
from __future__ import annotations

import os
import queue

import numpy as np
import torch

from ..fluid.framework import torch_dtype
from .registry import register_op

HOST_COPIES = {"to_host": 0, "to_card": 0}


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy view of ``t`` on the host, counting a copy off the card."""
    if t.device.type != "cpu":
        HOST_COPIES["to_host"] += 1
    return t.detach().cpu().numpy()


def _to_card(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a tensor on ``device``, counting a copy onto the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cpu":
        HOST_COPIES["to_card"] += 1
    return t.to(device)


def _meta(*ts) -> bool:
    return any(t.device.type == "meta" for t in ts)


@register_op("is_empty", differentiable=False)
def _is_empty(ins, attrs, ctx):
    x = ins["X"][0]
    return {"Out": [torch.tensor(x.numel() == 0, device=x.device)]}


# ---------------------------------------------------------------------------
# tensor arrays: a Python list of tensors in the executor's env.  The
# index is read on the host where the op runs (the values are concrete
# here; the TPU package folds constant index chains at trace time).
# ---------------------------------------------------------------------------

def _index(i, attrs=None) -> int:
    """The array index in ``i``, or the ``__index__`` attribute a
    program folded it into."""
    if attrs is not None and "__index__" in attrs:
        return int(attrs["__index__"])
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


@register_op("array_to_lod_tensor", differentiable=False)
def _array_to_lod_tensor(ins, attrs, ctx):
    """The written entries concatenated on axis 0 (a 0-d entry as one
    row)."""
    arr = [a for a in ins["X"][0] if a is not None]
    return {"Out": [torch.cat([torch.atleast_1d(a) for a in arr], dim=0)]}


@register_op("lod_tensor_to_array", differentiable=False)
def _lod_tensor_to_array(ins, attrs, ctx):
    """The padded layout's reading: one entry a row of X."""
    x = ins["X"][0]
    return {"Out": [[x[i] for i in range(x.shape[0])]]}


@register_op("tensor_array_to_tensor", differentiable=False)
def _tensor_array_to_tensor(ins, attrs, ctx):
    """The written entries stacked (``use_stack``) or concatenated on
    ``axis``; OutIndex holds each entry's extent on that axis (1 for a
    0-d entry)."""
    arr = [a for a in ins["X"][0] if a is not None]
    axis = attrs.get("axis", 0)
    if attrs.get("use_stack", False):
        out = torch.stack(arr, dim=axis)
    else:
        out = torch.cat([torch.atleast_1d(a) for a in arr], dim=axis)
    idx = torch.tensor([a.shape[axis] if a.ndim else 1 for a in arr],
                       dtype=torch.int64, device=out.device)
    return {"Out": [out], "OutIndex": [idx]}


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


@register_op("max_sequence_len", differentiable=False)
def _max_sequence_len(ins, attrs, ctx):
    return {"Out": [torch.max(ins["RankTable"][0]["lengths"]).reshape(1)]}


@register_op("reorder_lod_tensor_by_rank", differentiable=False)
def _reorder_lod_tensor_by_rank(ins, attrs, ctx):
    x, table = ins["X"][0], ins["RankTable"][0]
    return {"Out": [torch.index_select(x, 0, table["index"])]}


@register_op("shrink_rnn_memory", nondiff_inputs=("I", "RankTable"))
def _shrink_rnn_memory(ins, attrs, ctx):
    """The first k rows of X, k the rows still active at step I (at least
    one; the rank table sorts rows by descending length)."""
    x, table = ins["X"][0], ins["RankTable"][0]
    step = _index(ins["I"][0], attrs)
    active = int((table["lengths"] > step).sum().item())
    return {"Out": [x[:max(active, 1)]]}


def _row_mask(mask, like):
    """Mask [N] (or [N, 1]) as a bool broadcastable over ``like``'s rows."""
    m = mask.reshape(-1).to(torch.bool)
    return m.reshape((like.shape[0],) + (1,) * (like.ndim - 1))


@register_op("split_lod_tensor", nondiff_inputs=("Mask",))
def _split_lod_tensor(ins, attrs, ctx):
    """IfElse's split in the padded layout: both branches get the whole
    batch, the rows the other branch takes zeroed."""
    x = ins["X"][0]
    m = _row_mask(ins["Mask"][0], x)
    zero = torch.zeros_like(x)
    return {"OutTrue": [torch.where(m, x, zero)],
            "OutFalse": [torch.where(m, zero, x)]}


@register_op("merge_lod_tensor", nondiff_inputs=("Mask",))
def _merge_lod_tensor(ins, attrs, ctx):
    t, f = ins["InTrue"][0], ins["InFalse"][0]
    return {"Out": [torch.where(_row_mask(ins["Mask"][0], t), t, f)]}


@register_op("rnn_memory_helper")
def _rnn_memory_helper(ins, attrs, ctx):
    return {"Out": [ins["X"][0]]}


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


# ---------------------------------------------------------------------------
# creation and lifetime
# ---------------------------------------------------------------------------

def _attr_dtype(attrs):
    d = attrs.get("dtype", "float32")
    return torch_dtype(d if d not in (None, -1) else "float32")


@register_op("empty", differentiable=False)
def _empty(ins, attrs, ctx):
    """Zeros of ``shape`` and ``dtype`` (the reference fills them too)."""
    return {"Out": [torch.zeros(tuple(attrs.get("shape", [])),
                                dtype=_attr_dtype(attrs),
                                device=ctx.device)]}


@register_op("fill", differentiable=False)
def _fill(ins, attrs, ctx):
    """The ``value`` list as ``dtype``, reshaped to ``shape``."""
    vals = torch.tensor(list(attrs.get("value", [])),
                        dtype=_attr_dtype(attrs), device=ctx.device)
    return {"Out": [vals.reshape(tuple(attrs.get("shape",
                                                 list(vals.shape))))]}


@register_op("fake_init", differentiable=False)
def _fake_init(ins, attrs, ctx):
    return {"Out": [torch.zeros(tuple(attrs.get("shape", [1])),
                                dtype=torch.float32, device=ctx.device)]}


@register_op("delete_var", differentiable=False)
def _delete_var(ins, attrs, ctx):
    """Nothing, as in the reference: the executor's env drops a var at
    the end of the run and the scope keeps what it keeps."""
    return {}


# ---------------------------------------------------------------------------
# save and load: one ``np.savez`` file, the arrays by position in X's
# order, ``.npz`` appended to a path without it (the reference's format,
# so either package reads the other's files)
# ---------------------------------------------------------------------------

def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _save_arrays(path, xs):
    if _meta(*xs):
        return
    arrays = [_to_host(x) for x in xs]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(_npz_path(path), *arrays)


@register_op("save", differentiable=False)
def _save(ins, attrs, ctx):
    _save_arrays(attrs["file_path"], [ins["X"][0]])
    return {}


@register_op("save_combine", differentiable=False)
def _save_combine(ins, attrs, ctx):
    _save_arrays(attrs["file_path"], list(ins["X"]))
    return {}


def _load_arrays(path, device, first_only=False):
    """The file's arrays in its order, each on ``device``.  The file is
    read on every run, so a run after a save sees the new values; a
    missing file raises."""
    with np.load(_npz_path(path)) as f:
        names = f.files[:1] if first_only else f.files
        return [_to_card(f[n], device) for n in names]


@register_op("load", differentiable=False)
def _load(ins, attrs, ctx):
    if ctx.device.type == "meta":
        return {}
    return {"Out": _load_arrays(attrs["file_path"], ctx.device, True)}


@register_op("load_combine", differentiable=False)
def _load_combine(ins, attrs, ctx):
    if ctx.device.type == "meta":
        return {}
    return {"Out": _load_arrays(attrs["file_path"], ctx.device)}


# ---------------------------------------------------------------------------
# queues (a pipeline's section plumbing): a registry of host queues
# ---------------------------------------------------------------------------

_QUEUES = {}


@register_op("queue_generator", differentiable=False)
def _queue_generator(ins, attrs, ctx):
    for name in attrs.get("names", []):
        _QUEUES.setdefault(name, queue.Queue(
            maxsize=attrs.get("capacity", 64)))
    return {}


@register_op("enqueue", differentiable=False)
def _enqueue(ins, attrs, ctx):
    """Queue a snapshot of X (a copy where X lies), so that a later
    in-place update of X cannot change what was queued."""
    x = ins["X"][0]
    if not _meta(x):
        _QUEUES[attrs["queue_name"]].put(x.detach().clone())
    return {}


@register_op("dequeue", differentiable=False)
def _dequeue(ins, attrs, ctx):
    """The queue's next tensor, cast to ``dtype``, on the context's
    device; a shape other than ``shape`` raises."""
    if ctx.device.type == "meta":
        return {}
    t = _QUEUES[attrs["queue_name"]].get()
    shape = tuple(attrs["shape"])
    if tuple(t.shape) != shape:
        raise ValueError(f"dequeue: queue {attrs['queue_name']!r} gave a "
                         f"tensor of shape {tuple(t.shape)}, the op's "
                         f"shape is {shape}")
    return {"Out": [t.to(device=ctx.device, dtype=_attr_dtype(attrs))]}


# ---------------------------------------------------------------------------
# copies, coalescing and the selected-rows ops.  Gradients are dense
# here, so a SelectedRows value never exists: these are the dense
# equivalents.  The memcpy family keeps X where it lies (the executor
# runs every op on its one device).
# ---------------------------------------------------------------------------

@register_op("memcpy")
def _memcpy(ins, attrs, ctx):
    return {"Out": [ins["X"][0]]}


@register_op("memcpy_h2d")
def _memcpy_h2d(ins, attrs, ctx):
    return {"Out": [ins["X"][0]]}


@register_op("memcpy_d2h")
def _memcpy_d2h(ins, attrs, ctx):
    return {"Out": [ins["X"][0]]}


@register_op("coalesce_tensor", differentiable=False)
def _coalesce_tensor(ins, attrs, ctx):
    """The gradient-fusion buffer: Output is the inputs themselves,
    FusedOutput one float32 concatenation of them flattened."""
    xs = list(ins.get("Input", []))
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in xs]) if xs \
        else torch.zeros((0,), dtype=torch.float32, device=ctx.device)
    return {"Output": xs, "FusedOutput": [flat]}


@register_op("merge_selected_rows")
def _merge_selected_rows(ins, attrs, ctx):
    return {"Out": [ins["X"][0]]}      # dense grads arrive merged


@register_op("get_tensor_from_selected_rows")
def _get_tensor_from_selected_rows(ins, attrs, ctx):
    return {"Out": [ins["X"][0]]}


@register_op("split_selected_rows", differentiable=False)
def _split_selected_rows(ins, attrs, ctx):
    """Row blocks of ``height_sections``, else ``num`` equal blocks."""
    x = ins["X"][0]
    sections = attrs.get("height_sections", [])
    if not sections:
        n = attrs.get("num", 1)
        sections = [x.shape[0] // n] * n
    outs, start = [], 0
    for s in sections:
        outs.append(x[start:start + s])
        start += s
    return {"Out": outs}


@register_op("slice_multi_tensor", differentiable=False)
def _slice_multi_tensor(ins, attrs, ctx):
    start, end = attrs.get("begin", 0), attrs.get("end", None)
    return {"Out": [x[start:end] for x in ins["X"]]}


@register_op("split_ids", differentiable=False)
def _split_ids(ins, attrs, ctx):
    """The ids of each parameter-server shard (id mod ``num``), in their
    order, padded with -1 to the length of Ids."""
    ids = ins["Ids"][0].reshape(-1)
    n = int(attrs.get("num", 1)) or 1
    outs = []
    for s in range(n):
        pick = ids[ids % n == s]
        out = torch.full_like(ids, -1)
        out[:pick.shape[0]] = pick
        outs.append(out)
    return {"Out": outs}


@register_op("uniform_random_batch_size_like", differentiable=False,
             stateful_rng=True)
def _uniform_random_batch_size_like(ins, attrs, ctx):
    """U[min, max) float32 of ``shape`` with dim ``input_dim_idx`` taken
    from Input's same dim (the reference reads ``input_dim_idx`` on both
    sides and never ``output_dim_idx``)."""
    x = ins["Input"][0]
    k = attrs.get("input_dim_idx", 0)
    shape = list(attrs.get("shape", list(x.shape)))
    shape[k] = x.shape[k]
    gen = ctx.key_for(attrs.get("op_seed", attrs.get("seed", 0)))
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(tuple(shape), generator=gen, device=ctx.device,
                   dtype=torch.float32)
    return {"Out": [u * (hi - lo) + lo]}


# ---------------------------------------------------------------------------
# the sparse tables of the parameter-server tier: a registry of host
# tables (distributed/ps/table.py); rows cross to and from the card by
# counted copies
# ---------------------------------------------------------------------------

_SPARSE_TABLES = {}


def _get_table(name, dim, optimizer="sgd", lr=1.0):
    """The table ``name``, made with zero rows on first use.  A later call
    does not change its optimizer or learning rate, as in the
    reference."""
    from ..distributed.ps.table import CommonSparseTable, Initializer
    if name not in _SPARSE_TABLES:
        _SPARSE_TABLES[name] = CommonSparseTable(
            dim, optimizer, lr, initializer=Initializer("zeros"))
    return _SPARSE_TABLES[name]


def _pull_rows(name, dim, ids, device):
    """The rows of ``ids`` (flattened) as a float32 [N, dim] on
    ``device``."""
    rows = _get_table(name, dim).pull(_to_host(ids).reshape(-1))
    return _to_card(rows.astype(np.float32), device)


@register_op("lookup_sparse_table_init", differentiable=False)
def _lookup_sparse_table_init(ins, attrs, ctx):
    if ctx.device.type != "meta":
        _get_table(attrs["table_name"],
                   attrs.get("dim", attrs.get("embedding_dim", 8)),
                   attrs.get("optimizer", "sgd"), attrs.get("lr", 1.0))
    return {}


@register_op("lookup_sparse_table_read", differentiable=False)
def _lookup_sparse_table_read(ins, attrs, ctx):
    ids = ins["Ids"][0]
    if _meta(ids):
        return {}
    return {"Out": [_pull_rows(attrs["table_name"], attrs["dim"], ids,
                               ctx.device)]}


@register_op("lookup_sparse_table_write", differentiable=False)
def _lookup_sparse_table_write(ins, attrs, ctx):
    """Set the rows of Ids to Value: ``push_delta(Value - pull)``, so a
    repeated id's deltas add, as in the reference."""
    ids, vals = ins["Ids"][0], ins["Value"][0]
    if _meta(ids, vals):
        return {}
    t = _get_table(attrs["table_name"], int(vals.shape[-1]))
    i = _to_host(ids).reshape(-1)
    v = _to_host(vals).reshape(len(i), -1)
    t.push_delta(i, v - t.pull(i))
    return {}


@register_op("distributed_lookup_table", differentiable=False)
def _distributed_lookup_table(ins, attrs, ctx):
    """Pull embedding rows from the parameter-server tier
    (distributed_lookup_table_op.cc) out of the in-process table: Out and
    Outputs of shape Ids.shape + [dim]."""
    ids = ins["Ids"][0]
    if _meta(ids):
        return {}
    name = attrs.get("table_name", attrs.get("table_names", ["emb"])[0]
                     if attrs.get("table_names") else "emb")
    dim = attrs.get("dim", attrs.get("emb_dim", 8))
    rows = _pull_rows(name, dim, ids, ctx.device).reshape(
        tuple(ids.shape) + (dim,))
    return {"Outputs": [rows], "Out": [rows]}
