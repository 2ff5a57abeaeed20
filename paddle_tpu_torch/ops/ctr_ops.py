"""CTR ops (counterpart of ``paddle_tpu/ops/ctr_ops.py``, the fused
sparse embedding and the parameter-server pulls and pushes the BoxPS
tier runs, ``pull_box_sparse`` among them; the rest of that module comes
with the op-catalog slice).

``fused_embedding_pool`` is what the ``fuse_sparse_embedding`` pass
(fluid/passes/kernel_tier.py) makes of a ``lookup_table[_v2]`` →
``sequence_pool`` / ``reduce_sum`` chain: ``out[i] = Σ_j W[ids[i,j]] ·
wgt[i,j]``, where one ``[B, S]`` weight folds ``padding_idx``, the
``Length`` mask and AVERAGE's divisor; a SUM pool with neither mask has
no weight (``None``: every weight 1), so such a slot runs its kernel
and nothing else.  Its custom gradient is one
weighted scatter-add, ``dW[ids[i,j]] += g[i] · wgt[i,j]`` in (i, j)
order, into a dense ``[V, D]`` dW.

Dispatch, forward and gradient alike:

* a CPU tensor (and a ``meta`` tensor during shape inference) takes the
  plain version (``_reference_embedding_pool``,
  ``_reference_embedding_pool_grad``).  It keeps the unfused chain's
  elementwise structure (gather, zero the padding rows, ``sum(rows ·
  wgt, dim=1)``; ``index_add_`` of ``g · wgt``), so the rewrite is
  bit-identical to the unrewritten program on the host for SUM pooling;
* a CUDA tensor launches the hand-written Hopper kernel
  (``cuda_kernels.embedding_pool_fwd`` / ``embedding_pool_grad``) or
  raises.  The only shapes kept off the kernel are those that are no
  pool at all: W not 2-d, or no ids per row.  The reference's lane
  (D % 128) and VMEM gates are the TPU's layout, not the op's meaning,
  and are not carried over.

With grad off (serving, and every ``Executor.run``), the forward goes
through the dispatcher op ``paddle_tpu_torch::embedding_pool_fwd``, whose
host implementation is the plain version and whose CUDA implementation
launches the kernel: an exported graph (``torch.export``, the AOT
artifact of inference/aot.py) holds the op and so the kernel.
"""
from __future__ import annotations

import torch

from . import cuda_kernels
from .registry import register_op


def _emb_pool_prep(ins, attrs):
    """(w, ids, wgt): the per-(row, position) contribution weight folds
    padding_idx zeroing, the Length mask and mean-pool division into one
    ``[B, S]`` tensor of W's dtype; None where every weight is 1 (SUM
    with neither mask), which x · 1 = x makes the same sums."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if attrs.get("squeeze_ids") and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])   # lookup_table's [.., 1] ids
    b, s = ids.shape
    pool = str(attrs.get("pooltype", "SUM")).upper()
    padding_idx = attrs.get("padding_idx", -1)
    length = ins["Length"][0] if ins.get("Length") else None
    wgt = None
    if length is not None:
        pos = torch.arange(s, device=ids.device)
        wgt = (pos[None, :] < length.reshape(-1, 1)).to(w.dtype)
    if padding_idx is not None and padding_idx >= 0:
        keep = (ids != padding_idx).to(w.dtype)
        wgt = keep if wgt is None else wgt * keep
    if pool == "AVERAGE":
        if length is not None:
            denom = torch.clamp(length.reshape(-1, 1).to(w.dtype), min=1)
        else:
            denom = torch.full((b, 1), float(s), dtype=w.dtype,
                               device=w.device)
        if wgt is None:
            wgt = torch.ones((b, s), dtype=w.dtype, device=w.device)
        wgt = wgt / denom
    return w, ids, wgt


def _on_kernel(w, ids):
    """A CUDA table whose op is a pool: 2-d W, ids per row."""
    return w.device.type == "cuda" and w.ndim == 2 and ids.shape[1] > 0


def _reference_embedding_pool(w, ids, wgt, padding_idx=-1):
    """Plain version of the forward kernel, the unfused chain's
    elementwise structure: gather, zero the padding rows, ``sum(rows ·
    wgt, dim=1)`` (``sum(rows, dim=1)`` for a None wgt)."""
    gathered = w.index_select(0, ids.reshape(-1).long()).reshape(
        tuple(ids.shape) + tuple(w.shape[1:]))
    if padding_idx is not None and padding_idx >= 0:
        gathered = gathered.masked_fill((ids == padding_idx)[..., None],
                                        0.0)
    if wgt is None:
        return torch.sum(gathered, dim=1)
    return torch.sum(gathered * wgt[..., None], dim=1)


# The forward kernel's launch as a dispatcher op, as the flash forward's
# (ops/attention.py): export traces on fake tensors, which have no data
# pointer for a ctypes launch.  Its fake gives the output's shape, its
# default (host) implementation is the plain version, looked up at call
# time, and its CUDA implementation launches the kernel.
@torch.library.custom_op(
    "paddle_tpu_torch::embedding_pool_fwd", mutates_args=(),
    schema="(Tensor w, Tensor ids, Tensor? wgt, int padding_idx) -> Tensor")
def embedding_pool_fwd_op(w, ids, wgt, padding_idx):
    return _reference_embedding_pool(w, ids, wgt, padding_idx)


@embedding_pool_fwd_op.register_kernel("cuda")
def _embedding_pool_fwd_cuda(w, ids, wgt, padding_idx):
    # padding_idx is folded into wgt by _emb_pool_prep
    return cuda_kernels.embedding_pool_fwd(w, ids, wgt)


@embedding_pool_fwd_op.register_fake
def _embedding_pool_fwd_fake(w, ids, wgt, padding_idx):
    return w.new_empty((ids.shape[0], w.shape[1]))


def _emb_grad_rows(g, ids, wgt):
    """The ``[B·S, D]`` per-position terms ``g[i] · wgt[i,j]`` of the
    gradient, in (i, j) order (``g[i]`` itself for a None wgt)."""
    d = g.shape[-1]
    if wgt is None:
        rows = g[:, None, :].expand(ids.shape[0], ids.shape[1], d)
    else:
        rows = g[:, None, :] * wgt[:, :, None]          # [B, S, D]
    return rows.reshape(-1, d)


def _reference_embedding_pool_grad(g, ids, wgt, vocab):
    """Plain version of the gradient kernel: ``g · wgt`` per position,
    then ``index_add_`` into a zero ``[vocab, D]`` dW (on the CPU it adds
    in index order, which is (i, j) order)."""
    d = g.shape[-1]
    rows = _emb_grad_rows(g, ids, wgt)
    dw = torch.zeros((vocab, d), dtype=g.dtype, device=g.device)
    return dw.index_add_(0, ids.reshape(-1).long(), rows)


def _fused_embedding_pool_grad(ins, outs, out_grads, attrs, ctx):
    """dW by one weighted scatter-add, never materialising the
    ``[B, S, D]`` per-position cotangent on the card."""
    w, ids, wgt = _emb_pool_prep(ins, attrs)
    g = out_grads.get("Out")
    if g is None:
        return {"W": [torch.zeros_like(w)]}
    g = g.to(w.dtype)
    if _on_kernel(w, ids):
        return {"W": [cuda_kernels.embedding_pool_grad(
            g.contiguous(), ids.long(), wgt, w.shape[0])]}
    return {"W": [_reference_embedding_pool_grad(g, ids, wgt, w.shape[0])]}


@register_op("fused_embedding_pool", nondiff_inputs=("Ids", "Length"),
             custom_grad=_fused_embedding_pool_grad)
def _fused_embedding_pool(ins, attrs, ctx):
    w, ids, wgt = _emb_pool_prep(ins, attrs)
    if not torch.is_grad_enabled() and w.ndim == 2 and ids.shape[1] > 0:
        pad = attrs.get("padding_idx", -1)
        return {"Out": [embedding_pool_fwd_op(
            w, ids.long(), wgt, -1 if pad is None else int(pad))]}
    if _on_kernel(w, ids):
        return {"Out": [cuda_kernels.embedding_pool_fwd(w, ids.long(),
                                                        wgt)]}
    return {"Out": [_reference_embedding_pool(
        w, ids, wgt, attrs.get("padding_idx", -1))]}


# --- sparse PS pull/push (the device halves) --------------------------------
def _scatter_rows(g, ids, shape):
    """``dW[ids[k]] += g[k]`` into a zero ``shape`` table, summed in a
    fixed order on every device: a stable sort of the ids, one segment
    sum per unique id in (i, j) order, one write per unique row.  The
    same bits on every run, as the reference's pipelined-equals-serial
    pass contract needs; PyTorch's own accumulation into repeated rows
    (``index_put_``/``index_add_``) is not run-to-run stable on the
    host's threads or with the card's atomics."""
    d = shape[-1]
    flat = ids.reshape(-1).long()
    rows = g.reshape(-1, d)
    sorted_ids, perm = torch.sort(flat, stable=True)
    uniq, counts = torch.unique_consecutive(sorted_ids, return_counts=True)
    sums = torch.segment_reduce(rows.index_select(0, perm), "sum",
                                lengths=counts, axis=0)
    dw = torch.zeros(shape, dtype=g.dtype, device=g.device)
    dw[uniq] = sums
    return dw


class _GatherRows(torch.autograd.Function):
    """``W[ids]`` whose gradient is :func:`_scatter_rows`.  Forward and
    ``setup_context`` apart, so ``torch.func.vjp`` (generic_grad) runs
    it."""

    @staticmethod
    def forward(w, ids):
        return w[ids]

    @staticmethod
    def setup_context(ctx, inputs, output):
        w, ids = inputs
        ctx.save_for_backward(ids)
        ctx.w_shape = tuple(w.shape)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return _scatter_rows(g, ids, ctx.w_shape), None


def _rows_of(w, ids_list):
    """One gather of W's rows per id tensor; the ids the program sees are
    cache slots, kept int64."""
    return [_GatherRows.apply(w, ids.long()) for ids in ids_list]


@register_op("pull_box_sparse", nondiff_inputs=("Ids",))
def _pull_box_sparse(ins, attrs, ctx):
    """pull_box_sparse_op.cc device half: the rows of the pass's device
    cache (distributed/ps/box.py) for each id tensor.  Its gradient is
    ``generic_grad``'s vjp, a scatter-add into a dense zero cache
    (:func:`_scatter_rows`)."""
    return {"Out": _rows_of(ins["W"][0], ins["Ids"])}


@register_op("push_box_sparse", differentiable=False)
def _push_box_sparse(ins, attrs, ctx):
    """Grad side of pull_box_sparse: scatter-add each Grad into a zero
    table of W's shape and dtype; returns that dense delta."""
    w = ins["W"][0]
    delta = torch.zeros_like(w)
    for ids, g in zip(ins["Ids"], ins["Grad"]):
        delta = delta + _scatter_rows(g.to(w.dtype), ids, w.shape)
    return {"Out": [delta]}


@register_op("pull_sparse", nondiff_inputs=("Ids",))
def _pull_sparse(ins, attrs, ctx):
    return {"Out": _rows_of(ins["W"][0], ins["Ids"])}


@register_op("push_dense", differentiable=False)
def _push_dense(ins, attrs, ctx):
    """push_dense_op: the device half is the identity; the trainer ships
    the gradients to the parameter server after the step."""
    return {"Out": list(ins["Ids"]) if ins.get("Ids") else [ins["X"][0]]}
