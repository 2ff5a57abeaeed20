"""CTR ops (counterpart of ``paddle_tpu/ops/ctr_ops.py``): the fused
sparse embedding, the parameter-server pulls and pushes the BoxPS tier
runs (``pull_box_sparse`` among them), and the PaddleBox CTR tier:
``cvm``, ``fused_seqpool_cvm``, ``batch_fc``, ``scaled_fc``,
``rank_attention``, ``cross_norm_hadamard``, ``filter_by_instag``,
``hash``, ``pyramid_hash``, the TDM pair, ``store_q_value``,
``merge_ids``, ``ps_lookup_rows`` and ``data_norm``.  Each keeps the
reference's reading of its inputs and attributes, what it ignores
included (``fused_seqpool_cvm`` pools by SUM whatever ``pooltype`` says,
``batch_fc`` is always ReLU, ``scaled_fc`` never reads
``grad_scale_factor``, ``filter_by_instag`` zeroes rows and never
compacts).  A gather with a gradient sums its repeats in a fixed order
on the card: ``rank_attention`` picks its blocks by a one-hot product,
``pyramid_hash`` gathers through ``_GatherRows`` (a stable sort and one
segment sum per row, as ``pull_box_sparse``'s gradient).

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
import torch.nn.functional as F

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


# --- the PaddleBox CTR tier ---------------------------------------------------
def _x(ins, slot="X"):
    return ins[slot][0]


def _cvm_fwd(x, use_cvm):
    """cvm_op.h: column 0 becomes log(show + 1), column 1 log(click + 1)
    less column 0; without use_cvm the two leading columns go."""
    if use_cvm:
        c0 = torch.log(x[:, 0:1] + 1.0)
        c1 = torch.log(x[:, 1:2] + 1.0) - c0
        return torch.cat([c0, c1, x[:, 2:]], dim=1)
    return x[:, 2:]


@register_op("cvm", nondiff_inputs=("CVM",))
def _cvm(ins, attrs, ctx):
    return {"Y": [_cvm_fwd(_x(ins), attrs.get("use_cvm", True))]}


@register_op("continuous_value_model", nondiff_inputs=("CVM",))
def _continuous_value_model(ins, attrs, ctx):
    return {"Y": [_cvm_fwd(_x(ins), attrs.get("use_cvm", True))]}


@register_op("fused_seqpool_cvm", nondiff_inputs=("CVM", "Length"))
def _fused_seqpool_cvm(ins, attrs, ctx):
    """SUM-pool each padded [B, T, D] slot, then CVM: one ``Length`` [B]
    for every slot (an empty row pools to ``pad_value``); ``pooltype``,
    ``cvm_offset`` and the ``CVM`` input are not read, as in the
    reference."""
    use_cvm = attrs.get("use_cvm", True)
    pad_value = attrs.get("pad_value", 0.0)
    length = ins["Length"][0] if ins.get("Length") else None
    outs = []
    for x in ins["X"]:
        if length is not None:
            pos = torch.arange(x.shape[1], device=x.device)
            m = (pos[None, :] < length.reshape(-1, 1)).to(x.dtype)[..., None]
            pooled = torch.sum(x * m, dim=1)
            empty = length.reshape(-1, 1) == 0
            pooled = torch.where(empty, torch.full_like(pooled, pad_value),
                                 pooled)
        else:
            pooled = torch.sum(x, dim=1)
        outs.append(_cvm_fwd(pooled, use_cvm))
    return {"Out": outs}


@register_op("batch_fc")
def _batch_fc(ins, attrs, ctx):
    """batch_fc_op.cc: Input [S, N, in], W [S, in, out], Bias [S, out] ->
    relu(Input @ W + Bias), whatever ``activation`` says."""
    x, w, b = _x(ins, "Input"), _x(ins, "W"), _x(ins, "Bias")
    out = torch.bmm(x, w.to(x.dtype)) + b[:, None, :]
    return {"Out": [torch.relu(out)]}


@register_op("scaled_fc")
def _scaled_fc(ins, attrs, ctx):
    """scaled_fc_op.cc: relu((x · input_scale) @ W + b · bias_scale);
    ``grad_scale_factor`` is not read."""
    x, w, b = _x(ins, "Input"), _x(ins, "W"), _x(ins, "Bias")
    isf = attrs.get("input_scale_factor", 1.0)
    bsf = attrs.get("bias_scale_factor", 1.0)
    return {"Out": [torch.relu((x * isf) @ w + b * bsf)]}


@register_op("rank_attention", nondiff_inputs=("RankOffset",))
def _rank_attention(ins, attrs, ctx):
    """rank_attention_op.cc: X [N, x_dim]; RankOffset [N, 1 + 2·max_rank]
    (column 0 the instance's rank, 0 for none, then (other rank, block
    row) pairs); RankParam [rows, x_dim · para_col].  Out [N, para_col]
    is the mean over the present pairs of X[i] @ block.  Computed as
    X @ every block (one product) and a one-hot product that picks each
    instance's present blocks, so RankParam's gradient is one product
    over the instances, the same bits on every run (a gather's gradient
    over blocks most instances share adds them in an order the card does
    not fix)."""
    x = _x(ins)
    rank_offset = ins["RankOffset"][0].long()
    param = _x(ins, "RankParam")
    n, x_dim = x.shape
    rows = param.shape[0]
    para_col = param.shape[1] // x_dim
    idx = rank_offset[:, 2::2]                      # [N, max_rank]
    present = (rank_offset[:, 1::2] >= 0) & (rank_offset[:, 0:1] > 0)
    pick = F.one_hot(torch.clamp(idx, min=0), rows).to(x.dtype) \
        * present.to(x.dtype)[..., None]            # [N, max_rank, rows]
    every = (x @ param.reshape(rows, x_dim, para_col).permute(1, 0, 2)
             .reshape(x_dim, rows * para_col)).reshape(n, rows, para_col)
    out = torch.bmm(pick.sum(1)[:, None, :], every)[:, 0] / torch.clamp(
        present.to(x.dtype).sum(1, keepdim=True), min=1.0)
    return {"Out": [out.to(x.dtype)], "InputHelp": [x],
            "ParamHelp": [param],
            "InsRank": [rank_offset[:, 0:1].to(x.dtype)]}


@register_op("cross_norm_hadamard")
def _cross_norm_hadamard(ins, attrs, ctx):
    """cross_norm_hadamard_op.cc: paired fields [a, b] of ``embed_dim``
    become (a, b, a · b) each, normalised by ``SummaryInput``'s row 0 as
    the mean and row 1 (at least 1e-6) as the scale; SummaryInput is a
    parameter the optimizer moves, and ``summary_decay_rate`` is not
    read."""
    x = _x(ins, "Input")
    summary = _x(ins, "SummaryInput")
    fields = attrs.get("fields_num", 1)
    embed = attrs.get("embed_dim", x.shape[1] // (2 * fields))
    pairs = x.reshape(x.shape[0], fields, 2, embed)
    a, b = pairs[:, :, 0], pairs[:, :, 1]
    out = torch.cat([a, b, a * b], dim=-1).reshape(x.shape[0], -1)
    mean, scale = summary[0], torch.clamp(summary[1], min=1e-6)
    return {"Out": [(out - mean) / scale],
            "CudaMeans": [mean], "CudaScales": [scale]}


@register_op("filter_by_instag",
             nondiff_inputs=("Ins_tag", "Filter_tag"), differentiable=False)
def _filter_by_instag(ins, attrs, ctx):
    """filter_by_instag_op.cc at a static shape: a row none of whose tags
    is a filter tag is zeroed and weighs 0 in ``LossWeight``; rows are
    never compacted, and ``is_lod`` and ``out_val_if_empty`` are not
    read."""
    rows = ins["Ins"][0]
    tags = ins["Ins_tag"][0]          # [N, T] tag ids, -1 pads
    filt = ins["Filter_tag"][0]       # [F]
    if tags.ndim == 1:
        tags = tags[:, None]
    hit = (tags[:, :, None] == filt.reshape(-1)[None, None, :]).any(
        dim=2).any(dim=1)
    w = hit.to(rows.dtype)
    shaped = w.reshape((-1,) + (1,) * (rows.ndim - 1))
    pos = torch.arange(rows.shape[0], device=rows.device)
    return {"Out": [rows * shaped], "LossWeight": [w.reshape(-1, 1)],
            "IndexMap": [torch.stack([pos, pos], 1)]}


_M32 = 0xFFFFFFFF


def _xxhash_like(x, mod, seed):
    """The reference's multiplicative mix on uint32 words, in int64 with
    every product and shift masked to 32 bits (a wrapped int64 product's
    low word is exact): the high word is mixed into the low first, as the
    reference does under x64 (for ids below 2^32 the high word is 0 and
    its x64-off branch gives the same)."""
    x = x.long()
    lo = x & _M32
    hi = (x >> 32) & _M32
    lo = lo ^ ((hi * 2246822519) & _M32)
    h = (lo * 2654435761 + seed) & _M32
    h = h ^ (h >> 16)
    h = (h * 2246822519) & _M32
    h = h ^ (h >> 13)
    return h % mod


@register_op("hash", differentiable=False)
def _hash(ins, attrs, ctx):
    """hash_op.cc: ``num_hash`` hashes of each id into [0, mod_by)."""
    x = _x(ins)
    mod = attrs.get("mod_by", 1)
    return {"Out": [torch.stack(
        [_xxhash_like(x, mod, seed)
         for seed in range(attrs.get("num_hash", 1))], dim=-1)]}


@register_op("pyramid_hash", nondiff_inputs=("X",))
def _pyramid_hash(ins, attrs, ctx):
    """pyramid_hash_op.cc: each n-gram window (n from 2 to 1 +
    pyramid_layer) of the padded [B, T] ids hashes to a row of W; the
    rows' first ``num_emb`` columns are summed a sequence.  W's rows are
    gathered by ``_GatherRows``, whose gradient sums repeats in a fixed
    order."""
    x = _x(ins).long()
    w = _x(ins, "W")
    num_emb = attrs.get("num_emb", w.shape[1])
    space_len = attrs.get("space_len", w.shape[0])
    b, t = x.shape[:2]
    acc = torch.zeros((b, num_emb), dtype=w.dtype, device=w.device)
    for n in range(2, 2 + attrs.get("pyramid_layer", 2)):
        if t < n:
            break
        coef = torch.arange(1, n + 1, device=x.device)
        for s in range(t - n + 1):
            h = torch.sum(x[:, s:s + n] * coef[None, :], dim=1)
            acc = acc + _GatherRows.apply(w, h % space_len)[:, :num_emb]
    return {"Out": [acc]}


@register_op("tdm_child", nondiff_inputs=("X", "TreeInfo"),
             differentiable=False)
def _tdm_child(ins, attrs, ctx):
    """tdm_child_op.cc: each node's children from TreeInfo's rows
    [item_id, layer_id, parent_id, child_0 .. child_{n-1}]; LeafMask is 1
    where a child is not 0."""
    x = _x(ins).long()
    tree = ins["TreeInfo"][0].long()
    child_nums = attrs.get("child_nums", tree.shape[1] - 3)
    children = tree[:, 3:3 + child_nums]
    out = children[x.reshape(-1)].reshape(tuple(x.shape) + (child_nums,))
    return {"Child": [out], "LeafMask": [(out != 0).long()]}


@register_op("tdm_sampler", nondiff_inputs=("X", "Travel", "Layer"),
             differentiable=False, stateful_rng=True)
def _tdm_sampler(ins, attrs, ctx):
    """tdm_sampler_op.cc: per tree layer, each item's node on its travel
    path (label 1) then ``neg_samples_num_list[i]`` nodes drawn uniformly
    from that layer's row of ``Layer`` (label 0); Mask is 1 where a node
    is not 0.  ``output_positive`` and ``output_list`` are not read."""
    x = _x(ins).long().reshape(-1)
    travel = ins["Travel"][0].long()        # [n_items, n_layers]
    layer = ins["Layer"][0].long()          # [n_layers, width] padded
    negs = attrs.get("neg_samples_num_list", [1] * travel.shape[1])
    n = x.shape[0]
    gen = ctx.key_for(attrs.get("op_seed", attrs.get("seed", 0) or 0))
    dev = x.device
    path = travel[x]
    outs, labels = [], []
    for li in range(travel.shape[1]):
        neg_idx = torch.randint(0, layer.shape[1], (n, negs[li]),
                                generator=gen, device=dev)
        outs.append(torch.cat([path[:, li:li + 1], layer[li][neg_idx]], 1))
        labels.append(torch.cat(
            [torch.ones((n, 1), dtype=torch.long, device=dev),
             torch.zeros((n, negs[li]), dtype=torch.long, device=dev)], 1))
    out = torch.cat(outs, 1)
    return {"Out": [out.reshape(n, -1, 1)],
            "Labels": [torch.cat(labels, 1).reshape(n, -1, 1)],
            "Mask": [(out != 0).long().reshape(n, -1, 1)]}


@register_op("store_q_value", differentiable=False)
def _store_q_value(ins, attrs, ctx):
    """store_q_value_op: the identity on the device; the Q values are
    kept on the host."""
    return {"Out": [ins["Input"][0]]}


@register_op("merge_ids", nondiff_inputs=("Ids", "Rows"),
             differentiable=False)
def _merge_ids(ins, attrs, ctx):
    """merge_ids_op: rows pulled from ``len(X)`` shards (id % shards, in
    arrival order within a shard) put back in the ids' order."""
    ids = ins["Ids"][0].long().reshape(-1)
    parts = ins["X"]
    n_shard = len(parts)
    stacked = torch.cat(list(parts), dim=0)
    shard = ids % n_shard
    offsets = torch.zeros_like(ids)
    for s in range(n_shard):
        in_s = (shard == s).long()
        offsets = offsets + in_s * (torch.cumsum(in_s, 0) - 1)
    sizes = torch.tensor([0] + [p.shape[0] for p in parts[:-1]],
                         dtype=torch.long, device=ids.device)
    base = torch.cumsum(sizes, 0)
    return {"Out": [stacked[base[shard] + offsets].reshape(
        tuple(ids.shape) + (parts[0].shape[-1],))]}


@register_op("ps_lookup_rows", nondiff_inputs=("Ids",))
def _ps_lookup_rows(ins, attrs, ctx):
    """The device half of a PS-served lookup: ``Rows``, the host's rows
    for each id position, shaped as the ids; padding positions zeroed."""
    rows = ins["Rows"][0]
    ids = ins["Ids"][0]
    if attrs.get("v1") and ids.shape and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    out = rows.reshape(tuple(ids.shape) + (rows.shape[-1],))
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = torch.where((ids == pad)[..., None], torch.zeros_like(out),
                          out)
    return {"Out": [out]}


@register_op("data_norm",
             nondiff_inputs=("BatchSize", "BatchSum", "BatchSquareSum"),
             nondiff_outputs=("Means", "Scales", "BatchSizeOut",
                              "BatchSumOut", "BatchSquareSumOut"))
def _data_norm(ins, attrs, ctx):
    """data_norm_op.cc: y = (x - sum/size) · sqrt(size/square_sum) (then
    · ScaleW + Bias), the statistics held constant in the backward, so
    dX = dY · scales.  Unless ``is_test``, the op writes the decayed
    running statistics as outputs (``summary_decay_rate``); with
    ``slot_dim`` a slot whose first column (its show) is 0 is left out.
    As in the reference, padded rows of a bucketed batch enter the
    statistics (``ctx.batch_mask`` is not read), and ``sync_stats`` is not
    read."""
    x = ins["X"][0]
    bsize, bsum, bsq = (ins["BatchSize"][0], ins["BatchSum"][0],
                        ins["BatchSquareSum"][0])
    means = bsum / bsize
    scales = torch.sqrt(bsize / bsq)
    y = (x - means) * scales
    if ins.get("ScaleW"):
        y = y * ins["ScaleW"][0] + ins["Bias"][0]
    outs = {"Y": [y], "Means": [means], "Scales": [scales]}
    if ctx.is_test:
        return outs
    eps = attrs.get("epsilon", 1e-4)
    decay = attrs.get("summary_decay_rate", 0.9999999)
    slot_dim = int(attrs.get("slot_dim", -1))
    n, c = x.shape[0], x.shape[-1]
    if slot_dim > 0 and c % slot_dim == 0:
        xm = x.reshape(n, c // slot_dim, slot_dim)
        live = (torch.abs(xm[:, :, 0]) > 1e-7)[..., None]
        cnt_s = live.sum(0).to(x.dtype)
        cnt = cnt_s.expand(c // slot_dim, slot_dim).reshape(c)
        ssum = (xm * live).sum(0).reshape(c)
        ssq = (((xm - means.reshape(c // slot_dim, slot_dim)) ** 2)
               * live).sum(0).reshape(c)
        safe = torch.clamp(cnt, min=1.0)
        hit = cnt >= 1
        zero = torch.zeros_like(cnt)
        d_size = torch.where(hit, torch.ones_like(cnt), zero)
        d_sum = torch.where(hit, ssum / safe, zero)
        d_sq = torch.where(hit, ssq / safe + cnt * eps, zero)
    else:
        d_size = torch.full((c,), float(n), dtype=x.dtype, device=x.device)
        d_sum = x.reshape(-1, c).sum(0)
        d_sq = ((x - means) ** 2).reshape(-1, c).sum(0) + n * eps
    outs["BatchSizeOut"] = [decay * bsize + d_size]
    outs["BatchSumOut"] = [decay * bsum + d_sum]
    outs["BatchSquareSumOut"] = [decay * bsq + d_sq]
    return outs
