"""Catalog-tail lowerings (counterpart of
``paddle_tpu/ops/catalog_tail_ops.py``: the op paddle.tensor reaches,
the framework tail (``fc``, ``py_func``, the 2.0 ``rnn``, ``recurrent``
(StaticRNN's step loop), ``attention_lstm``), the sequence tail's
``sequence_reshape`` and ``sequence_topk_avg_pooling``, the twelve of
the detection tail with ``bilateral_slice`` and
``fusion_conv_inception``, and the CTR tail's
``pull_box_extended_sparse``, ``pull_sparse_v2`` and the sparse-table
five: the two fused pushes, the merge and the grad split).

As in the reference: ``fc``'s ``gelu`` is the tanh form (the ``gelu`` op
is the erf form); ``rnn`` runs one direction, chains its layers and reads
no ``PreState``, ``SequenceLength`` or ``is_bidirec``; ``bilateral_slice``
reads no ``X`` and no ``has_offset``."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .detection_ops import gather_rows, true_div
from .registry import get_op, register_op


def _p(ins, slot):
    return ins[slot][0]


_FC_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
            "tanh": torch.tanh,
            "gelu": lambda v: F.gelu(v, approximate="tanh")}


def _act(name, x):
    if not name or name == "identity":
        return x
    return _FC_ACTS[name](x)


# ---------------------------------------------------------------------------
# framework tail
# ---------------------------------------------------------------------------

@register_op("fc")
def _fc(ins, attrs, ctx):
    """Input flattened to [prod(shape[:in_num_col_dims]), -1], times W,
    plus Bias, then ``activation_type``; the leading axes restored."""
    x, w = _p(ins, "Input"), _p(ins, "W")
    ncol = attrs.get("in_num_col_dims", 1)
    lead = tuple(x.shape[:ncol])
    out = x.reshape(math.prod(lead), -1) @ w
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(1, -1)
    out = _act(attrs.get("activation_type", ""), out)
    return {"Out": [out.reshape(lead + (w.shape[1],))]}


_PY_FUNCS = []


def register_py_func(fn) -> int:
    """Register a host callable for ``py_func``; its id is the op's
    ``forward_callable_id``."""
    _PY_FUNCS.append(fn)
    return len(_PY_FUNCS) - 1


@register_op("py_func", differentiable=False)
def _py_func(ins, attrs, ctx):
    """The registered callable on numpy copies of X, on the host; each
    output as ``out_dtypes``, reshaped to ``out_shapes``, on X's device
    (the context's when there is no X).  Every tensor copied between the
    card and the host, either way, adds one to ``_py_func.copies``."""
    fn = _PY_FUNCS[int(attrs["forward_callable_id"])]
    xs = list(ins.get("X", []))
    shapes = attrs.get("out_shapes", [])
    dtypes = attrs.get("out_dtypes", ["float32"] * len(shapes))
    dev = xs[0].device if xs else ctx.device
    arrays = []
    for x in xs:
        if x.device.type != "cpu":
            _py_func.copies += 1
        arrays.append(x.detach().cpu().numpy())
    out = fn(*arrays)
    out = out if isinstance(out, (list, tuple)) else [out]
    outs = []
    for o, shape, dtype in zip(out, shapes, dtypes):
        t = torch.from_numpy(np.array(o, np.dtype(dtype)).reshape(shape))
        if dev.type != "cpu":
            _py_func.copies += 1
        outs.append(t.to(dev))
    return {"Out": outs}


_py_func.copies = 0


@register_op("equal_all", differentiable=False)
def _equal_all(ins, attrs, ctx):
    """One bool: same shape and every element equal."""
    x, y = ins["X"][0], ins["Y"][0]
    if x.shape != y.shape:
        return {"Out": [torch.tensor(False, device=x.device)]}
    return {"Out": [torch.all(torch.eq(x, y))]}


@register_op("recurrent", differentiable=False)
def _recurrent(ins, attrs, ctx):
    """StaticRNN's step loop (recurrent_op.cc): run the step sub-block
    once per time step, feeding each sequence input's step ``[:, t]``
    and threading the memories; the step outputs are stacked on axis 1.
    The executor binds the program as ``__program__``."""
    from ..fluid.executor import run_block_ops
    sub = attrs["__program__"].blocks[attrs["sub_block"]]
    seq_ins = dict(zip(attrs.get("inputs", []), ins.get("Inputs", [])))
    states = dict(zip(attrs.get("ex_states", []),
                      ins.get("InitStates", [])))
    params = dict(zip(attrs.get("parameters", []),
                      ins.get("Parameters", [])))
    state_names = attrs.get("states", [])
    out_names = attrs.get("outputs", [])
    steps = next(iter(seq_ins.values())).shape[1] if seq_ins \
        else attrs["len"]
    collected = {n: [] for n in out_names}
    for t in range(steps):
        env = dict(params)
        for n, v in seq_ins.items():
            env[n] = v[:, t]
        env.update(states)
        run_block_ops(sub, env, ctx)
        states = {ex: env[cur] for ex, cur in zip(states, state_names)}
        for n in out_names:
            collected[n].append(env[n])
    return {"Out": [torch.stack(collected[n], dim=1) for n in out_names]}


@register_op("rnn", nondiff_inputs=("SequenceLength", "PreState"))
def _rnn(ins, attrs, ctx):
    """The 2.0 generic RNN over Input [B, T, I]: ``mode`` LSTM or GRU
    through those lowerings (LSTM without peepholes), RNN_TANH or
    RNN_RELU through a step loop.  WeightList holds a layer's [Wx (I x
    G), Wh (G x H), then its biases, summed]; the recurrent weight is
    used as Whᵀ.  Layers chain; ``Out`` is the last layer's."""
    h = _p(ins, "Input")
    wl = list(ins["WeightList"])
    mode = attrs.get("mode", "LSTM").upper()
    num_layers = attrs.get("num_layers", 1)
    hidden = attrs.get("hidden_size", wl[1].shape[0])
    per = len(wl) // num_layers
    for layer in range(num_layers):
        wx, wh = wl[layer * per], wl[layer * per + 1]
        proj = h @ wx
        if per >= 3:
            proj = proj + sum(b.reshape(-1) for b in
                              wl[layer * per + 2:(layer + 1) * per])
        if mode == "LSTM":
            h = get_op("lstm").fn({"Input": [proj], "Weight": [wh.t()]},
                                  {"use_peepholes": False}, ctx)["Hidden"][0]
        elif mode == "GRU":
            h = get_op("gru").fn({"Input": [proj], "Weight": [wh.t()]},
                                 {}, ctx)["Hidden"][0]
        else:
            act = torch.tanh if mode == "RNN_TANH" else torch.relu
            carry = proj.new_zeros((h.shape[0], hidden))
            steps = []
            for xt in proj.unbind(1):
                carry = act(xt + carry @ wh.t())
                steps.append(carry)
            h = torch.stack(steps, dim=1)
    return {"Out": [h]}


@register_op("attention_lstm")
def _attention_lstm(ins, attrs, ctx):
    """Each step attends over the whole input X [B, T, I] by
    ``softmax([X, h]·AttentionWeight)`` and feeds the attended context
    and h through one LSTM cell of LSTMWeight [I + H, 4H] and LSTMBias,
    gates (i, f, c, o).  ``Hidden`` [B, T, H]; ``Cell`` the last c."""
    x = _p(ins, "X")
    aw, lw = _p(ins, "AttentionWeight"), _p(ins, "LSTMWeight")
    lb = _p(ins, "LSTMBias").reshape(-1)
    b, t, _ = x.shape
    hdim = lw.shape[1] // 4
    h = ins["H0"][0] if ins.get("H0") else x.new_zeros((b, hdim))
    c = ins["C0"][0] if ins.get("C0") else x.new_zeros((b, hdim))
    hs = []
    for _ in range(t):
        hx = torch.cat([x, torch.broadcast_to(h[:, None], (b, t, hdim))],
                       dim=-1)
        alpha = torch.softmax(torch.squeeze(hx @ aw, -1), dim=-1)
        ctx_vec = torch.einsum("bt,btd->bd", alpha, x)
        gates = torch.cat([ctx_vec, h], dim=-1) @ lw + lb
        i, f, cc, o = torch.chunk(gates, 4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return {"Hidden": [torch.stack(hs, dim=1)], "Cell": [c]}


@register_op("sequence_reshape")
def _sequence_reshape(ins, attrs, ctx):
    """Rows regrouped to width ``new_dim`` ([B, T, D] keeps its batch)."""
    x, new_dim = ins["X"][0], attrs["new_dim"]
    return {"Out": [x.reshape(x.shape[0], -1, new_dim) if x.ndim == 3
                    else x.reshape(-1, new_dim)]}


@register_op("sequence_topk_avg_pooling", nondiff_inputs=("ROW", "COLUMN"))
def _sequence_topk_avg_pooling(ins, attrs, ctx):
    """For each k of ``topks``, the mean of the k largest along the last
    axis of X [B, C, L]; the means concatenated on the last axis."""
    x = ins["X"][0]
    outs = [torch.topk(x, min(k, x.shape[-1]), dim=-1).values.mean(-1)
            for k in attrs.get("topks", [1])]
    return {"Out": [torch.cat(outs, dim=-1)]}


# ---------------------------------------------------------------------------
# CTR / sparse-table tail
# ---------------------------------------------------------------------------

@register_op("pull_box_extended_sparse", differentiable=False)
def _pull_box_extended_sparse(ins, attrs, ctx):
    """pull_box_extended_sparse_op.cc: ``pull_box_sparse``'s rows of W,
    and an ``emb_extended_size``-wide zero vector an id beside them.  It
    reads ``W``, which the reference's builder never appends, so a
    program built by ``_pull_box_extended_sparse`` raises here as it
    does there."""
    base = get_op("pull_box_sparse").fn(ins, attrs, ctx)["Out"]
    edim = attrs.get("emb_extended_size", 8)
    return {"Out": base,
            "OutExtend": [o.new_zeros(tuple(o.shape[:-1]) + (edim,))
                          for o in base]}


@register_op("pull_sparse_v2", differentiable=False)
def _pull_sparse_v2(ins, attrs, ctx):
    return get_op("pull_sparse").fn(ins, attrs, ctx)


def _push_to_table(ins, attrs, optimizer, lr):
    """(table, ids, grad rows) on the host for a push of Grad's rows for
    Ids into the table ``table_name``, which is made with ``optimizer``
    and ``lr`` on first use only; None on the meta device."""
    from .plumbing_ops import _get_table, _meta, _to_host
    ids, grads = ins["Ids"][0], ins["Grad"][0]
    if _meta(ids, grads):
        return None
    i = _to_host(ids).reshape(-1)
    g = _to_host(grads)
    t = _get_table(attrs["table_name"], int(g.shape[-1]), optimizer, lr)
    return t, i, g.reshape(len(i), -1)


@register_op("lookup_sparse_table_fuse_sgd", differentiable=False)
def _lookup_sparse_table_fuse_sgd(ins, attrs, ctx):
    """An sgd push at ``lr``, which also resets the table's rate."""
    lr = attrs.get("lr", 0.01)
    pushed = _push_to_table(ins, attrs, "sgd", lr)
    if pushed is not None:
        t, i, g = pushed
        t.lr = lr
        t.push(i, g)
    return {}


@register_op("lookup_sparse_table_fuse_adam", differentiable=False)
def _lookup_sparse_table_fuse_adam(ins, attrs, ctx):
    """A push through the table's own accessor: adam for a table this op
    made, but whatever an earlier op made it with otherwise (a table
    ``lookup_sparse_table_init`` made with sgd runs sgd), as in the
    reference."""
    pushed = _push_to_table(ins, attrs, "adam", attrs.get("lr", 0.001))
    if pushed is not None:
        t, i, g = pushed
        t.push(i, g)
    return {}


@register_op("lookup_sparse_table_merge", differentiable=False)
def _lookup_sparse_table_merge(ins, attrs, ctx):
    """Merge the grads of repeated ids (SelectedRows MergeAdd, dense
    layout): Ids the sorted unique ids padded with -1, Out their summed
    rows padded with zeros, both of Ids' length.  Summed on the host, in
    id order as ``np.add.at`` gives it, so the card's rows and the host's
    are the same bits; the push that follows runs on the host too."""
    from .plumbing_ops import _meta, _to_card, _to_host
    ids, grads = ins["Ids"][0], ins["Grad"][0]
    if _meta(ids, grads):
        return {}
    i = _to_host(ids).reshape(-1)
    g = _to_host(grads).reshape(len(i), -1)
    uniq, inv = np.unique(i, return_inverse=True)
    out_ids = np.full(len(i), -1, i.dtype)
    out_ids[:len(uniq)] = uniq
    merged = np.zeros_like(g)
    np.add.at(merged, inv.reshape(-1), g)
    return {"Ids": [_to_card(out_ids, ctx.device)],
            "Out": [_to_card(merged.reshape(grads.shape), ctx.device)]}


@register_op("lookup_sparse_table_grad_split", differentiable=False)
def _lookup_sparse_table_grad_split(ins, attrs, ctx):
    """Each shard's (id mod ``num``) ids and grad rows in place, the
    others' -1 and zero."""
    ids = ins["Ids"][0].reshape(-1)
    grads = ins["Grad"][0].reshape(ids.shape[0], -1)
    n = attrs.get("num", 1)
    outs_i, outs_g = [], []
    for s in range(n):
        mask = (ids % n) == s
        outs_i.append(torch.where(mask, ids, torch.full_like(ids, -1)))
        outs_g.append(torch.where(mask[:, None], grads,
                                  torch.zeros_like(grads)))
    return {"OutIds": outs_i, "OutGrads": outs_g}


# ---------------------------------------------------------------------------
# detection tail
# ---------------------------------------------------------------------------

# elements of one block of classes' [k, M, M] comparison in matrix_nms
_NMS_BLOCK_ELEMENTS = 1 << 28


def _pair_iou(a, b):
    """IoU of each box of a [N, 4] against each of b [M, 4] (no +1):
    [N, M]."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_a[:, None] + area_b[None] - inter,
                               min=1e-9)


@register_op("box_clip", nondiff_inputs=("ImInfo",))
def _box_clip(ins, attrs, ctx):
    """Boxes clipped into the image ``[0, w - 1] x [0, h - 1]``
    (``ImInfo`` rows of [h, w, scale])."""
    boxes, im_info = _p(ins, "Input"), _p(ins, "ImInfo")
    h = im_info[..., 0:1] - 1.0
    w = im_info[..., 1:2] - 1.0
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0::4], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1::4], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2::4], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3::4], zero), h)
    return {"Output": [torch.stack([x1, y1, x2, y2], -1)
                       .reshape(boxes.shape)]}


@register_op("box_decoder_and_assign", nondiff_inputs=("PriorBox",
                                                       "BoxScore"))
def _box_decoder_and_assign(ins, attrs, ctx):
    """Each prior's class offsets decoded (pixel boxes, ``box_var`` from
    the attribute), and the box of its best non-background class."""
    prior, var = _p(ins, "PriorBox"), attrs.get("box_var",
                                                [0.1, 0.1, 0.2, 0.2])
    target, score = _p(ins, "TargetBox"), _p(ins, "BoxScore")
    n, c4 = target.shape
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    cx = prior[:, 0] + pw * 0.5
    cy = prior[:, 1] + ph * 0.5
    t = target.reshape(n, c4 // 4, 4)
    dx, dy, dw, dh = (t[..., 0] * var[0], t[..., 1] * var[1],
                      t[..., 2] * var[2], t[..., 3] * var[3])
    gx = cx[:, None] + dx * pw[:, None]
    gy = cy[:, None] + dy * ph[:, None]
    gw = torch.exp(dw) * pw[:, None]
    gh = torch.exp(dh) * ph[:, None]
    decoded = torch.stack([gx - gw * 0.5, gy - gh * 0.5,
                           gx + gw * 0.5 - 1, gy + gh * 0.5 - 1], -1)
    best = torch.argmax(score[:, 1:], 1) + 1
    assigned = torch.gather(decoded, 1,
                            best[:, None, None].expand(-1, 1, 4))[:, 0]
    return {"DecodeBox": [decoded.reshape(n, c4)],
            "OutputAssignBox": [assigned]}


@register_op("matrix_nms", differentiable=False)
def _matrix_nms(ins, attrs, ctx):
    """matrix_nms_op.cc as the reference keeps it: for each image and
    class the boxes by score (ties to the lower index), each score
    decayed by its largest IoU with a better box (linear, or Gaussian
    under ``use_gaussian``); rows [class, score or -1 under
    ``score_threshold``, box], every class's M rows (no top-k).  BBoxes
    [B, M, 4], Scores [B, C, M] (class-major).  The largest IoU is read
    against the inverse order on the unsorted matrix, the same maximum
    as the sorted matrix's upper triangle, a block of classes at a
    time."""
    boxes, scores = _p(ins, "BBoxes"), _p(ins, "Scores")
    bsz, m = boxes.shape[0], boxes.shape[1]
    ncls = scores.shape[1]
    thr = attrs.get("score_threshold", 0.0)
    use_gauss = attrs.get("use_gaussian", False)
    sigma = attrs.get("gaussian_sigma", 2.0)
    dev, dt = boxes.device, boxes.dtype
    block = max(1, _NMS_BLOCK_ELEMENTS // max(1, m * m))
    arange = torch.arange(m, device=dev)
    outs = []
    for bi in range(bsz):
        m_iou = _pair_iou(boxes[bi], boxes[bi])
        per_cls = []
        for c0 in range(0, ncls, block):
            s = scores[bi, c0:c0 + block]                        # [k, M]
            k = s.shape[0]
            order = torch.argsort(-s, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, arange.expand(k, m).contiguous())
            later = rank[:, :, None] < rank[:, None, :]
            max_iou = torch.where(later, m_iou[None], torch.zeros(
                (), dtype=dt, device=dev)).amax(1)
            max_iou = torch.gather(max_iou, 1, order)
            decay = (torch.exp(-(max_iou ** 2) / sigma) if use_gauss
                     else 1.0 - max_iou)
            dec = torch.gather(s, 1, order) * decay
            cls = (torch.arange(c0, c0 + k, device=dev, dtype=dt)[:, None]
                   .expand(k, m))
            per_cls.append(torch.cat(
                [cls[..., None],
                 torch.where(dec > thr, dec, torch.full(
                     (), -1.0, dtype=dt, device=dev))[..., None],
                 boxes[bi][order]], -1).reshape(k * m, 6))
        outs.append(torch.cat(per_cls, 0))
    out = torch.stack(outs)
    return {"Out": [out],
            "Index": [torch.zeros((bsz, out.shape[1]), dtype=torch.int64,
                                  device=dev)],
            "RoisNum": [torch.full((bsz,), out.shape[1], dtype=torch.int64,
                                   device=dev)]}


@register_op("locality_aware_nms", differentiable=False)
def _locality_aware_nms(ins, attrs, ctx):
    """locality_aware_nms_op.cc as the reference keeps it: each box
    merged with the boxes overlapping it past ``nms_threshold``, weighted
    by score, and kept (its score, else -1) when no better box overlaps
    it and it passes ``score_threshold``; rows [class, score, box], every
    class's M rows."""
    boxes, scores = _p(ins, "BBoxes"), _p(ins, "Scores")
    nms_thr = attrs.get("nms_threshold", 0.3)
    score_thr = attrs.get("score_threshold", 0.0)
    bsz, m = boxes.shape[0], boxes.shape[1]
    dev, dt = boxes.device, boxes.dtype
    zero = torch.zeros((), dtype=dt, device=dev)
    outs = []
    for bi in range(bsz):
        m_iou = _pair_iou(boxes[bi], boxes[bi])
        near = m_iou > nms_thr
        per_cls = []
        for c in range(scores.shape[1]):
            s = scores[bi, c]
            wts = torch.where(near, s[None, :], zero)
            merged = (wts @ boxes[bi]) / torch.clamp(wts.sum(1),
                                                     min=1e-9)[:, None]
            higher = (s[None, :] > s[:, None]) & near
            keep = (~higher.any(1)) & (s > score_thr)
            per_cls.append(torch.cat(
                [torch.full((m, 1), float(c), dtype=dt, device=dev),
                 torch.where(keep, s, torch.full((), -1.0, dtype=dt,
                                                 device=dev))[:, None],
                 merged], 1))
        outs.append(torch.cat(per_cls, 0))
    return {"Out": [torch.stack(outs)]}


@register_op("mine_hard_examples", differentiable=False)
def _mine_hard_examples(ins, attrs, ctx):
    """The ``neg_pos_ratio`` x positives (at most the negatives) highest-
    loss negatives of each row: a mask, and the match indices with them
    set to -1."""
    cls_loss, match = _p(ins, "ClsLoss"), _p(ins, "MatchIndices")
    pos = match >= 0
    n_pos = pos.sum(1, keepdim=True)
    n_neg = torch.minimum((n_pos * attrs.get("neg_pos_ratio", 3.0)).long(),
                          (~pos).sum(1, keepdim=True))
    neg_loss = torch.where(pos, torch.full((), -float("inf"),
                                           dtype=cls_loss.dtype,
                                           device=cls_loss.device), cls_loss)
    order = torch.argsort(-neg_loss, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    neg_mask = rank < n_neg
    return {"NegIndices": [neg_mask.long()],
            "UpdatedMatchIndices": [torch.where(
                neg_mask, torch.full((), -1, dtype=match.dtype,
                                     device=match.device), match)]}


def _bce_logits(p, t):
    return torch.clamp(p, min=0) - p * t + torch.log1p(torch.exp(-p.abs()))


@register_op("yolov3_loss", nondiff_inputs=("GTBox", "GTLabel", "GTScore"))
def _yolov3_loss(ins, attrs, ctx):
    """yolov3_loss_op.cc as the reference keeps it: each valid ground
    truth (cx, cy, w, h in [0, 1]) goes to its cell and to the mask's
    anchor of best shape IoU; sigmoid cross-entropy on the cell offsets
    and the classes, squared error on the log sizes, all scaled by
    ``2 - w h``; objectness cross-entropy against those cells over the
    whole map (``ignore_thresh``, ``GTScore`` and label smoothing are not
    read).  One loss an image.  The responsible cells' rows are one
    ``F.embedding`` gather of the head."""
    x = _p(ins, "X")                        # [B, A (5 + C), H, W]
    gt_box, gt_label = _p(ins, "GTBox"), _p(ins, "GTLabel")
    anchors = np.asarray(attrs.get("anchors", [10, 13, 16, 30, 33, 23]),
                         np.float32).reshape(-1, 2)
    mask = attrs.get("anchor_mask", list(range(len(anchors))))
    ncls = attrs.get("class_num", 1)
    bsz, _, h, w = x.shape
    na = len(mask)
    dev, dt = x.device, x.dtype
    pred = x.reshape(bsz, na, 5 + ncls, h, w)
    amask = torch.from_numpy(anchors[mask] / (attrs.get(
        "downsample_ratio", 32) * h)).to(dev)
    gx, gy, gw, gh = gt_box.unbind(-1)
    g = gt_box.shape[1]
    valid = ((gw > 0) & (gh > 0)).reshape(-1)
    ci = torch.clamp((gx * w).long(), 0, w - 1).reshape(-1)
    cj = torch.clamp((gy * h).long(), 0, h - 1).reshape(-1)
    inter = (torch.minimum(gw[..., None], amask[:, 0])
             * torch.minimum(gh[..., None], amask[:, 1]))
    union = (gw * gh)[..., None] + (amask[:, 0] * amask[:, 1]) - inter
    best_a = torch.argmax(inter / torch.clamp(union, min=1e-9), -1)
    bidx = torch.arange(bsz, device=dev)[:, None].expand(bsz, g).reshape(-1)
    aidx = best_a.reshape(-1)
    flat = ((bidx * na + aidx) * h + cj) * w + ci
    obj_target = torch.zeros(bsz * na * h * w, dtype=dt, device=dev) \
        .scatter_reduce(0, flat, valid.to(dt), "amax") \
        .reshape(bsz, na, h, w)
    tx = (gx * w - torch.floor(gx * w)).reshape(-1)
    ty = (gy * h - torch.floor(gy * h)).reshape(-1)
    tw = torch.gather(torch.log(torch.clamp(gw[..., None] / amask[:, 0],
                                            min=1e-9)), -1,
                      best_a[..., None]).reshape(-1)
    th = torch.gather(torch.log(torch.clamp(gh[..., None] / amask[:, 1],
                                            min=1e-9)), -1,
                      best_a[..., None]).reshape(-1)
    rows = gather_rows(pred.permute(0, 1, 3, 4, 2).reshape(-1, 5 + ncls),
                       flat)                               # [B G, 5 + C]

    def logit(p):
        p = torch.clamp(torch.sigmoid(p), 1e-6, 1 - 1e-6)
        return torch.log(p / (1 - p))
    box_loss = (_bce_logits(logit(rows[:, 0]), tx)
                + _bce_logits(logit(rows[:, 1]), ty)
                + (rows[:, 2] - tw) ** 2 + (rows[:, 3] - th) ** 2) \
        * (2.0 - gw * gh).reshape(-1)
    obj_loss = _bce_logits(pred[:, :, 4], obj_target).sum((1, 2, 3))
    cls_t = (gt_label.reshape(-1)[:, None]
             == torch.arange(ncls, device=dev)[None]).to(dt)
    cls_loss = _bce_logits(rows[:, 5:], cls_t).sum(-1)
    per_gt = torch.where(valid, box_loss + cls_loss,
                         torch.zeros((), dtype=dt, device=dev))
    return {"Loss": [obj_loss + per_gt.reshape(bsz, g).sum(1)]}


def _host_map(d, l, thr):
    """11-point mean average precision of detections d [N, 6] (label,
    score, box) against labels l [M, 5+] (label, box), on the host."""
    if len(l) == 0 or len(d) == 0:
        return np.zeros((1,), np.float32)
    aps = []
    for cls in np.unique(l[:, 0]):
        gt = l[l[:, 0] == cls][:, 1:5]
        dd = d[d[:, 0] == cls]
        dd = dd[np.argsort(-dd[:, 1])]
        used = np.zeros(len(gt), bool)
        tp = np.zeros(len(dd))
        for i, row in enumerate(dd):
            box = row[2:6]
            xx1 = np.maximum(gt[:, 0], box[0])
            yy1 = np.maximum(gt[:, 1], box[1])
            xx2 = np.minimum(gt[:, 2], box[2])
            yy2 = np.minimum(gt[:, 3], box[3])
            inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
            a1 = (box[2] - box[0]) * (box[3] - box[1])
            a2 = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
            iou = inter / np.maximum(a1 + a2 - inter, 1e-9)
            j = int(np.argmax(iou))
            if iou[j] >= thr and not used[j]:
                tp[i] = 1
                used[j] = True
        cum_tp = np.cumsum(tp)
        prec = cum_tp / (np.arange(len(dd)) + 1)
        rec = cum_tp / len(gt)
        ap = 0.0
        for t in np.arange(0, 1.01, 0.1):
            p = prec[rec >= t].max() if (rec >= t).any() else 0.0
            ap += p / 11
        aps.append(ap)
    return np.asarray([np.mean(aps)], np.float32)


@register_op("detection_map", differentiable=False)
def _detection_map(ins, attrs, ctx):
    """detection_map_op.cc as the reference keeps it: one 11-point mAP
    of DetectRes [N, 6] against Label on the host (no accumulation: the
    Accum outputs are zeros)."""
    det, label = _p(ins, "DetectRes"), _p(ins, "Label")
    dev = det.device
    if dev.type == "meta":
        out = torch.zeros((1,), dtype=torch.float32, device=dev)
    else:
        out = torch.from_numpy(_host_map(
            det.detach().cpu().numpy(), label.detach().cpu().numpy(),
            attrs.get("overlap_threshold", 0.5))).to(dev)
    zero = torch.zeros((1,), device=dev)
    return {"MAP": [out], "AccumPosCount": [zero.long()],
            "AccumTruePos": [zero], "AccumFalsePos": [zero]}


@register_op("generate_proposals_v2", differentiable=False)
def _generate_proposals_v2(ins, attrs, ctx):
    return get_op("generate_proposals").fn(ins, attrs, ctx)


@register_op("roi_perspective_transform", nondiff_inputs=("ROIs",))
def _roi_perspective_transform(ins, attrs, ctx):
    """As the reference approximates it: ``roi_align`` over each quad's
    [N, 8] bounding box."""
    x, rois = _p(ins, "X"), _p(ins, "ROIs")
    xs, ys = rois[:, 0::2], rois[:, 1::2]
    bbox = torch.stack([xs.amin(1), ys.amin(1), xs.amax(1), ys.amax(1)], 1)
    return {"Out": get_op("roi_align").fn(
        {"X": [x], "ROIs": [bbox]},
        {"pooled_height": attrs.get("transformed_height", 8),
         "pooled_width": attrs.get("transformed_width", 8),
         "spatial_scale": attrs.get("spatial_scale", 1.0)}, ctx)["Out"]}


@register_op("deformable_psroi_pooling", nondiff_inputs=("ROIs", "Trans"))
def _deformable_psroi_pooling(ins, attrs, ctx):
    """As the reference keeps it: each RoI shifted by its first part's
    offset (``trans_std`` times its size), then ``psroi_pool``."""
    x, rois = _p(ins, "X"), _p(ins, "ROIs")
    trans = ins["Trans"][0] if ins.get("Trans") else None
    ph = attrs.get("pooled_height", attrs.get("pooled_size", 7))
    pw = attrs.get("pooled_width", attrs.get("pooled_size", 7))
    if trans is not None:
        off = trans.reshape(rois.shape[0], 2, -1)[:, :, 0] \
            * attrs.get("trans_std", 0.1)
        w = rois[:, 2] - rois[:, 0]
        h = rois[:, 3] - rois[:, 1]
        rois = rois + torch.stack([off[:, 0] * w, off[:, 1] * h,
                                   off[:, 0] * w, off[:, 1] * h], 1)
    return get_op("psroi_pool").fn(
        {"X": [x], "ROIs": [rois]},
        {"pooled_height": ph, "pooled_width": pw,
         "output_channels": attrs.get("output_channels",
                                      attrs.get("output_dim", 1)),
         "spatial_scale": attrs.get("spatial_scale", 1.0)}, ctx)


@register_op("generate_proposal_labels", differentiable=False,
             stateful_rng=True)
def _generate_proposal_labels(ins, attrs, ctx):
    """generate_proposal_labels_op.cc as the reference keeps it: exactly
    ``batch_size_per_im`` RoIs of the RPN's and the ground truth's, the
    ``fg_fraction`` share ranked by IoU past ``fg_thresh`` and the rest
    in [``bg_thresh_lo``, ``bg_thresh_hi``) (ranked, not sampled: the
    seed is not read), with labels and regression targets."""
    rois, gt_boxes = _p(ins, "RpnRois"), _p(ins, "GtBoxes")
    gt_classes = _p(ins, "GtClasses").reshape(-1)
    per_im = attrs.get("batch_size_per_im", 256)
    fg_thr = attrs.get("fg_thresh", 0.5)
    all_rois = torch.cat([rois, gt_boxes], 0)
    m = _pair_iou(all_rois, gt_boxes)
    best, argbest = m.amax(1), torch.argmax(m, 1)
    n_fg = int(per_im * attrs.get("fg_fraction", 0.25))
    minus = torch.full((), -1.0, dtype=m.dtype, device=m.device)
    fg_score = torch.where(best >= fg_thr, best, minus)
    fg_idx = torch.argsort(-fg_score, stable=True)[:n_fg]
    bg_score = torch.where((best < attrs.get("bg_thresh_hi", 0.5))
                           & (best >= attrs.get("bg_thresh_lo", 0.0)),
                           best, minus)
    bg_idx = torch.argsort(-bg_score, stable=True)[:per_im - n_fg]
    keep = torch.cat([fg_idx, bg_idx])
    out_rois = all_rois[keep]
    is_fg = torch.arange(per_im, device=m.device) < n_fg
    labels = torch.where(is_fg, gt_classes[argbest[keep]].long(),
                         torch.zeros((), dtype=torch.int64,
                                     device=m.device))
    matched = gt_boxes[argbest[keep]]
    w = torch.clamp(out_rois[:, 2] - out_rois[:, 0], min=1e-6)
    h = torch.clamp(out_rois[:, 3] - out_rois[:, 1], min=1e-6)
    gw = torch.clamp(matched[:, 2] - matched[:, 0], min=1e-6)
    gh = torch.clamp(matched[:, 3] - matched[:, 1], min=1e-6)
    tx = ((matched[:, 0] + matched[:, 2])
          - (out_rois[:, 0] + out_rois[:, 2])) / (2 * w)
    ty = ((matched[:, 1] + matched[:, 3])
          - (out_rois[:, 1] + out_rois[:, 3])) / (2 * h)
    targets = torch.stack([tx, ty, torch.log(gw / w), torch.log(gh / h)], 1)
    fg_mask = is_fg[:, None].to(m.dtype)
    return {"Rois": [out_rois], "LabelsInt32": [labels],
            "BboxTargets": [targets * fg_mask],
            "BboxInsideWeights": [fg_mask.expand(per_im, 4).contiguous()],
            "BboxOutsideWeights": [fg_mask.expand(per_im, 4).contiguous()]}


@register_op("generate_mask_labels", differentiable=False)
def _generate_mask_labels(ins, attrs, ctx):
    """generate_mask_labels_op.cc as the reference keeps it: each RoI's
    matched full-image mask [G, H, W] sampled at ``resolution`` x
    ``resolution`` nearest points; -1 rows for background RoIs."""
    rois, masks = _p(ins, "Rois"), _p(ins, "GtSegms")
    labels = _p(ins, "LabelsInt32").reshape(-1)
    n = rois.shape[0]
    match = (_p(ins, "MatchIndices").reshape(-1).long()
             if ins.get("MatchIndices")
             else torch.zeros((n,), dtype=torch.int64, device=rois.device))
    res = attrs.get("resolution", 14)
    h, w = masks.shape[1:]
    frac = true_div(torch.arange(res, dtype=rois.dtype, device=rois.device),
                    max(res - 1, 1))
    y = torch.clamp((rois[:, 1:2] + frac * (rois[:, 3:4] - rois[:, 1:2]))
                    .long(), 0, h - 1)
    x = torch.clamp((rois[:, 0:1] + frac * (rois[:, 2:3] - rois[:, 0:1]))
                    .long(), 0, w - 1)
    mi = torch.clamp(match, 0, masks.shape[0] - 1)
    out = masks[mi[:, None, None], y[:, :, None], x[:, None, :]].long()
    fg = labels > 0
    out = torch.where(fg[:, None, None], out,
                      torch.full((), -1, dtype=torch.int64,
                                 device=rois.device))
    return {"MaskRois": [rois], "RoiHasMaskInt32": [fg.long()],
            "MaskInt32": [out.reshape(n, -1)]}


@register_op("bilateral_slice")
def _bilateral_slice(ins, attrs, ctx):
    """HDRnet's slice of a bilateral Grid [B, C, D, GH, GW] at every
    pixel of Guide [B, H, W] (values in [0, 1]): trilinear in the grid's
    (y, x) spread over (H, W) and in its depth at guide·(D - 1)."""
    grid, guide = _p(ins, "Grid"), _p(ins, "Guide")
    b, c, d, gh, gw = grid.shape
    h, w = guide.shape[1:]
    dev, dt = grid.device, grid.dtype
    ys = torch.linspace(0, gh - 1, h, dtype=dt, device=dev)
    xs = torch.linspace(0, gw - 1, w, dtype=dt, device=dev)
    gz = torch.clamp(guide * (d - 1), 0, d - 1)
    y0, x0, z0 = (torch.floor(v).long() for v in (ys, xs, gz))
    fy = (ys - y0)[None, :, None]
    fx = (xs - x0)[None, None, :]
    fz = (gz - z0)[:, None]
    y1 = torch.clamp(y0 + 1, 0, gh - 1)
    x1 = torch.clamp(x0 + 1, 0, gw - 1)
    z1 = torch.clamp(z0 + 1, 0, d - 1)

    def corner(zi, yi, xi):
        gp = grid[:, :, :, yi[:, None], xi[None, :]]       # [B, C, D, H, W]
        zb = torch.broadcast_to(zi[:, None], (b, c, h, w))
        return torch.gather(gp, 2, zb[:, :, None])[:, :, 0]

    def plane(zi):
        return ((1 - fy) * ((1 - fx) * corner(zi, y0, x0)
                            + fx * corner(zi, y0, x1))
                + fy * ((1 - fx) * corner(zi, y1, x0)
                        + fx * corner(zi, y1, x1)))

    return {"Out": [(1 - fz) * plane(z0) + fz * plane(z1)]}


@register_op("fusion_conv_inception")
def _fusion_conv_inception(ins, attrs, ctx):
    """Parallel branches over Input, one a Filter: ``conv2d`` at stride 1
    with half the kernel's size as padding, plus its Bias, ReLU; the
    branches concatenated on channels."""
    x = _p(ins, "Input")
    bs = ins.get("Bias", [])
    outs = []
    for i, w in enumerate(ins["Filter"]):
        y = get_op("conv2d").fn(
            {"Input": [x], "Filter": [w]},
            {"strides": [1, 1],
             "paddings": [w.shape[2] // 2, w.shape[3] // 2]}, ctx)["Output"][0]
        if i < len(bs):
            y = y + bs[i].reshape(1, -1, 1, 1)
        outs.append(torch.relu(y))
    return {"Output": [torch.cat(outs, dim=1)]}
