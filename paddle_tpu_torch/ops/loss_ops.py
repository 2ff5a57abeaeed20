"""Loss lowerings (counterpart of ``paddle_tpu/ops/loss_ops.py``, the ops
the training slices run).

``softmax_with_cross_entropy`` keeps its integer ``Label`` in a nondiff
slot and carries a custom grad, ``softmax - onehot(label)``, which is
what the fused reference kernel computes, instead of differentiating
through the log-softmax composition.
"""
from __future__ import annotations

import torch

from .registry import register_op


def _xent_norm(logits, axis):
    """(shifted logits, log-sum-exp), both at least float32: the
    streaming log-softmax pieces with float32 accumulation."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    lmax = logits.detach().amax(dim=axis, keepdim=True).to(acc)
    shifted = logits.to(acc) - lmax
    lse = torch.log(torch.exp(shifted).sum(dim=axis, keepdim=True))
    return shifted, lse


def _to_last_axis(logits, label, axis):
    """Move the class axis to -1; returns (logits, label, restore_fn)."""
    ax = axis if axis >= 0 else logits.ndim + axis
    if ax == logits.ndim - 1:
        return logits, label, lambda t: t
    lg = torch.movedim(logits, ax, -1)
    lb = torch.movedim(label, ax, -1) if label.ndim == logits.ndim \
        else label
    return lg, lb, lambda t: torch.movedim(t, -1, ax)


def _hard_label(label, logits):
    lbl = label.long()
    if lbl.ndim == logits.ndim:
        lbl = lbl.squeeze(-1)
    return lbl


def _softmax_xent_fwd(ins, attrs, ctx):
    logits, label = ins["Logits"][0], ins["Label"][0]
    logits, label, restore = _to_last_axis(logits, label,
                                           attrs.get("axis", -1))
    shifted, lse = _xent_norm(logits, -1)
    softmax = torch.exp(shifted - lse).to(logits.dtype)
    if attrs.get("soft_label", False):
        loss = torch.sum(label.to(shifted.dtype) * (lse - shifted), dim=-1,
                         keepdim=True)
    else:
        lbl = _hard_label(label, logits)
        picked = torch.gather(shifted, -1, lbl.clamp(min=0)[..., None])
        loss = lse - picked
        ignore = attrs.get("ignore_index", -100)
        loss = torch.where(lbl[..., None] == ignore,
                           torch.zeros((), dtype=loss.dtype,
                                       device=loss.device), loss)
    return {"Softmax": [restore(softmax)], "Loss": [restore(loss)]}


def _softmax_xent_grad(ins, outs, out_grads, attrs, ctx):
    """d(loss)/d(logits) = (softmax - onehot(label)) · g, softmax
    recomputed from the logits."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    gloss = out_grads.get("Loss")
    if gloss is None:
        return {"Logits": [torch.zeros_like(logits)]}
    dtype = logits.dtype
    logits, label, restore = _to_last_axis(logits, label,
                                           attrs.get("axis", -1))
    ax = attrs.get("axis", -1)
    ax = ax if ax >= 0 else logits.ndim + ax
    if ax != logits.ndim - 1:
        gloss = torch.movedim(gloss, ax, -1)
    shifted, lse = _xent_norm(logits, -1)
    softmax = torch.exp(shifted - lse)
    gloss = gloss.to(softmax.dtype)
    if attrs.get("soft_label", False):
        grad = (softmax - label.to(softmax.dtype)) * gloss
    else:
        lbl = _hard_label(label, logits)
        classes = torch.arange(logits.shape[-1], device=logits.device)
        onehot = (classes == lbl[..., None]).to(softmax.dtype)
        ignore = attrs.get("ignore_index", -100)
        mask = (lbl != ignore)[..., None].to(softmax.dtype)
        grad = (softmax - onehot) * gloss * mask
    return {"Logits": [restore(grad).to(dtype)]}


register_op("softmax_with_cross_entropy", _softmax_xent_fwd,
            nondiff_inputs=("Label",), nondiff_outputs=("Softmax",),
            custom_grad=_softmax_xent_grad)


def _and_batch_mask(mask, x, ctx):
    """Fold the shape-bucketing row mask (the padded tail rows) into an
    op's own validity mask, so its counts and denominators see only the
    true batch."""
    bm = ctx.batch_mask(x.shape[0]) if x.ndim else None
    if bm is None:
        return mask
    return mask * bm.reshape((x.shape[0],) + (1,) * (mask.ndim - 1)) \
        .to(mask.dtype)


@register_op("sigmoid_cross_entropy_with_logits", nondiff_inputs=("Label",))
def _sce(ins, attrs, ctx):
    """Elementwise ``max(x, 0) - x·label + log1p(exp(-|x|))``, zero where
    the label is ``ignore_index`` or the row is bucket padding; with
    ``normalize``, divided by the count of the other entries."""
    x, label = ins["X"][0], ins["Label"][0]
    ignore = attrs.get("ignore_index", -100)
    loss = torch.clamp(x, min=0.0) - x * label \
        + torch.log1p(torch.exp(-torch.abs(x)))
    mask = _and_batch_mask((label != ignore).to(x.dtype), x, ctx)
    loss = loss * mask
    if attrs.get("normalize", False):
        loss = loss / torch.clamp(torch.sum(mask), min=1.0)
    return {"Out": [loss]}


@register_op("mse_loss", nondiff_inputs=("Label",))
def _mse(ins, attrs, ctx):
    x, y = ins["Input"][0], ins["Label"][0]
    return {"Out": [torch.square(x - y)]}


# --- metrics ---------------------------------------------------------------
@register_op("accuracy", differentiable=False)
def _accuracy(ins, attrs, ctx):
    """The share of rows whose label is among the top-k ``Indices``;
    ``Correct`` and ``Total`` are int32.  Under shape bucketing the
    padded rows are neither correct nor counted."""
    pred_idx = ins["Indices"][0].long()
    label = ins["Label"][0].long()
    if label.ndim < pred_idx.ndim:
        label = label[..., None]
    correct = torch.any(pred_idx == label, dim=-1)
    bm = ctx.batch_mask(correct.shape[0]) if correct.ndim else None
    total = correct.numel()
    if bm is not None:
        row = bm.reshape((correct.shape[0],) + (1,) * (correct.ndim - 1))
        correct = correct & row
        total = ctx.batch_valid * (total // correct.shape[0])
    num_correct = torch.sum(correct.to(torch.float32))
    return {"Accuracy": [num_correct / total],
            "Correct": [num_correct.to(torch.int32)],
            "Total": [torch.full((), total, dtype=torch.int32,
                                 device=correct.device)]}


# --------------------------------------------------------------------------
# the 2.0 losses (nn.functional, nn.layer's loss classes)
# --------------------------------------------------------------------------
@register_op("bce_loss", nondiff_inputs=("Label",))
def _bce(ins, attrs, ctx):
    x, label = ins["X"][0], ins["Label"][0]
    xc = torch.minimum(torch.maximum(x, x.new_full((), 1e-12)),
                       x.new_full((), 1.0 - 1e-7))
    return {"Out": [-(label * torch.log(xc)
                      + (1 - label) * torch.log1p(-xc))]}


@register_op("log_loss", nondiff_inputs=("Labels",))
def _log_loss(ins, attrs, ctx):
    p, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(p + eps)
                     - (1 - label) * torch.log(1 - p + eps)]}


@register_op("huber_loss", nondiff_inputs=("Y",))
def _huber(ins, attrs, ctx):
    x, y = ins["X"][0], ins["Y"][0]
    d = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    return {"Out": [torch.where(ar <= d, 0.5 * r * r, d * (ar - 0.5 * d))],
            "Residual": [r]}


@register_op("kldiv_loss", nondiff_inputs=("Target",))
def _kldiv(ins, attrs, ctx):
    """``t (log t - x)`` where t > 0; the reductions leave the padded
    rows of a bucketed batch out, and ``batchmean`` divides by the true
    row count."""
    from .reduction import masked_batch_reduce
    x, t = ins["X"][0], ins["Target"][0]
    loss = torch.where(t > 0, t * (torch.log(t) - x), torch.zeros_like(x))
    red = attrs.get("reduction", "mean")
    every = tuple(range(loss.ndim))
    if red == "mean":
        m = masked_batch_reduce(loss, ctx, every, mean=True)
        loss = torch.mean(loss) if m is None else m
    elif red == "sum":
        m = masked_batch_reduce(loss, ctx, every)
        loss = torch.sum(loss) if m is None else m
    elif red == "batchmean":
        m = masked_batch_reduce(loss, ctx, every)
        loss = torch.sum(loss) / x.shape[0] if m is None \
            else m / ctx.batch_valid
    return {"Loss": [loss]}


@register_op("nll_loss", nondiff_inputs=("Label", "Weight"))
def _nll(ins, attrs, ctx):
    """The picked log-probabilities, weighted, with ``ignore_index``
    masked; "mean" divides by the weights' sum over the kept rows."""
    x, label = ins["X"][0], ins["Label"][0].long()
    w = ins["Weight"][0] if ins.get("Weight") \
        else torch.ones((x.shape[1],), dtype=x.dtype, device=x.device)
    picked = torch.take_along_dim(x, label[:, None], dim=1).squeeze(1)
    wl = w.index_select(0, torch.clamp(label, min=0))
    mask = _and_batch_mask(
        (label != attrs.get("ignore_index", -100)).to(x.dtype), x, ctx)
    loss = -picked * wl * mask
    total_w = torch.sum(wl * mask)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        out = torch.sum(loss) / torch.clamp(total_w, min=1e-12)
    elif red == "sum":
        out = torch.sum(loss)
    else:
        out = loss
    return {"Out": [out], "Total_weight": [total_w]}


@register_op("label_smooth", nondiff_inputs=("PriorDist",))
def _label_smooth(ins, attrs, ctx):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    if ins.get("PriorDist"):
        return {"Out": [(1 - eps) * x + eps * ins["PriorDist"][0]]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


# -- the plain losses of the image layers' slice ------------------------------
@register_op("cross_entropy", nondiff_inputs=("Label",))
def _cross_entropy(ins, attrs, ctx):
    """``-log p[label]`` of probabilities X (clipped at 1e-12), 0 where
    the label is ``ignore_index``; with ``soft_label`` the label
    distribution's ``-Σ label · log p``."""
    x, label = ins["X"][0], ins["Label"][0]
    if attrs.get("soft_label", False):
        return {"Y": [-torch.sum(label * torch.log(torch.clamp(x, min=1e-12)),
                                 dim=-1, keepdim=True)]}
    lbl = label.to(torch.int64)
    if lbl.ndim == x.ndim:
        lbl = lbl.squeeze(-1)
    lbl = lbl.unsqueeze(-1)
    ignored = lbl == attrs.get("ignore_index", -100)
    picked = torch.gather(x, -1, torch.where(ignored, 0, lbl))
    out = -torch.log(torch.clamp(picked, min=1e-12))
    return {"Y": [torch.where(ignored, torch.zeros_like(out), out)]}


@register_op("smooth_l1_loss",
             nondiff_inputs=("Y", "InsideWeight", "OutsideWeight"))
def _smooth_l1(ins, attrs, ctx):
    """Per-row sums ``[N, 1]`` of ``½σ²d²`` where ``|d| < 1/σ²``, else
    ``|d| - ½/σ²``, d = (X - Y)·InsideWeight, each term times
    OutsideWeight."""
    x, y = ins["X"][0], ins["Y"][0]
    s2 = attrs.get("sigma", 1.0) ** 2
    diff = x - y
    if ins.get("InsideWeight"):
        diff = diff * ins["InsideWeight"][0]
    ad = torch.abs(diff)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if ins.get("OutsideWeight"):
        loss = loss * ins["OutsideWeight"][0]
    return {"Out": [torch.sum(loss, dim=tuple(range(1, loss.ndim)))
                    .reshape(-1, 1)], "Diff": [diff]}


@register_op("hinge_loss", nondiff_inputs=("Labels",))
def _hinge(ins, attrs, ctx):
    logits, labels = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": [torch.clamp(1.0 - (2.0 * labels - 1.0) * logits,
                                 min=0.0)]}


@register_op("rank_loss", nondiff_inputs=("Label",))
def _rank_loss(ins, attrs, ctx):
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": [torch.log1p(torch.exp(d)) - ins["Label"][0] * d]}


@register_op("margin_rank_loss", nondiff_inputs=("Label",))
def _margin_rank(ins, attrs, ctx):
    label, x1, x2 = ins["Label"][0], ins["X1"][0], ins["X2"][0]
    out = torch.clamp(-label * (x1 - x2) + attrs.get("margin", 0.0), min=0.0)
    return {"Out": [out], "Activated": [(out > 0).to(x1.dtype)]}


@register_op("bpr_loss", nondiff_inputs=("Label",))
def _bpr(ins, attrs, ctx):
    """``-Σ_{j ≠ label} log σ(x_label - x_j) / (C - 1)``: the label's own
    column left out, the mean over the C - 1 negatives."""
    x, label = ins["X"][0], ins["Label"][0].to(torch.int64)
    c = x.shape[1]
    pos = torch.gather(x, 1, label)
    term = torch.log(torch.sigmoid(pos - x) + 1e-8)
    is_label = (torch.arange(c, device=x.device)[None, :] == label) \
        .to(x.dtype)
    return {"Y": [-(term * (1.0 - is_label)).sum(dim=1, keepdim=True)
                  / max(c - 1, 1)]}


@register_op("auc", differentiable=False)
def _auc(ins, attrs, ctx):
    """Streaming AUC (metrics/auc_op.cc): the batch's positives and
    negatives added into the persistable ``num_thresholds + 1`` bucket
    histograms by ``Predict[:, -1]``, then the ROC area by trapezoids
    over the thresholds, high to low.  Under shape bucketing the padded
    rows add nothing.  ``curve`` and ``slide_steps`` are not read, as in
    the reference.  The counts are integers in float32, exact below 2^24
    a bucket, so ``index_add_``'s order does not change them."""
    preds, labels = ins["Predict"][0], ins["Label"][0]
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    nt = attrs.get("num_thresholds", 4095)
    p1 = preds[:, -1] if preds.ndim > 1 else preds
    idx = torch.clamp((p1 * nt).to(torch.int64), 0, nt)
    lbl = labels.reshape(-1).to(torch.float32)
    bm = ctx.batch_mask(p1.shape[0])
    row_w = bm.to(torch.float32) if bm is not None else torch.ones_like(lbl)
    pos_new = stat_pos.reshape(-1).clone().index_add_(0, idx, lbl * row_w)
    neg_new = stat_neg.reshape(-1).clone().index_add_(
        0, idx, (1.0 - lbl) * row_w)
    tp = torch.cumsum(torch.flip(pos_new, [0]), 0)
    fp = torch.cumsum(torch.flip(neg_new, [0]), 0)
    tot_pos, tot_neg = tp[-1], fp[-1]
    zero = tp.new_zeros(1)
    tp_prev = torch.cat([zero, tp[:-1]])
    fp_prev = torch.cat([zero, fp[:-1]])
    area = torch.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
    auc = torch.where(tot_pos * tot_neg > 0,
                      area / (tot_pos * tot_neg + 1e-12),
                      torch.zeros_like(area))
    return {"AUC": [auc], "StatPosOut": [pos_new.reshape(stat_pos.shape)],
            "StatNegOut": [neg_new.reshape(stat_neg.shape)]}


@register_op("precision_recall", differentiable=False)
def _precision_recall(ins, attrs, ctx):
    """precision_recall_op.cc: each class's TP/FP/TN/FN from (Indices,
    Labels[, Weights]) -> [macro P, R, F1, micro P, R, F1] for the batch
    and for the states accumulated over ``StatesInfo``.  A class with an
    empty denominator counts P or R as 1.0; macro F1 is the F1 of the
    macro P and R (precision_recall_op.h)."""
    idx = ins["Indices"][0].to(torch.int64).reshape(-1)
    label = ins["Labels"][0].to(torch.int64).reshape(-1)
    n_cls = int(attrs["class_number"])
    w = (ins["Weights"][0].to(torch.float32).reshape(-1)
         if ins.get("Weights") else torch.ones(idx.shape, device=idx.device))
    bm = ctx.batch_mask(idx.shape[0])
    if bm is not None:      # shape bucketing: padded rows carry no weight
        w = w * bm.to(torch.float32)
    pred_1h = torch.nn.functional.one_hot(idx, n_cls).to(torch.float32)
    true_1h = torch.nn.functional.one_hot(label, n_cls).to(torch.float32)
    hit = (idx == label).to(torch.float32) * w
    tp = torch.einsum("n,nc->c", hit, true_1h)
    fp = torch.einsum("n,nc->c", w, pred_1h) - tp
    fn = torch.einsum("n,nc->c", w, true_1h) - tp
    tn = torch.sum(w) - tp - fp - fn
    batch_states = torch.stack([tp, fp, tn, fn], dim=1)       # [C, 4]
    accum_states = batch_states
    if ins.get("StatesInfo"):
        accum_states = accum_states + ins["StatesInfo"][0].to(torch.float32)

    def ratio(num, den):
        return torch.where(den > 0, num / (den + 1e-12),
                           torch.ones_like(num))

    def f1_of(p, r):
        return torch.where(p + r > 0, 2 * p * r / (p + r + 1e-12),
                           torch.zeros_like(p))

    def metrics(states):
        tp_, fp_, fn_ = states[:, 0], states[:, 1], states[:, 3]
        macro_p = ratio(tp_, tp_ + fp_).mean()
        macro_r = ratio(tp_, tp_ + fn_).mean()
        tps, fps, fns = tp_.sum(), fp_.sum(), fn_.sum()
        mp, mr = ratio(tps, tps + fps), ratio(tps, tps + fns)
        return torch.stack([macro_p, macro_r, f1_of(macro_p, macro_r),
                            mp, mr, f1_of(mp, mr)])

    return {"BatchMetrics": [metrics(batch_states)],
            "AccumMetrics": [metrics(accum_states)],
            "AccumStatesInfo": [accum_states]}


@register_op("mean_iou", differentiable=False)
def _mean_iou(ins, attrs, ctx):
    """The mean over classes present in either input of each class's
    intersection over union, from the confusion matrix (counted by
    ``bincount``: exact and in a fixed order on either device)."""
    pred = ins["Predictions"][0].to(torch.int64).reshape(-1)
    label = ins["Labels"][0].to(torch.int64).reshape(-1)
    n = attrs["num_classes"]
    cm = torch.bincount(label * n + pred, minlength=n * n).reshape(n, n) \
        .to(torch.float32)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp(union, min=1e-12),
                      torch.zeros_like(inter))
    mean_iou = torch.sum(iou) / torch.clamp(valid.sum(), min=1)
    return {"OutMeanIou": [mean_iou],
            "OutWrong": [(cm.sum(1) - inter).to(torch.int32)],
            "OutCorrect": [inter.to(torch.int32)]}
