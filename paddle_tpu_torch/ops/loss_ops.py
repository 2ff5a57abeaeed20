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
