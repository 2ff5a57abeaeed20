"""Fused attention op (counterpart of ``paddle_tpu/ops/attention.py``).

``fused_multihead_attention`` computes ``softmax(scale·QKᵀ + mask)·V``
over ``[B, H, T, D]`` tensors; the ``fuse_attention`` pass
(fluid/passes/kernel_tier.py) produces it from the naive
matmul → scale → +mask → softmax → dropout → matmul chain.

Dispatch (``flash_attention``):

* a CPU tensor (and a ``meta`` tensor during shape inference) takes the
  plain version ``_reference_attention``;
* a CUDA tensor launches the hand-written Hopper kernel
  (ops/cuda_kernels.py, csrc/flash_attention.cu) or raises — there is no
  fallback.  Where autograd records (inside ``generic_grad``'s
  ``torch.func.vjp``), the launch goes through ``_FlashAttention``: its
  forward also writes each row's softmax statistics (max and sum), and
  its backward is the hand-written backward kernel;
* the two cases the TPU package also keeps off its kernel take the plain
  version on every device: live attention dropout (training) and
  ``prob_scale`` (downgrade_in_infer at test time).

There is no sequence-length crossover: the kernel runs at every length.
"""
from __future__ import annotations

import math

import torch

from . import cuda_kernels
from .nn_ops import _key_words, _reference_dropout, _scale_for, \
    _threshold_for
from .registry import register_op


def _scores(q, k, mask, scale, causal):
    """fp32 ``scale·QKᵀ + mask``, causal positions at the fp32 minimum.
    The products are ``torch.matmul``, as the ``matmul`` lowering spells
    them, so the fused op and its autodiff on the host are bit-identical
    to the unfused chain."""
    acc = torch.float32
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if causal:
        t = s.shape[-1]
        causal_mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                            device=s.device))
        s = torch.where(causal_mask, s, torch.finfo(acc).min)
    if mask is not None:
        s = s + mask.to(acc)
    return s


def _reference_attention(q, k, v, mask, scale, causal,
                         dropout_rate=0.0, dropout_key=None,
                         dropout_upscale=True, prob_scale=None):
    """Plain PyTorch version, line for line the TPU package's
    ``_reference_attention``: fp32 scores, causal masking with the fp32
    minimum, probabilities cast to q's dtype before the product with V,
    dropout on the probabilities (the ``dropout`` op's Philox mask under
    the key words ``dropout_key``, so the fused op drops what the chain
    it replaced dropped)."""
    s = _scores(q, k, mask, scale, causal)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    if dropout_rate:
        p = _reference_dropout(p, *dropout_key,
                               _threshold_for(dropout_rate),
                               _scale_for(dropout_rate, dropout_upscale))
    elif prob_scale is not None:
        p = (p * prob_scale).to(p.dtype)
    return torch.matmul(p, v)


def _reference_stats(q, k, mask, scale, causal):
    """Each row's softmax statistics, ``(m, l)`` float32 ``[B, H, Tq]``:
    the max of the scores and the sum of ``exp(score - m)``, the plain
    version of the forward kernel's ``return_stats`` outputs.  The two
    stay apart (no folded log-sum-exp): the static BERT program's padding
    bias is near -1e8, where float32 would round ``m + log l`` to
    ``m``."""
    s = _scores(q, k, mask, scale, causal)
    m = s.amax(dim=-1)
    return m, torch.exp(s - m[..., None]).sum(dim=-1)


def _reference_attention_bwd(q, k, v, mask, scale, o, m, l, do,
                             causal=False):
    """(dQ, dK, dV) of ``softmax(scale·QKᵀ + mask)·V`` from the saved
    output and softmax statistics: the plain version of the backward
    kernel, the same recurrence in float32.  ``P = exp(S - m) / l``,
    ``Δ = rowsum(dO∘O)``, ``dS = P∘(dO·Vᵀ - Δ)``; ``dV = Pᵀ·dO``,
    ``dQ = scale·dS·K``, ``dK = scale·dSᵀ·Q``.  The mask gets no
    gradient."""
    acc = torch.float32
    p = torch.exp(_scores(q, k, mask, scale, causal) - m[..., None]) \
        / l[..., None]
    do32 = do.to(acc)
    delta = (do32 * o.to(acc)).sum(-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), do32)
    ds = p * (torch.matmul(do32, v.to(acc).transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, k.to(acc)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The backward kernel's launch as a dispatcher op.  Under torch.func.vjp
# the tensors a Function saves come back to its backward wrapped by
# functorch, and a wrapped tensor has no data pointer; a dispatcher op
# unwraps its arguments before its implementation runs.
@torch.library.custom_op(
    "paddle_tpu_torch::flash_attention_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? mask, float scale, "
           "bool causal, Tensor o, Tensor m, Tensor l, Tensor do) -> "
           "(Tensor, Tensor, Tensor)")
def _flash_attention_bwd(q, k, v, mask, scale, causal, o, m, l, do):
    return cuda_kernels.flash_attention_bwd(q, k, v, mask, scale, causal, o,
                                            m, l, do)


class _FlashAttention(torch.autograd.Function):
    """The card's attention under autograd: the forward kernel, which
    also writes the row softmax statistics, and the backward kernel.
    Forward and ``setup_context`` are separate so ``torch.func.vjp`` (the
    ``generic_grad`` lowering) can call it."""

    @staticmethod
    def forward(q, k, v, mask, scale, causal):
        return cuda_kernels.flash_attention_fwd(q, k, v, mask, scale, causal,
                                                return_stats=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, mask, scale, causal = inputs
        o, m, l = output
        ctx.save_for_backward(q, k, v, mask, o, m, l)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(m, l)

    @staticmethod
    def backward(ctx, do, _dm, _dl):
        q, k, v, mask, o, m, l = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        # under torch.func.grad the saved tensors still require grad at
        # the transform's level; launching with grad on would send the
        # custom op back into autograd, which it has no rule for
        with torch.no_grad():
            dq, dk, dv = _flash_attention_bwd(q, k, v, mask, ctx.scale,
                                              ctx.causal, o, m, l, do)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, mask=None, scale=None, causal=False,
                    dropout_rate=0.0, dropout_key=None,
                    dropout_upscale=True, prob_scale=None):
    """``softmax(scale·QKᵀ + mask)·V`` on the kernel for CUDA tensors,
    on the plain version otherwise (see the module docstring)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    drop_active = bool(dropout_rate) and dropout_key is not None
    if q.device.type == "cuda" and not drop_active and prob_scale is None:
        if torch.is_grad_enabled():
            return _FlashAttention.apply(q, k, v, mask, scale, causal)[0]
        return cuda_kernels.flash_attention_fwd(q, k, v, mask, scale, causal)
    return _reference_attention(q, k, v, mask, scale, causal,
                                dropout_rate if drop_active else 0.0,
                                dropout_key, dropout_upscale, prob_scale)


@register_op("fused_multihead_attention", nondiff_inputs=("Mask",))
def _fused_mha(ins, attrs, ctx):
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    mask = ins["Mask"][0] if ins.get("Mask") else None
    # attention-dropout attrs stamped by fuse_attention when it absorbs a
    # dropout op; in serving, ctx.is_test (the frozen program's hint)
    # turns it off and keeps the op on the kernel
    rate = float(attrs.get("dropout_rate", 0.0) or 0.0)
    dropout_key = None
    prob_scale = None
    upscale = attrs.get("dropout_implementation",
                        "downgrade_in_infer") == "upscale_in_train"
    if rate:
        if attrs.get("dropout_is_test", False) or ctx.is_test:
            if not upscale:
                prob_scale = 1.0 - rate
        else:
            dropout_key = _key_words(ctx.seed_for(
                attrs.get("dropout_seed", 0)))
    out = flash_attention(q, k, v, mask,
                          scale=attrs.get("scale", None),
                          causal=attrs.get("causal", False),
                          dropout_rate=rate, dropout_key=dropout_key,
                          dropout_upscale=upscale, prob_scale=prob_scale)
    return {"Out": [out]}
