"""Fused attention op (counterpart of ``paddle_tpu/ops/attention.py``).

``fused_multihead_attention`` computes ``softmax(scale·QKᵀ + mask)·V``
over ``[B, H, T, D]`` tensors; the ``fuse_attention`` pass
(fluid/passes/kernel_tier.py) produces it from the naive
matmul → scale → +mask → softmax → dropout → matmul chain.
``multihead_matmul``, Paddle Inference's ERNIE form, reads Q, K and V
from one packed ``[B, T, 3·H·D]`` tensor and takes the same dispatch.

Dispatch (``flash_attention``):

* a CPU tensor (and a ``meta`` tensor during shape inference) takes the
  plain version ``_reference_attention``;
* a CUDA tensor launches the hand-written Hopper kernel
  (ops/cuda_kernels.py, csrc/flash_attention.cu) or raises — there is no
  fallback.  With grad off the call goes through the dispatcher op
  ``paddle_tpu_torch::flash_attention_fwd`` (``flash_attention_fwd_op``:
  the kernel on CUDA, the plain version on the host, a fake for
  ``torch.export``), the op an exported graph holds.  Where autograd
  records (inside ``generic_grad``'s
  ``torch.func.vjp``), the launch goes through ``_FlashAttention``: its
  forward also writes each row's softmax statistics (max and sum), and
  its backward is the hand-written backward kernel;
* the two cases the TPU package also keeps off its kernel take the plain
  version on every device: live attention dropout (training) and
  ``prob_scale`` (downgrade_in_infer at test time).

There is no sequence-length crossover: the kernel runs at every length.

``paged_attention`` is the decode step's attention over block-paged K/V
pools (serving/decode.py); the ``fuse_paged_attention`` pass produces it
from the demo paged program's gather → mul+reduce_sum → scale → masked
add → softmax → mul+reduce_sum chain.  A CPU (or ``meta``) tensor takes
the plain version ``_paged_reference``; a CUDA tensor launches the
hand-written kernel (csrc/paged_attention.cu) or raises.  The
reference's TPU gate (head dim a multiple of 128, both pools inside an
8 MB VMEM budget) and its ``page_size → 1`` downgrade encode the TPU's
layout, not the op's meaning, and have no counterpart: the kernel reads
the page table per position, so the ``page_size`` attr is carried for
the IR's sake and read by nothing.
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


# The forward kernel's launch as a dispatcher op, the one an exported
# eval forward (``paddle.jit.save``'s ``torch.export``) holds: export
# traces on fake tensors, which have no data pointer for a ctypes launch.
# Its fake gives the output's shape, its default (host) implementation
# is the plain version, and its CUDA implementation launches the kernel.
@torch.library.custom_op(
    "paddle_tpu_torch::flash_attention_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? mask, float scale, "
           "bool causal) -> Tensor")
def flash_attention_fwd_op(q, k, v, mask, scale, causal):
    return _reference_attention(q, k, v, mask, scale, causal)


@flash_attention_fwd_op.register_kernel("cuda")
def _flash_attention_fwd_cuda(q, k, v, mask, scale, causal):
    return cuda_kernels.flash_attention_fwd(q, k, v, mask, scale, causal)


@flash_attention_fwd_op.register_fake
def _flash_attention_fwd_fake(q, k, v, mask, scale, causal):
    return q.new_empty((*q.shape[:-1], v.shape[-1]))


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
    if not drop_active and prob_scale is None:
        if not torch.is_grad_enabled():
            return flash_attention_fwd_op(q, k, v, mask, float(scale),
                                          bool(causal))
        if q.device.type == "cuda":
            return _FlashAttention.apply(q, k, v, mask, scale, causal)[0]
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


@register_op("multihead_matmul", nondiff_inputs=("BiasQK",))
def _multihead_matmul(ins, attrs, ctx):
    """Paddle Inference's fused attention over a packed QKV: ``Input``
    [B, T, 3·H·D] laid out (3, H, D) on its last axis, ``BiasQK`` added
    to the scores, ``alpha`` the scale (1/sqrt(D) when absent).  Q, K and
    V are strided views of the packed tensor, which the kernel reads in
    place; ``Out`` [B, T, H·D]."""
    x = ins["Input"][0]
    bias_qk = ins["BiasQK"][0] if ins.get("BiasQK") else None
    h = attrs["head_number"]
    b, t, c3 = x.shape
    d = c3 // 3 // h
    qkv = x.reshape(b, t, 3, h, d).permute(2, 0, 3, 1, 4)
    out = flash_attention(qkv[0], qkv[1], qkv[2], bias_qk,
                          scale=attrs.get("alpha", None))
    return {"Out": [out.permute(0, 2, 1, 3).reshape(b, t, h * d)]}


def _paged_reference(q, kp, vp, idx, valid, scale, neg):
    """Plain PyTorch version, op for op the unfused decode chain as the
    port lowers it (``index_select`` for gather, the same reduce axes,
    ``x * scale + 0.0`` for scale, the masked add ``s·valid +
    (valid·neg - neg)``, ``softmax``), so the rewrite is bit-transparent
    on the host.  q ``[B, d]``, pools ``[R, d]``, idx ``B·S`` pool rows,
    valid ``[B, S]``."""
    b = q.shape[0]
    s_len = valid.shape[1]
    d = kp.shape[-1]
    ii = idx.reshape(-1).long()
    kg = kp.index_select(0, ii).reshape(b, s_len, d)
    vg = vp.index_select(0, ii).reshape(b, s_len, d)
    s = torch.sum(kg * q.reshape(b, 1, d), dim=(2,))
    s = s * scale + 0.0
    s = s * valid + (valid * neg + (-neg))
    p = torch.softmax(s, dim=-1)
    return torch.sum(vg * p.reshape(b, s_len, 1), dim=(1,))


def paged_attention(q, kp, vp, idx, valid, scale, neg=1e30):
    """Decode attention over paged pools: the kernel for CUDA tensors,
    the plain version otherwise (see the module docstring)."""
    if q.device.type == "cuda":
        # the page table is int32 (as the reference casts it); a wider
        # index is narrowed, never the path of the decode programs
        b, s_len = valid.shape
        return cuda_kernels.paged_attention(
            q, kp, vp, idx.reshape(b, s_len).to(torch.int32), valid, scale,
            neg)
    return _paged_reference(q, kp, vp, idx, valid, scale, neg)


@register_op("paged_attention", nondiff_inputs=("Index", "Valid"))
def _paged_attention(ins, attrs, ctx):
    """Decode-step attention over a block-paged KV pool.  Q ``[B, d]``;
    KPool/VPool ``[R, d]`` flat page pools; Index ``[B·S]`` (or
    ``[B, S]``) int32 pool row per logical position; Valid ``[B, S]``
    float 0/1 mask."""
    out = paged_attention(ins["Q"][0], ins["KPool"][0], ins["VPool"][0],
                          ins["Index"][0], ins["Valid"][0],
                          float(attrs.get("scale", 1.0)),
                          float(attrs.get("neg", 1e30)))
    return {"Out": [out]}
