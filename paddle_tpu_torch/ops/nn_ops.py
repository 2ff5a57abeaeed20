"""Neural-net lowerings (counterpart of ``paddle_tpu/ops/nn_ops.py``, the
ops the ported slices run): softmax, layer_norm, conv2d, pool2d,
batch_norm, and the dropout family — ``dropout``, ``fused_dropout_add``
(``dropout(x) + residual``) and ``fused_act_dropout`` (``dropout(act(x))``,
gelu or relu).  conv2d and pool2d are PyTorch library calls (cuDNN on
the card): the reference computes them with XLA, outside any Pallas
kernel.

The random bits.  The reference draws its masks from
``jax.random.bernoulli`` or the TPU core's PRNG; torch can reproduce
neither.  Every mask here is Philox4x32-10 (``philox4x32``): element
``i`` of the flattened tensor takes word ``i % 4`` of
``philox4x32(counter=(i // 4 mod 2^32, i // 2^34, 0, 0), key)``, the key
being the two 32-bit words of the op's 64-bit seed
(``LoweringContext.seed_for``), and is kept when ``bits >=
_threshold_for(rate)``.  The mask is a function of (seed, flat index)
alone, so the backward regenerates it, and the plain version
(``_reference_keep``, integer tensor ops) gives the CUDA kernel's bits on
any device.  Masks are never compared with the reference's.

Kept values are ``x · scale`` in float32 with ``scale`` the float32
``1/(1-rate)`` (upscale_in_train) or 1 (downgrade_in_infer), rounded once
to the input's dtype; dropout-add adds the residual in float32 before
that rounding.

Dispatch: each kernel launch is a ``torch.library.custom_op`` whose
implementation takes the plain version for a CPU tensor and launches the
hand-written Hopper kernel (``ops/cuda_kernels.py``,
``csrc/fused_dropout.cu``) for a CUDA tensor, or raises.  Autograd goes
through a ``torch.autograd.Function`` around it (``setup_context`` kept
apart, so ``torch.func.grad`` and ``torch.func.vjp`` can use it) that
saves the seed (and ``x`` for act-dropout) and whose backward is the
kernel again: dropout's and dropout-add's ``dx`` is the dropout kernel
applied to ``g``, the residual's cotangent is ``g``, act-dropout's is its
backward kernel.  The ``dropout`` op also carries that gradient as its
``custom_grad``, so the tape and a static backward launch the kernel on
the cotangent and run no forward again.  The backward launches under
``torch.no_grad()``: under ``torch.func`` the saved tensors are wrapped,
and an op whose inputs require grad would otherwise re-enter autograd.  The cases the reference
also keeps off its kernels stay plain on every device: ``is_test``,
``rate <= 0``, ``rate >= 1``, and a residual whose shape differs from x.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_kernels
from .registry import register_op

# Random123's philox4x32 round multipliers and Weyl key increments
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _threshold_for(rate: float) -> int:
    """P(bits >= threshold) == 1 - rate over uint32 (the reference's
    ``pallas_kernels._threshold_for``)."""
    return min(int(rate * 4294967296.0), 4294967295)


def _scale_for(rate: float, upscale: bool) -> float:
    """The kept values' factor, a float32 value."""
    return float(np.float32(1.0 / (1.0 - rate))) if upscale else 1.0


def _mulhilo(m: int, a):
    """(high, low) 32-bit words of ``m · a``, a an int64 tensor of 32-bit
    values, exact: the product is formed from a's 16-bit halves so no
    intermediate leaves int64."""
    p_lo = (a & 0xFFFF) * m                  # < 2^48
    p_hi = (a >> 16) * m                     # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)     # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 over int64 tensors of 32-bit counter words (they
    broadcast) under the key (k0, k1); returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _key_words(seed: int):
    """The 64-bit seed's (low, high) 32-bit words, the Philox key."""
    return seed & _U32, (seed >> 32) & _U32


def _reference_bits(shape, k0: int, k1: int, device):
    """The uint32 Philox words of every element of ``shape``, in
    row-major order, as int64."""
    n = math.prod(shape)
    j = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32(j & _U32, j >> 32, zero, zero, k0, k1)
    return torch.stack(words, dim=-1).reshape(-1)[:n].reshape(shape)


def _reference_keep(shape, k0: int, k1: int, threshold: int, device):
    """The plain version of the kernels' keep mask (bool)."""
    return _reference_bits(shape, k0, k1, device) >= threshold


def _acc(dtype):
    """float32, or wider when the tensor is (float64 on the host)."""
    return torch.promote_types(dtype, torch.float32)


def _act(x, act):
    if act == "relu":
        return torch.relu(x)
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def _act_grad(x, act):
    if act == "relu":
        return (x > 0).to(x.dtype)
    return 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) \
        + x * 0.3989422804014327 * torch.exp(-0.5 * x * x)


def _reference_dropout(x, k0, k1, threshold, scale):
    keep = _reference_keep(x.shape, k0, k1, threshold, x.device)
    return torch.where(keep, x.to(_acc(x.dtype)) * scale, 0.0).to(x.dtype)


def _reference_dropout_add(x, r, k0, k1, threshold, scale):
    keep = _reference_keep(x.shape, k0, k1, threshold, x.device)
    dtype = torch.promote_types(x.dtype, r.dtype)
    acc = _acc(dtype)
    return (torch.where(keep, x.to(acc) * scale, 0.0) + r.to(acc)).to(dtype)


def _reference_act_dropout(x, k0, k1, threshold, scale, act):
    keep = _reference_keep(x.shape, k0, k1, threshold, x.device)
    a = _act(x.to(_acc(x.dtype)), act)
    return torch.where(keep, a * scale, 0.0).to(x.dtype)


def _reference_act_dropout_bwd(x, g, k0, k1, threshold, scale, act):
    keep = _reference_keep(x.shape, k0, k1, threshold, x.device)
    acc = _acc(x.dtype)
    return (torch.where(keep, g.to(acc) * scale, 0.0)
            * _act_grad(x.to(acc), act)).to(x.dtype)


# ---------------------------------------------------------------------------
# the launches: a CPU tensor takes the plain version, a CUDA tensor the
# kernel (or the wrapper raises)
# ---------------------------------------------------------------------------
def _seed(k0, k1):
    return k0 | (k1 << 32)


def _on_kernel(x):
    """A CUDA tensor launches the kernel; a host (or meta) one takes the
    plain version."""
    return x.device.type == "cuda"


@torch.library.custom_op("paddle_tpu_torch::dropout", mutates_args=())
def _dropout_launch(x: torch.Tensor, k0: int, k1: int, threshold: int,
                    scale: float) -> torch.Tensor:
    if _on_kernel(x):
        return cuda_kernels.fused_dropout(x.contiguous(), _seed(k0, k1),
                                          threshold, scale)
    return _reference_dropout(x, k0, k1, threshold, scale)


@torch.library.custom_op("paddle_tpu_torch::dropout_mask", mutates_args=())
def _mask_launch(x: torch.Tensor, k0: int, k1: int,
                 threshold: int) -> torch.Tensor:
    if _on_kernel(x):
        return cuda_kernels.dropout_mask(x, _seed(k0, k1), threshold)
    return _reference_keep(x.shape, k0, k1, threshold,
                           x.device).to(torch.uint8)


@torch.library.custom_op("paddle_tpu_torch::dropout_add", mutates_args=())
def _dropout_add_launch(x: torch.Tensor, r: torch.Tensor, k0: int, k1: int,
                        threshold: int, scale: float) -> torch.Tensor:
    if _on_kernel(x):
        dtype = torch.promote_types(x.dtype, r.dtype)
        return cuda_kernels.fused_dropout_add(
            x.to(dtype).contiguous(), r.to(dtype).contiguous(),
            _seed(k0, k1), threshold, scale)
    return _reference_dropout_add(x, r, k0, k1, threshold, scale)


@torch.library.custom_op("paddle_tpu_torch::act_dropout", mutates_args=())
def _act_dropout_launch(x: torch.Tensor, k0: int, k1: int, threshold: int,
                        scale: float, act: str) -> torch.Tensor:
    if _on_kernel(x):
        return cuda_kernels.fused_act_dropout(x.contiguous(), _seed(k0, k1),
                                              threshold, scale, act)
    return _reference_act_dropout(x, k0, k1, threshold, scale, act)


@torch.library.custom_op("paddle_tpu_torch::act_dropout_bwd",
                         mutates_args=())
def _act_dropout_bwd_launch(x: torch.Tensor, g: torch.Tensor, k0: int,
                            k1: int, threshold: int, scale: float,
                            act: str) -> torch.Tensor:
    if _on_kernel(x):
        return cuda_kernels.fused_act_dropout_bwd(
            x.contiguous(), g.to(x.dtype).contiguous(), _seed(k0, k1),
            threshold, scale, act)
    return _reference_act_dropout_bwd(x, g, k0, k1, threshold, scale, act)


@_dropout_launch.register_fake
def _(x, k0, k1, threshold, scale):
    return torch.empty_like(x)


@_mask_launch.register_fake
def _(x, k0, k1, threshold):
    return torch.empty(x.shape, dtype=torch.uint8, device=x.device)


@_dropout_add_launch.register_fake
def _(x, r, k0, k1, threshold, scale):
    return torch.empty(x.shape, dtype=torch.promote_types(x.dtype, r.dtype),
                       device=x.device)


@_act_dropout_launch.register_fake
def _(x, k0, k1, threshold, scale, act):
    return torch.empty_like(x)


@_act_dropout_bwd_launch.register_fake
def _(x, g, k0, k1, threshold, scale, act):
    return torch.empty_like(x)


class _Dropout(torch.autograd.Function):
    """dropout with the mask regenerated in the backward."""

    @staticmethod
    def forward(x, k0, k1, threshold, scale):
        return _dropout_launch(x, k0, k1, threshold, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            return (_dropout_launch(g, *ctx.args),) + (None,) * 4


class _DropoutAdd(torch.autograd.Function):
    """dropout(x) + r; dx is the dropout kernel on g, dr is g."""

    @staticmethod
    def forward(x, r, k0, k1, threshold, scale):
        return _dropout_add_launch(x, r, k0, k1, threshold, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[2:]
        ctx.dtypes = (inputs[0].dtype, inputs[1].dtype)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            dx = _dropout_launch(g.to(ctx.dtypes[0]), *ctx.args)
        return (dx, g.to(ctx.dtypes[1])) + (None,) * 4


class _ActDropout(torch.autograd.Function):
    """dropout(act(x)); the backward kernel regenerates the mask and
    recomputes act'(x) from the saved x."""

    @staticmethod
    def forward(x, k0, k1, threshold, scale, act):
        return _act_dropout_launch(x, k0, k1, threshold, scale, act)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        with torch.no_grad():
            dx = _act_dropout_bwd_launch(x, g, *ctx.args)
        return (dx,) + (None,) * 5


# ---------------------------------------------------------------------------
# lowerings
# ---------------------------------------------------------------------------
@register_op("softmax")
def _softmax(ins, attrs, ctx):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


def _op_key(attrs, ctx):
    """The Philox key words of this op's mask."""
    return _key_words(ctx.seed_for(attrs.get("op_seed",
                                             attrs.get("seed", 0) or 0)))


def _dropout_common(attrs, ctx):
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    upscale = (attrs.get("dropout_implementation", "upscale_in_train")
               == "upscale_in_train")
    return p, is_test, upscale


def _dropout_grad(ins, outs, out_grads, attrs, ctx):
    """dX without running the forward again: the dropout kernel on the
    cotangent, its mask regenerated from the op's seed (what
    ``_Dropout.backward`` launches), or the cotangent scaled as the
    forward's plain cases scale X.  A vjp over the lowering would launch
    the forward kernel and the mask once more in every backward."""
    x = ins["X"][0]
    g = out_grads.get("Out")
    if g is None:
        return {"X": [torch.zeros_like(x)]}
    g = g.to(x.dtype)
    p = attrs.get("dropout_prob", 0.5)
    upscale = (attrs.get("dropout_implementation", "downgrade_in_infer")
               == "upscale_in_train")
    if attrs.get("is_test", False) or ctx.is_test:
        return {"X": [g if upscale else g * (1.0 - p)]}
    if p <= 0.0:
        return {"X": [g]}
    if p >= 1.0:
        return {"X": [torch.zeros_like(g)]}
    k0, k1 = _op_key(attrs, ctx)
    return {"X": [_dropout_launch(g.contiguous(), k0, k1, _threshold_for(p),
                                  _scale_for(p, upscale))]}


@register_op("dropout", stateful_rng=True, nondiff_outputs=("Mask",),
             custom_grad=_dropout_grad)
def _dropout(ins, attrs, ctx):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    ones = torch.ones_like(x, dtype=torch.uint8)
    if is_test:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out], "Mask": [ones]}
    if p <= 0.0:
        return {"Out": [x], "Mask": [ones]}
    if p >= 1.0:        # everything dropped; also guards 1/(1-p) below
        return {"Out": [torch.zeros_like(x)],
                "Mask": [torch.zeros_like(x, dtype=torch.uint8)]}
    k0, k1 = _op_key(attrs, ctx)
    threshold = _threshold_for(p)
    out = _Dropout.apply(x, k0, k1, threshold,
                         _scale_for(p, impl == "upscale_in_train"))
    with torch.no_grad():
        mask = _mask_launch(x, k0, k1, threshold)
    return {"Out": [out], "Mask": [mask]}


@register_op("fused_dropout_add", stateful_rng=True)
def _fused_dropout_add(ins, attrs, ctx):
    """out = dropout(X) + Residual in one pass; the backward regenerates
    the mask."""
    x, r = ins["X"][0], ins["Residual"][0]
    p, is_test, upscale = _dropout_common(attrs, ctx)
    if p <= 0.0:
        return {"Out": [x + r]}
    if is_test:
        return {"Out": [(x if upscale else x * (1.0 - p)) + r]}
    if p >= 1.0:
        return {"Out": [r]}
    k0, k1 = _op_key(attrs, ctx)
    args = (k0, k1, _threshold_for(p), _scale_for(p, upscale))
    if x.shape != r.shape:      # a broadcast residual: dropout, then add
        return {"Out": [_Dropout.apply(x, *args) + r]}
    return {"Out": [_DropoutAdd.apply(x, r, *args)]}


@register_op("fused_act_dropout", stateful_rng=True)
def _fused_act_dropout(ins, attrs, ctx):
    """out = dropout(act(X)), act gelu (exact erf) or relu."""
    x = ins["X"][0]
    act = attrs.get("act", "gelu")
    if act not in ("gelu", "relu"):
        raise ValueError(f"fused_act_dropout: unsupported act '{act}'")
    p, is_test, upscale = _dropout_common(attrs, ctx)
    if is_test or p <= 0.0:
        a = torch.nn.functional.gelu(x) if act == "gelu" else torch.relu(x)
        return {"Out": [a if upscale or p <= 0.0 else a * (1.0 - p)]}
    if p >= 1.0:
        return {"Out": [torch.zeros_like(x)]}
    k0, k1 = _op_key(attrs, ctx)
    return {"Out": [_ActDropout.apply(x, k0, k1, _threshold_for(p),
                                      _scale_for(p, upscale), act)]}


@register_op("layer_norm", nondiff_outputs=("Mean", "Variance"))
def _layer_norm(ins, attrs, ctx):
    """Statistics in float32 over the dims from ``begin_norm_axis`` on,
    the result cast back to X's dtype (the reference leaves it to XLA)."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    xf = x.to(_acc(x.dtype))
    m = torch.mean(xf, dim=axes, keepdim=True)
    v = torch.var(xf, dim=axes, keepdim=True, correction=0)
    out = (xf - m) * torch.rsqrt(v + eps)
    norm_shape = tuple(x.shape[begin:])
    if ins.get("Scale"):
        out = out * ins["Scale"][0].reshape(norm_shape)
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(norm_shape)
    lead = tuple(x.shape[:begin])
    return {"Y": [out.to(x.dtype)], "Mean": [m.reshape(lead)],
            "Variance": [v.reshape(lead)]}


# ---------------------------------------------------------------------------
# convolution, pooling and batch norm: library calls (cuDNN on the card),
# as the reference leaves them to XLA's lax.conv_general_dilated and
# lax.reduce_window
# ---------------------------------------------------------------------------
def _same_pads(sizes, ksize, strides, dilations):
    """lax's ``SAME`` rule per spatial dim: ``ceil(in / s)`` outputs, the
    total padding ``(out - 1)·s + (k - 1)·d + 1 - in`` (at least 0), its
    low half ``total // 2``."""
    pads = []
    for n, k, s, d in zip(sizes, ksize, strides, dilations):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _explicit_pads(p):
    """2 paddings (symmetric per dim) or 4 (low, high per dim)."""
    p = list(p)
    if len(p) == 4:
        return [(p[0], p[1]), (p[2], p[3])]
    if len(p) == 2:
        return [(p[0], p[0]), (p[1], p[1])]
    return [(p[0], p[0])] * 2


def _conv_pad(attrs, sizes, ksize, strides, dilations):
    """The reference's ``_conv_pad``: ``SAME``, ``VALID`` or explicit."""
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    if algo == "SAME":
        return _same_pads(sizes, ksize, strides, dilations)
    if algo == "VALID":
        return [(0, 0), (0, 0)]
    return _explicit_pads(attrs.get("paddings", [0, 0]))


def _pad_hw(x, pads, value=0.0):
    """Pad the last two dims of an NCHW tensor by [(lo, hi), (lo, hi)]."""
    (hl, hh), (wl, wh) = pads
    if hl == hh == wl == wh == 0:
        return x
    return F.pad(x, (wl, wh, hl, hh), value=value)


def _to_nchw(x, nhwc):
    return x.permute(0, 3, 1, 2) if nhwc else x


def _from_nchw(x, nhwc):
    return x.permute(0, 2, 3, 1) if nhwc else x


@register_op("conv2d")
def _conv2d(ins, attrs, ctx):
    """``F.conv2d`` with fluid's attrs; asymmetric and ``SAME`` padding
    (which ``F.conv2d`` refuses at stride > 1) as an explicit ``F.pad``
    first."""
    x, w = ins["Input"][0], ins["Filter"][0]
    nhwc = attrs.get("data_format", "NCHW") not in ("NCHW", "AnyLayout")
    xc = _to_nchw(x, nhwc)
    strides = list(attrs.get("strides", [1, 1]))
    dilations = list(attrs.get("dilations", [1, 1]))
    pads = _conv_pad(attrs, xc.shape[2:], w.shape[2:], strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        xc, padding = _pad_hw(xc, pads), [0, 0]
    out = F.conv2d(xc, w, stride=strides, padding=padding,
                   dilation=dilations, groups=attrs.get("groups", 1))
    return {"Output": [_from_nchw(out, nhwc).to(x.dtype)]}


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ins, attrs, ctx):
    """``conv2d`` with ``groups`` defaulting to the input's channels
    (``F.conv2d`` with groups: on the card PyTorch's library picks cuDNN
    or its own depthwise kernels; the reference has no kernel of its own
    for it either); a filter of ``C · m`` outputs is a channel multiplier
    of ``m``."""
    x = ins["Input"][0]
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    groups = attrs.get("groups", x.shape[-1] if nhwc else x.shape[1])
    return _conv2d(ins, dict(attrs, groups=groups), ctx)


@register_op("pool2d")
def _pool2d(ins, attrs, ctx):
    """Max or average pooling as the reference's ``lax.reduce_window``:
    padded positions are -inf for max and 0 for average.  The average
    divides by the count of real positions only when ``exclusive`` is
    set and the padding is explicit and nonzero; under ``SAME`` it
    divides by the whole window, as the reference does.  The reference
    reads no ``ceil_mode``; the port refuses it rather than give
    floor-sized outputs under that name."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if attrs.get("global_pooling", False):
        axes = (1, 2) if nhwc else (2, 3)
        out = (torch.amax(x, axes, keepdim=True) if ptype == "max"
               else torch.mean(x, axes, keepdim=True))
        return {"Out": [out]}
    if attrs.get("ceil_mode", False):
        raise NotImplementedError(
            "pool2d(ceil_mode=True) is not supported: the reference ignores "
            "ceil_mode and gives floor-sized outputs")
    ks = list(attrs["ksize"])
    st = list(attrs.get("strides", ks))
    xc = _to_nchw(x, nhwc)
    same = attrs.get("padding_algorithm", "EXPLICIT") == "SAME"
    pads = (_same_pads(xc.shape[2:], ks, st, (1, 1)) if same
            else _explicit_pads(attrs.get("paddings", [0, 0])))
    if ptype == "max":
        out = F.max_pool2d(_pad_hw(xc, pads, float("-inf")), ks, st)
    else:
        summed = F.avg_pool2d(_pad_hw(xc, pads), ks, st, divisor_override=1)
        if attrs.get("exclusive", True) and not same \
                and any(p != (0, 0) for p in pads):
            ones = torch.ones_like(xc[:1, :1])
            out = summed / F.avg_pool2d(_pad_hw(ones, pads), ks, st,
                                        divisor_override=1)
        else:
            out = summed / (ks[0] * ks[1])
    return {"Out": [_from_nchw(out, nhwc)]}


@register_op("adaptive_pool2d")
def _adaptive_pool2d(ins, attrs, ctx):
    """Average or max over uniform bins: ``ksize`` (the output size) must
    divide the spatial dims, which the reference asserts and the port
    refuses with a ``ValueError``."""
    x = ins["X"][0]
    oh, ow = attrs["ksize"] if "ksize" in attrs else attrs["output_size"]
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if nhwc:
        n, h, w, c = x.shape
    else:
        n, c, h, w = x.shape
    if h % oh or w % ow:
        raise ValueError(f"adaptive_pool2d needs divisible dims: "
                         f"{h}x{w} into {oh}x{ow} bins")
    if nhwc:
        bins, red = x.reshape(n, oh, h // oh, ow, w // ow, c), (2, 4)
    else:
        bins, red = x.reshape(n, c, oh, h // oh, ow, w // ow), (3, 5)
    if attrs.get("pooling_type", "avg") == "avg":
        return {"Out": [torch.mean(bins, red)]}
    return {"Out": [torch.amax(bins, red)]}


def _batch_stats(xf, ctx, red_axes):
    """Mean and population variance (``jnp.var``'s, not ``torch.var``'s
    default) over ``red_axes``; under shape bucketing over the valid rows
    only, so the padded rows do not drag the statistics."""
    from .reduction import masked_batch_reduce
    m = masked_batch_reduce(xf, ctx, red_axes, mean=True)
    if m is None:
        return (torch.mean(xf, dim=red_axes),
                torch.var(xf, dim=red_axes, correction=0))
    msq = masked_batch_reduce(torch.square(xf), ctx, red_axes, mean=True)
    return m, msq - torch.square(m)


@register_op("batch_norm",
             nondiff_inputs=("Mean", "Variance"),
             nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean",
                              "SavedVariance"))
def _batch_norm(ins, attrs, ctx):
    """Batch statistics in float32 (``_batch_stats``); the moving
    statistics come out as MeanOut and VarianceOut under the names they
    were read from, and SavedVariance is the inverse standard deviation
    ``rsqrt(v + eps)``."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = (attrs.get("is_test", False) or ctx.is_test
               or attrs.get("use_global_stats", False))
    ch_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    red_axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    shape = [1] * x.ndim
    shape[ch_axis] = x.shape[ch_axis]
    if is_test:
        m, v = mean, var
        mean_out, var_out = mean, var
    else:
        m, v = _batch_stats(x.to(torch.float32), ctx, red_axes)
        mean_out = momentum * mean + (1 - momentum) * m
        var_out = momentum * var + (1 - momentum) * v
    inv = torch.rsqrt(v.to(torch.float32) + eps)
    out = ((x.to(torch.float32) - m.reshape(shape)) * inv.reshape(shape)
           * scale.reshape(shape) + bias.reshape(shape)).to(x.dtype)
    return {"Y": [out], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [m], "SavedVariance": [inv]}
