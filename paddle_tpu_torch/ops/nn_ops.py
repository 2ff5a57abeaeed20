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
from .detection_ops import gather_rows
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


# ---------------------------------------------------------------------------
# the 2.0 surface (nn.functional): log-softmax and the normalizations
# ---------------------------------------------------------------------------
@register_op("log_softmax")
def _log_softmax(ins, attrs, ctx):
    return {"Out": [torch.log_softmax(ins["X"][0],
                                      dim=attrs.get("axis", -1))]}


@register_op("l2_normalize")
def _l2_normalize(ins, attrs, ctx):
    x = ins["X"][0]
    norm = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                                keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": [x / norm], "Norm": [norm]}


@register_op("lrn")
def _lrn(ins, attrs, ctx):
    """Across-channel local response normalization of NCHW x: the
    squares summed over a window of ``n`` channels."""
    x = ins["X"][0]
    n = attrs.get("n", 5)
    k, alpha, beta = (attrs.get("k", 2.0), attrs.get("alpha", 1e-4),
                      attrs.get("beta", 0.75))
    pad = n // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, pad, pad))
    acc = sum(sq[:, i:i + x.shape[1]] for i in range(n))
    mid = k + alpha * acc
    return {"Out": [x / torch.pow(mid, beta)], "MidOut": [mid]}


@register_op("maxout")
def _maxout(ins, attrs, ctx):
    x = ins["X"][0]
    g = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": [x.reshape(n, c // g, g, h, w).amax(dim=2)]}


# ---------------------------------------------------------------------------
# the image layers: transposed and 3-d convolutions, the instance, group
# and sync batch norms, interpolation, sampling grids (library calls and
# torch index arithmetic; the reference computes them in XLA outside any
# Pallas kernel)
# ---------------------------------------------------------------------------
def _conv_transpose(x, w, strides, dilations, crops, groups):
    """The reference's transposed convolution: the stride-dilated input
    correlated with the spatially flipped kernel (``F.conv_transposeNd``
    is that), then ``(lo, hi)`` of ``crops`` taken off each spatial side
    of the full output ``(in - 1)·s + k_eff`` (a negative crop pads
    zeros: those rows see only padding).  One library call when torch's
    ``padding``/``output_padding`` can say it (a crop ``lo`` at least the
    high one, by less than the stride), else the full output cropped."""
    conv = {3: F.conv_transpose1d, 4: F.conv_transpose2d,
            5: F.conv_transpose3d}[x.dim()]
    if all(lo >= 0 and 0 <= lo - hi < max(s, d)
           for (lo, hi), s, d in zip(crops, strides, dilations)):
        return conv(x, w, stride=strides, padding=[lo for lo, _ in crops],
                    output_padding=[lo - hi for lo, hi in crops],
                    groups=groups, dilation=dilations)
    out = conv(x, w, stride=strides, groups=groups, dilation=dilations)
    pads = [v for lo, hi in reversed(crops) for v in (-lo, -hi)]
    return F.pad(out, pads)


@register_op("conv2d_transpose")
def _conv2d_transpose(ins, attrs, ctx):
    """fluid's filter ``[C_in, C_out/groups, kh, kw]`` (torch's layout);
    ``paddings`` 2 (symmetric) or 4 (``[top, bottom, left, right]``),
    ``SAME`` (the output ``in · s``, an odd crop's extra row off the high
    side) or ``VALID``; ``output_size`` (absolute) or ``output_padding``
    adds rows on the high edge.  NCHW whatever ``data_format`` says, as
    the reference."""
    x, w = ins["Input"][0], ins["Filter"][0]
    s = list(attrs.get("strides", [1, 1]))
    d = list(attrs.get("dilations", [1, 1]))
    kh = (w.shape[2] - 1) * d[0] + 1
    kw = (w.shape[3] - 1) * d[1] + 1
    p = list(attrs.get("paddings", [0, 0]))
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    if algo == "VALID":
        p = [0, 0, 0, 0]
    elif algo == "SAME":
        p = [(kh - s[0]) // 2, (kh - s[0]) - (kh - s[0]) // 2,
             (kw - s[1]) // 2, (kw - s[1]) - (kw - s[1]) // 2]
    if len(p) == 2:
        p = [p[0], p[0], p[1], p[1]]
    extra = [0, 0]
    osize, opad = attrs.get("output_size"), attrs.get("output_padding")
    if osize:
        dh = (x.shape[2] - 1) * s[0] - p[0] - p[1] + kh
        dw = (x.shape[3] - 1) * s[1] - p[2] - p[3] + kw
        extra = [int(osize[0]) - dh, int(osize[1]) - dw]
    elif opad:
        extra = [int(opad[0]), int(opad[1])]
    out = _conv_transpose(x, w, s, d, [(p[0], p[1] - extra[0]),
                                       (p[2], p[3] - extra[1])],
                          attrs.get("groups", 1))
    return {"Output": [out.to(x.dtype)]}


def _conv3d_pads(attrs, sizes, ksize, strides, dilations):
    """The reference's ``_conv_pad`` over three spatial dims."""
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    if algo == "SAME":
        return _same_pads(sizes, ksize, strides, dilations)
    if algo == "VALID":
        return [(0, 0)] * 3
    p = list(attrs.get("paddings", [0, 0, 0]))
    if len(p) == 3:
        return [(v, v) for v in p]
    if len(p) == 6:
        return [(p[2 * i], p[2 * i + 1]) for i in range(3)]
    return [(p[0], p[0])] * 3


@register_op("conv3d")
def _conv3d(ins, attrs, ctx):
    """``F.conv3d`` over NCDHW (the reference reads no ``data_format``);
    asymmetric and ``SAME`` padding as an ``F.pad`` first."""
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = list(attrs.get("strides", [1, 1, 1]))
    dilations = list(attrs.get("dilations", [1, 1, 1]))
    pads = _conv3d_pads(attrs, x.shape[2:], w.shape[2:], strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        x = F.pad(x, [v for lo, hi in reversed(pads) for v in (lo, hi)])
        padding = [0, 0, 0]
    out = F.conv3d(x, w, stride=strides, padding=padding,
                   dilation=dilations, groups=attrs.get("groups", 1))
    return {"Output": [out.to(ins["Input"][0].dtype)]}


@register_op("sync_batch_norm",
             nondiff_inputs=("Mean", "Variance"),
             nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean",
                              "SavedVariance"))
def _sync_batch_norm(ins, attrs, ctx):
    """Batch norm over axis 1 whose statistics would be averaged across
    the data-parallel replicas; one process holds every row, so they are
    the local batch's (the multi-process path is ROADMAP item 10's).  It
    reads neither ``data_layout`` nor ``use_global_stats``, as the
    reference."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    shape = [1] * x.ndim
    shape[1] = x.shape[1]
    if attrs.get("is_test", False) or ctx.is_test:
        m, v = mean, var
        mean_out, var_out = mean, var
    else:
        m, v = _batch_stats(x.to(torch.float32), ctx,
                            tuple(i for i in range(x.ndim) if i != 1))
        mean_out = momentum * mean + (1 - momentum) * m
        var_out = momentum * var + (1 - momentum) * v
    inv = torch.rsqrt(v + eps)
    out = ((x.to(torch.float32) - m.reshape(shape)) * inv.reshape(shape)
           * scale.reshape(shape) + bias.reshape(shape)).to(x.dtype)
    return {"Y": [out], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [m], "SavedVariance": [inv]}


def _affine(out, ins, c, ndim):
    shape = (1, c) + (1,) * (ndim - 2)
    if ins.get("Scale"):
        out = out * ins["Scale"][0].reshape(shape)
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(shape)
    return out


@register_op("instance_norm", nondiff_outputs=("SavedMean", "SavedVariance"))
def _instance_norm(ins, attrs, ctx):
    """Each (sample, channel)'s spatial statistics in float32 under any
    input dtype.  ``SavedMean`` is the mean with every unit axis squeezed
    (at N = 1 the batch axis goes too) and ``SavedVariance`` the inverse
    standard deviation, as the reference gives them."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    xf = x.to(_acc(x.dtype))
    if axes:
        m = torch.mean(xf, dim=axes, keepdim=True)
        v = torch.var(xf, dim=axes, keepdim=True, correction=0)
    else:       # no spatial axis: each value its own mean (torch's
        m, v = xf, torch.zeros_like(xf)     # dim=() would reduce all)
    inv = torch.rsqrt(v + eps)
    out = _affine((xf - m) * inv, ins, x.shape[1], x.ndim)
    return {"Y": [out.to(x.dtype)], "SavedMean": [torch.squeeze(m)],
            "SavedVariance": [torch.squeeze(inv)]}


@register_op("group_norm", nondiff_outputs=("Mean", "Variance"))
def _group_norm(ins, attrs, ctx):
    """Statistics over each group of ``C / groups`` channels and the
    spatial dims, in float32; ``Variance`` is the variance itself."""
    x = ins["X"][0]
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[:2]
    xg = x.to(_acc(x.dtype)).reshape((n, g, c // g) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.ndim))
    m = torch.mean(xg, dim=axes, keepdim=True)
    v = torch.var(xg, dim=axes, keepdim=True, correction=0)
    out = _affine(((xg - m) * torch.rsqrt(v + eps)).reshape(x.shape), ins,
                  c, x.ndim)
    return {"Y": [out.to(x.dtype)], "Mean": [m.reshape(n, g)],
            "Variance": [v.reshape(n, g)]}


register_op("norm", lambda ins, a, c: _l2_normalize(ins, a, c))


# -- interpolation: the reference's index arithmetic, in float32 -------------
def _interp_ratio(i, o, align_corners):
    if o <= 1:
        return 0.0
    return (i - 1) / (o - 1) if align_corners else i / o


def _arange(o, device):
    return torch.arange(o, dtype=torch.float32, device=device)


def _interp_axis_idx(r, o, i, align_flag, device):
    """(lo, hi, frac) source indices of one axis for linear
    interpolation: ``src = r·(k + ½) - ½`` (align_mode 0) or ``r·k``."""
    k = _arange(o, device)
    src = r * (k + 0.5) - 0.5 if align_flag else r * k
    lo = torch.clamp(torch.floor(src).to(torch.int64), min=0)
    hi = torch.clamp(lo + 1, max=i - 1)
    frac = (torch.clamp(src, min=0.0) - lo) if align_flag else r * k - lo
    return lo, hi, frac


def _cubic_weights(r, o, align_corners, device):
    """Keys' cubic convolution with A = -0.75: the four taps' weights
    ``[4, o]`` and each output's base source index."""
    k = _arange(o, device)
    src = r * k if align_corners else r * (k + 0.5) - 0.5
    base = torch.floor(src).to(torch.int64)
    t = src - base
    a = -0.75

    def cc1(v):
        return ((a + 2) * v - (a + 3)) * v * v + 1

    def cc2(v):
        return ((a * v - 5 * a) * v + 8 * a) * v - 4 * a
    return base, torch.stack([cc2(t + 1.0), cc1(t), cc1(1.0 - t),
                              cc2(2.0 - t)])


def _take(x, dim, idx):
    """``index_select`` along ``dim`` by ``gather_rows`` (``F.embedding``),
    whose gradient sums an index's repeats in a fixed order on the card
    (an upsampling reads a row two or three times; ``index_select``'s
    gradient adds them by atomics, so two runs could differ in the last
    bit)."""
    return torch.movedim(gather_rows(torch.movedim(x, dim, 0), idx), 0, dim)


def _out_size(ins, attrs, keys, sizes):
    """The output's spatial sizes: ``OutSize``, else the ``out_*`` attrs,
    else the input's times ``scale`` (truncated)."""
    if ins.get("OutSize"):
        return [int(v) for v in ins["OutSize"][0].reshape(-1).tolist()]
    outs = [attrs.get(k, -1) for k in keys]
    if outs[0] > 0:
        return outs
    scale = attrs.get("scale", 1.0)
    scale = (list(scale) if isinstance(scale, (list, tuple))
             else [scale] * len(keys))
    return [int(n * s) for n, s in zip(sizes, scale)]


def _interp(ins, attrs, ctx, method):
    """nearest (``trunc(r·k)``, or ``trunc(r·k + ½)`` with corners),
    bilinear in the three alignment modes and bicubic, over NCHW or
    NHWC, gathered along each axis (``_take``)."""
    x = ins["X"][0]
    nhwc = attrs.get("data_layout", "NCHW") == "NHWC"
    xc = _to_nchw(x, nhwc)
    h, w = xc.shape[2], xc.shape[3]
    oh, ow = _out_size(ins, attrs, ("out_h", "out_w"), (h, w))
    align_corners = attrs.get("align_corners", False)
    rh = _interp_ratio(h, oh, align_corners)
    rw = _interp_ratio(w, ow, align_corners)
    dev = x.device
    if method == "nearest":
        off = 0.5 if align_corners else 0.0
        iy = torch.clamp((rh * _arange(oh, dev) + off).to(torch.int64),
                         0, h - 1)
        ix = torch.clamp((rw * _arange(ow, dev) + off).to(torch.int64),
                         0, w - 1)
        out = _take(_take(xc, 2, iy), 3, ix)
    elif method == "bilinear":
        flag = attrs.get("align_mode", 1) == 0 and not align_corners
        y0, y1, fy = _interp_axis_idx(rh, oh, h, flag, dev)
        x0, x1, fx = _interp_axis_idx(rw, ow, w, flag, dev)
        fy = fy.reshape(1, 1, oh, 1)
        fx = fx.reshape(1, 1, 1, ow)
        r0, r1 = _take(xc, 2, y0), _take(xc, 2, y1)
        out = ((1 - fy) * (1 - fx) * _take(r0, 3, x0)
               + (1 - fy) * fx * _take(r0, 3, x1)
               + fy * (1 - fx) * _take(r1, 3, x0)
               + fy * fx * _take(r1, 3, x1))
    elif method == "bicubic":
        by, wy = _cubic_weights(rh, oh, align_corners, dev)
        bx, wx = _cubic_weights(rw, ow, align_corners, dev)
        out = 0.0
        for i in range(4):
            rows = _take(xc, 2, torch.clamp(by + (i - 1), 0, h - 1))
            row = 0.0
            for j in range(4):
                xx = torch.clamp(bx + (j - 1), 0, w - 1)
                row = row + wx[j].reshape(1, 1, 1, ow) * _take(rows, 3, xx)
            out = out + wy[i].reshape(1, 1, oh, 1) * row
    else:
        raise ValueError(f"unsupported interpolation method {method!r}")
    return {"Out": [_from_nchw(out.to(x.dtype), nhwc)]}


def _trilinear_interp(ins, attrs, ctx):
    """Trilinear over NCDHW or NDHWC in bilinear's three alignment
    modes."""
    x = ins["X"][0]
    ndhwc = attrs.get("data_layout", "NCDHW") == "NDHWC"
    xc = x.permute(0, 4, 1, 2, 3) if ndhwc else x
    d, h, w = xc.shape[2:]
    od, oh, ow = _out_size(ins, attrs, ("out_d", "out_h", "out_w"),
                           (d, h, w))
    align_corners = attrs.get("align_corners", False)
    flag = attrs.get("align_mode", 1) == 0 and not align_corners
    dev = x.device
    axes = [_interp_axis_idx(_interp_ratio(i, o, align_corners), o, i, flag,
                             dev) for i, o in ((d, od), (h, oh), (w, ow))]
    shapes = ((1, 1, od, 1, 1), (1, 1, 1, oh, 1), (1, 1, 1, 1, ow))
    (d0, d1, fd), (y0, y1, fy), (x0, x1, fx) = [
        (lo, hi, f.reshape(s)) for (lo, hi, f), s in zip(axes, shapes)]
    out = 0.0
    for wd, dd in ((1 - fd, d0), (fd, d1)):
        plane = _take(xc, 2, dd)
        for wh, yy in ((1 - fy, y0), (fy, y1)):
            rows = _take(plane, 3, yy)
            for ww, xx in ((1 - fx, x0), (fx, x1)):
                out = out + wd * wh * ww * _take(rows, 4, xx)
    out = out.to(x.dtype)
    return {"Out": [out.permute(0, 2, 3, 4, 1) if ndhwc else out]}


register_op("nearest_interp", lambda ins, a, c: _interp(ins, a, c, "nearest"),
            nondiff_inputs=("OutSize",))
register_op("bilinear_interp",
            lambda ins, a, c: _interp(ins, a, c, "bilinear"),
            nondiff_inputs=("OutSize",))
register_op("bicubic_interp", lambda ins, a, c: _interp(ins, a, c, "bicubic"),
            nondiff_inputs=("OutSize",))
register_op("trilinear_interp", _trilinear_interp,
            nondiff_inputs=("OutSize",))


@register_op("grid_sampler")
def _grid_sampler(ins, attrs, ctx):
    """Bilinear sampling of NCHW x at ``Grid``'s [-1, 1] points, corners
    aligned, every tap clamped into the image (so a point outside takes
    the border's values); the reference reads neither ``mode`` nor
    ``padding_mode`` nor ``align_corners``."""
    x, grid = ins["X"][0], ins["Grid"][0]
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    wx = (gx - x0).unsqueeze(1)
    wy = (gy - y0).unsqueeze(1)
    flat = x.reshape(n, c, h * w)
    gh, gw = grid.shape[1], grid.shape[2]

    def sample(yy, xx):
        idx = (torch.clamp(yy, 0, h - 1) * w + torch.clamp(xx, 0, w - 1))
        idx = idx.reshape(n, 1, gh * gw).expand(n, c, gh * gw)
        return torch.gather(flat, 2, idx).reshape(n, c, gh, gw)
    out = (sample(y0, x0) * (1 - wx) * (1 - wy)
           + sample(y0, x0 + 1) * wx * (1 - wy)
           + sample(y0 + 1, x0) * (1 - wx) * wy
           + sample(y0 + 1, x0 + 1) * wx * wy)
    return {"Output": [out]}


@register_op("affine_channel")
def _affine_channel(ins, attrs, ctx):
    x, s, b = ins["X"][0], ins["Scale"][0], ins["Bias"][0]
    shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
    return {"Out": [x * s.reshape(shape) + b.reshape(shape)]}


@register_op("temporal_shift")
def _temporal_shift(ins, attrs, ctx):
    """TSM's shift of ``[N·T, C, H, W]``: the first ``C·ratio`` channels
    one segment back, the next as many one segment forward, zeros where
    nothing shifts in."""
    x = ins["X"][0]
    t = attrs["seg_num"]
    nt, c, h, w = x.shape
    x = x.reshape(nt // t, t, c, h, w)
    c1 = int(c * attrs.get("shift_ratio", 0.25))
    fwd = F.pad(x[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    bwd = F.pad(x[:, :-1, c1:2 * c1], (0, 0, 0, 0, 0, 0, 1, 0))
    out = torch.cat([fwd, bwd, x[:, :, 2 * c1:]], dim=2)
    return {"Out": [out.reshape(nt, c, h, w)]}
