"""Quantization ops: the QAT fake-quant family and the PTQ dequant family
(counterpart of ``paddle_tpu/ops/quant_ops.py``).

Reference: operators/fake_quantize_op.{cc,cu}, fake_dequantize_op.cc,
dequantize_log_op.cc, dequantize_abs_max_op.cc.  Every fake-quant op has
a straight-through gradient (``_st_grad``: dX = dOut), as the reference's
FakeQuantGradMaker passes dY through.

Rounding is half to even (``torch.round``, as ``jnp.round``).  Every
division by a host number goes through ``true_div``: the card divides by
a host scalar as a product with its reciprocal, which moves a half-way
value to the other side of a ``round``.  A division by a scale tensor is a
true division on either device.
"""
from __future__ import annotations

import torch

from .detection_ops import true_div
from .registry import register_op


def _bnt(attrs):
    # bin count: 2^(bit_length-1) - 1  (127 for int8)
    return float((1 << (attrs.get("bit_length", 8) - 1)) - 1)


def _quant(x, scale, bnt):
    s = torch.clamp(scale, min=1e-9)
    return torch.round(torch.clamp(x / s, -1.0, 1.0) * bnt)


def _dequant(q, scale, bnt):
    return true_div(q * scale, bnt)


def _abs_max(x):
    return torch.abs(x).amax()


def _st_grad(slot_in="X", slot_out="Out"):
    def grad(ins, outs, out_grads, attrs, ctx):
        g = out_grads.get(slot_out)
        x = ins[slot_in][0]
        if g is None:
            g = torch.zeros_like(x)
        return {slot_in: [g.to(x.dtype)]}
    return grad


def _scalar(t):
    return t.reshape(())


def _ones(x):
    return torch.ones((), dtype=torch.float32, device=x.device)


@register_op("fake_quantize_abs_max", nondiff_outputs=("OutScale",),
             custom_grad=_st_grad())
def _fake_quantize_abs_max(ins, attrs, ctx):
    x = ins["X"][0]
    scale = _abs_max(x)
    return {"Out": [_quant(x, scale, _bnt(attrs))],
            "OutScale": [scale.reshape(1)]}


@register_op("fake_quantize_dequantize_abs_max", nondiff_outputs=("OutScale",),
             custom_grad=_st_grad())
def _fake_qdq_abs_max(ins, attrs, ctx):
    x = ins["X"][0]
    bnt = _bnt(attrs)
    scale = _abs_max(x)
    return {"Out": [_dequant(_quant(x, scale, bnt), scale, bnt)],
            "OutScale": [scale.reshape(1)]}


def _channel_scale(x, axis):
    """Per-channel abs max over every axis but ``axis``, and its shape for
    broadcasting against ``x`` (a negative axis matches no axis: one scale
    over all, as in the reference)."""
    red = tuple(i for i in range(x.ndim) if i != axis)
    scale = torch.amax(torch.abs(x), dim=red) if red else torch.abs(x)
    shape = [1] * x.ndim
    shape[axis] = -1
    return scale, shape


@register_op("fake_channel_wise_quantize_abs_max",
             nondiff_outputs=("OutScale",), custom_grad=_st_grad())
def _fake_cw_quant(ins, attrs, ctx):
    x = ins["X"][0]
    scale, shape = _channel_scale(x, attrs.get("quant_axis", 0))
    return {"Out": [_quant(x, scale.reshape(shape), _bnt(attrs))],
            "OutScale": [scale]}


@register_op("fake_channel_wise_quantize_dequantize_abs_max",
             nondiff_outputs=("OutScale",), custom_grad=_st_grad())
def _fake_cw_qdq(ins, attrs, ctx):
    """Channel-wise quant->dequant in one op: consumers see float-scale
    weights (the QAT training path)."""
    x = ins["X"][0]
    bnt = _bnt(attrs)
    scale, shape = _channel_scale(x, attrs.get("quant_axis", 0))
    s = scale.reshape(shape)
    return {"Out": [_dequant(_quant(x, s, bnt), s, bnt)],
            "OutScale": [scale]}


@register_op("fake_quantize_range_abs_max",
             nondiff_inputs=("InScale", "Iter"),
             nondiff_outputs=("OutScale", "OutScales"),
             custom_grad=_st_grad())
def _fake_quant_range(ins, attrs, ctx):
    """The scale is max(abs max, InScale) in training and InScale under
    ``is_test``; ``window_size`` and ``Iter`` are never read, as in the
    reference."""
    x = ins["X"][0]
    in_scale = _scalar(ins["InScale"][0])
    if attrs.get("is_test", False) or ctx.is_test:
        scale = in_scale
    else:
        scale = torch.maximum(_abs_max(x), in_scale)
    return {"Out": [_quant(x, scale, _bnt(attrs))],
            "OutScale": [scale.reshape(1)],
            "OutScales": [scale.reshape(1)]}


@register_op("fake_quantize_moving_average_abs_max",
             nondiff_inputs=("InScale", "InAccum", "InState"),
             nondiff_outputs=("OutScale", "OutAccum", "OutState"),
             custom_grad=_st_grad())
def _fake_quant_moving(ins, attrs, ctx):
    x = ins["X"][0]
    rate = attrs.get("moving_rate", 0.9)
    in_scale = _scalar(ins["InScale"][0])
    if attrs.get("is_test", False) or ctx.is_test:
        scale = accum = in_scale
        state = _ones(x)
    else:
        in_accum = _scalar(ins["InAccum"][0]) if ins.get("InAccum") \
            else in_scale
        in_state = _scalar(ins["InState"][0]) if ins.get("InState") \
            else _ones(x)
        state = rate * in_state + 1.0
        accum = rate * in_accum + _abs_max(x)
        scale = accum / state
    return {"Out": [_quant(x, scale, _bnt(attrs))],
            "OutScale": [scale.reshape(1)],
            "OutAccum": [accum.reshape(1)],
            "OutState": [state.reshape(1)]}


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             nondiff_inputs=("InScale", "InAccum", "InState"),
             nondiff_outputs=("OutScale", "OutAccum", "OutState"),
             custom_grad=_st_grad())
def _fake_qdq_moving(ins, attrs, ctx):
    outs = _fake_quant_moving(ins, attrs, ctx)
    scale = _scalar(outs["OutScale"][0])
    outs["Out"] = [_dequant(outs["Out"][0], scale, _bnt(attrs))]
    return outs


@register_op("fake_dequantize_max_abs", nondiff_inputs=("Scale",))
def _fake_dequantize_max_abs(ins, attrs, ctx):
    x, scale = ins["X"][0], _scalar(ins["Scale"][0])
    return {"Out": [true_div(x.float() * scale,
                             attrs.get("max_range", 127.0))]}


@register_op("fake_channel_wise_dequantize_max_abs",
             nondiff_inputs=("Scales",))
def _fake_cw_dequant(ins, attrs, ctx):
    x = ins["X"][0].float()
    scales = ins["Scales"]
    bits = attrs.get("quant_bits", [8])
    axis = attrs.get("quant_axis", 0)
    shape = [1] * x.ndim
    shape[axis] = -1
    out = true_div(x * scales[0].reshape(shape),
                   float((1 << (bits[0] - 1)) - 1))
    if len(scales) > 1:
        out = true_div(out * _scalar(scales[1]),
                       float((1 << (bits[1] - 1)) - 1))
    return {"Out": [out]}


@register_op("dequantize_abs_max", nondiff_inputs=("Scale",),
             differentiable=False)
def _dequantize_abs_max(ins, attrs, ctx):
    x, scale = ins["X"][0], _scalar(ins["Scale"][0])
    return {"Out": [true_div(x.float() * scale,
                             attrs.get("max_range", 127.0))]}


@register_op("dequantize_log", nondiff_inputs=("Dict",),
             differentiable=False)
def _dequantize_log(ins, attrs, ctx):
    """int8 codes index a 128-entry log-scale dict; a negative code
    mirrors to -dict[code + 128]."""
    x = ins["X"][0].long()
    d = ins["Dict"][0]
    neg = x < 0
    idx = torch.where(neg, x + 128, x).clamp(0, d.shape[0] - 1)
    val = d[idx]
    return {"Out": [torch.where(neg, -val, val)]}


@register_op("quantize", differentiable=False)
def _quantize(ins, attrs, ctx):
    """int8 codes ``round(x · Scale + Shift)``; a code outside [-128, 127]
    wraps or saturates as the device's cast does (no contract)."""
    x = ins["Input"][0]
    return {"Output": [torch.round(x * attrs.get("Scale", 1.0)
                                   + attrs.get("Shift", 0.0))
                       .to(torch.int8)]}


@register_op("dequantize", differentiable=False)
def _dequantize(ins, attrs, ctx):
    x = ins["Input"][0]
    return {"Output": [true_div(x.float() - attrs.get("Shift", 0.0),
                                attrs.get("Scale", 1.0))]}


@register_op("requantize", differentiable=False)
def _requantize(ins, attrs, ctx):
    x = ins["Input"][0]
    si, so = attrs.get("Scale_in", 1.0), attrs.get("Scale_out", 1.0)
    return {"Output": [torch.round(true_div(x.float() * so, si))
                       .to(x.dtype)]}


@register_op("moving_average_abs_max_scale",
             nondiff_outputs=("OutScale", "OutAccum", "OutState"),
             custom_grad=_st_grad())
def _moving_average_abs_max_scale(ins, attrs, ctx):
    """The scale observer of QAT's output quantization: Out is X."""
    x = ins["X"][0]
    rate = attrs.get("moving_rate", 0.9)
    cur = _abs_max(x)
    in_accum = _scalar(ins["InAccum"][0]) if ins.get("InAccum") else cur
    in_state = _scalar(ins["InState"][0]) if ins.get("InState") \
        else _ones(x)
    state = rate * in_state + 1.0
    accum = rate * in_accum + cur
    return {"Out": [x], "OutScale": [(accum / state).reshape(1)],
            "OutAccum": [accum.reshape(1)], "OutState": [state.reshape(1)]}
