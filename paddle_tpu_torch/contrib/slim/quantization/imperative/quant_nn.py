"""Quantized layer twins and fake-quant helpers (counterpart of
``paddle_tpu/contrib/slim/quantization/imperative/quant_nn.py``): the
forward simulates int8 storage while training in float.

As in the reference, ``_fake_quant`` wraps its result in a fresh
``VarBase``, which cuts the tape: a quantized layer's weight and input
get no gradient (ROADMAP queue C).  The moving-average observers keep
their scales as Python floats, so each training call reads the card
once.  In eval mode they read their recorded scale and record nothing,
so an eval forward is a function of its input alone (what
``save_quantized_model`` exports; the reference's export cannot trace
the float read and raises).
"""
from __future__ import annotations

import torch

from .....dygraph.base import VarBase
from .....dygraph.layers import Layer
from .....ops.detection_ops import true_div

__all__ = ["FakeQuantMovingAverage", "FakeQuantAbsMax",
           "FakeChannelWiseQuantDequantAbsMax",
           "MovingAverageAbsMaxScale", "QuantizedConv2D",
           "QuantizedLinear"]


def _value(x):
    return getattr(x, "_value", x)


def _fake_quant(x, bits, scale):
    v = _value(x)
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.clamp(torch.as_tensor(scale, dtype=torch.float32,
                                    device=v.device), min=1e-9)
    q = true_div(torch.clamp(torch.round(v / s * qmax), -qmax, qmax) * s,
                 qmax)
    return VarBase(q, stop_gradient=getattr(x, "stop_gradient", True))


def _moving(layer, x, prev):
    """The observer's next scale: the call's abs max averaged into
    ``prev`` at the layer's rate, one read of the card."""
    cur = float(torch.abs(_value(x)).amax())
    return cur if prev is None else \
        layer._rate * prev + (1 - layer._rate) * cur


class FakeQuantAbsMax(Layer):
    def __init__(self, name=None, quant_bits=8, dtype="float32"):
        super().__init__()
        self._bits = quant_bits

    def forward(self, x):
        return _fake_quant(x, self._bits, torch.abs(_value(x)).amax())


class FakeQuantMovingAverage(Layer):
    def __init__(self, name=None, moving_rate=0.9, quant_bits=8,
                 dtype="float32"):
        super().__init__()
        self._bits = quant_bits
        self._rate = moving_rate
        self._scale = None

    def forward(self, x):
        if self.training or self._scale is None:
            self._scale = _moving(self, x, self._scale)
        return _fake_quant(x, self._bits, self._scale)


class FakeChannelWiseQuantDequantAbsMax(Layer):
    def __init__(self, name=None, quant_bits=8, quant_axis=0,
                 dtype="float32"):
        super().__init__()
        self._bits = quant_bits
        self._axis = quant_axis

    def forward(self, x):
        v = torch.abs(_value(x))
        axes = tuple(i for i in range(v.ndim) if i != self._axis)
        scale = torch.amax(v, dim=axes, keepdim=True) if axes else v
        return _fake_quant(x, self._bits, scale)


class MovingAverageAbsMaxScale(Layer):
    def __init__(self, name=None, moving_rate=0.9, dtype="float32"):
        super().__init__()
        self._rate = moving_rate
        self.scale = None

    def forward(self, x):
        if self.training or self.scale is None:
            self.scale = _moving(self, x, self.scale)
        return x


class _QuantizedWrapper(Layer):
    def __init__(self, layer, weight_bits=8, activation_bits=8):
        super().__init__()
        self._inner = layer
        self._w_quant = FakeQuantAbsMax(quant_bits=weight_bits)
        self._a_quant = FakeQuantMovingAverage(quant_bits=activation_bits)

    def forward(self, x):
        x = self._a_quant(x)
        w_orig = self._inner.weight
        self._inner.weight = self._w_quant(w_orig)
        try:
            out = self._inner(x)
        finally:
            self._inner.weight = w_orig
        return out


class QuantizedConv2D(_QuantizedWrapper):
    pass


class QuantizedLinear(_QuantizedWrapper):
    pass
