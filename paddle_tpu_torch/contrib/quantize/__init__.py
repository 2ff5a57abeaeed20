"""fluid.contrib.quantize (counterpart of
``paddle_tpu/contrib/quantize/__init__.py``): the pre-slim
``QuantizeTranspiler`` over the slim quantization passes."""
from __future__ import annotations

__all__ = ["QuantizeTranspiler"]


class QuantizeTranspiler:
    """Legacy QAT transpiler: ``training_transpile`` is ``quant_aware``
    (the quantize types and window are kept, not read, as in the
    reference), ``freeze_program`` is ``convert``."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000):
        self._wbits = weight_bits
        self._abits = activation_bits
        self._act_type = activation_quantize_type
        self._w_type = weight_quantize_type
        self._window = window_size

    def training_transpile(self, program=None, startup_program=None):
        from ..slim.quantization import quant_aware
        from ...fluid.framework import default_main_program
        return quant_aware(program or default_main_program(),
                           weight_bits=self._wbits,
                           activation_bits=self._abits)

    def freeze_program(self, program, place=None, fuse_bn=False):
        from ..slim.quantization import convert
        return convert(program)
