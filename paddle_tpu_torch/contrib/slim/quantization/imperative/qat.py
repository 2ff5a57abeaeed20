"""Dygraph QAT (counterpart of
``paddle_tpu/contrib/slim/quantization/imperative/qat.py``):
``ImperativeQuantAware`` swaps quantizable layers, by class name, for
their Quantized* twins; ``ImperativeCalcOutScale`` records each
sublayer's output threshold through forward post hooks (a host read a
call while training; in eval mode the hooks record nothing).
``save_quantized_model`` exports the eval forward through ``jit.save``."""
from __future__ import annotations

import numpy as np

__all__ = ["ImperativeQuantAware", "ImperativeCalcOutScale"]


def _save_eval(layer, path, input_spec):
    """``jit.save`` of ``layer`` in eval mode, its mode restored after."""
    from .....jit import save as jit_save
    training = layer.training
    layer.eval()
    try:
        jit_save(layer, path, input_spec)
    finally:
        if training:
            layer.train()


class ImperativeQuantAware:
    def __init__(self, weight_bits=8, activation_bits=8,
                 weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 moving_rate=0.9, quantizable_layer_type=("Conv2D",
                                                          "Linear")):
        self._wbits = weight_bits
        self._abits = activation_bits
        self._types = tuple(quantizable_layer_type)
        self._rate = moving_rate

    def quantize(self, model):
        from .quant_nn import QuantizedConv2D, QuantizedLinear
        swap = {"Conv2D": QuantizedConv2D, "Linear": QuantizedLinear}
        for name, child in list(model._sub_layers.items()):
            cls_name = type(child).__name__
            if cls_name in self._types and cls_name in swap:
                # Layer.__setattr__ updates the registry and the attribute
                setattr(model, name, swap[cls_name](child, self._wbits,
                                                    self._abits))
            else:
                self.quantize(child)
        return model

    def save_quantized_model(self, layer, path, input_spec=None):
        _save_eval(layer, path, input_spec)


class ImperativeCalcOutScale:
    def __init__(self, moving_rate=0.9):
        self._rate = moving_rate
        self._scales = {}

    def calc_out_scale(self, model):
        rate = self._rate
        scales = self._scales

        def hook(layer, inputs, outputs):
            if not layer.training:
                return outputs
            out = outputs[0] if isinstance(outputs, (list, tuple)) \
                else outputs
            val = float(np.abs(out.numpy() if hasattr(out, "numpy")
                               else np.asarray(out)).max() or 0.0)
            key = id(layer)
            prev = scales.get(key, val)
            scales[key] = rate * prev + (1 - rate) * val
            layer._out_threshold = scales[key]
            return outputs

        for layer in model.sublayers():
            layer.register_forward_post_hook(hook)
        return model

    def save_quantized_model(self, layer, path, input_spec=None):
        _save_eval(layer, path, input_spec)
