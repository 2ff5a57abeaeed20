"""fluid.contrib.slim.quantization (counterpart of
``paddle_tpu/contrib/slim/quantization/__init__.py``): the QAT passes,
post-training quantization, the dygraph QAT and ``WeightQuantization``."""
from .quantization_pass import (QuantizationTransformPass,
                                QuantizationFreezePass,
                                quant_aware, convert)
from .post_training_quantization import PostTrainingQuantization
from .quantization_pass import (ConvertToInt8Pass, TransformForMobilePass,
                                OutScaleForTrainingPass,
                                OutScaleForInferencePass,
                                AddQuantDequantPass, Quant2Int8MkldnnPass,
                                QuantInt8MkldnnPass)
from . import imperative
from .imperative import ImperativeQuantAware, ImperativeCalcOutScale


class WeightQuantization:
    """Weight-only quantization of a saved inference model.  As in the
    reference, ``quantize_weight_to_int`` copies the model's files and
    quantizes nothing (ROADMAP queue C)."""

    def __init__(self, model_dir, model_filename=None,
                 params_filename=None):
        self._model_dir = model_dir

    def quantize_weight_to_int(self, save_model_dir, weight_bits=8,
                               quantizable_op_type=("conv2d", "mul"),
                               weight_quantize_type="channel_wise_abs_max",
                               generate_test_model=False, threshold_rate=0.0):
        import os
        import shutil
        os.makedirs(save_model_dir, exist_ok=True)
        for f in os.listdir(self._model_dir):
            shutil.copy(os.path.join(self._model_dir, f),
                        os.path.join(save_model_dir, f))
        return save_model_dir
