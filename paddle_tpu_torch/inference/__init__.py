"""Inference API (counterpart of ``paddle_tpu/inference``; reference
paddle/fluid/inference/): ``AnalysisPredictor`` over a saved
``__model__`` (fluid.io.save_inference_model), and the ``torch.export``
artifact that ``save_aot_model`` writes and ``AotPredictor`` serves."""
from .predictor import (AnalysisConfig, AnalysisPredictor,
                        create_paddle_predictor, Config, create_predictor)
from .aot import AotPredictor, load_aot_model, save_aot_model
