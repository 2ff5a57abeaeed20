"""paddle.regularizer (counterpart of ``paddle_tpu/regularizer.py``):
the 2.0 names over the fluid regularizers."""
from .fluid.regularizer import (  # noqa: F401
    L1Decay, L2Decay, L1DecayRegularizer, L2DecayRegularizer,
    WeightDecayRegularizer)
