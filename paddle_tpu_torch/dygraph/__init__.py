"""Dygraph (eager imperative) mode (counterpart of ``paddle_tpu/dygraph``:
the tracer and its tape, ``Layer`` and its containers, the layer classes
the ported models call, ``functionalize``, ``save_dygraph`` and
``load_dygraph``, ``declarative`` and ``TracedLayer``, the 1.x
learning-rate decays, the 1.x cells and the sequence tier's classes)."""
from .base import (VarBase, ParamBase, Tracer, guard, enable_dygraph,
                   disable_dygraph, to_variable, no_grad)
from .layers import Layer, Sequential, LayerList, ParameterList
from . import nn
from .nn import (Linear, Embedding, LayerNorm, Dropout, Conv2D, Pool2D,
                 BatchNorm, PRelu, Conv2DTranspose, Conv3D, Conv3DTranspose,
                 InstanceNorm, GroupNorm, SpectralNorm,
                 BilinearTensorProduct, Flatten, GRUUnit, SequenceConv, NCE,
                 TreeConv)
from .functional import functionalize, functional_loss
from .checkpoint import save_dygraph, load_dygraph
from .jit import TracedLayer, declarative
from . import learning_rate_scheduler
from .learning_rate_scheduler import (NoamDecay, PiecewiseDecay,
                                      NaturalExpDecay, ExponentialDecay,
                                      InverseTimeDecay, PolynomialDecay,
                                      CosineDecay, LinearLrWarmup,
                                      ReduceLROnPlateau, StepDecay,
                                      MultiStepDecay, LambdaDecay)
from . import rnn
