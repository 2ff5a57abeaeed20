"""Dygraph (eager imperative) mode (counterpart of ``paddle_tpu/dygraph``,
the modules the flagship BERT and the ResNet training steps run: the
tracer and its tape, ``Layer`` and its containers, the layers BERT and
ResNet call, and ``functionalize``)."""
from .base import (VarBase, ParamBase, Tracer, guard, enable_dygraph,
                   disable_dygraph, to_variable, no_grad)
from .layers import Layer, Sequential, LayerList, ParameterList
from . import nn
from .nn import (Linear, Embedding, LayerNorm, Dropout, Conv2D, Pool2D,
                 BatchNorm)
from .functional import functionalize, functional_loss
