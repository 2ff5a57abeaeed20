"""Dygraph (eager imperative) mode (counterpart of ``paddle_tpu/dygraph``,
the modules the flagship BERT training step runs: the tracer and its
tape, ``Layer`` and its containers, the layers BERT calls, and
``functionalize``)."""
from .base import (VarBase, ParamBase, Tracer, guard, enable_dygraph,
                   disable_dygraph, to_variable, no_grad)
from .layers import Layer, Sequential, LayerList, ParameterList
from . import nn
from .nn import Linear, Embedding, LayerNorm, Dropout
from .functional import functionalize, functional_loss
