"""fluid.layers namespace: the op builders the ported slices use."""
from . import tensor
from . import nn
from . import loss

from .tensor import data, _to_variable, fill_constant, create_global_var
from .nn import (fc, embedding, dropout, softmax, reshape, transpose, scale,
                 matmul, relu, reduce_mean, mean, elementwise_op,
                 elementwise_add)
from .loss import softmax_with_cross_entropy
