"""fluid.layers namespace: the op builders the ported slices use."""
from . import tensor
from . import nn
from . import loss
from . import sequence_lod

from .tensor import (data, _to_variable, fill_constant, create_global_var,
                     concat)
from .nn import (fc, embedding, dropout, softmax, reshape, transpose, scale,
                 matmul, relu, reduce_mean, reduce_sum, mean, elementwise_op,
                 elementwise_add)
from .loss import (softmax_with_cross_entropy,
                   sigmoid_cross_entropy_with_logits)
from .sequence_lod import sequence_pool
