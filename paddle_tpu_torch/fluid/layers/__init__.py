"""fluid.layers namespace: the op builders the ported slices use."""
from . import tensor
from . import nn
from . import loss
from . import sequence_lod
from . import control_flow

from .tensor import (data, _to_variable, fill_constant, create_global_var,
                     concat, assign, fill_constant_batch_size_like)
from .nn import (fc, embedding, dropout, softmax, reshape, transpose, scale,
                 matmul, relu, gelu, tanh, reduce_mean, reduce_sum, mean,
                 elementwise_op, elementwise_add, fused_dropout_add,
                 fused_act_dropout, layer_norm, cast, squeeze, slice,
                 unsqueeze, one_hot, gather)
from .loss import (softmax_with_cross_entropy,
                   sigmoid_cross_entropy_with_logits)
from .sequence_lod import sequence_pool
from .control_flow import less_than
