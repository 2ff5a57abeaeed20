"""fluid.layers namespace: the op builders the ported slices use."""
from . import tensor
from . import nn
from . import loss
from . import metric_op
from . import sequence_lod
from . import control_flow
from . import rnn

from .tensor import (data, _to_variable, fill_constant, create_global_var,
                     concat, assign, fill_constant_batch_size_like, sums,
                     ones_like, zeros_like)
from .nn import (fc, embedding, dropout, softmax, reshape, transpose, scale,
                 matmul, relu, relu6, gelu, tanh, sigmoid, reduce_mean,
                 reduce_sum, split, stack,
                 mean, elementwise_op, elementwise_add, elementwise_sub,
                 elementwise_mul, elementwise_div, elementwise_max, square,
                 sqrt, clip, clip_by_norm, fused_dropout_add,
                 fused_act_dropout, layer_norm, cast, squeeze, slice,
                 unsqueeze, one_hot, gather, conv2d, pool2d, adaptive_pool2d,
                 batch_norm, flatten, topk, pull_box_sparse)
from .loss import (softmax_with_cross_entropy,
                   sigmoid_cross_entropy_with_logits, square_error_cost)
from .metric_op import accuracy
from .sequence_lod import sequence_pool
from .control_flow import less_than
