"""fluid.layers namespace: the op builders the ported slices and the 2.0
surface (paddle.tensor, nn.functional) use."""
from . import tensor
from . import nn
from . import loss
from . import metric_op
from . import sequence_lod
from . import control_flow
from . import rnn
from . import extras

from .tensor import (data, _to_variable, fill_constant, create_global_var,
                     concat, assign, fill_constant_batch_size_like, sums,
                     ones_like, zeros_like, zeros, ones, argmax, argmin,
                     argsort, linspace, increment, eye, range)
from .nn import (fc, embedding, dropout, softmax, reshape, transpose, scale,
                 matmul, relu, relu6, gelu, tanh, sigmoid, reduce_mean,
                 reduce_sum, split, stack,
                 mean, elementwise_op, elementwise_add, elementwise_sub,
                 elementwise_mul, elementwise_div, elementwise_max, square,
                 sqrt, clip, clip_by_norm, fused_dropout_add,
                 fused_act_dropout, layer_norm, cast, squeeze, slice,
                 unsqueeze, one_hot, gather, conv2d, pool2d, adaptive_pool2d,
                 batch_norm, flatten, topk, pull_box_sparse, log_softmax,
                 mul, gather_nd, scatter, unstack, expand, expand_as, pad,
                 l2_normalize, label_smooth, where, elementwise_min,
                 elementwise_pow, elementwise_mod, elementwise_floordiv,
                 reduce_max, reduce_min, reduce_prod, reduce_all,
                 reduce_any, exp, log, abs, floor, ceil, round, sign, sin,
                 cos, rsqrt, reciprocal, log2, log10, log1p, sinh, cosh,
                 tan, asin, acos, atan, logsumexp, erf, silu, leaky_relu,
                 elu, selu, softplus, softsign, softshrink, hard_shrink,
                 tanh_shrink, thresholded_relu, hard_swish, hard_sigmoid,
                 mish, swish, logsigmoid, stanh)
from .loss import (softmax_with_cross_entropy,
                   sigmoid_cross_entropy_with_logits, square_error_cost,
                   log_loss, huber_loss, kldiv_loss, mse_loss)
from .metric_op import accuracy
from .sequence_lod import sequence_pool
from .control_flow import less_than, equal, is_empty
from .extras import (adaptive_pool3d, maxout, lrn, crop_tensor, crop, sum,
                     strided_slice, shape, rank, unique, scatter_nd_add,
                     scatter_nd, multiplex, shard_index, reverse, dice_loss,
                     create_parameter)
