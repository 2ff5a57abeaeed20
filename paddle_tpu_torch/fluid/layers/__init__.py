"""fluid.layers namespace: the op builders the ported slices and the 2.0
surface (paddle.tensor, nn.functional) use, the image layers, the control
flow, the in-graph learning-rate schedules, the recurrent layers with
the decode framework, the sequence tier (the padded ``sequence_*``
layers, the CRF, CTC and sampled heads), the detection layers and the
plumbing tail."""
from . import tensor
from . import nn
from . import loss
from . import metric_op
from . import sequence_lod
from . import control_flow
from . import rnn
from . import extras
from . import detection

from .tensor import (data, _to_variable, fill_constant, create_global_var,
                     concat, assign, fill_constant_batch_size_like, sums,
                     ones_like, zeros_like, zeros, ones, argmax, argmin,
                     argsort, linspace, increment, eye, range, diag)
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
                 mish, swish, logsigmoid, stanh, brelu, conv2d_transpose,
                 group_norm, instance_norm, pad2d, relu_, unfold,
                 data_norm, cos_sim, cond_value, uniform_random,
                 gaussian_random, matmul_v2)
from .loss import (softmax_with_cross_entropy,
                   sigmoid_cross_entropy_with_logits, square_error_cost,
                   log_loss, huber_loss, kldiv_loss, mse_loss,
                   cross_entropy, smooth_l1)
from .detection import *  # noqa: F401,F403
from .metric_op import accuracy, auc
from .sequence_lod import (sequence_pool, sequence_conv, sequence_expand,
                           sequence_mask, sequence_pad, sequence_unpad,
                           sequence_erase, sequence_concat,
                           sequence_first_step, sequence_last_step,
                           sequence_slice, sequence_expand_as,
                           sequence_reshape, sequence_scatter,
                           sequence_enumerate, sequence_softmax,
                           sequence_reverse)
from .control_flow import (cond, while_loop, array_write, array_read,
                           array_length, create_array, less_than,
                           greater_than, equal,
                           increment as cf_increment, Switch,
                           Print, Assert, is_empty, case,
                           switch_case, IfElse, StaticRNN, DynamicRNN,
                           reorder_lod_tensor_by_rank, logical_and,
                           logical_or, logical_not)
from .extras import (adaptive_pool3d, maxout, lrn, crop_tensor, crop, sum,
                     strided_slice, shape, rank, unique, scatter_nd_add,
                     scatter_nd, multiplex, hash, shard_index, reverse,
                     dice_loss, continuous_value_model, filter_by_instag,
                     create_parameter, autoincreased_step_counter,
                     row_conv, beam_search, beam_search_decode,
                     gather_tree, conv3d, pool3d, affine_grid,
                     grid_sampler, pixel_shuffle, image_resize,
                     resize_bilinear, resize_nearest, resize_trilinear,
                     image_resize_short, resize_linear, prelu, soft_relu,
                     bilinear_tensor_product, spectral_norm, inplace_abn,
                     bpr_loss, rank_loss, margin_rank_loss,
                     teacher_student_sigmoid_loss, conv3d_transpose,
                     im2sequence, center_loss, warpctc, edit_distance, nce,
                     hsigmoid, sampled_softmax_with_cross_entropy,
                     linear_chain_crf, crf_decoding, chunk_eval,
                     ctc_greedy_decoder, psroi_pool, prroi_pool,
                     deformable_conv, pow, size, space_to_depth,
                     random_crop, unique_with_counts, isfinite, has_inf,
                     has_nan, sampling_id, mean_iou, add_position_encoding,
                     fsp_matrix, similarity_focus, py_func, affine_channel,
                     shuffle_channel, temporal_shift, unbind, logical_xor,
                     triu, uniform_random_batch_size_like,
                     gaussian_random_batch_size_like, pad_constant_like,
                     lod_reset, lod_append, merge_selected_rows,
                     get_tensor_from_selected_rows, tensor_array_to_tensor,
                     load)
from .rnn import (lstm_unit, gru_unit, dynamic_lstm_unit, dynamic_lstm,
                  dynamic_lstmp, dynamic_gru, lstm, RNNCell, LSTMCell,
                  GRUCell, rnn, birnn, Decoder, DecodeHelper, TrainingHelper,
                  GreedyEmbeddingHelper, SampleEmbeddingHelper, BasicDecoder,
                  dynamic_decode, BeamSearchDecoder)
from . import learning_rate_scheduler
from .learning_rate_scheduler import (
    exponential_decay, natural_exp_decay, inverse_time_decay,
    polynomial_decay, piecewise_decay, noam_decay, cosine_decay,
    linear_lr_warmup)
