"""paddle.nn.functional (counterpart of ``paddle_tpu/nn/functional.py``):
functions over the fluid op builders, in a program and under a tracer
alike; thin wrappers fit 2.0's conventions (training flags, reductions,
int-or-tuple sizes) onto the fluid builders."""
from __future__ import annotations

import numpy as np

from ..fluid import layers as L
from ..fluid.layer_helper import emit_op
from ..fluid.layers import nn as _nn


# -- activations -------------------------------------------------------------
relu = _nn.relu
relu6 = _nn.relu6
gelu = _nn.gelu
sigmoid = _nn.sigmoid
tanh = _nn.tanh
silu = _nn.silu
leaky_relu = _nn.leaky_relu
elu = _nn.elu
selu = _nn.selu
softplus = _nn.softplus
softsign = _nn.softsign
softshrink = _nn.softshrink
hardshrink = _nn.hard_shrink
tanhshrink = _nn.tanh_shrink
thresholded_relu = _nn.thresholded_relu
hardswish = _nn.hard_swish
hardsigmoid = _nn.hard_sigmoid
mish = _nn.mish
swish = _nn.swish
log_sigmoid = _nn.logsigmoid
softmax = L.softmax
log_softmax = L.log_softmax


def hardtanh(x, min=-1.0, max=1.0):
    return L.clip(x, min, max)


def prelu(x, weight):
    """One alpha: mode "all"; one a channel: broadcast along C."""
    n = int(np.prod(weight.shape)) if hasattr(weight, "shape") else 1
    mode = "all" if n == 1 else "channel"
    return emit_op("prelu", "prelu", {"X": [x], "Alpha": [weight]},
                   ("Out",), {"mode": mode})["Out"][0]


def glu(x, axis=-1):
    a, b = L.split(x, 2, dim=axis)
    return a * L.sigmoid(b)


# -- regularization / normalization ------------------------------------------
embedding_fluid = L.embedding
one_hot = L.one_hot
pad = L.pad
label_smooth = L.label_smooth
normalize = L.l2_normalize


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    impl = ("upscale_in_train" if mode == "upscale_in_train"
            else "downgrade_in_infer")
    return L.dropout(x, p, is_test=not training,
                     dropout_implementation=impl, name=name)


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Whole channels dropped: a mask of shape [N, C, 1, 1] broadcast."""
    if not training or p <= 0.0:
        return x
    n, c = (x.shape[0], x.shape[1]) if data_format == "NCHW" \
        else (x.shape[0], x.shape[-1])
    shape = [n, c, 1, 1] if data_format == "NCHW" else [n, 1, 1, c]
    mask = L.dropout(L.ones(shape, x.dtype), p, is_test=False,
                     dropout_implementation="upscale_in_train")
    return x * mask


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of a given weight (``lookup_table_v2``)."""
    pad_i = -1 if padding_idx is None else int(padding_idx)
    if pad_i < -1:
        pad_i = int(weight.shape[0]) + pad_i
    return emit_op("embedding", "lookup_table_v2",
                   {"W": [weight], "Ids": [x]}, ("Out",),
                   {"padding_idx": pad_i})["Out"][0]


# -- losses ------------------------------------------------------------------
cross_entropy = L.softmax_with_cross_entropy
square_error_cost = L.square_error_cost
sigmoid_cross_entropy_with_logits = L.sigmoid_cross_entropy_with_logits
binary_cross_entropy = L.loss.log_loss
kl_div = L.kldiv_loss
mse_loss = L.mse_loss


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """Reduced over ``axis`` (fluid's ``cos_sim`` fixes the last)."""
    num = L.reduce_sum(x1 * x2, dim=axis)
    den = L.sqrt(L.reduce_sum(L.square(x1), dim=axis)
                 * L.reduce_sum(L.square(x2), dim=axis) + eps)
    return num / den


def _reduce(loss, reduction):
    if reduction == "mean":
        return L.reduce_mean(loss)
    if reduction == "sum":
        return L.reduce_sum(loss)
    return loss


def l1_loss(input, label, reduction="mean"):
    return _reduce(L.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    return _reduce(emit_op("huber_loss", "huber_loss",
                           {"X": [input], "Y": [label]}, ("Out",),
                           {"delta": float(delta)})["Out"][0], reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean"):
    """The reduction is the op's: "mean" is sum(w·loss) / sum(w·mask)
    over the rows not ignored."""
    ins = {"X": [input], "Label": [label]}
    if weight is not None:
        ins["Weight"] = [weight]
    return emit_op("nll_loss", "nll_loss", ins, ("Out",),
                   {"reduction": reduction,
                    "ignore_index": ignore_index})["Out"][0]


def binary_cross_entropy_with_logits(logit, label, reduction="mean"):
    return _reduce(L.sigmoid_cross_entropy_with_logits(logit, label),
                   reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce(L.relu(margin - label * (input - other)), reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean"):
    """The ``warpctc`` op over ``log_probs`` [B, T, C] (axis 0 the batch,
    as the reference reads it, where Paddle 2.0's is time-major); under
    ``mean`` each row's loss is divided by its label's length first."""
    loss = emit_op("warpctc", "warpctc",
                   {"Logits": [log_probs], "Label": [labels],
                    "LogitsLength": [input_lengths],
                    "LabelLength": [label_lengths]}, ("Loss",),
                   {"blank": blank, "norm_by_times": False})["Loss"][0]
    if reduction == "mean":
        loss = loss / L.cast(label_lengths, "float32")
    return _reduce(loss, reduction)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    d = x - y
    if p == 2.0:
        return L.sqrt(L.reduce_sum(L.square(d), dim=-1,
                                   keep_dim=keepdim) + epsilon)
    # epsilon inside the root on the general path too: identical pairs
    # give 0, where 0^(1/p) has an infinite derivative
    out = L.reduce_sum(L.elementwise_pow(
        L.abs(d), L.fill_constant([1], x.dtype, p)), dim=-1,
        keep_dim=keepdim) + epsilon
    return L.elementwise_pow(out, L.fill_constant([1], x.dtype, 1.0 / p))


def linear(x, weight, bias=None):
    out = L.matmul(x, weight)
    if bias is not None:
        out = L.elementwise_add(out, bias, axis=-1)
    return out


def _tolist(v, n):
    return [v] * n if isinstance(v, int) else list(v)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    out = emit_op("conv2d", "conv2d", {"Input": [x], "Filter": [weight]},
                  ("Output",),
                  {"strides": _tolist(stride, 2),
                   "paddings": _tolist(padding, 2),
                   "dilations": _tolist(dilation, 2), "groups": groups,
                   "data_format": data_format})["Output"][0]
    if bias is not None:
        out = L.elementwise_add(out, bias, axis=1)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0):
    return L.pool2d(x, kernel_size, "max", stride or kernel_size, padding)


def avg_pool2d(x, kernel_size, stride=None, padding=0):
    return L.pool2d(x, kernel_size, "avg", stride or kernel_size, padding)


def adaptive_avg_pool2d(x, output_size):
    return L.adaptive_pool2d(x, output_size, "avg")


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW"):
    from ..fluid.framework import in_dygraph_mode, _dygraph_tracer
    from ..fluid.layer_helper import LayerHelper
    ins = {"X": [x], "Scale": [weight], "Bias": [bias],
           "Mean": [running_mean], "Variance": [running_var]}
    attrs = {"momentum": momentum, "epsilon": epsilon,
             "is_test": not training, "data_layout": data_format}
    if in_dygraph_mode():
        return _dygraph_tracer().trace_op(
            "batch_norm", ins, {"Y": [None]}, attrs)["Y"][0]
    helper = LayerHelper("batch_norm")
    y = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("batch_norm", inputs=ins,
                     outputs={"Y": [y], "MeanOut": [running_mean],
                              "VarianceOut": [running_var]}, attrs=attrs)
    return y


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    shape = ([normalized_shape] if isinstance(normalized_shape, int)
             else list(normalized_shape))
    ins = {"X": [x]}
    if weight is not None:
        ins["Scale"] = [weight]
    if bias is not None:
        ins["Bias"] = [bias]
    return emit_op("layer_norm", "layer_norm", ins, ("Y",),
                   {"epsilon": epsilon,
                    "begin_norm_axis": len(x.shape) - len(shape)})["Y"][0]


# -- 1-d and 3-d convolutions and pools ---------------------------------------
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NCL"):
    """[N, C, L] as a conv2d over a height of 1."""
    x4 = L.unsqueeze(x, [2])
    w4 = L.unsqueeze(weight, [2])
    out = emit_op("conv2d", "conv2d",
                  {"Input": [x4], "Filter": [w4]}, ("Output",),
                  {"strides": [1] + _tolist(stride, 1),
                   "paddings": [0] + _tolist(padding, 1),
                   "dilations": [1] + _tolist(dilation, 1),
                   "groups": groups})["Output"][0]
    out = L.squeeze(out, [2])
    if bias is not None:
        out = L.elementwise_add(out, bias, axis=1)
    return out


def _bias_c(out, bias):
    return out if bias is None else L.elementwise_add(out, bias, axis=1)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NCDHW"):
    out = emit_op("conv3d", "conv3d", {"Input": [x], "Filter": [weight]},
                  ("Output",),
                  {"strides": _tolist(stride, 3),
                   "paddings": _tolist(padding, 3),
                   "dilations": _tolist(dilation, 3),
                   "groups": groups})["Output"][0]
    return _bias_c(out, bias)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    """``output_padding`` rows go on the high edge (the reference's
    function drops the argument)."""
    out = emit_op("conv2d_transpose", "conv2d_transpose",
                  {"Input": [x], "Filter": [weight]}, ("Output",),
                  {"strides": _tolist(stride, 2),
                   "paddings": _tolist(padding, 2),
                   "dilations": _tolist(dilation, 2), "groups": groups,
                   "output_padding": _tolist(output_padding, 2)}
                  )["Output"][0]
    return _bias_c(out, bias)


def max_pool1d(x, kernel_size, stride=None, padding=0):
    out = L.pool2d(L.unsqueeze(x, [2]), [1] + _tolist(kernel_size, 1),
                   "max", [1] + _tolist(stride or kernel_size, 1),
                   [0] + _tolist(padding, 1))
    return L.squeeze(out, [2])


def avg_pool1d(x, kernel_size, stride=None, padding=0):
    out = L.pool2d(L.unsqueeze(x, [2]), [1] + _tolist(kernel_size, 1),
                   "avg", [1] + _tolist(stride or kernel_size, 1),
                   [0] + _tolist(padding, 1))
    return L.squeeze(out, [2])


def _pool3d(x, kind, kernel_size, stride, padding):
    return emit_op("pool3d", "pool3d", {"X": [x]}, ("Out",),
                   {"pooling_type": kind,
                    "ksize": _tolist(kernel_size, 3),
                    "strides": _tolist(stride or kernel_size, 3),
                    "paddings": _tolist(padding, 3)})["Out"][0]


def max_pool3d(x, kernel_size, stride=None, padding=0):
    return _pool3d(x, "max", kernel_size, stride, padding)


def avg_pool3d(x, kernel_size, stride=None, padding=0):
    return _pool3d(x, "avg", kernel_size, stride, padding)


def adaptive_max_pool2d(x, output_size):
    return L.adaptive_pool2d(x, output_size, "max")


# -- vision / sampling -------------------------------------------------------
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    return emit_op("pixel_shuffle", "pixel_shuffle", {"X": [x]}, ("Out",),
                   {"upscale_factor": upscale_factor,
                    "data_format": data_format})["Out"][0]


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """Bilinear, corners aligned, border values outside (the op reads
    neither ``mode`` nor ``padding_mode`` nor ``align_corners``)."""
    return emit_op("grid_sampler", "grid_sampler",
                   {"X": [x], "Grid": [grid]}, ("Output",),
                   {"mode": mode, "padding_mode": padding_mode,
                    "align_corners": align_corners})["Output"][0]


def affine_grid(theta, out_shape, align_corners=True):
    return emit_op("affine_grid", "affine_grid", {"Theta": [theta]},
                   ("Output",),
                   {"output_shape": list(out_shape),
                    "align_corners": align_corners})["Output"][0]


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    return emit_op("unfold", "unfold", {"X": [x]}, ("Y",),
                   {"kernel_sizes": _tolist(kernel_sizes, 2),
                    "strides": _tolist(strides, 2),
                    "paddings": _tolist(paddings, 2),
                    "dilations": _tolist(dilations, 2)})["Y"][0]


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """The ``{nearest,bilinear,bicubic}_interp`` op at ``align_mode`` 1
    (the source index ``ratio · k``, not torch's half-pixel one)."""
    op = {"nearest": "nearest_interp", "bilinear": "bilinear_interp",
          "bicubic": "bicubic_interp"}[mode]
    attrs = {"data_layout": data_format, "align_corners": align_corners}
    if size is not None:
        attrs["out_h"], attrs["out_w"] = int(size[0]), int(size[1])
    else:
        s = (scale_factor if isinstance(scale_factor, (list, tuple))
             else [scale_factor, scale_factor])
        attrs["scale"] = [float(v) for v in s]
    return emit_op("interpolate", op, {"X": [x]}, ("Out",), attrs)["Out"][0]


upsample = interpolate


# -- the 2.0 tail --------------------------------------------------------------
def _adaptive_1d(x, output_size, mode):
    out = L.adaptive_pool2d(L.unsqueeze(x, [2]), [1, int(output_size)], mode)
    return L.squeeze(out, [2])


def adaptive_avg_pool1d(x, output_size):
    return _adaptive_1d(x, output_size, "avg")


def adaptive_max_pool1d(x, output_size):
    return _adaptive_1d(x, output_size, "max")


def adaptive_avg_pool3d(x, output_size):
    return L.adaptive_pool3d(x, output_size, "avg")


def adaptive_max_pool3d(x, output_size):
    return L.adaptive_pool3d(x, output_size, "max")


def alpha_dropout(x, p=0.5, training=True):
    """Dropout that keeps SELU's mean and variance: dropped units take
    alpha' and the output is rescaled."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    if p >= 1.0:
        return L.zeros(list(x.shape), "float32") + 0.0 * x
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    keep = L.dropout(L.ones(list(x.shape), "float32"), p, is_test=False,
                     dropout_implementation="upscale_in_train") * (1 - p)
    return a * (x * keep + alpha_p * (1.0 - keep)) + b


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    if not training or p <= 0.0:
        return x
    n = x.shape[0]
    c = x.shape[1] if data_format == "NCDHW" else x.shape[-1]
    shape = ([n, c, 1, 1, 1] if data_format == "NCDHW"
             else [n, 1, 1, 1, c])
    mask = L.dropout(L.ones(shape, x.dtype), p, is_test=False,
                     dropout_implementation="upscale_in_train")
    return x * mask


def assign(x, output=None):
    return L.assign(x)


def bilinear(x1, x2, weight, bias=None):
    ins = {"X": [x1], "Y": [x2], "Weight": [weight]}
    if bias is not None:
        ins["Bias"] = [bias]
    return emit_op("bilinear", "bilinear_tensor_product", ins,
                   ("Out",), {})["Out"][0]


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    """``[N, C, L]`` as a transposed conv2d over a height of 1."""
    out = emit_op("conv2d_transpose", "conv2d_transpose",
                  {"Input": [L.unsqueeze(x, [2])],
                   "Filter": [L.unsqueeze(weight, [2])]}, ("Output",),
                  {"strides": [1] + _tolist(stride, 1),
                   "paddings": [0] + _tolist(padding, 1),
                   "dilations": [1] + _tolist(dilation, 1),
                   "groups": groups,
                   "output_padding": [0] + _tolist(output_padding, 1)}
                  )["Output"][0]
    return _bias_c(L.squeeze(out, [2]), bias)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    out = emit_op("conv3d_transpose", "conv3d_transpose",
                  {"Input": [x], "Filter": [weight]}, ("Output",),
                  {"strides": _tolist(stride, 3),
                   "paddings": _tolist(padding, 3),
                   "dilations": _tolist(dilation, 3),
                   "output_padding": _tolist(output_padding, 3),
                   "groups": groups})["Output"][0]
    return _bias_c(out, bias)


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    return emit_op("diag_embed", "diag_embed", {"Input": [input]},
                   ("Out",), {"offset": offset, "dim1": dim1,
                              "dim2": dim2})["Out"][0]


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, eps=1e-5, momentum=0.9, use_input_stats=True,
                  data_format="NCHW"):
    """Each sample's own statistics; the running ones are not read, as
    the reference's."""
    ins = {"X": [x]}
    if weight is not None:
        ins["Scale"] = [weight]
    if bias is not None:
        ins["Bias"] = [bias]
    return emit_op("instance_norm", "instance_norm", ins, ("Y",),
                   {"epsilon": eps})["Y"][0]


def local_response_norm(x, size=5, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    return L.lrn(x, n=size, k=k, alpha=alpha, beta=beta)


def hsigmoid_loss(input, label, num_classes, weight, bias=None, **kw):
    """The ``hierarchical_sigmoid`` op over the default binary tree."""
    ins = {"X": [input], "W": [weight], "Label": [label]}
    if bias is not None:
        ins["Bias"] = [bias]
    return emit_op("hsigmoid_loss", "hierarchical_sigmoid", ins,
                   ("Out",), {"num_classes": num_classes})["Out"][0]


def dice_loss(input, label, epsilon=1e-5):
    return L.dice_loss(input, label, epsilon)


def log_loss(input, label, epsilon=1e-4):
    return emit_op("log_loss", "log_loss",
                   {"Predicted": [input], "Labels": [label]}, ("Loss",),
                   {"epsilon": epsilon})["Loss"][0]


def maxout(x, groups, axis=1):
    return L.maxout(x, groups, axis=axis)


def row_conv(x, weight, act=None):
    out = emit_op("row_conv", "row_conv",
                  {"X": [x], "Filter": [weight]}, ("Out",), {})["Out"][0]
    return getattr(L.nn, act)(out) if act else out


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum"):
    """One-hot float labels, an optional normalizer, a reduction."""
    p = L.sigmoid(logit)
    ce = L.sigmoid_cross_entropy_with_logits(logit, label)
    p_t = p * label + (1.0 - p) * (1.0 - label)
    a_t = alpha * label + (1.0 - alpha) * (1.0 - label)
    loss = a_t * L.elementwise_pow(
        1.0 - p_t, L.fill_constant([1], "float32", gamma)) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Cross-entropy over anchor·positiveᵀ similarities, plus L2 on the
    embeddings."""
    l2 = l2_reg * (L.reduce_sum(L.square(anchor))
                   + L.reduce_sum(L.square(positive))) * 0.25
    sim = L.matmul(anchor, positive, transpose_y=True)
    lbl = L.reshape(labels, [-1, 1])
    same = L.cast(L.equal(lbl, L.reshape(labels, [1, -1])), "float32")
    tgt = same / L.reduce_sum(same, dim=1, keep_dim=True)
    ce = cross_entropy(sim, tgt, soft_label=True)
    return L.reduce_mean(ce) + l2


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    return L.softmax_with_cross_entropy(
        logits, label, soft_label=soft_label, ignore_index=ignore_index,
        axis=axis, return_softmax=return_softmax)
