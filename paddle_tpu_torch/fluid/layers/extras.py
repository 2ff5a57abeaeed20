"""fluid.layers tail (counterpart of ``paddle_tpu/fluid/layers/extras.py``,
the builders paddle.tensor, nn.functional, the image layers and the
sequence tier (the CRF, CTC and sampled-head builders) and the detection
tier (the position-sensitive pools, the deformable convolution) and the
fused inference tier (``add_position_encoding``, ``fsp_matrix``,
``similarity_focus``, ``py_func``) and the plumbing tail (the selected-rows
and LoD pass-throughs, ``tensor_array_to_tensor``, the
``*_batch_size_like`` random layers, ``load``) reach):
op-builder sugar over the registered lowerings, mode-agnostic through
``emit_op``; and the ``conv3d_transpose`` op, which the reference
registers here."""
from __future__ import annotations

import numpy as np
import torch

from ...ops.registry import register_op
from ..framework import Variable, in_dygraph_mode
from ..layer_helper import LayerHelper, emit_op
from . import nn as _nn
from . import tensor as _tensor


def _one(op, ins, out_slot="Out", layer=None, **attrs):
    return emit_op(layer or op, op, ins, (out_slot,), attrs)[out_slot][0]


def _many(op, ins, out_slots, **attrs):
    return emit_op(op, op, ins, tuple(out_slots), attrs)


def adaptive_pool3d(input, pool_size, pool_type="max", name=None):
    """Adaptive 3-d pooling by a reshape and a mean or max (the size must
    divide evenly)."""
    n, c, d, h, w = input.shape
    od, oh, ow = (pool_size,) * 3 if isinstance(pool_size, int) \
        else pool_size
    x = _nn.reshape(input, [n, c, od, d // od, oh, h // oh, ow, w // ow])
    red = _one("transpose", {"X": [x]}, layer="transpose",
               axis=[0, 1, 2, 4, 6, 3, 5, 7])
    red = _nn.reshape(red, [n, c, od, oh, ow, -1])
    if pool_type == "avg":
        return _nn.reduce_mean(red, dim=-1)
    return _nn.reduce_max(red, dim=-1)


def maxout(x, groups, name=None, axis=1):
    return _one("maxout", {"X": [x]}, groups=groups, axis=axis)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    return _one("lrn", {"X": [input]}, n=n, k=k, alpha=alpha, beta=beta)


def crop_tensor(x, shape=None, offsets=None, name=None):
    return _one("crop_tensor", {"X": [x]}, shape=list(shape),
                offsets=list(offsets or [0] * len(shape)))


crop = crop_tensor


def sum(x):
    xs = x if isinstance(x, (list, tuple)) else [x]
    return _one("sum", {"X": list(xs)}, layer="sum")


def strided_slice(input, axes, starts, ends, strides):
    return _one("strided_slice", {"Input": [input]}, axes=list(axes),
                starts=list(starts), ends=list(ends),
                strides=list(strides))


def shape(input):
    return _one("shape", {"Input": [input]}, layer="shape")


def rank(input):
    return _one("rank", {"Input": [input]}, layer="rank")


def pow(x, factor=1.0, name=None):
    if isinstance(factor, Variable):
        return _one("elementwise_pow", {"X": [x], "Y": [factor]},
                    layer="pow")
    return _one("pow", {"X": [x]}, factor=float(factor))


def size(input):
    return _one("size", {"Input": [input]}, layer="size")


def space_to_depth(x, blocksize, name=None):
    return _one("space_to_depth", {"X": [x]}, blocksize=blocksize)


def random_crop(x, shape, seed=None):
    return _one("random_crop", {"X": [x]}, shape=list(shape),
                op_seed=seed or 0)


def unique_with_counts(x, dtype="int32"):
    outs = _many("unique_with_counts", {"X": [x]},
                 ("Out", "Index", "Count"))
    return outs["Out"][0], outs["Index"][0], outs["Count"][0]


def isfinite(x):
    return _one("isfinite", {"X": [x]})


def has_inf(x):
    return _nn.reduce_any(_one("isinf_v2", {"X": [x]}, layer="has_inf"))


def has_nan(x):
    return _nn.reduce_any(_one("isnan_v2", {"X": [x]}, layer="has_nan"))


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    return _one("sampling_id", {"X": [x]}, op_seed=seed)


def mean_iou(input, label, num_classes):
    outs = _many("mean_iou", {"Predictions": [input], "Labels": [label]},
                 ("OutMeanIou", "OutWrong", "OutCorrect"),
                 num_classes=num_classes)
    return (outs["OutMeanIou"][0], outs["OutWrong"][0],
            outs["OutCorrect"][0])


def unique(x, dtype="int32"):
    outs = _many("unique", {"X": [x]}, ("Out", "Index"))
    return outs["Out"][0], outs["Index"][0]


def scatter_nd_add(ref, index, updates, name=None):
    return _one("scatter_nd_add",
                {"X": [ref], "Index": [index], "Updates": [updates]})


def scatter_nd(index, updates, shape, name=None):
    return _one("scatter_nd", {"Index": [index], "Updates": [updates]},
                shape=list(shape))


def multiplex(inputs, index):
    return _one("multiplex", {"X": list(inputs), "Ids": [index]})


def hash(input, hash_size, num_hash=1, name=None):
    return _one("hash", {"X": [input]}, mod_by=hash_size,
                num_hash=num_hash)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    return _one("shard_index", {"X": [input]}, index_num=index_num,
                nshards=nshards, shard_id=shard_id,
                ignore_value=ignore_value)


def reverse(x, axis):
    return _one("reverse", {"X": [x]},
                axis=[axis] if isinstance(axis, int) else list(axis))


def dice_loss(input, label, epsilon=1e-5):
    """1 - 2|A∩B| / (|A| + |B| + eps) with the integer label one-hot to
    the input's depth."""
    if len(label.shape) and label.shape[-1] == 1:
        label = _nn.squeeze(label, [-1])
    label = _nn.one_hot(label, input.shape[-1])
    reduce_dims = list(range(1, len(input.shape)))
    inse = _nn.reduce_sum(input * label, dim=reduce_dims)
    denom = (_nn.reduce_sum(input, dim=reduce_dims)
             + _nn.reduce_sum(label, dim=reduce_dims))
    return _nn.reduce_mean(1.0 - inse * 2.0 / (denom + epsilon))


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    from ..param_attr import ParamAttr
    helper = LayerHelper("create_parameter", name=name)
    if attr is None and name is not None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, list(shape), dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """The global step counter, a persistable int64 var that an
    ``increment`` op advances by ``step`` every run.  As in the
    reference, each call appends its own ``increment``: two schedules
    that each call it advance the counter twice a run."""
    from .tensor import create_global_var
    counter = create_global_var([1], float(begin - step), "int64",
                                persistable=True,
                                name=counter_name or "@step_counter@")
    LayerHelper("increment").append_op(
        "increment", inputs={"X": [counter]}, outputs={"Out": [counter]},
        attrs={"step": float(step)})
    return counter


def row_conv(input, future_context_size, param_attr=None, act=None):
    """The lookahead convolution over [B, T, D]: a [future_context_size +
    1, D] filter."""
    helper = LayerHelper("row_conv")
    w = helper.create_parameter(param_attr,
                                [future_context_size + 1, input.shape[-1]],
                                "float32")
    out = _one("row_conv", {"X": [input], "Filter": [w]})
    return getattr(_nn, act)(out) if act else out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One beam step: (selected ids, selected scores[, parent rows])."""
    outs = _many("beam_search",
                 {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                  "ids": [ids], "scores": [scores]},
                 ("selected_ids", "selected_scores", "parent_idx"),
                 beam_size=beam_size, end_id=end_id, level=level,
                 is_accumulated=is_accumulated)
    if return_parent_idx:
        return (outs["selected_ids"][0], outs["selected_scores"][0],
                outs["parent_idx"][0])
    return outs["selected_ids"][0], outs["selected_scores"][0]


def beam_search_decode(ids, scores, beam_size, end_id, name=None,
                       parent_idx=None):
    """The backtraced sentences [T, B, beam] and their scores."""
    ins = {"Ids": [ids], "Scores": [scores]}
    if parent_idx is not None:
        ins["ParentIdx"] = [parent_idx]
    outs = _many("beam_search_decode", ins,
                 ("SentenceIds", "SentenceScores"),
                 beam_size=beam_size, end_id=end_id)
    return outs["SentenceIds"][0], outs["SentenceScores"][0]


def gather_tree(ids, parents):
    return _one("gather_tree", {"Ids": [ids], "Parents": [parents]})


# -- the image layers ---------------------------------------------------------
def _triple(v):
    return [v] * 3 if isinstance(v, int) else list(v)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           act=None, name=None, data_format="NCDHW"):
    helper = LayerHelper("conv3d", name=name)
    w = helper.create_parameter(
        param_attr, [num_filters, input.shape[1] // groups]
        + _triple(filter_size), "float32")
    out = _one("conv3d", {"Input": [input], "Filter": [w]}, "Output",
               strides=_triple(stride), paddings=_triple(padding),
               dilations=_triple(dilation), groups=groups)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], "float32",
                                    is_bias=True)
        out = _nn.elementwise_add(out, b, axis=1)
    return getattr(_nn, act)(out) if act else out


def pool3d(input, pool_size=2, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, name=None):
    ks = _triple(pool_size)
    if global_pooling:
        ks = list(input.shape[2:])
        pool_stride, pool_padding = ks, 0
    return _one("pool3d", {"X": [input]}, pooling_type=pool_type, ksize=ks,
                strides=_triple(pool_stride),
                paddings=_triple(pool_padding))


def affine_grid(theta, out_shape, name=None):
    """The shape from a list, or from a Variable (the ``OutputShape``
    input)."""
    ins, attrs = {"Theta": [theta]}, {}
    if isinstance(out_shape, Variable):
        ins["OutputShape"] = [out_shape]
    else:
        attrs["output_shape"] = list(out_shape)
    return emit_op("affine_grid", "affine_grid", ins, ("Output",),
                   attrs)["Output"][0]


def grid_sampler(x, grid, name=None):
    return _one("grid_sampler", {"X": [x], "Grid": [grid]}, "Output")


def pixel_shuffle(x, upscale_factor):
    return _one("pixel_shuffle", {"X": [x]}, upscale_factor=upscale_factor)


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", align_corners=True,
                 data_format="NCHW"):
    """The ``*_interp`` op of ``resample``; ``out_shape`` sets the height
    and width only (a trilinear resize needs ``scale``), as the
    reference."""
    op = {"BILINEAR": "bilinear_interp", "NEAREST": "nearest_interp",
          "BICUBIC": "bicubic_interp",
          "TRILINEAR": "trilinear_interp"}[resample.upper()]
    attrs = {"align_corners": align_corners, "data_layout": data_format}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), \
            int(out_shape[1])
    else:
        attrs["scale"] = scale
    return _one(op, {"X": [input]}, layer="image_resize", **attrs)


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    align_corners=True):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        align_corners)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        align_corners)


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     align_corners=True):
    return image_resize(input, out_shape, scale, name, "TRILINEAR",
                        align_corners)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """The short side to ``out_short_len``, the long one in proportion
    (rounded)."""
    h, w = input.shape[2], input.shape[3]
    scale = out_short_len / float(min(h, w))
    return image_resize(input, (int(round(h * scale)),
                                int(round(w * scale))), resample=resample)


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_num=None, name=None):
    ins = {"X": [input], "ROIs": [rois]}
    if rois_num is not None:
        ins["RoisNum"] = [rois_num]
    return _one("psroi_pool", ins, output_channels=output_channels,
                spatial_scale=spatial_scale, pooled_height=pooled_height,
                pooled_width=pooled_width)


def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,
               pooled_width=1, rois_num=None, name=None):
    ins = {"X": [input], "ROIs": [rois]}
    if rois_num is not None:
        ins["RoisNum"] = [rois_num]
    return _one("prroi_pool", ins, spatial_scale=spatial_scale,
                pooled_height=pooled_height, pooled_width=pooled_width)


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=1,
                    deformable_groups=1, im2col_step=1, param_attr=None,
                    bias_attr=None, modulated=True, name=None):
    """The deformable convolution layer: ``deformable_conv`` (with the
    modulation mask) or ``deformable_conv_v1``, its filter a parameter,
    a bias on the channel axis unless ``bias_attr`` is False."""
    helper = LayerHelper("deformable_conv", name=name)
    fs = [filter_size] * 2 if isinstance(filter_size, int) \
        else list(filter_size)
    w = helper.create_parameter(param_attr,
                                [num_filters, input.shape[1] // groups] + fs,
                                "float32")
    ins = {"Input": [input], "Offset": [offset], "Filter": [w]}
    op_type = "deformable_conv" if modulated else "deformable_conv_v1"
    if modulated:
        ins["Mask"] = [mask]

    def pair(v):
        return [v] * 2 if isinstance(v, int) else list(v)
    out = _one(op_type, ins, "Output", strides=pair(stride),
               paddings=pair(padding), dilations=pair(dilation),
               groups=groups, deformable_groups=deformable_groups,
               im2col_step=im2col_step)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], "float32",
                                    is_bias=True)
        out = _nn.elementwise_add(out, b, axis=1)
    return out


def resize_linear(input, out_shape=None, scale=None, name=None,
                  align_corners=True):
    """``[N, C, L]`` through the bilinear op at a height of 1."""
    length = (int(out_shape[0]) if out_shape is not None
              else int(input.shape[-1] * scale))
    out = image_resize(_nn.unsqueeze(input, [2]), (1, length),
                       resample="BILINEAR", align_corners=align_corners)
    return _nn.squeeze(out, [2])


def prelu(x, mode="all", param_attr=None, name=None):
    """One alpha (``all``) or one a channel of axis 1."""
    helper = LayerHelper("prelu", name=name)
    alpha = helper.create_parameter(
        param_attr, [1 if mode == "all" else x.shape[1]], "float32")
    return _one("prelu", {"X": [x], "Alpha": [alpha]}, mode=mode)


def soft_relu(x, threshold=40.0, name=None):
    """``log(1 + exp(clip(x, -threshold, threshold)))``."""
    return _nn.log(1.0 + _nn.exp(_nn.clip(x, -threshold, threshold)))


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", name=name)
    w = helper.create_parameter(param_attr,
                                [size, x.shape[-1], y.shape[-1]], "float32")
    ins = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        ins["Bias"] = [helper.create_parameter(bias_attr, [1, size],
                                               "float32", is_bias=True)]
    out = _one("bilinear_tensor_product", ins)
    return getattr(_nn, act)(out) if act else out


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight / σ`` with the power iteration's U and V as parameters of
    their own (Xavier, as the reference creates them)."""
    helper = LayerHelper("spectral_norm", name=name)
    h = weight.shape[dim]
    u = helper.create_parameter(None, [h], "float32")
    v = helper.create_parameter(None, [int(np.prod(weight.shape)) // h],
                                "float32")
    return _one("spectral_norm", {"Weight": [weight], "U": [u], "V": [v]},
                dim=dim, power_iters=power_iters, eps=eps)


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _one("add_position_encoding", {"X": [input]}, alpha=alpha,
                beta=beta)


def fsp_matrix(x, y):
    return _one("fsp", {"X": [x], "Y": [y]}, layer="fsp_matrix")


def similarity_focus(input, axis, indexes, name=None):
    return _one("similarity_focus", {"X": [input]}, axis=axis,
                indexes=list(indexes))


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """The host-Python op: ``func`` registered for ``py_func`` and called
    on numpy copies of ``x``; ``out`` declares the output variables, whose
    shapes and dtypes the callback's results take.  ``backward_func`` is
    not read, as in the reference."""
    from ...ops.catalog_tail_ops import register_py_func
    helper = LayerHelper("py_func")
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    op = helper.append_op(
        "py_func", inputs={"X": xs}, outputs={"Out": outs},
        attrs={"forward_callable_id": register_py_func(func),
               "out_shapes": [list(o.shape) for o in outs],
               "out_dtypes": [str(o.dtype or "float32") for o in outs]})
    result = list(op["Out"]) if in_dygraph_mode() else outs
    return result if len(result) > 1 else result[0]


def inplace_abn(input, act="identity", **kw):
    """Batch norm and its activation (in place in the reference's CUDA
    op only)."""
    return _nn.batch_norm(input, act=None if act == "identity" else act,
                          **kw)


def bpr_loss(input, label, name=None):
    return _one("bpr_loss", {"X": [input], "Label": [label]}, "Y")


def rank_loss(label, left, right, name=None):
    return _one("rank_loss",
                {"Label": [label], "Left": [left], "Right": [right]})


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    return _one("margin_rank_loss",
                {"Label": [label], "X1": [left], "X2": [right]},
                margin=margin)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """The bounds reach the op under their names here; the op reads
    ``soft_max_{up,low}_threshold`` (2 and -2), as the reference's."""
    return _one("teacher_student_sigmoid_loss",
                {"X": [input], "Label": [label]}, "Y",
                soft_max_up_bound=soft_max_up_bound,
                soft_max_lower_bound=soft_max_lower_bound)


@register_op("conv3d_transpose")
def _conv3d_transpose(ins, attrs, ctx):
    """The reference's ``lax.conv_transpose`` without ``transpose_kernel``:
    the stride-dilated input correlated with the filter as it lies (not
    flipped, unlike ``conv2d_transpose``), padded ``(k_eff - 1 - p,
    k_eff - 1 - p + output_padding)`` a dim: ``F.conv_transpose3d`` over
    the spatially flipped filter."""
    from ...ops.nn_ops import _conv_transpose
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = list(attrs.get("strides", [1, 1, 1]))
    pads = list(attrs.get("paddings", [0, 0, 0]))
    dil = list(attrs.get("dilations", [1, 1, 1]))
    opad = attrs.get("output_padding") or [0, 0, 0]
    crops = [(p, p - o) for p, o in zip(pads, opad)]
    return {"Output": [_conv_transpose(x, torch.flip(w, (2, 3, 4)), strides,
                                       dil, crops, attrs.get("groups", 1))]}


def conv3d_transpose(input, num_filters, output_size=None,
                     filter_size=None, stride=1, padding=0, dilation=1,
                     groups=1, param_attr=None, bias_attr=None, act=None,
                     name=None):
    """Filter ``[C, num_filters/groups, kd, kh, kw]``, bias on axis 1;
    the reference reads neither ``output_size`` nor ``dilation`` here."""
    helper = LayerHelper("conv3d_transpose", name=name)
    w = helper.create_parameter(
        param_attr, [input.shape[1], num_filters // groups]
        + _triple(filter_size), "float32")
    out = _one("conv3d_transpose", {"Input": [input], "Filter": [w]},
               "Output", strides=_triple(stride), paddings=_triple(padding),
               groups=groups)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], "float32",
                                    is_bias=True)
        out = _nn.elementwise_add(out, b, axis=1)
    return getattr(_nn, act)(out) if act else out


# --- the sequence tier: CRF, CTC, the sampled heads --------------------------
def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """Patch rows [B · out_h · out_w, C · kh · kw] of an image batch."""
    fs = [filter_size] * 2 if isinstance(filter_size, int) \
        else list(filter_size)
    return _one("im2sequence", {"X": [input]}, kernels=fs,
                strides=[stride] * 2 if isinstance(stride, int)
                else list(stride),
                paddings=[padding] * 4 if isinstance(padding, int)
                else list(padding))


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    helper = LayerHelper("center_loss")
    centers = helper.create_parameter(param_attr,
                                      [num_classes, input.shape[-1]],
                                      "float32")
    rate = _tensor.fill_constant([1], "float32", alpha)
    return _one("center_loss",
                {"X": [input], "Label": [label], "Centers": [centers],
                 "CenterUpdateRate": [rate]}, "Loss",
                need_update=update_center)


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss [B, 1] of padded logits [B, T, C] against padded labels."""
    ins = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        ins["LogitsLength"] = [input_length]
    if label_length is not None:
        ins["LabelLength"] = [label_length]
    return _one("warpctc", ins, "Loss", blank=blank,
                norm_by_times=norm_by_times)


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """(distances [B, 1], the sequence count); ``ignored_tokens`` is not
    read, as in the reference."""
    ins = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        ins["HypsLength"] = [input_length]
    if label_length is not None:
        ins["RefsLength"] = [label_length]
    outs = _many("edit_distance", ins, ("Out", "SequenceNum"),
                 normalized=normalized)
    return outs["Out"][0], outs["SequenceNum"][0]


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=5, name=None,
        seed=0, **kw):
    """The NCE cost [B, 1] with uniform negatives (``sample_weight`` and
    the sampler arguments are not read, as in the reference)."""
    helper = LayerHelper("nce", name=name)
    w = helper.create_parameter(param_attr,
                                [num_total_classes, input.shape[-1]],
                                "float32")
    b = helper.create_parameter(bias_attr, [num_total_classes], "float32",
                                is_bias=True)
    return _one("nce", {"Input": [input], "Label": [label],
                        "Weight": [w], "Bias": [b]}, "Cost",
                num_total_classes=num_total_classes,
                num_neg_samples=num_neg_samples, op_seed=seed)


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, **kw):
    helper = LayerHelper("hsigmoid", name=name)
    w = helper.create_parameter(param_attr,
                                [num_classes - 1, input.shape[-1]],
                                "float32")
    b = helper.create_parameter(bias_attr, [1, num_classes - 1],
                                "float32", is_bias=True)
    return _one("hierarchical_sigmoid",
                {"X": [input], "W": [w], "Bias": [b], "Label": [label]},
                "Out", layer="hsigmoid", num_classes=num_classes)


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1, seed=0, **kw):
    """The full ``softmax_with_cross_entropy``, as the reference computes
    it; the sampling arguments are accepted and not read."""
    from .loss import softmax_with_cross_entropy
    return softmax_with_cross_entropy(logits, label)


def linear_chain_crf(input, label, param_attr=None, length=None):
    """The CRF's negative log-likelihood [B, 1]; its transition parameter
    is [D + 2, D] (start, stop, then the transitions)."""
    helper = LayerHelper("linear_chain_crf")
    n_tags = input.shape[-1]
    w = helper.create_parameter(param_attr, [n_tags + 2, n_tags],
                                "float32")
    ins = {"Emission": [input], "Transition": [w], "Label": [label]}
    if length is not None:
        ins["Length"] = [length]
    return _one("linear_chain_crf", ins, "LogLikelihood")


def crf_decoding(input, param_attr=None, label=None, length=None):
    """The Viterbi path [B, T]; the transition is the CRF's, shared by the
    ``ParamAttr`` name."""
    helper = LayerHelper("crf_decoding")
    n_tags = input.shape[-1]
    w = helper.create_parameter(param_attr, [n_tags + 2, n_tags],
                                "float32")
    ins = {"Emission": [input], "Transition": [w]}
    if label is not None:
        ins["Label"] = [label]
    if length is not None:
        ins["Length"] = [length]
    return _one("crf_decoding", ins, "ViterbiPath")


CHUNK_OUTS = ("Precision", "Recall", "F1-Score", "NumInferChunks",
              "NumLabelChunks", "NumCorrectChunks")


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """(precision, recall, F1, inferred, labelled and correct chunks)."""
    ins = {"Inference": [input], "Label": [label]}
    if seq_length is not None:
        ins["SeqLength"] = [seq_length]
    outs = _many("chunk_eval", ins, CHUNK_OUTS, chunk_scheme=chunk_scheme,
                 num_chunk_types=num_chunk_types,
                 excluded_chunk_types=list(excluded_chunk_types or []))
    return tuple(outs[k][0] for k in CHUNK_OUTS)


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """The best class a step, then repeats merged and blanks removed
    (``ctc_align``): the rows alone, padded with 0, as the reference's
    builder returns them."""
    ids = _tensor.argmax(input, axis=-1)
    ins = {"Input": [ids]}
    if input_length is not None:
        ins["InputLength"] = [input_length]
    return _one("ctc_align", ins, "Output", layer="ctc_greedy_decoder",
                blank=blank, merge_repeated=True)


def continuous_value_model(input, cvm, use_cvm=True):
    return _one("cvm", {"X": [input], "CVM": [cvm]}, layer="cvm",
                use_cvm=use_cvm, out_slot="Y")


def filter_by_instag(ins, ins_tag, filter_tag, is_lod, out_val_if_empty=0):
    outs = _many("filter_by_instag",
                 {"Ins": [ins], "Ins_tag": [ins_tag],
                  "Filter_tag": [filter_tag]},
                 ("Out", "LossWeight", "IndexMap"),
                 is_lod=is_lod, out_val_if_empty=out_val_if_empty)
    return outs["Out"][0], outs["LossWeight"][0], outs["IndexMap"][0]


# --- the plumbing tail -------------------------------------------------------
def affine_channel(x, scale=None, bias=None, data_layout="NCHW",
                   name=None, act=None):
    """x·scale + bias on the channel axis; a missing scale is ones and a
    missing bias zeros, as in the reference."""
    c = x.shape[1] if data_layout == "NCHW" else x.shape[-1]
    if scale is None:
        scale = _tensor.fill_constant([c], "float32", 1.0)
    if bias is None:
        bias = _tensor.fill_constant([c], "float32", 0.0)
    out = _one("affine_channel", {"X": [x], "Scale": [scale],
                                  "Bias": [bias]},
               data_layout=data_layout)
    return getattr(_nn, act)(out) if act else out


def shuffle_channel(x, group, name=None):
    return _one("shuffle_channel", {"X": [x]}, group=group)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _one("temporal_shift", {"X": [x]}, seg_num=seg_num,
                shift_ratio=shift_ratio)


def unbind(input, axis=0):
    helper = LayerHelper("unbind")
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in range(input.shape[axis])]
    op = helper.append_op("unbind", inputs={"X": [input]},
                          outputs={"Out": outs}, attrs={"axis": axis})
    return list(op["Out"]) if in_dygraph_mode() else outs


def logical_xor(x, y, out=None, name=None):
    return _one("logical_xor", {"X": [x], "Y": [y]})


def triu(input, diagonal=0, name=None):
    from ...tensor import triu as _triu
    return _triu(input, diagonal)


def uniform_random_batch_size_like(input, shape, dtype="float32", min=-1.0,
                                   max=1.0, seed=0, input_dim_idx=0,
                                   output_dim_idx=0):
    return _one("uniform_random_batch_size_like", {"Input": [input]},
                shape=list(shape), min=min, max=max, op_seed=seed,
                input_dim_idx=input_dim_idx, output_dim_idx=output_dim_idx)


def gaussian_random_batch_size_like(input, shape, dtype="float32",
                                    mean=0.0, std=1.0, seed=0,
                                    input_dim_idx=0, output_dim_idx=0):
    return _one("gaussian_random_batch_size_like", {"Input": [input]},
                shape=list(shape), mean=mean, std=std, op_seed=seed,
                input_dim_idx=input_dim_idx, output_dim_idx=output_dim_idx)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _one("pad_constant_like", {"X": [x], "Y": [y]},
                pad_value=float(pad_value))


def lod_reset(x, y=None, target_lod=None):
    """x itself: lengths travel as explicit tensors, so there is no LoD
    to reset (the reference's builder appends no op either)."""
    return x


def lod_append(x, level):
    return x


def merge_selected_rows(x, name=None):
    """x itself: gradients are dense, so there are no SelectedRows to
    merge (the reference's builder appends no op either)."""
    return x


def get_tensor_from_selected_rows(x, name=None):
    return x


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """The tensor array's entries concatenated (or stacked) on ``axis``,
    and each entry's extent on it, through the ``tensor_array_to_tensor``
    op on the array the program built at run time (the reference's
    builder concatenates the entries its ``array_write`` calls recorded
    at build time, with the same values for arrays written in index
    order)."""
    outs = _many("tensor_array_to_tensor", {"X": [input]},
                 ("Out", "OutIndex"), axis=axis, use_stack=use_stack)
    return outs["Out"][0], outs["OutIndex"][0]


def load(out, file_path, load_as_fp16=False):
    """Append a ``load`` op that reads ``file_path``'s first array into
    ``out`` each time the program runs."""
    LayerHelper("load").append_op("load", inputs={}, outputs={"Out": [out]},
                                  attrs={"file_path": file_path})
    return out
