"""fluid.layers tail (counterpart of ``paddle_tpu/fluid/layers/extras.py``,
the builders paddle.tensor and nn.functional reach): op-builder sugar
over the registered lowerings, mode-agnostic through ``emit_op``."""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper, emit_op
from . import nn as _nn


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
