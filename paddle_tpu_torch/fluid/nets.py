"""Composite network helpers (counterpart of ``paddle_tpu/fluid/nets.py``,
Paddle's ``python/paddle/fluid/nets.py``): ``simple_img_conv_pool``,
``img_conv_group``, ``sequence_conv_pool``, ``glu`` and
``scaled_dot_product_attention``, each built from ``fluid.layers``."""
from __future__ import annotations

from . import layers

__all__ = [
    "simple_img_conv_pool",
    "img_conv_group",
    "sequence_conv_pool",
    "glu",
    "scaled_dot_product_attention",
]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    """conv2d, then pool2d."""
    conv_out = layers.conv2d(input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """A stack of conv2d (each with batch_norm and dropout if asked), then
    one pool2d: VGG's block.  A conv followed by batch_norm has no bias
    and hands its activation to the batch_norm."""
    if not hasattr(conv_num_filter, "__len__"):
        raise TypeError("conv_num_filter must be a list or tuple")
    n = len(conv_num_filter)

    def _expand(v):
        return list(v) if hasattr(v, "__len__") else [v] * n

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    tmp = input
    for i in range(n):
        tmp = layers.conv2d(tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i],
                            bias_attr=(False if conv_with_batchnorm[i]
                                       else None),
                            act=None if conv_with_batchnorm[i] else conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i]:
                tmp = layers.dropout(tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    """sequence_conv, then sequence_pool, over padded [B, T, D] input: the
    text CNN's block."""
    conv_out = layers.sequence_conv(input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr,
                                    bias_attr=bias_attr, act=act)
    return layers.sequence_pool(conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """The gated linear unit: one half times the sigmoid of the other."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over queries [N, Lq, d]
    and keys, values [N, Lk, d] (d divisible by ``num_heads``); with more
    than one head each input first goes through an fc of its own."""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same feature size")
    if keys.shape[-1] != values.shape[-1]:
        raise ValueError("keys and values must have the same feature size")
    d_model = queries.shape[-1]
    if d_model % num_heads != 0:
        raise ValueError(f"feature size {d_model} is not divisible by "
                         f"num_heads {num_heads}")

    q, k, v = queries, keys, values
    if num_heads > 1:
        q = layers.fc(q, size=d_model, num_flatten_dims=2, bias_attr=False)
        k = layers.fc(k, size=d_model, num_flatten_dims=2, bias_attr=False)
        v = layers.fc(v, size=d_model, num_flatten_dims=2, bias_attr=False)

    def _split_heads(x):
        if num_heads == 1:
            return x
        b, t = x.shape[0], x.shape[1]
        x = layers.reshape(x, [b, t, num_heads, d_model // num_heads])
        return layers.transpose(x, perm=[0, 2, 1, 3])

    def _combine_heads(x):
        if num_heads == 1:
            return x
        x = layers.transpose(x, perm=[0, 2, 1, 3])
        b, t = x.shape[0], x.shape[1]
        return layers.reshape(x, [b, t, d_model])

    q, k, v = _split_heads(q), _split_heads(k), _split_heads(v)
    d_k = d_model // num_heads
    scores = layers.matmul(layers.scale(q, scale=d_k ** -0.5), k,
                           transpose_y=True)
    weights = layers.softmax(scores)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    return _combine_heads(layers.matmul(weights, v))
