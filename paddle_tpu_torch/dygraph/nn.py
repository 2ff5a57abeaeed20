"""Dygraph layer classes (counterpart of ``paddle_tpu/dygraph/nn.py``:
the four BERT builds from, Linear, Embedding, LayerNorm and Dropout, and
the three ResNet builds from, Conv2D, Pool2D and BatchNorm).  Each wraps
the shared ``fluid.layers`` op builders or ``emit_op``, which run eagerly
through the tracer in dygraph mode.  ``BatchNorm`` is its dygraph branch
only: the static one waits for its slice (ROADMAP.md)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..fluid import layers as L
from ..fluid.framework import (get_default_dtype, in_dygraph_mode,
                               torch_dtype, _dygraph_tracer)
from ..fluid.initializer import ConstantInitializer, NormalInitializer
from ..fluid.layer_helper import LayerHelper, emit_op
from ..fluid.layers.nn import _pair
from .layers import Layer


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype=None):
        dtype = dtype or get_default_dtype()
        super().__init__(dtype=dtype)
        helper = LayerHelper("linear")
        self.weight = helper.create_parameter(param_attr,
                                              [input_dim, output_dim], dtype)
        self.bias = helper.create_parameter(bias_attr, [output_dim], dtype,
                                            is_bias=True) \
            if bias_attr is not False else None
        self._act = act

    def forward(self, x):
        out = L.matmul(x, self.weight)
        if self.bias is not None:
            out = L.elementwise_add(out, self.bias, axis=-1)
        if self._act:
            out = getattr(L, self._act)(out)
        return out


class Conv2D(Layer):
    """2-d convolution, filters [num_filters, num_channels / groups, kh,
    kw] from He's normal N(0, 2 / fan_in); the bias on the channel axis
    (1 under NCHW, the last under NHWC)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype="float32",
                 data_format="NCHW"):
        super().__init__(dtype=dtype)
        helper = LayerHelper("conv2d")
        fs = _pair(filter_size)
        self._stride = _pair(stride)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._groups = groups
        self._act = act
        self._data_format = data_format
        fan_in = (num_channels // groups) * fs[0] * fs[1]
        self.weight = helper.create_parameter(
            param_attr, [num_filters, num_channels // groups] + fs, dtype,
            default_initializer=NormalInitializer(0., math.sqrt(2. / fan_in)))
        self.bias = helper.create_parameter(bias_attr, [num_filters], dtype,
                                            is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x):
        out = emit_op(
            "conv2d", "conv2d", {"Input": [x], "Filter": [self.weight]},
            ("Output",),
            {"strides": self._stride, "paddings": self._padding,
             "dilations": self._dilation, "groups": self._groups,
             "data_format": self._data_format})["Output"][0]
        if self.bias is not None:
            out = L.elementwise_add(
                out, self.bias,
                axis=1 if self._data_format == "NCHW" else -1)
        if self._act:
            out = getattr(L, self._act)(out)
        return out


class Pool2D(Layer):
    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True):
        super().__init__()
        self._attrs = dict(pool_size=pool_size, pool_type=pool_type,
                           pool_stride=pool_stride, pool_padding=pool_padding,
                           global_pooling=global_pooling, ceil_mode=ceil_mode,
                           exclusive=exclusive)

    def forward(self, x):
        return L.pool2d(x, **self._attrs)


class BatchNorm(Layer):
    """Batch norm over the channel axis; the moving mean and variance are
    buffers (``_mean``, ``_variance``), written back after each call in
    training (``is_test = not self.training``)."""

    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype="float32", data_layout="NCHW", in_place=False,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(dtype=dtype)
        helper = LayerHelper("batch_norm")
        self.weight = helper.create_parameter(
            param_attr, [num_channels], dtype,
            default_initializer=ConstantInitializer(1.0))
        self.bias = helper.create_parameter(bias_attr, [num_channels], dtype,
                                            is_bias=True)
        device = _dygraph_tracer().device if in_dygraph_mode() else None
        self.register_buffer("_mean", torch.zeros(
            [num_channels], dtype=torch_dtype(dtype), device=device))
        self.register_buffer("_variance", torch.ones(
            [num_channels], dtype=torch_dtype(dtype), device=device))
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_layout = data_layout
        self._use_global_stats = use_global_stats
        self._act = act

    def forward(self, x):
        if not in_dygraph_mode():
            raise NotImplementedError(
                "dygraph BatchNorm in a static program is not ported yet")
        attrs = {"momentum": self._momentum, "epsilon": self._epsilon,
                 "is_test": not self.training,
                 "data_layout": self._data_layout,
                 "use_global_stats": self._use_global_stats}
        outs = _dygraph_tracer().trace_op(
            "batch_norm",
            {"X": [x], "Scale": [self.weight], "Bias": [self.bias],
             "Mean": [self._mean], "Variance": [self._variance]},
            {"Y": [None]}, attrs)
        # the moving statistics, written back (the op's in-place outputs)
        self._mean.set_value(outs["MeanOut"][0]._value)
        self._variance.set_value(outs["VarianceOut"][0]._value)
        out = outs["Y"][0]
        if self._act:
            out = getattr(L, self._act)(out)
        return out


class Embedding(Layer):
    """Both calling conventions: fluid ``Embedding([vocab, dim])`` and 2.0
    ``Embedding(num_embeddings, embedding_dim)``."""

    def __init__(self, size, embedding_dim=None, is_sparse=False,
                 is_distributed=False, padding_idx=None, sparse=False,
                 param_attr=None, weight_attr=None, dtype="float32",
                 name=None):
        super().__init__(dtype=dtype)
        helper = LayerHelper("embedding")
        if embedding_dim is not None and isinstance(size, int):
            size = [size, embedding_dim]
        self.weight = helper.create_parameter(param_attr or weight_attr,
                                              list(size), dtype)
        # negative indices count from the end; -1 internally: no padding
        self._padding_idx = -1 if padding_idx is None else (
            padding_idx if padding_idx >= 0
            else int(size[0]) + int(padding_idx))

    def forward(self, ids):
        return emit_op("embedding", "lookup_table_v2",
                       {"W": [self.weight], "Ids": [ids]}, ("Out",),
                       {"padding_idx": self._padding_idx})["Out"][0]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        helper = LayerHelper("layer_norm")
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = int(np.prod(normalized_shape))
        self.weight = helper.create_parameter(
            param_attr, [n], dtype,
            default_initializer=ConstantInitializer(1.0)) if scale else None
        self.bias = helper.create_parameter(bias_attr, [n], dtype,
                                            is_bias=True) if shift else None
        self._epsilon = epsilon
        self._act = act
        self._nshape = normalized_shape

    def forward(self, x):
        ins = {"X": [x]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        begin = len(x.shape) - len(self._nshape)
        out = emit_op("layer_norm", "layer_norm", ins, ("Y",),
                      {"epsilon": self._epsilon,
                       "begin_norm_axis": begin})["Y"][0]
        if self._act:
            out = getattr(L, self._act)(out)
        return out


class Dropout(Layer):
    def __init__(self, p=0.5, seed=None,
                 dropout_implementation="downgrade_in_infer",
                 is_test=False):
        super().__init__()
        self._p = p
        self._impl = dropout_implementation

    def forward(self, x):
        return L.dropout(x, self._p, is_test=not self.training,
                         dropout_implementation=self._impl)
