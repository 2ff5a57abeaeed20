"""Dygraph layer classes (counterpart of ``paddle_tpu/dygraph/nn.py``:
the four BERT builds from, Linear, Embedding, LayerNorm and Dropout, the
three ResNet builds from, Conv2D, Pool2D and BatchNorm, and the image
layers).  Each wraps the shared ``fluid.layers`` op builders or
``emit_op``, which run eagerly through the tracer in dygraph mode and
append ops to the current program otherwise."""
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
    training (``is_test = not self.training``).  Called while a program
    is built, it appends the op over parameters seeded from the buffers
    (``_static_forward``)."""

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

    def _static_forward(self, x, attrs):
        """In a program: the moving statistics become persistable
        parameters (not trained) seeded from the buffers, made once, and
        the op writes them back under their own names."""
        if getattr(self, "_static_stats", None) is None:
            from ..fluid.initializer import NumpyArrayInitializer
            from ..fluid.param_attr import ParamAttr
            helper = LayerHelper("batch_norm")
            stats = []
            for buf in (self._mean, self._variance):
                value = buf._value.detach().cpu().numpy()
                var = helper.create_parameter(
                    ParamAttr(initializer=NumpyArrayInitializer(value),
                              trainable=False), [int(value.shape[0])],
                    self._dtype)
                var.stop_gradient = True
                stats.append(var)
            self._static_stats = tuple(stats)
        mean, var = self._static_stats
        helper = LayerHelper("batch_norm")
        y = helper.create_variable_for_type_inference()
        helper.append_op(
            "batch_norm",
            inputs={"X": [x], "Scale": [self.weight], "Bias": [self.bias],
                    "Mean": [mean], "Variance": [var]},
            outputs={"Y": [y], "MeanOut": [mean], "VarianceOut": [var]},
            attrs=attrs)
        return y

    def forward(self, x):
        attrs = {"momentum": self._momentum, "epsilon": self._epsilon,
                 "is_test": not self.training,
                 "data_layout": self._data_layout,
                 "use_global_stats": self._use_global_stats}
        if not in_dygraph_mode():
            out = self._static_forward(x, attrs)
            return getattr(L, self._act)(out) if self._act else out
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


# -- the image layers ---------------------------------------------------------
def _listed(v, n):
    return [v] * n if isinstance(v, int) else list(v)


class _ConvLayer(Layer):
    """The shared tail of the transposed and 3-d convolution classes: the
    op with its attrs, the bias on axis 1, the activation."""

    OP = None

    def _make(self, n, num_channels, num_filters, filter_size, stride,
              padding, dilation, groups, param_attr, bias_attr, act, dtype,
              transposed):
        helper = LayerHelper(self.OP)
        self._attrs = {"strides": _listed(stride, n),
                       "paddings": _listed(padding, n),
                       "dilations": _listed(dilation, n), "groups": groups}
        self._act = act
        shape = ([num_channels, num_filters // groups] if transposed
                 else [num_filters, num_channels // groups])
        self.weight = helper.create_parameter(
            param_attr, shape + _listed(filter_size, n), dtype)
        self.bias = helper.create_parameter(bias_attr, [num_filters], dtype,
                                            is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x):
        out = emit_op(self.OP, self.OP,
                      {"Input": [x], "Filter": [self.weight]}, ("Output",),
                      self._attrs)["Output"][0]
        if self.bias is not None:
            out = L.elementwise_add(out, self.bias, axis=1)
        return getattr(L, self._act)(out) if self._act else out


class Conv2DTranspose(_ConvLayer):
    """Filter ``[num_channels, num_filters/groups, kh, kw]``; ``output_size``
    sets the output's height and width (rows added on the high edge)."""

    OP = "conv2d_transpose"

    def __init__(self, num_channels, num_filters, filter_size,
                 output_size=None, padding=0, stride=1, dilation=1,
                 groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
                 act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self._make(2, num_channels, num_filters, filter_size, stride,
                   padding, dilation, groups, param_attr, bias_attr, act,
                   dtype, True)
        if output_size is not None:
            self._attrs["output_size"] = _listed(output_size, 2)


class Conv3D(_ConvLayer):
    OP = "conv3d"

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self._make(3, num_channels, num_filters, filter_size, stride,
                   padding, dilation, groups, param_attr, bias_attr, act,
                   dtype, False)


class Conv3DTranspose(_ConvLayer):
    OP = "conv3d_transpose"

    def __init__(self, num_channels, num_filters, filter_size,
                 padding=0, stride=1, dilation=1, groups=1,
                 param_attr=None, bias_attr=None, use_cudnn=True, act=None,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        self._make(3, num_channels, num_filters, filter_size, stride,
                   padding, dilation, groups, param_attr, bias_attr, act,
                   dtype, True)


class PRelu(Layer):
    """One alpha (``all``) or one a channel (``channel``), 0.25 to start."""

    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        helper = LayerHelper("prelu")
        self.weight = helper.create_parameter(
            param_attr, [1] if mode == "all" else [channel], dtype,
            default_initializer=ConstantInitializer(0.25))
        self._mode = mode

    def forward(self, x):
        return emit_op("prelu", "prelu", {"X": [x], "Alpha": [self.weight]},
                       ("Out",), {"mode": self._mode})["Out"][0]


class InstanceNorm(Layer):
    def __init__(self, num_channels, epsilon=1e-5, param_attr=None,
                 bias_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        helper = LayerHelper("instance_norm")
        self.scale = helper.create_parameter(
            param_attr, [num_channels], dtype,
            default_initializer=ConstantInitializer(1.0))
        self.bias = helper.create_parameter(bias_attr, [num_channels],
                                            dtype, is_bias=True)
        self._eps = epsilon

    def forward(self, x):
        return emit_op("instance_norm", "instance_norm",
                       {"X": [x], "Scale": [self.scale], "Bias": [self.bias]},
                       ("Y",), {"epsilon": self._eps})["Y"][0]


class GroupNorm(Layer):
    def __init__(self, channels, groups, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        helper = LayerHelper("group_norm")
        self.weight = helper.create_parameter(
            param_attr, [channels], dtype,
            default_initializer=ConstantInitializer(1.0))
        self.bias = helper.create_parameter(bias_attr, [channels], dtype,
                                            is_bias=True)
        self._groups, self._eps, self._act = groups, epsilon, act

    def forward(self, x):
        out = emit_op("group_norm", "group_norm",
                      {"X": [x], "Scale": [self.weight],
                       "Bias": [self.bias]}, ("Y",),
                      {"groups": self._groups, "epsilon": self._eps})["Y"][0]
        return getattr(L, self._act)(out) if self._act else out


def _power_iteration(wm, u, v, iters, eps):
    for _ in range(iters):
        v = wm.t() @ u
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
        u = wm @ v
        u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
    return u, v


class SpectralNorm(Layer):
    """``weight / σ`` by the ``spectral_norm`` op from the layer's own U
    and V (N(0, 1), not trained); under a tracer the iterated vectors are
    written back, so the estimate compounds from call to call as the
    reference kernel's in-place U and V do."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        helper = LayerHelper("spectral_norm")
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        self.weight_u = helper.create_parameter(
            None, [h], dtype, default_initializer=NormalInitializer(0., 1.))
        self.weight_v = helper.create_parameter(
            None, [w], dtype, default_initializer=NormalInitializer(0., 1.))
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True
        self._cfg = (dim, power_iters, eps)

    def forward(self, weight):
        dim, iters, eps = self._cfg
        out = emit_op("spectral_norm", "spectral_norm",
                      {"Weight": [weight], "U": [self.weight_u],
                       "V": [self.weight_v]}, ("Out",),
                      {"dim": dim, "power_iters": iters, "eps": eps})["Out"][0]
        if in_dygraph_mode() and iters > 0:
            with torch.no_grad():
                wv = getattr(weight, "_value", weight)
                wm = torch.movedim(wv, dim, 0).reshape(wv.shape[dim], -1)
                u, v = _power_iteration(wm, self.weight_u._value,
                                        self.weight_v._value, iters, eps)
            self.weight_u.set_value(u)
            self.weight_v.set_value(v)
        return out


class BilinearTensorProduct(Layer):
    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        helper = LayerHelper("bilinear_tensor_product")
        self.weight = helper.create_parameter(
            param_attr, [output_dim, input1_dim, input2_dim], dtype)
        self.bias = helper.create_parameter(bias_attr, [1, output_dim],
                                            dtype, is_bias=True)
        self._act = act

    def forward(self, x, y):
        out = emit_op("bilinear_tensor_product", "bilinear_tensor_product",
                      {"X": [x], "Y": [y], "Weight": [self.weight],
                       "Bias": [self.bias]}, ("Out",), {})["Out"][0]
        return getattr(L, self._act)(out) if self._act else out


class Flatten(Layer):
    """Axes ``start_axis`` to ``stop_axis`` into one, by a reshape."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self._start, self._stop = start_axis, stop_axis

    def forward(self, x):
        nd = len(x.shape)
        start, stop = self._start % nd, self._stop % nd
        return L.reshape(x, list(x.shape[:start]) + [-1]
                         + list(x.shape[stop + 1:]))


# --- the sequence tier -------------------------------------------------------
class GRUUnit(Layer):
    """One GRU step over an already projected ``input`` [B, 3D] and
    ``hidden`` [B, D]: (new hidden, new hidden, candidate).  As the
    reference's, the reset gate is computed and never applied."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32"):
        super().__init__(dtype=dtype)
        helper = LayerHelper("gru_unit")
        d = size // 3
        self.weight = helper.create_parameter(param_attr, [d, d * 3], dtype)
        self.bias = helper.create_parameter(bias_attr, [1, d * 3], dtype,
                                            is_bias=True)
        self._d = d
        self._activation = activation
        self._gate_activation = gate_activation

    def forward(self, input, hidden):
        g = input + L.matmul(hidden, self.weight) + self.bias
        u, _, c = L.split(g, [self._d] * 3, dim=-1)
        u = getattr(L, self._gate_activation)(u)
        c = getattr(L, self._activation)(c)
        new_h = u * hidden + (1 - u) * c
        return new_h, new_h, c


class SequenceConv(Layer):
    """``sequence_conv`` over padded [B, T, D] input; the filter
    [filter_size · D, num_filters] and the bias are made at the first
    call, when D is known."""

    def __init__(self, name_scope, num_filters, filter_size=3,
                 filter_stride=1, padding=None, bias_attr=None,
                 param_attr=None, act=None):
        super().__init__()
        self._num_filters = num_filters
        self._filter_size = filter_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._act = act
        self._built = False

    def forward(self, x):
        if not self._built:
            helper = LayerHelper("sequence_conv")
            self.weight = helper.create_parameter(
                self._param_attr,
                [self._filter_size * int(x.shape[-1]), self._num_filters],
                "float32")
            self.bias = helper.create_parameter(
                self._bias_attr, [self._num_filters], "float32",
                is_bias=True) if self._bias_attr is not False else None
            self._built = True
        out = emit_op("sequence_conv", "sequence_conv",
                      {"X": [x], "Filter": [self.weight]}, ("Out",),
                      {"contextLength": self._filter_size,
                       "contextStart": -(self._filter_size // 2),
                       "contextStride": 1})["Out"][0]
        if self.bias is not None:
            out = out + self.bias
        return getattr(L, self._act)(out) if self._act else out


class NCE(Layer):
    """The ``nce`` cost with uniform negatives; ``sampler`` is checked and
    not read, as in the reference."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=None,
                 sampler="uniform", custom_dist=None, seed=0,
                 is_sparse=False, dtype="float32"):
        super().__init__(dtype=dtype)
        helper = LayerHelper("nce")
        self.weight = helper.create_parameter(
            param_attr, [num_total_classes, dim], dtype)
        self.bias = helper.create_parameter(
            bias_attr, [num_total_classes, 1], dtype, is_bias=True)
        samplers = {"uniform": 0, "log_uniform": 1, "custom_dist": 2}
        if sampler not in samplers:
            raise ValueError(f"NCE sampler must be one of "
                             f"{sorted(samplers)}, got {sampler!r}")
        self._attrs = {"num_total_classes": num_total_classes,
                       "num_neg_samples": num_neg_samples or 10,
                       "seed": seed, "sampler": samplers[sampler]}

    def forward(self, input, label, sample_weight=None):
        return emit_op("nce", "nce",
                       {"Input": [input], "Label": [label],
                        "Weight": [self.weight], "Bias": [self.bias]},
                       ("Cost", "SampleLogits", "SampleLabels"),
                       self._attrs)["Cost"][0]


class TreeConv(Layer):
    """``tree_conv`` with a [feature_size, 3, output_size, num_filters]
    filter (which the op reads as [D, H, depth, out]), the bias, then
    ``act``."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None, bias_attr=None,
                 name=None, dtype="float32"):
        super().__init__(dtype=dtype)
        helper = LayerHelper("tree_conv")
        self.weight = helper.create_parameter(
            param_attr, [feature_size, 3, output_size, num_filters], dtype)
        self.bias = helper.create_parameter(
            bias_attr, [num_filters], dtype, is_bias=True) \
            if bias_attr is not False else None
        self._attrs = {"max_depth": max_depth, "output_size": output_size,
                       "num_filters": num_filters}
        self._act = act

    def forward(self, nodes_vector, edge_set):
        out = emit_op("tree_conv", "tree_conv",
                      {"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
                       "Filter": [self.weight]}, ("Out",),
                      self._attrs)["Out"][0]
        if self.bias is not None:
            out = out + self.bias
        return getattr(L, self._act)(out) if self._act else out
