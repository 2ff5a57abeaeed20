"""Dygraph layer classes (counterpart of ``paddle_tpu/dygraph/nn.py``, the
four BERT builds from: Linear, Embedding, LayerNorm, Dropout).  Each
wraps the shared ``fluid.layers`` op builders or ``emit_op``, which run
eagerly through the tracer in dygraph mode."""
from __future__ import annotations

import numpy as np

from ..fluid import layers as L
from ..fluid.framework import get_default_dtype
from ..fluid.initializer import ConstantInitializer
from ..fluid.layer_helper import LayerHelper, emit_op
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
