"""paddle.nn 2.0 layers (counterpart of ``paddle_tpu/nn/layer.py``: the
activations, the losses ``Model.prepare`` takes, the flatten, pooling
and batch-norm layers the vision models run, the transformer encoder
stack BERT runs, the encoder-decoder ``Transformer`` NMT runs, the
recurrent layers: ``LSTM``, ``GRU`` and ``SimpleRNN`` over the
``rnn_scan`` op, the three cells, and ``RNN`` and ``BiRNN``, which take
a cell over time step by step; and the image layers: the 1-d, 3-d and
transposed convolutions and pools, the instance, group, spectral,
local-response and sync norms, padding, upsampling, pixel shuffle and
the plain losses).

The encoder and decoder layers always emit the fused epilogues:
``fused_dropout_add`` for each residual and ``fused_act_dropout`` for the
FFN's gelu or relu.
The reference's ``PADDLE_TPU_UNFUSED_EPILOGUE`` switch, an ablation knob
of its MFU sweep, is not ported: an environment variable would take
training off the kernels.
"""
from __future__ import annotations

import copy
import math

import torch

from ..dygraph.layers import Layer, LayerList
from ..dygraph.nn import Linear, LayerNorm, BatchNorm, _listed
from ..fluid import layers as L
from ..fluid.framework import _dygraph_tracer
from ..fluid.initializer import ConstantInitializer, NormalInitializer
from ..fluid.layer_helper import LayerHelper, emit_op


def _act_layer(fname):
    class _Act(Layer):
        def forward(self, x):
            return getattr(L.nn, fname)(x)
    _Act.__name__ = fname.title().replace("_", "")
    return _Act


ReLU = _act_layer("relu")
ReLU6 = _act_layer("relu6")
GELU = _act_layer("gelu")
Tanh = _act_layer("tanh")
Sigmoid = _act_layer("sigmoid")
SiLU = _act_layer("silu")
Mish = _act_layer("mish")
Hardswish = _act_layer("hard_swish")
ELU = _act_layer("elu")
SELU = _act_layer("selu")
Softplus = _act_layer("softplus")
Softsign = _act_layer("softsign")
Softshrink = _act_layer("softshrink")
Hardshrink = _act_layer("hard_shrink")
Tanhshrink = _act_layer("tanh_shrink")
Hardsigmoid = _act_layer("hard_sigmoid")
Swish = _act_layer("swish")
LogSigmoid = _act_layer("logsigmoid")


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return L.nn.leaky_relu(x, alpha=self._slope)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        from . import functional as F
        return F.hardtanh(x, self._min, self._max)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None):
        super().__init__()
        helper = LayerHelper("prelu")
        self.weight = helper.create_parameter(
            weight_attr, [num_parameters], None,
            default_initializer=ConstantInitializer(init))

    def forward(self, x):
        from . import functional as F
        return F.prelu(x, self.weight)


class GLU(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        from . import functional as F
        return F.glu(x, self._axis)


class Softmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return L.softmax(x, axis=self._axis)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self._start, self._stop = start_axis, stop_axis

    def forward(self, x):
        return emit_op(
            "flatten", "flatten_contiguous_range", {"X": [x]}, ("Out",),
            {"start_axis": self._start, "stop_axis": self._stop})["Out"][0]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCHW"):
        super().__init__()
        self._k, self._s, self._p = kernel_size, stride or kernel_size, padding
        self._fmt = data_format

    def forward(self, x):
        return L.pool2d(x, self._k, "max", self._s, self._p,
                        data_format=self._fmt)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCHW"):
        super().__init__()
        self._k, self._s, self._p = kernel_size, stride or kernel_size, padding
        self._fmt = data_format

    def forward(self, x):
        return L.pool2d(x, self._k, "avg", self._s, self._p,
                        data_format=self._fmt)


class AdaptiveAvgPool2D(Layer):
    """A global average pool when the output is 1x1, else
    ``adaptive_pool2d``'s uniform bins."""

    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self._size = output_size
        self._fmt = data_format

    def forward(self, x):
        if self._size in (1, (1, 1), [1, 1]):
            return L.pool2d(x, global_pooling=True, pool_type="avg",
                            data_format=self._fmt)
        return L.adaptive_pool2d(x, self._size, "avg",
                                 data_format=self._fmt)


class BatchNorm2D(BatchNorm):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(num_features, momentum=momentum, epsilon=epsilon,
                         param_attr=weight_attr, bias_attr=bias_attr,
                         data_layout=data_format)


BatchNorm1D = BatchNorm2D
BatchNorm3D = BatchNorm2D


# --- losses ------------------------------------------------------------------
def _reduced(loss, reduction):
    if reduction == "mean":
        return L.nn.mean(loss)
    if reduction == "sum":
        return L.nn.reduce_sum(loss)
    return loss


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1):
        super().__init__()
        self._ignore = ignore_index
        self._reduction = reduction
        self._soft = soft_label

    def forward(self, input, label):
        return _reduced(L.softmax_with_cross_entropy(
            input, label, soft_label=self._soft,
            ignore_index=self._ignore), self._reduction)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return _reduced(L.square_error_cost(input, label), self._reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return _reduced(L.nn.abs(input - label), self._reduction)


class BCELoss(Layer):
    """Dygraph only, as the reference's: it traces its op."""

    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        loss = _dygraph_tracer().trace_op(
            "bce_loss", {"X": [input], "Label": [label]}, {"Out": [None]},
            {})["Out"][0]
        return _reduced(loss, self._reduction)


class NLLLoss(Layer):
    """Dygraph only, as the reference's: it traces its op."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean"):
        super().__init__()
        self._ignore, self._reduction = ignore_index, reduction

    def forward(self, input, label):
        return _dygraph_tracer().trace_op(
            "nll_loss", {"X": [input], "Label": [label]}, {"Out": [None]},
            {"ignore_index": self._ignore,
             "reduction": self._reduction})["Out"][0]


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return L.kldiv_loss(input, label, self._reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self._delta, self._reduction = delta, reduction

    def forward(self, input, label):
        return _reduced(L.huber_loss(input, label, self._delta),
                        self._reduction)


class MultiHeadAttention(Layer):
    """Self- or cross-attention over the ``fused_multihead_attention`` op
    (the Hopper flash-attention kernels on the card); the dropout is on
    the attention output, before the output projection, as in the
    reference."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        b, tq = query.shape[0], query.shape[1]
        h, d = self.num_heads, self.head_dim

        def heads(x, t):
            return L.transpose(L.reshape(x, [b, t, h, d]), [0, 2, 1, 3])

        q = heads(self.q_proj(query), tq)
        k = heads(self.k_proj(key), key.shape[1])
        v = heads(self.v_proj(value), value.shape[1])
        ins = {"Q": [q], "K": [k], "V": [v]}
        if attn_mask is not None:
            ins["Mask"] = [attn_mask]
        out = _dygraph_tracer().trace_op(
            "fused_multihead_attention", ins, {"Out": [None]},
            {"scale": 1.0 / math.sqrt(d)})["Out"][0]
        out = L.reshape(L.transpose(out, [0, 2, 1, 3]), [b, tq, h * d])
        if self.dropout:
            out = L.dropout(out, self.dropout, is_test=not self.training,
                            dropout_implementation="upscale_in_train")
        return self.out_proj(out)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            attn_dropout or dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self._dropout = dropout
        self._act_dropout = act_dropout if act_dropout is not None \
            else dropout
        self._act = activation
        self._pre_norm = normalize_before

    def _drop_add(self, x, residual):
        """The residual epilogue, one fused op (one kernel on the card)."""
        if self._dropout:
            return L.fused_dropout_add(x, residual, self._dropout,
                                       is_test=not self.training)
        return residual + x

    def _mlp_mid(self, x):
        if self._act in ("gelu", "relu"):
            return L.fused_act_dropout(
                x, act=self._act, dropout_prob=(
                    self._act_dropout if self.training else 0.0),
                is_test=not self.training)
        a = getattr(L.nn, self._act)(x)
        if self._act_dropout and self.training:
            a = L.dropout(a, self._act_dropout, is_test=False,
                          dropout_implementation="upscale_in_train")
        return a

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self._pre_norm:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
        src = self._drop_add(src, residual)
        if not self._pre_norm:
            src = self.norm1(src)
        residual = src
        if self._pre_norm:
            src = self.norm2(src)
        src = self.linear2(self._mlp_mid(self.linear1(src)))
        src = self._drop_add(src, residual)
        if not self._pre_norm:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """``num_layers`` deep copies of ``encoder_layer`` (so every layer
    starts from the same weights, as in the reference)."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    """Self-attention under ``tgt_mask``, cross-attention over ``memory``
    under ``memory_mask``, then the FFN; each sublayer ends in the
    encoder layer's fused residual epilogue."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            attn_dropout or dropout)
        self.cross_attn = MultiHeadAttention(d_model, nhead,
                                             attn_dropout or dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self._dropout = dropout
        self._act_dropout = act_dropout if act_dropout is not None \
            else dropout
        self._act = activation
        self._pre_norm = normalize_before

    _drop_add = TransformerEncoderLayer._drop_add
    _mlp_mid = TransformerEncoderLayer._mlp_mid

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self._pre_norm:
            tgt = self.norm1(tgt)
        tgt = self._drop_add(self.self_attn(tgt, tgt, tgt, tgt_mask),
                             residual)
        if not self._pre_norm:
            tgt = self.norm1(tgt)
        residual = tgt
        if self._pre_norm:
            tgt = self.norm2(tgt)
        tgt = self._drop_add(
            self.cross_attn(tgt, memory, memory, memory_mask), residual)
        if not self._pre_norm:
            tgt = self.norm2(tgt)
        residual = tgt
        if self._pre_norm:
            tgt = self.norm3(tgt)
        tgt = self._drop_add(self.linear2(self._mlp_mid(self.linear1(tgt))),
                             residual)
        if not self._pre_norm:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    """``num_layers`` deep copies of ``decoder_layer``, as the encoder."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    """The encoder and decoder stacks: ``memory = encoder(src,
    src_mask)``, then ``decoder(tgt, memory, tgt_mask, memory_mask)``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", normalize_before=False):
        super().__init__()
        enc = TransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                      dropout, activation,
                                      normalize_before=normalize_before)
        dec = TransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                      dropout, activation,
                                      normalize_before=normalize_before)
        self.encoder = TransformerEncoder(enc, num_encoder_layers)
        self.decoder = TransformerDecoder(dec, num_decoder_layers)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)


# --- RNN ---------------------------------------------------------------------
def _zero_state(shape, like):
    """A float32 zero state on ``like``'s device, off the tape."""
    from ..dygraph.base import VarBase
    return VarBase(torch.zeros(shape, dtype=torch.float32,
                               device=like._value.device),
                   stop_gradient=True)


class _RNNBase(Layer):
    """A whole-sequence RNN: one ``rnn_scan`` op (fluid/layers/rnn.py)
    over all layers and directions.  ``direction="bidirect"`` adds a
    reverse pass a layer and concatenates both directions' outputs (the
    cuDNN layout).  ``dropout`` is taken and not applied between the
    stacked layers, as in the reference."""
    MODE = "LSTM"
    GATES = 4

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", dropout=0.0, time_major=False,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None):
        super().__init__()
        helper = LayerHelper(self.MODE.lower())
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.ndir = 2 if direction in ("bidirect", "bidirectional") else 1
        self._weights = []
        g = self.GATES
        for layer in range(num_layers):
            in_d = input_size if layer == 0 else hidden_size * self.ndir
            for d in range(self.ndir):
                wi = helper.create_parameter(weight_ih_attr,
                                             [g * hidden_size, in_d], None)
                wh = helper.create_parameter(weight_hh_attr,
                                             [g * hidden_size, hidden_size],
                                             None)
                bi = helper.create_parameter(bias_ih_attr, [g * hidden_size],
                                             None, is_bias=True)
                bh = helper.create_parameter(bias_hh_attr, [g * hidden_size],
                                             None, is_bias=True)
                for i, w in enumerate((wi, wh, bi, bh)):
                    self.add_parameter(f"l{layer}d{d}_{i}", w)
                self._weights += [wi, wh, bi, bh]

    def forward(self, inputs, initial_states=None):
        if self.time_major:
            inputs = L.transpose(inputs, [1, 0, 2])
        if initial_states is None:
            z = _zero_state((self.num_layers * self.ndir, inputs.shape[0],
                             self.hidden_size), inputs)
            states = [z, z.clone()] if self.MODE == "LSTM" else [z]
        else:
            states = (list(initial_states)
                      if isinstance(initial_states, (list, tuple))
                      else [initial_states])
        outs = _dygraph_tracer().trace_op(
            "rnn_scan",
            {"Input": [inputs], "WeightList": self._weights,
             "PreState": states},
            {"Out": [None]},
            {"mode": self.MODE, "num_layers": self.num_layers,
             "bidirectional": self.ndir == 2})
        out = outs["Out"][0]
        if self.time_major:
            out = L.transpose(out, [1, 0, 2])
        st = outs["State"]
        if self.MODE == "LSTM":
            return out, (st[0], st[1])
        return out, st[0]


class LSTM(_RNNBase):
    MODE = "LSTM"
    GATES = 4


class GRU(_RNNBase):
    MODE = "GRU"
    GATES = 3


class SimpleRNN(_RNNBase):
    GATES = 1

    # the reference's positional order: activation before direction
    def __init__(self, input_size, hidden_size, num_layers=1,
                 activation="tanh", direction="forward", time_major=False,
                 dropout=0.0, **kw):
        self.MODE = "RNN_RELU" if activation == "relu" else "RNN_TANH"
        super().__init__(input_size, hidden_size, num_layers, direction,
                         dropout, time_major, **kw)


# --- cells and the runners that take any cell over time ----------------------
class _CellBase(Layer):
    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        helper = LayerHelper(type(self).__name__.lower())
        g = self.GATES
        self.input_size, self.hidden_size = input_size, hidden_size
        self.weight_ih = helper.create_parameter(
            weight_ih_attr, [g * hidden_size, input_size], None)
        self.weight_hh = helper.create_parameter(
            weight_hh_attr, [g * hidden_size, hidden_size], None)
        self.bias_ih = helper.create_parameter(
            bias_ih_attr, [g * hidden_size], None, is_bias=True)
        self.bias_hh = helper.create_parameter(
            bias_hh_attr, [g * hidden_size], None, is_bias=True)

    def get_initial_states(self, batch_ref):
        z = _zero_state((batch_ref.shape[0], self.hidden_size), batch_ref)
        return (z, z.clone()) if isinstance(self, LSTMCell) else z

    def _gates(self, x, h):
        gi = L.matmul(x, self.weight_ih, transpose_y=True) + self.bias_ih
        gh = L.matmul(h, self.weight_hh, transpose_y=True) + self.bias_hh
        return gi, gh


class SimpleRNNCell(_CellBase):
    GATES = 1

    def __init__(self, input_size, hidden_size, activation="tanh", **kw):
        super().__init__(input_size, hidden_size, **kw)
        self._act = activation

    def forward(self, inputs, states=None):
        h = states if states is not None \
            else self.get_initial_states(inputs)
        gi, gh = self._gates(inputs, h)
        out = L.relu(gi + gh) if self._act == "relu" else L.tanh(gi + gh)
        return out, out


class LSTMCell(_CellBase):
    GATES = 4

    def forward(self, inputs, states=None):
        h, c = states if states is not None \
            else self.get_initial_states(inputs)
        gi, gh = self._gates(inputs, h)
        i, f, gg, o = L.split(gi + gh, 4, dim=-1)
        c2 = L.sigmoid(f) * c + L.sigmoid(i) * L.tanh(gg)
        h2 = L.sigmoid(o) * L.tanh(c2)
        return h2, (h2, c2)


class GRUCell(_CellBase):
    GATES = 3

    def forward(self, inputs, states=None):
        h = states if states is not None \
            else self.get_initial_states(inputs)
        gi, gh = self._gates(inputs, h)
        ir, iu, ic = L.split(gi, 3, dim=-1)
        hr, hu, hc = L.split(gh, 3, dim=-1)
        r = L.sigmoid(ir + hr)
        u = L.sigmoid(iu + hu)
        c = L.tanh(ic + r * hc)
        h2 = u * h + (1.0 - u) * c
        return h2, h2


class RNN(Layer):
    """Any cell over time, one step at a time (the fused ``LSTM``,
    ``GRU`` and ``SimpleRNN`` run the whole sequence in one op)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None):
        if self.time_major:
            inputs = L.transpose(inputs, [1, 0, 2])
        steps = inputs.shape[1]
        states = initial_states if initial_states is not None \
            else self.cell.get_initial_states(inputs)
        order = range(steps - 1, -1, -1) if self.is_reverse \
            else range(steps)
        outs = [None] * steps
        for t in order:
            xt = L.squeeze(L.slice(inputs, axes=[1], starts=[t],
                                   ends=[t + 1]), [1])
            outs[t], states = self.cell(xt, states)
        out = L.stack(outs, axis=1)
        if self.time_major:
            out = L.transpose(out, [1, 0, 2])
        return out, states


class BiRNN(Layer):
    """A forward and a reverse cell, their outputs concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None):
        fw_states, bw_states = (initial_states if initial_states is not None
                                else (None, None))
        out_f, st_f = self.rnn_fw(inputs, fw_states)
        out_b, st_b = self.rnn_bw(inputs, bw_states)
        # both runners give batch-first outputs: features are axis 2
        return L.concat([out_f, out_b], axis=2), (st_f, st_b)


class RowConv(Layer):
    """The lookahead convolution (``row_conv``) over [B, T, num_channels]
    with a [future_context_size + 1, num_channels] weight."""

    def __init__(self, num_channels, future_context_size, param_attr=None):
        super().__init__()
        helper = LayerHelper("row_conv")
        self.weight = helper.create_parameter(
            param_attr, [future_context_size + 1, num_channels], None)

    def forward(self, x):
        from . import functional as F
        return F.row_conv(x, self.weight)


RNNCellBase = _CellBase


# --- the image layers --------------------------------------------------------
class _ConvNd(Layer):
    """``Conv1D`` and ``Conv3D``: filters ``[out, in/groups, k...]`` from
    He's normal N(0, 2 / fan_in), through ``F.conv1d`` / ``F.conv3d``."""

    ND = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        helper = LayerHelper(f"conv{self.ND}d")
        ks = _listed(kernel_size, self.ND)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        fan_in = (in_channels // groups) * math.prod(ks)
        self.weight = helper.create_parameter(
            weight_attr, [out_channels, in_channels // groups] + ks, None,
            default_initializer=NormalInitializer(
                0., math.sqrt(2. / fan_in)))
        self.bias = helper.create_parameter(
            bias_attr, [out_channels], None, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x):
        from . import functional as F
        fn = {1: F.conv1d, 3: F.conv3d}[self.ND]
        return fn(x, self.weight, self.bias, stride=self._stride,
                  padding=self._padding, dilation=self._dilation,
                  groups=self._groups)


class Conv1D(_ConvNd):
    ND = 1


class Conv3D(_ConvNd):
    ND = 3


class _ConvTransposeNd(Layer):
    """Filters ``[in, out/groups, k...]`` (Xavier); no ``output_padding``
    reaches the op, as in the reference's classes (``F.conv*_transpose``
    takes one)."""

    ND = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        helper = LayerHelper(f"conv{self.ND}d_transpose")
        self._cfg = dict(stride=stride, padding=padding, dilation=dilation,
                         groups=groups)
        self.weight = helper.create_parameter(
            weight_attr, [in_channels, out_channels // groups]
            + _listed(kernel_size, self.ND), None)
        self.bias = helper.create_parameter(
            bias_attr, [out_channels], None, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x):
        from . import functional as F
        fn = {1: F.conv1d_transpose, 2: F.conv2d_transpose,
              3: F.conv3d_transpose}[self.ND]
        return fn(x, self.weight, self.bias, **self._cfg)


class Conv2DTranspose(_ConvTransposeNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, groups, dilation, weight_attr, bias_attr)


class Conv1DTranspose(_ConvTransposeNd):
    ND = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, groups, dilation, weight_attr, bias_attr)


class Conv3DTranspose(_ConvTransposeNd):
    """The reference's class passes no ``dilation`` either."""

    ND = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, groups, 1, weight_attr, bias_attr)


class MaxPool1D(Layer):
    FN = "max_pool1d"

    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self._k, self._s, self._p = kernel_size, stride, padding

    def forward(self, x):
        from . import functional as F
        return getattr(F, self.FN)(x, self._k, self._s, self._p)


class AvgPool1D(MaxPool1D):
    FN = "avg_pool1d"


class MaxPool3D(MaxPool1D):
    FN = "max_pool3d"


class AvgPool3D(MaxPool1D):
    FN = "avg_pool3d"


class _AdaptivePoolNd(Layer):
    """Uniform bins (the size must divide the input's); ``return_mask``
    for ``AdaptiveMaxPool2D`` only, the ``max_pool2d_with_index`` op's
    mask (all zeros, as the reference's)."""

    MODE, ND = "avg", 2

    def __init__(self, output_size, data_format=None, return_mask=False):
        super().__init__()
        self._size = output_size
        self._return_mask = return_mask
        if return_mask and not (self.MODE == "max" and self.ND == 2):
            raise NotImplementedError(
                "return_mask is supported for AdaptiveMaxPool2D only")

    def forward(self, x):
        from . import functional as F
        out = getattr(F, f"adaptive_{self.MODE}_pool{self.ND}d")(
            x, self._size)
        if not self._return_mask:
            return out
        oh, ow = _listed(self._size, 2)
        k = [x.shape[2] // oh, x.shape[3] // ow]
        mask = emit_op("max_pool2d_with_index", "max_pool2d_with_index",
                       {"X": [x]}, ("Out", "Mask"),
                       {"ksize": k, "strides": k, "paddings": [0, 0],
                        "adaptive": True})["Mask"][0]
        return out, mask


class AdaptiveAvgPool1D(_AdaptivePoolNd):
    MODE, ND = "avg", 1


class AdaptiveMaxPool1D(_AdaptivePoolNd):
    MODE, ND = "max", 1


class AdaptiveMaxPool2D(_AdaptivePoolNd):
    MODE, ND = "max", 2


class AdaptiveAvgPool3D(_AdaptivePoolNd):
    MODE, ND = "avg", 3


class AdaptiveMaxPool3D(_AdaptivePoolNd):
    MODE, ND = "max", 3


class _AffineNorm(Layer):
    """A norm layer's per-channel weight (1) and bias (0)."""

    def _affine(self, op, channels, weight_attr, bias_attr):
        helper = LayerHelper(op)
        self.weight = helper.create_parameter(
            weight_attr, [channels], None,
            default_initializer=ConstantInitializer(1.0))
        self.bias = helper.create_parameter(bias_attr, [channels], None,
                                            is_bias=True)


class GroupNorm(_AffineNorm):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self._affine("group_norm", num_channels, weight_attr, bias_attr)
        self._groups, self._eps = num_groups, epsilon

    def forward(self, x):
        return emit_op("group_norm", "group_norm",
                       {"X": [x], "Scale": [self.weight],
                        "Bias": [self.bias]}, ("Y",),
                       {"groups": self._groups, "epsilon": self._eps})["Y"][0]


class InstanceNorm2D(_AffineNorm):
    def __init__(self, num_features, epsilon=1e-5, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self._affine("instance_norm", num_features, weight_attr, bias_attr)
        self._eps = epsilon

    def forward(self, x):
        return emit_op("instance_norm", "instance_norm",
                       {"X": [x], "Scale": [self.weight],
                        "Bias": [self.bias]}, ("Y",),
                       {"epsilon": self._eps})["Y"][0]


class InstanceNorm1D(InstanceNorm2D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(num_features, epsilon, weight_attr, bias_attr)


class InstanceNorm3D(InstanceNorm1D):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW"):
        super().__init__()
        self._cfg = (size, alpha, beta, k)

    def forward(self, x):
        from . import functional as F
        return F.local_response_norm(x, *self._cfg)


class SpectralNorm(Layer):
    """``weight / σ`` by the ``spectral_norm`` op from U and V, parameters
    of the layer (Xavier, as the reference's); they are not written
    back."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12):
        super().__init__()
        helper = LayerHelper("spectral_norm")
        h = weight_shape[dim]
        self._cfg = {"dim": dim, "power_iters": power_iters, "eps": eps}
        self.weight_u = helper.create_parameter(None, [h], None)
        self.weight_v = helper.create_parameter(
            None, [math.prod(weight_shape) // h], None)

    def forward(self, weight):
        return emit_op("spectral_norm", "spectral_norm",
                       {"Weight": [weight], "U": [self.weight_u],
                        "V": [self.weight_v]}, ("Out",), self._cfg)["Out"][0]


class SyncBatchNorm(BatchNorm2D):
    """Batch norm whose statistics would be averaged across replicas; in
    one process it is ``BatchNorm2D`` (the multi-process path is ROADMAP
    item 10's)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Each BatchNorm under ``layer`` made a SyncBatchNorm, its
        parameters, moving statistics, epsilon and momentum carried."""
        if isinstance(layer, BatchNorm) and not isinstance(layer, cls):
            new = cls(layer.weight.shape[0],
                      momentum=getattr(layer, "_momentum", 0.9),
                      epsilon=getattr(layer, "_epsilon", 1e-5))
            new.weight, new.bias = layer.weight, layer.bias
            new._mean, new._variance = layer._mean, layer._variance
            return new
        for name, sub in getattr(layer, "_sub_layers", {}).items():
            layer._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return layer


class Pad1D(Layer):
    """``[N, C, L]`` padded ``[left, right]`` through ``pad2d``."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL"):
        super().__init__()
        self._pad, self._mode, self._value = _listed(padding, 2), mode, value

    def forward(self, x):
        out = L.pad2d(L.unsqueeze(x, [2]), paddings=[0, 0] + self._pad,
                      mode=self._mode, pad_value=self._value)
        return L.squeeze(out, [2])


class Pad2D(Layer):
    """``padding`` ``[top, bottom, left, right]`` (or one int)."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__()
        self._padding = _listed(padding, 4)
        self._mode, self._value, self._fmt = mode, value, data_format

    def forward(self, x):
        return L.pad2d(x, self._padding, self._mode, self._value, self._fmt)


class Pad3D(Layer):
    """``padding`` ``[left, right, top, bottom, front, back]``."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW"):
        super().__init__()
        self._attrs = {"paddings": _listed(padding, 6), "mode": mode,
                       "value": value}

    def forward(self, x):
        return emit_op("pad3d", "pad3d", {"X": [x]}, ("Out",),
                       self._attrs)["Out"][0]


class Upsample(Layer):
    """The ``*_interp`` op of ``mode`` at ``size`` or one ``scale_factor``
    (the reference reads neither ``align_corners`` nor ``data_format``
    here)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW"):
        super().__init__()
        self._attrs = ({"out_h": size[0], "out_w": size[1]}
                       if size is not None
                       else {"scale": float(scale_factor)})
        self._op = {"nearest": "nearest_interp",
                    "bilinear": "bilinear_interp",
                    "bicubic": "bicubic_interp"}[mode]

    def forward(self, x):
        return emit_op("upsample", self._op, {"X": [x]}, ("Out",),
                       self._attrs)["Out"][0]


class UpsamplingBilinear2D(Layer):
    MODE = "bilinear"

    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__()
        self._size, self._scale = size, scale_factor

    def forward(self, x):
        from . import functional as F
        return F.interpolate(x, size=self._size, scale_factor=self._scale,
                             mode=self.MODE,
                             align_corners=self.MODE == "bilinear")


class UpsamplingNearest2D(UpsamplingBilinear2D):
    MODE = "nearest"


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW"):
        super().__init__()
        self._factor = upscale_factor

    def forward(self, x):
        from . import functional as F
        return F.pixel_shuffle(x, self._factor)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW"):
        super().__init__()
        self._p, self._fmt = p, data_format

    def forward(self, x):
        from . import functional as F
        return F.dropout2d(x, self._p, training=self.training,
                           data_format=self._fmt)


class Dropout3D(Dropout2D):
    def __init__(self, p=0.5, data_format="NCDHW"):
        super().__init__(p, data_format)

    def forward(self, x):
        from . import functional as F
        return F.dropout3d(x, self._p, training=self.training,
                           data_format=self._fmt)


class AlphaDropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        from . import functional as F
        return F.alpha_dropout(x, self._p, training=self.training)


class LogSoftmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return L.log_softmax(x, axis=self._axis)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0):
        super().__init__()
        self._t = threshold

    def forward(self, x):
        return L.nn.thresholded_relu(x, threshold=self._t)


class Maxout(Layer):
    def __init__(self, groups, axis=1):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        from . import functional as F
        return F.maxout(x, self._groups, self._axis)


class Bilinear(Layer):
    """``out[b, k] = x1[b] · W[k] · x2[b] + bias[k]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        helper = LayerHelper("bilinear")
        self.weight = helper.create_parameter(
            weight_attr, [out_features, in1_features, in2_features], None)
        self.bias = helper.create_parameter(
            bias_attr, [1, out_features], None, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x1, x2):
        from . import functional as F
        return F.bilinear(x1, x2, self.weight, self.bias)


class BilinearTensorProduct(Bilinear):
    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 param_attr=None, bias_attr=None):
        super().__init__(input1_dim, input2_dim, output_dim,
                         weight_attr=param_attr, bias_attr=bias_attr)


class BCEWithLogitsLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, logit, label):
        from . import functional as F
        return F.binary_cross_entropy_with_logits(logit, label,
                                                  self._reduction)


class CTCLoss(Layer):
    """``F.ctc_loss`` (batch-major ``log_probs``, as the reference)."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._blank, self._reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths):
        from . import functional as F
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self._blank, self._reduction)


class HSigmoidLoss(Layer):
    """``F.hsigmoid_loss`` with a [num_classes - 1, feature_size] weight
    and a [1, num_classes - 1] bias."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, **kw):
        super().__init__()
        helper = LayerHelper("hsigmoid_loss")
        self._num_classes = num_classes
        self.weight = helper.create_parameter(
            weight_attr, [num_classes - 1, feature_size], None)
        self.bias = helper.create_parameter(
            bias_attr, [1, num_classes - 1], None, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, input, label):
        from . import functional as F
        return F.hsigmoid_loss(input, label, self._num_classes,
                               self.weight, self.bias)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input, other, label):
        from . import functional as F
        return F.margin_ranking_loss(input, other, label, self._margin,
                                     self._reduction)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._axis, self._eps = axis, eps

    def forward(self, x1, x2):
        from . import functional as F
        return F.cosine_similarity(x1, x2, self._axis, self._eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False):
        super().__init__()
        self._p, self._eps, self._keep = p, epsilon, keepdim

    def forward(self, x, y):
        from . import functional as F
        return F.pairwise_distance(x, y, self._p, self._eps, self._keep)
