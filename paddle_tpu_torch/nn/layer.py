"""paddle.nn 2.0 layers (counterpart of ``paddle_tpu/nn/layer.py``: the
activations, the losses ``Model.prepare`` takes, the flatten, pooling
and batch-norm layers the vision models run, the transformer encoder
stack BERT runs, the encoder-decoder ``Transformer`` NMT runs, and the
recurrent layers: ``LSTM``, ``GRU`` and ``SimpleRNN`` over the
``rnn_scan`` op, the three cells, and ``RNN`` and ``BiRNN``, which take
a cell over time step by step).

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
from ..dygraph.nn import Linear, LayerNorm, BatchNorm
from ..fluid import layers as L
from ..fluid.framework import _dygraph_tracer
from ..fluid.initializer import ConstantInitializer
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
