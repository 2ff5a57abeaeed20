"""Recurrent layers (counterpart of ``paddle_tpu/fluid/layers/rnn.py``):
the whole-sequence ``rnn_scan`` op, the builders of the static RNN ops
(``lstm`` over ``cudnn_lstm``, ``dynamic_lstm``, ``dynamic_lstmp``,
``dynamic_gru``), the step layers ``lstm_unit`` and ``gru_unit``, the
cells with ``rnn`` and ``birnn``, and the decode framework
(``BasicDecoder`` and its helpers, ``BeamSearchDecoder``,
``dynamic_decode``).  Every builder appends ops in a static program and
traces them under the dygraph tracer alike.

``rnn_scan`` runs a padded multi-layer LSTM, GRU or simple RNN (tanh or
relu) over time, batch first.  The reference computes the recurrence in
``lax.scan``; here it is a loop over time of PyTorch ops, the products
on cuBLAS.  The input projection of every step is one product before the
loop (``seq @ wi.T`` with the biases that do not wait on ``h``), so each
step launches one ``addmm`` for its gates and the elementwise cell.  The
gate order is i, f, g, o for the LSTM and r, u, c for the GRU, the
weights ``[gates · H, in]``, two biases added, as in the reference (and
in cuDNN).
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops.registry import register_op
from ..layer_helper import LayerHelper, emit_op
from . import control_flow as _cf
from . import nn as _nn
from . import tensor as _tensor


def _scan_one_direction(mode, wi, wh, bi, bh, h, c, seq, reverse=False):
    """One (layer, direction) over ``seq`` [T, B, D]: (out [T, B, H],
    the last h, the last c or None)."""
    steps = range(seq.shape[0] - 1, -1, -1) if reverse \
        else range(seq.shape[0])
    outs = [None] * seq.shape[0]
    wh_t = wh.t()
    if mode == "LSTM":
        xw = torch.matmul(seq, wi.t()) + bi + bh
        for t in steps:
            i, f, g, o = torch.addmm(xw[t], h, wh_t).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs[t] = h
        return torch.stack(outs), h, c
    if mode == "GRU":
        xw = torch.matmul(seq, wi.t()) + bi
        for t in steps:
            ir, iu, ic = xw[t].chunk(3, dim=-1)
            hr, hu, hc = torch.addmm(bh, h, wh_t).chunk(3, dim=-1)
            r = torch.sigmoid(ir + hr)
            u = torch.sigmoid(iu + hu)
            h = u * h + (1 - u) * torch.tanh(ic + r * hc)
            outs[t] = h
        return torch.stack(outs), h, None
    act = torch.tanh if mode == "RNN_TANH" else torch.relu
    xw = torch.matmul(seq, wi.t()) + bi + bh
    for t in steps:
        h = act(torch.addmm(xw[t], h, wh_t))
        outs[t] = h
    return torch.stack(outs), h, None


@register_op("rnn_scan", nondiff_inputs=("SequenceLength",))
def _rnn_scan(ins, attrs, ctx):
    """``mode`` LSTM, GRU, RNN_TANH or RNN_RELU over ``Input`` [B, T, D].
    ``WeightList`` holds (wi, wh, bi, bh) for each (layer, direction),
    forward then reverse when ``bidirectional``; a reverse direction runs
    over the same padded sequence from its end, and each deeper layer
    takes both directions' outputs concatenated.  ``PreState`` is h0 (and
    c0 for the LSTM), [layers · directions, B, H]; ``State`` the last h
    (and c) in the same layout."""
    x = ins["Input"][0]
    mode = attrs.get("mode", "LSTM")
    ws = ins["WeightList"]
    h0 = ins["PreState"][0]
    c0 = ins["PreState"][1] if len(ins["PreState"]) > 1 else None
    num_layers = attrs.get("num_layers", 1)
    ndir = 2 if attrs.get("bidirectional", False) else 1

    out = x.transpose(0, 1)
    h_fin, c_fin = [], []
    for layer in range(num_layers):
        dir_outs = []
        for d in range(ndir):
            k = layer * ndir + d
            wi, wh, bi, bh = ws[4 * k: 4 * k + 4]
            c_init = c0[k] if c0 is not None else torch.zeros_like(h0[k])
            o, h_t, c_t = _scan_one_direction(mode, wi, wh, bi, bh, h0[k],
                                              c_init, out, reverse=d == 1)
            dir_outs.append(o)
            h_fin.append(h_t)
            if c_t is not None:
                c_fin.append(c_t)
        out = dir_outs[0] if ndir == 1 else torch.cat(dir_outs, dim=-1)
    outs = {"Out": [out.transpose(0, 1)], "State": [torch.stack(h_fin)]}
    if mode == "LSTM":
        outs["State"].append(torch.stack(c_fin))
    return outs


# ---------------------------------------------------------------------------
# step layers and the static RNN ops' builders
# ---------------------------------------------------------------------------
def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: the gates from one ``fc`` over [x_t, h_prev]
    (i, f, c, o), ``forget_bias`` added to f; returns (h, c)."""
    size = hidden_t_prev.shape[-1]
    gates = _nn.fc([x_t, hidden_t_prev], 4 * size, param_attr=param_attr,
                   bias_attr=bias_attr)
    i, f, c_hat, o = _nn.split(gates, 4, dim=-1)
    f = _nn.sigmoid(_nn.scale(f, bias=float(forget_bias)))
    c = f * cell_t_prev + _nn.sigmoid(i) * _nn.tanh(c_hat)
    return _nn.sigmoid(o) * _nn.tanh(c), c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step from ``fc`` layers (no op of its own, as in the
    reference): (update, reset) from [input, h], the candidate from
    [input, r * h]; returns (h', h', candidate)."""
    d = hidden.shape[-1]
    gates = _nn.fc([input, hidden], 2 * d, param_attr=param_attr,
                   bias_attr=bias_attr, act=gate_activation)
    u, r = _nn.split(gates, 2, dim=-1)
    c = _nn.fc([input, r * hidden], d, param_attr=param_attr,
               bias_attr=bias_attr, act=activation)
    new_h = u * hidden + (1.0 - u) * c
    return new_h, new_h, c


def dynamic_lstm_unit(*args, **kwargs):
    raise NotImplementedError(
        "LoD dynamic_lstm is replaced by padded scan RNN (rnn op)")


def _rnn_one(op, ins, out_slots, **attrs):
    outs = emit_op(op, op, ins, out_slots, attrs)
    vals = tuple(outs[s][0] for s in out_slots)
    return vals if len(vals) > 1 else vals[0]


def _state_ins(ins, h_0, c_0=None):
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    return ins


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """The ``lstm`` op over ``input`` [B, T, size] already projected
    (size = 4H); returns (hidden, cell), each [B, T, H]."""
    helper = LayerHelper("dynamic_lstm", name=name)
    h = size // 4
    w = helper.create_parameter(param_attr, [h, 4 * h], dtype)
    b = helper.create_parameter(bias_attr,
                                [1, 7 * h if use_peepholes else 4 * h],
                                dtype, is_bias=True)
    ins = _state_ins({"Input": [input], "Weight": [w], "Bias": [b]},
                     h_0, c_0)
    return _rnn_one("lstm", ins, ("Hidden", "Cell"),
                    use_peepholes=use_peepholes, is_reverse=is_reverse,
                    gate_activation=gate_activation,
                    cell_activation=cell_activation,
                    candidate_activation=candidate_activation)


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32", name=None):
    """The ``lstmp`` op: returns (projection [B, T, proj_size], cell)."""
    helper = LayerHelper("dynamic_lstmp", name=name)
    h = size // 4
    w = helper.create_parameter(param_attr, [proj_size, 4 * h], dtype)
    proj_w = helper.create_parameter(None, [h, proj_size], dtype)
    b = helper.create_parameter(bias_attr,
                                [1, 7 * h if use_peepholes else 4 * h],
                                dtype, is_bias=True)
    ins = _state_ins({"Input": [input], "Weight": [w],
                      "ProjWeight": [proj_w], "Bias": [b]}, h_0, c_0)
    return _rnn_one("lstmp", ins, ("Projection", "Cell"),
                    use_peepholes=use_peepholes, is_reverse=is_reverse,
                    gate_activation=gate_activation,
                    cell_activation=cell_activation,
                    candidate_activation=candidate_activation,
                    proj_activation=proj_activation)


def dynamic_gru(input, size, h_0=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", origin_mode=False,
                dtype="float32", name=None):
    """The ``gru`` op over ``input`` [B, T, 3 · size] already projected."""
    helper = LayerHelper("dynamic_gru", name=name)
    w = helper.create_parameter(param_attr, [size, 3 * size], dtype)
    b = helper.create_parameter(bias_attr, [1, 3 * size], dtype,
                                is_bias=True)
    ins = _state_ins({"Input": [input], "Weight": [w], "Bias": [b]}, h_0)
    return _rnn_one("gru", ins, ("Hidden",), is_reverse=is_reverse,
                    gate_activation=gate_activation,
                    activation=candidate_activation,
                    origin_mode=origin_mode)


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """A ``num_layers`` LSTM through the ``cudnn_lstm`` op, ``input`` time
    major [T, B, D]; one flat weight of the reference's layout.  Returns
    (out, last_h, last_c).  The op reads neither ``dropout_prob`` nor
    ``is_test``, as in the reference, which also refuses ``is_bidirec``."""
    helper = LayerHelper("lstm", name=name)
    if is_bidirec:
        raise NotImplementedError(
            "layers.lstm(is_bidirec=True): use paddle.nn.LSTM("
            "direction='bidirect'), the bidirectional scan tier")
    d_in = input.shape[-1]
    n_w = sum(4 * hidden_size * (d_in if layer == 0 else hidden_size)
              + 4 * hidden_size * hidden_size + 8 * hidden_size
              for layer in range(num_layers))
    w = helper.create_parameter(None, [n_w], "float32",
                                default_initializer=default_initializer)
    return _rnn_one(
        "cudnn_lstm",
        {"Input": [input], "W": [w], "InitH": [init_h], "InitC": [init_c]},
        ("Out", "LastH", "LastC"), hidden_size=hidden_size,
        num_layers=num_layers, is_bidirec=is_bidirec,
        dropout_prob=dropout_prob, is_test=is_test)


# ---------------------------------------------------------------------------
# cells, rnn and birnn
# ---------------------------------------------------------------------------
class RNNCell:
    """A cell: ``call(inputs, states) -> (out, new_states)``.  Its
    parameters are made at the first call, from the input's width."""

    def call(self, inputs, states):
        raise NotImplementedError

    def __call__(self, inputs, states):
        return self.call(inputs, states)

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        b = batch_ref.shape[batch_dim_idx]
        shape = list(shape or [self.hidden_size])
        return _tensor.fill_constant([b] + shape, dtype, init_value)


class LSTMCell(RNNCell):
    """Gates (i, f, c, o) = [x, h] @ W + b, ``forget_bias`` added to f."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, forget_bias=1.0,
                 dtype="float32", name="LSTMCell"):
        self.hidden_size = hidden_size
        self._param_attr, self._bias_attr = param_attr, bias_attr
        self._forget_bias = forget_bias
        self._dtype = dtype
        self._w = None

    def _params(self, d_in):
        if self._w is None:
            helper = LayerHelper("lstm_cell")
            self._w = helper.create_parameter(
                self._param_attr, [d_in + self.hidden_size,
                                   4 * self.hidden_size], self._dtype)
            self._b = helper.create_parameter(
                self._bias_attr, [4 * self.hidden_size], self._dtype,
                is_bias=True)
        return self._w, self._b

    def call(self, inputs, states):
        h, c = states
        w, b = self._params(inputs.shape[-1])
        gates = _nn.matmul(_tensor.concat([inputs, h], axis=1), w) + b
        i, f, g, o = _nn.split(gates, 4, dim=-1)
        c2 = _nn.sigmoid(f + self._forget_bias) * c + \
            _nn.sigmoid(i) * _nn.tanh(g)
        h2 = _nn.sigmoid(o) * _nn.tanh(c2)
        return h2, [h2, c2]

    def get_initial_states(self, batch_ref, **kw):
        return [super().get_initial_states(batch_ref, **kw),
                super().get_initial_states(batch_ref, **kw)]


class GRUCell(RNNCell):
    """(u, r) = sigmoid([x, h] @ Wg + bg), c = tanh([x, r * h] @ Wc + bc),
    h' = u * h + (1 - u) * c."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, dtype="float32",
                 name="GRUCell"):
        self.hidden_size = hidden_size
        self._param_attr, self._bias_attr = param_attr, bias_attr
        self._dtype = dtype
        self._wg = None

    def _params(self, d_in):
        if self._wg is None:
            helper = LayerHelper("gru_cell")
            h = self.hidden_size
            self._wg = helper.create_parameter(
                self._param_attr, [d_in + h, 2 * h], self._dtype)
            self._wc = helper.create_parameter(
                self._param_attr, [d_in + h, h], self._dtype)
            self._bg = helper.create_parameter(
                self._bias_attr, [2 * h], self._dtype, is_bias=True)
            self._bc = helper.create_parameter(
                self._bias_attr, [h], self._dtype, is_bias=True)
        return self._wg, self._wc, self._bg, self._bc

    def call(self, inputs, states):
        h = states
        wg, wc, bg, bc = self._params(inputs.shape[-1])
        gates = _nn.sigmoid(
            _nn.matmul(_tensor.concat([inputs, h], axis=1), wg) + bg)
        u, r = _nn.split(gates, 2, dim=-1)
        c = _nn.tanh(
            _nn.matmul(_tensor.concat([inputs, r * h], axis=1), wc) + bc)
        h2 = u * h + (1.0 - u) * c
        return h2, h2


def _step(x, t):
    """``x``'s step ``t`` along axis 1."""
    return _nn.squeeze(_nn.slice(x, axes=[1], starts=[t], ends=[t + 1]),
                       [1])


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kw):
    """Runs ``cell`` over the padded time axis, unrolled.  Past a row's
    ``sequence_length`` its outputs are zero and its states stop."""
    if time_major:
        inputs = _nn.transpose(inputs, [1, 0, 2])
    T = inputs.shape[1]
    states = initial_states if initial_states is not None \
        else cell.get_initial_states(inputs)
    seq_len = None
    if sequence_length is not None:
        seq_len = sequence_length if hasattr(sequence_length, "shape") \
            else _tensor.assign(np.asarray(sequence_length, "float32"))
        seq_len = _nn.reshape(_nn.cast(seq_len, "float32"), [-1, 1])

    def blend(new, old, m):
        if isinstance(new, (list, tuple)):
            return [blend(n, o, m) for n, o in zip(new, old)]
        return new * m + old * (1.0 - m)

    outs = [None] * T
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        out_t, new_states = cell(_step(inputs, t), states)
        if seq_len is not None:
            m = _nn.cast(_cf.less_than(
                _tensor.fill_constant([1], "float32", float(t)), seq_len),
                "float32")                       # [B, 1] valid rows
            out_t = out_t * m
            states = blend(new_states, states, m)
        else:
            states = new_states
        outs[t] = out_t
    out = _tensor.concat([_nn.unsqueeze(o, [1]) for o in outs], axis=1)
    if time_major:
        out = _nn.transpose(out, [1, 0, 2])
    return out, states


def birnn(cell_fw, cell_bw, inputs, initial_states=None,
          sequence_length=None, time_major=False, **kw):
    """``rnn`` forward with ``cell_fw`` and from the end with ``cell_bw``;
    the two outputs concatenated on the feature axis."""
    fw_states, bw_states = initial_states if initial_states is not None \
        else (None, None)
    out_f, st_f = rnn(cell_fw, inputs, fw_states,
                      sequence_length=sequence_length,
                      time_major=time_major)
    out_b, st_b = rnn(cell_bw, inputs, bw_states,
                      sequence_length=sequence_length,
                      time_major=time_major, is_reverse=True)
    return _tensor.concat([out_f, out_b], axis=2), (st_f, st_b)


# ---------------------------------------------------------------------------
# the decode framework: eager loops that read each step's ids on the host
# ---------------------------------------------------------------------------
class Decoder:
    """``initialize(inits) -> (inputs, states, finished)``;
    ``step(time, inputs, states) -> (outputs, states, next_inputs,
    finished)``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kw):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class DecodeHelper:
    """The sampling strategy of a ``BasicDecoder``."""

    def initialize(self):
        raise NotImplementedError

    def sample(self, time, outputs, states):
        raise NotImplementedError

    def next_inputs(self, time, outputs, states, sample_ids):
        raise NotImplementedError


class TrainingHelper(DecodeHelper):
    """Teacher forcing: each step's input is the next target."""

    def __init__(self, inputs, sequence_length=None, time_major=False):
        self._inputs = _nn.transpose(inputs, [1, 0, 2]) if time_major \
            else inputs
        self._seq_len = sequence_length

    def initialize(self):
        return _step(self._inputs, 0), np.array(False)

    def sample(self, time, outputs, states):
        return _tensor.argmax(outputs, axis=-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        T = self._inputs.shape[1]
        nxt = _step(self._inputs, min(time + 1, T - 1))
        return (time + 1) >= T, nxt, states


class GreedyEmbeddingHelper(DecodeHelper):
    """Feeds back the embedding of the argmax id; done when every row
    gave ``end_token``."""

    def __init__(self, embedding_fn, start_tokens, end_token):
        self._embed = embedding_fn
        self._start = start_tokens
        self._end = int(end_token)

    def initialize(self):
        return self._embed(self._start), np.array(False)

    def sample(self, time, outputs, states):
        return _tensor.argmax(outputs, axis=-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        ids = sample_ids.numpy() if hasattr(sample_ids, "numpy") \
            else sample_ids
        done = np.asarray(np.asarray(ids) == self._end).all()
        return done, self._embed(sample_ids), states


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """Draws each id from softmax(outputs) (the ``sampling_id`` op)."""

    def __init__(self, embedding_fn, start_tokens, end_token, seed=None):
        super().__init__(embedding_fn, start_tokens, end_token)
        self._seed = seed

    def sample(self, time, outputs, states):
        return emit_op("sampling_id", "sampling_id",
                       {"X": [_nn.softmax(outputs)]}, ("Out",),
                       {"op_seed": self._seed or 0})["Out"][0]


class BasicDecoder(Decoder):
    """A cell, a helper and an optional output layer; each step emits
    (cell outputs, sample ids)."""

    def __init__(self, cell, helper, output_fn=None):
        self._cell = cell
        self._helper = helper
        self._output_fn = output_fn

    def initialize(self, inits):
        first, finished = self._helper.initialize()
        return first, inits, finished

    def step(self, time, inputs, states, **kw):
        out, next_states = self._cell(inputs, states)
        if self._output_fn is not None:
            out = self._output_fn(out)
        sample_ids = self._helper.sample(time, out, next_states)
        finished, nxt, next_states = self._helper.next_inputs(
            time, out, next_states, sample_ids)
        return (out, sample_ids), next_states, nxt, finished


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, **kw):
    """Steps ``decoder`` until every row is finished or ``max_step_num``
    (256 when None) steps ran; returns ((outputs [B, T, ...], sample ids
    [B, T, ...]), the last states, the number of steps)."""
    inputs, states, finished = decoder.initialize(inits)
    outputs, samples = [], []
    t = 0
    while t < (max_step_num or 256):
        (out, sids), states, inputs, finished = decoder.step(
            t, inputs, states)
        outputs.append(out)
        samples.append(sids)
        t += 1
        if bool(np.asarray(finished).all()):
            break
    out_seq = _tensor.concat([_nn.unsqueeze(o, [1]) for o in outputs],
                             axis=1)
    sample_seq = _tensor.concat([_nn.unsqueeze(s, [1]) for s in samples],
                                axis=1)
    if output_time_major:
        out_seq = _nn.transpose(out_seq, [1, 0, 2])
    return (out_seq, sample_seq), states, t


class BeamSearchDecoder(Decoder):
    """Beam search over a cell: each step adds the cell's log-softmax to
    the beams' scores, keeps the top ``beam_size`` of beam · V for each
    source row, and reorders the states by parent beam.  Runs under
    ``dynamic_decode`` (sample ids [B, beam] a step) or through
    ``decode()`` ([B, beam, T] ids)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self._cell = cell
        self._start, self._end = start_token, int(end_token)
        self._beam = beam_size
        self._embed = embedding_fn
        self._output_fn = output_fn

    @property
    def tracks_own_finished(self):
        return True

    def _tile(self, x):
        """[B, ...] -> [B · beam, ...], each row repeated beam times."""
        e = _nn.expand(_nn.unsqueeze(x, [1]),
                       expand_times=[1, self._beam] + [1] * (len(x.shape)
                                                             - 1))
        return _nn.reshape(e, [-1] + list(x.shape[1:]))

    def _start_state(self, inits):
        from ...dygraph.base import to_variable
        states = [self._tile(s) for s in inits] \
            if isinstance(inits, (list, tuple)) else self._tile(inits)
        b = (inits[0] if isinstance(inits, (list, tuple))
             else inits).shape[0]
        scores = to_variable(np.tile(
            np.array([0.] + [-1e9] * (self._beam - 1), "float32"),
            b).reshape(-1))
        return states, scores, b

    def _advance(self, ids, cell_states, scores, b):
        """One beam step from the beams' last ids (a [B · beam] VarBase):
        the new (ids [B, beam], states, scores)."""
        from ...dygraph.base import to_variable
        emb = self._embed(ids) if self._embed is not None else ids
        out, cell_states = self._cell(emb, cell_states)
        if self._output_fn is not None:
            out = self._output_fn(out)
        logp = _nn.log(_nn.softmax(out))
        v = logp.shape[-1]
        total = _nn.reshape(_nn.reshape(scores, [-1, 1]) + logp,
                            [b, self._beam * v])
        top_v, top_i = _nn.topk(total, self._beam)
        top_i = np.asarray(top_i.numpy())
        parent, tok = top_i // v, top_i % v
        flat_parent = (parent + np.arange(b)[:, None] * self._beam) \
            .reshape(-1)
        cell_states = self._reorder(
            cell_states, to_variable(flat_parent.astype("int64")))
        return tok, cell_states, _nn.reshape(top_v, [-1])

    @staticmethod
    def _reorder(cell_states, idx):
        """Each beam's states taken from its parent's row."""
        if isinstance(cell_states, (list, tuple)):
            return [_nn.gather(s, idx) for s in cell_states]
        return _nn.gather(cell_states, idx)

    def initialize(self, inits):
        from ...dygraph.base import to_variable
        states, scores, b = self._start_state(inits)
        tokens = to_variable(np.full((b * self._beam,), self._start,
                                     "int64"))
        return tokens, (states, scores, b), np.array(False)

    def step(self, time, inputs, states, **kw):
        from ...dygraph.base import to_variable
        cell_states, scores, b = states
        tok, cell_states, scores = self._advance(inputs, cell_states,
                                                 scores, b)
        sample_ids = to_variable(tok.astype("int64"))     # [B, beam]
        return (sample_ids, sample_ids), (cell_states, scores, b), \
            to_variable(tok.reshape(-1).astype("int64")), \
            np.asarray((tok == self._end).all())

    def decode(self, init_states, max_step_num=32):
        """The beam loop alone: [B, beam, T] token ids."""
        from ...dygraph.base import to_variable
        states, scores, b = self._start_state(init_states)
        tokens = np.full((b * self._beam,), self._start, "int64")
        all_tokens = []
        for _ in range(max_step_num):
            tok, states, scores = self._advance(to_variable(tokens), states,
                                                scores, b)
            tokens = tok.reshape(-1).astype("int64")
            all_tokens.append(tok.copy())
            if (tok == self._end).all():
                break
        return np.stack(all_tokens, axis=-1)
