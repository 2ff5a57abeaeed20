"""Recurrent ops at the reference's op granularity (counterpart of
``paddle_tpu/ops/rnn_ops.py``): ``lstm``, ``lstmp``, ``gru``,
``gru_unit``, ``cudnn_lstm``, ``conv_shift`` and ``row_conv``.

The sequences are padded [B, T, D] (the reference's LoD-ragged
recurrences made dense).  ``lstm``, ``lstmp`` and ``gru`` take their
input already projected (x @ Wx, as the reference requires) and run a
loop over time of PyTorch ops, one recurrent product a step (two for the
GRU, whose candidate waits on the reset gate), as
``fluid/layers/rnn.py``'s ``_scan_one_direction`` does.  The gate order
is the reference's: LSTM (i, f, c, o), GRU (update, reset, candidate),
the recurrent weight used as ``h @ w``.

``cudnn_lstm`` is the one that the reference's ``lax.scan`` computes as
cuDNN's LSTM does, so here it is PyTorch's LSTM: cuDNN's fused RNN
kernels on the card (``aten::_cudnn_rnn``, what ``nn.LSTM.forward``
reaches), ``rnn_scan``'s LSTM loop on the host.  Its weights are views of the flat ``W``
in the reference's layout, ``[wi (4H x in), wh (4H x H), bi, bh]`` a
layer, which is also the order PyTorch hands cuDNN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op

_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": lambda x: x}
# cudnnRNNMode_t's CUDNN_LSTM
_CUDNN_LSTM = 2
# gru_unit's integer activation codes (gru_unit_op.h)
_ACT_CODES = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _act(attrs, key, default):
    a = attrs.get(key, default)
    return _ACT[_ACT_CODES.get(a, default) if isinstance(a, int) else a]


def _time_major(x, reverse):
    """[B, T, D] -> a list of T [B, D] steps, last first if ``reverse``."""
    steps = list(x.transpose(0, 1).unbind(0))
    return steps[::-1] if reverse else steps


def _batch_major(steps, reverse):
    return torch.stack(steps[::-1] if reverse else steps, dim=1)


@register_op("lstm", nondiff_inputs=("C0", "H0"))
def _lstm(ins, attrs, ctx):
    """``Input`` [B, T, 4H] pre-projected, ``Weight`` [H, 4H], ``Bias``
    [1, 4H], or [1, 7H] with peepholes (on by default, as in
    lstm_op.cc): the last 3H are W_ic, W_if and W_oc.  ``Hidden`` and
    ``Cell`` [B, T, H]; ``is_reverse`` runs the padded sequence from its
    end."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    h = w.shape[0]
    braw = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    b = braw[:4 * h] if braw is not None else None
    peep = (attrs.get("use_peepholes", True) and braw is not None
            and braw.shape[0] >= 7 * h)
    if peep:
        w_ic, w_if, w_oc = braw[4 * h:7 * h].chunk(3)
    bsz = x.shape[0]
    hp = ins["H0"][0] if ins.get("H0") else x.new_zeros(bsz, h)
    c = ins["C0"][0] if ins.get("C0") else x.new_zeros(bsz, h)
    ga = _act(attrs, "gate_activation", "sigmoid")
    ca = _act(attrs, "cell_activation", "tanh")
    na = _act(attrs, "candidate_activation", "tanh")
    reverse = attrs.get("is_reverse", False)
    hs, cs = [], []
    for xt in _time_major(x, reverse):
        g = torch.addmm(xt if b is None else xt + b, hp, w)
        i, f, cc, o = g.chunk(4, dim=-1)
        if peep:
            i, f = ga(i + w_ic * c), ga(f + w_if * c)
            c = f * c + i * na(cc)
            o = ga(o + w_oc * c)
        else:
            c = ga(f) * c + ga(i) * na(cc)
            o = ga(o)
        hp = o * ca(c)
        hs.append(hp)
        cs.append(c)
    cell = _batch_major(cs, reverse)
    return {"Hidden": [_batch_major(hs, reverse)], "Cell": [cell],
            "BatchGate": [x], "BatchCellPreAct": [cell]}


@register_op("lstmp", nondiff_inputs=("C0", "H0"))
def _lstmp(ins, attrs, ctx):
    """LSTM with a recurrent projection (lstmp_op.cc): ``Weight`` [P, 4H]
    over the projected state, ``ProjWeight`` [H, P]; the projection
    ``proj_act(h @ ProjWeight)`` is what recurs and what ``Projection``
    holds.  As in the reference, peepholes and ``is_reverse`` are not
    read and ``Cell`` is zeros."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    proj = ins["ProjWeight"][0]
    h_dim, p_dim = proj.shape
    b = ins["Bias"][0].reshape(-1)[:4 * h_dim] if ins.get("Bias") else None
    bsz = x.shape[0]
    r = ins["H0"][0] if ins.get("H0") else x.new_zeros(bsz, p_dim)
    c = ins["C0"][0] if ins.get("C0") else x.new_zeros(bsz, h_dim)
    ga = _act(attrs, "gate_activation", "sigmoid")
    ca = _act(attrs, "cell_activation", "tanh")
    na = _act(attrs, "candidate_activation", "tanh")
    pa = _act(attrs, "proj_activation", "tanh")
    rs = []
    for xt in _time_major(x, False):
        g = torch.addmm(xt if b is None else xt + b, r, w)
        i, f, cc, o = g.chunk(4, dim=-1)
        c = ga(f) * c + ga(i) * na(cc)
        r = pa((ga(o) * ca(c)) @ proj)
        rs.append(r)
    return {"Projection": [_batch_major(rs, False)],
            "Cell": [x.new_zeros(bsz, x.shape[1], h_dim)],
            "BatchGate": [x], "BatchCellPreAct": [x], "BatchHidden": [x]}


def _gru_step(xt, hp, w, b, h, ga, na, origin):
    """One GRU step of gru_op.h: gates (update, reset) from
    ``x + h @ w[:, :2H]``, the candidate from ``x + (r * h) @ w[:, 2H:]``;
    ``origin_mode`` blends u * h + (1 - u) * c, else (1 - u) * h + u * c.
    Returns (h', u, r, c)."""
    xur, xc = xt[:, :2 * h] + b[:2 * h], xt[:, 2 * h:] + b[2 * h:]
    u, r = ga(torch.addmm(xur, hp, w[:, :2 * h])).chunk(2, dim=-1)
    c = na(torch.addmm(xc, r * hp, w[:, 2 * h:]))
    out = u * hp + (1 - u) * c if origin else (1 - u) * hp + u * c
    return out, u, r, c


@register_op("gru", nondiff_inputs=("H0",))
def _gru(ins, attrs, ctx):
    """``Input`` [B, T, 3H] pre-projected, ``Weight`` [H, 3H] (update and
    reset, then candidate), ``Bias`` [1, 3H]; ``Hidden`` [B, T, H]."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    h = w.shape[0]
    b = ins["Bias"][0].reshape(-1) if ins.get("Bias") \
        else x.new_zeros(3 * h)
    hp = ins["H0"][0] if ins.get("H0") else x.new_zeros(x.shape[0], h)
    ga = _act(attrs, "gate_activation", "sigmoid")
    na = _act(attrs, "activation", "tanh")
    origin = attrs.get("origin_mode", False)
    reverse = attrs.get("is_reverse", False)
    hs = []
    for xt in _time_major(x, reverse):
        hp = _gru_step(xt, hp, w, b, h, ga, na, origin)[0]
        hs.append(hp)
    out = _batch_major(hs, reverse)
    return {"Hidden": [out], "BatchGate": [x],
            "BatchResetHiddenPrev": [out], "BatchHidden": [out]}


@register_op("gru_unit")
def _gru_unit(ins, attrs, ctx):
    """One GRU step (gru_unit_op.cc): ``Input`` [B, 3H], ``HiddenPrev``
    [B, H], ``Weight`` [H, 3H], ``Bias`` [1, 3H]; the activations as
    strings or gru_unit_op.h's codes (0 identity, 1 sigmoid, 2 tanh,
    3 relu)."""
    x = ins["Input"][0]
    hp = ins["HiddenPrev"][0]
    w = ins["Weight"][0]
    h = hp.shape[-1]
    b = ins["Bias"][0].reshape(-1) if ins.get("Bias") \
        else x.new_zeros(3 * h)
    out, u, r, c = _gru_step(
        x, hp, w, b, h, _act(attrs, "gate_activation", "sigmoid"),
        _act(attrs, "activation", "tanh"), attrs.get("origin_mode", False))
    return {"Hidden": [out], "Gate": [torch.cat([u, r, c], -1)],
            "ResetHiddenPrev": [r * hp]}


def _cudnn_weights(wflat, num_layers, hidden, in_dim):
    """Views of the flat ``W``: (wi [4H, in], wh [4H, H], bi [4H],
    bh [4H]) for each layer, in order."""
    ws, off = [], 0
    for layer in range(num_layers):
        d = in_dim if layer == 0 else hidden
        for shape in ((4 * hidden, d), (4 * hidden, hidden),
                      (4 * hidden,), (4 * hidden,)):
            n = shape[0] * (shape[1] if len(shape) > 1 else 1)
            ws.append(wflat[off:off + n].view(shape))
            off += n
    return ws


@register_op("cudnn_lstm",
             nondiff_inputs=("InitH", "InitC", "SequenceLength"),
             stateful_rng=True)
def _cudnn_lstm(ins, attrs, ctx):
    """A ``num_layers`` LSTM over ``Input`` [T, B, D] (time major, the
    reference's cuDNN layout) with the flat ``W``; ``Out`` [T, B, H],
    ``LastH`` and ``LastC`` [layers, B, H].  As in the reference,
    ``dropout_prob``, ``is_test`` and ``SequenceLength`` are not read
    (ROADMAP queue C); ``Reserve`` and ``StateOut`` are zeros.

    On the card this is ``aten::_cudnn_rnn`` itself: ``torch._VF.lstm``
    reaches it through a composite that reads the weights' storage,
    which ``torch.func``'s wrapped tensors do not have, so
    ``generic_grad``'s vjp could not run it.  The op's own derivative is
    cuDNN's backward, which needs the forward's training state: the
    forward keeps it only where a gradient is taken (the vjp and the tape
    run with grad on, the Executor's forward without).  cuDNN copies the
    weight views into its own buffer at each call.  On the host each
    layer is ``rnn_scan``'s LSTM loop (``torch._VF.lstm`` takes oneDNN
    there, whose backward fails under a vjp inside ``no_grad``)."""
    x = ins["Input"][0]
    num_layers = attrs.get("num_layers", 1)
    hidden = attrs.get("hidden_size", x.shape[-1])
    zeros = x.new_zeros(num_layers, x.shape[1], hidden)
    h0 = ins["InitH"][0] if ins.get("InitH") else zeros
    c0 = ins["InitC"][0] if ins.get("InitC") else zeros
    ws = _cudnn_weights(ins["W"][0].reshape(-1), num_layers, hidden,
                        x.shape[-1])
    if x.is_cuda:
        out, last_h, last_c = torch.ops.aten._cudnn_rnn(
            x, ws, 4, None, h0, c0, _CUDNN_LSTM, hidden, 0, num_layers,
            False, 0.0, torch.is_grad_enabled(), False, [], None)[:3]
    else:
        from ..fluid.layers.rnn import _scan_one_direction
        out, hs, cs = x, [], []
        for layer in range(num_layers):
            out, h, c = _scan_one_direction(
                "LSTM", *ws[4 * layer:4 * layer + 4], h0[layer], c0[layer],
                out)
            hs.append(h)
            cs.append(c)
        last_h, last_c = torch.stack(hs), torch.stack(cs)
    return {"Out": [out], "LastH": [last_h], "LastC": [last_c],
            "Reserve": [x.new_zeros(1)], "StateOut": [x.new_zeros(1)]}


@register_op("conv_shift")
def _conv_shift(ins, attrs, ctx):
    """Circular 1-d correlation (conv_shift_op.cc), ``Y`` of odd width M
    no wider than ``X``'s N: out[i, j] = sum_k X[i, (j + k - M/2) mod N]
    · Y[i, k]."""
    x, y = ins["X"][0], ins["Y"][0]
    n, m = x.shape[1], y.shape[1]
    idx = (torch.arange(n, device=x.device)[:, None]
           + torch.arange(m, device=x.device)[None, :] - m // 2) % n
    return {"Out": [torch.einsum("bnm,bm->bn", x[:, idx], y)]}


@register_op("row_conv", nondiff_inputs=("Length",))
def _row_conv(ins, attrs, ctx):
    """The lookahead convolution of DeepSpeech2 (row_conv_op.cc) over a
    padded [B, T, D] input with ``Filter`` [future_context + 1, D]:
    out[b, t, d] = sum_k x[b, t + k, d] · filter[k, d], zero past T."""
    x = ins["X"][0]
    f = ins["Filter"][0]
    t = x.shape[1]
    pad = F.pad(x, (0, 0, 0, f.shape[0] - 1))
    out = pad[:, :t] * f[0]
    for k in range(1, f.shape[0]):
        out = out + pad[:, k:k + t] * f[k]
    return {"Out": [out]}
