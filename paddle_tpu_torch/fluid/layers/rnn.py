"""The whole-sequence recurrent op (counterpart of
``paddle_tpu/fluid/layers/rnn.py``'s ``rnn_scan`` and
``_scan_one_direction``; the cells and the other recurrent layers of that
module come with their slices).

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

import torch

from ...ops.registry import register_op


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
