"""The nn tail and the fused op family (counterpart of
``paddle_tpu/ops/fused_extra_ops.py``), each the plain composition of its
parts, as in the reference: the nn tail (``add_position_encoding``,
``crop``, ``expand_as``, ``unpool``, ``segment_pool``,
``similarity_focus``, ``lstm_unit``, ``frobenius_norm``, ``fsp``,
``inplace_abn``, ``interpolate`` and ``interpolate_v2``,
``correlation``), the fused family Paddle Inference's passes emit
(``fused_bn_add_activation``, ``fused_fc_elementwise_layernorm``,
``skip_layernorm``, ``conv_fusion``, ``fusion_repeated_fc_relu``,
``fusion_squared_mat_sub``, ``fusion_transpose_flatten_concat``,
``fusion_seqexpand_concat_fc``, ``fusion_seqconv_eltadd_relu``), the
recurrent fusions over the ``lstm`` and ``gru`` lowerings
(``fusion_gru``, ``fusion_lstm``, ``multi_gru``,
``fused_embedding_fc_lstm``) and the CTR rows
(``fused_embedding_seq_pool``, ``fusion_seqpool_concat``,
``fusion_seqpool_cvm_concat``, ``scaled_int8fc``,
``fused_seqpool_cvm_with_pcoc``).  ``c_mixallgather``, a ring
collective, comes with the collectives (ROADMAP queue A item 10).

As in the reference: ``fused_embedding_seq_pool`` never reads
``padding_idx``; the two CVM variants apply no log transform, they only
strip the leading columns when ``use_cvm`` is off; the ``gelu`` of the
fused activations is the tanh form (the ``gelu`` op is the erf form);
``fused_fc_elementwise_layernorm`` flattens X by its first axis and
reads no ``x_num_col_dims``; ``correlation`` rolls the second map with
wrap-around and reads no ``pad_size``, ``kernel_size`` or ``stride1``;
``fusion_transpose_flatten_concat`` flattens each input after its first
axis and reads no ``flatten_axis``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ctr_ops import _GatherRows
from .detection_ops import gather_rows, true_div
from .registry import get_op, has_op, register_op


def _p(ins, slot):
    return ins[slot][0]


_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "gelu": lambda v: F.gelu(v, approximate="tanh"), "swish": F.silu,
         "leaky_relu": F.leaky_relu}


def _act(name, x):
    if not name or name == "identity":
        return x
    return _ACTS[name](x)


def _layer_norm_rows(h, ins, scale_slot, bias_slot, eps):
    """LayerNorm over the last axis (population variance, ``rsqrt``),
    then the optional scale and bias slots."""
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.var(h, dim=-1, keepdim=True, correction=0)
    out = (h - mu) * torch.rsqrt(var + eps)
    if ins.get(scale_slot):
        out = out * ins[scale_slot][0]
    if ins.get(bias_slot):
        out = out + ins[bias_slot][0]
    return out


# ---------------------------------------------------------------------------
# nn tail
# ---------------------------------------------------------------------------

@register_op("add_position_encoding")
def _add_position_encoding(ins, attrs, ctx):
    """``alpha·X + beta·PE`` with the sinusoid table, the sines of the
    first D/2 frequencies before their cosines."""
    x = _p(ins, "X")                       # [B, T, D]
    alpha, beta = attrs.get("alpha", 1.0), attrs.get("beta", 1.0)
    _, t, d = x.shape
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=x.device)[None, :]
    freq = pos / torch.pow(10000.0, true_div(2.0 * i, d))
    pe = torch.cat([torch.sin(freq), torch.cos(freq)], dim=1)
    return {"Out": [alpha * x + beta * pe[None].to(x.dtype)]}


def _host_ints(t):
    return [int(v) for v in t.reshape(-1).tolist()]


@register_op("crop", nondiff_inputs=("Offsets", "Y"))
def _crop(ins, attrs, ctx):
    """X's window of Y's shape (else ``shape``) from ``Offsets`` (else
    ``offsets``, else the origin)."""
    x = _p(ins, "X")
    shape = list(ins["Y"][0].shape) if ins.get("Y") else attrs.get("shape")
    offsets = _host_ints(ins["Offsets"][0]) if ins.get("Offsets") \
        else attrs.get("offsets", [0] * x.ndim)
    return {"Out": [x[tuple(slice(int(o), int(o) + int(s))
                            for o, s in zip(offsets, shape))]]}


@register_op("expand_as", nondiff_inputs=("target_tensor",))
def _expand_as(ins, attrs, ctx):
    """X tiled to the target's shape (``target_tensor``, else ``Y``)."""
    x = _p(ins, "X")
    target = ins.get("target_tensor") or ins.get("Y")
    reps = [int(t // s) for t, s in zip(target[0].shape, x.shape)]
    return {"Out": [x.repeat(reps)]}


@register_op("unpool", nondiff_inputs=("Indices",))
def _unpool(ins, attrs, ctx):
    """Max-unpooling: each pooled value written at its argmax position of
    an ``unpooled_height`` x ``unpooled_width`` map of zeros."""
    x, idx = _p(ins, "X"), _p(ins, "Indices")
    n, c, h, w = x.shape
    oh = attrs.get("unpooled_height", h * 2)
    ow = attrs.get("unpooled_width", w * 2)
    out = x.new_zeros((n, c, oh * ow)).scatter(
        2, idx.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return {"Out": [out.reshape(n, c, oh, ow)]}


@register_op("segment_pool", nondiff_inputs=("SegmentIds",))
def _segment_pool(ins, attrs, ctx):
    """Rows of X pooled by ``SegmentIds`` into max(id) + 1 segments (an
    empty one: 0 for SUM and MEAN, -inf for MAX, +inf for MIN).  SUM and
    MEAN are a one-hot product, so the sums keep one order on the
    card."""
    x, seg = _p(ins, "X"), _p(ins, "SegmentIds").reshape(-1).long()
    n_seg = int(seg.max()) + 1
    pool = attrs.get("pooltype", "SUM").upper()
    flat = x.reshape(x.shape[0], -1)
    if pool in ("SUM", "MEAN"):
        onehot = (seg[None, :] == torch.arange(
            n_seg, device=x.device)[:, None]).to(x.dtype)
        out = onehot @ flat
        if pool == "MEAN":
            out = out / torch.clamp(onehot.sum(1, keepdim=True), min=1)
    else:
        big = float("inf") if pool == "MIN" else -float("inf")
        out = flat.new_full((n_seg, flat.shape[1]), big).scatter_reduce(
            0, seg[:, None].expand_as(flat), flat,
            "amax" if pool == "MAX" else "amin")
    return {"Out": [out.reshape((n_seg,) + tuple(x.shape[1:]))]}


@register_op("similarity_focus", differentiable=False)
def _similarity_focus(ins, attrs, ctx):
    """For each index of ``indexes``, the slice of X at it along ``axis``
    marks every row's and every column's largest value with 1, the mark
    broadcast back along ``axis``; the marks summed and clipped to 1."""
    x = _p(ins, "X")
    axis = attrs.get("axis", 1)
    out = torch.zeros_like(x)
    for idx in attrs.get("indexes", [0]):
        sl = torch.select(x, axis, idx)
        rows = torch.amax(sl, dim=-1, keepdim=True) == sl
        cols = torch.amax(sl, dim=-2, keepdim=True) == sl
        out = out + torch.unsqueeze((rows | cols).to(x.dtype), axis)
    return {"Out": [torch.clamp(out, 0.0, 1.0)]}


@register_op("lstm_unit")
def _lstm_unit(ins, attrs, ctx):
    """One LSTM cell step from pre-activations X [B, 4H], gates (i, f, o,
    g), the candidate last: C = C_prev·σ(f + forget_bias) + σ(i)·tanh(g),
    H = tanh(C)·σ(o)."""
    x, c_prev = _p(ins, "X"), _p(ins, "C_prev")
    i, f, o, g = torch.chunk(x, 4, dim=1)
    new_c = (c_prev * torch.sigmoid(f + attrs.get("forget_bias", 0.0))
             + torch.sigmoid(i) * torch.tanh(g))
    return {"C": [new_c], "H": [torch.tanh(new_c) * torch.sigmoid(o)]}


@register_op("frobenius_norm")
def _frobenius_norm(ins, attrs, ctx):
    """sqrt of the sum of squares over ``dim`` (every axis by default) in
    float32; ``reduce_all`` is not read."""
    x = _p(ins, "X")
    dims = attrs.get("dim", list(range(x.ndim)))
    out = torch.sqrt(torch.sum(torch.square(x.to(torch.float32)),
                               dim=tuple(dims),
                               keepdim=attrs.get("keep_dim", False)))
    return {"Out": [out.to(x.dtype)]}


@register_op("fsp")
def _fsp(ins, attrs, ctx):
    """The flow of solution procedure: the Gram matrix of two feature
    maps' channels over their H·W positions, divided by H·W."""
    x, y = _p(ins, "X"), _p(ins, "Y")
    b, cx, h, w = x.shape
    xf = x.reshape(b, cx, h * w).to(torch.float32)
    yf = y.reshape(b, y.shape[1], h * w).to(torch.float32)
    out = true_div(torch.einsum("bxs,bys->bxy", xf, yf), h * w)
    return {"Out": [out.to(x.dtype)]}


@register_op("inplace_abn")
def _inplace_abn(ins, attrs, ctx):
    """``batch_norm`` then ``activation`` (the in-place part is a memory
    detail of the reference's GPU kernel)."""
    outs = get_op("batch_norm").fn(ins, attrs, ctx)
    outs["Y"] = [_act(attrs.get("activation", ""), outs["Y"][0])]
    return outs


_INTERP = {"bilinear": "bilinear_interp", "nearest": "nearest_interp",
           "trilinear": "trilinear_interp", "bicubic": "bicubic_interp",
           "linear": "linear_interp"}


def _interp_dispatch(ins, attrs, ctx):
    """The ``interp_method``'s op, its ``_v2`` first where one is
    registered."""
    method = attrs.get("interp_method", "bilinear")
    target = _INTERP.get(method)
    if target is not None:
        for cand in (target + "_v2", target):
            if has_op(cand):
                return get_op(cand).fn(ins, attrs, ctx)
    raise NotImplementedError(f"interpolate method {method}")


register_op("interpolate", _interp_dispatch,
            nondiff_inputs=("OutSize", "SizeTensor", "Scale"))
register_op("interpolate_v2", _interp_dispatch,
            nondiff_inputs=("OutSize", "SizeTensor", "Scale"))


@register_op("correlation")
def _correlation(ins, attrs, ctx):
    """FlowNet's correlation: for each displacement (dy, dx) of the
    window ``max_displacement`` by ``stride2``, the channel mean of
    Input1 times Input2 rolled by it (with wrap-around); one output
    channel a displacement, dy major."""
    a, b = _p(ins, "Input1"), _p(ins, "Input2")
    max_disp = attrs.get("max_displacement", 1)
    disp = range(-max_disp, max_disp + 1, attrs.get("stride2", 1))
    outs = [torch.mean(a * torch.roll(b, (dy, dx), dims=(2, 3)), dim=1)
            for dy in disp for dx in disp]
    return {"Output": [torch.stack(outs, dim=1)]}


# ---------------------------------------------------------------------------
# fused family — compositions
# ---------------------------------------------------------------------------

@register_op("fused_bn_add_activation",
             nondiff_inputs=("Mean", "Variance"),
             nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean",
                              "SavedVariance"))
def _fused_bn_add_activation(ins, attrs, ctx):
    """``act(batch_norm(X) + Z)``."""
    z = _p(ins, "Z")
    outs = get_op("batch_norm").fn(
        {k: v for k, v in ins.items() if k != "Z"}, attrs, ctx)
    outs["Y"] = [_act(attrs.get("act_type", "relu"), outs["Y"][0] + z)]
    return outs


@register_op("fused_fc_elementwise_layernorm")
def _fused_fc_elementwise_layernorm(ins, attrs, ctx):
    """LayerNorm(X·W + Bias0 + Y) with Scale and Bias1; X flattened to
    [X.shape[0], -1]."""
    x, w, y = _p(ins, "X"), _p(ins, "W"), _p(ins, "Y")
    h = x.reshape(x.shape[0], -1) @ w
    if ins.get("Bias0"):
        h = h + ins["Bias0"][0]
    return {"Out": [_layer_norm_rows(h + y, ins, "Scale", "Bias1",
                                     attrs.get("epsilon", 1e-5))]}


@register_op("skip_layernorm")
def _skip_layernorm(ins, attrs, ctx):
    """LayerNorm(X + Y) with Scale and Bias."""
    h = _p(ins, "X") + _p(ins, "Y")
    return {"Out": [_layer_norm_rows(h, ins, "Scale", "Bias",
                                     attrs.get("epsilon", 1e-5))]}


@register_op("conv_fusion")
def _conv_fusion(ins, attrs, ctx):
    """``act(conv2d(Input, Filter) + Bias + ResidualData)``, ReLU by
    default."""
    outs = get_op("conv2d").fn(
        {k: v for k, v in ins.items() if k in ("Input", "Filter")},
        attrs, ctx)
    y = outs["Output"][0]
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(1, -1, 1, 1)
    if ins.get("ResidualData"):
        y = y + ins["ResidualData"][0]
    return {"Output": [_act(attrs.get("activation", "relu"), y)]}


@register_op("fusion_repeated_fc_relu")
def _fusion_repeated_fc_relu(ins, attrs, ctx):
    """X flattened to [N, -1], then ``relu(x·W_i + Bias_i)`` a weight."""
    x = _p(ins, "X")
    x = x.reshape(x.shape[0], -1)
    bs = list(ins.get("Bias", []))
    for i, w in enumerate(ins["W"]):
        x = x @ w
        if i < len(bs):
            x = x + bs[i]
        x = torch.relu(x)
    return {"Out": [x]}


@register_op("fusion_squared_mat_sub")
def _fusion_squared_mat_sub(ins, attrs, ctx):
    """``scalar·((XY)² - (X²)(Y²))``."""
    x, y = _p(ins, "X"), _p(ins, "Y")
    xy = x @ y
    return {"Out": [attrs.get("scalar", 1.0) * (xy * xy - (x * x) @ (y * y))]}


@register_op("fusion_transpose_flatten_concat")
def _fusion_transpose_flatten_concat(ins, attrs, ctx):
    """Each input transposed by ``trans_axis`` (when given), flattened
    after its first axis, then all concatenated on ``concat_axis``."""
    trans = attrs.get("trans_axis", None)
    outs = []
    for x in ins["X"]:
        if trans:
            x = x.permute(*trans)
        outs.append(x.reshape(x.shape[0], -1))
    return {"Out": [torch.cat(outs, dim=attrs.get("concat_axis", 1))]}


@register_op("fusion_seqexpand_concat_fc")
def _fusion_seqexpand_concat_fc(ins, attrs, ctx):
    """Inputs of fewer axes than the first broadcast over its steps, all
    concatenated on the last axis, then ``act(x·FCWeight + FCBias)``."""
    xs = list(ins["X"])
    ref = xs[0]
    cat = torch.cat([x if x.ndim == ref.ndim else torch.broadcast_to(
        x[:, None], tuple(ref.shape[:2]) + tuple(x.shape[1:])) for x in xs],
        dim=-1)
    w = _p(ins, "FCWeight")
    out = cat.reshape(-1, cat.shape[-1]) @ w
    if ins.get("FCBias"):
        out = out + ins["FCBias"][0]
    out = _act(attrs.get("fc_activation", "identity"), out)
    return {"Out": [out.reshape(tuple(cat.shape[:-1]) + (w.shape[1],))]}


@register_op("fusion_seqconv_eltadd_relu")
def _fusion_seqconv_eltadd_relu(ins, attrs, ctx):
    """``relu(sequence_conv(X, Filter) + Bias)``."""
    conv = get_op("sequence_conv").fn(
        {"X": ins["X"], "Filter": ins["Filter"]},
        {"contextLength": attrs.get("contextLength", 3),
         "contextStart": attrs.get("contextStart", -1),
         "contextStride": attrs.get("contextStride", 1)}, ctx)
    return {"Out": [torch.relu(conv["Out"][0] + _p(ins, "Bias"))]}


def _run_rnn(op, ins, attrs, ctx):
    """fusion_gru and fusion_lstm: X projected by WeightX, then the plain
    recurrent op over it with WeightH, Bias, H0 (and the LSTM's C0)."""
    inner = {"Input": [_p(ins, "X") @ _p(ins, "WeightX")],
             "Weight": [_p(ins, "WeightH")]}
    for slot in ("Bias", "H0") + (("C0",) if op == "lstm" else ()):
        if ins.get(slot):
            inner[slot] = ins[slot]
    return get_op(op).fn(inner, attrs, ctx)


@register_op("fusion_gru")
def _fusion_gru(ins, attrs, ctx):
    outs = _run_rnn("gru", ins, attrs, ctx)
    return {"Hidden": outs.get("Hidden", outs.get("Out", []))}


@register_op("fusion_lstm")
def _fusion_lstm(ins, attrs, ctx):
    outs = _run_rnn("lstm", ins, attrs, ctx)
    return {"Hidden": outs.get("Hidden", []), "Cell": outs.get("Cell", [])}


@register_op("multi_gru")
def _multi_gru(ins, attrs, ctx):
    """Stacked GRU layers: each layer's input projected by its WeightX,
    then the ``gru`` lowering with its WeightH and Bias."""
    h = _p(ins, "X")
    bs = list(ins.get("Bias", []))
    for i, (wx, wh) in enumerate(zip(ins["WeightX"], ins["WeightH"])):
        inner = {"Input": [h @ wx], "Weight": [wh]}
        if i < len(bs):
            inner["Bias"] = [bs[i]]
        outs = get_op("gru").fn(inner, attrs, ctx)
        h = outs.get("Hidden", outs.get("Out"))[0]
    return {"Hidden": [h]}


@register_op("fused_embedding_fc_lstm")
def _fused_embedding_fc_lstm(ins, attrs, ctx):
    """The rows of ``Embeddings`` (already the input projection, [V, 4H])
    at Ids, then the ``lstm`` lowering with WeightH and Bias; the gather
    is ``F.embedding``, whose gradient keeps one order on the card."""
    ids, w = _p(ins, "Ids"), _p(ins, "Embeddings")
    emb = gather_rows(w, ids.reshape(ids.shape[0], -1))
    inner = {"Input": [emb.reshape(emb.shape[0], emb.shape[1], -1)
                       if emb.ndim > 2 else emb],
             "Weight": [_p(ins, "WeightH")]}
    if ins.get("Bias"):
        inner["Bias"] = ins["Bias"]
    outs = get_op("lstm").fn(inner, attrs, ctx)
    return {"Hidden": outs.get("Hidden", []), "Cell": outs.get("Cell", [])}


# ---------------------------------------------------------------------------
# the CTR rows
# ---------------------------------------------------------------------------

@register_op("fused_embedding_seq_pool", nondiff_inputs=("Ids",))
def _fused_embedding_seq_pool(ins, attrs, ctx):
    """The rows of W summed (or averaged) a row of ids; the gather's
    gradient sums repeats in a fixed order (``_GatherRows``)."""
    w, ids = _p(ins, "W"), _p(ins, "Ids")
    emb = _GatherRows.apply(w, ids.reshape(ids.shape[0], -1).long())
    if attrs.get("combiner", "sum") == "sum":
        return {"Out": [torch.sum(emb, dim=1)]}
    return {"Out": [torch.mean(emb, dim=1)]}


@register_op("fusion_seqpool_concat")
def _fusion_seqpool_concat(ins, attrs, ctx):
    pool = attrs.get("pooltype", "SUM").upper()

    def red(x):
        if pool == "AVERAGE":
            return torch.mean(x, dim=1)
        if pool == "MAX":
            return torch.amax(x, dim=1)
        if pool == "SQRT":                 # sum / sqrt(len)
            return torch.sum(x, dim=1) / float(x.shape[1]) ** 0.5
        return torch.sum(x, dim=1)

    return {"Out": [torch.cat([red(x) if x.ndim == 3 else x
                               for x in ins["X"]], dim=-1)]}


@register_op("fusion_seqpool_cvm_concat")
def _fusion_seqpool_cvm_concat(ins, attrs, ctx):
    outs = [torch.sum(x, dim=1) if x.ndim == 3 else x for x in ins["X"]]
    if not attrs.get("use_cvm", True):
        outs = [x[:, 2:] for x in outs]   # show and click stripped
    return {"Out": [torch.cat(outs, dim=-1)]}


@register_op("scaled_int8fc")
def _scaled_int8fc(ins, attrs, ctx):
    """scaled_int8fc: the int8 product simulated in float32, the inputs
    and weights divided by their scales (rounded once, as the host
    rounds: ``true_div``), rounded half to even and clipped to [-127,
    127]."""
    x, w = _p(ins, "Input"), _p(ins, "W")
    sx = attrs.get("input_scale", 1.0)
    sw = attrs.get("weight_scale", 1.0)
    qx = torch.clamp(torch.round(true_div(x, sx)), -127, 127)
    qw = torch.clamp(torch.round(true_div(w, sw)), -127, 127)
    out = (qx @ qw) * (sx * sw)
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return {"Out": [out]}


@register_op("fused_seqpool_cvm_with_pcoc")
def _fused_seqpool_cvm_with_pcoc(ins, attrs, ctx):
    outs = []
    for x in ins["X"]:
        pooled = torch.sum(x, dim=1) if x.ndim == 3 else x
        if not attrs.get("use_cvm", True):
            pooled = pooled[:, 3:]        # show, click and pcoc stripped
        outs.append(pooled)
    return {"Out": outs}
