"""Fused compositions and optimizer variants (counterpart of
``paddle_tpu/ops/misc_ops.py`` and ``paddle_tpu/ops/fused_extra_ops.py``):
the two ops the pairwise fusion passes make, each the plain composition
of its parts, the ``adamax`` update, and the image layers' stragglers
(``bilinear_tensor_product``, ``pool3d``, ``spectral_norm``,
``teacher_student_sigmoid_loss``, ``dropout_nd``), ``center_loss``,
the fused inference tier's ``fused_embedding_eltwise_layernorm`` and
``fusion_group``, and the catalog's last thirteen: the proximal
optimizers, ``minus``, ``elementwise_heaviside``,
``modified_huber_loss``, ``fill_diagonal``, ``pad_constant_like``,
``spp``, ``shuffle_channel``, ``positive_negative_pair``,
``gaussian_random_batch_size_like``, ``diag`` and ``lod_reset``."""
from __future__ import annotations

import torch

from .math import _bcast
from .registry import register_op

_UNARY = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
          "identity": lambda v: v, "": lambda v: v}
_BINARY = {"elementwise_add": torch.add, "elementwise_mul": torch.mul,
           "elementwise_sub": torch.sub}


@register_op("adamax", differentiable=False)
def _adamax(ins, attrs, ctx):
    """Adam under the infinity norm: ``u = max(b2·u, |g|)``, the step
    bias-corrected by ``Beta1Pow`` (which the caller advances)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m, u = ins["Moment"][0], ins["InfNorm"][0]
    lr = ins["LearningRate"][0].reshape(())
    b1p = ins["Beta1Pow"][0].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m2 = b1 * m + (1 - b1) * g
    u2 = torch.maximum(b2 * u, torch.abs(g))
    p2 = p - (lr / (1 - b1p)) * m2 / (u2 + eps)
    return {"ParamOut": [p2], "MomentOut": [m2], "InfNormOut": [u2]}


@register_op("fused_elemwise_activation")
def _fused_elemwise_activation(ins, attrs, ctx):
    """fused_elemwise_activation_op.cc: ``functor_list`` such as
    ['elementwise_add', 'relu'] applied as f2(f1(x, y)), honouring the
    elementwise ``axis``; IntermediateOut is f1's result."""
    x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
    functors = attrs.get("functor_list", ["elementwise_add", "relu"])
    cur = inter = None
    for f in functors:
        if f in _BINARY:
            cur = _BINARY[f](x, y) if cur is None else _BINARY[f](cur, y)
        else:
            name = f.replace("scale", "identity")
            cur = _UNARY.get(name, _UNARY["identity"])(
                cur if cur is not None else x)
        inter = cur if inter is None else inter
    return {"Out": [cur], "IntermediateOut": [inter]}


@register_op("fused_bn_activation",
             nondiff_inputs=("Mean", "Variance"),
             nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean",
                              "SavedVariance"))
def _fused_bn_activation(ins, attrs, ctx):
    """fused_bn_activation_op.cc, what the ``fuse_bn_act`` pass makes of
    batch_norm + act: ``batch_norm``'s lowering, then ``act_type`` on Y."""
    from .registry import get_op
    outs = get_op("batch_norm").fn(ins, attrs, ctx)
    act = attrs.get("act_type", "relu")
    outs["Y"] = [_UNARY[act](outs["Y"][0])]
    return outs


# the 2.0 surface (paddle.tensor's tail)
@register_op("unique", differentiable=False)
def _unique(ins, attrs, ctx):
    """unique_op.cc with a static shape: the sorted unique values padded
    with 0 to the input's length, the inverse index (int32) and the
    count of unique values."""
    x = ins["X"][0].reshape(-1)
    u, inverse = torch.unique(x, sorted=True, return_inverse=True)
    out = torch.zeros_like(x)
    out[:u.numel()] = u
    return {"Out": [out], "Index": [inverse.to(torch.int32)],
            "UniqueCount": [torch.tensor([u.numel()], dtype=torch.int32,
                                         device=x.device)]}


@register_op("multiplex", nondiff_inputs=("Ids",))
def _multiplex(ins, attrs, ctx):
    """Row r of the output is row r of candidate ``X[Ids[r]]``."""
    ids = ins["Ids"][0].long().reshape(-1)
    stacked = torch.stack(ins["X"], dim=0)
    return {"Out": [stacked[ids, torch.arange(ids.shape[0],
                                              device=ids.device)]]}


@register_op("scatter_nd", nondiff_inputs=("Index", "Shape"))
def _scatter_nd(ins, attrs, ctx):
    idx, upd = ins["Index"][0], ins["Updates"][0]
    shape = [int(v) for v in ins["Shape"][0].tolist()] \
        if ins.get("Shape") else list(attrs["shape"])
    out = torch.zeros(shape, dtype=upd.dtype, device=upd.device)
    return {"Out": [out.index_put(tuple(idx.long().movedim(-1, 0)), upd,
                                  accumulate=True)]}


@register_op("histogram", differentiable=False)
def _histogram(ins, attrs, ctx):
    """``bins`` equal bins over [min, max] (the data's range when both
    are 0), the last bin closed; int64 counts."""
    x = ins["X"][0].reshape(-1).float()
    lo, hi = attrs.get("min", 0), attrs.get("max", 0)
    if lo == 0 and hi == 0:
        lo, hi = x.min().item(), x.max().item()
    return {"Out": [torch.histc(x, bins=attrs.get("bins", 100), min=lo,
                                max=hi).long()]}


@register_op("crop_tensor", nondiff_inputs=("Shape", "Offsets"))
def _crop_tensor(ins, attrs, ctx):
    """The window of ``shape`` (-1 keeps a dim) at ``offsets``."""
    x = ins["X"][0]
    shape = [int(s) for s in ins["Shape"][0].reshape(-1).tolist()] \
        if ins.get("Shape") else list(attrs.get("shape"))
    offsets = [int(o) for o in ins["Offsets"][0].reshape(-1).tolist()] \
        if ins.get("Offsets") else list(attrs.get("offsets",
                                                  [0] * x.ndim))
    shape = [x.shape[i] if s == -1 else s for i, s in enumerate(shape)]
    return {"Out": [x[tuple(slice(o, o + s)
                            for o, s in zip(offsets, shape))]]}


# -- the image layers' stragglers ---------------------------------------------
@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ins, attrs, ctx):
    """``out[b, k] = x[b] · W[k] · y[b] (+ bias[k])``, accumulated in at
    least float32."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    acc = torch.promote_types(x.dtype, torch.float32)
    out = torch.einsum("bi,kij,bj->bk", x.to(acc), w.to(acc),
                       y.to(acc)).to(x.dtype)
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(1, -1)
    return {"Out": [out]}


@register_op("pool3d")
def _pool3d(ins, attrs, ctx):
    """Max or average over NCDHW windows with symmetric ``paddings``
    (-inf for max, 0 for average); the average divides by the whole
    window, padding included, as the reference's ``reduce_window`` sum
    does."""
    x = ins["X"][0]
    ksize = list(attrs.get("ksize", [2, 2, 2]))
    strides = list(attrs.get("strides", ksize))
    pads = list(attrs.get("paddings", [0, 0, 0]))
    if attrs.get("global_pooling", False):
        ksize = strides = list(x.shape[2:])
        pads = [0, 0, 0]
    flat = [v for p in reversed(pads) for v in (p, p)]
    if attrs.get("pooling_type", "max") == "max":
        xp = torch.nn.functional.pad(x, flat, value=float("-inf"))
        return {"Out": [torch.nn.functional.max_pool3d(xp, ksize, strides)]}
    summed = torch.nn.functional.avg_pool3d(
        torch.nn.functional.pad(x, flat), ksize, strides,
        divisor_override=1)
    return {"Out": [summed / float(ksize[0] * ksize[1] * ksize[2])]}


@register_op("spectral_norm", nondiff_inputs=("U", "V"))
def _spectral_norm(ins, attrs, ctx):
    """``Weight / σ``, σ from ``power_iters`` power iterations on
    ``(U, V)`` over the weight as a matrix of its ``dim`` rows; every
    norm floored at 1e-12 (the reference reads no ``eps``), and the
    gradient flows through the iteration as the reference's vjp's does."""
    w = ins["Weight"][0]
    u = ins["U"][0].reshape(-1)
    v = ins["V"][0].reshape(-1)
    dim = attrs.get("dim", 0)
    wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    for _ in range(max(attrs.get("power_iters", 1), 0)):
        v = wm.t() @ u
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
        u = wm @ v
        u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-12)
    sigma = u @ wm @ v
    return {"Out": [w / torch.clamp(sigma, min=1e-12)]}


@register_op("teacher_student_sigmoid_loss", nondiff_inputs=("Label",))
def _ts_sigmoid_loss(ins, attrs, ctx):
    """CTR distillation: a label below 0 is a teacher's score ``-label``
    (clipped to the ``soft_max_*_threshold`` range), else the click
    bit; ``[N, 1]``."""
    x = ins["X"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1)
    lo = attrs.get("soft_max_low_threshold", -2.0)
    hi = attrs.get("soft_max_up_threshold", 2.0)
    log1e = torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0.0)
    hard = log1e - x * (label > 0).to(x.dtype)
    soft = log1e - x * torch.sigmoid(torch.clamp(-label, lo, hi))
    return {"Y": [torch.where(label < 0, soft, hard).reshape(-1, 1)]}


@register_op("dropout_nd", stateful_rng=True, nondiff_outputs=("Mask",))
def _dropout_nd(ins, attrs, ctx):
    """Dropout whose mask is shared along every axis outside ``axis``
    (whole channels for ``axis=[0, 1]``): the mask of the reduced shape is
    Philox4x32-10 from the op's seed and its flat index (ROADMAP ground
    rule 5, the plain version of the dropout kernels' draw; the reference
    draws ``jax.random.bernoulli``), kept values ``x / (1 - p)``."""
    from .nn_ops import _op_key, _reference_keep, _threshold_for
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("is_test", False) or ctx.is_test:
        return {"Out": [x], "Mask": [torch.ones_like(x, dtype=torch.uint8)]}
    shape = list(x.shape)
    axis = attrs.get("axis", None)
    if axis is not None:
        keep_axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in keep_axes else 1 for i, s in enumerate(shape)]
    k0, k1 = _op_key(attrs, ctx)
    keep = _reference_keep(shape, k0, k1, _threshold_for(p), x.device)
    out = torch.where(keep, x / (1 - p), torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    return {"Out": [out.to(x.dtype)],
            "Mask": [torch.broadcast_to(keep, x.shape).to(torch.uint8)]}


@register_op("center_loss", nondiff_inputs=("Label", "Centers",
                                            "CenterUpdateRate"))
def _center_loss(ins, attrs, ctx):
    """center_loss_op.cc: 0.5 · ||x - center[label]||² a row; under
    ``need_update`` the centers move by ``alpha`` times their rows' mean
    difference (a count of n divides by n + 1)."""
    x, centers = ins["X"][0], ins["Centers"][0]
    label = ins["Label"][0].reshape(-1).long()
    alpha = ins["CenterUpdateRate"][0].reshape(()) \
        if ins.get("CenterUpdateRate") else 0.5
    diff = x - centers[label]
    loss = 0.5 * torch.sum(diff * diff, dim=1, keepdim=True)
    if attrs.get("need_update", True):
        cnt = torch.zeros(centers.shape[0], dtype=x.dtype, device=x.device) \
            .index_add(0, label, torch.ones_like(label, dtype=x.dtype))
        delta = torch.zeros_like(centers).index_add(0, label, diff)
        centers = centers + alpha * delta / (cnt[:, None] + 1.0)
    return {"Loss": [loss], "SampleCenterDiff": [diff],
            "CentersOut": [centers]}


@register_op("partial_concat")
def _partial_concat(ins, attrs, ctx):
    """partial_concat_op.cc: the columns [start_index, start_index +
    length) of every input (to the end for length -1), concatenated."""
    start = attrs.get("start_index", 0)
    length = attrs.get("length", -1)
    return {"Out": [torch.cat(
        [x[:, start:(x.shape[1] if length < 0 else start + length)]
         for x in ins["X"]], dim=1)]}


@register_op("partial_sum")
def _partial_sum(ins, attrs, ctx):
    """partial_sum_op.cc: the same column slice of every input, summed."""
    start = attrs.get("start_index", 0)
    length = attrs.get("length", -1)
    acc = None
    for x in ins["X"]:
        piece = x[:, start:(x.shape[1] if length < 0 else start + length)]
        acc = piece if acc is None else acc + piece
    return {"Out": [acc]}


@register_op("lookup_table_dequant", nondiff_inputs=("Ids",))
def _lookup_table_dequant(ins, attrs, ctx):
    """lookup_table_dequant_op.cc, the int8 table read: a row holds [min,
    max, codes...] and reads as ``min + (max - min) · codes / 255``.  The
    rows are gathered by ``F.embedding`` (``gather_rows``), so the
    gradient adds a repeated id's rows in a fixed order on the card."""
    from .detection_ops import gather_rows, true_div
    rows = gather_rows(ins["W"][0], ins["Ids"][0].reshape(-1))
    mn, mx = rows[:, 0:1], rows[:, 1:2]
    return {"Out": [mn + true_div((mx - mn) * rows[:, 2:], 255.0)]}


@register_op("fused_embedding_eltwise_layernorm", nondiff_inputs=("Ids",))
def _fused_embedding_eltwise_layernorm(ins, attrs, ctx):
    """The BERT embedding block as one op (Paddle Inference's ERNIE
    form): the rows of each ``Embs`` table at its ``Ids`` [B, T], summed
    in slot order, then LayerNorm with Scale and Bias, divided by
    ``sqrt(var + eps)``.  The gathers are ``F.embedding``
    (``gather_rows``), whose gradient keeps one order on the card."""
    from .detection_ops import gather_rows
    acc = None
    for ids, emb in zip(ins["Ids"], ins["Embs"]):
        v = gather_rows(emb, ids.reshape(tuple(ids.shape[:2])))
        acc = v if acc is None else acc + v
    mu = acc.mean(-1, keepdim=True)
    var = torch.var(acc, dim=-1, keepdim=True, correction=0)
    return {"Out": [(acc - mu) / torch.sqrt(var + attrs.get("epsilon", 1e-5))
                    * ins["Scale"][0] + ins["Bias"][0]]}


@register_op("fusion_group")
def _fusion_group(ins, attrs, ctx):
    """fusion_group_pass's generated-kernel op, the identity over its
    inputs, as in the reference: the subgraph it stands for is not
    carried, so ``Outs`` are ``Inputs``."""
    return {"Outs": list(ins["Inputs"])}


# --- the catalog's last thirteen ---------------------------------------------
def _soft_threshold(prox, shrink, l2_rate):
    """sign(prox)·max(|prox| - shrink, 0) / (1 + l2_rate)."""
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - shrink, min=0.0)
            / (1.0 + l2_rate))


@register_op("proximal_gd", differentiable=False)
def _proximal_gd(ins, attrs, ctx):
    """A gradient step, then the l1 soft threshold and the l2 shrink
    (proximal_gd_op.h)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    return {"ParamOut": [_soft_threshold(p - lr * g, lr * l1, lr * l2)]}


@register_op("proximal_adagrad", differentiable=False)
def _proximal_adagrad(ins, attrs, ctx):
    """proximal_gd at the Adagrad rate lr / sqrt(Moment + g² + 1e-12)."""
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0].reshape(())
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    m2 = m + g * g
    alr = lr / torch.sqrt(m2 + 1e-12)
    return {"ParamOut": [_soft_threshold(p - alr * g, alr * l1, alr * l2)],
            "MomentOut": [m2]}


@register_op("minus")
def _minus(ins, attrs, ctx):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


@register_op("elementwise_heaviside")
def _elementwise_heaviside(ins, attrs, ctx):
    """1 where X > 0, Y where X == 0, 0 elsewhere, in X's dtype."""
    x, y = ins["X"][0], ins["Y"][0]
    one, zero = x.new_ones(()), x.new_zeros(())
    return {"Out": [torch.where(x > 0, one,
                                torch.where(x == 0, y.to(x.dtype), zero))]}


@register_op("modified_huber_loss", nondiff_inputs=("Y",))
def _modified_huber_loss(ins, attrs, ctx):
    """Labels {0, 1} as {-1, +1}, z = X·label: -4z below -1, (1 - z)²
    below 1, 0 above; IntermediateVal is z."""
    x, y = ins["X"][0], ins["Y"][0]
    z = x * (2.0 * y - 1.0)
    zero = z.new_zeros(())
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, (1.0 - z) ** 2, zero))
    return {"Out": [loss], "IntermediateVal": [z]}


@register_op("fill_diagonal")
def _fill_diagonal(ins, attrs, ctx):
    """X with ``value`` on the diagonal of its last two axes."""
    x = ins["X"][0]
    r, c = x.shape[-2], x.shape[-1]
    diag = (torch.arange(r, device=x.device)[:, None]
            == torch.arange(c, device=x.device)[None, :])
    return {"Out": [torch.where(diag, x.new_full((), attrs.get("value", 0.0)),
                                x)]}


@register_op("pad_constant_like", nondiff_inputs=("X",))
def _pad_constant_like(ins, attrs, ctx):
    """Y padded at the end of each axis up to X's shape with
    ``pad_value``; the gradient flows to Y only."""
    x, y = ins["X"][0], ins["Y"][0]
    pads = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pads += [0, xs - ys]
    return {"Out": [torch.nn.functional.pad(
        y, pads, value=float(attrs.get("pad_value", 0.0)))]}


@register_op("spp")
def _spp(ins, attrs, ctx):
    """Spatial pyramid pooling (spp_op.cc): level l pools X [N, C, H, W]
    into 2^l x 2^l bins of ceil(H / 2^l) x ceil(W / 2^l), the map padded
    at the bottom and right (with -inf for max, 0 for avg, which divides
    by the whole bin), each level flattened, the levels concatenated."""
    x = ins["X"][0]
    levels = attrs.get("pyramid_height", 1)
    is_max = attrs.get("pooling_type", "max") == "max"
    b, c, h, w = x.shape
    outs = []
    for level in range(levels):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        xp = torch.nn.functional.pad(
            x, (0, kw * bins - w, 0, kh * bins - h),
            value=float("-inf") if is_max else 0.0)
        r = xp.reshape(b, c, bins, kh, bins, kw)
        v = torch.amax(r, dim=(3, 5)) if is_max \
            else r.sum(dim=(3, 5)) / (kh * kw)
        outs.append(v.reshape(b, -1))
    return {"Out": [torch.cat(outs, dim=1)]}


@register_op("shuffle_channel")
def _shuffle_channel(ins, attrs, ctx):
    """ShuffleNet's channel shuffle: [N, g, C/g, H, W] transposed to
    [N, C/g, g, H, W]."""
    x = ins["X"][0]
    g = attrs.get("group", 1)
    b, c, h, w = x.shape
    return {"Out": [x.reshape(b, g, c // g, h, w).transpose(1, 2)
                    .reshape(b, c, h, w)]}


@register_op("positive_negative_pair", nondiff_inputs=("Label", "QueryID"),
             differentiable=False)
def _positive_negative_pair(ins, attrs, ctx):
    """The ranking metric (positive_negative_pair_op.cc): over the pairs
    i < j of one query with different labels, those the scores order as
    the labels (positive), tie (neutral) or order against them
    (negative); each count a float32 [1, 1]."""
    score = ins["Score"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1)
    qid = ins["QueryID"][0].reshape(-1)
    n = score.shape[0]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=score.device), diagonal=1)
    considered = (upper & (qid[:, None] == qid[None, :])
                  & (label[:, None] != label[None, :]))
    lbl_gt = label[:, None] > label[None, :]
    sc_gt = score[:, None] > score[None, :]
    sc_eq = score[:, None] == score[None, :]
    pos = torch.sum(considered & (lbl_gt == sc_gt) & ~sc_eq)
    neu = torch.sum(considered & sc_eq)
    neg = torch.sum(considered) - pos - neu

    def f(v):
        return v.reshape(1, 1).to(torch.float32)
    return {"PositivePair": [f(pos)], "NegativePair": [f(neg)],
            "NeutralPair": [f(neu)]}


@register_op("gaussian_random_batch_size_like", nondiff_inputs=("Input",),
             differentiable=False, stateful_rng=True)
def _gaussian_random_batch_size_like(ins, attrs, ctx):
    """N(mean, std²) float32 of ``shape``, its dim ``output_dim_idx``
    taken from Input's dim ``input_dim_idx``."""
    ref = ins["Input"][0]
    shape = list(attrs.get("shape"))
    shape[attrs.get("output_dim_idx", 0)] = ref.shape[
        attrs.get("input_dim_idx", 0)]
    gen = ctx.key_for(attrs.get("op_seed", attrs.get("seed", 0) or 0))
    n = torch.randn(tuple(shape), generator=gen, device=ctx.device,
                    dtype=torch.float32)
    return {"Out": [attrs.get("mean", 0.0) + attrs.get("std", 1.0) * n]}


@register_op("diag", differentiable=False)
def _diag(ins, attrs, ctx):
    return {"Out": [torch.diag(ins["Diagonal"][0].reshape(-1))]}


@register_op("lod_reset", nondiff_inputs=("Y",))
def _lod_reset(ins, attrs, ctx):
    """The data unchanged: lengths travel as explicit tensors here, so
    there is no LoD to reset (lod_reset_op.cc)."""
    return {"Out": [ins["X"][0]]}
