"""Detection lowerings (counterpart of ``paddle_tpu/ops/detection_ops.py``):
the RoI pools, anchors and priors, matching and target assignment, the
R-CNN/FPN proposal ops, RetinaNet's output, the EAST quad transform, the
deformable convolutions, ``affine_grid`` and ``sigmoid_focal_loss``.

Variable numbers of boxes are a fixed budget with a validity mask, as in
the reference.  Loops the reference writes as ``fori_loop`` (greedy
matching, NMS) are plain loops over tensor ops, run for the whole batch
at once and never read a value on the host; ties break toward the first
index, as ``jnp.argmax`` and ``lax.top_k`` do.  The gathers that carry a
gradient (the RoI pools, the deformable taps) are one-hot products or
``F.embedding``, whose gradients sum in a fixed order on the card; a
plain index's gradient adds by atomics there."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op

_NEG = -1e30
# elements of one masked max's [R, C, H, W] slab
_SLAB = 1 << 26


def _xyxy_wh(boxes):
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return w, h


def _iou(a, b):
    """a: [N, 4], b: [M, 4] -> [N, M]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.prod(torch.clamp(a[:, 2:] - a[:, :2], min=0), -1)
    area_b = torch.prod(torch.clamp(b[:, 2:] - b[:, :2], min=0), -1)
    return inter / torch.clamp(area_a[:, None] + area_b[None] - inter,
                               min=1e-10)


def _top_k(x, k):
    """``lax.top_k`` on the last axis: descending, ties to the lower
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def true_div(x, d):
    """``x / d`` for a host number ``d``, rounded once as the host and the
    reference round it: the card divides by a host scalar as a product
    with its reciprocal, one ulp away, which can move a floor or a
    threshold (a RoI bin's edge, an FPN level)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def gather_rows(table, idx):
    """``table[idx]`` for a 2-d table, by ``F.embedding``: its gradient
    adds a row's repeats in a fixed order on the card."""
    flat = table.reshape(table.shape[0], -1)
    out = F.embedding(idx.long(), flat)
    return out.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


# --- RoI pooling family ------------------------------------------------------
def _roi_masks(rois, ph, pw, spatial_scale, h, w):
    """Each RoI's bins as row and column masks: ``my [R, ph, H]``,
    ``mx [R, pw, W]`` (bin (i, j) covers ``my[i] x mx[j]``)."""
    dev, dt = rois.device, rois.dtype
    x1 = torch.round(rois[:, 0] * spatial_scale)
    y1 = torch.round(rois[:, 1] * spatial_scale)
    x2 = torch.round(rois[:, 2] * spatial_scale)
    y2 = torch.round(rois[:, 3] * spatial_scale)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    bin_h, bin_w = true_div(rh, ph), true_div(rw, pw)
    ys = torch.arange(h, dtype=dt, device=dev)
    xs = torch.arange(w, dtype=dt, device=dev)

    def edges(lo0, size, n, grid):
        i = torch.arange(n, dtype=dt, device=dev)
        lo = lo0[:, None] + size[:, None] * i
        hi = lo0[:, None] + size[:, None] * (i + 1)
        return ((grid >= torch.floor(lo)[..., None])
                & (grid < torch.ceil(hi)[..., None]))
    return edges(y1, bin_h, ph, ys), edges(x1, bin_w, pw, xs)


def _bin_counts(my, mx, dtype):
    return torch.clamp(my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :],
                       min=1).to(dtype)                     # [R, ph, pw]


def _roi_avg(x, my, mx):
    """Mean of each bin of each RoI over every channel of x [C, H, W]:
    [R, C, ph, pw], one product each way."""
    s = torch.einsum("rih,chw,rjw->rcij", my.to(x.dtype), x, mx.to(x.dtype))
    return s / _bin_counts(my, mx, x.dtype)[:, None]


def _roi_max(x, my, mx):
    """Max of each bin of each RoI over x [C, H, W], 0 for an empty bin:
    [R, C, ph, pw].  The columns' max, then the rows', over slabs of
    RoIs that bound the [R, C, H, W] temporaries."""
    c, h, w = x.shape
    r, ph, pw = my.shape[0], my.shape[1], mx.shape[1]
    step = max(1, _SLAB // max(1, c * h * w))
    outs = []
    for s in range(0, r, step):
        ms_y, ms_x = my[s:s + step], mx[s:s + step]
        cols = []
        for j in range(pw):
            t = torch.where(ms_x[:, j, None, None, :], x[None],
                            _NEG).amax(-1)                     # [r, C, H]
            cols.append(torch.where(ms_y[:, :, None, :], t[:, None],
                                    _NEG).amax(-1))            # [r, ph, C]
        outs.append(torch.stack(cols, -1).transpose(1, 2))    # [r, C, ph, pw]
    v = torch.cat(outs, 0) if outs else x.new_zeros((0, c, ph, pw))
    return torch.where(torch.isfinite(v) & (v > _NEG / 2), v,
                       torch.zeros((), dtype=v.dtype, device=v.device))


@register_op("roi_pool", nondiff_inputs=("ROIs", "RoisNum"))
def _roi_pool(ins, attrs, ctx):
    """roi_pool_op.cc: the max of each RoI bin (bins of rounded integer
    edges); the RoIs all read the batch's first image, as the
    reference's do."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    my, mx = _roi_masks(rois, ph, pw, attrs.get("spatial_scale", 1.0),
                        x.shape[2], x.shape[3])
    out = _roi_max(x[0], my, mx)
    return {"Out": [out], "Argmax": [torch.zeros(out.shape,
                                                 dtype=torch.int64,
                                                 device=out.device)]}


@register_op("psroi_pool", nondiff_inputs=("ROIs",))
def _psroi_pool(ins, attrs, ctx):
    """psroi_pool_op.cc: position-sensitive RoI average pooling; input
    channels ``C = output_channels * ph * pw``, and bin (i, j) of output
    channel o reads channel ``(o * ph + i) * pw + j``."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    oc = attrs.get("output_channels", x.shape[1] // (ph * pw))
    my, mx = _roi_masks(rois, ph, pw, attrs.get("spatial_scale", 1.0),
                        x.shape[2], x.shape[3])
    xg = x[0].reshape(oc, ph, pw, x.shape[2], x.shape[3])
    s = torch.einsum("rih,oijhw,rjw->roij", my.to(x.dtype), xg,
                     mx.to(x.dtype))
    return {"Out": [s / _bin_counts(my, mx, x.dtype)[:, None]]}


@register_op("prroi_pool", nondiff_inputs=("ROIs",))
def _prroi_pool(ins, attrs, ctx):
    """prroi_pool_op.cc, as the reference approximates it: the average
    of each bin of integer edges (exact for aligned bins)."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    my, mx = _roi_masks(rois, ph, pw, attrs.get("spatial_scale", 1.0),
                        x.shape[2], x.shape[3])
    return {"Out": [_roi_avg(x[0], my, mx)]}


# --- anchors / priors --------------------------------------------------------
@register_op("anchor_generator", differentiable=False)
def _anchor_generator(ins, attrs, ctx):
    """anchor_generator_op.cc: anchors [H, W, A, 4] over the feature
    map's grid, A = ratios x sizes (ratio-major)."""
    x = ins["Input"][0]
    sizes = attrs.get("anchor_sizes", [64.0, 128.0, 256.0, 512.0])
    ratios = attrs.get("aspect_ratios", [0.5, 1.0, 2.0])
    stride = attrs.get("stride", [16.0, 16.0])
    offset = attrs.get("offset", 0.5)
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    h, w = x.shape[-2], x.shape[-1]
    dev = x.device
    cx = (torch.arange(w, device=dev) + offset) * stride[0]
    cy = (torch.arange(h, device=dev) + offset) * stride[1]
    anchors = []
    for r in ratios:
        for s in sizes:
            aw = s * (r ** 0.5)
            ah = s / (r ** 0.5)
            anchors.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
    base = torch.tensor(anchors, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(cy.float(), cx.float(), indexing="ij")
    grid = torch.stack([gx, gy], -1)
    shift = torch.cat([grid, grid], -1)
    out = shift[:, :, None, :] + base[None, None]
    var = torch.tensor(variances, dtype=torch.float32,
                       device=dev).expand(out.shape)
    return {"Anchors": [out], "Variances": [var]}


@register_op("density_prior_box", differentiable=False)
def _density_prior_box(ins, attrs, ctx):
    """density_prior_box_op.cc: SSD priors [H, W, P, 4] where each fixed
    size spawns density² shifted boxes a cell, clipped to [0, 1]."""
    x, img = ins["Input"][0], ins["Image"][0]
    fixed_sizes = attrs.get("fixed_sizes", [])
    fixed_ratios = attrs.get("fixed_ratios", [1.0])
    densities = attrs.get("densities", [1] * len(fixed_sizes))
    step_w = attrs.get("step_w", 0.0)
    step_h = attrs.get("step_h", 0.0)
    offset = attrs.get("offset", 0.5)
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    h, w = x.shape[-2], x.shape[-1]
    ih, iw = img.shape[-2], img.shape[-1]
    sw = step_w or iw / w
    sh = step_h or ih / h
    boxes = []
    for size, dens in zip(fixed_sizes, densities):
        for ratio in fixed_ratios:
            bw = size * (ratio ** 0.5)
            bh = size / (ratio ** 0.5)
            shift = size / dens
            for di in range(dens):
                for dj in range(dens):
                    ox = (dj + 0.5) * shift - size / 2
                    oy = (di + 0.5) * shift - size / 2
                    boxes.append((ox, oy, bw, bh))
    dev = x.device
    cx = ((torch.arange(w, device=dev) + offset) * sw).float()
    cy = ((torch.arange(h, device=dev) + offset) * sh).float()
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    prior = [torch.stack([true_div(gx + ox - bw / 2, iw),
                          true_div(gy + oy - bh / 2, ih),
                          true_div(gx + ox + bw / 2, iw),
                          true_div(gy + oy + bh / 2, ih)], -1)
             for ox, oy, bw, bh in boxes]
    out = torch.clamp(torch.stack(prior, 2), 0.0, 1.0)
    var = torch.tensor(variances, dtype=torch.float32,
                       device=dev).expand(out.shape)
    return {"Boxes": [out], "Variances": [var]}


# --- matching / assignment ---------------------------------------------------
def greedy_match(dist):
    """bipartite_match's greedy pass over [B, N, M]: min(N, M) times,
    the largest positive entry of each image's matrix matches its column
    to its row, and both are struck out.  Returns (match [B, M] int64,
    -1 unmatched; its distances)."""
    b, n, m = dist.shape
    dev = dist.device
    match = torch.full((b, m), -1, dtype=torch.int64, device=dev)
    md = torch.zeros((b, m), dtype=dist.dtype, device=dev)
    dd = dist
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    for _ in range(min(n, m)):
        flat = torch.argmax(dd.reshape(b, -1), 1)
        r, c = flat // m, flat % m
        val = dd.reshape(b, -1).gather(1, flat[:, None])[:, 0]
        ok = val > 0
        hit = ok[:, None] & (cols[None] == c[:, None])
        match = torch.where(hit, r[:, None], match)
        md = torch.where(hit, val[:, None], md)
        strike = ((rows[None, :, None] == r[:, None, None])
                  | (cols[None, None, :] == c[:, None, None]))
        dd = torch.where(ok[:, None, None] & strike,
                         torch.full((), -1.0, dtype=dd.dtype, device=dev), dd)
    return match, md


@register_op("bipartite_match", differentiable=False)
def _bipartite_match(ins, attrs, ctx):
    """bipartite_match_op.cc: the greedy matching of columns (priors) to
    rows (ground truth), then with ``per_prediction`` each unmatched
    column whose best row reaches ``dist_threshold`` takes it."""
    dist = ins["DistMat"][0]
    if dist.dim() == 2:
        dist = dist[None]
    match, md = greedy_match(dist)
    if attrs.get("match_type", "bipartite") == "per_prediction":
        col_best = torch.argmax(dist, 1)
        col_val = dist.amax(1)
        fill = (match < 0) & (col_val >= attrs.get("dist_threshold", 0.5))
        match = torch.where(fill, col_best, match)
        md = torch.where(fill, col_val, md)
    return {"ColToRowMatchIndices": [match], "ColToRowMatchDist": [md]}


@register_op("target_assign", nondiff_inputs=("MatchIndices", "NegIndices"),
             differentiable=False)
def _target_assign(ins, attrs, ctx):
    """target_assign_op.cc: each prior's target gathered by its match
    index, ``mismatch_value`` and weight 0 where unmatched, weight 1
    where matched."""
    x = ins["X"][0]                                       # [B, N, K]
    match = ins["MatchIndices"][0].long()                 # [B, M]
    safe = torch.clamp(match, min=0)
    out = torch.gather(x, 1, safe[..., None].expand(-1, -1, x.shape[2]))
    matched = (match >= 0)[..., None]
    fill = torch.tensor(attrs.get("mismatch_value", 0), dtype=x.dtype,
                        device=x.device)
    out = torch.where(matched, out, fill)
    return {"Out": [out], "OutWeight": [matched.to(x.dtype)]}


@register_op("rpn_target_assign", differentiable=False, stateful_rng=True)
def _rpn_target_assign(ins, attrs, ctx):
    """rpn_target_assign_op.cc as the reference keeps it: every anchor
    labelled by its best IoU (1 at ``rpn_positive_overlap`` or more, 0
    under ``rpn_negative_overlap``, -1 between), each ground truth's best
    anchor 1; no budget is sampled (the reference reads neither
    ``rpn_batch_size_per_im`` nor its seed), per-anchor outputs."""
    anchor = ins["Anchor"][0].reshape(-1, 4)
    gt = ins["GtBoxes"][0].reshape(-1, 4)
    iou = _iou(anchor, gt)                                  # [A, G]
    best = iou.amax(1)
    argbest = torch.argmax(iou, 1)
    one = torch.ones((), dtype=torch.int64, device=anchor.device)
    label = torch.where(best >= attrs.get("rpn_positive_overlap", 0.7), one,
                        torch.where(best < attrs.get("rpn_negative_overlap",
                                                     0.3), 0 * one, -one))
    label = label.index_fill(0, torch.argmax(iou, 0), 1)
    pos = (label == 1)
    return {"LocationIndex": [pos.long()],
            "ScoreIndex": [(label >= 0).long()],
            "TargetLabel": [label],
            "TargetBBox": [gt[argbest]],
            "BBoxInsideWeight": [pos.to(anchor.dtype)[:, None].expand(-1, 4)
                                 .contiguous()]}


def _decode_anchor_deltas(anchors, deltas):
    aw, ah = _xyxy_wh(anchors)
    cx = anchors[..., 0] + aw / 2 + deltas[..., 0] * aw
    cy = anchors[..., 1] + ah / 2 + deltas[..., 1] * ah
    w = aw * torch.exp(torch.clamp(deltas[..., 2], max=4.0))
    h = ah * torch.exp(torch.clamp(deltas[..., 3], max=4.0))
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def greedy_nms(boxes, scores, keep_n, thresh):
    """``keep_n`` rounds of greedy NMS over [B, N] scores sorted high to
    low: each round keeps the best unsuppressed box (the first box once
    all are suppressed, as ``jnp.argmax`` of a constant row) and
    suppresses what overlaps it past ``thresh``.  Returns the kept
    indices [B, keep_n]."""
    b, n = scores.shape
    iou = torch.stack([_iou(bx, bx) for bx in boxes])       # [B, N, N]
    sup = torch.zeros((b, n), dtype=torch.bool, device=scores.device)
    batch = torch.arange(b, device=scores.device)
    neg = torch.full((), _NEG, dtype=scores.dtype, device=scores.device)
    keep = []
    for _ in range(keep_n):
        j = torch.argmax(torch.where(sup, neg, scores), 1)
        keep.append(j)
        sup = sup | (iou[batch, j] > thresh)
        sup[batch, j] = True
    return torch.stack(keep, 1) if keep else \
        torch.zeros((b, 0), dtype=torch.int64, device=scores.device)


@register_op("generate_proposals", differentiable=False)
def _generate_proposals(ins, attrs, ctx):
    """generate_proposals_op.cc as the reference keeps it: the
    ``pre_nms_topN`` best scores' anchors decoded (``exp`` capped at 4),
    clipped at 0 when ``ImInfo`` is given, then ``post_nms_topN`` rounds
    of greedy NMS.  Scores and deltas are read (A, H, W)-major and the
    anchors as given."""
    scores = ins["Scores"][0]                     # [B, A, H, W]
    deltas = ins["BboxDeltas"][0]                 # [B, A*4, H, W]
    anchors = ins["Anchors"][0].reshape(-1, 4)
    b = scores.shape[0]
    sc = scores.reshape(b, -1)
    dl = deltas.reshape(b, -1, 4, deltas.shape[-2], deltas.shape[-1])
    dl = torch.movedim(dl, 2, -1).reshape(b, -1, 4)
    n = min(attrs.get("pre_nms_topN", 6000), sc.shape[1])
    top_s, top_i = _top_k(sc, n)
    boxes = _decode_anchor_deltas(anchors[top_i],
                                  torch.gather(dl, 1, top_i[..., None]
                                               .expand(-1, -1, 4)))
    if ins.get("ImInfo"):
        boxes = torch.clamp(boxes, min=0.0)
    keep = greedy_nms(boxes, top_s, min(attrs.get("post_nms_topN", 1000), n),
                      attrs.get("nms_thresh", 0.7))
    kept = torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4))
    probs = torch.gather(top_s, 1, keep)
    return {"RpnRois": [kept], "RpnRoiProbs": [probs[..., None]],
            "RpnRoisNum": [torch.full((b,), kept.shape[1], dtype=torch.int64,
                                      device=scores.device)]}


@register_op("distribute_fpn_proposals", differentiable=False)
def _distribute_fpn_proposals(ins, attrs, ctx):
    """distribute_fpn_proposals_op.cc: each RoI's FPN level from its
    scale; a copy of the RoIs a level with the rows of other levels
    zeroed, ``RestoreIndex`` and the count a level."""
    rois = ins["FpnRois"][0]
    min_level = attrs.get("min_level", 2)
    max_level = attrs.get("max_level", 5)
    w, h = _xyxy_wh(rois)
    scale = torch.sqrt(torch.clamp(w * h, min=1e-6))
    lvl = torch.floor(attrs.get("refer_level", 4) + torch.log2(
        true_div(scale, attrs.get("refer_scale", 224)) + 1e-6))
    lvl = torch.clamp(lvl, min_level, max_level).long()
    levels = range(min_level, max_level + 1)
    order = torch.argsort(torch.argsort(lvl, stable=True), stable=True)
    return {"MultiFpnRois": [rois * (lvl == l).to(rois.dtype)[:, None]
                             for l in levels],
            "RestoreIndex": [order[:, None]],
            "MultiLevelRoIsNum": [torch.stack([(lvl == l).sum()
                                               for l in levels])]}


@register_op("collect_fpn_proposals", differentiable=False)
def _collect_fpn_proposals(ins, attrs, ctx):
    """collect_fpn_proposals_op.cc: the levels' RoIs merged, the best
    ``post_nms_topN`` by score kept."""
    rois = torch.cat(list(ins["MultiLevelRois"]), 0)
    scores = torch.cat([s.reshape(-1) for s in ins["MultiLevelScores"]], 0)
    n = min(attrs.get("post_nms_topN", 1000), scores.shape[0])
    _, top_i = _top_k(scores, n)
    return {"FpnRois": [rois[top_i]],
            "RoisNum": [torch.tensor([n], dtype=torch.int64,
                                     device=rois.device)]}


# --- losses / outputs --------------------------------------------------------
@register_op("sigmoid_focal_loss", nondiff_inputs=("Label", "FgNum"))
def _sigmoid_focal_loss(ins, attrs, ctx):
    """``-α (1 - p)^γ log p`` one class against the rest (label ``c`` in
    [0, C], 0 the background, -1 a row left out), over ``max(FgNum,
    1)``."""
    x = ins["X"][0]
    label = ins["Label"][0].to(torch.int64).reshape(-1)
    fg = (ins["FgNum"][0].reshape(()).to(x.dtype) if ins.get("FgNum")
          else torch.ones((), dtype=x.dtype, device=x.device))
    gamma = attrs.get("gamma", 2.0)
    alpha = attrs.get("alpha", 0.25)
    c = x.shape[1]
    target = label[:, None] == (torch.arange(c, device=x.device) + 1)[None]
    valid = (label[:, None] != -1).to(x.dtype)
    p = torch.sigmoid(x)
    pt = torch.where(target, p, 1 - p)
    at = torch.where(target, alpha, 1 - alpha)
    bce = -torch.where(target, F.logsigmoid(x), F.logsigmoid(-x))
    loss = valid * at * ((1 - pt) ** gamma) * bce / torch.clamp(fg, min=1.0)
    return {"Out": [loss]}


@register_op("retinanet_detection_output", differentiable=False)
def _retinanet_detection_output(ins, attrs, ctx):
    """retinanet_detection_output_op.cc as the reference keeps it: the
    levels merged, each box's best class, the best ``keep_top_k`` past
    ``score_threshold`` as rows [class, score, x1, y1, x2, y2] (no
    NMS)."""
    bboxes = torch.cat([b.reshape(b.shape[0], -1, 4) for b in ins["BBoxes"]],
                       1)
    scores = torch.cat([s.reshape(s.shape[0], -1, s.shape[-1])
                        for s in ins["Scores"]], 1)
    best_s, best_c = scores.amax(-1), torch.argmax(scores, -1)
    k = min(attrs.get("keep_top_k", 100), best_s.shape[1])
    top_s, top_i = _top_k(torch.where(
        best_s > attrs.get("score_threshold", 0.05), best_s,
        torch.full((), _NEG, dtype=best_s.dtype, device=best_s.device)), k)
    cls = torch.gather(best_c, 1, top_i).to(bboxes.dtype)
    box = torch.gather(bboxes, 1, top_i[..., None].expand(-1, -1, 4))
    return {"Out": [torch.cat([cls[..., None], top_s[..., None], box], -1)]}


@register_op("polygon_box_transform", differentiable=False)
def _polygon_box_transform(ins, attrs, ctx):
    """polygon_box_transform_op.cc (EAST): offsets to absolute quad
    corners, ``4 x - in`` on even planes and ``4 y - in`` on odd, the
    plane's parity that of ``batch * C + channel``."""
    x = ins["Input"][0]
    b, c, h, w = x.shape
    gx = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None] \
        * 4.0
    gy = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :,
                                                         None] * 4.0
    plane = (torch.arange(b, device=x.device)[:, None] * c
             + torch.arange(c, device=x.device)[None])
    even = (plane % 2 == 0)[:, :, None, None]
    return {"Output": [torch.where(even, gx, gy) - x]}


# --- deformable conv / grids -------------------------------------------------
@register_op("deformable_conv", nondiff_inputs=("Offset", "Mask"))
def _deformable_conv(ins, attrs, ctx):
    """deformable_conv_op.cc (v2, with the modulation Mask) as the
    reference keeps it: each kernel tap samples the zero-padded input
    bilinearly at its offset (corners clipped into the padded map, the
    fractions into [0, 1]), then one contraction with the filter; groups,
    dilations and deformable groups are not read.  The taps are
    ``F.embedding`` rows of the padded map."""
    x = ins["Input"][0]                     # [B, C, H, W]
    offset = ins["Offset"][0]               # [B, 2 kh kw, H, W]
    w = ins["Filter"][0]                    # [O, C, kh, kw]
    mask = ins["Mask"][0] if ins.get("Mask") else None
    stride = attrs.get("strides", [1, 1])
    pad = attrs.get("paddings", [0, 0])
    b, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    oh = (h + 2 * pad[0] - kh) // stride[0] + 1
    ow = (wd + 2 * pad[1] - kw) // stride[1] + 1
    xp = F.pad(x, (pad[1], pad[1], pad[0], pad[0]))
    ph, pw = xp.shape[2], xp.shape[3]
    table = xp.permute(0, 2, 3, 1).reshape(b * ph * pw, c)
    base = (torch.arange(b, device=x.device) * (ph * pw))[:, None, None]
    oy = (torch.arange(oh, device=x.device) * stride[0])[None, :, None]
    ox = (torch.arange(ow, device=x.device) * stride[1])[None, None, :]
    cols = []
    for ki in range(kh):
        for kj in range(kw):
            t = ki * kw + kj
            yy = oy + ki + offset[:, 2 * t, :oh, :ow]
            xx = ox + kj + offset[:, 2 * t + 1, :oh, :ow]
            y0 = torch.clamp(torch.floor(yy), 0, ph - 2).long()
            x0 = torch.clamp(torch.floor(xx), 0, pw - 2).long()
            fy = torch.clamp(yy - y0, 0.0, 1.0)[..., None]
            fx = torch.clamp(xx - x0, 0.0, 1.0)[..., None]

            def tap(yi, xi):
                return gather_rows(table, base + yi * pw + xi)  # [B,oh,ow,C]
            v = (tap(y0, x0) * ((1 - fy) * (1 - fx))
                 + tap(y0, x0 + 1) * ((1 - fy) * fx)
                 + tap(y0 + 1, x0) * (fy * (1 - fx))
                 + tap(y0 + 1, x0 + 1) * (fy * fx))
            if mask is not None:
                v = v * mask[:, t, :oh, :ow][..., None]
            cols.append(v)
    col = torch.stack(cols, 3)              # [B, oh, ow, K, C]
    out = torch.einsum("bhwkc,ock->bohw", col, w.reshape(o, cg, kh * kw))
    return {"Output": [out.to(x.dtype)]}


@register_op("deformable_conv_v1", nondiff_inputs=("Offset",))
def _deformable_conv_v1(ins, attrs, ctx):
    ins = dict(ins)
    ins.pop("Mask", None)
    return _deformable_conv(ins, attrs, ctx)


@register_op("affine_grid")
def _affine_grid(ins, attrs, ctx):
    """``Theta [B, 2, 3]`` to the grid ``[B, H, W, 2]`` of the points
    ``theta · (x, y, 1)`` over [-1, 1]², corners aligned; the shape from
    ``output_shape`` or the ``OutputShape`` input."""
    theta = ins["Theta"][0]
    shape = attrs.get("output_shape", None)
    if shape is None and ins.get("OutputShape"):
        shape = [int(v) for v in ins["OutputShape"][0].reshape(-1).tolist()]
    _, _, h, w = shape
    ys = torch.linspace(-1.0, 1.0, h, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, w, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return {"Output": [torch.einsum("hwk,bak->bhwa", base.to(theta.dtype),
                                    theta)]}
