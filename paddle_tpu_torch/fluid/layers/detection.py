"""Detection layers (counterpart of ``paddle_tpu/fluid/layers/detection.py``):
the lowerings of ``iou_similarity``, ``prior_box``, ``box_coder``,
``yolo_box`` and ``roi_align`` (``multiclass_nms`` and ``multiclass_nms2``
raise, as the reference's do: their outputs' shapes depend on the data),
and the builders of the reference's ``__all__``, each the reference's
composition op for op, quirks included (ROADMAP queue C)."""
from __future__ import annotations

import numpy as np
import torch

from ...ops.detection_ops import true_div
from ...ops.registry import register_op
from ..framework import in_dygraph_mode
from ..layer_helper import LayerHelper

__all__ = ["yolo_box", "prior_box", "box_coder", "iou_similarity",
           "roi_align", "roi_pool", "multiclass_nms",
           "density_prior_box", "anchor_generator", "bipartite_match",
           "target_assign", "sigmoid_focal_loss", "rpn_target_assign",
           "retinanet_target_assign", "generate_proposals",
           "generate_proposal_labels", "generate_mask_labels",
           "polygon_box_transform", "yolov3_loss", "box_clip",
           "matrix_nms", "locality_aware_nms",
           "retinanet_detection_output", "distribute_fpn_proposals",
           "collect_fpn_proposals", "box_decoder_and_assign",
           "roi_perspective_transform", "deformable_roi_pooling",
           "detection_output", "ssd_loss", "multi_box_head"]


@register_op("iou_similarity", nondiff_inputs=("Y",))
def _iou_similarity(ins, attrs, ctx):
    """IoU of X [N, 4] against Y [M, 4] (corner boxes): [N, M]; 2-d
    only, as the reference's."""
    x, y = ins["X"][0], ins["Y"][0]
    area_x = (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    area_y = (y[:, 2] - y[:, 0]) * (y[:, 3] - y[:, 1])
    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return {"Out": [inter / (area_x[:, None] + area_y[None, :] - inter
                             + 1e-10)]}


@register_op("prior_box", differentiable=False)
def _prior_box(ins, attrs, ctx):
    """SSD priors [H, W, P, 4] over the feature map, normalised by the
    image's size: for each min size its ``aspect_ratios`` (with their
    inverses under ``flip``; 1.0 only when given), then the max size's
    square.  Every box is clipped to [0, 1], whatever ``clip`` says."""
    feat, img = ins["Input"][0], ins["Image"][0]
    min_sizes = attrs["min_sizes"]
    max_sizes = attrs.get("max_sizes", [])
    flip = attrs.get("flip", False)
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    offset = attrs.get("offset", 0.5)
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    sw = attrs.get("step_w", 0.0) or iw / fw
    sh = attrs.get("step_h", 0.0) or ih / fh
    ars = []
    for r in attrs.get("aspect_ratios", [1.0]):
        ars.append(r)
        if flip and abs(r - 1.0) > 1e-6:
            ars.append(1.0 / r)
    boxes = []
    for ms_i, ms in enumerate(min_sizes):
        for ar in ars:
            boxes.append((float(ms * np.sqrt(ar)), float(ms / np.sqrt(ar))))
        if ms_i < len(max_sizes):
            s = float(np.sqrt(ms * max_sizes[ms_i]))
            boxes.append((s, s))
    dev = feat.device
    cx = ((torch.arange(fw, device=dev) + offset) * sw).float()
    cy = ((torch.arange(fh, device=dev) + offset) * sh).float()
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    out = torch.stack([torch.stack([true_div(cxg - bw / 2, iw),
                                    true_div(cyg - bh / 2, ih),
                                    true_div(cxg + bw / 2, iw),
                                    true_div(cyg + bh / 2, ih)], -1)
                       for bw, bh in boxes], 2)
    out = torch.clamp(out, 0.0, 1.0)
    var = torch.tensor(variances, dtype=torch.float32,
                       device=dev).expand(out.shape)
    return {"Boxes": [out], "Variances": [var]}


@register_op("box_coder", nondiff_inputs=("PriorBox", "PriorBoxVar"))
def _box_coder(ins, attrs, ctx):
    """box_coder_op.h: ``encode_center_size`` gives [N, M, 4] offsets of
    each target against each prior (over the variances when given);
    decoding takes the targets' offsets back to corners.  Boxes in pixels
    (``box_normalized`` false) are inclusive: widths +1, decoded maxima
    -1; the target's centre is its plain midpoint."""
    prior = ins["PriorBox"][0]
    pvar = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") else None
    target = ins["TargetBox"][0]
    off = 0.0 if attrs.get("box_normalized", True) else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2
    if "encode" in attrs.get("code_type", "encode_center_size"):
        tw = target[:, 2] - target[:, 0] + off
        th = target[:, 3] - target[:, 1] + off
        tcx = (target[:, 0] + target[:, 2]) / 2
        tcy = (target[:, 1] + target[:, 3]) / 2
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(tw[:, None] / pw[None, :])
        dh = torch.log(th[:, None] / ph[None, :])
        out = torch.stack([dx, dy, dw, dh], -1)
        if pvar is not None:
            out = out / pvar[None, :, :]
    else:
        d = target
        if pvar is not None:
            d = d * pvar[None, :, :] if d.dim() == 3 else d * pvar
        cx = d[..., 0] * pw + pcx
        cy = d[..., 1] * ph + pcy
        w = torch.exp(d[..., 2]) * pw
        h = torch.exp(d[..., 3]) * ph
        out = torch.stack([cx - w / 2, cy - h / 2,
                           cx + w / 2 - off, cy + h / 2 - off], -1)
    return {"OutputBox": [out]}


@register_op("yolo_box", nondiff_inputs=("ImgSize",))
def _yolo_box(ins, attrs, ctx):
    """yolo_box_op: the head's [N, A (5 + C), H, W] decoded to boxes
    [N, A H W, 4] in the image's pixels and scores [N, A H W, C] (class
    times objectness, 0 where the objectness is under
    ``conf_thresh``)."""
    x, img_size = ins["X"][0], ins["ImgSize"][0]
    anchors = attrs["anchors"]
    class_num = attrs["class_num"]
    down = attrs.get("downsample_ratio", 32)
    n, _, h, w = x.shape
    na = len(anchors) // 2
    x = x.reshape(n, na, 5 + class_num, h, w)
    dev = x.device
    gx = torch.arange(w, device=dev).reshape(1, 1, 1, w)
    gy = torch.arange(h, device=dev).reshape(1, 1, h, 1)
    aw = torch.tensor(anchors[0::2], dtype=torch.float32,
                      device=dev).reshape(1, na, 1, 1)
    ah = torch.tensor(anchors[1::2], dtype=torch.float32,
                      device=dev).reshape(1, na, 1, 1)
    bx = (torch.sigmoid(x[:, :, 0]) + gx) / w
    by = (torch.sigmoid(x[:, :, 1]) + gy) / h
    bw = torch.exp(x[:, :, 2]) * aw / (w * down)
    bh = torch.exp(x[:, :, 3]) * ah / (h * down)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    imgh = img_size[:, 0].reshape(n, 1, 1, 1).float()
    imgw = img_size[:, 1].reshape(n, 1, 1, 1).float()
    boxes = torch.stack([(bx - bw / 2) * imgw, (by - bh / 2) * imgh,
                         (bx + bw / 2) * imgw, (by + bh / 2) * imgh], -1)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    mask = (conf.reshape(n, -1, 1) >= attrs.get("conf_thresh", 0.01)) \
        .to(scores.dtype)
    return {"Boxes": [boxes.reshape(n, -1, 4)], "Scores": [scores * mask]}


def _bilinear_rows(pos, size):
    """The bilinear weights [..., size] of sample positions ``pos``,
    corners clipped into [0, size - 1] and the fraction read against the
    clipped corner, as the reference's ``roi_align`` reads them."""
    p0 = torch.clamp(torch.floor(pos).long(), 0, size - 1)
    p1 = torch.clamp(p0 + 1, 0, size - 1)
    frac = (pos - p0)[..., None]
    eye = torch.arange(size, device=pos.device)
    return ((1 - frac) * (eye == p0[..., None])
            + frac * (eye == p1[..., None]))


@register_op("roi_align", nondiff_inputs=("ROIs",))
def _roi_align(ins, attrs, ctx):
    """roi_align_op as the reference keeps it: ``sampling_ratio`` ²
    bilinear samples a bin (2 when it is not positive), averaged; the
    RoIs all read the batch's first image.  Bilinear sampling separates
    by axis, so the pool is two products with the samples' averaged
    one-hot weights (a fixed-order gradient on the card)."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    ratio = attrs.get("sampling_ratio", 2)
    if ratio <= 0:
        ratio = 2
    _, _, h, w = x.shape
    r = rois * attrs.get("spatial_scale", 1.0)
    dev, dt = x.device, x.dtype
    sub = (true_div(torch.arange(ratio, device=dev, dtype=dt), ratio) - 0.5
           + 0.5 / ratio)[None, None, :]

    def axis_weights(lo, hi, n, size):
        span = torch.clamp(hi - lo, min=1.0)
        step = true_div(span, n)[:, None, None]
        pos = lo[:, None, None] + (torch.arange(
            n, device=dev, dtype=dt)[None, :, None] + 0.5) * step + sub * step
        return _bilinear_rows(pos, size).to(dt).mean(2)     # [R, n, size]
    ay = axis_weights(r[:, 1], r[:, 3], ph, h)
    ax = axis_weights(r[:, 0], r[:, 2], pw, w)
    return {"Out": [torch.einsum("rih,chw,rjw->rcij", ay, x[0], ax)]}


@register_op("multiclass_nms", differentiable=False)
def _multiclass_nms(ins, attrs, ctx):
    raise NotImplementedError(
        "multiclass_nms has dynamic output shape; use "
        "paddle_tpu_torch.vision.ops.batched_nms (fixed-k), or matrix_nms")


@register_op("multiclass_nms2", differentiable=False)
def _multiclass_nms2(ins, attrs, ctx):
    raise NotImplementedError(
        "multiclass_nms2 has dynamic output shape; use "
        "paddle_tpu_torch.vision.ops.batched_nms (fixed-k), or matrix_nms")


def _layer2(op_type, in_map, out_slots, attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    outs = {s: [helper.create_variable_for_type_inference(dtype="float32")]
            for s in out_slots}
    op = helper.append_op(op_type, inputs=in_map, outputs=outs, attrs=attrs)
    if in_dygraph_mode():
        vals = [op[s][0] for s in out_slots]
    else:
        vals = [outs[s][0] for s in out_slots]
    return vals[0] if len(vals) == 1 else tuple(vals)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, name=None):
    return _layer2("yolo_box", {"X": [x], "ImgSize": [img_size]},
                   ["Boxes", "Scores"],
                   {"anchors": list(anchors), "class_num": class_num,
                    "conf_thresh": conf_thresh,
                    "downsample_ratio": downsample_ratio}, name)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=[1.],
              variance=[0.1, 0.1, 0.2, 0.2], flip=False, clip=False,
              steps=[0.0, 0.0], offset=0.5, name=None):
    return _layer2("prior_box", {"Input": [input], "Image": [image]},
                   ["Boxes", "Variances"],
                   {"min_sizes": list(min_sizes),
                    "max_sizes": list(max_sizes or []),
                    "aspect_ratios": list(aspect_ratios),
                    "variances": list(variance), "flip": flip,
                    "step_w": steps[0], "step_h": steps[1],
                    "offset": offset}, name)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    ins = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    return _layer2("box_coder", ins, ["OutputBox"],
                   {"code_type": code_type, "axis": axis,
                    "box_normalized": box_normalized}, name)


def iou_similarity(x, y, name=None):
    return _layer2("iou_similarity", {"X": [x], "Y": [y]}, ["Out"], {}, name)


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None):
    return _layer2("roi_align", {"X": [input], "ROIs": [rois]}, ["Out"],
                   {"pooled_height": pooled_height,
                    "pooled_width": pooled_width,
                    "spatial_scale": spatial_scale,
                    "sampling_ratio": sampling_ratio}, name)


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    return roi_align(input, rois, pooled_height, pooled_width, spatial_scale)


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None):
    return _layer2("multiclass_nms", {"BBoxes": [bboxes], "Scores": [scores]},
                   ["Out"],
                   {"score_threshold": score_threshold,
                    "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                    "nms_threshold": nms_threshold}, name)


# --- the rest of __all__ -----------------------------------------------------
def _det_op(op_type, ins, out_slots, **attrs):
    helper = LayerHelper(op_type)
    outs = {s: [helper.create_variable_for_type_inference()]
            for s in out_slots}
    op = helper.append_op(op_type, inputs=ins, outputs=outs, attrs=attrs)
    got = op if in_dygraph_mode() else outs
    vals = tuple(got[s][0] for s in out_slots)
    return vals if len(vals) > 1 else vals[0]


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5,
                      flatten_to_2d=False, name=None):
    return _det_op("density_prior_box",
                   {"Input": [input], "Image": [image]},
                   ("Boxes", "Variances"),
                   densities=list(densities or []),
                   fixed_sizes=list(fixed_sizes or []),
                   fixed_ratios=list(fixed_ratios or []),
                   variances=list(variance), clip=clip,
                   steps=list(steps), offset=offset,
                   flatten_to_2d=flatten_to_2d)


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None,
                     offset=0.5, name=None):
    return _det_op("anchor_generator", {"Input": [input]},
                   ("Anchors", "Variances"),
                   anchor_sizes=list(anchor_sizes or [64.0]),
                   aspect_ratios=list(aspect_ratios or [1.0]),
                   variances=list(variance),
                   stride=list(stride or [16.0, 16.0]), offset=offset)


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    return _det_op("bipartite_match", {"DistMat": [dist_matrix]},
                   ("ColToRowMatchIndices", "ColToRowMatchDist"),
                   match_type=match_type or "bipartite",
                   dist_threshold=dist_threshold or 0.5)


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    from . import nn as _nn
    if len(input.shape) == 2:
        # LoD-era unbatched gt: the padded design batches it ([1, N, K])
        input = _nn.unsqueeze(input, [0])
    ins = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        ins["NegIndices"] = [negative_indices]
    return _det_op("target_assign", ins, ("Out", "OutWeight"),
                   mismatch_value=mismatch_value or 0)


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    return _det_op("sigmoid_focal_loss",
                   {"X": [x], "Label": [label], "FgNum": [fg_num]},
                   ("Out",), gamma=gamma, alpha=alpha)


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    outs = _det_op("rpn_target_assign",
                   {"Anchor": [anchor_box], "GtBoxes": [gt_boxes]},
                   ("LocationIndex", "ScoreIndex", "TargetBBox",
                    "TargetLabel", "BBoxInsideWeight"),
                   rpn_batch_size_per_im=rpn_batch_size_per_im,
                   rpn_positive_overlap=rpn_positive_overlap,
                   rpn_negative_overlap=rpn_negative_overlap)
    return outs


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd=None,
                            im_info=None, num_classes=1,
                            positive_overlap=0.5, negative_overlap=0.4):
    """Reference retinanet_target_assign: same matcher as RPN but takes
    gt_labels positionally and ALSO returns fg_num (6 outputs)."""
    loc_i, score_i, tgt_bbox, tgt_lbl, in_w = rpn_target_assign(
        bbox_pred, cls_logits, anchor_box, anchor_var, gt_boxes,
        is_crowd, im_info, rpn_positive_overlap=positive_overlap,
        rpn_negative_overlap=negative_overlap)
    fg_num = _nn_shape_sum(tgt_lbl)
    return score_i, loc_i, tgt_lbl, tgt_bbox, in_w, fg_num


def _nn_shape_sum(lbl):
    from . import nn as _n
    from .control_flow import greater_than
    from .tensor import fill_constant
    # fg_num = count of positive labels (+1 as the reference does to
    # avoid div-by-zero in the focal-loss normalizer)
    pos = _n.cast(greater_than(_n.cast(lbl, "float32"),
                               fill_constant([1], "float32", 0.0)),
                  "int32")
    return _n.reduce_sum(pos) + 1


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=False, name=None):
    outs = _det_op("generate_proposals",
                   {"Scores": [scores], "BboxDeltas": [bbox_deltas],
                    "ImInfo": [im_info], "Anchors": [anchors],
                    "Variances": [variances]},
                   ("RpnRois", "RpnRoiProbs", "RpnRoisNum"),
                   pre_nms_topN=pre_nms_top_n,
                   post_nms_topN=post_nms_top_n,
                   nms_thresh=nms_thresh, min_size=min_size, eta=eta)
    if return_rois_num:
        return outs
    return outs[0], outs[1]


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, **kw):
    return _det_op("generate_proposal_labels",
                   {"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
                    "IsCrowd": [is_crowd], "GtBoxes": [gt_boxes],
                    "ImInfo": [im_info]},
                   ("Rois", "LabelsInt32", "BboxTargets",
                    "BboxInsideWeights", "BboxOutsideWeights"),
                   batch_size_per_im=batch_size_per_im,
                   fg_fraction=fg_fraction, fg_thresh=fg_thresh,
                   bg_thresh_hi=bg_thresh_hi, bg_thresh_lo=bg_thresh_lo,
                   class_nums=class_nums or 81)


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution):
    return _det_op("generate_mask_labels",
                   {"ImInfo": [im_info], "GtClasses": [gt_classes],
                    "IsCrowd": [is_crowd], "GtSegms": [gt_segms],
                    "Rois": [rois], "LabelsInt32": [labels_int32]},
                   ("MaskRois", "RoiHasMaskInt32", "MaskInt32"),
                   num_classes=num_classes, resolution=resolution)


def polygon_box_transform(input, name=None):
    return _det_op("polygon_box_transform", {"Input": [input]},
                   ("Output",))


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    ins = {"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]}
    if gt_score is not None:
        ins["GTScore"] = [gt_score]
    return _det_op("yolov3_loss", ins, ("Loss",),
                   anchors=list(anchors), anchor_mask=list(anchor_mask),
                   class_num=class_num, ignore_thresh=ignore_thresh,
                   downsample_ratio=downsample_ratio,
                   use_label_smooth=use_label_smooth)


def box_clip(input, im_info, name=None):
    return _det_op("box_clip", {"Input": [input], "ImInfo": [im_info]},
                   ("Output",))


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    outs = _det_op("matrix_nms",
                   {"BBoxes": [bboxes], "Scores": [scores]},
                   ("Out", "Index", "RoisNum"),
                   score_threshold=score_threshold,
                   post_threshold=post_threshold, nms_top_k=nms_top_k,
                   keep_top_k=keep_top_k, use_gaussian=use_gaussian,
                   gaussian_sigma=gaussian_sigma,
                   background_label=background_label,
                   normalized=normalized)
    out, index, rois_num = outs
    res = [out]
    if return_index:
        res.append(index)
    if return_rois_num:
        res.append(rois_num)
    return tuple(res) if len(res) > 1 else res[0]


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    return _det_op("locality_aware_nms",
                   {"BBoxes": [bboxes], "Scores": [scores]}, ("Out",),
                   score_threshold=score_threshold, nms_top_k=nms_top_k,
                   keep_top_k=keep_top_k, nms_threshold=nms_threshold,
                   normalized=normalized, nms_eta=nms_eta,
                   background_label=background_label)


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    return _det_op("retinanet_detection_output",
                   {"BBoxes": [bboxes], "Scores": [scores],
                    "Anchors": [anchors], "ImInfo": [im_info]}, ("Out",),
                   score_threshold=score_threshold, nms_top_k=nms_top_k,
                   keep_top_k=keep_top_k, nms_threshold=nms_threshold,
                   nms_eta=nms_eta)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    n_levels = max_level - min_level + 1
    helper = LayerHelper("distribute_fpn_proposals")
    multi = [helper.create_variable_for_type_inference()
             for _ in range(n_levels)]
    restore = helper.create_variable_for_type_inference()
    nums = [helper.create_variable_for_type_inference()
            for _ in range(n_levels)]
    ins = {"FpnRois": [fpn_rois]}
    if rois_num is not None:
        ins["RoisNum"] = [rois_num]
    op = helper.append_op("distribute_fpn_proposals", inputs=ins,
                          outputs={"MultiFpnRois": multi,
                                   "RestoreIndex": [restore],
                                   "MultiLevelRoIsNum": nums},
                          attrs={"min_level": min_level,
                                 "max_level": max_level,
                                 "refer_level": refer_level,
                                 "refer_scale": refer_scale})
    got = op if in_dygraph_mode() else {"MultiFpnRois": multi,
                                        "RestoreIndex": [restore],
                                        "MultiLevelRoIsNum": nums}
    if rois_num is not None:
        return (list(got["MultiFpnRois"]), got["RestoreIndex"][0],
                list(got["MultiLevelRoIsNum"]))
    return list(got["MultiFpnRois"]), got["RestoreIndex"][0]


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_num_per_level=None,
                          name=None):
    ins = {"MultiLevelRois": list(multi_rois),
           "MultiLevelScores": list(multi_scores)}
    if rois_num_per_level is not None:
        ins["MultiLevelRoIsNum"] = list(rois_num_per_level)
        return _det_op("collect_fpn_proposals", ins,
                       ("FpnRois", "RoisNum"),
                       post_nms_topN=post_nms_top_n)
    return _det_op("collect_fpn_proposals", ins, ("FpnRois",),
                   post_nms_topN=post_nms_top_n)


def box_decoder_and_assign(prior_box, prior_box_var, target_box,
                           box_score, box_clip, name=None):
    return _det_op("box_decoder_and_assign",
                   {"PriorBox": [prior_box],
                    "PriorBoxVar": [prior_box_var],
                    "TargetBox": [target_box], "BoxScore": [box_score]},
                   ("DecodeBox", "OutputAssignBox"), box_clip=box_clip)


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0):
    return _det_op("roi_perspective_transform",
                   {"X": [input], "ROIs": [rois]}, ("Out",),
                   transformed_height=transformed_height,
                   transformed_width=transformed_width,
                   spatial_scale=spatial_scale)


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1,
                           part_size=None, sample_per_part=1,
                           trans_std=0.1, position_sensitive=False,
                           name=None):
    ins = {"X": [input], "ROIs": [rois]}
    if not no_trans:
        ins["Trans"] = [trans]
    c = input.shape[1]
    # position-sensitive: C must factor as out_dim * ph * pw (psroi
    # contract); plain mode keeps all C channels via an out_dim-preserving
    # roi_align-equivalent psroi with 1x1 parts per channel group
    out_dim = (c // (pooled_height * pooled_width)
               if position_sensitive else c)
    if position_sensitive and out_dim * pooled_height * pooled_width != c:
        raise ValueError(
            f"deformable_roi_pooling(position_sensitive=True) needs "
            f"channels divisible by pooled_h*pooled_w; got C={c}")
    if not position_sensitive:
        # non-PS deformable pooling == offset-shifted roi_align
        shifted = rois
        if not no_trans:
            from . import nn as _nn
            off = _nn.reshape(trans, [rois.shape[0], 2, -1])
            off0 = _nn.slice(off, axes=[2], starts=[0], ends=[1])
            off0 = _nn.reshape(off0, [rois.shape[0], 2]) * trans_std
            w = _nn.slice(rois, axes=[1], starts=[2], ends=[3]) - \
                _nn.slice(rois, axes=[1], starts=[0], ends=[1])
            h = _nn.slice(rois, axes=[1], starts=[3], ends=[4]) - \
                _nn.slice(rois, axes=[1], starts=[1], ends=[2])
            dx = _nn.slice(off0, axes=[1], starts=[0], ends=[1]) * w
            dy = _nn.slice(off0, axes=[1], starts=[1], ends=[2]) * h
            from .tensor import concat as _concat
            shifted = rois + _concat([dx, dy, dx, dy], axis=1)
        return roi_align(input, shifted, pooled_height, pooled_width,
                         spatial_scale)
    return _det_op("deformable_psroi_pooling", ins, ("Out",),
                   spatial_scale=spatial_scale,
                   pooled_height=pooled_height,
                   pooled_width=pooled_width, output_dim=out_dim,
                   sample_per_part=sample_per_part, trans_std=trans_std,
                   position_sensitive=position_sensitive)


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     return_index=False):
    """SSD head decode (layers/detection.py detection_output = box_coder
    decode + per-class NMS — composed from the FD-checked pieces)."""
    from . import nn as _nn
    decoded = box_coder(prior_box=prior_box, prior_box_var=prior_box_var,
                        target_box=loc,
                        code_type="decode_center_size")
    if len(decoded.shape) == 2:
        decoded = _nn.unsqueeze(decoded, [0])   # [1, P, 4] batched
    return matrix_nms(decoded, scores, score_threshold, score_threshold,
                      nms_top_k, keep_top_k,
                      background_label=background_label,
                      return_index=return_index, return_rois_num=False)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True,
             sample_size=None):
    """SSD matched loss (layers/detection.py ssd_loss recipe): IoU match
    priors to gt, assign loc/conf targets, smooth-l1 + softmax-ce —
    composed from iou_similarity/bipartite_match/target_assign, the same
    pipeline the reference builds, over padded batches."""
    from . import nn as _nn
    from .loss import softmax_with_cross_entropy
    from ..layer_helper import emit_op

    if len(location.shape) == 2:
        location = _nn.unsqueeze(location, [0])      # [1, P, 4]
    if len(confidence.shape) == 2:
        confidence = _nn.unsqueeze(confidence, [0])  # [1, P, C]
    iou = iou_similarity(gt_box, prior_box)          # [G, P]
    matched, _dist = bipartite_match(iou, match_type, overlap_threshold)
    loc_tgt, loc_w = target_assign(gt_box, matched,
                                   mismatch_value=background_label)
    lbl_tgt, conf_w = target_assign(gt_label, matched,
                                    mismatch_value=background_label)
    loc_diff = emit_op("huber_loss", "huber_loss",
                       {"X": [location], "Y": [loc_tgt]}, ("Out",),
                       {"delta": 1.0})["Out"][0]
    loc_loss = _nn.reduce_sum(loc_diff * loc_w, dim=-1)
    conf_loss = softmax_with_cross_entropy(
        confidence, _nn.cast(lbl_tgt, "int64"))
    total = (loc_loss_weight * loc_loss
             + conf_loss_weight * _nn.squeeze(conf_loss, [-1]))
    return total


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, offset=0.5, flip=True,
                   clip=False, name=None, **kw):
    """SSD multi-scale head (layers/detection.py multi_box_head): per
    feature map, a prior_box + 3x3 conv loc/conf predictions, concat."""
    from . import nn as _nn

    locs, confs, boxes_all, vars_all = [], [], [], []
    n_in = len(inputs)
    if min_sizes is None:
        min_ratio, max_ratio = min_ratio or 20, max_ratio or 90
        step = int((max_ratio - min_ratio) / max(1, n_in - 2))
        min_sizes, max_sizes = [], []
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes[:n_in - 1]
        max_sizes = [base_size * 0.2] + max_sizes[:n_in - 1]
    for i, x in enumerate(inputs):
        ar = aspect_ratios[i] if isinstance(aspect_ratios[0],
                                            (list, tuple)) \
            else aspect_ratios
        box, var = prior_box(
            x, image, min_sizes=[float(min_sizes[i])],
            max_sizes=[float(max_sizes[i])] if max_sizes else None,
            aspect_ratios=[float(a) for a in ar], flip=flip, clip=clip)
        box2 = _nn.reshape(box, [-1, 4])
        var2 = _nn.reshape(var, [-1, 4])
        n_priors = int(np.prod(box.shape[:-1])) // int(
            np.prod(x.shape[2:]))
        loc = _nn.conv2d(x, n_priors * 4, 3, padding=1)
        conf = _nn.conv2d(x, n_priors * num_classes, 3, padding=1)
        locs.append(_nn.reshape(_nn.transpose(loc, [0, 2, 3, 1]),
                                [x.shape[0], -1, 4]))
        confs.append(_nn.reshape(_nn.transpose(conf, [0, 2, 3, 1]),
                                 [x.shape[0], -1, num_classes]))
        boxes_all.append(box2)
        vars_all.append(var2)
    from .tensor import concat as _concat
    mbox_locs = _concat(locs, axis=1)
    mbox_confs = _concat(confs, axis=1)
    boxes = _concat(boxes_all, axis=0)
    variances = _concat(vars_all, axis=0)
    return mbox_locs, mbox_confs, boxes, variances
