"""The detection tier's 34 op types in both packages, op by op: the
fifteen of ``ops/detection_ops.py`` (the RoI pools, anchors and priors,
matching and assignment, the R-CNN/FPN proposal ops, RetinaNet's output,
the EAST quad transform, the deformable convolutions), the seven of
``fluid/layers/detection.py`` and the twelve of the detection tail in
``ops/catalog_tail_ops.py``.

- Forward: every output within rtol 1e-4 of its largest value, integer
  outputs equal (values, not dtypes: the reference's ids are int32).
- Through ``generic_grad``: every float input gradient from one random
  cotangent, within rtol 1e-3 (the op sweep's tolerance).
- ``multiclass_nms`` and ``multiclass_nms2`` raise ``NotImplementedError``
  in both packages.
- ``rpn_target_assign`` and ``generate_proposal_labels`` carry the
  reference's ``stateful_rng`` flag but draw nothing (the reference reads
  neither its seed nor ``rpn_batch_size_per_im``): they are held to the
  reference's outputs and to their contract (labels against the IoU
  thresholds, each ground truth's best anchor positive; the fg share
  first, ranked by IoU), under two op seeds.

The boxes are drawn in pixels from a numpy seed; the RoI pools' maps hold
distinct values, so no max ties.
"""
import numpy as np
import pytest
import torch

import jax

import chip_smoke as C
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-4


# the op sweep's helpers, imported at the call: the sweep imports this
# module's OP_CASES
def run_both(*args, **kw):
    import test_torch_op_sweep
    return test_torch_op_sweep.run_both(*args, **kw)


def assert_outputs_match(*args, **kw):
    import test_torch_op_sweep
    return test_torch_op_sweep.assert_outputs_match(*args, **kw)


def check_generic_grad(*args, **kw):
    import test_torch_op_sweep_grad
    return test_torch_op_sweep_grad.check_generic_grad(*args, **kw)


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _u(*shape, seed=0, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype("float32")


def _distinct(*shape, seed=0):
    n = int(np.prod(shape))
    return (np.random.RandomState(seed).permutation(n).reshape(shape)
            / n).astype("float32")


def boxes(n, seed=0, lo=0.0, hi=20.0, size=(2.0, 12.0)):
    """n corner boxes in pixels: the corner in [lo, hi), sides in
    ``size``."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype("float32")


def unit_boxes(n, seed=0):
    """n corner boxes inside [0, 1]²."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0.0, 0.7, (n, 2))
    wh = rng.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype("float32")


def yolo_gt(b, g, valid, seed=0):
    """[b, g, 4] (cx, cy, w, h) in [0, 1], rows past ``valid[i]`` zero."""
    rng = np.random.RandomState(seed)
    gt = np.concatenate([rng.uniform(0.1, 0.9, (b, g, 2)),
                         rng.uniform(0.05, 0.5, (b, g, 2))], -1)
    for i, v in enumerate(valid):
        gt[i, v:] = 0
    return gt.astype("float32")


ROIS = np.array([[0.3, 0.4, 5.2, 5.6], [2.2, 1.1, 7.4, 6.3],
                 [1.5, 2.6, 4.1, 7.2]], "float32")
QUADS = np.array([[1.2, 0.7, 6.1, 1.3, 5.8, 5.9, 0.8, 5.2],
                  [2.3, 2.1, 7.0, 2.5, 6.6, 7.1, 2.6, 6.4]], "float32")
ANCHORS = np.concatenate([boxes(48, seed=30, hi=24.0)]).reshape(4, 4, 3, 4)
DET = np.concatenate([np.random.RandomState(40).randint(0, 3, (12, 1)),
                      _u(12, 1, seed=41),
                      boxes(12, seed=42) / 24], 1).astype("float32")
DET_LABEL = np.concatenate([np.random.RandomState(43).randint(0, 3, (6, 1)),
                            boxes(6, seed=44) / 24], 1).astype("float32")
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]

OP_CASES = {
    # ops/detection_ops.py
    "roi_pool": ("roi_pool", {"X": _distinct(1, 2, 8, 8, seed=1),
                              "ROIs": ROIS},
                 {"pooled_height": 2, "pooled_width": 2,
                  "spatial_scale": 1.0}),
    "roi_pool 3x3 at half scale": (
        "roi_pool", {"X": _distinct(2, 3, 9, 10, seed=2),
                     "ROIs": boxes(5, seed=3, hi=12.0)},
        {"pooled_height": 3, "pooled_width": 3, "spatial_scale": 0.5}),
    "psroi_pool": ("psroi_pool", {"X": _r(1, 8, 8, 8, seed=4),
                                  "ROIs": ROIS},
                   {"output_channels": 2, "pooled_height": 2,
                    "pooled_width": 2, "spatial_scale": 1.0}),
    "psroi_pool 3x3": ("psroi_pool", {"X": _r(1, 18, 9, 10, seed=5),
                                      "ROIs": boxes(4, seed=6, hi=12.0)},
                       {"output_channels": 2, "pooled_height": 3,
                        "pooled_width": 3, "spatial_scale": 0.5}),
    "prroi_pool": ("prroi_pool", {"X": _r(1, 2, 8, 8, seed=7),
                                  "ROIs": ROIS},
                   {"pooled_height": 2, "pooled_width": 2,
                    "spatial_scale": 1.0}),
    "anchor_generator": ("anchor_generator", {"Input": _r(1, 3, 4, 5)},
                         {"anchor_sizes": [32.0, 64.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "stride": [16.0, 16.0], "offset": 0.5,
                          "variances": [0.1, 0.1, 0.2, 0.2]}),
    "density_prior_box": ("density_prior_box",
                          {"Input": _r(1, 3, 4, 4), "Image": _r(1, 3, 32, 32)},
                          {"fixed_sizes": [8.0, 16.0], "densities": [2, 1],
                           "fixed_ratios": [1.0, 2.0]}),
    "bipartite_match": ("bipartite_match", {"DistMat": _u(3, 7, seed=8)},
                        {"match_type": "bipartite"}),
    "bipartite_match per_prediction": (
        "bipartite_match", {"DistMat": _u(2, 3, 7, seed=9)},
        {"match_type": "per_prediction", "dist_threshold": 0.5}),
    "target_assign": ("target_assign",
                      {"X": _r(1, 3, 4, seed=10),
                       "MatchIndices": np.array([[0, -1, 2, 2, -1, 1, 0]],
                                                "int64")},
                      {"mismatch_value": 0.5}),
    "target_assign labels": (
        "target_assign", {"X": np.array([[[3], [1], [7]]], "int64"),
                          "MatchIndices": np.array([[0, -1, 2, 1, -1]],
                                                   "int64")},
        {"mismatch_value": 0}),
    "rpn_target_assign": ("rpn_target_assign",
                          {"Anchor": boxes(30, seed=11),
                           "GtBoxes": boxes(3, seed=12)},
                          {"rpn_positive_overlap": 0.5,
                           "rpn_negative_overlap": 0.2}),
    "generate_proposals": ("generate_proposals",
                           {"Scores": _r(2, 3, 4, 4, seed=13),
                            "BboxDeltas": _r(2, 12, 4, 4, seed=14) * 0.3,
                            "ImInfo": np.array([[32, 32, 1], [32, 32, 1]],
                                               "float32"),
                            "Anchors": ANCHORS,
                            "Variances": np.ones((4, 4, 3, 4), "float32")},
                           {"pre_nms_topN": 20, "post_nms_topN": 6,
                            "nms_thresh": 0.5}),
    "distribute_fpn_proposals": (
        "distribute_fpn_proposals",
        {"FpnRois": boxes(10, seed=15, hi=300.0, size=(8.0, 400.0))},
        {"min_level": 2, "max_level": 5, "refer_level": 4,
         "refer_scale": 224}),
    "collect_fpn_proposals": (
        "collect_fpn_proposals",
        {"MultiLevelRois": [boxes(5, seed=16), boxes(6, seed=17)],
         "MultiLevelScores": [_u(5, 1, seed=18), _u(6, 1, seed=19)]},
        {"post_nms_topN": 7}),
    "retinanet_detection_output": (
        "retinanet_detection_output",
        {"BBoxes": [boxes(6, seed=20)[None], boxes(3, seed=21)[None]],
         "Scores": [_u(1, 6, 5, seed=22), _u(1, 3, 5, seed=23)],
         "Anchors": [boxes(6, seed=24), boxes(3, seed=25)],
         "ImInfo": np.array([[32, 32, 1]], "float32")},
        {"score_threshold": 0.3, "keep_top_k": 4}),
    "polygon_box_transform": ("polygon_box_transform",
                              {"Input": _r(2, 8, 3, 4, seed=26)}, {}),
    "deformable_conv": ("deformable_conv",
                        {"Input": _r(2, 3, 6, 6, seed=27),
                         "Offset": _r(2, 18, 6, 6, seed=28) * 0.7,
                         "Mask": _u(2, 9, 6, 6, seed=29),
                         "Filter": _r(4, 3, 3, 3, seed=31)},
                        {"strides": [1, 1], "paddings": [1, 1]}),
    "deformable_conv_v1": ("deformable_conv_v1",
                           {"Input": _r(1, 2, 7, 7, seed=32),
                            "Offset": _r(1, 8, 7, 7, seed=33) * 0.7,
                            "Filter": _r(3, 2, 2, 2, seed=34)},
                           {"strides": [2, 2], "paddings": [0, 0]}),
    # fluid/layers/detection.py
    "iou_similarity": ("iou_similarity", {"X": boxes(4, seed=35),
                                          "Y": boxes(6, seed=36)}, {}),
    "prior_box": ("prior_box", {"Input": _r(1, 3, 3, 4),
                                "Image": _r(1, 3, 30, 40)},
                  {"min_sizes": [6.0, 12.0], "max_sizes": [10.0],
                   "aspect_ratios": [1.0, 2.0], "flip": True}),
    "box_coder encode": ("box_coder",
                         {"PriorBox": unit_boxes(5, seed=37),
                          "PriorBoxVar": np.tile([[0.1, 0.1, 0.2, 0.2]],
                                                 (5, 1)).astype("float32"),
                          "TargetBox": unit_boxes(3, seed=38)},
                         {"code_type": "encode_center_size"}),
    "box_coder decode in pixels": (
        "box_coder", {"PriorBox": boxes(5, seed=39),
                      "PriorBoxVar": np.tile([[0.1, 0.1, 0.2, 0.2]],
                                             (5, 1)).astype("float32"),
                      "TargetBox": _r(2, 5, 4, seed=45) * 0.5},
        {"code_type": "decode_center_size", "box_normalized": False}),
    "yolo_box": ("yolo_box", {"X": _r(2, 3 * 7, 3, 4, seed=46),
                              "ImgSize": np.array([[96, 128], [64, 80]],
                                                  "int64")},
                 {"anchors": YOLO_ANCHORS[:6], "class_num": 2,
                  "conf_thresh": 0.4, "downsample_ratio": 32}),
    "roi_align": ("roi_align", {"X": _r(1, 2, 8, 8, seed=47),
                                "ROIs": ROIS},
                  {"pooled_height": 2, "pooled_width": 2,
                   "spatial_scale": 1.0, "sampling_ratio": 2}),
    "roi_align past the edges at half scale": (
        "roi_align", {"X": _r(1, 3, 6, 7, seed=48),
                      "ROIs": boxes(4, seed=49, lo=-4.0, hi=14.0)},
        {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5,
         "sampling_ratio": -1}),
    # ops/catalog_tail_ops.py
    "box_clip": ("box_clip", {"Input": boxes(5, seed=50, lo=-6.0, hi=30.0),
                              "ImInfo": np.array([[24., 28., 1.]],
                                                 "float32")}, {}),
    "box_decoder_and_assign": (
        "box_decoder_and_assign",
        {"PriorBox": boxes(4, seed=51),
         "PriorBoxVar": np.tile([[0.1, 0.1, 0.2, 0.2]], (4, 1))
         .astype("float32"),
         "TargetBox": _r(4, 12, seed=52), "BoxScore": _u(4, 3, seed=53)},
        {"box_clip": 4.135}),
    "matrix_nms": ("matrix_nms", {"BBoxes": boxes(8, seed=54)[None]
                                  .repeat(2, 0),
                                  "Scores": _u(2, 3, 8, seed=55)},
                   {"score_threshold": 0.2, "post_threshold": 0.2,
                    "nms_top_k": 8, "keep_top_k": 8}),
    "matrix_nms gaussian": ("matrix_nms",
                            {"BBoxes": boxes(7, seed=56)[None],
                             "Scores": _u(1, 2, 7, seed=57)},
                            {"score_threshold": 0.1, "use_gaussian": True,
                             "gaussian_sigma": 2.0}),
    "locality_aware_nms": ("locality_aware_nms",
                           {"BBoxes": boxes(6, seed=58)[None],
                            "Scores": _u(1, 2, 6, seed=59)},
                           {"nms_threshold": 0.2, "score_threshold": 0.1}),
    "mine_hard_examples": ("mine_hard_examples",
                           {"ClsLoss": _u(2, 9, seed=60),
                            "MatchIndices": np.array(
                                [[0, -1, -1, 1, -1, -1, -1, -1, -1],
                                 [-1, -1, 2, -1, -1, -1, -1, 0, -1]],
                                "int64")},
                           {"neg_pos_ratio": 3.0}),
    "yolov3_loss": ("yolov3_loss",
                    {"X": _r(2, 3 * 8, 4, 4, seed=61),
                     "GTBox": yolo_gt(2, 3, [3, 1], seed=62),
                     "GTLabel": np.random.RandomState(63)
                     .randint(0, 3, (2, 3)).astype("int64")},
                    {"anchors": YOLO_ANCHORS, "anchor_mask": [3, 4, 5],
                     "class_num": 3, "ignore_thresh": 0.7,
                     "downsample_ratio": 32}),
    "detection_map": ("detection_map", {"DetectRes": DET,
                                        "Label": DET_LABEL},
                      {"overlap_threshold": 0.3}),
    "generate_proposals_v2": ("generate_proposals_v2",
                              {"Scores": _r(1, 3, 4, 4, seed=64),
                               "BboxDeltas": _r(1, 12, 4, 4, seed=65) * 0.3,
                               "Anchors": ANCHORS,
                               "Variances": np.ones((4, 4, 3, 4),
                                                    "float32")},
                              {"pre_nms_topN": 16, "post_nms_topN": 5,
                               "nms_thresh": 0.6}),
    "roi_perspective_transform": ("roi_perspective_transform",
                                  {"X": _r(1, 2, 8, 8, seed=66),
                                   "ROIs": QUADS},
                                  {"transformed_height": 3,
                                   "transformed_width": 2,
                                   "spatial_scale": 1.0}),
    "deformable_psroi_pooling": ("deformable_psroi_pooling",
                                 {"X": _r(1, 8, 8, 8, seed=67),
                                  "ROIs": ROIS,
                                  "Trans": _r(3, 2, 2, 2, seed=68)},
                                 {"pooled_height": 2, "pooled_width": 2,
                                  "output_dim": 2, "trans_std": 0.1,
                                  "spatial_scale": 1.0}),
    "generate_proposal_labels": (
        "generate_proposal_labels",
        {"RpnRois": boxes(20, seed=69), "GtClasses": np.array(
            [[3], [1], [5]], "int64"), "IsCrowd": np.zeros((3, 1), "int64"),
         "GtBoxes": boxes(3, seed=70), "ImInfo": np.array([[32, 32, 1]],
                                                          "float32")},
        {"batch_size_per_im": 12, "fg_fraction": 0.25, "fg_thresh": 0.5,
         "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0}),
    "generate_mask_labels": (
        "generate_mask_labels",
        {"Rois": boxes(4, seed=71, hi=10.0), "GtSegms": (
            _u(2, 16, 16, seed=72) > 0.5).astype("int64"),
         "LabelsInt32": np.array([[2], [0], [1], [3]], "int64"),
         "MatchIndices": np.array([1, 0, 0, 1], "int64")},
        {"resolution": 5}),
}

DIFFERENTIABLE = sorted(
    k for k, (op, _, _) in OP_CASES.items()
    if treg.get_op(op).differentiable and jreg.get_op(op).differentiable)


def test_the_tier_is_34_op_types():
    ops = {op for op, _, _ in OP_CASES.values()} | {"multiclass_nms",
                                                     "multiclass_nms2"}
    assert len(ops) == 34
    assert ops <= set(treg.all_ops()) & set(jreg.all_ops())
    assert len(treg.all_ops()) == 488       # with the CTR, quant, fused, plumbing tiers


_FORWARD = {}


def _forward(case):
    """Both packages' outputs of one case, kept for its gradient test (the
    reference's eager ops compile at each new shape)."""
    if case not in _FORWARD:
        op, ins, attrs = OP_CASES[case]
        _FORWARD[case] = run_both(op, ins, attrs)
    return _FORWARD[case]


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_forward_matches_reference(case):
    ref, port = _forward(case)
    assert_outputs_match(ref, port, RTOL, case)


@pytest.mark.parametrize("case", DIFFERENTIABLE)
def test_generic_grad_matches_reference(case):
    op, ins, attrs = OP_CASES[case]
    check_generic_grad(op, ins, attrs, ref=_forward(case)[0])


@pytest.mark.parametrize("op", ["multiclass_nms", "multiclass_nms2"])
def test_multiclass_nms_raises_in_both(op):
    ins = {"BBoxes": boxes(4)[None], "Scores": _u(1, 2, 4)}
    with pytest.raises(NotImplementedError):
        run_both(op, ins, {})
    with pytest.raises(NotImplementedError):
        treg.get_op(op).fn({k: [torch.from_numpy(v)] for k, v in ins.items()},
                           {}, treg.LoweringContext())


def _port(op, ins, attrs, seed=0):
    return treg.get_op(op).fn(
        {k: [torch.from_numpy(np.asarray(v))] for k, v in ins.items()},
        dict(attrs), treg.LoweringContext(base_seed=seed))


@pytest.mark.parametrize("seed", [0, 7])
def test_rpn_target_assign_contract(seed):
    """Each anchor's label from its best IoU against the thresholds,
    every ground truth's best anchor positive; the op seed changes
    nothing (no budget is sampled)."""
    _, ins, attrs = OP_CASES["rpn_target_assign"]
    out = _port("rpn_target_assign", ins, attrs, seed)
    label = out["TargetLabel"][0].numpy()
    iou = C._np_iou(ins["Anchor"], ins["GtBoxes"])
    best = iou.max(1)
    want = np.where(best >= 0.5, 1, np.where(best < 0.2, 0, -1))
    want[iou.argmax(0)] = 1
    np.testing.assert_array_equal(label, want)
    np.testing.assert_array_equal(out["LocationIndex"][0].numpy(),
                                  label == 1)
    np.testing.assert_array_equal(out["ScoreIndex"][0].numpy(), label >= 0)
    np.testing.assert_array_equal(out["TargetBBox"][0].numpy(),
                                  ins["GtBoxes"][iou.argmax(1)])
    other = _port("rpn_target_assign", ins, attrs, seed + 1)
    for k in out:
        assert torch.equal(out[k][0], other[k][0]), k


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_proposal_labels_contract(seed):
    """Exactly ``batch_size_per_im`` RoIs: the fg share first, IoU at
    ``fg_thresh`` or more in falling order, labelled with their ground
    truth's class and regression targets; the rest background, label 0,
    zero targets and weights; the op seed changes nothing."""
    _, ins, attrs = OP_CASES["generate_proposal_labels"]
    out = _port("generate_proposal_labels", ins, attrs, seed)
    rois = out["Rois"][0].numpy()
    n_fg = int(12 * 0.25)
    assert rois.shape == (12, 4)
    iou = C._np_iou(rois, ins["GtBoxes"]).max(1)
    assert (np.diff(iou[:n_fg]) <= 1e-7).all() and (iou[:n_fg] >= 0.5).all()
    assert (iou[n_fg:] < 0.5).all()
    lbl = out["LabelsInt32"][0].numpy()
    np.testing.assert_array_equal(
        lbl[:n_fg], ins["GtClasses"][C._np_iou(rois[:n_fg], ins["GtBoxes"])
                                     .argmax(1), 0])
    assert (lbl[n_fg:] == 0).all()
    assert (out["BboxTargets"][0].numpy()[n_fg:] == 0).all()
    w = out["BboxInsideWeights"][0].numpy()
    assert (w[:n_fg] == 1).all() and (w[n_fg:] == 0).all()
    other = _port("generate_proposal_labels", ins, attrs, seed + 1)
    for k in out:
        assert torch.equal(out[k][0], other[k][0]), k


def test_matrix_nms_blocks_of_classes_agree():
    """The classes a block at a time, as at YOLOv3's 22,743 boxes, give
    the outputs of one block of all classes."""
    from paddle_tpu_torch.ops import catalog_tail_ops as ct
    _, ins, attrs = OP_CASES["matrix_nms"]
    whole = _port("matrix_nms", ins, attrs)
    old = ct._NMS_BLOCK_ELEMENTS
    try:
        ct._NMS_BLOCK_ELEMENTS = 64          # one class a block
        blocked = _port("matrix_nms", ins, attrs)
    finally:
        ct._NMS_BLOCK_ELEMENTS = old
    assert torch.equal(whole["Out"][0], blocked["Out"][0])


def test_roi_max_slabs_agree():
    """roi_pool's RoIs a slab at a time give one slab's outputs."""
    from paddle_tpu_torch.ops import detection_ops as dops
    op, ins, attrs = OP_CASES["roi_pool 3x3 at half scale"]
    whole = _port(op, ins, attrs)["Out"][0]
    old = dops._SLAB
    try:
        dops._SLAB = 1
        sliced = _port(op, ins, attrs)["Out"][0]
    finally:
        dops._SLAB = old
    assert torch.equal(whole, sliced)
