"""The detection tier's builders in both packages: the 33 ``fluid.layers``
names the tier brings, static and under each package's tracer;
``paddle_tpu_torch.vision.ops``; and one test for each of the reference's
quirks that the port copies (ROADMAP queue C).
``test_torch_detection_models.py`` trains the small detectors.

- Builders: one static program a family in each package from the
  reference's startup values (``run_both``), and the same builders under
  each tracer with the reference's parameters handed to the port by name
  (``shared_params``); outputs within rtol 1e-4 of their largest value,
  ids equal.
- ``batched_nms`` equal indices; ``yolo_loss`` and ``DeformConv2D``
  (its parameters carried across) within rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu.fluid as jfluid
import paddle_tpu.vision.ops as jvops
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.fluid import framework as jframework

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.vision.ops as tvops
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.fluid import framework as tframework

import chip_smoke as C
from test_torch_control_flow import run_both
from test_torch_detection_ops import (ANCHORS, QUADS, ROIS, YOLO_ANCHORS,
                                      _distinct, _r, _u, boxes, unit_boxes,
                                      yolo_gt)
from test_torch_op_sweep import assert_close
from test_torch_rnn_ops import shared_params

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-4
VAR4 = lambda n: np.tile([[0.1, 0.1, 0.2, 0.2]], (n, 1)).astype("float32")

FEED = {
    "img": _r(2, 3, 32, 32, seed=1), "feat": _r(2, 4, 4, 4, seed=2),
    "box_a": boxes(4, seed=3), "box_b": boxes(6, seed=4),
    "prior": unit_boxes(5, seed=5), "pvar": VAR4(5),
    "tbox": unit_boxes(3, seed=6), "loc": _r(2, 5, 4, seed=7) * 0.5,
    "cls_major": _u(2, 3, 5, seed=8),
    "yolo_x": _r(2, 21, 3, 4, seed=9),
    "img_size": np.array([[96, 128], [64, 80]], "int32"),
    "dist": _u(3, 7, seed=10),
    "match": np.array([[0, -1, 2, 2, -1, 1, 0]], "int64"),
    "gt2": _r(3, 4, seed=11), "poly": _r(2, 8, 3, 4, seed=12),
    "clip_box": boxes(5, seed=13, lo=-6.0, hi=30.0),
    "im_info": np.array([[24.0, 28.0, 1.0]], "float32"),
    "dec_prior": boxes(4, seed=14), "dec_var": VAR4(4),
    "dec_target": _r(4, 12, seed=15), "dec_score": _u(4, 3, seed=16),
    "nms_box": boxes(8, seed=17)[None].repeat(2, 0),
    "nms_score": _u(2, 3, 8, seed=18),
    "ret_box": boxes(6, seed=19)[None], "ret_score": _u(1, 6, 5, seed=20),
    "ret_anchor": boxes(6, seed=21),
    "x2": _r(1, 2, 8, 8, seed=22), "x8": _r(1, 8, 8, 8, seed=23),
    "xd": _distinct(1, 2, 8, 8, seed=24), "rois": ROIS, "quads": QUADS,
    "trans": _r(3, 2, 2, 2, seed=25) * 0.5,
    "dcn_x": _r(2, 3, 6, 6, seed=26), "dcn_off": _r(2, 18, 6, 6, seed=27)
    * 0.7, "dcn_mask": _u(2, 9, 6, 6, seed=28),
    "anchors": boxes(30, seed=29), "gt_boxes": boxes(3, seed=30),
    "rpn_scores": _r(1, 3, 4, 4, seed=31),
    "rpn_deltas": _r(1, 12, 4, 4, seed=32) * 0.3, "rpn_anchors": ANCHORS,
    "rpn_var": np.ones((4, 4, 3, 4), "float32"),
    "rpn_im": np.array([[32.0, 32.0, 1.0]], "float32"),
    "fpn_rois": boxes(10, seed=33, hi=300.0, size=(8.0, 400.0)),
    "lvl_a": boxes(5, seed=34), "lvl_b": boxes(6, seed=35),
    "lvl_sa": _u(5, 1, seed=36), "lvl_sb": _u(6, 1, seed=37),
    "prop_rois": boxes(20, seed=38),
    "gt_cls": np.array([[3], [1], [5]], "int64"),
    "crowd": np.zeros((3, 1), "int64"),
    "masks": (_u(3, 16, 16, seed=39) > 0.5).astype("int64"),
    "mask_rois": boxes(4, seed=40, hi=10.0),
    "mask_lbl": np.array([[2], [0], [1], [3]], "int64"),
    "y3_x": _r(2, 24, 4, 4, seed=41), "y3_gt": yolo_gt(2, 3, [3, 1], 42),
    "y3_lbl": np.random.RandomState(43).randint(0, 3, (2, 3))
    .astype("int64"),
    "focal_x": _r(6, 3, seed=44),
    "focal_lbl": np.array([[0], [1], [3], [2], [0], [1]], "int32"),
    "fg": np.array([3], "int32"),
    "ssd_loc": _r(1, 5, 4, seed=45) * 0.3, "ssd_conf": _r(1, 5, 3, seed=46),
    "ssd_gt": unit_boxes(2, seed=47),
    "ssd_lbl": np.array([[1], [2]], "int64"),
    "mbh_a": _r(2, 4, 4, 4, seed=48), "mbh_b": _r(2, 4, 2, 2, seed=49),
}


def _data(fluid, names):
    return {k: fluid.data(k, list(FEED[k].shape), str(FEED[k].dtype))
            for k in names}


def _deformable_roi(L, v, ps):
    return L.deformable_roi_pooling(
        v["x8"], v["rois"], v["trans"], pooled_height=2, pooled_width=2,
        position_sensitive=ps)


FAMILIES = {
    "boxes": {
        "iou_similarity": lambda L, v: L.iou_similarity(v["box_a"],
                                                        v["box_b"]),
        "prior_box": lambda L, v: L.prior_box(
            v["feat"], v["img"], [8.0], [14.0], [1.0, 2.0], flip=True)[0],
        "box_coder encode": lambda L, v: L.box_coder(
            v["prior"], v["pvar"], v["tbox"]),
        "box_coder decode": lambda L, v: L.box_coder(
            v["prior"], v["pvar"], v["loc"], "decode_center_size"),
        "yolo_box boxes": lambda L, v: L.yolo_box(
            v["yolo_x"], v["img_size"], YOLO_ANCHORS[:6], 2, 0.4, 32)[0],
        "yolo_box scores": lambda L, v: L.yolo_box(
            v["yolo_x"], v["img_size"], YOLO_ANCHORS[:6], 2, 0.4, 32)[1],
        "density_prior_box": lambda L, v: L.density_prior_box(
            v["feat"], v["img"], densities=[2, 1], fixed_sizes=[8.0, 16.0],
            fixed_ratios=[1.0, 2.0])[0],
        "anchor_generator": lambda L, v: L.anchor_generator(
            v["feat"], [32.0, 64.0], [0.5, 1.0, 2.0], stride=[16.0, 16.0])[0],
        "bipartite_match": lambda L, v: L.bipartite_match(v["dist"])[0],
        "bipartite_match dist": lambda L, v: L.bipartite_match(
            v["dist"], "per_prediction", 0.5)[1],
        "target_assign": lambda L, v: L.target_assign(
            v["gt2"], v["match"], mismatch_value=0.5)[0],
        "polygon_box_transform": lambda L, v: L.polygon_box_transform(
            v["poly"]),
        "box_clip": lambda L, v: L.box_clip(v["clip_box"], v["im_info"]),
        "box_decoder_and_assign": lambda L, v: L.box_decoder_and_assign(
            v["dec_prior"], v["dec_var"], v["dec_target"], v["dec_score"],
            4.135)[1],
        "matrix_nms": lambda L, v: L.matrix_nms(
            v["nms_box"], v["nms_score"], 0.2, 0.2, 8, 8,
            return_rois_num=False),
        "locality_aware_nms": lambda L, v: L.locality_aware_nms(
            v["nms_box"], v["nms_score"], 0.1, 8, 8, nms_threshold=0.2),
        "retinanet_detection_output":
            lambda L, v: L.retinanet_detection_output(
                v["ret_box"], v["ret_score"], v["ret_anchor"], v["im_info"],
                score_threshold=0.3, keep_top_k=4),
        "detection_output": lambda L, v: L.detection_output(
            v["loc"], v["cls_major"], v["prior"], v["pvar"],
            score_threshold=0.2),
    },
    "pools": {
        "roi_align": lambda L, v: L.roi_align(v["x2"], v["rois"], 2, 2, 1.0,
                                              2),
        "roi_pool": lambda L, v: L.roi_pool(v["xd"], v["rois"], 2, 2),
        "psroi_pool": lambda L, v: L.psroi_pool(v["x8"], v["rois"], 2, 1.0,
                                                2, 2),
        "prroi_pool": lambda L, v: L.prroi_pool(v["x2"], v["rois"], 1.0, 2,
                                                2),
        "roi_perspective_transform":
            lambda L, v: L.roi_perspective_transform(v["x2"], v["quads"], 3,
                                                     2),
        "deformable_roi_pooling": lambda L, v: _deformable_roi(L, v, False),
        "deformable_roi_pooling position-sensitive":
            lambda L, v: _deformable_roi(L, v, True),
        "deformable_conv": lambda L, v: L.deformable_conv(
            v["dcn_x"], v["dcn_off"], v["dcn_mask"], 4, 3, padding=1),
        "deformable_conv v1": lambda L, v: L.deformable_conv(
            v["dcn_x"], v["dcn_off"], None, 4, 3, stride=2, padding=1,
            modulated=False),
    },
    "rcnn": {
        "rpn_target_assign labels": lambda L, v: L.rpn_target_assign(
            None, None, v["anchors"], None, v["gt_boxes"],
            rpn_positive_overlap=0.5, rpn_negative_overlap=0.2)[3],
        "rpn_target_assign boxes": lambda L, v: L.rpn_target_assign(
            None, None, v["anchors"], None, v["gt_boxes"])[2],
        "retinanet_target_assign fg_num":
            lambda L, v: L.retinanet_target_assign(
                None, None, v["anchors"], None, v["gt_boxes"], None,
                positive_overlap=0.5)[5],
        "generate_proposals": lambda L, v: L.generate_proposals(
            v["rpn_scores"], v["rpn_deltas"], v["rpn_im"], v["rpn_anchors"],
            v["rpn_var"], 20, 6, 0.5)[0],
        "generate_proposal_labels rois":
            lambda L, v: L.generate_proposal_labels(
                v["prop_rois"], v["gt_cls"], v["crowd"], v["gt_boxes"],
                v["im_info"], batch_size_per_im=12)[0],
        "generate_proposal_labels labels":
            lambda L, v: L.generate_proposal_labels(
                v["prop_rois"], v["gt_cls"], v["crowd"], v["gt_boxes"],
                v["im_info"], batch_size_per_im=12)[1],
        "generate_mask_labels": lambda L, v: L.generate_mask_labels(
            v["im_info"], v["gt_cls"], v["crowd"], v["masks"],
            v["mask_rois"], v["mask_lbl"], 3, 5)[2],
        "distribute_fpn_proposals restore":
            lambda L, v: L.distribute_fpn_proposals(v["fpn_rois"], 2, 5, 4,
                                                    224)[1],
        "distribute_fpn_proposals level 3":
            lambda L, v: L.distribute_fpn_proposals(v["fpn_rois"], 2, 5, 4,
                                                    224)[0][1],
        "collect_fpn_proposals": lambda L, v: L.collect_fpn_proposals(
            [v["lvl_a"], v["lvl_b"]], [v["lvl_sa"], v["lvl_sb"]], 2, 3, 7),
    },
    "losses": {
        "yolov3_loss": lambda L, v: L.yolov3_loss(
            v["y3_x"], v["y3_gt"], v["y3_lbl"], YOLO_ANCHORS, [3, 4, 5], 3,
            0.7, 32),
        "sigmoid_focal_loss": lambda L, v: L.sigmoid_focal_loss(
            v["focal_x"], v["focal_lbl"], v["fg"]),
        "ssd_loss": lambda L, v: L.ssd_loss(
            v["ssd_loc"], v["ssd_conf"], v["ssd_gt"], v["ssd_lbl"],
            v["prior"], v["pvar"]),
        "multi_box_head locs": lambda L, v: _mbh(L, v)[0],
        "multi_box_head confs": lambda L, v: _mbh(L, v)[1],
        "multi_box_head priors": lambda L, v: _mbh(L, v)[2],
    },
}
BUILDER_CASES = [(f, name) for f, cases in FAMILIES.items()
                 for name in sorted(cases)]


def _mbh(L, v):
    return L.multi_box_head([v["mbh_a"], v["mbh_b"]], v["img"], 32, 3,
                            [[1.0, 2.0], [1.0, 2.0, 3.0]],
                            min_sizes=[8.0, 16.0], max_sizes=[16.0, 24.0])


def _family(L, v, family):
    return {k: FAMILIES[family][k](L, v) for k in sorted(FAMILIES[family])}


def test_the_builders_cover_the_33_names():
    names = {n.split(" ")[0] for f in FAMILIES.values() for n in f} \
        | {"multiclass_nms"}
    from paddle_tpu_torch.fluid.layers import detection
    assert set(detection.__all__) <= names | {"roi_pool"}
    extras = {"psroi_pool", "prroi_pool", "deformable_conv"}
    assert len((set(detection.__all__) - {"sigmoid_focal_loss"}) | extras) \
        == 33
    for n in (set(detection.__all__) | extras):
        assert hasattr(tfluid.layers, n), n


@pytest.fixture(scope="module")
def static_results():
    out = {}
    for family in FAMILIES:
        def build(fluid, family=family):
            return list(_family(fluid.layers, _data(fluid, FEED),
                                family).values())
        ref, port, _ = run_both(build, FEED)
        out[family] = dict(zip(sorted(FAMILIES[family]),
                               zip(port[0], ref[0])))
    return out


@pytest.mark.parametrize("family,name", BUILDER_CASES)
def test_builder_static_matches_reference(family, name, static_results):
    got, want = static_results[family][name]
    assert_close(np.asarray(got), np.asarray(want), RTOL, name)


def _dygraph_outs(pkg, family, store):
    fluid, dy, fw = (jfluid, jdy, jframework) if pkg == "ref" \
        else (tfluid, tdy, tframework)
    fw.reset_unique_name()
    with (dy.guard() if pkg == "ref" else dy.guard(tfluid.CPUPlace())), \
            shared_params(fw._dygraph_tracer(), store, pkg == "ref", []):
        outs = _family(fluid.layers, {k: dy.to_variable(v)
                                      for k, v in FEED.items()}, family)
        return {k: np.asarray(v.numpy()) for k, v in outs.items()}


@pytest.fixture(scope="module")
def dygraph_results():
    out = {}
    for family in FAMILIES:
        store = {}
        want = _dygraph_outs("ref", family, store)
        got = _dygraph_outs("port", family, store)
        out[family] = {k: (got[k], want[k]) for k in want}
    return out


@pytest.mark.parametrize("family,name", BUILDER_CASES)
def test_builder_dygraph_matches_reference(family, name, dygraph_results):
    got, want = dygraph_results[family][name]
    assert_close(got, want, RTOL, name)


# --- vision.ops --------------------------------------------------------------
@pytest.mark.parametrize("top_k", [3, 12])
def test_batched_nms_matches_reference(top_k):
    bx, sc = boxes(9, seed=60, hi=10.0), _u(9, seed=61)
    want = np.asarray(jvops.batched_nms(bx, sc, 0.3, top_k))
    got = tvops.batched_nms(torch.from_numpy(bx), torch.from_numpy(sc), 0.3,
                            top_k)
    assert got.shape == (top_k,)
    np.testing.assert_array_equal(got.numpy(), want)


def _dygraph_pair(fn):
    """``fn(fluid, dy, vops)``'s outputs under each tracer, the
    reference's parameters handed to the port by name."""
    store, outs = {}, []
    for pkg in ("ref", "port"):
        fluid, dy, fw, vops = (jfluid, jdy, jframework, jvops) \
            if pkg == "ref" else (tfluid, tdy, tframework, tvops)
        fw.reset_unique_name()
        with (dy.guard() if pkg == "ref" else dy.guard(tfluid.CPUPlace())),\
                shared_params(fw._dygraph_tracer(), store, pkg == "ref", []):
            outs.append(np.asarray(fn(fluid, dy, vops).numpy()))
    return outs[1], outs[0]


def test_yolo_loss_matches_reference():
    got, want = _dygraph_pair(lambda fluid, dy, vops: vops.yolo_loss(
        dy.to_variable(FEED["y3_x"]), dy.to_variable(FEED["y3_gt"]),
        dy.to_variable(FEED["y3_lbl"]), YOLO_ANCHORS, [3, 4, 5], 3, 0.7, 32))
    assert_close(got, want, RTOL, "yolo_loss")


@pytest.mark.parametrize("modulated", [True, False])
def test_deform_conv2d_matches_reference(modulated):
    def run(fluid, dy, vops):
        layer = vops.DeformConv2D(3, 4, 3, padding=1)
        return layer(dy.to_variable(FEED["dcn_x"]),
                     dy.to_variable(FEED["dcn_off"]),
                     dy.to_variable(FEED["dcn_mask"]) if modulated else None)
    got, want = _dygraph_pair(run)
    assert_close(got, want, RTOL, "DeformConv2D")


# --- the reference's quirks, copied ------------------------------------------
def _one(pkg, fn):
    """``fn(fluid, dy)`` under the tracer of ``pkg`` ("port" or "ref")."""
    fluid, dy = (tfluid, tdy) if pkg == "port" else (jfluid, jdy)
    with (dy.guard(tfluid.CPUPlace()) if pkg == "port" else dy.guard()):
        return fn(fluid, dy)


def test_ssd_loss_takes_one_image():
    """A batch's [2, P, 4] locations with [2, G, 4] ground truth fail in
    both (``iou_similarity`` is 2-d only; the reference's error is a
    ValueError of broadcasting, the port's an IndexError at G = 2)."""
    def run(fluid, dy):
        v = dy.to_variable
        return fluid.layers.ssd_loss(
            v(np.repeat(FEED["ssd_loc"], 2, 0)),
            v(np.repeat(FEED["ssd_conf"], 2, 0)),
            v(np.stack([FEED["ssd_gt"]] * 2)),
            v(np.stack([FEED["ssd_lbl"]] * 2)), v(FEED["prior"]),
            v(FEED["pvar"]))
    for pkg in ("port", "ref"):
        with pytest.raises((ValueError, RuntimeError, TypeError,
                            IndexError)):
            _one(pkg, run)


def test_ssd_loss_targets_the_raw_corners_and_reads_no_variance():
    """The location target is the matched ground truth's corners (a
    location equal to them leaves the softmax loss alone), and neither
    the prior variances nor the mining options change the loss."""
    prior, gt = FEED["prior"], FEED["ssd_gt"]
    iou = C._np_iou(gt, prior)
    match = np.where(iou.max(0) >= 0.5, iou.argmax(0), -1)
    for b in range(len(gt)):
        match[iou[b].argmax()] = b
    loc = np.where(match[:, None] >= 0, gt[np.maximum(match, 0)], 0.0)[None] \
        .astype("float32")

    def run(fluid, dy, location=loc, var=FEED["pvar"], **kw):
        v = dy.to_variable
        return fluid.layers.ssd_loss(v(location), v(FEED["ssd_conf"]),
                                     v(gt), v(FEED["ssd_lbl"]), v(prior),
                                     v(var), **kw).numpy()
    for pkg in ("port", "ref"):
        base = _one(pkg, run)
        np.testing.assert_array_equal(
            base, _one(pkg, lambda f, d: run(f, d, var=FEED["pvar"] * 7,
                                             neg_pos_ratio=9.0,
                                             mining_type="hard_example",
                                             normalize=False)))
        conf = _one(pkg, lambda f, d: f.layers.softmax_with_cross_entropy(
            d.to_variable(FEED["ssd_conf"]), d.to_variable(np.where(
                match >= 0, FEED["ssd_lbl"][np.maximum(match, 0), 0], 0)
                [None, :, None].astype("int64"))).numpy())
        np.testing.assert_allclose(base, conf[..., 0], rtol=1e-6)


def test_detection_output_reads_scores_class_major():
    """[B, P, C] confidences (P != C) fail in both; [B, C, P] give
    [B, C P, 6] rows, unsoftmaxed (a score of 5 comes out 5), -1 where
    suppressed, whatever ``nms_threshold``, ``nms_top_k`` and
    ``keep_top_k`` say."""
    loc, prior, var = FEED["loc"], FEED["prior"], FEED["pvar"]
    scores = FEED["cls_major"].copy()
    scores[0, 1, 2] = 5.0

    def run(fluid, dy, s=scores, **kw):
        v = dy.to_variable
        return fluid.layers.detection_output(v(loc), v(s), v(prior), v(var),
                                             score_threshold=0.2,
                                             **kw).numpy()
    for pkg in ("port", "ref"):
        with pytest.raises((ValueError, RuntimeError, TypeError)):
            _one(pkg, lambda f, d: run(f, d, s=np.ascontiguousarray(
                scores.transpose(0, 2, 1))))
        out = _one(pkg, run)
        assert out.shape == (2, 3 * 5, 6)
        assert out[0, 5:10, 1].max() == np.float32(5.0)
        assert (out[..., 1] == -1).any()
        np.testing.assert_array_equal(out, _one(pkg, lambda f, d: run(
            f, d, nms_threshold=0.9, nms_top_k=1, keep_top_k=2)))


def test_prior_box_uses_only_the_given_ratios_and_always_clips():
    """Ratios [2] with ``flip`` give two boxes a cell (Paddle's would add
    ratio 1), and boxes are clipped to [0, 1] with ``clip`` off."""
    for pkg in ("port", "ref"):
        box = _one(pkg, lambda f, d: f.layers.prior_box(
            d.to_variable(FEED["feat"]), d.to_variable(FEED["img"]), [40.0],
            aspect_ratios=[2.0], flip=True, clip=False)[0].numpy())
        assert box.shape == (4, 4, 2, 4)
        assert box.min() == 0.0 and box.max() == 1.0


def test_multi_box_head_takes_a_max_size_for_every_map():
    """mobilenet_ssd.py's ``max_sizes=[[], 150.0]`` (no max size on the
    first map) fails in both."""
    def run(fluid, dy):
        v = dy.to_variable
        return fluid.layers.multi_box_head(
            [v(FEED["mbh_a"]), v(FEED["mbh_b"])], v(FEED["img"]), 32, 3,
            [[2.0], [2.0, 3.0]], min_sizes=[8.0, 16.0],
            max_sizes=[[], 24.0])
    for pkg in ("port", "ref"):
        with pytest.raises(TypeError):
            _one(pkg, run)


@pytest.mark.parametrize("name", ["multiclass_nms", "multiclass_nms2"])
def test_multiclass_nms_raises(name):
    """The builder (``multiclass_nms``) and the op types raise
    ``NotImplementedError`` in both."""
    def run(fluid, dy):
        v = dy.to_variable
        if name == "multiclass_nms":
            return fluid.layers.multiclass_nms(v(FEED["nms_box"]),
                                               v(FEED["nms_score"]), 0.1, 8,
                                               8)
        from_pkg = tframework if fluid is tfluid else jframework
        return from_pkg._dygraph_tracer().trace_op(
            name, {"BBoxes": [v(FEED["nms_box"])],
                   "Scores": [v(FEED["nms_score"])]}, {"Out": [None]}, {})
    for pkg in ("port", "ref"):
        with pytest.raises(NotImplementedError):
            _one(pkg, run)


def test_roi_pool_builder_is_roi_align():
    """``fluid.layers.roi_pool`` pools by ``roi_align``, though a
    ``roi_pool`` op of its own (a max) is registered."""
    def run(fluid, dy):
        v = dy.to_variable
        a = fluid.layers.roi_pool(v(FEED["xd"]), v(FEED["rois"]), 2, 2)
        b = fluid.layers.roi_align(v(FEED["xd"]), v(FEED["rois"]), 2, 2)
        return a.numpy(), b.numpy()
    for pkg in ("port", "ref"):
        a, b = _one(pkg, run)
        np.testing.assert_array_equal(a, b)
    op = treg.get_op("roi_pool").fn(
        {"X": [torch.from_numpy(FEED["xd"])],
         "ROIs": [torch.from_numpy(FEED["rois"])]},
        {"pooled_height": 2, "pooled_width": 2}, treg.LoweringContext())
    assert not np.allclose(op["Out"][0].numpy(), a)
