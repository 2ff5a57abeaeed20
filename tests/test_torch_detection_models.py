"""Small MobileNet-SSD and YOLOv3 programs (``chip_smoke.ssd_program`` and
``yolov3_program`` at phase 4u's host widths, ``SSD_HOST`` and
``YOLO_HOST``) built in both packages and trained from the reference's
startup values (``run_both`` carries them through
``interop.scope_from_numpy``).

- YOLOv3 (an eighth of DarkNet-53's width at 128², 2 images, Momentum
  with L2Decay): two steps' losses within rtol 1e-4, the first step's
  gradients within cosine 1e-4 of 1 and norm 1e-3 (phase 4u's card
  check holds one step at cosine 1e-3: there a leaky ReLU input within
  float32 noise of 0 flipped its slope; the reference's XLA and torch's
  CPU kernels agree to 4e-11 here).
- MobileNet-SSD (a quarter width at 96², the prior sizes scaled to it, 4
  images, RMSProp over the piecewise decay with L2Decay): one step (a
  second RMSProp step moves every weight by about lr·√10 whatever its
  gradient's size, so its loss inherits the sign of gradients that are
  float32 noise); the loss within rtol 1e-4, the gradients within cosine
  1e-3 of 1 and norm 2e-3 (batch norm over the 1x1 maps of 4 images
  amplifies the float32 differences of the reference's XLA convolutions
  against torch's: 4.6e-5 and 7.7e-4 when written).
- Both: the first step's detections past the score threshold plus
  ``chip_smoke.DET_SCORE_MARGIN`` matched in the other package's by
  their boxes within 1e-4 of the largest coordinate, and at most one in
  1,000 of their scores moved more than 1e-4 (matrix NMS reorders boxes
  whose scores tie within float32 noise; ``chip_smoke.detection_error``).
"""
import numpy as np

import jax

import chip_smoke as C
from test_torch_control_flow import run_both

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-4


def _detector(build, cfg, feed_fn, seed, steps):
    """``steps`` steps of ``build`` on one batch in both packages:
    {step: (port, reference)}, each [loss, nmsed, gradients]."""
    def fetches(fluid):
        got = build(fluid, cfg, cfg["host_batch"])
        return [got[0], got[1]] + [g for _, g in got[-1]]
    ref, port, _ = run_both(fetches, feed_fn(cfg, cfg["host_batch"], seed),
                            runs=steps)
    return {i: (port[i], ref[i]) for i in range(steps)}


def _check(run, cfg, cos_tol, norm_tol):
    for step, (port, ref) in run.items():
        got, want = float(np.asarray(port[0])), float(np.asarray(ref[0]))
        assert abs(got - want) <= RTOL * abs(want), (step, got, want)
    port, ref = run[0]
    cos, norm = C._cosine([np.asarray(g) for g in port[2:]],
                          [np.asarray(g) for g in ref[2:]])
    assert 1 - cos <= cos_tol and abs(norm - 1) <= norm_tol, (cos, norm)
    boxes, scores = C.detection_error(np.asarray(port[1]), np.asarray(ref[1]),
                                      cfg["score"], C.DET_SCORE_MARGIN,
                                      C.DET_CARD_TOL)
    assert boxes <= 1 and scores <= 1, (boxes, scores)


def test_ssd_against_reference():
    _check(_detector(C.ssd_program, C.SSD_HOST, C.ssd_feed, 7, 1),
           C.SSD_HOST, 1e-3, 2e-3)


def test_yolov3_against_reference():
    _check(_detector(C.yolov3_program, C.YOLO_HOST, C.yolov3_feed, 9, 2),
           C.YOLO_HOST, 1e-4, 1e-3)


def test_ssd_priors_at_the_published_width():
    """The published head's 1,917 priors at 300², in both packages."""
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid
    for fluid in (tfluid, jfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            _, priors = C.ssd_program(fluid, C.SSD, 1, train=False)
        assert priors.shape[0] == C.SSD_PRIORS
