"""The image layers' ``nn`` classes (ROADMAP queue A item 5's image
half: the 1-d, 3-d and transposed convolutions and pools, the adaptive
pools, the batch, sync, group, instance, local-response and spectral
norms, padding, upsampling, pixel shuffle, the activations and the plain
losses) and the ``dygraph`` classes (``PRelu``, ``Conv2DTranspose``,
``Conv3D``, ``Conv3DTranspose``, ``InstanceNorm``, ``GroupNorm``,
``SpectralNorm``, ``BilinearTensorProduct``, ``Flatten``; in
``test_torch_image_dygraph.py``) in both packages: each layer made in the
reference, its weights carried into the port (``interop.
layer_from_numpy``), then the outputs of two calls (a ``SpectralNorm``'s
second starts from the first's vectors) and the input's gradient of the
sum of the first output's sigmoid (a normalized output's plain sum has
no gradient but rounding), within rtol 1e-4 of each value's largest.
The gradient is left to ``test_torch_image_layers.py`` for the layers
with no weight that run one op of its cases (``FORWARD_ONLY``).
"""
import numpy as np
import pytest

import jax

import paddle_tpu as jp
from paddle_tpu.dygraph import base as jdy

import paddle_tpu_torch as tp
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy

from test_torch_image_layers import A, FWD_RTOL, _np
from test_torch_op_sweep import assert_close

jax.config.update("jax_platforms", "cpu")


# name -> (make(pd) -> layer, input keys)
LAYERS = {
    "nn.Conv1D": (lambda pd: pd.nn.Conv1D(4, 3, 3, padding=1, stride=2),
                  ["seq"]),
    "nn.Conv3D": (lambda pd: pd.nn.Conv3D(4, 6, 3, padding=1, groups=2),
                  ["vol"]),
    "nn.Conv1DTranspose": (lambda pd: pd.nn.Conv1DTranspose(
        4, 2, 3, stride=2, padding=1), ["seq"]),
    "nn.Conv2DTranspose": (lambda pd: pd.nn.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, groups=2), ["img"]),
    "nn.Conv3DTranspose": (lambda pd: pd.nn.Conv3DTranspose(
        4, 3, 2, stride=2, padding=1), ["vol"]),
    "nn.MaxPool1D": (lambda pd: pd.nn.MaxPool1D(3, 2, 1), ["seq"]),
    "nn.AvgPool1D": (lambda pd: pd.nn.AvgPool1D(2), ["seq"]),
    "nn.MaxPool3D": (lambda pd: pd.nn.MaxPool3D(2), ["vol"]),
    "nn.AvgPool3D": (lambda pd: pd.nn.AvgPool3D(3, 1, 1), ["vol"]),
    "nn.AdaptiveAvgPool1D": (lambda pd: pd.nn.AdaptiveAvgPool1D(4), ["seq"]),
    "nn.AdaptiveMaxPool1D": (lambda pd: pd.nn.AdaptiveMaxPool1D(2), ["seq"]),
    "nn.AdaptiveMaxPool2D": (lambda pd: pd.nn.AdaptiveMaxPool2D(
        [3, 2], return_mask=True), ["img"]),
    "nn.AdaptiveAvgPool3D": (lambda pd: pd.nn.AdaptiveAvgPool3D(2), ["vol"]),
    "nn.AdaptiveMaxPool3D": (lambda pd: pd.nn.AdaptiveMaxPool3D(
        [4, 3, 2]), ["vol"]),
    "nn.BatchNorm1D": (lambda pd: pd.nn.BatchNorm1D(4), ["seq"]),
    "nn.BatchNorm3D": (lambda pd: pd.nn.BatchNorm3D(4), ["vol"]),
    "nn.SyncBatchNorm": (lambda pd: pd.nn.SyncBatchNorm(4), ["img"]),
    "nn.GroupNorm": (lambda pd: pd.nn.GroupNorm(2, 4), ["img"]),
    "nn.InstanceNorm1D": (lambda pd: pd.nn.InstanceNorm1D(4), ["seq"]),
    "nn.InstanceNorm2D": (lambda pd: pd.nn.InstanceNorm2D(4), ["img"]),
    "nn.InstanceNorm3D": (lambda pd: pd.nn.InstanceNorm3D(4), ["vol"]),
    "nn.LocalResponseNorm": (lambda pd: pd.nn.LocalResponseNorm(3),
                             ["img"]),
    "nn.SpectralNorm": (lambda pd: pd.nn.SpectralNorm([3, 5], power_iters=2),
                        ["w35"]),
    "nn.Pad1D": (lambda pd: pd.nn.Pad1D([2, 1], mode="reflect"), ["seq"]),
    "nn.Pad2D": (lambda pd: pd.nn.Pad2D([1, 0, 2, 3], mode="edge"),
                 ["img"]),
    "nn.Pad3D": (lambda pd: pd.nn.Pad3D(1, mode="reflect"), ["vol"]),
    "nn.Upsample": (lambda pd: pd.nn.Upsample(scale_factor=2,
                                              mode="bilinear"), ["img"]),
    "nn.UpsamplingBilinear2D": (lambda pd: pd.nn.UpsamplingBilinear2D(
        size=[5, 11]), ["img"]),
    "nn.UpsamplingNearest2D": (lambda pd: pd.nn.UpsamplingNearest2D(
        scale_factor=1.5), ["img"]),
    "nn.PixelShuffle": (lambda pd: pd.nn.PixelShuffle(3), ["img9"]),
    "nn.PRelu": (lambda pd: pd.nn.PRelu("channel", 4), ["img"]),
    "nn.Maxout": (lambda pd: pd.nn.Maxout(2), ["img"]),
    "nn.ThresholdedReLU": (lambda pd: pd.nn.ThresholdedReLU(0.3), ["vec"]),
    "nn.LogSoftmax": (lambda pd: pd.nn.LogSoftmax(0), ["vec"]),
    "nn.Bilinear": (lambda pd: pd.nn.Bilinear(4, 5, 2), ["vec", "vec2"]),
    "nn.BilinearTensorProduct": (lambda pd: pd.nn.BilinearTensorProduct(
        4, 5, 3), ["vec", "vec2"]),
    "nn.BCEWithLogitsLoss": (lambda pd: pd.nn.BCEWithLogitsLoss("sum"),
                             ["vec", "bin"]),
    "nn.MarginRankingLoss": (lambda pd: pd.nn.MarginRankingLoss(0.2),
                             ["col", "col2", "sign"]),
    "nn.CosineSimilarity": (lambda pd: pd.nn.CosineSimilarity(0),
                            ["vec", "bin"]),
    "nn.PairwiseDistance": (lambda pd: pd.nn.PairwiseDistance(3.0),
                            ["vec", "bin"]),
}


FORWARD_ONLY = {
    "nn.MaxPool1D", "nn.AvgPool1D", "nn.MaxPool3D", "nn.AvgPool3D",
    "nn.AdaptiveAvgPool1D", "nn.AdaptiveMaxPool1D", "nn.AdaptiveMaxPool2D",
    "nn.AdaptiveAvgPool3D", "nn.AdaptiveMaxPool3D", "nn.Pad1D", "nn.Pad2D",
    "nn.Pad3D", "nn.Upsample", "nn.UpsamplingBilinear2D",
    "nn.UpsamplingNearest2D", "nn.PixelShuffle", "nn.Maxout",
    "nn.ThresholdedReLU", "nn.LogSoftmax", "nn.LocalResponseNorm",
    "dygraph.Flatten"}


def _layer_run(pd, dy, enter, case, state=None):
    """The layer's state (as numpy), its outputs over two calls and the
    first input's gradient."""
    name, (make, keys) = case
    enter()
    try:
        np.random.seed(0)
        layer = make(pd)
        if state is None:
            state = {k: _np(v) for k, v in layer.state_dict().items()}
        else:
            interop.layer_from_numpy(layer, state)
        ins = [dy.to_variable(A[k]) for k in keys]
        grad = name not in FORWARD_ONLY
        ins[0].stop_gradient = not grad
        out = layer(*ins)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        vals = [np.asarray(o.numpy()) for o in outs]
        if grad:
            L = pd.fluid.layers
            L.reduce_sum(L.sigmoid(outs[0])).backward()
            vals.append(np.asarray(ins[0].gradient()))
        vals.append(np.asarray(layer(*ins).numpy())
                    if not isinstance(out, (list, tuple)) else vals[0])
        return state, vals
    finally:
        dy.disable_dygraph()


def run_layers(cases):
    """Every class of ``cases`` in both packages, the port from the
    reference's state; a case that raises keeps its exception."""
    out = {}
    for case in cases.items():
        try:
            state, want = _layer_run(jp, jdy, jdy.enable_dygraph, case)
            _, got = _layer_run(
                tp, tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace()), case,
                state)
            out[case[0]] = (got, want)
        except Exception as e:      # noqa: BLE001  re-raised by its case
            out[case[0]] = e
    return out


def check_layer(res, name):
    if isinstance(res, Exception):
        raise res
    got, want = res
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, FWD_RTOL, f"{name} [{i}]")


@pytest.fixture(scope="module")
def layer_results():
    return run_layers(LAYERS)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name, layer_results):
    check_layer(layer_results[name], name)
