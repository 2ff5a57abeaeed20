"""The image layers' ``dygraph`` classes (``PRelu``,
``Conv2DTranspose``, ``Conv3D``, ``Conv3DTranspose``, ``InstanceNorm``,
``GroupNorm``, ``SpectralNorm``, ``BilinearTensorProduct``,
``Flatten``), as ``test_torch_image_classes.py`` holds the ``nn`` ones:
made in the reference, weights carried into the port, two calls' outputs
and the input's gradient within rtol 1e-4.
"""
import pytest

import jax

from test_torch_image_classes import check_layer, run_layers

jax.config.update("jax_platforms", "cpu")

DYGRAPH_LAYERS = {
    "dygraph.PRelu": (lambda pd: pd.dygraph.PRelu("all"), ["img"]),
    "dygraph.Conv2DTranspose": (lambda pd: pd.dygraph.Conv2DTranspose(
        4, 3, 3, output_size=[12, 16], padding=1, stride=2, act="relu"),
        ["img"]),
    "dygraph.Conv3D": (lambda pd: pd.dygraph.Conv3D(4, 2, 3, padding=1),
                       ["vol"]),
    "dygraph.Conv3DTranspose": (lambda pd: pd.dygraph.Conv3DTranspose(
        4, 2, 3, stride=2), ["vol"]),
    "dygraph.InstanceNorm": (lambda pd: pd.dygraph.InstanceNorm(4),
                             ["img"]),
    "dygraph.GroupNorm": (lambda pd: pd.dygraph.GroupNorm(4, 2, act="tanh"),
                          ["img"]),
    "dygraph.SpectralNorm": (lambda pd: pd.dygraph.SpectralNorm(
        [3, 5], dim=1, power_iters=2), ["w35"]),
    "dygraph.BilinearTensorProduct": (
        lambda pd: pd.dygraph.BilinearTensorProduct(4, 5, 3, act="sigmoid"),
        ["vec", "vec2"]),
    "dygraph.Flatten": (lambda pd: pd.dygraph.Flatten(1, 2), ["vol"]),
}


@pytest.fixture(scope="module")
def layer_results():
    return run_layers(DYGRAPH_LAYERS)


@pytest.mark.parametrize("name", sorted(DYGRAPH_LAYERS))
def test_dygraph_layer_matches_reference(name, layer_results):
    check_layer(layer_results[name], name)


def test_convert_sync_batchnorm_carries_the_state():
    """``SyncBatchNorm.convert_sync_batchnorm`` swaps each BatchNorm of a
    model for a SyncBatchNorm holding its parameters, moving statistics,
    epsilon and momentum, and one process computes BatchNorm2D's output
    with it, in both packages alike."""
    import numpy as np

    import paddle_tpu as jp
    from paddle_tpu.dygraph import base as jdy

    import paddle_tpu_torch as tp
    import paddle_tpu_torch.fluid as tfluid
    from paddle_tpu_torch.dygraph import base as tdy

    x = np.random.RandomState(3).randn(4, 3, 5, 5).astype("float32")
    outs = []
    for pd, dy, enter in ((jp, jdy, jdy.enable_dygraph),
                          (tp, tdy,
                           lambda: tdy.enable_dygraph(tfluid.CPUPlace()))):
        enter()
        try:
            bn = pd.nn.BatchNorm2D(3, momentum=0.8, epsilon=1e-3)
            bn._mean.set_value(np.array([0.5, -1.0, 2.0], "float32"))
            model = pd.nn.Sequential(pd.nn.Conv2D(3, 3, 1), bn)
            model = pd.nn.SyncBatchNorm.convert_sync_batchnorm(model)
            sync = model._sub_layers["1"]
            assert isinstance(sync, pd.nn.SyncBatchNorm)
            assert sync.weight is bn.weight and sync._mean is bn._mean
            assert sync._momentum == 0.8 and sync._epsilon == 1e-3
            model.eval()
            outs.append(model._sub_layers["1"](dy.to_variable(x)).numpy())
        finally:
            dy.disable_dygraph()
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
