"""A reduced CycleGAN (``chip_smoke.cyclegan_nets``, the phase 4s model
at ngf 8, 2 residual blocks, 32x32, batch 1) in both packages, weights
carried from the reference (``interop.layer_from_numpy``; the static
program's persistables by name):

- the dygraph 2.0 loop (``chip_smoke.cyclegan_step``): the first step's
  four losses (the generators' LSGAN, cycle and identity terms, the
  discriminators') within rtol 1e-4, the first-step gradients of all four
  networks as one vector to a cosine of at least 0.9999 and a norm
  within 1e-3.  The first step's losses and gradients precede every
  update, so the reference's step runs without its optimizers' updates
  (each an op to compile per parameter shape); the port's runs its Adam.
- the generator as a static program (``chip_smoke.
  cyclegan_generator_program``: ``fluid.layers.pad2d``, ``conv2d``,
  ``instance_norm``, ``conv2d_transpose(output_size=...)``, Adam): its
  output within rtol 1e-4 of its largest value, its loss over two steps
  and its first gradients as above.

The reference's ``nn.functional.conv2d_transpose`` drops
``output_padding`` and its ``fluid.layers.conv2d_transpose`` drops
``output_size``, so its networks are built over its op with them
(``_ref_conv_t``, ``_ref_conv_t_layer``).
"""
import numpy as np

import jax

import paddle_tpu as jp
import paddle_tpu.fluid as jfluid
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.fluid.layer_helper import LayerHelper as JHelper
from paddle_tpu.fluid.layer_helper import emit_op as jemit

import paddle_tpu_torch as tp
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy

import chip_smoke as C
from test_torch_control_flow import run_both as run_static
from test_torch_image_layers import FWD_RTOL, _np
from test_torch_op_sweep import assert_close

jax.config.update("jax_platforms", "cpu")


CG = dict(C.CYCLEGAN_HOST, size=32)


def _ref_conv_t(x, w, b, stride, padding, output_padding):
    """The reference's op with ``output_padding`` (its function drops
    it)."""
    out = jemit("conv2d_transpose", "conv2d_transpose",
                {"Input": [x], "Filter": [w]}, ("Output",),
                {"strides": [stride] * 2, "paddings": [padding] * 2,
                 "output_padding": [output_padding] * 2})["Output"][0]
    return jp.fluid.layers.elementwise_add(out, b, axis=1)


def _ref_conv_t_layer(input, num_filters, output_size, filter_size, stride,
                      padding):
    """The reference's builder with ``output_size`` reaching the op (its
    builder drops it), the parameters made in the builder's order."""
    helper = JHelper("conv2d_transpose")
    w = helper.create_parameter(None, [input.shape[1], num_filters,
                                       filter_size, filter_size],
                                input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": [stride] * 2,
                            "paddings": [padding] * 2,
                            "output_size": list(output_size)})
    b = helper.create_parameter(None, [num_filters], input.dtype,
                                is_bias=True)
    return helper.append_bias_op(out, b, axis=1)


class _NoUpdate:
    """The reference's side of the first step: gradients cleared, no
    update (the first step's losses and gradients precede it)."""

    def __init__(self, params):
        self._params = params

    def step(self):
        pass

    def clear_grad(self):
        for p in self._params:
            p.clear_gradient()


def _cyclegan_first_step(pd, dy, enter, state=None, conv_t=None, opts=None):
    a, b = C.cyclegan_images(CG, C.SEED + 71)
    enter()
    try:
        np.random.seed(0)
        nets = C.cyclegan_nets(pd, CG, conv_t)
        if state is None:
            state = [{k: _np(v) for k, v in n.state_dict().items()}
                     for n in nets]
        else:
            for n, s in zip(nets, state):
                interop.layer_from_numpy(n, s)
        opts = opts(nets) if opts else C.cyclegan_optimizers(pd, nets)
        grads = []
        losses = C.cyclegan_step(pd, nets, opts, dy.to_variable(a),
                                 dy.to_variable(b), grads)
        return state, {"losses": [float(np.asarray(v.numpy()).ravel()[0])
                                  for v in losses], "grads": grads}
    finally:
        dy.disable_dygraph()


def _no_update(nets):
    g_a, g_b, d_a, d_b = nets
    return (_NoUpdate(g_a.parameters() + g_b.parameters()),
            _NoUpdate(d_a.parameters() + d_b.parameters()))


def _within(got, want, names=C.CYCLEGAN_LOSSES):
    """Each criterion's error over its tolerance (under 1 passes)."""
    cos, norm = C._cosine(got["grads"], want["grads"])
    out = {f"loss {k}": abs(g - w) / abs(w) / 1e-4
           for k, g, w in zip(names, got["losses"], want["losses"])}
    out.update({"gradient cosine": (1 - cos) / 1e-4,
                "gradient norm": abs(norm - 1) / 1e-3})
    return out


def test_cyclegan_dygraph_step_matches_reference():
    """The first step's four losses and the gradients of all four
    networks, the port's Adam after it."""
    state, want = _cyclegan_first_step(jp, jdy, jdy.enable_dygraph,
                                       conv_t=_ref_conv_t, opts=_no_update)
    _, got = _cyclegan_first_step(
        tp, tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace()), state)
    n_params = sum(v.size for s in state for v in s.values())
    assert n_params == sum(g.size for g in got["grads"])
    margins = _within(got, want)
    assert max(margins.values()) < 1, margins


def test_cyclegan_static_generator_matches_reference():
    """The generator program of ``fluid.layers.pad2d``, ``conv2d``,
    ``instance_norm`` and ``conv2d_transpose(output_size=...)``: its
    output, its loss over two Adam steps and its first gradients, from
    the reference's startup."""
    a, b = C.cyclegan_images(CG, C.SEED + 72)

    def build(fluid):
        conv_t = _ref_conv_t_layer if fluid is jfluid else None
        fake, loss, pg = C.cyclegan_generator_program(fluid, CG, conv_t)
        return [fake, loss] + [g for _, g in pg]
    ref, port, _ = run_static(build, {"real_a": a, "real_b": b}, runs=2)
    assert ref[0][0].shape == (1, 3, 32, 32)
    assert_close(np.asarray(port[0][0]), ref[0][0], FWD_RTOL, "fake")
    margins = _within({"losses": [float(np.asarray(r[1])) for r in port],
                       "grads": [np.asarray(g) for g in port[0][2:]]},
                      {"losses": [float(np.asarray(r[1])) for r in ref],
                       "grads": [np.asarray(g) for g in ref[0][2:]]},
                      ("step 1", "step 2"))
    assert max(margins.values()) < 1, margins
