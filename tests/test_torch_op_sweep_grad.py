"""The gradient half of the op sweep (``test_torch_op_sweep.py``): every
swept op type that both registries call differentiable, through each
package's ``generic_grad`` lowering (the reference's ``jax.vjp``, the
port's ``torch.func.vjp``) from the same inputs and the same random
cotangent of each float output; every input gradient within rtol 1e-3
(and 1e-3 of its largest value).  The grad slots are the spec's, else
each float input the op differentiates.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import registry as jreg

from paddle_tpu_torch.ops import registry as treg

from test_torch_op_sweep import (SWEPT, _jctx, _listed, _tctx,
                                 assert_outputs_match, run_both, spec_for)

GRAD_RTOL = 1e-3

DIFFERENTIABLE = [op for op in SWEPT
                  if treg.get_op(op).differentiable
                  and jreg.get_op(op).differentiable]


def check_generic_grad(op, ins, attrs, slots=None, rtol=GRAD_RTOL,
                       ref=None):
    """``op``'s ``generic_grad`` in both packages from ``ins`` and the same
    random cotangent of each float output: every input gradient of
    ``slots`` (by default, or when the spec lists none, each float input
    the op differentiates) within
    ``rtol``.  ``ref``: the reference's forward outputs, when the caller
    has them (they give the cotangents' shapes)."""
    jdef = jreg.get_op(op)
    if not slots:
        slots = [s for s, v in ins.items() if s not in jdef.nondiff_inputs
                 and np.asarray(_listed(v)[0]).dtype.kind == "f"]
    if ref is None:
        ref, _ = run_both(op, ins, attrs)
    rng = np.random.RandomState(5)
    cots = {}
    for s, vals in ref.items():
        arrs = [np.asarray(v) for v in vals if v is not None]
        if s not in jdef.nondiff_outputs and arrs \
                and all(a.dtype.kind == "f" for a in arrs):
            cots[s] = [np.asarray(rng.randn(*a.shape), a.dtype)
                       for a in arrs]
    assert cots and slots, op
    gattrs = {"fwd_type": op, "fwd_attrs": attrs, "grad_slots": slots,
              "in_slots": list(ins)}

    def grad_ins(conv):
        out = {"I_" + s: [conv(np.array(a)) for a in _listed(v)]
               for s, v in ins.items()}
        out.update({"G_" + s: [conv(c) for c in cs]
                    for s, cs in cots.items()})
        return out
    want = jreg.get_op("generic_grad").fn(grad_ins(jnp.asarray),
                                         dict(gattrs), _jctx())
    got = treg.get_op("generic_grad").fn(grad_ins(torch.from_numpy),
                                        dict(gattrs), _tctx())
    assert sorted(want) == sorted(got) == sorted("GI_" + s for s in slots)
    assert_outputs_match(want, got, rtol, f"{op} generic_grad")


@pytest.mark.parametrize("op", DIFFERENTIABLE)
def test_generic_grad_matches_reference(op):
    ins, attrs, slots = spec_for(op)
    check_generic_grad(op, ins, attrs, slots)
