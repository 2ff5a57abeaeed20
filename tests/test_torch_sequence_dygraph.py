"""The sequence tier under each package's tracer: the 27 builders of
``test_torch_sequence_layers.py`` with the reference's parameters handed
to the port by name (``shared_params``), and the classes ``dygraph``
``GRUUnit``, ``SequenceConv``, ``NCE`` and ``TreeConv``, ``nn.CTCLoss``
and ``nn.HSigmoidLoss``, made in the reference and carried into the port
through ``interop.layer_from_numpy``: outputs and the first input's
gradient within rtol 1e-4 of their largest value, ids equal.  ``NCE``
draws its negatives from its seed, so it is held to its contract.
"""
import numpy as np
import pytest

import jax

import paddle_tpu as jp
import paddle_tpu.fluid as jfluid
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.fluid import framework as jframework

import paddle_tpu_torch as tp
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.fluid import framework as tframework

from test_torch_rnn_ops import shared_params
from test_torch_op_sweep import assert_close
from test_torch_sequence_layers import (BUILDER_CASES, FAMILIES, FEED, RTOL,
                                        _family)

jax.config.update("jax_platforms", "cpu")


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


# --- the dygraph and nn classes ----------------------------------------------
def _class_run(pd, dy, enter, make, keys, state=None, grad=True):
    """The layer's state (reference: its ``state_dict()`` after a first
    call, which builds a lazy layer's parameters; port: carried in), its
    outputs and the first input's gradient of sum(sigmoid(out))."""
    enter()
    try:
        layer = make(pd)
        layer(*[dy.to_variable(FEED[k]) for k in keys])
        if state is None:
            state = {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
                     for k, v in layer.state_dict().items()}
        else:
            interop.layer_from_numpy(layer, state)
        ins = [dy.to_variable(FEED[k]) for k in keys]
        ins[0].stop_gradient = not grad
        out = layer(*ins)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        vals = [np.asarray(o.numpy()) for o in outs]
        if grad:
            L = pd.fluid.layers
            L.reduce_sum(L.sigmoid(outs[0])).backward()
            vals.append(np.asarray(ins[0].gradient()))
        return state, vals
    finally:
        dy.disable_dygraph()


CLASSES = {
    "dygraph.GRUUnit": (lambda pd: pd.dygraph.GRUUnit(12),
                        ["gru_in", "gru_h"]),
    "dygraph.SequenceConv": (lambda pd: pd.dygraph.SequenceConv(
        "sc", 5, filter_size=3, act="relu"), ["x"]),
    "dygraph.TreeConv": (lambda pd: pd.dygraph.TreeConv(3, 2, 4),
                         ["nodes", "edges"]),
    "nn.CTCLoss": (lambda pd: pd.nn.CTCLoss(blank=0),
                   ["logp", "lbl", "in_n", "lbl_n"]),
    "nn.CTCLoss sum": (lambda pd: pd.nn.CTCLoss(blank=0, reduction="sum"),
                       ["logp", "lbl", "in_n", "lbl_n"]),
    "nn.HSigmoidLoss": (lambda pd: pd.nn.HSigmoidLoss(4, 7),
                        ["feat", "cls"]),
}


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_matches_reference(name):
    make, keys = CLASSES[name]
    state, want = _class_run(jp, jdy, jdy.enable_dygraph, make, keys)
    _, got = _class_run(tp, tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace()),
                        make, keys, state)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, RTOL, f"{name} [{i}]")


def test_nce_class_contract():
    """``dygraph.NCE``: the reference's weights carried in; the cost is
    ``nce``'s formula over the port's own samples (the op's contract,
    ``test_torch_sequence_ops``), its weight and bias shaped as the
    reference's, and its input's gradient finite."""
    make = lambda pd: pd.dygraph.NCE(7, 4, num_neg_samples=3, seed=2)  # noqa
    state, _ = _class_run(jp, jdy, jdy.enable_dygraph, make, ["feat", "cls"],
                          grad=False)
    assert [v.shape for v in state.values()] == [(7, 4), (7, 1)]
    tdy.enable_dygraph(tfluid.CPUPlace())
    try:
        layer = make(tp)
        interop.layer_from_numpy(layer, state)
        x = tdy.to_variable(FEED["feat"])
        x.stop_gradient = False
        cost = layer(x, tdy.to_variable(FEED["cls"]))
        assert cost.shape == [6, 1] or tuple(cost.shape) == (6, 1)
        tp.fluid.layers.reduce_sum(cost).backward()
        assert np.isfinite(cost.numpy()).all()
        assert np.isfinite(x.gradient()).all() and x.gradient().any()
    finally:
        tdy.disable_dygraph()
