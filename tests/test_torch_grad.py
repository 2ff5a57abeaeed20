"""paddle.grad, the partial-grad engine, in both packages.

The fourteen cases of ``tests/test_dygraph_grad.py`` (first order
against the analytic value, ``grad_outputs``, ``allow_unused``, a
gradient with respect to an intermediate, ``no_grad_vars`` at a leaf and
mid-graph, freeing the replayed graph and keeping unrelated ones, the
double backward of a gradient penalty reaching other parameters, the
length mismatch refused, and the eager dropout's backward mask) run in
``paddle_tpu`` and ``paddle_tpu_torch`` from the same numpy inputs; the
values must agree with each other and with the analytic ones.  One more
case: ``paddle.grad`` with a dropout live gives what ``loss.backward()``
gives on the same tape, because the replay uses the recorded seeds.
"""
import types

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.fluid import layers as JL

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.fluid import layers as TL

REF = types.SimpleNamespace(grad=jpaddle.grad, dy=jdy, L=JL,
                            enter=lambda: jdy.enable_dygraph(),
                            leave=jdy.disable_dygraph)
PORT = types.SimpleNamespace(grad=tpaddle.grad, dy=tdy, L=TL,
                             enter=lambda: tdy.enable_dygraph(
                                 tfluid.CPUPlace()),
                             leave=tdy.disable_dygraph)


def _var(P, a, trainable=True):
    v = P.dy.to_variable(np.asarray(a, "float32"))
    v.stop_gradient = not trainable
    return v


def _np(v):
    """A result VarBase's value as numpy."""
    return np.asarray(v.numpy(), dtype="float64")


def _grad_np(v):
    """A leaf's accumulated gradient as numpy (None when it has none)."""
    return None if v.gradient_var is None else np.asarray(v.grad,
                                                          "float64")


def first_order(P):
    x = _var(P, [[1.0, 2.0], [3.0, 4.0]])
    y = P.L.reduce_sum(P.L.square(x))
    (gx,) = P.grad([y], [x])
    return {"gx": _np(gx), "x.grad is None": x.grad is None}


def grad_outputs_seed(P):
    x = _var(P, np.ones((2, 2)))
    y = P.L.scale(x, scale=3.0)
    seed = _var(P, np.full((2, 2), 2.0), trainable=False)
    (gx,) = P.grad([y], [x], grad_outputs=[seed])
    return {"gx": _np(gx)}


def unused_input(P):
    x, z = _var(P, np.ones(2)), _var(P, np.ones(2))
    y = P.L.reduce_sum(P.L.square(x))
    with pytest.raises(RuntimeError, match="unreachable"):
        P.grad([y], [x, z], retain_graph=True)
    gx, gz = P.grad([y], [x, z], allow_unused=True)
    return {"gx": _np(gx), "gz is None": gz is None}


def double_backward_penalty(P):
    x = _var(P, [[1.0, -2.0]])
    y = P.L.reduce_sum(P.L.square(x))
    (gx,) = P.grad([y], [x], create_graph=True)
    (ggx,) = P.grad([P.L.reduce_sum(P.L.square(gx))], [x])
    return {"ggx": _np(ggx)}


def double_backward_via_backward(P):
    x = _var(P, [2.0])
    y = P.L.reduce_sum(x * x * x)
    (gx,) = P.grad([y], [x], create_graph=True)
    P.L.reduce_sum(P.L.square(gx)).backward()
    return {"x.grad": _grad_np(x)}


def penalty_reaches_other_params(P):
    w = _var(P, [[2.0], [3.0]])
    x = _var(P, np.ones((4, 2)))
    y = P.L.reduce_sum(P.L.matmul(x, w))
    (gx,) = P.grad([y], [x], create_graph=True)
    P.L.reduce_mean(P.L.square(gx)).backward()
    return {"w.grad": _grad_np(w)}


def grad_wrt_intermediate(P):
    x = _var(P, [2.0])
    h = P.L.square(x)
    y = P.L.reduce_sum(P.L.square(h))
    (gh,) = P.grad([y], [h], retain_graph=True)
    return {"gh": _np(gh)}


def no_grad_vars_frozen(P):
    w = _var(P, [[3.0]])
    x = _var(P, np.ones((2, 1)))
    y = P.L.reduce_sum(P.L.matmul(x, w))
    (gx,) = P.grad([y], [x], create_graph=True, no_grad_vars=[w])
    P.L.reduce_sum(P.L.square(gx)).backward()
    with pytest.raises(ValueError, match="no_grad_vars"):
        P.grad([y], [x], no_grad_vars=[x])
    return {"w.grad is None": w.gradient_var is None, "x.grad": _grad_np(x)}


def default_frees_graph(P):
    tracer = P.dy._dygraph_tracer()
    x = _var(P, np.ones(2))
    y = P.L.reduce_sum(P.L.square(x))
    before = len(tracer._tape) > 0
    P.grad([y], [x])
    return {"recorded": before, "freed": len(tracer._tape) == 0}


def keeps_unrelated_graphs(P):
    a, x = _var(P, np.ones(2)), _var(P, np.ones(2))
    y1 = P.L.reduce_sum(P.L.square(a))
    y2 = P.L.reduce_sum(P.L.square(x))
    P.grad([y2], [x])
    y1.backward()
    return {"a.grad": _grad_np(a)}


def create_graph_frees_but_keeps_its_op(P):
    x = _var(P, [2.0])
    y = P.L.reduce_sum(P.L.square(x))
    (gx,) = P.grad([y], [x], create_graph=True, retain_graph=False)
    P.L.reduce_sum(P.L.square(gx)).backward()
    return {"x.grad": _grad_np(x)}


def no_grad_vars_mid_graph(P):
    x = _var(P, [2.0])
    u = P.L.square(x)
    y = P.L.reduce_sum(P.L.square(u))
    (gx,) = P.grad([y], [x], no_grad_vars=[u], allow_unused=True,
                   retain_graph=True)
    (gx2,) = P.grad([y], [x])
    return {"frozen": _np(gx), "full": _np(gx2)}


def length_mismatch(P):
    x = _var(P, np.ones(2))
    y1 = P.L.reduce_sum(P.L.square(x))
    y2 = P.L.reduce_sum(x)
    seed = _var(P, np.ones(()), trainable=False)
    with pytest.raises(ValueError, match="lengths must match"):
        P.grad([y1, y2], [x], grad_outputs=[seed])
    return {}


def dropout_backward_mask(P):
    """The backward regenerates the forward's mask: the gradient is
    zero exactly where the output is."""
    x = _var(P, np.ones((4, 64)))
    y = P.L.dropout(x, dropout_prob=0.5)
    P.L.reduce_sum(y).backward()
    out, g = y.numpy(), np.asarray(x.grad)
    return {"mask matches": bool(((out != 0) == (g != 0)).all()),
            "dropped some": bool((out == 0).any() and (out != 0).any())}


def grad_with_dropout_equals_backward(P):
    """paddle.grad replays the tape under each entry's recorded seed, so
    a live dropout draws the same mask: its gradient is what
    ``backward()`` leaves on the same tape."""
    w = _var(P, np.random.RandomState(5).randn(8, 16))
    x = _var(P, np.random.RandomState(6).randn(4, 8), trainable=False)
    h = P.L.dropout(P.L.matmul(x, w), dropout_prob=0.5,
                    dropout_implementation="upscale_in_train")
    loss = P.L.reduce_sum(P.L.square(h))
    (gw,) = P.grad([loss], [w], retain_graph=True)
    loss.backward()
    return {"same": bool(np.allclose(_np(gw), _grad_np(w), rtol=1e-6)),
            "nonzero": bool(np.abs(_np(gw)).sum() > 0)}


# case -> the analytic values both packages must give
CASES = {
    "first_order": (first_order, {"gx": 2 * np.array([[1.0, 2.0],
                                                       [3.0, 4.0]]),
                                  "x.grad is None": True}),
    "grad_outputs_seed": (grad_outputs_seed, {"gx": np.full((2, 2), 6.0)}),
    "unused_input": (unused_input, {"gx": np.full(2, 2.0),
                                    "gz is None": True}),
    "double_backward_penalty": (double_backward_penalty,
                                {"ggx": np.array([[8.0, -16.0]])}),
    "double_backward_via_backward": (double_backward_via_backward,
                                     {"x.grad": np.array([36 * 8.0])}),
    "penalty_reaches_other_params": (penalty_reaches_other_params,
                                     {"w.grad": np.array([[2.0], [3.0]])}),
    "grad_wrt_intermediate": (grad_wrt_intermediate,
                              {"gh": np.array([8.0])}),
    "no_grad_vars_frozen": (no_grad_vars_frozen,
                            {"w.grad is None": True,
                             "x.grad": np.zeros((2, 1))}),
    "default_frees_graph": (default_frees_graph,
                            {"recorded": True, "freed": True}),
    "keeps_unrelated_graphs": (keeps_unrelated_graphs,
                               {"a.grad": np.full(2, 2.0)}),
    "create_graph_frees_but_keeps_its_op": (
        create_graph_frees_but_keeps_its_op, {"x.grad": np.array([16.0])}),
    "no_grad_vars_mid_graph": (no_grad_vars_mid_graph,
                               {"frozen": np.array([0.0]),
                                "full": np.array([32.0])}),
    "length_mismatch": (length_mismatch, {}),
    "dropout_backward_mask": (dropout_backward_mask,
                              {"mask matches": True, "dropped some": True}),
    "grad_with_dropout_equals_backward": (
        grad_with_dropout_equals_backward, {"same": True, "nonzero": True}),
}


def _run(P, fn):
    P.enter()
    try:
        return fn(P)
    finally:
        P.leave()


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_case_matches_reference_and_analytic(case):
    fn, want = CASES[case]
    ref, got = _run(REF, fn), _run(PORT, fn)
    assert set(got) == set(ref) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(got[k], w, rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        else:
            assert got[k] == ref[k] == w, k
