"""The RNN tier: paddle_tpu_torch against paddle_tpu.

- The ``rnn_scan`` op (LSTM, GRU, RNN_TANH, RNN_RELU, each at one layer
  one way and two layers both ways, a given ``PreState``) against the
  reference's ``lax.scan`` lowering: ``Out`` and ``State``, and the vjp
  of a random cotangent into the input, every weight and the initial
  states (``jax.vjp`` against ``torch.func.vjp``).
- The ``nn`` layers ``LSTM``, ``GRU`` and ``SimpleRNN`` (batch first and
  ``time_major``, given ``initial_states`` or the zero default; the cells
  are in ``test_torch_rnn_cells.py``): each built in both packages from one ``state_dict`` (the reference's,
  carried by ``interop.layer_from_numpy``), run eagerly, the outputs and
  states held to rtol 1e-5, and the first step's gradients of
  ``sum(out · c)`` (the tape in both packages) to rtol 1e-5 of each
  tensor's largest value.
- The small ops under them: ``split``, ``stack``, ``fill_any_like``,
  ``fill_zeros_like``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid.layers as jL
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.dygraph import rnn as jrnn
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.nn import layer as jlayer
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.fluid.layers as tL
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.dygraph import rnn as trnn
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.nn import layer as tlayer
from paddle_tpu_torch.ops import registry as treg

B, T, D, H = 2, 3, 4, 5
GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------
def _scan_inputs(mode, layers, ndir, seed):
    rng = np.random.RandomState(seed)
    g = GATES[mode]
    ws = []
    for layer in range(layers):
        in_d = D if layer == 0 else H * ndir
        for _ in range(ndir):
            ws += [0.4 * rng.randn(g * H, in_d), 0.4 * rng.randn(g * H, H),
                   0.1 * rng.randn(g * H), 0.1 * rng.randn(g * H)]
    states = [rng.randn(layers * ndir, B, H)]
    if mode == "LSTM":
        states.append(rng.randn(layers * ndir, B, H))
    x = rng.randn(B, T, D)
    f32 = [np.asarray(a, "float32") for a in [x] + ws + states]
    return f32[0], f32[1:1 + len(ws)], f32[1 + len(ws):]


# each mode at one layer one way and at two layers both ways, and the
# two mixed shapes for the LSTM
SCAN_CASES = [(m, n, n) for m in GATES for n in (1, 2)] + \
    [("LSTM", 1, 2), ("LSTM", 2, 1)]


@pytest.mark.parametrize("mode,layers,ndir", SCAN_CASES,
                         ids=[f"{m}-{n}l-{d}d" for m, n, d in SCAN_CASES])
def test_rnn_scan_matches_reference(mode, layers, ndir):
    x, ws, states = _scan_inputs(mode, layers, ndir, seed=layers * 10 + ndir)
    attrs = {"mode": mode, "num_layers": layers,
             "bidirectional": ndir == 2}
    nw, ns = len(ws), len(states)

    def ins_of(args):
        return {"Input": [args[0]], "WeightList": list(args[1:1 + nw]),
                "PreState": list(args[1 + nw:])}

    def j_fn(*args):
        out = jreg.get_op("rnn_scan").fn(ins_of(args), dict(attrs),
                                         jreg.LoweringContext())
        return (out["Out"][0],) + tuple(out["State"])

    def t_fn(*args):
        out = treg.get_op("rnn_scan").fn(ins_of(args), dict(attrs),
                                         treg.LoweringContext())
        return (out["Out"][0],) + tuple(out["State"])

    args = [x] + ws + states
    j_outs, j_vjp = jax.vjp(j_fn, *[jnp.asarray(a) for a in args])
    t_outs, t_vjp = torch.func.vjp(t_fn, *[torch.from_numpy(a.copy())
                                           for a in args])
    assert len(j_outs) == len(t_outs) == 1 + ns
    assert tuple(t_outs[0].shape) == (B, T, H * ndir)
    for j, t in zip(j_outs, t_outs):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    rng = np.random.RandomState(99)
    cots = [rng.randn(*np.shape(j)).astype("float32") for j in j_outs]
    j_grads = j_vjp(tuple(jnp.asarray(c) for c in cots))
    t_grads = t_vjp(tuple(torch.from_numpy(c) for c in cots))
    for i, (j, t) in enumerate(zip(j_grads, t_grads)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                                   atol=1e-5 * np.abs(j).max() + 1e-6,
                                   err_msg=f"input {i}")


# ---------------------------------------------------------------------------
# layers and cells, the reference's weights carried across
# ---------------------------------------------------------------------------
def _close_each(got, want, name):
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            got[k], w, rtol=1e-5, atol=1e-5 * np.abs(w).max() + 1e-6,
            err_msg=f"{name}: {k}")


def _flat(outs):
    """Every VarBase in a nest of tuples and lists, in order."""
    if isinstance(outs, (list, tuple)):
        return [v for o in outs for v in _flat(o)]
    return [outs]


def _run(pkg, build, call, inputs, state=None):
    """Build the layer in ``pkg``, load ``state`` (or keep the reference's
    own), run ``call`` on the inputs and back-propagate ``sum(out · c)``
    over every output; (state, outputs, parameter gradients)."""
    dy, mods = (jdy, (jlayer, jrnn, jL)) if pkg == "j" \
        else (tdy, (tlayer, trnn, tL))
    framework = jframework if pkg == "j" else tframework
    framework.reset_unique_name()
    with dy.guard() if pkg == "j" else dy.guard(tfluid.CPUPlace()):
        layer = build(*mods)
        if state is None:
            state = layer.state_dict()
        else:
            assert list(layer.state_dict()) == list(state)
            interop.layer_from_numpy(layer, state)
        vs = [dy.to_variable(a) for a in inputs]
        outs = _flat(call(layer, mods, vs))
        rng = np.random.RandomState(5)
        loss = None
        for o in outs:
            c = dy.to_variable(rng.randn(*o.shape).astype("float32"))
            term = mods[2].reduce_sum(o * c)
            loss = term if loss is None else loss + term
        loss.backward()
        grads = {n: np.asarray(p.gradient())
                 for n, p in layer.named_parameters()}
        return state, [np.asarray(o.numpy()) for o in outs], grads


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _h0(layers_dirs, seed):
    return _x(layers_dirs, B, H, seed=seed)


LAYER_CASES = {
    "lstm_1l": (lambda nn, r, L: nn.LSTM(D, H),
                lambda m, mods, v: m(v[0]), [_x(B, T, D)]),
    "lstm_2l_bidirect_given_states": (
        lambda nn, r, L: nn.LSTM(D, H, num_layers=2, direction="bidirect"),
        lambda m, mods, v: m(v[0], (v[1], v[2])),
        [_x(B, T, D), _h0(4, 1), _h0(4, 2)]),
    "gru_2l": (lambda nn, r, L: nn.GRU(D, H, num_layers=2),
               lambda m, mods, v: m(v[0]), [_x(B, T, D)]),
    "gru_bidirect_given_state": (
        lambda nn, r, L: nn.GRU(D, H, direction="bidirectional"),
        lambda m, mods, v: m(v[0], v[1]), [_x(B, T, D), _h0(2, 3)]),
    "simple_rnn_relu_positional": (
        lambda nn, r, L: nn.SimpleRNN(D, H, 2, "relu"),
        lambda m, mods, v: m(v[0]), [_x(B, T, D)]),
    "simple_rnn_tanh_time_major_bidirect": (
        lambda nn, r, L: nn.SimpleRNN(D, H, 1, "tanh", "bidirect",
                                      time_major=True),
        lambda m, mods, v: m(v[0]), [_x(T, B, D)]),
}


def check_against_reference(case, build, call, inputs):
    """``build`` in both packages from the reference's state, ``call``d
    on ``inputs``: the outputs and the parameters' gradients agree."""
    state, want_outs, want_grads = _run("j", build, call, inputs)
    _, got_outs, got_grads = _run("t", build, call, inputs, state)
    assert len(got_outs) == len(want_outs)
    for i, (g, w) in enumerate(zip(got_outs, want_outs)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=f"output {i}")
    assert set(got_grads) == set(want_grads)
    _close_each(got_grads, want_grads, case)
    assert any(np.abs(g).max() > 0 for g in got_grads.values())


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_reference(case):
    check_against_reference(case, *LAYER_CASES[case])


def test_parameter_names_and_layout_follow_the_reference():
    built = {}
    for pkg, nn, fw in (("j", jlayer, jframework), ("t", tlayer, tframework)):
        fw.reset_unique_name()
        with jdy.guard() if pkg == "j" else tdy.guard(tfluid.CPUPlace()):
            m = nn.LSTM(D, H, num_layers=2, direction="bidirect")
            built[pkg] = [(k, p.name, tuple(p.shape))
                          for k, p in m.named_parameters()]
    assert built["t"] == built["j"]
    assert built["t"][0] == ("l0d0_0", "lstm.w_0", (4 * H, D))
    assert built["t"][4][2] == (4 * H, D)           # reverse of layer 0
    assert built["t"][8][2] == (4 * H, 2 * H)       # layer 1 takes both


# ---------------------------------------------------------------------------
# the small ops
# ---------------------------------------------------------------------------
_A = _x(4, 6, 2)
OP_CASES = {
    "split_num": ("split", {"X": [_A]}, {"axis": 1, "num": 3}),
    "split_sections_rest": ("split", {"X": [_A]},
                            {"axis": 1, "sections": [1, -1, 2]}),
    "split_last_axis": ("split", {"X": [_A]}, {"axis": -1, "num": 2}),
    "stack": ("stack", {"X": [_A, _A * 2, _A - 1]}, {"axis": 1}),
    "stack_last": ("stack", {"X": [_A, _A]}, {"axis": -1}),
    "fill_any_like": ("fill_any_like", {"X": [_A]}, {"value": 1.0}),
    "fill_any_like_dtype": ("fill_any_like", {"X": [_A]},
                            {"value": 3.0, "dtype": "int32"}),
    "fill_zeros_like": ("fill_zeros_like", {"X": [_A]}, {}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_small_op_matches_reference(case):
    op_type, ins, attrs = OP_CASES[case]
    j_out = jreg.get_op(op_type).fn(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs), jreg.LoweringContext())
    t_out = treg.get_op(op_type).fn(
        {s: [torch.from_numpy(a.copy()) for a in v] for s, v in ins.items()},
        dict(attrs), treg.LoweringContext())
    assert set(j_out) == set(t_out)
    for slot in j_out:
        assert len(j_out[slot]) == len(t_out[slot])
        for j, t in zip(j_out[slot], t_out[slot]):
            assert tuple(j.shape) == tuple(t.shape)
            assert np.dtype(str(j.dtype)).kind == \
                np.dtype(str(t.dtype).removeprefix("torch.")).kind
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_split_refuses_an_uneven_num():
    with pytest.raises(ValueError, match="divisible"):
        treg.get_op("split").fn({"X": [torch.zeros(4, 5)]},
                                {"axis": 1, "num": 2},
                                treg.LoweringContext())
