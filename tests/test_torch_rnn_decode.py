"""The static RNN tier's cells and decoders: paddle_tpu_torch against
paddle_tpu.

- The beam-search ops (``beam_search`` accumulated and not, with
  finished beams; ``gather_tree``; ``beam_search_decode``) through both
  lowerings, and through their ``fluid.layers`` builders in a static
  program and under the tracer: ids equal (the reference's are int32,
  the port's int64: values are compared), scores within rtol 1e-6.
- ``sampling_id``'s contract (ROADMAP ground rule 5: draws are never
  compared across packages): int64 ids of the input's leading shape,
  each in range, never a class of probability 0, a one-hot row's class
  always, one op seed the same draws, the frequencies of 20,000 draws
  within 6 sigma of the probabilities.
- ``LSTMCell`` and ``GRUCell`` through ``rnn`` (batch and time major,
  from the end, the ``sequence_length`` mask, given states) and
  ``birnn``, static and under the tracer (each parameter the reference
  made given to the port under its name): outputs, states and the
  parameters' gradients within rtol 1e-5.
- The decoders under the tracer: ``BasicDecoder`` with
  ``TrainingHelper`` and ``GreedyEmbeddingHelper``, with
  ``SampleEmbeddingHelper`` at logits so sharp that each draw is the
  argmax, ``BeamSearchDecoder`` through ``dynamic_decode`` and through
  ``decode()``, over one cell and over a two-``LSTMCell`` stack: ids
  equal, outputs within rtol 1e-5, the same number of steps.  The output
  weights are drawn wide, so no step's beam edge is a near tie.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.ops import registry as treg

from test_torch_rnn_ops import (_close, _programs, _rnd, dygraph_run,
                                shared_params)

jax.config.update("jax_platforms", "cpu")

B, BEAM, V, T = 2, 3, 7, 4


# ---------------------------------------------------------------------------
# the beam-search ops
# ---------------------------------------------------------------------------
def _beam_inputs(seed):
    rng = np.random.RandomState(seed)
    pre_ids = rng.randint(0, V, (B * BEAM, 1)).astype("int64")
    pre_ids[1, 0] = pre_ids[4, 0] = 1           # two finished beams
    return {"pre_ids": pre_ids,
            "pre_scores": rng.randn(B * BEAM, 1).astype("float32"),
            "ids": np.zeros((B * BEAM, 1), "int64"),
            "scores": rng.randn(B * BEAM, V).astype("float32")}


def _tree(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (T, B, BEAM)).astype("int64"),
            rng.randint(0, BEAM, (T, B, BEAM)).astype("int64"))


def _probs(seed):
    p = np.random.RandomState(seed).rand(B * BEAM, V).astype("float32")
    return p / p.sum(-1, keepdims=True)


NLP_CASES = {
    "beam_search_accumulated": ("beam_search", _beam_inputs(1),
                                {"beam_size": BEAM, "end_id": 1}),
    "beam_search_probabilities": (
        "beam_search", dict(_beam_inputs(2), scores=_probs(3)),
        {"beam_size": BEAM, "end_id": 1, "is_accumulated": False}),
    "gather_tree": ("gather_tree", dict(zip(("Ids", "Parents"), _tree(4))),
                    {}),
    "beam_search_decode": (
        "beam_search_decode",
        dict(zip(("Ids", "ParentIdx"), _tree(5)),
             Scores=_rnd(T, B, BEAM, seed=6)), {"beam_size": BEAM,
                                                "end_id": 1}),
}


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        assert got.dtype == np.int64, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=what)


@pytest.mark.parametrize("case", sorted(NLP_CASES))
def test_nlp_op_matches_reference(case):
    op, ins, attrs = NLP_CASES[case]
    want = jreg.get_op(op).fn({k: [jnp.asarray(v)] for k, v in ins.items()},
                              dict(attrs), jreg.LoweringContext())
    got = treg.get_op(op).fn({k: [torch.from_numpy(v.copy())]
                              for k, v in ins.items()}, dict(attrs),
                             treg.LoweringContext())
    assert sorted(got) == sorted(want)
    for slot in want:
        _same(got[slot][0].numpy(), want[slot][0], slot)


def _beam_builders(L, xs):
    ids, scores, parent = L.beam_search(
        xs["pre_ids"], xs["pre_scores"], xs["ids"], xs["scores"], BEAM, 1,
        return_parent_idx=True)
    sel = L.beam_search(xs["pre_ids"], xs["pre_scores"], xs["ids"],
                        xs["probs"], BEAM, 1, is_accumulated=False)
    tree = L.gather_tree(xs["t_ids"], xs["t_par"])
    sent, sent_scores = L.beam_search_decode(
        xs["t_ids"], xs["t_scores"], BEAM, 1, parent_idx=xs["t_par"])
    return [ids, scores, parent, sel[0], sel[1], tree, sent, sent_scores]


BEAM_FEEDS = dict(_beam_inputs(7), probs=_probs(8),
                  **dict(zip(("t_ids", "t_par"), _tree(9))),
                  t_scores=_rnd(T, B, BEAM, seed=10))


def _feed_var(fluid, name, value):
    return fluid.data(name, list(value.shape), dtype=str(value.dtype))


def test_beam_builders_static_match_reference():
    def build(fluid):
        xs = {k: _feed_var(fluid, k, v) for k, v in BEAM_FEEDS.items()}
        return _beam_builders(fluid.layers, xs)
    ref, port = _programs(build)(BEAM_FEEDS)
    for i, (g, w) in enumerate(zip(port, ref)):
        _same(g, w, f"fetch {i}")


def test_beam_builders_dygraph_match_reference():
    def fn(fluid, dy):
        xs = {k: dy.to_variable(v) for k, v in BEAM_FEEDS.items()}
        return _beam_builders(fluid.layers, xs)
    outs = {}
    for pkg in ("ref", "port"):
        fluid, dy = _pkg(pkg)
        with _guard(pkg):
            outs[pkg] = [np.asarray(o.numpy()) for o in fn(fluid, dy)]
    for i, (g, w) in enumerate(zip(outs["port"], outs["ref"])):
        _same(g, w, f"output {i}")


def _pkg(pkg):
    from paddle_tpu.dygraph import base as jdy
    from paddle_tpu_torch.dygraph import base as tdy
    return (jfluid, jdy) if pkg == "ref" else (tfluid, tdy)


def _guard(pkg):
    dy = _pkg(pkg)[1]
    return dy.guard() if pkg == "ref" else dy.guard(tfluid.CPUPlace())


# ---------------------------------------------------------------------------
# sampling_id: a contract
# ---------------------------------------------------------------------------
SAMPLE_P = np.array([0.5, 0.0, 0.3, 0.2, 0.0], "float32")


def _sample(pkg, probs, seed):
    if pkg == "ref":
        return np.asarray(jreg.get_op("sampling_id").fn(
            {"X": [jnp.asarray(probs)]}, {"op_seed": seed},
            jreg.LoweringContext(base_key=jax.random.PRNGKey(0)))["Out"][0])
    return treg.get_op("sampling_id").fn(
        {"X": [torch.from_numpy(probs)]}, {"op_seed": seed},
        treg.LoweringContext(base_seed=0))["Out"][0].numpy()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_sampling_id_contract(pkg):
    n = 20000
    probs = np.tile(SAMPLE_P, (n, 1))
    ids = _sample(pkg, probs, 3)
    assert ids.shape == (n,) and np.issubdtype(ids.dtype, np.integer)
    if pkg == "port":
        assert ids.dtype == np.int64
        np.testing.assert_array_equal(ids, _sample(pkg, probs, 3))
        assert not np.array_equal(ids, _sample(pkg, probs, 4))
    assert ids.min() >= 0 and ids.max() < SAMPLE_P.size
    freq = np.bincount(ids, minlength=SAMPLE_P.size) / n
    assert freq[SAMPLE_P == 0].sum() == 0
    sigma = np.sqrt(SAMPLE_P * (1 - SAMPLE_P) / n)
    assert (np.abs(freq - SAMPLE_P) <= 6 * sigma + 1e-12).all(), freq
    one_hot = np.eye(SAMPLE_P.size, dtype="float32")[[2, 0, 4, 3]]
    np.testing.assert_array_equal(_sample(pkg, one_hot, 5), [2, 0, 4, 3])
    batched = _sample(pkg, np.tile(one_hot, (3, 1, 1)), 6)
    assert batched.shape == (3, 4)


# ---------------------------------------------------------------------------
# cells, rnn and birnn
# ---------------------------------------------------------------------------
H, D, S = 5, 3, 4
CELL_FEEDS = {"x": _rnd(B, S, D, seed=20), "xt": _rnd(S, B, D, seed=21),
              "h": _rnd(B, H, seed=22), "c": _rnd(B, H, seed=23),
              "lens": np.array([2, 4], "int64")}


def _cells(L, xs):
    lstm, gru = L.LSTMCell(H), L.GRUCell(H)
    out, (h, c) = L.rnn(lstm, xs["x"], sequence_length=xs["lens"])
    out_t, st_t = L.rnn(lstm, xs["xt"], [xs["h"], xs["c"]],
                        time_major=True)
    out_r, st_r = L.rnn(gru, xs["x"], xs["h"], sequence_length=[3, 1],
                        is_reverse=True)
    out_b, (sf, sb) = L.birnn(L.GRUCell(H), L.LSTMCell(H), xs["x"],
                              sequence_length=xs["lens"])
    return [out, h, c, out_t] + list(st_t) + [out_r, st_r, out_b, sf] \
        + list(sb)


def test_cells_static_match_reference():
    def build(fluid):
        xs = {k: _feed_var(fluid, k, v) for k, v in CELL_FEEDS.items()}
        outs = _cells(fluid.layers, xs)
        loss = None
        for i, o in enumerate(outs):
            term = fluid.layers.reduce_sum(
                o * fluid.layers.assign(_rnd(*o.shape, seed=70 + i)))
            loss = term if loss is None else loss + term
        _, pg = fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
        return outs + [g for _, g in sorted(pg, key=lambda t: t[0].name)]
    ref, port = _programs(build)(CELL_FEEDS)
    _close(port, ref, "cells")
    out = ref[0]
    assert np.abs(out[0, 2:]).max() == 0 and np.abs(out[1, 2:]).max() > 0


def test_cells_dygraph_match_reference():
    def fn(fluid, dy):
        xs = {k: dy.to_variable(v) for k, v in CELL_FEEDS.items()}
        return _cells(fluid.layers, xs)
    store = {}
    want, want_g = dygraph_run("ref", fn, store)
    got, got_g = dygraph_run("port", fn, store)
    assert len(store) == 12 and set(got_g) == set(want_g)
    _close(got, want, "cells")
    _close([got_g[k] for k in sorted(want_g)],
           [want_g[k] for k in sorted(want_g)], "cell gradients")


# ---------------------------------------------------------------------------
# the decoders
# ---------------------------------------------------------------------------
E, VOCAB = 6, 9
DEC_W = {"emb": _rnd(VOCAB, E, seed=30), "proj": _rnd(H, VOCAB, seed=31,
                                                      scale=4.0)}


class _Stack:
    """Two LSTM cells, one over the other (the seq2seq decoder's stack);
    states [h0, c0, h1, c1]."""

    def __init__(self, L):
        self.cells = [L.LSTMCell(H), L.LSTMCell(H)]

    def __call__(self, x, states):
        new = []
        for i, cell in enumerate(self.cells):
            x, (h, c) = cell(x, states[2 * i:2 * i + 2])
            new += [h, c]
        return x, new


def _decode_parts(fluid, dy, cell_kind):
    L = fluid.layers
    emb_w, proj_w = (dy.to_variable(DEC_W[k]) for k in ("emb", "proj"))
    cell = _Stack(L) if cell_kind == "stack" else L.GRUCell(H)

    def embed(ids):
        return L.gather(emb_w, ids)

    def project(o):
        return L.matmul(o, proj_w)

    def inits(rows):
        n = 4 if cell_kind == "stack" else 1
        states = [dy.to_variable(_rnd(rows, H, seed=40 + i, scale=0.3))
                  for i in range(n)]
        return states if cell_kind == "stack" else states[0]
    return L, cell, embed, project, inits


def _decoded(case):
    """``run(fluid, dy)``: the decode case in one package, its outputs as
    numpy arrays."""
    def run(fluid, dy):
        kind, cell_kind = case
        L, cell, embed, project, inits = _decode_parts(fluid, dy, cell_kind)
        if kind == "greedy":
            helper = L.GreedyEmbeddingHelper(
                embed, dy.to_variable(np.zeros(B, "int64")), end_token=1)
        elif kind == "sample":
            helper = L.SampleEmbeddingHelper(
                embed, dy.to_variable(np.zeros(B, "int64")), end_token=1,
                seed=5)
        elif kind == "training":
            helper = L.TrainingHelper(dy.to_variable(
                _rnd(B, S, E, seed=45)))
        if kind in ("greedy", "sample", "training"):
            scale = 1e4 if kind == "sample" else 1.0
            dec = L.BasicDecoder(cell, helper,
                                 output_fn=lambda o: project(o) * scale)
            (outs, ids), _, steps = L.dynamic_decode(dec, inits(B),
                                                     max_step_num=6)
            return [outs.numpy(), ids.numpy(), np.array(steps)]
        bsd = L.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                  beam_size=BEAM, embedding_fn=embed,
                                  output_fn=project)
        if kind == "beam_decode":
            return [bsd.decode(inits(B), max_step_num=6)]
        (_, ids), _, steps = L.dynamic_decode(bsd, inits(B), max_step_num=6)
        return [ids.numpy(), np.array(steps)]
    return run


DECODE_CASES = [(k, c) for k in ("greedy", "training", "sample", "beam",
                                 "beam_decode")
                for c in ("gru", "stack")]


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"{k}-{c}" for k, c in DECODE_CASES])
def test_decoder_matches_reference(case):
    store = {}
    results = {}
    for pkg in ("ref", "port"):
        results[pkg] = _dygraph_values(pkg, _decoded(case), store)
    want, got = results["ref"], results["port"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"output {i}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"output {i}")


def _dygraph_values(pkg, run, store):
    """``run`` under the package's tracer, the cells' parameters shared
    by name through ``store`` (the reference's recorded)."""
    fluid, dy = _pkg(pkg)
    fw = importlib.import_module(fluid.__name__ + ".framework")
    fw.reset_unique_name()
    with _guard(pkg), shared_params(fw._dygraph_tracer(), store,
                                    pkg == "ref", []):
        return [np.asarray(v) for v in run(fluid, dy)]


def test_nn_decode_names():
    assert tnn.decode.BeamSearchDecoder is tfluid.layers.BeamSearchDecoder
    assert tnn.decode.dynamic_decode is tfluid.layers.dynamic_decode
    assert tnn.decode.__all__ == ["BeamSearchDecoder", "dynamic_decode"]


def test_dynamic_lstm_unit_raises_as_reference():
    for L in (jfluid.layers, tfluid.layers):
        with pytest.raises(NotImplementedError, match="padded scan"):
            L.dynamic_lstm_unit()
