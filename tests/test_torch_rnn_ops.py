"""The static RNN tier's ops and layers: paddle_tpu_torch against
paddle_tpu.

- The seven ops of ``ops/rnn_ops.py`` (``lstm`` with and without
  peepholes, forward and ``is_reverse``, given states or none;
  ``lstmp``; ``gru`` in both ``origin_mode``s, forward and reverse;
  ``gru_unit`` with string and integer activations; ``cudnn_lstm`` at one
  and two layers over its flat ``W``; ``conv_shift``; ``row_conv``)
  through both registries' lowerings from one set of numpy inputs: every
  output within rtol 1e-5, and the vjp of a random cotangent into every
  differentiable input (``jax.vjp`` against ``torch.func.vjp``, the route
  ``generic_grad`` takes) within rtol 1e-5 of each gradient's largest
  value.
- ``cudnn_lstm``'s ``W`` is the layout ``torch.nn.LSTM`` keeps in its four
  tensors a layer; the op ignores ``dropout_prob`` and ``is_test``, and
  ``layers.lstm`` refuses ``is_bidirec``, as the reference does (ROADMAP
  queue C).
- The builders (``dynamic_lstm``, ``dynamic_lstmp``, ``dynamic_gru``,
  ``lstm``, ``lstm_unit``, ``gru_unit``, ``row_conv``, ``nn.RowConv``) in
  a static program (the reference's startup values carried across by
  name) and under the dygraph tracer (each parameter the reference's
  tracer made given to the port's under the same name): outputs and the
  parameters' gradients within rtol 1e-5.
- The slice as a whole, at T 6 and H 16: a static PTB LM through
  ``layers.lstm`` (SGD over a piecewise decay, a global-norm clip,
  ``LastH``/``LastC`` fed back as the next step's state) and the book's
  stacked ``dynamic_lstm`` net (Adagrad): three steps' losses within
  rtol 1e-5 and the first step's gradients within 1e-5 of each one's
  largest value.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.nn as jnn
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid.core import Scope as JScope, scope_guard as jguard
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.ops import registry as treg

jax.config.update("jax_platforms", "cpu")

B, T, D, H = 3, 5, 4, 6
RTOL = 1e-5


def _rnd(*shape, seed=0, scale=0.5):
    return (scale * np.random.RandomState(seed).randn(*shape)) \
        .astype("float32")


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------
def _n_cudnn(layers, d_in=D, h=H):
    return sum(4 * h * (d_in if i == 0 else h) + 4 * h * h + 8 * h
               for i in range(layers))


OP_CASES = {
    "lstm_peepholes": ("lstm", {
        "Input": _rnd(B, T, 4 * H, seed=1), "Weight": _rnd(H, 4 * H, seed=2),
        "Bias": _rnd(1, 7 * H, seed=3), "H0": _rnd(B, H, seed=4),
        "C0": _rnd(B, H, seed=5)}, {}),
    "lstm_peepholes_reverse": ("lstm", {
        "Input": _rnd(B, T, 4 * H, seed=6), "Weight": _rnd(H, 4 * H, seed=7),
        "Bias": _rnd(1, 7 * H, seed=8)}, {"is_reverse": True}),
    "lstm_plain_relu_cell": ("lstm", {
        "Input": _rnd(B, T, 4 * H, seed=9), "Weight": _rnd(H, 4 * H, seed=10),
        "Bias": _rnd(1, 4 * H, seed=11), "H0": _rnd(B, H, seed=12),
        "C0": _rnd(B, H, seed=13)},
        {"use_peepholes": False, "cell_activation": "relu"}),
    "lstm_plain_reverse_no_bias": ("lstm", {
        "Input": _rnd(B, T, 4 * H, seed=14),
        "Weight": _rnd(H, 4 * H, seed=15)},
        {"use_peepholes": False, "is_reverse": True}),
    "lstmp": ("lstmp", {
        "Input": _rnd(B, T, 4 * H, seed=16), "Weight": _rnd(3, 4 * H, seed=17),
        "ProjWeight": _rnd(H, 3, seed=18), "Bias": _rnd(1, 7 * H, seed=19),
        "H0": _rnd(B, 3, seed=20), "C0": _rnd(B, H, seed=21)},
        {"proj_activation": "identity"}),
    "gru": ("gru", {
        "Input": _rnd(B, T, 3 * H, seed=22), "Weight": _rnd(H, 3 * H, seed=23),
        "Bias": _rnd(1, 3 * H, seed=24), "H0": _rnd(B, H, seed=25)}, {}),
    "gru_origin_reverse": ("gru", {
        "Input": _rnd(B, T, 3 * H, seed=26), "Weight": _rnd(H, 3 * H, seed=27),
        "Bias": _rnd(1, 3 * H, seed=28)},
        {"origin_mode": True, "is_reverse": True}),
    "gru_unit_codes": ("gru_unit", {
        "Input": _rnd(B, 3 * H, seed=29), "HiddenPrev": _rnd(B, H, seed=30),
        "Weight": _rnd(H, 3 * H, seed=31), "Bias": _rnd(1, 3 * H, seed=32)},
        {"gate_activation": 1, "activation": 3}),
    "gru_unit_names_origin": ("gru_unit", {
        "Input": _rnd(B, 3 * H, seed=33), "HiddenPrev": _rnd(B, H, seed=34),
        "Weight": _rnd(H, 3 * H, seed=35)},
        {"gate_activation": "sigmoid", "activation": "tanh",
         "origin_mode": True}),
    "cudnn_lstm_1l": ("cudnn_lstm", {
        "Input": _rnd(T, B, D, seed=36), "W": _rnd(_n_cudnn(1), seed=37),
        "InitH": _rnd(1, B, H, seed=38), "InitC": _rnd(1, B, H, seed=39)},
        {"num_layers": 1, "hidden_size": H}),
    "cudnn_lstm_2l": ("cudnn_lstm", {
        "Input": _rnd(T, B, D, seed=40), "W": _rnd(_n_cudnn(2), seed=41),
        "InitH": _rnd(2, B, H, seed=42), "InitC": _rnd(2, B, H, seed=43)},
        {"num_layers": 2, "hidden_size": H, "is_test": False}),
    "conv_shift": ("conv_shift", {
        "X": _rnd(B, 7, seed=44), "Y": _rnd(B, 3, seed=45)}, {}),
    "row_conv": ("row_conv", {
        "X": _rnd(B, T, D, seed=46), "Filter": _rnd(3, D, seed=47)}, {}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    op, ins, attrs = OP_CASES[case]
    slots = sorted(ins)
    diff = [s for s in slots
            if s not in treg.get_op(op).nondiff_inputs]
    assert diff == [s for s in slots
                    if s not in jreg.get_op(op).nondiff_inputs]
    order = []

    def call(reg, ctx, asarray):
        def fn(*diff_args):
            full = dict(zip(diff, diff_args))
            merged = {s: [full[s] if s in full else asarray(ins[s])]
                      for s in slots}
            outs = reg.get_op(op).fn(merged, dict(attrs), ctx)
            order[:] = sorted(outs)
            return tuple(outs[s][0] for s in order)
        return fn

    j_outs, j_vjp = jax.vjp(call(jreg, jreg.LoweringContext(), jnp.asarray),
                            *[jnp.asarray(ins[s]) for s in diff])
    j_order = list(order)
    t_outs, t_vjp = torch.func.vjp(
        call(treg, treg.LoweringContext(), torch.from_numpy),
        *[torch.from_numpy(ins[s].copy()) for s in diff])
    assert order == j_order
    for s, j, t in zip(order, j_outs, t_outs):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, s
        np.testing.assert_allclose(t.numpy(), j, rtol=RTOL, atol=1e-6,
                                   err_msg=s)
    rng = np.random.RandomState(99)
    cots = [rng.randn(*np.shape(j)).astype("float32") for j in j_outs]
    j_grads = j_vjp(tuple(jnp.asarray(c) for c in cots))
    t_grads = t_vjp(tuple(torch.from_numpy(c) for c in cots))
    for s, j, t in zip(diff, j_grads, t_grads):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=RTOL,
                                   atol=RTOL * np.abs(j).max() + 1e-6,
                                   err_msg=f"d{s}")


def test_the_eleven_op_types_are_registered():
    new = {"cudnn_lstm", "lstm", "lstmp", "gru", "gru_unit", "row_conv",
           "conv_shift", "beam_search", "gather_tree", "beam_search_decode",
           "sampling_id"}
    assert new <= set(treg.all_ops())
    assert new <= set(jreg.all_ops())
    # 245, the image layers' 33, the sequence tier's 29, the detection
    # tier's 34, the CTR tier's 26, the quant tier's 35, the fused
    # tier's 35 and the plumbing tier's 51
    assert len(treg.all_ops()) == 488


def test_cudnn_lstm_w_is_nn_lstm_layout():
    """The flat ``W`` laid out as ``torch.nn.LSTM``'s weight_ih, weight_hh,
    bias_ih, bias_hh a layer gives ``nn.LSTM``'s outputs."""
    torch.manual_seed(0)
    ref = torch.nn.LSTM(D, H, num_layers=2)
    w = torch.cat([p.detach().reshape(-1) for p in ref._flat_weights])
    x = torch.from_numpy(_rnd(T, B, D, seed=50))
    h0 = torch.from_numpy(_rnd(2, B, H, seed=51))
    c0 = torch.from_numpy(_rnd(2, B, H, seed=52))
    outs = treg.get_op("cudnn_lstm").fn(
        {"Input": [x], "W": [w], "InitH": [h0], "InitC": [c0]},
        {"num_layers": 2, "hidden_size": H}, treg.LoweringContext())
    with torch.no_grad():
        want, (h, c) = ref(x, (h0, c0))
    for got, w_ in ((outs["Out"][0], want), (outs["LastH"][0], h),
                    (outs["LastC"][0], c)):
        torch.testing.assert_close(got, w_, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_cudnn_lstm_ignores_dropout_and_is_test(pkg):
    """Queue C: the reference's cudnn_lstm reads neither dropout_prob nor
    is_test; the port gives the same output at rate 0.5 as at 0."""
    reg, conv = (jreg, jnp.asarray) if pkg == "ref" \
        else (treg, torch.from_numpy)
    _, ins, attrs = OP_CASES["cudnn_lstm_2l"]
    ins = {s: [conv(a)] for s, a in ins.items()}
    outs = [reg.get_op("cudnn_lstm").fn(
        ins, dict(attrs, dropout_prob=p, is_test=t), reg.LoweringContext())
        for p, t in ((0.0, False), (0.5, False), (0.5, True))]
    for o in outs[1:]:
        for s in ("Out", "LastH", "LastC"):
            np.testing.assert_array_equal(np.asarray(o[s][0]),
                                          np.asarray(outs[0][s][0]))


@pytest.mark.parametrize("fluid", [jfluid, tfluid], ids=["ref", "port"])
def test_lstm_refuses_bidirec(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [T, B, D])
        h = fluid.data("h", [2, B, H])
        with pytest.raises(NotImplementedError, match="is_bidirec"):
            fluid.layers.lstm(x, h, h, T, H, 1, is_bidirec=True)


# ---------------------------------------------------------------------------
# the builders, static and dygraph
# ---------------------------------------------------------------------------
def _persistables(main, scope):
    return {n: np.asarray(scope.find_var(n))
            for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _programs(build, prepare=None):
    """``build(fluid)`` in fresh programs of both packages (each
    appending an SGD of rate 0, whose gradients it returns after the
    fetches); the reference's startup values carried into the port's
    scope (first through ``prepare(main, values)``, which may change them
    in both scopes).  Returns one ``run(feed) -> (ref, port)`` of both
    mains."""
    out = {}
    for pkg, fluid in (("ref", jfluid), ("port", tfluid)):
        (jframework if pkg == "ref" else tframework).reset_unique_name()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            fetch = build(fluid)
        out[pkg] = (main, startup, fetch)
    jmain, jstart, jfetch = out["ref"]
    tmain, tstart, tfetch = out["port"]
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(jstart)
    init = _persistables(jmain, jscope)
    if prepare is not None:
        init = prepare(jmain, init)
        for n, v in init.items():
            jscope.set_var(n, jnp.asarray(v))
    place = tfluid.CPUPlace()
    tscope, texe = tfluid.Scope(), tfluid.Executor(place)
    texe.run(tstart, scope=tscope)
    assert set(_persistables(tmain, tscope)) == set(init)
    interop.scope_from_numpy(init, tscope, place)

    def run(feed):
        with jguard(jscope):
            ref = [np.asarray(v) for v in
                   jexe.run(jmain, feed=feed, fetch_list=jfetch)]
        port = [np.asarray(v) for v in
                texe.run(tmain, feed=feed, fetch_list=tfetch, scope=tscope)]
        return ref, port
    return run


def _close(got, want, what, rtol=RTOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * np.abs(w).max() + 1e-7,
                                   err_msg=f"{what}: fetch {i}")


def _dyn_lstm(L, x, xs):
    h, c = L.dynamic_lstm(x, 4 * H, h_0=xs["h0"], c_0=xs["c0"])
    h2, c2 = L.dynamic_lstm(x, 4 * H, use_peepholes=False, is_reverse=True)
    return [h, c, h2, c2]


def _dyn_lstmp(L, x, xs):
    return list(L.dynamic_lstmp(x, 4 * H, 3, c_0=xs["c0"]))


def _dyn_gru(L, x, xs):
    g = L.fc(x, 3 * H, num_flatten_dims=2)
    return [L.dynamic_gru(g, H, h_0=xs["h0"]),
            L.dynamic_gru(g, H, is_reverse=True, origin_mode=True)]


def _cudnn(L, x, xs):
    t = L.transpose(L.fc(x, D, num_flatten_dims=2), [1, 0, 2])
    return list(L.lstm(t, xs["h2"], xs["c2"], T, H, 2))


def _units(L, x, xs):
    step = L.reshape(L.slice(x, axes=[1], starts=[0], ends=[1]),
                     [B, 4 * H])
    h, c = L.lstm_unit(step, xs["h0"], xs["c0"], forget_bias=0.5)
    g = L.gru_unit(step, xs["h0"], 3 * H)
    return [h, c] + list(g)


def _row_conv(L, x, xs):
    return [L.row_conv(x, 2), L.row_conv(x, 1, act="relu")]


BUILDERS = {"dynamic_lstm": _dyn_lstm, "dynamic_lstmp": _dyn_lstmp,
            "dynamic_gru": _dyn_gru, "lstm": _cudnn,
            "lstm_unit_gru_unit": _units, "row_conv": _row_conv}

FEEDS = {"x": _rnd(B, T, 4 * H, seed=60), "h0": _rnd(B, H, seed=61),
         "c0": _rnd(B, H, seed=62), "h2": _rnd(2, B, H, seed=63),
         "c2": _rnd(2, B, H, seed=64), "cot": _rnd(B, T, 4 * H, seed=65)}


def _loss(L, outs, fluid):
    """sum(out · c) over every output, a fixed cotangent c each."""
    total = None
    for i, o in enumerate(outs):
        c = L.assign(_rnd(*o.shape, seed=70 + i))
        term = L.reduce_sum(o * c)
        total = term if total is None else total + term
    return total


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_static_matches_reference(name):
    def build(fluid):
        L = fluid.layers
        xs = {k: fluid.data(k, list(v.shape)) for k, v in FEEDS.items()}
        outs = BUILDERS[name](L, xs["x"], xs)
        loss = _loss(L, outs, fluid)
        _, pg = fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
        return outs + [g for _, g in sorted(pg, key=lambda pg: pg[0].name)]
    ref, port = _programs(build)(FEEDS)
    _close(port, ref, name)


@contextlib.contextmanager
def shared_params(tracer, store, record, made):
    """Each parameter the tracer makes goes into ``made``, and is recorded
    into ``store`` by name (``record``) or given ``store``'s value under
    its name."""
    orig = tracer.create_parameter

    def create(name, shape, dtype, init, **kw):
        p = orig(name, shape, dtype, init, **kw)
        if record:
            store[name] = np.asarray(p.numpy())
        else:
            p.set_value(store[name])
        made.append(p)
        return p
    tracer.create_parameter = create
    try:
        yield
    finally:
        del tracer.create_parameter


def dygraph_run(pkg, fn, store):
    """``fn(fluid, dy)`` under each package's tracer, the parameters shared
    through ``store``; (outputs, the parameters' gradients by name) of
    ``sum(out · c)``."""
    fluid, dy, fw = (jfluid, jdy, jframework) if pkg == "ref" \
        else (tfluid, tdy, tframework)
    fw.reset_unique_name()
    made = []
    with (dy.guard() if pkg == "ref" else dy.guard(tfluid.CPUPlace())), \
            shared_params(fw._dygraph_tracer(), store, pkg == "ref", made):
        outs = fn(fluid, dy)
        loss = None
        for i, o in enumerate(outs):
            c = dy.to_variable(_rnd(*o.shape, seed=70 + i))
            term = fluid.layers.reduce_sum(o * c)
            loss = term if loss is None else loss + term
        loss.backward()
        grads = {p.name: np.asarray(p.gradient()) for p in made
                 if p.gradient() is not None}
        return [np.asarray(o.numpy()) for o in outs], grads


def _dygraph_both(fn):
    store = {}
    want, want_g = dygraph_run("ref", fn, store)
    got, got_g = dygraph_run("port", fn, store)
    assert store and set(got_g) == set(want_g)
    return got, want, [got_g[k] for k in sorted(want_g)], \
        [want_g[k] for k in sorted(want_g)]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_dygraph_matches_reference(name):
    def fn(fluid, dy):
        xs = {k: dy.to_variable(v) for k, v in FEEDS.items()}
        return BUILDERS[name](fluid.layers, xs["x"], xs)
    got, want, got_g, want_g = _dygraph_both(fn)
    _close(got, want, name)
    _close(got_g, want_g, name + " gradients")


def test_row_conv_layer_matches_reference():
    def fn(fluid, dy):
        nn = jnn if fluid is jfluid else tnn
        return [nn.RowConv(4 * H, 2)(dy.to_variable(FEEDS["x"]))]
    got, want, got_g, want_g = _dygraph_both(fn)
    _close(got, want, "RowConv")
    _close(got_g, want_g, "RowConv gradients")


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
PTB = dict(vocab=50, hidden=16, layers=2, steps=6, batch=4)


def _ptb_program(fluid):
    """Phase 4r (a)'s program at PTB's small width: embedding, dropout,
    time major, ``layers.lstm``, dropout, fc to the vocab,
    softmax_with_cross_entropy, SGD over a piecewise decay with a
    global-norm clip.  Dropout runs at rate 0 (masks are not compared
    across packages)."""
    L = fluid.layers
    p = PTB
    ids = fluid.data("ids", [p["batch"], p["steps"]], "int64")
    lbl = fluid.data("lbl", [p["batch"], p["steps"], 1], "int64")
    h0 = fluid.data("h0", [p["layers"], p["batch"], p["hidden"]])
    c0 = fluid.data("c0", [p["layers"], p["batch"], p["hidden"]])
    init = fluid.initializer.UniformInitializer(-0.3, 0.3)
    emb = L.embedding(ids, [p["vocab"], p["hidden"]],
                      param_attr=fluid.ParamAttr(initializer=init))
    emb = L.dropout(emb, 0.0, dropout_implementation="upscale_in_train")
    out, last_h, last_c = L.lstm(L.transpose(emb, [1, 0, 2]), h0, c0,
                                 p["steps"], p["hidden"], p["layers"],
                                 default_initializer=init)
    out = L.dropout(L.transpose(out, [1, 0, 2]), 0.0,
                    dropout_implementation="upscale_in_train")
    logits = L.fc(out, p["vocab"], num_flatten_dims=2,
                  param_attr=fluid.ParamAttr(initializer=init))
    loss = L.reduce_mean(L.reduce_sum(
        L.softmax_with_cross_entropy(logits, lbl), dim=1))
    lr = L.piecewise_decay([2], [1.0, 0.5])
    opt = fluid.optimizer.SGD(
        learning_rate=lr, grad_clip=fluid.clip.GradientClipByGlobalNorm(5.0))
    _, pg = opt.minimize(loss)
    return [loss, last_h, last_c] + [g for _, g in
                                      sorted(pg, key=lambda t: t[0].name)]


def test_static_ptb_matches_reference():
    p = PTB
    rng = np.random.RandomState(80)
    tok = rng.randint(0, p["vocab"], (p["batch"], p["steps"] + 1))
    feed = {"ids": tok[:, :-1].astype("int64"),
            "lbl": tok[:, 1:, None].astype("int64"),
            "h0": np.zeros((p["layers"], p["batch"], p["hidden"]), "float32"),
            "c0": np.zeros((p["layers"], p["batch"], p["hidden"]),
                           "float32")}
    run = _programs(_ptb_program)
    for step in range(3):
        ref, port = run(feed)
        if step == 0:
            _close(port, ref, "first step, with the gradients")
        else:
            _close(port[:3], ref[:3], f"step {step}")
        # the next batch starts from this one's last states, as a PTB
        # trainer feeds them
        feed = dict(feed, h0=ref[1], c0=ref[2])


BOOK = dict(vocab=40, emb=8, hid=16, stacked=3, batch=4, words=6)


def _stacked_lstm_net(fluid):
    """The book's ``stacked_lstm_net`` (test_understand_sentiment.py) at
    BOOK's width over padded rows: fc, then dynamic_lstms of alternating
    direction, each fed by an fc over the last (fc, lstm) pair; both
    max-pooled over time into an fc of 2 classes; Adagrad."""
    L = fluid.layers
    p = BOOK
    data = fluid.data("words", [p["batch"], p["words"]], "int64")
    label = fluid.data("label", [p["batch"], 1], "int64")
    emb = L.embedding(data, [p["vocab"], p["emb"]], is_sparse=True)
    fc1 = L.fc(emb, p["hid"], num_flatten_dims=2)
    lstm1, _ = L.dynamic_lstm(fc1, p["hid"])
    inputs = [fc1, lstm1]
    for i in range(2, p["stacked"] + 1):
        fc = L.fc(inputs, p["hid"], num_flatten_dims=2)
        lstm, _ = L.dynamic_lstm(fc, p["hid"], is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = L.sequence_pool(inputs[0], pool_type="max")
    lstm_last = L.sequence_pool(inputs[1], pool_type="max")
    logits = L.fc([fc_last, lstm_last], 2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    _, pg = fluid.optimizer.AdagradOptimizer(0.002).minimize(loss)
    return [loss] + [g for _, g in sorted(pg, key=lambda t: t[0].name)]


def test_stacked_lstm_net_matches_reference():
    p = BOOK
    rng = np.random.RandomState(81)
    feed = {"words": rng.randint(0, p["vocab"], (p["batch"], p["words"]))
            .astype("int64"),
            "label": rng.randint(0, 2, (p["batch"], 1)).astype("int64")}
    run = _programs(_stacked_lstm_net)
    for step in range(3):
        ref, port = run(feed)
        _close(port if step == 0 else port[:1], ref if step == 0
               else ref[:1], f"step {step}")
