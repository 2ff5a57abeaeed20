"""hapi.Model in both packages: ``Model.fit`` through the static and the
dygraph adapter, ``evaluate``, ``predict_batch``, ``save``/``load`` across
packages, the callbacks, ``amp_level="O1"``, and Transformer NMT through
the dygraph adapter.  Each network is built in the reference and its
weights carried into the port; per-batch losses are compared (ground
rule 9: losses, not weights after Adam steps), each training check with
a twin that must miss it by 10 times its tolerance or more.  Mirrors
``tests/test_hapi_static_book.py`` and ``tests/test_namespace20.py``.
"""
import json

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.fluid as jfluid
from paddle_tpu import hapi as jhapi, nn as jnn, optimizer as jopt
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.dygraph.checkpoint import load_dygraph as j_load
from paddle_tpu.vision.models import LeNet as JLeNet

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import hapi as thapi, nn as tnn, optimizer as topt
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.dygraph.checkpoint import load_dygraph as t_load
from paddle_tpu_torch.fluid.framework import _set_expected_place
from paddle_tpu_torch.vision.models import LeNet as TLeNet

LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _host():
    """The port's entry points take the card unless told otherwise: the
    tests run them on the host."""
    tpaddle.set_device("cpu")
    yield
    _set_expected_place(None)
    jdy.disable_dygraph()
    tdy.disable_dygraph()


def synthetic_mnist(n=96, seed=7):
    """tests/test_hapi_static_book.py's digits: a block pattern a class
    plus noise."""
    rng = np.random.RandomState(seed)
    xs = (rng.randn(n, 1, 28, 28) * 0.25).astype("float32")
    ys = rng.randint(0, 10, (n, 1)).astype("int64")
    for i in range(n):
        r, col = divmod(int(ys[i, 0]), 4)
        xs[i, 0, r * 7:(r + 1) * 7, col * 7:(col + 1) * 7] += 1.5
    return [(x, y) for x, y in zip(xs, ys)]


def _fresh_static(fluid, dy):
    """Static mode with fresh default programs, global scope and name
    counters, as the reference's tests get them from their conftest:
    both packages name every parameter alike, and no value of an earlier
    program (a learning rate, an accumulator) is taken for this one's."""
    dy.disable_dygraph()
    fluid.framework._main_program = fluid.Program()
    fluid.framework._startup_program = fluid.Program()
    fluid.core._global_scope = fluid.core.Scope()
    fluid.framework.reset_unique_name()


def _init():
    """LeNet's weights drawn in the reference, in parameter order."""
    jdy.enable_dygraph()
    try:
        return [np.asarray(p.numpy()) for p in JLeNet().parameters()]
    finally:
        jdy.disable_dygraph()


class _Losses:
    """A callback keeping each batch's loss."""

    def __init__(self):
        self.losses = []

    def set_model(self, model):
        pass

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


def _lenet_fit(pkg, static, init, data, amp=None, epochs=1,
               make_opt=None):
    """LeNet through Model.fit in ``pkg`` ("ref" or "port"): the
    per-batch losses and the model.  ``make_opt(opt, parameters)`` makes
    the optimizer from the package's ``paddle.optimizer`` (default
    Adam at 1e-3)."""
    paddle, fluid, dy, hapi, nn, opt, LeNet = (
        (jpaddle, jfluid, jdy, jhapi, jnn, jopt, JLeNet) if pkg == "ref"
        else (tpaddle, tfluid, tdy, thapi, tnn, topt, TLeNet))
    if static:
        _fresh_static(fluid, dy)
    elif pkg == "ref":
        dy.enable_dygraph()
    else:
        dy.enable_dygraph(fluid.CPUPlace())
    net = LeNet()
    model = paddle.Model(net, inputs=[hapi.Input([-1, 1, 28, 28])],
                         labels=[hapi.Input([-1, 1], "int64")])
    make_opt = make_opt or (lambda o, ps: o.Adam(1e-3, parameters=ps))
    model.prepare(optimizer=make_opt(opt, model.parameters()),
                  loss=nn.CrossEntropyLoss(),
                  metrics=[paddle.metric.Accuracy()], amp_level=amp)
    if pkg == "port":
        interop.model_from_numpy(model, init)
    elif static:
        model._adapter.set_state_dict(
            {p.name: v for p, v in zip(model.parameters(), init)})
    else:
        for p, v in zip(net.parameters(), init):
            p.set_value(v)
    rec = _Losses()
    model.fit(data, batch_size=32, epochs=epochs, verbose=0, shuffle=False,
              callbacks=[rec])
    return rec.losses, model


def _swapped(init):
    """The twin's weights: conv1's filters 0 and 1 swapped."""
    out = list(init)
    out[0] = out[0][[1, 0, 2, 3, 4, 5]]
    return out


def _weights_margin(got, want, rtol=1e-3, atol=1e-5):
    """The worst ``|a - b| / (atol + rtol |b|)`` over the tensors."""
    return max(float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))
               for a, b in zip(got, want))


def _margin(got, want, rtol):
    return float(np.max(np.abs(np.subtract(got, want))
                        / np.abs(want))) / rtol


@pytest.mark.parametrize("static", [True, False], ids=["static", "dygraph"])
def test_lenet_fit_losses_match_reference(static):
    """The first epoch's per-batch losses from the carried weights, at
    rtol 1e-4; the swapped-filters twin misses by 10 times or more."""
    data, init = synthetic_mnist(), _init()
    want, _ = _lenet_fit("ref", static, init, data)
    got, _ = _lenet_fit("port", static, init, data)
    twin, _ = _lenet_fit("port", static, _swapped(init), data)
    assert len(got) == len(want) == 3
    assert _margin(got, want, LOSS_RTOL) <= 1
    assert _margin(twin, want, LOSS_RTOL) > 10


def _small_net(nn):
    return nn.Sequential(
        nn.Conv2D(1, 4, 3, padding=1), nn.ReLU(), nn.MaxPool2D(2),
        nn.Flatten(), nn.Linear(4 * 4 * 4, 10))


def _small_data():
    rng = np.random.RandomState(42)
    xs = rng.randn(32, 1, 8, 8).astype("float32") * 0.3
    ys = rng.randint(0, 10, (32, 1)).astype("int64")
    for i in range(32):
        xs[i, 0, ys[i, 0] % 8, ys[i, 0] % 8] += 2.0
    return [(x, y) for x, y in zip(xs, ys)]


def _small_fit(static, init):
    if static:
        _fresh_static(tfluid, tdy)
    else:
        tdy.enable_dygraph(tfluid.CPUPlace())
    net = _small_net(tnn)
    model = tpaddle.Model(net, inputs=[thapi.Input([-1, 1, 8, 8])],
                          labels=[thapi.Input([-1, 1], "int64")])
    model.prepare(optimizer=topt.SGD(0.1, parameters=model.parameters()),
                  loss=tnn.CrossEntropyLoss())
    interop.model_from_numpy(model, init)
    hist = model.fit(_small_data(), batch_size=8, epochs=3, verbose=0,
                     shuffle=False)
    if static:
        state = [model._adapter.state_dict()[p.name]
                 for p in model.parameters()]
    else:
        state = [p.numpy() for p in net.parameters()]
    tdy.disable_dygraph()
    return [h["loss"] for h in hist], state


def test_static_and_dygraph_adapters_follow_one_trajectory():
    """tests/test_namespace20.py:346 in the port: one network, one set of
    weights, both adapters, the same losses and weights (rtol 1e-3,
    atol 1e-5); a dygraph twin with conv1's filters 0 and 1 swapped
    misses the weights by 10 times or more."""
    tdy.enable_dygraph(tfluid.CPUPlace())
    shapes = [p.shape for p in _small_net(tnn).parameters()]
    tdy.disable_dygraph()
    rng = np.random.RandomState(9)
    init = [(rng.randn(*s) * 0.05).astype("float32") for s in shapes]
    s_losses, s_final = _small_fit(True, init)
    d_losses, d_final = _small_fit(False, init)
    twin_init = list(init)
    twin_init[0] = init[0][[1, 0, 2, 3]]
    _, t_final = _small_fit(False, twin_init)
    np.testing.assert_allclose(d_losses, s_losses, rtol=1e-3, atol=1e-5)
    for a, b in zip(s_final, d_final):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)
    assert s_losses[-1] < s_losses[0]
    # the weights criterion carries the twin: its epoch losses differ
    # from the static ones by only about twice the tolerance (at 0.05
    # the logits sit near uniform), its conv1 weights by far more
    assert _weights_margin(t_final, s_final) > 10


@pytest.mark.parametrize("static", [True, False], ids=["static", "dygraph"])
def test_evaluate_predict_and_save_load_across_packages(static, tmp_path):
    """evaluate and predict_batch against the reference's; the port's
    ``.pdparams`` loads in the reference's load_dygraph and the
    reference's in the port's, and a model loaded back predicts bit for
    bit what it predicted before."""
    data, init = synthetic_mnist(), _init()
    x = np.stack([d[0] for d in data[:8]])
    _, jm = _lenet_fit("ref", static, init, data)
    j_ev = jm.evaluate(data, batch_size=32, verbose=0)
    j_pred = jm.predict_batch([x])[0]
    jm.save(str(tmp_path / "ref"))
    _, tm = _lenet_fit("port", static, init, data)
    t_ev = tm.evaluate(data, batch_size=32, verbose=0)
    t_pred = tm.predict_batch([x])[0]
    tm.save(str(tmp_path / "port"))
    assert abs(t_ev["loss"] - j_ev["loss"]) <= 1e-4 * abs(j_ev["loss"])
    assert t_ev["metrics"] == pytest.approx(j_ev["metrics"], abs=1e-9)
    np.testing.assert_allclose(t_pred, j_pred, rtol=1e-4, atol=1e-5)
    # across packages: each reads the other's file, names and values
    theirs, _ = j_load(str(tmp_path / "port"))
    mine, _ = t_load(str(tmp_path / "ref"))
    assert set(theirs) == set(mine)
    for k in mine:
        np.testing.assert_allclose(theirs[k], mine[k], rtol=1e-4,
                                   atol=1e-5)
    # the port loads the reference's weights and predicts with them
    state = tm._adapter.state_dict() if static else tm.network.state_dict()
    zeros = {k: np.zeros(np.shape(v), "float32") for k, v in state.items()}
    if static:
        tm._adapter.set_state_dict(zeros)
    else:
        tm.network.set_dict(zeros)
    assert not np.allclose(tm.predict_batch([x])[0], t_pred)
    tm.load(str(tmp_path / "ref"))
    np.testing.assert_allclose(tm.predict_batch([x])[0], j_pred,
                               rtol=1e-4, atol=1e-5)
    tm.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(tm.predict_batch([x])[0], t_pred)


@pytest.mark.parametrize("static", [True, False], ids=["static", "dygraph"])
def test_amp_o1(static):
    """amp_level="O1": finite losses; the static adapter's first loss
    equal to the reference's within bf16's 2^-8, the dygraph adapter's
    within 2^-6 of its float32 one, its forward in the reference's
    autocast dtype.  (From these weights the static O1 program's first
    loss is 4.33 in both packages, against float32's 2.60: ROADMAP queue
    C.)"""
    data, init = synthetic_mnist(), _init()
    want, jm = _lenet_fit("ref", static, init, data, amp="O1")
    got, tm = _lenet_fit("port", static, init, data, amp="O1")
    assert np.isfinite(got).all() and np.isfinite(want).all()
    if static:
        np.testing.assert_allclose(got[0], want[0], rtol=2 ** -8)
        return
    f32, _ = _lenet_fit("port", static, init, data)
    np.testing.assert_allclose(got[0], f32[0], rtol=2 ** -6)
    dtypes = []
    for dy, enter, amp, m in (
            (jdy, jdy.enable_dygraph, jpaddle.amp, jm),
            (tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace()),
             tpaddle.amp, tm)):
        enter()
        with amp.auto_cast(enable=True):
            out = m.network(dy.to_variable(np.stack(
                [d[0] for d in data[:4]])))
        dtypes.append(out.dtype)
        dy.disable_dygraph()
    assert dtypes[0] == dtypes[1] == "bfloat16"


def test_amp_o1_static_starts_where_float32_does():
    """From one init the static O1 fit's first loss is float32's within
    bf16's 2^-6, in both packages.  (The 4.33 against 2.60 once recorded
    in ROADMAP queue C compared two inits: ``_init()`` draws new weights
    at every call.)"""
    data, init = synthetic_mnist(), _init()
    for pkg in ("ref", "port"):
        o1, _ = _lenet_fit(pkg, True, init, data, amp="O1")
        f32, _ = _lenet_fit(pkg, True, init, data)
        np.testing.assert_allclose(o1[0], f32[0], rtol=2 ** -6)


@pytest.mark.parametrize("mu", [0.9, 0.5])
def test_static_momentum_honours_its_momentum(mu):
    """A static ``Model`` with ``optimizer.Momentum(momentum=mu)``: at
    0.9 both packages' fits agree; at 0.5 the port's fit is that of
    fluid's ``MomentumOptimizer(lr, 0.5)`` and the reference's still runs
    at 0.9, the momentum it reads from an attribute its eager Momentum
    lacks (ROADMAP queue C, failures on the reference's side)."""
    data, init = synthetic_mnist(), _init()

    def eager(o, ps):
        return o.Momentum(0.05, momentum=mu, parameters=ps)

    ref, _ = _lenet_fit("ref", True, init, data, make_opt=eager)
    port, _ = _lenet_fit("port", True, init, data, make_opt=eager)
    fluid_mu, _ = _lenet_fit(
        "port", True, init, data,
        make_opt=lambda o, ps: tfluid.optimizer.MomentumOptimizer(0.05, mu))
    np.testing.assert_array_equal(port, fluid_mu)
    if mu == 0.9:
        np.testing.assert_allclose(port, ref, rtol=1e-4)
    else:
        ref_09, _ = _lenet_fit(
            "ref", True, init, data,
            make_opt=lambda o, ps: o.Momentum(0.05, momentum=0.9,
                                              parameters=ps))
        np.testing.assert_array_equal(ref, ref_09)
        assert abs(port[-1] - ref[-1]) > 1e-3 * abs(ref[-1])


NMT = dict(src_vocab=50, tgt_vocab=50, d_model=64, nhead=4,
           num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=128,
           dropout=0.0, max_len=16)


def _nmt_fit(state, data):
    """The port's NMT from ``state`` through Model.fit: the losses."""
    from paddle_tpu_torch.models import TransformerModel
    paddle, dy, nn, opt = tpaddle, tdy, tnn, topt
    dy.enable_dygraph(tfluid.CPUPlace())
    try:
        net = TransformerModel(**NMT)
        interop.layer_from_numpy(net, state)
        model = paddle.Model(net)
        model.prepare(optimizer=opt.Adam(1e-3, parameters=net.parameters()),
                      loss=nn.CrossEntropyLoss())
        rec = _Losses()
        model.fit(data, batch_size=4, epochs=1, verbose=0, shuffle=False,
                  callbacks=[rec])
        return rec.losses
    finally:
        dy.disable_dygraph()


def test_nmt_fit_losses_match_reference():
    """Transformer NMT (d_model 64, 2 + 2 layers, dropout 0) through
    Model.fit with inputs [src, tgt_in], labels [tgt_out] and
    CrossEntropyLoss over [B, T, V]: the first 3 losses at rtol 1e-4 from
    the reference's weights; a twin whose label ids are each shifted by
    one misses by 10 times or more."""
    rng = np.random.RandomState(3)
    src, tgt_in, tgt_out = (rng.randint(0, NMT["tgt_vocab"], (12, 8))
                            .astype("int64") for _ in range(3))
    data = list(zip(src, tgt_in, tgt_out[..., None]))
    twin = list(zip(src, tgt_in,
                    ((tgt_out + 1) % NMT["tgt_vocab"])[..., None]))
    # the reference's weights, drawn there, fitted there, carried over
    jdy.enable_dygraph()
    from paddle_tpu.models import TransformerModel
    np.random.seed(11)
    jnet = TransformerModel(**NMT)
    state = {k: np.asarray(getattr(v, "numpy", lambda: v)())
             for k, v in jnet.state_dict().items()}
    jm = jpaddle.Model(jnet)
    jm.prepare(optimizer=jopt.Adam(1e-3, parameters=jnet.parameters()),
               loss=jnn.CrossEntropyLoss())
    rec = _Losses()
    jm.fit(data, batch_size=4, epochs=1, verbose=0, shuffle=False,
           callbacks=[rec])
    want = rec.losses
    jdy.disable_dygraph()
    got = _nmt_fit(state, data)
    miss = _nmt_fit(state, twin)
    assert len(got) == len(want) == 3
    assert _margin(got, want, LOSS_RTOL) <= 1
    assert _margin(miss, want, LOSS_RTOL) > 10


def test_fit_checkpoint_dir_waits_for_item_9():
    tdy.enable_dygraph(tfluid.CPUPlace())
    model = tpaddle.Model(tnn.Linear(4, 1))
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        model.fit([(np.zeros(4, "float32"), np.zeros(1, "float32"))],
                  checkpoint_dir="unused")


def test_eval_metric_is_zero_only_where_accuracy_does_not_apply():
    """The reference answers 0.0 where its accuracy raises; the port
    gives the same answers by a test, and a fault inside accuracy is not
    swallowed."""
    from paddle_tpu_torch.hapi.model import _eval_metric, _np_metric
    tdy.enable_dygraph(tfluid.CPUPlace())
    logits = tdy.to_variable(np.eye(4, dtype="float32"))
    right = tdy.to_variable(np.arange(4).reshape(4, 1).astype("int64"))
    assert _eval_metric([logits], [right]) == 1.0
    flat = tdy.to_variable(np.arange(4).astype("int64"))
    assert _eval_metric([logits], [flat]) == 0.0
    assert _np_metric(np.eye(4), [np.arange(4)]) == 1.0
    assert _np_metric(np.eye(4), [np.arange(3)]) == 0.0


# --- callbacks: tests/test_namespace20.py:152-283 ---------------------------
def _linear_model(pkg):
    paddle, dy, nn = ((jpaddle, jdy, jnn) if pkg == "ref"
                      else (tpaddle, tdy, tnn))
    if pkg == "ref":
        dy.enable_dygraph()
    else:
        dy.enable_dygraph(tfluid.CPUPlace())
    np.random.seed(0)
    net = nn.Linear(4, 1)
    if pkg == "port":
        net.weight.set_value(_LIN_W)
        net.bias.set_value(np.zeros(1, "float32"))
    return paddle.Model(net), net


_LIN_W = np.random.RandomState(1).randn(4, 1).astype("float32")


def _mse(pkg):
    L = jpaddle.fluid.layers if pkg == "ref" else tpaddle.fluid.layers
    return lambda p, y: L.reduce_mean(L.square(p - y))


def _xy(n):
    xs = np.random.RandomState(0).randn(n, 4).astype("float32")
    return [(x, y) for x, y in zip(xs, np.zeros((n, 1), "float32"))]


def _callback_case(pkg, name, tmp_path):
    C = (jhapi if pkg == "ref" else thapi).callbacks
    opt = jopt if pkg == "ref" else topt
    model, net = _linear_model(pkg)
    if pkg == "ref":
        net.weight.set_value(_LIN_W)
        net.bias.set_value(np.zeros(1, "float32"))
    if name == "early_stopping":
        model.prepare(optimizer=opt.SGD(0.0, parameters=net.parameters()),
                      loss=_mse(pkg))
        hist = model.fit(_xy(16), batch_size=8, epochs=10, verbose=0,
                         callbacks=[C.EarlyStopping(
                             monitor="loss", patience=1, verbose=0,
                             min_delta=1.0)])
        return {"epochs": len(hist)}
    if name == "reduce_lr_on_plateau":
        o = opt.SGD(0.5, parameters=net.parameters())
        model.prepare(optimizer=o, loss=_mse(pkg))
        model.fit(_xy(8), batch_size=8, epochs=6, verbose=0,
                  callbacks=[C.ReduceLROnPlateau(
                      monitor="loss", factor=0.5, patience=0,
                      min_delta=1e6, verbose=0)])
        return {"lr": float(o.get_lr())}
    if name == "lr_scheduler":
        lr = (jopt if pkg == "ref" else topt).lr
        o = opt.SGD(lr.StepDecay(learning_rate=1.0, step_size=1, gamma=0.5),
                    parameters=net.parameters())
        model.prepare(optimizer=o, loss=_mse(pkg))
        model.fit(_xy(8), batch_size=4, epochs=1, verbose=0,
                  callbacks=[C.LRScheduler(by_step=True)])
        return {"lr": float(o.get_lr())}
    if name == "visualdl":
        model.prepare(optimizer=opt.SGD(0.1, parameters=net.parameters()),
                      loss=_mse(pkg))
        d = str(tmp_path / pkg)
        model.fit(_xy(8), batch_size=4, epochs=2, verbose=0,
                  callbacks=[C.VisualDL(log_dir=d)])
        recs = [json.loads(line) for line in
                open(f"{d}/scalars.jsonl").read().splitlines()]
        return {"tags": sorted({r["tag"] for r in recs}),
                "values": [round(r["value"], 4) for r in recs]}
    if name == "model_checkpoint":
        model.prepare(optimizer=opt.SGD(0.1, parameters=net.parameters()),
                      loss=_mse(pkg))
        d = tmp_path / f"ckpt_{pkg}"
        model.fit(_xy(8), batch_size=4, epochs=2, verbose=0,
                  callbacks=[C.ModelCheckpoint(1, str(d))])
        return {"files": sorted(p.name for p in d.iterdir())}
    if name == "reduce_lr_cooldown":
        class FakeOpt:
            def __init__(self):
                self._lr = 1.0

            def get_lr(self):
                return self._lr

            def set_lr(self, v):
                self._lr = v

        cb = C.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=0,
                                 cooldown=3, verbose=0)
        m = type("FakeModel", (), {})()
        m._optimizer = FakeOpt()
        cb.set_model(m)
        for epoch in range(6):
            cb.on_epoch_end(epoch, {"loss": 1.0})
        return {"lr": m._optimizer.get_lr()}
    if name == "set_lr_on_scheduler":
        lr = (jopt if pkg == "ref" else topt).lr
        o = opt.SGD(lr.StepDecay(learning_rate=1.0, step_size=1))
        with pytest.raises(RuntimeError, match="scheduler"):
            o.set_lr(0.1)
        return {}
    raise KeyError(name)


CALLBACK_CASES = {
    "early_stopping": lambda r: r["epochs"] <= 4,
    "reduce_lr_on_plateau": lambda r: r["lr"] <= 0.25 + 1e-9,
    "lr_scheduler": lambda r: r["lr"] < 1.0,
    "visualdl": lambda r: "epoch/loss" in r["tags"]
    and any(t.startswith("train/") for t in r["tags"]),
    "model_checkpoint": lambda r: r["files"] == ["0.pdparams",
                                                 "1.pdparams"],
    "reduce_lr_cooldown": lambda r: abs(r["lr"] - 0.25) < 1e-9,
    "set_lr_on_scheduler": lambda r: r == {},
}


@pytest.mark.parametrize("name", sorted(CALLBACK_CASES))
def test_callback_matches_reference(name, tmp_path):
    try:
        want = _callback_case("ref", name, tmp_path)
    finally:
        jdy.disable_dygraph()
    try:
        got = _callback_case("port", name, tmp_path)
    finally:
        tdy.disable_dygraph()
    assert CALLBACK_CASES[name](got)
    assert got.keys() == want.keys()
    for k in got:
        if k == "values":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                       atol=1e-4)
        else:
            assert got[k] == want[k], k


def test_progress_bar_and_summary():
    import io
    out = io.StringIO()
    bar = thapi.ProgressBar(num=2, verbose=1, file=out)
    bar.update(1, [("loss", 0.5)])
    bar.update(2, [("loss", 0.25)])
    assert "step 2/2" in out.getvalue()
    tdy.enable_dygraph(tfluid.CPUPlace())
    jdy.enable_dygraph()
    got = tpaddle.summary(TLeNet(), (2, 1, 28, 28))
    want = jpaddle.summary(JLeNet(), (2, 1, 28, 28))
    assert got == want
    assert tpaddle.Model(TLeNet()).summary() == \
        jpaddle.Model(JLeNet()).summary()


# --- fluid.reader: DataLoader, batch, shuffle --------------------------------
def test_dataloader_matches_reference():
    """The single-process DataLoader: the same batches (numpy in a
    program; VarBases on the tracer's device under one), the same
    ``bucket_edges`` and length, the same shuffled order from one numpy
    seed; ``batch`` and ``shuffle`` compose readers alike."""
    from paddle_tpu.fluid import reader as JR
    from paddle_tpu_torch.fluid import reader as TR
    data = [(np.full(3, i, "float32"), np.array([i], "int64"))
            for i in range(10)]
    out = []
    for R in (JR, TR):
        np.random.seed(5)
        dl = R.DataLoader(data, batch_size=4, shuffle=True)
        batches = [[np.asarray(a) for a in b] for b in dl]
        dl2 = R.DataLoader(data, batch_size=4, drop_last=True)
        np.random.seed(6)
        reader = R.shuffle(lambda: iter(range(10)), 4)
        out.append((batches, dl.bucket_edges, len(dl), len(dl2),
                    list(R.batch(lambda: iter(range(7)), 3)()),
                    list(reader())))
    (jb, je, jn, jn2, jbat, jsh), (tb, te, tn, tn2, tbat, tsh) = out
    assert (te, tn, tn2, tbat, tsh) == (je, jn, jn2, jbat, jsh)
    for a, b in zip(tb, jb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    tdy.enable_dygraph(tfluid.CPUPlace())
    first = next(iter(TR.DataLoader(data, batch_size=4)))
    assert all(isinstance(v, tdy.VarBase) for v in first)
    assert first[0].value().device.type == "cpu"


def test_dataloader_workers_and_staging_wait():
    from paddle_tpu_torch.fluid.reader import DataLoader
    dl = DataLoader([np.zeros(2, "float32")] * 4, batch_size=2,
                    num_workers=2)
    with pytest.raises(NotImplementedError, match="queue A item 12"):
        next(iter(dl))
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        dl.stacked(2)


def test_generator_loader_feeds_a_program():
    from paddle_tpu_torch.fluid.reader import DataLoader
    loader = DataLoader.from_generator(feed_list=["x", "y"])
    loader.set_sample_generator(
        lambda: ((np.full(2, i, "float32"), np.array([i])) for i in range(5)),
        batch_size=2, drop_last=False)
    feeds = list(loader)
    assert [f["x"].shape[0] for f in feeds] == [2, 2, 1]
    assert loader.bucket_edges == (1, 2)


# --- hapi.flops -------------------------------------------------------------
def test_flops_counts_the_products_exactly():
    """The port counts the products, two FLOP a multiply-add: exact for a
    Linear stack and for LeNet.  XLA's count in the reference adds the
    elementwise work (biases, activations, pooling): here 2.0 to 2.4%
    more, so the port's count lies between 95% and 100% of it."""
    tdy.enable_dygraph(tfluid.CPUPlace())
    lin = tnn.Sequential(tnn.Linear(32, 64), tnn.ReLU(), tnn.Linear(64, 16))
    lenet = TLeNet()
    got = (tpaddle.flops(lin, [4, 32]), tpaddle.flops(lenet, [2, 1, 28, 28]))
    tdy.disable_dygraph()
    assert got[0] == 2 * 4 * (32 * 64 + 64 * 16)
    assert got[1] == 2 * 2 * (6 * 28 * 28 * 9 + 16 * 10 * 10 * 150
                              + 400 * 120 + 120 * 84 + 84 * 10)
    jdy.enable_dygraph()
    want = (jpaddle.flops(jnn.Sequential(jnn.Linear(32, 64), jnn.ReLU(),
                                         jnn.Linear(64, 16)), [4, 32]),
            jpaddle.flops(JLeNet(), [2, 1, 28, 28]))
    jdy.disable_dygraph()
    for g, w in zip(got, want):
        assert 0.95 * w <= g <= w
    tdy.enable_dygraph(tfluid.CPUPlace())
    detail = tpaddle.flops(lin, [4, 32], custom_ops={
        tnn.ReLU: lambda layer, shape: 1000.0})
    assert detail == got[0] + 1000.0
