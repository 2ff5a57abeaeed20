"""The dygraph-to-static tier of paddle_tpu_torch against paddle_tpu:
``declarative`` / ``to_static`` (dygraph/jit_static.py, the
``run_program`` op), ``paddle.jit.save`` / ``load`` and ``TracedLayer``.

Each case builds the same layer in both packages, carries the
reference's weights into the port (``interop.layer_from_numpy``) and runs
both on the CPU from the same numpy inputs.  Tolerances, float32: layer
outputs and gradients rtol 1e-5, atol 1e-6; BERT losses rtol 1e-4 and
every gradient's cosine 0.9999 (the key bias's, zero in exact
arithmetic, within 1e-6 of the largest gradient); the served LeNet
within 1e-5 of the reference's largest logit.  Dropout runs at rate 0
where outputs are compared; the dropout contract is held within the
port (masks are never compared across packages).

One fault of the reference is pinned here: ``TracedLayer.trace`` binds
parameters in name-sorted order, so a ``Linear`` fails inside its jit
(ROADMAP queue C); the port binds them by name.
"""
import os

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.dygraph import base as jdy
from paddle_tpu.dygraph import jit as jjit
from paddle_tpu.dygraph.layers import Layer as JLayer
from paddle_tpu.dygraph import nn as jnn
import paddle_tpu.fluid.layers as JL

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.dygraph import jit as tjit
from paddle_tpu_torch.dygraph.layers import Layer as TLayer
from paddle_tpu_torch.dygraph import nn as tnn
import paddle_tpu_torch.fluid.layers as TL

jax.config.update("jax_platforms", "cpu")

RTOL, ATOL = 1e-5, 1e-6


def _np(v):
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=rtol, atol=atol)


class _Both:
    """Each package's dygraph mode, the port on the CPU."""

    def __enter__(self):
        jdy.enable_dygraph()
        tdy.enable_dygraph(tfluid.CPUPlace())
        return self

    def __exit__(self, *exc):
        jdy.disable_dygraph()
        tdy.disable_dygraph()


@pytest.fixture
def both():
    with _Both() as b:
        yield b


def _mlp(pkg):
    """The reference test's MLP, in package ``pkg`` ("j" or "t")."""
    Layer, nn, L, jit = ((JLayer, jnn, JL, jjit) if pkg == "j"
                         else (TLayer, tnn, TL, tjit))

    class MLP(Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16)
            self.fc2 = nn.Linear(16, 4)

        @jit.declarative
        def forward(self, x):
            return self.fc2(L.relu(self.fc1(x)))

    return MLP()


def _pair(make):
    """(reference layer, port layer with the reference's weights)."""
    jm, tm = make("j"), make("t")
    interop.layer_from_numpy(tm, jm.state_dict())
    return jm, tm


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


# --- declarative: the cases of tests/test_jit_static.py --------------------
def test_mlp_forward_and_one_build(both):
    jm, tm = _pair(_mlp)
    x = _x(4, 8)
    _close(tm(tdy.to_variable(x)), jm(jdy.to_variable(x)))
    for _ in range(3):
        tm(tdy.to_variable(x))
    entry = next(iter(tm._declarative_caches.values()))
    assert len(tm._declarative_caches) == 1 and entry["cell"]["traces"] == 1
    # a new input signature records a second tree, as jax.jit retraces
    jm(jdy.to_variable(_x(2, 8)))
    tm(tdy.to_variable(_x(2, 8)))
    jentry = next(iter(jm._declarative_caches.values()))
    assert entry["cell"]["traces"] == jentry["cell"]["traces"] == 2


def test_mlp_is_one_tape_entry_and_backward_matches(both):
    jm, tm = _pair(_mlp)
    x = _x(4, 8, seed=1)
    tdy._dygraph_tracer()._tape.clear()
    out = tm(tdy.to_variable(x))
    tape = tdy._dygraph_tracer()._tape
    assert [e.op_type for e in tape] == ["run_program"]
    TL.mean(TL.square(out)).backward()
    JL.nn.mean(JL.nn.square(jm(jdy.to_variable(x)))).backward()
    for (n, tp), (_, jp) in zip(tm.named_parameters(),
                                jm.named_parameters()):
        _close(tp.gradient(), np.asarray(jp._grad))
    # the same gradients as the port's own eager tape
    want = [p.gradient().copy() for p in tm.parameters()]
    tm.clear_gradients()
    eager = type(tm).forward._fn(tm, tdy.to_variable(x))
    TL.mean(TL.square(eager)).backward()
    for w, p in zip(want, tm.parameters()):
        _close(p.gradient(), w)


def test_parameter_updates_are_read(both):
    _, tm = _pair(_mlp)
    x = tdy.to_variable(_x(2, 8))
    y1 = tm(x).numpy()
    for p in tm.parameters():
        p._value = p._value + 1.0
    assert not np.allclose(y1, tm(x).numpy())


def test_free_function_and_static_arguments(both):
    def build(dec, L):
        @dec
        def f(a, b):
            return L.relu(a + b), a - b

        @dec
        def g(x, scale):
            return L.scale(x, scale=scale)
        return f, g

    jf, jg = build(jjit.declarative, JL)
    tf, tg = build(tjit.declarative, TL)
    a, b = _x(3, 3, seed=2), _x(3, 3, seed=3)
    for got, want in zip(tf(tdy.to_variable(a), tdy.to_variable(b)),
                         jf(jdy.to_variable(a), jdy.to_variable(b))):
        _close(got, want)
    for s in (2.0, 3.0):
        _close(tg(tdy.to_variable(a), s), jg(jdy.to_variable(a), s))
    assert len(tg._own_cache) == len(jg._own_cache) == 2


def test_transformer_encoder_layer(both):
    from paddle_tpu.nn.layer import TransformerEncoderLayer as J
    from paddle_tpu_torch.nn.layer import TransformerEncoderLayer as T

    def make(pkg):
        layer = (J if pkg == "j" else T)(64, 4, 128, dropout=0.0,
                                         attn_dropout=0.0)
        layer.eval()
        return layer

    jl, tl = _pair(make)
    x = _x(2, 16, 64, seed=4)
    jfwd, tfwd = (jjit.declarative(J.forward), tjit.declarative(T.forward))
    want = jfwd(jl, jdy.to_variable(x))
    _close(tfwd(tl, tdy.to_variable(x)), want, rtol=2e-5)
    _close(tl(tdy.to_variable(x)), want, rtol=2e-5)
    entry = next(iter(tl._declarative_caches.values()))
    for _ in range(3):
        tfwd(tl, tdy.to_variable(x))
    assert entry["cell"]["traces"] == 1


def _bn_net(pkg):
    Layer, nn, jit = ((JLayer, jnn, jjit) if pkg == "j"
                      else (TLayer, tnn, tjit))

    class BNNet(Layer):
        def __init__(self):
            super().__init__()
            self.bn = nn.BatchNorm(4, momentum=0.5)

        @jit.declarative
        def forward(self, x):
            return self.bn(x)

    return BNNet()


def _plain(t):
    return type(t) is torch.Tensor and \
        not torch._C._functorch.is_functorch_wrapped_tensor(t)


def test_batchnorm_buffers_written_back(both):
    jm, tm = _pair(_bn_net)
    jm.train()
    tm.train()
    x = _x(8, 4, seed=5) + 3.0
    for _ in range(2):
        jm(jdy.to_variable(x))
        tm(tdy.to_variable(x))
        for tb, jb in zip(tm.buffers(), jm.buffers()):
            _close(tb.numpy(), np.asarray(jb._value))
            assert _plain(tb._value)
    # a call whose gradient is wanted runs under torch.func.vjp: the
    # buffers written back are plain tensors all the same
    xv = tdy.to_variable(x)
    xv.stop_gradient = False
    TL.mean(TL.square(tm(xv))).backward()
    assert all(_plain(b._value) for b in tm.buffers())
    assert xv.gradient() is not None
    tm.eval()
    tm(tdy.to_variable(x))      # an eval call reads live buffers


def test_dict_tensor_arguments(both):
    def build(dec):
        @dec
        def f(x, extras):
            return x + extras["bias"]
        return f

    jf, tf = build(jjit.declarative), build(tjit.declarative)
    x = _x(2, 3)
    for b in (np.ones((2, 3), "float32"), np.full((2, 3), 5.0, "float32")):
        _close(tf(tdy.to_variable(x), {"bias": tdy.to_variable(b)}),
               jf(jdy.to_variable(x), {"bias": jdy.to_variable(b)}))
    assert len(tf._own_cache) == len(jf._own_cache) == 1


def _drop_net(rate):
    class DropNet(TLayer):
        def __init__(self):
            super().__init__()
            self.drop = tnn.Dropout(rate)

        @tjit.declarative
        def forward(self, x):
            return self.drop(x)

    return DropNet()


def test_dropout_contract(both):
    """Rate 0 gives exactly the reference's output; at 0.5 the kept
    fraction is 1 - rate, the mask changes call by call, and the
    backward regenerates the forward's mask."""
    x = _x(4, 64, seed=6)
    jd = jnn.Dropout(0.0)
    jd.train()
    want = np.asarray(jjit.declarative(lambda v: jd(v))(
        jdy.to_variable(x))._value)
    net0 = _drop_net(0.0)
    net0.train()
    np.testing.assert_array_equal(net0(tdy.to_variable(x)).numpy(), want)

    net = _drop_net(0.5)
    net.train()
    ones = tdy.to_variable(np.ones((64, 256), "float32"))
    ones.stop_gradient = False
    a = net(ones)
    kept = float((a.numpy() != 0).mean())
    n = ones.numpy().size
    assert abs(kept - 0.5) < 6 * np.sqrt(0.25 / n)
    TL.reduce_sum(a).backward()
    np.testing.assert_array_equal(ones.gradient(), a.numpy())
    assert not np.array_equal(a.numpy(), net(ones).numpy())


# --- BertForPretraining through to_static ----------------------------------
BERT = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, max_position=16, dropout=0.0,
            attn_dropout=0.0)


def _bert_inputs():
    r = np.random.RandomState(7)
    return (r.randint(0, 100, (2, 16)).astype("int64"),
            r.randint(0, 100, (2, 16)).astype("int64"),
            r.randint(0, 2, (2,)).astype("int64"))


def _cosine(a, b):
    a, b = np.ravel(a).astype("float64"), np.ravel(b).astype("float64")
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def test_bert_for_pretraining_through_to_static(both):
    from paddle_tpu.models.bert import BertForPretraining as JBert
    from paddle_tpu_torch.models.bert import BertForPretraining as TBert

    jm, tm = JBert(**BERT), TBert(**BERT)
    interop.layer_from_numpy(tm, jm.state_dict())
    jm.train()
    tm.train()

    def loss_fn(model, ids, mlm, nsp):
        return model.loss(*model(ids), mlm, nsp)

    jfn, tfn = jjit.declarative(loss_fn), tpaddle.jit.to_static(loss_fn)
    ids, mlm, nsp = _bert_inputs()
    jloss = jfn(jm, *(jdy.to_variable(a) for a in (ids, mlm, nsp)))
    jloss.backward()
    tdy._dygraph_tracer()._tape.clear()
    tloss = tfn(tm, *(tdy.to_variable(a) for a in (ids, mlm, nsp)))
    assert [e.op_type for e in tdy._dygraph_tracer()._tape] == \
        ["run_program"]
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(np.asarray(
        jloss._value)), rtol=1e-4)
    jg = {n: np.asarray(p._grad) for n, p in jm.named_parameters()}
    # the key projection's bias has a zero gradient in exact arithmetic
    # (softmax ignores a shift shared by a row's scores): both packages
    # give it rounding noise, held to 1e-6 of the largest gradient
    floor = 1e-6 * max(float(np.abs(g).max()) for g in jg.values())
    for n, p in tm.named_parameters():
        if "k_proj.bias" in n:
            np.testing.assert_allclose(p.gradient(), jg[n], rtol=0,
                                       atol=floor)
        else:
            assert _cosine(p.gradient(), jg[n]) > 0.9999, n


# --- jit.save and jit.load --------------------------------------------------
def test_jit_save_load_lenet(both, tmp_path):
    import paddle_tpu as jpaddle
    from paddle_tpu.vision.models import LeNet as JLeNet
    from paddle_tpu_torch.vision.models import LeNet as TLeNet

    np.random.seed(0)
    jm, tm = JLeNet(), TLeNet()
    interop.layer_from_numpy(tm, jm.state_dict())
    jm.eval()
    tm.eval()
    x = _x(2, 1, 28, 28, seed=8)
    eager = tm(tdy.to_variable(x)).numpy()
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "ref")
    tpaddle.jit.save(tm, tdir, input_spec=[x])
    jpaddle.jit.save(jm, jdir, input_spec=[x])
    assert sorted(os.listdir(tdir)) == ["jit_meta.json", "model.pt2",
                                        "state.npz"]
    served = tpaddle.jit.load(tdir)
    out = served(x).numpy()
    np.testing.assert_allclose(out, eager, rtol=1e-6, atol=1e-6)
    # within 1e-5 of the largest logit: logits near 0 carry the
    # packages' rounding (about 3e-7 of the largest) at any rtol
    ref = np.asarray(jpaddle.jit.load(jdir)(x)._value)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))
    tstate, jstate = served.state_dict(), jpaddle.jit.load(jdir).state_dict()
    assert sorted(tstate) == sorted(jstate)
    for k in tstate:
        np.testing.assert_array_equal(tstate[k], jstate[k])
    assert open(os.path.join(tdir, "jit_meta.json")).read() == \
        open(os.path.join(jdir, "jit_meta.json")).read()


def test_exported_graph_holds_the_flash_op(tmp_path):
    """BertModel's eval forward exports with the flash custom op in its
    graph (its host implementation is the plain version), and the loaded
    artifact gives the eager forward."""
    from paddle_tpu_torch.models.bert import BertModel
    with tdy.guard(tfluid.CPUPlace()):
        m = BertModel(**BERT)
        m.eval()
        ids = np.random.RandomState(9).randint(0, 100, (2, 16)) \
            .astype("int64")
        want = m(tdy.to_variable(ids))
        tpaddle.jit.save(m, str(tmp_path), input_spec=[ids])
    served = tpaddle.jit.load(str(tmp_path))
    ops = [str(n.target) for n in served._exported.graph.nodes
           if n.op == "call_function"]
    assert ops.count("paddle_tpu_torch.flash_attention_fwd.default") == \
        BERT["num_layers"]
    for got, w in zip(served(ids), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_to_static_alias():
    assert tpaddle.jit.to_static is tpaddle.jit.declarative
    assert tpaddle.dygraph.declarative is tpaddle.jit.declarative
    assert tpaddle.dygraph.TracedLayer is tpaddle.jit.TracedLayer


# --- TracedLayer -------------------------------------------------------------
def test_traced_layer_matches_reference_eager(both, tmp_path):
    def make(pkg):
        Layer, nn, L = ((JLayer, jnn, JL) if pkg == "j"
                        else (TLayer, tnn, TL))

        class Net(Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = nn.Linear(8, 16)
                self.fc2 = nn.Linear(16, 4)

            def forward(self, x):
                return self.fc2(L.relu(self.fc1(x)))
        return Net()

    jm, tm = _pair(make)
    x = _x(3, 8, seed=10)
    want = jm(jdy.to_variable(x))
    out, traced = tpaddle.jit.TracedLayer.trace(tm, [tdy.to_variable(x)])
    _close(out, want)
    _close(traced(x), want)
    traced.save_inference_model(str(tmp_path))
    import pickle
    with open(tmp_path / "traced_layer.pkl", "rb") as f:
        state = pickle.load(f)["state"]
    assert sorted(state) == sorted(jm.state_dict())
    assert all(isinstance(v, np.ndarray) for v in state.values())


def test_reference_traced_layer_binds_sorted(both):
    """The reference's fault: ``trace`` zips ``named_parameters()``
    (weight, bias) with the values of a dict ``jax.jit`` sorted by name,
    so a ``Linear(4, 3)`` gets its bias as its weight and fails.  The
    port binds by name."""
    jl = jnn.Linear(4, 3)
    w = jl.state_dict()        # read first: the failed trace leaves tracers
    with pytest.raises(TypeError, match="dot_general"):
        jjit.TracedLayer.trace(jl, [jdy.to_variable(_x(2, 4))])
    tl = tnn.Linear(4, 3)
    interop.layer_from_numpy(tl, w)
    out, _ = tjit.TracedLayer.trace(tl, [tdy.to_variable(_x(2, 4))])
    _close(out, _x(2, 4) @ w["weight"] + w["bias"])
