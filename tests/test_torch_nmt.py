"""The Transformer NMT slice: paddle_tpu_torch against paddle_tpu.

The same numpy inputs (from seeded ``RandomState``s) go through both
packages on the CPU, the reference on XLA-CPU, the port on its plain
versions: ``PositionalEmbedding``'s table, ``TransformerDecoderLayer``
(post-norm and pre-norm, the causal mask, a memory longer than the
target), and ``TransformerModel`` at a reduced NMT size (vocab 1000,
d_model 128, 4 heads, 2 + 2 layers, FFN 256, source 24 and target 16
tokens, so the cross-attention has Tq != Tk, batch 4).  Every
comparison carries the reference's ``state_dict()`` into the port
through ``interop.layer_from_numpy``, after drawing every parameter from
a seed, so that no two layers are equal (the reference's deep copies
would otherwise hide a fault in the order of the layers).

Tolerances, float32: the decoder layer's output within 1e-5; the model's
loss rtol 1e-5 and every parameter's functional gradient within 1e-4 of
the largest gradient (XLA-CPU and torch-CPU sum in different orders; a
probe measured 2.4e-7).  A port whose decoder drops the causal mask
must miss.  Under bf16 autocast every op's input and output dtypes equal
the reference tracer's, the ``Mask`` included.  Dropout is a contract,
not a bit comparison (masks are never compared across packages): rate
0.1 in eval and rate 0 in training give the same output in the port,
bit for bit, and the reference's within 1e-5; in training the rate-0.1
output differs.  The copy task of ``tests/test_book_models.py`` trains
on the port and its loss halves in 40 steps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.dygraph import base as jdy
from paddle_tpu.dygraph.functional import functional_loss as j_functional
from paddle_tpu.fluid import layers as JL
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.nn import layer as jlayer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.dygraph.functional import functional_loss as \
    t_functional
from paddle_tpu_torch.fluid import layers as TL
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.nn import layer as tlayer

HOST = tfluid.CPUPlace()
NMT = dict(src_vocab=1000, tgt_vocab=1000, d_model=128, nhead=4,
           num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=256,
           dropout=0.0, max_len=25)
SRC_T, TGT_T, BATCH = 24, 16, 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    if hasattr(x, "value"):
        x = x.value()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _close(got, want, rtol=1e-5, atol=1e-5, msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


def _seeded_state(state, seed):
    """Every parameter of ``state`` drawn anew from ``seed``: matrices
    N(0, 1 / rows), LayerNorm scales 1 + N(0, 0.1²), biases N(0, 0.02²);
    buffers (the sinusoid table) kept."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, v in state.items():
        if name.endswith(".pe"):
            out[name] = v
        elif v.ndim == 2:
            out[name] = rng.randn(*v.shape) / np.sqrt(v.shape[0])
        elif "norm" in name and name.endswith("weight"):
            out[name] = 1 + 0.1 * rng.randn(*v.shape)
        else:
            out[name] = 0.02 * rng.randn(*v.shape)
        out[name] = np.asarray(out[name], "float32")
    return out


def _causal(t):
    return np.triu(np.full((t, t), -1e9, "float32"), 1)[None, None]


def test_positional_table_matches_reference():
    with jdy.guard():
        want = jtransformer.PositionalEmbedding(96, 65).state_dict()
    with tdy.guard(HOST):
        pe = ttransformer.PositionalEmbedding(96, 65)
        got = pe.state_dict()
        x = np.random.RandomState(3).randn(2, 7, 96).astype("float32")
        out = pe(tdy.to_variable(x)).numpy()
    assert list(got) == ["pe"] == list(want)
    np.testing.assert_array_equal(got["pe"], want["pe"])
    np.testing.assert_array_equal(out, x + want["pe"][None, :7])


@pytest.mark.parametrize("pre_norm", [False, True], ids=["post", "pre"])
def test_decoder_layer_matches_reference(pre_norm):
    """Dropout 0, the causal mask on the self-attention, a memory of 11
    positions against a target of 7 (Tq != Tk in the cross-attention)."""
    rng = np.random.RandomState(5)
    tgt = rng.randn(2, 7, 32).astype("float32")
    mem = rng.randn(2, 11, 32).astype("float32")
    mask = _causal(7)

    def build(lay):
        return lay.TransformerDecoderLayer(32, 4, 64, dropout=0.0,
                                           normalize_before=pre_norm)

    with jdy.guard():
        jm = build(jlayer)
        state = _seeded_state(jm.state_dict(), 6)
        jm.set_dict(state)
        want = jm(*[jdy.to_variable(jnp.asarray(a))
                    for a in (tgt, mem, mask)])
    with tdy.guard(HOST):
        tm = build(tlayer)
        assert list(tm.state_dict()) == list(state)
        interop.layer_from_numpy(tm, state)
        got = tm(*[tdy.to_variable(a) for a in (tgt, mem, mask)])
    _close(got.value(), want, msg="decoder layer")


# ---------------------------------------------------------------------------
# TransformerModel at the chip check's host size
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """(reference model, port model, state) from one seeded state."""
    with jdy.guard():
        np.random.seed(7)
        jm = jtransformer.TransformerModel(**NMT)
        state = _seeded_state(jm.state_dict(), 8)
        jm.set_dict(state)
    with tdy.guard(HOST):
        tm = ttransformer.TransformerModel(**NMT)
        assert list(tm.state_dict()) == list(state)
        interop.layer_from_numpy(tm, state)
    return jm, tm, state


def _ids(seed):
    rng = np.random.RandomState(seed)
    v = NMT["src_vocab"]
    return (rng.randint(0, v, (BATCH, SRC_T)).astype("int64"),
            rng.randint(0, v, (BATCH, TGT_T)).astype("int64"),
            rng.randint(0, v, (BATCH, TGT_T)).astype("int64"))


def _loss(L, model, vocab=NMT["tgt_vocab"]):
    def fn(src, tgt_in, tgt_out):
        logits = model(src, tgt_in)
        return L.mean(L.softmax_with_cross_entropy(
            L.reshape(logits, [-1, vocab]), L.reshape(tgt_out, [-1, 1])))
    return fn


def _ref_step(jm, ids):
    with jdy.guard():
        jm.train()
        pv, lfn = j_functional(jm, _loss(JL, jm))
        loss, grads = jax.jit(jax.value_and_grad(lfn))(
            pv, *[jnp.asarray(a.astype("int32")) for a in ids])
    return float(loss), [_np(g) for g in grads]


def _port_step(tm, ids):
    with tdy.guard(HOST):
        tm.train()
        pv, lfn = t_functional(tm, _loss(TL, tm))
        grads, loss = torch.func.grad_and_value(lfn)(
            pv, *[torch.from_numpy(a) for a in ids])
    return float(loss), [_np(g) for g in grads]


def _no_causal_forward(self, src_ids, tgt_ids):
    """The model's forward with the decoder's causal mask dropped."""
    scale = np.sqrt(self.d_model)
    src = self.pos(TL.scale(self.src_emb(src_ids), scale=scale))
    tgt = self.pos(TL.scale(self.tgt_emb(tgt_ids), scale=scale))
    return self.out_proj(self.transformer(src, tgt))


def _grad_error(got, want):
    largest = max(float(np.abs(w).max()) for w in want)
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want)) \
        / largest


def test_model_loss_and_gradients_match_reference(models, monkeypatch):
    jm, tm, _ = models
    ids = _ids(9)
    j_loss, j_grads = _ref_step(jm, ids)
    t_loss, t_grads = _port_step(tm, ids)
    names = [n for n, _ in tm.named_parameters()]
    assert len(t_grads) == len(j_grads) == len(names)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    assert _grad_error(t_grads, j_grads) <= 1e-4
    # the twin: the port with the decoder's causal mask dropped
    monkeypatch.setattr(ttransformer.TransformerModel, "forward",
                        _no_causal_forward)
    twin_loss, twin_grads = _port_step(tm, ids)
    assert abs(twin_loss - j_loss) > 1e-5 * abs(j_loss)
    assert _grad_error(twin_grads, j_grads) > 1e-4


def test_functional_step_leaves_the_table_plain(models):
    """After a ``torch.func.grad_and_value`` step the sinusoid table is
    the same plain tensor it was: read inside the transform as a
    constant, put back by ``functionalize``, and given no gradient."""
    _, tm, _ = models
    before = tm.pos.pe._value
    _, grads = _port_step(tm, _ids(12))
    assert tm.pos.pe._value is before
    assert type(tm.pos.pe._value) is torch.Tensor
    assert len(grads) == len(tm.parameters())


def _op_dtypes(tracer_cls, log):
    """Wrap ``tracer_cls.trace_op`` to log each op's input dtypes after
    autocast and its output dtypes."""
    orig = tracer_cls.trace_op
    orig_cast = tracer_cls._autocast

    def names(slots):
        return {s: [str(v._value.dtype).split(".")[-1] for v in vs]
                for s, vs in sorted(slots.items())}

    def autocast(self, op_type, ins_vb):
        out = orig_cast(self, op_type, ins_vb)
        log.append((op_type, "in", names(out)))
        return out

    def trace_op(self, op_type, inputs, outputs, attrs=None):
        outs = orig(self, op_type, inputs, outputs, attrs)
        log.append((op_type, "out", names(outs)))
        return outs
    return trace_op, autocast


def test_autocast_dtypes_match_reference(models, monkeypatch):
    """One bf16 training forward and loss: every op's inputs after
    autocast and its outputs have the reference tracer's dtypes; the
    attention op is white, so Q, K, V and the causal ``Mask`` reach it as
    bf16 in both packages."""
    jm, tm, _ = models
    ids = _ids(10)
    logs = {}
    for key, mod in (("ref", jdy), ("port", tdy)):
        logs[key] = []
        trace_op, autocast = _op_dtypes(mod.Tracer, logs[key])
        monkeypatch.setattr(mod.Tracer, "trace_op", trace_op)
        monkeypatch.setattr(mod.Tracer, "_autocast", autocast)
    with jdy.guard():
        jdy._dygraph_tracer()._amp_enabled = True
        jm.train()
        _loss(JL, jm)(*[jdy.to_variable(jnp.asarray(a.astype("int32")))
                        for a in ids])
    with tdy.guard(HOST):
        tdy._dygraph_tracer()._amp_enabled = True
        tm.train()
        _loss(TL, tm)(*[tdy.to_variable(a) for a in ids])
    ref = [(op, d, {s: [t.replace("int32", "int64") for t in ts]
                    for s, ts in slots.items()})
           for op, d, slots in logs["ref"]]
    assert logs["port"] == ref
    attention = [slots for op, d, slots in logs["port"]
                 if op == "fused_multihead_attention" and d == "in"]
    n_layers = NMT["num_encoder_layers"] + 2 * NMT["num_decoder_layers"]
    assert len(attention) == n_layers
    masked = [s for s in attention if "Mask" in s]
    assert len(masked) == NMT["num_decoder_layers"]
    assert all(s == {"K": ["bfloat16"], "Mask": ["bfloat16"],
                     "Q": ["bfloat16"], "V": ["bfloat16"]} for s in masked)


def test_dropout_contract(models):
    """Rate 0.1 in eval and rate 0 in training: the same logits in the
    port, bit for bit, and the reference's eval logits within 1e-5; in
    training rate 0.1 gives other logits."""
    _, _, state = models
    src, tgt, _ = _ids(11)
    live = dict(NMT, dropout=0.1)
    with jdy.guard():
        jm = jtransformer.TransformerModel(**live)
        jm.set_dict(state)
        jm.eval()
        want = jm(jdy.to_variable(jnp.asarray(src.astype("int32"))),
                  jdy.to_variable(jnp.asarray(tgt.astype("int32"))))
    with tdy.guard(HOST):
        outs = {}
        for name, cfg, train in (("eval", live, False),
                                 ("rate 0", NMT, True),
                                 ("rate 0.1", live, True)):
            tm = ttransformer.TransformerModel(**cfg)
            interop.layer_from_numpy(tm, state)
            tm.train() if train else tm.eval()
            outs[name] = tm(tdy.to_variable(src),
                            tdy.to_variable(tgt)).value()
    assert torch.equal(outs["eval"], outs["rate 0"])
    _close(outs["eval"], want, msg="eval logits")
    assert not torch.allclose(outs["rate 0.1"], outs["rate 0"], atol=1e-3)


def test_copy_task_converges():
    """``tests/test_book_models.py``'s machine-translation case on the
    port: a one-layer Transformer learns to reverse token sequences
    through ``functional_loss`` and ``torch.func.grad_and_value``, SGD
    0.1; the loss halves in 40 steps."""
    vocab, seq, batch = 12, 6, 16
    with tdy.guard(HOST):
        np.random.seed(0)
        model = ttransformer.TransformerModel(
            src_vocab=vocab, tgt_vocab=vocab, d_model=32, nhead=2,
            num_encoder_layers=1, num_decoder_layers=1,
            dim_feedforward=64, dropout=0.0, max_len=seq + 1)
        model.train()
        values, lfn = t_functional(model, _loss(TL, model, vocab))
        grad_fn = torch.func.grad_and_value(lfn)
        r = np.random.RandomState(0)
        src = r.randint(2, vocab, (batch, seq)).astype("int64")
        rev = src[:, ::-1].copy()
        tgt_in = np.concatenate(
            [np.ones((batch, 1), "int64"), rev[:, :-1]], axis=1)
        feed = [torch.from_numpy(a) for a in (src, tgt_in, rev)]
        losses = []
        for _ in range(40):
            grads, loss = grad_fn(values, *feed)
            values = [v - 0.1 * g for v, g in zip(values, grads)]
            losses.append(float(loss))
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0] * 0.5, losses
