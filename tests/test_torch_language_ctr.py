"""The models of this slice: paddle_tpu_torch against paddle_tpu.

``models/language.py`` (``SkipGram``, ``PtbLm``) and ``models/ctr.py``
(``WideDeep``, ``DeepFM``) at a few units, built in both packages, the
reference's ``state_dict`` carried into the port, inputs from a seed:
the loss (rtol 1e-4), the tape's first-step gradients of every
parameter (within 1e-4 of each tensor's largest value), ``perplexity``
and ``most_similar``; one ``optimizer.SGD`` step under
``ClipGradByGlobalNorm`` and an ``ExponentialDecay`` after it.  The CTR
models train as the reference's PS trainer trains ``WideDeep``
(``tests/ps_ctr_trainer.py``): the mean squared error of the sigmoid
output against the label.  Dropout is compared across packages only
where it is deterministic (rate 0, and ``eval()``'s
``downgrade_in_infer`` scaling by ``1 - p``); with it live the port is
held to the dropout contract: ``Out == X · Mask`` unscaled, and three
dropout launches forward and three backward a step, the tape's backward
running none of the forwards again.
"""
import numpy as np
import pytest

import paddle_tpu.optimizer as jopt
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.fluid import clip as jclip
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import layers as jL
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import language as jlang

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.fluid import clip as tclip
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import layers as tL
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import language as tlang
from paddle_tpu_torch.ops import nn_ops

PTB = dict(vocab_size=30, hidden_size=8, num_layers=2)
PTB_B, PTB_T = 2, 4
CTR = dict(num_slots=4, vocab_per_slot=50, embed_dim=4, dense_dim=13)
CTR_B = 8


def _pkg(name):
    if name == "j":
        return jdy, jframework, jlang, jctr, jL, jopt, jclip, {}
    return (tdy, tframework, tlang, tctr, tL, topt, tclip,
            {"place": tfluid.CPUPlace()})


def _guard(dy, kw):
    return dy.guard(kw["place"]) if kw else dy.guard()


def _close(got, want, what, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max() + 1e-7,
                               err_msg=what)


def _grads(model):
    return {n: np.asarray(p.gradient()) for n, p in model.named_parameters()}


def _ptb_ids(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, PTB["vocab_size"], (PTB_B, PTB_T)).astype("int64")
    lbl = rng.randint(0, PTB["vocab_size"], (PTB_B, PTB_T)).astype("int64")
    return ids, lbl


def _ptb_run(name, state=None, dropout=0.0):
    """The eval logits and perplexity, then the training logits, loss
    and gradients of one step and the weights after its clipped SGD
    update."""
    dy, fw, lang, _, _, opt, clip, kw = _pkg(name)
    fw.reset_unique_name()
    ids, lbl = _ptb_ids()
    with _guard(dy, kw):
        model = lang.PtbLm(dropout=dropout, **PTB)
        if state is None:
            state = model.state_dict()
        else:
            assert list(model.state_dict()) == list(state)
            interop.layer_from_numpy(model, state)
        model.eval()
        eval_logits = model(dy.to_variable(ids))
        ppl = model.perplexity(eval_logits, dy.to_variable(lbl))
        model.train()
        sched = opt.ExponentialDecay(1.0, 0.5)
        sgd = opt.SGD(learning_rate=sched, parameters=model.parameters(),
                      grad_clip=clip.ClipGradByGlobalNorm(0.05))
        logits = model(dy.to_variable(ids))
        loss = model.loss(logits, dy.to_variable(lbl))
        loss.backward()
        grads = _grads(model)
        sgd.step()
        sgd.clear_grad()
        sched.step()
        return dict(state=state, loss=float(loss), ppl=ppl,
                    logits=np.asarray(logits.numpy()), grads=grads,
                    after={k: np.asarray(v)
                           for k, v in model.state_dict().items()},
                    eval_logits=np.asarray(eval_logits.numpy()),
                    lr=sgd.get_lr())


def test_ptb_lm_matches_reference():
    want = _ptb_run("j")
    got = _ptb_run("t", want["state"])
    _close(got["logits"], want["logits"], "logits")
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    assert abs(got["ppl"] - want["ppl"]) <= 1e-4 * want["ppl"]
    assert set(got["grads"]) == set(want["grads"]) == set(want["state"])
    for k in want["grads"]:
        _close(got["grads"][k], want["grads"][k], k)
    for k in want["after"]:
        _close(got["after"][k], want["after"][k], k, rtol=1e-5)
    assert got["lr"] == want["lr"] == 0.5
    # the clip took effect: the weights moved by at most lr · 0.05
    moved = [np.abs(got["after"][k] - np.asarray(want["state"][k])).max()
             for k in want["state"]]
    assert 0 < max(moved) <= 0.05 + 1e-6


def test_ptb_lm_eval_scales_by_keep_rate_as_reference():
    """``Dropout``'s default ``downgrade_in_infer``: eval multiplies by
    ``1 - p`` at each of the three dropouts."""
    want = _ptb_run("j", dropout=0.65)
    got = _ptb_run("t", want["state"], dropout=0.65)
    _close(got["eval_logits"], want["eval_logits"], "eval logits")
    rate0 = _ptb_run("t", want["state"], dropout=0.0)
    assert not np.allclose(got["eval_logits"], rate0["eval_logits"])


def test_ptb_lm_dropout_contract_and_launches(monkeypatch):
    """Live dropout (0.65, ``downgrade_in_infer``) in a training step:
    every output is ``X · Mask`` (kept values unscaled), and the step
    runs three dropout forwards, three masks and three backwards: the
    tape's backward takes the dropout's own gradient and runs no
    forward again."""
    calls = {"dropout": 0, "keep": 0}
    plain_dropout, plain_keep = nn_ops._reference_dropout, \
        nn_ops._reference_keep

    def counted_dropout(*a):
        calls["dropout"] += 1
        return plain_dropout(*a)

    def counted_keep(*a):
        calls["keep"] += 1
        return plain_keep(*a)

    monkeypatch.setattr(nn_ops, "_reference_dropout", counted_dropout)
    monkeypatch.setattr(nn_ops, "_reference_keep", counted_keep)
    tframework.reset_unique_name()
    ids, lbl = _ptb_ids(1)
    with tdy.guard(tfluid.CPUPlace()):
        model = tlang.PtbLm(dropout=0.65, **PTB)
        seen = []
        model.dropout.register_forward_post_hook(
            lambda layer, args, out: seen.append((args[0], out)))
        loss = model.loss(model(tdy.to_variable(ids)),
                          tdy.to_variable(lbl))
        forward = dict(calls)
        loss.backward()
        grads = _grads(model)
    assert len(seen) == 3
    assert forward == {"dropout": 3, "keep": 6}     # 3 outputs + 3 masks
    assert calls == {"dropout": 6, "keep": 9}       # + 3 backwards
    for x, out in seen:
        x, out = x.numpy(), out.numpy()
        kept = out != 0
        np.testing.assert_array_equal(out[kept], x[kept])
        assert 0.25 < 1 - kept.mean() < 0.95
    assert all(np.isfinite(g).all() for g in grads.values())


def _skipgram_run(name, state=None):
    dy, fw, lang, _, _, _, _, kw = _pkg(name)
    fw.reset_unique_name()
    with _guard(dy, kw):
        model = lang.SkipGram(20, embed_dim=6, neg_num=3)
        if state is None:
            state = model.state_dict()
        else:
            interop.layer_from_numpy(model, state)
        rng = np.random.RandomState(4)
        center = rng.randint(0, 20, (5,)).astype("int64")
        context = rng.randint(0, 20, (5,)).astype("int64")
        neg = model.sample_negatives(5, np.random.RandomState(8))
        loss = model(dy.to_variable(center), dy.to_variable(context),
                     dy.to_variable(neg))
        loss.backward()
        return dict(state=state, loss=float(loss), grads=_grads(model),
                    neg=neg, similar=np.asarray(model.most_similar(3, k=4)),
                    neg_gen=model.sample_negatives(
                        2, np.random.default_rng(1)))


def test_skipgram_matches_reference():
    want = _skipgram_run("j")
    got = _skipgram_run("t", want["state"])
    np.testing.assert_array_equal(got["neg"], want["neg"])
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    for k in want["grads"]:
        _close(got["grads"][k], want["grads"][k], k)
    np.testing.assert_array_equal(got["similar"], want["similar"])
    assert 3 not in got["similar"]
    np.testing.assert_array_equal(got["neg_gen"], want["neg_gen"])


def _ctr_run(name, cls, state=None):
    dy, fw, _, ctr, L, _, _, kw = _pkg(name)
    fw.reset_unique_name()
    rng = np.random.RandomState(6)
    offsets = np.arange(CTR["num_slots"]) * CTR["vocab_per_slot"]
    sparse = (rng.randint(0, CTR["vocab_per_slot"],
                          (CTR_B, CTR["num_slots"])) + offsets).astype("int64")
    dense = rng.randn(CTR_B, CTR["dense_dim"]).astype("float32")
    label = rng.randint(0, 2, (CTR_B, 1)).astype("float32")
    hidden = (16, 16, 16) if cls == "WideDeep" else (16, 16)
    with _guard(dy, kw):
        model = getattr(ctr, cls)(hidden=hidden, **CTR)
        if state is None:
            state = model.state_dict()
        else:
            assert list(model.state_dict()) == list(state)
            interop.layer_from_numpy(model, state)
        pred = model(dy.to_variable(sparse), dy.to_variable(dense))
        loss = L.mean(L.square(pred - dy.to_variable(label)))
        loss.backward()
        return dict(state=state, pred=np.asarray(pred.numpy()),
                    loss=float(loss), grads=_grads(model))


@pytest.mark.parametrize("cls", ["WideDeep", "DeepFM"])
def test_ctr_model_matches_reference(cls):
    want = _ctr_run("j", cls)
    got = _ctr_run("t", cls, want["state"])
    _close(got["pred"], want["pred"], "pred")
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for k in want["grads"]:
        _close(got["grads"][k], want["grads"][k], k)
    # the embedding gradient is dense: rows of ids not in the batch are 0
    emb = got["grads"]["embed.weight"]
    assert emb.shape == (CTR["num_slots"] * CTR["vocab_per_slot"],
                         CTR["embed_dim"])
    assert 0 < (np.abs(emb).sum(1) > 0).sum() <= CTR_B * CTR["num_slots"]
