"""Static AMP of paddle_tpu_torch (amp/static_amp.py: ``decorate``,
``OptimizerWithMixedPrecision``, ``rewrite_program_bf16``, and the
``check_finite_and_unscale`` / ``update_loss_scaling`` ops) against
paddle_tpu's.

LeNet and a 2-layer static BERT classifier (the naive attention chain of
``models/static_graphs``) are built in both packages under
``decorate(Adam, init_loss_scaling=2**15, use_dynamic_loss_scaling=True,
decr_ratio=0.5)``: the op-type streams are equal, and from the
reference's startup state carried into the port the bf16 losses agree
within the reference's own bf16 bound (rtol 0.05, atol 0.05,
``tests/test_amp_plane.py:123``) over 3 steps.  Under an injected
overflow (one infinite value in the feed: LeNet's image, BERT's attention
mask) the scale, good-step and bad-step trajectory equals the
reference's exactly and every gradient reaching the optimizer is zero.

The reference's ``decorate`` drops its four scaling arguments (ROADMAP
queue C): its ``update_loss_scaling`` keeps the op's defaults (1000, 2,
2.0, 0.5).  The port passes them on; at ``decr_ratio=0.8`` the
reference's scale still halves and the port's falls to 0.8 of itself.
"""
import numpy as np
import pytest

import paddle_tpu.amp as jamp
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid.framework import reset_unique_name as j_reset
from paddle_tpu.models import static_graphs as jgraphs
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.amp as tamp
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset
from paddle_tpu_torch.models import static_graphs as tgraphs
from paddle_tpu_torch.ops import registry as treg

HOST = tfluid.CPUPlace()
BOUND = dict(rtol=0.05, atol=0.05)
PKG = {"ref": (jfluid, j_reset, jamp, jgraphs),
       "port": (tfluid, t_reset, tamp, tgraphs)}
SCALE_VARS = ["loss_scaling", "good_steps", "bad_steps"]


def _lenet(fluid, graphs, rng):
    L = fluid.layers
    img = fluid.data("img", [-1, 1, 28, 28])
    label = fluid.data("label", [-1, 1], dtype="int64")
    h = L.pool2d(L.conv2d(img, 6, 5, act="relu"), 2, pool_stride=2)
    h = L.pool2d(L.conv2d(h, 16, 5, act="relu"), 2, pool_stride=2)
    h = L.fc(L.fc(h, 120, act="relu"), 84, act="relu")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 10), label))
    feed = {"img": rng.randn(8, 1, 28, 28).astype("float32"),
            "label": rng.randint(0, 10, (8, 1)).astype("int64")}
    return loss, feed


def _bert(fluid, graphs, rng):
    L = fluid.layers
    seq, hidden = 16, 32
    ids = fluid.data("ids", [-1, seq], dtype="int64")
    labels = fluid.data("labels", [-1, 1], dtype="int64")
    am = L.reshape(fluid.data("attn_mask", [-1, seq]), [0, 1, 1, seq])
    mask = L.scale(am, scale=10000.0, bias=-10000.0, bias_after_scale=False)
    h = L.embedding(ids, size=[64, hidden])
    for _ in range(2):
        h = graphs._naive_attention(h, hidden, 4, mask=mask)
        h = L.fc(h, hidden, num_flatten_dims=2, act="relu")
    logits = L.fc(L.reduce_mean(h, dim=[1]), 2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, labels))
    return loss, graphs.bert_demo_feed(rng, batch=4)


MODELS = {"lenet": _lenet, "bert": _bert}


def _build(pkg, model, **deco):
    """(main, startup, loss, feed, decorated optimizer) in ``pkg``."""
    fluid, reset, amp, graphs = PKG[pkg]
    reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, feed = MODELS[model](fluid, graphs, np.random.RandomState(3))
        kw = dict(init_loss_scaling=2.0 ** 15,
                  use_dynamic_loss_scaling=True, decr_ratio=0.5)
        kw.update(deco)
        opt = amp.decorate(fluid.optimizer.Adam(1e-3), **kw)
        opt.minimize(loss)
    return main, startup, loss, feed, opt


def _poisoned(model, feed):
    """The feed with one infinite value: an overflow in every gradient
    (LeNet's image; BERT's attention mask, whose bias then makes a row of
    scores infinite)."""
    feed = {k: v.copy() for k, v in feed.items()}
    feed["img" if model == "lenet" else "attn_mask"].flat[0] = np.inf
    return feed


def _run_both(model, steps, poison=0, **deco):
    """Each package's fetches of ``steps`` steps from the reference's
    startup state, the first ``poison`` of them on the poisoned feed:
    [loss, loss_scaling, good_steps, bad_steps] a step."""
    out = {}
    jm, js, jloss, feed, _ = _build("ref", model, **deco)
    feeds = [_poisoned(model, feed)] * poison + [feed] * (steps - poison)
    fetch = [jloss.name] + SCALE_VARS
    with jcore.scope_guard(jcore.Scope()):
        exe = jfluid.Executor()
        exe.run(js)
        scope = jcore.global_scope()
        init = {n: np.asarray(scope.find_var(n))
                for n, v in jm.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        out["ref"] = [[np.asarray(v) for v in
                       exe.run(jm, feed=f, fetch_list=fetch)]
                      for f in feeds]
    tm, ts, tloss, feed, _ = _build("port", model, **deco)
    scope, exe = tfluid.Scope(), tfluid.Executor(HOST)
    exe.run(ts, scope=scope)
    interop.scope_from_numpy(init, scope, HOST)
    out["port"] = [[np.asarray(v) for v in
                    exe.run(tm, feed=f, fetch_list=fetch, scope=scope)]
                   for f in feeds]
    return out["ref"], out["port"], (jm, tm)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_op_stream_equals_the_reference(model):
    streams = {pkg: [op.type for op in _build(pkg, model)[0]
                     .global_block().ops] for pkg in PKG}
    assert streams["port"] == streams["ref"]
    for t in ("check_finite_and_unscale", "update_loss_scaling"):
        assert streams["port"].count(t) == 1


@pytest.mark.parametrize("model", sorted(MODELS))
def test_losses_and_scale_over_three_steps(model):
    ref, port, _ = _run_both(model, 3)
    for r, p in zip(ref, port):
        assert np.allclose(float(p[0]), float(r[0]), **BOUND), (p, r)
        for a, b in zip(p[1:], r[1:]):       # scale, good, bad: exact
            np.testing.assert_array_equal(a.ravel(), b.ravel())
    assert [float(p[2][0]) for p in port] == [1.0, 2.0, 3.0]  # good steps


@pytest.mark.parametrize("model", sorted(MODELS))
def test_overflow_trajectory_equals_the_reference(model):
    """4 overflowing steps, then 2 good ones: the scale halves after
    each 2 bad steps and counts good steps after."""
    ref, port, _ = _run_both(model, 6, poison=4)
    traj = {k: [[float(np.ravel(s[i])[0]) for i in (1, 2, 3)] for s in v]
            for k, v in (("ref", ref), ("port", port))}
    assert traj["port"] == traj["ref"]
    s = 2.0 ** 15
    assert traj["port"] == [[s, 0, 1], [s / 2, 0, 0], [s / 2, 0, 1],
                            [s / 4, 0, 0], [s / 4, 1, 0], [s / 4, 2, 0]]


def test_overflow_zeroes_the_gradients():
    """FoundInfinite is set and the gradients the update reads are 0."""
    main, startup, loss, feed, opt = _build("port", "lenet")
    ops = main.global_block().ops
    upd = next(op for op in ops if op.type == "update_loss_scaling")
    grads = list(upd.outputs["Out"])
    found = upd.inputs["FoundInfinite"][0]
    scope, exe = tfluid.Scope(), tfluid.Executor(HOST)
    exe.run(startup, scope=scope)
    vals = exe.run(main, feed=_poisoned("lenet", feed),
                   fetch_list=[found] + grads, scope=scope)
    assert bool(np.ravel(vals[0])[0])
    assert all(not np.any(np.asarray(g)) for g in vals[1:])
    assert opt.get_loss_scaling().name == "loss_scaling"


def test_decorate_arguments_reach_the_op():
    """The reference's fault: ``decorate`` drops decr_ratio and the
    rest, so at decr_ratio=0.8 its scale still halves after two bad
    steps; the port's falls to 0.8 of itself."""
    ref, port, (jm, tm) = _run_both("lenet", 2, poison=2, decr_ratio=0.8)
    assert float(np.ravel(ref[1][1])[0]) == 2.0 ** 14
    assert float(np.ravel(port[1][1])[0]) == float(
        np.float32(2.0 ** 15) * np.float32(0.8))
    jattrs = next(op for op in jm.global_block().ops
                  if op.type == "update_loss_scaling").attrs
    tattrs = next(op for op in tm.global_block().ops
                  if op.type == "update_loss_scaling").attrs
    assert "decr_ratio" not in jattrs
    assert tattrs["decr_ratio"] == 0.8 and tattrs["incr_every_n_steps"] == \
        1000 and tattrs["decr_every_n_nan_or_inf"] == 2 and \
        tattrs["incr_ratio"] == 2.0


# --- the two ops against the reference's lowerings --------------------------
def _ops_ins(seed, inf):
    r = np.random.RandomState(seed)
    xs = [r.randn(3, 4).astype("float32"), r.randn(5).astype("float32")]
    if inf:
        xs[1][2] = np.inf
    return xs


@pytest.mark.parametrize("inf", [False, True], ids=["finite", "inf"])
@pytest.mark.parametrize("good,bad", [(0, 0), (999, 0), (5, 1)])
def test_scaling_ops_match_the_reference(inf, good, bad):
    import jax.numpy as jnp
    import torch
    xs = _ops_ins(good + bad, inf)
    scale = np.array([1024.0], "float32")
    attrs = {"incr_every_n_steps": 1000, "decr_every_n_nan_or_inf": 2,
             "incr_ratio": 2.0, "decr_ratio": 0.5}
    outs = {}
    for pkg, reg, arr in (("ref", jreg, jnp.asarray),
                          ("port", treg, torch.as_tensor)):
        ctx = reg.LoweringContext()
        c = reg.get_op("check_finite_and_unscale").fn(
            {"X": [arr(x) for x in xs], "Scale": [arr(scale)]}, {}, ctx)
        u = reg.get_op("update_loss_scaling").fn(
            {"X": c["Out"], "FoundInfinite": c["FoundInfinite"],
             "PrevLossScaling": [arr(scale)],
             "InGoodSteps": [arr(np.array([good], "int32"))],
             "InBadSteps": [arr(np.array([bad], "int32"))]}, attrs, ctx)
        outs[pkg] = [np.asarray(v) for v in
                     c["Out"] + c["FoundInfinite"] + u["Out"]
                     + u["LossScaling"] + u["OutGoodSteps"]
                     + u["OutBadSteps"]]
    for r, p in zip(outs["ref"], outs["port"]):
        np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_kernel_tier_after_decorate(model):
    """``fuse_attention`` and ``fuse_optimizer`` after ``decorate``'s
    rewrite: the folded casts (``__amp_cast__``) keep the score chain
    from matching in either package, so no attention is fused; the Adam
    updates fuse into one ``fused_adam`` in both.  The streams after the
    passes are equal."""
    streams = {}
    for pkg in PKG:
        fluid = PKG[pkg][0]
        main, _, loss, _, _ = _build(pkg, model)
        bs = fluid.BuildStrategy()
        bs.fuse_attention = bs.fuse_optimizer = True
        fluid.CompiledProgram(main, bs)._apply_ir_passes([loss.name])
        streams[pkg] = [op.type for op in main.global_block().ops]
    assert streams["port"] == streams["ref"]
    assert streams["port"].count("fused_multihead_attention") == 0
    assert streams["port"].count("fused_adam") == 1
    assert "adam" not in streams["port"]
