"""Control flow and the in-graph learning-rate schedules of
paddle_tpu_torch against paddle_tpu.

Each case builds one program in each package through the same layer
calls (``cond``, ``while_loop``, ``While``, ``Switch``, ``case``,
``switch_case``, ``IfElse``, the tensor arrays, ``StaticRNN``, the eight
schedules), runs the reference's startup, carries every persistable into
the port by name (``interop.scope_from_numpy``) and runs both, the port
on ``CPUPlace()``, from the same numpy feeds.  Values are compared
within rtol 1e-6 (float32; the schedules within 1e-7 relative, the
tolerance the schedule's closed form is held to on the card), ids and
counts exactly.

Where the reference has no builder for an op its executor runs (the
``recurrent`` op of ``StaticRNN``, whose reference builder raises), its
program is built by hand around that op.  Where the reference's tensor
array reads give a leading axis of 1 (a ``gather`` over the stacked
list), the comparison drops it.
"""
import numpy as np
import pytest

import jax

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.core import Scope as JScope, scope_guard as jguard
from paddle_tpu.fluid.framework import reset_unique_name as j_reset
from paddle_tpu.models import static_graphs as jsg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.fluid import framework as tfw
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset
from paddle_tpu_torch.models import static_graphs as tsg

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-6


def _persistables(main, scope):
    return {n: np.asarray(scope.find_var(n))
            for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def run_both(build, feed=None, runs=1, strategy=None):
    """``build(fluid)`` appends to fresh main and startup programs and
    returns the vars to fetch.  Returns ``(ref, port, programs)``: the
    fetched numpy values of each run in each package, and the two main
    programs.  ``strategy(fluid)`` gives a BuildStrategy to run both
    through ``CompiledProgram``."""
    feed = feed or {}
    out, progs = {}, {}
    j_reset()
    jm, js = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(jm, js):
        jf = build(jfluid)
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(js)
        init = _persistables(jm, jscope)
        jprog = jfluid.CompiledProgram(jm, strategy(jfluid)) \
            if strategy else jm
        out["ref"] = [[np.asarray(x) for x in
                       jexe.run(jprog, feed=feed, fetch_list=jf)]
                      for _ in range(runs)]
    t_reset()
    tm, ts = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(tm, ts):
        tf = build(tfluid)
    place = tfluid.CPUPlace()
    tscope, texe = tfluid.Scope(), tfluid.Executor(place)
    texe.run(ts, scope=tscope)
    interop.scope_from_numpy(init, tscope, place)
    tprog = tfluid.CompiledProgram(tm, strategy(tfluid)) if strategy else tm
    out["port"] = [texe.run(tprog, feed=feed, fetch_list=tf, scope=tscope)
                   for _ in range(runs)]
    progs["ref"], progs["port"] = jm, tm
    return out["ref"], out["port"], progs


def _close(ref, port, rtol=RTOL, squeeze=False):
    for rr, pr in zip(ref, port):
        for a, b in zip(rr, pr):
            a, b = np.asarray(a), np.asarray(b)
            if squeeze:
                a, b = a.reshape(b.shape) if a.size == b.size else a, b
            assert a.shape == b.shape, (a.shape, b.shape)
            if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(b, a, rtol=rtol, atol=0)


def _x(seed=0, shape=(4, 8)):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


# --- cond, while, Switch, case, IfElse -----------------------------------------
def _cond_prog(fluid):
    L = fluid.layers
    x = fluid.data("x", [4, 8])
    s = L.reduce_sum(x)
    zero = L.fill_constant([1], "float32", 0.0)
    pred = L.less_than(L.reshape(s, [1]), zero)
    a, b = L.cond(pred, lambda: (L.scale(x, scale=2.0), L.exp(x)),
                  lambda: (L.scale(x, scale=-3.0), L.tanh(x)))
    return [a, b, pred]


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["false", "true"])
def test_cond_both_branches(sign):
    feed = {"x": _x() * 0 + sign * np.abs(_x())}
    ref, port, _ = run_both(_cond_prog, feed)
    _close(ref, port)


TRIPS = 20


def _loop_body(L, n_w):
    """One trip: x <- x @ w / |x @ w|, and a cond inside that adds 1 to
    a counter on odd trips only."""
    def body(i, x, odd):
        y = L.matmul(x, n_w)
        y = y / L.reshape(L.sqrt(L.reduce_sum(L.square(y))), [1])
        two = L.fill_constant([1], "int64", 2)
        is_odd = L.equal(L.elementwise_mod(i, two),
                         L.fill_constant([1], "int64", 1))
        odd2 = L.cond(is_odd, lambda: odd + 1.0, lambda: L.scale(odd))
        return [L.increment(i, 1, in_place=False), y, odd2]
    return body


def _while_nested_cond(fluid, unrolled=False):
    """TRIPS trips of ``_loop_body`` through ``while_loop``, or unrolled
    into TRIPS copies of the body (each with its cond)."""
    L = fluid.layers
    x = fluid.data("x", [4, 8])
    w = L.create_parameter([8, 8], "float32", name="w_loop")
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", TRIPS)
    odd = L.fill_constant([1], "float32", 0.0)
    body = _loop_body(L, w)
    if unrolled:
        loop_vars = [i, x, odd]
        for _ in range(TRIPS):
            loop_vars = body(*loop_vars)
        return loop_vars
    return L.while_loop(lambda i, x, odd: L.less_than(i, n), body,
                        [i, x, odd])


def test_while_loop_with_nested_cond():
    """The port's while_loop against the reference's ops unrolled: the
    reference's own ``while`` cannot carry the body's new vars (see the
    next test)."""
    ref, port, _ = run_both(
        lambda f: _while_nested_cond(f, unrolled=f is jfluid),
        {"x": _x()})
    _close(ref, port, rtol=1e-5)
    assert int(port[0][0][0]) == TRIPS and float(port[0][2][0]) == 10.0


def test_reference_while_cannot_carry_a_new_var():
    """The reference's fault, pinned: its ``while`` starts the carry of
    every var the body makes at a float32 zero of shape (), so
    ``lax.while_loop`` refuses any body that makes a var (ROADMAP queue
    C).  The port runs the same program."""
    j_reset()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        out = _while_nested_cond(jfluid)
    exe = jfluid.Executor()
    with jguard(JScope()):
        exe.run(startup)
        with pytest.raises(TypeError, match="carry"):
            exe.run(main, feed={"x": _x()}, fetch_list=out)


def _while_block(fluid):
    """``While`` with a body of in-place ops only (the reference's
    ``while`` carries no new var)."""
    L = fluid.layers
    i = L.fill_constant([1], "float32", 0.0)
    n = L.fill_constant([1], "float32", 7.0)
    c = L.less_than(i, n)
    w = fluid.layers.control_flow.While(c)
    with w.block():
        L.increment(i, 1.0)
        L.less_than(i, n, cond=c)
    return [i, c]


def test_while_block():
    ref, port, _ = run_both(_while_block)
    _close(ref, port)
    assert float(port[0][0][0]) == 7.0


def _switch(fluid, default=True):
    """Switch over the fed step: three arms writing one var; without a
    default, the var keeps its earlier value when no case fires (the
    pass-through ``conditional_block``)."""
    L = fluid.layers
    step = fluid.data("step", [1])
    out = L.create_global_var([1], -1.0, "float32", persistable=True,
                              name="switch_out")
    with L.Switch() as sw:
        with sw.case(L.less_than(step, L.fill_constant([1], "float32",
                                                       3.0))):
            L.assign(step * 2.0, out)
        with sw.case(L.less_than(step, L.fill_constant([1], "float32",
                                                       6.0))):
            L.assign(step + 100.0, out)
        if default:
            with sw.default():
                L.assign(L.fill_constant([1], "float32", 7.5), out)
    return [out]


@pytest.mark.parametrize("step", [1.0, 4.0, 9.0])
@pytest.mark.parametrize("default", [True, False],
                         ids=["default", "pass-through"])
def test_switch(step, default):
    ref, port, progs = run_both(lambda f: _switch(f, default),
                                {"step": np.array([step], "float32")})
    _close(ref, port)
    want = {1.0: 2.0, 4.0: 104.0, 9.0: 7.5 if default else -1.0}[step]
    assert float(port[0][0][0]) == want
    for p in progs.values():
        assert [op.type for op in p.global_block().ops].count(
            "conditional_block") == (3 if default else 2)


def _case_prog(fluid, which):
    L = fluid.layers
    x = fluid.data("x", [4, 8])
    idx = fluid.data("idx", [1], dtype="int64")
    if which == "case":
        one = L.fill_constant([1], "int64", 1)
        two = L.fill_constant([1], "int64", 2)
        out = L.case([(L.less_than(idx, one), lambda: L.scale(x, scale=3.0)),
                      (L.less_than(idx, two), lambda: L.exp(x))],
                     default=lambda: L.tanh(x))
    else:
        out = L.switch_case(idx, {0: lambda: L.scale(x, scale=3.0),
                                  2: lambda: L.exp(x)},
                            default=lambda: L.tanh(x))
    return [out]


@pytest.mark.parametrize("idx", [0, 1, 2, 5])
@pytest.mark.parametrize("which", ["case", "switch_case"])
def test_case_and_switch_case(which, idx):
    feed = {"x": _x(), "idx": np.array([idx], "int64")}
    ref, port, _ = run_both(lambda f: _case_prog(f, which), feed)
    _close(ref, port)


def _ifelse(fluid):
    L = fluid.layers
    x = fluid.data("x", [4, 8])
    c = L.less_than(x, L.fill_constant([4, 8], "float32", 0.0))
    ie = L.IfElse(c)
    with ie.true_block():
        ie.output(L.scale(x, scale=-2.0))
    with ie.false_block():
        ie.output(L.sqrt(x))
    return ie()


def test_ifelse():
    ref, port, _ = run_both(_ifelse, {"x": _x()})
    _close(ref, port)


# --- tensor arrays, Print, Assert ----------------------------------------------
def _arrays(fluid):
    L = fluid.layers
    x = fluid.data("x", [4, 8])
    arr = L.create_array("float32")
    for k in range(3):
        L.array_write(L.scale(x, scale=float(k + 1)), k, array=arr)
    n = L.array_length(arr)
    return [L.array_read(arr, 2), L.array_read(arr, 0), n]


def test_arrays_written_in_a_loop():
    ref, port, _ = run_both(_arrays, {"x": _x()})
    _close(ref, port, squeeze=True)
    assert int(port[0][2][0]) == 3


def test_array_read_out_of_range_raises():
    t_reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [2, 2])
        arr = tfluid.layers.array_write(x, 0)
        y = tfluid.layers.array_read(arr, 3)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(IndexError, match="out of range"):
        exe.run(main, feed={"x": _x(shape=(2, 2))}, fetch_list=[y],
                scope=tfluid.Scope())


def _print_assert(fluid, ok):
    L = fluid.layers
    x = fluid.data("x", [4, 8])
    y = L.Print(L.scale(x, scale=2.0), message="x2", summarize=3)
    L.Assert(L.fill_constant([1], "bool", ok))
    return [y]


def test_print_is_the_identity(capsys):
    ref, port, _ = run_both(lambda f: _print_assert(f, True), {"x": _x()})
    _close(ref, port)
    assert "x2" in capsys.readouterr().out


def test_assert_op_raises_on_false():
    from paddle_tpu_torch.ops.registry import get_op, LoweringContext
    import torch
    fn = get_op("assert").fn
    fn({"Cond": [torch.tensor([True])]}, {}, LoweringContext())
    with pytest.raises(AssertionError):
        fn({"Cond": [torch.tensor([False])]}, {}, LoweringContext())


def test_dynamic_rnn_raises_as_the_reference():
    for fluid in (jfluid, tfluid):
        with pytest.raises(NotImplementedError):
            fluid.layers.DynamicRNN()


# --- StaticRNN over the recurrent op ---------------------------------------------
B, T, D, H = 4, 35, 3, 6


def _step(L, xt, hp):
    return L.tanh(L.elementwise_add(L.fc(xt, H, bias_attr=False),
                                    L.fc(hp, H)))


def _rnn_port(fluid):
    L = fluid.layers
    x = fluid.data("x", [B, T, D])
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        hp = rnn.memory(shape=[-1, H], batch_ref=x)
        h = _step(L, xt, hp)
        rnn.update_memory(hp, h)
        rnn.step_output(h)
    return [rnn()]


def _rnn_ref(fluid):
    """The same step block, built by hand around the reference's
    ``recurrent`` op (its StaticRNN builder raises)."""
    L = fluid.layers
    x = fluid.data("x", [B, T, D])
    h0 = L.fill_constant([B, H], "float32", 0.0)
    prog = fluid.default_main_program()
    parent = prog.current_block_idx
    blk = prog._create_block(parent)
    xt = blk.create_var(name="rnn_x", shape=[B, D], dtype="float32")
    hp = blk.create_var(name="rnn_h", shape=[B, H], dtype="float32")
    h = _step(L, xt, hp)
    prog.current_block_idx = parent
    params = [p.name for p in prog.all_parameters()]
    out = prog.global_block().create_var(name="rnn_out", dtype="float32")
    prog.global_block().append_op(
        "recurrent",
        inputs={"Inputs": [x], "InitStates": [h0], "Parameters": params},
        outputs={"Out": [out]},
        attrs={"sub_block": blk.idx, "inputs": ["rnn_x"],
               "ex_states": ["rnn_h"], "states": [h.name],
               "parameters": params, "outputs": [h.name]})
    return [out]


def test_static_rnn_over_the_recurrent_op():
    feed = {"x": _x(1, (B, T, D))}
    ref, port, progs = run_both(
        lambda f: (_rnn_ref if f is jfluid else _rnn_port)(f), feed)
    # 35 steps of float32 rounding, summed in two libraries' orders
    _close(ref, port, rtol=1e-4)
    assert port[0][0].shape == (B, T, H)
    rec = [op for op in progs["port"].global_block().ops
           if op.type == "recurrent"]
    assert len(rec) == 1 and sorted(rec[0].attrs["parameters"]) == \
        ["fc.b_0", "fc.w_0", "fc.w_1"]


# --- the pruner reads sub-blocks -------------------------------------------------
def test_pruner_keeps_what_sub_blocks_read():
    """A var only a cond branch reads survives pruning to the cond's
    output, in both packages; the executor reads it into the env."""
    def build(fluid):
        L = fluid.layers
        x = fluid.data("x", [4, 8])
        hidden = L.exp(x)                      # read only inside a branch
        pred = L.fill_constant([1], "bool", True)
        return [L.cond(pred, lambda: L.scale(hidden, scale=2.0),
                       lambda: L.scale(x, scale=0.0))]

    ref, port, progs = run_both(build, {"x": _x()})
    _close(ref, port)
    kept = {}
    for pkg, mod in (("ref", jfluid.framework), ("port", tfw)):
        p = progs[pkg]
        b = p.global_block()
        out = [op for op in b.ops if op.type == "conditional_block"][0]
        kept[pkg] = [op.type for op in mod.prune_ops(
            b, b.ops, targets=out.output("Out"))]
    assert kept["port"] == kept["ref"] and "exp" in kept["port"]


def test_switch_costs_no_host_sync():
    """A Switch's conditional_blocks select on the device: no host read;
    a while reads its predicate once a trip and once at the end."""
    reads = ttrace.metrics().counter("control_flow.host_reads")
    before = reads.value
    run_both(lambda f: _switch(f, True), {"step": np.array([4.0], "f4")})
    assert reads.value == before
    run_both(_while_block)
    assert reads.value == before + 8


# --- the eight schedules ------------------------------------------------------------
SCHEDULES = {
    "exponential_decay": lambda L: L.exponential_decay(0.1, 7, 0.5, True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 5, 0.3),
    "inverse_time_decay": lambda L: L.inverse_time_decay(0.1, 4, 0.5, True),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 20, 0.001, 2.0,
                                                     cycle=True),
    "piecewise_decay": lambda L: L.piecewise_decay([5, 12, 20],
                                                   [0.1, 0.05, 0.01, 0.001]),
    "noam_decay": lambda L: L.noam_decay(512, 8),
    "cosine_decay": lambda L: L.cosine_decay(0.1, 3, 10),
    "linear_lr_warmup": lambda L: L.linear_lr_warmup(0.1, 6, 0.0, 0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_run_for_run(name):
    """30 runs of each schedule: the learning rate of every run within
    1e-7 relative of the reference's.  The two built on a transcendental
    (natural_exp_decay, cosine_decay) may also differ by 2e-7 of their
    base rate of 0.1: XLA's and torch's ``exp`` and ``cos`` round
    differently by an ulp, which ``cos(.) + 1`` keeps in absolute terms
    as the rate falls toward 0."""
    ref, port, progs = run_both(lambda f: [SCHEDULES[name](f.layers)],
                                runs=30)
    atol = 2e-7 * 0.1 if name in ("natural_exp_decay",
                                  "cosine_decay") else 0.0
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p[0], r[0], rtol=1e-7, atol=atol)
    lrs = [float(r[0].reshape(-1)[0]) for r in port]
    assert len(set(lrs)) > 1, lrs
    for p in progs.values():
        assert [op.type for op in p.global_block().ops].count(
            "increment") == 1


def test_two_composed_schedules_advance_the_step_twice():
    """The reference's fault, held as it is: each schedule calls
    ``autoincreased_step_counter``, which appends an ``increment`` each
    time, so a composition of two advances the counter by 2 a run and
    the warmup reads 2e-5, 4e-5, ... (ROADMAP queue C)."""
    def build(fluid):
        L = fluid.layers
        return [L.linear_lr_warmup(L.polynomial_decay(1e-4, 100, 0.0), 10,
                                   0.0, 1e-4)]

    ref, port, progs = run_both(build, runs=4)
    _close(ref, port, rtol=1e-7)
    np.testing.assert_allclose([float(r[0].reshape(-1)[0]) for r in port],
                               [2e-5, 4e-5, 6e-5, 8e-5], rtol=1e-6)
    for p in progs.values():
        assert [op.type for op in p.global_block().ops].count(
            "increment") == 2


# --- the BERT recipe at a small width -------------------------------------------------
RECIPE = dict(vocab=64, hidden=32, heads=4, seq=16, layers=2, warmup=3,
              total=10, base_lr=1e-4)


def recipe_program(fluid, sg, vocab, hidden, heads, seq, layers, warmup,
                   total, base_lr, optimizer="adam"):
    """The BERT pretraining recipe of the Paddle 1.8 era in fluid's
    spelling: linear warmup then linear decay by a Switch over the step
    counter, L2 decay 0.01, global-norm clip 1.0, Adam (or LAMB), over
    the BERT body of ``models/static_graphs``.  Returns (loss, lr)."""
    L = fluid.layers
    ids = fluid.data("ids", [-1, seq], dtype="int64")
    labels = fluid.data("labels", [-1, 1], dtype="int64")
    am = L.reshape(fluid.data("attn_mask", [-1, seq]), [0, 1, 1, seq])
    mask = L.scale(am, scale=10000.0, bias=-10000.0, bias_after_scale=False)
    lr = L.create_global_var([1], 0.0, "float32", persistable=True,
                             name="scheduled_learning_rate")
    step = L.cast(L.autoincreased_step_counter(begin=1), "float32")
    with L.Switch() as sw:
        with sw.case(L.less_than(step, L.fill_constant([1], "float32",
                                                       warmup))):
            L.assign(step * (base_lr / warmup), lr)
        with sw.default():
            L.assign((1.0 - step / total) * base_lr, lr)
    h = L.embedding(ids, size=[vocab, hidden])
    for _ in range(layers):
        h = sg._naive_attention(h, hidden, heads, mask=mask)
        h = L.fc(h, hidden, num_flatten_dims=2, act="relu")
    logits = L.fc(L.reduce_mean(h, dim=[1]), 2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, labels))
    opt = fluid.optimizer.LambOptimizer if optimizer == "lamb" \
        else fluid.optimizer.AdamOptimizer
    opt(lr, regularization=fluid.regularizer.L2Decay(0.01),
        grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)).minimize(loss)
    return loss, lr


def recipe_lr(step, warmup, total, base_lr):
    """The schedule's closed form in float32, in the program's op
    order."""
    f = np.float32
    s = f(step)
    if s < f(warmup):
        return s * f(base_lr / warmup)
    return (f(1.0) - s / f(total)) * f(base_lr)


def _strategy(fluid):
    bs = fluid.BuildStrategy()
    bs.fuse_attention = bs.fuse_optimizer = True
    return bs


@pytest.mark.parametrize("optimizer", ["adam", "lamb"])
def test_bert_recipe(optimizer):
    """Hidden 32, 2 layers, dropout 0, 5 steps through the kernel tier:
    the learning rates equal the closed form and the reference's, the
    losses and the first step's gradients agree within rtol 1e-4, and
    fuse_optimizer leaves one fused update op."""
    feed = tsg.bert_demo_feed(np.random.RandomState(0), batch=8,
                              seq=RECIPE["seq"], vocab=RECIPE["vocab"])
    names = []

    def build(fluid):
        sg = jsg if fluid is jfluid else tsg
        loss, lr = recipe_program(fluid, sg, optimizer=optimizer, **RECIPE)
        grads = [p.name + "@GRAD" for p in
                 fluid.default_main_program().all_parameters()]
        names[:] = grads
        return [loss, lr]

    ref, port, progs = run_both(build, feed, runs=5, strategy=_strategy)
    for k, (r, p) in enumerate(zip(ref, port)):
        want = recipe_lr(k + 1, RECIPE["warmup"], RECIPE["total"],
                         RECIPE["base_lr"])
        assert abs(float(p[1][0]) - want) <= 1e-7 * want
        np.testing.assert_allclose(float(p[1][0]), float(r[1][0]),
                                   rtol=1e-7)
        np.testing.assert_allclose(float(p[0]), float(r[0]), rtol=1e-4)
    fused = "fused_lamb" if optimizer == "lamb" else "fused_adam"
    for p in progs.values():
        types = [op.type for op in p.global_block().ops]
        assert types.count(fused) == 1 and optimizer not in types
        assert types.count("conditional_block") == 2


def test_bert_recipe_first_step_gradients():
    """The first step's gradients of every parameter, the reference's
    against the port's, within 1e-4 of the largest gradient."""
    feed = tsg.bert_demo_feed(np.random.RandomState(0), batch=8,
                              seq=RECIPE["seq"], vocab=RECIPE["vocab"])

    def build(fluid):
        sg = jsg if fluid is jfluid else tsg
        loss, lr = recipe_program(fluid, sg, **RECIPE)
        main = fluid.default_main_program()
        return [loss] + [main.global_block().var(p.name + "@GRAD")
                         for p in main.all_parameters()]

    ref, port, _ = run_both(build, feed, runs=1)
    scale = max(float(np.abs(g).max()) for g in ref[0][1:])
    for a, b in zip(ref[0][1:], port[0][1:]):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * scale)
