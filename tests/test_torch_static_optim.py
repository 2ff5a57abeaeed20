"""The static training surface of paddle_tpu_torch against paddle_tpu:
the 20 ``fluid.optimizer`` classes, the regularizers, a Variable
learning rate, fp32 master weights, the fused updates with masters,
GradientMerge, ModelAverage, EMA, Lookahead, ``gradients()`` and the
``append_backward`` arguments, and the 2.0 ``Model``'s static mapping of
Momentum, AdamW, Adagrad and RMSProp.

Each optimizer trains the same 2-layer fc program in both packages for
3 steps from the reference's init (carried by name, with every
accumulator and master).  Compared: the losses within rtol 1e-5, and the
first step's parameter deltas within rtol 1e-4 and atol 1e-6 of the
largest delta (ground rule 9: not weights after several Adam steps).
DP-SGD runs at sigma 0, where its update is the reference's exactly;
its noise is held by contract (scale, the seed) since the packages draw
from different generators.  The fused updates with masters are held
bit for bit against the per-param ops on the host (the reference's own
contract, tests/test_kernel_tier.py:314-366).
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu.fluid as jfluid
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.dygraph import nn as jnn
from paddle_tpu.fluid.core import Scope as JScope, scope_guard as jguard
from paddle_tpu.fluid.framework import reset_unique_name as j_reset

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.dygraph import nn as tnn
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset

from test_torch_control_flow import run_both

jax.config.update("jax_platforms", "cpu")

HOST = tfluid.CPUPlace()


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(8, 6).astype("float32"),
            "y": rng.randn(8, 1).astype("float32")}


def _fc_loss(fluid, param_attr=None):
    L = fluid.layers
    x = fluid.data("x", [8, 6])
    y = fluid.data("y", [8, 1])
    h = L.fc(x, 10, act="tanh", param_attr=param_attr)
    out = L.fc(h, 1, param_attr=param_attr)
    return L.mean(L.square(out - y))


def _params(fluid):
    return [p for p in fluid.default_main_program().all_parameters()]


def _opt(fluid, name):
    """The optimizer of ``name`` in ``fluid``'s package, or None for the
    wrappers that ``_build`` assembles."""
    O = fluid.optimizer
    return {
        "SGD": lambda: O.SGDOptimizer(0.1),
        "Momentum": lambda: O.MomentumOptimizer(0.1, 0.9, use_nesterov=True),
        "LarsMomentum": lambda: O.LarsMomentumOptimizer(0.1, 0.9),
        "Adam": lambda: O.AdamOptimizer(0.01, lazy_mode=True),
        "AdamW": lambda: O.AdamWOptimizer(0.01, weight_decay=0.1),
        "Adagrad": lambda: O.AdagradOptimizer(0.1),
        "RMSProp": lambda: O.RMSPropOptimizer(0.01, momentum=0.5,
                                              centered=True),
        "Lamb": lambda: O.LambOptimizer(0.01),
        "Ftrl": lambda: O.FtrlOptimizer(0.1, l1=0.01, l2=0.01),
        "Dpsgd": lambda: O.DpsgdOptimizer(0.1, clip=1.0, sigma=0.0),
        "Adamax": lambda: O.AdamaxOptimizer(0.01),
        "Adadelta": lambda: O.AdadeltaOptimizer(1.0),
        "DecayedAdagrad": lambda: O.DecayedAdagradOptimizer(0.1),
        "DGCMomentum": lambda: O.DGCMomentumOptimizer(
            0.1, 0.9, rampup_begin_step=1, sparsity=[0.5]),
    }[name]()


WRAPPERS = ("ExponentialMovingAverage", "ModelAverage",
            "RecomputeOptimizer", "GradientMergeOptimizer",
            "LookaheadOptimizer", "PipelineOptimizer")
PLAIN = ("SGD", "Momentum", "LarsMomentum", "Adam", "AdamW", "Adagrad",
         "RMSProp", "Lamb", "Ftrl", "Dpsgd", "Adamax", "Adadelta",
         "DecayedAdagrad", "DGCMomentum")


def _build(name):
    def build(fluid):
        loss = _fc_loss(fluid)
        O = fluid.optimizer
        if name in PLAIN:
            _opt(fluid, name).minimize(loss)
        elif name == "RecomputeOptimizer":
            r = O.RecomputeOptimizer(O.AdamOptimizer(0.01))
            r._set_checkpoints([loss])
            r.minimize(loss)
        elif name == "GradientMergeOptimizer":
            O.GradientMergeOptimizer(O.AdamOptimizer(0.01),
                                     k_steps=2).minimize(loss)
        elif name == "LookaheadOptimizer":
            O.LookaheadOptimizer(O.SGDOptimizer(0.1), alpha=0.5,
                                 k=2).minimize(loss)
        elif name == "PipelineOptimizer":
            O.PipelineOptimizer(O.MomentumOptimizer(0.1, 0.9),
                                num_microbatches=2).minimize(loss)
        elif name == "ModelAverage":
            O.SGDOptimizer(0.1).minimize(loss)
            O.ModelAverage(0.5, min_average_window=2, max_average_window=3)
        else:                                   # the EMA runs on the host
            O.SGDOptimizer(0.1).minimize(loss)
        return [loss] + _params(fluid)
    return build


def _check(ref, port):
    np.testing.assert_allclose([float(r[0]) for r in port],
                               [float(r[0]) for r in ref], rtol=1e-5)


@pytest.mark.parametrize("name", PLAIN + WRAPPERS)
def test_optimizer_class(name):
    """Losses over 3 steps; the wrappers' program hints."""
    ref, port, progs = run_both(_build(name), _feed(), runs=3)
    _check(ref, port)
    hints = progs["port"]._hints
    if name == "RecomputeOptimizer":
        assert hints["recompute_checkpoints"] == \
            progs["ref"]._hints["recompute_checkpoints"] != []
    if name == "PipelineOptimizer":
        assert hints["pipeline_microbatches"] == 2


def _first_step_deltas(name):
    """(ref deltas, port deltas) of the first step, each parameter's new
    value less the init both packages start from."""
    feed = _feed()
    j_reset()
    jm, js = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(jm, js):
        jf = _build(name)(jfluid)
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(js)
        init = {n: np.asarray(jscope.find_var(n))
                for n, v in jm.global_block().vars.items()
                if v.persistable and jscope.find_var(n) is not None}
        ref = [np.asarray(v) for v in
               jexe.run(jm, feed=feed, fetch_list=jf)[1:]]
    t_reset()
    tm, ts = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(tm, ts):
        tf = _build(name)(tfluid)
    tscope, texe = tfluid.Scope(), tfluid.Executor(HOST)
    texe.run(ts, scope=tscope)
    interop.scope_from_numpy(init, tscope, HOST)
    port = texe.run(tm, feed=feed, fetch_list=tf, scope=tscope)[1:]
    names = [p.name for p in jm.all_parameters()]
    return ([r - init[n] for r, n in zip(ref, names)],
            [p - init[n] for p, n in zip(port, names)])


@pytest.mark.parametrize("name", PLAIN + WRAPPERS)
def test_first_step_deltas(name):
    """GradientMerge (k = 2) moves nothing on its first run."""
    ref, port = _first_step_deltas(name)
    scale = max(float(np.abs(d).max()) for d in ref)
    assert (scale == 0) == (name == "GradientMergeOptimizer")
    for a, b in zip(ref, port):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6 * scale)


def test_dpsgd_noise_contract():
    """sigma > 0: the update less the noise-free one is normal noise of
    scale lr * sigma * clip, drawn again the same for the same seed and
    otherwise for another step."""
    def run(sigma, steps=1):
        t_reset()
        m, s = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(m, s):
            loss = _fc_loss(tfluid)
            tfluid.optimizer.DpsgdOptimizer(0.1, clip=1.0,
                                            sigma=sigma).minimize(loss)
        m.random_seed = 5
        scope, exe = tfluid.Scope(), tfluid.Executor(HOST)
        exe.run(s, scope=scope)
        torch.manual_seed(0)
        params = [p.name for p in m.all_parameters()]
        for n in params:
            scope.set_var(n, torch.full_like(scope.find_var(n), 0.1))
        for _ in range(steps):
            out = exe.run(m, feed=_feed(), fetch_list=params, scope=scope)
        return out

    plain, noisy, again = run(0.0), run(2.0), run(2.0)
    noise = np.concatenate([(b - a).ravel() for a, b in zip(plain, noisy)])
    assert abs(noise.std() / (0.1 * 2.0 * 1.0) - 1) < 0.1
    assert abs(noise.mean()) < 0.03
    for a, b in zip(noisy, again):
        np.testing.assert_array_equal(a, b)
    two = run(2.0, steps=2)
    assert not np.allclose(two[0], noisy[0])


# --- regularization --------------------------------------------------------------
@pytest.mark.parametrize("kind", ["L1Decay", "L2Decay"])
@pytest.mark.parametrize("where", ["optimizer", "param_attr"])
def test_regularization_static(kind, where):
    def build(fluid):
        reg = getattr(fluid.regularizer, kind)(0.05)
        attr = fluid.ParamAttr(regularizer=reg) if where == "param_attr" \
            else None
        loss = _fc_loss(fluid, param_attr=attr)
        kw = {"regularization": reg} if where == "optimizer" else {}
        fluid.optimizer.MomentumOptimizer(0.1, 0.9, **kw).minimize(loss)
        return [loss] + _params(fluid)

    ref, port, progs = run_both(build, _feed(), runs=3)
    _check(ref, port)
    for p in progs.values():
        types = [op.type for op in p.global_block().ops]
        assert types.count("sign") == (
            (4 if where == "optimizer" else 2) if kind == "L1Decay" else 0)


def _dygraph_step(pkg, kind, where, init):
    dy, nn, fluid = (jdy, jnn, jfluid) if pkg == "ref" \
        else (tdy, tnn, tfluid)
    if pkg == "ref":
        dy.enable_dygraph()
    else:
        dy.enable_dygraph(HOST)
    try:
        reg = getattr(fluid.regularizer, kind)(0.05)
        attr = fluid.ParamAttr(regularizer=reg) if where == "param_attr" \
            else None
        layer = nn.Linear(6, 1, param_attr=attr)
        for p, v in zip(layer.parameters(), init):
            p.set_value(v)
        x = dy.to_variable(_feed()["x"])
        loss = fluid.layers.mean(layer(x))
        kw = {"regularization": reg} if where == "optimizer" else {}
        opt = fluid.optimizer.SGDOptimizer(
            0.1, parameter_list=layer.parameters(), **kw)
        opt.minimize(loss)
        return [np.asarray(p.numpy()) for p in layer.parameters()]
    finally:
        dy.disable_dygraph()


@pytest.mark.parametrize("kind", ["L1Decay", "L2Decay"])
@pytest.mark.parametrize("where", ["optimizer", "param_attr"])
def test_regularization_dygraph(kind, where):
    rng = np.random.RandomState(3)
    init = [rng.randn(6, 1).astype("float32"),
            rng.randn(1).astype("float32")]
    want = _dygraph_step("ref", kind, where, init)
    got = _dygraph_step("port", kind, where, init)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_variable_and_callable_learning_rate():
    """A Variable learning rate (an in-graph decay) and a callable that
    builds one drive the update; ``current_lr`` is that var and
    ``set_lr`` replaces the rate of the next program."""
    def build(fluid, callable_lr):
        loss = _fc_loss(fluid)
        L = fluid.layers
        make = lambda: L.exponential_decay(0.1, 2, 0.5)   # noqa: E731
        opt = fluid.optimizer.SGDOptimizer(make if callable_lr
                                           else make())
        opt.minimize(loss)
        assert opt.current_lr is not None
        return [loss, opt.current_lr]

    for callable_lr in (False, True):
        ref, port, _ = run_both(lambda f: build(f, callable_lr), _feed(),
                                runs=3)
        _check(ref, port)
        np.testing.assert_allclose([float(r[1][0]) for r in port],
                                   [float(r[1][0]) for r in ref], rtol=1e-7)
    opt = tfluid.optimizer.SGDOptimizer(0.1)
    opt.set_lr(0.5)
    assert opt._learning_rate == 0.5


def test_state_var_names_and_state_dict():
    def build(fluid):
        loss = _fc_loss(fluid)
        opt = fluid.optimizer.AdamOptimizer(0.01)
        opt.minimize(loss)
        build.opt[fluid] = opt
        return [loss]
    build.opt = {}
    run_both(build, _feed())
    j, t = build.opt[jfluid], build.opt[tfluid]
    assert t.state_var_names() == j.state_var_names()
    assert len(t.state_var_names()) == 4 * 4 + 1


# --- multi_precision ---------------------------------------------------------------
def _mp_program(fluid, opt_cls, names=("W_lo",), **kw):
    """The reference's multi-precision program (tests/test_amp_plane.py
    and test_kernel_tier.py): bfloat16 parameters of ones, made by
    ``create_parameter(dtype="bfloat16")``, under ``opt_cls(1e-3,
    multi_precision=True)``."""
    L = fluid.layers
    x = fluid.data("x", [-1, 4])
    main = fluid.default_main_program()
    gb = main.global_block()
    sb = fluid.default_startup_program().global_block()
    h = x
    for nm in names:
        gb.create_parameter(nm, [4, 4], dtype="bfloat16")
        sb.create_var(name=nm, shape=[4, 4], dtype="bfloat16",
                      persistable=True)
        sb.append_op("fill_constant", outputs={"Out": [nm]},
                     attrs={"shape": [4, 4], "dtype": "bfloat16",
                            "value": 1.0})
        h = L.matmul(h, gb.vars[nm])
    loss = L.mean(h)
    opt_cls(1e-3, multi_precision=True, **kw).minimize(loss)
    return loss


MP = {"sgd": "SGDOptimizer", "momentum": "MomentumOptimizer",
      "adam": "AdamOptimizer", "adamw": "AdamWOptimizer",
      "lamb": "LambOptimizer"}


@pytest.mark.parametrize("opt_name", sorted(MP))
def test_multi_precision_matches_reference(opt_name):
    """50 steps on the fp32 master: the master and the bf16 parameter
    equal the reference's (the master within rtol 1e-6, the parameter,
    its rounding, exactly)."""
    def build(fluid):
        loss = _mp_program(fluid, getattr(fluid.optimizer, MP[opt_name]))
        main = fluid.default_main_program()
        masters = [n for n in main.global_block().vars
                   if "master_weight" in n]
        assert masters == [f"{MP[opt_name]}_master_weight_W_lo"]
        return [loss, main.global_block().vars[masters[0]],
                main.global_block().vars["W_lo"]]

    feed = {"x": np.ones((2, 4), "float32")}
    ref, port, _ = run_both(build, feed, runs=50)
    m_ref, w_ref = ref[-1][1], np.asarray(ref[-1][2], np.float32)
    m, w = port[-1][1], port[-1][2]
    assert m.dtype == np.float32 and np.all(m < 1.0)
    np.testing.assert_allclose(m, m_ref, rtol=1e-6)
    np.testing.assert_allclose(w, m, atol=0.004)
    np.testing.assert_array_equal(w, w_ref)


def test_multi_precision_refused_where_unsupported():
    for fluid in (jfluid, tfluid):
        with pytest.raises(NotImplementedError):
            fluid.optimizer.AdagradOptimizer(0.1, multi_precision=True)


@pytest.mark.parametrize("opt_name", ["adam", "momentum"])
def test_fused_masters_bit_identical(opt_name):
    """A bucket of bf16 params with fp32 masters: fuse_optimizer makes
    one fused op carrying the masters, and 20 steps leave every master,
    moment or velocity and bf16 parameter bit-identical to the per-param
    ops' (on the host: the kernel's plain version)."""
    cls = "AdamOptimizer" if opt_name == "adam" else "MomentumOptimizer"

    def run(fuse):
        t_reset()
        m, s = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(m, s):
            loss = _mp_program(tfluid, getattr(tfluid.optimizer, cls),
                               names=("Wa_lo", "Wb_lo", "Wc_lo"))
        scope, exe = tfluid.Scope(), tfluid.Executor(HOST)
        exe.run(s, scope=scope)
        prog = m
        if fuse:
            bs = tfluid.BuildStrategy()
            bs.fuse_optimizer = True
            prog = tfluid.CompiledProgram(m, bs)
        for k in range(20):
            exe.run(prog, feed={"x": np.full((2, 4), 1.0 + k / 7, "f4")},
                    fetch_list=[loss], scope=scope)
        state = {n: scope.find_var(n).clone() for n, v in
                 m.global_block().vars.items() if v.persistable}
        return m, state

    m_off, off = run(False)
    m_on, on = run(True)
    fused = [o for o in m_on.global_block().ops
             if o.type == f"fused_{opt_name}"]
    assert len(fused) == 1 and len(fused[0].inputs["MasterParam"]) == 3
    assert sorted(fused[0].outputs) == sorted(
        ["ParamOut", "MasterParamOut"] + (
            ["Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"]
            if opt_name == "adam" else ["VelocityOut"]))
    assert sorted(off) == sorted(on)
    for n in off:
        assert off[n].dtype == on[n].dtype and torch.equal(off[n], on[n]), n
    assert on["Wa_lo"].dtype == torch.bfloat16


def test_fuse_optimizer_bucket_size_and_lamb():
    """``bucket_size`` splits a run of update ops, and a run of ``lamb``
    ops fuses into ``fused_lamb``, bit-identical to the per-param ops."""
    from paddle_tpu_torch.fluid.passes.kernel_tier import FuseOptimizerPass
    from paddle_tpu_torch.fluid.passes.core import PassContext

    def build(opt):
        t_reset()
        m, s = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(m, s):
            L = tfluid.layers
            x = tfluid.data("x", [8, 6])
            h = x
            for _ in range(5):
                h = L.fc(h, 6, act="tanh")
            loss = L.mean(h)
            opt().minimize(loss)
        return m, s, loss

    m, _, _ = build(lambda: tfluid.optimizer.AdamOptimizer(0.01))
    FuseOptimizerPass(bucket_size=4).apply(m, PassContext(m))
    sizes = [len(o.inputs["Param"]) for o in m.global_block().ops
             if o.type == "fused_adam"]
    assert sizes == [4, 4, 2]

    def run(fuse):
        m, s, loss = build(lambda: tfluid.optimizer.LambOptimizer(0.01))
        scope, exe = tfluid.Scope(), tfluid.Executor(HOST)
        exe.run(s, scope=scope)
        torch.manual_seed(0)
        for p in m.all_parameters():
            scope.set_var(p.name, torch.randn_like(scope.find_var(p.name)))
        prog = m
        if fuse:
            bs = tfluid.BuildStrategy()
            bs.fuse_optimizer = True
            prog = tfluid.CompiledProgram(m, bs)
        for _ in range(3):
            exe.run(prog, feed=_feed(), fetch_list=[loss], scope=scope)
        return m, {n: scope.find_var(n) for n, v in
                   m.global_block().vars.items() if v.persistable}

    _, off = run(False)
    m_on, on = run(True)
    assert [o.type for o in m_on.global_block().ops].count("fused_lamb") == 1
    for n in off:
        assert torch.equal(off[n], on[n]), n


# --- GradientMerge, ModelAverage, EMA, Lookahead -----------------------------------
def _global_scope_runs(build, after, runs, feed):
    """Both packages under their own global scope (EMA and ModelAverage
    read it): ``after(pkg, fluid, k)`` runs after each run; returns what
    it returns, run by run."""
    out = {}
    j_reset()
    jm, js = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(jm, js):
        jf, jx = build(jfluid)
    jscope, jexe = JScope(), jfluid.Executor()
    with jguard(jscope):
        jexe.run(js)
        init = {n: np.asarray(jscope.find_var(n))
                for n, v in jm.global_block().vars.items()
                if v.persistable and jscope.find_var(n) is not None}
        out["ref"] = []
        for k in range(runs):
            jexe.run(jm, feed=feed, fetch_list=jf)
            out["ref"].append(after(jfluid, jx, jscope, jm))
    t_reset()
    tm, ts = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(tm, ts):
        tf, tx = build(tfluid)
    tscope, texe = tfluid.Scope(), tfluid.Executor(HOST)
    with tfluid.scope_guard(tscope):
        texe.run(ts)
        interop.scope_from_numpy(init, tscope, HOST)
        out["port"] = []
        for k in range(runs):
            texe.run(tm, feed=feed, fetch_list=tf)
            out["port"].append(after(tfluid, tx, tscope, tm))
    return out["ref"], out["port"]


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def test_gradient_merge_k_step_gate():
    """k = 3: the parameters and Adam's moments and powers move only on
    every third run, by the averaged gradient."""
    def build(fluid):
        loss = _fc_loss(fluid)
        fluid.optimizer.GradientMergeOptimizer(
            fluid.optimizer.AdamOptimizer(0.01), k_steps=3).minimize(loss)
        return [loss], None

    def after(fluid, _, scope, main):
        return {n: _np(scope.find_var(n)) for n, v in
                main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}

    ref, port = _global_scope_runs(build, after, 6, _feed())
    names = [n for n in ref[0] if n.startswith("fc.")]
    for k in range(6):
        for n in ref[k]:
            np.testing.assert_allclose(port[k][n], ref[k][n], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{n} run {k}")
    moved = [not np.array_equal(port[k][names[0]], port[k - 1][names[0]])
             for k in range(1, 6)]
    assert moved == [False, True, False, False, True]


def test_model_average_apply_and_restore():
    def build(fluid):
        loss = _fc_loss(fluid)
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
        ma = fluid.optimizer.ModelAverage(0.5, min_average_window=2,
                                          max_average_window=3)
        return [loss], ma

    def after(fluid, ma, scope, main):
        names = [p.name for p in main.all_parameters()]
        before = [_np(scope.find_var(n)) for n in names]
        with ma.apply():
            applied = [_np(scope.find_var(n)) for n in names]
        restored = [_np(scope.find_var(n)) for n in names]
        return before, applied, restored

    ref, port = _global_scope_runs(build, after, 5, _feed())
    for r, p in zip(ref, port):
        for a, b in zip(r, p):
            for x, y in zip(a, b):
                np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-7)
        for x, y in zip(p[0], p[2]):
            np.testing.assert_array_equal(x, y)
    assert not np.allclose(port[-1][0][0], port[-1][1][0])


def test_exponential_moving_average():
    def build(fluid):
        loss = _fc_loss(fluid)
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
        return [loss], fluid.optimizer.ExponentialMovingAverage(0.8)

    def after(fluid, ema, scope, main):
        ema.update()
        names = [p.name for p in main.all_parameters()]
        cur = [_np(scope.find_var(n)) for n in names]
        with ema.apply():
            shadow = [_np(scope.find_var(n)) for n in names]
        back = [_np(scope.find_var(n)) for n in names]
        return cur, shadow, back

    ref, port = _global_scope_runs(build, after, 4, _feed())
    for r, p in zip(ref, port):
        for a, b in zip(r, p):
            for x, y in zip(a, b):
                np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-7)
        for x, y in zip(p[0], p[2]):
            np.testing.assert_array_equal(x, y)


def test_lookahead_syncs_every_k():
    def build(fluid):
        loss = _fc_loss(fluid)
        fluid.optimizer.LookaheadOptimizer(fluid.optimizer.SGDOptimizer(0.1),
                                           alpha=0.5, k=3).minimize(loss)
        return [loss], None

    def after(fluid, _, scope, main):
        return {n: _np(scope.find_var(n)) for n, v in
                main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}

    ref, port = _global_scope_runs(build, after, 6, _feed())
    for r, p in zip(ref, port):
        for n in r:
            np.testing.assert_allclose(p[n], r[n], rtol=1e-5, atol=1e-7,
                                       err_msg=n)


# --- backward ----------------------------------------------------------------------
def test_gradients_and_append_backward_arguments():
    """``gradients(loss, [x])`` gives d loss / d x (None for an input the
    loss does not read); ``append_backward`` takes ``callbacks`` and
    ``checkpoints`` and appends the same ops as without them."""
    def build(fluid):
        L = fluid.layers
        x = fluid.data("x", [8, 6])
        x.stop_gradient = False
        z = fluid.data("z", [8, 6])
        loss = L.mean(L.square(L.fc(x, 3)))
        gx, gz = fluid.gradients([loss], [x, z])
        assert gz is None
        return [gx]

    feed = dict(_feed(), z=np.zeros((8, 6), "float32"))
    ref, port, _ = run_both(build, feed)
    np.testing.assert_allclose(port[0][0], ref[0][0], rtol=1e-5, atol=1e-7)

    types = []
    for kw in ({}, {"callbacks": [lambda *a: None], "checkpoints": []}):
        t_reset()
        m, s = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(m, s):
            loss = _fc_loss(tfluid)
            tfluid.backward.append_backward(loss, **kw)
        types.append([o.type for o in m.global_block().ops])
    assert types[0] == types[1]


# --- hapi's static mapping ---------------------------------------------------------
def test_hapi_static_optimizer_mapping():
    """The 2.0 optimizers a static ``Model`` maps onto fluid's: the port
    honours Momentum's momentum (the reference reads ``_momentum``, which
    its eager Momentum lacks, and so always runs 0.9: ROADMAP queue C),
    and maps AdamW, Adagrad and RMSProp as the reference does."""
    import paddle_tpu.hapi.model as jhm
    import paddle_tpu.optimizer as jopt
    import paddle_tpu_torch.hapi.model as thm
    import paddle_tpu_torch.optimizer as topt
    for mu in (0.9, 0.5):
        j = jhm._static_optimizer(jopt.Momentum(0.1, momentum=mu))
        t = thm._static_optimizer(topt.Momentum(0.1, momentum=mu))
        assert t._momentum == mu and j._momentum == 0.9
    for name, attrs in (("AdamW", ("_coeff",)), ("Adagrad", ("_epsilon",)),
                        ("RMSProp", ("_rho", "_epsilon"))):
        j = jhm._static_optimizer(getattr(jopt, name)(0.1))
        t = thm._static_optimizer(getattr(topt, name)(0.1))
        assert type(t).__name__ == type(j).__name__ == name + "Optimizer"
        for a in attrs:
            assert getattr(t, a) == getattr(j, a), (name, a)
