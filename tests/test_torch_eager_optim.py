"""The 2.0 dygraph training loop's parts: paddle_tpu_torch against paddle_tpu.

- The 13 learning-rate schedulers (``optimizer/lr.py``) and the 1.x names
  (``dygraph/learning_rate_scheduler.py``): 40 steps' rates, equal
  exactly (both are the same Python arithmetic on host floats), and the
  1.x ``fluid.optimizer`` taking a 1.x decay in dygraph.
- The optimizer ops (``adamw``, ``adagrad``, ``rmsprop``, ``lamb``,
  ``adadelta``, ``adamax``, and ``MasterParam`` on ``sgd``, ``momentum``,
  ``adam``, ``adamw`` and ``lamb``) against the reference's lowerings,
  rtol 1e-5 (float32).
- The nine eager optimizers: the same gradients, drawn from a seed with
  numpy, fed into both packages' ``p._grad`` for 3 steps (never
  gradients each package computes: Adam's first steps move a weight by
  about ``sign(g)·lr``, so rounding noise in a gradient would move it by
  up to 2·lr).  Parameters after every step to rtol 1e-5; one parameter
  starts at zero (Lamb's trust ratio's zero case) and one gets a zero
  gradient; the gradients repeat values (Adamax's max ties).  Also the
  three clips, ``weight_decay``, ``multi_precision`` on bf16 parameters
  (masters to rtol 1e-5, the bf16 parameters to one bf16 unit), the
  refusals, ``set_lr`` on a scheduler, and the ``state_dict`` keys.
- ``auto_cast`` (bf16 and fp16: the dtype each op runs in, op by op) and
  ``GradScaler``: the bf16 identity, the fp16 skip-and-rescale sequence
  with injected infs, and the latch across the context's exit.
- ``save_dygraph`` / ``load_dygraph`` across packages both ways, and the
  ``Layer`` methods (``create_parameter``, ``sublayers``,
  ``named_sublayers``, ``set_dict``/``load_dict``, forward hooks).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.dygraph import checkpoint as jckpt
from paddle_tpu.dygraph import learning_rate_scheduler as jlrs
from paddle_tpu.dygraph import nn as jnn
from paddle_tpu.dygraph import layers as jlayers
from paddle_tpu.fluid import clip as jclip
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import optimizer as jfopt
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.dygraph import checkpoint as tckpt
from paddle_tpu_torch.dygraph import learning_rate_scheduler as tlrs
from paddle_tpu_torch.dygraph import nn as tnn
from paddle_tpu_torch.dygraph import layers as tlayers
from paddle_tpu_torch.fluid import clip as tclip
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import optimizer as tfopt
from paddle_tpu_torch.ops import registry as treg

STEPS = 40


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------
def _lam(e):
    return 0.95 ** e


SCHEDULERS = {
    "Noam": lambda m: m.NoamDecay(64, 10, learning_rate=2.0),
    "Exponential": lambda m: m.ExponentialDecay(0.5, 0.9),
    "NaturalExp": lambda m: m.NaturalExpDecay(0.5, 0.1),
    "InverseTime": lambda m: m.InverseTimeDecay(0.5, 0.2),
    "Polynomial": lambda m: m.PolynomialDecay(0.5, 15, end_lr=0.01,
                                              power=2.0),
    "Polynomial_cycle": lambda m: m.PolynomialDecay(0.5, 7, cycle=True),
    "Piecewise": lambda m: m.PiecewiseDecay([5, 12, 30],
                                            [1.0, 0.5, 0.1, 0.01]),
    "CosineAnnealing": lambda m: m.CosineAnnealingDecay(0.3, 17,
                                                        eta_min=0.01),
    "LinearWarmup_float": lambda m: m.LinearWarmup(0.4, 8, 0.0, 0.4),
    "LinearWarmup_sched": lambda m: m.LinearWarmup(
        m.StepDecay(0.4, 5, 0.5), 8, 0.01, 0.4),
    "Step": lambda m: m.StepDecay(0.4, 6, 0.3),
    "MultiStep": lambda m: m.MultiStepDecay(0.4, [3, 9, 27], 0.5),
    "ReduceOnPlateau_no_metric": lambda m: m.ReduceOnPlateau(0.1),
    "Lambda": lambda m: m.LambdaDecay(0.2, _lam),
    # the 1.x names
    "fluid_Noam": lambda m: m.NoamDecay(64, 10),
    "fluid_Piecewise": lambda m: m.PiecewiseDecay([4, 20], [0.1, 0.05,
                                                            0.01]),
    "fluid_NaturalExp": lambda m: m.NaturalExpDecay(0.5, 7, 0.3),
    "fluid_NaturalExp_staircase": lambda m: m.NaturalExpDecay(
        0.5, 7, 0.3, staircase=True),
    "fluid_Exponential_staircase": lambda m: m.ExponentialDecay(
        0.5, 6, 0.8, staircase=True),
    "fluid_InverseTime": lambda m: m.InverseTimeDecay(0.5, 5, 0.4),
    "fluid_Polynomial": lambda m: m.PolynomialDecay(0.5, 20,
                                                    end_learning_rate=0.02),
    "fluid_Cosine": lambda m: m.CosineDecay(0.3, 4, 12),
    "fluid_LinearLrWarmup": lambda m: m.LinearLrWarmup(0.2, 9, 0.0, 0.2),
    "fluid_Step": lambda m: m.StepDecay(0.3, 4, 0.7),
    "fluid_MultiStep": lambda m: m.MultiStepDecay(0.3, [5, 15], 0.2),
    "fluid_Lambda": lambda m: m.LambdaDecay(0.3, _lam),
}


def _rates(sched, metrics=None):
    out = []
    for i in range(STEPS):
        out.append(sched())
        if metrics is None:
            sched.step()
        else:
            sched.step(metrics[i])
    return out


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_scheduler_rates_equal_the_reference(case):
    fluid_form = case.startswith("fluid_")
    jm = jlrs if fluid_form else jopt.lr
    tm = tlrs if fluid_form else topt.lr
    want = _rates(SCHEDULERS[case](jm))
    got = _rates(SCHEDULERS[case](tm))
    assert got == want
    assert len(set(want)) > 1 or "ReduceOnPlateau" in case


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("fluid_form", [False, True])
def test_reduce_on_plateau_fed_a_metric(mode, fluid_form):
    rng = np.random.RandomState(3)
    # improves, then plateaus in stretches: the rate falls, cooldown holds
    metrics = np.concatenate([np.linspace(1.0, 0.5, 8),
                              0.5 + 1e-5 * rng.randn(32)])
    if mode == "max":
        metrics = -metrics

    def build(m):
        if fluid_form:
            return m.ReduceLROnPlateau(0.1, mode=mode, decay_rate=0.5,
                                       patience=3, cooldown=2, min_lr=1e-3)
        return m.ReduceOnPlateau(0.1, mode=mode, factor=0.5, patience=3,
                                 cooldown=2, min_lr=1e-3)

    want = _rates(build(jlrs if fluid_form else jopt.lr), metrics)
    got = _rates(build(tlrs if fluid_form else topt.lr), metrics)
    assert got == want
    assert min(got) < 0.1


def test_scheduler_state_dict_round_trip():
    s = topt.lr.StepDecay(0.4, 3)
    for _ in range(7):
        s.step()
    t = topt.lr.StepDecay(0.4, 3)
    t.set_state_dict(s.state_dict())
    assert t() == s() and t.last_epoch == s.last_epoch == 7


def _fluid_sgd_with_decay(dy, nn, fopt, lrs, x, state=None, place=None):
    """Three dygraph ``minimize`` steps of a Linear layer under
    ``SGDOptimizer(learning_rate=PiecewiseDecay)``, the decay stepped
    after each; the initial state and the final one."""
    with dy.guard(place) if place is not None else dy.guard():
        lin = nn.Linear(6, 3)
        if state is None:
            state = lin.state_dict()
        else:
            interop.layer_from_numpy(lin, state)
        sched = lrs.PiecewiseDecay([1, 2], [0.5, 0.1, 0.01])
        opt = fopt.SGDOptimizer(learning_rate=sched,
                                parameter_list=lin.parameters())
        for _ in range(3):
            out = lin(dy.to_variable(x))
            (out * out).backward(dy.to_variable(np.ones((4, 3), "float32")))
            opt.minimize(None)
            lin.clear_gradients()
            sched.step()
        return state, [np.asarray(v) for v in lin.state_dict().values()]


def test_fluid_optimizer_takes_a_fluid_decay_in_dygraph():
    """A 1.x decay as ``fluid.optimizer``'s ``learning_rate`` is read at
    every dygraph ``minimize``, as in the reference."""
    x = np.random.RandomState(0).randn(4, 6).astype("float32")
    state, want = _fluid_sgd_with_decay(jdy, jnn, jfopt, jlrs, x)
    _, got = _fluid_sgd_with_decay(tdy, tnn, tfopt, tlrs, x, state,
                                   tfluid.CPUPlace())
    for g, w, s in zip(got, want, state.values()):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        assert not np.allclose(g, np.asarray(s))


# ---------------------------------------------------------------------------
# the optimizer ops against the reference's lowerings
# ---------------------------------------------------------------------------
R = np.random.RandomState(7)


def _f(*shape):
    return R.randn(*shape).astype("float32")


def _pos(*shape):
    return (np.abs(R.randn(*shape)) + 0.1).astype("float32")


_LR = np.asarray([0.01], "float32")
_ADAM_INS = {"Param": [_f(3, 4)], "Grad": [_f(3, 4)],
             "Moment1": [_f(3, 4)], "Moment2": [_pos(3, 4)],
             "Beta1Pow": [np.asarray([0.81], "float32")],
             "Beta2Pow": [np.asarray([0.998], "float32")],
             "LearningRate": [_LR]}
_MASTER = {"MasterParam": [_ADAM_INS["Param"][0]]}
OPT_OP_CASES = {
    "sgd_master": ("sgd", {"Param": [_ADAM_INS["Param"][0]],
                           "Grad": [_f(3, 4)], "LearningRate": [_LR],
                           **_MASTER}, {}),
    "momentum_nesterov_master": ("momentum", {
        "Param": [_ADAM_INS["Param"][0]], "Grad": [_f(3, 4)],
        "Velocity": [_f(3, 4)], "LearningRate": [_LR], **_MASTER},
        {"mu": 0.8, "use_nesterov": True}),
    "adam_master": ("adam", dict(_ADAM_INS, **_MASTER), {"beta1": 0.9}),
    "adamw": ("adamw", _ADAM_INS, {"coeff": 0.05}),
    "adamw_no_decay": ("adamw", _ADAM_INS, {"coeff": 0.05,
                                            "with_decay": False}),
    "adamw_master": ("adamw", dict(_ADAM_INS, **_MASTER), {"coeff": 0.02}),
    "adagrad": ("adagrad", {"Param": [_f(5)], "Grad": [_f(5)],
                            "Moment": [_pos(5)], "LearningRate": [_LR]},
                {"epsilon": 1e-6}),
    "rmsprop": ("rmsprop", {"Param": [_f(2, 3)], "Grad": [_f(2, 3)],
                            "MeanSquare": [_pos(2, 3)],
                            "Moment": [_f(2, 3)], "LearningRate": [_LR]},
                {"decay": 0.9, "momentum": 0.5}),
    "rmsprop_centered": ("rmsprop", {
        "Param": [_f(2, 3)], "Grad": [_f(2, 3)],
        "MeanSquare": [_pos(2, 3) + 1.0], "Moment": [_f(2, 3)],
        "MeanGrad": [0.1 * _f(2, 3)], "LearningRate": [_LR]},
        {"decay": 0.9, "momentum": 0.5, "centered": True}),
    "lamb": ("lamb", _ADAM_INS, {"weight_decay": 0.01}),
    "lamb_zero_param": ("lamb", dict(_ADAM_INS, Param=[np.zeros((3, 4),
                                                                "float32")],
                                     Moment1=[np.zeros((3, 4), "float32")]),
                        {"weight_decay": 0.0}),
    "lamb_master": ("lamb", dict(_ADAM_INS, **_MASTER), {}),
    "adadelta": ("adadelta", {"Param": [_f(4)], "Grad": [_f(4)],
                              "AvgSquaredGrad": [_pos(4)],
                              "AvgSquaredUpdate": [_pos(4)]},
                 {"rho": 0.9, "epsilon": 1e-6}),
    "adamax": ("adamax", {"Param": [_f(6)],
                          "Grad": [np.asarray([1, -1, 2, 0, 1, -2],
                                              "float32")],
                          "Moment": [_f(6)],
                          "InfNorm": [np.asarray([1, 1, 0, 0, 3, 2],
                                                 "float32")],
                          "LearningRate": [_LR],
                          "Beta1Pow": [np.asarray([0.9], "float32")]},
               {"beta2": 1.0}),
}


@pytest.mark.parametrize("case", sorted(OPT_OP_CASES))
def test_optimizer_op_matches_reference(case):
    op_type, ins, attrs = OPT_OP_CASES[case]
    low = "master" in case      # Param and Grad in bf16 beside the master
    jins = {s: [jnp.asarray(a, jnp.bfloat16 if low and s in ("Param", "Grad")
                            else None) for a in v] for s, v in ins.items()}
    tins = {s: [torch.from_numpy(a.copy()).to(
        torch.bfloat16 if low and s in ("Param", "Grad") else torch.float32)
        for a in v] for s, v in ins.items()}
    j_out = jreg.get_op(op_type).fn(jins, dict(attrs), jreg.LoweringContext())
    t_out = treg.get_op(op_type).fn(tins, dict(attrs), treg.LoweringContext())
    assert set(j_out) == set(t_out)
    for slot in j_out:
        for j, t in zip(j_out[slot], t_out[slot]):
            assert tuple(j.shape) == tuple(t.shape), slot
            if j.dtype == jnp.bfloat16:
                assert t.dtype == torch.bfloat16, slot
                np.testing.assert_allclose(
                    t.float().numpy(), np.asarray(j.astype(jnp.float32)),
                    rtol=2 ** -8, atol=1e-6, err_msg=slot)
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=slot)


# ---------------------------------------------------------------------------
# the nine eager optimizers on fed gradients
# ---------------------------------------------------------------------------
SHAPES = {"w_0": (4, 3), "b_0": (3,), "z_0": (5,)}


def _init_and_grads(seed=1, steps=3):
    rng = np.random.RandomState(seed)
    init = {"w_0": rng.randn(4, 3).astype("float32"),
            "b_0": np.zeros(3, "float32"),          # a zero parameter
            "z_0": rng.randn(5).astype("float32")}
    grads = []
    for _ in range(steps):
        g = {"w_0": np.round(rng.randn(4, 3), 1).astype("float32"),
             "b_0": np.round(rng.randn(3), 1).astype("float32"),
             "z_0": np.zeros(5, "float32")}          # a zero gradient
        grads.append(g)
    return init, grads


def _params(pkg, init, dtype):
    if pkg == "j":
        return [jdy.ParamBase(jnp.asarray(init[n], dtype), name=n)
                for n in SHAPES]
    return [tdy.ParamBase(torch.from_numpy(init[n].copy()).to(dtype),
                          name=n) for n in SHAPES]


OPTIMIZERS = {
    "SGD": lambda m, ps, kw: m.SGD(0.1, parameters=ps, **kw),
    "Momentum": lambda m, ps, kw: m.Momentum(0.1, 0.9, parameters=ps,
                                             use_nesterov=True, **kw),
    "Adam": lambda m, ps, kw: m.Adam(0.01, parameters=ps, **kw),
    "AdamW": lambda m, ps, kw: m.AdamW(
        0.01, parameters=ps, weight_decay=0.1,
        apply_decay_param_fun=lambda n: n != "b_0", **kw),
    "Adagrad": lambda m, ps, kw: m.Adagrad(0.1, parameters=ps, **kw),
    "RMSProp": lambda m, ps, kw: m.RMSProp(0.01, momentum=0.5,
                                           centered=True, parameters=ps,
                                           **kw),
    "Lamb": lambda m, ps, kw: m.Lamb(0.01, parameters=ps, **kw),
    "Adadelta": lambda m, ps, kw: m.Adadelta(1.0, parameters=ps, **kw),
    "Adamax": lambda m, ps, kw: m.Adamax(0.01, parameters=ps, **kw),
}
MASTER_OK = ("SGD", "Momentum", "Adam", "AdamW", "Lamb")


def _run(pkg, name, init, grads, kw=None, dtype="float32", lr=None):
    """Each step's parameters (float32 numpy) and the final state_dict."""
    m = jopt if pkg == "j" else topt
    if pkg == "j":
        ps = _params(pkg, init, jnp.dtype(dtype))
    else:
        ps = _params(pkg, init, getattr(torch, dtype))
    opt = OPTIMIZERS[name](m, ps, dict(kw or {}))
    if lr is not None:
        opt._lr = lr(m.lr)
    seen = []
    for g in grads:
        for p in ps:
            if pkg == "j":
                p._grad = jnp.asarray(g[p.name], p._value.dtype)
            else:
                p._grad = torch.from_numpy(g[p.name].copy()).to(
                    p._value.dtype)
        opt.step()
        opt.clear_grad()
        assert all(p._grad is None for p in ps)
        if pkg == "j":
            seen.append([np.asarray(p._value.astype(jnp.float32))
                         for p in ps])
        else:
            seen.append([p._value.float().numpy() for p in ps])
        if lr is not None:
            opt._lr.step()
    return seen, opt.state_dict()


def _same_steps(got, want, rtol=1e-5, atol=1e-6):
    for step, (gs, ws) in enumerate(zip(got, want)):
        for n, g, w in zip(SHAPES, gs, ws):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"step {step} {n}")


def _same_state(got, want, rtol=1e-5, atol=1e-6):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_eager_optimizer_matches_reference(name):
    init, grads = _init_and_grads()
    want, wstate = _run("j", name, init, grads)
    got, gstate = _run("t", name, init, grads)
    _same_steps(got, want)
    _same_state(gstate, wstate)
    # the weights moved, and the zero-gradient one only by decay
    assert not np.allclose(got[-1][0], init["w_0"])


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_multi_precision_masters_or_refusal(name):
    init, grads = _init_and_grads(seed=2)
    if name not in MASTER_OK:
        for m, ps in ((jopt, _params("j", init, jnp.bfloat16)),
                      (topt, _params("t", init, torch.bfloat16))):
            with pytest.raises(NotImplementedError, match="multi_precision"):
                OPTIMIZERS[name](m, ps, {"multi_precision": True})
        return
    kw = {"multi_precision": True}
    want, wstate = _run("j", name, init, grads, kw, dtype="bfloat16")
    got, gstate = _run("t", name, init, grads, kw, dtype="bfloat16")
    masters = [k for k in wstate if k.endswith(".master")]
    assert sorted(masters) == sorted(f"{n}.master" for n in SHAPES)
    _same_state(gstate, wstate)
    # the bf16 parameters are the masters rounded: one bf16 unit apart at
    # most where a master sits at a rounding boundary
    _same_steps(got, want, rtol=2 ** -7, atol=1e-6)
    for n in SHAPES:
        np.testing.assert_allclose(
            got[-1][list(SHAPES).index(n)],
            torch.from_numpy(gstate[f"{n}.master"]).to(torch.bfloat16)
            .float().numpy(), rtol=0, atol=0)


CLIPS = {
    "global_norm": lambda c: c.ClipGradByGlobalNorm(0.5),
    "norm": lambda c: c.ClipGradByNorm(0.4),
    "value": lambda c: c.ClipGradByValue(0.3, -0.2),
}


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("name", ["SGD", "Adam", "Adadelta"])
def test_grad_clip_matches_reference(name, clip):
    init, grads = _init_and_grads(seed=3)
    want, _ = _run("j", name, init, grads,
                   {"grad_clip": CLIPS[clip](jclip)})
    got, _ = _run("t", name, init, grads,
                  {"grad_clip": CLIPS[clip](tclip)})
    _same_steps(got, want)
    if name == "SGD":       # Adam's step barely sees a gradient's scale
        unclipped, _ = _run("t", name, init, grads)
        assert not np.allclose(got[0][0], unclipped[0][0])


@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "AdamW"])
def test_weight_decay_and_scheduler_match_reference(name):
    init, grads = _init_and_grads(seed=4)
    kw = {} if name == "AdamW" else {"weight_decay": 0.05}

    def sched(m):
        return m.PiecewiseDecay([1, 2], [0.1, 0.05, 0.02])

    want, wstate = _run("j", name, init, grads, kw, lr=sched)
    got, gstate = _run("t", name, init, grads, kw, lr=sched)
    _same_steps(got, want)
    _same_state(gstate, wstate)


def test_set_lr_refused_on_a_scheduler():
    for m in (jopt, topt):
        ps = []
        opt = m.SGD(m.lr.StepDecay(0.1, 2), parameters=ps)
        with pytest.raises(RuntimeError, match="scheduler"):
            opt.set_lr(0.5)
        fixed = m.SGD(0.1, parameters=ps)
        fixed.set_lr(0.5)
        assert fixed.get_lr() == 0.5


def test_set_state_dict_restores_nothing_as_the_reference():
    """Kept on purpose: a resumed optimizer restarts its moments."""
    init, grads = _init_and_grads()
    for pkg, m in (("j", jopt), ("t", topt)):
        ps = _params(pkg, init, jnp.float32 if pkg == "j" else torch.float32)
        opt = m.Adam(0.01, parameters=ps)
        opt.set_state_dict({"w_0.m1": np.ones((4, 3), "float32")})
        assert opt.state_dict() == {"lr": 0.01}


# ---------------------------------------------------------------------------
# auto_cast and GradScaler
# ---------------------------------------------------------------------------
def _amp_dtypes(dy, nn, ac, L, dtype, place):
    """The dtype each op of a small net gives under auto_cast."""
    with dy.guard(place) if place is not None else dy.guard():
        lin = nn.Linear(8, 4)
        x = dy.to_variable(np.ones((2, 8), "float32"))
        with ac(dtype=dtype):
            h = lin(x)
            s = L.softmax(h)
            r = L.relu(h)
            m = L.reduce_mean(r)
        return [str(v.dtype) for v in (h, s, r, m)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_auto_cast_casts_the_ops_the_reference_casts(dtype):
    from paddle_tpu.fluid import layers as jL
    from paddle_tpu_torch.fluid import layers as tL
    want = _amp_dtypes(jdy, jnn, jamp.auto_cast, jL, dtype, None)
    got = _amp_dtypes(tdy, tnn, tamp.auto_cast, tL, dtype, tfluid.CPUPlace())
    assert got == want == [dtype, "float32", dtype, "float32"]


def test_grad_scaler_bf16_is_the_identity():
    with tdy.guard(tfluid.CPUPlace()):
        scaler = tamp.GradScaler()
        p = tdy.ParamBase(torch.ones(3), name="p_0")
        opt = topt.SGD(0.5, parameters=[p])
        with tamp.auto_cast():
            loss = tdy.to_variable(np.float32(2.0))
            assert scaler.scale(loss) is loss
        p._grad = torch.full((3,), float("inf"))
        scaler.minimize(opt, loss)
        # no finite check: the update ran on the inf gradient
        assert torch.isinf(p._value).all()
        assert scaler.get_scale() == 1.0 and not scaler.is_enable()


def _scaler_run(pkg, inf_steps, steps=12):
    """An fp16 scaler over ``steps`` steps of SGD on one parameter, an
    inf gradient injected at ``inf_steps``: each step's scale and the
    parameter."""
    dy, amp, m = (jdy, jamp, jopt) if pkg == "j" else (tdy, tamp, topt)
    scales, vals = [], []
    ctx = dy.guard() if pkg == "j" else dy.guard(tfluid.CPUPlace())
    with ctx:
        scaler = amp.GradScaler(init_loss_scaling=8.0,
                                incr_every_n_steps=3,
                                decr_every_n_nan_or_inf=2)
        if pkg == "j":
            p = jdy.ParamBase(jnp.ones(2), name="p_0")
        else:
            p = tdy.ParamBase(torch.ones(2), name="p_0")
        opt = m.SGD(0.25, parameters=[p])
        for i in range(steps):
            with amp.auto_cast(dtype="float16"):
                scaled = scaler.scale(1.0)
            g = np.asarray([np.inf if i in inf_steps else 0.5, 1.0],
                           "float32") * scaled
            p._grad = jnp.asarray(g) if pkg == "j" else torch.from_numpy(g)
            scaler.minimize(opt, None)     # outside the context: the latch
            scales.append(scaler.get_scale())
            vals.append(np.asarray(p._value if pkg == "j"
                                   else p._value.numpy()).copy())
        return scales, vals, scaler.state_dict()


def test_grad_scaler_fp16_skip_and_rescale_sequence():
    inf_steps = {1, 2, 6, 9}
    want = _scaler_run("j", inf_steps)
    got = _scaler_run("t", inf_steps)
    assert got[0] == want[0]
    assert got[2] == want[2]
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    # the sequence is not trivial: the scale fell and rose
    assert min(want[0]) < 8.0
    assert any(b > a for a, b in zip(want[0], want[0][1:]))
    # the skipped steps left the parameter where it was
    assert np.array_equal(got[1][1], got[1][0])


def test_grad_scaler_latch_and_state_dict():
    with tdy.guard(tfluid.CPUPlace()):
        scaler = tamp.GradScaler()
        assert not scaler.is_enable()
        with tamp.auto_cast(dtype="float16"):
            assert scaler.is_enable()
        assert scaler.is_enable()          # latched after the exit
        other = tamp.GradScaler(dtype="float16")
        other.load_state_dict({"scale": 4.0, "good": 2, "bad": 1})
        assert other.state_dict() == {"scale": 4.0, "good": 2, "bad": 1}
    with jdy.guard():
        j = jamp.GradScaler()
        with jamp.auto_cast(dtype="float16"):
            assert j.is_enable()
        assert j.is_enable()


# ---------------------------------------------------------------------------
# save_dygraph / load_dygraph across packages, and the Layer methods
# ---------------------------------------------------------------------------
class _Block:
    """A two-level net, built in either package."""

    @staticmethod
    def build(layers, nn):
        class Inner(layers.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(4, 3)

            def forward(self, x):
                return self.fc(x)

        class Outer(layers.Layer):
            def __init__(self):
                super().__init__()
                self.inner = Inner()
                self.head = nn.Linear(3, 2)
                self.scale = self.create_parameter([2])

            def forward(self, x):
                return self.head(self.inner(x))

        return Outer()


def test_save_load_dygraph_across_packages(tmp_path):
    jframework.reset_unique_name()
    tframework.reset_unique_name()
    with jdy.guard():
        jm = _Block.build(jlayers, jnn)
        jstate = jm.state_dict()
        jpath = jckpt.save_dygraph(jstate, str(tmp_path / "ref"))
        jopt_state = {"lr": 0.1, "fc_0.w_0.m1": np.arange(3.0)}
        jckpt.save_dygraph(jopt_state, str(tmp_path / "ref_opt"))
    with tdy.guard(tfluid.CPUPlace()):
        tm = _Block.build(tlayers, tnn)
        assert list(tm.state_dict()) == list(jstate)
        # the parameters' unique names follow the reference's
        assert [p.name for p in tm.parameters()] == \
            [p.name for p in jm.parameters()]
        params, opt = tckpt.load_dygraph(str(tmp_path / "ref"))
        assert opt is None
        tm.set_dict(params)
        for k, v in tm.state_dict().items():
            np.testing.assert_array_equal(v, np.asarray(jstate[k]))
        # the port writes the same bytes as the reference
        tpath = tckpt.save_dygraph(tm.state_dict(), str(tmp_path / "port"))
        assert open(tpath, "rb").read() == open(jpath, "rb").read()
        tckpt.save_dygraph(jopt_state, str(tmp_path / "port_opt"))
        assert open(tmp_path / "port_opt.pdparams", "rb").read() == \
            open(tmp_path / "ref_opt.pdparams", "rb").read()
        # a .pdopt beside the parameters comes back as the second value
        (tmp_path / "port.pdopt").write_bytes(
            (tmp_path / "port_opt.pdparams").read_bytes())
        _, opt = tckpt.load_dygraph(str(tmp_path / "port"))
        assert list(opt) == ["lr", "fc_0.w_0.m1"]
        moved = {k: v + 1.0 for k, v in tm.state_dict().items()}
        tckpt.save_dygraph(moved, str(tmp_path / "moved"))
        with pytest.raises(TypeError, match="bfloat16"):
            tckpt.save_dygraph(
                {"w": tdy.ParamBase(torch.ones(2, dtype=torch.bfloat16))},
                str(tmp_path / "bf16"))
    with jdy.guard():
        params, _ = jckpt.load_dygraph(str(tmp_path / "moved"))
        jm.load_dict(params)
        for k, v in jm.state_dict().items():
            np.testing.assert_array_equal(np.asarray(v), moved[k])


def test_layer_methods_match_reference():
    jframework.reset_unique_name()
    tframework.reset_unique_name()
    x = np.random.RandomState(0).randn(2, 4).astype("float32")
    out = {}
    for pkg, dy, layers, nn, place in (("j", jdy, jlayers, jnn, None),
                                       ("t", tdy, tlayers, tnn,
                                        tfluid.CPUPlace())):
        with dy.guard(place) if place is not None else dy.guard():
            m = _Block.build(layers, nn)
            if pkg == "t":
                interop.layer_from_numpy(m, state)
            else:
                state = m.state_dict()
            seen = []
            pre = m.register_forward_pre_hook(
                lambda layer, args: (args[0] * 2.0,))
            post = m.inner.register_forward_post_hook(
                lambda layer, args, o: seen.append(o.shape) or o * 0.25)
            hooked = np.asarray(m(dy.to_variable(x)).numpy())
            pre.remove()
            post.remove()
            plain = np.asarray(m(dy.to_variable(x)).numpy())
            out[pkg] = dict(
                hooked=hooked, plain=plain, seen=seen,
                sub=[type(s).__name__ for s in m.sublayers()],
                sub_self=len(m.sublayers(include_self=True)),
                named=[n for n, _ in m.named_sublayers()],
                named_self=[n for n, _ in m.named_sublayers(
                    prefix="net.", include_self=True)],
                scale=(m.scale.name, m.scale.shape),
                params=[p.name for p in m.parameters()])
    j, t = out["j"], out["t"]
    for k in ("seen", "sub", "sub_self", "named", "named_self", "scale",
              "params"):
        assert t[k] == j[k], k
    assert t["named"] == ["inner", "inner.fc", "head"]
    np.testing.assert_allclose(t["hooked"], j["hooked"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t["plain"], j["plain"], rtol=1e-5, atol=1e-6)
    assert not np.allclose(t["hooked"], t["plain"])
