"""The CTR slice: paddle_tpu_torch against paddle_tpu, module by module and
as a whole.

Every op of the wide&deep CTR program, the fused sparse embedding (its
forward and custom gradient), Momentum and its bucketed form run the same
numpy inputs (made from a seed) through the JAX lowering on the CPU and
through the port's on CPU tensors, where the fused ops take their plain
versions.  The port's plain versions of the three kernels are also held
against the reference's Pallas kernel bodies, run with ``interpret=True``.
Then both packages build the small CTR program (4 slots, vocab 128, dim
16, seq 5, 16 rows), the port takes the reference's startup values through
``interop.scope_from_numpy``, and the two train and serve side by side.

Tolerances: float32 results across packages rtol=atol=1e-5 (the two
libraries sum in different orders, nothing more); 5-step losses,
parameters and velocities rtol 1e-5 with atol 1e-6 x the largest
magnitude of that kind of state; the plain versions against the Pallas
bodies rtol=atol=1e-6 (the same products, summed in the same order up to
XLA's choices).  The port's own contracts are held bit for bit: the
``fuse_sparse_embedding`` rewrite against the unrewritten program, the
``fused_momentum`` bucket against the per-param updates, and the host's
``index_add_`` against sequential accumulation in index order.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401 — registers the reference lowerings
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.core import Scope as JScope, scope_guard
from paddle_tpu.fluid.framework import reset_unique_name as j_reset
from paddle_tpu.models.static_graphs import \
    build_ctr_train_program as j_build
from paddle_tpu.ops import registry as jreg
from paddle_tpu.serving import freeze_program as j_freeze

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset
from paddle_tpu_torch.fluid.passes import PassPipeline, create_pass
from paddle_tpu_torch.models.static_graphs import \
    build_ctr_train_program as t_build, ctr_demo_feed
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.ctr_ops import _emb_pool_prep, \
    _reference_embedding_pool, _reference_embedding_pool_grad
from paddle_tpu_torch.serving import freeze_program

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(slots=4, vocab=128, dim=16, seq=5)
ROWS = 16
STEPS = 5
FEEDS = ["dense"] + [f"ids_{i}" for i in range(SMALL["slots"])]
R = np.random.RandomState(11)


def _f(*shape):
    return R.randn(*shape).astype("float32")


def _run_both(op_type, ins, attrs, ctx_t=None):
    """The op in both packages; returns {slot: [(jax, torch), ...]}."""
    j_ins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    t_ins = {s: [torch.from_numpy(np.array(a)) for a in v]
             for s, v in ins.items()}
    j_out = jreg.get_op(op_type).fn(j_ins, dict(attrs),
                                    jreg.LoweringContext())
    t_out = treg.get_op(op_type).fn(t_ins, dict(attrs),
                                    ctx_t or treg.LoweringContext())
    assert set(j_out) == set(t_out), op_type
    return {s: list(zip(j_out[s], t_out[s])) for s in j_out}


def _check(op_type, ins, attrs, tol=TOL):
    for slot, pairs in _run_both(op_type, ins, attrs).items():
        for j, t in pairs:
            j, t = np.asarray(j), t.numpy()
            assert j.shape == t.shape, (op_type, slot, j.shape, t.shape)
            if slot == "MaxIndex":
                continue              # a placeholder in both packages
            np.testing.assert_allclose(t.astype(np.float64),
                                       j.astype(np.float64), **tol,
                                       err_msg=f"{op_type}.{slot}")


# ---------------------------------------------------------------------------
# the ops of the program, one by one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_length", [False, True],
                         ids=["full", "length"])
@pytest.mark.parametrize("pool", ["SUM", "AVERAGE", "SQRT", "MAX", "LAST",
                                  "FIRST"])
def test_sequence_pool_matches_reference(pool, with_length):
    ins = {"X": [_f(5, 6, 3)]}
    if with_length:
        ins["Length"] = [np.array([6, 3, 1, 5, 0], "int64")]
    _check("sequence_pool", ins, {"pooltype": pool})


OP_CASES = {
    "concat_axis1": ("concat", {"X": [_f(4, 3), _f(4, 5), _f(4, 1)]},
                     {"axis": 1}),
    "concat_axis0": ("concat", {"X": [_f(2, 3), _f(4, 3)]}, {"axis": 0}),
    "lookup_table_v1": ("lookup_table",
                        {"W": [_f(10, 4)],
                         "Ids": [R.randint(0, 10, (3, 5, 1))
                                 .astype("int64")]}, {}),
    "lookup_table_v1_padding": ("lookup_table",
                                {"W": [_f(10, 4)],
                                 "Ids": [np.array([[[2], [0]], [[2], [9]]],
                                                  "int64")]},
                                {"padding_idx": 2}),
    "reduce_sum_dim1": ("reduce_sum", {"X": [_f(4, 5, 3)]},
                        {"dim": [1], "keep_dim": False}),
    "reduce_sum_keep": ("reduce_sum", {"X": [_f(4, 5, 3)]},
                        {"dim": [-1], "keep_dim": True}),
    "reduce_sum_all": ("reduce_sum", {"X": [_f(4, 5)]},
                       {"dim": [0], "reduce_all": True}),
    "sigmoid_xent": ("sigmoid_cross_entropy_with_logits",
                     {"X": [3 * _f(8, 1)],
                      "Label": [R.randint(0, 2, (8, 1)).astype("float32")]},
                     {}),
    "sigmoid_xent_ignore_normalize": (
        "sigmoid_cross_entropy_with_logits",
        {"X": [3 * _f(6, 2)],
         "Label": [np.array([[1, 0], [-1, 1], [0, -1], [1, 1], [0, 0],
                             [-1, -1]], "float32")]},
        {"ignore_index": -1, "normalize": True}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    _check(*OP_CASES[case])


@pytest.mark.parametrize("op_type,ins,attrs", [
    ("reduce_sum", {"X": [_f(8, 3)]}, {"dim": [0]}),
    ("sigmoid_cross_entropy_with_logits",
     {"X": [_f(8, 1)], "Label": [np.ones((8, 1), "float32")]}, {})],
    ids=["reduce_sum", "sigmoid_xent"])
def test_padded_batch_is_refused(op_type, ins, attrs):
    """Under shape bucketing (5 valid rows padded to 8) both packages fold
    the padded rows out of a batch reduction; the port's masked answer is
    the reference's at the same inputs.  A reduction that keeps the
    batch axis is not masked."""
    ctx_t = treg.LoweringContext()
    ctx_t.batch_valid, ctx_t.batch_padded = 5, 8
    ctx_j = jreg.LoweringContext()
    ctx_j.batch_valid, ctx_j.batch_padded = jnp.asarray(5, jnp.int32), 8
    t_ins = {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}
    j_ins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    got = treg.get_op(op_type).fn(t_ins, dict(attrs), ctx_t)["Out"][0]
    want = jreg.get_op(op_type).fn(j_ins, dict(attrs), ctx_j)["Out"][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = ins["X"][0]
    if op_type == "reduce_sum":
        np.testing.assert_allclose(got.numpy(), x[:5].sum(0), **TOL)
    else:
        assert np.all(got.numpy()[5:] == 0) and np.all(got.numpy()[:5] != 0)
    out = treg.get_op("reduce_sum").fn({"X": [torch.ones(8, 3)]},
                                       {"dim": [1]}, ctx_t)["Out"][0]
    assert torch.equal(out, torch.full((8,), 3.0))


# ---------------------------------------------------------------------------
# fused sparse embedding: forward and custom gradient
# ---------------------------------------------------------------------------

def _emb_case(name):
    rng = np.random.RandomState(3)
    w = rng.randn(12, 8).astype("float32")
    ids = rng.randint(0, 12, (6, 5)).astype("int64")
    ins, attrs = {"W": [w], "Ids": [ids]}, {"pooltype": "SUM"}
    if name == "average_length":
        ins["Length"] = [np.array([5, 2, 1, 0, 3, 4], "int64")]
        attrs["pooltype"] = "AVERAGE"
    elif name == "padding_idx":
        ids[:, 1] = 4
        attrs["padding_idx"] = 4
    elif name == "squeeze_ids":
        ins["Ids"] = [ids[..., None]]
        attrs["squeeze_ids"] = True
    elif name == "repeated_ids":
        ins["Ids"] = [rng.randint(0, 3, (6, 5)).astype("int64")]
    return ins, attrs


EMB_CASES = ["sum", "average_length", "padding_idx", "squeeze_ids",
             "repeated_ids"]


@pytest.mark.parametrize("case", EMB_CASES)
def test_fused_embedding_pool_matches_reference(case):
    ins, attrs = _emb_case(case)
    _check("fused_embedding_pool", ins, attrs)
    g = np.random.RandomState(4).randn(6, 8).astype("float32")
    jd, td = jreg.get_op("fused_embedding_pool"), \
        treg.get_op("fused_embedding_pool")
    j_ins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    t_ins = {s: [torch.from_numpy(np.array(a)) for a in v]
             for s, v in ins.items()}
    want = jd.custom_grad(j_ins, None, {"Out": jnp.asarray(g)}, attrs,
                          jreg.LoweringContext())["W"][0]
    got = td.custom_grad(t_ins, None, {"Out": torch.from_numpy(g)}, attrs,
                         treg.LoweringContext())["W"][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", EMB_CASES)
def test_unmasked_sum_pool_makes_no_weight(case):
    """A SUM pool with neither ``Length`` nor ``padding_idx`` makes no
    ``[B, S]`` weight, so its slot runs only its kernel; its plain
    forward and gradient are bit for bit those of an all-ones weight."""
    ins, attrs = _emb_case(case)
    t_ins = {s: [torch.from_numpy(np.array(a)) for a in v]
             for s, v in ins.items()}
    w, ids, wgt = _emb_pool_prep(t_ins, attrs)
    assert (wgt is None) == (case in ("sum", "squeeze_ids", "repeated_ids"))
    if wgt is None:
        ones = torch.ones(ids.shape)
        g = torch.from_numpy(
            np.random.RandomState(4).randn(6, 8).astype("float32"))
        assert torch.equal(_reference_embedding_pool(w, ids, None),
                           _reference_embedding_pool(w, ids, ones))
        assert torch.equal(_reference_embedding_pool_grad(g, ids, None, 12),
                           _reference_embedding_pool_grad(g, ids, ones, 12))


def test_host_index_add_adds_in_index_order():
    """The plain gradient, and with it the card's check of the gradient
    kernel, relies on the CPU's ``index_add_`` summing the rows of one
    index in index order: it must equal numpy's unbuffered sequential
    ``add.at`` bit for bit on non-dyadic values with many repeats."""
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 7, 4096).astype("int64")
    rows = rng.randn(4096, 16).astype("float32") / 3
    want = np.zeros((7, 16), np.float32)
    np.add.at(want, ids, rows)
    got = torch.zeros(7, 16).index_add_(0, torch.from_numpy(ids),
                                        torch.from_numpy(rows))
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Momentum and its bucketed form
# ---------------------------------------------------------------------------

MOMENTUM_ATTRS = {
    "plain": {"mu": 0.9, "use_nesterov": False},
    "nesterov": {"mu": 0.9, "use_nesterov": True},
    "l2_decay": {"mu": 0.8, "use_nesterov": False,
                 "regularization_method": "l2_decay",
                 "regularization_coeff": 1e-2},
}


def _momentum_ins(shapes, seed=6):
    rng = np.random.RandomState(seed)
    return {"Param": [rng.randn(*s).astype("float32") for s in shapes],
            "Grad": [rng.randn(*s).astype("float32") / 10 for s in shapes],
            "Velocity": [rng.randn(*s).astype("float32") / 10
                         for s in shapes],
            "LearningRate": [np.array([0.05], "float32")]}


@pytest.mark.parametrize("kind", sorted(MOMENTUM_ATTRS))
def test_momentum_and_fused_momentum_match_reference(kind):
    attrs = MOMENTUM_ATTRS[kind]
    ins = _momentum_ins([(40, 30), (30,), (7, 3)])
    one = {s: v[:1] for s, v in ins.items()}
    _check("momentum", one, attrs)
    _check("fused_momentum", ins, attrs)
    # the port's bucket is bit-identical to its per-param updates
    t_ins = {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}
    ctx = treg.LoweringContext()
    fused = treg.get_op("fused_momentum").fn(t_ins, attrs, ctx)
    for i in range(3):
        per = treg.get_op("momentum").fn(
            {s: [v[0] if s == "LearningRate" else v[i]]
             for s, v in t_ins.items()}, attrs, ctx)
        for slot in ("ParamOut", "VelocityOut"):
            assert torch.equal(fused[slot][i], per[slot][0]), (slot, i)


@pytest.mark.parametrize("kind", sorted(MOMENTUM_ATTRS))
def test_fused_momentum_widens_grads_and_reads_strided_params(kind):
    """A float16 grad is widened to its param's float32, that segment
    only, and a non-contiguous param (a transposed view) is read by its
    values, as the reference's fused_momentum reads them."""
    attrs = MOMENTUM_ATTRS[kind]
    ins = _momentum_ins([(6, 5), (7,), (3, 4)], seed=9)
    ins["Grad"][1] = ins["Grad"][1].astype("float16")
    j_ins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    want = jreg.get_op("fused_momentum").fn(j_ins, dict(attrs),
                                            jreg.LoweringContext())
    t_ins = {s: [torch.from_numpy(a.copy()) for a in v]
             for s, v in ins.items()}
    t_ins["Param"][0] = torch.from_numpy(ins["Param"][0].T.copy()).T
    assert not t_ins["Param"][0].is_contiguous()
    assert t_ins["Grad"][1].dtype == torch.float16
    got = treg.get_op("fused_momentum").fn(t_ins, dict(attrs),
                                           treg.LoweringContext())
    for slot in ("ParamOut", "VelocityOut"):
        for i, (j, t) in enumerate(zip(want[slot], got[slot])):
            assert t.dtype == torch.float32 and t.shape == j.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL,
                                       err_msg=f"{slot} {i}")


# ---------------------------------------------------------------------------
# the plain versions against the reference's Pallas kernel bodies
# ---------------------------------------------------------------------------

@pytest.fixture
def pallas_interpret(monkeypatch):
    """``jax.experimental.pallas`` with ``load`` and ``store`` (newer jax
    keeps them only in ``jax._src.pallas.primitives``; the kernel bodies
    call ``pl.load``/``pl.store``)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    for name in ("load", "store"):
        if not hasattr(pl, name):
            from jax._src.pallas import primitives
            monkeypatch.setattr(pl, name, getattr(primitives, name),
                                raising=False)
    return pl, pltpu


def _emb_kernel_inputs(s=5, d=128):
    rng = np.random.RandomState(0)
    w = rng.randn(64, d).astype("float32")
    ids = rng.randint(0, 16, (4, s)).astype("int32")   # ids repeat
    wgt = rng.rand(4, s).astype("float32")
    g = rng.randn(4, d).astype("float32")
    return w, ids, wgt, g


# S and D around the Hopper kernel's splits: S = 1, the CTR program's 5,
# and 9 (past the 8 ids a thread holds at once, so a second chunk); D = 3
# (no 16-byte loads), 16 (the program's) and 128
@pytest.mark.parametrize("s", (1, 5, 9))
@pytest.mark.parametrize("d", (3, 16, 128))
def test_plain_gather_pool_matches_pallas_body(pallas_interpret, s, d):
    from paddle_tpu.ops import pallas_kernels as pk
    pl, pltpu = pallas_interpret
    w, ids, wgt, _ = _emb_kernel_inputs(s, d)
    smem = functools.partial(pl.BlockSpec, memory_space=pltpu.SMEM)
    want = pl.pallas_call(
        functools.partial(pk._gather_pool_kernel, n_ids=s),
        grid=(4,),
        in_specs=[smem((1, s), lambda i: (i, 0)),
                  smem((1, s), lambda i: (i, 0)),
                  pl.BlockSpec((64, d), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, d), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((4, d), jnp.float32),
        interpret=True)(jnp.asarray(ids), jnp.asarray(wgt), jnp.asarray(w))
    got = _reference_embedding_pool(torch.from_numpy(w),
                                    torch.from_numpy(ids.astype("int64")),
                                    torch.from_numpy(wgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_plain_scatter_grad_matches_pallas_body(pallas_interpret):
    from paddle_tpu.ops import pallas_kernels as pk
    pl, pltpu = pallas_interpret
    w, ids, wgt, g = _emb_kernel_inputs()
    smem = functools.partial(pl.BlockSpec, memory_space=pltpu.SMEM)
    want = pl.pallas_call(
        functools.partial(pk._scatter_grad_kernel, n_ids=5),
        grid=(4,),
        in_specs=[smem((1, 5), lambda i: (i, 0)),
                  smem((1, 5), lambda i: (i, 0)),
                  pl.BlockSpec((1, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((64, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((64, 128), jnp.float32),
        interpret=True)(jnp.asarray(ids), jnp.asarray(wgt), jnp.asarray(g))
    got = _reference_embedding_pool_grad(
        torch.from_numpy(g), torch.from_numpy(ids.astype("int64")),
        torch.from_numpy(wgt), 64)
    # the Pallas body adds in (i, j) order, as index_add_ does on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind", sorted(MOMENTUM_ATTRS))
def test_plain_momentum_matches_pallas_body(pallas_interpret, kind):
    from paddle_tpu.ops import pallas_kernels as pk
    pl, pltpu = pallas_interpret
    attrs = MOMENTUM_ATTRS[kind]
    l2 = attrs.get("regularization_coeff", 0.0)
    ins = _momentum_ins([(8, 128)])
    p, g, v = (ins[s][0] for s in ("Param", "Grad", "Velocity"))
    lr = ins["LearningRate"][0]
    spec = pl.BlockSpec((8, 128), lambda i: (i, 0))
    p_want, v_want = pl.pallas_call(
        functools.partial(pk._fused_momentum_kernel, mu=attrs["mu"],
                          use_nesterov=attrs["use_nesterov"], l2_decay=l2),
        grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + [spec] * 3,
        out_specs=[spec] * 2,
        out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.float32)] * 2,
        interpret=True)(jnp.asarray(lr), jnp.asarray(p), jnp.asarray(g),
                        jnp.asarray(v))
    got = treg.get_op("fused_momentum").fn(
        {s: [torch.from_numpy(a) for a in vals] for s, vals in ins.items()},
        attrs, treg.LoweringContext())
    np.testing.assert_allclose(got["ParamOut"][0].numpy(),
                               np.asarray(p_want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["VelocityOut"][0].numpy(),
                               np.asarray(v_want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the program as a whole
# ---------------------------------------------------------------------------

def _op_stream(program):
    return [(op.type, op.inputs, op.outputs)
            for op in program.global_block().ops]


def _strategy(fluid, sparse=True, optimizer=True):
    bs = fluid.BuildStrategy()
    bs.fuse_sparse_embedding = sparse
    bs.fuse_optimizer = optimizer
    return bs


def _feed(seed=0):
    return ctr_demo_feed(np.random.RandomState(seed), batch=ROWS,
                         slots=SMALL["slots"], vocab=SMALL["vocab"],
                         seq=SMALL["seq"])


@functools.lru_cache(maxsize=None)
def _reference(optimizer):
    """paddle_tpu's run with ``optimizer``, both passes on: the op
    streams before and after the passes, the parameter names and shapes,
    the initial persistables, STEPS losses and the final persistables."""
    j_reset()
    main, startup, loss = j_build(optimizer=optimizer, **SMALL)
    before = _op_stream(main)
    params = [(p.name, tuple(p.shape)) for p in main.all_parameters()]
    feed = _feed()
    exe = jfluid.Executor()
    scope = JScope()
    with scope_guard(scope):
        exe.run(startup)
        persist = [n for n, v in main.global_block().vars.items()
                   if v.persistable and scope.find_var(n) is not None]
        init = {n: np.array(scope.find_var(n)) for n in persist}
        prog = jfluid.CompiledProgram(main, build_strategy=_strategy(jfluid))
        losses = [float(np.asarray(exe.run(prog, feed=feed,
                                           fetch_list=[loss])[0]).ravel()[0])
                  for _ in range(STEPS)]
        final = {n: np.array(scope.find_var(n)) for n in persist}
    return dict(optimizer=optimizer, before=before,
                after=_op_stream(main), params=params, init=init,
                losses=losses, final=final, feed=feed)


def _port_run(init, feed, steps, optimizer, sparse=True, fuse_opt=True):
    """The port's run from ``init``: (losses, final persistables, main)."""
    t_reset()
    main, _, loss = t_build(optimizer=optimizer, train=True, **SMALL)
    scope = interop.scope_from_numpy(init, tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    prog = tfluid.CompiledProgram(main, _strategy(tfluid, sparse, fuse_opt))
    losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                            scope=scope)[0].ravel()[0])
              for _ in range(steps)]
    return losses, interop.scope_to_numpy(scope, list(init)), main


@pytest.fixture(scope="module")
def momentum_ref():
    return _reference("momentum")


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_program_matches_reference(optimizer):
    """The same parameters (names, shapes, order) and the same op
    stream, before the passes and after them: 4 fused_embedding_pool
    ops with their fused grads, one fused update op."""
    reference = _reference(optimizer)
    t_reset()
    main, _, loss = t_build(optimizer=reference["optimizer"], train=True,
                            **SMALL)
    assert [(p.name, tuple(p.shape)) for p in main.all_parameters()] == \
        reference["params"]
    assert _op_stream(main) == reference["before"]
    counters = [ttrace.metrics().counter(f"kernel_tier.{n}.rewrites")
                for n in ("fuse_sparse_embedding", "fuse_optimizer")]
    before = [c.value for c in counters]
    tfluid.CompiledProgram(main, _strategy(tfluid))._apply_ir_passes(
        [loss.name])
    assert [c.value - b for c, b in zip(counters, before)] == \
        [SMALL["slots"], 1]
    assert _op_stream(main) == reference["after"]
    types = [op.type for op in main.global_block().ops]
    assert types.count("fused_embedding_pool") == SMALL["slots"]
    assert types.count("fused_" + reference["optimizer"]) == 1
    for absent in ("lookup_table_v2", "sequence_pool",
                   reference["optimizer"]):
        assert absent not in types


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_training_matches_reference(optimizer):
    """STEPS losses and every persistable after them (parameters,
    velocities or moments) against paddle_tpu.  Adam's parameters get
    atol 1e-5 of the largest parameter, not 1e-6: at lr 0.05 it fits the
    16 rows within the 5 steps (loss about 3e-5), so the last steps'
    gradients are float32 cancellation in sigmoid(logit) - label, and
    Adam divides each by its own magnitude, which turns their relative
    rounding difference into the same relative difference of a 1e-2
    step.  Momentum's steps shrink with the gradients."""
    reference = _reference(optimizer)
    losses, final, _ = _port_run(reference["init"], reference["feed"],
                                 STEPS, reference["optimizer"])
    np.testing.assert_allclose(losses, reference["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    param_atol = 1e-5 if reference["optimizer"] == "adam" else 1e-6
    for kind in ("velocity", "moment1", "moment2", "w_", "b_"):
        names = [n for n in final if kind in n]
        if not names:
            continue
        scale = max(float(np.abs(reference["final"][n]).max())
                    for n in names)
        for n in names:
            frac = param_atol if kind in ("w_", "b_") else 1e-6
            np.testing.assert_allclose(final[n], reference["final"][n],
                                       rtol=1e-5, atol=frac * scale,
                                       err_msg=n)


def test_fuse_sparse_embedding_rewrite_is_bit_identical(momentum_ref):
    """The rewritten program (fused op + fused scatter-add grad) trains
    exactly as the lookup_table_v2 -> sequence_pool chain does on the
    host: same losses, same parameters and optimizer state."""
    reference = momentum_ref
    off = _port_run(reference["init"], reference["feed"], 3, "momentum",
                    sparse=False, fuse_opt=False)
    on = _port_run(reference["init"], reference["feed"], 3, "momentum",
                   sparse=True, fuse_opt=False)
    assert [op.type for op in on[2].global_block().ops].count(
        "fused_embedding_pool") == SMALL["slots"]
    assert on[0] == off[0]
    for name in off[1]:
        assert np.array_equal(on[1][name], off[1][name]), name


@pytest.mark.parametrize("nesterov", [False, True],
                         ids=["momentum", "nesterov"])
def test_fused_momentum_bucket_is_bit_identical(momentum_ref, nesterov):
    """One fused_momentum over the flattened bucket updates every param
    and velocity exactly as the per-param momentum ops do."""
    reference = momentum_ref

    def run(fuse_opt):
        t_reset()
        main, _, loss = t_build(optimizer="momentum", train=True, **SMALL)
        for op in main.global_block().ops:
            if op.type == "momentum":
                op.attrs["use_nesterov"] = nesterov
        scope = interop.scope_from_numpy(reference["init"], tfluid.Scope(),
                                         tfluid.CPUPlace())
        exe = tfluid.Executor(tfluid.CPUPlace())
        prog = tfluid.CompiledProgram(main, _strategy(tfluid, True,
                                                      fuse_opt))
        losses = [float(exe.run(prog, feed=reference["feed"],
                                fetch_list=[loss], scope=scope)[0])
                  for _ in range(3)]
        types = [op.type for op in main.global_block().ops]
        assert types.count("fused_momentum") == int(fuse_opt)
        return losses, interop.scope_to_numpy(scope, list(reference["init"]))

    off, on = run(False), run(True)
    assert on[0] == off[0]
    for name in off[1]:
        assert np.array_equal(on[1][name], off[1][name]), name


def _pool_program(pool_kind):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.data("ids", [-1, 4], dtype="int64")
        emb = tfluid.layers.embedding(ids, size=[32, 8])
        if pool_kind == "reduce_sum":
            out = tfluid.layers.reduce_sum(emb, dim=1)
            extra = []
        else:
            out = tfluid.layers.sequence_pool(emb, "sum")
            extra = [tfluid.layers.reshape(emb, [-1, 32])]
    return main, [out] + extra


@pytest.mark.parametrize("pool_kind,fused", [("reduce_sum", 1),
                                             ("multi_consumer", 0)])
def test_pass_fuses_reduce_sum_and_declines_a_second_consumer(pool_kind,
                                                              fused):
    """``reduce_sum(dim=1)`` is a pool the pass fuses; a gathered tensor
    with a second consumer (here a reshape) keeps its chain."""
    main, outs = _pool_program(pool_kind)
    stats = PassPipeline([create_pass("fuse_sparse_embedding")]).apply(
        main, targets=[o.name for o in outs])
    assert stats["fuse_sparse_embedding"].get("ops_fused", 0) == fused
    types = [op.type for op in main.global_block().ops]
    assert ("fused_embedding_pool" in types) == bool(fused)


def test_frozen_served_logits_match_reference(momentum_ref):
    """The frozen CTR program (train=False, stops at the logit) with
    ``fuse_sparse_embedding``, on the port's host, against the
    reference's frozen program with the same pass."""
    reference = momentum_ref
    t_reset()
    main, _, logit = t_build(train=False, **SMALL)
    frozen = freeze_program(main, FEEDS, [logit], scope=tfluid.Scope())
    cp = tfluid.CompiledProgram(frozen, _strategy(tfluid, True, False))
    params = {n: a for n, a in reference["init"].items()
              if n in {p.name for p in main.all_parameters()}}
    scope = interop.scope_from_numpy(params, tfluid.Scope(),
                                     tfluid.CPUPlace())
    feed = {k: v for k, v in _feed(seed=1).items() if k in FEEDS}
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        cp, feed=feed, fetch_list=[logit], scope=scope)[0]
    assert [op.type for op in frozen.global_block().ops].count(
        "fused_embedding_pool") == SMALL["slots"]

    j_reset()
    jmain, _, _ = j_build(optimizer="momentum", **SMALL)
    jscope = JScope()
    with scope_guard(jscope):
        for n, a in params.items():
            jscope.set_var(n, jnp.asarray(a))
        jfrozen = j_freeze(jmain, FEEDS, [logit.name])
        jcp = jfluid.CompiledProgram(jfrozen,
                                     build_strategy=_strategy(jfluid, True,
                                                              False))
        want = np.asarray(jfluid.Executor().run(jcp, feed=feed,
                                                fetch_list=[logit.name])[0])
    assert [op.type for op in jfrozen.global_block().ops].count(
        "fused_embedding_pool") == SMALL["slots"]
    assert got.shape == (ROWS, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_ctr_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers take CUDA tensors only, and say so before anything
    is built; the ops take the plain versions for CPU tensors."""
    from paddle_tpu_torch.ops import cuda_kernels
    w, wgt = torch.zeros(10, 4), torch.ones(2, 3)
    ids = torch.zeros(2, 3, dtype=torch.int64)
    ps, lr = [torch.zeros(2048), torch.zeros(3, 5)], torch.ones(1)
    for call in (lambda: cuda_kernels.embedding_pool_fwd(w, ids, wgt),
                 lambda: cuda_kernels.embedding_pool_grad(
                     torch.zeros(2, 4), ids, wgt, 10),
                 lambda: cuda_kernels.fused_momentum(ps, ps, ps, lr, 0.9,
                                                     0.0, False)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_fused_momentum_wrapper_refuses_malformed_buckets():
    """Lists of unequal length, an empty bucket and a grad or velocity
    whose size is not its param's are refused before anything is built
    (the sizes before the device)."""
    from paddle_tpu_torch.ops import cuda_kernels
    ps, lr = [torch.zeros(8), torch.zeros(3, 5)], torch.ones(1)
    short = ps[:1]
    for args, match in (((ps, short, ps), "as many grads"),
                        ((ps, ps, short), "as many grads"),
                        (([], [], []), "at least one"),
                        ((ps, [ps[0], torch.zeros(14)], ps),
                         "grad 1 holds 14 values, 15 expected"),
                        ((ps, ps, [torch.zeros(9), ps[1]]),
                         "velocity 0 holds 9 values, 8 expected")):
        with pytest.raises(ValueError, match=match):
            cuda_kernels.fused_momentum(*args, lr, 0.9, 0.0, False)
    assert cuda_kernels._libs.get("fused_momentum") is None
