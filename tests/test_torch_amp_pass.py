"""The static AMP passes of paddle_tpu_torch against paddle_tpu's.

``BuildStrategy.amp`` runs ``amp_bf16`` and ``prune_redundant_casts``.
On three training programs — ``bench.py:547 main_ctr``'s BoxPS CTR
program at its ``--quick`` width, the small static BERT classifier
(``build_bert_train_program``: naive attention, Adam) and an MLP — the
rewritten program equals the reference's op for op (types, slots, the
``__amp_cast__`` attributes folded into consumers, cast dtypes) and var
for var (dtypes), with and without the cast pruning, and the
``amp.ops_cast`` / ``amp.casts_pruned`` counts agree.  Run from one
state (the reference's parameters carried over), the port's bf16 losses
track its float32 ones and the reference's bf16 ones within the
reference's own bound (rtol 0.05, atol 0.05,
``tests/test_amp_plane.py:123``), and pruning never changes a fetch (bit
for bit).
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid import trace as jtrace
from paddle_tpu.fluid.framework import reset_unique_name as j_reset
from paddle_tpu.models import static_graphs as jgraphs

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset
from paddle_tpu_torch.models import static_graphs as tgraphs

HOST = tfluid.CPUPlace()
BOUND = dict(rtol=0.05, atol=0.05)
STEPS = 3
PKG = {"ref": (jfluid, j_reset, jtrace, jgraphs),
       "port": (tfluid, t_reset, ttrace, tgraphs)}


def _bench_ctr(fluid, graphs, slots=6, dim=8):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.data("ids", [-1, slots], dtype="int64")
        dense = fluid.data("dense", [-1, 13])
        label = fluid.data("label", [-1, 1])
        emb = fluid.layers.pull_box_sparse(ids, dim, table_name="amp_box")
        flat = fluid.layers.reshape(emb, [-1, slots * dim])
        deep = fluid.layers.concat([flat, dense], axis=1)
        h = fluid.layers.fc(deep, 256, act="relu")
        h = fluid.layers.fc(h, 128, act="relu")
        wide = fluid.layers.fc(dense, 1)
        logit = fluid.layers.fc(h, 1) + wide
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))
        fluid.optimizer.SGDOptimizer(0.01).minimize(loss)

    def feeds(rng):
        return [{"ids": rng.randint(0, 64, (16, slots)).astype("int64"),
                 "dense": rng.randn(16, 13).astype("float32"),
                 "label": rng.randint(0, 2, (16, 1)).astype("float32")}
                for _ in range(STEPS)]

    cache = {"amp_box@HBMCACHE":
             np.random.RandomState(8).randn(64, dim).astype("float32")}
    return main, startup, loss, feeds, cache


def _static_bert(fluid, graphs):
    main, startup, loss = graphs.build_bert_train_program()
    return main, startup, loss, (lambda rng: [
        graphs.bert_demo_feed(rng) for _ in range(STEPS)]), {}


def _mlp(fluid, graphs):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 16])
        y = fluid.data("y", [-1, 1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="relu")
        logits = fluid.layers.fc(h, 10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss, (lambda rng: [
        {"x": rng.randn(8, 16).astype("float32"),
         "y": rng.randint(0, 10, (8, 1)).astype("int64")}
        for _ in range(STEPS)]), {}


PROGRAMS = {"bench_ctr": _bench_ctr, "static_bert": _static_bert,
            "mlp": _mlp}


def _build(pkg, name):
    fluid, reset, _, graphs = PKG[pkg]
    reset()
    return PROGRAMS[name](fluid, graphs)


def _amp_strategy(fluid, prune=True):
    bs = fluid.BuildStrategy()
    bs.amp = True
    bs.prune_redundant_casts = prune
    return bs


def _stream(main):
    out = []
    for op in main.global_block().ops:
        out.append((op.type, op.inputs, op.outputs,
                    op.attrs.get("__amp_cast__"),
                    op.attrs.get("out_dtype"),
                    op.attrs.get("amp_inserted"), op.attrs.get("op_role")))
    return out


@pytest.mark.parametrize("prune", (True, False), ids=("pruned", "unpruned"))
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_amp_rewrite_equals_the_reference(name, prune):
    out = {}
    for pkg in ("ref", "port"):
        fluid, _, trace, _ = PKG[pkg]
        main, _, loss, _, _ = _build(pkg, name)
        m = trace.metrics()
        c0 = (m.counter("amp.ops_cast").value,
              m.counter("amp.casts_pruned").value)
        fluid.CompiledProgram(main, build_strategy=_amp_strategy(
            fluid, prune))._apply_ir_passes([loss.name])
        out[pkg] = dict(
            stream=_stream(main),
            dtypes={n: v.dtype for n, v in main.global_block().vars.items()},
            counts=(m.counter("amp.ops_cast").value - c0[0],
                    m.counter("amp.casts_pruned").value - c0[1]),
            flags=(main._amp_enabled, main._amp_dtype,
                   main._hints["amp_dtype"]))
    ref, got = out["ref"], out["port"]
    assert len(got["stream"]) == len(ref["stream"])
    for i, (g, r) in enumerate(zip(got["stream"], ref["stream"])):
        assert g == r, (i, g, r)
    assert got["dtypes"] == ref["dtypes"]
    assert got["counts"] == ref["counts"] and got["counts"][0] > 0
    assert got["flags"] == ref["flags"] == (True, "bfloat16", "bfloat16")
    if prune:
        assert not any(op[0] == "cast" and op[5] for op in got["stream"])
        assert any(op[3] for op in got["stream"])


def _losses(pkg, name, amp, init=None, prune=True):
    """STEPS training losses from one state: the reference's startup
    values (returned for the next call) or ``init`` carried in."""
    fluid = PKG[pkg][0]
    main, startup, loss, feeds, extra = _build(pkg, name)
    prog = main
    if amp:
        prog = fluid.CompiledProgram(main, build_strategy=_amp_strategy(
            fluid, prune))
    if pkg == "ref":
        with jcore.scope_guard(jcore.Scope()):
            exe = jfluid.Executor()
            exe.run(startup)
            scope = jcore.global_scope()
            init = {p.name: np.asarray(scope.find_var(p.name))
                    for p in main.all_parameters()
                    if scope.find_var(p.name) is not None}
            for n, v in extra.items():
                scope.set_var(n, v)
            out = [float(np.ravel(exe.run(prog, feed=f,
                                          fetch_list=[loss])[0])[0])
                   for f in feeds(np.random.RandomState(7))]
        return out, init
    scope = tfluid.Scope()
    exe = tfluid.Executor(HOST)
    exe.run(startup, scope=scope)
    interop.scope_from_numpy(dict(init, **extra), scope, HOST)
    return [float(exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0])
            for f in feeds(np.random.RandomState(7))], init


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_bf16_loss_tracks_fp32_and_the_reference(name):
    ref_bf16, init = _losses("ref", name, amp=True)
    fp32, _ = _losses("port", name, amp=False, init=init)
    bf16, _ = _losses("port", name, amp=True, init=init)
    for i, (a, b, c) in enumerate(zip(fp32, bf16, ref_bf16)):
        assert np.allclose(a, b, **BOUND), (i, a, b)
        assert np.allclose(b, c, **BOUND), (i, b, c)
    assert fp32 != bf16                  # the bf16 products really ran
    unpruned, _ = _losses("port", name, amp=True, init=init, prune=False)
    assert unpruned == bf16              # pruning is value-exact
