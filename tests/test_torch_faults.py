"""Faults of paddle_tpu_torch against paddle_tpu, each held by a probe.

Each test runs a case where the port once parted from the reference (a
bad id that took down a decode engine or a whole served batch, builders
that did not train by default, a float64 feed, an integer mean, a dygraph
``minimize`` that raised, a BuildStrategy that dropped its pass knobs)
and holds the port to what it does now.  Two departures are on purpose: an id
outside its table is refused at ``submit``, for that request alone, where
the reference answers with NaN (on the card such an id would trap in the
gather kernel or assert in ``index_select`` and lose the process's CUDA
context).  Also here: the kernel build's hash covers the headers, and the
flash wrappers' 16-byte alignment rule, neither of which needs a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu  # noqa: F401 — registers the reference lowerings
import paddle_tpu.fluid as jfluid
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.dygraph import nn as jnn
from paddle_tpu.fluid import layers as JL
from paddle_tpu.fluid import optimizer as jopt
from paddle_tpu.fluid.framework import reset_unique_name as j_reset
from paddle_tpu.models.static_graphs import \
    build_bert_train_program as j_bert
from paddle_tpu.models.static_graphs import \
    build_ctr_train_program as j_ctr
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.dygraph import nn as tnn
from paddle_tpu_torch.fluid import layers as TL
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset
from paddle_tpu_torch.models.static_graphs import \
    build_bert_train_program as t_bert
from paddle_tpu_torch.models.static_graphs import \
    build_ctr_train_program as t_ctr
from paddle_tpu_torch.ops import cuda_kernels
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.serving import ServingEngine, freeze_program
from paddle_tpu_torch.serving import decode as tdecode

HOST = tfluid.CPUPlace()
DECODE = dict(vocab=19, d_model=8, max_len=16, seed=5, page_size=4)
TIMEOUT = 60


@pytest.fixture(scope="module")
def decode_model():
    return tdecode.build_demo_decode_model(executor=tfluid.Executor(HOST),
                                           scope=tfluid.Scope(), **DECODE)


# -- 1. DecodeEngine: bad ids -------------------------------------------------
@pytest.mark.parametrize("paged", (False, True), ids=("dense", "paged"))
def test_decode_refuses_out_of_vocab_ids_and_keeps_serving(decode_model,
                                                           paged):
    eng = tdecode.DecodeEngine(decode_model, max_batch=4, paged=paged,
                               name=f"t_bad_ids_{paged}")
    with eng:
        good = eng.submit([1, 2, 3], max_new_tokens=2)
        for bad in ([10 ** 6], [-5], [3, DECODE["vocab"]]):
            with pytest.raises(tdecode.DecodeRejectedError, match="ids"):
                eng.submit(bad, max_new_tokens=2)
        assert len(good.result(timeout=TIMEOUT)["tokens"]) == 2
        later = eng.submit([4, 5], max_new_tokens=3)
        assert len(later.result(timeout=TIMEOUT)["tokens"]) == 3


@pytest.mark.parametrize("paged", (False, True), ids=("dense", "paged"))
def test_decode_failure_in_prefill_reaches_the_batch_being_admitted(
        decode_model, monkeypatch, paged):
    """A prefill that raises closes the engine; every client, the batch
    being seated included, gets the error instead of waiting forever."""
    eng = tdecode.DecodeEngine(decode_model, max_batch=4, paged=paged,
                               auto_start=False, name=f"t_abort_{paged}")

    def fail(*args, **kwargs):
        raise RuntimeError("prefill failed")

    monkeypatch.setattr(eng, "_paged_prefill" if paged else "_prefill", fail)
    futs = [eng.submit(p, max_new_tokens=2) for p in ([1, 2], [3], [4, 5])]
    eng.start()
    for f in futs:
        with pytest.raises(RuntimeError, match="prefill failed"):
            f.result(timeout=TIMEOUT)
    eng.close()


# -- 2. ServingEngine: one bad id in a batch ----------------------------------
def test_served_batch_keeps_its_good_requests_when_one_id_is_bad():
    t_reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.data("ids", [-1, 3], dtype="int64")
        emb = TL.embedding(ids, size=[10, 4])
        out = TL.sequence_pool(emb, "sum")
    scope = tfluid.Scope()
    exe = tfluid.Executor(HOST)
    exe.run(startup, scope=scope)
    frozen = freeze_program(main, ["ids"], [out], scope=scope)
    good = [np.array([[1, 2, 3]], "int64"), np.array([[4, 5, 9]], "int64")]
    with ServingEngine(frozen, executor=exe, scope=scope, max_batch=8,
                       max_wait_us=200_000) as eng:
        first = eng.submit({"ids": good[0]})
        with pytest.raises(ValueError, match="outside its table"):
            eng.submit({"ids": np.array([[0, 99, 1]], "int64")})
        with pytest.raises(ValueError, match="outside its table"):
            eng.submit({"ids": np.array([[-1, 0, 1]], "int64")})
        second = eng.submit({"ids": good[1]})
        answers = [f.result(timeout=TIMEOUT)[out.name]
                   for f in (first, second)]
        assert eng.dispatch_errors == 0
    w = scope.find_var(main.all_parameters()[0].name).numpy()
    for got, req in zip(answers, good):
        np.testing.assert_allclose(got, w[req].sum(axis=1), rtol=1e-6)


# -- 3. the builders train by default -----------------------------------------
def _op_types(program):
    return [op.type for op in program.global_block().ops]


@pytest.mark.parametrize("which", ("bert", "ctr"))
def test_builders_train_by_default_as_the_reference_does(which):
    j_build, t_build = {"bert": (j_bert, t_bert),
                        "ctr": (j_ctr, t_ctr)}[which]
    j_reset()
    t_reset()
    j_main, _, j_loss = j_build()
    t_main, _, t_loss = t_build()
    assert _op_types(t_main) == _op_types(j_main)
    assert t_loss.name == j_loss.name
    assert "adam" in _op_types(t_main)
    t_reset()
    served, _, logits = t_build(train=False)
    assert "adam" not in _op_types(served)
    assert logits.name != t_loss.name


# -- 4. a float64 feed ---------------------------------------------------------
def test_float64_feed_computes_in_the_declared_float32():
    t_reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 4])
        y = TL.fc(x, 3)
    scope = tfluid.Scope()
    exe = tfluid.Executor(HOST)
    exe.run(startup, scope=scope)
    x64 = np.random.RandomState(0).randn(5, 4)
    got = exe.run(main, feed={"x": x64}, fetch_list=[y], scope=scope)[0]
    want = exe.run(main, feed={"x": x64.astype("float32")}, fetch_list=[y],
                   scope=scope)[0]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# -- 5. integer means ----------------------------------------------------------
@pytest.mark.parametrize("op_type,attrs", [
    ("mean", {}), ("reduce_mean", {"dim": [1], "keep_dim": False}),
    ("reduce_mean", {"reduce_all": True})])
def test_integer_mean_is_the_float_mean(op_type, attrs):
    x = np.array([[1, 2, 4], [3, 5, 8]], "int64")
    want = np.asarray(jreg.get_op(op_type).fn(
        {"X": [jnp.asarray(x)]}, dict(attrs),
        jreg.LoweringContext())["Out"][0])
    got = treg.get_op(op_type).fn({"X": [torch.from_numpy(x)]}, dict(attrs),
                                  treg.LoweringContext())["Out"][0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# -- the kernel build hash and the flash wrappers' alignment rule ----------
def test_kernel_library_path_follows_the_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(cuda_kernels, "CSRC_DIR", tmp_path)
    first = cuda_kernels._lib_path("k")
    assert cuda_kernels._lib_path("k") == first
    header.write_text("// v2\n")
    assert cuda_kernels._lib_path("k") != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert len({first, cuda_kernels._lib_path("k")}) == 2
    assert cuda_kernels.sources() == ["k"]


def test_flash_inputs_that_16_byte_copies_cannot_read_are_copied():
    def permuted(t, d, dtype):   # the [B,H,T,D] views transpose2 leaves
        return torch.zeros(2, t, 3, d, dtype=dtype).permute(0, 2, 1, 3)

    aligned = [permuted(5, 64, torch.float32), permuted(7, 8, torch.bfloat16),
               torch.zeros(2, 3, 5, 40, dtype=torch.bfloat16)]
    assert all(cuda_kernels._aligned16(t) for t in aligned)
    flat = torch.zeros(2 * 3 * 5 * 64 + 1)
    shifted = flat[1:].view(2, 3, 5, 64)           # base off by 4 bytes
    packed = torch.zeros(2, 5, 3 * 64 + 2)[..., :192].reshape(2, 5, 3, 64) \
        .permute(0, 2, 1, 3)                         # a T stride of 194
    assert not cuda_kernels._aligned16(shifted)
    assert not cuda_kernels._aligned16(packed)

    class Counted:
        copies = 0

    out = cuda_kernels._aligned_inputs(Counted, aligned[:1] + [shifted,
                                                                packed])
    assert Counted.copies == 2
    assert out[0] is aligned[0]
    for got, want in zip(out[1:], (shifted, packed)):
        assert cuda_kernels._aligned16(got) and torch.equal(got, want)


def test_dygraph_adam_minimize_moves_the_weights_as_the_reference():
    """``AdamOptimizer(parameter_list=...).minimize(loss)`` under a
    dygraph guard: the port once went to ``loss.block.program`` and
    raised ``AttributeError: 'VarBase' object has no attribute 'block'``;
    the reference takes its dygraph branch and moves the weights.  One
    step on a Linear layer from the reference's weights: the weights and
    both moments within rtol 1e-5."""
    x = np.random.RandomState(4).randn(6, 5).astype("float32")
    with jdy.guard():
        j_layer = jnn.Linear(5, 3)
        state = j_layer.state_dict()
        opt = jopt.AdamOptimizer(0.01, parameter_list=j_layer.parameters())
        opt.minimize(JL.nn.mean(j_layer(jdy.to_variable(jnp.asarray(x)))))
        want = j_layer.state_dict()
        want_m = {n: np.asarray(v._value) for n, v in
                  opt._accumulators["moment1"].items()}
    with tdy.guard(HOST):
        t_layer = tnn.Linear(5, 3)
        interop.layer_from_numpy(t_layer, state)
        opt = tfluid.optimizer.AdamOptimizer(
            0.01, parameter_list=t_layer.parameters())
        opt.minimize(TL.nn.mean(t_layer(tdy.to_variable(x))))
        got = t_layer.state_dict()
        got_m = {n: v.numpy() for n, v in
                 opt._accumulators["moment1"].items()}
    for name in state:
        assert not np.allclose(got[name], state[name])
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-7)
    for g, w in zip(got_m.values(), want_m.values()):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-8)


# -- 6. BuildStrategy's pass knobs ----------------------------------------------
def _bench_ctr_ops_after_passes(fluid, reset, embed, run_place=None):
    """bench.py:571-589's CTR program (6 slots, dim 8) through
    ``fuse_elewise_add_act_ops`` + ``constant_folding``: the op count of
    one step.  ``embed`` is "box" (``pull_box_sparse``, as the bench
    builds it) or "dense" (an ``embedding`` table in its place).  With
    ``run_place``, (the count of the executor's run plan after one step,
    its ``ops_per_step`` gauge); without, the pruned program's count after
    the passes."""
    from paddle_tpu_torch.fluid import trace as ttrace
    reset()
    slots, dim = 6, 8
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.data("ids", [-1, slots], dtype="int64")
        dense = fluid.data("dense", [-1, 13])
        label = fluid.data("label", [-1, 1])
        if embed == "box":
            emb = fluid.layers.pull_box_sparse(ids, dim,
                                               table_name="faults_box")
        else:
            emb = fluid.layers.embedding(ids, [64, dim])
        flat = fluid.layers.reshape(emb, [-1, slots * dim])
        deep = fluid.layers.concat([flat, dense], axis=1)
        h = fluid.layers.fc(deep, 256, act="relu")
        h = fluid.layers.fc(h, 128, act="relu")
        wide = fluid.layers.fc(dense, 1)
        logit = fluid.layers.fc(h, 1) + wide
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))
        fluid.optimizer.SGDOptimizer(0.01).minimize(loss)
    bs = fluid.BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    bs.constant_folding = True
    prog = fluid.CompiledProgram(main, build_strategy=bs)
    if run_place is None:
        from paddle_tpu.fluid.framework import prune_ops
        prog._apply_ir_passes([loss.name])
        gb = main.global_block()
        return len(prune_ops(gb, list(gb.ops), targets=[loss.name],
                             keep_state_writes=True))
    scope = fluid.Scope()
    exe = fluid.Executor(run_place)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    if embed == "box":
        scope.set_var("faults_box@HBMCACHE",
                      rng.randn(64, dim).astype("float32"))
    exe.run(prog, feed={"ids": rng.randint(0, 64, (4, slots)),
                        "dense": rng.randn(4, 13).astype("float32"),
                        "label": np.ones((4, 1), "float32")},
            fetch_list=[loss], scope=scope)
    return (len(next(reversed(exe._plans.values())).run_ops),
            int(ttrace.metrics().gauge("executor.ops_per_step").value))


@pytest.mark.parametrize("embed", ("box", "dense"))
def test_build_strategy_runs_the_reference_passes(embed):
    """bench.py sets ``fuse_elewise_add_act_ops`` and ``constant_folding``
    on its CTR program; the reference runs both passes and its step has
    38 ops (two ``fused_elemwise_activation`` forwards and two fused grad
    pairs out of 42).  The port's BuildStrategy once lacked both knobs,
    took the assignments silently and ran all 42 ops.  Now it selects the
    reference's passes in the reference's order, and the knobs whose
    passes are not ported raise instead of being dropped."""
    want = _bench_ctr_ops_after_passes(jfluid, j_reset, embed)
    got, gauge = _bench_ctr_ops_after_passes(tfluid, t_reset, embed, HOST)
    assert got == want == 38
    assert gauge == got
    for knob in ("fuse_all_reduce_ops", "sharding", "auto_tune"):
        bs = tfluid.BuildStrategy()
        setattr(bs, knob, True)
        with pytest.raises(NotImplementedError, match=knob):
            tfluid.passes.passes_for_build_strategy(bs)
    bs = tfluid.BuildStrategy()
    bs.memory_optimize = True
    bs.amp = True
    bs.fuse_bn_act_ops = True
    bs.fuse_all_optimizer_ops = True
    names = [p.name for p in tfluid.passes.passes_for_build_strategy(bs)]
    assert names == ["constant_fold", "fuse_bn_act", "fuse_optimizer",
                     "prune_identity", "amp_bf16", "prune_redundant_casts",
                     "dce"]


_W_FC = np.random.RandomState(1).randn(4, 5).astype("float32")
_B_FC = np.random.RandomState(2).randn(5).astype("float32")
_W_EMB = np.random.RandomState(3).randn(10, 4).astype("float32")
_IDS = np.random.RandomState(4).randint(0, 10, (3, 2)).astype("int64")


def _attr(M, value):
    """Parameters carried across as values (the packages' initializers
    draw different numbers from one seed)."""
    return M.ParamAttr(initializer=M.NumpyArrayInitializer(value))


DYGRAPH_LAYER_CASES = {
    "concat": lambda M, a, b: M.layers.concat([a, b], axis=1),
    "sigmoid_cross_entropy_with_logits":
        lambda M, a, b: M.layers.sigmoid_cross_entropy_with_logits(
            a, b * 0 + 1),
    "fc": lambda M, a, b: M.layers.fc(a, 5, param_attr=_attr(M, _W_FC),
                                      bias_attr=_attr(M, _B_FC)),
    "embedding": lambda M, a, b: M.layers.embedding(
        M.to_variable(_IDS), [10, 4], param_attr=_attr(M, _W_EMB)),
    "fill_constant": lambda M, a, b: M.layers.fill_constant(
        [3, 4], "float32", 2.5),
    "sequence_pool": lambda M, a, b: M.layers.sequence_pool(
        M.layers.reshape(a, [3, 2, 2]), "sum"),
}


def _package(fluid, layers, dygraph):
    import types
    from importlib import import_module
    init = import_module(fluid.__name__ + ".initializer")
    return types.SimpleNamespace(
        layers=layers, ParamAttr=fluid.ParamAttr,
        NumpyArrayInitializer=init.NumpyArrayInitializer,
        to_variable=dygraph.to_variable)


@pytest.mark.parametrize("case", sorted(DYGRAPH_LAYER_CASES))
def test_dygraph_layer_returns_its_output_as_the_reference(case):
    """``fluid.layers.concat`` and ``sigmoid_cross_entropy_with_logits``
    returned the static output, None, under a dygraph tracer; WideDeep,
    DeepFM and SkipGram call both eagerly.  ``fc`` (whose product must
    also be the traced one its bias adds to), ``embedding``,
    ``fill_constant`` (the traced VarBase, stop_gradient set) and
    ``sequence_pool`` dropped the traced output the same way."""
    rng = np.random.RandomState(0)
    a, b = (rng.randn(3, 4).astype("float32") for _ in range(2))
    with jdy.guard():
        jm = _package(jfluid, JL, jdy)
        out = DYGRAPH_LAYER_CASES[case](jm, jdy.to_variable(a),
                                        jdy.to_variable(b))
        want, want_sg = np.asarray(out.numpy()), out.stop_gradient
    with tdy.guard(tfluid.CPUPlace()):
        tm = _package(tfluid, TL, tdy)
        got = DYGRAPH_LAYER_CASES[case](tm, tdy.to_variable(a),
                                        tdy.to_variable(b))
        assert got is not None
        assert got.stop_gradient == want_sg
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("op", ["matmul", "matmul_v2", "mul"])
def test_mixed_dtype_products_promote_as_the_reference(op):
    """A float32 activation times a bfloat16 parameter (a multi-precision
    program's ``matmul``): the reference promotes the operands and casts
    the product to the activation's dtype; the port raised."""
    import jax.numpy as jnp
    import torch
    from paddle_tpu.ops.registry import get_op as j_get_op
    from paddle_tpu_torch.ops.registry import get_op as t_get_op
    from paddle_tpu_torch.ops.registry import LoweringContext
    rng = np.random.RandomState(0)
    x = rng.randn(3, 4).astype("float32")
    w = rng.randn(4, 5).astype("float32")
    w_bf16 = torch.from_numpy(w).to(torch.bfloat16)
    got = t_get_op(op).fn({"X": [torch.from_numpy(x)], "Y": [w_bf16]}, {},
                          LoweringContext())["Out"][0]
    want = j_get_op(op).fn({"X": [jnp.asarray(x)],
                            "Y": [jnp.asarray(w_bf16.float().numpy(),
                                              jnp.bfloat16)]}, {},
                           None)["Out"][0]
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
