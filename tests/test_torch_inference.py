"""The inference deployment path in paddle_tpu_torch against paddle_tpu.

Every case of ``tests/test_inference.py`` on the port, on the host
(``AnalysisConfig.disable_gpu()``, ``load_aot_model(..., CPUPlace())``),
with the reference's tolerances: the predictor against the training
program's forward (rtol 1e-5), ``ir_optim`` on against off (rtol 1e-6),
bf16 weights against float32 (rtol 0.05, atol 0.05), the pool, the
``torch.export`` artifact (rtol 1e-5) and its refusal of a missing feed.
The reference's framework-free consumer (``examples/aot_serve.py`` in a
process without the framework) becomes a consumer that runs with the op
registry and the executor taken away: a ``torch.export.load`` of graphs
that hold the port's dispatcher ops needs the ops registered first (a gap
kept on purpose, ROADMAP queue C).

Then the two packages side by side from one set of weights: the 2-layer
BERT program after ``fuse_attention`` and the CTR program after
``fuse_sparse_embedding``, saved by either package and served by the
other's ``AnalysisPredictor`` and by the port's artifact, within fp32
rtol 1e-5 and atol 1e-6; the exported graphs hold
``paddle_tpu_torch::flash_attention_fwd`` and
``paddle_tpu_torch::embedding_pool_fwd``.  ``ServingEngine`` over an
``AotPredictor``: mixed request sizes, each answer equal to one artifact
call on its rows, and a batch reduction whose padded rows the bucket
programs leave out.  The refusals: a ``params_file`` outside
``model_dir``, a pickled ``__model__``, a missing feed, a batch over the
largest edge, and the default config and ``load_aot_model`` where torch
sees no card.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.inference import (AnalysisConfig, create_predictor,
                                        load_aot_model, save_aot_model)
from paddle_tpu_torch.inference.predictor import (PrecisionType,
                                                  PredictorPool)
from paddle_tpu_torch.serving import ServingEngine

fluid = tfluid
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def fresh_port_programs():
    prev = (tframework._main_program, tframework._startup_program,
            tcore._global_scope)
    tframework._main_program = tframework.Program()
    tframework._startup_program = tframework.Program()
    tcore._global_scope = tcore.Scope()
    tframework.reset_unique_name()
    yield
    (tframework._main_program, tframework._startup_program,
     tcore._global_scope) = prev


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _host_config(model_dir, **kw):
    cfg = AnalysisConfig(model_dir, **kw)
    cfg.disable_gpu()
    return cfg


def _serve(p, feed):
    for n in p.get_input_names():
        p.get_input_handle(n).copy_from_cpu(feed[n])
    p.run()
    return p.get_output_handle(p.get_output_names()[0]).copy_to_cpu()


def _train_and_export(tmp_path, rng):
    x = fluid.data("x", [-1, 8])
    y = fluid.data("y", [-1, 1])
    h = fluid.layers.fc(x, 16, act="relu")
    pred = fluid.layers.fc(h, 1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    xs = rng.randn(32, 8).astype("float32")
    ys = (xs.sum(1, keepdims=True) * 0.3).astype("float32")
    for _ in range(5):
        exe.run(feed={"x": xs, "y": ys}, fetch_list=[loss])
    model_dir = str(tmp_path / "model")
    fluid.io.save_inference_model(model_dir, ["x"], [pred], exe)
    ref, = exe.run(fluid.default_main_program().clone(for_test=True),
                   feed={"x": xs[:4]}, fetch_list=[pred])
    return model_dir, xs[:4], ref


# ---------------------------------------------------------------------------
# tests/test_inference.py, on the port
# ---------------------------------------------------------------------------

class TestAnalysisPredictor:
    def test_matches_training_forward(self, tmp_path, rng):
        model_dir, xs, ref = _train_and_export(tmp_path, rng)
        out = _serve(create_predictor(_host_config(model_dir)), {"x": xs})
        np.testing.assert_allclose(out, ref, rtol=1e-5)

    def test_ir_optim_switch_controls_pruning(self, tmp_path, rng):
        model_dir, xs, ref = _train_and_export(tmp_path, rng)

        def run_with(ir_optim):
            cfg = _host_config(model_dir)
            cfg.switch_ir_optim(ir_optim)
            p = create_predictor(cfg)
            return p, _serve(p, {"x": xs})

        p_opt, o1 = run_with(True)
        p_raw, o2 = run_with(False)
        assert p_opt.compiled_op_count() <= p_raw.compiled_op_count()
        np.testing.assert_allclose(o1, o2, rtol=1e-6)

    def test_bf16_precision(self, tmp_path, rng):
        model_dir, xs, ref = _train_and_export(tmp_path, rng)
        cfg = _host_config(model_dir)
        cfg.enable_tensorrt_engine(precision_mode=PrecisionType.Half)
        assert cfg.precision() == PrecisionType.Bfloat16
        p = create_predictor(cfg)
        out = _serve(p, {"x": xs})
        # bf16 weights: looser tolerance, but clearly the same function
        np.testing.assert_allclose(np.asarray(out, np.float32), ref,
                                   rtol=0.05, atol=0.05)
        w = tcore.global_scope().find_var(
            p._program.global_block().all_parameters()[0].name)
        assert w.dtype == torch.bfloat16

    def test_predictor_pool(self, tmp_path, rng):
        model_dir, xs, ref = _train_and_export(tmp_path, rng)
        pool = PredictorPool(_host_config(model_dir), size=2)
        for i in range(2):
            out = _serve(pool.retrieve(i), {"x": xs})
            np.testing.assert_allclose(out, ref, rtol=1e-5)

    def test_profile_traces_the_run(self, tmp_path, rng):
        model_dir, xs, ref = _train_and_export(tmp_path, rng)
        cfg = _host_config(model_dir)
        cfg.enable_profile()
        p = create_predictor(cfg)
        np.testing.assert_allclose(_serve(p, {"x": xs}), ref, rtol=1e-5)
        names = {e.key for e in p._last_profile.key_averages()}
        assert any("matmul" in n or "mm" in n for n in names), names


class TestAotExport:
    def test_save_load_roundtrip_matches(self, tmp_path, rng):
        model_dir, xs, ref = _train_and_export(tmp_path, rng)
        p = create_predictor(_host_config(model_dir))
        aot_dir = str(tmp_path / "aot")
        meta = save_aot_model(aot_dir, p, {"x": xs})
        assert meta["feed_names"] == ["x"]
        assert os.path.exists(os.path.join(aot_dir, "model.pt2"))
        served = load_aot_model(aot_dir, fluid.CPUPlace())
        assert served.get_input_names() == ["x"]
        got = served({"x": xs})[served.get_output_names()[0]]
        np.testing.assert_allclose(got, ref, rtol=1e-5)

    def test_consumer_needs_no_program_or_registry(self, tmp_path, rng,
                                                   monkeypatch):
        """Serving the artifact builds no Program, looks up no op in the
        registry and runs no executor."""
        model_dir, xs, ref = _train_and_export(tmp_path, rng)
        p = create_predictor(_host_config(model_dir))
        aot_dir = str(tmp_path / "aot_ext")
        save_aot_model(aot_dir, p, {"x": xs}, bucket_edges=[2, 8])

        def refuse(*a, **k):
            raise AssertionError("the AOT consumer reached the framework")

        from paddle_tpu_torch.fluid import executor
        from paddle_tpu_torch.ops import registry
        monkeypatch.setattr(registry, "get_op", refuse)
        monkeypatch.setattr(executor, "run_block_ops", refuse)
        monkeypatch.setattr(tframework.Program, "__init__", refuse)
        served = load_aot_model(aot_dir, fluid.CPUPlace())
        for n in (1, 3, 4):
            got = served({"x": xs[:n]})[p.get_output_names()[0]]
            np.testing.assert_allclose(got, ref[:n], rtol=1e-5)

    def test_missing_feed_rejected(self, tmp_path, rng):
        model_dir, xs, _ = _train_and_export(tmp_path, rng)
        p = create_predictor(_host_config(model_dir))
        with pytest.raises(ValueError, match="missing inputs"):
            save_aot_model(str(tmp_path / "aot2"), p, {})


# ---------------------------------------------------------------------------
# both packages from one set of weights
# ---------------------------------------------------------------------------

def _build(pkg, kind):
    from importlib import import_module
    mod = import_module(pkg.__name__.split(".")[0] + ".models.static_graphs")
    if kind == "bert":
        main, startup, _ = mod.build_bert_train_program(layers=2)
        feeds, flag = ["ids", "attn_mask"], "fuse_attention"
    else:
        main, startup, _ = mod.build_ctr_train_program()
        feeds = ["dense"] + [f"ids_{i}" for i in range(4)]
        flag = "fuse_sparse_embedding"
    op = [o for o in main.global_block().ops
          if o.type in ("softmax_with_cross_entropy",
                        "sigmoid_cross_entropy_with_logits")][0]
    fetch = op.input("Logits" if "Logits" in op.inputs else "X")[0]
    return main, startup, feeds, fetch, flag


def _feed(kind, rng, rows):
    if kind == "bert":
        return {"ids": rng.randint(0, 64, (rows, 16)).astype("int64"),
                "attn_mask": (np.arange(16)[None, :]
                              < rng.randint(1, 17, (rows, 1)))
                .astype("float32")}
    feed = {"dense": rng.randn(rows, 13).astype("float32")}
    for i in range(4):
        feed[f"ids_{i}"] = rng.randint(0, 128, (rows, 5)).astype("int64")
    return feed


def _export_reference(kind, d, rng):
    """The reference's kernel-tier program frozen, saved with a combined
    params file; returns (its startup weights, the reference predictor's
    answer to a 5-row feed, the feed)."""
    from paddle_tpu.fluid import core as jcore
    from paddle_tpu.inference import AnalysisConfig as JConfig, \
        create_predictor as jcreate
    from paddle_tpu.serving import freeze_program as jfreeze
    main, startup, feeds, fetch, flag = _build(jfluid, kind)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup)
    frozen = jfreeze(main, feeds, [fetch])
    bs = jfluid.BuildStrategy()
    setattr(bs, flag, True)
    jfluid.CompiledProgram(frozen, bs)._apply_ir_passes([fetch])
    jfluid.io.save_inference_model(d, feeds, [main.global_block().var(fetch)],
                                   exe, main_program=frozen,
                                   params_filename="params")
    feed = _feed(kind, rng, 5)
    cfg = JConfig(d, params_file="params")
    cfg.disable_gpu()
    jp = jcreate(cfg)
    for n in jp.get_input_names():
        jp.get_input_handle(n).copy_from_cpu(feed[n])
    jp.run()
    want = np.asarray(jp.get_output_handle(
        jp.get_output_names()[0]).copy_to_cpu())
    weights = {n: np.asarray(jcore.global_scope().find_var(n))
               for n in (p.name for p in main.all_parameters())}
    return weights, want, feed


@pytest.mark.parametrize("kind", ["bert", "ctr"])
def test_reference_export_served_by_port(kind, tmp_path, rng):
    d = str(tmp_path / "ref")
    _, want, feed = _export_reference(kind, d, rng)
    p = create_predictor(_host_config(d, params_file="params"))
    types = [o.type for o in p._program.global_block().ops]
    op = "fused_multihead_attention" if kind == "bert" \
        else "fused_embedding_pool"
    assert types.count(op) == (2 if kind == "bert" else 4)
    got = _serve(p, feed)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    aot_dir = str(tmp_path / "aot")
    save_aot_model(aot_dir, p, feed, bucket_edges=[1, 8])
    served = load_aot_model(aot_dir, fluid.CPUPlace())
    np.testing.assert_allclose(served(feed)[p.get_output_names()[0]], got,
                               rtol=RTOL, atol=ATOL)
    target = "flash_attention_fwd" if kind == "bert" \
        else "embedding_pool_fwd"
    for f in ("model.pt2", "model.b1.pt2", "model.b8.pt2"):
        ep = torch.export.load(os.path.join(aot_dir, f))
        # the weights are stored once, in weights.pt: no program carries
        # them as its example inputs
        assert ep.example_inputs is None
        held = [str(n.target) for n in ep.graph.nodes
                if n.op == "call_function"]
        assert held.count(f"paddle_tpu_torch.{target}.default") \
            == (2 if kind == "bert" else 4), f


@pytest.mark.parametrize("kind", ["bert", "ctr"])
def test_port_export_served_by_reference(kind, tmp_path, rng):
    from paddle_tpu.inference import AnalysisConfig as JConfig, \
        create_predictor as jcreate
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.serving import freeze_program
    weights, _, feed = _export_reference(kind, str(tmp_path / "ref"), rng)
    main, startup, feeds, fetch, flag = _build(tfluid, kind)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    interop.scope_from_numpy(weights, tcore.global_scope(), fluid.CPUPlace())
    frozen = freeze_program(main, feeds, [fetch])
    bs = fluid.BuildStrategy()
    setattr(bs, flag, True)
    (want,) = exe.run(fluid.CompiledProgram(frozen, bs), feed=feed,
                      fetch_list=[fetch])
    d = str(tmp_path / "port")
    fluid.io.save_inference_model(d, feeds, [main.global_block().var(fetch)],
                                  exe, main_program=frozen,
                                  params_filename="params")
    cfg = JConfig(d, params_file="params")
    cfg.disable_gpu()
    jp = jcreate(cfg)
    for n in jp.get_input_names():
        jp.get_input_handle(n).copy_from_cpu(feed[n])
    jp.run()
    got = np.asarray(jp.get_output_handle(
        jp.get_output_names()[0]).copy_to_cpu())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# ServingEngine over an AotPredictor
# ---------------------------------------------------------------------------

def _centred_model(tmp_path):
    """fc(x) less its batch mean: the padded rows of a bucket must stay
    out of the mean."""
    x = fluid.data("x", [-1, 6])
    h = fluid.layers.fc(x, 4)
    out = h - fluid.layers.reduce_mean(h, dim=0, keep_dim=True)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    d = str(tmp_path / "centred")
    fluid.io.save_inference_model(d, ["x"], [out], exe)
    return d, out.name


def test_engine_masks_padded_rows(tmp_path, rng):
    """Through the artifact and through the engine over it, a request of
    3 or 5 rows rides the 4- or 8-row program and answers as the
    predictor does on its rows alone; the same rows with zero rows in
    place of the padding answer otherwise."""
    d, name = _centred_model(tmp_path)
    cfg = _host_config(d)
    cfg.switch_shape_bucketing(False)
    p = create_predictor(cfg)
    xs = rng.randn(8, 6).astype("float32")
    aot_dir = str(tmp_path / "aot")
    save_aot_model(aot_dir, p, {"x": xs[:4]}, bucket_edges=[1, 4, 8])
    served = load_aot_model(aot_dir, fluid.CPUPlace())
    with ServingEngine(served, max_batch=64) as eng:
        assert eng.bucket_edges == (1, 4, 8) and eng.max_batch == 8
        assert eng.warmup()["buckets"] == [1, 4, 8]
        for n in (3, 5):
            want = _serve(p, {"x": xs[:n]})
            np.testing.assert_allclose(served({"x": xs[:n]})[name], want,
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(eng.infer({"x": xs[:n]}, 60)[name],
                                       want, rtol=RTOL, atol=ATOL)
            padded = np.concatenate([xs[:n], np.zeros((8 - n, 6),
                                                      "float32")])
            assert not np.allclose(_serve(p, {"x": padded})[:n], want,
                                   rtol=RTOL, atol=ATOL)


def test_engine_answers_match_single_calls(tmp_path, rng):
    """A model without batch coupling: every engine answer equals one
    artifact call on that request's rows."""
    model_dir, xs, ref = _train_and_export(tmp_path, rng)
    p = create_predictor(_host_config(model_dir))
    aot_dir = str(tmp_path / "aot")
    save_aot_model(aot_dir, p, {"x": xs}, bucket_edges=[1, 2, 4, 8])
    served = load_aot_model(aot_dir, fluid.CPUPlace())
    name = p.get_output_names()[0]
    reqs = [rng.randn(n, 8).astype("float32") for n in (1, 3, 2, 4, 1, 2)]
    with ServingEngine(served, max_batch=8, max_wait_us=20000) as eng:
        answers = [f.result(timeout=60)[name]
                   for f in [eng.submit({"x": r}) for r in reqs]]
        batches = eng.batches
    assert batches < len(reqs)          # requests were coalesced
    for r, a in zip(reqs, answers):
        np.testing.assert_allclose(a, served({"x": r})[name], rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_params_file_outside_model_dir_refused(tmp_path, rng):
    model_dir, _, _ = _train_and_export(tmp_path, rng)
    with pytest.raises(ValueError, match="outside model_dir"):
        create_predictor(_host_config(
            model_dir, params_file=str(tmp_path / "elsewhere" / "params")))


def test_legacy_pickle_refused_by_predictor(tmp_path):
    import pickle
    d = tmp_path / "legacy"
    d.mkdir()
    with open(d / "__model__", "wb") as f:
        pickle.dump({"not": "a model"}, f)
    with pytest.raises(RuntimeError, match="pickle"):
        create_predictor(_host_config(str(d)))


def test_missing_feed_and_oversized_batch_refused(tmp_path, rng):
    model_dir, xs, _ = _train_and_export(tmp_path, rng)
    p = create_predictor(_host_config(model_dir))
    aot_dir = str(tmp_path / "aot")
    save_aot_model(aot_dir, p, {"x": xs}, bucket_edges=[2, 4])
    served = load_aot_model(aot_dir, fluid.CPUPlace())
    with pytest.raises(ValueError, match="missing inputs"):
        served({})
    big = np.zeros((5, 8), "float32")
    with pytest.raises(ValueError, match="exceed the largest"):
        served({"x": big})
    single = str(tmp_path / "single")
    save_aot_model(single, p, {"x": xs})
    with pytest.raises(ValueError, match="batch size 4 only"):
        load_aot_model(single, fluid.CPUPlace())({"x": xs[:3]})


def test_default_config_and_artifact_need_the_card(tmp_path, rng, no_cuda):
    model_dir, xs, ref = _train_and_export(tmp_path, rng)
    assert AnalysisConfig(model_dir).use_gpu()
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        create_predictor(AnalysisConfig(model_dir))
    p = create_predictor(_host_config(model_dir))
    np.testing.assert_allclose(_serve(p, {"x": xs}), ref, rtol=1e-5)
    aot_dir = str(tmp_path / "aot")
    save_aot_model(aot_dir, p, {"x": xs})
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        load_aot_model(aot_dir)
    assert load_aot_model(aot_dir, fluid.CPUPlace()).device.type == "cpu"


def test_embedding_pool_dispatcher_op_on_the_host(rng):
    """The gather-pool's dispatcher op: its host implementation is the
    plain version, its fake gives the shape, and the lowering takes it
    with grad off only."""
    from paddle_tpu_torch.ops import ctr_ops
    w = torch.from_numpy(rng.randn(50, 8).astype("float32"))
    ids = torch.from_numpy(rng.randint(0, 50, (6, 5)))
    wgt = torch.from_numpy(rng.rand(6, 5).astype("float32"))
    for g, pad in ((None, -1), (wgt, 3)):
        assert torch.equal(ctr_ops.embedding_pool_fwd_op(w, ids, g, pad),
                           ctr_ops._reference_embedding_pool(w, ids, g, pad))
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        out = ctr_ops.embedding_pool_fwd_op(mode.from_tensor(w),
                                            mode.from_tensor(ids), None, -1)
    assert tuple(out.shape) == (6, 8)
    from paddle_tpu_torch.ops.registry import LoweringContext
    seen = []
    real = ctr_ops.embedding_pool_fwd_op
    try:
        ctr_ops.embedding_pool_fwd_op = lambda *a: seen.append(1) or real(*a)
        ins = {"W": [w], "Ids": [ids]}
        with torch.no_grad():
            ctr_ops._fused_embedding_pool(ins, {}, LoweringContext())
        ctr_ops._fused_embedding_pool(ins, {}, LoweringContext())
    finally:
        ctr_ops.embedding_pool_fwd_op = real
    assert seen == [1]
