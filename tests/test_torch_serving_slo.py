"""The serving engine's SLO surface in paddle_tpu_torch, on the CPU.

Twins of the reference's ``tests/test_serving.py`` cases
``test_queue_full_rejects``, ``test_deadline_timeout_under_overload``,
``test_slo_instruments_populated`` and ``test_serving_batch_trace_span``,
run on the port's engine over a small frozen MLP on ``CPUPlace()``; and
the rest of the surface: ``pause`` / ``resume``, named engines and their
``serving.<name>.*`` instruments, ``exception()`` and ``trace_id``, the
async window (``max_inflight=2`` answers equal ``max_inflight=1``'s bit
for bit, and an idle engine reads ``executor.inflight_steps == 0``), and
the refusals of what waits for later items.  The reference's own engine
answers the same requests on the same weights within 1e-5.
"""
import time

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import serving as jserving

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop, serving
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import trace

HOST = tfluid.CPUPlace()
ROWS = (1, 3, 5, 2, 8, 4, 7, 6, 1, 2, 3)


@pytest.fixture(autouse=True)
def _clean():
    tframework.reset_unique_name()
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _mlp(fluid, features=16, classes=10):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, features])
        h = fluid.layers.fc(x, 32, act="relu")
        logits = fluid.layers.fc(h, classes)
    return main, startup, logits


def _weights(main, seed=0):
    rng = np.random.RandomState(seed)
    return {p.name: (rng.randn(*p.shape) * 0.3).astype("float32")
            for p in main.all_parameters()}


def _engine(name=None, seed=0, **kw):
    """A port engine over the frozen MLP; returns (engine, executor,
    frozen program, scope, logits name, the weights)."""
    main, _, logits = _mlp(tfluid)
    params = _weights(main, seed)
    scope = interop.scope_from_numpy(params, tfluid.Scope(), HOST)
    frozen = serving.freeze_program(main, ["x"], [logits], scope=scope)
    exe = tfluid.Executor(HOST)
    kw.setdefault("max_batch", 16)
    kw.setdefault("max_wait_us", 2000)
    eng = serving.ServingEngine(frozen, executor=exe, scope=scope, name=name,
                                **kw)
    return eng, exe, frozen, scope, logits.name, params


def _xs(n=32, seed=1):
    return np.random.RandomState(seed).randn(n, 16).astype("float32")


# ---------------------------------------------------------------------------
# twins of tests/test_serving.py
# ---------------------------------------------------------------------------

def test_queue_full_rejects():
    eng, _, _, _, logits, _ = _engine(queue_depth=2, auto_start=False)
    xs = _xs()
    m = trace.metrics()
    rej0 = m.counter("serving.rejected").value
    accepted = []
    with pytest.raises(serving.QueueFullError):
        for _ in range(5):
            accepted.append(eng.submit({"x": xs[:2]}))
    assert len(accepted) == 2
    assert m.counter("serving.rejected").value == rej0 + 1
    assert eng.stats()["rejected"] == 1
    eng.start()
    for f in accepted:
        assert f.result(timeout=60)[logits].shape[0] == 2
    eng.close()
    with pytest.raises(serving.EngineClosedError):
        eng.submit({"x": xs[:2]})


def test_deadline_timeout_under_overload():
    """A request whose deadline elapses while queued is rejected with
    DeadlineExceededError and counted in serving.timeouts."""
    eng, _, _, _, _, _ = _engine(auto_start=False, default_deadline_ms=5)
    xs = _xs()
    m = trace.metrics()
    t0 = m.counter("serving.timeouts").value
    futs = [eng.submit({"x": xs[:2]}) for _ in range(4)]
    time.sleep(0.05)                 # deadlines elapse while queued
    eng.start()
    errs = [f.exception(timeout=60) for f in futs]
    eng.close()
    assert all(isinstance(e, serving.DeadlineExceededError)
               for e in errs), errs
    assert m.counter("serving.timeouts").value == t0 + 4
    assert eng.stats()["timeouts"] == 4 and eng.stats()["batches"] == 0


def test_slo_instruments_populated():
    eng, _, _, _, _, _ = _engine()
    xs = _xs()
    with eng:
        eng.warmup()
        for s in (1, 2, 3, 4):
            eng.infer({"x": xs[:s]}, timeout=60)
    st = eng.stats()
    assert st["requests"] == 4 and st["batches"] >= 1
    for h in ("latency_seconds", "queue_seconds", "device_seconds",
              "batch_size"):
        assert st[h]["count"] >= 1, (h, st)
        assert np.isfinite(st[h]["p99"]), (h, st)
    assert st["latency_seconds"]["count"] == 4
    assert st["batch_size"]["count"] == st["batches"]
    # queue + device make up the latency (within histogram slack)
    assert st["latency_seconds"]["avg"] >= \
        st["device_seconds"]["avg"] - 1e-6


def test_serving_batch_trace_span():
    eng, _, _, _, _, _ = _engine()
    xs = _xs()
    tfluid.core.set_flags({"FLAGS_enable_trace": True})
    try:
        with eng:
            eng.infer({"x": xs[:3]}, timeout=60)
        evs = trace.get_events()
        names = [e.get("name") for e in evs]
        assert "serving::batch" in names, names
        batch_ev = [e for e in evs if e.get("name") == "serving::batch"][0]
        assert batch_ev["args"]["rows"] == 3
    finally:
        tfluid.core.set_flags({"FLAGS_enable_trace": False})


# ---------------------------------------------------------------------------
# the rest of the surface
# ---------------------------------------------------------------------------

def test_answers_match_the_reference_engine():
    """The reference's engine and the port's, same weights and requests:
    each request's rows within 1e-5, every request answered once."""
    eng, _, _, _, logits, params = _engine(bucket_edges=[16])
    jmain, _, jlogits = _mlp(jfluid)
    jscope = jfluid.core.Scope()
    for n, v in params.items():
        jscope.set_var(n, v)
    jfrozen = jserving.freeze_program(jmain, ["x"], [jlogits], scope=jscope)
    jeng = jserving.ServingEngine(jfrozen, executor=jfluid.Executor(
        jfluid.CPUPlace()), scope=jscope, max_batch=16, bucket_edges=[16])
    xs = _xs()
    feeds = [{"x": xs[:s] + 0.01 * i} for i, s in enumerate(ROWS)]
    with jeng:
        want = [f.result(timeout=120)[jlogits.name]
                for f in [jeng.submit(f) for f in feeds]]
    with eng:
        got = [f.result(timeout=60)[logits]
               for f in [eng.submit(f) for f in feeds]]
    for g, w, s in zip(got, want, ROWS):
        assert g.shape == (s, 10)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)


def test_max_inflight_two_equals_one_bit_for_bit():
    """The async window changes when the host waits, never what a batch
    computes: the same requests through max_inflight=2 and =1 get the
    same bits, and each through its own sequential run too."""
    outs = []
    for window in (1, 2):
        eng, exe, frozen, scope, logits, _ = _engine(
            name=f"t_window_{window}", max_inflight=window,
            bucket_edges=[16])
        xs = _xs()
        with eng:
            futs = [eng.submit({"x": xs[:s] + 0.01 * i})
                    for i, s in enumerate(ROWS)]
            outs.append([f.result(timeout=60)[logits] for f in futs])
        assert eng._backend.runner.max_inflight == window
        assert trace.metrics().gauge("executor.inflight_steps").value == 0
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
    for i, s in enumerate(ROWS):
        seq, = exe.run(frozen, feed={"x": xs[:s] + 0.01 * i},
                       fetch_list=[logits], scope=scope)
        assert np.array_equal(seq, outs[1][i])


def test_idle_engine_reads_no_inflight_step():
    """After the last answer the collector reaps the window: an idle
    engine's executor.inflight_steps is 0 while the engine still runs."""
    eng, _, _, _, _, _ = _engine(name="t_idle", max_inflight=2)
    xs = _xs()
    with eng:
        for s in (1, 4, 2):
            eng.infer({"x": xs[:s]}, timeout=60)
        assert eng._backend.runner.inflight == 0
        assert trace.metrics().gauge("executor.inflight_steps").value == 0


def test_pause_holds_dispatch_and_resume_releases():
    eng, _, _, _, logits, _ = _engine(name="t_pause", max_wait_us=0)
    xs = _xs()
    with eng:
        eng.pause()
        assert eng.paused() and eng.stats()["paused"]
        futs = [eng.submit({"x": xs[:2]}) for _ in range(3)]
        time.sleep(0.2)
        assert not any(f.done() for f in futs)
        assert eng.stats()["batches"] == 0
        eng.resume()
        assert not eng.paused()
        assert all(f.result(timeout=60)[logits].shape == (2, 10)
                   for f in futs)


def test_deadlines_while_paused_all_time_out():
    """Requests held by a pause past their deadline are rejected when the
    batcher gets to them, whichever of them it had already taken."""
    eng, _, _, _, _, _ = _engine(name="t_paused_deadline", max_wait_us=0)
    xs = _xs()
    with eng:
        eng.pause()
        futs = [eng.submit({"x": xs[:1]}, deadline_ms=50) for _ in range(8)]
        time.sleep(0.15)
        eng.resume()
        errs = [f.exception(timeout=60) for f in futs]
        ok = eng.infer({"x": xs[:1]}, timeout=60)
    assert all(isinstance(e, serving.DeadlineExceededError) for e in errs)
    assert eng.stats()["timeouts"] == 8 and ok
    with pytest.raises(serving.DeadlineExceededError):
        futs[0].result(timeout=0)


def test_pause_after_close_is_a_no_op_and_close_drains_a_paused_engine():
    eng, _, _, _, logits, _ = _engine(name="t_close_paused")
    xs = _xs()
    eng.start()
    eng.pause()
    fut = eng.submit({"x": xs[:2]})
    eng.close()                          # resumes, drains
    assert fut.result(timeout=0)[logits].shape == (2, 10)
    eng.pause()
    assert not eng.paused()


def test_named_engines_keep_their_own_instruments():
    m = trace.metrics()
    agg0 = m.counter("serving.requests").value
    a, _, _, _, _, _ = _engine(name="t_named_a")
    b, _, _, _, _, _ = _engine(name="t_named_b")
    xs = _xs()
    with a, b:
        for s in (1, 2, 3):
            a.infer({"x": xs[:s]}, timeout=60)
        b.infer({"x": xs[:4]}, timeout=60)
    assert a.stats()["requests"] == 3 and b.stats()["requests"] == 1
    assert a.stats()["name"] == "t_named_a"
    assert m.counter("serving.t_named_a.requests").value == 3
    assert m.counter("serving.t_named_b.requests").value == 1
    assert m.counter("serving.requests").value == agg0 + 4
    assert m.histogram("serving.t_named_a.latency_seconds").count == 3
    # unnamed engines read their own counts, not the shared aggregate
    c, _, _, _, _, _ = _engine()
    with c:
        c.infer({"x": xs[:1]}, timeout=60)
    assert c.stats()["requests"] == 1 and c.requests == 1


def test_future_exception_and_trace_id():
    eng, _, _, _, logits, _ = _engine(name="t_ids")
    xs = _xs()
    with eng:
        f1 = eng.submit({"x": xs[:2]})
        f2 = eng.submit({"x": xs[:1]}, trace_id="client-7")
        with trace.trace_context("ambient-3"):
            f3 = eng.submit({"x": xs[:1]})
        assert f1.exception(timeout=60) is None
        assert f1.result(timeout=0)[logits].shape == (2, 10)
    assert f1.trace_id.startswith("req-")
    assert f2.trace_id == "client-7" and f3.trace_id == "ambient-3"
    assert len({f1.trace_id, f2.trace_id, f3.trace_id}) == 3
    assert set(f1.timing) == {"queue_us", "device_us", "latency_us"}
    pending = serving.ServingFuture(1)
    with pytest.raises(TimeoutError):
        pending.exception(timeout=0.01)


def test_mesh_and_auto_tune_are_refused_by_item():
    main, _, logits = _mlp(tfluid)
    frozen = serving.freeze_program(main, ["x"], [logits],
                                    scope=tfluid.Scope())
    with pytest.raises(NotImplementedError, match="item 10"):
        serving.ServingEngine(frozen, executor=tfluid.Executor(HOST),
                              mesh=object())
    with pytest.raises(NotImplementedError, match="item 9"):
        serving.ServingEngine(frozen, executor=tfluid.Executor(HOST),
                              auto_tune=True)


def test_warmup_reports_the_plans_built():
    eng, _, _, _, _, _ = _engine(name="t_warm", max_batch=8)
    report = eng.warmup()
    assert report["buckets"] == [1, 2, 4, 8]
    # the port's run plan does not depend on the batch's shape: one plan
    # serves every bucket, and a second warmup builds none
    assert report["compiles"] == 1
    assert eng.warmup()["compiles"] == 0
    eng.close()
