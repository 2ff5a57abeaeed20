"""The observability plane of paddle_tpu_torch against paddle_tpu's.

Twins of the reference's ``tests/test_observability.py``
(``TestEventStream``, ``TestChromeTraceExport``, ``TestSummaryTable``),
``tests/test_forensics.py`` (``TestTraceIdentity``, ``TestFlightRecorder``,
``TestRequestTracing``) and ``tests/test_metrics_export.py``.  The cases
that need no program run against both packages' modules (``pkg``), so
each holds the port to the reference's behaviour; the executor, serving
and decode cases run the port on ``CPUPlace()``.  The port's exported
timelines are checked by the reference's own ``tools/timeline.py``
validator, and one registry filled by the same calls renders the same
Prometheus text in both packages, line for line.  HTTP servers bind
127.0.0.1 on port 0.
"""
import importlib
import importlib.util
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.fluid import flight_recorder, metrics_export, trace
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid.core import Scope, scope_guard

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = tfluid.CPUPlace()
PACKAGES = ("paddle_tpu", "paddle_tpu_torch")


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.fluid.trace"),
            importlib.import_module(f"{pkg}.fluid.flight_recorder"),
            importlib.import_module(f"{pkg}.fluid.metrics_export"),
            importlib.import_module(f"{pkg}.fluid.core"))


@pytest.fixture(params=PACKAGES)
def pkg(request):
    tr, fr, me, core = _mods(request.param)
    tr.disable()
    tr.reset_all()
    fr.reset()
    yield tr, fr, me, core
    me.stop_http()
    me.stop_snapshots()
    tr.disable()
    tr.reset_all()
    fr.reset()


@pytest.fixture(autouse=True)
def _clean_port():
    tframework.reset_unique_name()
    trace.disable()
    trace.reset_all()
    flight_recorder.reset()
    yield
    metrics_export.stop_http()
    metrics_export.stop_snapshots()
    trace.disable()
    trace.reset_all()
    flight_recorder.reset()


def _timeline_tool():
    spec = importlib.util.spec_from_file_location(
        "timeline", os.path.join(_ROOT, "tools", "timeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the event stream (TestEventStream)
# ---------------------------------------------------------------------------

def test_span_nesting(pkg):
    tr = pkg[0]
    tr.enable()
    with tr.span("outer", cat="annotation"):
        time.sleep(0.002)
        with tr.span("inner", cat="annotation"):
            time.sleep(0.001)
    evs = {e["name"]: e for e in tr.get_events()}
    outer, inner = evs["outer"], evs["inner"]
    assert inner["ts"] >= outer["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert outer["dur"] >= inner["dur"]
    for e in (outer, inner):
        assert e["ph"] == "X" and "pid" in e and "tid" in e


def test_zero_events_when_disabled(pkg):
    tr = pkg[0]
    assert not tr.enabled()
    with tr.span("nope"):
        pass
    assert all(e["name"] != "nope" for e in tr.get_events())


def test_instant_and_counter_events(pkg):
    tr = pkg[0]
    tr.enable()
    tr.instant("marker", cat="compile", args={"k": 1})
    tr.counter_event("queue_depth", 7)
    phs = {e["name"]: e["ph"] for e in tr.get_events()}
    assert phs == {"marker": "i", "queue_depth": "C"}


def test_enable_and_set_path_sync_the_core_flags(pkg, tmp_path):
    tr, _, _, core = pkg
    tr.enable()
    assert core.get_flag("enable_trace") is True
    tr.disable()
    assert core.get_flag("enable_trace") is False
    prev = tr.get_path()
    try:
        tr.set_path(str(tmp_path / "sync.json"))
        assert core.get_flag("trace_path") == str(tmp_path / "sync.json")
    finally:
        tr.set_path(prev)


def test_event_buffer_bounded(pkg, tmp_path, capsys):
    tr = pkg[0]
    prev = tr._state.max_events
    tr.enable()
    try:
        tr.set_max_events(2)
        for i in range(4):
            tr.add_event(f"e{i}", float(i), 1.0)
        assert len(tr.get_events()) == 2 and tr.dropped_count() == 2
        assert "buffer full" in capsys.readouterr().err
        doc = json.loads(open(tr.export_chrome_trace(
            str(tmp_path / "capped.json"))).read())
        assert doc["metadata"]["dropped_events"] == 2
        tr.reset()
        assert tr.dropped_count() == 0
    finally:
        tr.set_max_events(prev)


def test_export_survives_numpy_args(pkg, tmp_path):
    tr = pkg[0]
    tr.enable()
    tr.instant("np", args={"n": np.int64(3), "v": np.float32(1.5)})
    path = tr.export_chrome_trace(str(tmp_path / "np.json"))
    assert json.loads(open(path).read())["traceEvents"]


def test_set_flags_drives_the_plane(pkg, tmp_path):
    tr, _, _, core = pkg
    core.set_flags({"FLAGS_enable_trace": True})
    try:
        assert tr.enabled()
        core.set_flags({"FLAGS_trace_path": str(tmp_path / "tl.json")})
        assert tr.get_path() == str(tmp_path / "tl.json")
    finally:
        core.set_flags({"FLAGS_enable_trace": False})
    assert not tr.enabled()


def test_default_path_is_under_the_temp_dir():
    import tempfile
    assert trace._default_path().startswith(tempfile.gettempdir())


# ---------------------------------------------------------------------------
# the Chrome trace export (TestChromeTraceExport)
# ---------------------------------------------------------------------------

def test_chrome_trace_schema(pkg, tmp_path):
    tr = pkg[0]
    tr.enable()
    with tr.span("a"):
        pass
    tr.instant("m")
    tr.metrics().counter("t/exp").inc()
    doc = json.loads(open(tr.export_chrome_trace(
        str(tmp_path / "t.json"))).read())
    evs = doc["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    last = None
    for e in evs:
        if e["ph"] == "M":
            continue
        assert "pid" in e and "tid" in e and e["ts"] >= 0
        if last is not None:
            assert e["ts"] >= last
        last = e["ts"]
    assert any(e["ph"] == "C" and e["name"] == "t/exp" for e in evs)


def test_the_reference_timeline_tool_reads_the_port_export(tmp_path):
    """The reference's tools/timeline.py validates and merges the port's
    exported timelines."""
    trace.enable()
    with trace.span("w"):
        pass
    p1 = trace.export_chrome_trace(str(tmp_path / "a.json"))
    p2 = trace.export_chrome_trace(str(tmp_path / "b.json"))
    tl = _timeline_tool()
    assert tl.validate_timeline(p1)
    out = str(tmp_path / "merged.json")
    assert tl.convert([p1, p2], out) == 0
    assert len({e["pid"] for e in tl.validate_timeline(out)}) >= 2


# ---------------------------------------------------------------------------
# the summary table (TestSummaryTable)
# ---------------------------------------------------------------------------

def _seed_events(tr):
    tr.enable()
    tr.add_event("opA", 0.0, 10.0)      # calls 2, total 30, max 20
    tr.add_event("opA", 20.0, 20.0)
    tr.add_event("opB", 50.0, 25.0)     # calls 1, total 25, min 25


@pytest.mark.parametrize("key,order", [
    ("total", ["opA", "opB"]), ("calls", ["opA", "opB"]),
    ("max", ["opB", "opA"]), ("min", ["opB", "opA"]),
    ("ave", ["opB", "opA"])])
def test_summary_sort_keys(pkg, key, order):
    tr = pkg[0]
    _seed_events(tr)
    assert [r[0] for r in tr.op_summary(key)] == order


def test_summary_row_math_and_table(pkg):
    tr = pkg[0]
    _seed_events(tr)
    row = {r[0]: r for r in tr.op_summary("total")}["opA"]
    assert row[1:] == (2, 30.0, 10.0, 20.0, 15.0)
    with pytest.raises(ValueError):
        tr.op_summary("bogus")
    txt = tr.summary_table("total")
    assert "opA" in txt and "Calls" in txt


# ---------------------------------------------------------------------------
# trace identity (TestTraceIdentity)
# ---------------------------------------------------------------------------

def test_new_trace_id_unique_and_prefixed(pkg):
    tr = pkg[0]
    ids = {tr.new_trace_id("req") for _ in range(1000)}
    assert len(ids) == 1000 and all(i.startswith("req-") for i in ids)


def test_context_attaches_trace_id_to_events(pkg):
    tr = pkg[0]
    tr.enable()
    with tr.trace_context("batch-xyz"):
        tr.complete("inner", tr.now(), cat="step", args={"k": 1})
        tr.instant("mark", cat="step")
    tr.complete("outside", tr.now(), cat="step")
    evs = {e["name"]: e for e in tr.get_events()}
    assert evs["inner"]["args"] == {"k": 1, "trace_id": "batch-xyz"}
    assert evs["mark"]["args"]["trace_id"] == "batch-xyz"
    assert "trace_id" not in (evs["outside"].get("args") or {})


def test_context_is_thread_local(pkg):
    tr = pkg[0]
    tr.enable()
    seen = []
    with tr.trace_context("mine"):
        t = threading.Thread(target=lambda: seen.append(
            tr.current_trace_id()))
        t.start()
        t.join()
        assert tr.current_trace_id() == "mine"
    assert seen == [None] and tr.current_trace_id() is None


def test_span_ids_nest_with_a_parent_chain(pkg):
    tr = pkg[0]
    tr.enable()
    with tr.span("outer", cat="step"):
        with tr.span("inner", cat="step"):
            pass
    evs = {e["name"]: e["args"] for e in tr.get_events()}
    assert evs["inner"]["parent_span"] == evs["outer"]["span_id"]
    assert evs["inner"]["span_id"] != evs["outer"]["span_id"]


def test_caller_args_never_mutated_and_tail_events(pkg):
    tr = pkg[0]
    tr.enable()
    args = {"a": 1}
    with tr.trace_context("t1"):
        tr.complete("x", tr.now(), args=args)
    assert args == {"a": 1}
    for i in range(10):
        tr.instant(f"e{i}")
    assert [e["name"] for e in tr.tail_events(3)] == ["e7", "e8", "e9"]
    assert tr.tail_events(0) == []


def test_propagation_fields(pkg):
    tr = pkg[0]
    assert tr.propagation_fields() == {}        # off: no bytes on the wire
    tr.enable()
    f = tr.propagation_fields("rpc")
    assert f["trace_id"].startswith("rpc-") and "parent_span" not in f
    with tr.trace_context("caller-1"):
        with tr.span("call") as sp:
            f = tr.propagation_fields()
    assert f == {"trace_id": "caller-1", "parent_span": sp.span_id}
    token = tr.set_context("handoff", 5)
    assert (tr.current_trace_id(), tr.current_span_id()) == ("handoff", 5)
    tr.restore_context(token)
    assert tr.current_trace_id() is None


# ---------------------------------------------------------------------------
# the flight recorder (TestFlightRecorder)
# ---------------------------------------------------------------------------

def test_ring_bounds_and_order(pkg):
    fr = pkg[1]
    r = fr.FlightRecorder(capacity=16)
    for i in range(40):
        r.record({"kind": "step", "i": i})
    snap = r.snapshot()
    assert [s["i"] for s in snap] == list(range(24, 40))
    assert [s["seq"] for s in snap] == list(range(24, 40))
    assert r.total == 40 and r.completions == 40
    r.resize(20)
    assert [s["i"] for s in r.snapshot()] == list(range(24, 40))


def test_disabled_recorder_and_completions(pkg):
    fr = pkg[1]
    r = fr.FlightRecorder(capacity=16, enabled=False)
    r.record({"kind": "step"})
    assert r.total == 0 and r.snapshot() == []
    r = fr.FlightRecorder(capacity=16)
    r.record({"kind": "request", "outcome": "rejected"})
    r.record({"kind": "request", "outcome": "ok"})
    assert r.total == 2 and r.completions == 1


def test_snapshot_last_and_copies(pkg):
    fr = pkg[1]
    r = fr.FlightRecorder(capacity=16)
    for i in range(5):
        r.record({"kind": "step", "i": i})
    last2 = r.snapshot(last=2)
    assert [s["i"] for s in last2] == [3, 4]
    last2[0]["i"] = 999
    assert r.snapshot(last=2)[0]["i"] == 3


def test_configure_flags_roundtrip(pkg):
    _, fr, _, core = pkg
    saved_en = fr.enabled()
    saved_cap = fr.recorder().capacity
    try:
        core.set_flags({"FLAGS_flight_recorder": False})
        assert not fr.enabled()
        fr.record("step", i=1)
        assert fr.recorder().total == 0
        core.set_flags({"FLAGS_flight_recorder": True,
                        "FLAGS_flight_recorder_events": 64})
        assert fr.enabled() and fr.recorder().capacity == 64
    finally:
        core.set_flags({"FLAGS_flight_recorder": saved_en,
                        "FLAGS_flight_recorder_events": saved_cap})


def _scale_program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [4])
        y = tfluid.layers.scale(x, scale=2.0)
        z = tfluid.layers.mean(y)
    return main, y, z


def test_executor_steps_recorded_with_tracing_off():
    assert not trace.enabled()
    main, y, _ = _scale_program()
    exe = tfluid.Executor(HOST)
    with scope_guard(Scope()):
        for _ in range(3):
            exe.run(main, feed={"x": np.ones(4, "float32")}, fetch_list=[y])
    steps = [r for r in flight_recorder.recorder().snapshot()
             if r["kind"] == "step"]
    assert len(steps) == 3
    assert steps[0]["compile_miss"] and not steps[1]["compile_miss"]
    assert steps[0]["fp"] and steps[0]["fp"] == steps[2]["fp"]
    assert steps[0]["dur_us"] > 0 and steps[0]["rss_bytes"] > 0
    assert "goodput_ratio" in steps[0] and steps[0]["hbm_peak_bytes"] == 0
    m = trace.metrics()
    assert m.counter("executor.steps_completed").value == 3
    assert m.counter("executor.compile_cache_miss").value == 1
    assert m.counter("executor.compile_cache_hit").value == 2
    assert trace.get_events() == []          # events stay gated


def test_executor_op_and_step_spans():
    main, _, z = _scale_program()
    exe = tfluid.Executor(HOST)
    trace.enable()
    with scope_guard(Scope()):
        exe.run(main, feed={"x": np.ones(4, "float32")}, fetch_list=[z])
    evs = trace.get_events()
    assert {"scale", "mean"} <= {e["name"] for e in evs
                                 if e["cat"] == "op"}
    assert [e["name"] for e in evs if e["cat"] == "step"] == \
        ["executor::step"]


def test_dygraph_op_spans():
    from paddle_tpu_torch.dygraph import base as dybase
    with dybase.guard(HOST):
        trace.enable()
        a = dybase.to_variable(np.ones((2, 2), "float32"))
        _ = a + a
    evs = [e for e in trace.get_events() if e["cat"] == "dygraph_op"]
    assert any(e["name"] == "elementwise_add" for e in evs)


# ---------------------------------------------------------------------------
# request tracing through the engines (TestRequestTracing)
# ---------------------------------------------------------------------------

def _engine(**kw):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 8])
        logits = tfluid.layers.fc(x, 4)
    scope = Scope()
    exe = tfluid.Executor(HOST)
    exe.run(startup, scope=scope)
    frozen = serving.freeze_program(main, ["x"], [logits], scope=scope)
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_us", 1000)
    return serving.ServingEngine(frozen, executor=exe, scope=scope, **kw)


def test_future_exposes_trace_id_even_untraced():
    eng = _engine()
    with eng:
        fut = eng.submit({"x": np.ones((2, 8), "float32")})
        fut.result(timeout=30)
    assert fut.trace_id.startswith("req-")
    recs = [r for r in flight_recorder.recorder().snapshot()
            if r.get("trace_id") == fut.trace_id]
    assert recs and recs[0]["outcome"] == "ok"
    assert recs[0]["latency_us"] > 0 and recs[0]["batch_rows"] == 2
    # the step that served it carries its batch's id
    steps = [r for r in flight_recorder.recorder().snapshot()
             if r["kind"] == "step"]
    assert steps[-1]["trace_id"] == recs[0]["batch_id"]


def test_causal_chain_reconstructible_by_trace_id():
    trace.enable()
    eng = _engine()
    with eng:
        futs = [eng.submit({"x": np.ones((2, 8), "float32")})
                for _ in range(4)]
        [f.result(timeout=30) for f in futs]
    evs = trace.get_events()
    for fut in futs:
        tid = fut.trace_id
        mine = [e for e in evs if (e.get("args") or {}).get("trace_id")
                == tid]
        names = {e["name"] for e in mine}
        assert {"serving::admit", "serving::queue",
                "serving::request"} <= names, (tid, names)
        req = [e for e in mine if e["name"] == "serving::request"][0]
        batch_id = req["args"]["batch_id"]
        assert req["args"]["queue_us"] >= 0 and req["args"]["device_us"] >= 0
        batch = [e for e in evs if e["name"] == "serving::batch"
                 and e["args"]["batch_id"] == batch_id]
        assert batch and tid in batch[0]["args"]["request_ids"]
        assert any(e["name"] == "serving::device"
                   and e["args"]["batch_id"] == batch_id for e in evs)
        assert any(e["name"] == "executor::step"
                   and (e.get("args") or {}).get("trace_id") == batch_id
                   for e in evs)


def test_timeout_and_rejection_wide_records():
    eng = _engine(max_wait_us=200000, queue_depth=2, auto_start=False)
    ok = [eng.submit({"x": np.ones((1, 8), "float32")}) for _ in range(2)]
    with pytest.raises(serving.QueueFullError):
        eng.submit({"x": np.ones((1, 8), "float32")})
    late = _engine(auto_start=False, default_deadline_ms=1)
    fut = late.submit({"x": np.ones((1, 8), "float32")})
    time.sleep(0.02)
    late.start()
    assert isinstance(fut.exception(timeout=30),
                      serving.DeadlineExceededError)
    late.close()
    recs = flight_recorder.recorder().snapshot()
    rej = [r for r in recs if r.get("outcome") == "rejected"]
    assert len(rej) == 1 and rej[0]["trace_id"].startswith("req-")
    tmo = [r for r in recs if r.get("outcome") == "timeout"]
    assert [r["trace_id"] for r in tmo] == [fut.trace_id]
    assert tmo[0]["queue_us"] >= 1000
    eng.start()
    [f.result(timeout=30) for f in ok]
    eng.close()


def test_decode_spans_and_records():
    from paddle_tpu_torch.serving import decode
    model = decode.build_demo_decode_model(
        vocab=19, d_model=8, max_len=16, seed=5, page_size=4,
        executor=tfluid.Executor(HOST), scope=Scope())
    trace.enable()
    eng = decode.DecodeEngine(model, max_batch=2, paged=True,
                              draft_model=model, spec_k=3, name="t_obs")
    with eng:
        fut = eng.submit([3, 1, 4], max_new_tokens=4)
        fut.result(timeout=60)
    names = {e["name"] for e in trace.get_events()}
    assert {"decode::admit", "decode::prefill", "decode::spec_round",
            "decode::finish"} <= names
    rec = [r for r in flight_recorder.recorder().snapshot()
           if r.get("trace_id") == fut.trace_id]
    assert rec and rec[0]["outcome"] == "ok"


# ---------------------------------------------------------------------------
# the metrics export (tests/test_metrics_export.py)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{quantile="0\.\d+"\})? '
    r'([-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?|[-+]?Inf|NaN)$')


def _assert_wellformed(body):
    lines = body.splitlines()
    assert lines
    for ln in lines:
        if ln.startswith("#"):
            assert re.match(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                            r"(counter|gauge|summary)$", ln), ln
        elif ln:
            assert _SAMPLE_RE.match(ln), f"torn or invalid line: {ln!r}"


def test_sanitize_and_nonfinite_values(pkg):
    tr, _, me, _ = pkg
    f = me.sanitize_metric_name
    assert f("executor.compile_cache_miss") == "executor_compile_cache_miss"
    assert f("psgpu/mem") == "psgpu_mem" and f("0weird") == "_0weird"
    tr.metrics().gauge("t.inf").set(float("inf"))
    tr.metrics().gauge("t.nan").set(float("nan"))
    body = me.prometheus_text()
    assert "t_inf +Inf" in body and "t_nan NaN" in body


def test_counter_gauge_histogram_rendering(pkg):
    tr, _, me, _ = pkg
    m = tr.metrics()
    m.counter("t.c").add(3)
    m.gauge("t.g").set(2.5)
    for v in (0.001, 0.01, 0.1):
        m.histogram("t.h").observe(v)
    body = me.prometheus_text()
    _assert_wellformed(body)
    assert "# TYPE t_c counter\nt_c 3" in body
    assert "# TYPE t_g gauge\nt_g 2.5" in body
    assert 't_h{quantile="0.5"}' in body and "t_h_count 3" in body


def _fill(tr):
    reg = tr.MetricsRegistry()
    reg.counter("serving.requests").add(48)
    reg.counter("serving.chip.batches").inc(7)
    reg.counter("decode.spec_proposed").add(12)
    reg.counter("decode.spec_proposed").dec(2)
    reg.gauge("serving.queue_depth").set(3)
    reg.gauge("goodput.ratio").set(0.8125)
    reg.gauge("executor.inflight_steps").add(2.0)
    for v in (1e-6, 3e-5, 2e-4, 0.0125, 0.5, 7.0, 900.0):
        reg.histogram("serving.latency_seconds").observe(v)
    reg.histogram("decode.step_seconds").observe(0.00093)
    return reg


def test_one_registry_renders_alike_in_both_packages():
    """The same calls on a fresh registry of each package render the same
    Prometheus text line for line, and parse back to the same families."""
    from paddle_tpu.fluid import metrics_export as jme
    from paddle_tpu.fluid import trace as jtr
    want = jme.prometheus_text(_fill(jtr)).splitlines()
    got = metrics_export.prometheus_text(_fill(trace)).splitlines()
    assert got == want
    assert metrics_export.parse_prometheus_text("\n".join(got)) == \
        jme.parse_prometheus_text("\n".join(want))


def test_parse_prometheus_text_roundtrip():
    reg = _fill(trace)
    fams = {f["name"]: f for f in metrics_export.parse_prometheus_text(
        metrics_export.prometheus_text(reg))}
    assert fams["serving_requests"]["type"] == "counter"
    assert fams["serving_requests"]["samples"] == [
        ("serving_requests", {}, 48.0)]
    lat = fams["serving_latency_seconds"]
    assert lat["type"] == "summary"
    qs = {s[1].get("quantile") for s in lat["samples"]}
    assert qs == {"0.5", "0.95", "0.99", None}
    assert ("serving_latency_seconds_count", {}, 7.0) in lat["samples"]


def test_http_endpoint_serves_and_stops(pkg):
    tr, _, me, _ = pkg
    tr.metrics().counter("executor.fake").add(1)
    srv = me.start_http(port=0)
    try:
        assert srv.host == "127.0.0.1"
        base = f"http://127.0.0.1:{srv.port}"
        assert urllib.request.urlopen(base + "/healthz",
                                      timeout=10).status == 200
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        _assert_wellformed(body)
        assert "executor_fake 1" in body
        stats = json.loads(urllib.request.urlopen(
            base + "/stats", timeout=10).read().decode())
        assert stats["status"] == "ok" and "uptime_s" in stats
        good = json.loads(urllib.request.urlopen(
            base + "/goodput", timeout=10).read().decode())
        assert good["source"] == "metrics" and 0.0 <= good["ratio"] <= 1.0
        assert tr.metrics().gauge("metrics.export_port").value == srv.port
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        me.stop_http()
    assert tr.metrics().gauge("metrics.export_port").value == 0


def test_apply_flags_leaves_programmatic_surfaces_alone(tmp_path):
    srv = metrics_export.start_http(port=0)
    w = metrics_export.start_snapshots(str(tmp_path / "mine.jsonl"), 0.05)
    try:
        metrics_export.apply_flags()     # the port and path flags are off
        tfluid.core.set_flags({"FLAGS_metrics_host": "127.0.0.1"})
        assert urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/healthz", timeout=10).status == 200
        assert metrics_export._writer is w
    finally:
        metrics_export.stop_http()
        metrics_export.stop_snapshots()


def test_concurrent_writers_no_torn_lines():
    m = trace.metrics()
    stop = threading.Event()
    errs = []

    def writer(i):
        try:
            while not stop.is_set():
                m.counter(f"w{i}.count").add(1)
                m.gauge(f"w{i}.depth").set(time.perf_counter())
                m.histogram(f"w{i}.lat").observe(1e-4)
        except Exception as e:          # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    srv = metrics_export.start_http(port=0)
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        bodies = [urllib.request.urlopen(url, timeout=10).read().decode()
                  for _ in range(10)]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        metrics_export.stop_http()
    assert not errs and not any(t.is_alive() for t in threads)
    for body in bodies:
        _assert_wellformed(body)
    assert all(f"w{i}_count" in bodies[-1] for i in range(4))


def test_snapshots_roundtrip_loop_and_flags(tmp_path):
    m = trace.metrics()
    m.counter("snap.c").add(7)
    m.histogram("snap.h").observe(0.01)
    path = str(tmp_path / "m.jsonl")
    row = metrics_export.write_snapshot(path)
    back = [json.loads(ln) for ln in open(path).read().splitlines()]
    assert back[0]["metrics"]["snap.c"] == 7
    assert back[0]["metrics"]["snap.h"]["p95"] == \
        row["metrics"]["snap.h"]["p95"]
    assert {"goodput", "uptime_s", "watchdog"} <= set(back[0])
    loop = str(tmp_path / "loop.jsonl")
    w = metrics_export.SnapshotWriter(loop, interval_s=0.05)
    time.sleep(0.22)
    w.stop()
    assert len(open(loop).read().splitlines()) >= 2
    flagged = str(tmp_path / "flagged.jsonl")
    tfluid.core.set_flags({"FLAGS_metrics_snapshot_interval_s": 0.05,
                           "FLAGS_metrics_snapshot_path": flagged})
    try:
        time.sleep(0.15)
    finally:
        tfluid.core.set_flags({"FLAGS_metrics_snapshot_path": None,
                               "FLAGS_metrics_snapshot_interval_s": 60.0})
    n = len(open(flagged).read().splitlines())
    assert n >= 1
    time.sleep(0.12)
    assert len(open(flagged).read().splitlines()) == n


def test_stats_payload_names_engines_and_decode():
    eng = _engine(name="t_payload")
    with eng:
        eng.infer({"x": np.ones((3, 8), "float32")}, timeout=30)
    out = metrics_export.stats_payload()
    assert out["engines"]["t_payload"]["requests"] == 1
    assert out["engines"]["t_payload"]["batches"] == 1
    assert "autotune" not in out
    assert out["status"] == "ok"


def test_goodput_attribution_matches_the_reference():
    """goodput.attribute_events over one synthetic event list gives the
    reference's buckets."""
    from paddle_tpu.fluid import goodput as jgp
    from paddle_tpu_torch.fluid import goodput as tgp
    evs = [{"ph": "X", "name": "executor::compile", "ts": 0.0, "dur": 50.0},
           {"ph": "X", "name": "executor::step", "ts": 40.0, "dur": 100.0},
           {"ph": "X", "name": "loader::wait", "ts": 160.0, "dur": 20.0},
           {"ph": "X", "name": "executor::host_wait", "ts": 185.0,
            "dur": 10.0}]
    want = jgp.attribute_events(evs, t0_us=0.0, t1_us=250.0,
                                include_segments=True)
    got = tgp.attribute_events(evs, t0_us=0.0, t1_us=250.0,
                               include_segments=True)
    assert got == want
    assert sum(got["buckets"].values()) == pytest.approx(
        got["wall_seconds"])
