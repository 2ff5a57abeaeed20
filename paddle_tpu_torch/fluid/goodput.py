"""Goodput accounting: wall-clock attribution over the observability plane.

Counterpart of ``paddle_tpu/fluid/goodput.py``, standard library only.
It answers what fraction of wall-clock was productive work by charging
every second to exactly one of eight exclusive buckets, from the spans
the runtime emits (``executor::compile``, ``executor::step``,
``executor::host_wait``, ``loader::wait``, ``checkpoint::save`` /
``::submit`` / ``::restore``, ``elastic::drain``, ``ps::pull_wait``):

=================  =========================================================
bucket             meaning
=================  =========================================================
device_compute     ``executor::step`` dispatch plus host time blocked on
                   device results (``executor::host_wait``)
host_input_wait    host blocked on the input pipeline (``loader::wait``)
compile            program build (``executor::compile``, pass spans)
checkpoint_stall   synchronous ``checkpoint::save`` and ``checkpoint::submit``
preemption_drain   closing the in-flight window on preemption
restart_init       process start to the first instrumented activity, plus
                   ``checkpoint::restore``
ps_pull_wait       a step blocked on parameter-server pulls
idle               everything else
=================  =========================================================

Attribution is an interval sweep: each elementary segment goes to the
strongest bucket covering it (drain > checkpoint stall > restart >
compile > input wait > PS pull > device compute), so the buckets sum to
wall-clock exactly.  The port emits ``executor::step`` today; the other
spans come with the planes that own them (ROADMAP item 9), and until then
their buckets read 0.

Entry points: :func:`attribute_events` (a pure function over an event
list), :func:`snapshot` / :func:`update_gauges` (live, over the trace
buffer; they refresh the ``goodput.*`` gauges the metrics export reads)
and :func:`from_metrics` (a coarse estimate from histogram totals with
tracing off, labelled ``source="metrics"``).  With tracing off nothing
here runs on a hot path.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

try:                                    # standard library only when
    from . import trace as _trace       # loaded by file path
except ImportError:                     # pragma: no cover - standalone load
    _trace = None

__all__ = [
    "BUCKETS", "PRODUCTIVE_BUCKET", "classify_event", "attribute_events",
    "snapshot", "update_gauges", "publish_gauges", "from_metrics",
]

#: every wall-clock second lands in exactly one of these
BUCKETS = ("device_compute", "host_input_wait", "compile",
           "checkpoint_stall", "preemption_drain", "restart_init",
           "ps_pull_wait", "idle")

PRODUCTIVE_BUCKET = "device_compute"

# sweep priority (index 0 strongest): when spans overlap — elastic::drain
# CONTAINS the host_wait spans of the window it closes, a sync
# checkpoint::save inside drain_and_save, the first executor::step
# overlaps its own executor::compile — the strongest bucket owns the
# overlap and nothing double-counts.  ps_pull_wait sits between the input
# wait and device compute: a PS pull stalled inside a loader wait is the
# loader's problem, but a pull stalling the step body is its own bucket.
_PRIORITY = ("preemption_drain", "checkpoint_stall", "restart_init",
             "compile", "host_input_wait", "ps_pull_wait",
             "device_compute")
_PRIO_INDEX = {b: i for i, b in enumerate(_PRIORITY)}


def classify_event(ev: Dict[str, Any]) -> Optional[str]:
    """Bucket for one Chrome-trace event, or None when it carries no
    goodput signal (per-op trace-time spans, comm annotations, bench
    wrappers...)."""
    if ev.get("ph") != "X":
        return None
    name = ev.get("name", "")
    cat = ev.get("cat", "")
    if name == "executor::compile" or cat == "pass":
        return "compile"
    if name in ("executor::step", "executor::host_wait"):
        return "device_compute"
    if name == "loader::wait":
        return "host_input_wait"
    if name == "ps::pull_wait":
        # sharded-PS pull latency the prefetcher failed to hide
        return "ps_pull_wait"
    if name == "checkpoint::submit":
        return "checkpoint_stall"
    if name == "checkpoint::save":
        # async saves ride the ckpt-writer thread and OVERLAP compute —
        # only a synchronous save stalls the step window.  A missing
        # arg (traces exported before the flag existed) defaults to
        # ASYNC: async_save is the default mode, so biasing old traces
        # toward no-stall beats inventing phantom checkpoint stalls.
        if (ev.get("args") or {}).get("sync", False):
            return "checkpoint_stall"
        return None
    if name == "checkpoint::restore":
        return "restart_init"
    if name == "elastic::drain":
        return "preemption_drain"
    return None


def _intervals_of(events: Sequence[Dict[str, Any]]):
    """(classified intervals, min event ts, max span end) of an event
    list."""
    intervals: List[Tuple[float, float, int]] = []
    ev_lo = ev_hi = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        try:
            s = float(ev.get("ts", 0.0))
            e = s + float(ev.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        ev_lo = s if ev_lo is None else min(ev_lo, s)
        ev_hi = e if ev_hi is None else max(ev_hi, e)
        bucket = classify_event(ev)
        if bucket is not None and e > s:
            intervals.append((s, e, _PRIO_INDEX[bucket]))
    return intervals, ev_lo, ev_hi


def attribute_events(events: Sequence[Dict[str, Any]],
                     t0_us: Optional[float] = None,
                     t1_us: Optional[float] = None,
                     include_segments: bool = False) -> Dict[str, Any]:
    """Exhaustive, exclusive wall-clock attribution over ``events``.

    The window defaults to [min ts, max span end] of the event list;
    live callers pass ``t0_us=0`` (trace epoch = process start) and
    ``t1_us=now`` so init time and trailing idle are charged too.
    Uncovered time before the FIRST classified span in the list is
    charged to restart_init (the list is taken to start at the run's
    start; for a mid-run window use :func:`snapshot`, which knows the
    run's true first activity).  Returns ``{"wall_seconds", "buckets":
    {bucket: seconds}, "ratio", "classified_spans", "source"}``; with
    ``include_segments`` also a ``segments`` list of ``(start_us,
    end_us, bucket)`` (adjacent same-bucket segments merged) for
    timeline rendering.  The buckets sum to ``wall_seconds`` up to
    float accumulation.
    """
    intervals, ev_lo, ev_hi = _intervals_of(events)
    return _attribute(intervals, ev_lo, ev_hi, t0_us, t1_us,
                      include_segments)


def _attribute(intervals, ev_lo, ev_hi,
               t0_us: Optional[float] = None,
               t1_us: Optional[float] = None,
               include_segments: bool = False,
               run_first_work_us: Optional[float] = None) -> Dict[str, Any]:
    """The sweep proper.  ``run_first_work_us`` — the run's earliest
    classified activity, independent of the window — bounds the
    restart_init rule: uncovered time is "restart" only while the run
    had not yet done ANY instrumented work, so a rolling window that
    starts mid-run never invents phantom restart seconds."""
    t0 = float(t0_us) if t0_us is not None else (ev_lo or 0.0)
    t1 = float(t1_us) if t1_us is not None else (ev_hi or t0)
    t1 = max(t0, t1)
    wall_us = t1 - t0

    buckets = {b: 0.0 for b in BUCKETS}
    segments: List[List[Any]] = []

    def _charge(s: float, e: float, bucket: str):
        if e <= s:
            return
        buckets[bucket] += e - s
        if include_segments:
            if segments and segments[-1][2] == bucket \
                    and segments[-1][1] == s:
                segments[-1][1] = e
            else:
                segments.append([s, e, bucket])

    # clip to the window, drop empties
    clipped = []
    for s, e, p in intervals:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            clipped.append((s, e, p))

    first_work = min((s for s, _, _ in clipped), default=None)
    if run_first_work_us is not None:
        # the run's true first activity wins over the window-local one:
        # when it lies before t0 the sweep below (cur >= t0 > first)
        # charges nothing to restart_init — a rolling window that starts
        # mid-run never invents phantom restart seconds
        first_work = run_first_work_us

    # boundary sweep with per-priority active counts: each elementary
    # segment goes to the strongest covering bucket; uncovered segments
    # are restart_init before the first instrumented activity, idle after
    points: List[Tuple[float, int, int]] = []
    for s, e, p in clipped:
        points.append((s, 0, p))        # opens sort before closes at a tie
        points.append((e, 1, p))
    points.sort(key=lambda x: (x[0], x[1]))
    active = [0] * len(_PRIORITY)
    cur = t0
    for t, kind, p in points:
        if t > cur:
            owner = next((i for i, n in enumerate(active) if n > 0), None)
            if owner is not None:
                _charge(cur, t, _PRIORITY[owner])
            elif first_work is not None and cur < first_work:
                _charge(cur, min(t, first_work), "restart_init")
                if t > first_work:      # straddles the first span start
                    _charge(first_work, t, "idle")
            else:
                _charge(cur, t, "idle")
            cur = t
        active[p] += 1 if kind == 0 else -1
    if cur < t1:
        if first_work is None:
            _charge(cur, t1, "idle")
        elif cur < first_work:
            _charge(cur, min(t1, first_work), "restart_init")
            _charge(max(cur, first_work), t1, "idle")
        else:
            _charge(cur, t1, "idle")

    wall_s = wall_us / 1e6
    out = {
        "wall_seconds": wall_s,
        "buckets": {b: v / 1e6 for b, v in buckets.items()},
        "ratio": (buckets[PRODUCTIVE_BUCKET] / wall_us) if wall_us else 0.0,
        "classified_spans": len(clipped),
        "source": "spans",
    }
    if include_segments:
        out["segments"] = [(s, e, b) for s, e, b in segments]
    return out


# ---------------------------------------------------------------------------
# live surface (needs the in-process trace plane)
# ---------------------------------------------------------------------------

def _require_trace():
    if _trace is None:              # pragma: no cover - standalone load
        raise RuntimeError(
            "goodput live attribution needs the in-process trace plane; "
            "this module was loaded standalone — use attribute_events() "
            "on an exported event list instead")
    return _trace


# incremental accumulator for the live surface: a scrape must not copy
# the whole (up to 1M-event) trace buffer under the tracer's lock on
# every tick — only the tail since the last cursor is fetched, and only
# the goodput-classified intervals are retained.  Reset()s of the trace
# buffer are detected by the cursor running past the buffer length.
_acc_lock = threading.Lock()
_acc = {"cursor": 0, "generation": 0, "intervals": [], "first_work": None}


def _live_intervals(tr):
    """(classified intervals so far, the run's first classified
    activity) — consuming only the NEW tail of the trace buffer."""
    with _acc_lock:
        gen = tr.buffer_generation()
        if gen != _acc["generation"]:               # buffer was reset
            _acc["cursor"] = 0
            _acc["generation"] = gen
            _acc["intervals"] = []
            _acc["first_work"] = None
        new = tr.get_events(_acc["cursor"])
        _acc["cursor"] += len(new)
        if new:
            intervals, ev_lo, _ = _intervals_of(new)
            _acc["intervals"].extend(intervals)
            fresh_first = min((s for s, _, _ in intervals), default=None)
            if fresh_first is not None \
                    and (_acc["first_work"] is None
                         or fresh_first < _acc["first_work"]):
                _acc["first_work"] = fresh_first
            # bound retention when a rolling window is configured: only
            # intervals that can still enter a future window are kept
            w = _flag_window_s()
            if w:
                cut = tr.elapsed_us() - w * 1e6
                _acc["intervals"] = [iv for iv in _acc["intervals"]
                                     if iv[1] >= cut]
        return list(_acc["intervals"]), _acc["first_work"]


def _flag_window_s() -> float:
    try:
        from . import core
        return float(core.get_flag("goodput_window_s", 0.0) or 0.0)
    except Exception:               # noqa: BLE001 — flags are advisory
        return 0.0


def snapshot(window_s: Optional[float] = None,
             t0_us: Optional[float] = None,
             include_segments: bool = False) -> Dict[str, Any]:
    """Attribution over the live trace buffer, up to *now*.

    ``window_s`` restricts to the trailing window (rolling goodput;
    default = ``FLAGS_goodput_window_s``, a bounded 600s so scrapes
    stay O(window) on long runs; pass 0 for the whole run back to the
    trace epoch, where init time shows up as restart_init).  ``t0_us``
    pins an explicit start (e.g. "since this gate began").  A window
    that starts after the run's first instrumented activity charges its
    uncovered head to idle, never to restart_init.

    Note: the live accumulator prunes intervals that can no longer
    enter the FLAG-configured window, so on a run older than
    ``FLAGS_goodput_window_s`` a wider explicit query here is
    approximate — for exact whole-run attribution export the timeline
    and use :func:`attribute_events` (or set the flag to 0 up front).
    """
    tr = _require_trace()
    t1 = tr.elapsed_us()
    if t0_us is None:
        if window_s is None:
            window_s = _flag_window_s()
        t0_us = max(0.0, t1 - window_s * 1e6) if window_s else 0.0
    intervals, first_work = _live_intervals(tr)
    rep = _attribute(intervals, None, None, t0_us=t0_us, t1_us=t1,
                     include_segments=include_segments,
                     run_first_work_us=first_work)
    dropped = tr.dropped_count()
    if dropped:
        # the trace buffer hit FLAGS_trace_max_events and is dropping
        # new spans: attribution is blind to recent activity (new time
        # decays toward "idle").  Never let that masquerade as a real
        # goodput collapse — flag it, and let publish_gauges surface
        # goodput.degraded for alerting.
        rep["degraded"] = True
        rep["dropped_events"] = dropped
    return rep


def publish_gauges(rep: Dict[str, Any]) -> Dict[str, Any]:
    """Publish one attribution report to the ``goodput.*`` gauges (the
    single place the gauge set is defined — the traced and
    metrics-fallback paths must publish identically)."""
    tr = _require_trace()
    m = tr.metrics()
    m.gauge("goodput.ratio").set(rep["ratio"])
    m.gauge("goodput.wall_seconds").set(rep["wall_seconds"])
    m.gauge("goodput.degraded").set(1.0 if rep.get("degraded") else 0.0)
    for b, v in rep["buckets"].items():
        m.gauge(f"goodput.{b}_seconds").set(v)
    return rep


def update_gauges(window_s: Optional[float] = None) -> Dict[str, Any]:
    """Refresh the ``goodput.*`` gauges from a fresh :func:`snapshot` and
    return the report.  Called by the metrics HTTP handler on every
    scrape and by the JSONL snapshot writer each tick — the gauges are a
    *view* of the event stream, never a second source of truth."""
    return publish_gauges(snapshot(window_s=window_s))


def from_metrics(wall_s: float) -> Dict[str, Any]:
    """Coarse attribution from histogram totals, for runs with tracing
    OFF (a benchmark run reports goodput without paying for the event
    stream).  The named badput buckets are measured; the remainder is
    credited to device_compute (idle is indistinguishable without
    spans), so the ratio is an upper bound — labeled
    ``source="metrics"``."""
    tr = _require_trace()
    m = tr.metrics()

    def _total(name):
        # read-only: a scrape must not register empty histograms as a
        # side effect (dead summary families in every later export)
        inst = m.get(name)
        return float(inst.stats()["total"]) \
            if isinstance(inst, tr.Histogram) else 0.0

    wall_s = max(0.0, float(wall_s))
    buckets = {b: 0.0 for b in BUCKETS}
    buckets["compile"] = _total("executor.compile_seconds")
    buckets["host_input_wait"] = _total("loader.consume_wait_seconds")
    buckets["checkpoint_stall"] = _total("ckpt.stall_seconds")
    buckets["preemption_drain"] = _total("elastic.drain_seconds")
    buckets["restart_init"] = _total("ckpt.restore_seconds")
    buckets["ps_pull_wait"] = _total("ps.pull_wait_seconds")
    badput = sum(buckets.values())
    if badput > wall_s > 0.0:           # totals can exceed a sub-run wall
        scale = wall_s / badput
        buckets = {b: v * scale for b, v in buckets.items()}
        badput = wall_s
    buckets["device_compute"] = max(0.0, wall_s - badput)
    return {
        "wall_seconds": wall_s,
        "buckets": buckets,
        "ratio": (buckets["device_compute"] / wall_s) if wall_s else 0.0,
        "classified_spans": 0,
        "source": "metrics",
    }
