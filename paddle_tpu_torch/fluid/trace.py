"""Runtime observability plane: structured events and metrics.

Counterpart of ``paddle_tpu/fluid/trace.py``, standard library only.
Three layers, one module:

* **Event stream** — ``span()`` / ``complete()`` / ``instant()`` append
  Chrome-trace-shaped dicts (``ph`` "X"/"i"/"C"/"M") to a process-wide,
  bounded buffer.  Timestamps come from ``time.perf_counter_ns`` against
  a fixed epoch, so exported ``ts`` values are monotonic microseconds.
  Each event carries the thread's ambient trace context (``trace_id`` and
  ``parent_span``), so a request's spans join up across the serving
  engine's threads and the executor steps it dispatched.
* **Metrics registry** — ``metrics()`` returns the global
  :class:`MetricsRegistry` of thread-safe counters, gauges and timing
  histograms.  The passes, the executor, the serving engines and the
  flight recorder count what they do here; ``metrics_export`` renders it.
* **Exporters** — ``export_chrome_trace()`` writes Perfetto-loadable JSON;
  ``op_summary()`` / ``summary_table()`` render the profiler's sorted
  calls/total/min/max/ave table.

Gating: ``FLAGS_enable_trace`` / ``FLAGS_trace_path`` (the environment at
import, or ``fluid.core.set_flags`` / ``enable()`` at run time).  When off,
a span site costs one boolean check: callers read ``enabled()`` once per
block and skip the ``now()``/``complete()`` pair.  When enabled from the
environment, the buffer is exported at process exit.

Every time here is a host time.  The port's executor runs each op
eagerly, so an ``op`` span times the op's host dispatch: on the card the
kernels it queued may still be running when the span closes.  Device time
comes from ``torch.profiler`` (chip_smoke.py's phase 5), not from here.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "enabled", "enable", "disable", "now", "complete", "instant",
    "counter_event", "add_event", "span", "get_events", "event_count",
    "tail_events", "reset",
    "reset_all", "set_path", "get_path", "set_max_events", "elapsed_us",
    "new_id", "new_trace_id", "trace_context", "current_trace_id",
    "current_span_id", "set_context", "restore_context",
    "propagation_fields", "dropped_count", "buffer_generation",
    "export_chrome_trace",
    "op_summary", "summary_table", "metrics", "MetricsRegistry",
    "gauge_value", "counter_value",
    "Counter", "Gauge", "Histogram", "SORTED_KEYS",
]

_TRUE_STRINGS = ("1", "true", "yes", "on")


def _default_path() -> str:
    return os.path.join(tempfile.gettempdir(),
                        "paddle_tpu_torch_timeline.json")


def _env_enabled() -> bool:
    return os.environ.get("FLAGS_enable_trace", "").strip().lower() \
        in _TRUE_STRINGS


class _State:
    """Process-wide tracer state."""

    def __init__(self):
        self.enabled = False
        self.lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self.epoch_ns = time.perf_counter_ns()
        self.path = os.environ.get("FLAGS_trace_path") or _default_path()
        self.atexit_registered = False
        # a long traced run degrades (drop and count), never exhausts the
        # host: ~200 bytes an event, so the default caps near 200 MB
        self.max_events = int(os.environ.get("FLAGS_trace_max_events",
                                             "1000000"))
        self.dropped = 0
        # bumped by reset(): incremental readers (goodput) drop their
        # cursor when it moves
        self.generation = 0


_state = _State()


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------

def enabled() -> bool:
    """The one-boolean hot-path guard.  Read once per block or loop."""
    return _state.enabled


def enable(path: Optional[str] = None) -> None:
    """Turn the event stream on (idempotent).  ``path`` also sets the
    export target (FLAGS_trace_path)."""
    if path:
        _state.path = str(path)
    _state.enabled = True
    if not _state.atexit_registered:
        _state.atexit_registered = True
        atexit.register(_export_at_exit)
    _sync_core_flag(True)


def disable() -> None:
    _state.enabled = False
    _sync_core_flag(False)


def _sync_core_flag(value: bool) -> None:
    # keep core.get_flag("enable_trace") truthful.  core imports this
    # module at its top and builds its flags from our state, so while core
    # is still importing (an environment-enabled trace) there is nothing
    # to sync yet
    from . import core
    flags = getattr(core, "_FLAGS", None)
    if flags is not None:
        flags["enable_trace"] = bool(value)
        flags["trace_path"] = _state.path


def set_path(path: str) -> None:
    _state.path = str(path)
    _sync_core_flag(_state.enabled)


def set_max_events(n: int) -> None:
    """Resize the event-buffer cap (FLAGS_trace_max_events).  Once full,
    new events are dropped and counted: the drop total lands in the
    export metadata, and the first drop warns once."""
    _state.max_events = int(n)


def get_path() -> str:
    return _state.path


def _export_at_exit() -> None:
    if _state.enabled and (_state.events or _registry._metrics):
        try:
            export_chrome_trace(_state.path)
        except Exception:           # noqa: BLE001 — an exit hook never raises
            pass


# ---------------------------------------------------------------------------
# trace identity: request and batch ids, the propagated context token
# ---------------------------------------------------------------------------

# itertools.count.__next__ is atomic under the GIL
_ids = itertools.count(1)


def new_id() -> int:
    """A process-unique, increasing integer id."""
    return next(_ids)


def new_trace_id(prefix: str = "req") -> str:
    """A short process-salted trace id, e.g. ``req-3f2a-1c``: unique in
    the process and told apart across merged multi-process timelines
    (the pid is in the middle).  Cheap enough to take per request with
    tracing off: the flight recorder keys its records on these."""
    return f"{prefix}-{os.getpid() & 0xffff:x}-{next(_ids):x}"


class _CtxLocal(threading.local):
    ctx: Optional[Tuple[Optional[str], Optional[int]]] = None


_tls = _CtxLocal()


def current_trace_id() -> Optional[str]:
    """The ambient request or batch trace id on this thread, or None."""
    ctx = _tls.ctx
    return ctx[0] if ctx is not None else None


def current_span_id() -> Optional[int]:
    ctx = _tls.ctx
    return ctx[1] if ctx is not None else None


def set_context(trace_id: Optional[str],
                span_id: Optional[int] = None):
    """Install (trace_id, span_id) as this thread's ambient context and
    return the previous token for :func:`restore_context`."""
    prev = _tls.ctx
    _tls.ctx = (trace_id, span_id)
    return prev


def restore_context(token) -> None:
    _tls.ctx = token


class _TraceCtx:
    """``with trace.trace_context(tid): ...`` — every event emitted on
    this thread inside the block carries ``trace_id`` in its args: a
    dispatch made for request or batch X stamps X on the executor spans
    it triggers."""

    __slots__ = ("trace_id", "span_id", "_token")

    def __init__(self, trace_id, span_id=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self._token = None

    def __enter__(self):
        self._token = set_context(self.trace_id, self.span_id)
        return self

    def __exit__(self, *exc):
        restore_context(self._token)
        return False


def trace_context(trace_id: Optional[str],
                  span_id: Optional[int] = None) -> _TraceCtx:
    return _TraceCtx(trace_id, span_id)


def propagation_fields(prefix: str = "rpc") -> Dict[str, Any]:
    """The trace-context fields a caller stamps into an outgoing request
    header: ``{"trace_id": ..., "parent_span": ...}`` (parent_span only
    inside a span).  ``{}`` when tracing is off, so an untraced process
    adds no bytes.  With tracing on and no ambient context, a fresh id is
    allocated; a caller that retries takes the fields once per logical
    call."""
    if not _state.enabled:
        return {}
    fields: Dict[str, Any] = {
        "trace_id": current_trace_id() or new_trace_id(prefix)}
    span_id = current_span_id()
    if span_id is not None:
        fields["parent_span"] = span_id
    return fields


def _with_ctx(ev: Dict[str, Any],
              args: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Attach the caller's args and the ambient context to an event; the
    caller's dict is never mutated."""
    ctx = _tls.ctx
    if ctx is None or (ctx[0] is None and ctx[1] is None):
        if args:
            ev["args"] = args
        return ev
    merged = dict(args) if args else {}
    if ctx[0] is not None:
        merged.setdefault("trace_id", ctx[0])
    if ctx[1] is not None:
        merged.setdefault("parent_span", ctx[1])
    ev["args"] = merged
    return ev


# ---------------------------------------------------------------------------
# event emission
# ---------------------------------------------------------------------------

def now() -> int:
    """Monotonic nanosecond stamp for complete()."""
    return time.perf_counter_ns()


def _ts_us(t_ns: int) -> float:
    return (t_ns - _state.epoch_ns) / 1e3


def elapsed_us() -> float:
    """Now in the exported timeline's coordinates (microseconds since the
    trace epoch, about process start)."""
    return _ts_us(now())


def _append(ev: Dict[str, Any]) -> None:
    """Bounded append: past max_events, drop and count."""
    warn = False
    with _state.lock:
        if len(_state.events) >= _state.max_events:
            warn = _state.dropped == 0
            _state.dropped += 1
        else:
            _state.events.append(ev)
    if warn:
        # the gauge flips on the first drop; the export plane refreshes
        # the exact count from dropped_count() on every scrape
        _registry.gauge("trace.dropped_events").set(1)
        import sys
        print(f"paddle_tpu_torch.trace: event buffer full "
              f"({_state.max_events} events) — dropping further events "
              f"(raise FLAGS_trace_max_events or export/reset "
              f"periodically); the drop count lands in the export metadata "
              f"and the trace.dropped_events gauge", file=sys.stderr)


def complete(name: str, t0_ns: int, cat: str = "op",
             args: Optional[Dict[str, Any]] = None,
             end_ns: Optional[int] = None) -> None:
    """Append a Chrome "X" (complete) event spanning t0_ns..now (or
    ``end_ns``).  Hot paths read ``enabled()`` once and pair ``t0 =
    now()`` ... ``complete(name, t0)`` around the guarded region."""
    t1 = now() if end_ns is None else end_ns
    ev = {"name": name, "cat": cat, "ph": "X",
          "ts": _ts_us(t0_ns), "dur": max((t1 - t0_ns) / 1e3, 0.0),
          "pid": os.getpid(), "tid": threading.get_ident()}
    _append(_with_ctx(ev, args))


def instant(name: str, cat: str = "instant",
            args: Optional[Dict[str, Any]] = None) -> None:
    """Append a Chrome "i" (instant) event: markers."""
    ev = {"name": name, "cat": cat, "ph": "i", "s": "p",
          "ts": _ts_us(now()), "pid": os.getpid(),
          "tid": threading.get_ident()}
    _append(_with_ctx(ev, args))


def counter_event(name: str, value, cat: str = "metric") -> None:
    """Append a Chrome "C" (counter) event: a sampled series point."""
    ev = {"name": name, "cat": cat, "ph": "C", "ts": _ts_us(now()),
          "pid": os.getpid(), "tid": threading.get_ident(),
          "args": {"value": value}}
    _append(ev)


def add_event(name: str, ts_us: float, dur_us: float, cat: str = "op",
              args: Optional[Dict[str, Any]] = None,
              pid: Optional[int] = None, tid: Optional[int] = None) -> None:
    """Append a complete event at explicit epoch-relative microsecond
    coordinates: for converters and deterministic tests."""
    ev = {"name": name, "cat": cat, "ph": "X", "ts": float(ts_us),
          "dur": float(dur_us), "pid": os.getpid() if pid is None else pid,
          "tid": threading.get_ident() if tid is None else tid}
    if args:
        ev["args"] = args
    _append(ev)


class _Span:
    """A scoped span.  Enabled-ness is read at __enter__, so a span
    opened while tracing is on closes correctly if tracing flips inside.
    While tracing, each span takes a ``span_id``, records its parent from
    the ambient context and installs itself as the context, so nested
    spans export a parent chain (``args.span_id`` / ``args.parent_span``)
    beside the enclosing ``trace_id``."""

    __slots__ = ("name", "cat", "args", "_t0", "span_id", "_token")

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = None
        self.span_id = None
        self._token = None

    def __enter__(self):
        if _state.enabled:
            self._t0 = now()
            self.span_id = new_id()
            ctx = _tls.ctx
            trace_id = ctx[0] if ctx is not None else None
            self._token = set_context(trace_id, self.span_id)
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            restore_context(self._token)
            args = dict(self.args) if self.args else {}
            args["span_id"] = self.span_id
            complete(self.name, self._t0, cat=self.cat, args=args)
            self._t0 = None
        return False


def span(name: str, cat: str = "span",
         args: Optional[Dict[str, Any]] = None) -> _Span:
    """``with trace.span("phase"): ...`` for warm paths; per-op loops use
    the now()/complete() pair instead."""
    return _Span(name, cat, args)


def get_events(start: int = 0) -> List[Dict[str, Any]]:
    """Copy of the event buffer from index ``start`` (default: all)."""
    with _state.lock:
        return _state.events[start:] if start else list(_state.events)


def event_count() -> int:
    with _state.lock:
        return len(_state.events)


def tail_events(n: int) -> List[Dict[str, Any]]:
    """Copy of the last ``n`` events."""
    n = int(n)
    if n <= 0:
        return []
    with _state.lock:
        return _state.events[-n:]


def buffer_generation() -> int:
    """How many times reset() ran: incremental readers drop their cursor
    when this moves."""
    with _state.lock:
        return _state.generation


def dropped_count() -> int:
    """Events dropped since the buffer filled (FLAGS_trace_max_events).
    Nonzero means span-derived views are blind to recent activity."""
    with _state.lock:
        return _state.dropped


def reset() -> None:
    """Clear the event buffer.  Metrics survive; reset_all() clears both.
    The epoch is not rebased: a span open across the reset still exports
    a non-negative ts."""
    with _state.lock:
        _state.events.clear()
        _state.dropped = 0
        _state.generation += 1
    _registry.gauge("trace.dropped_events").set(0)


def reset_all() -> None:
    """Clear events and metrics: test isolation in one call."""
    reset()
    _registry.reset_all()


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

class Counter:
    """Integer counter (``add`` may be negative).  Thread-safe."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    def inc(self, n: int = 1) -> int:
        return self.add(n)

    def dec(self, n: int = 1) -> int:
        return self.add(-n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins sampled value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0) -> float:
        """Atomic increment."""
        with self._lock:
            self._value += float(n)
            return self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def snapshot(self):
        return self.value


class Histogram:
    """Timing histogram: running count/total/min/max plus coarse
    power-of-4 microsecond buckets (enough to tell a 100 us step from a
    10 ms one without storing samples).  Percentiles are estimated from
    the buckets, to within one factor-of-4 bucket."""

    __slots__ = ("name", "_lock", "count", "total", "min", "max", "_buckets")

    # bucket upper bounds in seconds: 1us..~4.4min, then +inf
    BOUNDS = tuple(1e-6 * 4 ** i for i in range(13)) + (float("inf"),)

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._buckets = [0] * len(self.BOUNDS)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            for i, b in enumerate(self.BOUNDS):
                if v <= b:
                    self._buckets[i] += 1
                    break

    def _percentile_locked(self, q: float) -> float:
        """The q-quantile by linear interpolation inside the bucket that
        holds it, clamped to the observed extremes."""
        if not self.count:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, n in enumerate(self._buckets):
            if not n:
                continue
            if cum + n >= rank:
                lo = 0.0 if i == 0 else self.BOUNDS[i - 1]
                hi = self.BOUNDS[i]
                if hi == float("inf"):      # open top bucket: best bound
                    hi = self.max if self.max is not None else lo
                    lo = min(lo, hi)
                v = lo + (hi - lo) * (rank - cum) / n
                if self.min is not None:
                    v = max(v, self.min)
                if self.max is not None:
                    v = min(v, self.max)
                return v
            cum += n
        return self.max if self.max is not None else 0.0

    def percentile(self, q: float) -> float:
        """Bucket-estimated quantile, q in [0, 1]."""
        with self._lock:
            return self._percentile_locked(float(q))

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"count": self.count, "total": self.total,
                    "min": self.min or 0.0, "max": self.max or 0.0,
                    "avg": self.total / self.count if self.count else 0.0,
                    "p50": self._percentile_locked(0.50),
                    "p95": self._percentile_locked(0.95),
                    "p99": self._percentile_locked(0.99)}

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.min = None
            self.max = None
            self._buckets = [0] * len(self.BOUNDS)

    @property
    def value(self) -> Dict[str, float]:
        return self.stats()

    def snapshot(self):
        return self.stats()


class MetricsRegistry:
    """Typed, thread-safe name -> instrument map; one process-wide
    instance (``metrics()``)."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric '{name}' already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def get(self, name: str):
        """The instrument under ``name``, or None (never creates one)."""
        with self._lock:
            return self._metrics.get(name)

    def items(self) -> List[Tuple[str, Any]]:
        """Point-in-time (name, instrument) list sorted by name; each
        instrument read after is guarded by its own lock, so a concurrent
        scrape never sees a torn value."""
        with self._lock:
            return sorted(self._metrics.items())

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            items = list(self._metrics.items())
        return {n: m.snapshot() for n, m in items}

    def reset_all(self) -> None:
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m.reset()


_registry = MetricsRegistry()


def metrics() -> MetricsRegistry:
    return _registry


def gauge_value(name: str, default: float = 0.0) -> float:
    """Read a gauge or counter without creating it: a missing instrument
    or another type reads as ``default``."""
    inst = _registry.get(name)
    try:
        return float(inst.value) if inst is not None else default
    except (TypeError, AttributeError):
        return default


def counter_value(name: str, default: int = 0) -> int:
    """Integer twin of :func:`gauge_value`."""
    inst = _registry.get(name)
    try:
        return int(inst.value) if inst is not None else default
    except (TypeError, AttributeError):
        return default


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def export_chrome_trace(path: Optional[str] = None) -> str:
    """Write the event buffer (plus a terminal sample of every metric) as
    chrome://tracing / Perfetto JSON, events sorted by ts.  Returns the
    path written."""
    path = path or _state.path
    with _state.lock:
        events = list(_state.events)
    events.sort(key=lambda e: e.get("ts", 0.0))

    meta: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": os.getpid(), "tid": 0,
        "args": {"name": "paddle_tpu_torch"}}]
    for tid in sorted({e["tid"] for e in events}):
        meta.append({"name": "thread_name", "ph": "M", "pid": os.getpid(),
                     "tid": tid, "args": {"name": f"host-{tid}"}})

    tail: List[Dict[str, Any]] = []
    ts = _ts_us(now())
    for name, snap in sorted(_registry.snapshot().items()):
        value = snap if not isinstance(snap, dict) else snap.get("count", 0)
        tail.append({"name": name, "cat": "metric", "ph": "C", "ts": ts,
                     "pid": os.getpid(), "tid": 0, "args": {"value": value}})

    doc = {"traceEvents": meta + events + tail,
           "displayTimeUnit": "ms",
           "metadata": {"producer": "paddle_tpu_torch.fluid.trace",
                        "pid": os.getpid(),
                        # wall-clock instant of timeline ts=0: places
                        # several per-process traces on one axis
                        "epoch_unix_ts": time.time() - elapsed_us() / 1e6,
                        "dropped_events": _state.dropped,
                        "metrics": _registry.snapshot()}}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        # default=str: span args may carry numpy scalars or paths
        json.dump(doc, f, default=str)
    return path


# the profiler's sorted_key contract
SORTED_KEYS = ("default", "calls", "total", "max", "min", "ave")

_SUMMARY_CATS = ("op", "dygraph_op", "comm", "step", "compile", "pass",
                 "annotation")


def op_summary(sorted_key: str = "total", cats=_SUMMARY_CATS):
    """Aggregate complete events into per-name rows ``(name, calls,
    total_us, min_us, max_us, ave_us)``, sorted by ``sorted_key``."""
    if sorted_key is None:
        sorted_key = "default"
    if sorted_key not in SORTED_KEYS:
        raise ValueError(
            f"sorted_key must be one of {SORTED_KEYS}, got {sorted_key!r}")
    cats = set(cats)
    rows: Dict[str, List[float]] = {}
    for e in get_events():
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        dur = float(e.get("dur", 0.0))
        r = rows.get(e["name"])
        if r is None:
            rows[e["name"]] = [1, dur, dur, dur]
        else:
            r[0] += 1
            r[1] += dur
            r[2] = min(r[2], dur)
            r[3] = max(r[3], dur)
    out = [(n, int(c), t, lo, hi, t / c)
           for n, (c, t, lo, hi) in rows.items()]
    col = {"calls": 1, "total": 2, "max": 4, "min": 3, "ave": 5}
    if sorted_key in col:
        out.sort(key=lambda r: r[col[sorted_key]], reverse=True)
    return out


def summary_table(sorted_key: str = "total", cats=_SUMMARY_CATS) -> str:
    """The profiler's text report: Event / Calls / Total / Min. / Max. /
    Ave. in microseconds."""
    rows = op_summary(sorted_key, cats)
    head = (f"{'Event':<40s} {'Calls':>8s} {'Total(us)':>12s} "
            f"{'Min(us)':>10s} {'Max(us)':>10s} {'Ave(us)':>10s}")
    bar = "-" * 25 + f"  Profiling Report (sorted by {sorted_key})  " \
        + "-" * 25
    lines = [bar, head]
    for name, calls, total, lo, hi, ave in rows:
        lines.append(f"{name[:40]:<40s} {calls:>8d} {total:>12.1f} "
                     f"{lo:>10.1f} {hi:>10.1f} {ave:>10.1f}")
    if not rows:
        lines.append("(no events recorded)")
    return "\n".join(lines)


# FLAGS_enable_trace=1 in the environment turns the plane on for the run
if _env_enabled():
    enable()
