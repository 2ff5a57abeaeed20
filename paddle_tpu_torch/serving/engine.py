"""ServingEngine: admission queue + shape-bucketed continuous batching.

Counterpart of ``paddle_tpu/serving/engine.py``.  Data path of one
request:

    submit(feed) --bounded queue--> batcher thread
        coalesce same-signature requests up to max_batch rows (or until
        the oldest has waited max_wait_us); a request whose deadline
        passed is rejected here -> concatenate rows
        -> dispatch through the async step runner (fluid/async_pipeline.py):
           batch k+1 forms and is queued on the card while batch k runs,
           at most max_inflight batches outstanding
        -> collector thread copies the fetches to the host, hands each
           request its own rows, resolves its ServingFuture, records the
           queue / device / latency split

The engine stamps the program's ``shape_bucketing``/``bucket_edges``
hints (powers of two up to max_batch by default), so the executor pads
each batch to a bucket edge and slices the fetches back to the true row
count: padding rows never reach an answer.  ``warmup()`` runs every
bucket once.

The SLO surface: a per-request deadline (``submit(deadline_ms=)``,
``default_deadline_ms``; a request still queued past it is rejected with
:class:`DeadlineExceededError` and counted in ``timeouts``),
``pause()`` / ``resume()`` (dispatch held, admission open), and the
instruments (``serving.requests`` / ``rejected`` / ``timeouts`` /
``batches`` / ``dispatch_errors`` counters, the ``batch_size`` /
``queue_seconds`` / ``device_seconds`` / ``latency_seconds`` histograms
and the ``queue_depth`` gauge; a named engine writes
``serving.<name>.*`` beside the process aggregate).  Every request has a
``trace_id``, with tracing on or off: with tracing on it names the
request's ``serving::admit`` / ``queue`` / ``request`` spans and its
batch's ``serving::batch`` / ``device`` spans, and the executor step of
that batch carries the batch's id; the flight recorder keeps one wide
record per request either way.  Device times here are host times around
the card's work: ``device_seconds`` runs from the dispatch to the end of
the host copy that waited for the kernels.

The shared pieces the decode engine (serving/decode.py) rides are here
too: ``BaseFuture``, ``FamilyInstruments`` and
``PagePoolExhaustedError``.

``program`` may also be an ``inference.AotPredictor`` (the
``torch.export`` artifact of inference/aot.py): the engine then batches
requests onto its bucket programs, which pad and slice internally.

Not ported yet: mesh and sharded serving (``mesh=``, ``sharding=``;
ROADMAP item 10) and online self-tuning (``auto_tune=``, ``slo_ms=``;
item 9); the engine refuses them by name.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..fluid import compile_cache, core, trace
from ..fluid import flight_recorder as _flight
from ..fluid.async_pipeline import AsyncStepRunner
from ..fluid.core import global_scope
from ..fluid.executor import Executor

__all__ = ["ServingEngine", "ServingFuture", "ServingError",
           "QueueFullError", "EngineClosedError", "PagePoolExhaustedError",
           "DeadlineExceededError", "BaseFuture", "FamilyInstruments"]


class ServingError(RuntimeError):
    """Base class for serving-plane rejections."""


class QueueFullError(ServingError):
    """Admission queue at capacity: the request was rejected at submit —
    backpressure, not an out-of-memory on the card."""


class DeadlineExceededError(ServingError):
    """The request's deadline elapsed while it queued."""


class EngineClosedError(ServingError):
    """submit() after close()."""


class PagePoolExhaustedError(QueueFullError):
    """The decode KV page pool cannot hold the request (serving/decode.py
    block-paged mode): a typed queue-full rejection at admission — the
    paged answer to overload is backpressure, never an out-of-memory on
    the card."""


class BaseFuture:
    """The pending-result machinery every serving-plane future rides
    (ServingFuture here, decode.DecodeFuture): one event, one
    result-or-exception cell, timeout-raising reads."""

    __slots__ = ("_event", "_result", "_exc")

    _pending_msg = "request still pending"

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(self._pending_msg)
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None):
        """The error the request was rejected with, or None once it
        resolved; waits like result()."""
        if not self._event.wait(timeout):
            raise TimeoutError(self._pending_msg)
        return self._exc

    def _resolve(self, result) -> None:
        self._result = result
        self._event.set()

    def _reject(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()


class ServingFuture(BaseFuture):
    """One request's pending result: ``result(timeout)`` blocks until the
    batch holding this request completes, then returns
    ``{fetch_name: ndarray of this request's rows}``; a rejection or a
    timeout resolves it with the :class:`ServingError`.  ``timing`` is
    set at demux: ``{"queue_us", "device_us", "latency_us"}``.
    ``trace_id`` is the request's causal identity, allocated with tracing
    on or off: its spans and its flight-recorder record carry it."""

    __slots__ = ("rows", "trace_id", "timing")

    _pending_msg = "serving request still pending"

    def __init__(self, rows: int, trace_id: Optional[str] = None):
        super().__init__()
        self.rows = rows
        self.trace_id = trace_id
        self.timing: Optional[Dict[str, float]] = None


class FamilyInstruments:
    """Per-engine instrument bundle over one metric family.  A named
    engine writes its own ``<family>.<name>.*`` instruments and also the
    plain ``<family>.*`` aggregate; an unnamed one writes the aggregate
    and instruments of its own that no registry holds.  Reads come from
    the engine's own instruments, so two engines in one process never
    read each other's counts (the reference's unnamed engines read the
    shared aggregate)."""

    def __init__(self, family: str, counters, histograms, gauges,
                 name: Optional[str] = None):
        m = trace.metrics()
        self.name = name or None
        self._c = {}
        self._h = {}
        self._g = {}
        for table, kinds, make, cls in (
                (self._c, counters, m.counter, trace.Counter),
                (self._h, histograms, m.histogram, trace.Histogram),
                (self._g, gauges, m.gauge, trace.Gauge)):
            for b in kinds:
                own = make(f"{family}.{name}.{b}") if name \
                    else cls(f"{family}.{b}")
                table[b] = [own, make(f"{family}.{b}")]

    def count(self, base: str, n: int = 1) -> None:
        for inst in self._c[base]:
            inst.inc(n)

    def observe(self, base: str, v: float) -> None:
        for inst in self._h[base]:
            inst.observe(v)

    def set_gauge(self, base: str, v: float) -> None:
        for g in self._g[base]:
            g.set(v)

    def counter_value(self, base: str) -> int:
        return self._c[base][0].value

    def hist_stats(self, base: str):
        return self._h[base][0].stats()


class _EngineInstruments(FamilyInstruments):
    COUNTERS = ("requests", "rejected", "timeouts", "batches",
                "dispatch_errors")
    HISTOGRAMS = ("batch_size", "queue_seconds", "device_seconds",
                  "latency_seconds")

    def __init__(self, name: Optional[str] = None):
        super().__init__("serving", self.COUNTERS, self.HISTOGRAMS,
                         ("queue_depth",), name)

    def set_queue_depth(self, v: float) -> None:
        self.set_gauge("queue_depth", v)


class _Request:
    __slots__ = ("feed", "rows", "sig", "t_enqueue", "t_ns", "deadline",
                 "future", "trace_id")

    def __init__(self, feed, rows, sig, t_enqueue, deadline, future,
                 trace_id):
        self.feed = feed
        self.rows = rows
        self.sig = sig
        self.t_enqueue = t_enqueue      # monotonic: deadline arithmetic
        self.t_ns = trace.now()         # the trace clock: span windows
        self.deadline = deadline
        self.future = future
        self.trace_id = trace_id


_STOP = object()


# the ops that index a table by an id feed
_ID_LOOKUPS = ("lookup_table", "lookup_table_v2", "fused_embedding_pool")


def id_bounds(program, feed_names) -> Dict[str, int]:
    """{feed: rows of the smallest table it indexes} for each feed that is
    the ``Ids`` of a table lookup in ``program`` (``lookup_table``,
    ``lookup_table_v2``, ``fused_embedding_pool``)."""
    block = program.global_block()
    feeds = set(feed_names)
    out: Dict[str, int] = {}
    for op in block.ops:
        if op.type not in _ID_LOOKUPS:
            continue
        ids, w = op.input("Ids")[0], op.input("W")[0]
        rows = (block._find_var_recursive(w).shape or [-1])[0]
        if ids in feeds and rows is not None and rows > 0:
            out[ids] = min(out.get(ids, rows), int(rows))
    return out


class _ExecutorBackend:
    """Frozen Program + Executor, dispatched through the async step
    runner: ``dispatch`` queues the batch on the executor's device and
    returns at once (it waits only when ``max_inflight`` batches are
    outstanding); ``wait`` copies the fetches to the host (on the card,
    the copy is what waits for the kernels) and retires the batch from
    the window."""

    def __init__(self, program, fetch_names, executor, scope,
                 max_inflight):
        self.program = program
        self.fetch_names = list(fetch_names)
        self.executor = executor
        self.scope = scope
        self.runner = AsyncStepRunner(executor, program, fetch_names,
                                      scope=scope,
                                      max_inflight=max_inflight,
                                      steps_per_dispatch=1)

    def dispatch(self, feed):
        return self.runner.submit(feed)

    def wait(self, fut) -> List[np.ndarray]:
        out = [h.persist() for h in fut.handles()]
        # an idle engine must read executor.inflight_steps == 0
        self.runner.reap()
        return out

    def drain(self):
        self.runner.drain()

    def warmup_run(self, feed) -> None:
        self.executor.run(self.program, feed=feed,
                          fetch_list=self.fetch_names, scope=self.scope,
                          return_numpy=True)

    def id_bounds(self, feed_names) -> Dict[str, int]:
        return id_bounds(self.program, feed_names)

    def feed_specs(self):
        """(name, feature_shape, dtype) per feed, from the IR."""
        block = self.program.global_block()
        out = []
        for n in self.program._hints.get("feed_names", []):
            v = block._find_var_recursive(n)
            shape = list(v.shape or []) if v is not None else []
            out.append((n, [int(d) for d in shape[1:]],
                        (v.dtype if v is not None else None) or "float32"))
        return out


class _AotBackend:
    """AotPredictor-backed dispatch: the bucketed artifact pads and slices
    internally; ``dispatch`` leaves the outputs on the device, so the
    collector's host copy is what waits for the kernels."""

    def __init__(self, predictor):
        self.predictor = predictor

    def dispatch(self, feed):
        return self.predictor.call_lazy(feed)

    def wait(self, outs) -> List[np.ndarray]:
        from ..inference.aot import _host
        return [_host(o) for o in outs]

    def warmup_run(self, feed) -> None:
        self.wait(self.predictor.call_lazy(feed))

    def drain(self):
        pass

    def id_bounds(self, feed_names) -> Dict[str, int]:
        bounds = self.predictor._meta.get("id_bounds") or {}
        return {n: int(h) for n, h in bounds.items() if n in feed_names}

    def feed_specs(self):
        meta = self.predictor._meta
        return [(n, [int(d) for d in meta["input_shapes"].get(n, [])[1:]],
                 meta["input_dtypes"].get(n, "float32"))
                for n in meta["feed_names"]]

    def bucket_edges(self):
        return self.predictor._meta.get("buckets")


class ServingEngine:
    """Continuous-batching server over a frozen Program::

        frozen = serving.freeze_program(main, ["x"], [logits])
        with serving.ServingEngine(frozen) as eng:   # on CUDAPlace(0)
            eng.warmup()                             # every bucket once
            fut = eng.submit({"x": batch})           # -> ServingFuture
            out = fut.result(timeout=1.0)            # {"logits": rows}

    ``program`` may be a ``CompiledProgram`` (its passes apply at the
    first run) or an ``inference.AotPredictor`` (its bucket edges are the
    engine's, and ``max_batch`` is held to the largest).  The executor
    defaults to ``Executor()`` on the card; pass
    ``executor=Executor(CPUPlace())`` to serve on the host.  Knobs
    default to their ``FLAGS_serving_*`` flags: ``max_batch`` rows per
    batch, ``max_wait_us`` batch-formation deadline, ``queue_depth``
    admission bound, ``default_deadline_ms`` per-request deadline (0 =
    none); ``max_inflight`` batches may be outstanding on the device
    (``FLAGS_max_inflight_steps``); ``name`` gives the engine its own
    ``serving.<name>.*`` instruments.
    """

    def __init__(self, program,
                 fetch_names: Optional[Sequence[str]] = None,
                 feed_names: Optional[Sequence[str]] = None,
                 executor: Optional[Executor] = None,
                 scope=None,
                 max_batch: Optional[int] = None,
                 max_wait_us: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 bucket_edges=None,
                 max_inflight: Optional[int] = None,
                 auto_start: bool = True,
                 mesh=None,
                 sharding=None,
                 name: Optional[str] = None,
                 auto_tune: bool = False,
                 slo_ms: Optional[float] = None):
        if mesh is not None or sharding is not None:
            raise NotImplementedError(
                "ServingEngine(mesh=/sharding=): serving one program across "
                "cards is ROADMAP item 10, not ported yet")
        if auto_tune or slo_ms is not None:
            raise NotImplementedError(
                "ServingEngine(auto_tune=/slo_ms=): the online self-tuner "
                "(fluid/autotune.py) is ROADMAP item 9, not ported yet")
        self.name = name
        self._ins = _EngineInstruments(name)
        self.max_batch = int(max_batch
                             or core.get_flag("serving_max_batch", 32))
        self.max_wait_us = int(max_wait_us if max_wait_us is not None
                               else core.get_flag("serving_max_wait_us",
                                                  2000))
        self.queue_depth = int(queue_depth
                               or core.get_flag("serving_queue_depth", 256))
        dl = (default_deadline_ms if default_deadline_ms is not None
              else core.get_flag("serving_default_deadline_ms", 0))
        self.default_deadline_ms = float(dl or 0)
        if hasattr(program, "call_lazy"):           # AotPredictor
            self._backend = _AotBackend(program)
            self.feed_names = list(feed_names
                                   or program.get_input_names())
            self.fetch_names = list(fetch_names
                                    or program.get_output_names())
            edges = bucket_edges or self._backend.bucket_edges()
            if not edges:
                # a single-shape artifact: the one servable batch size is
                # the example's
                shapes = program._meta.get("input_shapes") or {}
                dims = {int(s[0]) for s in shapes.values() if s}
                if len(dims) != 1:
                    raise ValueError(
                        "this AOT artifact has no bucketed programs and no "
                        "common batch dim — re-export with "
                        "save_aot_model(..., bucket_edges=[...])")
                edges = [next(iter(dims))]
            self.bucket_edges = compile_cache.normalize_edges(edges)
            self.max_batch = min(self.max_batch, max(self.bucket_edges))
        else:
            hints = program._hints
            self.feed_names = list(feed_names or hints.get("feed_names")
                                   or [])
            self.fetch_names = list(fetch_names or hints.get("fetch_names")
                                    or [])
            if not self.fetch_names:
                raise ValueError(
                    "ServingEngine needs fetch_names — freeze the program "
                    "first (serving.freeze_program) or pass them "
                    "explicitly")
            self.bucket_edges = compile_cache.normalize_edges(
                bucket_edges or hints.get("bucket_edges")
                or compile_cache.pow2_edges(self.max_batch))
            # per-program opt-in to executor-side bucketing
            hints["shape_bucketing"] = True
            hints["bucket_edges"] = self.bucket_edges
            hints["feed_names"] = list(self.feed_names)
            hints["fetch_names"] = list(self.fetch_names)
            self._backend = _ExecutorBackend(
                program, self.fetch_names,
                executor if executor is not None else Executor(),
                scope or global_scope(),
                max_inflight or core.get_flag("max_inflight_steps", 2))
        # an id outside its table would fail every request of the batch
        # it rides in (and on the card trap in the gather kernel), so
        # submit refuses it for its own request
        self._id_bounds = self._backend.id_bounds(self.feed_names)

        self._auto_start = bool(auto_start)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._completions: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._started = False
        # pause()/resume(): cleared, the batcher holds every dispatch
        # while admission keeps filling the queue
        self._resume = threading.Event()
        self._resume.set()
        self._lock = threading.Lock()
        self._batcher_t: Optional[threading.Thread] = None
        self._collector_t: Optional[threading.Thread] = None
        self.warmup_report: Optional[Dict[str, Any]] = None

    # the engine's own counts (its instruments, whether or not named)
    requests = property(lambda self: self._ins.counter_value("requests"))
    rejected = property(lambda self: self._ins.counter_value("rejected"))
    timeouts = property(lambda self: self._ins.counter_value("timeouts"))
    batches = property(lambda self: self._ins.counter_value("batches"))
    dispatch_errors = property(
        lambda self: self._ins.counter_value("dispatch_errors"))

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ServingEngine":
        with self._lock:
            if self._started or self._closed:
                return self
            self._started = True
            self._batcher_t = threading.Thread(
                target=self._batcher, name="serving-batcher", daemon=True)
            self._collector_t = threading.Thread(
                target=self._collector, name="serving-collector",
                daemon=True)
            self._batcher_t.start()
            self._collector_t.start()
        return self

    def pause(self) -> None:
        """Hold every dispatch (maintenance, drills): admission stays
        open and the queue fills, nothing reaches the device.  A no-op
        after close(), which must drain."""
        if not self._closed:
            self._resume.clear()

    def resume(self) -> None:
        self._resume.set()

    def paused(self) -> bool:
        return not self._resume.is_set()

    def close(self) -> None:
        """Stop admitting, answer everything already admitted, join the
        threads.  Implies :meth:`resume`: a close drains, never waits on
        a paused batcher."""
        self._resume.set()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            started = self._started
        if started:
            self._q.put(_STOP)
            self._batcher_t.join()
            self._collector_t.join()
        else:
            # never started: resolve queued requests with the close
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                req.future._reject(EngineClosedError(
                    "engine closed before its batcher started"))
        self._backend.drain()

    stop = close

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- warmup -------------------------------------------------------------
    def warmup(self, example_feed: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
        """Run every bucket once with zero feeds (the first run also
        applies a CompiledProgram's passes and builds each bucket's run
        plan).  Feed shapes and dtypes come from the program IR;
        ``example_feed`` overrides them.  Returns ``{"buckets",
        "compiles", "seconds"}``, ``compiles`` being the run plans built."""
        specs = self._backend.feed_specs()
        by_name = {n: (feat, dt) for n, feat, dt in specs}
        for n in self.feed_names:
            by_name.setdefault(n, ([], "float32"))
        for n, v in (example_feed or {}).items():
            v = np.asarray(v)
            by_name[n] = (list(v.shape[1:]), str(v.dtype))
        bad = [n for n, (feat, _) in by_name.items()
               if any(d < 0 for d in feat)]
        if bad:
            raise ValueError(
                f"warmup cannot infer feature shapes for feeds {bad}; "
                f"pass example_feed with concretely shaped arrays")
        miss = trace.metrics().counter("executor.compile_cache_miss")
        miss0 = miss.value
        t0 = time.perf_counter()
        for edge in self.bucket_edges:
            feed = {n: np.zeros([int(edge)] + [int(d) for d in
                                               by_name[n][0]],
                                dtype=np.dtype(str(by_name[n][1])))
                    for n in self.feed_names}
            self._backend.warmup_run(feed)
        self.warmup_report = {"buckets": list(self.bucket_edges),
                              "compiles": miss.value - miss0,
                              "seconds": time.perf_counter() - t0}
        return self.warmup_report

    # -- request admission ---------------------------------------------------
    def submit(self, feed: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               trace_id: Optional[str] = None) -> ServingFuture:
        """Admit one request.  Every feed array must share one leading
        (row) dim.  ``deadline_ms`` (default ``default_deadline_ms``; 0 =
        none) bounds its time in the queue.  ``trace_id`` (else the
        ambient ``trace.current_trace_id()``, else a fresh ``req-`` id)
        names it.  Raises :class:`QueueFullError` when the admission
        queue is at capacity, :class:`EngineClosedError` after close()
        and ``ValueError`` for a malformed feed or an id outside the
        table its feed indexes."""
        if self._closed:
            raise EngineClosedError("ServingEngine is closed")
        if not self._started and self._auto_start:
            self.start()
        missing = [n for n in self.feed_names if n not in (feed or {})]
        if missing:
            raise ValueError(f"request missing feeds: {missing}")
        arrs = {n: np.asarray(feed[n]) for n in self.feed_names}
        rows = {a.shape[0] for a in arrs.values() if a.ndim >= 1}
        if len(rows) != 1:
            raise ValueError(
                f"request feeds must share one leading batch dim, got "
                f"{ {n: a.shape for n, a in arrs.items()} }")
        n_rows = int(next(iter(rows)))
        for n, height in self._id_bounds.items():
            a = arrs[n]
            if a.size and (a.min() < 0 or a.max() >= height):
                raise ValueError(
                    f"feed {n!r} holds ids outside its table's [0, "
                    f"{height}): {int(a.min())} .. {int(a.max())}")
        # non-batch feeds cannot be concatenated: their VALUE is part of
        # the coalescing signature
        sig = tuple(sorted(
            (n, a.shape[1:], str(a.dtype))
            if a.ndim >= 1 else (n, a.tobytes(), str(a.dtype))
            for n, a in arrs.items()))
        now = time.monotonic()
        dl_ms = (deadline_ms if deadline_ms is not None
                 else self.default_deadline_ms)
        deadline = now + dl_ms / 1e3 if dl_ms and dl_ms > 0 else None
        trace_id = (trace_id or trace.current_trace_id()
                    or trace.new_trace_id("req"))
        fut = ServingFuture(n_rows, trace_id=trace_id)
        req = _Request(arrs, n_rows, sig, now, deadline, fut, trace_id)
        # closed-check + enqueue under the lock: close() flips _closed
        # under it BEFORE it enqueues _STOP, so no request lands behind
        # the departing batcher
        with self._lock:
            if self._closed:
                raise EngineClosedError("ServingEngine is closed")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self._ins.count("rejected")
                if _flight.enabled():
                    _flight.record_request(trace_id, n_rows,
                                           outcome="rejected")
                exc = QueueFullError(
                    f"admission queue full ({self.queue_depth} requests)"
                    f" — the device is saturated; shed load or raise "
                    f"FLAGS_serving_queue_depth")
                fut._reject(exc)
                raise exc from None
        # admitted only: rejections do not count
        self._ins.count("requests")
        self._ins.set_queue_depth(self._q.qsize())
        if trace.enabled():
            trace.instant("serving::admit", cat="serving",
                          args={"trace_id": trace_id, "rows": n_rows,
                                "deadline_ms": dl_ms or 0})
        return fut

    def infer(self, feed: Dict[str, Any],
              timeout: Optional[float] = None,
              deadline_ms: Optional[float] = None) -> Dict[str, np.ndarray]:
        """Blocking convenience: submit + result."""
        return self.submit(feed, deadline_ms=deadline_ms).result(timeout)

    # -- batcher thread ------------------------------------------------------
    def _timeout_request(self, req: _Request) -> None:
        self._ins.count("timeouts")
        waited_ms = (time.monotonic() - req.t_enqueue) * 1e3
        if trace.enabled():
            trace.complete("serving::queue", req.t_ns, cat="serving",
                           args={"trace_id": req.trace_id,
                                 "outcome": "timeout"})
        if _flight.enabled():
            _flight.record_request(req.trace_id, req.rows,
                                   outcome="timeout",
                                   queue_us=waited_ms * 1e3,
                                   latency_us=waited_ms * 1e3)
        req.future._reject(DeadlineExceededError(
            f"deadline elapsed after {waited_ms:.1f}ms in queue"))

    def _batcher(self) -> None:
        pending: Dict[tuple, List[_Request]] = {}
        stopping = False
        while True:
            max_wait_s = self.max_wait_us / 1e6
            timeout = 0.05
            if pending:
                oldest = min(rs[0].t_enqueue for rs in pending.values())
                timeout = max(0.0, oldest + max_wait_s - time.monotonic())
            items = []
            if not stopping:
                try:
                    items.append(self._q.get(timeout=timeout))
                except queue.Empty:
                    pass
                # greedy drain, bounded at ~2 full batches of rows so
                # overload backs up into the bounded admission queue
                drained = sum(sum(r.rows for r in rs)
                              for rs in pending.values())
                try:
                    while drained < 2 * self.max_batch:
                        it = self._q.get_nowait()
                        items.append(it)
                        if it is not _STOP:
                            drained += it.rows
                except queue.Empty:
                    pass
                self._ins.set_queue_depth(self._q.qsize())
            now = time.monotonic()
            for item in items:
                if item is _STOP:
                    stopping = True
                elif item.deadline is not None and now > item.deadline:
                    self._timeout_request(item)
                else:
                    pending.setdefault(item.sig, []).append(item)
            # dispatch every signature that is full or has waited out
            now = time.monotonic()
            for sig in list(pending):
                reqs = pending[sig]
                total = sum(r.rows for r in reqs)
                aged = (now - reqs[0].t_enqueue) >= max_wait_s
                while reqs and (total >= self.max_batch or aged
                                or stopping):
                    take, taken_rows = [], 0
                    while reqs:
                        r = reqs[0]
                        if take and taken_rows + r.rows > self.max_batch:
                            break
                        take.append(reqs.pop(0))
                        taken_rows += r.rows
                    self._dispatch(take)
                    total = sum(r.rows for r in reqs)
                    if total < self.max_batch and not stopping:
                        break         # leftovers wait for their own age
                if not reqs:
                    del pending[sig]
            if stopping and not pending:
                with self._cv:
                    self._completions.append(_STOP)
                    self._cv.notify()
                return

    def _dispatch(self, reqs: List[_Request]) -> None:
        # paused: hold the dispatch until resume(); close() resumes first,
        # and the timed re-check keeps a pause that races past close()'s
        # resume from wedging the drain
        while not self._resume.wait(0.1):
            if self._closed:
                self._resume.set()
                break
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self._timeout_request(r)
            else:
                live.append(r)
        if not live:
            return
        rows = sum(r.rows for r in live)
        feed = {n: (np.concatenate([r.feed[n] for r in live])
                    if np.ndim(live[0].feed[n]) >= 1 else live[0].feed[n])
                for n in self.feed_names}
        tr_on = trace.enabled()
        # the batch's identity: the member requests' spans name it, and
        # the executor step dispatched below carries it as its context
        batch_id = trace.new_trace_id("batch")
        bucket = compile_cache.bucket_for(rows, self.bucket_edges)
        _t0 = trace.now()
        try:
            # may wait on the async window: that wait is the device
            # saturating, and it throttles batch formation
            with trace.trace_context(batch_id):
                fut = self._backend.dispatch(feed)
        except Exception as exc:    # noqa: BLE001 — resolved, not lost
            for r in live:
                r.future._reject(exc)
                if _flight.enabled():
                    _flight.record_request(r.trace_id, r.rows,
                                           outcome="error",
                                           batch_id=batch_id)
            self._ins.count("dispatch_errors")
            return
        t_dispatch = time.monotonic()
        t_dispatch_ns = trace.now()
        if tr_on:
            # each request's queue span: admit to this dispatch
            for r in live:
                trace.complete("serving::queue", r.t_ns, cat="serving",
                               args={"trace_id": r.trace_id,
                                     "batch_id": batch_id}, end_ns=_t0)
            trace.complete(
                "serving::batch", _t0, cat="serving",
                args={"rows": rows, "n_requests": len(live),
                      "batch_id": batch_id, "bucket": bucket,
                      "request_ids": [r.trace_id for r in live]})
        self._ins.count("batches")
        self._ins.observe("batch_size", float(rows))
        with self._cv:
            self._completions.append((fut, live, rows, t_dispatch,
                                      batch_id, t_dispatch_ns, bucket))
            self._cv.notify()

    # -- collector thread ----------------------------------------------------
    def _collector(self) -> None:
        while True:
            with self._cv:
                while not self._completions:
                    self._cv.wait(timeout=0.5)
                item = self._completions.popleft()
            if item is _STOP:
                return
            fut, reqs, rows, t_dispatch, batch_id, t_dispatch_ns, \
                bucket = item
            try:
                arrays = self._backend.wait(fut)
            except Exception as exc:  # noqa: BLE001 — per-request
                for r in reqs:
                    r.future._reject(exc)
                    if _flight.enabled():
                        _flight.record_request(r.trace_id, r.rows,
                                               outcome="error",
                                               batch_id=batch_id)
                self._ins.count("dispatch_errors")
                continue
            t_done = time.monotonic()
            t_done_ns = trace.now()
            tr_on = trace.enabled()
            device_s = max(t_done - t_dispatch, 0.0)
            self._ins.observe("device_seconds", device_s)
            if tr_on:
                trace.complete("serving::device", t_dispatch_ns,
                               cat="serving",
                               args={"batch_id": batch_id, "rows": rows},
                               end_ns=t_done_ns)
            off = 0
            for r in reqs:
                res = {}
                for name, arr in zip(self.fetch_names, arrays):
                    if arr.ndim >= 1 and arr.shape[0] == rows:
                        res[name] = arr[off:off + r.rows]
                    else:
                        res[name] = arr
                off += r.rows
                queue_s = max(t_dispatch - r.t_enqueue, 0.0)
                latency_s = max(t_done - r.t_enqueue, 0.0)
                self._ins.observe("queue_seconds", queue_s)
                self._ins.observe("latency_seconds", latency_s)
                if tr_on:
                    # the request's whole span, closed at demux:
                    # admit -> queue -> batch -> device -> request
                    trace.complete(
                        "serving::request", r.t_ns, cat="serving",
                        args={"trace_id": r.trace_id,
                              "batch_id": batch_id, "rows": r.rows,
                              "bucket": bucket,
                              "queue_us": round(queue_s * 1e6, 1),
                              "device_us": round(device_s * 1e6, 1)},
                        end_ns=t_done_ns)
                if _flight.enabled():
                    _flight.record_request(
                        r.trace_id, r.rows, outcome="ok",
                        batch_id=batch_id, batch_rows=rows,
                        bucket=bucket, queue_us=queue_s * 1e6,
                        device_us=device_s * 1e6,
                        latency_us=latency_s * 1e6)
                r.future.timing = {"queue_us": queue_s * 1e6,
                                   "device_us": device_s * 1e6,
                                   "latency_us": latency_s * 1e6}
                r.future._resolve(res)

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Point-in-time SLO snapshot: the engine's counters and its
        histograms' count, avg and p50/p95/p99."""
        out = {
            "name": self.name,
            "requests": self.requests,
            "rejected": self.rejected,
            "timeouts": self.timeouts,
            "batches": self.batches,
            "dispatch_errors": self.dispatch_errors,
            "queue_depth": self._q.qsize(),
            "paused": self.paused(),
            "buckets": list(self.bucket_edges),
        }
        for h in _EngineInstruments.HISTOGRAMS:
            st = self._ins.hist_stats(h)
            out[h] = {k: st[k] for k in ("count", "avg", "p50", "p95",
                                         "p99")}
        return out
