"""ServingEngine: admission queue + shape-bucketed continuous batching.

Counterpart of ``paddle_tpu/serving/engine.py``.  Data path of one
request:

    submit(feed) --bounded queue--> batcher thread
        coalesce same-signature requests up to max_batch rows (or until
        the oldest has waited max_wait_us) -> concatenate rows
        -> Executor.run on the card, fetches left on the device
        -> collector thread copies the fetches to the host, hands each
           request its own rows, resolves its ServingFuture

The engine stamps the program's ``shape_bucketing``/``bucket_edges``
hints (powers of two up to max_batch by default), so the executor pads
each batch to a bucket edge and slices the fetches back to the true row
count: padding rows never reach an answer.  ``warmup()`` runs every
bucket once.

The shared pieces the decode engine (serving/decode.py) rides are here
too: ``BaseFuture``, ``FamilyInstruments`` (per-engine counters, gauges
and histograms) and ``PagePoolExhaustedError``.

``program`` may also be an ``inference.AotPredictor`` (the
``torch.export`` artifact of inference/aot.py): the engine then batches
requests onto its bucket programs, which pad and slice internally.

Not ported yet: the async step runner, deadlines, pause/resume,
auto-tuning, trace ids and this engine's own metrics instruments, and
mesh/sharded serving.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..fluid import compile_cache, core, trace
from ..fluid.core import global_scope
from ..fluid.executor import Executor

__all__ = ["ServingEngine", "ServingFuture", "ServingError",
           "QueueFullError", "EngineClosedError", "PagePoolExhaustedError",
           "BaseFuture", "FamilyInstruments"]


class ServingError(RuntimeError):
    """Base class for serving-plane rejections."""


class QueueFullError(ServingError):
    """Admission queue at capacity: the request was rejected at submit —
    backpressure, not an out-of-memory on the card."""


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

    def _resolve(self, result) -> None:
        self._result = result
        self._event.set()

    def _reject(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()


class ServingFuture(BaseFuture):
    """One request's pending result: ``result(timeout)`` blocks until the
    batch holding this request completes, then returns
    ``{fetch_name: ndarray of this request's rows}``.  ``timing`` is set
    at demux: ``{"queue_us", "device_us", "latency_us"}``."""

    __slots__ = ("rows", "timing")

    _pending_msg = "serving request still pending"

    def __init__(self, rows: int):
        super().__init__()
        self.rows = rows
        self.timing: Optional[Dict[str, float]] = None


class FamilyInstruments:
    """Per-engine instrument bundle over one metric family.  A named
    engine writes its own ``<family>.<name>.*`` instruments and also the
    plain ``<family>.*`` aggregate; an unnamed one writes the aggregate
    only.  Reads come from the engine's own family."""

    def __init__(self, family: str, counters, histograms, gauges,
                 name: Optional[str] = None):
        m = trace.metrics()
        self.name = name or None
        self._c = {}
        self._h = {}
        self._g = {}
        for table, kinds, make in ((self._c, counters, m.counter),
                                   (self._h, histograms, m.histogram),
                                   (self._g, gauges, m.gauge)):
            for b in kinds:
                insts = [make(f"{family}.{name}.{b}")] if name else []
                insts.append(make(f"{family}.{b}"))
                table[b] = insts

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


class _Request:
    __slots__ = ("feed", "rows", "sig", "t_enqueue", "future")

    def __init__(self, feed, rows, sig, t_enqueue, future):
        self.feed = feed
        self.rows = rows
        self.sig = sig
        self.t_enqueue = t_enqueue
        self.future = future


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
    """Frozen Program + Executor.  ``dispatch`` runs the batch and leaves
    the fetches on the executor's device; ``wait`` copies them to the
    host (on the card, the copy is what waits for the kernels)."""

    def __init__(self, program, fetch_names, executor, scope):
        self.program = program
        self.fetch_names = list(fetch_names)
        self.executor = executor
        self.scope = scope

    def dispatch(self, feed):
        return self.executor.run(self.program, feed=feed,
                                 fetch_list=self.fetch_names,
                                 scope=self.scope, return_numpy=False)

    def wait(self, fetches) -> List[np.ndarray]:
        return [f.numpy() for f in fetches]

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
    default to their ``FLAGS_serving_*`` flags.
    """

    def __init__(self, program,
                 fetch_names: Optional[Sequence[str]] = None,
                 feed_names: Optional[Sequence[str]] = None,
                 executor: Optional[Executor] = None,
                 scope=None,
                 max_batch: Optional[int] = None,
                 max_wait_us: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 bucket_edges=None,
                 auto_start: bool = True):
        self.max_batch = int(max_batch
                             or core.get_flag("serving_max_batch", 32))
        self.max_wait_us = int(max_wait_us if max_wait_us is not None
                               else core.get_flag("serving_max_wait_us",
                                                  2000))
        self.queue_depth = int(queue_depth
                               or core.get_flag("serving_queue_depth", 256))
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
                scope or global_scope())
        # an id outside its table would fail every request of the batch
        # it rides in (and on the card trap in the gather kernel), so
        # submit refuses it for its own request
        self._id_bounds = self._backend.id_bounds(self.feed_names)

        # plain counts: batches is written by the batcher thread only,
        # the others under self._lock
        self.requests = 0        # admitted
        self.rejected = 0        # queue full at submit
        self.batches = 0         # dispatched
        self.dispatch_errors = 0
        self._auto_start = bool(auto_start)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._completions: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._started = False
        self._lock = threading.Lock()
        self._batcher_t: Optional[threading.Thread] = None
        self._collector_t: Optional[threading.Thread] = None

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

    def close(self) -> None:
        """Stop admitting, answer everything already admitted, join the
        threads."""
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

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- warmup -------------------------------------------------------------
    def warmup(self, example_feed: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
        """Run every bucket once with zero feeds (the first run also
        applies a CompiledProgram's passes).  Feed shapes and dtypes come
        from the program IR; ``example_feed`` overrides them.  Returns
        ``{"buckets", "seconds"}``."""
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
        t0 = time.perf_counter()
        for edge in self.bucket_edges:
            feed = {n: np.zeros([int(edge)] + [int(d) for d in
                                               by_name[n][0]],
                                dtype=np.dtype(str(by_name[n][1])))
                    for n in self.feed_names}
            self._backend.warmup_run(feed)
        return {"buckets": list(self.bucket_edges),
                "seconds": time.perf_counter() - t0}

    # -- request admission ---------------------------------------------------
    def submit(self, feed: Dict[str, Any]) -> ServingFuture:
        """Admit one request.  Every feed array must share one leading
        (row) dim.  Raises :class:`QueueFullError` when the admission
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
        fut = ServingFuture(n_rows)
        req = _Request(arrs, n_rows, sig, time.monotonic(), fut)
        # closed-check + enqueue under the lock: close() flips _closed
        # under it BEFORE it enqueues _STOP, so no request lands behind
        # the departing batcher
        with self._lock:
            if self._closed:
                raise EngineClosedError("ServingEngine is closed")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self.rejected += 1
                exc = QueueFullError(
                    f"admission queue full ({self.queue_depth} requests)"
                    f" — the device is saturated; shed load or raise "
                    f"FLAGS_serving_queue_depth")
                fut._reject(exc)
                raise exc from None
            self.requests += 1
        return fut

    def infer(self, feed: Dict[str, Any],
              timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        """Blocking convenience: submit + result."""
        return self.submit(feed).result(timeout)

    # -- batcher thread ------------------------------------------------------
    def _batcher(self) -> None:
        pending: Dict[tuple, List[_Request]] = {}
        stopping = False
        max_wait_s = self.max_wait_us / 1e6
        while True:
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
            for item in items:
                if item is _STOP:
                    stopping = True
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
        rows = sum(r.rows for r in reqs)
        feed = {n: (np.concatenate([r.feed[n] for r in reqs])
                    if np.ndim(reqs[0].feed[n]) >= 1 else reqs[0].feed[n])
                for n in self.feed_names}
        try:
            fetches = self._backend.dispatch(feed)
        except Exception as exc:    # noqa: BLE001 — resolved, not lost
            for r in reqs:
                r.future._reject(exc)
            with self._lock:
                self.dispatch_errors += 1
            return
        self.batches += 1
        with self._cv:
            self._completions.append((fetches, reqs, rows,
                                      time.monotonic()))
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
            fetches, reqs, rows, t_dispatch = item
            try:
                arrays = self._backend.wait(fetches)
            except Exception as exc:  # noqa: BLE001 — per-request
                for r in reqs:
                    r.future._reject(exc)
                with self._lock:
                    self.dispatch_errors += 1
                continue
            t_done = time.monotonic()
            device_s = max(t_done - t_dispatch, 0.0)
            off = 0
            for r in reqs:
                res = {}
                for name, arr in zip(self.fetch_names, arrays):
                    if arr.ndim >= 1 and arr.shape[0] == rows:
                        res[name] = arr[off:off + r.rows]
                    else:
                        res[name] = arr
                off += r.rows
                r.future.timing = {
                    "queue_us": max(t_dispatch - r.t_enqueue, 0.0) * 1e6,
                    "device_us": device_s * 1e6,
                    "latency_us": max(t_done - r.t_enqueue, 0.0) * 1e6}
                r.future._resolve(res)

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {"requests": self.requests, "rejected": self.rejected,
                "batches": self.batches,
                "dispatch_errors": self.dispatch_errors,
                "queue_depth": self._q.qsize(),
                "buckets": list(self.bucket_edges)}
