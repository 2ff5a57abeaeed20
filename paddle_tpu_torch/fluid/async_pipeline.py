"""Async step pipeline: lazy fetches and a bounded in-flight window.

Counterpart of ``paddle_tpu/fluid/async_pipeline.py``.  PyTorch's CUDA
launches are already asynchronous: an op returns a device tensor as soon
as its kernels are queued on the stream.  So the framework's job is to
stop forcing synchronisation.  Three pieces live here:

* :class:`FetchHandle` — what ``Executor.run`` returns under
  ``return_numpy=False``: a live device tensor and a ``torch.cuda.Event``
  recorded on the current stream after the step's work was queued.
  ``numpy()`` / ``np.asarray`` / ``float()`` wait on that event (never on
  ``torch.cuda.synchronize()``, which would also wait for every later
  step) and copy to the host.  A host tensor has no event.
* :class:`StepFuture` and :class:`_LazyFetch` — one submitted step's
  handles, and a deferred view of one of them.
* :class:`AsyncStepRunner` — ``submit(feed)`` dispatches steps while at
  most ``FLAGS_max_inflight_steps`` stay outstanding; backpressure waits
  on the oldest step's handles.  A dispatch error is stored on its own
  step's future and raised where that future is read, or by ``drain()``.

The reference's ``steps_per_dispatch=K`` runs K feeds through one
``lax.scan`` executable.  The port's counterpart is a captured CUDA graph
of K steps (ROADMAP queue A item 2, capture), not ported yet: K > 1
raises ``NotImplementedError`` instead of degrading to K dispatches.

Metrics: ``executor.inflight_steps`` / ``executor.inflight_peak`` gauges,
``executor.dispatch_seconds`` and ``executor.host_wait_seconds``
histograms, ``executor.async_steps`` and ``executor.async_dispatch_errors``
counters.

State aliasing: the reference guards lazy fetches of donated buffers.
The port needs no guard: its lowerings never write a scope tensor in
place (the executor rebinds each written name to a new tensor), so a
fetched handle of a parameter keeps the value of its own step
(``tests/test_torch_async_pipeline.py`` holds every state-writing
lowering to that).

Single-threaded contract: one runner is driven from one thread.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import core
from . import trace

__all__ = ["FetchHandle", "StepFuture", "AsyncStepRunner"]


def _to_numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class FetchHandle:
    """A lazy fetch: the live tensor of one fetched var.

    Materialisation (``numpy()`` / ``__array__`` / ``float()``) is the
    only point that waits for the device and copies to the host; until
    then the host keeps dispatching.  ``event`` is a ``torch.cuda.Event``
    recorded after the producing step was queued; waiting on it waits for
    that step and nothing after it.
    """

    __slots__ = ("name", "_raw", "_np", "_event")

    def __init__(self, value, name: Optional[str] = None, event=None):
        self.name = name
        self._raw = value
        self._np: Optional[np.ndarray] = None
        self._event = event

    # -- introspection (no sync) -------------------------------------------
    @property
    def raw(self):
        """The underlying tensor (no host copy, no wait)."""
        return self._raw if self._np is None else self._np

    @property
    def shape(self):
        return tuple(np.shape(self.raw))

    @property
    def dtype(self):
        raw = self.raw
        if hasattr(raw, "detach"):          # a torch tensor
            return np.dtype(str(raw.dtype).removeprefix("torch."))
        return np.dtype(getattr(raw, "dtype", type(raw)))

    @property
    def ndim(self):
        return len(self.shape)

    def is_materialized(self) -> bool:
        return self._np is not None

    # -- synchronisation ----------------------------------------------------
    def _wait(self):
        if self._event is not None:
            self._event.synchronize()

    def block_until_ready(self) -> "FetchHandle":
        """Wait for the device value (no host copy)."""
        if self._np is None:
            self._wait()
        return self

    def persist(self) -> np.ndarray:
        """Materialise to the host and cache it.  Safe under concurrent
        callers: the loser of the race re-reads the winner's value."""
        if self._np is None:
            self._wait()
            raw = self._raw            # local ref: survives a concurrent
            if raw is None:            # winner clearing the attribute
                return self._np
            self._np = _to_numpy(raw)  # publish before dropping the ref
            self._raw = None
        return self._np

    # -- materialisation protocols -----------------------------------------
    def numpy(self) -> np.ndarray:
        return self.persist()

    def __array__(self, dtype=None, copy=None):
        v = self.persist()
        return v.astype(dtype) if dtype is not None else v

    def __float__(self):
        return float(np.ravel(self.persist())[0])

    def __int__(self):
        return int(np.ravel(self.persist())[0])

    def __repr__(self):
        state = "np" if self._np is not None else "device"
        return (f"FetchHandle({self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, {state})")


class _LazyFetch:
    """A deferred view of fetch ``index`` of one step."""

    __slots__ = ("_future", "_index")

    def __init__(self, future: "StepFuture", index: int):
        self._future = future
        self._index = index

    def handle(self) -> FetchHandle:
        return self._future.handles()[self._index]

    def numpy(self) -> np.ndarray:
        return self.handle().persist()

    def __array__(self, dtype=None, copy=None):
        return self.handle().__array__(dtype)

    def __float__(self):
        return float(self.handle())

    def __int__(self):
        return int(self.handle())

    def __repr__(self):
        return f"_LazyFetch(step fetch #{self._index})"


class StepFuture:
    """One submitted step's result: resolves to a list of FetchHandles.

    A dispatch error is stored and raised when this step's handles are
    requested; ``AsyncStepRunner.drain`` raises any error nobody read.
    """

    __slots__ = ("_runner", "_handles", "_error", "_consumed")

    def __init__(self, runner: "AsyncStepRunner"):
        self._runner = runner
        self._handles: Optional[List[FetchHandle]] = None
        self._error: Optional[BaseException] = None
        self._consumed = False

    def _set_handles(self, handles: List[FetchHandle]):
        self._handles = list(handles)

    def _set_error(self, exc: BaseException):
        self._error = exc

    @property
    def dispatched(self) -> bool:
        return self._handles is not None or self._error is not None

    def handles(self) -> List[FetchHandle]:
        """The step's FetchHandles; raises the step's dispatch error if it
        had one."""
        if not self.dispatched:
            self._runner.flush()
        if self._error is not None:
            self._consumed = True
            raise self._error
        return self._handles

    def lazy(self, index: int = 0) -> _LazyFetch:
        """A deferred view of fetch ``index``, read only when used as a
        number."""
        return _LazyFetch(self, index)

    def result(self) -> List[np.ndarray]:
        """Materialise every fetch to numpy (the blocking read)."""
        return [h.persist() for h in self.handles()]

    def __len__(self):
        return len(self.handles())

    def __iter__(self):
        return iter(self.handles())

    def __getitem__(self, i):
        return self.handles()[i]


def _steps_per_dispatch(program, steps_per_dispatch) -> int:
    prog = getattr(program, "_program", program)
    hints = getattr(prog, "_hints", {}) or {}
    if steps_per_dispatch is None:
        steps_per_dispatch = (hints.get("steps_per_dispatch")
                              or core.get_flag("steps_per_dispatch", 1))
    k = max(1, int(steps_per_dispatch or 1))
    if k > 1 and not (hints.get("pipeline_microbatches")
                      or hints.get("recompute_checkpoints")
                      or hints.get("ps_plan") or hints.get("ps_server")):
        raise NotImplementedError(
            f"steps_per_dispatch={k}: running several steps per dispatch "
            f"needs a captured multi-step executable (CUDA graphs, ROADMAP "
            f"queue A item 2), which is not ported yet; use 1")
    return 1


class AsyncStepRunner:
    """Bounded in-flight dispatch window over one (program, fetch set).

    ``submit(feed)`` returns a :class:`StepFuture` at once; at most
    ``max_inflight`` dispatches stay outstanding — the window waits on
    the oldest dispatch's handles, and the waited time lands in
    ``executor.host_wait_seconds`` (beside ``executor.dispatch_seconds``
    for the time spent dispatching), so the overlap is measurable.
    """

    def __init__(self, executor, program, fetch_list: Sequence,
                 scope=None, max_inflight: Optional[int] = None,
                 steps_per_dispatch: Optional[int] = None):
        self._exe = executor
        self._program = program
        self._fetch_list = list(fetch_list or [])
        self._scope = scope
        if max_inflight is None:
            max_inflight = core.get_flag("max_inflight_steps", 2)
        self.max_inflight = max(1, int(max_inflight or 1))
        self.steps_per_dispatch = _steps_per_dispatch(program,
                                                      steps_per_dispatch)
        self._pending: List[tuple] = []    # (feed, future)
        self._inflight: "deque[List[FetchHandle]]" = deque()
        self._error_futures: List[StepFuture] = []

    # -- public -------------------------------------------------------------
    def submit(self, feed: Dict[str, Any]) -> StepFuture:
        fut = StepFuture(self)
        self._pending.append((dict(feed or {}), fut))
        self._dispatch_group()
        return fut

    def flush(self):
        """Dispatch anything buffered now."""
        self._dispatch_group()

    def drain(self):
        """Dispatch everything, wait for every in-flight step, and raise
        the first dispatch error nobody read — an error at dispatch N is
        never lost, even if handle N was never read."""
        self.flush()
        while self._inflight:
            self._wait_oldest()
        for fut in self._error_futures:
            if not fut._consumed:
                fut._consumed = True
                raise fut._error
        self._error_futures = [f for f in self._error_futures
                               if not f._consumed]

    def abort(self):
        """Error-path cleanup: drop buffered feeds (their futures resolve
        to an error), wait out in-flight dispatches and clear stored
        errors, without raising, so the primary exception stays
        primary."""
        aborted = RuntimeError(
            "AsyncStepRunner.abort(): step was buffered when the driving "
            "loop aborted — it was never dispatched")
        for _, fut in self._pending:
            fut._set_error(aborted)
        self._pending = []
        while self._inflight:
            try:
                self._wait_oldest()
            except Exception:       # noqa: BLE001 — cleanup never raises
                pass
        self._error_futures = []

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @property
    def pending(self) -> int:
        """Buffered submits not yet dispatched."""
        return len(self._pending)

    # -- internals ----------------------------------------------------------
    def _dispatch_feeds(self, feeds: List[Dict[str, Any]]
                        ) -> List[List[FetchHandle]]:
        """One group -> per-step handle lists.  Overridable test seam."""
        return [self._exe.run(self._program, feed=f,
                              fetch_list=self._fetch_list,
                              scope=self._scope, return_numpy=False)
                for f in feeds]

    def _dispatch_group(self):
        group, self._pending = self._pending, []
        if not group:
            return
        try:
            # backpressure before dispatching: never more than
            # max_inflight dispatches outstanding
            while len(self._inflight) >= self.max_inflight:
                self._wait_oldest()
        except BaseException:
            # an interrupted wait: the new group was never dispatched;
            # put it back so its futures are not stranded
            self._pending = group + self._pending
            raise
        m = trace.metrics()
        t0 = time.perf_counter()
        try:
            per_step = self._dispatch_feeds([f for f, _ in group])
        except BaseException as exc:    # noqa: BLE001 — stored, not lost
            for _, fut in group:
                fut._set_error(exc)
                self._error_futures.append(fut)
            m.counter("executor.async_dispatch_errors").inc()
            return
        m.histogram("executor.dispatch_seconds").observe(
            time.perf_counter() - t0)
        m.counter("executor.async_steps").inc(len(group))
        # duck-typed executors may hand back raw values: normalise so
        # futures always resolve to FetchHandles
        per_step = [[h if isinstance(h, FetchHandle) else FetchHandle(h)
                     for h in hs] for hs in per_step]
        flat: List[FetchHandle] = []
        for (_, fut), handles in zip(group, per_step):
            fut._set_handles(handles)
            flat.extend(handles)
        self._inflight.append(flat)
        depth = len(self._inflight)
        m.gauge("executor.inflight_steps").set(depth)
        peak = m.gauge("executor.inflight_peak")
        if depth > peak.value:
            peak.set(depth)

    def _wait_oldest(self):
        if not self._inflight:
            return
        handles = self._inflight.popleft()
        t0 = time.perf_counter()
        for h in handles:
            h.block_until_ready()
        m = trace.metrics()
        m.histogram("executor.host_wait_seconds").observe(
            time.perf_counter() - t0)
        m.gauge("executor.inflight_steps").set(len(self._inflight))
