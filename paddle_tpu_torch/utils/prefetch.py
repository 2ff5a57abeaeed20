"""Background-prefetch iterator (counterpart of
``paddle_tpu/utils/prefetch.py``).

Reference: operators/reader/buffered_reader.cc (double buffer thread) and
framework/channel.h — one producer thread fills a bounded queue, the
consumer drains it; producer exceptions are forwarded to the consumer
(not swallowed into a truncated epoch), and cancellation unblocks a
producer stuck on a full queue so no thread or staged device buffer
outlives an error.

Metrics: per-item produce time in the ``loader.produce_seconds``
histogram, the consumer's blocked time in ``loader.consume_wait_seconds``,
the queue fill in the ``loader.queue_depth`` gauge.

Device staging: when ``stage`` is set the queued items hold live device
tensors, so the capacity is capped at ``FLAGS_max_inflight_steps + 1``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional


class Prefetcher:
    """Iterate ``source`` on a background thread through a bounded queue.

    ``stage`` (optional) transforms each item on the producer side (the
    host-to-device copy of batch t+1 then overlaps step t).  Always
    closes cleanly: on consumer error or break the producer is cancelled
    and joined."""

    _STOP = object()

    def __init__(self, source: Iterable, stage: Optional[Callable] = None,
                 capacity: int = 2,
                 on_produce: Optional[Callable[[float], None]] = None):
        from ..fluid import core, trace
        self._source = source
        self._stage = stage
        capacity = max(1, capacity)
        if stage is not None:
            cap = int(core.get_flag("max_inflight_steps", 2) or 1) + 1
            capacity = min(capacity, max(1, cap))
        self._q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._cancel = threading.Event()
        self._on_produce = on_produce
        self._metrics = trace.metrics()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False

    def _note_depth(self):
        self._metrics.gauge("loader.queue_depth").set(self._q.qsize())

    # -- producer -----------------------------------------------------------
    def _put(self, item) -> bool:
        while not self._cancel.is_set():
            try:
                self._q.put(item, timeout=0.1)
                self._note_depth()
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            t_last = time.perf_counter()
            for item in self._source:
                if self._stage is not None:
                    item = self._stage(item)
                dt = time.perf_counter() - t_last
                self._metrics.histogram("loader.produce_seconds").observe(dt)
                if self._on_produce is not None:
                    self._on_produce(dt)
                if not self._put(item):
                    return                   # cancelled
                t_last = time.perf_counter()
            self._put(self._STOP)
        except BaseException as e:           # noqa: BLE001 — forwarded
            self._put(e)

    # -- consumer -----------------------------------------------------------
    def _get_blocking(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self._metrics.histogram("loader.consume_wait_seconds").observe(
            time.perf_counter() - t0)
        self._note_depth()
        return item

    def __iter__(self) -> Iterator[Any]:
        if not self._started:
            self._started = True
            self._thread.start()
        try:
            while True:
                item = self._get_blocking()
                if item is self._STOP:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.close()

    def get(self):
        """Blocking single fetch; returns Prefetcher._STOP at the end."""
        if not self._started:
            self._started = True
            self._thread.start()
        item = self._get_blocking()
        if isinstance(item, BaseException):
            self.close()
            raise item
        return item

    def close(self):
        """Cancel the producer and drain the queue (unblocks q.put) so the
        thread exits and staged device tensors are dropped."""
        self._cancel.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._started:
            self._thread.join(timeout=10)
