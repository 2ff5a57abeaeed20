"""Always-on flight recorder: a bounded ring of structured wide events.

Counterpart of ``paddle_tpu/fluid/flight_recorder.py``.  The trace plane
(fluid/trace.py) is rich but opt-in; this module keeps **one wide record
per executor step and per served request**, recorded with
``FLAGS_enable_trace`` off too, in a ring of fixed size, so the last
moments before an incident are there when nobody armed anything.

A wide record is one flat dict carrying what an incident responder asks
first:

* step records — ``{"kind": "step", "seq", "ts_us", "step", "dur_us",
  "bucket", "batch_valid", "compile_miss", "fp", "n_fetch", "inflight",
  "goodput_ratio", "rss_bytes", "hbm_peak_bytes", "trace_id"}``
  (``trace_id`` when the step ran under a serving batch's context;
  ``hbm_peak_bytes`` is ``torch.cuda.max_memory_allocated`` once the
  process has touched the card, else 0);
* request records — ``{"kind": "request", "seq", "ts_us", "trace_id",
  "batch_id", "rows", "batch_rows", "bucket", "queue_us", "device_us",
  "latency_us", "outcome"}`` (outcome ``ok`` / ``timeout`` /
  ``rejected`` / ``error``);
* marker records — any other ``kind``, from :func:`record`.

On the hot path ``record()`` costs one enabled boolean, one dict build
and one lock-guarded store into a ring slot.  The process's resident size
and the card's peak are read at most once a second.

Gating: ``FLAGS_flight_recorder`` (on by default) and
``FLAGS_flight_recorder_events`` (ring capacity, default 4096).
``completions`` counts only records of completed work (steps and ``ok``
requests): a storm of rejections is not progress.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import trace

__all__ = [
    "FlightRecorder", "recorder", "enabled", "record", "record_step",
    "record_request", "configure", "reset", "rss_bytes",
]


class FlightRecorder:
    """Fixed-capacity ring of wide-record dicts.  ``total`` counts every
    record ever written; ``completions`` only those that mean work
    completed (steps, ``ok`` requests).  The ring keeps the last
    ``capacity`` records in arrival order."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.capacity = max(16, int(capacity))
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._buf: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self._n = 0                     # records ever written
        self._done = 0                  # completion records only

    @property
    def total(self) -> int:
        with self._lock:
            return self._n

    @property
    def completions(self) -> int:
        with self._lock:
            return self._done

    def record(self, rec: Dict[str, Any],
               progress: Optional[bool] = None) -> None:
        """Store one wide record (adds ``seq`` and ``ts_us``).  A no-op
        when disabled.  ``progress`` marks the record as completed work
        (default: steps and ``ok`` requests)."""
        if not self.enabled:
            return
        if progress is None:
            progress = rec.get("kind") == "step" or (
                rec.get("kind") == "request"
                and rec.get("outcome") == "ok")
        rec["ts_us"] = trace.elapsed_us()
        with self._lock:
            rec["seq"] = self._n
            self._buf[self._n % self.capacity] = rec
            self._n += 1
            if progress:
                self._done += 1

    def snapshot(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        """The kept records oldest to newest (``last`` caps the count),
        each copied."""
        with self._lock:
            n, cap = self._n, self.capacity
            start = max(0, n - cap)
            if last is not None:
                start = max(start, n - int(last))
            out = [dict(r) for r in
                   (self._buf[i % cap] for i in range(start, n))
                   if r is not None]
        return out

    def resize(self, capacity: int) -> None:
        keep = self.snapshot()
        with self._lock:
            self.capacity = max(16, int(capacity))
            self._buf = [None] * self.capacity
            # lay the kept tail out again against the unchanged total
            keep = keep[-self.capacity:]
            for i, rec in enumerate(keep):
                self._buf[(self._n - len(keep) + i) % self.capacity] = rec

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0
            self._done = 0


_recorder = FlightRecorder(
    capacity=int(os.environ.get("FLAGS_flight_recorder_events", "4096")
                 or 4096),
    enabled=os.environ.get("FLAGS_flight_recorder", "1").strip().lower()
    in trace._TRUE_STRINGS)


def recorder() -> FlightRecorder:
    return _recorder


def enabled() -> bool:
    """The one-boolean hot-path guard (as trace.enabled())."""
    return _recorder.enabled


def record(kind: str, **fields) -> None:
    """A generic wide record: a marker."""
    if _recorder.enabled:
        fields["kind"] = kind
        _recorder.record(fields)


def configure(capacity: Optional[int] = None,
              enabled: Optional[bool] = None) -> None:
    """Apply FLAGS_flight_recorder / FLAGS_flight_recorder_events at run
    time (called from core.set_flags)."""
    if enabled is not None:
        _recorder.enabled = bool(enabled)
    if capacity is not None and int(capacity) != _recorder.capacity:
        _recorder.resize(int(capacity))


def reset() -> None:
    """Clear the ring (test isolation)."""
    _recorder.clear()


# ---------------------------------------------------------------------------
# cheap sampling for step records
# ---------------------------------------------------------------------------

# instruments looked up once: record_step pays no registry lookup
_m = trace.metrics()
_g_inflight = _m.gauge("executor.inflight_steps")
_g_goodput = _m.gauge("goodput.ratio")

_rss_cache = [0.0, 0]                   # (monotonic stamp, bytes)
_hbm_cache = [0.0, 0]
_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_bytes(max_age_s: float = 1.0) -> int:
    """This process's resident set size, read from /proc at most once per
    ``max_age_s``."""
    t = time.monotonic()
    if t - _rss_cache[0] > max_age_s:
        _rss_cache[0] = t
        try:
            with open("/proc/self/statm", "rb") as f:
                _rss_cache[1] = int(f.read().split()[1]) * _PAGE
        except (OSError, ValueError, IndexError):
            pass                        # not Linux: keep the last value
    return _rss_cache[1]


def _hbm_peak_bytes(max_age_s: float = 1.0) -> int:
    """The card's peak allocated bytes (``torch.cuda.max_memory_
    allocated``) once CUDA is initialised, read at most once per
    ``max_age_s``; 0 for a process that never touched the card."""
    t = time.monotonic()
    if t - _hbm_cache[0] > max_age_s:
        _hbm_cache[0] = t
        import torch
        if torch.cuda.is_initialized():
            _hbm_cache[1] = int(torch.cuda.max_memory_allocated())
    return _hbm_cache[1]


def record_step(step: int, dur_us: float, bucket=None, batch_valid=None,
                compile_miss: bool = False, fp: Optional[str] = None,
                n_fetch: int = 0) -> None:
    """One wide record per completed executor step.  Callers guard with
    :func:`enabled`, so a disabled recorder costs one boolean."""
    rec: Dict[str, Any] = {
        "kind": "step", "step": int(step), "dur_us": round(dur_us, 1),
        "compile_miss": bool(compile_miss), "n_fetch": int(n_fetch),
        "inflight": _g_inflight.value,
        "goodput_ratio": round(_g_goodput.value, 4),
        "rss_bytes": rss_bytes(),
        "hbm_peak_bytes": _hbm_peak_bytes(),
    }
    if bucket is not None:
        rec["bucket"] = int(bucket)
    if batch_valid is not None:
        rec["batch_valid"] = int(batch_valid)
    if fp:
        rec["fp"] = fp
    tid = trace.current_trace_id()
    if tid is not None:
        rec["trace_id"] = tid
    _recorder.record(rec)


def record_request(trace_id: str, rows: int, outcome: str = "ok",
                   batch_id: Optional[str] = None,
                   batch_rows: Optional[int] = None,
                   bucket=None, queue_us: Optional[float] = None,
                   device_us: Optional[float] = None,
                   latency_us: Optional[float] = None,
                   replica: Optional[str] = None) -> None:
    """One wide record per served, rejected or timed-out request."""
    rec: Dict[str, Any] = {
        "kind": "request", "trace_id": trace_id, "rows": int(rows),
        "outcome": outcome,
    }
    if replica is not None:
        rec["replica"] = replica
    if batch_id is not None:
        rec["batch_id"] = batch_id
    if batch_rows is not None:
        rec["batch_rows"] = int(batch_rows)
    if bucket is not None:
        rec["bucket"] = int(bucket)
    if queue_us is not None:
        rec["queue_us"] = round(queue_us, 1)
    if device_us is not None:
        rec["device_us"] = round(device_us, 1)
    if latency_us is not None:
        rec["latency_us"] = round(latency_us, 1)
    _recorder.record(rec)
