"""Metrics registry: thread-safe named counters, gauges and histograms.

Counterpart of the metrics half of ``paddle_tpu/fluid/trace.py``.  The
passes, the freeze step and the serving engines count what they do here;
the kernel-tier rewrite counters ``kernel_tier.<pass>.rewrites`` are
what the tests and ``chip_smoke.py`` read, and the decode engine's
``stats()`` reads its histograms' p50/p99 (``ttft_seconds``,
``step_seconds``, ``batch_occupancy``).  The event stream (spans, trace
ids, timelines, exporters, the flight recorder) is not ported yet, so
``enabled()`` is False.
"""
from __future__ import annotations

import threading
from typing import Any, Dict

__all__ = ["enabled", "metrics", "MetricsRegistry", "Counter", "Gauge",
           "Histogram"]


def enabled() -> bool:
    """Whether the event stream is recording.  Always False until the
    tracing plane is ported."""
    return False


class Counter:
    """Integer counter (``add`` may be negative).  Thread-safe."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


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

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


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

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"count": self.count, "total": self.total,
                    "min": self.min or 0.0, "max": self.max or 0.0,
                    "avg": self.total / self.count if self.count else 0.0,
                    "p50": self._percentile_locked(0.50),
                    "p95": self._percentile_locked(0.95),
                    "p99": self._percentile_locked(0.99)}

    @property
    def value(self) -> Dict[str, float]:
        return self.stats()


class MetricsRegistry:
    """Typed name -> instrument map; one process-wide instance."""

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

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            items = list(self._metrics.items())
        return {n: m.value for n, m in items}


_registry = MetricsRegistry()


def metrics() -> MetricsRegistry:
    return _registry
