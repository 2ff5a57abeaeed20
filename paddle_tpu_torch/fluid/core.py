"""Platform layer: places, the flags the port reads, and the Scope.

Counterpart of ``paddle_tpu/fluid/core.py``.  A Place names a torch
device: ``CUDAPlace(i)`` is ``cuda:i`` and ``CPUPlace()`` is the host.
The Scope maps variable names to torch tensors that live on the place
the executor ran them on.
"""
from __future__ import annotations

import contextlib

import os as _os
from typing import Dict, Optional

import torch

# standard library only; the single source of truth for the trace
# environment parsing and the default timeline path (trace touches core
# only inside functions, so the import order cannot cycle)
from . import trace as _trace


class Place:
    device_kind = "cpu"
    device_id = 0

    def torch_device(self) -> torch.device:
        raise NotImplementedError

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == getattr(other, "device_id", 0))

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    device_kind = "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """One CUDA card (``place.h`` CUDAPlace)."""
    device_kind = "cuda"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r} needs a CUDA device and torch sees none; run on "
                f"the host explicitly with fluid.CPUPlace()")
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"{self!r}: only {torch.cuda.device_count()} CUDA "
                f"device(s) visible")
        return torch.device("cuda", self.device_id)


# ---------------------------------------------------------------------------
# global flags: the subset of paddle_tpu's table this slice reads
# ---------------------------------------------------------------------------
_FLAGS: Dict[str, object] = {
    # the event stream (fluid/trace.py): FLAGS_enable_trace=1 leaves a
    # chrome://tracing timeline at FLAGS_trace_path; trace.enable(),
    # disable() and set_path() keep these two in step
    "enable_trace": _trace.enabled(),
    "trace_path": _trace.get_path(),
    # pad ragged leading batch dims up to a bucket edge (compile_cache.py);
    # bucket_edges=None means powers of two
    "shape_bucketing": _os.environ.get(
        "FLAGS_shape_bucketing", "").strip().lower()
        in ("1", "true", "yes", "on"),
    "shape_bucket_edges": _os.environ.get("FLAGS_shape_bucket_edges") or None,
    # serving plane (serving/engine.py): rows per coalesced device batch,
    # batch-formation deadline, admission queue bound
    "serving_max_batch": int(_os.environ.get(
        "FLAGS_serving_max_batch", "32")),
    "serving_max_wait_us": int(_os.environ.get(
        "FLAGS_serving_max_wait_us", "2000")),
    "serving_queue_depth": int(_os.environ.get(
        "FLAGS_serving_queue_depth", "256")),
    # a request's default deadline (0 = none): past it a queued request is
    # rejected with DeadlineExceededError instead of dispatched
    "serving_default_deadline_ms": float(_os.environ.get(
        "FLAGS_serving_default_deadline_ms", "0") or 0),
    # async step window (fluid/async_pipeline.py): dispatched steps that
    # may be outstanding before submit() waits on the oldest; steps per
    # dispatch above 1 need a captured multi-step executable, not ported
    "max_inflight_steps": int(_os.environ.get(
        "FLAGS_max_inflight_steps", "2")),
    "steps_per_dispatch": int(_os.environ.get(
        "FLAGS_steps_per_dispatch", "1")),
    # profile-guided self-tuning: read by bench-style scripts and stamped
    # on BuildStrategy.auto_tune; the tuner itself is not ported
    "auto_tune": _os.environ.get(
        "FLAGS_auto_tune", "").strip().lower() in ("1", "true", "yes", "on"),
    # the metrics export plane (fluid/metrics_export.py): metrics_port
    # serves /metrics, /stats, /goodput and /healthz on a daemon thread
    # (0 = off), on 127.0.0.1 unless metrics_host says otherwise; the
    # snapshot path and interval append JSONL snapshots
    "metrics_port": int(_os.environ.get("FLAGS_metrics_port", "0") or 0),
    "metrics_host": _os.environ.get("FLAGS_metrics_host", "127.0.0.1"),
    "metrics_snapshot_path": _os.environ.get(
        "FLAGS_metrics_snapshot_path") or None,
    "metrics_snapshot_interval_s": float(_os.environ.get(
        "FLAGS_metrics_snapshot_interval_s", "60") or 60),
    # goodput's rolling attribution window in seconds (0 = the whole run)
    "goodput_window_s": float(_os.environ.get(
        "FLAGS_goodput_window_s", "600") or 600),
    # the flight recorder (fluid/flight_recorder.py): a bounded ring of
    # one wide record per executor step and per served request, on by
    # default, tracing on or off
    "flight_recorder": _os.environ.get(
        "FLAGS_flight_recorder", "1").strip().lower()
        in _trace._TRUE_STRINGS,
    "flight_recorder_events": int(_os.environ.get(
        "FLAGS_flight_recorder_events", "4096") or 4096),
}


def set_flags(flags: Dict[str, object]):
    for k, v in flags.items():
        k = k.removeprefix("FLAGS_")
        if k not in _FLAGS:
            raise KeyError(f"unknown flag {k!r} (known: {sorted(_FLAGS)})")
        if k == "shape_bucket_edges":
            from . import compile_cache
            v = compile_cache.normalize_edges(v)
        _FLAGS[k] = v
        if k == "enable_trace":
            (_trace.enable if v else _trace.disable)()
        elif k == "trace_path":
            _trace.set_path(str(v))
        elif k in ("metrics_port", "metrics_host", "metrics_snapshot_path",
                   "metrics_snapshot_interval_s"):
            # reconcile the export surfaces with the new values: start,
            # restart on a changed port or path, stop on unset
            from . import metrics_export
            metrics_export.apply_flags()
        elif k in ("flight_recorder", "flight_recorder_events"):
            from . import flight_recorder
            flight_recorder.configure(
                capacity=int(_FLAGS.get("flight_recorder_events", 4096)
                             or 4096),
                enabled=bool(_FLAGS.get("flight_recorder", True)))


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    return {n: _FLAGS.get(n.removeprefix("FLAGS_")) for n in names}


def get_flag(name: str, default=None):
    return _FLAGS.get(name, default)


class Scope:
    """name -> tensor map (framework/scope.h analog, flat with parents)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, torch.Tensor] = {}
        self.parent = parent

    def var(self, name):
        return self._vars.get(name)

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def set_var(self, name, value):
        self._vars[name] = value

    def erase(self, name):
        self._vars.pop(name, None)

    def local_var_names(self):
        return list(self._vars)

    def new_scope(self) -> "Scope":
        """A child scope: it finds its parent's vars and keeps its own."""
        return Scope(parent=self)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """Make ``scope`` the global scope inside the block."""
    global _global_scope
    prev, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = prev
