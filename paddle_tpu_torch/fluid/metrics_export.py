"""Live metrics export plane: a Prometheus endpoint and JSONL snapshots.

Counterpart of ``paddle_tpu/fluid/metrics_export.py``: two surfaces over
the metrics registry (fluid/trace.py), standard library only.

* **HTTP endpoint** (``FLAGS_metrics_port``): a daemon-thread
  ``http.server`` on 127.0.0.1 unless ``FLAGS_metrics_host`` says
  otherwise, serving

  - ``/metrics`` — the registry in Prometheus text format (counters and
    gauges as they are, histograms as summaries with p50/p95/p99 lines
    from the bucket estimates);
  - ``/stats`` — the compact JSON a router polls: verdict, queue depth,
    p99, the serving counters, named engines and the decode block;
  - ``/goodput`` — the goodput attribution report as JSON;
  - ``/healthz`` and ``/watchdog`` — liveness and the SLO watchdog's
    state.

  Every scrape renders from a point-in-time ``registry.items()`` list,
  each instrument read under its own lock, so concurrent writers never
  produce a torn line.  ``port=0`` binds an ephemeral port, read back
  from ``MetricsServer.port``.
* **JSONL snapshot writer** (``FLAGS_metrics_snapshot_path`` /
  ``FLAGS_metrics_snapshot_interval_s``): a background thread appends one
  self-contained JSON line per interval, and a last one at shutdown.

Both are no-ops while their flags are unset: no thread starts.  The SLO
watchdog and the self-tuner (``fluid/watchdog.py``, ``fluid/autotune.py``)
are ROADMAP item 9's: until they land, ``/healthz`` reads ``ok`` with the
import error beside it, as the reference's does when the import fails,
and ``/stats`` has no ``autotune`` block.  The fleet's aggregated views
(``/fleet/*``, ``register_fleet_provider``) come with ``serving/fleet.py``
(items 10 and 11).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from . import goodput
from . import trace

__all__ = [
    "prometheus_text", "sanitize_metric_name", "goodput_payload",
    "stats_payload", "parse_prometheus_text", "MetricsServer", "SnapshotWriter", "write_snapshot",
    "start_http", "stop_http", "start_snapshots", "stop_snapshots",
    "apply_flags", "shutdown",
]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _uptime_s() -> float:
    """Process wall so far, measured against the TRACE epoch (trace.py
    is imported with fluid, at process start) — not this module's import
    time, which can be hours later when the export plane is enabled
    mid-run via set_flags."""
    return trace.elapsed_us() / 1e6


def sanitize_metric_name(name: str) -> str:
    """Registry names use dots/slashes; Prometheus wants
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = _NAME_RE.sub("_", str(name))
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


def prometheus_text(registry: Optional[trace.MetricsRegistry] = None) -> str:
    """The whole registry in Prometheus text exposition format (0.0.4).

    Counters/gauges are single samples; histograms render as summaries
    (quantile lines from the bucket-estimated p50/p95/p99 plus
    ``_sum``/``_count``).  The instrument list is snapshotted first and
    each read is lock-guarded by the instrument itself, so a scrape
    racing a training loop sees consistent individual values and never a
    torn line."""
    reg = registry or trace.metrics()
    lines = []
    for name, inst in reg.items():
        pname = sanitize_metric_name(name)
        if isinstance(inst, trace.Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {inst.value}")
        elif isinstance(inst, trace.Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(inst.value)}")
        elif isinstance(inst, trace.Histogram):
            s = inst.stats()
            lines.append(f"# TYPE {pname} summary")
            for q, key in (("0.5", "p50"), ("0.95", "p95"),
                           ("0.99", "p99")):
                lines.append(
                    f'{pname}{{quantile="{q}"}} {_fmt(s[key])}')
            lines.append(f"{pname}_sum {_fmt(s['total'])}")
            lines.append(f"{pname}_count {int(s['count'])}")
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    f = float(v)
    if f != f:                          # NaN — Prometheus spells both
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(int(f)) if f == int(f) else repr(f)


def goodput_payload() -> Dict[str, Any]:
    """The /goodput JSON body: exact span attribution when the trace
    plane is on, the metrics-totals estimate otherwise (both refresh
    the ``goodput.*`` gauges so the Prometheus view agrees)."""
    try:
        if trace.enabled():
            rep = goodput.update_gauges()
        else:
            rep = goodput.publish_gauges(
                goodput.from_metrics(_uptime_s()))
    except Exception as e:              # noqa: BLE001 — a scrape must
        return {"error": f"{type(e).__name__}: {e}"}       # never crash
    return rep


def _watchdog_health() -> Dict[str, Any]:
    """The SLO watchdog's state (``{"status": "ok"}`` when none runs) —
    a scrape must never crash on a half-imported forensic plane."""
    try:
        from . import watchdog
        return watchdog.health()
    except Exception as e:              # noqa: BLE001
        return {"status": "ok", "error": f"{type(e).__name__}: {e}"}


def stats_payload() -> Dict[str, Any]:
    """The compact ``/stats`` body a fleet router polls every interval:
    the watchdog verdict, serving queue depth, window p99, and the core
    serving counters in ONE small JSON payload — one cheap request per
    scrape instead of parsing the full Prometheus text.  Named engines
    (``serving.<name>.*``) appear under ``engines``; a process running
    the decode plane reports a ``decode`` block too.  Deliberately does
    NOT refresh goodput (a control-plane poll at router frequency must
    stay O(registry lookup))."""
    m = trace.metrics()
    wd = _watchdog_health()
    _gauge = trace.gauge_value          # shared defensive reads — the
    _counter = trace.counter_value      # watchdog uses the same pair

    def _p99_ms(hist_name):
        inst = m.get(hist_name)
        if isinstance(inst, trace.Histogram):
            return round(inst.percentile(0.99) * 1e3, 3)
        return 0.0

    out: Dict[str, Any] = {
        "status": wd.get("status", "ok"),
        "uptime_s": round(_uptime_s(), 3),
        # a decode replica's backlog lives on decode.queue_depth — fold
        # it in so least_queue routing sees one comparable number no
        # matter which engine kind the replica hosts
        "queue_depth": (_gauge("serving.queue_depth")
                        + _gauge("decode.queue_depth")),
        "p99_ms": _p99_ms("serving.latency_seconds"),
        "window_p99_ms": round(_gauge("watchdog.window_p99_ms"), 3),
        "requests": _counter("serving.requests"),
        "batches": _counter("serving.batches"),
        "rejected": _counter("serving.rejected"),
        "timeouts": _counter("serving.timeouts"),
    }
    # named engines: serving.<name>.queue_depth marks a namespace
    engines: Dict[str, Any] = {}
    for name, _ in m.items():
        parts = name.split(".")
        if len(parts) == 3 and parts[0] == "serving" \
                and parts[2] == "queue_depth":
            eng = parts[1]
            engines[eng] = {
                "queue_depth": _gauge(name),
                "p99_ms": _p99_ms(f"serving.{eng}.latency_seconds"),
                "requests": _counter(f"serving.{eng}.requests"),
                "batches": _counter(f"serving.{eng}.batches"),
            }
    if engines:
        out["engines"] = engines
    # self-tuning decisions (fluid/autotune.py): the fleet monitor and
    # diagnose tooling see what the tuner did from the same cheap poll.
    # Only present once the tuner has actually acted — the payload stays
    # small for untuned processes.
    try:
        from . import autotune
        at = autotune.state()
        if (at.get("enabled") or at.get("accepts") or at.get("rejects")
                or at.get("reverts") or at.get("warm_starts")):
            out["autotune"] = at
    except Exception:                   # noqa: BLE001 — a scrape never
        pass                            # crashes on a half-imported tuner
    if m.get("decode.requests") is not None:
        out["decode"] = {
            "requests": _counter("decode.requests"),
            "tokens": _counter("decode.tokens"),
            "steps": _counter("decode.steps"),
            "active_slots": _gauge("decode.active_slots"),
            "queue_depth": _gauge("decode.queue_depth"),
            # paged-KV / prefix-cache / speculative instruments (0 when
            # the engine runs the dense path — cheap, stable schema)
            "kv_pages_in_use": _gauge("decode.kv_pages_in_use"),
            "kv_page_pool_free": _gauge("decode.kv_page_pool_free"),
            "prefix_hits": _counter("decode.prefix_hits"),
            "prefix_evictions": _counter("decode.prefix_evictions"),
            "prefix_drops": _counter("decode.prefix_drops"),
            "spec_proposed": _counter("decode.spec_proposed"),
            "spec_accepted": _counter("decode.spec_accepted"),
        }
    return out


def parse_prometheus_text(text: str) -> List[Dict[str, Any]]:
    """Parse the exposition format :func:`prometheus_text` renders back
    into families: ``[{"name", "type", "samples": [(sample_name,
    labels_dict, value), ...]}, ...]``.  Summary families carry their
    quantile lines plus ``_sum``/``_count`` samples.  The fleet
    aggregator uses this to re-label and roll up replica scrapes;
    unknown/malformed lines are skipped, never fatal."""
    fams: List[Dict[str, Any]] = []
    by_name: Dict[str, Dict[str, Any]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                fam = {"name": parts[2], "type": parts[3], "samples": []}
                fams.append(fam)
                by_name[parts[2]] = fam
            continue
        try:
            sample, value_s = line.rsplit(None, 1)
            value = float(value_s)
        except ValueError:
            continue
        labels: Dict[str, str] = {}
        sname = sample
        if sample.endswith("}") and "{" in sample:
            sname, _, lab = sample.partition("{")
            for item in lab[:-1].split(","):
                if "=" in item:
                    k, _, v = item.partition("=")
                    labels[k.strip()] = v.strip().strip('"')
        fam = by_name.get(sname)
        if fam is None and (sname.endswith("_sum")
                            or sname.endswith("_count")):
            fam = by_name.get(sname.rsplit("_", 1)[0])
        if fam is None:
            fam = {"name": sname, "type": "untyped", "samples": []}
            fams.append(fam)
            by_name[sname] = fam
        fam["samples"].append((sname, labels, value))
    return fams


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-torch-metrics/1.0"
    protocol_version = "HTTP/1.1"

    def do_GET(self):                   # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        if path in ("/", "/metrics"):
            # refresh the goodput gauges so a plain Prometheus scrape
            # carries goodput_ratio without a second endpoint, and the
            # trace-drop gauge so attribution blindness is scrapeable
            # live (not just in export metadata at run end)
            goodput_payload()
            trace.metrics().gauge("trace.dropped_events").set(
                trace.dropped_count())
            body = prometheus_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/goodput":
            body = json.dumps(goodput_payload(), default=str).encode()
            ctype = "application/json"
        elif path == "/healthz":
            # liveness + the SLO watchdog's verdict: a fleet router
            # reads the status word (ok / stalled / breached) as its
            # ejection signal; /watchdog has the full state
            body = (_watchdog_health().get("status", "ok") + "\n").encode()
            ctype = "text/plain"
        elif path == "/watchdog":
            body = json.dumps(_watchdog_health(), default=str).encode()
            ctype = "application/json"
        elif path == "/stats":
            # a router's control-plane poll: verdict + queue depth +
            # window p99 in one compact payload
            body = json.dumps(stats_payload(), default=str).encode()
            ctype = "application/json"
        else:
            body = b"not found\n"
            self.send_response(404)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):       # scrapes are not stderr news
        pass


class MetricsServer:
    """The /metrics HTTP surface on a daemon thread.  ``port=0`` binds
    ephemeral; read the real one from ``.port``."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)
        self._thread.start()
        trace.metrics().gauge("metrics.export_port").set(self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)


def write_snapshot(path: str) -> Dict[str, Any]:
    """Append one self-contained JSONL metrics snapshot (histograms as
    their full stats dicts incl. p50/p95/p99) and return the row."""
    trace.metrics().gauge("trace.dropped_events").set(
        trace.dropped_count())
    row = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "uptime_s": round(_uptime_s(), 3),
        "metrics": trace.metrics().snapshot(),
        "goodput": goodput_payload(),
        "watchdog": _watchdog_health(),
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(row, default=str) + "\n")
    return row


class SnapshotWriter:
    """Background JSONL snapshot loop for headless runs: one line every
    ``interval_s``, plus a final line at ``stop()`` so short runs always
    leave at least one record."""

    def __init__(self, path: str, interval_s: float = 60.0):
        self.path = str(path)
        self.interval_s = max(0.01, float(interval_s))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="metrics-snapshot", daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self._write()

    def _write(self):
        try:
            write_snapshot(self.path)
        except Exception:               # noqa: BLE001 — a full disk must
            trace.metrics().counter(    # not kill training
                "metrics.snapshot_errors").inc()

    def stop(self) -> None:
        if not self._stop.is_set():
            self._stop.set()
            self._thread.join(timeout=10)
            self._write()               # terminal snapshot


# ---------------------------------------------------------------------------
# module-level lifecycle (flag-driven)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_server: Optional[MetricsServer] = None
_server_flagged = False             # started by apply_flags (vs direct)
_writer: Optional[SnapshotWriter] = None
_writer_flagged = False
_atexit_registered = False


def _register_atexit():
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        import atexit
        atexit.register(shutdown)


def start_http(port: Optional[int] = None,
               host: Optional[str] = None) -> MetricsServer:
    """Start (or return) the process metrics server.  ``port=None``
    reads FLAGS_metrics_port (and marks the server flag-managed, so
    later ``apply_flags`` reconciliation may stop/restart it — a server
    started with an explicit port is left alone).  ``host`` defaults to
    FLAGS_metrics_host (127.0.0.1: the registry names executables and
    checkpoints — exposing it beyond the host is an explicit opt-in via
    FLAGS_metrics_host=0.0.0.0)."""
    global _server, _server_flagged
    from . import core
    with _lock:
        if _server is not None:
            return _server
        flagged = port is None
        if port is None:
            port = int(core.get_flag("metrics_port", 0) or 0)
        if host is None:
            host = str(core.get_flag("metrics_host", "127.0.0.1")
                       or "127.0.0.1")
        _server = MetricsServer(int(port), host=host)
        _server_flagged = flagged
        _register_atexit()
        return _server


def stop_http() -> None:
    global _server, _server_flagged
    with _lock:
        srv, _server = _server, None
        _server_flagged = False
    if srv is not None:
        srv.stop()
        trace.metrics().gauge("metrics.export_port").set(0)


def start_snapshots(path: Optional[str] = None,
                    interval_s: Optional[float] = None) -> SnapshotWriter:
    """Start (or return) the process snapshot writer.  ``path=None``
    reads the flags and marks the writer flag-managed (like
    :func:`start_http`: only flag-started surfaces are reconciled by
    ``apply_flags``; a writer started with an explicit path belongs to
    its caller)."""
    global _writer, _writer_flagged
    with _lock:
        if _writer is not None:
            return _writer
        flagged = path is None
        if path is None or interval_s is None:
            from . import core
            path = path or core.get_flag("metrics_snapshot_path")
            if interval_s is None:
                interval_s = float(
                    core.get_flag("metrics_snapshot_interval_s", 60.0)
                    or 60.0)
        if not path:
            raise ValueError("start_snapshots needs a path "
                             "(FLAGS_metrics_snapshot_path)")
        _writer = SnapshotWriter(str(path), interval_s)
        _writer_flagged = flagged
        _register_atexit()
        return _writer


def stop_snapshots() -> None:
    global _writer, _writer_flagged
    with _lock:
        w, _writer = _writer, None
        _writer_flagged = False
    if w is not None:
        w.stop()


def apply_flags() -> None:
    """Reconcile the running surfaces with the current flags — called
    from ``fluid.core.set_flags`` and at import when the FLAGS_metrics_*
    env vars are set.  Unset flags stop the corresponding surface, so
    ``set_flags({"FLAGS_metrics_port": 0})`` is the off switch.  Only
    flag-started servers are reconciled: one started programmatically
    (``start_http(port=...)``, e.g. on an ephemeral port in tests)
    belongs to its caller and is never stopped from here."""
    from . import core
    port = int(core.get_flag("metrics_port", 0) or 0)
    host = str(core.get_flag("metrics_host", "127.0.0.1") or "127.0.0.1")
    path = core.get_flag("metrics_snapshot_path")
    interval = float(core.get_flag("metrics_snapshot_interval_s", 60.0)
                     or 60.0)
    with _lock:
        server, flagged = _server, _server_flagged
        writer, w_flagged = _writer, _writer_flagged
    if server is None:
        if port:
            start_http()            # port=None: reads flags, stays
    elif flagged:                   # flag-managed for later reconciles
        if not port or server.port != port or server.host != host:
            stop_http()
            if port:
                start_http()
    if writer is None:
        if path:
            start_snapshots()       # path=None: reads flags, stays
    elif w_flagged:
        if not path or writer.path != str(path) \
                or writer.interval_s != interval:
            stop_snapshots()
            if path:
                start_snapshots()


def shutdown() -> None:
    """Stop both surfaces (atexit hook; the writer flushes a final
    snapshot)."""
    try:
        stop_snapshots()
    finally:
        stop_http()
