"""Telemetry export: Prometheus text rendering, JSONL sampling, scrape HTTP.

Three ways numbers leave the process:

  * :func:`render_prometheus` — any :class:`~repro_torch.obs.metrics.
    MetricsRegistry` as Prometheus text exposition (counters as
    ``*_total``, gauges with a ``*_max`` high-water twin, histogram
    summaries as ``_count``/``_sum`` + quantile lines).  Dotted
    instrument names are sanitized to the Prometheus charset;
    :func:`parse_prometheus` parses the text back (the CI round-trip
    gate: render → parse → same counter values).
  * :class:`Sampler` — a daemon thread appending one JSONL time-series
    snapshot per interval (gauge value+max, histogram count/p50/p95,
    counters) while a service run or benchmark suite executes; the file
    is the raw material for queue-depth / slot-occupancy plots across a
    run, uploaded by CI next to the BENCH JSONs.
  * :func:`start_metrics_server` — a stdlib ``http.server`` scrape
    endpoint: ``GET /metrics`` renders the live registry, ``GET /stats``
    returns an arbitrary stats callable as JSON (what ``repro top``
    polls).  No third-party dependency; ``ThreadingHTTPServer`` so a
    slow scraper never blocks the service.
"""
from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from repro_torch.obs.metrics import MetricsRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LINE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s]+)\s*$'
)


def sanitize_metric_name(name: str) -> str:
    """Dotted registry names -> Prometheus charset (``a.b-c`` -> ``a_b_c``)."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def render_prometheus(registry: MetricsRegistry, *,
                      namespace: str = "repro") -> str:
    """Text exposition (version 0.0.4) of every instrument in ``registry``.

    Counters become ``<ns>_<name>_total``; gauges emit the live value and
    a ``_max`` high-water twin (the peak queue depth / slot occupancy the
    last-value export used to silently lose); histograms emit summary
    ``_count``/``_sum`` plus ``quantile``-labelled p50/p95/p99 lines.
    """
    snap = registry.snapshot()
    lines: list[str] = []

    def emit(name: str, kind: str, value, labels: str = "") -> None:
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name}{labels} {value}")

    for key, v in sorted(snap["counters"].items()):
        emit(f"{namespace}_{sanitize_metric_name(key)}_total", "counter", v)
    for key, g in sorted(snap["gauges"].items()):
        base = f"{namespace}_{sanitize_metric_name(key)}"
        emit(base, "gauge", g["value"])
        emit(f"{base}_max", "gauge", g["max"])
    for key, s in sorted(snap["histograms"].items()):
        base = f"{namespace}_{sanitize_metric_name(key)}"
        lines.append(f"# TYPE {base} summary")
        for q in ("p50", "p95", "p99"):
            if q in s:
                lines.append(
                    f'{base}{{quantile="0.{q[1:]}"}} {s[q]}'
                )
        lines.append(f"{base}_sum {s.get('sum', 0.0)}")
        lines.append(f"{base}_count {s.get('count', 0)}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict[str, float]:
    """Text exposition -> ``{metric_name[{labels}]: value}``.

    Minimal but sufficient for the round-trip gate: comments/TYPE lines
    are skipped, label sets are kept verbatim in the key.
    """
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            continue
        key = m.group("name")
        if m.group("labels"):
            key += "{" + m.group("labels") + "}"
        out[key] = float(m.group("value"))
    return out


def _jsonable(obj):
    """json.dumps default= for stats payloads (dataclasses, shapes, ...)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


class Sampler:
    """Background thread appending periodic registry snapshots as JSONL.

    One line per ``interval_s``: wall/elapsed time, every gauge's
    value+max, every histogram's count/mean/p50/p95, and raw counters —
    the time axis the point-in-time ``Report`` lacks.  ``extra`` is an
    optional callable returning a dict merged into each line (e.g. a
    service's pending-ticket count).  Stop flushes one final sample, so
    even a run shorter than the interval leaves at least one line.
    """

    def __init__(self, path, registry: MetricsRegistry, *,
                 interval_s: float = 0.5,
                 extra: Optional[Callable[[], dict]] = None):
        self.path = str(path)
        self.registry = registry
        self.interval_s = max(0.01, float(interval_s))
        self.extra = extra
        self.samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0
        self._file = None
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Sampler":
        if self._thread is not None:
            return self
        self._t0 = time.perf_counter()
        self._file = open(self.path, "a")
        self._thread = threading.Thread(
            target=self._loop, name="obs-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> int:
        """Stop the thread, flush a final sample; returns samples written."""
        if self._thread is None:
            return self.samples
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._thread = None
        self._sample()                 # the closing bookend
        with self._lock:
            self._file.close()
            self._file = None
        return self.samples

    def __enter__(self) -> "Sampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- internals -----------------------------------------------------------

    def _sample(self) -> None:
        snap = self.registry.snapshot()
        line = {
            "t": time.time(),
            "elapsed_s": time.perf_counter() - self._t0,
            "gauges": snap["gauges"],
            "histograms": {
                k: {q: s[q] for q in ("count", "mean", "p50", "p95") if q in s}
                for k, s in snap["histograms"].items()
            },
            "counters": snap["counters"],
        }
        if self.extra is not None:
            try:
                line.update(self.extra())
            except Exception:  # noqa: BLE001 — telemetry must not kill the run
                pass
        with self._lock:
            if self._file is None:
                return
            self._file.write(json.dumps(line, default=_jsonable) + "\n")
            self._file.flush()
            self.samples += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._sample()


class _MetricsHandler(BaseHTTPRequestHandler):
    server: "MetricsServer"

    def do_GET(self):  # noqa: N802 — http.server API
        try:
            if self.path.split("?")[0] in ("/metrics", "/"):
                body = render_prometheus(self.server.registry_fn()).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?")[0] == "/stats":
                body = json.dumps(
                    self.server.stats_fn(), default=_jsonable, indent=1
                ).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
        except Exception as e:  # noqa: BLE001 — a scrape must not crash us
            self.send_error(500, str(e))
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-scrape stderr noise
        pass


class MetricsServer:
    """A live scrape endpoint over a registry (+ optional stats callable)."""

    def __init__(self, registry_or_fn, *, port: int = 0,
                 stats_fn: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1"):
        if callable(registry_or_fn):
            self.registry_fn = registry_or_fn
        else:
            self.registry_fn = lambda: registry_or_fn
        self.stats_fn = stats_fn or (lambda: self.registry_fn().snapshot())
        self._httpd = ThreadingHTTPServer((host, port), _MetricsHandler)
        self._httpd.registry_fn = self.registry_fn        # type: ignore[attr-defined]
        self._httpd.stats_fn = self.stats_fn              # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-http",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(registry_or_fn, *, port: int = 0,
                         stats_fn: Optional[Callable[[], dict]] = None
                         ) -> MetricsServer:
    """Serve ``/metrics`` (Prometheus) + ``/stats`` (JSON) on ``port``
    (0 = ephemeral; read ``server.port``)."""
    return MetricsServer(registry_or_fn, port=port, stats_fn=stats_fn)
