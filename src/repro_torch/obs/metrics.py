"""Metrics registry: counters, gauges, histograms — one namespace.

Before ``repro_torch.obs`` every layer kept its own ad-hoc numbers: trace-time
kernel counters in ``kernels/groot_spmm.PROBE``, per-runner compile
counts in ``service/scheduler.BucketRunner``, streaming probes in
``exec/stream.StreamStats``, cache stats on three different LRU classes.
None shared a registry or an export format, so "where did the time go"
needed four imports and hand-stitched dicts.

:class:`MetricsRegistry` is the one sink.  Instruments are get-or-create
by dotted name (``registry.counter("exec.bytes_h2d")``), thread-safe,
and cheap enough for trace-time probe increments (a counter ``inc`` is
one lock-free int add under CPython's atomic int semantics isn't
guaranteed, so we take a per-instrument lock — still nanoseconds against
the kernel walks they count).  Two registries matter in practice:

  * :data:`REGISTRY` — the process-wide instance.  The kernel ``PROBE``
    counters live here (as a :class:`CounterGroup` view, so the historic
    ``PROBE["weight_gathers"] += 1`` dict idiom keeps working), as do the
    io/exec/gnn counters that are inherently process-global (jit traces,
    plan builds, staged bytes).
  * per-``Session`` instances — route counts, per-stage latency
    histograms, folded executor stats — so two live sessions never read
    each other's numbers (``Session.report()`` isolation).

``snapshot()``/``delta()`` produce plain json-safe dicts — the building
blocks of :class:`repro_torch.obs.report.Report`.
"""
from __future__ import annotations

import threading
from collections import deque
from collections.abc import MutableMapping
from typing import Iterable, Optional


class Counter:
    """Monotonic-by-convention integer (``set`` exists for probe resets)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, v: int) -> None:
        with self._lock:
            self._value = int(v)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-set value plus the high-water mark (queue depths, pool sizes)."""

    __slots__ = ("name", "_value", "_max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v
            if v > self._max:
                self._max = v

    @property
    def value(self) -> float:
        return self._value

    @property
    def max(self) -> float:
        return self._max


class Histogram:
    """Streaming summary: count/sum/min/max plus percentile estimates
    from a bounded reservoir of the most recent observations (plenty for
    per-request latency distributions; O(1) memory)."""

    __slots__ = ("name", "count", "total", "_min", "_max", "_recent", "_lock")

    RESERVOIR = 512

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._recent: deque = deque(maxlen=self.RESERVOIR)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._recent.append(v)

    def summary(self) -> dict:
        with self._lock:
            if not self.count:
                return {"count": 0, "sum": 0.0}
            vals = sorted(self._recent)
            q = lambda p: vals[min(len(vals) - 1, int(p * (len(vals) - 1) + 0.5))]
            return {
                "count": self.count,
                "sum": self.total,
                "mean": self.total / self.count,
                "min": self._min,
                "max": self._max,
                "p50": q(0.50),
                "p95": q(0.95),
                "p99": q(0.99),
            }


class MetricsRegistry:
    """Get-or-create namespace of instruments; snapshots are plain dicts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    # -- export ---------------------------------------------------------------

    def counters(self, prefix: str = "") -> dict[str, int]:
        with self._lock:
            items = list(self._counters.items())
        return {k: c.value for k, c in items if k.startswith(prefix)}

    def snapshot(self, prefix: str = "") -> dict:
        """Json-safe point-in-time view of every instrument under ``prefix``."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        return {
            "counters": {k: c.value for k, c in counters if k.startswith(prefix)},
            "gauges": {
                k: {"value": g.value, "max": g.max}
                for k, g in gauges
                if k.startswith(prefix)
            },
            "histograms": {
                k: h.summary() for k, h in hists if k.startswith(prefix)
            },
        }

    def delta(self, before: dict, prefix: str = "") -> dict[str, int]:
        """Counter movement since a prior ``snapshot()`` (gauges and
        histograms are not differenced — read them from the snapshot)."""
        base = before.get("counters", before) if isinstance(before, dict) else {}
        return {
            k: v - base.get(k, 0)
            for k, v in self.counters(prefix).items()
        }


#: The process-wide registry: kernel probes, io/exec/gnn counters, and
#: anything else inherently global (jit traces happen per process, not
#: per session).  Per-session numbers live on ``Session.obs.metrics``.
REGISTRY = MetricsRegistry()


class CounterGroup(MutableMapping):
    """Dict-shaped view over a set of registry counters.

    The backwards-compatibility bridge for ``kernels.groot_spmm.PROBE``:
    code (and tests) written against the historic probe dict —
    ``PROBE["weight_gathers"] += 1``, ``dict(PROBE)``, iteration in
    ``reset_probe`` — keeps working unchanged while every increment
    lands in the shared registry under ``<prefix>.<key>``.
    """

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 keys: Iterable[str]):
        self._counters = {k: registry.counter(f"{prefix}.{k}") for k in keys}

    def __getitem__(self, key: str) -> int:
        return self._counters[key].value

    def __setitem__(self, key: str, value: int) -> None:
        self._counters[key].set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("CounterGroup keys are fixed at construction")

    def __iter__(self):
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def __repr__(self) -> str:
        return f"CounterGroup({dict(self)})"


def fold_into(registry: MetricsRegistry, prefix: str, stats: dict,
              *, seconds_suffix: str = "_s") -> None:
    """Accumulate a plain stats dict into a registry: ints add to
    counters, float ``*_s`` timings are observed into histograms (the
    bridge that folds one run's ``exec_stats`` into a session report)."""
    for k, v in stats.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        name = f"{prefix}.{k}"
        if isinstance(v, float) or k.endswith(seconds_suffix):
            registry.histogram(name).observe(float(v))
        else:
            registry.counter(name).inc(int(v))
