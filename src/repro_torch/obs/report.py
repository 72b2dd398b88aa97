"""The `Report` snapshot: one json-safe answer to "where did the time go".

A :class:`Report` is assembled by ``Session.report()`` (and embedded by
``benchmarks/run.py`` into each ``BENCH_<suite>.json``).  It stitches the
previously scattered stats surfaces into one stable dict:

  * ``session``  — the session's own registry: route counts, per-stage
    latency histograms, folded executor stats;
  * ``process``  — counter movement in the process-wide registry since
    the session was created (kernel probes, jit traces, staged bytes);
  * ``plan_cache`` / ``results_cache`` — hit/miss/eviction rates;
  * ``scheduler`` — ``SchedulerStats`` when the service engine is live;
  * ``exec``     — accumulated streaming-executor ``exec_stats``;
  * ``spans``    — the tracer's per-name wall-time summary when tracing
    was on;
  * ``process_gauges`` — process-registry gauges with their high-water
    marks (peak queue depth / slot occupancy);
  * ``memory_model``   — modeled vs actual packed-peak bytes + drift
    ratio, validating the model that drives ``choose_k``;
  * ``flights``  — flight-recorder summary when any ticket was recorded.

``to_dict()`` drops absent sections and sorts keys, so serialized
reports diff cleanly across runs.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional


def _sorted(obj):
    """Recursively sort dict keys (stable serialization)."""
    if isinstance(obj, dict):
        return {k: _sorted(obj[k]) for k in sorted(obj, key=str)}
    if isinstance(obj, (list, tuple)):
        return [_sorted(v) for v in obj]
    return obj


@dataclasses.dataclass
class Report:
    """Point-in-time observability snapshot (json-safe once ``to_dict``)."""

    created: str
    session: dict
    process: dict
    plan_cache: Optional[dict] = None
    results_cache: Optional[dict] = None
    scheduler: Optional[dict] = None
    exec: Optional[dict] = None
    spans: Optional[dict] = None
    #: process-registry gauges as {name: {value, max}} — the high-water
    #: marks the counter-only ``process`` delta cannot carry
    process_gauges: Optional[dict] = None
    #: model-vs-actual packed-peak accounting ({modeled_peak_bytes,
    #: actual_peak_bytes, drift}) validating the choose_k memory model
    memory_model: Optional[dict] = None
    #: flight-recorder summary (recorded/retained/failures + last record)
    flights: Optional[dict] = None

    def to_dict(self) -> dict:
        out = {"created": self.created}
        for field in (
            "session",
            "process",
            "process_gauges",
            "memory_model",
            "flights",
            "plan_cache",
            "results_cache",
            "scheduler",
            "exec",
            "spans",
        ):
            v = getattr(self, field)
            if v is not None:
                out[field] = _sorted(v)
        return out

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    def __repr__(self) -> str:
        counters = self.session.get("counters", {}) if self.session else {}
        return (
            f"Report(created={self.created!r}, "
            f"verifies={counters.get('session.verifies', 0)}, "
            f"sections={[k for k in self.to_dict() if k != 'created']})"
        )
