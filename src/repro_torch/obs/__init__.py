"""repro_torch.obs — unified tracing + metrics spine.

Public surface:

  * tracing: :class:`Tracer`, :func:`span`, :func:`current_tracer`,
    :data:`NULL_TRACER`, :class:`TraceHandle`, plus the Chrome-trace
    round-trip helpers :func:`spans_from_chrome` / :func:`span_coverage`;
  * metrics: :class:`MetricsRegistry`, the process-wide :data:`REGISTRY`,
    :class:`CounterGroup` (the ``PROBE`` bridge), :func:`fold_into`;
  * reporting: :class:`Report` (built by ``Session.report()``);
  * forensics: :class:`FlightRecord` / :class:`FlightRecorder` (one
    structured record per service ticket, bounded ring);
  * export: :func:`render_prometheus` / :func:`parse_prometheus`,
    :class:`Sampler` (JSONL time series), :func:`start_metrics_server`
    (``/metrics`` + ``/stats`` scrape endpoint).
"""
from repro_torch.obs.export import (
    MetricsServer,
    Sampler,
    parse_prometheus,
    render_prometheus,
    start_metrics_server,
)
from repro_torch.obs.flight import FlightRecord, FlightRecorder, record_from_marks
from repro_torch.obs.metrics import (
    Counter,
    CounterGroup,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    fold_into,
)
from repro_torch.obs.report import Report
from repro_torch.obs.trace import (
    NULL_TRACER,
    NullTracer,
    Span,
    TraceHandle,
    Tracer,
    current_tracer,
    span,
    span_coverage,
    spans_from_chrome,
)

__all__ = [
    "Counter",
    "CounterGroup",
    "FlightRecord",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsServer",
    "NULL_TRACER",
    "NullTracer",
    "REGISTRY",
    "Report",
    "Sampler",
    "Span",
    "TraceHandle",
    "Tracer",
    "current_tracer",
    "fold_into",
    "parse_prometheus",
    "record_from_marks",
    "render_prometheus",
    "span",
    "span_coverage",
    "spans_from_chrome",
    "start_metrics_server",
]
