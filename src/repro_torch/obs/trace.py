"""Span tracer with Chrome-trace export.

One :class:`Tracer` records a forest of timed spans — nested via a
per-thread stack, joinable across threads (the ``exec/stream.py``
prefetch thread parents its pack spans under the consumer's stream span
via :meth:`Tracer.adopt`) — and exports the standard Chrome trace-event
JSON (``chrome://tracing`` / Perfetto "traceEvents" format).

Instrumented modules never hold a tracer: they call the module-level
:func:`span`, which resolves the *current* tracer from a thread-local
set by :meth:`Tracer.activate`.  When nothing is active the resolution
returns :data:`NULL_TRACER`, whose ``span()`` hands back one shared
no-op context manager — the disabled path costs two attribute lookups
and an empty ``with``, so kernels, the prefetch loop, and the service
workers pay effectively nothing unless a session (or benchmark) opted
in.  That is the one-flag gate: ``SessionConfig(trace=True)`` builds a
real tracer and activates it around each ``verify``; everything else in
the stack is permanently instrumented.

    tracer = Tracer()
    with tracer.activate():
        with span("parse"):
            ...
    tracer.save("trace.json")           # chrome://tracing-loadable
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional

_ACTIVE = threading.local()           # .tracer: the thread's current Tracer


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span (times are ``perf_counter`` seconds)."""

    span_id: int
    parent_id: Optional[int]
    name: str
    t0: float
    t1: float
    tid: int
    thread: str
    attrs: dict

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """The shared no-op span context (also serves as adopt/activate ctx)."""

    __slots__ = ()
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Absent-tracer behaviour: every operation is a no-op."""

    enabled = False

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def current_id(self) -> Optional[int]:
        return None

    def adopt(self, parent_id: Optional[int]):
        return _NULL_SPAN

    def activate(self):
        return _NULL_SPAN


NULL_TRACER = NullTracer()


def current_tracer():
    """The thread's active tracer (:data:`NULL_TRACER` when none)."""
    return getattr(_ACTIVE, "tracer", None) or NULL_TRACER


def span(name: str, **attrs):
    """Open a span on the current tracer (no-op when none is active)."""
    return current_tracer().span(name, **attrs)


class _SpanCtx:
    """Context manager recording one span on enter/exit."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = None
        self.parent_id = None
        self._t0 = 0.0

    def set(self, **attrs) -> None:
        """Attach attributes mid-span (e.g. the routing mode, an accuracy)."""
        self.attrs.update(attrs)

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        self.parent_id = stack[-1] if stack else None
        self.span_id = tr._new_id()
        stack.append(self.span_id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        th = threading.current_thread()
        tr._record(
            Span(
                span_id=self.span_id,
                parent_id=self.parent_id,
                name=self.name,
                t0=self._t0,
                t1=t1,
                tid=th.ident or 0,
                thread=th.name,
                attrs=self.attrs,
            )
        )
        return False


class _Activate:
    """Sets/restores the thread's current tracer (optionally seeding a
    cross-thread parent for :meth:`Tracer.adopt`)."""

    __slots__ = ("_tracer", "_parent", "_prev_tracer", "_prev_stack")

    def __init__(self, tracer: "Tracer", parent_id: Optional[int] = None):
        self._tracer = tracer
        self._parent = parent_id

    def __enter__(self):
        self._prev_tracer = getattr(_ACTIVE, "tracer", None)
        _ACTIVE.tracer = self._tracer
        if self._parent is not None:
            # a worker thread joining under a span that lives on another
            # thread: seed this thread's stack so nesting parents there
            tls = self._tracer._tls
            self._prev_stack = getattr(tls, "stack", None)
            tls.stack = [self._parent]
        else:
            self._prev_stack = None
        return self._tracer

    def __exit__(self, *exc):
        _ACTIVE.tracer = self._prev_tracer
        if self._parent is not None:
            self._tracer._tls.stack = self._prev_stack or []
        return False


class Tracer:
    """Thread-safe span recorder with Chrome trace-event export."""

    enabled = True

    def __init__(self, name: str = "repro"):
        self.name = name
        self.pid = os.getpid()
        #: perf_counter/epoch pair taken together so exported timestamps
        #: can be anchored to wall-clock time
        self.epoch_perf = time.perf_counter()
        self.epoch_wall = time.time()
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._next = 0
        self._tls = threading.local()

    # -- recording ------------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _new_id(self) -> int:
        with self._lock:
            self._next += 1
            return self._next

    def _record(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)

    def span(self, name: str, **attrs) -> _SpanCtx:
        return _SpanCtx(self, name, attrs)

    def current_id(self) -> Optional[int]:
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def activate(self) -> _Activate:
        """Make this the current tracer for the calling thread."""
        return _Activate(self)

    def adopt(self, parent_id: Optional[int]) -> _Activate:
        """Activate on a *worker* thread, parenting new spans under
        ``parent_id`` (captured on the owning thread via
        :meth:`current_id`) — how the prefetch thread's pack spans nest
        under the consumer's stream span."""
        return _Activate(self, parent_id=parent_id)

    # -- queries --------------------------------------------------------------

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def subtree(self, root_id: int) -> list[Span]:
        """``root_id``'s span plus every transitive child."""
        spans = self.spans()
        children: dict[Optional[int], list[Span]] = {}
        for s in spans:
            children.setdefault(s.parent_id, []).append(s)
        out, todo = [], [root_id]
        by_id = {s.span_id: s for s in spans}
        while todo:
            sid = todo.pop()
            if sid in by_id:
                out.append(by_id[sid])
            todo.extend(c.span_id for c in children.get(sid, ()))
        return out

    def summary(self) -> dict:
        """Per-span-name wall-time totals — the "where did the time go"
        table a :class:`~repro_torch.obs.report.Report` embeds."""
        out: dict[str, dict] = {}
        for s in self.spans():
            row = out.setdefault(s.name, {"count": 0, "total_s": 0.0})
            row["count"] += 1
            row["total_s"] += s.duration
        return out

    # -- export ---------------------------------------------------------------

    def to_chrome(self, spans: Optional[list[Span]] = None) -> dict:
        """Chrome trace-event JSON (``chrome://tracing`` / Perfetto)."""
        spans = self.spans() if spans is None else spans
        events = []
        tids = {}
        for s in spans:
            tids.setdefault(s.tid, s.thread)
            events.append(
                {
                    "name": s.name,
                    "ph": "X",
                    "pid": self.pid,
                    "tid": s.tid,
                    "ts": (s.t0 - self.epoch_perf) * 1e6,
                    "dur": s.duration * 1e6,
                    "args": {
                        **s.attrs,
                        "span_id": s.span_id,
                        "parent_id": s.parent_id,
                    },
                }
            )
        for tid, name in tids.items():
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self.pid,
                    "tid": tid,
                    "args": {"name": name},
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "tracer": self.name,
                "epoch_wall": self.epoch_wall,
            },
        }

    def save(self, path, spans: Optional[list[Span]] = None) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(spans), f, indent=1)


class TraceHandle:
    """One verify's span subtree — the per-result trace view
    (``SessionResult.trace`` / ``PipelineResult.trace``)."""

    def __init__(self, tracer: Tracer, root_id: int):
        self.tracer = tracer
        self.root_id = root_id

    def spans(self) -> list[Span]:
        return self.tracer.subtree(self.root_id)

    def root(self) -> Optional[Span]:
        for s in self.spans():
            if s.span_id == self.root_id:
                return s
        return None

    def coverage(self) -> float:
        """Fraction of the root span's wall time covered by its direct
        children (the ≥ 95% acceptance gate: un-spanned gaps inside a
        traced verify must stay under 5%)."""
        return span_coverage(self.spans(), self.root_id)

    def to_chrome(self) -> dict:
        return self.tracer.to_chrome(self.spans())

    def save(self, path) -> None:
        self.tracer.save(path, self.spans())


def span_coverage(spans: list, root_id: int) -> float:
    """Union of direct-child intervals, clipped to the root, over the
    root's duration.  ``spans`` accepts :class:`Span`s or the plain
    dicts :func:`spans_from_chrome` yields."""
    get = lambda s, k: getattr(s, k, None) if not isinstance(s, dict) else s[k]
    root = next((s for s in spans if get(s, "span_id") == root_id), None)
    if root is None:
        return 0.0
    r0, r1 = get(root, "t0"), get(root, "t1")
    if r1 <= r0:
        return 1.0
    ivals = sorted(
        (max(get(s, "t0"), r0), min(get(s, "t1"), r1))
        for s in spans
        if get(s, "parent_id") == root_id
    )
    covered, cur0, cur1 = 0.0, None, None
    for a, b in ivals:
        if b <= a:
            continue
        if cur1 is None or a > cur1:
            if cur1 is not None:
                covered += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        covered += cur1 - cur0
    return covered / (r1 - r0)


def spans_from_chrome(data: dict) -> list[dict]:
    """Parse exported Chrome trace JSON back into span dicts (keys:
    ``name/span_id/parent_id/t0/t1/tid/attrs``) — the export round-trip
    used by the CI trace gate and ``tests/test_obs.py``."""
    out = []
    for ev in data.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        sid = args.pop("span_id", None)
        pid = args.pop("parent_id", None)
        t0 = ev["ts"] / 1e6
        out.append(
            {
                "name": ev["name"],
                "span_id": sid,
                "parent_id": pid,
                "t0": t0,
                "t1": t0 + ev.get("dur", 0) / 1e6,
                "tid": ev.get("tid"),
                "attrs": args,
            }
        )
    return out
