"""Flight recorder: one structured forensic record per request.

The metrics registry answers "how much / how fast on average"; a
:class:`FlightRecord` answers "what happened to ticket 17".  Each record
carries the request's identity (name, tenant, priority), its routing
facts (bucket, capacity, cached/coalesced flags), a stage *timeline* of
monotonic ``perf_counter`` marks (submit → prepared → admitted →
inferred → done), and — for failures — the attributable failure cause
plus the stage it died in.

The :class:`FlightRecorder` is a bounded, thread-safe ring: a long-lived
service keeps the last ``capacity`` flights in memory at O(capacity)
cost, so post-hoc incident questions ("which tenant's requests queued
behind the spike at 14:03?") are answerable without any external
infrastructure.  ``dump()`` / ``dump_failure()`` write JSON files — the
service dumps a failed ticket's record at failure time, so the forensic
trail survives the process.

Stage-duration contract (what the tests pin): ``stages`` is derived from
*consecutive present marks*, each segment named by the stage it ends in,
so ``sum(stages.values()) == total_s`` exactly and the marks are
monotonic non-decreasing.  A cache hit has only ``submit``/``done``
marks; its whole life is one ``done`` segment.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Optional

#: canonical stage order of a service ticket's life; sync ``verify`` uses
#: the same vocabulary minus ``admitted`` (no device queue to wait in)
STAGE_ORDER = ("submit", "prepared", "admitted", "inferred", "done")

#: segment label for the interval ENDING at each mark (the queue-wait is
#: the time between being prepared and being admitted to a device pack)
SEGMENT_OF = {
    "prepared": "prepare",
    "admitted": "queue_wait",
    "inferred": "infer",
    "done": "finalize",
}


@dataclasses.dataclass(frozen=True)
class FlightRecord:
    """One request's full life, json-safe via :meth:`to_dict`."""

    req_id: int
    name: str
    status: str                       # verified|falsified|...|classified|error
    cached: bool = False
    coalesced: bool = False
    priority: int = 1
    tenant: Optional[str] = None
    bucket: Optional[tuple] = None    # (n_pad, e_pad) of the request's pack
    capacity: Optional[int] = None    # slots per device call when packed
    streamed: bool = False            # ran the oversized partitioned route
    error: Optional[str] = None       # "TypeError: ..." failure cause
    failed_stage: Optional[str] = None
    marks: tuple = ()                 # ((stage, perf_counter), ...) ordered
    stages: dict = dataclasses.field(default_factory=dict)
    total_s: float = 0.0
    # failure-domain facts: transient-launch replays this ticket consumed
    # and the wall-clock budget it was armed with (None = no deadline)
    retries: int = 0
    deadline_s: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.status != "error"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["marks"] = [[s, t] for s, t in self.marks]
        d["bucket"] = list(self.bucket) if self.bucket else None
        return d


def stages_from_marks(marks) -> tuple[dict, float]:
    """(segment durations, total) from an ordered mark list.

    Segments are named after the mark that *ends* them (see
    :data:`SEGMENT_OF`), so they tile the timeline: their sum equals
    ``last - first`` exactly, which is what makes "queue-wait + stage
    durations ≈ total" an assertable invariant rather than a hope.
    """
    if len(marks) < 2:
        return {}, 0.0
    stages: dict[str, float] = {}
    for (_, t0), (name, t1) in zip(marks, marks[1:]):
        seg = SEGMENT_OF.get(name, name)
        stages[seg] = stages.get(seg, 0.0) + (t1 - t0)
    return stages, marks[-1][1] - marks[0][1]


def failed_stage_from_marks(marks) -> str:
    """The segment a request died in: the one *after* its last mark.

    Call this on the timeline as it stood at failure time — before the
    terminal ``done`` mark is stamped — or the answer degenerates to
    ``finalize`` for every failure.
    """
    last = marks[-1][0] if marks else STAGE_ORDER[0]
    idx = STAGE_ORDER.index(last) if last in STAGE_ORDER else 0
    nxt = STAGE_ORDER[min(idx + 1, len(STAGE_ORDER) - 1)]
    return SEGMENT_OF.get(nxt, nxt)


def record_from_marks(
    req_id: int,
    name: str,
    status: str,
    marks,
    **facts,
) -> FlightRecord:
    """Assemble a record, deriving stage durations and — on error — the
    stage the request died in (the segment *after* its last mark)."""
    marks = tuple((str(s), float(t)) for s, t in marks)
    stages, total = stages_from_marks(marks)
    failed_stage = facts.pop("failed_stage", None)
    if status == "error" and failed_stage is None and marks:
        failed_stage = failed_stage_from_marks(marks)
    return FlightRecord(
        req_id=req_id, name=name, status=status, marks=marks,
        stages=stages, total_s=total, failed_stage=failed_stage, **facts,
    )


class FlightRecorder:
    """Bounded thread-safe ring of :class:`FlightRecord`."""

    def __init__(self, capacity: int = 256):
        assert capacity >= 1
        self.capacity = capacity
        self._ring: deque[FlightRecord] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._recorded = 0
        self._failures = 0

    def record(self, rec: FlightRecord) -> FlightRecord:
        with self._lock:
            self._ring.append(rec)
            self._recorded += 1
            if not rec.ok:
                self._failures += 1
        return rec

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def records(self, *, failures_only: bool = False) -> list[FlightRecord]:
        with self._lock:
            out = list(self._ring)
        if failures_only:
            out = [r for r in out if not r.ok]
        return out

    def stats(self) -> dict:
        """Json-safe summary for ``service.stats()["flights"]``."""
        with self._lock:
            ring = list(self._ring)
            recorded, failures = self._recorded, self._failures
        return {
            "recorded": recorded,
            "retained": len(ring),
            "capacity": self.capacity,
            "dropped": recorded - len(ring),
            "failures": failures,
            "last": ring[-1].to_dict() if ring else None,
        }

    # -- forensic dumps ------------------------------------------------------

    def dump(self, path, *, failures_only: bool = False) -> int:
        """Write the retained ring as a JSON list; returns records written."""
        recs = self.records(failures_only=failures_only)
        with open(path, "w") as f:
            json.dump([r.to_dict() for r in recs], f, indent=1)
        return len(recs)

    def dump_failure(self, rec: FlightRecord, directory) -> Optional[str]:
        """Write one failed ticket's record (plus the ring context around
        it) to ``<directory>/flight_fail_<req_id>.json``; returns the path
        (None when the directory cannot be created — a dump must never
        take the service down with it)."""
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, f"flight_fail_{rec.req_id}.json")
            with open(path, "w") as f:
                json.dump(
                    {
                        "failure": rec.to_dict(),
                        "wallclock": time.time(),
                        "context": [r.to_dict() for r in self.records()[-16:]],
                    },
                    f,
                    indent=1,
                )
            return path
        except OSError:
            return None


#: where failure dumps land when no explicit directory is configured —
#: benchmarks/CI set this so forensic trails ride the artifact upload
DUMP_DIR_ENV = "REPRO_FLIGHT_DUMP_DIR"


def failure_dump_dir(configured: Optional[str]) -> Optional[str]:
    """Resolve the dump directory: explicit config wins, else the
    :data:`DUMP_DIR_ENV` environment override, else None (no dump)."""
    return configured or os.environ.get(DUMP_DIR_ENV) or None
