"""`VerificationService`: submit/poll API + CLI entry point (port of
``repro/service/server.py``).

    svc = VerificationService(params, num_partitions=4, warmup=True)
    ticket = svc.submit_aiger("design.aig")        # or submit_design(...)
    result = svc.result(ticket)                    # blocking; poll() doesn't

Three overlapping execution stages, mirroring a production inference
server:

  * a *prepare pool* (threads) runs the host-side work per request —
    AIGER parsing, structural hashing + cache lookup, feature
    extraction, partitioning, boundary re-growth;
  * a single *device worker* runs a **continuous-batching** loop: every
    prepared item is admitted into a priority-ordered
    :class:`~repro_torch.service.scheduler.SlotPool`, and between any two
    device calls the loop re-drains its queue — so a request arriving
    mid-flight joins the very next same-bucket pack (up to ``capacity``
    slots per call) instead of waiting behind a drained wave.  It is the
    only thread that launches work for packs, on the service's device
    (named with its index, never the thread's current device), and it
    brings each pack's predictions to the host, so ``poll()`` never waits
    on the card;
  * verification (adder extraction + simulation cross-check) runs back
    on the pool, so the device never waits on host post-processing.

Latency/robustness features layered on the loop:

  * **warmup** (``warmup=True``): the configured ``(n_pad, e_pad)`` bucket
    grid — and the streamed route's slot layout when bucket ceilings are
    set — runs one dummy pack each at startup, so no user request meets a
    signature first.  The ``service.cold_compiles`` counter must read 0
    afterwards on the warmed grid (what a cold compile is in the port:
    ``repro_torch.service.scheduler``);
  * **priority lanes**: ``submit(priority=0)`` jumps a saturated queue —
    the pool orders items by ``(priority, arrival)`` (lower = sooner);
  * **per-tenant admission caps** (``max_inflight_per_tenant``): a
    tenant at its in-flight limit gets :class:`AdmissionError` back at
    ``submit()`` instead of head-of-line-blocking everyone else;
  * **in-flight coalescing** (``coalesce=True``): concurrent submissions
    with the same cache key share one execution — followers are finished
    from the leader's result with ``cached=True``.

Cache hits skip partitioning, inference, and verification entirely.

Failure domains:

  * **deadlines**: ``submit(deadline_s=...)`` (or the config default)
    arms a per-ticket budget checked at every stage boundary — an expired
    ticket fails with :class:`DeadlineExceeded` (flight-recorded,
    ``service.deadline_exceeded``) and ``poll()`` / ``result()``
    themselves expire overdue tickets;
  * **retries**: a transient launch failure of a lone item replays with
    exponential backoff + seeded jitter
    (``repro_torch.distributed.fault_tolerance``; ``service.retries``);
  * **bisection**: a failed multi-item pack is split and re-run in
    halves (``service.bisections``) so one poisoned design fails alone
    while its co-batched tickets complete.  A CUDA error is sticky, so it
    is not bisected away: it fails the run;
  * **worker-death detection**: ``poll()``/``result()`` notice a dead
    device thread and fail the affected tickets instead of blocking
    forever; every failure path releases tenant in-flight counts and
    slot-pool occupancy.

CLI (``python -m repro_torch.cli serve`` or ``python -m
repro_torch.service.server``)::

    python -m repro_torch.cli serve --designs csa:8,csa:16,booth:8 --partitions 4 --repeat 2
    python -m repro_torch.cli serve --aiger design.aig

NOTE: ``repro_torch.api.Session`` is the public front door — it owns this
engine behind ``session.submit()/poll()``.  Constructing
``VerificationService`` directly still works but is deprecated.
"""
from __future__ import annotations

import argparse
import dataclasses
import heapq
import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch import faults, resolve_device
from repro_torch.core import aig as A
from repro_torch.core import gnn
from repro_torch.core import pipeline as P
from repro_torch.core.verify import VerifyResult
from repro_torch.distributed.fault_tolerance import retry_call
from repro_torch.io import aiger
from repro_torch.obs import FlightRecorder, MetricsRegistry, record_from_marks, span
from repro_torch.obs.flight import failed_stage_from_marks, failure_dump_dir
from repro_torch.service.bucketing import items_from_prepared
from repro_torch.service.cache import ResultCache
from repro_torch.service.scheduler import ShapeBucketScheduler, SlotPool


def _indexed(device: torch.device) -> torch.device:
    """``device`` with its index: the device worker must not fall back on
    its thread's current device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _sticky_cuda_error(exc: BaseException) -> bool:
    """A CUDA error that is not an out-of-memory leaves the context unusable:
    every later launch fails too, so it ends the device worker (failing every
    pending ticket) instead of being bisected or retried away."""
    if faults.is_resource_error(exc):
        return False
    return type(exc).__name__ == "AcceleratorError" or "CUDA error" in str(exc)


class AdmissionError(RuntimeError):
    """Raised by ``submit()`` when a tenant is at its in-flight cap."""


class DeadlineExceeded(RuntimeError):
    """A ticket ran past its ``deadline_s`` budget.

    Raised *as the ticket's failure cause* (``result.error``), never out
    of ``poll()``/``result()`` themselves: expiry is cooperative — the
    stage boundaries and the retrieval API both check the clock, fail the
    ticket, release its tenant/pool resources, and record a flight.
    """


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    num_partitions: int = 1
    regrow: bool = True
    partitioner: str = "multilevel"
    backend: str = "ref"          # shape-stable OR structure-keyed (see scheduler)
    capacity: int = 2             # same-bucket items packed per device call
    max_structures: int = 64      # groot* backends: structures a runner
                                  # remembers before forgetting them wholesale
    min_nodes: int = 64           # bucket floor (nodes)
    min_edges: int = 128          # bucket floor (edges)
    # bucket ceilings ("device size").  A request whose graph would need a
    # larger bucket is NOT rejected: the scheduler partitions it (with
    # re-growth) and streams it through the repro_torch.exec executor.
    max_bucket_nodes: Optional[int] = None
    max_bucket_edges: Optional[int] = None
    stream_capacity: int = 2      # partitions packed per streamed launch
    prepare_workers: int = 2
    cache_capacity: int = 1024
    max_batch_requests: int = 16  # requests drained per device-worker cycle
    max_done_retained: int = 4096  # finished tickets kept pollable (FIFO evict)
    # staged edge-stream dtype for the groot* backends (None/f32 is
    # bit-exact; "bfloat16" halves staged stream bytes) — threaded through
    # to the BucketRunner, and part of the result-cache key because it
    # changes numerics
    stream_dtype: Optional[str] = None
    # warmup: run the bucket grid at construction so no user request meets
    # a signature first.  warmup_shapes pins the exact
    # (n_pad, e_pad) grid; None derives one from min/max bucket bounds.
    warmup: bool = False
    warmup_shapes: Optional[tuple] = None
    # in-flight coalescing: concurrent same-cache-key submissions share one
    # execution (followers finish from the leader's result, cached=True)
    coalesce: bool = True
    # per-tenant admission cap: submit(tenant=...) raises AdmissionError
    # once that tenant has this many unfinished requests (None = unlimited)
    max_inflight_per_tenant: Optional[int] = None
    # flight recorder: last N per-ticket forensic records kept in memory
    # (stats()["flights"]); failed tickets additionally dump a JSON record
    # to flight_dump_dir (or $REPRO_FLIGHT_DUMP_DIR) at failure time
    flight_records: int = 256
    flight_dump_dir: Optional[str] = None
    # failure domain (README "Failure semantics").  deadline_s arms every
    # ticket with a wall-clock budget (None = no deadline; a per-submit
    # deadline_s overrides).  launch_retries bounds transient-failure
    # replays of a lone item; retry_backoff_s seeds the exponential
    # backoff.  None of these changes results, so none is cache-keyed.
    deadline_s: Optional[float] = None
    launch_retries: int = 2
    retry_backoff_s: float = 0.05

    def cache_key_part(self) -> tuple:
        return (
            self.num_partitions, self.regrow, self.partitioner, self.backend,
            self.stream_dtype,
        )


@dataclasses.dataclass
class ServiceResult:
    req_id: int
    name: str
    status: str                   # verified|falsified|inconclusive|classified|error
    accuracy: float
    core_accuracy: float
    verdict: Optional[VerifyResult]
    cached: bool
    num_nodes: int
    num_edges: int
    timings: dict
    error: Optional[str] = None


@dataclasses.dataclass
class _Request:
    req_id: int
    design: object                       # AIG/LUTGraph or None (generate/parse)
    aiger_bytes: Optional[bytes]
    dataset: str
    bits: int
    seed: int
    verify: bool
    signed: Optional[bool]
    t_submit: float
    priority: int = 1                    # lower = sooner (0 = express lane)
    tenant: Optional[str] = None
    key: object = None                   # result-cache key, set during prepare
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[ServiceResult] = None
    # flight-record facts, filled in as the ticket moves through stages
    marks: list = dataclasses.field(default_factory=list)
    bucket: Optional[tuple] = None       # (n_pad, e_pad) of the pack it rode
    bucket_capacity: Optional[int] = None
    streamed: bool = False
    coalesced: bool = False
    # failure-domain state
    deadline_s: Optional[float] = None   # the armed budget (for the record)
    deadline: Optional[float] = None     # absolute perf_counter expiry
    retries: int = 0                     # transient-launch replays consumed
    claimed: bool = False                # first-result-wins guard (_finish)


@dataclasses.dataclass
class _Prepared:
    """One prepared request, queued for the device loop."""

    req: _Request
    key: object
    prep: object                         # PreparedDesign
    items: list
    t_prep: float
    t_enq: float


@dataclasses.dataclass
class _Inflight:
    """Device-loop state for a request whose items are in the pool."""

    req: _Request
    key: object
    prep: object
    remaining: int                       # items not yet run
    out: np.ndarray                      # predictions scattered so far
    t_prep: float
    t_enq: float
    t_infer: float = 0.0
    failed: bool = False


@dataclasses.dataclass
class _Slot:
    """One pool entry: a work item plus the request it belongs to."""

    inflight: _Inflight
    item: object                         # WorkItem


class VerificationService:
    """Batched, cached verification over a trained GROOT model.

    DEPRECATED as a public entry point: :class:`repro_torch.api.Session` is the
    façade (``session.submit()/poll()`` is this engine behind one config);
    the class keeps working as the service engine the session owns.
    ``**overrides`` always apply on top of ``config`` when both are given
    (via ``dataclasses.replace``), so a shared base config can be
    specialised per instance.  ``params`` is a :class:`~repro_torch.core.
    gnn.GrootGNN`, the reference's numpy tree or a ``.npz`` path; the
    device worker runs on ``device`` (``cuda`` unless named) and nothing
    else.
    """

    def __init__(self, params, config: Optional[ServiceConfig] = None,
                 _warn: bool = True, metrics: Optional[MetricsRegistry] = None,
                 flights: Optional[FlightRecorder] = None, device=None,
                 **overrides):
        if _warn:
            import warnings

            warnings.warn(
                "constructing VerificationService directly is deprecated; "
                "use repro_torch.api.Session (submit/poll)",
                DeprecationWarning,
                stacklevel=2,
            )
        if config is None:
            config = ServiceConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        # per-engine registry (a Session passes its own, so two live
        # sessions never read each other's service numbers)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # per-ticket forensic ring (a Session passes its own so
        # Session.flights() sees both sync and service flights)
        self.flights = (
            flights if flights is not None
            else FlightRecorder(config.flight_records)
        )
        self.cache = ResultCache(config.cache_capacity)
        self.device = _indexed(resolve_device(device))
        self.scheduler = ShapeBucketScheduler(
            gnn.as_model(params, self.device),
            backend=config.backend,
            capacity=config.capacity,
            min_nodes=config.min_nodes,
            min_edges=config.min_edges,
            max_structures=config.max_structures,
            max_bucket_nodes=config.max_bucket_nodes,
            max_bucket_edges=config.max_bucket_edges,
            stream_capacity=config.stream_capacity,
            stream_dtype=config.stream_dtype,
            metrics=self.metrics,
            device=self.device,
        )
        self._pool = ThreadPoolExecutor(
            max_workers=config.prepare_workers, thread_name_prefix="svc-prepare"
        )
        self._device_q: queue.Queue = queue.Queue()
        self._requests: dict[int, _Request] = {}
        self._done_order: deque[int] = deque()
        self._lock = threading.Lock()
        self._next_id = 0
        self._seq = itertools.count()           # pool admission order
        self._coalesce: dict = {}               # cache key -> follower reqs
        self._tenant_inflight: dict[str, int] = {}
        self._stop = False
        if config.warmup:
            # synchronous, before the device thread exists: every bucket in
            # the grid is warm before the first submit() can race it
            self.warm()
        self._device_thread = threading.Thread(
            target=self._device_loop, name="svc-device", daemon=True
        )
        self._device_thread.start()

    # -- compile-ahead warmup ------------------------------------------------

    def _default_warm_shapes(self) -> tuple:
        """Diagonal bucket grid from the floor up to the ceilings.

        Real AIGs land between ~1 and ~2 edges per node after padding, so
        for each pow-2 node count we warm both the (n, n) and (n, 2n)
        buckets (clamped to the configured edge bounds).
        """
        c = self.config
        n_hi = c.max_bucket_nodes or c.min_nodes * 8
        e_hi = c.max_bucket_edges or c.min_edges * 16
        shapes: list[tuple[int, int]] = []
        n = c.min_nodes
        while n <= n_hi:
            for e in (n, 2 * n):
                e = min(max(e, c.min_edges), e_hi)
                if (n, e) not in shapes:
                    shapes.append((n, e))
            n *= 2
        return tuple(shapes)

    def warm(self, shapes: Optional[tuple] = None) -> int:
        """Warm the bucket grid; returns the compiles it caused.

        Afterwards the runner counts every further first sight as a *cold*
        compile (``service.cold_compiles`` — a warmed service keeps it 0).
        Only shape-stable backends can be fully warmed; for the
        structure-keyed ``groot*`` backends this primes the pack path but
        an unseen structure still counts on first sight.
        """
        shapes = shapes or self.config.warmup_shapes or self._default_warm_shapes()
        stream = (
            self.config.max_bucket_nodes is not None
            or self.config.max_bucket_edges is not None
        )
        with span("service.warmup", shapes=len(shapes)):
            return self.scheduler.warm(shapes, stream=stream)

    # -- submission API ------------------------------------------------------

    def submit(
        self,
        design=None,
        *,
        dataset: str = "csa",
        bits: int = 8,
        seed: int = 0,
        aiger_bytes: Optional[bytes] = None,
        verify: bool = True,
        signed: Optional[bool] = None,
        priority: int = 1,
        tenant: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> int:
        """Enqueue one verification request; returns a ticket id.

        ``priority`` orders the device pool (lower = sooner; 0 is the
        express lane).  ``tenant`` attributes the request for admission
        control: past ``max_inflight_per_tenant`` unfinished requests a
        tenant gets :class:`AdmissionError` instead of queueing.
        ``deadline_s`` arms a wall-clock budget (default:
        ``config.deadline_s``); past it the ticket fails with
        :class:`DeadlineExceeded` instead of waiting further.
        """
        if self._stop:
            raise RuntimeError("service is closed")
        cap = self.config.max_inflight_per_tenant
        with self._lock:
            if tenant is not None and cap is not None:
                if self._tenant_inflight.get(tenant, 0) >= cap:
                    self.metrics.counter("service.rejected").inc()
                    raise AdmissionError(
                        f"tenant {tenant!r} already has {cap} requests "
                        f"in flight (max_inflight_per_tenant={cap})"
                    )
            rid = self._next_id
            self._next_id += 1
            req = _Request(
                req_id=rid,
                design=design,
                aiger_bytes=aiger_bytes,
                dataset=dataset,
                bits=bits,
                seed=seed,
                verify=verify,
                signed=signed,
                t_submit=time.perf_counter(),
                priority=priority,
                tenant=tenant,
            )
            budget = deadline_s if deadline_s is not None else self.config.deadline_s
            if budget is not None:
                req.deadline_s = budget
                req.deadline = req.t_submit + budget
            req.marks.append(("submit", req.t_submit))
            self._requests[rid] = req
            if tenant is not None:
                self._tenant_inflight[tenant] = (
                    self._tenant_inflight.get(tenant, 0) + 1
                )
        self.metrics.counter("service.admitted").inc()
        try:
            fast = self._fast_admit(req)
        except Exception as e:  # noqa: BLE001 — submit-side failures (e.g. an
            # injected cache.load fault) become per-ticket errors, releasing
            # the tenant slot, instead of leaking out of submit()
            self._fail(req, e)
            return rid
        if not fast:
            self._pool.submit(self._prepare_one, req)
        return rid

    def _gen_key(self, req: _Request):
        """Cache key for a generated design — computable without parsing."""
        return ResultCache.key(
            f"gen:{req.dataset}:{req.bits}:{req.seed}",
            self.config.cache_key_part() + (req.verify, req.signed, req.seed),
        )

    def _fast_admit(self, req: _Request) -> bool:
        """Resolve a generated-design request at submit time when its key
        alone decides it: a cache hit finishes immediately, a duplicate of
        an in-flight key coalesces behind the leader — either way no pool
        task is scheduled, so a burst of identical submissions costs one
        execution plus ~nothing per follower.  Returns True when the
        request needs no prepare."""
        if req.design is not None or req.aiger_bytes is not None:
            return False
        key = self._gen_key(req)
        hit = self.cache.get(key)
        if hit is not None:
            self.metrics.counter("service.cache_hits").inc()
            self._finish(
                req,
                dataclasses.replace(
                    hit,
                    req_id=req.req_id,
                    cached=True,
                    timings={"total": time.perf_counter() - req.t_submit},
                ),
            )
            return True
        if self.config.coalesce:
            with self._lock:
                followers = self._coalesce.get(key)
                if followers is not None:
                    req.coalesced = True
                    followers.append(req)
                    self.metrics.counter("service.coalesced").inc()
                    return True
                self._coalesce[key] = []
                req.key = key
        return False

    def submit_design(self, dataset: str, bits: int, *, seed: int = 0,
                      verify: bool = True) -> int:
        return self.submit(dataset=dataset, bits=bits, seed=seed, verify=verify)

    def submit_aiger(self, source, *, verify: bool = True,
                     signed: Optional[bool] = None) -> int:
        """Submit an AIGER file (path) or raw AIGER bytes."""
        return self.submit(
            aiger_bytes=aiger.source_bytes(source), verify=verify, signed=signed
        )

    # -- retrieval API -------------------------------------------------------

    def _worker_died(self) -> bool:
        """True when the device thread is gone without a clean shutdown."""
        return not self._stop and not self._device_thread.is_alive()

    def _expire_if_due(self, req: _Request) -> bool:
        """Cooperative deadline check: fail an overdue unfinished ticket
        (flight-recorded, tenant/pool resources released) and return True.
        Called at every stage boundary AND from poll()/result(), so an
        expired ticket is observed as failed no matter where it wedged."""
        if req.deadline is None or req.event.is_set():
            return False
        if time.perf_counter() < req.deadline:
            return False
        self.metrics.counter("service.deadline_exceeded").inc()
        self._fail(req, DeadlineExceeded(
            f"ticket {req.req_id} exceeded its {req.deadline_s:.4g}s deadline"
        ))
        return True

    def _fail_if_worker_dead(self, req: _Request) -> bool:
        if req.event.is_set() or not self._worker_died():
            return False
        self._fail(req, RuntimeError(
            "service device worker died; ticket can never finish"
        ))
        return True

    def poll(self, ticket: int) -> Optional[ServiceResult]:
        """Non-blocking: the result if finished, else None.

        Never returns None forever for a doomed ticket: an expired
        deadline or a dead device worker fails the ticket right here, so
        the caller sees an errored result on its next poll.
        """
        req = self._requests.get(ticket)
        if req is None:
            raise KeyError(f"unknown ticket {ticket}")
        if not req.event.is_set():
            self._expire_if_due(req)
            self._fail_if_worker_dead(req)
        return req.result if req.event.is_set() else None

    def result(self, ticket: int, timeout: Optional[float] = None) -> ServiceResult:
        """Blocking retrieval, bounded by ``timeout`` and the ticket's
        deadline.  Raises :class:`TimeoutError` past ``timeout``; a dead
        device worker or an expired deadline fails the ticket (errored
        result) instead of blocking forever."""
        req = self._requests.get(ticket)
        if req is None:
            raise KeyError(f"unknown ticket {ticket}")
        end = None if timeout is None else time.perf_counter() + timeout
        while not req.event.is_set():
            wait = 0.1
            now = time.perf_counter()
            if req.deadline is not None:
                wait = min(wait, max(req.deadline - now, 0.0) + 0.005)
            if end is not None:
                wait = min(wait, max(end - now, 0.0))
            if req.event.wait(max(wait, 0.005)):
                break
            if self._expire_if_due(req) or self._fail_if_worker_dead(req):
                break
            if end is not None and time.perf_counter() >= end:
                raise TimeoutError(f"ticket {ticket} not done within {timeout}s")
        assert req.result is not None
        return req.result

    def close(self, timeout: Optional[float] = 300.0) -> None:
        """Drain outstanding requests, stop the workers and drop the device
        copies the runner holds: nothing of the engine stays on the card."""
        with self._lock:
            pending = list(self._requests.values())
        for req in pending:
            req.event.wait(timeout)
        self._stop = True
        self._pool.shutdown(wait=True)
        self._device_thread.join(timeout=10.0)
        self.scheduler.runner.release()
        if self.device.type == "cuda":
            # the device worker's cuBLAS handle got workspaces from the
            # caching allocator; with the thread gone nothing uses them
            clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
            if clear is not None:
                clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        from repro_torch.kernels.plan_cache import PLAN_CACHE

        s = self.scheduler.stats()
        obs = self.metrics.snapshot(prefix="service.")
        return {
            "cache": self.cache.stats,
            "compile_count": s.compile_count,
            "device_calls": s.run_count,
            "buckets": [(b.n_pad, b.e_pad) for b in s.buckets],
            "items_run": s.items_run,
            "streamed_items": s.streamed_items,
            # warmup: grid size + cost, and the counter that must stay 0
            # afterwards (every post-warmup first sight is a cold compile
            # some user request paid for)
            "cold_compiles": s.cold_compiles,
            "warm_compiles": s.warm_compiles,
            "warm_shapes": list(s.warm_shapes),
            "warmup_s": s.warmup_s,
            # process-wide structural plan cache (groot* backends)
            "plan_cache": PLAN_CACHE.snapshot(),
            # this engine's obs registry: admit counts, queue depth/wait,
            # per-stage latency histograms
            "obs": obs,
            # high-water marks — the peaks last-value gauges silently lose
            "peaks": {k: g["max"] for k, g in obs["gauges"].items()},
            # per-ticket forensic ring (recorded/retained/failures + last)
            "flights": self.flights.stats(),
        }

    # -- workers -------------------------------------------------------------

    @staticmethod
    def _mark(req: _Request, stage: str) -> None:
        """Record a stage timestamp once per request (a multi-item request
        hits the device several times; only the first admission counts)."""
        if not any(s == stage for s, _ in req.marks):
            req.marks.append((stage, time.perf_counter()))

    def _record_flight(self, req: _Request, result: ServiceResult) -> None:
        """One forensic record per finished ticket, built at the single
        finish funnel so cache hits, coalesced followers, failures and
        normal completions all leave a trail.  Failed tickets also dump
        to disk immediately — the trail must survive the process."""
        # which segment a failure died in is only derivable before the
        # terminal mark lands
        failed_stage = (
            failed_stage_from_marks(req.marks)
            if result.status == "error" else None
        )
        self._mark(req, "done")
        rec = record_from_marks(
            req.req_id,
            result.name,
            result.status,
            req.marks,
            failed_stage=failed_stage,
            cached=result.cached and not req.coalesced,
            coalesced=req.coalesced,
            priority=req.priority,
            tenant=req.tenant,
            bucket=req.bucket,
            capacity=req.bucket_capacity,
            streamed=req.streamed,
            error=result.error,
            retries=req.retries,
            deadline_s=req.deadline_s,
        )
        self.flights.record(rec)
        if not rec.ok:
            directory = failure_dump_dir(self.config.flight_dump_dir)
            if directory:
                self.flights.dump_failure(rec, directory)

    def _finish(self, req: _Request, result: ServiceResult) -> None:
        # first-result-wins: a ticket can be finished concurrently from
        # several failure paths (deadline expiry in a poll()ing thread vs
        # the device loop completing it) — the claim below makes exactly
        # one of them the ticket's outcome; later finishes are no-ops, so
        # a DeadlineExceeded can never be overwritten by a late success
        with self._lock:
            first = not req.claimed
            req.claimed = True
        if not first:
            return          # the claiming path owns result + event
        self._record_flight(req, result)
        req.result = result
        req.event.set()
        # bound the ticket table: a long-lived service must not retain one
        # _Request (+ result payload) per request forever.  Oldest finished
        # tickets stop being pollable past max_done_retained.
        with self._lock:
            if req.tenant is not None:
                n = self._tenant_inflight.get(req.tenant, 1) - 1
                if n <= 0:
                    self._tenant_inflight.pop(req.tenant, None)
                else:
                    self._tenant_inflight[req.tenant] = n
            self._done_order.append(req.req_id)
            while len(self._done_order) > self.config.max_done_retained:
                self._requests.pop(self._done_order.popleft(), None)

    @staticmethod
    def _req_name(req: _Request) -> str:
        """Best attributable name for a request, even when it failed
        before (or during) parsing: the parsed design's name, else the
        AIGER comment name, else the generator spec."""
        name = getattr(req.design, "name", None)
        if name:
            return name
        if req.aiger_bytes is not None:
            return aiger.peek_name(req.aiger_bytes) or "aiger"
        return f"{req.dataset}:{req.bits}"

    def _pop_followers(self, key) -> list[_Request]:
        if key is None:
            return []
        with self._lock:
            return self._coalesce.pop(key, [])

    def _fail(self, req: _Request, exc: Exception) -> None:
        err = f"{type(exc).__name__}: {exc}"

        def _errored(r: _Request) -> ServiceResult:
            return ServiceResult(
                req_id=r.req_id, name=self._req_name(r), status="error",
                accuracy=0.0, core_accuracy=0.0, verdict=None, cached=False,
                num_nodes=0, num_edges=0, timings={}, error=err,
            )

        self._finish(req, _errored(req))
        # a coalesced leader takes its followers down with it — they share
        # the execution, so they share the failure
        for f in self._pop_followers(req.key):
            self._finish(f, _errored(f))

    def _prepare_one(self, req: _Request) -> None:
        try:
            if self._expire_if_due(req):
                return
            faults.fire("service.prepare", tag=lambda: self._req_name(req))
            t0 = time.perf_counter()
            design = req.design
            if design is None and req.aiger_bytes is not None:
                design = aiger.loads(req.aiger_bytes)
                req.design = design     # failed tickets stay attributable
            cfg = P.PipelineConfig(
                dataset=req.dataset,
                bits=req.bits,
                num_partitions=self.config.num_partitions,
                regrow=self.config.regrow,
                partitioner=self.config.partitioner,
                backend=self.config.backend,
                seed=req.seed,
                stream_dtype=self.config.stream_dtype,
            )
            key = req.key
            if key is None and (design is None or isinstance(design, A.AIG)):
                with span("service.hash"):
                    h = (
                        aiger.structural_hash(design)
                        if design is not None
                        else f"gen:{req.dataset}:{req.bits}:{req.seed}"
                    )
                # every request field that can change the outcome must be in
                # the key: seed steers the partitioner, signed the spec check
                key = ResultCache.key(
                    h,
                    self.config.cache_key_part()
                    + (req.verify, req.signed, req.seed),
                )
                hit = self.cache.get(key)
                if hit is not None:
                    assert isinstance(hit, ServiceResult)
                    self.metrics.counter("service.cache_hits").inc()
                    self._finish(
                        req,
                        dataclasses.replace(
                            hit,
                            req_id=req.req_id,
                            cached=True,
                            timings={
                                "prepare": time.perf_counter() - t0,
                                "total": time.perf_counter() - req.t_submit,
                            },
                        ),
                    )
                    return
                if self.config.coalesce:
                    # in-flight coalescing: if the same key is already being
                    # executed, ride along as a follower — the leader's
                    # _finalize/_fail finishes us too.  (A follower that
                    # registers just after the leader popped the entry
                    # simply becomes a new leader: duplicated work, never a
                    # hang or a wrong result.)
                    with self._lock:
                        followers = self._coalesce.get(key)
                        if followers is not None:
                            req.coalesced = True
                            followers.append(req)
                            self.metrics.counter("service.coalesced").inc()
                            return
                        self._coalesce[key] = []
                        req.key = key
            with span("service.prepare", req_id=req.req_id):
                prep = P.prepare(cfg, design)
                items = items_from_prepared(req.req_id, prep)
            t_prep = time.perf_counter() - t0
            self.metrics.histogram("service.prepare_s").observe(t_prep)
            self._mark(req, "prepared")
            self._device_q.put(
                _Prepared(req, key, prep, items, t_prep, time.perf_counter())
            )
            self.metrics.gauge("service.queue_depth").set(self._device_q.qsize())
        except Exception as e:  # noqa: BLE001 — request-scoped failure
            self._fail(req, e)

    def _drain_device_q(self, block: bool) -> Optional[list[_Prepared]]:
        """Everything currently queued (non-blocking past the first get).

        Called between every two device calls — this re-drain is what
        admits a freshly-prepared request into the next pack.  Returns
        None when the service is stopping and nothing is queued.
        """
        out: list[_Prepared] = []
        if block:
            try:
                out.append(self._device_q.get(timeout=0.05))
            except queue.Empty:
                if self._stop:
                    return None
        while True:
            try:
                out.append(self._device_q.get_nowait())
            except queue.Empty:
                break
        if out:
            self.metrics.gauge("service.queue_depth").set(self._device_q.qsize())
        return out

    def _admit(self, prepared: _Prepared, pool: SlotPool,
               streamed: list) -> None:
        """Slot a prepared request's items into the admission pool."""
        inf = _Inflight(
            req=prepared.req,
            key=prepared.key,
            prep=prepared.prep,
            remaining=len(prepared.items),
            out=np.zeros(prepared.prep.num_nodes, dtype=np.int32),
            t_prep=prepared.t_prep,
            t_enq=prepared.t_enq,
        )
        self.metrics.histogram("service.queue_wait_s").observe(
            time.perf_counter() - prepared.t_enq
        )
        for it in prepared.items:
            shape = self.scheduler.bucket_of(it)
            slot = _Slot(inf, it)
            if self.scheduler._oversized(shape):
                heapq.heappush(
                    streamed, (prepared.req.priority, next(self._seq), slot)
                )
            else:
                pool.admit(shape, prepared.req.priority, next(self._seq), slot)

    def _scatter(self, slot: _Slot, pred: np.ndarray, t_inf: float) -> None:
        """Fold one item's predictions into its request; finalize when the
        request's last item lands (host post-processing goes back to the
        pool so the device worker moves straight on)."""
        inf = slot.inflight
        it = slot.item
        inf.out[it.global_ids[: it.num_core]] = pred[: it.num_core]
        inf.t_infer += t_inf
        inf.remaining -= 1
        if inf.remaining == 0 and not inf.failed:
            self._mark(inf.req, "inferred")
            timings = {"prepare": inf.t_prep, "inference": inf.t_infer}
            self._pool.submit(
                self._finalize, inf.req, inf.key, inf.prep, inf.out, timings
            )

    def _fail_inflight(self, inf: _Inflight, exc: Exception) -> None:
        if not inf.failed:
            inf.failed = True
            self._fail(inf.req, exc)

    def _with_retries(self, attempt, req: _Request):
        """Run one device attempt with the shared transient-retry policy:
        exponential backoff + seeded jitter, bounded by ``launch_retries``
        AND the ticket's deadline (an expired budget aborts the replay
        loop with :class:`DeadlineExceeded`)."""
        def on_retry(i, exc):
            if req.deadline is not None and time.perf_counter() >= req.deadline:
                self.metrics.counter("service.deadline_exceeded").inc()
                raise DeadlineExceeded(
                    f"ticket {req.req_id} exceeded its {req.deadline_s:.4g}s "
                    f"deadline while retrying: {exc}"
                ) from exc
            req.retries += 1
            self.metrics.counter("service.retries").inc()

        return retry_call(
            attempt,
            retries=self.config.launch_retries,
            seed=req.req_id,
            base_s=self.config.retry_backoff_s,
            on_retry=on_retry,
        )

    def _run_streamed_slot(self, slot: _Slot) -> None:
        """One oversized item: partitioned + streamed through the shared
        runner (one whole-item unit; its sub-launches batch internally at
        stream_capacity).  Transient failures retry like packed items."""
        inf = slot.inflight
        req = inf.req
        t0 = time.perf_counter()
        self.metrics.histogram("service.admission_s").observe(t0 - inf.t_enq)
        req.streamed = True
        self._mark(req, "admitted")

        def _attempt():
            faults.fire("service.device", tag=lambda: self._req_name(req))
            return self.scheduler.run_one(slot.item)

        try:
            preds = self._with_retries(_attempt, req)
            t_inf = time.perf_counter() - t0
            self.metrics.histogram("service.infer_s").observe(t_inf)
            self._scatter(slot, preds[(req.req_id, slot.item.part_index)], t_inf)
        except Exception as e:  # noqa: BLE001
            if _sticky_cuda_error(e):
                raise
            self._fail_inflight(inf, e)

    def _run_pack_slots(self, slots: list, shape, depth: int = 0) -> None:
        """One device call over ≤capacity live same-bucket slots, with
        blast-radius isolation: a failing multi-slot pack is bisected and
        each half re-run (``service.bisections``), so a poisoned item
        ultimately fails *alone* while its co-batched tickets complete; a
        lone item's transient failure replays with backoff
        (``service.retries``)."""
        live = []
        for s in slots:
            inf = s.inflight
            if inf.failed or inf.req.event.is_set():
                continue
            if self._expire_if_due(inf.req):
                inf.failed = True
                continue
            live.append(s)
        slots = live
        if not slots:
            return
        t0 = time.perf_counter()
        for s in slots:
            if depth == 0:
                self.metrics.histogram("service.admission_s").observe(
                    t0 - s.inflight.t_enq
                )
            if s.inflight.req.bucket is None:
                s.inflight.req.bucket = (shape.n_pad, shape.e_pad)
                s.inflight.req.bucket_capacity = self.scheduler.capacity
            self._mark(s.inflight.req, "admitted")

        def _attempt():
            faults.fire(
                "service.device",
                tag=lambda: ",".join(
                    self._req_name(s.inflight.req) for s in slots
                ),
            )
            return self.scheduler.run_pack([s.item for s in slots], shape)

        try:
            if len(slots) == 1:
                preds = self._with_retries(_attempt, slots[0].inflight.req)
            else:
                preds = _attempt()
        except Exception as e:  # noqa: BLE001
            if _sticky_cuda_error(e):
                raise
            if len(slots) > 1:
                self.metrics.counter("service.bisections").inc()
                mid = (len(slots) + 1) // 2
                self._run_pack_slots(slots[:mid], shape, depth + 1)
                self._run_pack_slots(slots[mid:], shape, depth + 1)
                return
            self._fail_inflight(slots[0].inflight, e)
            return
        t_inf = time.perf_counter() - t0
        self.metrics.histogram("service.infer_s").observe(t_inf)
        for s in slots:
            self._scatter(
                s, preds[(s.inflight.req.req_id, s.item.part_index)], t_inf
            )

    @staticmethod
    def _slot_dead(slot: _Slot) -> bool:
        return slot.inflight.failed or slot.inflight.req.event.is_set()

    def _device_loop(self) -> None:
        """Crash containment around the batching loop: the device worker
        must never die silently — an escaped exception (including an
        injected :class:`~repro_torch.faults.WorkerKilled`) fails every pending
        ticket so pollers/result() unblock with an attributed error."""
        try:
            self._device_loop_inner()
        except BaseException as e:  # noqa: BLE001 — worker-death containment
            self.metrics.counter("service.worker_deaths").inc()
            with self._lock:
                pending = [
                    r for r in self._requests.values() if not r.event.is_set()
                ]
            for r in pending:
                self._fail(r, RuntimeError(f"device worker crashed: {e!r}"))

    def _device_loop_inner(self) -> None:
        """Continuous batching: one device call per iteration, re-draining
        the queue in between.  The pool orders items by (priority, seq);
        each iteration runs one pack of the globally most-urgent bucket —
        so an item prepared while a pack was on the device joins the next
        pack of its bucket mid-flight instead of waiting out a wave.
        """
        pool = SlotPool()
        streamed: list = []             # (priority, seq, _Slot) heap
        while True:
            idle = len(pool) == 0 and not streamed
            drained = self._drain_device_q(block=idle)
            if drained is None:
                return
            for prepared in drained:
                self._admit(prepared, pool, streamed)
            # release pool occupancy of failed / finished / expired slots
            # every cycle — no failure path leaves ghosts in the heaps
            pool.prune(self._slot_dead)
            while streamed and self._slot_dead(streamed[0][2]):
                heapq.heappop(streamed)
            self.metrics.gauge("service.pending_items").set(
                len(pool) + len(streamed)
            )
            shape = pool.best_bucket()
            if shape is None and not streamed:
                continue
            if streamed and (
                shape is None or streamed[0][:2] < pool.head_key(shape)
            ):
                _, _, slot = heapq.heappop(streamed)
                if not self._slot_dead(slot):
                    self._run_streamed_slot(slot)
                continue
            taken = pool.take(shape, self.scheduler.capacity)
            self._run_pack_slots([s for (_, _, s) in taken], shape)

    def _finalize(self, req, key, prep, pred: np.ndarray, timings: dict) -> None:
        try:
            if self._expire_if_due(req):
                return
            t0 = time.perf_counter()
            acc = gnn.accuracy(pred, prep.labels)
            verdict = None
            if req.verify:
                verdict = P.verify_prepared(prep, pred, signed=req.signed)
            timings["verify"] = time.perf_counter() - t0
            self.metrics.histogram("service.verify_s").observe(timings["verify"])
            timings["total"] = time.perf_counter() - req.t_submit
            result = ServiceResult(
                req_id=req.req_id,
                name=getattr(prep.design, "name", None) or self._req_name(req),
                status=verdict.status if verdict is not None else "classified",
                accuracy=acc,
                core_accuracy=acc,
                verdict=verdict,
                cached=False,
                num_nodes=prep.num_nodes,
                num_edges=prep.num_edges,
                timings=timings,
            )
            if key is not None:
                self.cache.put(key, result)
            self._finish(req, result)
            # coalesced followers share the leader's execution: finish them
            # from the same result, marked cached (it IS a shared outcome)
            for f in self._pop_followers(key):
                self._finish(
                    f,
                    dataclasses.replace(
                        result,
                        req_id=f.req_id,
                        cached=True,
                        timings={
                            **timings,
                            "total": time.perf_counter() - f.t_submit,
                        },
                    ),
                )
        except Exception as e:  # noqa: BLE001
            self._fail(req, e)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parse_designs(spec: str) -> list[tuple[str, int]]:
    out = []
    for part in spec.split(","):
        if not part:
            continue
        fam, _, bits = part.partition(":")
        out.append((fam, int(bits or 8)))
    return out


def main(argv=None, device=None):
    """The ``serve`` command: train, then serve a generated workload (and
    AIGER files) through one :class:`~repro_torch.api.Session`'s batched
    engine on ``device`` (``cuda`` unless named)."""
    ap = argparse.ArgumentParser(prog="serve", description="GROOT verification service")
    ap.add_argument("--designs", default="csa:8,csa:16,booth:8",
                    help="comma list of family:bits to generate and submit")
    ap.add_argument("--aiger", nargs="*", default=[],
                    help="AIGER files (.aig/.aag) to submit")
    ap.add_argument("--repeat", type=int, default=1,
                    help="submit the workload this many times (cache demo)")
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--no-regrow", action="store_true")
    ap.add_argument("--capacity", type=int, default=2)
    ap.add_argument("--max-bucket-nodes", type=int, default=None,
                    help="bucket ceiling; larger designs stream through "
                         "the partitioned executor instead of erroring")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--train-bits", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve GET /metrics (Prometheus text) and "
                         "GET /stats (JSON) on this port while running")
    ap.add_argument("--sample", metavar="OUT.jsonl", default=None,
                    help="append periodic JSONL registry snapshots "
                         "(queue depth, slot occupancy, stage latencies)")
    ap.add_argument("--sample-interval", type=float, default=0.5)
    ap.add_argument("--flight-dump-dir", default=None,
                    help="directory for failed tickets' flight-record dumps "
                         "(default: $REPRO_FLIGHT_DUMP_DIR)")
    args = ap.parse_args(argv)

    # the CLI is a thin client of the façade: one Session owns the params,
    # the batched engine, and every cache
    from repro_torch.api import Session, SessionConfig

    sess = Session(config=SessionConfig(
        num_partitions=args.partitions,
        regrow=not args.no_regrow,
        capacity=args.capacity,
        prepare_workers=args.workers,
        max_bucket_nodes=args.max_bucket_nodes,
        flight_dump_dir=args.flight_dump_dir,
        device=device,
    ))
    print(f"training groot-gnn on csa {args.train_bits}b ({args.epochs} epochs)...")
    sess.train("csa", args.train_bits, epochs=args.epochs)

    metrics_server = None
    sampler = None
    if args.metrics_port is not None:
        from repro_torch.obs import start_metrics_server

        metrics_server = start_metrics_server(
            sess.obs.metrics, port=args.metrics_port, stats_fn=sess.stats
        )
        print(f"metrics: {metrics_server.url}/metrics  "
              f"stats: {metrics_server.url}/stats")
    if args.sample is not None:
        from repro_torch.obs import Sampler

        sampler = Sampler(
            args.sample, sess.obs.metrics, interval_s=args.sample_interval
        ).start()

    t0 = time.perf_counter()
    results = []
    with sess:
        # rounds are sequential so repeat > 1 demonstrates cache hits
        for _ in range(args.repeat):
            tickets = [
                sess.submit(dataset=fam, bits=bits)
                for fam, bits in _parse_designs(args.designs)
            ]
            tickets += [sess.submit(path) for path in args.aiger]
            results += [sess.result(t) for t in tickets]
        svc_stats = sess.stats()["service"]
    dt = time.perf_counter() - t0
    print(f"\n{'ticket':>6} {'design':>18} {'status':>13} {'acc':>7} "
          f"{'nodes':>7} {'cached':>6} {'total_s':>8}")
    for r in results:
        print(f"{r.req_id:>6} {r.name:>18} {r.status:>13} {r.accuracy:7.4f} "
              f"{r.num_nodes:>7} {str(r.cached):>6} {r.timings.get('total', 0):8.3f}")
        if r.error:
            print(f"       error: {r.error}")
    s = svc_stats
    print(f"\nserved {len(results)} requests in {dt:.2f}s "
          f"({len(results) / dt:.1f} req/s incl. compile)")
    print(f"compiles: {s['compile_count']}  device calls: {s['device_calls']}  "
          f"buckets: {s['buckets']}  streamed: {s['streamed_items']}")
    print(f"cache: {s['cache'].hits} hits / {s['cache'].misses} misses "
          f"(rate {s['cache'].hit_rate:.0%})")
    fl = s["flights"]
    print(f"flights: {fl['recorded']} recorded, {fl['failures']} failed, "
          f"{fl['retained']}/{fl['capacity']} retained")
    if sampler is not None:
        print(f"sampler: {sampler.stop()} snapshots -> {sampler.path}")
    if metrics_server is not None:
        metrics_server.close()


if __name__ == "__main__":
    main()
