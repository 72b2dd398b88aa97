"""`Session`: the port's front door (port of ``repro/api/session.py``).

    session.train(...)          train a small model and adopt its params
    session.verify(design)      sync: route + run + verify
    session.explain(design)     the routing decision, without running
    session.submit()/poll()     async: the batched service engine
    session.report()            where the time went (``repro_torch.obs``)

A design is None (generated from ``dataset``/``bits``), an AIG/LUT object,
AIGER bytes, or an AIGER file path.  A structural-hash result LRU
(``session.results``) answers a repeated design under the same config
without touching the device; with ``checkpoint_dir`` set, a streamed run
journals each partition so a killed run resumes where it stopped.

The reference's four modes, on each of its five backends (``ref``,
``onehot``, ``groot``, ``groot_mxu``, ``groot_fused``; ``onehot``
materialises an (E, N) one-hot, so it suits small designs only):

  mode "full"         unpartitioned: no partition count, no budget, or a
                      budget the whole design fits
  mode "partitioned"  ``streaming=False``: the design is partitioned and
                      re-grown (Algorithm 1) and each subgraph runs the
                      full-graph forward in turn
  mode "streamed"     ``streaming=True`` (the default) with a partition
                      count or a budget the design does not fit: the
                      ``repro_torch.exec`` executor runs the subgraphs as
                      bucketed packed launches, a host thread packing the
                      next batch while the device runs the current one
  mode "sharded"      the streamed route over more than one device
                      (``repro_torch.mesh``): ``mesh_devices`` above 1, or
                      None with more than one visible device of the
                      session's type; each lane a device, its own params
                      copy, stream and prefetch thread

``submit``/``poll``/``result`` run designs through the batched service
engine (:class:`repro_torch.service.server.VerificationService`, started
lazily on the session's device): several users' designs packed into one
device launch.  Every session keeps a private metrics registry, an optional
span tracer (``trace=True``) and a flight recorder that both paths write.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import threading
import time
from typing import Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.api.config import SessionConfig
from repro_torch.core import aig as A
from repro_torch.core import gnn
from repro_torch.core import pipeline as P
from repro_torch.core.verify import VerifyResult
from repro_torch.kernels.plan_cache import PLAN_CACHE
from repro_torch.obs import (
    REGISTRY,
    FlightRecorder,
    MetricsRegistry,
    Report,
    TraceHandle,
    Tracer,
    current_tracer,
    fold_into,
    record_from_marks,
)
from repro_torch.service.cache import ResultCache


@dataclasses.dataclass(frozen=True)
class RoutingDecision:
    """Why a design runs the way it runs (``session.explain()``)."""

    mode: str                         # "full" | "partitioned" | "streamed"
                                      # | "sharded"
    backend: str
    stream_dtype: Optional[str]       # effective staged-stream dtype (None=f32)
    k: int                            # partition count (1 for full)
    num_buckets: int                  # compile-unit count (streamed mode)
    buckets: tuple                    # ((n_pad, e_pad), ...) ascending
    modeled_full_bytes: int           # unpartitioned device-memory model
    modeled_peak_bytes: int           # what is resident: the full bytes, the
                                      # largest subgraph's, or the packed-
                                      # launch peak (capacity slots of the
                                      # biggest bucket), per device in
                                      # mode "sharded"
    memory_budget_bytes: Optional[int]
    num_nodes: int
    num_edges: int
    reason: str
    #: mesh lanes the streamed route launches over (1 = the single-device
    #: executor; >1 = mode "sharded" through repro_torch.mesh)
    mesh_devices: int = 1


@dataclasses.dataclass
class SessionResult:
    """One verified design: verdict + accuracy + the route."""

    name: str
    status: str                       # verified|falsified|inconclusive|classified
    accuracy: float
    core_accuracy: float
    verdict: Optional[VerifyResult]
    cached: bool                      # answered from the result LRU
    num_nodes: int
    num_edges: int
    peak_memory_bytes: int            # peak over partitions (full bytes if k=1)
    unpartitioned_memory_bytes: int
    boundary_edge_frac: float
    routing: RoutingDecision
    timings: dict
    plan_cache: dict                  # structural-cache deltas for this call
    exec_stats: dict                  # streamed mode: executor probe deltas
    predictions: Optional[np.ndarray] = None   # verify(return_predictions=True)
    #: per-verify span subtree (config.trace=True; None on cache hits and
    #: untraced sessions) — ``result.trace.save(path)`` writes Chrome JSON
    trace: Optional[TraceHandle] = None


def route_prepared(prep: P.PreparedDesign, cfg: SessionConfig, device=None) -> RoutingDecision:
    """The routing decision ``verify`` executes and ``explain`` reports —
    both read the same prepared design, so they cannot drift."""
    return _route_with_plan(prep, cfg, device)[0]


def _route_with_plan(prep: P.PreparedDesign, cfg: SessionConfig, device=None):
    """Route + the PartitionPlan backing a streamed decision (None for the
    other modes), so ``verify`` hands the planned buckets to the executor
    instead of rebuilding them."""
    pcfg = prep.cfg
    full_bytes, peak_parts = prep.memory_bytes()
    budget = pcfg.memory_budget_bytes
    common = dict(
        backend=pcfg.backend, stream_dtype=P.effective_stream_dtype(cfg),
        modeled_full_bytes=full_bytes, memory_budget_bytes=budget,
        num_nodes=prep.num_nodes, num_edges=prep.num_edges,
    )
    if prep.subgraphs is None:
        reason = (
            f"modeled {full_bytes} B fits the {budget} B budget unpartitioned"
            if budget is not None
            else "no partitioning requested (num_partitions <= 1, no budget)"
        )
        return RoutingDecision(mode="full", k=1, num_buckets=0, buckets=(),
                               modeled_peak_bytes=full_bytes, reason=reason, **common), None
    k = prep.num_partitions
    if not cfg.streaming:
        return RoutingDecision(
            mode="partitioned", k=k, num_buckets=0, buckets=(), modeled_peak_bytes=peak_parts,
            reason=f"k={k} partitions through the sequential loop (streaming disabled)",
            **common,
        ), None
    from repro_torch.exec.plan import plan_from_subgraphs

    plan = plan_from_subgraphs(
        list(prep.subgraphs), prep.num_nodes, num_edges=prep.num_edges,
        regrow=pcfg.regrow, partitioner=pcfg.partitioner, seed=pcfg.seed,
        min_nodes=cfg.min_nodes, min_edges=cfg.min_edges,
    )
    if budget is not None and pcfg.num_partitions <= 1:
        reason = (
            f"modeled full-graph {full_bytes} B exceeds the {budget} B "
            f"budget -> choose_k cut k={k}, streamed as "
            f"{plan.num_buckets}-bucket packed launches"
        )
    else:
        reason = f"k={k} partitions requested, streamed as {plan.num_buckets}-bucket packed launches"
    peak = plan.peak_batch_memory_bytes(pcfg.gnn, cfg.stream_capacity)
    buckets = tuple((b.n_pad, b.e_pad) for b in plan.buckets)
    devices = P.resolve_mesh_devices(cfg.mesh_devices, device)
    if devices > 1:
        # the packed batches are independent until the core scatter (GROOT
        # Alg. 1), so the stream shards across the lanes; each lane launches
        # the same canonical bucket shapes, so the per-device peak equals the
        # single-device packed peak
        from repro_torch.mesh import build_mesh_plan

        mplan = build_mesh_plan(plan, devices, cfg.stream_capacity)
        reason += (
            f"; sharded across {devices} devices x k={k} x "
            f"{plan.num_buckets} bucket(s), modeled per-device peak "
            f"{peak / 1e6:.1f} MB, launch speedup "
            f"{mplan.modeled_speedup:.2f}x"
        )
        return RoutingDecision(
            mode="sharded", k=k, num_buckets=plan.num_buckets, buckets=buckets,
            modeled_peak_bytes=peak, mesh_devices=devices, reason=reason, **common,
        ), plan
    return RoutingDecision(
        mode="streamed", k=k, num_buckets=plan.num_buckets, buckets=buckets,
        modeled_peak_bytes=peak, reason=reason, **common,
    ), plan


class _SessionObs:
    """One session's observability state: a private metrics registry, an
    optional tracer, and the baselines report() deltas against."""

    def __init__(self, trace: bool, flight_records: int = 256):
        self.metrics = MetricsRegistry()
        self.tracer: Optional[Tracer] = Tracer() if trace else None
        # one forensic ring across both paths: the service engine records
        # its tickets here, sync verify records its calls (negative ids)
        self.flights = FlightRecorder(flight_records)
        self.flight_ids = itertools.count(1)     # sync-verify id space (<0)
        # deltas in report() are measured from session creation
        self.registry_baseline = REGISTRY.snapshot()
        self.plan_cache_baseline = PLAN_CACHE.snapshot()
        self.exec_totals: dict = {}


class Session:
    """One front door over the full-graph, partitioned, streamed, sharded
    and batched-service routes."""

    def __init__(self, params=None, config: Optional[SessionConfig] = None,
                 _obs: Optional[_SessionObs] = None, **overrides):
        if config is None:
            config = SessionConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = resolve_device(config.device)
        if config.fault_plan is not None:
            # chaos sessions: fire sites are global, so the plan is installed
            # for the whole process, once, at construction
            from repro_torch import faults

            faults.install(config.fault_plan)
        #: tracing + metrics state (``_obs`` lets :meth:`options` share the
        #: parent's, so a family of derived sessions traces one timeline)
        self.obs = (_obs if _obs is not None
                    else _SessionObs(config.trace, config.flight_records))
        self._params = None if params is None else gnn.as_model(params, self.device)
        #: structural-hash result LRU: a resubmitted design under the same
        #: config skips prepare + inference + verification entirely
        self.results = ResultCache(config.cache_capacity)
        self._service = None
        self._closed = False
        self._lock = threading.Lock()

    # -- params lifecycle ----------------------------------------------------

    @property
    def params(self) -> gnn.GrootGNN:
        if self._params is None:
            raise RuntimeError(
                "session has no params: pass them to Session(params=...) or call "
                "session.train() first")
        return self._params

    @property
    def has_params(self) -> bool:
        return self._params is not None

    def train(self, dataset: Optional[str] = None, bits: int = 8, *,
              epochs: int = 300, seed: Optional[int] = None) -> list:
        """Train on a small design (the paper trains on 8-bit) on the
        session's device and adopt the params; returns the loss history."""
        params, hist = P.train_model(
            dataset or self.config.dataset, bits, cfg=self.config.gnn, epochs=epochs,
            seed=self.config.seed if seed is None else seed, device=self.device,
        )
        self.set_params(params)
        return hist

    def set_params(self, params) -> None:
        """Adopt new params (anything ``Session(params=...)`` takes),
        invalidating every params-derived state: the result LRU (its keys
        carry no params fingerprint, so stale entries would be served as
        fresh) and the service engine (its runner holds the old params).
        The executor pool needs nothing: it is keyed on params identity."""
        model = gnn.as_model(params, self.device)
        with self._lock:
            self._params = model
            svc, self._service = self._service, None
            self.results = ResultCache(self.config.cache_capacity)
        if svc is not None:
            svc.close()

    def options(self, **overrides) -> "Session":
        """A derived session: the same params (shared, not copied), the
        config overridden, a fresh result LRU.  Obs state (tracer + metrics)
        is shared too, unless the override flips the trace flag."""
        cfg = dataclasses.replace(self.config, **overrides)
        obs = self.obs if cfg.trace == self.config.trace else None
        derived = Session(config=cfg, _obs=obs)
        derived._params = self._params
        return derived

    # -- design resolution ---------------------------------------------------

    def _resolve_design(self, design):
        """None (generate from config), an AIG/LUT object, AIGER bytes, or
        an AIGER file path."""
        if design is None or hasattr(design, "to_edge_graph"):
            return design
        from repro_torch.io import aiger

        if isinstance(design, (bytes, bytearray)):
            return aiger.loads(bytes(design))
        return aiger.load(design)      # str / PathLike

    def prepare(self, design=None, *, dataset: Optional[str] = None,
                bits: Optional[int] = None, seed: Optional[int] = None) -> P.PreparedDesign:
        """Host-side stage 1 for this session's config (features,
        partitioning, re-growth)."""
        pcfg = self.config.pipeline_config(dataset=dataset, bits=bits, seed=seed)
        return P.prepare(pcfg, self._resolve_design(design))

    def explain(self, design=None, *, dataset: Optional[str] = None,
                bits: Optional[int] = None, seed: Optional[int] = None) -> RoutingDecision:
        """The routing decision ``verify`` would take, without running
        inference.  Needs no params."""
        return route_prepared(
            self.prepare(design, dataset=dataset, bits=bits, seed=seed), self.config,
            self.device,
        )

    def _result_key(self, design, pcfg, verify: bool, signed):
        if pcfg.batch != 1:
            return None
        if design is None:
            h = f"gen:{pcfg.dataset}:{pcfg.bits}:{pcfg.seed}"
        elif isinstance(design, A.AIG):
            from repro_torch.io import aiger

            h = aiger.structural_hash(design)
        else:
            return None
        return ResultCache.key(
            h,
            self.config.cache_key_part() + (pcfg.dataset, pcfg.bits, pcfg.seed, verify, signed),
        )

    def _stream_executor(self):
        from repro_torch.exec.stream import shared_executor

        return shared_executor(
            self.params, self.config.backend,
            capacity=self.config.stream_capacity, prefetch=self.config.stream_prefetch,
            stream_dtype=P.effective_stream_dtype(self.config),
            min_nodes=self.config.min_nodes, min_edges=self.config.min_edges,
            device=self.device,
        )

    def _mesh_executor(self, num_devices: int):
        from repro_torch.mesh import shared_mesh_executor

        return shared_mesh_executor(
            self.params, self.config.backend or "ref", num_devices=num_devices,
            capacity=self.config.stream_capacity, prefetch=self.config.stream_prefetch,
            stream_dtype=P.effective_stream_dtype(self.config),
            min_nodes=self.config.min_nodes, min_edges=self.config.min_edges,
            launch_retries=self.config.launch_retries,
            retry_backoff_s=self.config.retry_backoff_s, device=self.device,
        )

    def verify(self, design=None, *, dataset: Optional[str] = None,
               bits: Optional[int] = None, seed: Optional[int] = None,
               verify: bool = True, signed: Optional[bool] = None,
               use_cache: bool = True,
               return_predictions: bool = False,
               prepared: Optional[P.PreparedDesign] = None,
               on_partition=None) -> SessionResult:
        """Prepare, infer on the session's device, and (optionally) verify
        one design.  ``design`` is anything :meth:`_resolve_design` accepts;
        None generates ``dataset``/``bits`` from the config.  A repeated
        design under the same config is answered from the result LRU
        (``cached=True``, no inference); ``use_cache=False`` bypasses it, and
        so does a caller asking for predictions (cached entries hold none).

        ``prepared`` (from :meth:`prepare`) skips the host stage 1 instead,
        e.g. to run one partitioning under several backends: the session's
        backend, stream dtype, GNN config and journal knobs
        (``checkpoint_dir``, ``resume``) apply to it, and such a run bypasses
        the result LRU.  In mode "partitioned", ``on_partition(i, sg)`` is
        called after each subgraph's forward
        (``gnn.predict_partitioned_loop``); in modes "streamed" and
        "sharded" the result's ``exec_stats`` carry the executor's probes for
        this call."""
        t_start = time.perf_counter()
        met = self.obs.metrics
        met.counter("session.verifies").inc()
        marks = [("submit", t_start)]
        # with our own tracer: activate it (and restore whatever was active
        # after); without: nullcontext, so a surrounding tracer still
        # receives every span below
        activate = (self.obs.tracer.activate() if self.obs.tracer is not None
                    else contextlib.nullcontext())
        with activate:
            tracer = self.obs.tracer or current_tracer()
            with tracer.span("session.verify") as root:
                key = None
                with tracer.span("parse"):
                    hit = None
                    if prepared is None:
                        design = self._resolve_design(design)
                        pcfg = self.config.pipeline_config(dataset=dataset, bits=bits,
                                                           seed=seed)
                        key = self._result_key(design, pcfg, verify, signed)
                        # cached entries hold no predictions, so a caller
                        # asking for them falls through to a real run
                        if use_cache and key is not None and not return_predictions:
                            hit = self.results.get(key)
                if hit is not None:
                    met.counter("session.cache_hits").inc()
                    root.set(cached=True)
                    self._record_sync_flight(marks, hit.name, hit.status, cached=True)
                    # fresh dicts: callers may mutate their result without
                    # corrupting the cached copy or other hits
                    return dataclasses.replace(
                        hit, cached=True, plan_cache=dict(hit.plan_cache),
                        exec_stats=dict(hit.exec_stats),
                        timings={**hit.timings, "total": time.perf_counter() - t_start},
                    )
                with tracer.span("plan") as plan_sp:
                    if prepared is None:
                        prep = P.prepare(pcfg, design)
                    else:  # this session's execution knobs over the partitioning
                        prep = dataclasses.replace(prepared, cfg=dataclasses.replace(
                            prepared.cfg, backend=self.config.backend,
                            stream_dtype=self.config.stream_dtype, gnn=self.config.gnn,
                            checkpoint_dir=self.config.checkpoint_dir,
                            resume=self.config.resume))
                    decision, plan = _route_with_plan(prep, self.config, self.device)
                    plan_sp.set(mode=decision.mode, k=decision.k)
                marks.append(("prepared", time.perf_counter()))
                met.counter(f"session.route.{decision.mode}").inc()
                met.histogram("session.prepare_s").observe(sum(prep.timings.values()))
                root.set(mode=decision.mode, design=getattr(prep.design, "name", "?"))

                t0 = time.perf_counter()
                pc_before = PLAN_CACHE.snapshot()
                exec_stats: dict = {}
                with tracer.span("execute", mode=decision.mode):
                    if decision.mode == "full":
                        pred = P.infer(self.params, prep, device=self.device)
                    elif decision.mode == "partitioned":
                        pred = gnn.predict_partitioned_loop(
                            self.params, prep.subgraphs, prep.feats, prep.num_nodes,
                            prep.cfg.backend, stream_dtype=decision.stream_dtype,
                            device=self.device, on_partition=on_partition,
                        )
                    else:
                        executor = (self._mesh_executor(decision.mesh_devices)
                                    if decision.mode == "sharded" else self._stream_executor())
                        pred, exec_stats = P.infer_streaming(
                            self.params, prep, executor=executor, plan=plan,
                            device=self.device,
                        )
                pc_after = PLAN_CACHE.snapshot()
                t_inf = time.perf_counter() - t0
                marks.append(("inferred", time.perf_counter()))
                met.histogram("session.infer_s").observe(t_inf)
                if exec_stats:
                    self._fold_exec_stats(exec_stats)

                with tracer.span("verdict"):
                    t0 = time.perf_counter()
                    acc = gnn.accuracy(pred, prep.labels)
                    verdict = P.verify_prepared(prep, pred, signed=signed) if verify else None
                    t_verify = time.perf_counter() - t0
                    met.histogram("session.verify_s").observe(t_verify)
                    mem_full, mem_peak = prep.memory_bytes()
                    result = SessionResult(
                        name=getattr(prep.design, "name", f"{prep.cfg.dataset}:{prep.cfg.bits}"),
                        status=verdict.status if verdict is not None else "classified",
                        accuracy=acc,
                        core_accuracy=acc,
                        verdict=verdict,
                        cached=False,
                        num_nodes=prep.num_nodes,
                        num_edges=prep.num_edges,
                        peak_memory_bytes=mem_peak,
                        unpartitioned_memory_bytes=mem_full,
                        boundary_edge_frac=prep.boundary_edge_frac,
                        routing=decision,
                        timings={
                            **prep.timings,
                            "inference": t_inf,
                            "verify": t_verify,
                            "total": time.perf_counter() - t_start,
                        },
                        plan_cache={
                            "builds": pc_after.builds - pc_before.builds,
                            "hits": pc_after.hits - pc_before.hits,
                        },
                        exec_stats=exec_stats,
                    )
                    if key is not None:
                        # cache a predictions-free, trace-free copy with its
                        # own dicts: the LRU must stay O(results), not
                        # O(designs), and must not alias the mutable stats
                        # the caller receives
                        self.results.put(key, dataclasses.replace(
                            result, predictions=None, trace=None,
                            timings=dict(result.timings), plan_cache=dict(result.plan_cache),
                            exec_stats=dict(result.exec_stats)))
                    if return_predictions:
                        result.predictions = pred
        met.histogram("session.total_s").observe(time.perf_counter() - t_start)
        if self.obs.tracer is not None and root.span_id is not None:
            result.trace = TraceHandle(self.obs.tracer, root.span_id)
        self._record_sync_flight(marks, result.name, result.status, decision=decision)
        return result

    def _fold_exec_stats(self, exec_stats: dict) -> None:
        """Model-vs-actual memory as high-water gauges (a peak must never
        accumulate), and the mesh width (``devices``) as a level; the run's
        other executor stats into the session registry (ints -> ``exec.*``
        counters, timings -> histograms) and the raw totals ``report()``
        exposes."""
        met = self.obs.metrics
        for g in ("modeled_peak_bytes", "actual_peak_bytes", "devices"):
            if exec_stats.get(g):
                met.gauge(f"exec.{g}").set(exec_stats[g])
        fold_into(met, "exec", {k: v for k, v in exec_stats.items()
                                if not k.endswith("peak_bytes") and k != "devices"})
        for k, v in exec_stats.items():
            if k == "devices":
                self.obs.exec_totals[k] = v
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                if k.endswith("peak_bytes") or k == "model_drift":
                    # peaks/ratios keep their high-water mark
                    self.obs.exec_totals[k] = max(self.obs.exec_totals.get(k, 0), v)
                else:
                    self.obs.exec_totals[k] = self.obs.exec_totals.get(k, 0) + v

    def _record_sync_flight(self, marks, name, status, *, cached=False,
                            decision=None) -> None:
        """Sync ``verify`` leaves the same forensic trail as a service
        ticket (negative ids keep the two spaces from colliding in the
        shared ring).  A sync call has no device queue, so its timeline is
        submit -> prepared -> inferred -> done."""
        marks.append(("done", time.perf_counter()))
        streamed = decision is not None and decision.mode in ("streamed", "sharded")
        self.obs.flights.record(record_from_marks(
            -next(self.obs.flight_ids), name, status, marks,
            cached=cached,
            streamed=streamed,
            bucket=decision.buckets[-1] if streamed and decision.buckets else None,
            capacity=self.config.stream_capacity if streamed else None,
        ))

    def flights(self, *, failures_only: bool = False) -> list:
        """The session's retained :class:`~repro_torch.obs.FlightRecord` ring
        — sync verifies (negative ids) and service tickets alike, oldest
        first."""
        return self.obs.flights.records(failures_only=failures_only)

    # -- the async (service-batched) path ------------------------------------

    def _service_engine(self):
        with self._lock:
            if self._closed:
                # a fresh engine here would leak worker threads and could
                # never know the closed engine's tickets anyway
                raise RuntimeError(
                    "session is closed: submit/poll/result need a live service engine")
            if self._service is None:
                from repro_torch.service.server import VerificationService

                self._service = VerificationService(
                    self.params, self.config.service_config(), _warn=False,
                    metrics=self.obs.metrics, flights=self.obs.flights,
                    device=self.device,
                )
            return self._service

    def submit(self, design=None, *, dataset: Optional[str] = None,
               bits: Optional[int] = None, seed: Optional[int] = None,
               verify: bool = True, signed: Optional[bool] = None,
               priority: int = 1, tenant: Optional[str] = None,
               deadline_s: Optional[float] = None) -> int:
        """Async verification through the batched service engine (continuous
        batching into shape-bucketed packs, warmup, overlap of
        prepare/device/verify across requests); returns a ticket for
        :meth:`poll` / :meth:`result`.

        ``priority`` orders the device pool (lower = sooner; 0 is the
        express lane).  ``tenant`` attributes the request for per-tenant
        admission caps (``max_inflight_per_tenant``) — a tenant at its cap
        gets :class:`repro_torch.service.AdmissionError` here.
        ``deadline_s`` overrides the config's per-ticket wall-clock budget;
        an expired ticket fails with ``DeadlineExceeded`` instead of hanging.

        AIGER bytes/paths are handed to the engine unparsed: parsing runs on
        the prepare pool, so a malformed file yields a per-ticket
        ``status="error"`` result instead of raising here."""
        aiger_bytes = None
        if design is not None and not hasattr(design, "to_edge_graph"):
            from repro_torch.io import aiger

            aiger_bytes, design = aiger.source_bytes(design), None
        return self._service_engine().submit(
            design,
            aiger_bytes=aiger_bytes,
            dataset=self.config.dataset if dataset is None else dataset,
            bits=self.config.bits if bits is None else bits,
            seed=self.config.seed if seed is None else seed,
            verify=verify,
            signed=signed,
            priority=priority,
            tenant=tenant,
            deadline_s=deadline_s,
        )

    def warm(self, shapes: Optional[tuple] = None) -> int:
        """Start the service engine and warm its bucket grid now, instead of
        on first :meth:`submit`.  Returns the compiles warmup caused (0 if
        the engine already warmed at construction via
        ``SessionConfig(warmup=True)``)."""
        engine = self._service_engine()
        if engine.scheduler.runner.warmed:
            return 0
        return engine.warm(shapes)

    def poll(self, ticket: int):
        """Non-blocking: the ServiceResult if finished, else None."""
        return self._service_engine().poll(ticket)

    def result(self, ticket: int, timeout: Optional[float] = None):
        """Blocking retrieval of a submitted ticket."""
        return self._service_engine().result(ticket, timeout)

    # -- lifecycle / observability -------------------------------------------

    def stats(self) -> dict:
        out = {"results": self.results.stats, "plan_cache": PLAN_CACHE.snapshot()}
        if self._service is not None:
            out["service"] = self._service.stats()
        return out

    def report(self) -> Report:
        """One snapshot answering "where did the time go" for every route
        this session ran: its own counters/histograms, process-registry
        movement since creation (kernel probes, forward signatures, staged
        bytes), plan/result cache rates, scheduler + executor stats, and the
        span summary when tracing is on."""
        pc, base = PLAN_CACHE.snapshot(), self.obs.plan_cache_baseline
        builds = pc.builds - base.builds
        hits = pc.hits - base.hits
        misses = pc.misses - base.misses
        plan_cache = {
            "builds": builds,
            "hits": hits,
            "misses": misses,
            "evictions": pc.evictions - base.evictions,
            "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
        }
        rc = self.results.stats
        scheduler = None
        if self._service is not None:
            st = self._service.scheduler.stats()
            scheduler = {
                "compile_count": st.compile_count,
                "run_count": st.run_count,
                "buckets": [(b.n_pad, b.e_pad) for b in st.buckets],
                "items_run": st.items_run,
                "streamed_items": st.streamed_items,
                "cold_compiles": st.cold_compiles,
                "warm_compiles": st.warm_compiles,
                "warmup_s": st.warmup_s,
            }
        session_snap = self.obs.metrics.snapshot()
        gauges = session_snap["gauges"]
        memory_model = None
        modeled = gauges.get("exec.modeled_peak_bytes", {}).get("max", 0)
        if modeled:
            # the validation loop for the analytic model driving choose_k:
            # drift ~1.0 means routing decisions rest on honest numbers
            actual = gauges.get("exec.actual_peak_bytes", {}).get("max", 0)
            memory_model = {
                "modeled_peak_bytes": int(modeled),
                "actual_peak_bytes": int(actual),
                "drift": actual / modeled,
            }
        return Report(
            created=datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
            session=session_snap,
            process=REGISTRY.delta(self.obs.registry_baseline),
            # high-water marks of the process gauges (value + max) — the
            # counter-only `process` delta above cannot carry peaks
            process_gauges=REGISTRY.snapshot()["gauges"] or None,
            memory_model=memory_model,
            flights=self.obs.flights.stats() if len(self.obs.flights) else None,
            plan_cache=plan_cache,
            results_cache={"hits": rc.hits, "misses": rc.misses,
                           "evictions": rc.evictions, "hit_rate": rc.hit_rate},
            scheduler=scheduler,
            exec=dict(self.obs.exec_totals) or None,
            spans=self.obs.tracer.summary() if self.obs.tracer is not None else None,
        )

    def save_trace(self, path) -> None:
        """Write the session's full span timeline as Chrome-trace JSON
        (``chrome://tracing`` / Perfetto loadable)."""
        if self.obs.tracer is None:
            raise RuntimeError(
                "tracing is off: construct the session with SessionConfig(trace=True)")
        self.obs.tracer.save(path)

    def close(self, timeout: Optional[float] = 300.0) -> None:
        """Drain and stop the async engine; its device copies are dropped.
        Sync ``verify``/``explain`` keep working afterwards;
        ``submit``/``poll``/``result`` raise."""
        with self._lock:
            svc, self._service = self._service, None
            self._closed = True
        if svc is not None:
            svc.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
