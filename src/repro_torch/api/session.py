"""`Session`: the port's front door (port of ``repro/api/session.py``).

    session.train(...)          train a small model and adopt its params
    session.verify(design)      route + run + verify
    session.explain(design)     the routing decision, without running

A design is None (generated from ``dataset``/``bits``), an AIG/LUT object,
AIGER bytes, or an AIGER file path.  A structural-hash result LRU
(``session.results``) answers a repeated design under the same config
without touching the device; with ``checkpoint_dir`` set, a streamed run
journals each partition so a killed run resumes where it stopped.

Three of the reference's four modes are ported, on each of its five
backends (``ref``, ``onehot``, ``groot``, ``groot_mxu``, ``groot_fused``;
``onehot`` materialises an (E, N) one-hot, so it suits small designs only):

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

The reference's mode "sharded" (the streamed route over more than one
device) raises ``NotImplementedError`` (ROADMAP Queue 1, item 7).  Its
batched service (``submit``/``poll``), tracer, metrics and flight recorder
wait for ROADMAP Queue 1, item 6.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.service.cache import ResultCache


@dataclasses.dataclass(frozen=True)
class RoutingDecision:
    """Why a design runs the way it runs (``session.explain()``)."""

    mode: str                         # "full" | "partitioned" | "streamed"
    backend: str
    stream_dtype: Optional[str]       # effective staged-stream dtype (None=f32)
    k: int                            # partition count (1 for full)
    num_buckets: int                  # compile-unit count (streamed mode)
    buckets: tuple                    # ((n_pad, e_pad), ...) ascending
    modeled_full_bytes: int           # unpartitioned device-memory model
    modeled_peak_bytes: int           # what is resident: the full bytes, the
                                      # largest subgraph's, or the packed-
                                      # launch peak (capacity slots of the
                                      # biggest bucket)
    memory_budget_bytes: Optional[int]
    num_nodes: int
    num_edges: int
    reason: str


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

    P.check_unsharded(cfg.mesh_devices, device)
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
    return RoutingDecision(
        mode="streamed", k=k, num_buckets=plan.num_buckets,
        buckets=tuple((b.n_pad, b.e_pad) for b in plan.buckets),
        modeled_peak_bytes=plan.peak_batch_memory_bytes(pcfg.gnn, cfg.stream_capacity),
        reason=reason, **common,
    ), plan


def _as_model(params, device) -> gnn.GrootGNN:
    """Params as a model on ``device``: a :class:`GrootGNN` (copied, never
    moved in place), the reference's numpy tree, or a ``.npz`` path."""
    if isinstance(params, gnn.GrootGNN):
        params = gnn.params_to_numpy(params)
    elif not isinstance(params, dict):
        params = gnn.load_params(params)
    return gnn.params_from_numpy(params, device=device)


class Session:
    """One front door over the full-graph, partitioned and streamed routes."""

    def __init__(self, params=None, config: Optional[SessionConfig] = None, **overrides):
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
        self._params = None if params is None else _as_model(params, self.device)
        #: structural-hash result LRU: a resubmitted design under the same
        #: config skips prepare + inference + verification entirely
        self.results = ResultCache(config.cache_capacity)

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
        """Adopt new params (anything ``Session(params=...)`` takes) and drop
        the result LRU: its keys carry no params fingerprint, so stale
        entries would be served as fresh.  The executor pool needs nothing:
        it is keyed on params identity."""
        self._params = _as_model(params, self.device)
        self.results = ResultCache(self.config.cache_capacity)

    def options(self, **overrides) -> "Session":
        """A derived session: the same params (shared, not copied), the
        config overridden, a fresh result LRU."""
        derived = Session(config=dataclasses.replace(self.config, **overrides))
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
        (``gnn.predict_partitioned_loop``); in mode "streamed" the result's
        ``exec_stats`` carry the executor's probes for this call."""
        t_start = time.perf_counter()
        key = None
        if prepared is None:
            design = self._resolve_design(design)
            pcfg = self.config.pipeline_config(dataset=dataset, bits=bits, seed=seed)
            key = self._result_key(design, pcfg, verify, signed)
            if use_cache and key is not None and not return_predictions:
                hit = self.results.get(key)
                if hit is not None:
                    # fresh dicts: callers may mutate their result without
                    # corrupting the cached copy or other hits
                    return dataclasses.replace(
                        hit, cached=True, plan_cache=dict(hit.plan_cache),
                        exec_stats=dict(hit.exec_stats),
                        timings={**hit.timings, "total": time.perf_counter() - t_start},
                    )
            prep = P.prepare(pcfg, design)
        else:  # this session's execution knobs over the prepared partitioning
            prep = dataclasses.replace(prepared, cfg=dataclasses.replace(
                prepared.cfg, backend=self.config.backend,
                stream_dtype=self.config.stream_dtype, gnn=self.config.gnn,
                checkpoint_dir=self.config.checkpoint_dir, resume=self.config.resume))
        decision, plan = _route_with_plan(prep, self.config, self.device)

        t0 = time.perf_counter()
        pc_before = PLAN_CACHE.snapshot()
        exec_stats: dict = {}
        if decision.mode == "full":
            pred = P.infer(self.params, prep, device=self.device)
        elif decision.mode == "partitioned":
            pred = gnn.predict_partitioned_loop(
                self.params, prep.subgraphs, prep.feats, prep.num_nodes, prep.cfg.backend,
                stream_dtype=decision.stream_dtype, device=self.device,
                on_partition=on_partition,
            )
        else:
            pred, exec_stats = P.infer_streaming(
                self.params, prep, executor=self._stream_executor(), plan=plan,
                device=self.device,
            )
        pc_after = PLAN_CACHE.snapshot()
        t_inf = time.perf_counter() - t0

        t0 = time.perf_counter()
        acc = gnn.accuracy(pred, prep.labels)
        verdict = P.verify_prepared(prep, pred, signed=signed) if verify else None
        t_verify = time.perf_counter() - t0
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
            # cache a predictions-free copy with its own dicts: the LRU must
            # stay O(results), not O(designs), and must not alias the
            # mutable stats the caller receives
            self.results.put(key, dataclasses.replace(
                result, timings=dict(result.timings), plan_cache=dict(result.plan_cache),
                exec_stats=dict(result.exec_stats)))
        if return_predictions:
            result.predictions = pred
        return result
