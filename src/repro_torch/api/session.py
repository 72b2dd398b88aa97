"""`Session`: the port's front door (port of ``repro/api/session.py``).

    session.verify(design)      route + run + verify
    session.explain(design)     the routing decision, without running

Two of the reference's modes are ported, on each of its five backends
(``ref``, ``onehot``, ``groot``, ``groot_mxu``, ``groot_fused``; ``onehot``
materialises an (E, N) one-hot, so it suits small designs only):

  mode "full"         unpartitioned (no partition count, no budget)
  mode "partitioned"  ``streaming=False``: the design is partitioned and
                      re-grown (Algorithm 1) and each subgraph runs the
                      full-graph forward in turn

With ``streaming=True`` (the reference's default) a partition count or a
budget asks for the streamed or sharded route, which raises
``NotImplementedError`` (ROADMAP Queue 1, items 2 and 7); so does an AIGER
file or bytes as the design (ROADMAP Queue 1, item 5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.api.config import SessionConfig
from repro_torch.core import gnn
from repro_torch.core import pipeline as P
from repro_torch.core.verify import VerifyResult
from repro_torch.kernels.plan_cache import PLAN_CACHE


@dataclasses.dataclass(frozen=True)
class RoutingDecision:
    """Why a design runs the way it runs (``session.explain()``)."""

    mode: str                         # "full" | "partitioned"
    backend: str
    stream_dtype: Optional[str]       # effective staged-stream dtype (None=f32)
    k: int                            # partition count (1 for full)
    num_buckets: int                  # compile-unit count (streamed mode: 0 here)
    buckets: tuple                    # ((n_pad, e_pad), ...) (streamed mode: ())
    modeled_full_bytes: int           # unpartitioned device-memory model
    modeled_peak_bytes: int           # what is resident: the full bytes, or
                                      # the largest subgraph's
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
    num_nodes: int
    num_edges: int
    peak_memory_bytes: int            # peak over partitions (full bytes if k=1)
    unpartitioned_memory_bytes: int
    boundary_edge_frac: float
    routing: RoutingDecision
    timings: dict
    plan_cache: dict                  # structural-cache deltas for this call
    predictions: Optional[np.ndarray] = None   # verify(return_predictions=True)


STREAMED_UNPORTED = (
    "the streamed and sharded routes are not ported yet: ROADMAP Queue 1, items 2 "
    "and 7 (a partition count or a memory budget with streaming=True asks for "
    "them); pass streaming=False for the sequential partitioned loop"
)


def check_ported(cfg: SessionConfig) -> None:
    """Raise for a configuration only the unported routes serve: with
    ``streaming=True`` a partition count or a budget plans packed streamed
    launches (the reference routes a design that fits its budget to mode
    "full", but on the streamed route's plan)."""
    if cfg.streaming and (cfg.num_partitions > 1 or cfg.memory_budget_bytes is not None):
        raise NotImplementedError(STREAMED_UNPORTED)


def route_prepared(prep: P.PreparedDesign, cfg: SessionConfig) -> RoutingDecision:
    """The routing decision ``verify`` executes and ``explain`` reports
    (a partitioned ``prep`` under ``streaming=True`` asks for the streamed
    route, whatever the session's own partition count)."""
    check_ported(cfg)
    if cfg.streaming and prep.subgraphs is not None:
        raise NotImplementedError(STREAMED_UNPORTED)
    pcfg = prep.cfg
    full_bytes, peak_parts = prep.memory_bytes()
    budget = pcfg.memory_budget_bytes
    common = dict(
        backend=pcfg.backend, stream_dtype=P.effective_stream_dtype(cfg),
        num_buckets=0, buckets=(), modeled_full_bytes=full_bytes,
        memory_budget_bytes=budget, num_nodes=prep.num_nodes, num_edges=prep.num_edges,
    )
    if prep.subgraphs is None:
        reason = (
            f"modeled {full_bytes} B fits the {budget} B budget unpartitioned"
            if budget is not None
            else "no partitioning requested (num_partitions <= 1, no budget)"
        )
        return RoutingDecision(mode="full", k=1, modeled_peak_bytes=full_bytes,
                               reason=reason, **common)
    k = prep.num_partitions
    return RoutingDecision(
        mode="partitioned", k=k, modeled_peak_bytes=peak_parts,
        reason=f"k={k} partitions through the sequential loop (streaming disabled)",
        **common,
    )


def _as_model(params, device) -> gnn.GrootGNN:
    """Params as a model on ``device``: a :class:`GrootGNN` (copied, never
    moved in place), the reference's numpy tree, or a ``.npz`` path."""
    if isinstance(params, gnn.GrootGNN):
        params = gnn.params_to_numpy(params)
    elif not isinstance(params, dict):
        params = gnn.load_params(params)
    return gnn.params_from_numpy(params, device=device)


class Session:
    """One front door over the full-graph and partitioned verification routes."""

    def __init__(self, params=None, config: Optional[SessionConfig] = None, **overrides):
        if config is None:
            config = SessionConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = resolve_device(config.device)
        self._params = None if params is None else _as_model(params, self.device)

    @property
    def params(self) -> gnn.GrootGNN:
        if self._params is None:
            raise RuntimeError("session has no params: pass them to Session(params=...)")
        return self._params

    def _resolve_design(self, design):
        if design is None or hasattr(design, "to_edge_graph"):
            return design
        raise NotImplementedError(
            "AIGER ingestion is not ported yet: ROADMAP Queue 1, item 5"
        )

    def prepare(self, design=None, *, dataset: Optional[str] = None,
                bits: Optional[int] = None, seed: Optional[int] = None) -> P.PreparedDesign:
        """Host-side stage 1 for this session's config (features,
        partitioning, re-growth)."""
        check_ported(self.config)
        pcfg = self.config.pipeline_config(dataset=dataset, bits=bits, seed=seed)
        return P.prepare(pcfg, self._resolve_design(design))

    def explain(self, design=None, *, dataset: Optional[str] = None,
                bits: Optional[int] = None, seed: Optional[int] = None) -> RoutingDecision:
        """The routing decision ``verify`` would take, without running
        inference.  Needs no params."""
        return route_prepared(
            self.prepare(design, dataset=dataset, bits=bits, seed=seed), self.config
        )

    def verify(self, design=None, *, dataset: Optional[str] = None,
               bits: Optional[int] = None, seed: Optional[int] = None,
               verify: bool = True, signed: Optional[bool] = None,
               return_predictions: bool = False,
               prepared: Optional[P.PreparedDesign] = None,
               on_partition=None) -> SessionResult:
        """Prepare, infer on the session's device, and (optionally) verify
        one design.  ``design`` is an AIG/LUT object, or None to generate
        ``dataset``/``bits`` from the config; ``prepared`` (from
        :meth:`prepare`) skips the host stage 1 instead, e.g. to run one
        partitioning under several backends.  In mode "partitioned",
        ``on_partition(i, sg)`` is called after each subgraph's forward
        (``gnn.predict_partitioned_loop``)."""
        t_start = time.perf_counter()
        if prepared is None:
            prep = self.prepare(design, dataset=dataset, bits=bits, seed=seed)
        else:  # this session's execution knobs over the prepared partitioning
            prep = dataclasses.replace(prepared, cfg=dataclasses.replace(
                prepared.cfg, backend=self.config.backend,
                stream_dtype=self.config.stream_dtype, gnn=self.config.gnn))
        decision = route_prepared(prep, self.config)

        t0 = time.perf_counter()
        pc_before = PLAN_CACHE.snapshot()
        pred = P.infer(self.params, prep, device=self.device, on_partition=on_partition)
        pc_after = PLAN_CACHE.snapshot()
        t_inf = time.perf_counter() - t0

        t0 = time.perf_counter()
        acc = gnn.accuracy(pred, prep.labels)
        verdict = P.verify_prepared(prep, pred, signed=signed) if verify else None
        t_verify = time.perf_counter() - t0
        mem_full, mem_peak = prep.memory_bytes()
        return SessionResult(
            name=getattr(prep.design, "name", f"{prep.cfg.dataset}:{prep.cfg.bits}"),
            status=verdict.status if verdict is not None else "classified",
            accuracy=acc,
            core_accuracy=acc,
            verdict=verdict,
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
            predictions=pred if return_predictions else None,
        )
