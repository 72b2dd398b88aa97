"""`Session`: the port's front door, full-graph route (port of
``repro/api/session.py``).

    session.verify(design)      route + run + verify
    session.explain(design)     the routing decision, without running

Only mode ``"full"`` is ported, on each of the reference's five backends
(``ref``, ``onehot``, ``groot``, ``groot_mxu``, ``groot_fused``; ``onehot``
materialises an (E, N) one-hot, so it suits small designs only).  A
partition count or a device budget asks
for the partitioned / streamed / sharded routes and raises
``NotImplementedError`` (ROADMAP Queue 1); so does an AIGER file or bytes
as the design (ROADMAP Queue 1, item 3).
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

    mode: str                         # "full" (the only ported mode)
    backend: str
    stream_dtype: Optional[str]       # effective staged-stream dtype (None=f32)
    k: int                            # partition count (1 for full)
    modeled_full_bytes: int           # unpartitioned device-memory model
    modeled_peak_bytes: int           # what is resident: the full bytes
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
    peak_memory_bytes: int
    unpartitioned_memory_bytes: int
    routing: RoutingDecision
    timings: dict
    plan_cache: dict                  # structural-cache deltas for this call
    predictions: Optional[np.ndarray] = None   # verify(return_predictions=True)


def route_prepared(prep: P.PreparedDesign, cfg: SessionConfig) -> RoutingDecision:
    """The routing decision ``verify`` executes and ``explain`` reports."""
    full = prep.memory_bytes()
    return RoutingDecision(
        mode="full", backend=prep.cfg.backend,
        stream_dtype=P.effective_stream_dtype(cfg), k=1,
        modeled_full_bytes=full, modeled_peak_bytes=full,
        memory_budget_bytes=prep.cfg.memory_budget_bytes,
        num_nodes=prep.num_nodes, num_edges=prep.num_edges,
        reason="no partitioning requested (num_partitions <= 1, no budget)",
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
    """One front door over the full-graph verification route."""

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
            "AIGER ingestion is not ported yet: ROADMAP Queue 1, item 3"
        )

    def prepare(self, design=None, *, dataset: Optional[str] = None,
                bits: Optional[int] = None, seed: Optional[int] = None) -> P.PreparedDesign:
        """Host-side stage 1 for this session's config."""
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
               return_predictions: bool = False) -> SessionResult:
        """Prepare, infer on the session's device, and (optionally) verify
        one design.  ``design`` is an AIG/LUT object, or None to generate
        ``dataset``/``bits`` from the config."""
        t_start = time.perf_counter()
        prep = self.prepare(design, dataset=dataset, bits=bits, seed=seed)
        decision = route_prepared(prep, self.config)

        t0 = time.perf_counter()
        pc_before = PLAN_CACHE.snapshot()
        pred = P.infer(self.params, prep, device=self.device)
        pc_after = PLAN_CACHE.snapshot()
        t_inf = time.perf_counter() - t0

        t0 = time.perf_counter()
        acc = gnn.accuracy(pred, prep.labels)
        verdict = P.verify_prepared(prep, pred, signed=signed) if verify else None
        t_verify = time.perf_counter() - t0
        mem = prep.memory_bytes()
        return SessionResult(
            name=getattr(prep.design, "name", f"{prep.cfg.dataset}:{prep.cfg.bits}"),
            status=verdict.status if verdict is not None else "classified",
            accuracy=acc,
            core_accuracy=acc,
            verdict=verdict,
            num_nodes=prep.num_nodes,
            num_edges=prep.num_edges,
            peak_memory_bytes=mem,
            unpartitioned_memory_bytes=mem,
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
