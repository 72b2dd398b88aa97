"""End-to-end GROOT verification pipeline (port of ``repro/core/pipeline.py``).

    netlist/AIG -> features -> [partition -> re-growth] -> GNN inference
    -> XOR/MAJ classification -> algebraic verification

The three stages :class:`repro_torch.api.Session` composes:

  :func:`prepare`          host: design generation, features (batching),
                           partitioning + boundary re-growth
  :func:`infer`            device: full-graph GNN prediction
  :func:`verify_prepared`  host: adder extraction + simulation check

A partitioned design runs through the sequential per-subgraph loop
(``gnn.predict_partitioned_loop``); the streamed executor is not ported yet
(ROADMAP Queue 1, item 2).  The analytic device-memory model
(:func:`memory_model_bytes`) is the reference's, so routing decisions agree;
partitioned runs count the PEAK over partitions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core import aig as A
from repro_torch.core import gnn
from repro_torch.core.features import groot_features
from repro_torch.core.graph import EdgeGraph, batch_graphs
from repro_torch.core.partition import PARTITIONERS
from repro_torch.core.regrowth import Subgraph, boundary_edge_fraction, extract_partitions
from repro_torch.core.verify import VerifyResult, verify


@dataclasses.dataclass
class PipelineConfig:
    dataset: str = "csa"
    bits: int = 32
    batch: int = 1
    num_partitions: int = 1
    regrow: bool = True
    regrow_hops: int = 1          # re-growth depth (iterated Algorithm 1);
                                  # >= gnn.num_layers -> partitioned == full
    partitioner: str = "multilevel"
    gnn: gnn.GNNConfig = dataclasses.field(default_factory=gnn.GNNConfig)
    # aggregation backend: "ref" | "onehot" | "groot" | "groot_mxu" |
    # "groot_fused"
    backend: str = "ref"
    seed: int = 0
    # ``memory_budget_bytes`` set and num_partitions <= 1: prepare() derives
    # the partition count from the device budget via choose_k
    memory_budget_bytes: Optional[int] = None
    stream_capacity: int = 2      # same-bucket partitions per modeled launch
    # edge-stream dtype for the hoisted groot* forward; None defers to
    # ``gnn.stream_dtype``
    stream_dtype: Optional[str] = None


def memory_model_bytes(
    num_nodes: int, num_edges: int, cfg: gnn.GNNConfig, include_params: bool = True
) -> int:
    """Device bytes for one inference over a (sub)graph (the reference's
    analytic model, kept identical so routing decisions agree).

    features (N,Fin) fp32 + per-layer activations 2x(N,H) (double-buffered
    current/next) + 2x aggregated (N,H) + edge index arrays 2x int32 x2
    directions + gathered edge stream (E,H) fp32 + params.
    """
    f32 = 4
    n, e = num_nodes, num_edges
    bytes_ = n * cfg.in_features * f32
    h = cfg.hidden
    bytes_ += 2 * n * h * f32          # h, h_next
    bytes_ += 2 * n * h * f32          # agg_in, agg_out
    bytes_ += 2 * 2 * e * 4            # edge src/dst, both directions
    bytes_ += e * h * f32              # gathered edge stream
    if include_params:
        p = cfg.in_features * h * 3 + (cfg.num_layers - 1) * 3 * h * h + h * cfg.num_classes
        bytes_ += p * f32
    return int(bytes_)


@dataclasses.dataclass
class PreparedDesign:
    """Host-side output of :func:`prepare` — everything inference needs."""

    cfg: PipelineConfig
    design: object               # AIG or LUTGraph
    labels: np.ndarray
    feats: np.ndarray
    graph: EdgeGraph
    subgraphs: Optional[list[Subgraph]]   # None when unpartitioned
    boundary_edge_frac: float
    timings: dict

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    @property
    def num_partitions(self) -> int:
        """Effective partition count (budget-driven prepare may exceed
        ``cfg.num_partitions``)."""
        return len(self.subgraphs) if self.subgraphs else 1

    def memory_bytes(self) -> tuple[int, int]:
        """(unpartitioned, peak-over-partitions) modeled device bytes."""
        full = memory_model_bytes(self.num_nodes, self.num_edges, self.cfg.gnn)
        if not self.subgraphs:
            return full, full
        peak = max(
            memory_model_bytes(sg.num_nodes, sg.num_edges, self.cfg.gnn)
            for sg in self.subgraphs
        )
        return full, peak


def prepare(cfg: PipelineConfig, design=None) -> PreparedDesign:
    """Stage 1 (host): design generation, features, batching, partitioning
    and boundary re-growth.

    ``design`` overrides generation; ``cfg.dataset``/``cfg.bits`` are then
    only used for verification metadata downstream.  A budget with
    ``num_partitions <= 1`` picks k through ``choose_k``, then doubles it
    until the built plan's modeled peak launch fits.
    """
    t0 = time.perf_counter()
    if design is None:
        design = A.make_design(cfg.dataset, cfg.bits, seed=cfg.seed)
    labels = design.label
    feats = groot_features(design)
    g1 = design.to_edge_graph()
    if cfg.batch > 1:
        g = batch_graphs([g1] * cfg.batch)
        feats = np.tile(feats, (cfg.batch, 1))
        labels = np.tile(labels, cfg.batch)
    else:
        g = g1
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    k = cfg.num_partitions
    budgeted = k <= 1 and cfg.memory_budget_bytes is not None
    if budgeted:
        from repro_torch.exec.plan import HALO_FRAC, choose_k

        # halo grows with re-growth depth; scale the planning margin so
        # deep-hop runs are not fitted with the 1-hop estimate
        k = choose_k(
            g.num_nodes, g.num_edges, cfg.gnn, cfg.memory_budget_bytes,
            capacity=cfg.stream_capacity,
            halo_frac=HALO_FRAC * max(1, cfg.regrow_hops if cfg.regrow else 1),
        )

    def _cut(k):
        part = PARTITIONERS[cfg.partitioner](g, k, seed=cfg.seed)
        return part, extract_partitions(g, part, regrow=cfg.regrow, hops=cfg.regrow_hops)

    if k <= 1:
        subs, bfrac, t_part = None, 0.0, 0.0
    else:
        part, subs = _cut(k)
        if budgeted and subs:
            # the estimate can undershoot real halo growth: validate the
            # BUILT plan's packed peak and re-split finer until it fits
            from repro_torch.exec.plan import plan_from_subgraphs

            while k < g.num_nodes and plan_from_subgraphs(
                subs, g.num_nodes
            ).peak_batch_memory_bytes(
                cfg.gnn, cfg.stream_capacity
            ) > cfg.memory_budget_bytes:
                k *= 2
                part, subs = _cut(k)
        bfrac = boundary_edge_fraction(g, part)
        if not subs:  # empty graph: fall back to the unpartitioned path
            subs = None
        t_part = time.perf_counter() - t0
    return PreparedDesign(
        cfg=cfg, design=design, labels=labels, feats=feats, graph=g,
        subgraphs=subs, boundary_edge_frac=bfrac,
        timings={"gen": t_gen, "partition": t_part},
    )


def effective_stream_dtype(cfg) -> Optional[str]:
    """The staged edge-stream dtype a run uses: the pipeline-level knob
    wins, else the GNN config's; f32 normalises to None."""
    sdt = cfg.stream_dtype or cfg.gnn.stream_dtype
    return None if sdt in (None, "float32") else sdt


def infer(params: gnn.GrootGNN, prep: PreparedDesign, *, backend: Optional[str] = None,
          device=None, on_partition=None) -> np.ndarray:
    """Stage 2 (device): per-node class predictions over the full graph,
    or, for a partitioned design, through the sequential per-subgraph loop
    (core predictions scattered back; ``on_partition`` as in
    ``gnn.predict_partitioned_loop``).  The reference streams partitioned
    designs; its streamed and looped core predictions are identical."""
    backend = backend or prep.cfg.backend
    if prep.subgraphs is not None:
        return gnn.predict_partitioned_loop(
            params, prep.subgraphs, prep.feats, prep.num_nodes, backend,
            stream_dtype=effective_stream_dtype(prep.cfg), device=device,
            on_partition=on_partition,
        )
    return gnn.predict(
        params, prep.graph, prep.feats, backend=backend,
        stream_dtype=effective_stream_dtype(prep.cfg), device=device,
    )


def verify_prepared(
    prep: PreparedDesign, pred: np.ndarray, *, signed: Optional[bool] = None
) -> Optional[VerifyResult]:
    """Stage 3 (host): algebraic adder extraction + simulation cross-check.

    Returns None when the prepared design is not verifiable as a single
    multiplier AIG (batched runs, LUT graphs).
    """
    if prep.cfg.batch != 1 or not isinstance(prep.design, A.AIG):
        return None
    bits = prep.design.n_pi // 2
    if signed is None:
        signed = prep.cfg.dataset == "booth" or prep.design.name.startswith("booth")
    return verify(
        prep.design,
        pred[: prep.design.num_nodes],
        bits=bits,
        signed=signed,
        simulate=bits <= 64,
    )
