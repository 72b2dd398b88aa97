"""End-to-end GROOT verification pipeline, full-graph route (port of
``repro/core/pipeline.py``).

    netlist/AIG -> features -> GNN inference -> XOR/MAJ classification
    -> algebraic verification

The three stages :class:`repro_torch.api.Session` composes:

  :func:`prepare`          host: design generation, features (batching)
  :func:`infer`            device: full-graph GNN prediction
  :func:`verify_prepared`  host: adder extraction + simulation check

Partitioning, re-growth and the streamed executor are not ported yet
(ROADMAP Queue 1, items 4-5): asking for them raises ``NotImplementedError``.
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
from repro_torch.core.verify import VerifyResult, verify


@dataclasses.dataclass
class PipelineConfig:
    dataset: str = "csa"
    bits: int = 32
    batch: int = 1
    num_partitions: int = 1
    gnn: gnn.GNNConfig = dataclasses.field(default_factory=gnn.GNNConfig)
    # aggregation backend: "ref" | "onehot" | "groot" | "groot_mxu" |
    # "groot_fused"
    backend: str = "ref"
    seed: int = 0
    # a device budget makes the reference derive a partition count
    memory_budget_bytes: Optional[int] = None
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
    timings: dict

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    def memory_bytes(self) -> int:
        """Modeled device bytes of the full-graph inference."""
        return memory_model_bytes(self.num_nodes, self.num_edges, self.cfg.gnn)


def prepare(cfg: PipelineConfig, design=None) -> PreparedDesign:
    """Stage 1 (host): design generation, features, batching.

    ``design`` overrides generation; ``cfg.dataset``/``cfg.bits`` are then
    only used for verification metadata downstream.
    """
    if cfg.num_partitions > 1 or cfg.memory_budget_bytes is not None:
        raise NotImplementedError(
            "partitioned inference is not ported yet: ROADMAP Queue 1, items 4-5 "
            "(partitioned and streamed routes)"
        )
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
    return PreparedDesign(
        cfg=cfg, design=design, labels=labels, feats=feats, graph=g,
        timings={"gen": time.perf_counter() - t0},
    )


def effective_stream_dtype(cfg) -> Optional[str]:
    """The staged edge-stream dtype a run uses: the pipeline-level knob
    wins, else the GNN config's; f32 normalises to None."""
    sdt = cfg.stream_dtype or cfg.gnn.stream_dtype
    return None if sdt in (None, "float32") else sdt


def infer(params: gnn.GrootGNN, prep: PreparedDesign, *, backend: Optional[str] = None,
          device=None) -> np.ndarray:
    """Stage 2 (device): per-node class predictions over the full graph."""
    return gnn.predict(
        params, prep.graph, prep.feats, backend=backend or prep.cfg.backend,
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
