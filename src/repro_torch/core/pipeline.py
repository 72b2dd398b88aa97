"""End-to-end GROOT verification pipeline (port of ``repro/core/pipeline.py``).

    netlist/AIG -> features -> [partition -> re-growth] -> GNN inference
    -> XOR/MAJ classification -> algebraic verification

The three stages :class:`repro_torch.api.Session` composes:

  :func:`prepare`          host: design generation, features (batching),
                           partitioning + boundary re-growth
  :func:`infer`            device: full-graph GNN prediction
  :func:`verify_prepared`  host: adder extraction + simulation check

A partitioned design streams through the ``repro_torch.exec`` executor
(:func:`infer_streaming`: bucketed packed launches, host prefetch; with
``checkpoint_dir`` set, each partition's predictions are journalled so a
killed run resumes); the sequential per-subgraph loop
(``gnn.predict_partitioned_loop``) gives the same core predictions.
:func:`train_model` trains the GNN on a small design.  The analytic
device-memory model (:func:`memory_model_bytes`) is the reference's, so
routing decisions agree; partitioned runs count the PEAK over partitions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import aig as A
from repro_torch.core import gnn
from repro_torch.core.features import groot_features
from repro_torch.core.graph import EdgeGraph, batch_graphs
from repro_torch.core.partition import PARTITIONERS
from repro_torch.core.regrowth import Subgraph, boundary_edge_fraction, extract_partitions
from repro_torch.core.verify import VerifyResult, verify
from repro_torch.obs import REGISTRY, span


def resolve_backend_alias(backend: Optional[str], aggregate: Optional[str],
                          *, owner: str) -> str:
    """Collapse the ``aggregate``/``backend`` naming split to ``backend``.

    ``aggregate=`` (the old ``PipelineConfig`` spelling) keeps working as
    a write-only alias: it warns, fills ``backend`` when that is unset,
    and conflicts loudly instead of silently preferring one.  Returns the
    resolved backend (default ``"ref"``).  Lives here (not ``repro_torch.api``)
    so the core layer never imports upward.
    """
    if aggregate is not None:
        import warnings

        warnings.warn(
            f"{owner}(aggregate=...) is deprecated; the knob is named "
            f"backend= everywhere now",
            DeprecationWarning,
            # resolve_backend_alias <- __post_init__ <- generated __init__
            # <- the user's call site
            stacklevel=4,
        )
        if backend is None:
            backend = aggregate
        elif backend != aggregate:
            raise ValueError(
                f"{owner}: backend={backend!r} and its deprecated alias "
                f"aggregate={aggregate!r} disagree — pass only backend="
            )
    return "ref" if backend is None else backend


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
    stream_capacity: int = 2      # same-bucket partitions packed per launch
    stream_prefetch: int = 1      # packed batches staged ahead of the device
    # edge-stream dtype for the hoisted groot* forward; None defers to
    # ``gnn.stream_dtype``
    stream_dtype: Optional[str] = None
    # devices the streamed route shards over: None = every visible device of
    # the run's device type; more than one asks for the sharded route, which
    # is not ported (ROADMAP Queue 1, item 7)
    mesh_devices: Optional[int] = None
    # crash-safe resume for streamed runs: when ``checkpoint_dir`` is set
    # (and the design has a structural hash), every launched partition's
    # core predictions are journalled atomically, and a re-run restores
    # committed partitions instead of re-executing them.  ``resume=False``
    # keeps journalling but ignores (wipes) any prior journal.
    checkpoint_dir: Optional[str] = None
    resume: bool = True


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


def layer_traffic_model_bytes(
    num_nodes: int,
    num_edges: int,
    cfg: gnn.GNNConfig,
    *,
    hoisted: bool = True,
    stream_dtype: Optional[str] = None,
    slots_in: Optional[int] = None,
    slots_out: Optional[int] = None,
    segments_in: int = 4,
    segments_out: int = 4,
) -> int:
    """Modeled per-layer HBM traffic of the grouped aggregation hot path.

    Counts the three per-layer terms the ForwardPlan hoisting targets
    (array-accurate when the caller passes the real plan ``num_slots`` /
    ``num_segments``; pow-2-padding estimates otherwise):

      * **edge-message streams** — ``x[src]`` gathered once per direction
        per layer: ``(slots_in + slots_out) * H * stream_bytes``.  Both
        paths pay it; ``stream_dtype="bfloat16"`` halves it.
      * **edge-weight streams** — pre-hoist each layer re-gathers the
        (E, 4) fanin + (E, 2) fanout group weights into kernel layout;
        hoisted stages them once per forward, so the per-layer share is
        amortised by ``num_layers``.
      * **output assembly** — pre-hoist each aggregation issues one
        ``(N, H)`` scatter per LD bucket plus one for HD (each a
        read-modify-write of the output array) plus the final read;
        hoisted assembles with a single permutation gather (concat write
        + gather read + result write: 3 passes).
    """
    f32 = 4
    sdt = np.dtype(stream_dtype) if stream_dtype is not None else np.dtype("float32")
    sb = sdt.itemsize
    h = cfg.hidden
    s_in = 2 * num_edges if slots_in is None else slots_in
    s_out = 2 * num_edges if slots_out is None else slots_out
    layers = max(cfg.num_layers, 1)

    traffic = (s_in + s_out) * h * sb                 # message streams
    w_bytes = (4 * s_in + 2 * s_out) * sb             # group-weight streams
    traffic += w_bytes // layers if hoisted else w_bytes
    out_plane = num_nodes * h * f32                   # one (N, H) pass
    if hoisted:
        traffic += 2 * 3 * out_plane                  # both directions
    else:
        # segments already counts the HD pass: 2 touches (read+write) per
        # scatter segment, plus the final read of the assembled output
        traffic += (2 * segments_in + 1) * out_plane
        traffic += (2 * segments_out + 1) * out_plane
    return int(traffic)


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
    with span("prepare.features"):
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
    REGISTRY.counter("pipeline.prepares").inc()

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
        with span("prepare.partition", k=k, partitioner=cfg.partitioner) as sp:
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
            sp.set(final_k=len(subs) if subs else 1)
        REGISTRY.counter("pipeline.partition_cuts").inc()
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
          device=None) -> np.ndarray:
    """Stage 2 (device): per-node class predictions over the full graph.

    Partitioned designs stream (plan -> packed launches -> scatter);
    :func:`infer_streaming` exposes the executor's probe counters too."""
    if prep.subgraphs is None:
        return gnn.predict(
            params, prep.graph, prep.feats, backend=backend or prep.cfg.backend,
            stream_dtype=effective_stream_dtype(prep.cfg), device=device,
        )
    pred, _ = infer_streaming(params, prep, backend=backend, device=device)
    return pred


def resolve_mesh_devices(mesh_devices: Optional[int], device=None) -> int:
    """The devices a streamed route would shard over: ``mesh_devices``, or
    with None every visible device of ``device``'s type (one for the CPU)."""
    if mesh_devices is not None:
        return max(1, int(mesh_devices))
    from repro_torch import resolve_device

    if resolve_device(device).type == "cuda":
        import torch

        return torch.cuda.device_count()
    return 1


def check_unsharded(mesh_devices: Optional[int], device=None) -> None:
    """Raise where the streamed route would shard over more than one device
    (:func:`resolve_mesh_devices`): the reference's mode "sharded" is not
    ported, and streaming on one device instead would ignore the ask."""
    devices = resolve_mesh_devices(mesh_devices, device)
    if devices > 1:
        raise NotImplementedError(
            f"the sharded route is not ported yet: ROADMAP Queue 1, item 7 ({devices} "
            f"devices asked for; pass mesh_devices=1 to stream on one device)"
        )


def _journal_for(prep: PreparedDesign):
    """The crash-resume journal of a streamed run, or None.

    Journalling needs a durable identity for "the same work": the design's
    structural hash (the result cache's key).  Only single-AIG runs have
    one, so batched/LUT runs stream unjournalled.  ``resume=False`` wipes
    any prior journal before the run — fresh execution, fresh journal.
    """
    cfg = prep.cfg
    if not cfg.checkpoint_dir or cfg.batch != 1 or not isinstance(prep.design, A.AIG):
        return None
    from repro_torch.checkpoint import PartitionJournal
    from repro_torch.io import aiger

    journal = PartitionJournal(cfg.checkpoint_dir, aiger.structural_hash(prep.design))
    if not cfg.resume:
        journal.complete()  # discard any prior partial run
    return journal


def infer_streaming(
    params: gnn.GrootGNN,
    prep: PreparedDesign,
    *,
    backend: Optional[str] = None,
    executor=None,
    plan=None,
    device=None,
    journal=None,
) -> tuple[np.ndarray, dict]:
    """Partitioned inference through the streaming executor.

    Returns ``(pred, exec_stats)`` where ``exec_stats`` carries the executor
    probes (compiles, launches, bytes_h2d, pack/device/wall seconds) plus
    ``peak_packed_memory_bytes`` — the modeled device bytes of the largest
    packed launch — and ``chosen_k``.  Without an ``executor`` the shared
    one for (params, backend, knobs) on ``device`` runs it; more than one
    device of that type asks for the sharded route, which raises.

    ``journal``: an explicit :class:`~repro_torch.checkpoint.PartitionJournal`;
    when None one is derived from ``cfg.checkpoint_dir`` (keyed by the
    design's structural hash) if configured — see :func:`_journal_for`.
    """
    from repro_torch.exec.plan import plan_from_subgraphs
    from repro_torch.exec.stream import shared_executor

    assert prep.subgraphs, "infer_streaming needs a partitioned PreparedDesign"
    backend = backend or prep.cfg.backend
    cfg = prep.cfg
    if executor is None:
        check_unsharded(cfg.mesh_devices, device)
        executor = shared_executor(
            params, backend, capacity=cfg.stream_capacity, prefetch=cfg.stream_prefetch,
            stream_dtype=effective_stream_dtype(cfg), device=device,
        )
    if plan is None:
        plan = plan_from_subgraphs(
            list(prep.subgraphs), prep.num_nodes, num_edges=prep.num_edges,
            regrow=cfg.regrow, partitioner=cfg.partitioner, seed=cfg.seed,
            min_nodes=executor.min_nodes, min_edges=executor.min_edges,
        )
    if journal is None:
        journal = _journal_for(prep)
    before = dataclasses.replace(executor.stats)
    pred = executor.run_plan(plan, prep.feats, gnn_cfg=cfg.gnn, journal=journal)
    stats = dataclasses.asdict(executor.stats.delta(before))
    stats["peak_packed_memory_bytes"] = plan.peak_batch_memory_bytes(
        cfg.gnn, executor.capacity
    )
    stats["num_buckets"] = plan.num_buckets
    stats["chosen_k"] = prep.num_partitions
    # model drift: the analytic model on real launched shapes over the
    # plan-time prediction choose_k budgeted against (> 1: launches were
    # bigger than modeled)
    modeled, actual = stats["modeled_peak_bytes"], stats["actual_peak_bytes"]
    if modeled:
        stats["model_drift"] = actual / modeled
    return pred, stats


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
    with span("pipeline.verify_prepared", bits=bits):
        REGISTRY.counter("pipeline.verifications").inc()
        return verify(
            prep.design,
            pred[: prep.design.num_nodes],
            bits=bits,
            signed=signed,
            simulate=bits <= 64,
        )


def train_model(
    dataset: str = "csa",
    bits: int = 8,
    *,
    cfg: Optional[gnn.GNNConfig] = None,
    epochs: int = 300,
    seed: int = 0,
    device=None,
):
    """Train the GNN on a small design (the paper trains on 8-bit) on
    ``device`` (``cuda`` unless named): the init is drawn on the host from
    ``seed``, so every device starts from the same params.  Returns
    ``(params, [(epoch, loss), ...])``."""
    cfg = cfg or gnn.GNNConfig()
    device = resolve_device(device)
    design = A.make_design(dataset, bits, seed=seed)
    feats = groot_features(design)
    batch = gnn.make_batch(design, feats, design.label.astype(np.int32), device=device)
    params = gnn.init_params(cfg, seed, device=device)
    return gnn.train(params, batch, epochs=epochs, log_every=50)
