"""Partition execution plans: the host-side schedule of a streamed run
(port of ``repro/exec/plan.py``, host numpy).

A :class:`PartitionPlan` is everything the streaming executor needs to
drive an arbitrarily large design through device-sized launches, computed
ONCE per design:

  * the k-way partition + boundary re-growth (paper §III-C / Algorithm 1),
  * the pow-2 shape bucket each subgraph falls in,
  * a deterministic batch schedule grouping same-bucket subgraphs into
    ``capacity``-slot packed launches.

Plans are pure functions of (graph structure, partition knobs), so
:func:`build_partition_plan` caches them by content hash in
:data:`EXEC_PLAN_CACHE`.  :func:`choose_k` closes the loop with the device:
given a memory budget it picks the partition count from
:func:`repro_torch.core.pipeline.memory_model_bytes`, accounting for halo
growth, pow-2 padding and the ``capacity`` slots resident per launch.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

from repro_torch.core.graph import EdgeGraph
from repro_torch.core.partition import PARTITIONERS
from repro_torch.core.regrowth import Subgraph, boundary_edge_fraction, extract_partitions
from repro_torch.kernels import ops
from repro_torch.kernels.plan_cache import PlanCache, graph_key
from repro_torch.service.bucketing import BucketShape

#: Dedicated cache for execution plans, NOT the kernel-layer PLAN_CACHE: a
#: PartitionPlan embeds every subgraph's arrays (roughly the whole design
#: plus halo), so entries are design-sized and a small LRU bounds host
#: memory.  Plans are built OUTSIDE the cache lock (peek/add).
EXEC_PLAN_CACHE = PlanCache(capacity=8)

#: Assumed relative halo growth of a re-grown partition (the paper observes
#: ~10% boundary edges on METIS-partitioned AIGs; 15% is a safe planning
#: margin).  Only used for *estimates* (choose_k) — the built plan uses the
#: real subgraph sizes.
HALO_FRAC = 0.15


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Partition + bucket assignment for one design (immutable, cacheable)."""

    num_nodes: int               # global node count (scatter target size)
    num_edges: int
    k: int                       # requested partition count
    regrow: bool
    partitioner: str
    seed: int
    min_nodes: int               # bucket floors (compile-unit quantisation)
    min_edges: int
    subgraphs: tuple[Subgraph, ...]
    buckets: tuple[BucketShape, ...]   # distinct shapes, sorted ascending
    bucket_of: np.ndarray        # (num_parts,) int32 -> index into buckets
    boundary_edge_frac: float

    @property
    def num_parts(self) -> int:
        return len(self.subgraphs)

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def schedule(self, capacity: int) -> list[tuple[BucketShape, list[int]]]:
        """Deterministic launch schedule: same-bucket subgraphs chunked
        ``capacity`` at a time, buckets in ascending shape order."""
        assert capacity >= 1
        out: list[tuple[BucketShape, list[int]]] = []
        for bi, shape in enumerate(self.buckets):
            members = [i for i in range(self.num_parts) if self.bucket_of[i] == bi]
            for j in range(0, len(members), capacity):
                out.append((shape, members[j : j + capacity]))
        return out

    def peak_batch_memory_bytes(self, gnn_cfg, capacity: int) -> int:
        """Modeled device bytes of the largest packed launch (``capacity``
        padded slots of the biggest bucket)."""
        from repro_torch.core.pipeline import memory_model_bytes

        if not self.buckets:
            return 0
        big = self.buckets[-1]
        return memory_model_bytes(capacity * big.n_pad, capacity * big.e_pad, gnn_cfg)

    def peak_layer_traffic_bytes(
        self, gnn_cfg, capacity: int, *, hoisted: bool = True,
        stream_dtype: str | None = None,
    ) -> int:
        """Modeled per-layer HBM traffic of the largest packed launch."""
        from repro_torch.core.pipeline import layer_traffic_model_bytes

        if not self.buckets:
            return 0
        big = self.buckets[-1]
        return layer_traffic_model_bytes(
            capacity * big.n_pad, capacity * big.e_pad, gnn_cfg,
            hoisted=hoisted, stream_dtype=stream_dtype,
        )


def _bucket_for(num_nodes: int, num_edges: int, min_nodes: int, min_edges: int) -> BucketShape:
    n_pad, e_pad = ops.padded_shape(
        num_nodes, num_edges, min_nodes=min_nodes, min_edges=min_edges
    )
    return BucketShape(n_pad, e_pad)


def plan_from_subgraphs(
    subgraphs: list[Subgraph],
    num_nodes: int,
    *,
    num_edges: int = 0,
    regrow: bool = True,
    partitioner: str = "precomputed",
    seed: int = 0,
    min_nodes: int = 64,
    min_edges: int = 128,
) -> PartitionPlan:
    """Wrap already-extracted partitions into a plan: assigns buckets, no
    re-partitioning."""
    shapes = [
        _bucket_for(sg.num_nodes, sg.num_edges, min_nodes, min_edges)
        for sg in subgraphs
    ]
    buckets = sorted(set(shapes), key=lambda b: (b.n_pad, b.e_pad))
    index = {b: i for i, b in enumerate(buckets)}
    return PartitionPlan(
        num_nodes=num_nodes,
        num_edges=num_edges,
        k=len(subgraphs),
        regrow=regrow,
        partitioner=partitioner,
        seed=seed,
        min_nodes=min_nodes,
        min_edges=min_edges,
        subgraphs=tuple(subgraphs),
        buckets=tuple(buckets),
        bucket_of=np.array([index[s] for s in shapes], dtype=np.int32),
        boundary_edge_frac=0.0,
    )


def build_partition_plan(
    graph: EdgeGraph,
    k: int,
    *,
    regrow: bool = True,
    hops: int = 1,
    partitioner: str = "multilevel",
    seed: int = 0,
    min_nodes: int = 64,
    min_edges: int = 128,
    use_cache: bool = True,
) -> PartitionPlan:
    """Partition + re-growth + bucket assignment for one design.

    ``hops`` is the re-growth depth (iterated Algorithm 1).  Content-hash
    cached: the same (structure, annotations, knobs) always returns the
    SAME plan object, so repeated streamed runs over a recurring design
    skip the whole host-side partitioning pass.
    """

    def _build() -> PartitionPlan:
        part = PARTITIONERS[partitioner](graph, k, seed=seed)
        bfrac = boundary_edge_fraction(graph, part) if part.size else 0.0
        subs = extract_partitions(graph, part, regrow=regrow, hops=hops)
        plan = plan_from_subgraphs(
            subs, graph.num_nodes, num_edges=graph.num_edges, regrow=regrow,
            partitioner=partitioner, seed=seed, min_nodes=min_nodes, min_edges=min_edges,
        )
        return dataclasses.replace(plan, k=k, boundary_edge_frac=bfrac)

    if not use_cache:
        return _build()
    key = (
        "exec_plan",
        graph_key(graph.edge_src, graph.edge_dst, graph.num_nodes),
        _annotation_key(graph),
        k, regrow, hops, partitioner, seed, min_nodes, min_edges,
    )
    cached = EXEC_PLAN_CACHE.peek(key)
    if cached is not None:
        return cached
    return EXEC_PLAN_CACHE.add(key, _build())


def _annotation_key(graph: EdgeGraph) -> str:
    """Digest of edge_inv/edge_slot.  ``graph_key`` hashes endpoints only,
    but a PartitionPlan embeds the annotation slices in its Subgraphs: two
    designs with the same connectivity and different inverter placement
    must NOT share a cached plan."""
    h = hashlib.sha256()
    for arr in (graph.edge_inv, graph.edge_slot):
        if arr is None:
            h.update(b"~")
        else:
            h.update(np.ascontiguousarray(np.asarray(arr, np.uint8)).tobytes())
        h.update(b"|")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Budget-driven partition-count selection
# ---------------------------------------------------------------------------

def _estimated_partition_bucket(
    num_nodes: int,
    num_edges: int,
    k: int,
    *,
    halo_frac: float,
    min_nodes: int,
    min_edges: int,
) -> tuple[int, int]:
    """Padded (n_pad, e_pad) bucket of one partition if the design is cut
    k ways: per-partition share + halo margin, pow-2 padded."""
    n_part = int(np.ceil(num_nodes / k * (1.0 + halo_frac)))
    e_part = int(np.ceil(num_edges / k * (1.0 + halo_frac)))
    return ops.padded_shape(n_part, e_part, min_nodes=min_nodes, min_edges=min_edges)


def _estimated_batch_bytes(
    num_nodes: int,
    num_edges: int,
    k: int,
    gnn_cfg,
    capacity: int,
    *,
    halo_frac: float,
    min_nodes: int,
    min_edges: int,
) -> int:
    """Modeled bytes of one ``capacity``-slot packed launch at cut k."""
    from repro_torch.core.pipeline import memory_model_bytes

    n_pad, e_pad = _estimated_partition_bucket(
        num_nodes, num_edges, k,
        halo_frac=halo_frac, min_nodes=min_nodes, min_edges=min_edges,
    )
    return memory_model_bytes(capacity * n_pad, capacity * e_pad, gnn_cfg)


def choose_k(
    num_nodes: int,
    num_edges: int,
    gnn_cfg,
    budget_bytes: int,
    *,
    capacity: int = 2,
    halo_frac: float = HALO_FRAC,
    min_nodes: int = 64,
    min_edges: int = 128,
    max_k: Optional[int] = None,
) -> int:
    """Smallest power-of-two k whose packed launches fit ``budget_bytes``.

    Walks k = 1, 2, 4, ... through the analytic memory model.  Returns the
    cap (``max_k`` or the node count) if even the finest cut does not fit.
    """
    if num_nodes <= 0:
        return 1
    cap = max(1, min(max_k or num_nodes, num_nodes))
    k = 1
    while k < cap:
        need = _estimated_batch_bytes(
            num_nodes, num_edges, k, gnn_cfg, capacity,
            halo_frac=halo_frac, min_nodes=min_nodes, min_edges=min_edges,
        )
        if need <= budget_bytes:
            return k
        k *= 2
    return min(k, cap)


def choose_k_for_caps(
    num_nodes: int,
    num_edges: int,
    max_bucket_nodes: int,
    max_bucket_edges: Optional[int] = None,
    *,
    halo_frac: float = HALO_FRAC,
    min_nodes: int = 64,
    min_edges: int = 128,
) -> int:
    """Smallest power-of-two k whose per-partition bucket fits a shape cap
    (the service's chooser: it bounds its compile units by the largest
    allowed bucket shape rather than a byte budget)."""
    if num_nodes <= 0:
        return 1
    k = 1
    while k < num_nodes:
        n_pad, e_pad = _estimated_partition_bucket(
            num_nodes, num_edges, k,
            halo_frac=halo_frac, min_nodes=min_nodes, min_edges=min_edges,
        )
        if n_pad <= max_bucket_nodes and (
            max_bucket_edges is None or e_pad <= max_bucket_edges
        ):
            return k
        k *= 2
    return min(k, num_nodes)
