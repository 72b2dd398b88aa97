"""Partition plans and budget-driven partition counts (port of
``repro/exec/plan.py``, host numpy).

A :class:`PartitionPlan` wraps one design's re-grown subgraphs with the
pow-2 shape bucket each falls in, so the analytic memory model can size the
largest launch.  :func:`choose_k` closes the loop with the device: given a
memory budget it picks the partition count from
:func:`repro_torch.core.pipeline.memory_model_bytes`, accounting for halo
growth, pow-2 padding and the ``capacity`` slots resident per launch.

The plan builder with its content-hash cache (``build_partition_plan``)
belongs to the streamed route and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.regrowth import Subgraph
from repro_torch.kernels import ops
from repro_torch.service.bucketing import BucketShape

#: Assumed relative halo growth of a re-grown partition (the paper observes
#: ~10% boundary edges on METIS-partitioned AIGs; 15% is a safe planning
#: margin).  Only used for *estimates* (choose_k) — the built plan uses the
#: real subgraph sizes.
HALO_FRAC = 0.15


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Partition + bucket assignment for one design (immutable)."""

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

    def peak_batch_memory_bytes(self, gnn_cfg, capacity: int) -> int:
        """Modeled device bytes of the largest packed launch (``capacity``
        padded slots of the biggest bucket)."""
        from repro_torch.core.pipeline import memory_model_bytes

        if not self.buckets:
            return 0
        big = self.buckets[-1]
        return memory_model_bytes(capacity * big.n_pad, capacity * big.e_pad, gnn_cfg)


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
