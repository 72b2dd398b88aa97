"""Shape buckets: pad every (sub)graph to power-of-two (nodes, edges).

Port of ``BucketShape`` from ``repro/service/bucketing.py``; the rest of that
module (work items, packing) belongs to the streamed route.  A bucket is the
equivalence class of (sub)graphs that pad to the same shape; the partition
plan (:mod:`repro_torch.exec.plan`) sizes its memory model on the largest.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BucketShape:
    """One padded-shape equivalence class: (slot nodes, slot edges)."""

    n_pad: int
    e_pad: int
