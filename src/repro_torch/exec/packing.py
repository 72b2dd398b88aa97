"""Packing partition batches for the streaming executor (port of
``repro/exec/packing.py``, host numpy).

One :class:`PackedBatch` is one device launch: up to ``capacity``
same-bucket subgraphs laid out as a disjoint union in the bucket's
canonical padded shape (the paper's "batch size 16" of partitions).  The
layout and the exactness contract (zero features on padding rows, padding
edges self-looped on each slot's dummy row) are
:func:`repro_torch.service.bucketing.pack_batch`'s — this module adds the
feature *staging* (the host gather of each partition's global feature
rows, the work the prefetch thread overlaps with device execution), the
packed structure's plan-cache keys for the structure-keyed backends (hashed
on the prefetch thread too), and the reverse *scatter* of core-node
predictions into the global output.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.exec.plan import PartitionPlan
from repro_torch.kernels.plan_cache import keys_of, recipe_keys
from repro_torch.obs import span
from repro_torch.service.bucketing import (
    BucketShape,
    WorkItem,
    item_from_subgraph,
    pack_batch,
    unpack_predictions,
)


@dataclasses.dataclass
class PackedBatch:
    """One staged device launch (host arrays, ready for transfer)."""

    shape: BucketShape
    indices: list[int]            # plan subgraph indices, slot order
    items: list[WorkItem]
    arrays: dict                  # pack_batch output (x/edge_*/num_nodes)
    capacity: int
    #: the packed structure's ``plan_cache.structure_keys`` (None unless the
    #: packer was asked for them: the structure-keyed backends)
    gkeys: Optional[tuple[str, str]] = None

    @property
    def nbytes(self) -> int:
        """Host->device transfer size of this launch."""
        return sum(
            a.nbytes for a in self.arrays.values() if isinstance(a, np.ndarray)
        )


def pack_partitions(
    plan: PartitionPlan,
    indices: list[int],
    features: np.ndarray,
    shape: BucketShape,
    capacity: int,
    *,
    keyed: bool = False,
) -> PackedBatch:
    """Stage one schedule entry: gather features, pad, pack into slots (the
    ``exec.gather`` span); with ``keyed``, the packed structure's plan-cache
    keys as well: each slot subgraph's memoized keys, then the packed
    arrays' keys looked up by that recipe (one ``plan.key`` span each;
    the arrays are hashed only on the recipe's first sight)."""
    with span("exec.gather"):
        items = [
            item_from_subgraph(0, i, plan.subgraphs[i], features) for i in indices
        ]
        arrays = pack_batch(items, shape, capacity)
    gkeys = None
    if keyed:
        # the packed arrays are a function of the bucket shape, the capacity
        # and each slot's structure, in slot order
        slots = tuple(keys_of(plan.subgraphs[i]) for i in indices)
        gkeys = recipe_keys(("pack_keys", shape, capacity, slots),
                            arrays["edge_src"], arrays["edge_dst"], arrays["num_nodes"])
    return PackedBatch(shape=shape, indices=list(indices), items=items, arrays=arrays,
                       capacity=capacity, gkeys=gkeys)


def scatter_core_predictions(
    out: np.ndarray, batch: PackedBatch, pred: np.ndarray
) -> int:
    """Write each slot's CORE-node predictions to their global rows.

    Halo rows are message-passing context only (paper §III-C); their
    predictions are discarded.  Returns the number of core rows written.
    """
    written = 0
    for it, p in zip(batch.items, unpack_predictions(pred, batch.items, batch.shape)):
        out[it.global_ids[: it.num_core]] = p[: it.num_core]
        written += it.num_core
    return written
