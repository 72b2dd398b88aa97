"""Shape buckets: pad every (sub)graph to power-of-two (nodes, edges).

Port of ``repro/service/bucketing.py`` (host numpy).  Bucketing quantises
shapes: a (sub)graph lands in the pow-2 bucket that fits it, and
``pack_batch`` packs up to ``capacity`` items of the same bucket into one
disjoint-union graph (fixed slot layout), so a batch of same-bucket
subgraphs is a single device launch of one padded shape.

Padding preserves exact numerics for real rows — see the contract in
``repro_torch.kernels.ops`` (zero features on padding rows, padding edges
self-looped on each slot's dummy row).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class BucketShape:
    """One padded-shape equivalence class: (slot nodes, slot edges)."""

    n_pad: int
    e_pad: int

    def total(self, capacity: int) -> tuple[int, int]:
        return capacity * self.n_pad, capacity * self.e_pad


@dataclasses.dataclass
class WorkItem:
    """One device-sized unit of work: a whole graph or one partition."""

    req_id: int
    part_index: int
    feats: np.ndarray             # (num_nodes, F) — includes halo rows
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_inv: Optional[np.ndarray]
    edge_slot: Optional[np.ndarray]
    num_core: int                 # predictions are read back for these rows
    global_ids: np.ndarray        # local row -> request-graph node id

    @property
    def num_nodes(self) -> int:
        return int(self.feats.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])

    def bucket(self, *, min_nodes: int = 64, min_edges: int = 128) -> BucketShape:
        n_pad, e_pad = ops.padded_shape(
            self.num_nodes, self.num_edges, min_nodes=min_nodes, min_edges=min_edges
        )
        return BucketShape(n_pad, e_pad)


def item_from_subgraph(req_id: int, part_index: int, sg, features: np.ndarray) -> WorkItem:
    """One partition as a work item: gathers (stages) its feature rows
    (float32, contiguous, halo rows included)."""
    return WorkItem(
        req_id=req_id,
        part_index=part_index,
        feats=np.ascontiguousarray(features[sg.global_ids], dtype=np.float32),
        edge_src=sg.edge_src,
        edge_dst=sg.edge_dst,
        edge_inv=sg.edge_inv,
        edge_slot=sg.edge_slot,
        num_core=sg.num_core,
        global_ids=sg.global_ids,
    )


def items_from_prepared(req_id: int, prep) -> list[WorkItem]:
    """Split a prepared request (``pipeline.PreparedDesign``) into
    schedulable work items."""
    if prep.subgraphs is None:
        g = prep.graph
        return [
            WorkItem(
                req_id=req_id,
                part_index=0,
                feats=prep.feats,
                edge_src=g.edge_src,
                edge_dst=g.edge_dst,
                edge_inv=g.edge_inv,
                edge_slot=g.edge_slot,
                num_core=g.num_nodes,
                global_ids=np.arange(g.num_nodes, dtype=np.int64),
            )
        ]
    return [
        item_from_subgraph(req_id, i, sg, prep.feats)
        for i, sg in enumerate(prep.subgraphs)
    ]


def dummy_item(n_feat: int) -> WorkItem:
    """Minimal valid work item (2 nodes, 1 edge): ``pack_batch`` pads it out
    to any target :class:`BucketShape`."""
    return WorkItem(
        req_id=-1,
        part_index=0,
        feats=np.zeros((2, n_feat), dtype=np.float32),
        edge_src=np.array([0], dtype=np.int32),
        edge_dst=np.array([1], dtype=np.int32),
        edge_inv=np.zeros(1, dtype=bool),
        edge_slot=np.zeros(1, dtype=np.uint8),
        num_core=2,
        global_ids=np.arange(2, dtype=np.int64),
    )


def pack_batch(items: list[WorkItem], shape: BucketShape, capacity: int) -> dict:
    """Disjoint-union pack of <= ``capacity`` same-bucket items.

    Slot ``i`` owns node rows [i*n_pad, (i+1)*n_pad); unused slots are
    all-padding.  The resulting arrays have the bucket's canonical shapes
    regardless of how many items are present — one padded signature per
    (bucket, capacity).
    """
    assert 0 < len(items) <= capacity
    n_pad, e_pad = shape.n_pad, shape.e_pad
    n_feat = items[0].feats.shape[1]
    x = np.zeros((capacity * n_pad, n_feat), dtype=np.float32)
    src = np.empty(capacity * e_pad, dtype=np.int32)
    dst = np.empty(capacity * e_pad, dtype=np.int32)
    inv = np.zeros(capacity * e_pad, dtype=bool)
    slot = np.zeros(capacity * e_pad, dtype=np.uint8)
    for i in range(capacity):
        n0, e0 = i * n_pad, i * e_pad
        if i < len(items):
            it = items[i]
            x[n0 : n0 + it.num_nodes] = it.feats
            s, d, iv, sl = ops.pad_graph_arrays(
                it.edge_src, it.edge_dst, it.edge_inv, it.edge_slot,
                it.num_nodes, n_pad, e_pad,
            )
            src[e0 : e0 + e_pad] = s + n0
            dst[e0 : e0 + e_pad] = d + n0
            inv[e0 : e0 + e_pad] = iv
            slot[e0 : e0 + e_pad] = sl
        else:
            src[e0 : e0 + e_pad] = n0 + n_pad - 1
            dst[e0 : e0 + e_pad] = n0 + n_pad - 1
    return {"x": x, "edge_src": src, "edge_dst": dst, "edge_inv": inv,
            "edge_slot": slot, "num_nodes": capacity * n_pad}


def unpack_predictions(
    pred: np.ndarray, items: list[WorkItem], shape: BucketShape
) -> list[np.ndarray]:
    """Slice each item's real-node predictions back out of a packed run."""
    return [
        pred[i * shape.n_pad : i * shape.n_pad + it.num_nodes]
        for i, it in enumerate(items)
    ]
