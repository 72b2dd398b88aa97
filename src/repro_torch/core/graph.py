"""Graph containers for EDA (AIG-derived) graphs.

The PyTorch port keeps its own copy of the reference module ``repro/core/graph.py``
(it imports nothing of ``repro``); the two must produce identical arrays.

All host-side graph manipulation (generation, partitioning, re-growth) is
numpy-based; device arrays are produced only at the batching boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class EdgeGraph:
    """A directed graph as flat edge arrays (COO), nodes are 0..num_nodes-1.

    ``edge_src[k] -> edge_dst[k]`` is a directed edge.  For AIGs the direction
    is fanin -> node (signal flow).  ``edge_inv[k]`` marks an inverted edge;
    ``edge_slot[k]`` is the fanin position (0=left, 1=right — AIG nodes have
    exactly two ordered fanins, the ordering the paper's '01'/'10' polarity
    encoding relies on).

    Once keyed for the plan cache (``kernels.plan_cache.keys_of``, the first
    groot-backend prediction on it), ``edge_src`` and ``edge_dst`` are
    read-only and ``key_memo`` holds their structure keys: a changed
    structure is a new object, never an in-place write.
    """

    num_nodes: int
    edge_src: np.ndarray  # int32 (E,)
    edge_dst: np.ndarray  # int32 (E,)
    edge_inv: Optional[np.ndarray] = None  # bool (E,)
    edge_slot: Optional[np.ndarray] = None  # uint8 (E,)
    #: ``plan_cache.keys_of``'s memo: a ``dataclasses.replace`` copy of the
    #: graph starts without one; a copy of a holder (``PreparedDesign``)
    #: holds this same graph, memo and all
    key_memo: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])

    def validate(self) -> None:
        assert self.edge_src.shape == self.edge_dst.shape
        if self.num_edges:
            assert self.edge_src.min() >= 0 and self.edge_src.max() < self.num_nodes
            assert self.edge_dst.min() >= 0 and self.edge_dst.max() < self.num_nodes

    def symmetrized(self) -> "EdgeGraph":
        """Undirected message-passing view: A + A^T (deduplicated)."""
        src = np.concatenate([self.edge_src, self.edge_dst])
        dst = np.concatenate([self.edge_dst, self.edge_src])
        key = src.astype(np.int64) * self.num_nodes + dst
        _, idx = np.unique(key, return_index=True)
        return EdgeGraph(self.num_nodes, src[idx], dst[idx])

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.edge_dst, minlength=self.num_nodes).astype(np.int32)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.edge_src, minlength=self.num_nodes).astype(np.int32)

    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (row_ptr, col_idx) with rows = edge_dst (aggregation rows).

        Row i's entries are the *sources* of edges arriving at node i — the
        neighbours aggregated by one step of message passing.
        """
        order = np.argsort(self.edge_dst, kind="stable")
        col = self.edge_src[order].astype(np.int32)
        counts = np.bincount(self.edge_dst, minlength=self.num_nodes)
        row_ptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return row_ptr, col

    def subgraph_edge_mask(self, node_mask: np.ndarray) -> np.ndarray:
        """Edges with BOTH endpoints inside ``node_mask`` (E[S] in the paper)."""
        return node_mask[self.edge_src] & node_mask[self.edge_dst]


def batch_graphs(graphs: list[EdgeGraph]) -> EdgeGraph:
    """Disjoint-union batching (the paper's "batch size" of identical designs)."""
    offsets = np.cumsum([0] + [g.num_nodes for g in graphs])
    src = np.concatenate([g.edge_src + off for g, off in zip(graphs, offsets)])
    dst = np.concatenate([g.edge_dst + off for g, off in zip(graphs, offsets)])
    inv = None
    if all(g.edge_inv is not None for g in graphs):
        inv = np.concatenate([g.edge_inv for g in graphs])
    slot = None
    if all(g.edge_slot is not None for g in graphs):
        slot = np.concatenate([g.edge_slot for g in graphs])
    return EdgeGraph(
        int(offsets[-1]), src.astype(np.int32), dst.astype(np.int32), inv, slot
    )
