"""Boundary edge re-growth (paper §III-C, Algorithm 1).

The PyTorch port keeps its own copy of the reference module
``repro/core/regrowth.py`` (host numpy; it imports nothing of ``repro``);
the two must produce identical subgraph arrays.

For each partition p with node set S_p:

    B_p = ( U_{u in S_p} N(u) ) \\ S_p            (Eq. 1, boundary nodes)
    C_p = { (i,j) in E : i in S_p, j in B_p  or  i in B_p, j in S_p }  (Eq. 2)
    S_p+ = S_p u B_p ;   E_p+ = E[S_p] u C_p       (augmented sets)

``extract_partitions`` returns one ``Subgraph`` per partition, either with
re-growth (augmented sets, the paper's method) or without (plain induced
subgraphs E[S_p], the ablation baseline).  Message passing runs on each
subgraph independently; predictions are read back only for core nodes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import EdgeGraph


@dataclasses.dataclass
class Subgraph:
    """One partition, relabeled to local ids [0, num_nodes).

    Keyed like an ``EdgeGraph`` (``kernels.plan_cache.keys_of``, by the
    partitioned loop and the packer): from then on ``edge_src`` and
    ``edge_dst`` are read-only and ``key_memo`` holds their structure keys;
    a changed subgraph is a new object.
    """

    global_ids: np.ndarray   # int64 (n_local,) — core nodes first, halo after
    num_core: int            # first num_core of global_ids are S_p
    edge_src: np.ndarray     # int32, local ids
    edge_dst: np.ndarray     # int32, local ids
    edge_inv: np.ndarray | None
    edge_slot: np.ndarray | None = None
    #: ``plan_cache.keys_of``'s memo (see ``EdgeGraph.key_memo``)
    key_memo: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def num_nodes(self) -> int:
        return int(self.global_ids.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def num_halo(self) -> int:
        return self.num_nodes - self.num_core

    def to_edge_graph(self) -> EdgeGraph:
        return EdgeGraph(
            self.num_nodes, self.edge_src, self.edge_dst, self.edge_inv, self.edge_slot
        )


def extract_partitions(
    graph: EdgeGraph, part: np.ndarray, regrow: bool = True, hops: int = 1
) -> list[Subgraph]:
    """Algorithm 1, vectorized over all partitions at once.

    Without ``regrow``: induced subgraphs E[S_p] only (what plain METIS
    partitioning gives you — the dashed lines of paper Fig. 6).

    ``hops`` iterates Algorithm 1's boundary growth: ``hops=1`` is the
    paper's B_p/C_p exactly; ``hops=h`` augments with the h-hop
    neighbourhood A_h = N^h(S_p) and every edge internal to it, which makes
    an L-layer GNN's core predictions *bit-exact* with the full-graph run
    once ``hops >= L`` (each core node then sees its complete receptive
    field, including the degree norms of every node whose representation it
    consumes).  Deeper halos trade memory for accuracy — the streaming
    executor's knob for the paper Fig. 6 recovery curve.

    Part ids are compacted first (``np.unique``), so sparse or gappy
    labelings — e.g. a partitioner asked for more parts than nodes — yield
    one ``Subgraph`` per *non-empty* partition and never an empty or
    out-of-range entry.  An empty graph yields an empty list.
    """
    if part.size == 0:
        return []
    # compact to consecutive ids 0..k-1 over non-empty partitions only
    _, part = np.unique(part, return_inverse=True)
    k = int(part.max()) + 1
    src, dst = graph.edge_src, graph.edge_dst
    ps, pd = part[src], part[dst]
    inv = graph.edge_inv

    subs: list[Subgraph] = []
    internal = ps == pd
    for p in range(k):
        core_mask = part == p
        core_ids = np.where(core_mask)[0]
        e_int = internal & (ps == p)

        if regrow and hops > 1:
            # iterated re-growth: A = N^hops(S_p); keep E[A] (halo-halo
            # edges included — they feed the halo representations the core
            # consumes at depth > 1)
            grown = core_mask.copy()
            for _ in range(hops):
                touch = grown[src] | grown[dst]
                grown[src[touch]] = True
                grown[dst[touch]] = True
            keep = grown[src] & grown[dst]
            halo_ids = np.where(grown & ~core_mask)[0]
            local_ids = np.concatenate([core_ids, halo_ids])
        elif regrow:
            # crossing edges C_p: exactly-one endpoint in S_p. (Any such
            # edge's other endpoint is 1-hop away, i.e. in B_p by Eq. 1.)
            cross = (ps == p) ^ (pd == p)
            # boundary nodes B_p from the crossing edges (Eq. 1)
            halo = np.concatenate(
                [dst[cross & (ps == p)], src[cross & (pd == p)]]
            )
            halo_ids = np.unique(halo)
            keep = cross | e_int
            local_ids = np.concatenate([core_ids, halo_ids])
        else:
            keep = e_int
            local_ids = core_ids

        remap = np.full(graph.num_nodes, -1, dtype=np.int64)
        remap[local_ids] = np.arange(len(local_ids))
        subs.append(
            Subgraph(
                global_ids=local_ids.astype(np.int64),
                num_core=len(core_ids),
                edge_src=remap[src[keep]].astype(np.int32),
                edge_dst=remap[dst[keep]].astype(np.int32),
                edge_inv=None if inv is None else inv[keep],
                edge_slot=None if graph.edge_slot is None else graph.edge_slot[keep],
            )
        )
    return subs


def boundary_edge_fraction(graph: EdgeGraph, part: np.ndarray) -> float:
    """Fraction of edges crossing partitions (the paper's ~10% observation)."""
    if graph.num_edges == 0:
        return 0.0
    return float((part[graph.edge_src] != part[graph.edge_dst]).mean())
