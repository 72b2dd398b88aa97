"""Graph partitioning for GROOT (§III-C).

The PyTorch port keeps its own copy of the reference module
``repro/core/partition.py`` (host numpy; it imports nothing of ``repro``):
the same ``np.random.default_rng(seed)`` draws in the same order, so the
part ids are identical.

The paper uses METIS [31].  METIS is not installable offline, so we provide
two partitioners with the same interface (``-> int32 part_id per node``):

  * ``multilevel_partition`` — a METIS-style multilevel scheme: heavy-edge
    random matching coarsening, greedy region-growing initial partition on
    the coarsest graph, and boundary FM-lite refinement during uncoarsening.
    This is the default (quality within ~1.3x of a spectral reference on our
    AIGs).
  * ``bfs_stripe_partition`` — topological-order stripes; O(N), useful as a
    fast baseline and for very large graphs.

Both balance |S_p| within ``tol``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import EdgeGraph


def edge_cut(graph: EdgeGraph, part: np.ndarray) -> int:
    """Number of edges crossing partitions (directed count)."""
    return int((part[graph.edge_src] != part[graph.edge_dst]).sum())


def bfs_stripe_partition(graph: EdgeGraph, k: int) -> np.ndarray:
    """Contiguous stripes in node order.

    AIG builders emit nodes in topological order, so equal stripes of the
    node range are already BFS-like level stripes with good locality.

    ``k`` is clamped to ``[1, num_nodes]`` so every emitted part id names a
    non-empty stripe — downstream consumers (``extract_partitions``, the
    streaming executor) never see an empty or out-of-range partition.
    """
    n = graph.num_nodes
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    k = max(1, min(k, n))
    return ((np.arange(n) * k) // n).astype(np.int32)


# ---------------------------------------------------------------------------
# Multilevel partitioner
# ---------------------------------------------------------------------------

def _coarsen_matching(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray, rng):
    """One level of heavy-edge matching.  Returns (coarse_map, n_coarse).

    Vectorized random matching: each node proposes its heaviest incident
    edge (random tie-break); mutual proposals are contracted.
    """
    if len(src) == 0:
        return np.arange(n, dtype=np.int64), n
    # score = weight + small random jitter for tie-breaking
    score = w.astype(np.float64) + rng.random(len(w)) * 0.5
    # For each node, find its best incident edge (consider both directions).
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    sc2 = np.concatenate([score, score])
    order = np.lexsort((-sc2, s2))
    s_sorted = s2[order]
    first = np.ones(len(s_sorted), dtype=bool)
    first[1:] = s_sorted[1:] != s_sorted[:-1]
    best_src = s_sorted[first]
    best_dst = d2[order][first]
    choice = -np.ones(n, dtype=np.int64)
    choice[best_src] = best_dst
    mutual = (choice >= 0) & (choice[np.clip(choice, 0, n - 1)] == np.arange(n))
    lo = np.minimum(np.arange(n), choice)
    merged = np.where(mutual & (np.arange(n) > choice), choice, np.arange(n))
    del lo
    # build coarse ids
    reps = np.unique(merged)
    remap = np.zeros(n, dtype=np.int64)
    remap[reps] = np.arange(len(reps))
    return remap[merged], len(reps)


def _contract(src, dst, w, cmap, n_coarse):
    cs, cd = cmap[src], cmap[dst]
    keep = cs != cd
    cs, cd, cw = cs[keep], cd[keep], w[keep]
    lo = np.minimum(cs, cd)
    hi = np.maximum(cs, cd)
    key = lo * n_coarse + hi
    uk, inv = np.unique(key, return_inverse=True)
    ww = np.zeros(len(uk), dtype=np.float64)
    np.add.at(ww, inv, cw)
    return (uk // n_coarse).astype(np.int64), (uk % n_coarse).astype(np.int64), ww


def _greedy_grow(n, src, dst, node_w, k, rng):
    """Initial partition on the coarsest graph: BFS region growing."""
    # adjacency as CSR over symmetrized edges
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    order = np.argsort(s2, kind="stable")
    s_sorted, d_sorted = s2[order], d2[order]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, s_sorted + 1, 1)
    np.cumsum(ptr, out=ptr)
    target = node_w.sum() / k
    part = -np.ones(n, dtype=np.int32)
    perm = rng.permutation(n)
    pi = 0
    for p in range(k):
        grown = 0.0
        limit = target if p < k - 1 else np.inf
        frontier: list = []
        while grown < limit:
            if not frontier:
                # (re)seed: a region whose frontier died (disconnected
                # component, or fully surrounded by assigned nodes) keeps
                # growing from the next unassigned node — without this,
                # starved regions stay tiny and the LAST partition swallows
                # every leftover node (observed: 32% of a 530k-node graph).
                while pi < n and part[perm[pi]] >= 0:
                    pi += 1
                if pi >= n:
                    break
                frontier = [int(perm[pi])]
            nxt = []
            for u in frontier:
                if part[u] >= 0:
                    continue
                part[u] = p
                grown += node_w[u]
                if grown >= limit:
                    break
                nbrs = d_sorted[ptr[u] : ptr[u + 1]]
                nxt.extend(int(x) for x in nbrs[part[nbrs] < 0])
            frontier = nxt
    part[part < 0] = k - 1
    return part


def _refine(n, src, dst, w, part, node_w, k, tol, passes=4):
    """FM-lite boundary refinement: move nodes to the neighbouring partition
    with max gain, respecting balance, a few vectorized passes."""
    sizes = np.zeros(k)
    np.add.at(sizes, part, node_w)
    cap = node_w.sum() / k * (1 + tol)
    for _ in range(passes):
        ps, pd = part[src], part[dst]
        boundary_edges = ps != pd
        if not boundary_edges.any():
            break
        # per (node, neighbour-part) accumulated edge weight
        nodes = np.concatenate([src[boundary_edges], dst[boundary_edges]])
        nbr_part = np.concatenate([pd[boundary_edges], ps[boundary_edges]])
        ww = np.concatenate([w[boundary_edges], w[boundary_edges]])
        key = nodes.astype(np.int64) * k + nbr_part
        uk, inv = np.unique(key, return_inverse=True)
        ext = np.zeros(len(uk))
        np.add.at(ext, inv, ww)
        cand_node = (uk // k).astype(np.int64)
        cand_part = (uk % k).astype(np.int32)
        # internal weight of each node (edges to own part)
        internal = np.zeros(n)
        same = ~boundary_edges
        np.add.at(internal, src[same], w[same])
        np.add.at(internal, dst[same], w[same])
        gain = ext - internal[cand_node]
        # best candidate per node
        order = np.lexsort((-gain, cand_node))
        cn = cand_node[order]
        first = np.ones(len(cn), dtype=bool)
        first[1:] = cn[1:] != cn[:-1]
        mv_node = cn[first]
        mv_part = cand_part[order][first]
        mv_gain = gain[order][first]
        good = mv_gain > 0
        mv_node, mv_part = mv_node[good], mv_part[good]
        if len(mv_node) == 0:
            break
        # apply greedily in gain order under balance cap
        order2 = np.argsort(-mv_gain[good])
        moved = 0
        for i in order2:
            u, p = mv_node[i], mv_part[i]
            if sizes[p] + node_w[u] <= cap and sizes[part[u]] - node_w[u] > 0:
                sizes[part[u]] -= node_w[u]
                sizes[p] += node_w[u]
                part[u] = p
                moved += 1
        if moved == 0:
            break
    return part


def multilevel_partition(
    graph: EdgeGraph,
    k: int,
    tol: float = 0.1,
    seed: int = 0,
    coarse_target: int | None = None,
) -> np.ndarray:
    """METIS-style multilevel k-way partition.

    ``k`` is clamped to ``[1, num_nodes]`` (a partition cannot be empty);
    ``k == num_nodes`` degenerates to singletons without running the
    coarsen/grow/refine machinery.

    ``coarse_target`` (default ``max(4096, num_nodes // 8)``) bounds how
    far coarsening runs.  Stopping earlier on large graphs costs a little
    host time in the initial partition but measurably improves the cut —
    on a 530k-node CSA-256 AIG, n//8 vs a flat 4096 shrinks the 2-hop
    re-grown worst partition ~15% (the margin that keeps a k=16 stream
    under half the full-graph memory model).
    """
    n0 = graph.num_nodes
    if n0 == 0:
        return np.zeros(0, dtype=np.int32)
    if coarse_target is None:
        coarse_target = max(4096, n0 // 8)
    k = max(1, min(k, n0))
    if k <= 1:
        return np.zeros(n0, dtype=np.int32)
    if k == n0:
        return np.arange(n0, dtype=np.int32)
    rng = np.random.default_rng(seed)
    levels = []
    n = graph.num_nodes
    src = graph.edge_src.astype(np.int64)
    dst = graph.edge_dst.astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = np.ones(len(src), dtype=np.float64)
    node_w = np.ones(n, dtype=np.float64)
    while n > max(coarse_target, 8 * k):
        cmap, nc = _coarsen_matching(n, src, dst, w, rng)
        if nc >= n * 0.98:  # matching stalled
            break
        levels.append((n, src, dst, w, node_w, cmap))
        cw = np.zeros(nc)
        np.add.at(cw, cmap, node_w)
        src, dst, w = _contract(src, dst, w, cmap, nc)
        node_w = cw
        n = nc
    part = _greedy_grow(n, src, dst, node_w, k, rng)
    part = _refine(n, src, dst, w, part, node_w, k, tol)
    for (pn, psrc, pdst, pw, pnw, cmap) in reversed(levels):
        part = part[cmap]
        part = _refine(pn, psrc, pdst, pw, part, pnw, k, tol, passes=2)
    return part.astype(np.int32)


PARTITIONERS = {
    "multilevel": multilevel_partition,
    "bfs": lambda g, k, **kw: bfs_stripe_partition(g, k),
}
