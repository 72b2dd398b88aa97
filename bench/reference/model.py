"""Plain PyTorch reference of what one classification request computes.

From a design's arrays (``reference.generators``) and the weights, it works
out again GROOT's 4-bit node features, the fanin->node edges with their
slot and polarity, the direction- and polarity-separated SAGE forward
(four fanin groups, two fanout groups, per-group mean, ReLU, linear head),
and, for a run under a memory budget, the bfs stripe partition with 1-hop
edge re-growth that decides which subgraph each node is classified in.
Float32 throughout; matrix products run with TF32 off unless ``tf32=True``,
the lower precision the benchmark's control computes in (on a CPU tensor
the operands are rounded to TF32's 10-bit mantissa instead).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

PI, AND, PO = 0, 1, 2
LAYER_WEIGHTS = ("w_self", "w_in_l_pos", "w_in_l_neg", "w_in_r_pos", "w_in_r_neg",
                 "w_out_pos", "w_out_neg")
# (slot, inverted) of each fanin group and (inverted,) of each fanout group,
# in LAYER_WEIGHTS order after w_self
FANIN_GROUPS = ((0, 0), (0, 1), (1, 0), (1, 1))
FANOUT_GROUPS = (0, 1)


def features(kind: torch.Tensor, fanin0: torch.Tensor, fanin1: torch.Tensor) -> torch.Tensor:
    """GROOT's node features (paper §III-B): type bits (PI 00, AND 11, PO 0X
    with X the polarity of the PO's driver) and input-polarity bits (AND:
    left and right inverted; PI 00; PO 11)."""
    n = kind.shape[0]
    x = torch.zeros((n, 4), dtype=torch.float32, device=kind.device)
    is_and = kind == AND
    is_po = kind == PO
    x[is_and, 0] = 1.0
    x[is_and, 1] = 1.0
    x[is_po, 1] = (fanin0[is_po] & 1).float()
    x[is_and, 2] = (fanin0[is_and] & 1).float()
    x[is_and, 3] = (fanin1[is_and] & 1).float()
    x[is_po, 2] = 1.0
    x[is_po, 3] = 1.0
    return x


def edges(kind: torch.Tensor, fanin0: torch.Tensor, fanin1: torch.Tensor):
    """Fanin->node edges: (src, dst, slot, inverted), each (E,) int64.  An AND
    node has its two ordered fanins (slot 0, 1), a PO its driver (slot 0)."""
    ands = torch.nonzero(kind == AND).flatten()
    pos = torch.nonzero(kind == PO).flatten()
    lits = torch.cat([fanin0[ands], fanin1[ands], fanin0[pos]])
    dst = torch.cat([ands, ands, pos])
    slot = torch.cat([torch.zeros_like(ands), torch.ones_like(ands), torch.zeros_like(pos)])
    return lits >> 1, dst, slot, lits & 1


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10-bit mantissa, to nearest (emulation)."""
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, w: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32 and a.device.type == "cpu":
        return _round_tf32(a) @ _round_tf32(w)
    with _tf32(tf32):
        return a @ w


def _mean(h, rows, cols, num_nodes):
    """Per-row mean of ``h[cols]`` over the edges (rows, cols); 0 where a
    row has no edge."""
    out = torch.zeros((num_nodes, h.shape[1]), dtype=h.dtype, device=h.device)
    out.index_add_(0, rows, h[cols])
    deg = torch.bincount(rows, minlength=num_nodes).clamp_min(1).to(h.dtype)
    return out / deg[:, None]


def forward(params: dict, x, src, dst, slot, inv, num_nodes: int, *, tf32: bool = False):
    """Logits (num_nodes, classes).  ``params``: ``{"layers": [{w_self,
    w_in_l_pos, ..., w_out_neg, b}], "head": {"w", "b"}}``, weights (in,
    out) applied as ``h @ W``."""
    in_sel = [(slot == s) & (inv == i) for s, i in FANIN_GROUPS]
    in_edges = [(dst[m], src[m]) for m in in_sel]
    out_edges = [(src[inv == i], dst[inv == i]) for i in FANOUT_GROUPS]
    del in_sel
    h = x
    for layer in params["layers"]:
        acc = _mm(h, layer["w_self"], tf32) + layer["b"]
        for (rows, cols), nm in zip(in_edges + out_edges, LAYER_WEIGHTS[1:]):
            acc += _mm(_mean(h, rows, cols, num_nodes), layer[nm], tf32)
        h = torch.relu(acc)
    return _mm(h, params["head"]["w"], tf32) + params["head"]["b"]


# -- partitioning under a memory budget --------------------------------------

def memory_model_bytes(num_nodes: int, num_edges: int, gnn: dict) -> int:
    """Device bytes the program's router budgets for one forward over a
    (sub)graph, frozen: features, two activation and two aggregate planes,
    int32 edge indices of both directions, the gathered (E, H) edge stream
    and the params, all 4-byte."""
    fin, h, layers, c = gnn["in_features"], gnn["hidden"], gnn["num_layers"], gnn["num_classes"]
    params = fin * h * 3 + (layers - 1) * 3 * h * h + h * c
    return 4 * (num_nodes * fin + 4 * num_nodes * h + 4 * num_edges
                + num_edges * h + params)


def _pow2(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def padded_shape(num_nodes: int, num_edges: int, min_nodes: int, min_edges: int):
    """Power-of-two (nodes, edges) launch bucket, one spare row at least."""
    return _pow2(max(num_nodes + 1, min_nodes)), _pow2(max(num_edges, min_edges, 1))


def estimated_k(num_nodes: int, num_edges: int, gnn: dict, budget: int, *,
                capacity: int, halo_frac: float, min_nodes: int, min_edges: int) -> int:
    """Smallest power of two k whose estimated packed launch (``capacity``
    partitions of 1/k of the design plus ``halo_frac``, padded) fits."""
    k = 1
    while k < num_nodes:
        n_pad, e_pad = padded_shape(int(np.ceil(num_nodes / k * (1.0 + halo_frac))),
                                    int(np.ceil(num_edges / k * (1.0 + halo_frac))),
                                    min_nodes, min_edges)
        if memory_model_bytes(capacity * n_pad, capacity * e_pad, gnn) <= budget:
            return k
        k *= 2
    return min(k, num_nodes)


def stripes(num_nodes: int, k: int, device) -> torch.Tensor:
    """bfs stripe partition: k equal stripes of the topological node order."""
    k = max(1, min(k, num_nodes))
    return torch.arange(num_nodes, device=device, dtype=torch.int64) * k // num_nodes


def regrown(part: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, p: int):
    """Partition p re-grown by one hop (GROOT Algorithm 1): its core nodes
    (ascending), then the boundary nodes across its crossing edges
    (ascending), and the mask of the edges kept (internal or crossing)."""
    in_s, in_d = part[src] == p, part[dst] == p
    cross = in_s ^ in_d
    core = torch.nonzero(part == p).flatten()
    halo = torch.unique(torch.cat([dst[cross & in_s], src[cross & in_d]]))
    return core, halo, cross | (in_s & in_d)


def budget_partition(num_nodes: int, src, dst, gnn: dict, mix: dict) -> tuple[torch.Tensor, int]:
    """The stripe partition a budgeted run classifies under: k from the
    estimate, doubled until the largest packed launch of the re-grown
    partitions, as padded, fits the budget."""
    budget, cap = mix["memory_budget_bytes"], mix["stream_capacity"]
    floors = (mix["min_nodes"], mix["min_edges"])
    k = estimated_k(num_nodes, src.shape[0], gnn, budget, capacity=cap,
                    halo_frac=0.15 * mix["regrow_hops"], min_nodes=floors[0],
                    min_edges=floors[1])
    while True:
        part = stripes(num_nodes, k, src.device)
        shapes = set()
        for p in range(int(part.max()) + 1):
            core, halo, keep = regrown(part, src, dst, p)
            shapes.add(padded_shape(core.numel() + halo.numel(), int(keep.sum()), *floors))
        n_pad, e_pad = max(shapes)
        if k >= num_nodes or memory_model_bytes(cap * n_pad, cap * e_pad, gnn) <= budget:
            return part, k
        k *= 2


def partitioned_logits(params: dict, x, src, dst, slot, inv, part, *, tf32: bool = False):
    """Each node's logits from the forward over its own partition re-grown
    by one hop (degree norms within the subgraph)."""
    n = x.shape[0]
    out = torch.empty((n, params["head"]["w"].shape[1]), dtype=torch.float32, device=x.device)
    local = torch.full((n,), -1, dtype=torch.int64, device=x.device)
    for p in range(int(part.max()) + 1):
        core, halo, keep = regrown(part, src, dst, p)
        ids = torch.cat([core, halo])
        local[ids] = torch.arange(ids.numel(), device=x.device)
        logits = forward(params, x[ids], local[src[keep]], local[dst[keep]], slot[keep],
                         inv[keep], ids.numel(), tf32=tf32)
        out[core] = logits[: core.numel()]
        local[ids] = -1
    return out
