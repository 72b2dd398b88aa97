"""Backend dispatch for graph aggregation (port of ``repro/kernels/ops.py``).

An *aggregation pair* is ``(in_agg, out_agg)`` — two callables ``(x, w) ->
(N, F)`` computing the weighted neighbour sums over fanin edges and fanout
edges — plus the grouped, staged and fused entry points the GNN forward
prefers when present.  Backends:

  ``ref``          gather + ``index_add_`` (row-parallel SpMM); calls no kernel
  ``onehot``       dense one-hot matmul ``onehot(dst)^T @ (x[src] * w)``
                   (O(N*E) memory: small graphs only); calls no kernel of ours
  ``groot``        the degree-bucketed walks: grouped K1 (LD) + K2 (HD),
                   ungrouped K5 (LD) + K6 (HD)
  ``groot_mxu``    ``groot`` whose LD buckets of degree > 1 reduce on the
                   tensor cores: grouped K4, ungrouped K5's MXU body
  ``groot_fused``  ``groot`` whose fanin LD buckets also fuse the following
                   weight matmul: grouped K3, per-group K7

The seven kernels (``csrc/``): K1 grouped LD, K2 grouped HD, K3 grouped fused
LD + matmul, K4 grouped MXU LD, K5 ungrouped LD, K6 ungrouped HD, K7
ungrouped fused LD + matmul.  Plans are built once per graph on the host and
copied to the device once (``SpmmPlan.on``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import plan_cache as pc
from repro_torch.kernels import ref as kref
from repro_torch.kernels.forward_plan import ForwardPlan
from repro_torch.kernels.fused_sage import fused_ld_matmul, fused_ld_matmul_grouped
from repro_torch.kernels.groot_spmm import (
    PROBE,
    SpmmPlan,
    StagedWeights,
    apply_plan,
    apply_plan_grouped,
    apply_plan_grouped_staged,
    assemble_rows,
    hd_apply,
    hd_grouped_apply,
    pad_features,
    stage_group_weights,
    stage_weight,
)

BACKENDS = ("ref", "onehot", "groot", "groot_mxu", "groot_fused")


def onehot_spmm(x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                num_nodes: int, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense formulation: ``onehot(dst)^T @ (x[src] * w)``.

    What a "just use dense matmul" SpMM looks like without the GROOT
    insight — the baseline the degree-bucketed kernels beat on memory (it
    materialises an (E, N) one-hot)."""
    msgs = x.index_select(0, edge_src)
    if w is not None:
        msgs = msgs * w[:, None].to(msgs.dtype)
    oh = torch.nn.functional.one_hot(edge_dst, num_nodes).to(x.dtype)     # (E, N)
    return oh.t() @ msgs


@dataclasses.dataclass
class AggPair:
    """Aggregation callables for one graph (+ optional fused/grouped paths).

    The grouped entry points take a ``(E, G)`` weight matrix — one column
    per slot x polarity group — and compute every group's aggregation in
    one plan walk, returning group-major ``(G, N, F)``.  They are ``None``
    for ``ref`` and ``onehot``, where the model layer keeps its per-group
    loop.
    """

    in_agg: Callable      # (x, w) -> (N, F) over fanin edges
    out_agg: Callable     # (x, w) -> (N, F) over fanout edges
    backend: str
    # fused aggregate+matmul over fanin edges: (x, w, w_mat (F, H)) -> (N, H)
    in_agg_mm: Optional[Callable] = None
    in_plan: Optional[SpmmPlan] = None
    out_plan: Optional[SpmmPlan] = None
    # grouped paths: (x, wg (E, G)) -> (G, N, F) in one plan walk
    in_agg_grouped: Optional[Callable] = None
    out_agg_grouped: Optional[Callable] = None
    # grouped fuse: (x, wg (E, G), w_stack (G, F, H)) -> (N, H)
    in_agg_mm_grouped: Optional[Callable] = None
    # forward-invariant hoisting: the ForwardPlan stages the weight streams
    # once per forward; the *_staged entry points take padded features +
    # staged streams and return f32 — (G, N, F), or (N, H) for the fuse
    fwd_plan: Optional[ForwardPlan] = None
    in_agg_staged: Optional[Callable] = None     # (x_p, staged) -> (G, N, F)
    out_agg_staged: Optional[Callable] = None
    in_agg_mm_staged: Optional[Callable] = None  # (x_p, staged, w_stack) -> (N, H)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def ungrouped(pair: AggPair) -> AggPair:
    """A copy of ``pair`` with the grouped entry points stripped — forces
    the model layer back onto the per-group loop (which runs the ungrouped
    kernels K5-K7)."""
    return dataclasses.replace(
        pair,
        in_agg_grouped=None,
        out_agg_grouped=None,
        in_agg_mm_grouped=None,
        fwd_plan=None,
        in_agg_staged=None,
        out_agg_staged=None,
        in_agg_mm_staged=None,
    )


def unhoisted(pair: AggPair) -> AggPair:
    """A copy of ``pair`` without the ForwardPlan — keeps the grouped walks
    but re-stages the weight streams every layer (the pre-hoist walk)."""
    return dataclasses.replace(
        pair,
        fwd_plan=None,
        in_agg_staged=None,
        out_agg_staged=None,
        in_agg_mm_staged=None,
    )


def _edge_tensors(edge_src, edge_dst, device) -> tuple:
    return tuple(torch.as_tensor(np.asarray(a, dtype=np.int64)).to(device)
                 for a in (edge_src, edge_dst))


def _segment_pair(edge_src, edge_dst, num_nodes, device) -> AggPair:
    s, d = _edge_tensors(edge_src, edge_dst, device)
    return AggPair(
        in_agg=lambda x, w=None: kref.spmm_ref(x, s, d, num_nodes, w),
        out_agg=lambda x, w=None: kref.spmm_ref(x, d, s, num_nodes, w),
        backend="ref",
    )


def _onehot_pair(edge_src, edge_dst, num_nodes, device) -> AggPair:
    s, d = _edge_tensors(edge_src, edge_dst, device)
    return AggPair(
        in_agg=lambda x, w=None: onehot_spmm(x, s, d, num_nodes, w),
        out_agg=lambda x, w=None: onehot_spmm(x, d, s, num_nodes, w),
        backend="onehot",
    )


def _groot_pair(edge_src, edge_dst, num_nodes, *, mxu: bool, fused: bool,
                device, gkeys=None) -> AggPair:
    src = np.asarray(edge_src)
    dst = np.asarray(edge_dst)
    gkeys = gkeys or pc.structure_keys(src, dst, num_nodes)
    in_plan = pc.cached_plan(src, dst, num_nodes, gkey=gkeys[0])
    out_plan = pc.cached_plan(dst, src, num_nodes, gkey=gkeys[1])
    fwd_plan = pc.cached_forward_plan(src, dst, num_nodes, gkeys=gkeys)
    # copy the index arrays to the device now, not inside the first forward
    in_plan.on(device)
    out_plan.on(device)

    def in_agg(x, w=None):
        return apply_plan(in_plan, x, w, mxu=mxu)

    def out_agg(x, w=None):
        return apply_plan(out_plan, x, w, mxu=mxu)

    def in_agg_grouped(x, wg):
        return apply_plan_grouped(in_plan, x, wg, mxu=mxu)

    def out_agg_grouped(x, wg):
        return apply_plan_grouped(out_plan, x, wg, mxu=mxu)

    def in_agg_staged(x_p, staged):
        return apply_plan_grouped_staged(in_plan, x_p, staged, mxu=mxu)

    def out_agg_staged(x_p, staged):
        return apply_plan_grouped_staged(out_plan, x_p, staged, mxu=mxu)

    in_agg_mm = None
    in_agg_mm_grouped = None
    in_agg_mm_staged = None
    if fused:

        def in_agg_mm(x, w, w_mat):
            return _apply_plan_fused(in_plan, x, w, w_mat)

        def in_agg_mm_grouped(x, wg, w_stack):
            return _apply_plan_fused_grouped(in_plan, x, wg, w_stack)

        def in_agg_mm_staged(x_p, staged, w_stack):
            return _apply_plan_fused_grouped_staged(in_plan, x_p, staged, w_stack)

    return AggPair(
        in_agg=in_agg,
        out_agg=out_agg,
        backend="groot_fused" if fused else ("groot_mxu" if mxu else "groot"),
        in_agg_mm=in_agg_mm,
        in_plan=in_plan,
        out_plan=out_plan,
        in_agg_grouped=in_agg_grouped,
        out_agg_grouped=out_agg_grouped,
        in_agg_mm_grouped=in_agg_mm_grouped,
        fwd_plan=fwd_plan,
        in_agg_staged=in_agg_staged,
        out_agg_staged=out_agg_staged,
        in_agg_mm_staged=in_agg_mm_staged,
    )


def _apply_plan_fused(plan: SpmmPlan, x: torch.Tensor, w: Optional[torch.Tensor],
                      w_mat: torch.Tensor) -> torch.Tensor:
    """:func:`apply_plan` with the LD reductions fused with ``@ w_mat``.

    Output is (N, H) = (sum_e w_e x[src_e] into rows) @ w_mat: per LD
    bucket K7 writes its (R, H) rows straight into the concatenation
    buffer, the aggregated (N, F) intermediate never materialised; HD rows
    reduce through K6 and contract outside (HD rows are few).  Assembly is
    one permutation gather — no scatters.
    """
    PROBE["edge_stream_gathers"] += 1
    PROBE["kernel_walks"] += 1
    if w is not None:
        PROBE["weight_gathers"] += 1
    dp = plan.on(x.device)
    x_p = pad_features(x)
    w_mat = w_mat.float().contiguous()
    w_buckets, w_hd = stage_weight(plan, w, x.dtype)
    cat = torch.empty((plan.asm_rows, w_mat.shape[1]), dtype=torch.float32, device=x.device)
    cat[-1].zero_()
    for b, cols, off, wb in zip(plan.buckets, dp.cols, dp.offsets, w_buckets):
        fused_ld_matmul(x_p, cols, w_mat, b.deg, wb, out=cat[off : off + b.num_rows])
    if plan.hd is not None:
        red = hd_apply(x_p, dp.hd_cols, dp.hd_meta, dp.hd_row_chunks, plan.e_t, w_hd)
        cat[dp.hd_offset : dp.hd_offset + red.shape[0]] = red @ w_mat
    return assemble_rows(plan, cat).to(x.dtype)


def _apply_plan_fused_grouped_staged(plan: SpmmPlan, x_p: torch.Tensor,
                                     staged: StagedWeights,
                                     w_stack: torch.Tensor) -> torch.Tensor:
    """Hoisted grouped fused walk: padded features, staged weight streams
    and the (G, F, H) f32 weight stack in; ``(N, H)`` f32 out.

    Per LD bucket the fused kernel K3 writes its (R, H) rows straight into
    the concatenation buffer; HD rows reduce through K2 and contract with
    the stack outside (HD rows are few).  Assembly is one permutation
    gather — no scatters.
    """
    PROBE["edge_stream_gathers"] += 1
    PROBE["kernel_walks"] += 1
    PROBE["stream_bytes"] += plan.num_slots * x_p.shape[1] * x_p.element_size()
    dp = plan.on(x_p.device)
    hid = w_stack.shape[2]
    cat = torch.empty((plan.asm_rows, hid), dtype=torch.float32, device=x_p.device)
    cat[-1].zero_()
    for b, cols, off, wge in zip(plan.buckets, dp.cols, dp.offsets, staged.buckets):
        fused_ld_matmul_grouped(x_p, cols, wge, w_stack, b.deg, out=cat[off : off + b.num_rows])
    if plan.hd is not None:
        red = hd_grouped_apply(
            x_p, dp.hd_cols, staged.hd, dp.hd_meta, dp.hd_row_chunks, plan.e_t
        )
        n_hd = red.shape[1]
        cat[dp.hd_offset : dp.hd_offset + n_hd] = torch.einsum("gnf,gfh->nh", red, w_stack)
    return cat.index_select(0, dp.asm_index)


def _apply_plan_fused_grouped(plan: SpmmPlan, x: torch.Tensor, wg: torch.Tensor,
                              w_stack: torch.Tensor) -> torch.Tensor:
    """Grouped fused path: ``sum_g (group-g aggregation) @ w_stack[g]``,
    staging the weight streams per call (the pre-hoist walk)."""
    staged = stage_group_weights(plan, wg)
    out = _apply_plan_fused_grouped_staged(
        plan, pad_features(x.float()), staged, w_stack.float().contiguous()
    )
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Padded-shape helpers (the service scheduler's bucketing contract): padded
# feature rows are zero and padded edges are self-loops on a dummy node, so
# every aggregation a real node sees is identical to the unpadded run.
# ---------------------------------------------------------------------------

def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 if n <= 1 else 1 << int(n - 1).bit_length()


def padded_shape(
    num_nodes: int, num_edges: int, *, min_nodes: int = 16, min_edges: int = 16
) -> tuple[int, int]:
    """Power-of-two (nodes, edges) padding target.

    Nodes round up from ``num_nodes + 1``: at least one spare row is
    guaranteed, which is where padding edges park their endpoints.
    """
    n_pad = next_pow2(max(num_nodes + 1, min_nodes))
    e_pad = next_pow2(max(num_edges, min_edges, 1))
    return n_pad, e_pad


def pad_graph_arrays(
    edge_src,
    edge_dst,
    edge_inv,
    edge_slot,
    num_nodes: int,
    n_pad: int,
    e_pad: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad COO edge arrays to length ``e_pad`` for a ``n_pad``-row graph.

    Padding edges are self-loops on the dummy row ``n_pad - 1``; missing
    inv/slot annotations come back as zeros.
    """
    e = len(edge_src)
    if n_pad <= num_nodes or e_pad < e:
        raise ValueError(
            f"padded shape ({n_pad}, {e_pad}) cannot hold graph "
            f"({num_nodes} nodes, {e} edges)"
        )
    dummy = n_pad - 1
    pad = e_pad - e
    src = np.concatenate([edge_src, np.full(pad, dummy)]).astype(np.int32)
    dst = np.concatenate([edge_dst, np.full(pad, dummy)]).astype(np.int32)
    inv = np.zeros(e_pad, dtype=bool)
    if edge_inv is not None:
        inv[:e] = edge_inv
    slot = np.zeros(e_pad, dtype=np.uint8)
    if edge_slot is not None:
        slot[:e] = edge_slot
    return src, dst, inv, slot


def _build_pair(edge_src, edge_dst, num_nodes: int, backend: str, device,
                gkeys=None) -> AggPair:
    if backend == "ref":
        return _segment_pair(edge_src, edge_dst, num_nodes, device)
    if backend == "onehot":
        return _onehot_pair(edge_src, edge_dst, num_nodes, device)
    if backend in ("groot", "groot_mxu", "groot_fused"):
        return _groot_pair(edge_src, edge_dst, num_nodes, mxu=backend == "groot_mxu",
                           fused=backend == "groot_fused", device=device, gkeys=gkeys)
    raise ValueError(f"unknown backend {backend!r} (want one of {BACKENDS})")


def make_agg_pair(edge_src, edge_dst, num_nodes: int, backend: str = "ref", *,
                  device, cache: bool = True, gkeys=None) -> AggPair:
    """Build (or fetch from the structural cache) the aggregation pair of a
    graph under a backend, with its index arrays on ``device``.

    ``cache=False`` builds a pair the cache does not keep (its host plans
    still come from, and stay in, the cache); with :func:`release_device`
    after use, nothing of it stays on the device.  ``gkeys`` are the
    structure's ``plan_cache.structure_keys`` where the caller hashed it
    already (the streaming executor, on its prefetch thread)."""
    device = torch.device(device)
    if not cache:
        return _build_pair(edge_src, edge_dst, num_nodes, backend, device, gkeys)
    key = ("pair", pc.graph_key(edge_src, edge_dst, num_nodes), backend, str(device))
    return pc.PLAN_CACHE.get_or_build(
        key, lambda: _build_pair(edge_src, edge_dst, num_nodes, backend, device)
    )


def release_device(pair: AggPair) -> None:
    """Drop the device copies of a pair's plans (``SpmmPlan.release``)."""
    for plan in (pair.in_plan, pair.out_plan):
        if plan is not None:
            plan.release()


def groot_spmm(x: torch.Tensor, edge_src, edge_dst, num_nodes: int,
               w: Optional[torch.Tensor] = None, *, backend: str = "groot") -> torch.Tensor:
    """One-shot SpMM ``out[r] = sum_{e: dst[e]=r} w[e] * x[src[e]]`` through
    a backend's ungrouped walk (the paper's single SpMM; persistent users
    should hold an :class:`AggPair`), on the device ``x`` lies on.  The plan
    comes from the structural plan cache: a recurring structure builds
    nothing.
    """
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    pair = make_agg_pair(host(edge_src), host(edge_dst), num_nodes, backend, device=x.device)
    return pair.in_agg(x, w)
