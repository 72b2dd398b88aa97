"""Mixture-of-Experts with sort-based capacity dispatch (port of
``repro/zoo/models/moe.py``).

The token->expert dispatch count-sorts (token, expert) pairs by expert, so
each expert's inputs become a contiguous dense slab processed by a plain
dense matmul:

    scores -> top_k -> stable-sort (token,expert) pairs by expert
    -> position-within-expert (capacity C drops overflow)
    -> scatter tokens into the (E, C, D) expert slab
    -> per-expert dense FFN (batched matmuls over the expert axis)
    -> gather back + combine-weight sum

The per-expert products are ``torch.einsum`` over the expert axis (cuBLAS
batched GEMMs on the card): the reference computes them outside any Pallas
kernel.  Under a sharding context ``moe_apply`` runs the expert-parallel
form, :func:`moe_ffn_dist`: a ``local_map`` over the mesh (the reference's
``shard_map``) in which each rank dispatches its tokens onto its own slice
of the experts (:func:`_local_dispatch_ffn`), then one all-reduce over
"model" sums the slices' outputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import shard
from repro_torch.zoo.configs.base import ModelConfig


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.top_k / max(cfg.num_experts, 1) * cfg.capacity_factor)
    return max(c, cfg.top_k)


def route(x2d: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """Top-k routing.  x2d: (T, D).  Returns (idx (T,k) int32, weights (T,k))."""
    logits = (x2d @ router_w).float()
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(gates, cfg.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)  # renorm
    return top_i.to(torch.int32), top_w.to(x2d.dtype)


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    top_i, top_w = route(x2, p["router"], cfg)
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(t, cfg)
    dev = x.device

    flat_e = top_i.reshape(-1).long()                        # (T*k,)
    tok_of = torch.arange(t * k, device=dev) // k

    # count-sort by expert: position within the expert's contiguous segment
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order].contiguous()
    first_of_val = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(t * k, device=dev) - first_of_val
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < c
    slot = torch.where(keep, pos, c)                         # c = overflow bin (dropped)

    # scatter into the expert slab (E, C, D); two tokens only ever share a
    # cell in the overflow bin, which is sliced off
    slab = torch.zeros((e, c + 1, d), dtype=x.dtype, device=dev)
    slab.index_put_((flat_e, slot), x2[tok_of], accumulate=True)
    slab = shard(slab[:, :c], ("experts", None, None))

    # dense per-expert FFN
    h = torch.einsum("ecd,edf->ecf", slab, p["w_in"])
    if "w_gate" in p:
        g = torch.einsum("ecd,edf->ecf", slab, p["w_gate"])
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    h = shard(h, ("experts", None, None))
    y_slab = torch.einsum("ecf,efd->ecd", h, p["w_out"])

    # gather back + combine
    y_tok = y_slab[flat_e, slot.clamp_max(c - 1)]            # (T*k, D)
    y_tok = y_tok.masked_fill(~keep[:, None], 0.0)
    y = (y_tok.reshape(t, k, d) * top_w[..., None]).sum(dim=1)
    return y.reshape(b, s, d)


def _local_dispatch_ffn(x2, top_i, top_w, p_local, cfg: ModelConfig, lo: int, e_local: int,
                        c: int):
    """Sort-based dispatch + dense FFN over ONE rank's expert slice.

    Runs inside ``local_map``: every tensor is local.  x2: (T, D) local
    tokens; experts [lo, lo + e_local) live here."""
    t, d = x2.shape
    k = cfg.top_k
    dev = x2.device
    flat_e = top_i.reshape(-1).long() - lo                   # (T*k,) local ids
    in_range = (flat_e >= 0) & (flat_e < e_local)
    key = torch.where(in_range, flat_e, e_local)             # out of range -> bin e_local
    order = torch.argsort(key, stable=True)
    sorted_e = key[order].contiguous()
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(t * k, device=dev) - first
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = in_range & (pos < c)
    slot = torch.where(keep, pos, c)
    e_idx = torch.where(in_range, flat_e, e_local - 1)

    tok_of = torch.arange(t * k, device=dev) // k
    slab = torch.zeros((e_local, c + 1, d), dtype=x2.dtype, device=dev)
    slab.index_put_((e_idx, slot), x2[tok_of] * keep[:, None].to(x2.dtype), accumulate=True)
    slab = slab[:, :c]

    h = torch.einsum("ecd,edf->ecf", slab, p_local["w_in"])
    if "w_gate" in p_local:
        g = torch.einsum("ecd,edf->ecf", slab, p_local["w_gate"])
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    y_slab = torch.einsum("ecf,efd->ecd", h, p_local["w_out"])

    y_tok = y_slab[e_idx, slot.clamp_max(c - 1)]
    y_tok = y_tok.masked_fill(~keep[:, None], 0.0)
    return (y_tok.reshape(t, k, d) * top_w[..., None]).sum(dim=1)


def moe_ffn_dist(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Production MoE: ``local_map`` over the mesh.

    Activations are batch-sharded over ("pod", "data") and replicated over
    "model"; experts are sharded over "model" (EP).  Each rank therefore
    already holds every token it could need: dispatch is a *local*
    count-sort + gather onto its expert slice, and the only collective is
    the per-layer all-reduce over "model" (the TP-MLP pattern), issued when
    the partial outputs are made replicated.  FSDP weight shards are
    all-gathered by the ``local_map``'s input placements.  An expert count
    that "model" does not divide runs :func:`moe_ffn`, as the reference's.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding import rules as sh

    mesh = sh.current_ctx().mesh
    n_shards = sh.axis_sizes(mesh)["model"]
    if cfg.num_experts % n_shards != 0:
        return moe_ffn(x, p, cfg)
    e_local = cfg.num_experts // n_shards
    b, s, d = x.shape
    b_axes = sh.batch_axes(mesh)
    b_ok = b % sh.axis_size(mesh, b_axes) == 0
    names = sh.axis_names(mesh)
    x_place = tuple(Shard(0) if n in b_axes and b_ok else Replicate() for n in names)
    y_part = tuple(Partial() if n == "model" else pl for n, pl in zip(names, x_place))
    rep = tuple(Replicate() for _ in names)
    exp = tuple(Shard(0) if n == "model" else Replicate() for n in names)
    # a replicated weight's gradient sums each rank's tokens (and, for the
    # router, each rank's experts)
    tok = tuple(Partial() if pl == Shard(0) else Replicate() for pl in x_place)
    rep_grad = tuple(Partial() if n == "model" else t for n, t in zip(names, tok))
    exp_grad = tuple(Shard(0) if n == "model" else t for n, t in zip(names, tok))
    lo = sh.mesh_index("model") * e_local
    w_gate = p["w_gate"] if "w_gate" in p else None

    def body(xb, router, w_in, w_gate, w_out):
        bl = xb.shape[0]
        t = bl * s
        x2 = xb.reshape(t, d)
        top_i, top_w = route(x2, router, cfg)  # identical on every model shard
        p_local = {"w_in": w_in, "w_out": w_out}
        if w_gate is not None:
            p_local["w_gate"] = w_gate
        y = _local_dispatch_ffn(x2, top_i, top_w, p_local, cfg, lo, e_local, capacity(t, cfg))
        return y.reshape(bl, s, d)

    x_place, y_part, rep, exp, tok, rep_grad, exp_grad = map(
        list, (x_place, y_part, rep, exp, tok, rep_grad, exp_grad))
    fn = local_map(
        body, out_placements=y_part,
        in_placements=(x_place, rep, exp, exp if w_gate is not None else None, exp),
        in_grad_placements=(y_part, rep_grad, exp_grad, exp_grad if w_gate is not None else None,
                            exp_grad),
        device_mesh=mesh, redistribute_inputs=True)
    y = fn(x, p["router"], p["w_in"], w_gate, p["w_out"])
    return y.redistribute(mesh, x_place)


def moe_apply(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Dispatch to :func:`moe_ffn_dist` when a sharding context is active."""
    from repro_torch.sharding import current_ctx

    if current_ctx() is not None:
        return moe_ffn_dist(x, p, cfg)
    return moe_ffn(x, p, cfg)


def aux_load_balance_loss(x2d: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """Switch-style load-balancing auxiliary loss (mean gate * mean count)."""
    logits = (x2d @ router_w).float()
    gates = torch.softmax(logits, dim=-1)
    top1 = gates.argmax(-1)
    e = cfg.num_experts
    counts = torch.zeros((e,), dtype=torch.float32, device=x2d.device).index_add_(
        0, top1, torch.ones_like(top1, dtype=torch.float32)) / x2d.shape[0]
    return e * torch.sum(counts * gates.mean(dim=0))
