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
kernel.  The reference's expert-parallel form, ``moe_ffn_dist`` (and its
``_local_dispatch_ffn``, a ``shard_map`` over the mesh's "model" axis), waits
for the port of ``sharding/``: the port has no sharding context, so
``moe_apply`` always runs :func:`moe_ffn`, as the reference does without one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    slab = slab[:, :c]

    # dense per-expert FFN
    h = torch.einsum("ecd,edf->ecf", slab, p["w_in"])
    if "w_gate" in p:
        g = torch.einsum("ecd,edf->ecf", slab, p["w_gate"])
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    y_slab = torch.einsum("ecf,efd->ecd", h, p["w_out"])

    # gather back + combine
    y_tok = y_slab[flat_e, slot.clamp_max(c - 1)]            # (T*k, D)
    y_tok = y_tok.masked_fill(~keep[:, None], 0.0)
    y = (y_tok.reshape(t, k, d) * top_w[..., None]).sum(dim=1)
    return y.reshape(b, s, d)


def moe_apply(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """The MoE FFN.  The reference dispatches to ``moe_ffn_dist`` under a
    sharding context; the port has none, so this is :func:`moe_ffn`."""
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
