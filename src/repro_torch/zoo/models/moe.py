"""Mixture-of-Experts with sort-based capacity dispatch (port of
``repro/zoo/models/moe.py``), and the port's dropless dispatch.

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

Configs with ``dropless`` (the port-only ``trinity-mini``) run
:func:`moe_dropless` on one device instead: the (token, expert) pairs
sorted by expert, each expert's tokens one contiguous segment, and one
grouped GEMM a projection over the segments (``torch._grouped_mm`` on the
card, :func:`grouped_mm_plain` on the CPU).  No capacity, no dropped token,
no host sync: an expert that holds no token is not read.  Routing may score
by sigmoid with a selection-only bias, the weights renormalised and scaled
(``route_scale``), and a shared expert adds a SwiGLU of every token.  Its
spans (``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.shared``,
``moe.combine``) and counters (``moe.assignments``; with a tracer active,
which reads device values, ``moe.experts_active`` and the gauge
``moe.max_expert_tokens``) are the benchmark's view of the layer.  These
configs have no expert-parallel form: ``moe_apply`` refuses them under a
sharding context rather than drop tokens or the selection bias there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import current_tracer, span
from repro_torch.sharding.rules import shard
from repro_torch.zoo.configs.base import ModelConfig
from repro_torch.zoo.models.layers import mlp


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.top_k / max(cfg.num_experts, 1) * cfg.capacity_factor)
    return max(c, cfg.top_k)


def route(x2d: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig, bias=None):
    """Top-k routing.  x2d: (T, D).  Returns (idx (T,k) int32, weights (T,k)).

    ``router_score == "sigmoid"``: scores s = sigmoid(x W), the product and
    the scores in f32 (a bf16 product's rounding swaps near-tied experts); the k
    experts of the largest s + ``bias`` (selection only); weights s over
    their sum (+ 1e-20), times ``route_scale``."""
    if cfg.router_score == "sigmoid":
        logits = x2d.float() @ router_w.float()
        scores = torch.sigmoid(logits)
        pick = scores if bias is None else scores + bias.float()
        top_i = torch.topk(pick, cfg.top_k, dim=-1).indices
        top_w = scores.gather(-1, top_i)
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
        return top_i.to(torch.int32), (top_w * cfg.route_scale).to(x2d.dtype)
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


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Plain version of the grouped GEMM: rows [offs[e-1], offs[e]) of
    ``x`` (M, K) times ``w[e]`` (K, N), one matmul an expert that holds rows
    (the segment ends are read on the host)."""
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[e]
        start = end
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``x`` (M, K), its rows sorted by expert with segment ends ``offs``
    (E,) int32, times each segment's expert ``w`` (E, K, N): one
    ``torch._grouped_mm`` on the card (no host sync; empty segments read no
    weights; a dtype it does not take raises), :func:`grouped_mm_plain` on
    the CPU."""
    if x.is_cuda:
        return torch._grouped_mm(x, w, offs=offs)
    return grouped_mm_plain(x, w, offs)


def _expert_counters(offs: torch.Tensor):
    """Under a tracer: ``moe.experts_active`` and the gauge
    ``moe.max_expert_tokens`` from the experts' segment ends, and the
    ``moe.experts`` span's attributes (the pairs its GEMMs take, the experts
    holding them).  Device values: read only under a tracer, else None."""
    if not current_tracer().enabled:
        return None
    counts = torch.diff(offs, prepend=offs.new_zeros(1))
    active = int((counts > 0).sum())
    REGISTRY.counter("moe.experts_active").inc(active)
    REGISTRY.gauge("moe.max_expert_tokens").set(int(counts.max()))
    return {"computed": int(offs[-1]), "experts": active}


def moe_dropless(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): the routed experts' weighted SwiGLUs of
    every (token, expert) pair, plus the shared expert's SwiGLU.  Under a
    tracer the ``moe.experts`` span holds ``routed`` (token, expert) pairs,
    ``computed`` (the rows its grouped GEMMs take: every routed pair) and
    ``experts`` (the experts holding them)."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.num_experts
    x2 = x.reshape(t, d)
    with span("moe.route"):
        top_i, top_w = route(x2, p["router"], cfg, p["bias"] if "bias" in p else None)
    REGISTRY.counter("moe.assignments").inc(t * k)
    with span("moe.dispatch"):
        flat_e = top_i.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        # segment ends: the pairs routed to experts 0..e
        offs = torch.searchsorted(flat_e[order], torch.arange(e, device=x.device,
                                                              dtype=flat_e.dtype), right=True)
        seen = _expert_counters(offs)
        offs = offs.to(torch.int32)
        xs = x2[order // k]
    with span("moe.experts") as sp:
        if seen is not None:
            sp.set(routed=t * k, **seen)
        h = F.silu(grouped_mm(xs, p["w_gate"], offs)) * grouped_mm(xs, p["w_in"], offs)
        del xs
        ys = grouped_mm(h, p["w_out"], offs)
        del h
    with span("moe.combine"):
        # back to (token, k) order, then each token's weighted sum of its k
        y = torch.empty_like(ys).index_copy_(0, order, ys).view(t, k, d)
        del ys
        y = torch.bmm(top_w.to(y.dtype)[:, None, :], y).view(b, s, d)
    if "shared" in p:
        with span("moe.shared"):
            y = y + mlp(x, p["shared"], cfg.act)
    return y


def moe_apply(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Dispatch to :func:`moe_ffn_dist` when a sharding context is active,
    else to :func:`moe_dropless` or :func:`moe_ffn` as the config says.  A
    dropless config under a sharding context raises: the expert-parallel
    form drops tokens past capacity and routes without the selection bias,
    so it would compute another model."""
    from repro_torch.sharding import current_ctx

    if current_ctx() is not None:
        if cfg.dropless or "bias" in p:
            raise NotImplementedError(
                f"{cfg.name}: dropless experts have no expert-parallel form; "
                "serve it on one device, outside a sharding context")
        return moe_ffn_dist(x, p, cfg)
    if cfg.dropless:
        return moe_dropless(x, p, cfg)
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
