"""Attention (port of ``repro/zoo/models/attention.py``): GQA + RoPE +
qk-norm + QKV-bias + sliding window + softcap + cross-attention, with a KV
cache for decode.

One function serves prefill (causal + cache write-out), decode (single
query against the cache), full-sequence calls and the encoder
(bidirectional); :func:`cross_attention` serves decoder queries over
encoder keys.  Masks are position-based, so ring-buffer caches fall out of
the same code path.

Whenever S*T score elements exceed ``FLASH_THRESHOLD`` the reference
switches to its flash schedule in ``lax``; the port takes one of two routes
there, chosen by the masks alone:
  * **K8** (``repro_torch.kernels.flash_attention``), which the reference's
    docstring names as that schedule's deployment form.  K8 takes positions
    from tile indices, so it serves every call whose queries and keys share
    their positions (prefill at any cache offset, full-sequence calls) and
    every bidirectional call without a window, whose mask positions do not
    enter (cross-attention; the encoder).  It masks key positions past T.
  * **The block schedule** (:func:`_sdpa_blocks`), the reference's ``lax``
    schedule on tensors, for causal or windowed queries against keys at
    other positions: a decode token against more than ``FLASH_THRESHOLD``
    cache slots.
Under grad (grad mode on, an input that requires grad) every flash-path call
takes the block schedule: K8 has no backward (its wrapper refuses such
inputs), and the block schedule is what the reference differentiates when it
trains.  ``flash_attention.launches`` counts K8's launches,
``_sdpa_blocks.calls`` the block schedule's calls without grad and
``_sdpa_blocks.grad_calls`` those under grad.  No route stands in for the
other when it fails.  In bf16 K8 and the reference differ by design: the
reference's schedule rounds its scores to bf16 (its einsum runs in the
stream dtype), K8 keeps them in f32, as the reference's Pallas kernel does;
the block schedule rounds as the reference's.

Under a sharding context (``repro_torch.sharding.use_sharding``) the
activations are DTensors and the reference's ``shard()`` points constrain
them; the attention core, which GSPMD partitions by itself in the
reference, runs on each rank's local shards (:func:`_sdpa_sharded`, a
``local_map``): batch over the batch axes, query heads over "model" where
they divide it, the KV heads each rank's query heads read sliced out of
replicated K/V.  Decode against a cache sharded along its sequence
("kv_seq" over "model") attends each rank's slice and combines the partial
softmaxes across "model" (flash-decoding: one max and two sum
all-reduces), and prefill writes each rank's slice of the positions.
Without a context every such point is the identity.

Departures from the reference, none of which changes a value:
  * ``KVCache.pos`` is a Python int (the port runs eagerly, so branching on
    it costs no device sync), and the cache is written in place: the
    returned ``KVCache`` holds the same tensors as the one passed in;
  * the plain schedule scales and masks its f32 scores in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.sharding import rules as sh
from repro_torch.sharding.rules import shard
from repro_torch.zoo.configs.base import ModelConfig
from repro_torch.zoo.models.layers import rms_norm, rope, softcap

FLASH_THRESHOLD = 4 * 1024 * 1024  # S*T elements above which the flash path runs
Q_CHUNK = 1024
KV_CHUNK = 1024  # the block schedule's tiles (the reference's lax schedule's)
PAD_POS = 1 << 30  # key-position sentinel: fails every mask test
NEG_INF = -1e30
# the cache's logical axes: sharded along seq over "model" under a context
# (flash-decode layout): kv_heads (<= 8) never divides model = 16, seq does
_CACHE_AXES = ("batch", "kv_seq", None, None)


@dataclasses.dataclass
class KVCache:
    """Per-layer KV cache. ``k/v``: (B, S_max, KV, hd); ``pos``: tokens
    written so far.  For sliding-window layers S_max == window and writes
    wrap (ring buffer)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0
    window: int = 0  # 0 = full cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, window: int = 0,
               dtype=torch.bfloat16, device=None) -> KVCache:
    s = window or max_seq
    kv, hd = cfg.num_kv_heads, cfg.head_dim_
    return KVCache(
        k=sh.zeros((batch, s, kv, hd), _CACHE_AXES, dtype=dtype, device=device),
        v=sh.zeros((batch, s, kv, hd), _CACHE_AXES, dtype=dtype, device=device),
        pos=0,
        window=window,
    )


def _proj(x, w):
    """(B, S, D) @ (D, H, hd) -> (B, S, H, hd), as one matmul over the
    flattened heads.  Over DTensors the product is constrained to (batch,
    -, heads over "model" where they divide it) before the heads are split
    out again, so no view has to split a dim that "model" shards."""
    h, hd = w.shape[1], w.shape[2]
    y = x @ w.flatten(1)
    if sh.is_dtensor(y):
        n = sh.axis_sizes(y.device_mesh).get("model", 1)
        y = shard(y, ("batch", None, "heads_flat" if h % n == 0 else None))
    return y.unflatten(-1, (h, hd))


def _out_proj(out, wo):
    """(B, S, H, hd) @ (H, hd, D) -> (B, S, D), as one matmul over the
    flattened heads."""
    return out.flatten(2) @ wo.flatten(0, 1)


def _project_qkv(x, p, cfg: ModelConfig):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if "q_norm" in p:  # qwen3 qk-norm (per-head RMS over head_dim)
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _mask(q_pos, k_pos, *, causal: bool, window: int):
    """(S, T) boolean validity from global positions."""
    if causal:
        ok = k_pos[None, :] <= q_pos[:, None]
    else:
        ok = (k_pos[None, :] < PAD_POS).expand(q_pos.shape[0], k_pos.shape[0])
    if window:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return ok


def _scores(q, k, cfg: ModelConfig, scale: float):
    """q: (B,S,KV,G,hd), k: (B,T,KV,hd) -> (B,KV,G,S,T) f32 (capped)."""
    s = torch.einsum("bskgd,btkd->bkgst", q, k).float().mul_(scale)
    if cfg.attn_softcap:
        s = softcap(s, cfg.attn_softcap)
    return s


def _sdpa_plain(q, k, v, q_pos, k_pos, cfg, scale, *, causal, window):
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    sc = _scores(q.reshape(b, s, kvh, h // kvh, hd), k, cfg, scale)
    sc.masked_fill_(~_mask(q_pos, k_pos, causal=causal, window=window), NEG_INF)
    probs = torch.softmax(sc, dim=-1).to(v.dtype)
    del sc
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _sdpa_flash(q, k, v, q_pos, k_pos, cfg, scale, *, causal, window):
    """The flash path: K8 where its tile-index positions give the mask (the
    queries' and keys' positions are the same tensor, or the call is
    bidirectional without a window), else the block schedule.  A call that
    autograd records (grad mode on, an input that requires grad) always runs
    the block schedule: K8 has no backward, and the reference trains through
    its ``lax`` schedule, never through the Pallas kernel."""
    if _wants_grad(q, k, v) or (q_pos is not k_pos and (causal or window)):
        return _sdpa_blocks(q, k, v, q_pos, k_pos, cfg, scale, causal=causal, window=window)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).contiguous().view(b * h, s, hd)
    kf = k.transpose(1, 2).contiguous().view(b * kvh, t, hd)
    vf = v.transpose(1, 2).contiguous().view(b * kvh, t, hd)
    # K8 masks a ragged T itself, as the lax schedule masks its padded keys,
    # so no kv_block divides T here
    out = flash_attention(qf, kf, vf, causal=causal, window=window, scale=scale,
                          softcap=cfg.attn_softcap or 0.0, q_block=Q_CHUNK, kv_block=t)
    return out.reshape(b, h, s, hd).transpose(1, 2).to(v.dtype)


def _sdpa_blocks(q, k, v, q_pos, k_pos, cfg, scale, *, causal, window):
    """The reference's ``lax`` flash schedule on tensors: query blocks of
    ``Q_CHUNK``, key blocks of ``KV_CHUNK`` with an online softmax (running
    max and denominator), padded keys at ``PAD_POS``; scores and the PV
    product in the stream dtype, as the reference's einsums.  A call that
    autograd records counts in ``_sdpa_blocks.grad_calls``, any other in
    ``_sdpa_blocks.calls``."""
    if _wants_grad(q, k, v):
        _sdpa_blocks.grad_calls += 1
    else:
        _sdpa_blocks.calls += 1
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qc, kc = min(Q_CHUNK, s), min(KV_CHUNK, t)
    s_pad, t_pad = -s % qc, -t % kc
    if s_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad))
        q_pos = F.pad(q_pos, (0, s_pad))
    if t_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, t_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, t_pad))
        k_pos = F.pad(k_pos, (0, t_pad), value=PAD_POS)
    q = q.reshape(b, s + s_pad, kvh, g, hd)
    outs = []
    for q0 in range(0, s + s_pad, qc):
        qb, qpos = q[:, q0:q0 + qc], q_pos[q0:q0 + qc]
        acc = torch.zeros((b, kvh, g, qc, hd), dtype=torch.float32, device=q.device)
        m = torch.full((b, kvh, g, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=q.device)
        for k0 in range(0, t + t_pad, kc):
            kb, vb, kpos = k[:, k0:k0 + kc], v[:, k0:k0 + kc], k_pos[k0:k0 + kc]
            sc = _scores(qb, kb, cfg, scale)  # (B,KV,G,qc,kc) f32
            sc.masked_fill_(~_mask(qpos, kpos, causal=causal, window=window), NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bkgsc,bckd->bkgsd", p.to(vb.dtype), vb)
            acc = acc * alpha[..., None] + pv.float()
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B,qc,KV,G,hd)
    out = torch.cat(outs, dim=1).reshape(b, s + s_pad, h, hd)
    return out[:, :s].to(v.dtype)


_sdpa_blocks.calls = 0
_sdpa_blocks.grad_calls = 0


def _sdpa(q, k, v, q_pos, k_pos, cfg, scale, *, causal=True, window=0):
    if sh.is_dtensor(q):
        return _sdpa_sharded(q, k, v, q_pos, k_pos, cfg, scale, causal=causal, window=window)
    if q.shape[1] * k.shape[1] > FLASH_THRESHOLD:
        return _sdpa_flash(q, k, v, q_pos, k_pos, cfg, scale, causal=causal, window=window)
    return _sdpa_plain(q, k, v, q_pos, k_pos, cfg, scale, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Sharded attention (under a sharding context)
# ---------------------------------------------------------------------------

def _head_placements(mesh, b: int, heads: int, shard_heads: bool) -> tuple:
    """(batch over the batch axes where it divides them, heads over "model"
    when ``shard_heads``), as placements of a (B, S, H, hd) tensor."""
    from torch.distributed.tensor import Replicate, Shard

    b_axes = sh.batch_axes(mesh)
    b_ok = b % sh.axis_size(mesh, b_axes) == 0
    out = []
    for name in sh.axis_names(mesh):
        if name in b_axes and b_ok:
            out.append(Shard(0))
        elif name == "model" and shard_heads:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out)


def _sdpa_sharded(q, k, v, q_pos, k_pos, cfg, scale, *, causal, window):
    """The attention core on each rank's shards (``local_map``): queries
    split by batch and, where "model" divides the heads into whole KV
    groups, by head; K/V split by KV head when "model" divides those too,
    else replicated over "model" with each rank reading the KV heads its
    query heads use (their gradient a partial sum over "model")."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = sh.current_ctx().mesh
    b, _, h, _ = q.shape
    kvh = k.shape[2]
    g = h // kvh
    n = sh.axis_sizes(mesh).get("model", 1)
    hl = h // n
    q_split = h % n == 0 and (hl % g == 0 or g % hl == 0)
    kv_split = q_split and kvh % n == 0
    q_place = _head_placements(mesh, b, h, q_split)
    kv_place = _head_placements(mesh, b, kvh, kv_split)
    kv_grad = tuple(Partial() if name == "model" and q_split and not kv_split else p
                    for name, p in zip(sh.axis_names(mesh), kv_place))
    r = sh.mesh_index("model") if q_split and not kv_split else 0

    def local(ql, kl, vl):
        if q_split and not kv_split:  # the KV heads of this rank's query heads
            first, last = r * hl // g, ((r + 1) * hl - 1) // g
            kl, vl = kl[:, :, first:last + 1], vl[:, :, first:last + 1]
        return _sdpa(ql, kl, vl, q_pos, k_pos, cfg, scale, causal=causal, window=window)

    q_place, kv_place, kv_grad = list(q_place), list(kv_place), list(kv_grad)
    fn = local_map(local, out_placements=q_place, in_placements=(q_place, kv_place, kv_place),
                   in_grad_placements=(q_place, kv_grad, kv_grad), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(q, k, v)


def _decode_sharded(q, cache: KVCache, q_pos, k_pos, cfg, scale, *, window):
    """One decode query against a cache sharded along its sequence: each
    rank attends its slice of the keys (f32 max, denominator and PV sum),
    then the partial softmaxes combine across the mesh axes that split the
    sequence (a max, then two sums: flash-decoding)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = sh.current_ctx().mesh
    kp = tuple(cache.k.placements)
    q_place = tuple(Shard(0) if p == Shard(0) else Replicate() for p in kp)
    ql = q.redistribute(mesh, q_place).to_local()
    kl, vl = cache.k.to_local().to(ql.dtype), cache.v.to_local().to(ql.dtype)
    n, lo = sh.local_range(cache.k, 1)
    b, s, h, hd = ql.shape
    kvh = kl.shape[2]
    sc = _scores(ql.reshape(b, s, kvh, h // kvh, hd), kl, cfg, scale)
    sc.masked_fill_(~_mask(q_pos, k_pos[lo:lo + n], causal=True, window=window), NEG_INF)

    def combine(x, op):  # a partial over the sequence's mesh axes -> replicated
        place = tuple(Partial(op) if p == Shard(1) else qp for p, qp in zip(kp, q_place))
        return DTensor.from_local(x, mesh, place, run_check=False).redistribute(
            mesh, q_place).to_local()

    m = combine(sc.amax(-1), "max")                            # (B,KV,G,S)
    p = torch.exp(sc - m[..., None])
    del sc
    l = combine(p.sum(-1), "sum")
    acc = combine(torch.einsum("bkgst,btkd->bkgsd", p.to(vl.dtype), vl).float(), "sum")
    out = (acc / l.clamp_min(1e-30)[..., None]).permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return DTensor.from_local(out.to(vl.dtype), mesh, q_place, run_check=False)


def _slots(first: int, count: int, s_max: int, ring: bool) -> np.ndarray:
    """The cache slots of positions [first, first + count), on the host."""
    pos = np.arange(first, first + count, dtype=np.int64)
    return pos % s_max if ring else pos


def _write(cache: KVCache, slots: torch.Tensor, first: int, k, v) -> None:
    """Write k/v (B, n, KV, hd), the keys of positions [first, first + n),
    into the cache at ``slots`` (those positions mod its length for a
    ring)."""
    if sh.is_dtensor(cache.k):
        host = _slots(first, k.shape[1], cache.k.shape[1], bool(cache.window))
        return _write_sharded(cache, host, k, v)
    slots = slots.long()
    cache.k.index_copy_(1, slots, k.to(cache.k.dtype))
    cache.v.index_copy_(1, slots, v.to(cache.v.dtype))


def _write_sharded(cache: KVCache, slots: np.ndarray, k, v) -> None:
    """Each rank writes the slots that fall in its slice of the cache's
    sequence (K/V gathered over the other axes first, on every rank: the
    cache splits the sequence, not the heads)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = sh.current_ctx().mesh
    place = tuple(Shard(0) if p == Shard(0) else Replicate() for p in cache.k.placements)
    kv = [sh.as_dtensor(x, mesh, place).to_local() for x in (k, v)]
    n, lo = sh.local_range(cache.k, 1)
    sel = np.nonzero((slots >= lo) & (slots < lo + n))[0]
    if sel.size == 0:
        return
    dst = torch.as_tensor(slots[sel] - lo, device=cache.k.device)
    src = torch.as_tensor(sel, device=cache.k.device)
    for c, xl in zip((cache.k, cache.v), kv):
        c.to_local().index_copy_(1, dst, xl.index_select(1, src).to(c.dtype))


def attention(
    x: torch.Tensor,
    p,
    cfg: ModelConfig,
    *,
    window: int = 0,
    cache: Optional[KVCache] = None,
    bidirectional: bool = False,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention.  Returns (out, updated_cache).

    Full sequence: ``cache=None``.  Prefill: pass a zeroed cache of S_max
    (or a ring); keys land at positions [pos, pos + S).  Decode: S == 1,
    cache holds history; the new token is written at ``cache.pos`` (mod
    window).
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    offset = cache.pos if cache is not None else 0
    positions = torch.arange(offset, offset + s, dtype=torch.int32, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    scale = cfg.head_dim_**-0.5

    new_cache = None
    if cache is not None:
        s_max = cache.k.shape[1]
        if s > 1:
            # Prefill (the reference assumes an empty cache): attend over
            # THIS call's k/v; for ring caches the early queries need keys
            # that the ring will overwrite, so the cache is write-only here.
            if s >= s_max:  # ring smaller than the prompt: keep the tail
                kw, vw = k[:, -s_max:], v[:, -s_max:]
                slots = positions[-s_max:] % s_max if cache.window else positions[-s_max:]
            else:
                kw, vw = k, v
                slots = positions % s_max if cache.window else positions
            _write(cache, slots, offset + s - kw.shape[1], kw, vw)
            new_cache = KVCache(shard(cache.k, _CACHE_AXES), shard(cache.v, _CACHE_AXES),
                                offset + s, cache.window)
            out = _sdpa(q, k, v, positions, positions, cfg, scale, causal=True, window=window)
        else:
            # Decode: write one token, attend against the cache.
            slots = positions % s_max if cache.window else positions
            _write(cache, slots, offset, k, v)
            new_cache = KVCache(shard(cache.k, _CACHE_AXES), shard(cache.v, _CACHE_AXES),
                                offset + s, cache.window)
            j = torch.arange(s_max, dtype=torch.int32, device=x.device)
            if cache.window:
                # global position held by ring slot j after this write
                total = offset + s
                wraps = torch.where(total > j, (total - 1 - j) // s_max, 0)
                k_pos = j + wraps * s_max
                # slots never written yet hold zeros: mask them out
                k_pos = torch.where(k_pos < total, k_pos, PAD_POS)
                win = window or s_max
            else:
                k_pos, win = j, window
            if sh.is_dtensor(cache.k):
                out = _decode_sharded(q, cache, positions, k_pos, cfg, scale, window=win)
            else:
                out = _sdpa(q, cache.k.to(q.dtype), cache.v.to(q.dtype), positions, k_pos,
                            cfg, scale, causal=True, window=win)
    else:
        out = _sdpa(q, k, v, positions, positions, cfg, scale, causal=not bidirectional,
                    window=window)
    out = shard(out, ("batch", None, "heads", None))
    return _out_proj(out, p["wo"]), new_cache


def cross_attention(x: torch.Tensor, enc_kv: tuple, p, cfg: ModelConfig) -> torch.Tensor:
    """Decoder query over precomputed encoder K/V (B, S_enc, KV, hd):
    bidirectional, no window, no rotary embedding."""
    q = _proj(x, p["wq"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    k, v = enc_kv
    q_pos = torch.zeros((q.shape[1],), dtype=torch.int32, device=x.device)
    k_pos = torch.zeros((k.shape[1],), dtype=torch.int32, device=x.device)
    out = _sdpa(q, k.to(q.dtype), v.to(q.dtype), q_pos, k_pos, cfg, cfg.head_dim_**-0.5,
                causal=False, window=0)
    return _out_proj(out, p["wo"])


def encode_cross_kv(enc_out: torch.Tensor, p, cfg: ModelConfig):
    """Project encoder output once into cross-attention K/V.  An encoder
    output in bf16 beside f32 weights is cast up, as ``jnp`` promotes it."""
    if enc_out is None:
        raise ValueError(f"{cfg.name}: a cross-attention layer needs the encoder input "
                         "(enc_input=...), and none was given")
    enc_out = enc_out.to(torch.promote_types(enc_out.dtype, p["wk"].dtype))
    k = _proj(enc_out, p["wk"])
    v = _proj(enc_out, p["wv"])
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v
