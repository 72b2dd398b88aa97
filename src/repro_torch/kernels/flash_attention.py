"""Flash attention (port of ``repro/kernels/flash_attention.py``).

K8 ``flash_attention`` replaces the Pallas kernel ``_flash_kernel``: online
softmax attention, causal, sliding-window or bidirectional, with an optional
logit softcap.  One CUDA block (``csrc/flash_attention.cu``) owns one
(batch-head, query tile) and loops over the key tiles, its running max,
denominator and f32 accumulator in registers.  Positions come from tile
indices, so no mask tensor exists.

The wrapper keeps the reference's contract: q (BH, S, hd), k/v (BH, T, hd),
f32 or bf16, output (BH, S, hd) in q's dtype, the ``ValueError`` for a
bidirectional call with ``T % kv_block != 0``.  GQA callers may also pass k/v
once per KV head, (BH / G, T, hd): query row ``bh`` then reads KV row
``bh // G``.  ``q_block``/``kv_block`` keep the reference's signature and
its check; the kernel tiles the keys by :func:`key_tile`.  Key positions past
T are masked, where the reference pads them with zeros that stay visible to
query rows past T (S > T, causal); the two agree for S <= T.

Two bodies (``BODIES``): bf16 streams run the ``wgmma`` body (warpgroup
MMAs fed by a TMA ring, 128 query rows by 128 keys, 64 keys at hd = 256),
f32 streams the ``mma_sync`` body (three TF32 MMAs per product, 64 query
rows by 64 keys).  On a CPU tensor the wrapper runs :func:`flash_plain`,
which follows the kernel's rounding points and walks the keys in the tile
of the body that (dtype, hd) takes; on a CUDA tensor it launches the kernel
or raises.  ``flash_attention.launches`` counts the launches,
``flash_attention.body_launches`` the launches of each body.  K8 has no
backward, as the Pallas kernel has none: with grad mode on and an input that
requires grad, the wrapper raises on every device (the model trains through
the block schedule of ``zoo/models/attention.py`` instead).

On the card the launch goes through a custom op,
``torch.ops.repro_torch.flash_attention`` (:func:`_flash_op`), so the dry
run can trace the program the card runs: on a fake CUDA tensor (a
``FakeTensorMode`` trace) the op's fake implementation returns an empty
output of q's shape and dtype and launches nothing, the wrapper counts the
call in ``flash_attention.traced`` (never in ``launches``), and
``torch.utils.flop_counter`` bills it :func:`flash_flops`, the attended
(query, key) pairs only.  A DTensor sharding rule splits it over BH.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.groot_spmm import on_cuda, refuse_grad, stream

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
#: the kernel body each (dtype, head dim) runs (csrc/flash_attention.cu)
BODIES = {
    **{(torch.bfloat16, hd): "wgmma" for hd in HEAD_DIMS},
    **{(torch.float32, hd): "mma_sync" for hd in HEAD_DIMS},
}
#: its C id (the entry point's ``body`` argument)
BODY_IDS = {"mma_sync": 0, "wgmma": 1}


def key_tile(dtype: torch.dtype, hd: int) -> int:
    """Keys per step of the body that (dtype, hd) takes: the wgmma body's
    ``Cfg<HD>::kBN`` (128, or 64 at hd = 256), the mma_sync body's ``kBN``
    (64).  Other dtypes and head dims, which no body takes, walk 64."""
    if BODIES.get((dtype, hd)) == "wgmma":
        return 64 if hd == 256 else 128
    return 64


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                window: int = 0, scale: Optional[float] = None, softcap: float = 0.0,
                out_dtype: Optional[torch.dtype] = None,
                kv_tile: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K8 with the Pallas kernel's rounding points:
    scores in f32 from the stream-dtype inputs, the finite ``NEG_INF``
    sentinel, p rounded to v's dtype before the PV product, an f32
    accumulator, ``acc / max(l, 1e-30)`` at the end.  Walks the keys
    ``kv_tile`` at a time (by default the tile of the body q's dtype and
    head dim take), all query rows at once.  ``out_dtype`` (q's by default)
    set to f32 returns the output before its last rounding, which the card
    checks hold a bf16 kernel output to."""
    bh, s, hd = q.shape
    t = k.shape[1]
    tile = kv_tile or key_tile(q.dtype, hd)
    group = bh // k.shape[0]
    if group > 1:
        k = k.repeat_interleave(group, 0)
        v = v.repeat_interleave(group, 0)
    scale = hd**-0.5 if scale is None else scale
    qf = q.float()
    q_pos = torch.arange(s, device=q.device)[:, None]
    acc = torch.zeros((bh, s, hd), dtype=torch.float32, device=q.device)
    m = torch.full((bh, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s, 1), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, tile):
        kb, vb = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        sc = torch.bmm(qf, kb.float().transpose(1, 2)) * scale
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
        ok = k_pos <= q_pos if causal else torch.ones_like(k_pos, dtype=torch.bool)
        if window:
            ok = ok & (k_pos > q_pos - window)
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        acc = acc * alpha + torch.bmm(p.to(v.dtype).float(), vb.float())
    return (acc / l.clamp_min(1e-30)).to(out_dtype or q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, scale: Optional[float] = None, softcap: float = 0.0,
                    q_block: int = 256, kv_block: int = 256) -> torch.Tensor:
    """K8: q (BH, S, hd), k/v (BH or BH / G, T, hd) -> (BH, S, hd) in q's
    dtype.  CPU tensors run :func:`flash_plain`; CUDA tensors launch the
    kernel."""
    refuse_grad("flash_attention", q, k, v,
                instead="under grad the model's attention runs the block schedule "
                "(repro_torch.zoo.models.attention._sdpa_blocks), which autograd differentiates")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: q (BH, S, hd) and k/v (BH, T, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, hd = q.shape
    t = k.shape[1]
    if k.shape[0] == 0 or bh % k.shape[0]:
        raise ValueError(f"flash_attention: {bh} query rows over {k.shape[0]} KV rows")
    scale = hd**-0.5 if scale is None else scale
    kc = min(kv_block, t)
    if not causal and t % kc:
        raise ValueError("bidirectional flash requires T % kv_block == 0")
    if not on_cuda("flash_attention", q):
        return flash_plain(q, k, v, causal=causal, window=window, scale=scale, softcap=softcap)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    fake = is_fake(q)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.device != q.device or (not fake and x.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} must be contiguous, 16-byte aligned "
                             f"and on {q.device}")
    if bh > 65535 or s <= 0 or t <= 0:
        raise ValueError(f"flash_attention: BH={bh} (at most 65535), S={s}, T={t}")
    if fake:
        flash_attention.traced += 1
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), int(window),
                                                 float(scale), float(softcap))


flash_attention.launches = 0
flash_attention.body_launches = dict.fromkeys(BODY_IDS, 0)
flash_attention.traced = 0


def is_fake(t: torch.Tensor) -> bool:
    """True for a tensor of a ``FakeTensorMode`` trace (no storage)."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake

    return _is_fake(t)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
              scale: float, softcap: float) -> torch.Tensor:
    """K8's launch on validated CUDA tensors (see :func:`flash_attention`)."""
    bh, s, hd = q.shape
    t = k.shape[1]
    # TMA (the wgmma body) needs a 16-byte aligned base: the wrapper checks it
    body = BODIES[(q.dtype, hd)]
    out = torch.empty_like(q)
    rc = build.library("flash_attention").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, t, hd,
        bh // k.shape[0], int(causal), int(window), scale, softcap,
        int(q.dtype == torch.bfloat16), BODY_IDS[body], stream(q),
    )
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.body_launches[body] += 1
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, scale, softcap):
    return torch.empty_like(q)


def attended_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs that K8's mask keeps: the work the data needs."""
    qi = np.arange(s)
    hi = np.minimum(qi, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(qi - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(q_shape, k_shape, causal: bool, window: int) -> int:
    """K8's dot FLOPs: QK^T and PV over the attended pairs only, 4·hd a pair
    and a query row."""
    bh, s, hd = q_shape
    return 4 * bh * hd * attended_pairs(s, k_shape[1], causal, window)


def _register_cost_and_sharding() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _flops(q_shape, k_shape, v_shape, causal, window, scale, softcap, *args, out_shape=None,
               **kwargs) -> int:
        return flash_flops(q_shape, k_shape, causal, window)

    try:
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import register_sharding
    except ImportError:  # a build without torch.distributed
        return

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _rule(q, k, v, causal, window, scale, softcap):
        # query rows and their KV rows split alike over BH, or all replicated
        return [([Shard(0)], [Shard(0), Shard(0), Shard(0), None, None, None, None]),
                ([Replicate()], [Replicate(), Replicate(), Replicate(), None, None, None, None])]


_register_cost_and_sharding()
