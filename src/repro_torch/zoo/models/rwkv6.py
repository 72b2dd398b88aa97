"""RWKV-6 "Finch" time-mix + channel-mix (arXiv:2404.05892), port of
``repro/zoo/models/rwkv6.py``.

Per head (head size ``hs``), with data-dependent per-channel decay
``w_t = exp(-exp(w0 + tanh(x_t A) B))``:

    y_t = ( S_{t-1} + (u ⊙ k_t) v_tᵀ )ᵀ r_t
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

Two execution forms, equal up to float rounding (the tests hold them to
each other):

  * ``scan``     — a loop over time with O(1) state: the decode path and the
                   ``FORCE_SCAN`` baseline;
  * ``chunked``  — the linear-attention chunk trick: the intra-chunk
                   contributions are causal matmuls and the state is carried
                   from chunk to chunk.

Chunked-form numerics (the reference's): decay factors are exponentials of
per-channel cumulative logs; all carry/state factors have non-positive
exponents, and the intra-chunk attention is stabilised around the
chunk-midpoint cumulant.  ``log w`` is clamped at ``LOGW_FLOOR`` = -8,
bounding exponents by C/2 * 8 < 88 for the default C = 16.

The reference scans ``chunk_step`` over the chunks.  Only its state carry
is sequential, so the port computes every chunk's intra-chunk terms, carry
factors and state increment at once, runs the carry ``S_{c+1} = W_c S_c +
U_c`` as a loop of one fused multiply-add a chunk, and adds every chunk's
carry-in term in one product: the same per-element formulas, in the
reference's order of operations, with far fewer launches on the card.

Token-shift: every projection sees ``lerp(x_t, x_{t-1}, mu)``.  The
recurrences are plain tensor code (the reference's are ``lax``, not Pallas),
so no kernel of the port runs here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import rules as sh
from repro_torch.zoo.configs.base import ModelConfig

LOGW_FLOOR = -8.0

# force the sequential scan for every prefill (the baseline the chunked
# form is measured against), as the reference's switch does
FORCE_SCAN = False


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """x: (B,S,D) -> x shifted right by one; ``prev`` is the carry (B,D)."""
    p = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([p, x[:, :-1]], dim=1)


def _projections(x: torch.Tensor, p, cfg: ModelConfig, x_prev):
    xs = _token_shift(x, x_prev)
    mix = lambda mu: x + (xs - x) * mu  # lerp with learned per-channel mu
    mu = p["mu"]
    r = mix(mu["r"]) @ p["wr"]
    k = mix(mu["k"]) @ p["wk"]
    v = mix(mu["v"]) @ p["wv"]
    g = mix(mu["g"]) @ p["wg"]
    # data-dependent decay (low-rank LoRA): log w = -exp(w0 + tanh(x A) B)
    lora = torch.tanh(mix(mu["w"]) @ p["wa"]) @ p["wb"]
    logw = -torch.exp((p["w0"] + lora).float())
    logw = logw.clamp_min(LOGW_FLOOR)
    nh = cfg.mixer_heads_
    hs = cfg.d_model // nh
    shp = lambda a: a.reshape(a.shape[0], a.shape[1], nh, hs)
    return shp(r), shp(k), shp(v), g, shp(logw)


def _finalize(y: torch.Tensor, g: torch.Tensor, p, cfg: ModelConfig, dtype):
    b, s = y.shape[:2]
    y = y.reshape(b, s, cfg.d_model).float()
    # per-head group norm (population variance, as jnp.var)
    nh = cfg.mixer_heads_
    yh = y.reshape(b, s, nh, -1)
    yh = (yh - yh.mean(-1, keepdim=True)) * torch.rsqrt(
        yh.var(-1, keepdim=True, unbiased=False) + 1e-5)
    y = (yh.reshape(b, s, cfg.d_model) * p["ln_x"]).to(dtype)
    y = y * F.silu(g)
    return y @ p["wo"]


def init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """The carried state: ``s`` in f32, the token-shift carries in bf16
    (whatever the model's dtype), as the reference's."""
    nh = cfg.mixer_heads_
    hs = cfg.d_model // nh
    return {
        "s": sh.zeros((batch, nh, hs, hs), ("batch", None, None, None), dtype=torch.float32,
                      device=device),
        "x_prev": sh.zeros((batch, cfg.d_model), ("batch", None), dtype=torch.bfloat16,
                           device=device),
        "ffn_prev": sh.zeros((batch, cfg.d_model), ("batch", None), dtype=torch.bfloat16,
                             device=device),
    }


def _start(x, p, cfg: ModelConfig, state: Optional[dict]):
    b, _, d = x.shape
    nh = cfg.mixer_heads_
    hs = d // nh
    x_prev = state["x_prev"].to(x.dtype) if state else None
    r, k, v, g, logw = _projections(x, p, cfg, x_prev)
    u = p["u"].float()
    s0 = state["s"] if state else torch.zeros((b, nh, hs, hs), dtype=torch.float32,
                                              device=x.device)
    return r, k, v, g, logw, u, s0


def time_mix_scan(x: torch.Tensor, p, cfg: ModelConfig, state: Optional[dict] = None):
    """The recurrence one token at a time.  Returns (out (B,S,D), new_state)."""
    r, k, v, g, logw, u, S = _start(x, p, cfg, state)
    r, k, v = r.float(), k.float(), v.float()
    w = torch.exp(logw)
    ys = []
    for t in range(x.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]            # (B,nh,hs,hs)
        ys.append(torch.einsum("bhij,bhi->bhj", S + u[..., :, None] * kv, r[:, t]))
        S = w[:, t, :, :, None] * S + kv
    y = torch.stack(ys, dim=1)  # (B,S,nh,hs)
    out = _finalize(y, g, p, cfg, x.dtype)
    return out, {"s": S, "x_prev": x[:, -1]}


def time_mix_chunked(x: torch.Tensor, p, cfg: ModelConfig, state: Optional[dict] = None,
                     chunk: int = 16):
    """Chunked parallel form: the scan's math, O(T/chunk) sequential steps."""
    b, s, d = x.shape
    nh = cfg.mixer_heads_
    hs = d // nh
    r, k, v, g, logw, u, s0 = _start(x, p, cfg, state)

    pad = (-s) % chunk
    if pad:
        # padded logw = 0 (w = 1): state passes through unchanged
        zp = lambda a: F.pad(a, (0, 0, 0, 0, 0, pad))
        r, k, v, logw = map(zp, (r, k, v, logw))
    n_ch = (s + pad) // chunk

    def to_chunks(a):  # (B, S, nh, hs) -> (B, n_ch, C, nh, hs), f32
        return a.float().reshape(b, n_ch, chunk, nh, hs)

    r_, k_, v_, lw = map(to_chunks, (r, k, v, logw))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device), -1)

    cum = torch.cumsum(lw, dim=2)                    # log W_t (inclusive)
    w_prev = torch.exp(cum - lw)                     # W_{t-1} <= 1
    # intra-chunk attention, stabilised at the chunk midpoint cumulant
    m = cum[:, :, chunk // 2][:, :, None]            # (B,n,1,nh,hs)
    qa = r_ * torch.exp(cum - lw - m)
    ka = k_ * torch.exp(m - cum)
    att = torch.einsum("bnchi,bndhi->bnhcd", qa, ka)
    att = torch.where(tri, att, torch.zeros((), device=x.device))  # strict causal (j < t)
    y = torch.einsum("bnhcd,bndhj->bnchj", att, v_)
    # diagonal bonus term
    diag = torch.einsum("bnchi,bnchi->bnch", r_ * u, k_)
    y_intra = diag[..., None] * v_
    # state carry-out: S' = W_C S + Σ_j (W_C/W_j) k_j v_jᵀ
    w_total = torch.exp(cum[:, :, -1])               # (B,n,nh,hs)
    k_state = k_ * torch.exp(cum[:, :, -1][:, :, None] - cum)  # exponent <= 0
    inc = torch.einsum("bnchi,bnchj->bnhij", k_state, v_)
    states = []                                      # S entering each chunk
    S = s0
    for c in range(n_ch):
        states.append(S)
        S = torch.addcmul(inc[:, c], w_total[:, c, ..., None], S)
    # carry-in: y_t += (r_t ⊙ W_{t-1}) · S_in, then the reference's sum order
    carry = torch.einsum("bnchi,bnhij->bnchj", r_ * w_prev, torch.stack(states, dim=1))
    y = carry + y + y_intra
    y = y.reshape(b, n_ch * chunk, nh, hs)[:, :s]
    out = _finalize(y, g, p, cfg, x.dtype)
    return out, {"s": S, "x_prev": x[:, -1]}


def channel_mix(x: torch.Tensor, p, prev: Optional[torch.Tensor] = None):
    """RWKV channel-mix FFN: r-gated squared-ReLU.  Returns (out, carry)."""
    xs = _token_shift(x, None if prev is None else prev.to(x.dtype))
    mix = lambda mu: x + (xs - x) * mu
    kx = mix(p["mu_k"])
    rx = mix(p["mu_r"])
    h = torch.square(torch.relu(kx @ p["w_k"]))
    out = h @ p["w_v"]
    r = torch.sigmoid(rx @ p["w_r"])
    return r * out, x[:, -1]
