"""Shared neural layers (port of ``repro/zoo/models/layers.py``): pure
functions over tensors and param dicts, with the reference's rounding
points (norms and rotary embeddings computed in f32, cast back)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import shard


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * gain.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_in, w_gate, w_out) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_in)) @ w_out


def gelu_mlp(x: torch.Tensor, w_in, w_out) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w_in, approximate="tanh") @ w_out


def mlp(x: torch.Tensor, p, act: str) -> torch.Tensor:
    """The dense FFN, its hidden activation constrained to (batch, -, d_ff)
    as the reference's (Megatron TP: d_ff over "model")."""
    if act == "swiglu" and "w_gate" in p:
        h = shard(F.silu(x @ p["w_gate"]) * (x @ p["w_in"]), ("batch", None, "d_ff"))
        return h @ p["w_out"]
    h = shard(F.gelu(x @ p["w_in"], approximate="tanh"), ("batch", None, "d_ff"))
    return h @ p["w_out"]
