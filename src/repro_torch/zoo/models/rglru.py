"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), port
of ``repro/zoo/models/rglru.py``.

Gated linear recurrence, per channel:

    r_t = sigmoid(x_t W_rg)                    (recurrence gate)
    i_t = sigmoid(x_t W_ig)                    (input gate)
    a_t = a^(c * r_t)     with a = sigmoid(Λ), c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The block wraps the recurrence Griffin-style: two input branches (linear +
gated), a short temporal conv (width 4) before the RG-LRU, GeLU-gated merge,
and an output projection.

The recurrence is a first-order linear scan.  The reference runs it with
``jax.lax.associative_scan``; the port runs the same combine
``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)`` as a Hillis-Steele doubling
scan over the sequence: ceil(log2 S) steps of whole-tensor products (12 at
4,096 tokens), not S steps of a loop.  The decode path is the O(1)
single-step update.  The conv carry is kept in bf16 and ``h`` in f32, as
the reference's state is.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import rules as sh
from repro_torch.zoo.configs.base import ModelConfig

C_EXP = 8.0


def init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    dr = cfg.d_rnn_
    return {
        "h": sh.zeros((batch, dr), ("batch", None), dtype=torch.float32, device=device),
        "conv": sh.zeros((batch, cfg.conv_width - 1, dr), ("batch", None, None),
                         dtype=torch.bfloat16, device=device),
    }


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, carry: Optional[torch.Tensor]):
    """Causal depthwise conv over time.  x: (B,S,C); w: (W,C).

    Returns (out (B,S,C), new_carry (B,W-1,C))."""
    width = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xx = torch.cat([carry.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = xx[:, 0:s] * w[0][None, None, :]
    for i in range(1, width):  # the reference's sum(...) order: 0 + t0 + t1 + ...
        out = out + xx[:, i:i + s] * w[i][None, None, :]
    return out + b, xx[:, -(width - 1):] if width > 1 else carry


def _gates(xr: torch.Tensor, p):
    r = torch.sigmoid(xr @ p["w_rec_gate"])
    i = torch.sigmoid(xr @ p["w_input_gate"])
    log_a = C_EXP * r.float() * F.logsigmoid(p["lambda_p"].float())
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2 * log_a), 1e-12)) * (
        i.float() * xr.float())
    return a, gated_x


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` (h_{-1} = 0) along dim
    1, by doubling: after the step of offset ``o`` each position holds the
    combine of the ``2 o`` terms ending at it."""
    s = a.shape[1]
    o = 1
    while o < s:
        a_hi, b_hi = a[:, o:], b[:, o:]
        b = torch.cat([b[:, :o], torch.addcmul(b_hi, a_hi, b[:, :-o])], dim=1)
        a = torch.cat([a[:, :o], a_hi * a[:, :-o]], dim=1)
        o *= 2
    return b


def rg_lru(xr: torch.Tensor, p, h0: Optional[torch.Tensor] = None):
    """Linear recurrence by a parallel scan.  xr: (B,S,C) post-conv.

    Returns (h (B,S,C) in input dtype, h_final (B,C) f32)."""
    a, gx = _gates(xr, p)  # (B,S,C) f32
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h_0 + gx_1
        gx = torch.cat([gx[:, :1] + a[:, :1] * h0[:, None], gx[:, 1:]], dim=1)
    h = _linear_scan(a, gx)
    return h.to(xr.dtype), h[:, -1]


def rg_lru_step(xr: torch.Tensor, p, h0: torch.Tensor):
    """Decode: one token.  xr: (B,1,C).  Returns (out, h_new)."""
    a, gx = _gates(xr, p)
    h = a[:, 0] * h0 + gx[:, 0]
    return h[:, None].to(xr.dtype), h


def rglru_block(x: torch.Tensor, p, cfg: ModelConfig, state: Optional[dict] = None, *,
                decode: bool = False):
    """Full Griffin recurrent block.  x: (B,S,D) -> (B,S,D), state'."""
    gate = F.gelu(x @ p["w_gate_branch"], approximate="tanh")  # jax.nn.gelu's form
    xb = x @ p["w_x"]
    conv_carry = state["conv"] if state else None
    xb, conv_carry = _conv1d(xb, p["conv_w"], p["conv_b"], conv_carry)
    h0 = state["h"] if state else None
    if decode:
        if h0 is None:
            h0 = torch.zeros((x.shape[0], cfg.d_rnn_), dtype=torch.float32, device=x.device)
        y, h_fin = rg_lru_step(xb, p, h0)
    else:
        y, h_fin = rg_lru(xb, p, h0)
    out = (y * gate) @ p["w_out"]
    return out, {"h": h_fin, "conv": conv_carry}
