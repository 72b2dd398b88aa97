"""Plain PyTorch reference of an AFMoE decoder (Trinity-Mini's block:
https://huggingface.co/arcee-ai/Trinity-Mini, its ``config.json`` and the
``afmoe`` modeling code published with it), for the CPU tests of the
port's ``trinity-mini``.  It imports nothing of ``repro``, ``repro_torch``
or JAX; ``bench/reference/afmoe.py`` is its copy in the benchmark (with the
seeded weight draw the chip runs use, an fp8 control and routes taken from
the program).

Over the whole sequence of each row alone (no cache, no batching of rows
into one attention), float32, TF32 off, d = d_model:

    x = E[tok] * sqrt(d)                                    (mup_enabled)
    per layer i:
      h = RMSNorm_in(x) ;  q, k, v = h Wq, h Wk, h Wv       (GQA: H query, KV key heads)
      q, k = RMSNorm_hd(q), RMSNorm_hd(k)                   (qk-norm, per head)
      sliding layers: q, k = RoPE(q), RoPE(k)               (rotate-half, theta)
      full layers: no position encoding
      a = softmax(q k^T / sqrt(hd) + mask) v                (causal; sliding layers also
                                                             key > query - window)
      a = a * sigmoid(h Wgate)                              (per head channel)
      x = x + RMSNorm_post_attn(a Wo)
      h = RMSNorm_pre_mlp(x)
      i < dense_layers:  m = SwiGLU_dff(h)
      else:              s = sigmoid(h Wr) over E experts; S = top_k(s + b), the bias
                         b for selection only; w_j = route_scale * s_j / (sum_S s + 1e-20);
                         m = sum_{j in S} w_j SwiGLU_moe^(j)(h) + SwiGLU_moe^(shared)(h)
      x = x + RMSNorm_post_mlp(m)
    logits = RMSNorm_final(x) Whead                         (untied)

SwiGLU_f(h) = (silu(h W_gate) * h W_in) W_out.  The experts are a loop over
the experts some token chose, each on its own tokens.  Departures from the
published description: none in the equations; the weights are drawn
(``make_weights``), not the published ones; padding ids are tokens like any
other (the server masks no left padding).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

F32 = torch.float32
GAIN_SIGMA = 0.5      # every norm gain: log-normal a channel
ROUTER_SIGMA = 0.7    # each expert's router column: a log-normal scale


def layer_kinds(model: dict) -> list:
    p = model["layer_pattern"]
    return [p[i % len(p)] for i in range(model["num_layers"])]


def make_weights(model: dict, seed: int) -> dict:
    """Float32 weights on the CPU, laid out as the serving path loads them:
    N(0, 1) / sqrt(fan_in) leaves (the embedding too), log-normal norm
    gains, router columns scaled log-normally and the expert bias that
    evens the load this skews (the benchmark's draw, in its own order)."""
    n, d, h, kv = model["num_layers"], model["d_model"], model["num_heads"], model["num_kv_heads"]
    hd, f, v = model["head_dim"], model["d_ff"], model["vocab_size"]
    e, fe = model["num_experts"], model["moe_d_ff"]
    fs, nd = fe * model["shared_experts"], model["dense_layers"]
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, fan_in=None):
        return torch.randn(shape, generator=gen) * (fan_in or shape[-2]) ** -0.5

    def gain(*shape):
        return (torch.randn(shape, generator=gen) * GAIN_SIGMA).exp()

    layers = []
    for i in range(n):
        lp = {"ln1": gain(d), "ln1_post": gain(d), "ln2": gain(d), "ln2_post": gain(d),
              "attn": {"wq": normal(d, h * hd).view(d, h, hd),
                       "wk": normal(d, kv * hd).view(d, kv, hd),
                       "wv": normal(d, kv * hd).view(d, kv, hd),
                       "wo": normal(h * hd, d).view(h, hd, d),
                       "wgate": normal(d, h * hd).view(d, h, hd),
                       "q_norm": gain(hd), "k_norm": gain(hd)}}
        if i < nd:
            lp["ffn"] = {"w_in": normal(d, f), "w_gate": normal(d, f), "w_out": normal(f, d)}
        else:
            router = normal(d, e) * (torch.randn(e, generator=gen) * ROUTER_SIGMA
                                     - ROUTER_SIGMA ** 2).exp()
            lp["moe"] = {"router": router, "w_in": normal(e, d, fe), "w_gate": normal(e, d, fe),
                         "w_out": normal(e, fe, d),
                         "bias": balancing_bias(router, lp["ln2"], model["top_k"]),
                         "shared": {"w_in": normal(d, fs), "w_gate": normal(d, fs),
                                    "w_out": normal(fs, d)}}
        layers.append(lp)
    return {"embed": normal(v, d, fan_in=d), "final_norm": gain(d), "lm_head": normal(d, v),
            "layers": layers}


def balancing_bias(router: torch.Tensor, gain: torch.Tensor, top_k: int) -> torch.Tensor:
    """The bias (E,) under which each expert of ``router`` (d, E), fed
    RMS-normed rows times ``gain``, is chosen about equally often: expert e's
    logit spreads with std S_e = sqrt(sum_i gain_i^2 Wr_ie^2), and
    sigmoid(z_q S_e) + b_e is made equal, z_q the normal quantile of
    1 - top_k / E."""
    z_q = float(torch.special.ndtri(torch.tensor(1.0 - top_k / router.shape[-1],
                                                 dtype=torch.float64)))
    b = -torch.sigmoid(z_q * ((gain[:, None] ** 2) * router ** 2).sum(0).sqrt())
    return b - b.mean()


@contextlib.contextmanager
def _full_f32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _rms(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gain


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over (S, heads, hd), positions 0..S-1."""
    s, hd = x.shape[0], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * inv
    cos, sin = ang.cos().to(F32)[:, None, :], ang.sin().to(F32)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _swiglu(y: torch.Tensor, p: dict) -> torch.Tensor:
    return (F.silu(y @ p["w_gate"]) * (y @ p["w_in"])) @ p["w_out"]


def _attend(q, k, v, window: int) -> torch.Tensor:
    """One row's causal attention, keys more than ``window`` back masked
    where it is set: q (S, H, hd), k/v (S, KV, hd) -> (S, H, hd)."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    scores = q.transpose(0, 1) @ k.transpose(1, 2) * hd ** -0.5
    pos = torch.arange(s)
    off = pos[None, :] > pos[:, None]
    if window:
        off |= pos[None, :] <= pos[:, None] - window
    return (torch.softmax(scores.masked_fill(off, float("-inf")), -1) @ v).transpose(0, 1)


def route(y: torch.Tensor, p: dict, model: dict):
    """(chosen experts (N, k), their weights (N, k)) of the rows ``y``."""
    scores = torch.sigmoid(y @ p["router"])
    sel = torch.topk(scores + p["bias"], model["top_k"], dim=-1).indices
    w = scores.gather(-1, sel)
    return sel, model["route_scale"] * w / (w.sum(-1, keepdim=True) + 1e-20)


def moe(y: torch.Tensor, p: dict, model: dict) -> torch.Tensor:
    """The MoE block of the rows ``y`` (N, d): each chosen expert on its own
    tokens, weighted, plus the shared expert on every token."""
    sel, w = route(y, p, model)
    out = _swiglu(y, p["shared"])
    for e in torch.unique(sel).tolist():
        tok, slot = torch.nonzero(sel == e, as_tuple=True)
        ex = {k: p[k][e] for k in ("w_in", "w_gate", "w_out")}
        out.index_add_(0, tok, w[tok, slot, None] * _swiglu(y[tok], ex))
    return out


@torch.no_grad()
def logits(weights: dict, model: dict, rows: torch.Tensor, first: int = 0) -> torch.Tensor:
    """The float32 logits (R, S - first, V) of the token rows (R, S) at
    positions first..S-1, each row computed alone."""
    eps, theta = model["norm_eps"], model["rope_theta"]
    d, h, kv, hd = model["d_model"], model["num_heads"], model["num_kv_heads"], model["head_dim"]
    out = []
    with _full_f32():
        for row in rows.long():
            x = weights["embed"][row].float() * d ** 0.5
            s = x.shape[0]
            for lp, kind in zip(weights["layers"], layer_kinds(model)):
                a = lp["attn"]
                y = _rms(x, lp["ln1"], eps)
                q = _rms((y @ a["wq"].flatten(1)).view(s, h, hd), a["q_norm"], eps)
                k = _rms((y @ a["wk"].flatten(1)).view(s, kv, hd), a["k_norm"], eps)
                v = (y @ a["wv"].flatten(1)).view(s, kv, hd)
                window = model["sliding_window"] if kind == "local" else 0
                if window:
                    q, k = _rope(q, theta), _rope(k, theta)
                o = _attend(q, k, v, window).flatten(1) * torch.sigmoid(y @ a["wgate"].flatten(1))
                x = x + _rms(o @ a["wo"].flatten(0, 1), lp["ln1_post"], eps)
                y = _rms(x, lp["ln2"], eps)
                m = _swiglu(y, lp["ffn"]) if "ffn" in lp else moe(y, lp["moe"], model)
                x = x + _rms(m, lp["ln2_post"], eps)
            out.append(_rms(x[first:], weights["final_norm"], eps) @ weights["lm_head"])
    return torch.stack(out)
