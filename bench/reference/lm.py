"""Plain PyTorch reference of a dense decoder LM of the ``lm_serve`` kind:
Qwen3's published block (https://huggingface.co/Qwen/Qwen3-8B, its
``modeling_qwen3``), and the seeded weights both sides are given.

Per layer, over the whole sequence of one row at once (no cache, no
batching of rows into one attention, no kernels of the program):

    h = RMSNorm(x) ;  q, k, v = h Wq, h Wk, h Wv   (GQA: H query heads, KV key heads)
    q, k = RMSNorm_hd(q), RMSNorm_hd(k)            (qk-norm, per head)
    q, k = RoPE(q), RoPE(k)                        (rotate-half, theta; positions 0..S-1)
    x = x + softmax(q k^T / sqrt(hd) + causal) v Wo
    x = x + (silu(RMSNorm(x) Wgate) * RMSNorm(x) Win) Wout

then the final RMSNorm and the untied head.  Float32 throughout, with TF32
off: the weights are the bf16 draws upcast one layer at a time, so only
the arithmetic differs from the program, and 36 full-width layers fit
beside the bf16 weights.  Padding ids are tokens like any other: the
server masks no left padding, so a row goes in exactly as the server built
it.

``control="fp8"`` computes every product with both operands rounded to
float8 e4m3 (one scale a tensor, its largest magnitude at 448), the
precision below the configuration's bfloat16: the benchmark's control.
"""
from __future__ import annotations

import contextlib

import torch

F32 = torch.float32
E4M3_MAX = 448.0
QK_GAIN_SIGMA = 0.5   # the qk-norm gains' log-normal sigma
# the model keys this reference computes; anything else in a configuration
# (windows, experts, biases, softcaps, tied heads) it refuses
DENSE_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "qk_norm", "rope_theta", "norm_eps", "tie_embeddings", "act", "dtype")


def check_model(model: dict) -> None:
    if set(model) != set(DENSE_KEYS) or model["tie_embeddings"] or model["act"] != "swiglu":
        raise ValueError(f"the lm reference computes an untied dense SwiGLU decoder with the keys "
                         f"{DENSE_KEYS}; got {sorted(model)}")


def make_weights(model: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights, drawn on ``device`` from ``seed`` in ``dtype`` (the
    served type), one call a leaf kind over every layer: normal leaves
    N(0, 1) / sqrt(fan_in), the embedding N(0, 1), the qk-norm gains
    log-normal (``QK_GAIN_SIGMA``) a channel, the other norm gains 1.  Laid
    out as the serving path loads them (per-depth ``layers``)."""
    check_model(model)
    n, d, h, kv = model["num_layers"], model["d_model"], model["num_heads"], model["num_kv_heads"]
    hd, f, v = model["head_dim"], model["d_ff"], model["vocab_size"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(fan_in ** -0.5)

    stacked = {
        "wq": normal((n, d, h, hd), d), "wk": normal((n, d, kv, hd), d),
        "wv": normal((n, d, kv, hd), d), "wo": normal((n, h, hd, d), h * hd),
        "w_in": normal((n, d, f), d), "w_gate": normal((n, d, f), d), "w_out": normal((n, f, d), f),
    }
    embed, lm_head = normal((v, d), 1), normal((d, v), d)
    # q and k come out of the projections at unit RMS, so unit gains would
    # make qk-norm all but the identity, and skipping it no fault at all
    qk_gain = torch.randn((n, 2, hd), generator=gen, device=device, dtype=F32)
    qk_gain = qk_gain.mul_(QK_GAIN_SIGMA).exp_().to(dtype)
    ones_d = torch.ones(d, device=device, dtype=dtype)
    layers = []
    for i in range(n):
        attn = {k: stacked[k][i] for k in ("wq", "wk", "wv", "wo")}
        if model["qk_norm"]:
            attn.update(q_norm=qk_gain[i, 0], k_norm=qk_gain[i, 1])
        layers.append({"ln1": ones_d, "attn": attn, "ln2": ones_d,
                       "ffn": {k: stacked[k][i] for k in ("w_in", "w_gate", "w_out")}})
    return {"embed": embed, "final_norm": ones_d, "lm_head": lm_head, "layers": layers}


@contextlib.contextmanager
def _full_f32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, control) -> torch.Tensor:
    if control == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _rms(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gain.to(F32)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over (R, S, heads, hd), positions 0..S-1; angles in
    float64."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().to(F32)[:, None, :], ang.sin().to(F32)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, control) -> torch.Tensor:
    """Causal attention of one row: q (S, H, hd), k/v (S, KV, hd)."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)          # (H, S, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    scores = _mm(q.transpose(0, 1), k.transpose(1, 2), control) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).triu_(1)
    probs = torch.softmax(scores.masked_fill_(causal, float("-inf")), dim=-1)
    return _mm(probs, v, control).transpose(0, 1)               # (S, H, hd)


@torch.no_grad()
def logits(weights: dict, model: dict, rows: torch.Tensor, first: int, *,
           control=None) -> torch.Tensor:
    """Logits (R, S - first, V) in float32 at positions first..S-1 of the
    token rows (R, S), each row computed alone in its attention."""
    check_model(model)
    eps, theta = model["norm_eps"], model["rope_theta"]
    r, s = rows.shape
    h, kv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    with _full_f32():
        x = weights["embed"][rows.long()].to(F32)
        for lp in weights["layers"]:
            a = {k: w.to(F32) for k, w in lp["attn"].items()}
            y = _rms(x, lp["ln1"], eps)
            q = _mm(y, a["wq"].flatten(1), control).view(r, s, h, hd)
            k = _mm(y, a["wk"].flatten(1), control).view(r, s, kv, hd)
            v = _mm(y, a["wv"].flatten(1), control).view(r, s, kv, hd)
            if model["qk_norm"]:
                q, k = _rms(q, a["q_norm"], eps), _rms(k, a["k_norm"], eps)
            q, k = _rope(q, theta), _rope(k, theta)
            o = torch.stack([_attend(q[i], k[i], v[i], control) for i in range(r)])
            x = x + _mm(o.flatten(2), a["wo"].flatten(0, 1), control)
            del q, k, v, o, a
            ffn = {k: w.to(F32) for k, w in lp["ffn"].items()}
            y = _rms(x, lp["ln2"], eps)
            up = torch.nn.functional.silu(_mm(y, ffn["w_gate"], control)) * _mm(y, ffn["w_in"],
                                                                                control)
            x = x + _mm(up, ffn["w_out"], control)
            del ffn, y, up
        y = _rms(x[:, first:], weights["final_norm"], eps)
        return _mm(y, weights["lm_head"].to(F32), control)
