"""Plain PyTorch reference of an AFMoE decoder (the ``afmoe_serve`` kind):
Trinity-Mini's published block (https://huggingface.co/arcee-ai/Trinity-Mini,
its ``config.json`` and the ``afmoe`` modeling code published with it), and
the seeded weights both sides are given.

Over the whole sequence of one row at once (no cache, no batching of rows
into one attention, no kernels of the program), d = d_model:

    x = E[tok] * sqrt(d)                                    (mup_enabled)
    per layer i:
      h = RMSNorm_in(x) ;  q, k, v = h Wq, h Wk, h Wv       (GQA: H query heads, KV key heads)
      q, k = RMSNorm_hd(q), RMSNorm_hd(k)                   (qk-norm, per head)
      sliding layers: q, k = RoPE(q), RoPE(k)               (rotate-half, theta; positions 0..S-1)
      full layers: no position encoding
      a = softmax(q k^T / sqrt(hd) + mask) v                (causal; sliding layers also
                                                             key > query - window)
      a = a * sigmoid(h Wgate)                              (the output gate, per head channel)
      x = x + RMSNorm_post_attn(a Wo)
      h = RMSNorm_pre_mlp(x)
      i < dense_layers:  m = SwiGLU_dff(h)
      else:              s = sigmoid(h Wr) in f32 over E experts; S = top_k(s + b), the
                         expert bias b used for selection only;
                         w_j = route_scale * s_j / (sum_{l in S} s_l + 1e-20);
                         m = sum_{j in S} w_j SwiGLU_moe^(j)(h) + SwiGLU_moe^(shared)(h)
      x = x + RMSNorm_post_mlp(m)
    logits = RMSNorm_final(x) Whead                         (untied)

SwiGLU_f(h) = (silu(h W_gate) * h W_in) W_out with W_gate, W_in (d, f).
The experts are computed by a loop over the experts some token chose, each
on its own tokens.  ``forward(..., routes=...)`` takes a selection made
elsewhere in place of its own top-k (the benchmark's comparison: bf16
rounding swaps near-tied experts, so a program and this reference, each
choosing for itself, would compute different sums); it still computes the
weights itself, and reads how far each chosen set lies from its own top-k
(``regret``).  Float32 throughout, TF32 off: the weights are the bf16
draws upcast one layer at a time, so only the arithmetic differs from the
program.  Padding ids are tokens like any other (the server masks no left
padding), so a row goes in exactly as the server built it.  Departures from
the published description: none in the equations; the weights are drawn
(``make_weights``), not the published ones.

``control="fp8"`` computes every product with both operands rounded to
float8 e4m3 (one scale a tensor), the precision below the configuration's
bfloat16: the benchmark's control.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.lm import _fp8, _full_f32, _rms, _rope

F32 = torch.float32
GAIN_SIGMA = 0.5      # every norm gain: log-normal a channel
ROUTER_SIGMA = 0.7    # each expert's router column: a log-normal scale
# the model keys this reference computes, and the value of each switch it
# holds the model to; a configuration with other keys or values is refused
SIZE_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
             "vocab_size", "num_experts", "top_k", "moe_d_ff", "shared_experts", "dense_layers",
             "sliding_window", "layer_pattern", "rope_theta", "norm_eps", "route_scale", "dtype")
SWITCHES = {"qk_norm": True, "tie_embeddings": False, "act": "swiglu", "moe": True,
            "router_score": "sigmoid", "router_bias": True, "dropless": True,
            "attn_out_gate": True, "rope_local_only": True, "sandwich_norm": True,
            "embed_scale": True}


def check_model(model: dict) -> None:
    if set(model) != set(SIZE_KEYS) | set(SWITCHES) or any(
            model[k] != v for k, v in SWITCHES.items()):
        raise ValueError(f"the afmoe reference computes the keys {SIZE_KEYS} with the switches "
                         f"{SWITCHES}; got {model}")


def layer_kinds(model: dict) -> list:
    p = model["layer_pattern"]
    return [p[i % len(p)] for i in range(model["num_layers"])]


def make_weights(model: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights, drawn on ``device`` from ``seed`` in ``dtype`` (the
    served type), one call a leaf kind over every layer: normal leaves
    N(0, 1) / sqrt(fan_in), the embedding too (fan_in d: the sqrt(d) scale
    then gives unit-RMS rows, as the published init's 0.02 std does; an
    N(0, 1) table would hold the residual stream at RMS sqrt(d), where the
    layers' outputs of RMS about 1 would drown in its bf16 rounding), every
    norm gain log-normal (``GAIN_SIGMA``) a channel, so that no norm is an
    identity.  Each expert's router column is scaled by a log-normal factor
    (``ROUTER_SIGMA``, mean square 1), so that some experts score higher
    than others, as a trained router's do; the expert bias is the one that
    balances the load this skews (``balancing_bias``), as aux-loss-free
    training leaves it.  Laid out as the serving path loads them
    (per-depth ``layers``)."""
    check_model(model)
    n, d, h, kv = model["num_layers"], model["d_model"], model["num_heads"], model["num_kv_heads"]
    hd, f, v = model["head_dim"], model["d_ff"], model["vocab_size"]
    e, fe, fs = model["num_experts"], model["moe_d_ff"], model["moe_d_ff"] * model["shared_experts"]
    nd = model["dense_layers"]
    nm = n - nd
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(fan_in ** -0.5)

    def gains(shape):
        g = torch.randn(shape, generator=gen, device=device, dtype=F32)
        return g.mul_(GAIN_SIGMA).exp_().to(dtype)

    attn = {"wq": normal((n, d, h, hd), d), "wk": normal((n, d, kv, hd), d),
            "wv": normal((n, d, kv, hd), d), "wo": normal((n, h, hd, d), h * hd),
            "wgate": normal((n, d, h, hd), d)}
    dense = {"w_in": normal((nd, d, f), d), "w_gate": normal((nd, d, f), d),
             "w_out": normal((nd, f, d), f)}
    scale = torch.randn((nm, 1, e), generator=gen, device=device, dtype=F32)
    scale = scale.mul_(ROUTER_SIGMA).sub_(ROUTER_SIGMA ** 2).exp_().to(dtype)
    experts = {"router": normal((nm, d, e), d).mul_(scale), "w_in": normal((nm, e, d, fe), d),
               "w_gate": normal((nm, e, d, fe), d), "w_out": normal((nm, e, fe, d), fe)}
    shared = {"w_in": normal((nm, d, fs), d), "w_gate": normal((nm, d, fs), d),
              "w_out": normal((nm, fs, d), fs)}
    embed, lm_head = normal((v, d), d), normal((d, v), d)
    norm = gains((n, 4, d))
    qk = gains((n, 2, hd))
    bias = balancing_bias(experts["router"], norm[nd:, 2], model["top_k"])
    layers = []
    for i in range(n):
        lp = {"ln1": norm[i, 0], "ln1_post": norm[i, 1], "ln2": norm[i, 2], "ln2_post": norm[i, 3],
              "attn": {**{k: w[i] for k, w in attn.items()}, "q_norm": qk[i, 0],
                       "k_norm": qk[i, 1]}}
        if i < nd:
            lp["ffn"] = {k: w[i] for k, w in dense.items()}
        else:
            j = i - nd
            lp["moe"] = {**{k: w[j] for k, w in experts.items()}, "bias": bias[j].to(dtype),
                         "shared": {k: w[j] for k, w in shared.items()}}
        layers.append(lp)
    return {"embed": embed, "final_norm": gains((d,)), "lm_head": lm_head, "layers": layers}


def balancing_bias(router: torch.Tensor, gain: torch.Tensor, top_k: int) -> torch.Tensor:
    """The expert bias (L, E) that evens the load of routers (L, d, E) fed
    RMS-normed rows times ``gain`` (L, d): over such rows expert e's logit
    spreads with std S_e = sqrt(sum_i gain_i^2 Wr_ie^2), and e is chosen
    about as often as any other where sigmoid(z_q S_e) + b_e is the same for
    all, z_q the normal quantile of 1 - top_k / E; centred on 0."""
    z_q = float(torch.special.ndtri(torch.tensor(1.0 - top_k / router.shape[-1],
                                                 dtype=torch.float64)))
    spread = torch.einsum("ld,lde->le", gain.to(F32) ** 2, router.to(F32) ** 2).sqrt_()
    b = -torch.sigmoid(z_q * spread)
    return b - b.mean(-1, keepdim=True)


def bias_moved(y: torch.Tensor, p: dict, model: dict) -> float:
    """The share of the rows of ``y`` (N, d) whose top-k experts the bias
    changes: those of scores + bias against those of the scores alone."""
    scores = torch.sigmoid(y @ p["router"])
    k = model["top_k"]
    own = torch.topk(scores, k, dim=-1).indices.sort(-1).values
    picked = torch.topk(scores + p["bias"], k, dim=-1).indices.sort(-1).values
    return float((own != picked).any(-1).float().mean())


def _mm(a: torch.Tensor, b: torch.Tensor, control) -> torch.Tensor:
    if control == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _swiglu(y: torch.Tensor, p: dict, control) -> torch.Tensor:
    return _mm(F.silu(_mm(y, p["w_gate"], control)) * _mm(y, p["w_in"], control), p["w_out"],
               control)


def _attend(q, k, v, window: int, control) -> torch.Tensor:
    """Causal attention of one row, keys past ``window`` positions back
    masked where it is set: q (S, H, hd), k/v (S, KV, hd)."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)          # (H, S, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    scores = _mm(q.transpose(0, 1), k.transpose(1, 2), control) * hd ** -0.5
    pos = torch.arange(s, device=q.device)
    off = pos[None, :] > pos[:, None]
    if window:
        off |= pos[None, :] <= pos[:, None] - window
    probs = torch.softmax(scores.masked_fill_(off, float("-inf")), dim=-1)
    return _mm(probs, v, control).transpose(0, 1)               # (S, H, hd)


def route(y: torch.Tensor, p: dict, model: dict, control=None, sel=None):
    """(selected experts (N, k), their weights (N, k), regret (N,)) of the
    rows of ``y`` (N, d): sigmoid scores in f32, the top-k of scores + bias
    (or ``sel``, a selection made elsewhere), weights from the scores alone,
    renormalised and scaled.  ``regret``: how far the lowest score + bias
    among the selected lies below the k-th largest (0 for this reference's
    own selection)."""
    scores = torch.sigmoid(_mm(y, p["router"], control))
    keys = scores + p["bias"]
    kth = torch.topk(keys, model["top_k"], dim=-1)
    if sel is None:
        sel = kth.indices
    w = scores.gather(-1, sel)
    regret = (kth.values[:, -1] - keys.gather(-1, sel).min(-1).values).clamp_min(0)
    return sel, model["route_scale"] * w / (w.sum(-1, keepdim=True) + 1e-20), regret


def moe(y: torch.Tensor, p: dict, model: dict, control=None, sel=None):
    """The MoE block of the rows of ``y`` (N, d): each chosen expert on its
    own tokens, weighted, plus the shared expert on every token.  Returns
    (output, the selection, its regret) (``route``)."""
    sel, w, regret = route(y, p, model, control, sel)
    out = _swiglu(y, p["shared"], control)
    for e in torch.unique(sel).tolist():
        tok, slot = torch.nonzero(sel == e, as_tuple=True)
        ex = {k: p[k][e] for k in ("w_in", "w_gate", "w_out")}
        out.index_add_(0, tok, w[tok, slot, None] * _swiglu(y[tok], ex, control))
    return out, sel, regret


@torch.no_grad()
def forward(weights: dict, model: dict, rows: torch.Tensor, first: int, *, control=None,
            routes=None) -> dict:
    """The token rows (R, S), each row computed alone in its attention:
    ``logits`` (R, S - first, V) in float32 at positions first..S-1;
    ``routes``, the experts each MoE layer chose, (R, S, k) a layer; and
    ``regret``, the largest of those choices' regret; ``bias_moved``, the
    share of (position, MoE layer) pairs whose own top-k the expert bias
    changes (``bias_moved``).  ``routes`` given (a
    selection made elsewhere, as this returns it) is taken in place of this
    reference's own top-k: the weights are still this reference's, and
    ``regret`` then judges that selection."""
    check_model(model)
    eps, theta, k_top = model["norm_eps"], model["rope_theta"], model["top_k"]
    r, s = rows.shape
    d, h, kv, hd = model["d_model"], model["num_heads"], model["num_kv_heads"], model["head_dim"]
    chosen, regret, moved = [], 0.0, []
    with _full_f32():
        x = weights["embed"][rows.long()].to(F32) * d ** 0.5
        for i, (lp, kind) in enumerate(zip(weights["layers"], layer_kinds(model))):
            a = {k: w.to(F32) for k, w in lp["attn"].items()}
            y = _rms(x, lp["ln1"], eps)
            q = _mm(y, a["wq"].flatten(1), control).view(r, s, h, hd)
            k = _mm(y, a["wk"].flatten(1), control).view(r, s, kv, hd)
            v = _mm(y, a["wv"].flatten(1), control).view(r, s, kv, hd)
            q, k = _rms(q, a["q_norm"], eps), _rms(k, a["k_norm"], eps)
            window = model["sliding_window"] if kind == "local" else 0
            if window:
                q, k = _rope(q, theta), _rope(k, theta)
            o = torch.stack([_attend(q[j], k[j], v[j], window, control) for j in range(r)])
            o = o.flatten(2) * torch.sigmoid(_mm(y, a["wgate"].flatten(1), control))
            x = x + _rms(_mm(o, a["wo"].flatten(0, 1), control), lp["ln1_post"], eps)
            del q, k, v, o, a
            y = _rms(x, lp["ln2"], eps)
            if "ffn" in lp:
                m = _swiglu(y, {k: w.to(F32) for k, w in lp["ffn"].items()}, control)
            else:
                p = {k: w.to(F32) for k, w in lp["moe"].items() if k != "shared"}
                p["shared"] = {k: w.to(F32) for k, w in lp["moe"]["shared"].items()}
                sel = None if routes is None else routes[len(chosen)].reshape(r * s, k_top)
                moved.append(bias_moved(y.flatten(0, 1), p, model))
                m, sel, miss = moe(y.flatten(0, 1), p, model, control, sel)
                m = m.view(r, s, d)
                chosen.append(sel.view(r, s, k_top))
                regret = max(regret, float(miss.max()))
                del p
            x = x + _rms(m, lp["ln2_post"], eps)
            del y, m
        y = _rms(x[:, first:], weights["final_norm"], eps)
        return {"logits": _mm(y, weights["lm_head"].to(F32), control), "routes": chosen,
                "regret": regret, "bias_moved": sum(moved) / max(len(moved), 1)}


def logits(weights: dict, model: dict, rows: torch.Tensor, first: int, *,
           control=None) -> torch.Tensor:
    """``forward``'s logits, with this reference's own expert choices."""
    return forward(weights, model, rows, first, control=control)["logits"]
