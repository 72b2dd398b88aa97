"""Frozen operation and byte counts of the AFMoE decoder (the
``afmoe_serve`` kind), from the model's sizes alone: a served batch's model
FLOPs, the routed experts' grouped GEMMs and K8's prefill launches.

Model FLOPs of a served batch count every token the server runs, padded
prompt positions included (the server computes them), a multiply-add as 2:
a layer's Q, K, V, gate and O projections; a dense layer's three SwiGLU
products; an MoE layer's router, its top_k routed experts' three products
(only the experts a token is routed to) and the shared expert's; attention
over the (query, key) pairs the mask keeps (4 hd a pair and head: QK^T and
PV; a sliding layer's query attends at most ``sliding_window`` keys); the
head on each prefill row's last position and on every decoded token.  Norms,
RoPE, the router's softmax-free scoring and the combine are left out.

A kernel's bytes count each input byte read once and each output byte
written once; its least time is the larger of bytes over the HBM rate and
FLOPs over the bf16 peak (``bench/peaks.py``).
"""
from __future__ import annotations

import numpy as np

from bench import peaks

BYTES = 2   # bf16


def layer_kinds(model: dict) -> list:
    p = model["layer_pattern"]
    return [p[i % len(p)] for i in range(model["num_layers"])]


def token_flops(model: dict) -> int:
    """The projections, FFN and expert products of one token through every
    layer."""
    d, h, kv, hd = (model[k] for k in ("d_model", "num_heads", "num_kv_heads", "head_dim"))
    attn = 3 * d * h * hd + 2 * d * kv * hd          # Q, gate, O; K, V
    dense = 3 * d * model["d_ff"]
    routed = d * model["num_experts"] + 3 * d * model["moe_d_ff"] * (
        model["top_k"] + model["shared_experts"])
    nd = model["dense_layers"]
    return 2 * (model["num_layers"] * attn + nd * dense + (model["num_layers"] - nd) * routed)


def attended_pairs(s: int, t: int, window: int) -> int:
    """Causal (query, key) pairs of ``s`` queries at positions t - s .. t - 1
    over ``t`` keys, each query at most ``window`` keys back (0: none)."""
    q = np.arange(t - s, t)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, np.int64)
    return int((q - lo + 1).sum())


def _attention_flops(model: dict, s: int, t: int) -> int:
    per_pair = 4 * model["num_heads"] * model["head_dim"]
    return sum(per_pair * attended_pairs(s, t, model["sliding_window"] if kind == "local" else 0)
               for kind in layer_kinds(model))


def batch_flops(model: dict, batch: int, prompt: int, new: int) -> int:
    """One served batch: the prefill of ``batch`` rows of ``prompt`` (padded)
    tokens, then ``new - 1`` decode steps, the step at position p attending
    the keys written so far (a sliding layer's last ``sliding_window``)."""
    head = 2 * model["d_model"] * model["vocab_size"]
    prefill = prompt * token_flops(model) + head + _attention_flops(model, prompt, prompt)
    decode = sum(token_flops(model) + head + _attention_flops(model, 1, p + 1)
                 for p in range(prompt, prompt + new - 1))
    return batch * (prefill + decode)


def _t_min(nbytes: int, flops: int) -> float:
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.BF16_FLOPS)


def expert_gemms(model: dict, assignments: int, experts: int) -> dict:
    """One MoE layer's routed-expert grouped GEMMs (gate, in: (M, d) x (d, f);
    out: (M, f) x (f, d)) over ``assignments`` (token, expert) pairs held by
    ``experts`` experts: ``bytes``, ``flops`` and ``t_min`` (s) summed over
    the three launches.  Each launch reads its M rows, the weights of the
    experts that hold rows, and writes its M output rows."""
    m, d, f = assignments, model["d_model"], model["moe_d_ff"]
    launches = [(m * d + experts * d * f + m * f)] * 2 + [m * f + experts * f * d + m * d]
    flops = 2 * m * d * f
    return {"bytes": BYTES * sum(launches), "flops": 3 * flops,
            "t_min": sum(_t_min(BYTES * b, flops) for b in launches)}


def k8_prefill(model: dict, batch: int, prompt: int) -> dict:
    """K8's launches of one prefill of ``batch`` rows of ``prompt`` tokens,
    one a layer (causal; a sliding layer's window): ``bytes`` (Q, K, V read
    once, K and V once a KV head; O written), ``flops`` (4 hd a kept pair
    and query head), ``t_min`` (s) summed, and ``launches``."""
    h, kv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    out = {"bytes": 0, "flops": 0, "t_min": 0.0, "launches": 0}
    for kind in layer_kinds(model):
        window = model["sliding_window"] if kind == "local" else 0
        b = BYTES * prompt * hd * batch * (2 * h + 2 * kv)
        fl = 4 * batch * h * hd * attended_pairs(prompt, prompt, window)
        out["bytes"] += b
        out["flops"] += fl
        out["t_min"] += _t_min(b, fl)
        out["launches"] += 1
    return out
