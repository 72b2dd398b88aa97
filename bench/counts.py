"""Frozen operation and byte counts: of the GNN forward and of its two SpMM
kernels, from the graph alone; and of the zoo's dense decoder LM,
from the model's sizes (below).

The forward is GROOT's SAGE layer, per layer with input width F and hidden
width H over N nodes and E fanin->node edges:

    acc = h W_self + b + sum over 4 fanin groups and 2 fanout groups of
          mean(group's neighbours of h) W_g ;   h' = relu(acc)

and a linear head to C classes.  Model FLOPs count a multiply-add as 2:
seven (N, F) x (F, H) products, the two directions' mean aggregations (one
multiply-add per edge and feature each), the bias and six group sums
(7 N H adds); the head 2 N H C + N C.

The SpMM kernels aggregate each direction in G groups (fanin G = 4, rows are
the edges' destinations; fanout G = 2, rows are their sources).  Rows of
degree <= E_T go through the LD kernel (K1), rows above it through the HD
kernel (K2).  A kernel's bytes count each input byte read once and each
output byte written once: the distinct neighbour rows of h it reads (F
floats), one int32 column index and G float32 weights an edge, and G
(F-float) output rows for each row that has an edge.  Its FLOPs: one
multiply-add an edge, group and feature.  Its least time is the larger of
bytes over the HBM rate and FLOPs over the float32 peak, per launch.
"""
from __future__ import annotations

import numpy as np

from bench import peaks

E_T = 512          # the paper's HD threshold: rows of degree > E_T are HD
FANIN_G, FANOUT_G = 4, 2


def model_flops(num_nodes: int, num_edges: int, gnn: dict) -> int:
    n, e = num_nodes, num_edges
    h, c = gnn["hidden"], gnn["num_classes"]
    total = 0
    f = gnn["in_features"]
    for _ in range(gnn["num_layers"]):
        total += 7 * 2 * n * f * h + 2 * 2 * e * f + 7 * n * h
        f = h
    return total + 2 * n * h * c + n * c


def _distinct(ids: np.ndarray, num_nodes: int) -> int:
    return int(np.count_nonzero(np.bincount(ids, minlength=num_nodes)))


def spmm_counts(src: np.ndarray, dst: np.ndarray, num_nodes: int, gnn: dict) -> dict:
    """Per forward: ``{"ld": {...}, "hd": {...}}``, each with ``bytes``,
    ``flops`` and ``t_min`` (seconds) summed over both directions and
    every layer, and ``launches``, the (direction, layer) pairs that have
    such rows."""
    widths = [gnn["in_features"]] + [gnn["hidden"]] * (gnn["num_layers"] - 1)
    out = {k: {"bytes": 0, "flops": 0, "t_min": 0.0, "launches": 0} for k in ("ld", "hd")}
    for rows, cols, groups in ((dst, src, FANIN_G), (src, dst, FANOUT_G)):
        hd = np.bincount(rows, minlength=num_nodes)[rows] > E_T
        for kind, sel in (("ld", ~hd), ("hd", hd)):
            e = int(np.count_nonzero(sel))
            if e == 0:
                continue
            out_rows = _distinct(rows[sel], num_nodes)
            in_rows = _distinct(cols[sel], num_nodes)
            for f in widths:
                b = 4 * (in_rows * f + e + e * groups + out_rows * groups * f)
                fl = 2 * e * groups * f
                acc = out[kind]
                acc["bytes"] += b
                acc["flops"] += fl
                acc["t_min"] += max(b / peaks.HBM_BYTES_PER_S, fl / peaks.F32_FLOPS)
                acc["launches"] += 1
    return out


# -- the zoo's dense decoder LM (lm_serve) ----------------------------------
#
# Model FLOPs of a served batch: every matrix product of every token the
# server runs, padded prompt positions included (the server computes them),
# as 2 a multiply-add: a layer's Q, K, V and O projections and its three
# SwiGLU products; causal attention over the keys a query attends (QK^T and
# PV, 4 hd a (query, key) pair and head); the head on each prefill row's last
# position and on every decoded token.  Norms, RoPE and softmax are left out.


def lm_token_flops(model: dict) -> int:
    """The projections and FFN products of one token through every layer."""
    d, h, kv, hd, f = (model[k] for k in ("d_model", "num_heads", "num_kv_heads", "head_dim",
                                          "d_ff"))
    return model["num_layers"] * 2 * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f)


def lm_attention_flops(model: dict, pairs: int) -> int:
    return model["num_layers"] * 4 * model["num_heads"] * model["head_dim"] * pairs


def lm_batch_flops(model: dict, batch: int, prompt: int, new: int) -> int:
    """One served batch: the prefill of ``batch`` rows of ``prompt`` (padded)
    tokens, then ``new - 1`` decode steps, the step at position p attending
    the p + 1 keys written so far."""
    head = 2 * model["d_model"] * model["vocab_size"]
    prefill = (prompt * lm_token_flops(model) + head
               + lm_attention_flops(model, prompt * (prompt + 1) // 2))
    decode = sum(lm_token_flops(model) + head + lm_attention_flops(model, p + 1)
                 for p in range(prompt, prompt + new - 1))
    return batch * (prefill + decode)
