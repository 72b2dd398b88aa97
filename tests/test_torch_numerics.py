"""The numerics argument behind the tensor-core bodies (K3 and K7, K4 and
K5's MXU body), on the CPU.

The card's TF32 tensor cores see 10 explicit mantissa bits.  The kernels keep
f32 accuracy by splitting an f32 value v into hi = tf32(v) and lo =
tf32(v - hi) (``csrc/mma.cuh``: ``cvt.rna.tf32.f32``, to nearest, ties away
from zero, on the 13 dropped bits), so v = hi + lo + e with |e| <= 2^-22 |v|.

* K3 contracts each (row, G*F) aggregate a with the (G*F, H) weights W as
  three products a_hi w_hi + a_hi w_lo + a_lo w_hi; what that drops is at
  most 3 * 2^-22 (1 + 2^-10) of each |a w|, so per output
      |approx - a @ W| <= 2 * 2^-21 * sum_k |a_k w_k|.
  K7 is the same body at one group: a is one group's (row, F) aggregate.
* K4 splits each rounded product p = x * w into hi + lo and sums both with
  the exact one-hot A: per output |approx - sum p| <= 2^-21 / 2 * sum |p|.
  K5's MXU body is the same at one group.

Both are held here against an f64 product with torch's own model of the
rounding, and shown to stay under the card tests' and ``chip_smoke.py``'s
tolerance, 1e-5 * max(1, max|plain|), at the path's magnitudes: the trained
``groot_csa8.npz`` layer weights, csa features and the mean-normalised group
weights, layer by layer.  The argument has a limit: where the terms cancel
(sum |a w| >> max|out|) the bound, not the tolerance, is what holds; that
case is kept on its own.

The HD body (K2, K6) rounds as its plain versions do but adds in its own
order: a lane sums the slots of its residue class (slot mod the rows a pass
covers) in ascending order, the classes meet in a butterfly, and a row's
chunk sums are added in chunk order.  That order, emulated here on
cancelling standard-normal inputs, lands within the tolerance of the plain
versions' reshape-sums, so those need not follow it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import gnn
from repro_torch.core import pipeline as P

TOL = 1e-5
K3_BOUND = 2 * 2.0**-21   # times sum_k |a_k w_k|, per output
K4_BOUND = 2.0**-21 / 2   # times sum |p|, per output
PARAMS = Path(gnn.__file__).resolve().parents[1] / "data" / "groot_csa8.npz"


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: an f32 tensor rounded to 10 explicit mantissa
    bits, to nearest, ties away from zero (adding half of the dropped 2^13
    to the magnitude's bits carries into the kept ones)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)      # back to int32's range
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def three_term(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3's contraction: (R, K) @ (K, H) as hi*hi + hi*lo + lo*hi, the
    products of TF32 values summed exactly enough in f64."""
    ah, al = (t.double() for t in split(a))
    wh, wl = (t.double() for t in split(w))
    return ah @ wh + ah @ wl + al @ wh


def check_three_term(a: torch.Tensor, w: torch.Tensor) -> tuple[float, float]:
    """Hold the three-term contraction to its bound; returns (largest bound
    over outputs, max |a @ w|)."""
    exact = a.double() @ w.double()
    bound = K3_BOUND * (a.double().abs() @ w.double().abs())
    err = (three_term(a, w) - exact).abs()
    assert (err <= bound).all(), (err - bound).max().item()
    return bound.max().item(), exact.abs().max().item()


def _layers():
    """Per layer of the csa-16 forward (the port's reference path): the
    fanin aggregate (N, 4 * F), the (4 * F, H) fanin weights, and the
    weighted fanin messages (E, 4, F) that K4 sums."""
    prep = P.prepare(P.PipelineConfig(dataset="csa", bits=16))
    g = prep.graph
    n = g.num_nodes
    src, dst, inv, slot = gnn.graph_tensors(g, "cpu")
    wg_in, wg_out = gnn.grouped_edge_weights(src, dst, inv, slot, n)
    model = gnn.params_from_numpy(gnn.load_params(PARAMS))
    h = torch.as_tensor(prep.feats).float()
    out = []
    for layer in model.layers:
        msgs = wg_in[:, :, None] * h[src][:, None, :]                      # (E, 4, F)
        agg_in = torch.zeros((n,) + msgs.shape[1:]).index_add_(0, dst, msgs)
        agg_out = torch.zeros((n, 2, h.shape[1])).index_add_(
            0, src, wg_out[:, :, None] * h[dst][:, None, :])
        w_in = layer.stack(gnn.IN_GROUPS)                                   # (4, F, H)
        out.append((agg_in.reshape(n, -1), w_in.reshape(-1, w_in.shape[2]), msgs, dst, n))
        acc = (h @ layer.w_self + layer.b + torch.einsum("ngf,gfh->nh", agg_in, w_in)
               + torch.einsum("ngf,gfh->nh", agg_out, layer.stack(gnn.OUT_GROUPS)))
        h = torch.relu(acc)
    return out


@pytest.fixture(scope="module")
def layers():
    return _layers()


def test_tf32_model_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-11), 1.0 + 2**-12,
                      3.0e-30, -7.5e12], dtype=torch.float32)
    hi = tf32_rna(x)
    # ties (exactly half of the last kept bit) go away from zero
    assert hi[1].item() == 1.0 + 2**-10 and hi[2].item() == 1.0 + 2 * 2**-10
    assert hi[3].item() == -(1.0 + 2**-10) and hi[4].item() == 1.0
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal(10000) * 10.0 ** rng.uniform(-20, 20, 10000),
                        dtype=torch.float32)
    hi, lo = split(v)
    assert ((v.double() - hi.double()).abs() <= 2.0**-11 * v.double().abs()).all()
    assert ((v.double() - hi.double() - lo.double()).abs() <= 2.0**-22 * v.double().abs()).all()


# the grouped bodies at the fanin's four groups, the ungrouped ones at one
BODY_GROUPS = {"K3": 4, "K7": 1, "K4": 4, "K5": 1}


def _layer_bodies(grouped: str, ungrouped: str) -> list:
    """(layer, body) cases: the grouped body's keep their ids, the
    ungrouped body's add its name."""
    return ([pytest.param(i, grouped, id=str(i)) for i in range(4)]
            + [pytest.param(i, ungrouped, id=f"{i}-{ungrouped}") for i in range(4)])


@pytest.mark.parametrize("layer, body", _layer_bodies("K3", "K7"))
def test_k3_split_holds_its_bound_under_the_tolerance_at_the_path(layers, layer, body):
    agg, w, msgs, *_ = layers[layer]
    k = BODY_GROUPS[body] * msgs.shape[2]          # group-major: the first groups' columns
    worst, scale = check_three_term(agg[:, :k], w[:k])
    assert worst <= TOL * max(1.0, scale), (worst, scale)


@pytest.mark.parametrize("layer, body", _layer_bodies("K4", "K5"))
def test_k4_split_holds_its_bound_under_the_tolerance_at_the_path(layers, layer, body):
    *_, msgs, dst, n = layers[layer]
    p = msgs[:, :BODY_GROUPS[body]].float()             # x * w rounded to f32, as K4 takes it
    hi, lo = split(p)
    exact = torch.zeros((n,) + p.shape[1:], dtype=torch.float64).index_add_(0, dst, p.double())
    approx = torch.zeros_like(exact).index_add_(0, dst, hi.double() + lo.double())
    bound = K4_BOUND * torch.zeros_like(exact).index_add_(0, dst, p.double().abs())
    assert ((approx - exact).abs() <= bound).all()
    assert bound.max().item() <= TOL * max(1.0, exact.abs().max().item())


@pytest.mark.parametrize("k", [16, 128, 512])
def test_k3_split_bound_over_wide_range_and_mixed_signs(k):
    rng = np.random.default_rng(k)
    mag = lambda shape: 10.0 ** rng.uniform(-6, 6, shape) * rng.choice([-1.0, 1.0], shape)
    a = torch.as_tensor(mag((64, k)), dtype=torch.float32)
    w = torch.as_tensor(mag((k, 32)), dtype=torch.float32)
    check_three_term(a, w)


def test_k3_split_under_heavy_cancellation_holds_the_bound_not_the_tolerance():
    """W's columns in the null space of the aggregate rows: every output
    cancels to the f32 rounding of W, sum |a w| is 10^3 times |out| and
    more, and the split's bound lies past the tolerance, so only the bound
    is asserted.  The path's weights do not do this (the tests above); a
    layer that did would need the plain version's f32 contraction."""
    rng = np.random.default_rng(1)
    a = rng.uniform(50.0, 150.0, (64, 128))
    null = np.linalg.svd(a)[2][64:96].T                       # (128, 32): a @ null = 0
    a, w = (torch.as_tensor(t, dtype=torch.float32) for t in (a, null))
    exact = a.double() @ w.double()
    terms = a.double().abs() @ w.double().abs()
    assert (terms / exact.abs()).min() > 1e3
    worst, scale = check_three_term(a, w)
    assert worst > TOL * max(1.0, scale)


def hd_body_order(x, w, chunk_rows, n_hd, at_once, fused):
    """The HD body's sums of (C, e_t, F) messages x and (C, e_t, G)
    weights w (f32): per chunk, lane class r (slots r, r + at_once, ...)
    added in ascending order (``fused``: K2's fmaf, else K6's product
    rounded to f32 first), the classes combined by a butterfly (r + (r ^ b)
    for b = 1, 2, 4, ...), then each row's chunk sums in chunk order.
    -> (G, n_hd, F) f32."""
    c, e_t, f = x.shape
    pad = -e_t % at_once
    x = torch.cat([x, x.new_zeros((c, pad, f))], 1).reshape(c, -1, at_once, 1, f)
    w = torch.cat([w, w.new_zeros((c, pad, w.shape[2]))], 1).reshape(c, -1, at_once,
                                                                     w.shape[2], 1)
    acc = torch.zeros((c, at_once, w.shape[3], f), dtype=torch.float32)
    for k in range(x.shape[1]):
        if fused:  # fmaf: the product exact in f64, one rounding
            acc = (acc.double() + w[:, k].double() * x[:, k].double()).float()
        else:
            acc = acc + w[:, k] * x[:, k]
    b = 1
    while b < at_once:
        acc = acc + acc[:, torch.arange(at_once) ^ b]
        b <<= 1
    out = torch.zeros((acc.shape[2], n_hd, f))
    seen = set()
    for ci, r in enumerate(chunk_rows.tolist()):
        out[:, r] = acc[ci, 0] if r not in seen else out[:, r] + acc[ci, 0]
        seen.add(r)
    return out


@pytest.mark.parametrize("body", ["K2", "K6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat", [4, 32])
@pytest.mark.parametrize("e_t", [16, 64, 512])
def test_hd_body_order_stays_within_the_tolerance_of_the_plain_versions(e_t, feat, dtype, body):
    from repro_torch.kernels import groot_spmm as gs

    rng = np.random.default_rng(e_t + feat)
    n, n_hd = 3000, 40
    deg = rng.integers(e_t + 1, 5 * e_t, n_hd)
    deg[deg % e_t == 0] -= 1
    dst = np.repeat(np.arange(n_hd), deg)
    plan = gs.build_plan(rng.integers(0, n, dst.shape[0]), dst, n, e_t=e_t)
    groups = 2 if body == "K2" else 1
    x_p = gs.pad_features(torch.as_tensor(rng.standard_normal((n, feat)),
                                          dtype=torch.float32)).to(dtype)
    w = torch.as_tensor(rng.standard_normal((plan.hd.cols.shape[0], groups)),
                        dtype=torch.float32).to(dtype)
    cols, meta = torch.as_tensor(plan.hd.cols), torch.as_tensor(plan.hd.chunk_meta)
    # the lanes a staged row of F (16 bytes each) and the rows a pass covers
    at_once = 32 // max(1, feat * x_p.element_size() // 16)
    if body == "K2":
        plain = gs.hd_grouped_plain(x_p, cols, w, meta, n_hd, e_t)
        msgs, ws = x_p[cols.long()].float(), w.float()
    else:
        plain = gs.hd_plain(x_p, cols, meta, e_t, w[:, 0])[None]
        msgs, ws = gs.weighted_msgs(x_p, cols, w[:, 0]).float(), torch.ones_like(w.float())
    got = hd_body_order(msgs.reshape(-1, e_t, feat), ws.reshape(-1, e_t, groups),
                        meta[:, 0], n_hd, at_once, fused=body == "K2")
    assert (got - plain).abs().max().item() <= TOL * max(1.0, plain.abs().max().item())
