"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and skips
without one.  The file imports nothing of JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels and their plain versions round each message-weight product the
same way (K1-K3 widen bf16 inputs to f32 exactly; K4-K7 round the product to
the stream dtype) and accumulate in f32, so only the order of the sums
differs (K5's VPU body and K7 add a row's slots in the order their plain
version does), plus what the TF32 splits drop: K4's and K5's MXU two-term
split of an f32 product at most 2^-22 of it, K3's and K7's three-term
contraction at most 2 * 2^-21 of each aggregate-weight product
(tests/test_torch_numerics.py): a tolerance of 1e-5 relative to
max(1, max|plain|) holds for f32 and bf16 streams alike.

K8 (flash attention) and its plain version round at the same points (f32
scores, p rounded to the stream dtype, f32 accumulator) and walk the same
key tiles (``fa.key_tile``: 64 keys on the f32 mma_sync body, 128 on the
bf16 wgmma body, 64 there at hd 256); the kernel's f32 products run as
three TF32 MMAs (what the split drops is under 2 * 2^-21 of each product), and
exp, tanh and the sums run in other orders.  f32: within 5e-5 of max(1, max|plain|).  bf16: within
2^-7 of max(1, max|plain|), since the f32 scores differ in their last bits
and now and then the two round a p to neighbouring bf16 values, which moves
that row's outputs by up to 2^-8 * p * |v| / l; and at most 2^-4 of the
outputs may differ from the plain version's (both round the same f32 output
once), which a rounding fault such as a truncated p or output exceeds.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Session  # noqa: E402
from repro_torch.core import gnn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_sage as fs  # noqa: E402
from repro_torch.kernels import groot_spmm as gs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 1e-5
FLASH_TOL = {torch.float32: 5e-5, torch.bfloat16: 2**-7}
FLASH_OFF_SHARE = 2**-4

# (query rows BH, KV rows, S, T, hd, causal, window, softcap)
FLASH_CASES = [
    (4, 4, 256, 256, 64, True, 0, 0.0),
    (8, 2, 300, 300, 128, True, 100, 0.0),     # ragged S/T, window, GQA
    (4, 4, 128, 512, 128, True, 0, 0.0),       # cross-length (q short)
    (4, 2, 1000, 1000, 128, True, 0, 0.0),     # ragged causal
    (2, 1, 384, 384, 256, True, 128, 50.0),    # gemma2 local: hd 256, window, softcap
    (2, 2, 256, 256, 64, False, 0, 0.0),       # bidirectional
    (2, 1, 200, 200, 256, False, 0, 20.0),     # bidirectional, ragged T, softcap
]

# the bf16 wgmma body's edges: (query rows BH, KV rows, S, T, hd, causal,
# window, softcap)
WGMMA_CASES = [
    (8, 2, 4000, 200, 128, True, 0, 0.0),      # ragged S and T, GQA G=4, S > T
    (8, 2, 1000, 1000, 128, True, 300, 0.0),   # a window that ends inside a tile
    (4, 1, 512, 512, 64, True, 0, 30.0),       # softcap, GQA G=4, hd 64
    (4, 4, 512, 512, 64, False, 0, 0.0),       # bidirectional, hd 64
    (4, 1, 300, 1000, 128, False, 0, 0.0),     # bidirectional, ragged T, S != T
    (4, 2, 80, 80, 128, True, 0, 0.0),         # S < 128
    (2, 1, 100, 100, 256, True, 0, 0.0),       # S < 128, hd 256
    (2, 2, 640, 640, 256, False, 0, 20.0),     # bidirectional, softcap, hd 256
    (2, 1, 1000, 1000, 256, True, 200, 50.0),  # gemma2 local, ragged
]

# degree mixtures (n, e_t, hd_frac, scale, seed): LD only, HD past a small
# threshold, deep LD buckets + HD rows at the real threshold, HD-heavy
MIXTURES = [
    (60, 512, 0.0, 1, 0),
    (150, 64, 0.05, 1, 1),
    (90, 512, 0.03, 20, 2),
    (40, 16, 0.4, 1, 3),
]


def _graph(case):
    n, e_t, hd_frac, scale, seed = case
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.geometric(p=0.35, size=n) - 1) * scale, 4 * e_t)
    hd_rows = rng.random(n) < hd_frac
    deg[hd_rows] += rng.integers(e_t + 1, 3 * e_t + 1, size=int(hd_rows.sum()))
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    src = rng.integers(0, n, dst.shape[0], dtype=np.int64)
    perm = rng.permutation(dst.shape[0])
    return src[perm], dst[perm], n, e_t


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    scale = max(1.0, want.abs().max().item())
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("case", MIXTURES)
def test_kernels_match_plain_versions(cuda, case, groups, dtype):
    src, dst, n, e_t = _graph(case)
    plan = gs.build_plan(src, dst, n, e_t=e_t)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((n, 32)), dtype=torch.float32, device=cuda)
    x_p = gs.pad_features(x).to(dtype)
    wg = torch.as_tensor(rng.random((len(src), groups)), dtype=torch.float32, device=cuda)
    staged = gs.stage_group_weights(plan, wg, dtype=dtype)
    w_stack = torch.as_tensor(rng.standard_normal((groups, 32, 24)), dtype=torch.float32,
                              device=cuda)
    w_mat = w_stack[0].contiguous()
    dp = plan.on(cuda)
    for b, cols, wge in zip(plan.buckets, dp.cols, staged.buckets):
        before = gs.ld_grouped_apply.launches
        _close(gs.ld_grouped_apply(x_p, cols, wge, b.deg),
               gs.ld_grouped_plain(x_p, cols, wge, b.deg))
        assert gs.ld_grouped_apply.launches == before + 1
        _close(fs.fused_ld_matmul_grouped(x_p, cols, wge, w_stack, b.deg),
               fs.fused_ld_grouped_plain(x_p, cols, wge, w_stack, b.deg))
        before = gs.ld_grouped_mxu_apply.launches
        _close(gs.ld_grouped_mxu_apply(x_p, cols, wge, b.deg),
               gs.ld_grouped_mxu_plain(x_p, cols, wge, b.deg))
        assert gs.ld_grouped_mxu_apply.launches == before + 1
        for w in (None, wge[:, 0].contiguous()):
            for mxu in (False, True):
                _close(gs.ld_bucket_apply(x_p, cols, b.deg, w, mxu=mxu),
                       gs.ld_bucket_plain(x_p, cols, b.deg, w))
            _close(fs.fused_ld_matmul(x_p, cols, w_mat, b.deg, w),
                   fs.fused_ld_plain(x_p, cols, w_mat, b.deg, w))
    if plan.hd is not None:
        n_hd = plan.hd.rows.shape[0]
        _close(gs.hd_grouped_apply(x_p, dp.hd_cols, staged.hd, dp.hd_meta, dp.hd_row_chunks, e_t),
               gs.hd_grouped_plain(x_p, dp.hd_cols, staged.hd, dp.hd_meta, n_hd, e_t))
        for w in (None, staged.hd[:, 0].contiguous()):
            _close(gs.hd_apply(x_p, dp.hd_cols, dp.hd_meta, dp.hd_row_chunks, e_t, w),
                   gs.hd_plain(x_p, dp.hd_cols, dp.hd_meta, e_t, w))


# The staged bodies (K3, K4, K5's two, K7) at their edges: row counts around
# the 16-row tile and K3's and K7's 64-row warpgroup tile, and walks long
# enough that every warp of the persistent grid takes several tiles, except
# at degrees 64 and 512, where the plain versions' (G, R * deg, F) products
# would grow large.  Widths the bodies are built for (4, 8, 16, 32), ones
# they pad (1, 24) and ones they slice (48, 64).
EDGE_ROWS = {1: (1, 15, 63, 65, 64 * 37 + 1, 64 * 1500 + 1),
             2: (1, 15, 63, 65, 64 * 37 + 1, 64 * 1500 + 1),
             4: (1, 15, 63, 65, 64 * 9 + 1, 64 * 1500 + 1), 64: (1, 15, 65, 64 * 9 + 1),
             512: (1, 15, 65)}
EDGE_FEATS = (1, 4, 8, 16, 24, 32, 48, 64)
EDGE_HIDS = (8, 24, 32, 40, 64)


def _into_slice(run, shape, rows):
    """``run(out)`` into a row slice of a larger buffer (the last axis but
    one is rows), asserting that the other rows stay as they were."""
    big = torch.full(shape[:-1] + (rows + 7, shape[-1]), 7.0, device="cuda")
    got = run(big[..., 3:3 + rows, :])
    assert (big[..., :3, :] == 7.0).all() and (big[..., 3 + rows:, :] == 7.0).all()
    return got


@pytest.mark.parametrize("deg", sorted(EDGE_ROWS))
@pytest.mark.parametrize("feat", EDGE_FEATS)
@pytest.mark.parametrize("groups", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_bodies_at_their_edges(cuda, dtype, groups, feat, deg):
    """K3 (every H of EDGE_HIDS) and K4 (degree > 1) against their plain
    versions, and at one group K1, K5 (VPU body; MXU body at degree > 1) and
    K7 (every H), with and without a weight, each launch counted (one a
    32-column slice), written into a row slice of a larger buffer whose
    other rows stay as they were.  At degree 512 a tile's 8,192 slots span
    256 ring stages."""
    rng = np.random.default_rng(groups * 1000 + feat * 10 + deg)
    n = 3000
    x = torch.as_tensor(rng.standard_normal((n, feat)), dtype=torch.float32, device=cuda)
    x_p = gs.pad_features(x).to(dtype)
    slices = len(gs.staged_slices(feat)[1])
    rows_list = EDGE_ROWS[deg] if feat in (4, 32) else EDGE_ROWS[deg][:-1]
    for rows in rows_list:
        slots = rows * deg
        # some slots hit the zero pad row n, as a bucket's padding does
        cols = torch.as_tensor(rng.integers(0, n + 1, slots), dtype=torch.int32, device=cuda)
        wg = torch.as_tensor(rng.standard_normal((slots, groups)), dtype=torch.float32,
                             device=cuda).to(dtype)
        for hid in EDGE_HIDS:
            w_stack = torch.as_tensor(rng.standard_normal((groups, feat, hid)),
                                      dtype=torch.float32, device=cuda)
            before = fs.fused_ld_matmul_grouped.launches
            got = _into_slice(lambda o: fs.fused_ld_matmul_grouped(x_p, cols, wg, w_stack, deg,
                                                                   out=o), (hid,), rows)
            assert fs.fused_ld_matmul_grouped.launches == before + slices
            _close(got, fs.fused_ld_grouped_plain(x_p, cols, wg, w_stack, deg))
            if groups == 1:
                for w in (wg[:, 0].contiguous(), None):
                    before = fs.fused_ld_matmul.launches
                    got = _into_slice(lambda o: fs.fused_ld_matmul(x_p, cols, w_stack[0], deg, w,
                                                                   out=o), (hid,), rows)
                    assert fs.fused_ld_matmul.launches == before + slices
                    _close(got, fs.fused_ld_plain(x_p, cols, w_stack[0], deg, w))
        if deg > 1:
            before = gs.ld_grouped_mxu_apply.launches
            got = _into_slice(lambda o: gs.ld_grouped_apply(x_p, cols, wg, deg, out=o, mxu=True),
                              (groups, feat), rows)
            assert gs.ld_grouped_mxu_apply.launches == before + slices
            _close(got, gs.ld_grouped_mxu_plain(x_p, cols, wg, deg))
        if groups == 1:
            before = gs.ld_grouped_apply.launches
            got = _into_slice(lambda o: gs.ld_grouped_apply(x_p, cols, wg, deg, out=o),
                              (1, feat), rows)
            assert gs.ld_grouped_apply.launches == before + slices
            _close(got, gs.ld_grouped_plain(x_p, cols, wg, deg))
            for w in (wg[:, 0].contiguous(), None):
                for mxu in (False, True):
                    body = "mxu" if mxu and deg > 1 else "vpu"
                    before = dict(gs.ld_bucket_apply.body_launches)
                    got = _into_slice(lambda o: gs.ld_bucket_apply(x_p, cols, deg, w, mxu=mxu,
                                                                   out=o), (feat,), rows)
                    assert gs.ld_bucket_apply.body_launches == {
                        **before, body: before[body] + slices}
                    _close(got, gs.ld_bucket_plain(x_p, cols, deg, w))


def test_staged_bodies_refuse_what_they_cannot_take(cuda):
    """The staged bodies raise on a CUDA shape none of them takes (a
    degree that is not a power of two, an input off a 16-byte boundary)
    rather than run the plain version, and take every width and H: here
    F = 12, H = 20, and K3's and K7's W too wide for one block's shared
    memory, which runs in blocks of its columns."""
    x_p = torch.zeros((11, 32), device=cuda)
    cols = torch.zeros(30, dtype=torch.int32, device=cuda)
    wg = torch.ones((30, 2), device=cuda)
    w_stack = torch.ones((2, 32, 32), device=cuda)
    with pytest.raises(ValueError, match="power of two"):
        fs.fused_ld_matmul_grouped(x_p, cols, wg, w_stack, 3)
    with pytest.raises(ValueError, match="power of two"):
        gs.ld_grouped_mxu_apply(x_p, cols, wg, 3)
    with pytest.raises(ValueError, match="power of two"):
        gs.ld_bucket_apply(x_p, cols, 3)
    with pytest.raises(ValueError, match="power of two"):
        fs.fused_ld_matmul(x_p, cols, w_stack[0], 3)
    off = torch.zeros(11 * 32 + 1, device=cuda)[1:].view(11, 32)
    with pytest.raises(ValueError, match="16-byte"):
        gs.ld_grouped_mxu_apply(off, cols, wg, 2)
    with pytest.raises(ValueError, match="16-byte"):
        gs.ld_bucket_apply(off, cols, 2)
    with pytest.raises(ValueError, match="16-byte"):
        gs.ld_bucket_apply(x_p, torch.zeros(31, dtype=torch.int32, device=cuda)[1:], 2)
    x12 = torch.ones((11, 12), device=cuda)
    _close(gs.ld_grouped_mxu_apply(x12, cols, wg, 2), gs.ld_grouped_mxu_plain(x12, cols, wg, 2))
    w20 = torch.ones((2, 12, 20), device=cuda)
    _close(fs.fused_ld_matmul_grouped(x12, cols, wg, w20, 2),
           fs.fused_ld_grouped_plain(x12, cols, wg, w20, 2))
    gen = torch.Generator(cuda).manual_seed(0)
    xr = torch.randn((11, 32), generator=gen, device=cuda)
    colr = torch.randint(0, 11, (30,), generator=gen, device=cuda, dtype=torch.int32)
    wide = torch.randn((2, 32, 1000), generator=gen, device=cuda)
    before = fs.fused_ld_matmul_grouped.launches
    _close(fs.fused_ld_matmul_grouped(xr, colr, wg, wide, 2),
           fs.fused_ld_grouped_plain(xr, colr, wg, wide, 2))
    assert fs.fused_ld_matmul_grouped.launches - before > 1
    before = fs.fused_ld_matmul.launches
    _close(fs.fused_ld_matmul(xr, colr, wide[0], 2), fs.fused_ld_plain(xr, colr, wide[0], 2))
    assert fs.fused_ld_matmul.launches - before > 1


# The HD body (K2 and K6) at its edges: chunks of 16, 64 and 512 slots, rows
# of 2 to 5 chunks whose last chunk is ragged (padded with the zero row),
# widths it reads whole (4, 8, 32), pads in the kernel (1, 24) or slices
# (64).
HD_E_T = (16, 64, 512)
HD_FEATS = (1, 4, 8, 24, 32, 64)


def _hd_plan(e_t: int, seed: int):
    """A plan whose HD rows have 2 to 5 chunks, the last one ragged, beside
    a few LD rows; x's rows (3000 nodes) are the gather's sources."""
    rng = np.random.default_rng(seed)
    n, n_hd = 3000, 13
    deg = rng.integers(e_t + 1, 5 * e_t, n_hd)
    deg[deg % e_t == 0] -= 1
    deg[:4] = (2 * e_t - 1, 2 * e_t + 1, 5 * e_t - 1, 3 * e_t + 5)
    deg = np.concatenate([deg, rng.integers(1, 4, 20)])
    dst = np.repeat(np.arange(deg.shape[0], dtype=np.int64), deg)
    src = rng.integers(0, n, dst.shape[0], dtype=np.int64)
    plan = gs.build_plan(src, dst, n, e_t=e_t)
    counts = plan.hd.row_chunks()[:, 1]
    assert plan.hd.rows.shape[0] == n_hd and counts.min() == 2 and counts.max() == 5
    return plan, src.shape[0], n


@pytest.mark.parametrize("feat", HD_FEATS)
@pytest.mark.parametrize("groups", [1, 2, 3, 4])
@pytest.mark.parametrize("e_t", HD_E_T)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hd_body_at_its_edges(cuda, dtype, e_t, groups, feat):
    """K2 against hd_grouped_plain into a group-strided slice of a larger
    buffer (as apply_plan_grouped_staged passes it), and at one group K6
    against hd_plain with and without a weight into a row slice; each
    launch counted (one a 32-column slice), the other rows left as they
    were.  Weights are standard normal, so the sums cancel."""
    plan, n_edges, n = _hd_plan(e_t, e_t + 10 * groups + feat)
    rng = np.random.default_rng(feat * 100 + groups)
    x = torch.as_tensor(rng.standard_normal((n, feat)), dtype=torch.float32, device=cuda)
    x_p = gs.pad_features(x).to(dtype)
    wg = torch.as_tensor(rng.standard_normal((n_edges, groups)), dtype=torch.float32, device=cuda)
    staged = gs.stage_group_weights(plan, wg, dtype=dtype)
    dp = plan.on(cuda)
    n_hd, slices = plan.hd.rows.shape[0], len(gs.staged_slices(feat)[1])
    before = gs.hd_grouped_apply.launches
    got = _into_slice(lambda o: gs.hd_grouped_apply(x_p, dp.hd_cols, staged.hd, dp.hd_meta,
                                                    dp.hd_row_chunks, e_t, out=o),
                      (groups, feat), n_hd)
    assert gs.hd_grouped_apply.launches == before + slices
    _close(got, gs.hd_grouped_plain(x_p, dp.hd_cols, staged.hd, dp.hd_meta, n_hd, e_t))
    if groups == 1:
        for w in (staged.hd[:, 0].contiguous(), None):
            before = gs.hd_apply.launches
            got = _into_slice(lambda o: gs.hd_apply(x_p, dp.hd_cols, dp.hd_meta, dp.hd_row_chunks,
                                                    e_t, w, out=o), (feat,), n_hd)
            assert gs.hd_apply.launches == before + slices
            _close(got, gs.hd_plain(x_p, dp.hd_cols, dp.hd_meta, e_t, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat", [4, 32, 64])
def test_hd_body_is_deterministic(cuda, feat, dtype):
    """Two launches on the same inputs give the same bits: the chunk sums
    and each row's combine add in a fixed order, with no float atomics."""
    plan, n_edges, n = _hd_plan(512, 5)
    rng = np.random.default_rng(feat)
    x_p = gs.pad_features(torch.as_tensor(rng.standard_normal((n, feat)), dtype=torch.float32,
                                          device=cuda)).to(dtype)
    wg = torch.as_tensor(rng.standard_normal((n_edges, 2)), dtype=torch.float32, device=cuda)
    staged = gs.stage_group_weights(plan, wg, dtype=dtype)
    dp = plan.on(cuda)
    runs = [gs.hd_grouped_apply(x_p, dp.hd_cols, staged.hd, dp.hd_meta, dp.hd_row_chunks, 512)
            for _ in range(2)]
    w = staged.hd[:, 0].contiguous()
    runs += [gs.hd_apply(x_p, dp.hd_cols, dp.hd_meta, dp.hd_row_chunks, 512, w) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[2], runs[3])


def test_hd_body_refuses_what_it_cannot_take(cuda):
    """K2 and K6 raise on a CUDA shape the body does not take (chunks of
    slots not a multiple of 8, a stream off a 16-byte boundary) and, as
    before, on chunk tables that do not fit the slots, mixed dtypes, more
    than 4 groups and a malformed output, rather than run the plain
    version."""
    plan, n_edges, n = _hd_plan(64, 1)
    dp = plan.on(cuda)
    x_p = torch.zeros((n + 1, 32), device=cuda)
    wg = torch.ones((dp.hd_cols.shape[0], 2), device=cuda)
    meta, rc = dp.hd_meta, dp.hd_row_chunks
    n_hd = rc.shape[0]
    with pytest.raises(ValueError, match="multiple of 8"):
        gs.hd_grouped_apply(x_p, dp.hd_cols[:-4 * meta.shape[0]], wg[:-4 * meta.shape[0]],
                            meta, rc, 60)
    with pytest.raises(ValueError, match="multiple of 8"):
        gs.hd_apply(x_p, dp.hd_cols[:-4 * meta.shape[0]], meta, rc, 60)
    off = torch.zeros(dp.hd_cols.shape[0] + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        gs.hd_grouped_apply(x_p, off, wg, meta, rc, 64)
    with pytest.raises(ValueError, match="16-byte"):
        gs.hd_apply(x_p, dp.hd_cols, meta, rc, 64,
                    torch.ones(dp.hd_cols.shape[0] + 1, device=cuda)[1:])
    with pytest.raises(ValueError, match="chunks"):
        gs.hd_grouped_apply(x_p, dp.hd_cols[:-1], wg[:-1], meta, rc, 64)
    with pytest.raises(ValueError, match="chunks"):
        gs.hd_apply(x_p, dp.hd_cols[:-1], meta, rc, 64)
    with pytest.raises(ValueError, match="share dtype"):
        gs.hd_grouped_apply(x_p, dp.hd_cols, wg.bfloat16(), meta, rc, 64)
    with pytest.raises(ValueError, match="1 to 4 groups"):
        gs.hd_grouped_apply(x_p, dp.hd_cols, torch.ones((wg.shape[0], 5), device=cuda), meta,
                            rc, 64)
    with pytest.raises(ValueError, match="out must be"):
        gs.hd_grouped_apply(x_p, dp.hd_cols, wg, meta, rc, 64,
                            out=torch.empty((2, n_hd, 16), device=cuda))
    with pytest.raises(ValueError, match="out must be"):
        gs.hd_apply(x_p, dp.hd_cols, meta, rc, 64,
                    out=torch.empty((n_hd, 64), device=cuda)[:, :32])


def _random_params(hidden: int, seed: int) -> dict:
    """A GNNConfig(hidden=hidden) params tree from a seeded numpy generator,
    each matrix scaled by 1 / sqrt(its fan-in)."""
    rng = np.random.default_rng(seed)
    cfg = gnn.GNNConfig(hidden=hidden)
    dims = [cfg.in_features] + [hidden] * cfg.num_layers

    def mat(a, b):
        return (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)

    return {"layers": [{**{nm: mat(a, b) for nm in gnn.LAYER_WEIGHTS},
                        "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
                       for a, b in zip(dims, dims[1:])],
            "head": {"w": mat(hidden, cfg.num_classes),
                     "b": np.zeros(cfg.num_classes, np.float32)}}


@pytest.mark.parametrize("hidden", [24, 64])
def test_session_at_other_hidden_widths_matches_ref(cuda, hidden):
    """groot_fused and groot_mxu run a hidden width the staged bodies pad
    (24) or slice (64) on the card and give ref's verdict and predictions
    on the same params."""
    params = gnn.params_from_numpy(_random_params(hidden, hidden), device=cuda)
    want = Session(params, backend="ref").verify(dataset="csa", bits=16,
                                                 return_predictions=True)
    for backend, kernel in (("groot_fused", fs.fused_ld_matmul_grouped),
                            ("groot_mxu", gs.ld_grouped_mxu_apply)):
        before = kernel.launches
        got = Session(params, backend=backend).verify(dataset="csa", bits=16,
                                                      return_predictions=True)
        assert kernel.launches > before
        assert got.verdict == want.verdict
        np.testing.assert_array_equal(got.predictions, want.predictions)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_matches_plain_version(cuda, case, dtype):
    bh, bh_kv, s, t, hd, causal, window, cap = case
    rng = np.random.default_rng(bh * s + hd)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32).to(cuda, dtype)
               for shape in ((bh, s, hd), (bh_kv, t, hd), (bh_kv, t, hd)))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window, softcap=cap, kv_block=t)
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_plain(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape and torch.isfinite(got).all()
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= FLASH_TOL[dtype] * scale
    if dtype == torch.bfloat16:
        assert (got != want).float().mean().item() <= FLASH_OFF_SHARE


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_wgmma_body_matches_plain_version(cuda, case):
    """bf16 runs the wgmma body, held against flash_plain at that body's key
    tile with the limits of test_flash_matches_plain_version."""
    bh, bh_kv, s, t, hd, causal, window, cap = case
    assert fa.BODIES[(torch.bfloat16, hd)] == "wgmma"
    rng = np.random.default_rng(bh * s + t + hd)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
               .to(cuda, torch.bfloat16)
               for shape in ((bh, s, hd), (bh_kv, t, hd), (bh_kv, t, hd)))
    before = dict(fa.flash_attention.body_launches)
    got = fa.flash_attention(q, k, v, causal=causal, window=window, softcap=cap, kv_block=t)
    assert fa.flash_attention.body_launches == {**before, "wgmma": before["wgmma"] + 1}
    want = fa.flash_plain(q, k, v, causal=causal, window=window, softcap=cap,
                          kv_tile=fa.key_tile(torch.bfloat16, hd))
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= FLASH_TOL[torch.bfloat16] * scale
    assert (got != want).float().mean().item() <= FLASH_OFF_SHARE


def test_flash_custom_op_matches_plain_version(cuda):
    """K8 called through its custom op, ``torch.ops.repro_torch.flash_attention``
    (what the wrapper launches and the dry run traces), at a prefill shape
    (32 query heads over 8 KV heads, S = T = 1024, causal, bf16): equal to
    the plain version within the wrapper's limits, one launch a call, no
    call counted as traced."""
    rng = np.random.default_rng(1024)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
               .to(cuda, torch.bfloat16)
               for shape in ((32, 1024, 128), (8, 1024, 128), (8, 1024, 128)))
    before, traced = fa.flash_attention.launches, fa.flash_attention.traced
    got = torch.ops.repro_torch.flash_attention(q, k, v, True, 0, 128**-0.5, 0.0)
    again = fa.flash_attention(q, k, v, causal=True, kv_block=1024)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert fa.flash_attention.traced == traced
    want = fa.flash_plain(q, k, v, causal=True)
    scale = max(1.0, want.float().abs().max().item())
    assert torch.equal(got, again)
    assert (got.float() - want.float()).abs().max().item() <= FLASH_TOL[torch.bfloat16] * scale
    assert (got != want).float().mean().item() <= FLASH_OFF_SHARE


def test_flash_bodies_by_dtype(cuda):
    """Every bf16 call at hd 64 and 128 launches the wgmma body, every f32
    call the mma_sync body."""
    before = dict(fa.flash_attention.body_launches)
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (64, 128):
            q = torch.randn((2, 200, hd), device=cuda).to(dtype)
            fa.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert fa.flash_attention.body_launches == {
        "wgmma": before["wgmma"] + 2, "mma_sync": before["mma_sync"] + 2}


def test_attention_at_qwen3_width_through_k8(cuda, monkeypatch):
    """One qwen3-8b layer's attention (32 query heads over 8 KV heads, hd
    128, qk-norm), f32, past FLASH_THRESHOLD: K8 against the model's plain
    schedule (threshold raised), within 1e-4 of max(1, max|plain|)."""
    from repro_torch.zoo.configs import get_config
    from repro_torch.zoo.configs import base
    from repro_torch.zoo.models import attention as A

    cfg = get_config("qwen3-8b")
    gen = torch.Generator(cuda).manual_seed(0)
    p = base.materialize(base.param_tree(cfg)["layers"][0]["attn"], gen)
    s = 2100  # s * s just past FLASH_THRESHOLD; 33 query tiles, the last ragged
    x = torch.randn((1, s, cfg.d_model), generator=gen, device=cuda)
    before = fa.flash_attention.launches
    got, _ = A.attention(x, p, cfg)
    assert fa.flash_attention.launches == before + 1
    monkeypatch.setattr(A, "FLASH_THRESHOLD", s * s)
    want, _ = A.attention(x, p, cfg)
    assert fa.flash_attention.launches == before + 1
    torch.cuda.synchronize()
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-4 * scale


def test_cuda_wrappers_never_run_the_plain_versions(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    for mod, name in ((gs, "ld_grouped_plain"), (gs, "hd_grouped_plain"),
                      (gs, "ld_grouped_mxu_plain"), (gs, "ld_bucket_plain"), (gs, "hd_plain"),
                      (fs, "fused_ld_grouped_plain"), (fs, "fused_ld_plain"),
                      (fa, "flash_plain")):
        monkeypatch.setattr(mod, name, boom)
    q = torch.randn((4, 80, 64), device=cuda)
    assert torch.isfinite(fa.flash_attention(q, q[:2], q[:2], window=16)).all()
    src, dst, n, e_t = _graph(MIXTURES[2])
    plan = gs.build_plan(src, dst, n, e_t=e_t)
    x = torch.randn((n, 8), device=cuda)
    wg = torch.rand((len(src), 4), device=cuda)
    for mxu in (False, True):
        out = gs.apply_plan_grouped(plan, x, wg, mxu=mxu)
        assert out.shape == (4, n, 8) and torch.isfinite(out).all()
        for w in (None, wg[:, 0]):
            out = gs.apply_plan(plan, x, w, mxu=mxu)
            assert out.shape == (n, 8) and torch.isfinite(out).all()
    out = ops._apply_plan_fused(plan, x, wg[:, 0], torch.randn((8, 16), device=cuda))
    assert out.shape == (n, 16) and torch.isfinite(out).all()
    # "cuda" and the tensors' "cuda:<n>" share one device copy of the plan
    assert plan.on("cuda") is plan.on(x.device)
    assert len(plan._device) == 1


def test_session_on_card_matches_cpu(cuda):
    params = gnn.load_params(Path(gs.__file__).resolve().parents[1] / "data" / "groot_csa8.npz")
    for backend in ("onehot", "groot", "groot_mxu", "groot_fused"):
        on_card = Session(params, backend=backend).verify(
            dataset="csa", bits=16, return_predictions=True)
        on_cpu = Session(params, backend=backend, device="cpu").verify(
            dataset="csa", bits=16, return_predictions=True)
        np.testing.assert_array_equal(on_card.predictions, on_cpu.predictions)
        assert on_card.verdict == on_cpu.verdict


NPZ = Path(gs.__file__).resolve().parents[1] / "data" / "groot_csa8.npz"


@pytest.mark.parametrize("bits", [32, 64])
def test_partitioned_loop_on_card_matches_cpu(cuda, bits):
    """The partitioned route (``streaming=False``, k=4, one partitioning)
    on the card gives the CPU run's predictions and verdict, launching the
    grouped kernels on the partitions."""
    params = gnn.load_params(NPZ)
    kw = dict(streaming=False, num_partitions=4)
    prep = Session(device="cpu", **kw).prepare(dataset="csa", bits=bits)
    for backend, kernel in (("groot", gs.ld_grouped_apply),
                            ("groot_fused", fs.fused_ld_matmul_grouped),
                            ("groot_mxu", gs.ld_grouped_mxu_apply)):
        before = kernel.launches
        on_card = Session(params, backend=backend, **kw).verify(
            prepared=prep, return_predictions=True)
        assert kernel.launches > before, backend
        on_cpu = Session(params, backend=backend, device="cpu", **kw).verify(
            prepared=prep, return_predictions=True)
        assert on_card.routing.mode == "partitioned"
        np.testing.assert_array_equal(on_card.predictions, on_cpu.predictions, err_msg=backend)
        assert on_card.verdict == on_cpu.verdict


@pytest.mark.parametrize("backend", ["groot", "groot_mxu", "groot_fused"])
def test_partitioned_loop_peak_is_one_partitions(cuda, backend):
    """Over k=8 partitions of csa-128 the loop's device peak is no higher
    than the largest partition's run alone (margin 1%: the same allocations
    in the same order, rounded to the allocator's blocks), and no partition
    leaves bytes allocated behind it."""
    params = gnn.params_from_numpy(gnn.load_params(NPZ), device=cuda)
    prep = Session(device="cpu", streaming=False, num_partitions=8).prepare(
        dataset="csa", bits=128)

    def peak(subgraphs):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        left = []
        gnn.predict_partitioned_loop(
            params, subgraphs, prep.feats, prep.num_nodes, backend, device=cuda,
            on_partition=lambda i, sg: left.append(torch.cuda.memory_allocated() - base))
        return torch.cuda.max_memory_allocated() - base, left

    peak(prep.subgraphs)          # warm: the kernels' libraries, cuBLAS's workspace
    whole, left = peak(prep.subgraphs)
    alone = max(peak([sg])[0] for sg in prep.subgraphs)
    assert gnn.structure_groups(prep.subgraphs) == [[i] for i in range(8)]
    assert len(left) == 8 and max(left) <= 0, left
    assert 0 < whole <= 1.01 * alone, (whole, alone)


@pytest.mark.parametrize("backend", ["groot", "groot_fused"])
def test_partitioned_loop_holds_one_structure(cuda, backend):
    """Four copies of csa-64 cut into eight stripes: two structures of four
    subgraphs.  The loop keeps a structure's tensors on the card across its
    subgraphs (the same bytes left after each but the last, none after the
    last), peaks no higher than the largest subgraph alone (1%), and gives
    the CPU run's predictions."""
    params = gnn.load_params(NPZ)
    on_card = gnn.params_from_numpy(params, device=cuda)
    prep = Session(device="cpu", streaming=False, num_partitions=8, partitioner="bfs",
                   batch=4).prepare(dataset="csa", bits=64)
    groups = gnn.structure_groups(prep.subgraphs)
    assert groups == [[0, 2, 4, 6], [1, 3, 5, 7]]

    def run(subgraphs):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        left = {}
        pred = gnn.predict_partitioned_loop(
            on_card, subgraphs, prep.feats, prep.num_nodes, backend, device=cuda,
            on_partition=lambda i, sg: left.__setitem__(i, torch.cuda.memory_allocated() - base))
        return pred, torch.cuda.max_memory_allocated() - base, left

    run(prep.subgraphs)           # warm
    pred, whole, left = run(prep.subgraphs)
    alone = max(run([sg])[1] for sg in prep.subgraphs)
    for grp in groups:
        held = [left[i] for i in grp]
        assert held[-1] <= 0 and held[0] > 0 and len(set(held[:-1])) == 1, held
    assert 0 < whole <= 1.01 * alone, (whole, alone)
    on_cpu = gnn.predict_partitioned_loop(
        gnn.params_from_numpy(params), prep.subgraphs, prep.feats, prep.num_nodes, backend,
        device="cpu")
    np.testing.assert_array_equal(pred, on_cpu)


@pytest.mark.parametrize("backend", ["groot", "groot_mxu", "groot_fused"])
def test_streamed_route_on_card_matches_the_loop(cuda, backend):
    """The streamed route (default ``streaming=True``, k=4 at csa-32, two
    packed launches of two slots) gives the card's loop predictions on the
    same subgraphs (PERF.md's limit: at most 1e-5 of the nodes differ),
    launches the grouped kernels, peaks no higher than its largest packed
    launch alone (1%) and leaves no bytes allocated."""
    from repro_torch.exec.packing import pack_partitions
    from repro_torch.exec.plan import plan_from_subgraphs
    from repro_torch.service.scheduler import BucketRunner

    params = gnn.load_params(NPZ)
    prep = Session(device="cpu", num_partitions=4).prepare(dataset="csa", bits=32)
    sess = Session(params, backend=backend)
    kernel = {"groot": gs.ld_grouped_apply, "groot_mxu": gs.ld_grouped_mxu_apply,
              "groot_fused": fs.fused_ld_matmul_grouped}[backend]

    def streamed():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r = sess.verify(prepared=prep, return_predictions=True)
        torch.cuda.synchronize()
        return r, torch.cuda.max_memory_allocated() - base, torch.cuda.memory_allocated() - base

    streamed()                    # warm: the kernels' libraries, cuBLAS's workspace
    before = kernel.launches
    r, peak, left = streamed()
    assert kernel.launches > before and r.routing.mode == "streamed"
    assert r.exec_stats["batches"] == 2 and r.exec_stats["capacity_halvings"] == 0
    assert left <= 0, left
    loop = Session(params, backend=backend, streaming=False).verify(
        prepared=prep, return_predictions=True)
    assert int((r.predictions != loop.predictions).sum()) <= 1e-5 * prep.num_nodes
    assert r.status == loop.status
    plan = plan_from_subgraphs(prep.subgraphs, prep.num_nodes)
    alone = []
    for shape, indices in plan.schedule(2):
        runner = BucketRunner(sess.params, backend, device=cuda)
        batch = pack_partitions(plan, indices, prep.feats, shape, 2, keyed=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runner(batch.arrays, batch.gkeys)
        torch.cuda.synchronize()
        alone.append(torch.cuda.max_memory_allocated() - base)
        runner.release()
        assert torch.cuda.memory_allocated() <= base
    assert 0 < peak <= 1.01 * max(alone), (peak, alone)


@pytest.mark.parametrize("groups", [2, 4])
def test_hd_body_on_a_packed_dummy_row(cuda, groups):
    """A packed batch parks each slot's padding edges as self-loops on its
    last row: one HD row of 14,000 chunks of 512 slots (7,168,000 edges)
    beside ordinary ones.  K2 against its plain version there, with the
    mean-normalised weights of the model's walks."""
    rng = np.random.default_rng(groups)
    n, pad = 4096, 14_000 * 512
    src = np.concatenate([rng.integers(0, n - 1, 40_000), np.full(pad, n - 1)]).astype(np.int32)
    dst = np.concatenate([rng.integers(0, 8, 40_000), np.full(pad, n - 1)]).astype(np.int32)
    plan = gs.build_plan(src, dst, n)
    counts = plan.hd.row_chunks()[:, 1]
    assert counts.max() == 14_000 and plan.hd.rows.shape[0] == 9
    deg = np.bincount(dst, minlength=n)[dst].astype(np.float32)
    wg = torch.as_tensor(np.repeat((1.0 / deg)[:, None], groups, axis=1), device=cuda)
    x_p = gs.pad_features(torch.as_tensor(rng.standard_normal((n, 32)), dtype=torch.float32,
                                          device=cuda))
    staged = gs.stage_group_weights(plan, wg)
    dp = plan.on(cuda)
    before = gs.hd_grouped_apply.launches
    got = gs.hd_grouped_apply(x_p, dp.hd_cols, staged.hd, dp.hd_meta, dp.hd_row_chunks, 512)
    assert gs.hd_grouped_apply.launches == before + 1
    want = gs.hd_grouped_plain(x_p, dp.hd_cols, staged.hd, dp.hd_meta, 9, 512)
    _close(got, want)
    # the dummy row sums 7,168,000 slots of x[n - 1] / 7,168,000: x[n - 1],
    # up to the f32 rounding of 14,000 equal chunk sums added in turn (each
    # add off by at most 2^-24 of the running sum: 8.3e-4 of it in all)
    dummy = int(np.flatnonzero(plan.hd.rows == n - 1)[0])
    torch.testing.assert_close(got[:, dummy], x_p[n - 1].expand(groups, -1), rtol=1e-3,
                               atol=1e-6)


def test_training_steps_on_the_card_follow_the_cpu(cuda):
    """20 AdamW steps at csa-8 from one init on the card and on the CPU:
    losses within 1e-4 relative (``index_add_`` adds in another order on
    the card)."""
    from repro_torch.core import aig as A
    from repro_torch.core.features import groot_features

    design = A.make_design("csa", 8)
    feats, labels = groot_features(design), design.label.astype(np.int32)
    init = gnn.init_params(gnn.GNNConfig(), 0)
    losses = {}
    for dev in ("cpu", cuda):
        batch = gnn.make_batch(design, feats, labels, device=dev)
        _, hist = gnn.train(init.to(dev), batch, epochs=20, log_every=1)
        losses[str(dev)] = np.array([loss for _, loss in hist])
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-4)


def test_killed_streamed_run_resumes_on_the_card(cuda, tmp_path):
    """csa-12 cut 6 ways on ``groot``: killed at the second packed launch,
    resumed by a fresh session that runs only the rest, bit-equal to the
    uninterrupted run, the journal gone afterwards."""
    from repro_torch import faults

    kw = dict(num_partitions=6, stream_capacity=1, backend="groot", device="cuda")
    prep = Session(**kw).prepare(dataset="csa", bits=12)
    want = Session(params=NPZ, **kw).verify(prepared=prep, return_predictions=True)
    with faults.injected("exec.launch:nth=2,kind=fatal"):
        with pytest.raises(faults.FatalFault):
            Session(params=NPZ, checkpoint_dir=str(tmp_path), **kw).verify(prepared=prep)
    (jdir,) = tmp_path.iterdir()
    committed = len(list(jdir.glob("part_*.npz")))
    assert 0 < committed < prep.num_partitions
    before = gs.ld_grouped_apply.launches
    r = Session(params=NPZ, checkpoint_dir=str(tmp_path), **kw).verify(
        prepared=prep, return_predictions=True)
    assert gs.ld_grouped_apply.launches > before
    np.testing.assert_array_equal(r.predictions, want.predictions)
    assert r.exec_stats["resumed_partitions"] == committed
    assert r.exec_stats["partitions"] == prep.num_partitions - committed
    assert not any(tmp_path.iterdir())


def test_cli_verify_on_the_card(cuda, tmp_path, capsys):
    from repro_torch import cli
    from repro_torch.core import aig as A
    from repro_torch.io import aiger

    path = tmp_path / "csa8.aig"
    aiger.dump(A.make_design("csa", 8), path)
    before = gs.ld_grouped_apply.launches
    assert cli.main(["verify", str(path), "--backend", "groot", "--epochs", "20"]) == 0
    assert gs.ld_grouped_apply.launches > before
    row = capsys.readouterr().out.splitlines()[-1].split()
    assert row[:2] == ["csa_mult_8b", "full"] and row[2] in ("verified", "inconclusive")


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5])
def test_init_params_on_the_card_equal_the_cpus(cuda, seed):
    """The init is drawn on the host and moved, so every device starts alike."""
    cfg = gnn.GNNConfig()
    on_card = gnn.params_to_numpy(gnn.init_params(cfg, seed, device=cuda))
    on_cpu = gnn.params_to_numpy(gnn.init_params(cfg, seed))
    for got, want in zip(on_card["layers"] + [on_card["head"]],
                         on_cpu["layers"] + [on_cpu["head"]]):
        for k in want:
            assert np.array_equal(got[k].view(np.uint32), want[k].view(np.uint32))


@pytest.mark.parametrize("backend", ["groot", "groot_fused", "groot_mxu"])
def test_service_on_the_card_matches_sync_verify(cuda, backend):
    """Concurrent tickets through the batched engine on the card: the sync
    verify's status, predictions differing on at most 1e-5 of the nodes;
    after ``close()`` no worker thread and no byte of the engine is left."""
    import threading

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    sess = Session(params=NPZ, backend=backend, max_inflight_per_tenant=4)
    svc = sess._service_engine()
    preds, inner = {}, svc._finalize

    def finalize(req, key, prep, pred, timings):
        preds[req.req_id] = pred.copy()
        return inner(req, key, prep, pred, timings)

    svc._finalize = finalize
    bits = (8, 12, 16, 12)
    tickets = [sess.submit(dataset="csa", bits=b, seed=i, tenant="t")
               for i, b in enumerate(bits)]
    results = [sess.result(t, timeout=300) for t in tickets]
    launched = gs.ld_grouped_apply.launches + fs.fused_ld_matmul_grouped.launches
    sess.close()
    del svc, inner, finalize
    torch.cuda.synchronize()
    assert not [t for t in threading.enumerate()
                if t.is_alive() and t.name.startswith(("svc-", "exec-prefetch"))]
    del sess
    import gc

    gc.collect()
    # the process-wide plan cache may have evicted (and freed) older entries
    assert torch.cuda.memory_allocated() <= before
    assert launched > 0
    for t, b, r in zip(tickets, bits, results):
        want = Session(params=NPZ, backend=backend).verify(
            dataset="csa", bits=b, return_predictions=True, use_cache=False)
        assert r.status == want.status
        mism = int((preds[t] != want.predictions).sum())
        assert mism <= 1e-5 * want.num_nodes, (b, mism)


@pytest.mark.parametrize("backend", ["groot", "groot_fused"])
def test_two_lanes_on_one_card_equal_one_lane(cuda, backend):
    """The sharded route with two lanes on ``cuda:0`` (two streams, two
    params copies, two worker threads) against one lane: csa-32 cut 8 ways
    at capacity 1, so each wave runs both lanes; the same predictions, the
    same compile count, the grouped kernels launched, and after ``close()``
    no lane thread and no byte left."""
    import gc
    import threading

    from repro_torch.exec.plan import plan_from_subgraphs
    from repro_torch.mesh import MeshRunner, ShardedStreamingExecutor, build_mesh_plan

    prep = Session(device="cpu", num_partitions=8).prepare(dataset="csa", bits=32)
    plan = plan_from_subgraphs(prep.subgraphs, prep.num_nodes)
    model = gnn.params_from_numpy(gnn.load_params(NPZ), device=cuda)
    kernel = {"groot": gs.ld_grouped_apply, "groot_fused": fs.fused_ld_matmul_grouped}[backend]
    dev0 = torch.device("cuda", 0)
    runs = {}
    for lanes in (1, 2):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        runner = MeshRunner(model, backend, devices=[dev0] * lanes)
        ex = ShardedStreamingExecutor(runner=runner, capacity=1, prefetch=1)
        launched = kernel.launches
        pred = ex.run_plan(plan, prep.feats)
        runs[lanes] = (pred, ex.stats.compiles, kernel.launches - launched)
        mp = build_mesh_plan(plan, lanes, 1)
        assert (ex.stats.waves, ex.stats.lane_launches) == (len(mp.waves), mp.total_batches)
        runner.close()
        del runner, ex
        gc.collect()
        torch.cuda.synchronize()
        assert not [t for t in threading.enumerate()
                    if t.is_alive() and t.name.startswith("mesh-")]
        assert torch.cuda.memory_allocated() <= before
    assert max(build_mesh_plan(plan, 2, 1).lane_batches) < plan.num_parts
    np.testing.assert_array_equal(runs[2][0], runs[1][0])
    assert runs[2][1] == runs[1][1] > 0
    assert runs[2][2] == runs[1][2] > 0


def _zoo_layer(arch, key, layer=0, seed=0, **kw):
    """One layer's ``key`` params of the arch's smoke config (``kw`` widens
    it), drawn on the CPU, every ``zeros``/``ones`` leaf given N(0, 0.01)
    noise (so token shift, the bonus term and the conv are not zero)."""
    import dataclasses

    from repro_torch.zoo.configs import base, get_config

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)
    spec = base.param_tree(cfg)["layers"][layer][key]
    gen = torch.Generator().manual_seed(seed)
    p = base.materialize(spec, gen)
    return cfg, base.tree_map(
        lambda s, a: a if s.init == "normal" else a + 0.1 * torch.randn(
            a.shape, generator=gen), spec, p)


@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_moe_ffn_on_card_matches_cpu(cuda, cf):
    """The MoE dispatch (count-sort, slab scatter with overflow, batched
    expert matmuls, gather) on the card against the same call on the CPU,
    f32: routes equal, outputs within 1e-5 of max(1, max|cpu|)."""
    from repro_torch.zoo.configs import base
    from repro_torch.zoo.models import moe

    cfg, p = _zoo_layer("qwen3-moe-235b-a22b", "moe", capacity_factor=cf, d_model=256,
                        num_experts=16, top_k=4, moe_d_ff=128)
    x = torch.randn((2, 200, cfg.d_model), generator=torch.Generator().manual_seed(1))
    pc = base.tree_map(lambda a: a.to(cuda), p)
    want_i, _ = moe.route(x.reshape(-1, cfg.d_model), p["router"], cfg)
    got_i, _ = moe.route(x.reshape(-1, cfg.d_model).to(cuda), pc["router"], cfg)
    assert torch.equal(got_i.cpu(), want_i)
    want = moe.moe_ffn(x, p, cfg)
    got = moe.moe_ffn(x.to(cuda), pc, cfg)
    _close(got.cpu(), want)


@pytest.mark.parametrize("length", [37, 300])
def test_time_mix_chunked_matches_scan_on_card(cuda, length):
    """RWKV6's chunked form against the token-by-token scan on the card,
    with a carried state, f32: within 1e-4 of max(1, max|scan|)."""
    from repro_torch.zoo.configs import base
    from repro_torch.zoo.models import rwkv6

    cfg, p = _zoo_layer("rwkv6-3b", "rwkv", d_model=256, mixer_heads=4)
    p = base.tree_map(lambda a: a.to(cuda), p)
    gen = torch.Generator(cuda).manual_seed(2)
    x = torch.randn((2, length, cfg.d_model), generator=gen, device=cuda)
    state = rwkv6.init_state(cfg, 2, cuda)
    state["s"] = 0.5 * torch.randn(state["s"].shape, generator=gen, device=cuda)
    state["x_prev"] = torch.randn((2, cfg.d_model), generator=gen, device=cuda).bfloat16()
    want, wst = rwkv6.time_mix_scan(x, p, cfg, state)
    got, gst = rwkv6.time_mix_chunked(x, p, cfg, state)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for g, w in ((got, want), (gst["s"], wst["s"])):
        assert (g - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item())


@pytest.mark.parametrize("length", [1, 100, 4096])
def test_rg_lru_matches_sequential_loop_on_card(cuda, length):
    """The RG-LRU's doubling scan against the recurrence one token at a
    time on the card, with a carried state, f32: within 1e-5 of
    max(1, max|loop|)."""
    from repro_torch.zoo.configs import base
    from repro_torch.zoo.models import rglru

    cfg, p = _zoo_layer("recurrentgemma-9b", "rglru", d_rnn=128, d_model=128)
    p = base.tree_map(lambda a: a.to(cuda), p)
    gen = torch.Generator(cuda).manual_seed(3)
    xr = torch.randn((2, length, cfg.d_rnn_), generator=gen, device=cuda)
    h0 = torch.randn((2, cfg.d_rnn_), generator=gen, device=cuda)
    got, fin = rglru.rg_lru(xr, p, h0)
    a, gx = rglru._gates(xr, p)
    h, rows = h0, []
    for t in range(length):
        h = a[:, t] * h + gx[:, t]
        rows.append(h)
    want = torch.stack(rows, 1)
    _close(got, want)
    _close(fin, want[:, -1])


def test_block_schedule_matches_plain_on_card(cuda):
    """The flash path at other positions (causal decode queries against more
    keys than one block, ragged, unwritten slots at PAD_POS, GQA; and a
    window) on the card: the block schedule against the plain schedule,
    f32, within 1e-5 of max(1, max|plain|); K8 does not launch."""
    import dataclasses

    from repro_torch.zoo.configs import get_config
    from repro_torch.zoo.models import attention as A

    cfg = dataclasses.replace(get_config("llama-3.2-vision-11b"), dtype="float32")
    gen = torch.Generator(cuda).manual_seed(4)
    b, s, h, kvh, hd, t = 2, 3, 32, 8, 128, 2500
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda)
    k = torch.randn((b, t, kvh, hd), generator=gen, device=cuda)
    v = torch.randn((b, t, kvh, hd), generator=gen, device=cuda)
    q_pos = torch.arange(2200, 2200 + s, dtype=torch.int32, device=cuda)
    k_pos = torch.arange(t, dtype=torch.int32, device=cuda)
    k_pos[2300:] = A.PAD_POS
    launches, calls = fa.flash_attention.launches, A._sdpa_blocks.calls
    for window in (0, 700):
        got = A._sdpa_flash(q, k, v, q_pos, k_pos, cfg, hd**-0.5, causal=True, window=window)
        want = A._sdpa_plain(q, k, v, q_pos, k_pos, cfg, hd**-0.5, causal=True, window=window)
        _close(got, want)
    assert fa.flash_attention.launches == launches and A._sdpa_blocks.calls == calls + 2


@pytest.mark.parametrize("flash", [False, True])
def test_train_step_on_card_follows_cpu(cuda, flash, monkeypatch):
    """One smoke-size qwen3-8b train step (f32, two microbatches, remat) on
    the card and on the CPU from the same params and batch: loss and grad
    norm within 1e-5 relative, the moments within 1e-4 of max(1, max|cpu|)
    (sums in other orders).  With ``flash`` the flash threshold is lowered
    so that every attention call under grad takes the block schedule: K8
    does not launch."""
    import dataclasses

    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step
    from repro_torch.zoo.configs import get_config
    from repro_torch.zoo.configs.base import leaves, materialize, model_spec_tree
    from repro_torch.zoo.models import attention as A
    from repro_torch.zoo.models.transformer import params_from_numpy

    if flash:
        monkeypatch.setattr(A, "FLASH_THRESHOLD", 16)
        monkeypatch.setattr(A, "Q_CHUNK", 8)
        monkeypatch.setattr(A, "KV_CHUNK", 8)
    cfg = dataclasses.replace(get_config("qwen3-8b", smoke=True), dtype="float32")
    tree = materialize(model_spec_tree(cfg), torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33))
                           .astype(np.int32))
    out = {}
    launches, grad_calls = fa.flash_attention.launches, A._sdpa_blocks.grad_calls
    for dev in ("cpu", cuda):
        params = params_from_numpy(tree, cfg, dev, trainable=True)
        optimizer = opt.AdamW(lr=3e-4, weight_decay=0.1)
        step = make_train_step(cfg, optimizer, microbatches=2, remat=True)
        _, state, met = step(params, optimizer.init(leaves(params)), {"tokens": tok.to(dev)})
        out[str(dev)] = (met["loss"].item(), met["grad_norm"].item(),
                         [m.cpu() for m in state.m + state.v])
    assert fa.flash_attention.launches == launches
    assert (A._sdpa_blocks.grad_calls > grad_calls) == flash
    (cl, cn, cm), (gl, gn, gm) = out["cpu"], out[str(cuda)]
    assert gl == pytest.approx(cl, rel=1e-5) and gn == pytest.approx(cn, rel=1e-5)
    for g, c in zip(gm, cm):
        assert (g - c).abs().max().item() <= 1e-4 * max(1.0, c.abs().max().item())


def test_kernels_refuse_grad_on_card(cuda):
    """K1-K8 have no backward: with grad mode on, each wrapper refuses a
    CUDA input that requires grad before it launches (no launch counted)."""
    x = torch.ones((5, 4), device=cuda, requires_grad=True)
    calls = {
        gs.ld_grouped_apply: lambda f: f(x, None, None, 2),
        gs.ld_grouped_mxu_apply: lambda f: f(x, None, None, 2),
        gs.hd_grouped_apply: lambda f: f(x, None, None, None, None, 512),
        gs.ld_bucket_apply: lambda f: f(x, None, 2),
        gs.hd_apply: lambda f: f(x, None, None, None, 512),
        fs.fused_ld_matmul: lambda f: f(x, None, None, 2),
        fs.fused_ld_matmul_grouped: lambda f: f(x, None, None, None, 2),
    }
    for fn, call in calls.items():
        before = fn.launches
        with pytest.raises(RuntimeError, match="no backward"):
            call(fn)
        assert fn.launches == before
    q = torch.randn((2, 256, 128), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn((2, 256, 128), device=cuda, dtype=torch.bfloat16)
    before = fa.flash_attention.launches
    with pytest.raises(RuntimeError, match="block schedule"):
        fa.flash_attention(q, k, k)
    with torch.no_grad():
        out = fa.flash_attention(q, k, k)
    assert out.grad_fn is None and fa.flash_attention.launches == before + 1
