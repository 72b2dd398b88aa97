"""The port's K4-K7 plain versions, ungrouped walks and one-shot SpMM against
the reference.

K4 (grouped MXU LD), K5 (ungrouped LD, VPU and MXU bodies), K6 (ungrouped
HD) and K7 (ungrouped fused LD + matmul) each have a plain PyTorch version
beside their CUDA wrapper; on CPU tensors the wrapper runs it.  The same
inputs, made with numpy from a seed, go through the reference's Pallas
wrapper (``interpret=True``, on messages gathered with ``jnp.take`` and
pre-weighted in the stream dtype, as the reference's walks do) and through
the port's wrapper on the CPU.  The reference pads features to 128 lanes;
the port does not, so ``[..., :F]`` is compared.

Tolerances, as in ``tests/test_torch_kernels.py``: f32 within rtol = atol =
1e-5 (other summation orders); bf16 streams within the reference's own
bf16-vs-f32 error plus 1e-3.  The kernels themselves are held against these
plain versions on the card in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fused_sage as RFS  # noqa: E402
from repro.kernels import groot_spmm as RS  # noqa: E402
from repro.kernels import ops as ROPS  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro_torch.kernels import fused_sage as TFS  # noqa: E402
from repro_torch.kernels import groot_spmm as TS  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from tests.test_forward_plan import MIXTURES  # noqa: E402
from tests.test_plan_properties import graph_from_degrees  # noqa: E402
from tests.test_torch_kernels import _case, _staged  # noqa: E402

F, H = 8, 12
DTYPES = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _assert_close(results):
    """``results[dtype] = [(what, reference, port), ...]``: f32 within
    1e-5, bf16 within the reference's own bf16 error plus 1e-3."""
    for what, ref, port in results["float32"]:
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5, err_msg=what)
    ref32 = {w: r for w, r, _ in results["float32"]}
    for what, ref, port in results["bfloat16"]:
        bound = np.max(np.abs(ref - ref32[what]), initial=0.0) + 1e-3
        assert np.max(np.abs(port - ref), initial=0.0) <= bound, what


# ---------------------------------------------------------------------------
# K4: grouped MXU LD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("idx", range(len(MIXTURES)))
def test_k4_grouped_mxu_matches_pallas(idx, groups):
    results = {}
    for dtype in DTYPES:
        src, dst, n, e_t, x, wg, _ = _case(idx, groups)
        rplan, tplan, rx, tx, rsw, tsw = _staged(src, dst, n, e_t, x, wg, dtype)
        dp = tplan.on("cpu")
        out = []
        for rb, cols, rw, tw in zip(rplan.buckets, dp.cols, rsw.buckets, tsw.buckets):
            msgs = jnp.take(rx, jnp.asarray(rb.cols), axis=0)
            ref = RS.ld_grouped_apply(msgs, rw, rb.deg, rb.rows_per_tile, interpret=True, mxu=True)
            port = TS.ld_grouped_apply(tx, cols, tw, rb.deg, mxu=True)
            # degree > 1 goes to K4, degree 1 stays on K1, as in the reference
            plain = TS.ld_grouped_mxu_plain if rb.deg > 1 else TS.ld_grouped_plain
            torch.testing.assert_close(port, plain(tx, cols, tw, rb.deg), rtol=0, atol=0)
            out.append((f"K4 d={rb.deg}", np.asarray(ref)[..., :F], port.numpy()))
        results[dtype] = out
    assert any(w != "K4 d=1" for w, _, _ in results["float32"])
    _assert_close(results)


def test_k4_rounds_the_bf16_product_where_k1_does_not():
    """K4 takes ``msgs * wg`` in bf16 (as the reference's MXU kernel);
    K1 widens both to f32 first.  The two plain versions differ in bf16
    and agree exactly in f32."""
    rng = np.random.default_rng(5)
    x_p = torch.as_tensor(rng.standard_normal((33, 16)), dtype=torch.float32)
    x_p[-1] = 0
    cols = torch.as_tensor(rng.integers(0, 33, 64), dtype=torch.int32)
    wg = torch.as_tensor(rng.random((64, 2)), dtype=torch.float32)
    f32 = [p(x_p, cols, wg, 4) for p in (TS.ld_grouped_plain, TS.ld_grouped_mxu_plain)]
    torch.testing.assert_close(f32[0], f32[1], rtol=0, atol=0)
    xb, wb = x_p.to(torch.bfloat16), wg.to(torch.bfloat16)
    k1, k4 = TS.ld_grouped_plain(xb, cols, wb, 4), TS.ld_grouped_mxu_plain(xb, cols, wb, 4)
    assert (k1 - k4).abs().max() > 0
    msgs = xb.index_select(0, cols.long())
    want = (msgs[None] * wb.t()[:, :, None]).float().reshape(2, -1, 4, 16).sum(2)
    torch.testing.assert_close(k4, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K5, K6, K7: the ungrouped kernels, on pre-weighted messages
# ---------------------------------------------------------------------------

def _ungrouped_outputs(idx, dtype, weighted, mxu):
    """Every ungrouped kernel output of one mixture through both packages:
    ``[(what, reference, port), ...]`` as f32 numpy."""
    src, dst, n, e_t, x, wg, _ = _case(idx, 1)
    rng = np.random.default_rng(idx + 11)
    w_mat = rng.standard_normal((F, H)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    rplan = RS.build_plan(src, dst, n, e_t=e_t)
    tplan = TS.build_plan(src, dst, n, e_t=e_t)
    rx = RS.pad_features(jnp.asarray(x))
    tx = TS.pad_features(torch.from_numpy(x))
    if jdt is not None:
        rx, tx = rx.astype(jdt), tx.to(tdt)
    w = wg[:, 0] if weighted else None
    rw_p = None if w is None else jnp.pad(jnp.asarray(w).astype(rx.dtype), (0, 1))
    tw_buckets, tw_hd = TS.stage_weight(tplan, None if w is None else torch.from_numpy(w),
                                        tx.dtype)
    rwm = jnp.pad(jnp.asarray(w_mat), ((0, RS.F_TILE - F), (0, RS.F_TILE - H)))
    twm = torch.from_numpy(w_mat)

    def msgs(cols, eids):
        m = jnp.take(rx, jnp.asarray(cols), axis=0)
        return m if rw_p is None else m * jnp.take(rw_p, jnp.asarray(eids), axis=0)[:, None]

    dp = tplan.on("cpu")
    out = []
    for rb, cols, tw in zip(rplan.buckets, dp.cols, tw_buckets):
        m = msgs(rb.cols, rb.eids)
        ref = RS.ld_bucket_apply(m, rb.deg, rb.rows_per_tile, interpret=True, mxu=mxu)
        port = TS.ld_bucket_apply(tx, cols, rb.deg, tw, mxu=mxu)
        out.append((f"K5 d={rb.deg}", np.asarray(ref)[:, :F], port.numpy()))
        if not mxu:
            ref = RFS.fused_ld_matmul(m, rwm, rb.deg, rb.rows_per_tile, interpret=True)
            port = TFS.fused_ld_matmul(tx, cols, twm, rb.deg, tw)
            out.append((f"K7 d={rb.deg}", np.asarray(ref)[:, :H], port.numpy()))
    if rplan.hd is not None:
        hd = rplan.hd
        ref = RS.hd_apply(msgs(hd.cols, hd.eids), hd.chunk_meta, len(hd.rows), e_t,
                          interpret=True)
        port = TS.hd_apply(tx, dp.hd_cols, dp.hd_meta, dp.hd_row_chunks, e_t, tw_hd)
        out.append(("K6", np.asarray(ref)[:, :F], port.numpy()))
    return out


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("idx", [0, 2, 3])
def test_ungrouped_kernels_match_pallas(idx, weighted, mxu):
    results = {d: _ungrouped_outputs(idx, d, weighted, mxu) for d in DTYPES}
    kinds = {w.split()[0] for w, _, _ in results["float32"]}
    assert "K5" in kinds and ("K7" in kinds) != mxu
    if idx:
        assert "K6" in kinds
    _assert_close(results)


def test_oracles_match_reference():
    rng = np.random.default_rng(3)
    msgs = rng.standard_normal((24, 5)).astype(np.float32)
    np.testing.assert_allclose(
        TREF.ell_block_reduce_ref(torch.from_numpy(msgs), 8, 4).numpy(),
        np.asarray(RREF.ell_block_reduce_ref(jnp.asarray(msgs), 8, 4)), rtol=1e-6, atol=1e-6)
    chunks = msgs.reshape(4, 6, 5)
    rows = np.array([0, 0, 1, 3])
    np.testing.assert_allclose(
        TREF.hd_chunk_reduce_ref(torch.from_numpy(chunks), torch.from_numpy(rows)).numpy(),
        np.asarray(RREF.hd_chunk_reduce_ref(jnp.asarray(chunks), rows)), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Walks and the one-shot SpMM
# ---------------------------------------------------------------------------

def _graph(idx):
    n, e_t, hd_frac, scale, seed = MIXTURES[idx]
    src, dst = graph_from_degrees(np.random.default_rng(seed), n, e_t, hd_frac, scale)
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((n, F)).astype(np.float32)
    w = rng.random(len(src)).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), n, e_t, x, w


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_apply_plan_matches_reference(transpose, mxu):
    src, dst, n, e_t, x, w = _graph(2)
    if transpose:
        src, dst = dst, src
    rplan = RS.build_plan(src, dst, n, e_t=e_t)
    tplan = TS.build_plan(src, dst, n, e_t=e_t)
    for ww in (None, w):
        ref = RS.apply_plan(rplan, jnp.asarray(x), None if ww is None else jnp.asarray(ww),
                            mxu=mxu)
        port = TS.apply_plan(tplan, torch.from_numpy(x),
                             None if ww is None else torch.from_numpy(ww), mxu=mxu)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        want = TREF.spmm_ref(torch.from_numpy(x), torch.from_numpy(src).long(),
                             torch.from_numpy(dst).long(), n,
                             None if ww is None else torch.from_numpy(ww))
        np.testing.assert_allclose(port.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_fused_walk_matches_reference():
    src, dst, n, e_t, x, w = _graph(2)
    w_mat = np.random.default_rng(9).standard_normal((F, H)).astype(np.float32)
    rplan = RS.build_plan(src, dst, n, e_t=e_t)
    tplan = TS.build_plan(src, dst, n, e_t=e_t)
    ref = ROPS._apply_plan_fused(rplan, jnp.asarray(x), jnp.asarray(w), jnp.asarray(w_mat),
                                 interpret=True)
    port = TOPS._apply_plan_fused(tplan, torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(w_mat))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["groot", "groot_mxu", "onehot"])
@pytest.mark.parametrize("transpose", [False, True])
def test_groot_spmm_matches_reference(backend, transpose):
    """The paper's single SpMM, both directions, against the reference's
    one-shot entry point and against the dense oracle."""
    src, dst, n, e_t, x, w = _graph(1)
    if transpose:
        src, dst = dst, src
    for ww in (None, w):
        ref = ROPS.groot_spmm(x, src, dst, n, ww, backend=backend)
        port = TOPS.groot_spmm(torch.from_numpy(x), src, dst, n,
                               None if ww is None else torch.from_numpy(ww), backend=backend)
        assert port.dtype == torch.float32 and port.shape == (n, F)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        dense = TREF.spmm_dense_ref(torch.from_numpy(x), torch.from_numpy(src).long(),
                                    torch.from_numpy(dst).long(), n,
                                    None if ww is None else torch.from_numpy(ww))
        np.testing.assert_allclose(port.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)


def test_onehot_spmm_matches_reference():
    src, dst, n, _, x, w = _graph(0)
    ref = ROPS.onehot_spmm(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), n, jnp.asarray(w))
    port = TOPS.onehot_spmm(torch.from_numpy(x), torch.from_numpy(src).long(),
                            torch.from_numpy(dst).long(), n, torch.from_numpy(w))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_backends_and_pairs_match_reference():
    assert TOPS.BACKENDS == ROPS.BACKENDS
    src, dst, n, _, _, _ = _graph(0)
    for backend in TOPS.BACKENDS:
        pair = TOPS.make_agg_pair(src, dst, n, backend, device="cpu")
        ref = ROPS.make_agg_pair(src, dst, n, backend)
        assert pair.backend == ref.backend == backend
        for f in ("in_agg_mm", "in_agg_grouped", "in_agg_mm_grouped", "fwd_plan"):
            assert (getattr(pair, f) is None) == (getattr(ref, f) is None), (backend, f)
        assert TOPS.ungrouped(pair).in_agg_mm is pair.in_agg_mm
    with pytest.raises(ValueError, match="unknown backend"):
        TOPS.make_agg_pair(src, dst, n, "nosuch", device="cpu")


def test_ungrouped_wrappers_reject_bad_inputs():
    src, dst, n, e_t, x, w = _graph(1)
    tplan = TS.build_plan(src, dst, n, e_t=e_t)
    b, cols = tplan.buckets[1], tplan.on("cpu").cols[1]
    x_p = TS.pad_features(torch.from_numpy(x))
    with pytest.raises(ValueError, match="share dtype"):
        TS.ld_bucket_apply(x_p, cols, b.deg, torch.ones(cols.shape[0], dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="weight stream"):
        TS.ld_bucket_apply(x_p, cols, b.deg, torch.ones((cols.shape[0], 1)))
    with pytest.raises(ValueError, match="rows of"):
        TS.ld_bucket_apply(x_p, cols[:-1], b.deg)
    with pytest.raises(ValueError, match="w_mat"):
        TFS.fused_ld_matmul(x_p, cols, torch.ones((F + 1, H)), b.deg)
    dp = tplan.on("cpu")
    with pytest.raises(ValueError, match="chunks"):
        TS.hd_apply(x_p, dp.hd_cols[:-1], dp.hd_meta, dp.hd_row_chunks, e_t)
