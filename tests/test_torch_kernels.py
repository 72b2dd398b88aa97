"""Plain versions of the port's kernels against the reference's Pallas kernels.

Each kernel of the full-graph path (K1 grouped LD, K2 grouped HD, K3 grouped
fused LD) has a plain PyTorch version beside its CUDA wrapper; on CPU tensors
the wrapper runs it.  Here the same inputs, made with numpy from a seed, go
through the reference's Pallas wrapper (``interpret=True``, on messages
gathered with ``jnp.take`` as the reference's walks do) and through the
port's wrapper on the CPU.  The reference pads features to 128 lanes; the
port does not, so ``[..., :F]`` is compared.

Tolerances: f32 within rtol = atol = 1e-5 (the reference's HD kernel reduces
through a matmul, another summation order).  bf16 streams within the
reference's own bf16-vs-f32 error plus 1e-3.  The kernels themselves are held
against these plain versions on the card in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fused_sage as RFS  # noqa: E402
from repro.kernels import groot_spmm as RS  # noqa: E402
from repro_torch.kernels import fused_sage as TFS  # noqa: E402
from repro_torch.kernels import groot_spmm as TS  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro.kernels import ops as ROPS  # noqa: E402
from tests.test_forward_plan import MIXTURES  # noqa: E402
from tests.test_plan_properties import graph_from_degrees  # noqa: E402

F, H = 8, 12


def _case(idx, groups):
    n, e_t, hd_frac, scale, seed = MIXTURES[idx]
    rng = np.random.default_rng(seed)
    src, dst = graph_from_degrees(rng, n, e_t, hd_frac, scale)
    x = rng.standard_normal((n, F)).astype(np.float32)
    wg = rng.random((len(src), groups)).astype(np.float32)
    w_stack = rng.standard_normal((groups, F, H)).astype(np.float32)
    return src, dst, n, e_t, x, wg, w_stack


def _staged(src, dst, n, e_t, x, wg, dtype):
    """Reference and port inputs for one plan: padded features and staged
    weight streams, in the stream dtype."""
    rplan = RS.build_plan(src, dst, n, e_t=e_t)
    tplan = TS.build_plan(src, dst, n, e_t=e_t)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    rx = RS.pad_features(jnp.asarray(x))
    rx = rx if jdt is None else rx.astype(jdt)
    tx = TS.pad_features(torch.from_numpy(x))
    tx = tx if tdt is None else tx.to(tdt)
    rsw = RS.stage_group_weights(rplan, jnp.asarray(wg), dtype=jdt)
    tsw = TS.stage_group_weights(tplan, torch.from_numpy(wg), dtype=tdt)
    return rplan, tplan, rx, tx, rsw, tsw


def _outputs(idx, groups, dtype):
    """Every kernel output of one mixture through both packages:
    ``[(what, reference, port), ...]`` as f32 numpy."""
    src, dst, n, e_t, x, wg, w_stack = _case(idx, groups)
    rplan, tplan, rx, tx, rsw, tsw = _staged(src, dst, n, e_t, x, wg, dtype)
    rws = jnp.pad(jnp.asarray(w_stack), ((0, 0), (0, RS.F_TILE - F), (0, RS.F_TILE - H)))
    tws = torch.from_numpy(w_stack)
    dp = tplan.on("cpu")
    out = []
    for rb, cols, rw, tw in zip(rplan.buckets, dp.cols, rsw.buckets, tsw.buckets):
        msgs = jnp.take(rx, jnp.asarray(rb.cols), axis=0)
        ref = RS.ld_grouped_apply(msgs, rw, rb.deg, rb.rows_per_tile, interpret=True, mxu=False)
        port = TS.ld_grouped_apply(tx, cols, tw, rb.deg)
        out.append((f"K1 d={rb.deg}", np.asarray(ref)[..., :F], port.numpy()))
        ref = RFS.fused_ld_matmul_grouped(msgs, rw, rws, rb.deg, rb.rows_per_tile, interpret=True)
        port = TFS.fused_ld_matmul_grouped(tx, cols, tw, tws, rb.deg)
        out.append((f"K3 d={rb.deg}", np.asarray(ref)[:, :H], port.numpy()))
    if rplan.hd is not None:
        hd = rplan.hd
        msgs = jnp.take(rx, jnp.asarray(hd.cols), axis=0)
        ref = RS.hd_grouped_apply(msgs, rsw.hd, hd.chunk_meta, len(hd.rows), e_t, interpret=True)
        port = TS.hd_grouped_apply(tx, dp.hd_cols, tsw.hd, dp.hd_meta, dp.hd_row_chunks, e_t)
        out.append(("K2", np.asarray(ref)[..., :F], port.numpy()))
    return out


@pytest.mark.parametrize("idx,groups", [(1, 4), (2, 2), (3, 4)])
def test_plain_kernels_match_pallas(idx, groups):
    f32 = _outputs(idx, groups, "float32")
    assert {w.split()[0] for w, _, _ in f32} == {"K1", "K2", "K3"}
    for what, ref, port in f32:
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5, err_msg=what)
    ref32 = {w: r for w, r, _ in f32}
    for what, ref, port in _outputs(idx, groups, "bfloat16"):
        bound = np.max(np.abs(ref - ref32[what])) + 1e-3
        assert np.max(np.abs(port - ref)) <= bound, what


def test_staged_weights_identical():
    src, dst, n, e_t, x, wg, _ = _case(2, 4)
    rplan, tplan, _, _, rsw, tsw = _staged(src, dst, n, e_t, x, wg, "float32")
    for r, t in zip(rsw.buckets, tsw.buckets):
        np.testing.assert_array_equal(np.asarray(r), t.numpy())
    np.testing.assert_array_equal(np.asarray(rsw.hd), tsw.hd.numpy())


@pytest.mark.parametrize("fused", [False, True])
def test_grouped_walks_match_reference(fused):
    """The slice's whole walks (kernels + permutation assembly, and the fused
    walk's HD einsum) against the reference's."""
    src, dst, n, e_t, x, wg, w_stack = _case(2, 4)
    rplan = RS.build_plan(src, dst, n, e_t=e_t)
    tplan = TS.build_plan(src, dst, n, e_t=e_t)
    if fused:
        ref = ROPS._apply_plan_fused_grouped(rplan, jnp.asarray(x), jnp.asarray(wg),
                                             jnp.asarray(w_stack), interpret=True)
        port = TOPS._apply_plan_fused_grouped(tplan, torch.from_numpy(x), torch.from_numpy(wg),
                                              torch.from_numpy(w_stack))
    else:
        ref = RS.apply_plan_grouped(rplan, jnp.asarray(x), jnp.asarray(wg))
        port = TS.apply_plan_grouped(tplan, torch.from_numpy(x), torch.from_numpy(wg))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_inputs():
    src, dst, n, e_t, x, wg, w_stack = _case(1, 2)
    tplan = TS.build_plan(src, dst, n, e_t=e_t)
    b, cols = tplan.buckets[0], tplan.on("cpu").cols[0]
    x_p = TS.pad_features(torch.from_numpy(x))
    w = torch.ones((cols.shape[0], 2))
    with pytest.raises(ValueError, match="share dtype"):
        TS.ld_grouped_apply(x_p, cols, w.to(torch.bfloat16), b.deg)
    with pytest.raises(ValueError, match="int32"):
        TS.ld_grouped_apply(x_p, cols.long(), w, b.deg)
    with pytest.raises(ValueError, match="1 to 4 groups"):
        TS.ld_grouped_apply(x_p, cols, torch.ones((cols.shape[0], 5)), b.deg)
    with pytest.raises(ValueError, match="w_stack"):
        TFS.fused_ld_matmul_grouped(x_p, cols, w, torch.ones((2, F + 1, H)), b.deg)
