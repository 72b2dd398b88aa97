"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and skips
without one.  The file imports nothing of JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels and their plain versions round each message-weight product the
same way (K1-K3 widen bf16 inputs to f32 exactly; K4-K7 round the product to
the stream dtype) and accumulate in f32, so only the order of the sums
differs, plus, for K4 on f32 streams, what the two-term TF32 split loses
(under 2^-22 of each product): a tolerance of 1e-5 relative to
max(1, max|plain|) holds for f32 and bf16 streams alike.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Session  # noqa: E402
from repro_torch.core import gnn  # noqa: E402
from repro_torch.kernels import fused_sage as fs  # noqa: E402
from repro_torch.kernels import groot_spmm as gs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 1e-5

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


def test_cuda_wrappers_never_run_the_plain_versions(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    for mod, name in ((gs, "ld_grouped_plain"), (gs, "hd_grouped_plain"),
                      (gs, "ld_grouped_mxu_plain"), (gs, "ld_bucket_plain"), (gs, "hd_plain"),
                      (fs, "fused_ld_grouped_plain"), (fs, "fused_ld_plain")):
        monkeypatch.setattr(mod, name, boom)
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
