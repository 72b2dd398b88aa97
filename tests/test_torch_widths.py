"""The staged bodies' width handling, on the CPU.

The CUDA bodies of K3, K4, K5 and K7 are built for rows of 4, 8, 16 or 32
features and, for the fused ones, W of a multiple of 32 columns.
``groot_spmm.stage_width`` pads x with zero columns to the next of those
widths (or to a multiple of 32, run as 32-column slices) and the weight stack
to match; each slice's sum stores its valid columns, each slice's
contraction is added to the last.  Here the plain versions run through that
staging, slice by slice as the wrappers launch the kernels, and must give
what they give on the unpadded inputs: zero columns add zero terms.  Sums of
one column do not depend on the other columns (within 1e-6); the fused
slices add partial contractions in another order (within 1e-5 of
max(1, max|plain|), the card's tolerance).  A W too wide for one block's
shared memory runs in blocks of its columns (``fused_sage.column_blocks``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_sage as fs  # noqa: E402
from repro_torch.kernels import groot_spmm as gs  # noqa: E402

WIDTHS = (24, 40, 64)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
N, ROWS, DEG, GROUPS = 50, 37, 4, 3


def _inputs(feat: int, dtype, seed: int):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((N, feat)), dtype=torch.float32)
    x_p = gs.pad_features(x).to(dtype)
    cols = torch.as_tensor(rng.integers(0, N + 1, ROWS * DEG), dtype=torch.int32)
    wg = torch.as_tensor(rng.standard_normal((ROWS * DEG, GROUPS)), dtype=torch.float32)
    return rng, x_p, cols, wg.to(dtype)


def _sum_slices(plain, x_p):
    """``plain(x slice)`` per slice of the staging, valid columns side by
    side, as the sum bodies store them."""
    xs, slices, _ = gs.stage_width(x_p)
    assert xs.shape[1] in gs.STAGED_FEATS or xs.shape[1] % gs.SLICE == 0
    assert all(c0 + valid <= x_p.shape[1] for c0, _, valid in slices)
    parts = [plain(xs[:, c0:c0 + sw].contiguous())[..., :valid] for c0, sw, valid in slices]
    return torch.cat(parts, dim=-1)


def _fused_slices(plain, x_p, w_stack):
    """``plain(x slice, W slice)`` summed over the staging's slices, H
    columns kept, as the fused bodies add them."""
    xs, slices, ws = gs.stage_width(x_p, w_stack)
    assert ws.shape[1] == xs.shape[1] and ws.shape[2] % gs.SLICE == 0
    out = 0
    for c0, sw, _ in slices:
        out = out + plain(xs[:, c0:c0 + sw].contiguous(), ws[:, c0:c0 + sw].contiguous())
    return out[:, :w_stack.shape[2]]


@pytest.mark.parametrize("feat", [1, 4, 5, 8, 16, 24, 32, 33, 40, 64, 100])
def test_staged_slices_cover_the_row(feat):
    width, slices = gs.staged_slices(feat)
    assert width >= feat and (width in gs.STAGED_FEATS or width % gs.SLICE == 0)
    assert sum(valid for _, _, valid in slices) == feat
    assert [c0 for c0, _, _ in slices] == list(range(0, width, slices[0][1]))
    x = torch.ones((3, feat))
    assert gs.pad_columns(x, width).shape == (3, width)
    if width == feat:
        assert gs.pad_columns(x, width) is x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("feat", WIDTHS)
@pytest.mark.parametrize("kernel", ["K4", "K5", "K5 unweighted"])
def test_sum_plains_agree_through_the_staging(kernel, feat, dtype):
    _, x_p, cols, wg = _inputs(feat, DTYPES[dtype], feat)
    if kernel == "K4":
        def plain(x):
            return gs.ld_grouped_mxu_plain(x, cols, wg, DEG)
    else:
        w = wg[:, 0].contiguous() if kernel == "K5" else None

        def plain(x):
            return gs.ld_bucket_plain(x, cols, DEG, w)
    torch.testing.assert_close(_sum_slices(plain, x_p), plain(x_p), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hid", WIDTHS)
@pytest.mark.parametrize("feat", WIDTHS)
@pytest.mark.parametrize("kernel", ["K3", "K7"])
def test_fused_plains_agree_through_the_staging(kernel, feat, hid, dtype):
    rng, x_p, cols, wg = _inputs(feat, DTYPES[dtype], feat * 100 + hid)
    groups = GROUPS if kernel == "K3" else 1
    w_stack = torch.as_tensor(rng.standard_normal((groups, feat, hid)), dtype=torch.float32)
    if kernel == "K3":
        def plain(x, w):
            return fs.fused_ld_grouped_plain(x, cols, wg, w, DEG)
    else:
        def plain(x, w):
            return fs.fused_ld_plain(x, cols, w[0], DEG, wg[:, 0].contiguous())
    want = plain(x_p, w_stack)
    got = _fused_slices(plain, x_p, w_stack)
    assert got.shape == want.shape
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("hid, hb", [(1000, 352), (1000, 768), (64, 32), (40, 32)])
def test_fused_plains_agree_through_column_blocks(hid, hb):
    """W too wide for one block's shared memory runs in blocks of its
    (padded) columns, the last one narrower: each block's stored columns
    are the unblocked result's."""
    rng, x_p, cols, wg = _inputs(32, torch.float32, hid)
    w_stack = torch.as_tensor(rng.standard_normal((GROUPS, 32, hid)), dtype=torch.float32)
    _, _, ws = gs.stage_width(x_p, w_stack)
    blocks = fs.column_blocks(ws.shape[2], hb)
    assert sum(bw for _, bw in blocks) == ws.shape[2]
    assert all(bw % gs.SLICE == 0 for _, bw in blocks)
    want = fs.fused_ld_grouped_plain(x_p, cols, wg, w_stack, DEG)
    got = torch.cat([fs.fused_ld_grouped_plain(x_p, cols, wg, ws[:, :, h0:h0 + bw].contiguous(),
                                               DEG) for h0, bw in blocks], dim=1)[:, :hid]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


def test_staging_copies_nothing_at_the_model_widths():
    """F = H = 32 and the 4-wide first layer: x and W go to the kernels as
    they are."""
    for feat in (4, 32):
        x_p = torch.zeros((9, feat))
        w = torch.zeros((4, feat, 32))
        xs, slices, ws = gs.stage_width(x_p, w)
        assert xs is x_p and ws is w and slices == ((0, feat, feat),)
