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

The HD body (K2, K6) stages no x: its launches (``groot_spmm._staged_hd``,
the C call stubbed here) pass x where it lies, a slice's first column, x's
row stride and the widest copy piece its rows are aligned to; only bf16
rows of an odd width, which no 4-byte copy can start on, are padded first.
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


# the C entry's arguments (csrc/groot_spmm.cu: groot_hd) that hold x's layout
HD_X, HD_STRIDE, HD_OUT, HD_FEAT, HD_VALID, HD_PIECE = 0, 1, 6, 11, 12, 13


def _hd_launches(monkeypatch, x_p, e_t=8, chunks=6, groups=2):
    """Run ``_staged_hd`` (K2's launches) with the C call recorded, not
    made: (its return value, the recorded argument tuples, out)."""
    calls = []

    class Lib:
        def groot_hd(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(gs.build, "library", lambda name: Lib())
    monkeypatch.setattr(gs, "stream", lambda t: 0)
    cols = torch.zeros(chunks * e_t, dtype=torch.int32)
    wg = torch.zeros((chunks * e_t, groups), dtype=x_p.dtype)
    row_chunks = torch.tensor([[0, 2], [2, 4]], dtype=torch.int32)
    out = torch.empty((groups, 2, x_p.shape[1]))
    n = gs._staged_hd("hd_grouped_apply", x_p, cols, wg, row_chunks, chunks, e_t, out,
                      round_product=False)
    return n, calls, out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("feat", [1, 3, 4, 6, 8, 24, 32, 40, 64])
def test_hd_launches_read_x_in_place(monkeypatch, feat, dtype):
    x_p = torch.zeros((N + 1, feat), dtype=DTYPES[dtype])
    n, calls, out = _hd_launches(monkeypatch, x_p)
    width, slices = gs.staged_slices(feat)
    assert n == len(slices) == len(calls)
    es = x_p.element_size()
    padded = dtype == "bf16" and feat % 2 == 1
    for (c0, sw, valid), args in zip(slices, calls):
        if padded:  # a zero-padded copy of the staged width
            assert args[HD_STRIDE] == width
        else:
            assert args[HD_X] == x_p.data_ptr() + c0 * es and args[HD_STRIDE] == feat
        piece = 1 << args[HD_PIECE]
        assert piece <= sw * es and (args[HD_X] | args[HD_STRIDE] * es) % piece == 0
        assert piece == 16 or (args[HD_X] | args[HD_STRIDE] * es) % (2 * piece) or 2 * piece > sw * es
        assert (args[HD_FEAT], args[HD_VALID]) == (sw, valid)
        assert args[HD_OUT] == out.data_ptr() + 4 * c0


def test_hd_launches_refuse_chunks_off_a_multiple_of_8(monkeypatch):
    with pytest.raises(ValueError, match="multiple of 8"):
        _hd_launches(monkeypatch, torch.zeros((N + 1, 32)), e_t=12)
