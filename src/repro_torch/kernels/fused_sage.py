"""Fused LD-aggregate + weight-matmul (port of ``repro/kernels/fused_sage.py``).

In GraphSAGE every aggregation is immediately followed by a dense
``(N, F) @ (F, H)`` matmul.  One CUDA body (``csrc/fused_sage.cu``) fuses
the two per LD bucket, the aggregated rows kept in registers and contracted
on the tensor cores, never written to device memory; it runs as two
kernels:

  K7 ``fused_ld_matmul``          out (R, H) = rowsum(x_p[cols] * w) @ W
     (the per-group fused path; replaces ``_fused_kernel``)
  K3 ``fused_ld_matmul_grouped``  out (R, H) = sum_g rowsum(wg[:, g] * x_p[cols]) @ W_g
     (the grouped fused path; replaces ``_fused_kernel_grouped``)

Each wrapper runs its plain PyTorch version on a CPU tensor and its kernel on
a CUDA tensor, and counts its kernel launches.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.groot_spmm import (
    PROBE,
    MAX_SMEM,
    SLICE,
    check_deg,
    check_out,
    check_staged,
    check_stream,
    check_weight,
    grouped_rowsum,
    ld_bucket_plain,
    on_cuda,
    ptr,
    refuse_grad,
    stage_width,
    staged_out,
    staged_slice,
    stream,
)

#: the fused body's modes: K3 (weights widened and fused), K7 with a weight
#: (the product rounded to the stream dtype), K7 without one
K3, K7_WEIGHTED, K7_PLAIN = 0, 1, 2


def check_w_mat(name: str, label: str, w: torch.Tensor, shape: tuple, device) -> None:
    """Reject a weight matrix/stack ``label`` that is not contiguous f32 of
    ``shape`` (its last dim free) on ``device``."""
    if (w.dtype != torch.float32 or w.dim() != len(shape) + 1 or tuple(w.shape[:-1]) != shape
            or not w.is_contiguous() or w.device != device):
        raise ValueError(f"{name}: {label} must be contiguous float32 "
                         f"{shape + ('H',)} on {device}")


def column_blocks(hp: int, hb: int) -> list:
    """``(first column, width)`` of each block of a W with ``hp`` columns
    run ``hb`` at a time (both multiples of 32; the last block may be
    narrower)."""
    return [(h0, min(hb, hp - h0)) for h0 in range(0, hp, hb)]


@functools.lru_cache(maxsize=None)
def _smem(groups: int, feat: int, hp: int, mode: int, bf16: int) -> int:
    """Dynamic shared memory of one fused-body block at this shape."""
    return build.library("fused_sage").fused_ld_staged_smem(groups, feat, hp, mode, bf16)


def _staged_fused(name: str, x_p: torch.Tensor, cols: torch.Tensor, wg: Optional[torch.Tensor],
                  w_stack: torch.Tensor, deg: int, out: torch.Tensor, mode: int) -> int:
    """Launch the staged fused body over one bucket, x and W as
    :func:`stage_width` pads them: once per block of W's columns whose two
    TF32 parts fit a block's shared memory (all of W at the model's width)
    and per slice of x, the first slice into ``out`` (through a scratch
    where the block has padded columns or out's rows are off 8-byte
    boundaries), each later one into a scratch added to it.  Returns the
    number of launches."""
    g, hid = w_stack.shape[0], w_stack.shape[2]
    xs, slices, wp = stage_width(x_p, w_stack)
    width, hp = xs.shape[1], wp.shape[2]
    bf16, sw0 = int(xs.dtype == torch.bfloat16), slices[0][1]
    hb = hp
    while hb > SLICE and _smem(g, sw0, hb, mode, bf16) > MAX_SMEM:
        hb -= SLICE
    check_staged(name, xs, cols, wg, deg, _smem(g, sw0, hb, mode, bf16))
    lib, rows = build.library("fused_sage"), cols.shape[0] // deg
    blocks = column_blocks(hp, hb)
    for h0, bw in blocks:
        wb = wp if bw == hp else wp[:, :, h0:h0 + bw].contiguous()
        real = min(bw, hid - h0)
        for i, (c0, sw, _) in enumerate(slices):
            xc = staged_slice(xs, c0, sw)
            dst, scratch = staged_out(out, h0, bw, real if i == 0 else -1, 8)
            rc = lib.fused_ld_staged(
                xc.data_ptr(), cols.data_ptr(), ptr(wg), wb.data_ptr() + 4 * c0 * bw,
                dst.data_ptr(), rows, deg, g, sw, width * bw, bw, dst.stride(0), mode, bf16,
                stream(xs),
            )
            build.check(rc, name)
            PROBE["pallas_calls"] += 1
            if scratch:
                if i == 0:
                    out[:, h0:h0 + real].copy_(dst[:, :real])
                else:
                    out[:, h0:h0 + real] += dst[:, :real]
    return len(slices) * len(blocks)


# ---------------------------------------------------------------------------
# K7: ungrouped fused LD + matmul
# ---------------------------------------------------------------------------

def fused_ld_plain(x_p: torch.Tensor, cols: torch.Tensor, w_mat: torch.Tensor, deg: int,
                   w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K7: the K5 plain version, then ``@ w_mat``."""
    return ld_bucket_plain(x_p, cols, deg, w) @ w_mat.float()


def fused_ld_matmul(x_p: torch.Tensor, cols: torch.Tensor, w_mat: torch.Tensor, deg: int,
                    w: Optional[torch.Tensor] = None, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7: ungrouped fused LD aggregate + matmul over one ELL bucket.

    x_p (N + 1, F) f32/bf16, cols (R * deg,) int32, w_mat (F, H) f32, w
    (R * deg,) of x_p's dtype or None -> ``out`` (R, H) f32 (contiguous
    rows; may be a row slice of a larger buffer).  CPU tensors run
    :func:`fused_ld_plain`; CUDA tensors launch K3's staged body at one
    group (power-of-two degrees), once per slice of :func:`stage_width` and
    per block of W's columns that fits a block's shared memory.
    """
    refuse_grad("fused_ld_matmul", x_p, w_mat, w)
    rows = check_deg("fused_ld_matmul", cols.shape[0], deg)
    check_weight("fused_ld_matmul", x_p, cols, w, cols.shape[0])
    feat = x_p.shape[1]
    check_w_mat("fused_ld_matmul", "w_mat", w_mat, (feat,), x_p.device)
    hid = w_mat.shape[1]
    if out is None:
        out = torch.empty((rows, hid), dtype=torch.float32, device=x_p.device)
    check_out("fused_ld_matmul", out, (rows, hid), x_p.device)
    if not on_cuda("fused_ld_matmul", x_p):
        out.copy_(fused_ld_plain(x_p, cols, w_mat, deg, w))
        return out
    launched = _staged_fused("fused_ld_matmul", x_p, cols, w, w_mat[None], deg,
                             out, K7_PLAIN if w is None else K7_WEIGHTED)
    # added after the call returns, so launches other threads (mesh lanes)
    # count meanwhile are not lost
    fused_ld_matmul.launches += launched
    return out


fused_ld_matmul.launches = 0


# ---------------------------------------------------------------------------
# K3: grouped fused LD + matmul
# ---------------------------------------------------------------------------


def fused_grouped_ref(msgs: torch.Tensor, wg: torch.Tensor, w_stack: torch.Tensor,
                      deg: int) -> torch.Tensor:
    """Oracle on gathered messages: per-group weighted reshape-sum, then
    ``einsum`` against the (G, F, H) stack.  -> (R, H) f32."""
    return torch.einsum("grf,gfh->rh", grouped_rowsum(msgs, wg, deg), w_stack.float())


def fused_ld_grouped_plain(x_p: torch.Tensor, cols: torch.Tensor, wg: torch.Tensor,
                           w_stack: torch.Tensor, deg: int) -> torch.Tensor:
    """Plain PyTorch version of K3: the K1 plain version, then ``einsum``."""
    return fused_grouped_ref(x_p.index_select(0, cols.long()), wg, w_stack, deg)


def fused_ld_matmul_grouped(x_p: torch.Tensor, cols: torch.Tensor, wg: torch.Tensor,
                            w_stack: torch.Tensor, deg: int,
                            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: grouped fused LD aggregate + matmul over one ELL bucket.

    x_p (N + 1, F) f32/bf16, cols (R * deg,) int32, wg (R * deg, G) of
    x_p's dtype, w_stack (G, F, H) f32 -> ``out`` (R, H) f32 (contiguous
    rows; may be a row slice of a larger buffer).  CPU tensors run
    :func:`fused_ld_grouped_plain`; CUDA tensors launch the kernel, which
    takes power-of-two degrees, once per slice of :func:`stage_width` and
    per block of W's columns that fits a block's shared memory.
    """
    refuse_grad("fused_ld_matmul_grouped", x_p, wg, w_stack)
    rows = check_deg("fused_ld_matmul_grouped", cols.shape[0], deg)
    check_stream("fused_ld_matmul_grouped", x_p, cols, wg, cols.shape[0])
    g, feat = wg.shape[1], x_p.shape[1]
    check_w_mat("fused_ld_matmul_grouped", "w_stack", w_stack, (g, feat), x_p.device)
    hid = w_stack.shape[2]
    if out is None:
        out = torch.empty((rows, hid), dtype=torch.float32, device=x_p.device)
    check_out("fused_ld_matmul_grouped", out, (rows, hid), x_p.device)
    if not on_cuda("fused_ld_matmul_grouped", x_p):
        out.copy_(fused_ld_grouped_plain(x_p, cols, wg, w_stack, deg))
        return out
    launched = _staged_fused(
        "fused_ld_matmul_grouped", x_p, cols, wg, w_stack, deg, out, K3)
    # added after the call returns, so launches other threads (mesh lanes)
    # count meanwhile are not lost
    fused_ld_matmul_grouped.launches += launched
    return out


fused_ld_matmul_grouped.launches = 0
