"""Fused LD-aggregate + weight-matmul (port of ``repro/kernels/fused_sage.py``).

In GraphSAGE every aggregation is immediately followed by a dense
``(N, F) @ (F, H)`` matmul.  Two CUDA kernels (``csrc/fused_sage.cu``) fuse
the two per LD bucket, the aggregated rows kept in registers (K3, which
contracts them on the tensor cores) or shared memory (K7), never written to
device memory:

  K7 ``fused_ld_matmul``          out (R, H) = rowsum(x_p[cols] * w) @ W
     (the per-group fused path; replaces ``_fused_kernel``)
  K3 ``fused_ld_matmul_grouped``  out (R, H) = sum_g rowsum(wg[:, g] * x_p[cols]) @ W_g
     (the grouped fused path; replaces ``_fused_kernel_grouped``)

Each wrapper runs its plain PyTorch version on a CPU tensor and its kernel on
a CUDA tensor, and counts its kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.groot_spmm import (
    MAX_SMEM,
    check_deg,
    check_out,
    check_staged,
    check_stream,
    check_weight,
    grouped_rowsum,
    ld_bucket_plain,
    on_cuda,
    ptr,
    stream,
)

def check_w_mat(name: str, label: str, w: torch.Tensor, shape: tuple, device) -> None:
    """Reject a weight matrix/stack ``label`` that is not contiguous f32 of
    ``shape`` (its last dim free) on ``device``."""
    if (w.dtype != torch.float32 or w.dim() != len(shape) + 1 or tuple(w.shape[:-1]) != shape
            or not w.is_contiguous() or w.device != device):
        raise ValueError(f"{name}: {label} must be contiguous float32 "
                         f"{shape + ('H',)} on {device}")


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
    :func:`fused_ld_plain`; CUDA tensors launch the kernel.
    """
    rows = check_deg("fused_ld_matmul", cols.shape[0], deg)
    check_weight("fused_ld_matmul", x_p, cols, w, cols.shape[0])
    feat = x_p.shape[1]
    check_w_mat("fused_ld_matmul", "w_mat", w_mat, (feat,), x_p.device)
    # the weights and one aggregate per warp (8 warps) live in shared memory
    smem = 4 * (w_mat.numel() + 8 * feat)
    if smem > MAX_SMEM:
        raise ValueError(f"fused_ld_matmul: {tuple(w_mat.shape)} weights need {smem} B of "
                         f"shared memory, over the {MAX_SMEM} B a block may use")
    hid = w_mat.shape[1]
    if out is None:
        out = torch.empty((rows, hid), dtype=torch.float32, device=x_p.device)
    check_out("fused_ld_matmul", out, (rows, hid), x_p.device)
    if not on_cuda("fused_ld_matmul", x_p):
        out.copy_(fused_ld_plain(x_p, cols, w_mat, deg, w))
        return out
    rc = build.library("fused_sage").fused_ld(
        x_p.data_ptr(), cols.data_ptr(), ptr(w), w_mat.data_ptr(), out.data_ptr(),
        rows, deg, feat, hid, int(x_p.dtype == torch.bfloat16), stream(x_p),
    )
    build.check(rc, "fused_ld_matmul")
    fused_ld_matmul.launches += 1
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
    takes power-of-two degrees, feature widths in ``STAGED_FEATS`` and H a
    multiple of 8 (``check_staged``).
    """
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
    if hid % 8:
        raise ValueError(f"fused_ld_matmul_grouped: H = {hid} is not a multiple of 8")
    lib, bf16 = build.library("fused_sage"), int(x_p.dtype == torch.bfloat16)
    check_staged("fused_ld_matmul_grouped", x_p, cols, wg, deg, out,
                 lib.fused_ld_grouped_smem(g, feat, hid, bf16))
    rc = lib.fused_ld_grouped(
        x_p.data_ptr(), cols.data_ptr(), wg.data_ptr(), w_stack.data_ptr(), out.data_ptr(),
        rows, deg, g, feat, hid, bf16, stream(x_p),
    )
    build.check(rc, "fused_ld_matmul_grouped")
    fused_ld_matmul_grouped.launches += 1
    return out


fused_ld_matmul_grouped.launches = 0
