"""Grouped fused LD-aggregate + weight-matmul (port of ``repro/kernels/fused_sage.py``).

In GraphSAGE every aggregation is immediately followed by a dense
``(N, F) @ (F, H)`` matmul.  The fused kernel K3 (``csrc/fused_sage.cu``,
replacing ``_fused_kernel_grouped``) computes, per LD bucket,

    out (R, H) = sum_g rowsum(wg[:, g] * x_p[cols]) @ W_g

with the G aggregated rows kept in registers and shared memory: the
(G, R, F) aggregate of the unfused walk is never written to device memory.
The wrapper runs the plain PyTorch version on a CPU tensor and the kernel on
a CUDA tensor, and counts its kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.groot_spmm import check_out, check_stream, grouped_rowsum


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
    rows; may be a row slice of a larger buffer).
    """
    slots = cols.shape[0]
    if deg < 1 or slots % deg:
        raise ValueError(f"fused_ld_matmul_grouped: {slots} slots do not split into rows of {deg}")
    check_stream("fused_ld_matmul_grouped", x_p, cols, wg, slots)
    g, rows, feat = wg.shape[1], slots // deg, x_p.shape[1]
    if (w_stack.dtype != torch.float32 or w_stack.dim() != 3 or w_stack.shape[:2] != (g, feat)
            or not w_stack.is_contiguous() or w_stack.device != x_p.device):
        raise ValueError(f"fused_ld_matmul_grouped: w_stack must be contiguous float32 "
                         f"({g}, {feat}, H) on {x_p.device}")
    hid = w_stack.shape[2]
    if out is None:
        out = torch.empty((rows, hid), dtype=torch.float32, device=x_p.device)
    check_out("fused_ld_matmul_grouped", out, (rows, hid), x_p.device)
    if x_p.device.type == "cpu":
        out.copy_(fused_ld_grouped_plain(x_p, cols, wg, w_stack, deg))
        return out
    if x_p.device.type != "cuda":
        raise ValueError(f"fused_ld_matmul_grouped: no kernel for device {x_p.device}")
    # the weight stack and one (G, F) aggregate per warp live in shared memory
    smem = 4 * (g * feat * hid + 8 * g * feat)
    if smem > 227 * 1024:
        raise ValueError(f"fused_ld_matmul_grouped: ({g}, {feat}, {hid}) weight stack needs "
                         f"{smem} B of shared memory, over the 227 KB a block may use")
    lib = build.library("fused_sage")
    rc = lib.fused_ld_grouped(
        x_p.data_ptr(), cols.data_ptr(), wg.data_ptr(), w_stack.data_ptr(), out.data_ptr(),
        rows, deg, g, feat, hid, int(x_p.dtype == torch.bfloat16),
        torch.cuda.current_stream(x_p.device).cuda_stream,
    )
    build.check(rc, "fused_ld_matmul_grouped")
    fused_ld_matmul_grouped.launches += 1
    return out


fused_ld_matmul_grouped.launches = 0
