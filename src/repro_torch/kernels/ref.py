"""Plain PyTorch oracle for the SpMM contract (port of ``repro/kernels/ref.py``).

    out[r] = sum over edges e with dst[e] == r of  w[e] * x[src[e]]

which is SpMM ``A @ x`` with ``A[dst, src] = w`` in COO form.  The ``ref``
backend runs on it and calls no kernel.
"""
from __future__ import annotations

import torch


def spmm_ref(x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
             num_nodes: int, w: torch.Tensor | None = None) -> torch.Tensor:
    """Gather + ``index_add_`` reference (row-parallel SpMM)."""
    msgs = x.index_select(0, edge_src)
    if w is not None:
        msgs = msgs * w[:, None].to(msgs.dtype)
    out = torch.zeros((num_nodes, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, edge_dst, msgs)
