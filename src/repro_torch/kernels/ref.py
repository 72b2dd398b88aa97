"""Plain PyTorch oracles for the SpMM contract (port of ``repro/kernels/ref.py``).

    out[r] = sum over edges e with dst[e] == r of  w[e] * x[src[e]]

which is SpMM ``A @ x`` with ``A[dst, src] = w`` in COO form.  The ``ref``
backend runs on :func:`spmm_ref` and calls no kernel; the HD kernels'
plain versions reduce through :func:`hd_chunk_reduce_ref`, the ungrouped LD
ones through ``groot_spmm.ordered_rowsum`` (:func:`ell_block_reduce_ref`'s
sums in the kernels' slot order).
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


def spmm_dense_ref(x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                   num_nodes: int, w: torch.Tensor | None = None) -> torch.Tensor:
    """Dense-adjacency oracle (O(N^2) memory, tiny graphs only), independent
    of ``index_add_``: cross-validates :func:`spmm_ref` itself."""
    a = torch.zeros((num_nodes, x.shape[0]), dtype=x.dtype, device=x.device)
    vals = torch.ones_like(edge_src, dtype=x.dtype) if w is None else w.to(x.dtype)
    a.index_put_((edge_dst, edge_src), vals, accumulate=True)
    return a @ x


def ell_block_reduce_ref(msgs: torch.Tensor, rows_per_tile, degree: int) -> torch.Tensor:
    """Oracle for the LD kernel body: (R*d, F) padded edge stream -> (R, F)
    row sums.  ``msgs`` rows are grouped per destination row;
    ``rows_per_tile`` is unused (kept for the reference's signature)."""
    del rows_per_tile
    return msgs.reshape(-1, degree, msgs.shape[1]).sum(dim=1)


def hd_chunk_reduce_ref(msgs: torch.Tensor, chunk_rows: torch.Tensor) -> torch.Tensor:
    """Oracle for the HD kernel: msgs (C, E_t, F) chunks, chunk_rows (C,)
    destination row per chunk -> (num_rows, F) accumulated sums."""
    n_rows = int(chunk_rows.max()) + 1 if chunk_rows.numel() else 0
    partial = msgs.sum(dim=1)                                            # (C, F)
    out = torch.zeros((n_rows, msgs.shape[2]), dtype=partial.dtype, device=msgs.device)
    return out.index_add_(0, chunk_rows, partial)
