"""GROOT's 4-bit node features (§III-B).

The PyTorch port keeps its own copy of ``groot_features`` from the reference
module ``repro/core/features.py`` (it imports nothing of ``repro``); the two
must produce identical arrays.

Feature layout (one bit per column, float32 0/1):

  bits[0:2]  node type:     PI -> 00,  internal AND -> 11,  PO -> 0X
             (X = polarity of the PO's single driving edge)
  bits[2:4]  input polarity: AND -> (left_inverted, right_inverted)
             PI -> 00;  PO -> 11  (the paper's worked example: PO m0 = 0011)
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import aig as A


def groot_features(design) -> np.ndarray:
    """4-bit GROOT features for an AIG (or LUTGraph, which generalizes)."""
    if isinstance(design, A.AIG):
        n = design.num_nodes
        feat = np.zeros((n, 4), dtype=np.float32)
        is_and = design.kind == A.AND
        is_po = design.kind == A.PO
        # type bits
        feat[is_and, 0] = 1.0
        feat[is_and, 1] = 1.0
        feat[is_po, 1] = (design.fanin0[is_po] & 1).astype(np.float32)  # 0X
        # polarity bits
        feat[is_and, 2] = (design.fanin0[is_and] & 1).astype(np.float32)
        feat[is_and, 3] = (design.fanin1[is_and] & 1).astype(np.float32)
        feat[is_po, 2] = 1.0
        feat[is_po, 3] = 1.0
        return feat
    # LUTGraph: type bits as for AIG; polarity bits = (any leaf inverted,
    # all leaves inverted) aggregated over the LUT cone's boundary edges.
    n = design.num_nodes
    feat = np.zeros((n, 4), dtype=np.float32)
    is_and = design.kind == A.AND
    is_po = design.kind == A.PO
    feat[is_and, 0] = 1.0
    feat[is_and, 1] = 1.0
    inv_any = np.zeros(n, dtype=bool)
    inv_all = np.ones(n, dtype=bool)
    np.logical_or.at(inv_any, design.edge_dst, design.edge_inv)
    np.logical_and.at(inv_all, design.edge_dst, design.edge_inv)
    has_in = np.zeros(n, dtype=bool)
    has_in[design.edge_dst] = True
    inv_all &= has_in
    feat[is_po, 1] = inv_any[is_po].astype(np.float32)
    feat[is_and, 2] = inv_any[is_and].astype(np.float32)
    feat[is_and, 3] = inv_all[is_and].astype(np.float32)
    feat[is_po, 2] = 1.0
    feat[is_po, 3] = 1.0
    return feat
