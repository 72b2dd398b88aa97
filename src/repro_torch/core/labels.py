"""Ground-truth labels + the classical structural XOR/MAJ detector (port of
``repro/core/labels.py``, host numpy; the two must give identical labels).

Construction-time labels live on ``AIG.label`` (oracle-equivalent to ABC's
labeling — see DESIGN.md §7).  This module adds the *structural detector*:
the classical pattern-matching pass that algebraic-rewriting flows (ABC's
``&polyn`` / GAMORA's teacher) run over a flattened netlist.  It serves two
roles:

  1. independent validation of the construction labels (tests), and
  2. the "classical detector" runtime baseline of benchmark Fig. 10 —
     the thing whose cost the GNN replaces.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import aig as A


def structural_detect(aig: A.AIG) -> np.ndarray:
    """Label every node by local structural pattern matching.

    An AND node ``g = AND(u^pu, v^pv)`` (p* = edge inversions) is:

      * an XOR/XNOR root iff pu=pv=1, u and v are AND nodes, and the
        grandchild literal sets satisfy  {u0,u1} = {~v0,~v1}  — i.e.
        u = AND(x,y), v = AND(~x,~y) up to permutation;
      * a MAJ root iff pu=pv=1 and u,v are ANDs sharing exactly the
        pattern u=AND(a,b), v=AND(xor_root(a,b)^phase, c)  — i.e. the
        OR(ab, c·(a XOR b)) carry shape — or the degenerate HA carry
        (an AND both of whose fanins also feed a sibling XOR root);
      * otherwise a plain AND.

    Vectorized over all nodes with numpy; O(N).
    """
    n = aig.num_nodes
    kind, f0, f1 = aig.kind, aig.fanin0, aig.fanin1
    out = np.full(n, A.LABEL_AND, dtype=np.int8)
    out[kind == A.PI] = A.LABEL_PI
    out[kind == A.PO] = A.LABEL_PO

    is_and = kind == A.AND
    ands = np.where(is_and)[0]
    u, pu = f0[ands] >> 1, f0[ands] & 1
    v, pv = f1[ands] >> 1, f1[ands] & 1
    both_inv = (pu == 1) & (pv == 1)
    u_is_and = is_and[u]
    v_is_and = is_and[v]
    cand = both_inv & u_is_and & v_is_and

    # Grandchild literals (valid only where cand)
    u0 = np.where(cand, f0[u], 0)
    u1 = np.where(cand, f1[u], 0)
    v0 = np.where(cand, f0[v], 0)
    v1 = np.where(cand, f1[v], 0)

    # XOR root: {u0,u1} == {v0^1, v1^1} as sets
    xa = (u0 == (v0 ^ 1)) & (u1 == (v1 ^ 1))
    xb = (u0 == (v1 ^ 1)) & (u1 == (v0 ^ 1))
    is_xor = cand & (xa | xb)
    out[ands[is_xor]] = A.LABEL_XOR

    # MAJ root: AND(~t1, ~t3) where t1 = AND(a,b), t3 = AND(xor(a,b)^ph, c)
    # i.e. one grandchild of t3 is an XOR root over t1's children.
    xor_node = np.zeros(n, dtype=bool)
    xor_node[ands[is_xor]] = True

    def _maj_side(t1, t3):
        """t1 = AND(a,b); t3's children contain an XOR root whose own
        grandchildren literal-set matches {a,b} or {~a,~b}."""
        a_, b_ = f0[t1], f1[t1]
        ok = np.zeros(t1.shape, dtype=bool)
        for gc in (f0[t3] >> 1, f1[t3] >> 1):
            gx = xor_node[gc]
            g0, g1 = f0[gc], f1[gc]
            # XOR root gc has children AND(x,y), AND(~x,~y); recover {x,y}
            c0 = f0[g0 >> 1]
            c1 = f1[g0 >> 1]
            m_pos = (c0 == a_) & (c1 == b_) | (c0 == b_) & (c1 == a_)
            m_neg = (c0 == (a_ ^ 1)) & (c1 == (b_ ^ 1)) | (
                (c0 == (b_ ^ 1)) & (c1 == (a_ ^ 1))
            )
            ok |= gx & is_and[g0 >> 1] & (m_pos | m_neg)
        return ok

    maj = cand & ~is_xor & (_maj_side(u, v) | _maj_side(v, u))
    out[ands[maj]] = A.LABEL_MAJ

    # Degenerate HA carry: in an AIG, a half adder shares its carry AND(a,b)
    # with the XOR decomposition's first child (structural hashing), so the
    # carry is an XOR-root child with *external* fanout (>= 2: the root plus
    # the next compressor stage / PO).  Exclusion: a full adder's t1 = ab is
    # also an XOR-root child with fanout 2, but its extra consumer is the FA
    # MAJ root (consuming it inverted) — an HA carry is never consumed
    # inverted by a MAJ root.
    xr = ands[is_xor]
    if xr.size:
        fanout = np.zeros(n, dtype=np.int64)
        valid0 = f0 >= 0
        valid1 = (f1 >= 0) & (kind == A.AND)
        np.add.at(fanout, f0[valid0] >> 1, 1)
        np.add.at(fanout, f1[valid1] >> 1, 1)
        maj_nodes = np.zeros(n, dtype=bool)
        maj_nodes[ands[maj]] = True
        eaten_by_maj = np.zeros(n, dtype=bool)  # consumed inverted by MAJ root
        for ff in (f0, f1):
            sel = maj_nodes & ((ff & 1) == 1) & (ff >= 0)
            eaten_by_maj[ff[sel] >> 1] = True
        for child in (f0[xr] >> 1, f1[xr] >> 1):
            carry_like = (
                (fanout[child] >= 2)
                & (out[child] == A.LABEL_AND)
                & ~eaten_by_maj[child]
            )
            out[child[carry_like]] = A.LABEL_MAJ
    return out


def label_counts(labels: np.ndarray) -> dict[str, int]:
    c = np.bincount(labels, minlength=A.NUM_CLASSES)
    return {A.LABEL_NAMES[i]: int(c[i]) for i in range(A.NUM_CLASSES)}
