"""And-Inverter Graph construction + arithmetic-circuit generators.

The PyTorch port keeps its own copy of the reference module ``repro/core/aig.py``
(it imports nothing of ``repro``); the two must produce identical arrays.

The paper obtains AIGs by running netlists through ABC.  ABC is unavailable
offline, so we *generate* the same families of designs structurally:

  * CSA (carry-save array) multipliers       (paper Figs. 6a/6b, 8a/8b, 10)
  * Booth (radix-4) multipliers              (paper Figs. 6c, 8c)
  * "technology-mapped" CSA multipliers      (paper Figs. 6d, 8d) — emulated
    with mixed XOR decompositions (irregular local structure, the property
    that makes the mapped dataset hard)
  * FPGA 4-LUT mapped variant                (paper Fig. 7) — a cone-packing
    LUT mapper over the CSA AIG

Ground-truth node labels (PO=0, MAJ=1, XOR=2, AND=3, PI=4 — §III-B) are
known *by construction*: every XOR/MAJ root is created explicitly by the
half-/full-adder builders, which is oracle-equivalent to ABC labeling.

Literals follow the ABC convention: ``lit = 2*node + inv``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.graph import EdgeGraph

# Node kinds
PI, AND, PO = 0, 1, 2
# Node labels (paper §III-B)
LABEL_PO, LABEL_MAJ, LABEL_XOR, LABEL_AND, LABEL_PI = 0, 1, 2, 3, 4
NUM_CLASSES = 5
LABEL_NAMES = ("PO", "MAJ", "XOR", "AND", "PI")

# Literal helpers (lit = 2*node + inv). Constants: we fold them away at build
# time, representing const-0 as lit -2 and const-1 as lit -1.
CONST0, CONST1 = -2, -1


def lit_node(lit: int) -> int:
    return lit >> 1


def lit_inv(lit: int) -> int:
    return lit & 1


def lit_not(lit: int) -> int:
    if lit == CONST0:
        return CONST1
    if lit == CONST1:
        return CONST0
    return lit ^ 1


@dataclasses.dataclass
class AIG:
    """A built AIG with construction-time labels.

    ``fanin0/fanin1`` store literals (2*node+inv); PIs have -3 sentinels,
    POs use only fanin0.
    """

    name: str
    kind: np.ndarray      # int8 (N,)  PI/AND/PO
    fanin0: np.ndarray    # int64 (N,) literal
    fanin1: np.ndarray    # int64 (N,) literal
    label: np.ndarray     # int8 (N,)
    n_pi: int
    pos: np.ndarray       # int64 (num_po,) node-ids of POs in output-bit order

    @property
    def num_nodes(self) -> int:
        return int(self.kind.shape[0])

    @property
    def num_ands(self) -> int:
        return int((self.kind == AND).sum())

    def to_edge_graph(self) -> EdgeGraph:
        """Directed fanin->node edges with inversion flags (the EDA graph)."""
        is_and = self.kind == AND
        is_po = self.kind == PO
        dst_and = np.where(is_and)[0]
        dst_po = np.where(is_po)[0]
        src = np.concatenate(
            [
                self.fanin0[dst_and] >> 1,
                self.fanin1[dst_and] >> 1,
                self.fanin0[dst_po] >> 1,
            ]
        )
        dst = np.concatenate([dst_and, dst_and, dst_po])
        inv = np.concatenate(
            [
                self.fanin0[dst_and] & 1,
                self.fanin1[dst_and] & 1,
                self.fanin0[dst_po] & 1,
            ]
        ).astype(bool)
        slot = np.concatenate(
            [
                np.zeros(len(dst_and), np.uint8),
                np.ones(len(dst_and), np.uint8),
                np.zeros(len(dst_po), np.uint8),
            ]
        )
        order = np.argsort(dst, kind="stable")
        return EdgeGraph(
            self.num_nodes,
            src[order].astype(np.int32),
            dst[order].astype(np.int32),
            inv[order],
            slot[order],
        )

    def simulate(self, pi_values: np.ndarray) -> np.ndarray:
        """Bit-parallel simulation.

        ``pi_values``: bool/uint (n_pi, batch).  Returns (num_po, batch).
        Nodes are in topological order by construction.
        """
        n, b = self.num_nodes, pi_values.shape[1]
        val = np.zeros((n, b), dtype=bool)
        val[: self.n_pi] = pi_values.astype(bool)
        kind, f0, f1 = self.kind, self.fanin0, self.fanin1

        def lit_val(lit_arr, mask):
            node = lit_arr[mask] >> 1
            inv = (lit_arr[mask] & 1).astype(bool)
            return val[node] ^ inv[:, None]

        # Topological order == node-id order; evaluate in chunks of same-kind
        # runs for speed (simple loop is fine for tests; vectorized by level).
        level = np.zeros(n, dtype=np.int32)
        and_nodes = np.where(kind == AND)[0]
        for i in and_nodes:  # levels computed cheaply
            level[i] = 1 + max(level[f0[i] >> 1], level[f1[i] >> 1])
        max_level = level.max() if len(and_nodes) else 0
        for lv in range(1, max_level + 1):
            mask = (kind == AND) & (level == lv)
            if not mask.any():
                continue
            a = lit_val(f0, mask)
            bb = lit_val(f1, mask)
            val[mask] = a & bb
        po_mask = kind == PO
        val[po_mask] = lit_val(f0, po_mask)
        return val[self.pos]


class AIGBuilder:
    """Incremental AIG builder with constant folding + structural hashing."""

    def __init__(self, name: str = "aig"):
        self.name = name
        self.kind: list[int] = []
        self.fanin0: list[int] = []
        self.fanin1: list[int] = []
        self.label: list[int] = []
        self.pos: list[int] = []
        self.n_pi = 0
        self._strash: dict[tuple[int, int], int] = {}

    def add_pi(self) -> int:
        self.kind.append(PI)
        self.fanin0.append(-3)
        self.fanin1.append(-3)
        self.label.append(LABEL_PI)
        self.n_pi += 1
        return 2 * (len(self.kind) - 1)

    def add_and(self, a: int, b: int, label: int = LABEL_AND) -> int:
        # constant folding
        if a == CONST0 or b == CONST0:
            return CONST0
        if a == CONST1:
            return b
        if b == CONST1:
            return a
        if a == b:
            return a
        if a == lit_not(b):
            return CONST0
        key = (min(a, b), max(a, b))
        hit = self._strash.get(key)
        if hit is not None:
            node = hit
            # upgrade label if a structural root is re-derived (keep strongest)
            if label != LABEL_AND and self.label[node] == LABEL_AND:
                self.label[node] = label
            return 2 * node
        self.kind.append(AND)
        self.fanin0.append(key[0])
        self.fanin1.append(key[1])
        self.label.append(label)
        node = len(self.kind) - 1
        self._strash[key] = node
        return 2 * node

    def add_po(self, lit: int) -> int:
        assert lit >= 0, "constant PO should not occur in generated designs"
        self.kind.append(PO)
        self.fanin0.append(lit)
        self.fanin1.append(-3)
        self.label.append(LABEL_PO)
        node = len(self.kind) - 1
        self.pos.append(node)
        return node

    # -- gate macros ---------------------------------------------------------
    def or_(self, a: int, b: int, label: int = LABEL_AND) -> int:
        return lit_not(self.add_and(lit_not(a), lit_not(b), label=label))

    def xor2(self, a: int, b: int, decomp: int = 0) -> int:
        """XOR with an explicitly-labeled root.

        decomp 0: XOR  = AND(NOT(ab), NOT(a'b'))  = (a'+b')(a+b) = a'b+ab'
        decomp 1: XNOR = AND(NOT(ab'), NOT(a'b))  → XOR is its complement
        Either way the root AND node (an XOR/XNOR function root up to phase)
        carries LABEL_XOR — exactly what the GNN must detect.
        """
        if a in (CONST0, CONST1) or b in (CONST0, CONST1):
            if a == CONST0:
                return b
            if a == CONST1:
                return lit_not(b)
            if b == CONST0:
                return a
            return lit_not(a)
        if a == b:
            return CONST0
        if a == lit_not(b):
            return CONST1
        if decomp == 0:
            n1 = self.add_and(a, b)
            n2 = self.add_and(lit_not(a), lit_not(b))
            root = self.add_and(lit_not(n1), lit_not(n2), label=LABEL_XOR)
            return root
        n1 = self.add_and(a, lit_not(b))
        n2 = self.add_and(lit_not(a), b)
        root = self.add_and(lit_not(n1), lit_not(n2), label=LABEL_XOR)
        return lit_not(root)

    def half_adder(self, a: int, b: int, decomp: int = 0) -> tuple[int, int]:
        """(sum, carry).  carry=AND(a,b) is a degenerate MAJ(a,b,0) — the
        paper labels HA carries as MAJ (nodes 8/12 of the 2-bit example)."""
        s = self.xor2(a, b, decomp=decomp)
        c = self.add_and(a, b, label=LABEL_MAJ)
        return s, c

    def full_adder(self, a: int, b: int, c: int, decomp: int = 0) -> tuple[int, int]:
        """(sum, carry) with shared XOR(a,b):
        sum = XOR(XOR(a,b),c);  carry = ab OR c*XOR(a,b)  (the MAJ root).
        """
        x_ab = self.xor2(a, b, decomp=decomp)
        s = self.xor2(x_ab, c, decomp=decomp)
        t1 = self.add_and(a, b)
        t3 = self.add_and(x_ab, c)
        carry = self.or_(t1, t3, label=LABEL_MAJ)
        return s, carry

    def build(self) -> AIG:
        return AIG(
            name=self.name,
            kind=np.asarray(self.kind, dtype=np.int8),
            fanin0=np.asarray(self.fanin0, dtype=np.int64),
            fanin1=np.asarray(self.fanin1, dtype=np.int64),
            label=np.asarray(self.label, dtype=np.int8),
            n_pi=self.n_pi,
            pos=np.asarray(self.pos, dtype=np.int64),
        )


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def _column_compress(
    b: AIGBuilder, cols: list[list[int]], rng: Optional[np.random.Generator], mixed: bool
) -> list[list[int]]:
    """Carry-save (Wallace-style 3:2 / 2:2) compression until <=2 per column."""
    def pick():
        return int(rng.integers(0, 2)) if (mixed and rng is not None) else 0

    while max(len(c) for c in cols) > 2:
        nxt: list[list[int]] = [[] for _ in range(len(cols) + 1)]
        for ci, col in enumerate(cols):
            i = 0
            while len(col) - i >= 3:
                s, cy = b.full_adder(col[i], col[i + 1], col[i + 2], decomp=pick())
                nxt[ci].append(s)
                nxt[ci + 1].append(cy)
                i += 3
            if len(col) - i == 2:
                s, cy = b.half_adder(col[i], col[i + 1], decomp=pick())
                nxt[ci].append(s)
                nxt[ci + 1].append(cy)
                i += 2
            nxt[ci].extend(col[i:])
        while nxt and not nxt[-1]:
            nxt.pop()
        cols = nxt
    return cols


def _final_cpa(
    b: AIGBuilder, cols: list[list[int]], rng: Optional[np.random.Generator], mixed: bool
) -> list[int]:
    """Ripple-carry adder over the two remaining carry-save rows."""
    def pick():
        return int(rng.integers(0, 2)) if (mixed and rng is not None) else 0

    out: list[int] = []
    carry = CONST0
    for col in cols:
        ops = list(col)
        if carry != CONST0:
            ops.append(carry)
        if not ops:
            out.append(CONST0)
            carry = CONST0
        elif len(ops) == 1:
            out.append(ops[0])
            carry = CONST0
        elif len(ops) == 2:
            s, carry = b.half_adder(ops[0], ops[1], decomp=pick())
            out.append(s)
        else:
            s, carry = b.full_adder(ops[0], ops[1], ops[2], decomp=pick())
            out.append(s)
    if carry != CONST0:
        out.append(carry)
    return out


def csa_multiplier(bits: int, mixed_decomp: bool = False, seed: int = 0) -> AIG:
    """n-bit unsigned carry-save-array multiplier AIG.

    ``mixed_decomp=True`` emulates the post-technology-mapping dataset: XOR
    decompositions are chosen per-gate at random, producing the local
    irregularity that makes the paper's 7nm-mapped dataset harder.
    """
    rng = np.random.default_rng(seed) if mixed_decomp else None
    name = f"{'mapped' if mixed_decomp else 'csa'}_mult_{bits}b"
    b = AIGBuilder(name)
    a_in = [b.add_pi() for _ in range(bits)]
    b_in = [b.add_pi() for _ in range(bits)]
    cols: list[list[int]] = [[] for _ in range(2 * bits)]
    for i in range(bits):
        for j in range(bits):
            cols[i + j].append(b.add_and(a_in[i], b_in[j]))
    cols = _column_compress(b, cols, rng, mixed_decomp)
    out = _final_cpa(b, cols, rng, mixed_decomp)
    for k in range(2 * bits):
        b.add_po(out[k] if k < len(out) else CONST0)
    return b.build()


def booth_multiplier(bits: int, seed: int = 0) -> AIG:
    """Radix-4 Booth-encoded signed multiplier (two's complement).

    Booth digits d_k = -2*y_{2k+1} + y_{2k} + y_{2k-1} in {-2,-1,0,1,2};
    each partial product is a MUX network (one&B_j | two&B_{j-1}) with
    conditional inversion + "+1" correction — the denser, more irregular
    graphs of the paper's Booth dataset.  Sign handling uses full sign
    extension modulo 2^(2n) (functionally identical to the !s,s,s trick).
    """
    assert bits % 2 == 0, "radix-4 booth needs even width"
    del seed
    b = AIGBuilder(f"booth_mult_{bits}b")
    a_in = [b.add_pi() for _ in range(bits)]
    b_in = [b.add_pi() for _ in range(bits)]
    width = 2 * bits
    cols: list[list[int]] = [[] for _ in range(width)]

    def b_at(j: int) -> int:
        if j < 0:
            return CONST0
        if j >= bits:
            return b_in[bits - 1]  # sign extension of multiplicand B
        return b_in[j]

    for k in range(bits // 2):
        y0 = a_in[2 * k - 1] if 2 * k - 1 >= 0 else CONST0
        y1 = a_in[2 * k]
        y2 = a_in[2 * k + 1] if 2 * k + 1 < bits else a_in[bits - 1]
        one = b.xor2(y0, y1)                               # |d|=1
        two = b.add_and(b.xor2(y2, y1), lit_not(one))      # |d|=2
        neg = y2                                            # d<0 (or d=0, harmless)
        shift = 2 * k
        p_top = CONST0
        for j in range(bits + 1):                           # v is (n+1)-bit signed
            t1 = b.add_and(one, b_at(j))
            t2 = b.add_and(two, b_at(j - 1))
            v = b.or_(t1, t2)
            p = b.xor2(v, neg)                              # conditional invert
            if shift + j < width:
                cols[shift + j].append(p)
            if j == bits:
                p_top = p
        for j in range(bits + 1, width - shift):            # full sign extension
            cols[shift + j].append(p_top)
        cols[shift].append(neg)                             # "+1" completes negation

    cols = _column_compress(b, cols, None, False)
    out = _final_cpa(b, cols, None, False)
    for k in range(width):
        b.add_po(out[k] if k < len(out) else CONST0)
    return b.build()


# ---------------------------------------------------------------------------
# FPGA 4-LUT mapping (paper Fig. 7): greedy cone packing of the AIG into
# <=K-input LUTs. The LUT graph keeps the label of each LUT's root AIG node.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LUTGraph:
    name: str
    num_nodes: int
    n_pi: int
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_inv: np.ndarray   # polarity of cone leaf edges (root-phase aggregated)
    label: np.ndarray
    kind: np.ndarray       # PI / AND(=LUT) / PO

    def to_edge_graph(self) -> EdgeGraph:
        # LUT fanin "slots": position parity within the sorted leaf list (a
        # degraded ordering signal — real LUT pins are symmetric anyway).
        order = np.argsort(self.edge_dst, kind="stable")
        dst_sorted = self.edge_dst[order]
        pos = np.arange(len(dst_sorted))
        starts = np.zeros(self.num_nodes, dtype=np.int64)
        first = np.ones(len(dst_sorted), dtype=bool)
        first[1:] = dst_sorted[1:] != dst_sorted[:-1]
        starts[dst_sorted[first]] = pos[first]
        slot = ((pos - starts[dst_sorted]) % 2).astype(np.uint8)
        return EdgeGraph(
            self.num_nodes,
            self.edge_src[order],
            self.edge_dst[order],
            self.edge_inv[order],
            slot,
        )


def fpga_lut_map(aig: AIG, k: int = 4) -> LUTGraph:
    """Greedy topological K-feasible cone packing (a simple FlowMap-lite)."""
    n = aig.num_nodes
    kind, f0, f1 = aig.kind, aig.fanin0, aig.fanin1
    # cut[i] = frozenset of leaf node-ids of the cone rooted at i
    cut: list[frozenset] = [frozenset()] * n
    is_root = np.zeros(n, dtype=bool)
    for i in range(n):
        if kind[i] == PI:
            cut[i] = frozenset((i,))
            is_root[i] = True
        elif kind[i] == AND:
            c0, c1 = cut[f0[i] >> 1], cut[f1[i] >> 1]
            merged = c0 | c1
            if len(merged) <= k:
                cut[i] = merged
            else:
                cut[i] = frozenset((f0[i] >> 1, f1[i] >> 1))
                is_root[f0[i] >> 1] = True
                is_root[f1[i] >> 1] = True
        else:  # PO
            is_root[f0[i] >> 1] = True
            cut[i] = frozenset((i,))
    is_root |= kind == PO
    roots = np.where(is_root)[0]
    remap = -np.ones(n, dtype=np.int64)
    remap[roots] = np.arange(len(roots))
    src, dst, inv = [], [], []
    for new_i, i in enumerate(roots):
        if kind[i] == PI:
            continue
        if kind[i] == PO:
            src.append(remap[f0[i] >> 1])
            dst.append(new_i)
            inv.append(bool(f0[i] & 1))
            continue
        for leaf in sorted(cut[i]):
            src.append(remap[leaf])
            dst.append(new_i)
            inv.append(False)
    order = np.argsort(np.asarray(dst), kind="stable")
    return LUTGraph(
        name=f"fpga{k}lut_{aig.name}",
        num_nodes=len(roots),
        n_pi=int((kind[roots] == PI).sum()),
        edge_src=np.asarray(src, dtype=np.int32)[order],
        edge_dst=np.asarray(dst, dtype=np.int32)[order],
        edge_inv=np.asarray(inv, dtype=bool)[order],
        label=aig.label[roots].copy(),
        kind=aig.kind[roots].copy(),
    )


DATASETS = ("csa", "booth", "mapped", "fpga")


def make_design(dataset: str, bits: int, seed: int = 0):
    """Uniform entry point used by the pipeline/benchmarks."""
    if dataset == "csa":
        return csa_multiplier(bits)
    if dataset == "booth":
        return booth_multiplier(bits, seed=seed)
    if dataset == "mapped":
        return csa_multiplier(bits, mixed_decomp=True, seed=seed)
    if dataset == "fpga":
        return fpga_lut_map(csa_multiplier(bits))
    raise ValueError(f"unknown dataset {dataset!r} (want one of {DATASETS})")
