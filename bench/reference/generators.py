"""Frozen copy of the multiplier generators the benchmark's designs come from.

The csa (carry-save array) and radix-4 Booth multiplier AIGs, built with
constant folding and structural hashing exactly as the program's own
generators built them when the benchmark was written, so that a later change
to the program cannot change the benchmark's inputs.  A design is returned as
plain arrays (``kind``, ``fanin0``, ``fanin1``, ``label``, ``pos``, ``n_pi``,
``name``); literals are ``2 * node + inverted``; nodes are in topological
order.  Node kinds: PI 0, AND 1, PO 2.  Labels: PO 0, MAJ 1, XOR 2, AND 3,
PI 4.
"""
from __future__ import annotations

import numpy as np

PI, AND, PO = 0, 1, 2
LABEL_PO, LABEL_MAJ, LABEL_XOR, LABEL_AND, LABEL_PI = 0, 1, 2, 3, 4
CONST0, CONST1 = -2, -1


def lit_not(lit: int) -> int:
    if lit == CONST0:
        return CONST1
    if lit == CONST1:
        return CONST0
    return lit ^ 1


class Builder:
    """Incremental AIG builder with constant folding and structural hashing."""

    def __init__(self, name: str):
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
            if label != LABEL_AND and self.label[hit] == LABEL_AND:
                self.label[hit] = label
            return 2 * hit
        self.kind.append(AND)
        self.fanin0.append(key[0])
        self.fanin1.append(key[1])
        self.label.append(label)
        node = len(self.kind) - 1
        self._strash[key] = node
        return 2 * node

    def add_po(self, lit: int) -> None:
        if lit < 0:
            raise ValueError("a generated design has no constant output")
        self.kind.append(PO)
        self.fanin0.append(lit)
        self.fanin1.append(-3)
        self.label.append(LABEL_PO)
        self.pos.append(len(self.kind) - 1)

    def or_(self, a: int, b: int, label: int = LABEL_AND) -> int:
        return lit_not(self.add_and(lit_not(a), lit_not(b), label=label))

    def xor2(self, a: int, b: int) -> int:
        """XOR as AND(NOT(ab), NOT(a'b')), its root labelled XOR."""
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
        n1 = self.add_and(a, b)
        n2 = self.add_and(lit_not(a), lit_not(b))
        return self.add_and(lit_not(n1), lit_not(n2), label=LABEL_XOR)

    def half_adder(self, a: int, b: int) -> tuple[int, int]:
        return self.xor2(a, b), self.add_and(a, b, label=LABEL_MAJ)

    def full_adder(self, a: int, b: int, c: int) -> tuple[int, int]:
        x_ab = self.xor2(a, b)
        s = self.xor2(x_ab, c)
        t1 = self.add_and(a, b)
        t3 = self.add_and(x_ab, c)
        return s, self.or_(t1, t3, label=LABEL_MAJ)

    def build(self) -> dict:
        return {
            "name": self.name,
            "kind": np.asarray(self.kind, dtype=np.int8),
            "fanin0": np.asarray(self.fanin0, dtype=np.int64),
            "fanin1": np.asarray(self.fanin1, dtype=np.int64),
            "label": np.asarray(self.label, dtype=np.int8),
            "n_pi": self.n_pi,
            "pos": np.asarray(self.pos, dtype=np.int64),
        }


def _compress(b: Builder, cols: list[list[int]]) -> list[list[int]]:
    """Carry-save 3:2 / 2:2 compression until at most two bits a column."""
    while max(len(c) for c in cols) > 2:
        nxt: list[list[int]] = [[] for _ in range(len(cols) + 1)]
        for ci, col in enumerate(cols):
            i = 0
            while len(col) - i >= 3:
                s, cy = b.full_adder(col[i], col[i + 1], col[i + 2])
                nxt[ci].append(s)
                nxt[ci + 1].append(cy)
                i += 3
            if len(col) - i == 2:
                s, cy = b.half_adder(col[i], col[i + 1])
                nxt[ci].append(s)
                nxt[ci + 1].append(cy)
                i += 2
            nxt[ci].extend(col[i:])
        while nxt and not nxt[-1]:
            nxt.pop()
        cols = nxt
    return cols


def _ripple(b: Builder, cols: list[list[int]]) -> list[int]:
    """Ripple-carry adder over the two carry-save rows left."""
    out: list[int] = []
    carry = CONST0
    for col in cols:
        ops = list(col) + ([carry] if carry != CONST0 else [])
        if not ops:
            out.append(CONST0)
            carry = CONST0
        elif len(ops) == 1:
            out.append(ops[0])
            carry = CONST0
        elif len(ops) == 2:
            s, carry = b.half_adder(ops[0], ops[1])
            out.append(s)
        else:
            s, carry = b.full_adder(ops[0], ops[1], ops[2])
            out.append(s)
    if carry != CONST0:
        out.append(carry)
    return out


def csa(bits: int) -> dict:
    """``bits``-bit unsigned carry-save-array multiplier."""
    b = Builder(f"csa_mult_{bits}b")
    a_in = [b.add_pi() for _ in range(bits)]
    b_in = [b.add_pi() for _ in range(bits)]
    cols: list[list[int]] = [[] for _ in range(2 * bits)]
    for i in range(bits):
        for j in range(bits):
            cols[i + j].append(b.add_and(a_in[i], b_in[j]))
    out = _ripple(b, _compress(b, cols))
    for k in range(2 * bits):
        b.add_po(out[k] if k < len(out) else CONST0)
    return b.build()


def booth(bits: int) -> dict:
    """``bits``-bit radix-4 Booth multiplier, two's complement, full sign
    extension."""
    if bits % 2:
        raise ValueError("radix-4 Booth needs an even width")
    b = Builder(f"booth_mult_{bits}b")
    a_in = [b.add_pi() for _ in range(bits)]
    b_in = [b.add_pi() for _ in range(bits)]
    width = 2 * bits
    cols: list[list[int]] = [[] for _ in range(width)]

    def b_at(j: int) -> int:
        if j < 0:
            return CONST0
        return b_in[min(j, bits - 1)]

    for k in range(bits // 2):
        y0 = a_in[2 * k - 1] if 2 * k - 1 >= 0 else CONST0
        y1 = a_in[2 * k]
        y2 = a_in[2 * k + 1] if 2 * k + 1 < bits else a_in[bits - 1]
        one = b.xor2(y0, y1)
        two = b.add_and(b.xor2(y2, y1), lit_not(one))
        neg = y2
        shift = 2 * k
        p_top = CONST0
        for j in range(bits + 1):
            v = b.or_(b.add_and(one, b_at(j)), b.add_and(two, b_at(j - 1)))
            p = b.xor2(v, neg)
            if shift + j < width:
                cols[shift + j].append(p)
            if j == bits:
                p_top = p
        for j in range(bits + 1, width - shift):
            cols[shift + j].append(p_top)
        cols[shift].append(neg)
    out = _ripple(b, _compress(b, cols))
    for k in range(width):
        b.add_po(out[k] if k < len(out) else CONST0)
    return b.build()


GENERATORS = {"csa": csa, "booth": booth}
