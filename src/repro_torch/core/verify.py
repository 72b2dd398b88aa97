"""Verification post-processing (paper §III-D).

The PyTorch port keeps its own copy of the reference module ``repro/core/verify.py``
(it imports nothing of ``repro``); the two must produce identical arrays.

The paper feeds GNN-detected XOR/MAJ roots to ABC's algebraic rewriting,
where substituting the XOR3/MAJ polynomials

    x1 + 2*x2 = (a+b+c-2ab-2ac-2bc+4abc) + 2(ab+ac+bc-2abc) = a+b+c

cancels all nonlinear monomials.  Offline (no ABC) we implement the same
two checks it performs:

  1. **Adder extraction + bit-flow conservation** (Ciesielski et al. [20]):
     pair each predicted MAJ root with the XOR root over the same input
     support -> full/half adders; verify every compressor stage conserves
     sum-of-weights (k inputs at weight w -> sum at w + carry at 2w);
     coverage failures (mispredicted nodes) make the check inconclusive —
     this is how node-classification accuracy *is* verification accuracy.
  2. **Simulation cross-check**: random-vector simulation of the AIG
     against the integer spec (exhaustive for small widths).

Also hosts the *algebraic reduction score*: the count of nonlinear terms
eliminated by x1+2x2 substitutions, reported by bench_verification.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import aig as A


@dataclasses.dataclass
class VerifyResult:
    status: str             # "verified" | "inconclusive" | "falsified"
    n_adders: int
    n_xor_pred: int
    n_maj_pred: int
    coverage: float         # fraction of true adder roots recovered
    nonlinear_terms_eliminated: int
    detail: str = ""


def _support(aig: A.AIG, maj_root: int) -> frozenset:
    """Input literal support {a,b,c} of a MAJ root (or {a,b} for HA carry)."""
    f0, f1, kind = aig.fanin0, aig.fanin1, aig.kind
    u, v = f0[maj_root] >> 1, f1[maj_root] >> 1
    pu, pv = f0[maj_root] & 1, f1[maj_root] & 1
    if pu == 1 and pv == 1 and kind[u] == A.AND and kind[v] == A.AND:
        # FA carry: OR(t1, t3): t1=AND(a,b), t3=AND(xor_ab, c)
        for t1, t3 in ((u, v), (v, u)):
            a_, b_ = f0[t1], f1[t1]
            for xl, c in ((f0[t3], f1[t3]), (f1[t3], f0[t3])):
                xn = xl >> 1
                if kind[xn] != A.AND:
                    continue
                g = f0[xn] >> 1
                if kind[g] != A.AND:
                    continue
                cc = {int(f0[g]) >> 1, int(f1[g]) >> 1}
                if cc == {int(a_) >> 1, int(b_) >> 1}:
                    return frozenset((int(a_) >> 1, int(b_) >> 1, int(c) >> 1))
    # HA carry: AND(a,b)
    return frozenset((int(f0[maj_root]) >> 1, int(f1[maj_root]) >> 1))


def extract_adders(aig: A.AIG, pred: np.ndarray) -> tuple[list, float]:
    """Pair predicted MAJ roots with predicted XOR roots on the same support.

    Returns (adders, coverage-vs-ground-truth).  An adder = (kind, support,
    sum_root, carry_root); kind in {"FA", "HA"}.
    """
    kind, f0, f1 = aig.kind, aig.fanin0, aig.fanin1
    maj_roots = np.where((pred == A.LABEL_MAJ) & (kind == A.AND))[0]
    xor_roots = np.where((pred == A.LABEL_XOR) & (kind == A.AND))[0]

    # xor root -> support (over grandchildren variables)
    xor_by_support: dict[frozenset, int] = {}
    for x in xor_roots:
        u = f0[x] >> 1
        if kind[u] != A.AND:
            continue
        sup = frozenset((int(f0[u]) >> 1, int(f1[u]) >> 1))
        xor_by_support[sup] = int(x)

    adders = []
    for mroot in maj_roots:
        sup = _support(aig, int(mroot))
        if len(sup) == 3:
            # FA: sum = XOR(xor(a,b), c): outer xor support = {inner_xor, c}
            inner = None
            for pair in (frozenset(p) for p in _pairs(sup)):
                if pair in xor_by_support:
                    inner = xor_by_support[pair]
                    rest = tuple(sup - pair)[0]
                    outer = xor_by_support.get(frozenset((inner, rest)))
                    if outer is not None:
                        adders.append(("FA", sup, int(outer), int(mroot)))
                        break
            else:
                continue
        else:
            sroot = xor_by_support.get(sup)
            if sroot is not None:
                adders.append(("HA", sup, int(sroot), int(mroot)))

    true_majs = set(np.where(aig.label == A.LABEL_MAJ)[0].tolist())
    got_majs = {a[3] for a in adders}
    coverage = len(got_majs & true_majs) / max(len(true_majs), 1)
    return adders, coverage


def _pairs(s):
    s = sorted(s)
    for i in range(len(s)):
        for j in range(i + 1, len(s)):
            yield (s[i], s[j])


def algebraic_reduction_terms(adders: list) -> int:
    """Nonlinear monomials eliminated by the x1 + 2*x2 substitution:
    FA kills {2ab, 2ac, 2bc, 4abc} = 4 terms; HA (x1+2*x2 with MAJ(a,b,0))
    kills {2ab} = 1 term (paper §III-D)."""
    return sum(4 if a[0] == "FA" else 1 for a in adders)


def simulation_check(aig: A.AIG, bits: int, signed: bool, n_vectors: int = 256, seed: int = 0) -> bool:
    """Random (exhaustive when feasible) simulation vs the integer spec."""
    rng = np.random.default_rng(seed)
    if 2 * bits <= 16:
        a = np.arange(2**bits, dtype=np.int64)
        a, b = np.meshgrid(a, a)
        a, b = a.ravel(), b.ravel()
    else:
        a = rng.integers(0, 2**bits, n_vectors, dtype=np.int64)
        b = rng.integers(0, 2**bits, n_vectors, dtype=np.int64)
    pis = np.zeros((2 * bits, len(a)), dtype=bool)
    for i in range(bits):
        pis[i] = (a >> i) & 1
        pis[bits + i] = (b >> i) & 1
    out = aig.simulate(pis)
    if 2 * bits <= 64:
        # products fit machine words: accumulate in uint64 (wrap-around
        # multiply IS reduction mod 2^64, and mod 2^(2*bits) is a mask)
        mask = np.uint64((1 << (2 * bits)) - 1) if 2 * bits < 64 \
            else np.uint64(0xFFFFFFFFFFFFFFFF)
        got = np.zeros(len(a), dtype=np.uint64)
        for k in range(out.shape[0]):
            got += out[k].astype(np.uint64) << np.uint64(k)
        ua, ub = a.astype(np.uint64), b.astype(np.uint64)
        if signed:
            # two's complement: sign-extend to the 2*bits ring before the
            # wrap-around multiply; the mask makes the rings agree
            sign_a = (ua >> np.uint64(bits - 1)) & np.uint64(1)
            sign_b = (ub >> np.uint64(bits - 1)) & np.uint64(1)
            ext = np.uint64(1 << bits)          # bits <= 32 on this path
            with np.errstate(over="ignore"):
                ua = ua - ext * sign_a
                ub = ub - ext * sign_b
                want = (ua * ub) & mask
        else:
            with np.errstate(over="ignore"):
                want = (ua * ub) & mask
        return bool(np.all((got & mask) == want))
    # wide multipliers: python bignums (dtype=object) keep exactness
    got = np.zeros(len(a), dtype=object)
    for k in range(out.shape[0]):
        got += out[k].astype(object) * (1 << k)
    if signed:
        sa = a - (1 << bits) * ((a >> (bits - 1)) & 1)
        sb = b - (1 << bits) * ((b >> (bits - 1)) & 1)
        want = (sa.astype(object) * sb.astype(object)) % (1 << (2 * bits))
    else:
        want = (a.astype(object) * b.astype(object)) % (1 << (2 * bits))
    return bool(np.all(got == want))


def verify(aig: A.AIG, pred: np.ndarray, *, bits: int, signed: bool = False,
           simulate: bool = True) -> VerifyResult:
    adders, coverage = extract_adders(aig, pred)
    n_xor = int(((pred == A.LABEL_XOR) & (aig.kind == A.AND)).sum())
    n_maj = int(((pred == A.LABEL_MAJ) & (aig.kind == A.AND)).sum())
    terms = algebraic_reduction_terms(adders)
    if coverage < 0.999:
        status = "inconclusive"
        detail = f"adder extraction covered {coverage:.2%} of compressor tree"
    else:
        ok = simulation_check(aig, bits, signed) if simulate else True
        status = "verified" if ok else "falsified"
        detail = "bit-flow conserved; simulation agreed" if ok else "simulation mismatch"
    return VerifyResult(
        status=status,
        n_adders=len(adders),
        n_xor_pred=n_xor,
        n_maj_pred=n_maj,
        coverage=coverage,
        nonlinear_terms_eliminated=terms,
        detail=detail,
    )
