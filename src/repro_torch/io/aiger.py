"""AIGER reader/writer for :class:`repro_torch.core.aig.AIG` (port of
``repro/io/aiger.py``; the bytes written, the arrays parsed and the
structural hashes equal the reference's).

Implements both formats of the AIGER 1.9 combinational subset:

  * ASCII  (``aag M I L O A``): explicit input/output/and lines, any
    gate order (we topologically sort on read);
  * binary (``aig M I L O A``): implicit inputs, delta-compressed
    LEB128 gate encoding, gates guaranteed topologically ordered.

Latches are not supported (the GROOT workload is combinational
multipliers).  Both the AIG and AIGER use the ABC literal convention
``lit = 2*var + inv``, so conversion is a variable renumbering:

  AIGER var 1..I        <->  AIG PI nodes 0..I-1
  AIGER var I+1..I+A    <->  AIG AND nodes, topological order
  AIGER output literals <->  AIG PO nodes (appended after all ANDs)

AIGER carries no node labels, but the GROOT flow needs the
construction-time XOR/MAJ ground truth to score predictions.  Labels are
persisted losslessly through the comment section (``c``) as a
``groot-labels`` digit string (one char per node, reconstructed node
order); files from other producers fall back to the classical structural
detector (:func:`repro_torch.core.labels.structural_detect`).

:func:`structural_hash` — the result cache's and the partition journal's
key — hashes the canonical comment-free binary encoding, so it is invariant
to format, symbol tables, comments, and design names.

The reference writes and parses gate by gate in Python (a few microseconds
a node).  Here the binary writer encodes every gate's LEB128 deltas at once
with numpy, and the binary reader decodes a well-formed AND section the same
way; any file the vectorised decode finds malformed is parsed again by the
reference's gate-by-gate reader, so a bad file raises the same error at the
same byte offset.  The ASCII paths are the reference's.  The reference's
metrics and spans (``repro.obs``) are not ported (ROADMAP Queue 1, item 6).
"""
from __future__ import annotations

import hashlib
import heapq
import io
import os
from typing import Optional, Union

import numpy as np

from repro_torch import faults
from repro_torch.core import aig as A

__all__ = [
    "dump", "dumps", "load", "loads", "peek_name", "source_bytes", "structural_hash",
    "AigerError", "AigerParseError",
]


class AigerError(ValueError):
    """Malformed or unsupported AIGER input."""


class AigerParseError(AigerError):
    """Malformed AIGER *content*, attributed to a byte offset when known:
    a corrupt file comes back as one typed, offset-attributed error, never
    as a bare ``ValueError`` or an unbounded allocation."""

    def __init__(self, message: str, *, offset: Optional[int] = None):
        if offset is not None:
            message = f"{message} (at byte {offset})"
        super().__init__(message)
        self.offset = offset


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _var_map(aig: A.AIG) -> tuple[np.ndarray, np.ndarray]:
    """AIGER variable index per node (PIs 1..I, ANDs I+1.. in node order)."""
    kind = aig.kind
    if not (kind[: aig.n_pi] == A.PI).all() or int((kind == A.PI).sum()) != aig.n_pi:
        raise AigerError("AIG does not keep its PIs in nodes [0, n_pi)")
    and_nodes = np.where(kind == A.AND)[0]
    var = np.zeros(aig.num_nodes, dtype=np.int64)
    var[: aig.n_pi] = np.arange(1, aig.n_pi + 1)
    var[and_nodes] = aig.n_pi + 1 + np.arange(len(and_nodes))
    return var, and_nodes


_CONST_MSG = "constant literals are folded at build time; cannot export"


def _to_aiger_lits(var: np.ndarray, lits: np.ndarray) -> np.ndarray:
    """AIGER literals of node literals; -1 where the literal is a constant."""
    lits = np.asarray(lits, dtype=np.int64)
    safe = np.where(lits < 0, 0, lits)
    return np.where(lits < 0, -1, 2 * var[safe >> 1] + (safe & 1))


def _label_bytes(aig: A.AIG, and_nodes: np.ndarray) -> bytes:
    """Labels in *reconstructed* node order: PIs, ANDs, POs(pos order)."""
    ordered = np.concatenate(
        [aig.label[: aig.n_pi], aig.label[and_nodes], aig.label[aig.pos]]
    )
    return (ordered.astype(np.uint8) + ord("0")).tobytes()


def _encode_leb(values: np.ndarray) -> bytes:
    """LEB128 encoding of non-negative int64 ``values``, concatenated."""
    v = values.astype(np.uint64)
    nb = np.ones(v.shape, dtype=np.int64)
    for s in range(1, 10):
        nb += (v >> np.uint64(7 * s)) > 0
    starts = np.cumsum(nb) - nb
    out = np.empty(int(nb.sum()), dtype=np.uint8)
    for s in range(int(nb.max()) if nb.size else 0):
        sel = nb > s
        byte = (v[sel] >> np.uint64(7 * s)) & np.uint64(0x7F)
        byte |= np.where(nb[sel] > s + 1, np.uint64(0x80), np.uint64(0))
        out[starts[sel] + s] = byte.astype(np.uint8)
    return out.tobytes()


def dumps(aig: A.AIG, *, binary: bool = True, comments: bool = True) -> bytes:
    """Serialize an AIG to AIGER bytes (binary ``aig`` or ASCII ``aag``)."""
    var, and_nodes = _var_map(aig)
    n_and = len(and_nodes)
    m = aig.n_pi + n_and
    outputs = _to_aiger_lits(var, aig.fanin0[aig.pos])
    if (outputs < 0).any():
        raise AigerError(_CONST_MSG)
    r0 = _to_aiger_lits(var, aig.fanin0[and_nodes])
    r1 = _to_aiger_lits(var, aig.fanin1[and_nodes])
    lhs = 2 * (aig.n_pi + 1 + np.arange(n_and, dtype=np.int64))
    hi, lo = np.maximum(r0, r1), np.minimum(r0, r1)
    # the reference raises at the first gate at fault, constants first; the
    # same ordering requirement holds for ASCII: the reader's
    # smallest-var-first topo sort then reproduces this gate order, which
    # the groot-labels comment relies on
    bad = np.flatnonzero((lo < 0) | (hi >= lhs))
    if bad.size:
        k = bad[0]
        raise AigerError(_CONST_MSG if lo[k] < 0 else
                         "AND fanins are not topologically ordered")

    buf = bytearray()
    magic = b"aig" if binary else b"aag"
    buf += b"%s %d %d 0 %d %d\n" % (magic, m, aig.n_pi, len(outputs), n_and)
    if not binary:
        buf += b"".join(b"%d\n" % (2 * (i + 1)) for i in range(aig.n_pi))
    buf += b"".join(b"%d\n" % o for o in outputs.tolist())
    if binary:
        deltas = np.empty(2 * n_and, dtype=np.int64)
        deltas[0::2] = lhs - hi
        deltas[1::2] = hi - lo
        buf += _encode_leb(deltas)
    else:
        buf += "".join(f"{a} {b} {c}\n" for a, b, c in
                       zip(lhs.tolist(), hi.tolist(), lo.tolist())).encode()
    if comments:
        buf += b"c\n"
        buf += b"groot-name %s\n" % aig.name.encode()
        buf += b"groot-labels %s\n" % _label_bytes(aig, and_nodes)
    return bytes(buf)


def dump(aig: A.AIG, path, *, binary: bool = True, comments: bool = True) -> None:
    with open(path, "wb") as f:
        f.write(dumps(aig, binary=binary, comments=comments))


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _read_line(f: io.BytesIO) -> bytes:
    at = f.tell()
    line = f.readline()
    if not line:
        raise AigerParseError("unexpected end of AIGER data", offset=at)
    return line.rstrip(b"\n")


def _read_uint(f: io.BytesIO, what: str) -> int:
    """One non-negative decimal line (output/input literal sections)."""
    at = f.tell()
    line = _read_line(f)
    try:
        value = int(line)
    except ValueError:
        raise AigerParseError(f"bad {what} line {line!r}", offset=at) from None
    if value < 0:
        raise AigerParseError(f"negative {what} {value}", offset=at)
    return value


def _decode_leb(f: io.BytesIO) -> int:
    value, shift = 0, 0
    while True:
        at = f.tell()
        byte = f.read(1)
        if not byte:
            raise AigerParseError("truncated binary AND section", offset=at)
        b = byte[0]
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value
        shift += 7
        if shift > 63:
            # a literal needing >63 bits is corruption, not a big design —
            # bail before the int (and the arrays sized from it) balloon
            raise AigerParseError("LEB128 delta exceeds 64 bits", offset=at)


def _decode_and_section(data: bytes, start: int, n_in: int, n_and: int):
    """Vectorised decode of a binary AND section starting at byte ``start``:
    ``(rhs0, rhs1, end)`` per gate in file order, or None where the section
    is anything but well-formed (truncated, a delta of 9 or more LEB128
    bytes, a fanin not below its gate), so that the gate-by-gate reader
    reports the fault."""
    if n_and == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), start
    buf = np.frombuffer(data, dtype=np.uint8, offset=start)
    ends = np.flatnonzero(buf < 0x80)[: 2 * n_and]
    if ends.size < 2 * n_and:
        return None
    begins = np.concatenate(([0], ends[:-1] + 1))
    lens = ends - begins + 1
    if lens.max() > 8:      # 56 bits: far past any design, and int64-safe
        return None
    vals = np.zeros(2 * n_and, dtype=np.int64)
    for s in range(int(lens.max())):
        sel = lens > s
        vals[sel] |= (buf[begins[sel] + s].astype(np.int64) & 0x7F) << (7 * s)
    d0, d1 = vals[0::2], vals[1::2]
    lhs = 2 * (n_in + 1 + np.arange(n_and, dtype=np.int64))
    if ((d0 == 0) | (d0 > lhs) | (d1 > lhs - d0)).any():
        return None
    rhs0 = lhs - d0
    return rhs0, rhs0 - d1, start + int(ends[-1]) + 1


def _topo_sort_ands(defs: dict[int, tuple[int, int]], n_in: int) -> list[int]:
    """Kahn's algorithm over AND variable definitions (ASCII files may list
    gates in any order).  Smallest ready variable first: a file whose
    variables are already topologically increasing (every writer we know
    of, including ours) round-trips with its gate order intact."""
    indeg = {v: 0 for v in defs}
    users: dict[int, list[int]] = {v: [] for v in defs}
    for v, (r0, r1) in defs.items():
        for r in (r0 >> 1, r1 >> 1):
            if r in defs:
                indeg[v] += 1
                users[r].append(v)
            elif r > n_in and r not in defs:
                raise AigerError(f"undefined AND variable {r}")
    ready = [v for v, d in indeg.items() if d == 0]
    heapq.heapify(ready)
    order: list[int] = []
    while ready:
        v = heapq.heappop(ready)
        order.append(v)
        for u in users[v]:
            indeg[u] -= 1
            if indeg[u] == 0:
                heapq.heappush(ready, u)
    if len(order) != len(defs):
        raise AigerError("cyclic AND definitions")
    return order


def _parse_trailer(f: io.BytesIO) -> dict[str, str]:
    """Symbol table + comment section -> {name, labels} when present."""
    meta: dict[str, str] = {}
    in_comments = False
    for raw in f.read().split(b"\n"):
        line = raw.decode("utf-8", errors="replace")
        if not in_comments:
            if line == "c":
                in_comments = True
            continue
        if line.startswith("groot-name "):
            meta["name"] = line[len("groot-name "):]
        elif line.startswith("groot-labels "):
            meta["labels"] = line[len("groot-labels "):]
    return meta


def peek_name(data: bytes) -> Optional[str]:
    """Cheap name scan: the ``groot-name`` comment line, without parsing
    (for attributing a design whose parse failed)."""
    in_comments = False
    for raw in data.split(b"\n"):
        if not in_comments:
            if raw == b"c":
                in_comments = True
            continue
        if raw.startswith(b"groot-name "):
            return raw[len(b"groot-name "):].decode(
                "utf-8", errors="replace"
            ).strip() or None
    return None


def loads(data: bytes, *, name: str = "aiger") -> A.AIG:
    """Parse AIGER bytes (either format) into an :class:`AIG`."""
    faults.fire("io.parse", tag=lambda: peek_name(data) or name)
    return _loads(data, name=name)


def _loads(data: bytes, *, name: str) -> A.AIG:
    f = io.BytesIO(data)
    header = _read_line(f).split()
    if len(header) < 6 or header[0] not in (b"aig", b"aag"):
        raise AigerParseError(
            "not an AIGER file (want 'aig'/'aag M I L O A' header)", offset=0
        )
    binary = header[0] == b"aig"
    try:
        m, n_in, n_latch, n_out, n_and = (int(x) for x in header[1:6])
    except ValueError as e:
        raise AigerParseError(f"bad header {header!r}", offset=0) from e
    if min(m, n_in, n_latch, n_out, n_and) < 0:
        raise AigerParseError(f"negative header count in {header!r}", offset=0)
    if n_latch:
        raise AigerError("latches are not supported (combinational AIGs only)")
    if m != n_in + n_and:
        raise AigerParseError(f"header M={m} != I+A={n_in + n_and}", offset=0)
    # every declared object costs bytes downstream (≥2 for an AND or an
    # output line) — counts past the file size are corruption, and must
    # be rejected BEFORE they size any allocation
    if max(n_in, n_out, n_and) > len(data):
        raise AigerParseError(
            f"header counts {header!r} exceed file size {len(data)}", offset=0
        )

    if binary:
        out_lits = [_read_uint(f, "output literal") for _ in range(n_out)]
        fast = _decode_and_section(data, f.tell(), n_in, n_and)
        outs = np.asarray(out_lits, dtype=np.int64)
        if fast is not None and (fast[1] >= 2).all() and (
                (outs >= 2) & (outs >> 1 <= m)).all():
            rhs0, rhs1, end = fast
            f.seek(end)
            return _build(n_in, n_and, n_out, rhs1 - 2, rhs0 - 2, outs - 2,
                          _parse_trailer(f), name)
        and_order = list(range(n_in + 1, n_in + n_and + 1))
        defs: dict[int, tuple[int, int]] = {}
        for v in and_order:
            lhs = 2 * v
            at = f.tell()
            d0 = _decode_leb(f)
            d1 = _decode_leb(f)
            rhs0 = lhs - d0
            rhs1 = rhs0 - d1
            if rhs1 < 0 or rhs0 >= lhs:
                raise AigerParseError(f"bad delta encoding for AND {v}", offset=at)
            defs[v] = (rhs0, rhs1)
    else:
        in_lits = [_read_uint(f, "input literal") for _ in range(n_in)]
        for i, lit in enumerate(in_lits):
            if lit != 2 * (i + 1):
                raise AigerError("non-contiguous ASCII input literals unsupported")
        out_lits = [_read_uint(f, "output literal") for _ in range(n_out)]
        defs = {}
        for _ in range(n_and):
            at = f.tell()
            fields = _read_line(f).split()
            try:
                lhs, r0, r1 = (int(x) for x in fields)
            except ValueError:
                raise AigerParseError(
                    f"bad AND line {fields!r} (want 'lhs rhs0 rhs1')", offset=at
                ) from None
            if lhs & 1 or not (n_in + 1 <= lhs >> 1 <= m):
                raise AigerParseError(f"bad AND lhs literal {lhs}", offset=at)
            defs[lhs >> 1] = (r0, r1)
        if len(defs) != n_and:
            raise AigerError("duplicate AND definitions")
        and_order = _topo_sort_ands(defs, n_in)
    meta = _parse_trailer(f)

    # Node layout: PIs, ANDs (topological), then POs.
    node_of_var = np.full(m + 1, -1, dtype=np.int64)
    node_of_var[1 : n_in + 1] = np.arange(n_in)
    for k, v in enumerate(and_order):
        node_of_var[v] = n_in + k

    def conv(lit: int) -> int:
        if lit < 2:
            raise AigerError("constant literals unsupported (fold them upstream)")
        if lit >> 1 > m:
            raise AigerError(f"literal {lit} exceeds max variable index {m}")
        node = int(node_of_var[lit >> 1])
        if node < 0:
            raise AigerError(f"literal {lit} references an undefined variable")
        return 2 * node + (lit & 1)

    lits = np.array([[conv(x) for x in defs[v]] for v in and_order],
                    dtype=np.int64).reshape(-1, 2)
    outs = np.array([conv(o) for o in out_lits], dtype=np.int64)
    return _build(n_in, n_and, n_out, lits.min(axis=1), lits.max(axis=1), outs, meta, name)


def _build(n_in: int, n_and: int, n_out: int, f0: np.ndarray, f1: np.ndarray,
           outs: np.ndarray, meta: dict, name: str) -> A.AIG:
    """The AIG of parsed node literals: PIs, the ANDs with fanins
    ``(f0, f1)`` (``f0 <= f1``) in topological order, then the POs."""
    num_nodes = n_in + n_and + n_out
    kind = np.empty(num_nodes, dtype=np.int8)
    fanin0 = np.full(num_nodes, -3, dtype=np.int64)
    fanin1 = np.full(num_nodes, -3, dtype=np.int64)
    kind[:n_in] = A.PI
    kind[n_in:n_in + n_and] = A.AND
    fanin0[n_in:n_in + n_and] = f0
    fanin1[n_in:n_in + n_and] = f1
    pos = np.arange(n_in + n_and, num_nodes, dtype=np.int64)
    kind[pos] = A.PO
    fanin0[pos] = outs

    label = meta.get("labels", "")
    labels = None  # the structural detector fills them in from the AIG below
    if len(label) == num_nodes:
        labels = np.frombuffer(label.encode(), dtype=np.uint8).astype(np.int8)
        labels -= ord("0")
        if labels.size and (labels.min() < 0 or labels.max() >= A.NUM_CLASSES):
            raise AigerError("corrupt groot-labels comment")

    aig = A.AIG(
        name=meta.get("name", name),
        kind=kind,
        fanin0=fanin0,
        fanin1=fanin1,
        label=labels if labels is not None else np.zeros(num_nodes, np.int8),
        n_pi=n_in,
        pos=pos,
    )
    if labels is None:
        from repro_torch.core.labels import structural_detect

        aig.label = structural_detect(aig)
    return aig


def load(path) -> A.AIG:
    with open(path, "rb") as f:
        data = f.read()
    return loads(data, name=os.path.splitext(os.path.basename(str(path)))[0])


def source_bytes(source) -> bytes:
    """Raw AIGER bytes from raw bytes or a file path (the one normalisation
    of a design given as AIGER)."""
    if isinstance(source, (bytes, bytearray)):
        return bytes(source)
    with open(source, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# Structural hashing (result-cache and journal key)
# ---------------------------------------------------------------------------

def structural_hash(design: Union[A.AIG, bytes]) -> str:
    """Canonical content hash of a design.

    AIGs hash their comment-free binary AIGER encoding, so the same
    structure produces the same key regardless of name, labels, or the
    on-disk format it arrived in.  Raw AIGER bytes are normalised by a
    parse -> re-encode round trip.
    """
    if isinstance(design, (bytes, bytearray)):
        design = loads(bytes(design))
    return hashlib.sha256(dumps(design, binary=True, comments=False)).hexdigest()
