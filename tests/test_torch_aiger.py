"""The port's AIGER reader/writer and structural detector against the
reference's (``repro/io/aiger.py``, ``repro/core/labels.py``).

Bytes written, arrays parsed, structural hashes and detector labels must be
identical, and a malformed file must be rejected with the same error class,
message and byte offset (the port's binary reader decodes with numpy and
falls back to the reference's gate-by-gate reader on a malformed section).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aig as RA  # noqa: E402
from repro.core import labels as RL  # noqa: E402
from repro.io import aiger as RI  # noqa: E402
from repro_torch import faults as TF  # noqa: E402
from repro_torch.core import aig as TA  # noqa: E402
from repro_torch.core import labels as TL  # noqa: E402
from repro_torch.io import aiger as TI  # noqa: E402

FIELDS = ("kind", "fanin0", "fanin1", "label", "pos")
DESIGNS = [(f, b) for f in ("csa", "booth") for b in (8, 16, 32)]


def assert_same_aig(got, want):
    for f in FIELDS:
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (got.name, got.n_pi) == (want.name, want.n_pi)


def outcome(mod, blob):
    """What parsing ``blob`` gives: the arrays, or the error's class name,
    message and offset."""
    try:
        a = mod.loads(blob)
    except Exception as e:  # noqa: BLE001 — the outcome is what is compared
        return type(e).__name__, str(e), getattr(e, "offset", None)
    return "ok", tuple(getattr(a, f).tobytes() for f in FIELDS), a.name


@pytest.mark.parametrize("comments", [True, False], ids=["comments", "bare"])
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("family,bits", DESIGNS)
def test_dumps_and_loads_identical_to_reference(family, bits, binary, comments):
    ref, port = RA.make_design(family, bits), TA.make_design(family, bits)
    want = RI.dumps(ref, binary=binary, comments=comments)
    assert TI.dumps(port, binary=binary, comments=comments) == want
    # both ways across packages: each parses the other's bytes the same
    assert_same_aig(TI.loads(want), RI.loads(want))
    assert_same_aig(TI.loads(want), RI.loads(TI.dumps(port, binary=binary, comments=comments)))


def test_mixed_decomp_round_trip_identical():
    ref = RA.csa_multiplier(6, mixed_decomp=True, seed=3)
    port = TA.csa_multiplier(6, mixed_decomp=True, seed=3)
    data = RI.dumps(ref)
    assert TI.dumps(port) == data
    back = TI.loads(data)
    assert_same_aig(back, RI.loads(data))
    v = np.random.default_rng(0).integers(0, 2, (port.n_pi, 64)).astype(bool)
    np.testing.assert_array_equal(back.simulate(v), port.simulate(v))


@pytest.mark.parametrize("family,bits", DESIGNS)
def test_structural_hash_identical(family, bits):
    ref, port = RA.make_design(family, bits), TA.make_design(family, bits)
    h = RI.structural_hash(ref)
    assert TI.structural_hash(port) == h
    assert TI.structural_hash(RI.dumps(ref, binary=False)) == h
    assert TI.structural_hash(TA.make_design(family, bits + 2)) != h


@pytest.mark.parametrize("family,bits,seed", [("csa", 6, 0), ("csa", 12, 0), ("booth", 8, 0),
                                              ("mapped", 8, 3)])
def test_structural_detect_identical(family, bits, seed):
    ref, port = RA.make_design(family, bits, seed=seed), TA.make_design(family, bits, seed=seed)
    got, want = TL.structural_detect(port), RL.structural_detect(ref)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert TL.label_counts(got) == RL.label_counts(want)
    # a file without the groot comments takes its labels from the detector
    back = TI.loads(RI.dumps(ref, comments=False))
    np.testing.assert_array_equal(back.label, want)


def _mutations(good: bytes, seed: int, flips: int):
    rng = np.random.default_rng(seed)
    cases = [good[:n] for n in range(0, len(good), 5)]
    for _ in range(flips):
        buf = bytearray(good)
        for _ in range(rng.integers(1, 4)):
            buf[rng.integers(0, len(buf))] = rng.integers(0, 256)
        cases.append(bytes(buf))
    return cases


MALFORMED = [
    b"not an aiger file\n",
    b"aag 1 1 1 0 0\n2\n",                          # latches unsupported
    b"aag 2 1 0 1 1\n2\n4\n4 2 6\n",                # undefined var in AND
    b"aig 5 2 0 1 -3\n",
    b"aig 999999999 2 0 1 999999997\n",             # counts past the file size
    b"aig x y z\n",
    b"aag 3 2 0 1 1\n2\n4\n6\n6 4 banana\n",
    b"aig 3 2 0 1 1\n6\n" + bytes([0x82] + [0x80] * 9 + [0x01, 0x01]),  # > 64-bit delta
    b"aig 3 2 0 1 1\n6\n" + bytes([0x82] + [0x80] * 7 + [0x00, 0x01]),  # 9-byte delta
    b"aig 3 2 0 1 1\n1\n" + bytes([2, 2]),          # constant output
    b"aig 3 2 0 1 1\n6\n" + bytes([5, 0]),          # fanin above its gate
    b"aig 3 2 0 1 1\n9\n" + bytes([2, 2]),          # output past M
    b"aig 3 2 0 1 1\n6\n" + bytes([2, 1]),          # constant fanin
]


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_malformed_inputs_rejected_identically(binary):
    """Truncations, byte flips and hand-made faults: the port parses what
    the reference parses, to the same arrays, and rejects the rest with the
    same error class (the port's own), message and offset."""
    good = RI.dumps(RA.csa_multiplier(6, mixed_decomp=True, seed=1), binary=binary)
    for blob in _mutations(good, seed=int(binary), flips=150) + MALFORMED:
        want, got = outcome(RI, blob), outcome(TI, blob)
        assert got == want, blob
        if got[0] != "ok":
            with pytest.raises(TI.AigerError):
                TI.loads(blob)


def test_parse_error_is_typed_and_offset_attributed():
    good = TI.dumps(TA.csa_multiplier(6))
    with pytest.raises(TI.AigerParseError) as ei:
        TI.loads(good[: len(good) // 2])
    assert "at byte" in str(ei.value) and ei.value.offset is not None
    assert issubclass(TI.AigerParseError, TI.AigerError)
    assert issubclass(TI.AigerError, ValueError)


def test_peek_name_and_load_identical(tmp_path):
    port = TA.make_design("booth", 8)
    data = TI.dumps(port)
    # the reference's scan splits binary bytes on newlines too, so it finds
    # the comment only where the AND section happens to end in byte 0x0a;
    # the port copies that (ROADMAP Queue 3)
    assert TI.peek_name(data) == RI.peek_name(data)
    text = TI.dumps(port, binary=False)
    assert TI.peek_name(text) == RI.peek_name(text) == port.name
    bare = TI.dumps(port, comments=False)
    assert TI.peek_name(bare) is RI.peek_name(bare) is None
    assert TI.peek_name(b"aig 0 0 0 0 0\nc\ngroot-name  \n") == RI.peek_name(
        b"aig 0 0 0 0 0\nc\ngroot-name  \n")
    path = tmp_path / "design.aig"
    TI.dump(port, path)
    assert path.read_bytes() == data == TI.source_bytes(path) == TI.source_bytes(data)
    assert_same_aig(TI.load(path), RI.load(path))
    # a file without a groot-name comment is named after the file
    (tmp_path / "bare.aig").write_bytes(bare)
    assert TI.load(tmp_path / "bare.aig").name == RI.load(tmp_path / "bare.aig").name == "bare"


def test_io_parse_fault_site_fires():
    good = TI.dumps(TA.csa_multiplier(4))
    with TF.injected("io.parse:every=1,kind=fatal"):
        with pytest.raises(TF.FatalFault):
            TI.loads(good)
    assert TI.loads(good).num_ands > 0
