"""The port's host side against the reference: identical arrays.

Design generation, features, edge graphs, batching, verification, the
degree-bucketed plans and the ForwardPlan streams of ``repro_torch`` are
numpy copies of ``repro``'s and must give the same arrays bit for bit.  The
port must also import neither JAX nor anything of ``repro``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aig as RA  # noqa: E402
from repro.core import features as RF  # noqa: E402
from repro.core import graph as RG  # noqa: E402
from repro.core import verify as RV  # noqa: E402
from repro.kernels import forward_plan as RFP  # noqa: E402
from repro.kernels import groot_spmm as RS  # noqa: E402
from repro.kernels import plan_cache as RPC  # noqa: E402
from repro_torch.core import aig as TA  # noqa: E402
from repro_torch.core import features as TF  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import verify as TV  # noqa: E402
from repro_torch.kernels import forward_plan as TFP  # noqa: E402
from repro_torch.kernels import groot_spmm as TS  # noqa: E402
from repro_torch.kernels import plan_cache as TPC  # noqa: E402
from tests.test_forward_plan import MIXTURES  # noqa: E402
from tests.test_plan_properties import graph_from_degrees  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _assert_graphs_equal(a, b):
    assert a.num_nodes == b.num_nodes
    for f in ("edge_src", "edge_dst", "edge_inv", "edge_slot"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("dataset,bits", [("csa", 8), ("booth", 8), ("mapped", 8), ("fpga", 6)])
def test_designs_features_and_edge_graphs_identical(dataset, bits):
    ref = RA.make_design(dataset, bits, seed=3)
    port = TA.make_design(dataset, bits, seed=3)
    for f in dataclasses.fields(ref):
        x, y = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    np.testing.assert_array_equal(RF.groot_features(ref), TF.groot_features(port))
    _assert_graphs_equal(ref.to_edge_graph(), port.to_edge_graph())


def test_batch_graphs_identical():
    designs = [("csa", 6), ("booth", 6), ("csa", 4)]
    ref = RG.batch_graphs([RA.make_design(d, b).to_edge_graph() for d, b in designs])
    port = TG.batch_graphs([TA.make_design(d, b).to_edge_graph() for d, b in designs])
    _assert_graphs_equal(ref, port)


@pytest.mark.parametrize("corrupt", [0, 7])
def test_verify_results_identical(corrupt):
    design = RA.make_design("csa", 8)
    pred = design.label.astype(np.int32).copy()
    rng = np.random.default_rng(corrupt)
    flip = rng.choice(design.num_nodes, corrupt, replace=False)
    pred[flip] = (pred[flip] + 1) % RA.NUM_CLASSES
    ref = RV.verify(design, pred, bits=8)
    port = TV.verify(TA.make_design("csa", 8), pred, bits=8)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)


def test_bits64_simulation_fault_is_copied():
    """The reference's ``simulation_check`` raises at bits == 64 (its random
    vectors need ``2**64``, past int64); the port copies the fault."""
    for A, V in ((RA, RV), (TA, TV)):
        with pytest.raises(ValueError, match="high is out of bounds"):
            V.simulation_check(A.csa_multiplier(64), 64, signed=False)


def _plan_cases():
    cases = []
    for case in MIXTURES:
        n, e_t, hd_frac, scale, seed = case
        src, dst = graph_from_degrees(np.random.default_rng(seed), n, e_t, hd_frac, scale)
        cases.append(pytest.param(src, dst, n, e_t, id=f"mixture{seed}"))
    g = RA.make_design("csa", 64).to_edge_graph()
    cases.append(pytest.param(g.edge_src, g.edge_dst, g.num_nodes, RS.E_T, id="csa64"))
    empty = np.zeros(0, np.int32)
    cases.append(pytest.param(empty, empty, 5, RS.E_T, id="empty"))
    return cases


def _assert_plans_equal(ref, port):
    for f in ("num_nodes", "num_edges", "e_t", "asm_rows", "num_slots"):
        assert getattr(ref, f) == getattr(port, f), f
    np.testing.assert_array_equal(ref.asm_index, port.asm_index)
    assert ref.asm_index.dtype == port.asm_index.dtype
    assert len(ref.buckets) == len(port.buckets)
    for rb, pb in zip(ref.buckets, port.buckets):
        assert (rb.deg, rb.rows_per_tile) == (pb.deg, pb.rows_per_tile)
        for f in ("rows", "cols", "eids"):
            assert getattr(rb, f).dtype == getattr(pb, f).dtype, f
            np.testing.assert_array_equal(getattr(rb, f), getattr(pb, f), err_msg=f)
    assert (ref.hd is None) == (port.hd is None)
    if ref.hd is not None:
        for f in ("rows", "cols", "eids", "chunk_meta"):
            assert getattr(ref.hd, f).dtype == getattr(port.hd, f).dtype, f
            np.testing.assert_array_equal(getattr(ref.hd, f), getattr(port.hd, f), err_msg=f)
        # the port's derived per-row chunk table agrees with chunk_meta
        rc = port.hd.row_chunks()
        rows_of_chunks = np.repeat(np.arange(rc.shape[0]), rc[:, 1])
        np.testing.assert_array_equal(rows_of_chunks, port.hd.chunk_meta[:, 0])
        np.testing.assert_array_equal(port.hd.chunk_meta[rc[:, 0], 1], 1)


@pytest.mark.parametrize("src,dst,n,e_t", _plan_cases())
def test_plans_and_forward_plan_streams_identical(src, dst, n, e_t):
    for a, b in ((src, dst), (dst, src)):     # fanin and fanout directions
        _assert_plans_equal(RS.build_plan(a, b, n, e_t=e_t), TS.build_plan(a, b, n, e_t=e_t))
    ref = RFP.build_forward_plan(RS.build_plan(src, dst, n, e_t=e_t),
                                 RS.build_plan(dst, src, n, e_t=e_t))
    port = TFP.build_forward_plan(TS.build_plan(src, dst, n, e_t=e_t),
                                  TS.build_plan(dst, src, n, e_t=e_t))
    for f in ("in_cat_eids", "out_cat_eids"):
        assert getattr(ref, f).dtype == getattr(port, f).dtype
        np.testing.assert_array_equal(getattr(ref, f), getattr(port, f))


def test_plan_cache_keys_and_reuse():
    g = TA.make_design("csa", 6).to_edge_graph()
    assert TPC.graph_key(g.edge_src, g.edge_dst, g.num_nodes) == \
        RPC.graph_key(g.edge_src, g.edge_dst, g.num_nodes)
    first = TPC.cached_forward_plan(g.edge_src, g.edge_dst, g.num_nodes)
    before = TPC.PLAN_CACHE.snapshot().builds
    again = TPC.cached_forward_plan(g.edge_src, g.edge_dst, g.num_nodes)
    assert again is first and TPC.PLAN_CACHE.snapshot().builds == before
    assert first.in_plan is TPC.cached_plan(g.edge_src, g.edge_dst, g.num_nodes)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.core.gnn, "
        "repro_torch.core.pipeline, repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


def test_no_jax_or_repro_import_in_port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        bad = {m for m in _imports(path)
               if m.split(".")[0] in ("jax", "jaxlib", "repro")}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_padded_shape_helpers_identical():
    from repro.kernels import ops as ROPS
    from repro_torch.kernels import ops as TOPS

    for n in (0, 1, 2, 3, 17, 1024, 1025):
        assert TOPS.next_pow2(n) == ROPS.next_pow2(n)
    assert TOPS.padded_shape(100, 300) == ROPS.padded_shape(100, 300)
    g = TA.make_design("booth", 6).to_edge_graph()
    n_pad, e_pad = TOPS.padded_shape(g.num_nodes, g.num_edges)
    args = (g.edge_src, g.edge_dst, g.edge_inv, g.edge_slot, g.num_nodes, n_pad, e_pad)
    for r, t in zip(ROPS.pad_graph_arrays(*args), TOPS.pad_graph_arrays(*args)):
        assert r.dtype == t.dtype
        np.testing.assert_array_equal(r, t)
    with pytest.raises(ValueError, match="cannot hold"):
        TOPS.pad_graph_arrays(*args[:5], g.num_nodes, e_pad)
