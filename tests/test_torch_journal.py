"""The port's crash-resume journal, result cache and command line against
the reference's (``repro/checkpoint/manager.py:PartitionJournal``,
``repro/service/cache.py``, ``repro/api/session.py``, ``repro/cli.py``).

The plan fingerprint and the journal's files are the reference's, so a
journal either package wrote restores in the other; a streamed run killed
partway re-runs only its unfinished partitions and gives the uninterrupted
run's predictions bit for bit; ``explain`` prints the reference CLI's text.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import cli as RC  # noqa: E402
from repro.checkpoint import PartitionJournal as RefJournal  # noqa: E402
from repro.core.graph import EdgeGraph as RefEdgeGraph  # noqa: E402
from repro.exec import plan as RX  # noqa: E402
from repro_torch import cli as TC  # noqa: E402
from repro_torch import faults as TF  # noqa: E402
from repro_torch.api import Session, SessionConfig  # noqa: E402
from repro_torch.checkpoint import PartitionJournal  # noqa: E402
from repro_torch.core import aig as A  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402
from repro_torch.core.features import groot_features  # noqa: E402
from repro_torch.exec import plan as TX  # noqa: E402
from repro_torch.exec.stream import StreamingExecutor  # noqa: E402
from repro_torch.io import aiger  # noqa: E402
from repro_torch.service.cache import ResultCache  # noqa: E402

NPZ = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data" / "groot_csa8.npz"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small graphs train far faster on one thread than on a contended pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test starts and ends with no installed fault plan."""
    TF.uninstall()
    yield
    TF.uninstall()


@pytest.fixture(scope="module")
def model():
    return TG.params_from_numpy(TG.load_params(NPZ))


def _plans(bits=12, k=4):
    """Each package's own plan of csa-<bits> cut k ways, and the features."""
    d = A.make_design("csa", bits)
    g = d.to_edge_graph()
    ref_g = RefEdgeGraph(g.num_nodes, g.edge_src, g.edge_dst, g.edge_inv, g.edge_slot)
    return (TX.build_partition_plan(g, k, use_cache=False),
            RX.build_partition_plan(ref_g, k, use_cache=False), groot_features(d))


@pytest.mark.parametrize("bits,k", [(12, 4), (16, 6)])
def test_plan_fingerprint_identical_to_reference(bits, k):
    plan, ref_plan, _ = _plans(bits, k)
    fp = PartitionJournal.plan_fingerprint(plan)
    assert fp == RefJournal.plan_fingerprint(ref_plan)
    assert fp != PartitionJournal.plan_fingerprint(_plans(bits, k + 1)[0])


def _core(plan, i):
    sg = plan.subgraphs[i]
    return sg.global_ids[: sg.num_core]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_restores_across_packages(tmp_path, writer):
    """Partitions one package committed restore in the other, row for row."""
    plan, ref_plan, _ = _plans()
    pred = (np.arange(plan.num_nodes, dtype=np.int32) * 7) % 5
    w, wplan = ((RefJournal(tmp_path, "design"), ref_plan) if writer == "reference"
                else (PartitionJournal(tmp_path, "design"), plan))
    r, rplan = ((PartitionJournal(tmp_path, "design"), plan) if writer == "reference"
                else (RefJournal(tmp_path, "design"), ref_plan))
    assert w.open(wplan) == set()
    for i in (0, 2):
        w.commit(i, _core(wplan, i), pred[_core(wplan, i)])
    out = np.full(plan.num_nodes, -1, dtype=np.int32)
    assert r.restore(rplan, out) == {0, 2}
    for i in range(plan.num_parts):
        want = pred[_core(plan, i)] if i in (0, 2) else -1
        np.testing.assert_array_equal(out[_core(plan, i)], want)


def test_journal_commit_restore_mismatch_and_corruption(tmp_path):
    plan, _, _ = _plans()
    j = PartitionJournal(tmp_path, "designA")
    assert j.open(plan) == set()
    with pytest.raises(AssertionError):
        PartitionJournal(tmp_path, "other").commit(0, _core(plan, 0), _core(plan, 0))
    pred = np.arange(plan.num_nodes, dtype=np.int32) % 5
    for i in range(3):
        j.commit(i, _core(plan, i), pred[_core(plan, i)])
    assert not list(j.dir.glob("*.tmp"))
    # an unreadable entry and one whose ids fall outside the design drop out
    (j.dir / "part_00001.npz").write_bytes(b"not an npz")
    np.savez(j.dir / "part_00002.npz", ids=np.array([plan.num_nodes + 5]),
             pred=np.array([1], np.int32))
    out = np.zeros(plan.num_nodes, np.int32)
    assert PartitionJournal(tmp_path, "designA").restore(plan, out) == {0}
    np.testing.assert_array_equal(out[_core(plan, 0)], pred[_core(plan, 0)])
    assert sorted(p.name for p in j.dir.glob("part_*")) == ["part_00000.npz"]
    # another cut of the same design: the fingerprint differs, the journal is wiped
    other, _, _ = _plans(k=5)
    assert PartitionJournal(tmp_path, "designA").open(other) == set()
    assert not list(j.dir.glob("part_*"))
    j.complete()
    assert not j.dir.exists()


def test_journal_load_fault_site_fires(tmp_path):
    plan, _, _ = _plans()
    with TF.injected("cache.load:every=1,kind=fatal"):
        with pytest.raises(TF.FatalFault):
            PartitionJournal(tmp_path, "d").restore(plan, np.zeros(plan.num_nodes, np.int32))


def test_killed_run_resumes_only_unfinished_partitions(model, tmp_path):
    """A fatal fault at the third launch, then a fresh executor: only the
    partitions the journal lacks run, and the predictions are the
    uninterrupted run's."""
    plan, _, feats = _plans(k=6)
    total = plan.num_parts
    want = StreamingExecutor(model, "ref", capacity=1, prefetch=0,
                             device="cpu").run_plan(plan, feats)
    journal = PartitionJournal(tmp_path, "csa12")
    ex = StreamingExecutor(model, "ref", capacity=1, prefetch=0, device="cpu")
    with TF.injected("exec.launch:nth=3,kind=fatal"):
        with pytest.raises(TF.FatalFault):
            ex.run_plan(plan, feats, journal=journal)
    committed = len(list(journal.dir.glob("part_*.npz")))
    assert 0 < committed < total

    ex2 = StreamingExecutor(model, "ref", capacity=1, prefetch=0, device="cpu")
    got = ex2.run_plan(plan, feats, journal=PartitionJournal(tmp_path, "csa12"))
    np.testing.assert_array_equal(got, want)
    assert ex2.stats.resumed_partitions == committed
    assert ex2.stats.partitions == total - committed    # only the rest ran
    assert not journal.dir.exists()                     # cleared when done


def test_session_config_threads_checkpoint_dir(tmp_path):
    """checkpoint_dir flows SessionConfig -> PipelineConfig -> journal; a
    completed run leaves nothing behind."""
    cfg = SessionConfig(num_partitions=4, checkpoint_dir=str(tmp_path), bits=10, device="cpu")
    pcfg = cfg.pipeline_config()
    assert pcfg.checkpoint_dir == str(tmp_path) and pcfg.resume
    r = Session(NPZ, cfg).verify(verify=False, use_cache=False)
    assert r.status == "classified" and r.routing.mode == "streamed"
    assert not any(tmp_path.iterdir())


def test_session_resumes_a_killed_prepared_run(tmp_path):
    """``verify(prepared=...)`` takes the session's journal knobs: killed at
    the second launch, a fresh session resumes the committed partitions;
    ``resume=False`` runs every partition again."""
    kw = dict(num_partitions=6, stream_capacity=1, device="cpu")
    prep = Session(**kw).prepare(dataset="csa", bits=12)
    want = Session(NPZ, backend="groot", **kw).verify(prepared=prep, return_predictions=True)
    sess = Session(NPZ, backend="groot", checkpoint_dir=str(tmp_path), **kw)
    with TF.injected("exec.launch:nth=2,kind=fatal"):
        with pytest.raises(TF.FatalFault):
            sess.verify(prepared=prep)
    (jdir,) = tmp_path.iterdir()
    assert jdir.name == aiger.structural_hash(prep.design)
    committed = len(list(jdir.glob("part_*.npz")))
    assert 0 < committed < prep.num_partitions
    r = Session(NPZ, backend="groot", checkpoint_dir=str(tmp_path), **kw).verify(
        prepared=prep, return_predictions=True)
    np.testing.assert_array_equal(r.predictions, want.predictions)
    assert r.status == want.status
    assert r.exec_stats["resumed_partitions"] == committed
    assert r.exec_stats["partitions"] == prep.num_partitions - committed
    assert not any(tmp_path.iterdir())
    # resume=False: a prior journal is wiped and every partition runs
    with TF.injected("exec.launch:nth=2,kind=fatal"):
        with pytest.raises(TF.FatalFault):
            sess.verify(prepared=prep)
    fresh = sess.options(resume=False).verify(prepared=prep)
    assert fresh.exec_stats["resumed_partitions"] == 0
    assert fresh.exec_stats["partitions"] == prep.num_partitions


def test_result_cache_hits_and_set_params_invalidates(tmp_path):
    design = A.make_design("csa", 8)
    path = tmp_path / "csa8.aig"
    aiger.dump(design, path)
    sess = Session(NPZ, device="cpu")
    first = sess.verify(design)
    assert not first.cached and first.predictions is None
    # the same structure by object, bytes or path: one key
    for again in (design, aiger.dumps(design), str(path), path):
        hit = sess.verify(again)
        assert hit.cached and hit.status == first.status and hit.accuracy == first.accuracy
    assert sess.results.stats.hits == 4 and len(sess.results) == 1
    hit.exec_stats["mutated"] = 1
    assert "mutated" not in sess.verify(design).exec_stats
    assert not sess.verify(design, use_cache=False).cached
    assert sess.verify(design, return_predictions=True).predictions is not None
    assert not sess.options(backend="groot").verify(design).cached
    sess.set_params(NPZ)
    assert not sess.verify(design).cached
    # generated designs key on (dataset, bits, seed)
    assert not sess.verify(dataset="csa", bits=6).cached
    assert sess.verify(dataset="csa", bits=6).cached
    assert not sess.verify(dataset="csa", bits=6, seed=1).cached


def test_result_cache_lru():
    c = ResultCache(2)
    for k in "abc":
        c.put(k, k.upper())
    assert c.get("a") is None and c.get("c") == "C" and len(c) == 2
    assert (c.stats.hits, c.stats.misses, c.stats.evictions) == (1, 1, 1)
    with TF.injected("cache.load:every=1,kind=fatal"):
        with pytest.raises(TF.FatalFault):
            c.get("c")


def test_session_installs_its_fault_plan():
    Session(device="cpu", fault_plan="io.parse:every=1,kind=fatal")
    assert TF.active() is not None
    with pytest.raises(TF.FatalFault):
        Session(device="cpu").verify(aiger.dumps(A.make_design("csa", 4)))


@pytest.mark.parametrize("argv", [
    ["explain", "csa:32", "--partitions", "4"],
    ["explain", "csa:12", "--budget-mb", "0.4", "--hops", "2"],
    ["explain", "csa:6", "booth:6"],
])
def test_cli_explain_prints_reference_text(argv, capsys):
    assert RC.main(argv) == 0
    want = capsys.readouterr().out
    assert TC.main(argv, device="cpu") == 0
    assert capsys.readouterr().out == want


def test_cli_verify_aiger_file(tmp_path, capsys):
    path = tmp_path / "csa8.aig"
    aiger.dump(A.make_design("csa", 8), path)
    assert TC.main(["verify", str(path), "csa:6", "--epochs", "20", "--explain"],
                   device="cpu") == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "training groot-gnn on csa 8b (20 epochs)..."
    header = next(i for i, ln in enumerate(lines) if ln.split()[:2] == ["design", "route"])
    assert lines[header].split() == ["design", "route", "status", "acc", "nodes", "peak_MB",
                                     "total_s"]
    row = lines[header + 1].split()
    assert row[:2] == ["csa_mult_8b", "full"] and int(row[4]) == 499
    assert "  routing: mode=full backend=ref k=1 buckets=0" in lines


@pytest.mark.parametrize("argv", [
    ["verify", "csa:8", "--partitions", "4", "--devices", "2", "--epochs", "2"],
    ["explain", "csa:8", "--partitions", "4", "--devices", "2"],
])
def test_cli_unported_commands_exit_nonzero(argv, capsys):
    """``--devices 2`` with the one CPU device, as the reference's CLI on the
    same host: ``explain`` prints its lines (mode "sharded", `` devices=2``),
    and ``verify`` of a partitioned design fails with its
    ``MeshConfigError`` and text (a process exits 1, the text on stderr)."""
    from repro.launch.mesh import MeshConfigError as RefMeshConfigError
    from repro_torch.launch.mesh import MeshConfigError

    if argv[0] == "explain":
        assert RC.main(argv) == 0
        want = capsys.readouterr().out
        assert TC.main(argv, device="cpu") == 0
        got = capsys.readouterr().out
        assert got == want
        assert "mode=sharded" in got and " devices=2" in got
        return
    with pytest.raises(RefMeshConfigError) as want:
        RC.main(argv)
    with pytest.raises(MeshConfigError) as got:
        TC.main(argv, device="cpu")
    assert str(got.value) == str(want.value) == (
        "mesh_devices=2 out of range: 1 device(s) visible")


def test_cli_rejects_bad_specs_before_training(tmp_path):
    with pytest.raises(SystemExit, match="AIGER file not found"):
        TC.main(["verify", str(tmp_path / "missing.aig")], device="cpu")
    with pytest.raises(SystemExit, match="bad design spec"):
        TC.main(["verify", "csa:x"], device="cpu")


def test_cached_result_is_a_copy():
    sess = Session(NPZ, device="cpu")
    r = sess.verify(dataset="csa", bits=6)
    hit = sess.verify(dataset="csa", bits=6)
    assert hit.cached and dataclasses.replace(hit, cached=False, timings=r.timings) == r
