"""The harness on the CPU: cells, mixes, configurations and metrics found by
name (a dummy of each added in a copy of the benchmark), the result line's
keys, faults planted under the timed path turning ``correct`` false, and no
JAX or JAX package among the modules a run loads."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
TINY_GNN = {"in_features": 4, "hidden": 32, "num_layers": 4, "num_classes": 5}

# a run of the copied harness on the CPU, in a fresh process; FAULT names a
# fault planted under the timed path first
DRIVER = r"""
import json, sys, time
from pathlib import Path
root = Path(sys.argv[1])
sys.path[0:0] = [str(root), str(root / "src")]
fault = sys.argv[2]
import numpy as np
if fault == "answer":
    # where each route produces its classes: the full graph's predict, the
    # streamed route's packed launch
    from repro_torch.core import gnn
    from repro_torch.service.scheduler import BucketRunner
    def altering(plain):
        def altered(*a, **k):
            out = plain(*a, **k)
            out[::7] = (out[::7] + 1) % 5
            return out
        return altered
    gnn._predict_graph = altering(gnn._predict_graph)
    BucketRunner.__call__ = altering(BucketRunner.__call__)
elif fault == "half":
    from repro_torch.core import gnn
    plain = gnn._predict_graph
    def half(*a, **k):
        out = plain(*a, **k)
        out[out.shape[0] // 2:] = 0
        return out
    gnn._predict_graph = half
elif fault == "half_partitions":
    from repro_torch.exec.stream import StreamingExecutor
    plain = StreamingExecutor._launch_degradable
    seen = []
    def skip(self, plan, batch, *a, **k):
        seen.append(1)
        if len(seen) % 2 == 0:
            return None
        return plain(self, plan, batch, *a, **k)
    StreamingExecutor._launch_degradable = skip
from bench import harness
code, res = harness.run(sys.argv[3:], root=root, t_start=time.perf_counter(), device="cpu")
print(json.dumps({"code": code, "result": res,
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _tiny_root(tmp_path: Path) -> Path:
    """A copy of the benchmark with a tiny configuration, its cells, a dummy
    mix and a dummy per-layer metric, added as a later change would add
    them: new files and new entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    (root / "src").symlink_to(ROOT / "src")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    from bench.reference import generators, model

    d = generators.csa(12)
    n = len(d["kind"])
    e = int(2 * (d["kind"] == 1).sum() + (d["kind"] == 2).sum())
    tiny = {"name": "csa-12", "source": "test", "design": {"generator": "csa", "bits": 12},
            "gnn": TINY_GNN, "dtype": "float32", "backend": "groot", "reduced": [],
            "check": json.loads((BENCH / "configs" / "csa-1024.json").read_text())["check"]}
    (root / "bench" / "configs" / "csa-12.json").write_text(json.dumps(tiny))
    for name, src in (("tinyfull", "full"), ("tinybudget", "budget")):
        mix = json.loads((BENCH / "mixes" / f"{src}.json").read_text())
        mix.update(name=name, warmup_requests=1, profile_requests=1)
        if name == "tinybudget":
            mix["session"]["memory_budget_bytes"] = model.memory_model_bytes(n, e, TINY_GNN) // 2
        (root / "bench" / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    (root / "bench" / "metrics" / "dummy_count.py").write_text(
        "def read(ctx):\n    return 42.0 + 0 * ctx.requests\n")
    spec["configs"].append({"name": "csa-12", "source": "test", "file": "bench/configs/csa-12.json",
                            "reduced": [], "why": "test"})
    spec["workloads"] += [
        {"name": "tiny.full", "config": "csa-12", "traffic": "tinyfull", "chips": 1, "why": "test"},
        {"name": "tiny.budget", "config": "csa-12", "traffic": "tinybudget", "chips": 1,
         "why": "test"},
    ]
    for m in spec["end_to_end"] + spec["per_layer"]:
        for cell, like in (("tiny.full", "csa1024.full"), ("tiny.budget", "csa1024.budget")):
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    spec["per_layer"].append({"name": "dummy_count", "unit": "count", "better": "lower",
                              "source": "program_counter", "layer": "test",
                              "moves": "nodes_per_s", "workloads": ["tiny.full"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    sys.path.insert(0, str(ROOT))
    try:
        yield _tiny_root(tmp_path_factory.mktemp("bench"))
    finally:
        sys.path.remove(str(ROOT))


def _run(root: Path, cell: str, trace: int = 0, fault: str = "none", seed: int = 2**31 + 5):
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace)]
    out = subprocess.run([sys.executable, "-c", DRIVER, str(root), fault, *argv],
                         capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return got["code"], got["result"], got["modules"], out.stderr


@pytest.mark.parametrize("cell", ["tiny.full", "tiny.budget"])
def test_added_cell_runs_correct_with_the_contract_keys(tiny_root, cell):
    code, res, modules, err = _run(tiny_root, cell)
    assert code == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert {"nodes_per_s", "setup_s"} <= set(res["metrics"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert err.strip().splitlines()[-1].startswith("check ")
    assert not FORBIDDEN & set(modules), sorted(FORBIDDEN & set(modules))


@pytest.mark.parametrize("cell,trace,metrics", [
    ("tiny.full", 0, {"nodes_per_s", "setup_s"}),
    ("tiny.budget", 0, {"nodes_per_s", "setup_s"}),
    ("tiny.budget", 1, {"route_ms", "plan_builds_per_req", "step_mfu", "pack_share",
                        "h2d_mib_per_req", "prepare_s", "key_ms", "stage_ms", "wait_share"}),
])
def test_gnn_runner_prints_the_result_line_the_harness_printed(tiny_root, cell, trace, metrics):
    # the line of the harness before configurations had kinds, on these cells
    # and seed: its keys in order, its metrics (no peak on a CPU; a p90 only
    # where the window held two requests), its checks
    code, res, _, _ = _run(tiny_root, cell, trace=trace)
    assert code == 0
    keys = ["correct", "attempted", "failed", "metrics", "device", "requests"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert set(res["metrics"]) - {"classify_p90_ms"} == metrics
    assert list(res["device"]) == ["platform", "kind", "count", "memory_peak_bytes"] + (
        ["busy_s", "window_s"] if trace else [])
    checks = {"max_logit_gap", "max_logit_error", "failed_requests"}
    assert set(res["checks"]) == checks | ({"partition_count_diff"} if "budget" in cell else set())
    assert res["checks"]["max_logit_gap"]["value"] == 0.0
    assert res["checks"]["max_logit_error"]["value"] < 1e-6


def test_traced_run_reads_the_added_metric(tiny_root):
    code, res, _, _ = _run(tiny_root, "tiny.full", trace=1)
    assert code == 0 and res["correct"] is True
    assert res["metrics"]["dummy_count"] == {"value": 42.0, "unit": "count"}
    assert {"route_ms", "plan_builds_per_req", "step_mfu", "prepare_s"} <= set(res["metrics"])
    assert "nodes_per_s" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_traced_budget_run_reads_the_streamed_route(tiny_root):
    code, res, _, _ = _run(tiny_root, "tiny.budget", trace=1)
    assert code == 0 and res["correct"] is True
    assert {"pack_share", "h2d_mib_per_req"} <= set(res["metrics"])
    assert "dummy_count" not in res["metrics"]
    assert res["checks"]["partition_count_diff"]["value"] == 0


@pytest.mark.parametrize("cell,fault", [
    ("tiny.full", "answer"),            # an answer altered where it is produced
    ("tiny.full", "half"),              # half of the nodes left unclassified
    ("tiny.budget", "answer"),
    ("tiny.budget", "half_partitions"),  # every other packed launch left out
])
def test_planted_fault_is_not_correct(tiny_root, cell, fault):
    code, res, _, err = _run(tiny_root, cell, fault=fault)
    assert code == 0
    assert res["correct"] is False
    gap = res["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"], gap
    assert "check max_logit_gap" in err


def test_missing_chip_exits_nonzero_without_a_result(tiny_root):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "tiny.full", "--seed",
                          "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tiny_root,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bench_alone_exits_nonzero(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "csa1024.full",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        assert not _imports(path) & FORBIDDEN, path
        assert "benchmarks/" not in path.read_text(), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"repro_torch"}), path


def test_window_judges_a_seeded_uniform_sample_of_its_answers():
    import numpy as np

    sys.path.insert(0, str(ROOT))
    try:
        from bench.runners.gnn import Sample
    finally:
        sys.path.remove(str(ROOT))

    def kept(seed, n):
        sample = Sample(seed)
        for answer in range(n):
            sample.offer(answer)
        return sample.kept

    assert kept(7, 5) == [0, 1, 2, 3, 4]
    picks = kept(2**31 + 5, 120)
    assert len(picks) == 8 and picks == kept(2**31 + 5, 120) != kept(2**31 + 6, 120)
    assert max(picks) >= 8
    times = np.zeros(40)
    for seed in range(2000):
        times[kept(seed, 40)] += 1
    assert np.abs(times / 2000 - 8 / 40).max() < 0.05
