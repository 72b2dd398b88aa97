"""The ``afmoe_serve`` kind on the CPU, at the zoo's trinity-mini smoke
sizes: a serving cell added with new files and entries only (a
configuration, a mix), its runs correct with the contract's keys, every
planted fault of ``bench/afmoe_faults.py`` turning ``correct`` false, no JAX
among the modules a run loads; and the counts the cell's readers take."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# trinity-mini's smoke_config() sizes, in float32 (see the limits below)
SMOKE = {"num_layers": 6, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 512, "num_experts": 8, "top_k": 2, "moe_d_ff": 32,
         "sliding_window": 8, "dtype": "float32"}
# The smoke cell's limits.  Its program computes in f32 but holds the KV
# cache in bf16 (as served); the reference takes the program's expert
# choices.  On seeds 1-7 and 2**31 + 11 the program read at most 0.0104 of
# error, 0.0007 of gap and 0 of regret; on seeds 3, 7 and 2**31 + 11 every
# fault read at least 0.041 of error (the bias in the weights; the others
# 0.22 and up).
SMOKE_CHECK = {"max_logit_gap": 0.05, "max_logit_error": 0.02, "max_route_regret": 0.005}

RUN_SCRIPT = r"""
import json, sys, time
from pathlib import Path
root = Path(sys.argv[1])
sys.path[0:0] = [str(root), str(root / "src")]
import contextlib
from bench import harness, afmoe_faults
fault = sys.argv[2]
with afmoe_faults.planted(fault) if fault != "none" else contextlib.nullcontext():
    code, res = harness.run(sys.argv[3:], root=root, t_start=time.perf_counter(), device="cpu")
print(json.dumps({"code": code, "result": res,
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _smoke_config() -> dict:
    cfg = json.loads((BENCH / "configs" / "trinity-mini.json").read_text())
    cfg["name"] = "trinity-smoke"
    cfg["model"].update(SMOKE)
    cfg["check"] = SMOKE_CHECK
    return cfg


def _smoke_mix() -> dict:
    mix = json.loads((BENCH / "mixes" / "long.json").read_text())
    mix.update(name="tinylong", batch=3, max_new=6, check_requests=3)
    mix["prompt_len"].update(median=12, min=9, max=16)
    return mix


@pytest.fixture(scope="module")
def afmoe_root(tmp_path_factory):
    """A copy of the benchmark with the smoke configuration and a small mix
    added as a later change would add them: new files and new entries only."""
    root = tmp_path_factory.mktemp("bench_afmoe") / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    (root / "src").symlink_to(ROOT / "src")
    (root / "bench" / "configs" / "trinity-smoke.json").write_text(json.dumps(_smoke_config()))
    (root / "bench" / "mixes" / "tinylong.json").write_text(json.dumps(_smoke_mix()))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "trinity-smoke", "source": "test",
                            "file": "bench/configs/trinity-smoke.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "tiny.long", "config": "trinity-smoke",
                              "traffic": "tinylong", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "trinity-mini.long" in m.get("workloads", ()):
            m["workloads"].append("tiny.long")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root: Path, trace: int = 0, fault: str = "none", seed: int = 2**31 + 11):
    argv = ["--workload", "tiny.long", "--seed", str(seed), "--seconds", "0.5", "--trace",
            str(trace)]
    out = subprocess.run([sys.executable, "-c", RUN_SCRIPT, str(root), fault, *argv],
                         capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return got["code"], got["result"], got["modules"], out.stderr


@pytest.mark.parametrize("seed", [2**31 + 11, 7])
def test_added_afmoe_cell_runs_correct_with_the_contract_keys(afmoe_root, seed):
    code, res, modules, err = _run(afmoe_root, seed=seed)
    assert code == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 3
    assert set(res["metrics"]) == {"tokens_per_s", "setup_s"}   # no peak on a CPU
    assert set(res["checks"]) == {"max_logit_gap", "max_logit_error", "failed_requests",
                                  "token_id_range", "dropped_tokens", "max_route_regret"}
    assert res["checks"]["dropped_tokens"]["value"] == 0
    assert not FORBIDDEN & set(modules), sorted(FORBIDDEN & set(modules))


def test_traced_afmoe_run_reads_the_serving_and_expert_layers(afmoe_root):
    """On the CPU the serving layers read; the profiler sees no device, so
    the device readers (idle share, the MoE share, the rooflines) fall
    silent rather than raise."""
    code, res, _, err = _run(afmoe_root, trace=1)
    assert code == 0 and res["correct"] is True
    assert {"serve_mfu", "prefill_ms", "decode_step_ms"} <= set(res["metrics"])
    assert not {"moe_share", "expert_roofline", "k8_roofline", "tokens_per_s"} & set(
        res["metrics"])
    assert "MoE calls" in err


@pytest.mark.parametrize("fault", ["window", "rope_global", "no_gate", "no_shared", "softmax",
                                   "bias_in_weights", "no_route_scale", "no_post_norm"])
def test_planted_fault_is_not_correct(afmoe_root, fault):
    code, res, _, err = _run(afmoe_root, fault=fault)
    assert code == 0
    assert res["correct"] is False, res["checks"]
    assert "check max_logit_" in err


def test_counts_of_the_cell():
    sys.path.insert(0, str(ROOT))
    try:
        from bench import counts_afmoe
    finally:
        sys.path.remove(str(ROOT))
    model = json.loads((BENCH / "configs" / "trinity-mini.json").read_text())["model"]
    # a sliding layer's query attends at most 2,048 keys, a full layer's all before it
    assert counts_afmoe.attended_pairs(4096, 4096, 2048) == 2048 * 2049 // 2 + 2048 * 2048
    assert counts_afmoe.attended_pairs(1, 4100, 2048) == 2048
    assert counts_afmoe.attended_pairs(1, 4100, 0) == 4100
    # about 3.47 G active parameters a token (the zoo's active_param_count less the
    # embedding table, which is a lookup, and less the unrouted experts)
    assert counts_afmoe.token_flops(model) == 2 * (32 * (3 * 2048 * 4096 + 2 * 2048 * 512)
                                                   + 2 * 3 * 2048 * 6144
                                                   + 30 * (2048 * 128 + 3 * 2048 * 1024 * 9))
    k8 = counts_afmoe.k8_prefill(model, 16, 4096)
    assert k8["launches"] == 32
    g = counts_afmoe.expert_gemms(model, 128, 81)
    assert g["flops"] == 3 * 2 * 128 * 2048 * 1024
    assert g["bytes"] == 2 * 3 * (128 * 2048 + 81 * 2048 * 1024 + 128 * 1024)
