"""The ``lm_serve`` kind on the CPU, at the zoo's qwen3-8b smoke sizes: a
serving cell added with new files and entries only (a configuration, a
mix), its runs correct with the contract's keys, the plain reference
against the program's forward and its prefill-then-decode path, the fp8
control and every planted fault turning ``correct`` false, and no JAX among
the modules a run loads; and the configuration kind's dispatch, which
leaves the GNN cells as they were."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SMOKE = {"num_layers": 4, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 512}
GNN_CELLS = ("csa1024.full", "booth1024.full", "csa1024.budget")

RUN_SCRIPT = r"""
import json, sys, time
from pathlib import Path
root = Path(sys.argv[1])
sys.path[0:0] = [str(root), str(root / "src")]
import contextlib
from bench import harness, lm_faults
fault = sys.argv[2]
with lm_faults.planted(fault) if fault != "none" else contextlib.nullcontext():
    code, res = harness.run(sys.argv[3:], root=root, t_start=time.perf_counter(), device="cpu")
print(json.dumps({"code": code, "result": res,
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _smoke_config() -> dict:
    cfg = json.loads((BENCH / "configs" / "qwen3-8b.json").read_text())
    cfg["name"] = "qwen3-smoke"
    cfg["model"].update(SMOKE)
    return cfg


def _smoke_mix() -> dict:
    mix = json.loads((BENCH / "mixes" / "serve.json").read_text())
    mix.update(name="tinyserve", batch=4, max_new=8)
    mix["prompt_len"].update(median=12, min=4, max=24)
    return mix


@pytest.fixture(scope="module")
def lm_root(tmp_path_factory):
    """A copy of the benchmark with the smoke configuration and a small mix
    added as a later change would add them: new files and new entries only
    (no runner, harness or loader edited)."""
    root = tmp_path_factory.mktemp("bench_lm") / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    (root / "src").symlink_to(ROOT / "src")
    (root / "bench" / "configs" / "qwen3-smoke.json").write_text(json.dumps(_smoke_config()))
    (root / "bench" / "mixes" / "tinyserve.json").write_text(json.dumps(_smoke_mix()))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "qwen3-smoke", "source": "test",
                            "file": "bench/configs/qwen3-smoke.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.serve", "config": "qwen3-smoke",
                              "traffic": "tinyserve", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "qwen3-8b.serve" in m.get("workloads", ()):
            m["workloads"].append("tiny.serve")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root: Path, trace: int = 0, fault: str = "none", seed: int = 2**31 + 9):
    argv = ["--workload", "tiny.serve", "--seed", str(seed), "--seconds", "0.5", "--trace",
            str(trace)]
    out = subprocess.run([sys.executable, "-c", RUN_SCRIPT, str(root), fault, *argv],
                         capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return got["code"], got["result"], got["modules"], out.stderr


@pytest.fixture(scope="module")
def bench_path():
    sys.path.insert(0, str(ROOT))
    try:
        yield
    finally:
        sys.path.remove(str(ROOT))


def test_added_serving_cell_runs_correct_with_the_contract_keys(lm_root):
    code, res, modules, err = _run(lm_root)
    assert code == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 4
    assert set(res["metrics"]) == {"tokens_per_s", "setup_s"}   # no GNN metric; no peak on a CPU
    assert set(res["checks"]) == {"max_logit_gap", "max_logit_error", "failed_requests",
                                  "token_id_range"}
    assert err.strip().splitlines()[-1].startswith("check ")
    assert not FORBIDDEN & set(modules), sorted(FORBIDDEN & set(modules))


def test_traced_serving_run_reads_the_serving_layers(lm_root):
    code, res, _, _ = _run(lm_root, trace=1)
    assert code == 0 and res["correct"] is True
    assert {"serve_mfu", "prefill_ms", "decode_step_ms"} <= set(res["metrics"])
    assert not {"route_ms", "step_mfu", "nodes_per_s", "tokens_per_s"} & set(res["metrics"])
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert dict(res["breakdown"]["idle_gaps"]).keys() <= {"serve.prefill", "serve.decode",
                                                          "outside spans"}


# a decode step that returns its state unchanged, half of the batch left out,
# a token altered where it is produced (the faults a served model can have);
# a layer left out, qk-norm skipped (the seeded qk-norm gains are not 1, so
# the norm is no identity).  The KV cache rounded to fp8 is left out: at the
# cell's size it reads 1.3-1.7x the program's own bf16 rounding, inside the
# room a limit keeps above it.
@pytest.mark.parametrize("fault", ["stale_cache", "half_batch", "token", "drop_layer",
                                   "no_qk_norm"])
def test_planted_fault_is_not_correct(lm_root, fault):
    code, res, _, err = _run(lm_root, fault=fault)
    assert code == 0
    assert res["correct"] is False, res["checks"]
    failing = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    if fault in ("drop_layer", "no_qk_norm"):
        assert "max_logit_error" in failing, res["checks"]
    assert "check max_logit_" in err


def _program(cfg_over: dict, seed: int):
    from bench.reference import lm
    from bench.runners import lm_serve

    config = _smoke_config()
    config["model"].update(cfg_over)
    model = config["model"]
    cfg = lm_serve.zoo_config(config)
    weights = lm.make_weights(model, seed, "cpu", getattr(torch, model["dtype"]))
    from repro_torch.zoo.models.transformer import params_from_numpy

    return config, model, cfg, weights, params_from_numpy(weights, cfg, "cpu")


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_reference_equals_the_program_forward_in_float32(bench_path, seed):
    from bench.reference import lm
    from repro_torch.zoo.models.transformer import model_forward

    _, model, cfg, weights, params = _program({"dtype": "float32"}, seed)
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(0, 512, (3, 20)))
    got, _ = model_forward(params, cfg, tokens)
    want = lm.logits(weights, model, tokens, 0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [1, 2**31 + 4])
def test_reference_holds_prefill_then_decode_within_the_limits(bench_path, seed):
    from bench.reference import lm
    from repro_torch.zoo.serving.decode import make_prefill_step, make_serve_step

    config, model, cfg, weights, params = _program({}, seed)
    prompt = torch.as_tensor(np.random.default_rng(seed).integers(0, 512, (2, 16)))
    steps = 10
    prefill, step = make_prefill_step(cfg, 16 + steps), make_serve_step(cfg)
    last, cache = prefill(params, prompt)
    tok = last.argmax(-1)[:, None].to(torch.int32)
    toks, logits = [tok], [last.float()]
    for _ in range(steps - 1):
        tok, lg, cache = step(params, cache, tok)
        toks.append(tok)
        logits.append(lg.float())
    served = torch.cat(toks, 1).long()
    got = torch.stack(logits, 1)
    want = lm.logits(weights, model, torch.cat([prompt, served[:, :-1]], 1), 15)
    err = float((got - want).abs().max() / want.abs().max())
    gap = float((want.max(-1).values - want.gather(-1, served[..., None])[..., 0]).max())
    assert err <= config["check"]["max_logit_error"]
    assert gap <= config["check"]["max_logit_gap"]
    # the control: the reference in float8 e4m3 reads above the limits
    low = lm.logits(weights, model, torch.cat([prompt, served[:, :-1]], 1), 15, control="fp8")
    assert float((low - want).abs().max() / want.abs().max()) > config["check"]["max_logit_error"]


def test_absent_kind_is_gnn_and_the_gnn_cells_load_as_before(bench_path):
    from bench import loader

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in spec["configs"]}
    for w in spec["workloads"]:
        cell = loader.load_cell(ROOT, w["name"])
        config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cell.config == config and cell.chips == w["chips"]
        assert cell.mix == json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text())
        assert cell.kind == config.get("kind", "gnn")
        assert cell.kind == ("gnn" if w["name"] in GNN_CELLS else "lm_serve")
        names = {m["name"] for m in cell.end_to_end}
        if cell.kind == "gnn":
            assert "kind" not in config
            assert "nodes_per_s" in names and "tokens_per_s" not in names
        else:
            assert names == {"tokens_per_s", "device_peak_gib", "setup_s"}
    assert loader.runner("gnn").run and loader.runner("lm_serve").run
    with pytest.raises(KeyError):
        loader.runner("../harness")


def test_qwen3_8b_configuration_is_the_zoos_at_published_widths(bench_path):
    from bench.runners import lm_serve
    from repro_torch.zoo.configs import get_config

    config = json.loads((BENCH / "configs" / "qwen3-8b.json").read_text())
    cfg, zoo = lm_serve.zoo_config(config), get_config("qwen3-8b")
    for key in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
                "qk_norm", "rope_theta", "norm_eps", "tie_embeddings", "act", "dtype"):
        assert getattr(cfg, key) == getattr(zoo, key), key
    assert cfg.head_dim_ == zoo.head_dim_ == config["published"]["head_dim"]
    pub = config["published"]
    assert (pub["hidden_size"], pub["intermediate_size"], pub["num_hidden_layers"],
            pub["num_attention_heads"], pub["num_key_value_heads"], pub["vocab_size"]) == (
        cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size)
    assert config["reduced"] == []


@pytest.mark.parametrize("trace", [0, 1])
def test_every_metric_of_the_benchmark_finds_its_reader(bench_path, trace):
    """Each metric of ``BENCHMARK.json`` resolves to a reader; a metric split
    by the end-to-end metric it moves reads as the one it was split from."""
    from bench import loader

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        assert callable(loader.reader(m["name"])), m["name"]
    ctx = SimpleNamespace(profile={"window_s": 2.0, "busy_s": 1.5})
    assert loader.reader("device_idle_share.serve")(ctx) == loader.reader(
        "device_idle_share")(ctx) == 25.0
    assert not (BENCH / "metrics" / "device_idle_share.serve.py").exists()
