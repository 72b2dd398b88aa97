"""The dry run's counter and cells on the CPU (``roofline/counter.py``,
``launch/dryrun.py``, ``roofline/report.py``).

* the counterparts of ``tests/test_infra.py``'s HLO parser tests: a loop of
  5 (128 x 128) matmuls counts exactly 5·2·128³ dot FLOPs; a one-device
  program moves no collective byte and its entry arguments are 2·64·64·4 B;
* an all-gather and an all-reduce of known DTensors on a fake (2, 4) mesh
  count their result bytes by kind;
* K8's custom op on fake CUDA tensors (no mesh): shape and dtype, its
  formula's FLOPs, ``traced`` counted and no launch;
* ``run_cell`` on a fake (2, 4) ``"cpu"`` mesh for smoke cells (qwen3-8b
  train, prefill and decode at 64 tokens, qwen3-moe's train cell through
  ``moe_ffn_dist``, groot-gnn at 8 bits): dot FLOPs > 0, no collective byte
  for groot-gnn, the useful ratio at most 1.05;
* ``estimate_cell`` (cut traces, extended) against the exact trace;
* dot FLOPs of the smoke qwen3-8b prefill and train cells on a one-device
  mesh against the reference's ``hlo.analyze`` of its compiled cell;
* ``report.model_flops`` equal to the reference's for every cell, and
  ``--list`` printing the reference's list.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import (512 host devices), so
it runs only in a subprocess here, as ``tests/test_distributed.py`` runs it.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch import steps as RS  # noqa: E402
from repro.roofline import hlo as RH  # noqa: E402
from repro.roofline import report as RREP  # noqa: E402
from repro.sharding import rules as RR  # noqa: E402
from repro.zoo import configs as RC  # noqa: E402
from repro.zoo.configs import shapes as RSH  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.roofline import report as TREP  # noqa: E402
from repro_torch.roofline.counter import CostCounter  # noqa: E402
from repro_torch.zoo import configs as TC  # noqa: E402
from repro_torch.zoo.configs import shapes as TSH  # noqa: E402
from repro_torch.zoo.models import moe as TM  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SMALL = {"train_4k": ("train_4k", 64, 16, "train"),
         "prefill_32k": ("prefill_32k", 64, 8, "prefill"),
         "decode_32k": ("decode_32k", 64, 8, "decode")}
# the port's dot FLOPs against the reference's compiled cell: equal on both
# cells when measured (test_dot_flops_match_reference_hlo); the bound allows
# float rounding of the sums only
HLO_RTOL = 1e-9


@pytest.fixture
def small_shapes(monkeypatch):
    """The shape grid at smoke scale in both packages (the reference's test
    of its dry run shrinks it the same way)."""
    for shapes, cls in ((TSH.SHAPES, TSH.ShapeSpec), (RSH.SHAPES, RSH.ShapeSpec)):
        for k, v in SMALL.items():
            monkeypatch.setitem(shapes, k, cls(*v))
    return SMALL


@pytest.fixture
def mesh_2x4():
    from torch.distributed.device_mesh import init_device_mesh

    with D.fake_world(8):
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))


@pytest.fixture
def mesh_1x1():
    from torch.distributed.device_mesh import init_device_mesh

    with D.fake_world(1):
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

def test_counter_loop_of_matmuls():
    """The counterpart of test_hlo_parser_loop_correction: the step runs as
    a Python loop, so 5 matmuls count as 5, with no loop correction."""
    x, ws = torch.randn(128, 128), torch.randn(5, 128, 128)
    with CostCounter((x, ws)) as c:
        for w in ws:
            x = torch.tanh(x @ w)
    assert c.stats.dot_flops == 5 * 2 * 128**3


def test_counter_one_device_program():
    """The counterpart of test_hlo_parser_counts_collectives."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with CostCounter((a, b)) as c:
        a @ b
    assert c.stats.collective_bytes == 0.0
    assert c.stats.dot_flops == 2 * 64**3
    assert c.stats.entry_param_bytes == 2 * 64 * 64 * 4
    # traffic: the product's inputs read and output written, the entry
    # arguments read once
    assert c.stats.traffic_bytes == 3 * 64 * 64 * 4 + 2 * 64 * 64 * 4


def test_counter_collectives_by_kind(mesh_2x4):
    """Redistributions of known DTensors bill their collectives' result
    bytes (each rank's), by kind."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 16), mesh_2x4, [Shard(0), Replicate()],
                               run_check=False)
        y = DTensor.from_local(torch.empty(8, 16), mesh_2x4, [Replicate(), Partial()],
                               run_check=False)
        with CostCounter((x, y)) as c:
            x.redistribute(mesh_2x4, [Replicate(), Replicate()])   # all-gather over data
            y.redistribute(mesh_2x4, [Replicate(), Replicate()])   # all-reduce over model
            y.redistribute(mesh_2x4, [Replicate(), Shard(0)])      # reduce-scatter over model
    assert c.stats.collective_by_kind == {"all-gather": 8 * 16 * 4, "all-reduce": 8 * 16 * 4,
                                          "reduce-scatter": 2 * 16 * 4}
    assert c.stats.collective_bytes == (2 * 8 + 2) * 16 * 4
    assert c.stats.dot_flops == 0


def test_k8_custom_op_on_fake_cuda_tensors():
    """K8 traced on fake CUDA tensors: its fake output, its formula's FLOPs
    (the attended pairs only), counted in ``traced``, never launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    launches, traced = fa.flash_attention.launches, fa.flash_attention.traced
    with FakeTensorMode():
        q = torch.empty(8, 300, 128, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 300, 128, dtype=torch.bfloat16, device="cuda")
        with CostCounter((q, k, k)) as c:
            out = fa.flash_attention(q, k, k, causal=True, window=100, kv_block=300)
    assert tuple(out.shape) == (8, 300, 128) and out.dtype == torch.bfloat16
    assert out.device.type == "cuda"
    pairs = sum(min(i, 299) - max(i - 99, 0) + 1 for i in range(300))
    assert c.stats.dot_flops == 4 * 8 * 128 * pairs == fa.flash_flops(
        (8, 300, 128), (2, 300, 128), True, 100)
    assert fa.flash_attention.traced == traced + 1
    assert fa.flash_attention.launches == launches


# ---------------------------------------------------------------------------
# Cells on a fake (2, 4) mesh
# ---------------------------------------------------------------------------

def _useful(rec, arch, shape, cfg, spec) -> float:
    mf = TREP.model_flops(arch, shape, rec["devices"], cfg=cfg, spec=spec)
    return mf / rec["hlo"]["dot_flops_per_device"]


@pytest.mark.parametrize("shape", list(SMALL))
def test_run_cell_qwen3_smoke(shape, small_shapes, mesh_2x4):
    cfg = TC.get_config("qwen3-8b", smoke=True)
    rec = D.run_cell(TS.build_cell(cfg, shape, mesh_2x4), mesh_2x4, "test", save=False,
                     device="cpu")
    assert rec["hlo"]["dot_flops_per_device"] > 0
    assert rec["hlo"]["collective_bytes_per_device"] > 0   # TP/FSDP over (2, 4)
    assert 0 < _useful(rec, "qwen3-8b", shape, cfg, TSH.SHAPES[shape]) <= 1.05
    assert rec["memory_analysis"]["peak_bytes"] >= rec["memory_analysis"][
        "argument_size_in_bytes"] > 0


def test_run_cell_moe_train_through_local_map(small_shapes, mesh_2x4, monkeypatch):
    """qwen3-moe's smoke train cell: every MoE layer through
    ``moe_ffn_dist`` (experts over "model")."""
    cfg = TC.get_config("qwen3-moe-235b-a22b", smoke=True)
    calls = []
    inner = TM._local_dispatch_ffn
    monkeypatch.setattr(TM, "_local_dispatch_ffn",
                        lambda *a, **k: calls.append(a[5:]) or inner(*a, **k))
    rec = D.run_cell(TS.build_cell(cfg, "train_4k", mesh_2x4), mesh_2x4, "test", save=False,
                     device="cpu")
    assert rec["meta"]["optimizer"] == "AdamW8bit"
    # forward and recompute, every layer, every microbatch: each rank's slice
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    assert len(calls) == 2 * n_moe * TS.MICROBATCHES[cfg.name]
    assert {c[1] for c in calls} == {cfg.num_experts // 4}
    assert rec["hlo"]["dot_flops_per_device"] > 0
    assert 0 < _useful(rec, cfg.name, "train_4k", cfg, TSH.SHAPES["train_4k"]) <= 1.05


def test_run_cell_groot_smoke(mesh_2x4, monkeypatch):
    """groot-gnn at 8 bits: each rank runs its own partition, no
    collective."""
    monkeypatch.setitem(TS.GROOT_SHAPES, "verify_256b_bs16", (8, 2))
    gcfg = TC.get_config("groot-gnn", smoke=True)
    rec = D.run_cell(TS.build_groot_cell(gcfg, "verify_256b_bs16", mesh_2x4), mesh_2x4, "test",
                     save=False, device="cpu")
    assert rec["hlo"]["dot_flops_per_device"] > 0
    assert rec["hlo"]["collective_bytes_per_device"] == 0
    assert rec["meta"]["partitions"] == 8
    assert 0 < _useful(rec, "groot-gnn", "verify_256b_bs16", gcfg, (8, 2)) <= 1.05


@pytest.mark.parametrize("shape", list(SMALL))
def test_estimate_matches_exact_trace(shape, small_shapes, mesh_2x4):
    """The cut traces extended to the full depth and microbatch count give
    the full trace's dot FLOPs, collective bytes (by kind) and traffic (up to
    float rounding), its arguments' bytes exactly, and its peak within 10%
    (the peak is not affine in depth near the bottom of the cut: 5% under at
    6 layers)."""
    cfg = dataclasses.replace(TC.get_config("qwen3-8b", smoke=True), num_layers=6)
    exact = D.run_cell(TS.build_cell(cfg, shape, mesh_2x4), mesh_2x4, "t", save=False,
                       device="cpu")
    est = D.estimate_cell("qwen3-8b", cfg, shape, mesh_2x4, "t", save=False, device="cpu")
    assert est["method"]["super_blocks"] == [2, 3] and est["method"]["of"] == 6
    for k in ("dot_flops_per_device", "collective_bytes_per_device",
              "traffic_bytes_per_device"):
        assert est["hlo"][k] == pytest.approx(exact["hlo"][k], rel=1e-9)
    for k, v in exact["hlo"]["collective_by_kind"].items():
        assert est["hlo"]["collective_by_kind"][k] == pytest.approx(v, rel=1e-9)
    m_ex, m_es = exact["memory_analysis"], est["memory_analysis"]
    assert m_es["argument_size_in_bytes"] == m_ex["argument_size_in_bytes"]
    assert m_es["peak_bytes"] == pytest.approx(m_ex["peak_bytes"], rel=0.10)
    assert est["param_bytes_per_device"] == exact["param_bytes_per_device"]


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

def _ref_dot_flops(shape: str) -> float:
    """The reference's ``hlo.analyze(...).dot_flops`` of its smoke qwen3-8b
    cell compiled on a one-device mesh (Auto axes)."""
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    cell = RS.build_cell(RC.get_config("qwen3-8b", smoke=True), shape, mesh)
    jitted = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                     out_shardings=cell.out_shardings, donate_argnums=cell.donate_argnums)
    with RR.use_sharding(mesh, fsdp=cell.static_meta.get("fsdp", False)):
        text = jitted.lower(*cell.args).compile().as_text()
    return RH.analyze(text).dot_flops


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_dot_flops_match_reference_hlo(shape, small_shapes, mesh_1x1):
    """The same cell's dot FLOPs, counted on the port's traced step and
    parsed from the reference's compiled HLO (loop-corrected): equal, the
    train step's remat recompute and 8 microbatches included."""
    cfg = TC.get_config("qwen3-8b", smoke=True)
    rec = D.run_cell(TS.build_cell(cfg, shape, mesh_1x1), mesh_1x1, "t", save=False,
                     device="cpu")
    want = _ref_dot_flops(shape)
    got = rec["hlo"]["dot_flops_per_device"]
    print(f"{shape}: port {got:.6e} reference {want:.6e} ({got / want - 1:+.4e})")
    assert got == pytest.approx(want, rel=HLO_RTOL)


def test_model_flops_equal_reference():
    """Every cell of the registry, on both production meshes' device counts."""
    for arch, cfg, shape in D.iter_cells():
        for devices in (256, 512):
            assert TREP.model_flops(arch, shape, devices) == RREP.model_flops(
                arch, shape, devices), (arch, shape)


def test_list_matches_reference():
    """``--list`` prints the reference's cells (both run in subprocesses:
    the reference's module sets XLA_FLAGS at import)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = {}
    for pkg in ("repro", "repro_torch"):
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.launch.dryrun", "--list"],
                              capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out[pkg] = proc.stdout
    assert out["repro_torch"] == out["repro"]
    assert len(out["repro"].splitlines()) > 30
