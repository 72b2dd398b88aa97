"""The port's distribution code with real collectives: ``gloo`` ranks on the
CPU, each test one subprocess that forks its ranks (``GLOO_SOCKET_IFNAME=lo``,
``MASTER_ADDR=127.0.0.1``, a free port, a timeout).

* the sharded train step on a (2, 4) mesh (FSDP + TP, 2 microbatches,
  qwen3-8b smoke in bf16 and in f32), through ``launch/train.py``'s
  ``place_train_state``, against the port's single-device step and the
  reference's single-device step: loss within rtol 2e-3, params within 5e-3
  (the reference test's own tolerances; the reference's own sharded run
  raises under jax 0.9's Explicit mesh axes, ROADMAP Queue 3, so it is no
  yardstick), and the gradients, read from the first moments, within
  ``GRAD_TOL``;
* the sharded state's checkpoint: written once, by rank 0, equal to the
  single-device checkpoint of the gathered state, and restored to the same
  shards;
* ``moe_ffn_dist`` on a (2, 4) mesh against ``moe_ffn`` (port and
  reference) within 2e-4;
* ``pipeline_apply`` (4 stages, 8 microbatches) against the stages applied
  in sequence within 1e-5;
* the int8 compressed all-reduce: close to the mean (atol 0.05), an error
  state left, compression ratio < 0.3;
* ``choose_mesh`` and ``replan_batch`` against the reference's.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import elastic as RE  # noqa: E402
from repro.training import optimizer as RO  # noqa: E402
from repro.training import train_step as RTS  # noqa: E402
from repro.zoo import configs as RC  # noqa: E402
from repro.zoo.configs import base as RB  # noqa: E402
from repro.zoo.models import moe as RM  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402
from repro_torch.zoo import configs as TC  # noqa: E402
from repro_torch.zoo.configs.base import leaves  # noqa: E402
from repro_torch.zoo.models import moe as TM  # noqa: E402
from repro_torch.zoo.models import transformer as TT  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240
#: the sharded step's gradients, by compute dtype: (each leaf's first moment
#: within this relative L2 of the single-device step's, the grad norm's
#: rtol).  Measured on a CPU: 2.4e-6 and 1e-6 in f32; in bf16 the two
#: single-device steps sit 0.028 apart a leaf (rounding of bf16 activations
#: in another order) and the sharded one 0.042 from either, its norm 6e-4.
#: A zero, sign-flipped or half-batch gradient is off by 0.5 or more.
GRAD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (0.1, 2e-3)}

RANKS = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        body(rank, world, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    mp.start_processes(_rank, args=(world, port, out), nprocs=world, start_method="fork")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, body: str, world: int) -> None:
    """Run ``body(rank, world, out)`` (source defining it) on ``world``
    forked gloo ranks; ``out`` is ``tmp_path``."""
    script = tmp_path / "ranks.py"
    script.write_text(textwrap.dedent(body) + RANKS)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", MASTER_ADDR="127.0.0.1",
               PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(world), str(_free_port()),
                           str(tmp_path)], capture_output=True, text=True, env=env,
                          timeout=TIMEOUT, cwd=REPO)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sharded_train_step_matches_single_device(tmp_path, dtype):
    """FSDP + TP over a (2, 4) gloo mesh, 2 microbatches: the step that
    ``launch/train.py --mesh`` runs equals the port's and the reference's
    single-device steps."""
    rc = dataclasses.replace(RC.get_config("qwen3-8b", smoke=True), dtype=dtype)
    tc = dataclasses.replace(TC.get_config("qwen3-8b", smoke=True), dtype=dtype)
    tree = jax.tree.map(np.asarray, RB.materialize(RB.model_spec_tree(rc), jax.random.key(0),
                                                   jnp.float32))
    tok = np.random.default_rng(0).integers(0, rc.vocab_size, (8, 33)).astype(np.int32)
    ropt = RO.AdamW(lr=1e-3)
    rp, rstate, rmet = jax.jit(RTS.make_train_step(rc, ropt, microbatches=2))(
        jax.tree.map(jnp.asarray, tree), ropt.init(jax.tree.map(jnp.asarray, tree)),
        {"tokens": jnp.asarray(tok)})
    topt = TO.AdamW(lr=1e-3)
    tp = TT.params_from_numpy(tree, tc, "cpu", trainable=True)
    tp, tstate, tmet = TTS.make_train_step(tc, topt, microbatches=2)(
        tp, topt.init(leaves(tp)), {"tokens": torch.from_numpy(tok)})
    np.savez(tmp_path / "in.npz", tok, *leaves(tree))

    run_ranks(tmp_path, """
        def body(rank, world, out):
            import dataclasses
            from torch.distributed.device_mesh import init_device_mesh
            from repro_torch.launch.train import place_train_state, shard_batch
            from repro_torch.sharding import use_sharding
            from repro_torch.training import optimizer as opt_mod
            from repro_torch.training.train_step import make_train_step
            from repro_torch.zoo.configs import get_config
            from repro_torch.zoo.configs.base import leaves, model_spec_tree, unflatten

            cfg = dataclasses.replace(get_config("qwen3-8b", smoke=True), dtype=DTYPE)
            data = np.load(f"{out}/in.npz")
            arrs = [data[f"arr_{i}"] for i in range(len(data.files))]
            tree = unflatten(model_spec_tree(cfg), arrs[1:])
            mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
            opt = opt_mod.AdamW(lr=1e-3)
            params, state = place_train_state(tree, cfg, mesh, opt)
            batch = shard_batch({"tokens": torch.from_numpy(arrs[0])}, mesh)
            with use_sharding(mesh, fsdp=True):
                params, state, met = make_train_step(cfg, opt, microbatches=2)(
                    params, state, batch)
            full = [p.detach().full_tensor().numpy() for p in leaves(params)]
            m = [z.full_tensor().numpy() for z in state.m]
            met = {k: v.full_tensor().numpy() for k, v in met.items()}
            if rank == 0:
                np.savez(f"{out}/got.npz", met["loss"], *full)
                np.savez(f"{out}/m.npz", met["grad_norm"], *m)
    """.replace("DTYPE", repr(dtype)), world=8)

    got = np.load(tmp_path / "got.npz")
    got = [got[f"arr_{i}"] for i in range(len(got.files))]
    m = np.load(tmp_path / "m.npz")
    m = [m[f"arr_{i}"] for i in range(len(m.files))]
    np.testing.assert_allclose(float(got[0]), float(rmet["loss"]), rtol=2e-3)
    np.testing.assert_allclose(float(got[0]), tmet["loss"].item(), rtol=2e-3)
    for g, r, t in zip(got[1:], jax.tree.leaves(rp), leaves(tp)):
        assert float(np.abs(g - np.asarray(r)).max()) < 5e-3
        assert float(np.abs(g - t.detach().numpy()).max()) < 5e-3
    # the gradients: after a first AdamW step from zero moments m = (1 - b1) g
    # (the norm is under the clip of 1, so g is unscaled), so the sharded
    # step's first moments against both single-device steps' hold the
    # gradient of every leaf through the same function
    m_tol, gn_rtol = GRAD_TOL[dtype]
    np.testing.assert_allclose(float(m[0]), float(rmet["grad_norm"]), rtol=gn_rtol)
    np.testing.assert_allclose(float(m[0]), tmet["grad_norm"].item(), rtol=gn_rtol)
    assert float(rmet["grad_norm"]) < 1.0
    for want in ([np.asarray(x) for x in jax.tree.leaves(rstate.m)],
                 [x.numpy() for x in tstate.m]):
        assert len(want) == len(m) - 1
        for g, w in zip(m[1:], want):
            assert g.shape == w.shape and np.linalg.norm(w) > 0
            assert np.linalg.norm(g - w) <= m_tol * np.linalg.norm(w), \
                (g.shape, np.linalg.norm(g - w) / np.linalg.norm(w))


def test_sharded_checkpoint_written_once(tmp_path):
    """The sharded launcher's state on a (2, 4) mesh, saved through
    ``CheckpointManager``: one checkpoint, written by rank 0, equal leaf for
    leaf (names, shapes, dtypes, values) to the single-device save of the
    gathered state; ``restore`` gives every rank back its own shards with
    the placements, params as parameters."""
    rc = RC.get_config("qwen3-8b", smoke=True)
    tree = jax.tree.map(np.asarray, RB.materialize(RB.model_spec_tree(rc), jax.random.key(3),
                                                   jnp.float32))
    np.savez(tmp_path / "in.npz", *leaves(tree))

    run_ranks(tmp_path, """
        def body(rank, world, out):
            from torch.distributed.device_mesh import init_device_mesh
            from repro_torch.checkpoint.manager import CheckpointManager, restore, save
            from repro_torch.launch.train import place_train_state
            from repro_torch.sharding.rules import is_dtensor
            from repro_torch.training import optimizer as opt_mod
            from repro_torch.zoo.configs import get_config
            from repro_torch.zoo.configs.base import leaves, model_spec_tree, tree_map, unflatten

            cfg = get_config("qwen3-8b", smoke=True)
            data = np.load(f"{out}/in.npz")
            tree = unflatten(model_spec_tree(cfg), [data[f"arr_{i}"]
                                                    for i in range(len(data.files))])
            mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
            opt = opt_mod.AdamW(lr=1e-3)
            params, state = place_train_state(tree, cfg, mesh, opt)
            plist = leaves(params)
            with torch.no_grad():  # moments that differ from the params and from 0
                state = state._replace(m=[p * 2 for p in plist], v=[p * p for p in plist])
            mgr = CheckpointManager(f"{out}/ck")
            mgr.save_async((params, state), 3)
            mgr.wait()
            assert mgr.save_count == 1
            whole = tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, (params, state))
            if rank == 0:
                save(whole, f"{out}/single", 3)

            zeros = tree_map(np.zeros_like, tree)
            like = place_train_state(zeros, cfg, mesh, opt)
            (got_p, got_s), step = restore(like, f"{out}/ck")
            assert step == 3
            assert all(isinstance(p, torch.nn.Parameter) and p.requires_grad
                       for p in leaves(got_p))
            for a, b in zip(leaves((got_p, got_s)), leaves((params, state))):
                assert is_dtensor(a) == is_dtensor(b)
                if is_dtensor(a):
                    assert tuple(a.placements) == tuple(b.placements)
                    assert torch.equal(a.to_local(), b.to_local())
                else:
                    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    """, world=8)

    ck, single = tmp_path / "ck", tmp_path / "single"
    assert sorted(p.name for p in ck.iterdir()) == ["step_000000003"]
    step_dir = ck / "step_000000003"
    assert sorted(p.name for p in step_dir.iterdir()) == ["manifest.json", "shard_0.npz"]
    assert (step_dir / "manifest.json").read_text() == \
        (single / "step_000000003" / "manifest.json").read_text()
    with np.load(step_dir / "shard_0.npz") as a, \
            np.load(single / "step_000000003" / "shard_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)

def test_moe_ffn_dist_matches_dense_path(tmp_path):
    """``moe_ffn_dist`` (``local_map`` expert parallelism over "model", one
    all-reduce) equals ``moe_ffn`` on both packages."""
    cfg_kw = dict(num_experts=8, top_k=2, capacity_factor=8.0)
    rc = dataclasses.replace(RC.get_config("qwen3-moe-235b-a22b", smoke=True), **cfg_kw)
    tc = dataclasses.replace(TC.get_config("qwen3-moe-235b-a22b", smoke=True), **cfg_kw)
    p = jax.tree.map(np.asarray, RB.materialize(RB.param_tree(rc)["layers"][0]["moe"],
                                                jax.random.key(1), jnp.float32))
    x = np.asarray(jax.random.normal(jax.random.key(2), (4, 8, rc.d_model), jnp.float32))
    want = np.asarray(RM.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), rc))
    port = TM.moe_ffn(torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()}, tc)
    np.testing.assert_allclose(port.numpy(), want, rtol=2e-4, atol=2e-4)
    np.savez(tmp_path / "in.npz", x=x, **p)

    run_ranks(tmp_path, """
        def body(rank, world, out):
            import dataclasses
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import distribute_tensor
            from repro_torch.sharding import make_rules, use_sharding
            from repro_torch.sharding.rules import partition_spec, placements
            from repro_torch.zoo.configs import get_config
            from repro_torch.zoo.configs.base import param_tree
            from repro_torch.zoo.models.moe import moe_ffn_dist

            cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b", smoke=True),
                                      num_experts=8, top_k=2, capacity_factor=8.0)
            data = dict(np.load(f"{out}/in.npz"))
            mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
            rules = make_rules(mesh)
            specs = param_tree(cfg)["layers"][0]["moe"]
            p = {k: distribute_tensor(torch.from_numpy(data[k]), mesh,
                                      placements(partition_spec(s.shape, s.axes, mesh, rules),
                                                 mesh))
                 for k, s in specs.items()}
            x = distribute_tensor(torch.from_numpy(data["x"]), mesh,
                                  placements(("data", None, None), mesh))
            with use_sharding(mesh):
                y = moe_ffn_dist(x, p, cfg).full_tensor()
            if rank == 0:
                np.save(f"{out}/got.npy", y.numpy())
    """, world=8)
    np.testing.assert_allclose(np.load(tmp_path / "got.npy"), want, rtol=2e-4, atol=2e-4)


def test_pipeline_parallel_matches_sequential(tmp_path):
    """The GPipe send/recv schedule equals applying the stages in turn."""
    rng = np.random.default_rng(0)
    n_stages, n_micro, b, d = 4, 8, 2, 16
    ws = (rng.standard_normal((n_stages, d, d)) * 0.3).astype(np.float32)
    x_mb = rng.standard_normal((n_micro, b, d)).astype(np.float32)
    want = x_mb
    for s in range(n_stages):
        want = np.tanh(want @ ws[s])
    np.savez(tmp_path / "in.npz", ws=ws, x=x_mb)

    run_ranks(tmp_path, """
        def body(rank, world, out):
            from repro_torch.distributed.pipeline_parallel import pipeline_apply

            data = np.load(f"{out}/in.npz")
            ws = torch.from_numpy(data["ws"])
            got = pipeline_apply(lambda w, x: torch.tanh(x @ w), ws[rank:rank + 1],
                                 torch.from_numpy(data["x"]))
            np.save(f"{out}/got_{rank}.npy", got.numpy())
    """, world=n_stages)
    for r in range(n_stages):  # every stage returns the last stage's outputs
        np.testing.assert_allclose(np.load(tmp_path / f"got_{r}.npy"), want, rtol=1e-5,
                                   atol=1e-5)


def test_grad_compression_error_feedback(tmp_path):
    """int8 all-reduce with error feedback: close to the mean, the residual
    kept, about a quarter of the f32 bytes on the wire."""
    g_all = np.random.default_rng(0).standard_normal((4, 64, 128)).astype(np.float32)
    np.save(tmp_path / "g.npy", g_all)

    run_ranks(tmp_path, """
        def body(rank, world, out):
            from repro_torch.distributed.grad_compression import (
                compressed_psum, compression_ratio, init_error_state)

            g = torch.from_numpy(np.load(f"{out}/g.npy")[rank])
            got, err = compressed_psum({"w": g}, None, init_error_state({"w": g}))
            if rank == 0:
                np.savez(f"{out}/got.npz", out=got["w"].numpy(), err=err["w"].numpy(),
                         ratio=compression_ratio({"w": g}))
    """, world=4)
    got = np.load(tmp_path / "got.npz")
    np.testing.assert_allclose(got["out"], g_all.mean(0), atol=0.05)
    assert float(np.abs(got["err"]).max()) > 0
    assert float(got["ratio"]) < 0.3


def test_elastic_mesh_choice():
    """``choose_mesh`` over a process group's ranks (the reference's test's
    shapes) and ``replan_batch`` against the reference's plan."""
    from repro_torch.distributed import elastic as TE
    from repro_torch.launch.dryrun import fake_world

    with fake_world(8):
        assert tuple(TE.choose_mesh(8, prefer_model=4, device_type="cpu").shape) == (2, 4)
        m2 = TE.choose_mesh(6, prefer_model=4, device_type="cpu")  # degraded topology
        assert tuple(m2.shape) == (3, 2) and m2.mesh_dim_names == ("data", "model")
    assert TE.mesh_shape(512) == (32, 16) and TE.mesh_shape(24) == (3, 8)
    assert TE.replan_batch(96, old_data=4, new_data=3) == RE.replan_batch(96, 4, 3)
    assert TE.replan_batch(96, old_data=4, new_data=3)["per_device_batch_new"] == 32

