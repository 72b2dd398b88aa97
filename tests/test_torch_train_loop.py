"""The zoo's training loop on the port against the reference, on the CPU:
``TokenStream``, ``cosine_schedule``, the int8 moments (``Q8``) and
``AdamW8bit``, ``make_optimizer``, the step checkpoints (each package
restores the other's), ``CheckpointManager``, ``ResilientLoop`` (the
reference's own cases, and one scripted failure run through both loops,
which pins the retry quirk of ROADMAP Queue 3 item 11), ``Heartbeat``, the
launcher ``repro_torch.launch.train`` and K8's refusal of inputs that
require grad."""
from __future__ import annotations

import dataclasses
import json
import re
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as RM  # noqa: E402
from repro.distributed import fault_tolerance as RF  # noqa: E402
from repro.launch import train as RL  # noqa: E402
from repro.training import data as RD  # noqa: E402
from repro.training import optimizer as RO  # noqa: E402
from repro.zoo import configs as RC  # noqa: E402
from repro.zoo.configs import base as RB  # noqa: E402
from repro_torch.checkpoint import manager as TM  # noqa: E402
from repro_torch.distributed import fault_tolerance as TF  # noqa: E402
from repro_torch.kernels import flash_attention as TK8  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.training import data as TD  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.zoo.configs.base import leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# data, schedule, optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("structure", [0, 8])
@pytest.mark.parametrize("n_hosts", [1, 2])
def test_token_stream_bit_equal(structure, n_hosts):
    for seed in (0, 3):
        for host in range(n_hosts):
            kw = dict(vocab_size=1000, seq_len=37, global_batch=6, seed=seed, n_hosts=n_hosts,
                      host_id=host, structure=structure)
            want, got = RD.TokenStream(RD.TokenStreamConfig(**kw)), TD.TokenStream(
                TD.TokenStreamConfig(**kw))
            assert got.local_batch == want.local_batch
            for step in (0, 1, 17, 1000):
                a, b = got.batch_at(step), want.batch_at(step)
                assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
            it = iter(got)
            assert np.array_equal(next(it), want.batch_at(0))
    with pytest.raises(ValueError):
        TD.TokenStream(TD.TokenStreamConfig(10, 4, 3, n_hosts=2))


def test_cosine_schedule_matches():
    for warmup, total in ((10, 100), (0, 50), (5, 5)):
        for step in (0, 1, 4, 5, 9, 10, 11, 37, 50, 99, 100, 150):
            want = float(RO.cosine_schedule(step, base=1.0, warmup=warmup, total=total))
            got = TO.cosine_schedule(step, base=1.0, warmup=warmup, total=total)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_q8_encode_decode_bit_equal():
    rng = np.random.default_rng(0)
    for shape in ((64, 256), (3, 5, 7), (9,)):
        x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
        x.flat[0] = 0.5 * np.abs(x).max()  # a tie
        want = RO._q8_encode(jnp.asarray(x))
        got = TO._q8_encode(torch.from_numpy(x))
        assert got.q.dtype == torch.int8 and got.scale.shape == shape[:-1] + (1,)
        assert np.array_equal(got.q.numpy(), np.asarray(want.q))
        assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
        assert np.array_equal(TO._q8_decode(got).numpy(), np.asarray(RO._q8_decode(want)))
        back = TO._q8_decode(got).numpy()
        assert np.abs(back - x).max() / np.abs(x).max() < 1.5 / 127


def test_adamw8bit_three_steps_match():
    """Three updates from the same params and gradients (global norm under 1,
    so the clip scale is exactly 1 on both sides): the int8 moments and their
    scales equal the reference's, the params within 1e-6 relative (the bias
    corrections' powers may differ by an ulp between the two libraries)."""
    rng = np.random.default_rng(1)
    shapes = [(16, 24), (24,), (2, 8, 12)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ropt = RO.make_optimizer("adamw8bit", lr=1e-2, weight_decay=0.1)
    topt = TO.make_optimizer("adamw8bit", lr=1e-2, weight_decay=0.1)
    assert type(topt) is TO.AdamW8bit and type(TO.make_optimizer("adamw", 1e-2)) is TO.AdamW
    rp, tp = [jnp.asarray(p) for p in params], [torch.from_numpy(p.copy()) for p in params]
    rstate, tstate = ropt.init(rp), topt.init(tp)
    for _ in range(3):
        grads = [(0.1 * rng.standard_normal(s) / np.sqrt(sum(np.prod(x) for x in shapes)))
                 .astype(np.float32) for s in shapes]
        rupd, rstate = ropt.update([jnp.asarray(g) for g in grads], rstate, rp)
        tupd, tstate = topt.update([torch.from_numpy(g) for g in grads], tstate, tp)
        rp = RO.apply_updates(rp, rupd)
        tp = TO.apply_updates(tp, tupd)
        for tz, rz in zip(tstate.m + tstate.v, list(rstate.m) + list(rstate.v)):
            assert isinstance(tz, TO.Q8)
            assert np.array_equal(tz.q.numpy(), np.asarray(rz.q))
            assert np.array_equal(tz.scale.numpy(), np.asarray(rz.scale))
        for a, b in zip(tp, rp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert int(tstate.step) == 3
    with pytest.raises(ValueError):
        TO.make_optimizer("sgd", 1e-3)
    with pytest.raises(ValueError):
        RO.make_optimizer("sgd", 1e-3)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(seed=0):
    """A training state of both packages' shapes: (params, AdamWState) with
    Q8 moments, as numpy leaves: the reference's tree and the port's."""
    rng = np.random.default_rng(seed)
    params = {"blocks": [{"w": rng.standard_normal((2, 3, 4)).astype(np.float32)}],
              "embed": rng.standard_normal((5, 4)).astype(np.float32), "tail": []}
    rparams = jax.tree.map(jnp.asarray, params)
    ropt = RO.AdamW8bit(lr=1e-2)
    rstate = ropt.init(rparams)
    g = jax.tree.map(lambda p: 0.01 * jnp.ones_like(p), rparams)
    _, rstate = ropt.update(g, rstate, rparams)
    tparams = {"blocks": [{"w": torch.nn.Parameter(torch.from_numpy(params["blocks"][0]["w"]))}],
               "embed": torch.nn.Parameter(torch.from_numpy(params["embed"])), "tail": []}
    topt = TO.AdamW8bit(lr=1e-2)
    tstate = topt.init(leaves(tparams))
    _, tstate = topt.update([0.01 * torch.ones_like(p) for p in leaves(tparams)], tstate,
                            leaves(tparams))
    return (rparams, rstate), (tparams, tstate)


def _np_leaves(tree, ref=False):
    flat = jax.tree.leaves(tree) if ref else leaves(tree)
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x) for x in flat]


def test_checkpoint_round_trip_and_cross_package(tmp_path):
    rtree, ttree = _state()
    assert [a.shape for a in _np_leaves(ttree)] == [a.shape for a in _np_leaves(rtree, True)]
    assert all(np.array_equal(a, b) for a, b in zip(_np_leaves(ttree), _np_leaves(rtree, True)))
    # the port's round trip, into fresh zeros
    TM.save(ttree, tmp_path / "port", 7)
    like = (ttree[0],
            TO.AdamWState(torch.zeros((), dtype=torch.int32),
                          [TO.Q8(torch.zeros_like(z.q), torch.zeros_like(z.scale))
                           for z in ttree[1].m],
                          [TO.Q8(torch.zeros_like(z.q), torch.zeros_like(z.scale))
                           for z in ttree[1].v]))
    got, step = TM.restore(like, tmp_path / "port")
    assert step == 7 and isinstance(got[1], TO.AdamWState) and isinstance(got[1].m[0], TO.Q8)
    assert isinstance(got[0]["embed"], torch.nn.Parameter) and got[0]["embed"].requires_grad
    assert got[1].m[0].q.dtype == torch.int8
    assert all(np.array_equal(a, b) for a, b in zip(_np_leaves(got), _np_leaves(ttree)))
    # port save -> reference restore
    rgot, rstep = RM.restore(jax.tree.map(jnp.zeros_like, rtree), tmp_path / "port")
    assert rstep == 7
    assert all(np.array_equal(a, b) for a, b in zip(_np_leaves(rgot, True), _np_leaves(ttree)))
    # reference save -> port restore
    RM.save(rtree, tmp_path / "ref", 3)
    got, step = TM.restore(like, tmp_path / "ref")
    assert step == 3
    assert all(np.array_equal(a, b) for a, b in zip(_np_leaves(got), _np_leaves(rtree, True)))
    # the manifests list the same keys, shapes and dtypes; the names of the
    # params and the step match (the moments: lists on the port's side)
    mp = json.loads((tmp_path / "port" / "step_000000007" / "manifest.json").read_text())
    mr = json.loads((tmp_path / "ref" / "step_000000003" / "manifest.json").read_text())
    strip = lambda m: [(e["key"], e["shape"], e["dtype"]) for e in m["leaves"]]  # noqa: E731
    assert strip(mp) == strip(mr)
    names = lambda m: [e["name"] for e in m["leaves"] if ".m" not in e["name"]  # noqa: E731
                       and ".v" not in e["name"]]
    assert names(mp) == names(mr)


def test_checkpoint_ignores_tmp_and_refuses_bf16(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "step": torch.tensor(7, dtype=torch.int32)}
    TM.save(tree, tmp_path, 1)
    (tmp_path / "step_000000009.tmp").mkdir()
    assert TM.latest_step(tmp_path) == RM.latest_step(tmp_path) == 1
    got, step = TM.restore({"w": torch.zeros(3, 4), "step": torch.tensor(0, dtype=torch.int32)},
                           tmp_path)
    assert step == 1 and torch.equal(got["w"], tree["w"]) and int(got["step"]) == 7
    with pytest.raises(ValueError, match="bfloat16"):
        TM.save({"w": torch.ones(2, dtype=torch.bfloat16)}, tmp_path, 2)
    with pytest.raises(ValueError, match="leaves"):
        TM.restore({"w": torch.zeros(3, 4)}, tmp_path)
    with pytest.raises(FileNotFoundError):
        TM.restore(tree, tmp_path / "none")


def test_checkpoint_manager_keeps_newest_and_reraises(tmp_path):
    mgr = TM.CheckpointManager(tmp_path, keep=3)
    tree = {"w": torch.arange(6.0)}
    for s in (1, 2, 3, 4, 5):
        mgr.save_async(tree, s)
        tree["w"].add_(1.0)  # in place after the snapshot: the checkpoint keeps the old value
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_") and not p.name.endswith(".tmp"))
    assert steps == [3, 4, 5] and mgr.save_count == 5
    got, _ = TM.restore({"w": torch.zeros(6)}, tmp_path, step=4)
    assert torch.equal(got["w"], torch.arange(6.0) + 3)
    (tmp_path / "blocked").write_text("a file where a directory goes")
    bad = TM.CheckpointManager(tmp_path / "blocked")
    bad.save_async(tree, 1)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()  # the error is raised once


# ---------------------------------------------------------------------------
# the resilient loop
# ---------------------------------------------------------------------------

def test_resilient_loop_runs_and_checkpoints(tmp_path):
    """The reference's ``tests/test_infra.py`` case on the port."""
    def step(state, batch):
        return state + batch, {"loss": float(state)}

    loop = TF.ResilientLoop(step, torch.zeros(()), ckpt_dir=str(tmp_path), ckpt_every=2)
    list(loop.run(iter([1.0, 1.0, 1.0, 1.0]), steps=4))
    assert TM.latest_step(tmp_path) is not None
    loop2 = TF.ResilientLoop(step, torch.zeros(()), ckpt_dir=str(tmp_path), ckpt_every=2)
    assert loop2.resumed and loop2.step >= 1
    assert float(loop2.state) > 0


def test_resilient_loop_retries_transient_failure(tmp_path):
    """The reference's ``tests/test_infra.py`` case on the port."""
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated preemption")
        return state + 1, {}

    loop = TF.ResilientLoop(flaky, torch.zeros(()), ckpt_dir=str(tmp_path), ckpt_every=1,
                            max_retries=2)
    list(loop.run(iter([0, 0, 0, 0]), steps=4))
    assert calls["n"] >= 5


def _scripted_run(pkg, zero, tmp_path, fail_at):
    """Run ``pkg``'s ResilientLoop over batches 1, 10, 100, ... with a step
    that fails once at call ``fail_at`` (after a pause that lets the async
    checkpoint of an earlier step publish); return the (step, state) pairs,
    the calls and the published steps."""
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == fail_at:
            time.sleep(0.3)
            raise RuntimeError("simulated preemption")
        return state + batch, {}

    loop = pkg.ResilientLoop(step, zero, ckpt_dir=str(tmp_path), ckpt_every=2, max_retries=2)
    seen = [(s, float(loop.state)) for s, _ in loop.run(iter([10.0**i for i in range(7)]),
                                                         steps=7)]
    published = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    return seen, calls["n"], published, float(loop.state)


def test_resilient_loop_retry_quirk_matches_reference(tmp_path):
    """Batches 1, 10, 100, ... and a checkpoint every two steps; the step
    fails once.  At call 4 (step 3) and call 6 (step 5) the newest published
    checkpoint (steps 2 and 4) is the state the step started from, so the
    retry loses nothing.  At call 5 (step 4) the retry restores step 2's
    checkpoint and keeps the step counter and the batch, so step 3's batch
    (1000) is dropped, not replayed (the reference's quirk, ROADMAP Queue 3
    item 11).  Both loops yield the same (step, state) pairs, make the same
    calls and publish the same checkpoints."""
    total = sum(10.0**i for i in range(7))
    for fail_at, final in ((4, total), (5, total - 1000.0), (6, total)):
        want = _scripted_run(RF, jnp.zeros(()), tmp_path / f"r{fail_at}", fail_at)
        got = _scripted_run(TF, torch.zeros(()), tmp_path / f"t{fail_at}", fail_at)
        assert got == want, fail_at
        assert got[3] == final and got[1] == 8
        assert got[2] == ["step_000000002", "step_000000004", "step_000000006"]


def test_heartbeat_staleness(tmp_path):
    hb = TF.Heartbeat(str(tmp_path), host_id=3)
    hb.beat(10)
    assert TF.Heartbeat.stale_hosts(str(tmp_path), timeout_s=60) == []
    data = json.loads(hb.path.read_text())
    assert data["step"] == 10
    data["t"] -= 3600
    hb.path.write_text(json.dumps(data))
    assert TF.Heartbeat.stale_hosts(str(tmp_path), timeout_s=60) == ["heartbeat_3"]
    assert RF.Heartbeat.stale_hosts(str(tmp_path), timeout_s=60) == ["heartbeat_3"]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LINE = re.compile(r"^step +(\d+) loss (\S+) gnorm (\S+) \(\S+s\)$")


def _loss_lines(out: str) -> list:
    return [(int(m[1]), float(m[2]), float(m[3]))
            for m in map(LINE.match, out.splitlines()) if m]


def test_launcher_prints_reference_loss_lines(tmp_path, capsys, monkeypatch):
    """The reference's launcher and the port's from the same params (the
    port's ``materialize`` patched to the reference's draw), both with the
    smoke config in f32 (``get_config`` patched on both sides; the smoke
    configs' own bf16 rounds at other points on the two sides, as
    ``test_torch_zoo_train.py``'s bf16 case bounds): the same lines;
    step 0's loss within a unit of its last printed digit (4 decimals) and
    its norm likewise (3 decimals); the later steps' within 1e-3 and 1e-2:
    Adam's first steps move each parameter whose gradient is near zero by
    about lr on the gradient's sign, which the two sides' rounding may flip
    (``test_torch_zoo_train.py`` counts them), and that moves the next
    loss in its fourth decimal."""
    argv = ["--arch", "qwen3-8b", "--smoke", "--steps", "3", "--log-every", "1",
            "--global-batch", "4", "--seq-len", "32"]
    for mod, get in ((RL, RC.get_config), (TL, TL.get_config)):
        monkeypatch.setattr(mod, "get_config", lambda *a, get=get, **k: dataclasses.replace(
            get(*a, **k), dtype="float32"))
    RL.main(argv + ["--ckpt-dir", str(tmp_path / "r")])
    want_out = capsys.readouterr().out
    rc = RC.get_config("qwen3-8b", smoke=True)
    drawn = jax.tree.map(np.asarray, RB.materialize(RB.model_spec_tree(rc), jax.random.key(0),
                                                    jnp.float32))
    monkeypatch.setattr(TL, "materialize", lambda *a, **k: drawn)
    TL.main(argv + ["--ckpt-dir", str(tmp_path / "t")], device="cpu")
    got_out = capsys.readouterr().out
    want, got = _loss_lines(want_out), _loss_lines(got_out)
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == [0, 1, 2]
    for (step, gl, gn), (_, wl, wn) in zip(got, want):
        tl, tn = (1.01e-4, 1.01e-3) if step == 0 else (1e-3, 1e-2)
        assert abs(gl - wl) <= tl and abs(gn - wn) <= tn, (step, gl, wl, gn, wn)
    assert got_out.splitlines()[-1] == want_out.splitlines()[-1] == "done."
    assert (tmp_path / "t" / "heartbeat_0.json").exists()
    assert sorted(p.name for p in (tmp_path / "t").glob("step_*")) == sorted(
        p.name for p in (tmp_path / "r").glob("step_*"))


def test_launcher_resumes(tmp_path, capsys):
    """Six steps with a checkpoint every three, then the same directory to
    twelve: "resumed from step 6" and only steps 6-11 run; the final
    checkpoint equals an uninterrupted twelve-step run's, bit for bit (the
    CPU run is deterministic)."""
    base = ["--arch", "qwen3-8b", "--smoke", "--log-every", "1", "--global-batch", "2",
            "--seq-len", "16", "--ckpt-every", "3"]
    TL.main(base + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")], device="cpu")
    first = _loss_lines(capsys.readouterr().out)
    TL.main(base + ["--steps", "12", "--ckpt-dir", str(tmp_path / "a")], device="cpu")
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "resumed from step 6"
    assert [s for s, _, _ in first] == list(range(6))
    assert [s for s, _, _ in _loss_lines(out)] == list(range(6, 12))
    TL.main(base + ["--steps", "12", "--ckpt-dir", str(tmp_path / "b")], device="cpu")
    capsys.readouterr()
    a = np.load(tmp_path / "a" / "step_000000011" / "shard_0.npz")
    b = np.load(tmp_path / "b" / "step_000000011" / "shard_0.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_launcher_refuses_pod_mesh_and_missing_card(tmp_path, monkeypatch):
    # the production meshes need a 256- or 512-rank world; none is initialised here
    from repro_torch.launch.mesh import MeshConfigError

    for mesh, ranks in (("pod", 256), ("multipod", 512)):
        with pytest.raises(MeshConfigError, match=f"needs a process group of {ranks} ranks"):
            TL.main(["--arch", "qwen3-8b", "--smoke", "--mesh", mesh], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1",
                 "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# K8 under grad
# ---------------------------------------------------------------------------

def test_flash_attention_refuses_grad():
    q = torch.randn(2, 8, 64, requires_grad=True)
    k, v = torch.randn(2, 8, 64), torch.randn(2, 8, 64)
    with pytest.raises(RuntimeError, match="block schedule"):
        TK8.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        TK8.flash_attention(q.detach(), k.requires_grad_(), v)
    with torch.no_grad():
        out = TK8.flash_attention(q, k, v)
    assert out.grad_fn is None
    k.requires_grad_(False)
    torch.testing.assert_close(TK8.flash_attention(q.detach(), k, v),
                               TK8.flash_plain(q.detach(), k, v))


KERNEL_WRAPPERS = {  # K1-K7: the wrapper and its arguments, x_p first
    "ld_grouped_apply": ("groot_spmm", lambda f, x, w: f(x, None, w, 2)),
    "ld_grouped_mxu_apply": ("groot_spmm", lambda f, x, w: f(x, None, w, 2)),
    "hd_grouped_apply": ("groot_spmm", lambda f, x, w: f(x, None, w, None, None, 512)),
    "ld_bucket_apply": ("groot_spmm", lambda f, x, w: f(x, None, 2, w)),
    "hd_apply": ("groot_spmm", lambda f, x, w: f(x, None, None, None, 512, w)),
    "fused_ld_matmul": ("fused_sage", lambda f, x, w: f(x, None, w, 2)),
    "fused_ld_matmul_grouped": ("fused_sage", lambda f, x, w: f(x, None, None, w, 2)),
}


@pytest.mark.parametrize("name", sorted(KERNEL_WRAPPERS))
def test_kernel_wrappers_refuse_grad(name):
    """K1-K7 write through ``ctypes`` into fresh outputs and have no
    backward: each wrapper raises, on every device and before it checks or
    touches anything else, when grad mode is on and its input or weight
    requires grad."""
    import importlib

    mod, call = KERNEL_WRAPPERS[name]
    fn = getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), name)
    x, w = torch.ones(5, 4), torch.ones(4, 2)
    for xg, wg in ((True, False), (False, True)):
        with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward"):
            call(fn, x.clone().requires_grad_(xg), w.clone().requires_grad_(wg))
