"""trinity-mini (AFMoE), the port-only architecture, at ``smoke_config()``
sizes on the CPU against the plain reference ``tests/afmoe_reference.py``
(plain torch, float32, TF32 off; it imports nothing of the port or of JAX):
the forward over whole rows, left-padded prefill then decode through
``BatchServer``, the dropless dispatch against the per-expert loop under
uneven routing, each planted fault of ``bench/afmoe_faults.py`` caught;
the ten reference architectures unchanged by the port-only options; the
registry's place for port-only architectures.

Tolerances: the program runs in float32 here, the reference in float32,
so only the order of the sums differs (an f32 ulp, 6e-8, a product, grown
over 6 layers and a 512-row head to about 1e-6 of the logits): 1e-4 of
max(1, max|reference|), the zoo's ``F32_TOL``.  Ties in the top-k do not
occur at these sizes (the selection scores differ by far more than the
rounding).  A fault must read above 10x that tolerance.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # ``bench`` beside ``src``
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import afmoe_reference as ref  # noqa: E402
from bench import afmoe_faults  # noqa: E402
from repro.zoo import configs as RC  # noqa: E402
from repro.zoo.configs import base as RB  # noqa: E402
from repro.zoo.models import transformer as RT  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs.metrics import REGISTRY  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.zoo import configs as TC  # noqa: E402
from repro_torch.zoo.configs import base as TB  # noqa: E402
from repro_torch.zoo.models import moe  # noqa: E402
from repro_torch.zoo.models import transformer as TT  # noqa: E402
from repro_torch.zoo.serving import decode  # noqa: E402

TOL = 1e-4
FAULT_FACTOR = 10


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def setup(seed: int = 0):
    cfg = dataclasses.replace(TC.get_config("trinity-mini", smoke=True), dtype="float32")
    model = dataclasses.asdict(cfg)
    weights = ref.make_weights(model, seed)
    return cfg, model, weights, TT.params_from_numpy(weights, cfg, "cpu")


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_forward_equals_the_reference(seed):
    cfg, model, weights, params = setup(seed)
    rows = torch.as_tensor(np.random.default_rng(seed).integers(0, 512, (3, 21)))
    got, _ = TT.model_forward(params, cfg, rows)
    want = ref.logits(weights, model, rows, 0)
    assert rel_err(got, want) <= TOL


def _serve_captured(server, reqs):
    """``serve_batch`` with the prefill and decode logits of every row kept."""
    kept = []
    prefill, decode = server.prefill, server.decode

    def keep_prefill(params, tokens, *a):
        last, cache = prefill(params, tokens, *a)
        kept.append(last.float())
        return last, cache

    def keep_decode(params, cache, token):
        nxt, logits, cache = decode(params, cache, token)
        kept.append(logits.float())
        return nxt, logits, cache

    server.prefill, server.decode = keep_prefill, keep_decode
    server.serve_batch(reqs)
    return torch.stack(kept, 1)


@pytest.mark.parametrize("seed", [1, 2**31 + 6])
def test_left_padded_prefill_then_decode_through_batchserver(seed, monkeypatch):
    """Prompts of 5, 12 and 17 tokens (the window is 8: the ring caches
    wrap, and the longest prompt keeps only its tail) left-padded into one
    batch, then 9 decode steps: every row's logits at every served position
    against the reference over the row as the server built it.  The server's
    KV cache is held in f32 here (bf16 as served): a bf16 cache rounds K and
    V by 2^-9, which moves the router's scores enough to swap a chosen
    expert now and then, and one swapped expert of 2 moves a row's logits by
    far more than the f32 tolerance (the chip's comparison judges bf16)."""
    plain = decode.init_cache_tree
    monkeypatch.setattr(decode, "init_cache_tree",
                        lambda *a, **kw: plain(*a, **{**kw, "dtype": torch.float32}))
    cfg, model, weights, params = setup(seed)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 12, 17)]
    new = 10
    server = serve.BatchServer(cfg, params, batch=3, max_seq=17 + new, device="cpu")
    reqs = [serve.Request(rid=i, prompt=p, max_new=new) for i, p in enumerate(prompts)]
    got = _serve_captured(server, reqs)
    for i, r in enumerate(reqs):
        row = np.concatenate([np.zeros(17 - len(r.prompt), np.int64), r.prompt, r.out[:-1]])
        want = ref.logits(weights, model, torch.as_tensor(row)[None], 16)[0]
        assert rel_err(got[i], want) <= TOL, i
        np.testing.assert_array_equal(r.out, want.argmax(-1).numpy())


def test_dropless_dispatch_equals_the_per_expert_loop_under_uneven_routing():
    """A bias that sends most tokens to experts 0 and 1: the dropless
    dispatch equals the reference's loop over the chosen experts (shared
    expert included), every assignment kept, where a capacity dispatch
    (capacity factor 1.25) would drop most of them."""
    cfg, model, weights, _ = setup(3)
    p = {k: v for k, v in weights["layers"][2]["moe"].items()}
    p["bias"] = torch.zeros(cfg.num_experts).index_fill_(0, torch.tensor([0, 1]), 0.6)
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(4))
    sel, _ = ref.route(x.reshape(-1, cfg.d_model), p, model)
    counts = torch.bincount(sel.flatten(), minlength=cfg.num_experts)
    assert int(counts[:2].sum()) >= 0.75 * sel.numel()
    want = ref.moe(x.reshape(-1, cfg.d_model), p, model).view_as(x)
    before = REGISTRY.counter("moe.assignments").value
    active = REGISTRY.counter("moe.experts_active").value
    tracer = Tracer()
    with tracer.activate():
        got = moe.moe_dropless(x, p, cfg)
    assert rel_err(got, want) <= 1e-5
    [sp] = [sp for sp in tracer.spans() if sp.name == "moe.experts"]
    assert sp.attrs == {"routed": sel.numel(), "computed": sel.numel(),
                        "experts": int((counts > 0).sum())}
    assert {sp.name for sp in tracer.spans()} == {"moe.route", "moe.dispatch", "moe.experts",
                                                  "moe.combine", "moe.shared"}
    assert REGISTRY.counter("moe.assignments").value - before == sel.numel()
    assert REGISTRY.counter("moe.experts_active").value - active == int((counts > 0).sum())
    assert REGISTRY.gauge("moe.max_expert_tokens").value == int(counts.max())
    # a capacity dispatch would have dropped most of experts 0 and 1's tokens
    assert int(counts[:2].min()) > 2 * moe.capacity(x.shape[0] * x.shape[1], cfg)


def test_grouped_mm_plain_skips_empty_segments():
    x = torch.randn((7, 4), generator=torch.Generator().manual_seed(0))
    w = torch.randn((4, 4, 3), generator=torch.Generator().manual_seed(1))
    offs = torch.tensor([2, 2, 7, 7], dtype=torch.int32)
    got = moe.grouped_mm(x, w, offs)
    torch.testing.assert_close(got, torch.cat([x[:2] @ w[0], x[2:] @ w[2]]))


def test_dropless_layer_refuses_a_sharding_context(monkeypatch):
    """The expert-parallel form drops tokens past capacity and routes
    without the selection bias: a dropless config must not fall into it."""
    import repro_torch.sharding as sh

    cfg, _, weights, _ = setup(6)
    p = weights["layers"][2]["moe"]
    x = torch.randn((1, 4, cfg.d_model), generator=torch.Generator().manual_seed(6))
    monkeypatch.setattr(sh, "current_ctx", lambda: object())
    with pytest.raises(NotImplementedError, match="no expert-parallel form"):
        moe.moe_apply(x, p, cfg)


@pytest.mark.parametrize("fault", afmoe_faults.FAULTS)
def test_each_planted_fault_fails_the_comparison(fault):
    cfg, model, weights, params = setup(5)
    rows = torch.as_tensor(np.random.default_rng(5).integers(0, 512, (2, 21)))
    want = ref.logits(weights, model, rows, 0)
    with afmoe_faults.planted(fault):
        got, _ = TT.model_forward(params, cfg, rows)
    assert rel_err(got, want) > FAULT_FACTOR * TOL
    got, _ = TT.model_forward(params, cfg, rows)   # and the patch is gone
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("arch", sorted(RC.LM_ARCHS))
def test_reference_archs_unchanged(arch):
    """The ten reference architectures read every port-only option off:
    their config fields, spec trees and smoke forwards are the reference's."""
    rc = dataclasses.replace(RC.get_config(arch, smoke=True), dtype="float32")
    tc = dataclasses.replace(TC.get_config(arch, smoke=True), dtype="float32")
    assert type(tc) is TB.ModelConfig
    assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
    is_spec = lambda x: isinstance(x, RB.ParamSpec)  # noqa: E731
    want = jax.tree.leaves(RB.model_spec_tree(rc), is_leaf=is_spec)
    assert [dataclasses.astuple(s) for s in TB.leaves(TB.model_spec_tree(tc))] == [
        dataclasses.astuple(s) for s in want]
    tree = RB.materialize(RB.model_spec_tree(rc), jax.random.key(0), jnp.float32)
    tree = jax.tree.map(np.array, tree)
    toks = np.random.default_rng(0).integers(0, rc.vocab_size, (2, 12)).astype(np.int32)
    n_enc = rc.encoder_seq or rc.cross_seq
    enc = (0.1 * np.random.default_rng(2).standard_normal((2, n_enc, rc.d_model))).astype(
        np.float32) if n_enc else None
    ref, _ = RT.model_forward(jax.tree.map(jnp.asarray, tree), rc, jnp.asarray(toks),
                              enc_input=None if enc is None else jnp.asarray(enc))
    got, _ = TT.model_forward(TT.params_from_numpy(tree, tc, "cpu"), tc, torch.from_numpy(toks),
                              enc_input=None if enc is None else torch.from_numpy(enc))
    assert rel_err(got, torch.from_numpy(np.array(ref))) <= TOL


def test_port_only_archs_live_beside_the_reference_registry():
    from repro_torch.launch import dryrun

    assert not set(TC.PORT_ARCHS) & set(RC.ARCHS)
    assert "trinity-mini" in TC.PORT_ARCHS and "trinity-mini" not in TC.ARCHS
    cfg = TC.get_config("trinity-mini")
    assert isinstance(cfg, TB.PortModelConfig)
    assert cfg.param_count() == 26_123_974_400
    assert [cfg.is_moe_layer(i) for i in range(4)] == [False, False, True, True]
    assert cfg.layer_kinds().count("local") == 24 and cfg.layer_kinds()[3] == "global"
    assert TC.get_config("trinity-mini", smoke=True).num_layers == 6
    assert "trinity-mini" not in {a for a, _, _ in dryrun.iter_cells()}
    with pytest.raises(SystemExit, match="no expert-parallel form"):
        dryrun.main(["--arch", "trinity-mini"])


def test_serve_launcher_takes_the_port_only_arch(capsys):
    t0 = time.perf_counter()
    serve.main(["--arch", "trinity-mini", "--requests", "2", "--batch", "2", "--max-new", "4"],
               device="cpu")
    assert "served 2 requests / 8 tokens" in capsys.readouterr().out
    assert time.perf_counter() - t0 < 60
