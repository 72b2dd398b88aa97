"""The zoo port (``repro_torch.zoo``, ``repro_torch.launch.serve``) against
the reference's ``repro.zoo`` at smoke size, on the CPU.

The same params (the reference's ``materialize`` output bridged through
numpy) and numpy-seeded tokens go through both.  Tolerances:
  * f32 (``dtype="float32"``): logits within 1e-4 of max(1, max|ref|)
    (sums in other orders over a few layers); greedy tokens identical.  The f32 decode checks use f32
    caches on both sides: the serving steps keep a bf16 cache, where a key
    that the two frameworks compute 1e-7 apart can round to neighbouring bf16
    values;
  * bf16: the port's logits lie within twice the reference's own bf16-vs-
    f32 distance (relative L2) of the reference's bf16 logits: each bf16 run
    is about that far from the f32 answer, so two of them are at most twice
    that apart.  The two round at different points by design: the
    frameworks' bf16 kernels round intermediates differently, and on the
    flash path the reference's ``lax`` schedule rounds scores to bf16 where
    K8, like the reference's Pallas kernel, keeps them in f32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.zoo.models.attention as RA  # noqa: E402
import repro_torch.zoo.models.attention as TA  # noqa: E402
from repro.launch import serve as RS  # noqa: E402
from repro.zoo import configs as RC  # noqa: E402
from repro.zoo.configs import base as RB  # noqa: E402
from repro.zoo.models import layers as RL  # noqa: E402
from repro.zoo.models import transformer as RT  # noqa: E402
from repro.zoo.serving import decode as RD  # noqa: E402
from repro_torch.kernels import flash_attention as TF  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.zoo import configs as TC  # noqa: E402
from repro_torch.zoo.configs import base as TB  # noqa: E402
from repro_torch.zoo.models import layers as TL  # noqa: E402
from repro_torch.zoo.models import transformer as TT  # noqa: E402
from repro_torch.zoo.serving import decode as TD  # noqa: E402

ARCHS = ("qwen3-8b", "qwen2-7b", "gemma2-9b", "deepseek-67b")
# qwen3: GQA + qk-norm; gemma2: local/global (window 8: ring caches),
# attention and final softcaps, tied embeddings
MODELS = ("qwen3-8b", "gemma2-9b")
F32_TOL = 1e-4  # of max(1, max|ref logits|)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Smoke-size ops gain nothing from more intra-op threads; two leave the
    cores to the test workers running beside this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype):
    return (dataclasses.replace(RC.get_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(TC.get_config(arch, smoke=True), dtype=dtype))


def _params(arch, dtype="float32", seed=0):
    rc, tc = _cfgs(arch, dtype)
    rp = RB.materialize(RB.model_spec_tree(rc), jax.random.key(seed), jnp.float32)
    tp = TT.params_from_numpy(jax.tree.map(np.array, rp), tc, "cpu")
    return rc, tc, rp, tp


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(a, b):
    return float(np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b)))


def _close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_param_count(arch, smoke):
    rc, tc = RC.get_config(arch, smoke), TC.get_config(arch, smoke)
    assert dataclasses.asdict(rc) == dataclasses.asdict(tc)
    assert tc.param_count() == rc.param_count()
    assert tc.layer_kinds() == rc.layer_kinds()
    assert tc.pattern_period == rc.pattern_period
    assert (tc.padded_vocab, tc.head_dim_, tc.padded_heads) == (
        rc.padded_vocab, rc.head_dim_, rc.padded_heads)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal(arch):
    rc, tc = RC.get_config(arch, smoke=True), TC.get_config(arch, smoke=True)
    want = jax.tree.leaves(RB.model_spec_tree(rc), is_leaf=lambda x: isinstance(x, RB.ParamSpec))
    got = TB.leaves(TB.model_spec_tree(tc))
    assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]


def test_registry_holds_every_lm_arch():
    """The port's registry holds the reference's ten LM architectures and
    groot-gnn, in the reference's order, and each LM builds its full-size
    and smoke param trees."""
    assert set(RC.LM_ARCHS) == set(TC.LM_ARCHS)
    assert list(TC.ARCHS) == list(RC.ARCHS)
    for arch in TC.LM_ARCHS:
        for smoke in (False, True):
            tree = TB.param_tree(TC.get_config(arch, smoke))
            assert len(tree["layers"]) == TC.get_config(arch, smoke).num_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MODELS)
def test_params_bridge(arch, dtype):
    rc, tc, rp, tp = _params(arch, dtype)
    period = rc.pattern_period
    assert len(tp["layers"]) == tc.num_layers
    for i, lp in enumerate(tp["layers"]):
        ref = jax.tree.map(lambda a: a[i // period], rp["blocks"][i % period])
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                _np(lp["attn"][name]), np.asarray(jnp.asarray(ref["attn"][name], dtype), np.float32))
        assert lp["ffn"]["w_in"].dtype == getattr(torch, dtype)
    assert ("lm_head" in tp) == (not tc.tie_embeddings)
    # the port's own materialize: same layout, its own generator
    tree = TB.materialize(TB.model_spec_tree(tc), torch.Generator().manual_seed(0))
    mine = TT.params_from_numpy(tree, tc, "cpu")
    assert [tuple(p.shape) for p in mine.parameters()] == [tuple(p.shape) for p in tp.parameters()]


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    gain = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        _np(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(gain))),
        _np(RL.rms_norm(jnp.asarray(x), jnp.asarray(gain))), rtol=1e-5, atol=1e-6)
    pos = np.arange(7, 12, dtype=np.int32)
    np.testing.assert_allclose(
        _np(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)),
        _np(RL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), rtol=1e-5, atol=1e-5)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("w_in", (16, 24)), ("w_gate", (16, 24)), ("w_out", (24, 16)))}
    h = x[:, :, 0]
    for act, keys in (("swiglu", p), ("gelu", {k: p[k] for k in ("w_in", "w_out")})):
        np.testing.assert_allclose(
            _np(TL.mlp(torch.from_numpy(h), {k: torch.from_numpy(v) for k, v in keys.items()}, act)),
            _np(RL.mlp(jnp.asarray(h), {k: jnp.asarray(v) for k, v in keys.items()}, act)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch,kind", [("qwen3-8b", "global"), ("gemma2-9b", "local"),
                                       ("gemma2-9b", "global")])
def test_attention_matches_reference(arch, kind, flash, monkeypatch):
    """Plain schedule, and the flash path (FLASH_THRESHOLD patched to 1 on
    both sides: the port's K8 wrapper against the reference's lax schedule),
    without a cache and as a prefill into one."""
    if flash:
        monkeypatch.setattr(RA, "FLASH_THRESHOLD", 1)
        monkeypatch.setattr(TA, "FLASH_THRESHOLD", 1)
    rc, tc, rp, tp = _params(arch)
    layer = 0 if kind == "local" or rc.pattern_period == 1 else 1
    rattn = jax.tree.map(lambda a: a[0], rp["blocks"][layer])["attn"]
    tattn = tp["layers"][layer]["attn"]
    window = rc.sliding_window if kind == "local" else 0
    x = np.random.default_rng(4).standard_normal((2, 24, rc.d_model)).astype(np.float32)
    calls = []
    plain = TF.flash_plain
    monkeypatch.setattr(TF, "flash_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    want, _ = RA.attention(jnp.asarray(x), rattn, rc, window=window)
    got, _ = TA.attention(torch.from_numpy(x), tattn, tc, window=window)
    _close(got, want, 1e-5)
    rcache = RA.init_cache(rc, 2, 30, window=window, dtype=jnp.float32)
    tcache = TA.init_cache(tc, 2, 30, window=window, dtype=torch.float32)
    want, rcache = RA.attention(jnp.asarray(x), rattn, rc, window=window, cache=rcache)
    got, tcache = TA.attention(torch.from_numpy(x), tattn, tc, window=window, cache=tcache)
    _close(got, want, 1e-5)
    _close(tcache.k, rcache.k, 1e-5)
    assert tcache.pos == int(rcache.pos) == 24
    # a second prefill chunk at offset 24 (queries and keys share positions)
    want, rcache = RA.attention(jnp.asarray(x[:, :4]), rattn, rc, window=window, cache=rcache)
    got, tcache = TA.attention(torch.from_numpy(x[:, :4]), tattn, tc, window=window, cache=tcache)
    _close(got, want, 1e-5)
    assert tcache.pos == int(rcache.pos) == 28
    assert len(calls) == (3 if flash else 0)  # the flash path went through K8's wrapper
    # one decode token against the cache: keys at other positions, so the
    # flash path takes the block schedule, not K8
    blocks = TA._sdpa_blocks.calls
    want, _ = RA.attention(jnp.asarray(x[:, :1]), rattn, rc, window=window, cache=rcache)
    got, _ = TA.attention(torch.from_numpy(x[:, :1]), tattn, tc, window=window, cache=tcache)
    _close(got, want, 1e-5)
    assert len(calls) == (3 if flash else 0)
    assert TA._sdpa_blocks.calls == blocks + int(flash)


# ---------------------------------------------------------------------------
# model_forward, greedy_generate, BatchServer
# ---------------------------------------------------------------------------

def _prefill_decode(rc, tc, rp, tp, prompt, steps, cache_dtype):
    """Prefill then ``steps`` teacher-forced decode steps on both sides (the
    reference's greedy tokens fed to both); returns the logits pairs."""
    b, s = prompt.shape
    rcache = RT.init_cache_tree(rc, b, s + steps, dtype=getattr(jnp, cache_dtype))
    tcache = TT.init_cache_tree(tc, b, s + steps, dtype=getattr(torch, cache_dtype))
    rl, rcache = RT.model_forward(rp, rc, jnp.asarray(prompt), cache=rcache)
    tl, tcache = TT.model_forward(tp, tc, torch.from_numpy(prompt), cache=tcache)
    pairs = [(tl, rl)]
    tok = np.asarray(jnp.argmax(rl[:, -1:], -1)).astype(np.int32)
    for _ in range(steps):
        rl, rcache = RT.model_forward(rp, rc, jnp.asarray(tok), cache=rcache, decode=True)
        tl, tcache = TT.model_forward(tp, tc, torch.from_numpy(tok), cache=tcache)
        pairs.append((tl, rl))
        tok = np.asarray(jnp.argmax(rl[:, -1:], -1)).astype(np.int32)
    return pairs


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", MODELS)
def test_model_forward_prefill_decode_f32(arch, flash, monkeypatch):
    rc, tc, rp, tp = _params(arch)
    prompt = _tokens(rc, (2, 12))
    if flash:  # prefill (12 x 12 scores) through flash, decode (1 x 18) plain
        monkeypatch.setattr(RA, "FLASH_THRESHOLD", 18)
        monkeypatch.setattr(TA, "FLASH_THRESHOLD", 18)
    for got, want in _prefill_decode(rc, tc, rp, tp, prompt, 6, "float32"):
        _close(got, want, F32_TOL)


@pytest.mark.parametrize("arch", MODELS)
def test_greedy_generate_f32(arch):
    rc, tc, rp, tp = _params(arch)
    prompt = _tokens(rc, (2, 12), seed=2)
    want = np.asarray(RD.greedy_generate(rp, rc, jnp.asarray(prompt), 8))
    got = TD.greedy_generate(tp, tc, torch.from_numpy(prompt), 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", MODELS)
def test_serving_steps_bf16(arch):
    """The serving steps in bf16 (bf16 weights and cache): prefill and
    teacher-forced decode logits, held to the reference's own bf16-vs-f32
    distance."""
    rc32, _, rp, _ = _params(arch)
    rc, tc, _, tp = _params(arch, "bfloat16")
    prompt = _tokens(rc, (2, 12), seed=5)
    r_pre, t_pre = RD.make_prefill_step(rc, 20), TD.make_prefill_step(tc, 20)
    r_srv, t_srv = RD.make_serve_step(rc), TD.make_serve_step(tc)
    r32_pre, r32_srv = RD.make_prefill_step(rc32, 20), RD.make_serve_step(rc32)
    rl, rcache = r_pre(rp, jnp.asarray(prompt))
    tl, tcache = t_pre(tp, torch.from_numpy(prompt))
    r32l, r32cache = r32_pre(rp, jnp.asarray(prompt))
    # gemma2's final softcap runs in f32, as the reference's
    assert tl.dtype == (torch.float32 if tc.final_softcap else torch.bfloat16)
    assert tcache[0]["kv"].k.dtype == torch.bfloat16
    assert _rel(tl, rl) <= 2 * _rel(rl, r32l)
    tok = np.array(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    for _ in range(4):
        rn, rl, rcache = r_srv(rp, rcache, jnp.asarray(tok))
        _, tl, tcache = t_srv(tp, tcache, torch.from_numpy(tok))
        _, r32l, r32cache = r32_srv(rp, r32cache, jnp.asarray(tok))
        assert _rel(tl, rl) <= 2 * _rel(rl, r32l)
        tok = np.array(rn)


def test_batch_server_matches_reference():
    rc, tc, rp, tp = _params("qwen3-8b")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, rc.vocab_size, n).astype(np.int32) for n in (9, 12, 7)]
    mk = lambda mod: [mod.Request(rid=i, prompt=p, max_new=4 + i) for i, p in enumerate(prompts)]
    want = RS.BatchServer(rc, rp, batch=4, max_seq=12 + 6 + 1).serve_batch(mk(RS))
    server = TS.BatchServer(tc, tp, batch=4, max_seq=12 + 6 + 1, device="cpu")
    got = server.serve_batch(mk(TS))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.out, w.out)
    with pytest.raises(ValueError, match="requests"):
        server.serve_batch(mk(TS) * 2)


def test_serve_main_on_cpu(capsys):
    TS.main(["--requests", "3", "--batch", "2", "--max-new", "3", "--prompt-len", "5"],
            device="cpu")
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out
