"""The zoo's remaining families on the port (MoE, RWKV6, RG-LRU,
encoder-decoder, cross-attention) against ``repro.zoo``, arch by arch, at
smoke size on the CPU.

The same params (the reference's ``materialize`` output with every
``zeros``/``ones`` leaf perturbed, bridged through numpy) and numpy-seeded
tokens and stub encoder inputs go through both packages.  Tolerances:
  * f32: logits within 1e-4 of max(1, max|ref|) (sums in other orders over
    a few layers); greedy tokens identical; decode after prefill within the
    same bound, with f32 caches on both sides (the recurrent states keep
    their own dtypes: f32 ``s``/``h``, bf16 carries);
  * bf16: the port's logits within twice the reference's own bf16-vs-f32
    relative L2 of the reference's bf16 logits (each bf16 run is about that
    far from the f32 answer);
  * decode against the full forward: the reference's own ``test_archs.py``
    bound (rtol 5e-3, atol 5e-3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_zoo_common import (  # noqa: E402
    CROSS_ARCHS, F32_TOL, NEW_ARCHS, as_np, cfgs, close, enc_input, jt, params, perturb,
    rel, stacked_tree, tokens, two_threads)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as RS  # noqa: E402
from repro.zoo import configs as RC  # noqa: E402
from repro.zoo.configs import base as RB  # noqa: E402
from repro.zoo.models import transformer as RT  # noqa: E402
from repro.zoo.serving import decode as RD  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.zoo import configs as TC  # noqa: E402
from repro_torch.zoo.configs import base as TB  # noqa: E402
from repro_torch.zoo.models import transformer as TT  # noqa: E402
from repro_torch.zoo.serving import decode as TD  # noqa: E402

_ = two_threads  # the module-scoped fixture


# ---------------------------------------------------------------------------
# configs, specs, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_fields_and_param_counts(arch, smoke):
    rc, tc = RC.get_config(arch, smoke), TC.get_config(arch, smoke)
    assert dataclasses.asdict(rc) == dataclasses.asdict(tc)
    assert tc.param_count() == rc.param_count()
    assert tc.active_param_count() == rc.active_param_count()
    assert tc.layer_kinds() == rc.layer_kinds()
    assert tc.pattern_period == rc.pattern_period
    assert [tc.is_moe_layer(i) for i in range(tc.num_layers)] == [
        rc.is_moe_layer(i) for i in range(rc.num_layers)]
    assert (tc.padded_vocab, tc.head_dim_, tc.padded_heads, tc.d_rnn_, tc.mixer_heads_) == (
        rc.padded_vocab, rc.head_dim_, rc.padded_heads, rc.d_rnn_, rc.mixer_heads_)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_spec_trees_equal(arch):
    rc, tc = RC.get_config(arch, smoke=True), TC.get_config(arch, smoke=True)
    is_spec = lambda x: isinstance(x, RB.ParamSpec)  # noqa: E731
    for rmk, tmk in ((RB.param_tree, TB.param_tree), (RB.model_spec_tree, TB.model_spec_tree)):
        want = jax.tree.leaves(rmk(rc), is_leaf=is_spec)
        got = TB.leaves(tmk(tc))
        assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
    if rc.encoder_layers:
        assert len(TB.param_tree(tc)["encoder"]["layers"]) == rc.encoder_layers


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_bridge_stacked_and_per_depth(arch):
    """The stacked layout (``blocks`` + ``tail``) and the per-depth one
    (the same draw unstacked) give the same per-layer weights: the
    reference's leaves of each depth, nested ``mu`` and ``(E, d, f)``
    expert leaves included, and the encoder."""
    rc, tc = cfgs(arch)
    stacked = stacked_tree(arch)
    period = rc.pattern_period
    n_body = 0 if stacked["blocks"] is None else period * (rc.num_layers // period)
    per_depth = {k: v for k, v in stacked.items() if k not in ("blocks", "tail")}
    per_depth["layers"] = [
        jax.tree.map(lambda a: a[i // period], stacked["blocks"][i % period])
        if i < n_body else stacked["tail"][i - n_body] for i in range(rc.num_layers)]
    assert len(per_depth["layers"][0]) == len(RB.param_tree(rc)["layers"][0])
    tp = TT.params_from_numpy(stacked, tc, "cpu")
    tq = TT.params_from_numpy(per_depth, tc, "cpu")
    assert len(tp["layers"]) == len(tq["layers"]) == rc.num_layers
    for i, ref in enumerate(per_depth["layers"]):
        _same_leaves(tp["layers"][i], ref)
        _same_leaves(tq["layers"][i], ref)
        if rc.is_moe_layer(i):
            assert tuple(tp["layers"][i]["moe"]["w_in"].shape) == (
                rc.num_experts, rc.d_model, rc.moe_d_ff or rc.d_ff)
    assert ("encoder" in tp) == ("encoder" in tq) == bool(rc.encoder_layers)
    if rc.encoder_layers:
        _same_leaves(tp["encoder"], stacked["encoder"])
        _same_leaves(tq["encoder"], stacked["encoder"])
    with pytest.raises(ValueError, match="layers"):
        TT.params_from_numpy(dict(per_depth, layers=per_depth["layers"][:-1]), tc, "cpu")
    # the port's own materialize: the same layout from its own generator
    mine = TT.params_from_numpy(
        TB.materialize(TB.model_spec_tree(tc), torch.Generator().manual_seed(0)), tc, "cpu")
    assert [tuple(p.shape) for p in mine.parameters()] == [tuple(p.shape) for p in tp.parameters()]


def _same_leaves(module, ref_tree):
    """The port's ``ParamDict`` holds exactly the reference tree's leaves,
    each by its path (``attn.wq``, ``rwkv.mu.w``, ``layers.0.ffn.w_in``)."""
    got = {name: as_np(p) for name, p in module.named_parameters()}
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(a)
            for path, a in flat}
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)


# ---------------------------------------------------------------------------
# forward, decode, generation, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_f32(arch):
    rc, tc, rp, tp = params(arch)
    toks = tokens(rc, (2, 20))
    ej, et = jt(enc_input(rc, 2))
    want, _ = RT.model_forward(rp, rc, jnp.asarray(toks), enc_input=ej)
    got, _ = TT.model_forward(tp, tc, torch.from_numpy(toks), enc_input=et)
    assert got.shape == (2, 20, tc.padded_vocab)
    close(got, want, F32_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_then_decode_f32(arch):
    """Prefill (20 tokens; rwkv takes its chunked form, chunks of 16 and a
    ragged tail) then 5 teacher-forced decode steps, the reference's greedy
    tokens fed to both: logits and the recurrent states equal."""
    rc, tc, rp, tp = params(arch)
    b, s, steps = 2, 20, 5
    prompt = tokens(rc, (b, s), seed=3)
    ej, et = jt(enc_input(rc, b, seed=4))
    rcache = RT.init_cache_tree(rc, b, s + steps, dtype=jnp.float32)
    tcache = TT.init_cache_tree(tc, b, s + steps, dtype=torch.float32)
    rl, rcache = RT.model_forward(rp, rc, jnp.asarray(prompt), enc_input=ej, cache=rcache)
    tl, tcache = TT.model_forward(tp, tc, torch.from_numpy(prompt), enc_input=et, cache=tcache)
    close(tl, rl, F32_TOL)
    r_dec = jax.jit(lambda p, t, c: RT.model_forward(p, rc, t, cache=c, decode=True))
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(rl[:, -1:], -1)).astype(np.int32)
        rl, rcache = r_dec(rp, jnp.asarray(tok), rcache)
        tl, tcache = TT.model_forward(tp, tc, torch.from_numpy(tok), cache=tcache, decode=True)
        close(tl, rl, F32_TOL)
    # the states after the last step, layer by layer (the reference stacks
    # them per super-block)
    period = rc.pattern_period
    n_body = 0 if rcache["blocks"] is None else period * (rc.num_layers // period)
    for i, entry in enumerate(tcache):
        ref = (jax.tree.map(lambda a: a[i // period], rcache["blocks"][i % period])
               if i < n_body else rcache["tail"][i - n_body])
        if "mix" in entry:
            close(entry["mix"]["s"], ref["mix"]["s"], F32_TOL)
            close(entry["ffn_prev"], ref["ffn_prev"], F32_TOL)
        if "rec" in entry:
            close(entry["rec"]["h"], ref["rec"]["h"], F32_TOL)
            close(entry["rec"]["conv"], ref["rec"]["conv"], F32_TOL)
        if "ck" in entry:
            close(entry["ck"], ref["ck"], F32_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_greedy_generate_f32(arch):
    rc, tc, rp, tp = params(arch)
    prompt = tokens(rc, (2, 12), seed=2)
    ej, et = jt(enc_input(rc, 2, seed=5))
    want = np.asarray(RD.greedy_generate(rp, rc, jnp.asarray(prompt), 6, enc_input=ej))
    got = TD.greedy_generate(tp, tc, torch.from_numpy(prompt), 6, enc_input=et).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference's ``test_archs.py`` check on the port: the last token
    decoded against a cache filled by the prompt's prefill gives the full
    forward's last row (rtol 5e-3, atol 5e-3); here on the port alone."""
    _, tc, _, tp = params(arch)
    b, s = 2, 16
    toks = torch.from_numpy(tokens(tc, (b, s), seed=6))
    _, enc = jt(enc_input(tc, b, seed=7))
    full, _ = TT.model_forward(tp, tc, toks, enc_input=enc)
    cache = TT.init_cache_tree(tc, b, s + 4, dtype=torch.float32)
    _, cache = TT.model_forward(tp, tc, toks[:, :s - 1], enc_input=enc, cache=cache)
    dec, _ = TT.model_forward(tp, tc, toks[:, s - 1:], cache=cache, decode=True)
    np.testing.assert_allclose(as_np(dec[:, -1]), as_np(full[:, -1]), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serving_steps_bf16(arch):
    """The serving steps in bf16 (bf16 weights, bf16 KV caches): prefill and
    teacher-forced decode logits, held to the reference's own bf16-vs-f32
    distance."""
    rc32, _, rp, _ = params(arch)
    rc, tc, _, tp = params(arch, "bfloat16")
    prompt = tokens(rc, (2, 12), seed=5)
    enc = enc_input(rc, 2, seed=8)  # the stub frontend's output in each model's dtype
    ej = None if enc is None else jnp.asarray(enc, jnp.bfloat16)
    et = None if enc is None else torch.from_numpy(enc).to(torch.bfloat16)
    ej32, _ = jt(enc)
    r_pre, t_pre = jax.jit(RD.make_prefill_step(rc, 20)), TD.make_prefill_step(tc, 20)
    r_srv, t_srv = jax.jit(RD.make_serve_step(rc)), TD.make_serve_step(tc)
    r32_pre, r32_srv = jax.jit(RD.make_prefill_step(rc32, 20)), jax.jit(RD.make_serve_step(rc32))
    rl, rcache = r_pre(rp, jnp.asarray(prompt), ej)
    tl, tcache = t_pre(tp, torch.from_numpy(prompt), et)
    r32l, r32cache = r32_pre(rp, jnp.asarray(prompt), ej32)
    assert tl.dtype == torch.bfloat16
    assert _rel_ok(tl, rl, r32l)
    tok = np.array(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    for _ in range(4):
        rn, rl, rcache = r_srv(rp, rcache, jnp.asarray(tok))
        _, tl, tcache = t_srv(tp, tcache, torch.from_numpy(tok))
        _, r32l, r32cache = r32_srv(rp, r32cache, jnp.asarray(tok))
        assert _rel_ok(tl, rl, r32l)
        tok = np.array(rn)


def _rel_ok(got, ref_bf16, ref_f32) -> bool:
    """relative L2 of the port's from the reference's bf16 logits within
    twice the reference's bf16-vs-f32; pad ids' logits (-inf on a serve
    step) left out."""
    a, b, c = as_np(got), as_np(ref_bf16), as_np(ref_f32)
    fin = np.isfinite(c)
    return rel(a[fin], b[fin]) <= 2 * rel(b[fin], c[fin])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_batch_server(arch):
    """Text archs: ``BatchServer`` tokens equal to the reference's.  The
    cross-attention archs: the reference's server passes no encoder input,
    so its prefill raises ``ValueError``; the port copies the failure."""
    rc, tc, rp, tp = params(arch)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, rc.vocab_size, n).astype(np.int32) for n in (9, 12, 7)]
    mk = lambda mod: [mod.Request(rid=i, prompt=p, max_new=3 + i)  # noqa: E731
                      for i, p in enumerate(prompts)]
    rserver = RS.BatchServer(rc, rp, batch=4, max_seq=12 + 5 + 1)
    tserver = TS.BatchServer(tc, tp, batch=4, max_seq=12 + 5 + 1, device="cpu")
    if arch in CROSS_ARCHS:
        with pytest.raises(ValueError):
            rserver.serve_batch(mk(RS))
        with pytest.raises(ValueError, match="encoder input"):
            tserver.serve_batch(mk(TS))
        return
    want = rserver.serve_batch(mk(RS))
    got = tserver.serve_batch(mk(TS))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.out, w.out)


@pytest.mark.parametrize("arch", [a for a in NEW_ARCHS if a not in CROSS_ARCHS])
def test_serve_main_on_cpu(arch, capsys):
    TS.main(["--arch", arch, "--requests", "3", "--batch", "2", "--max-new", "3",
             "--prompt-len", "5"], device="cpu")
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out


def test_perturbation_reaches_every_init_kind():
    """Every ``zeros``/``ones`` leaf moves off its init, normal leaves stay."""
    rc, _ = cfgs("recurrentgemma-9b")
    spec = RB.param_tree(rc)
    base = RB.materialize(spec, jax.random.key(0), jnp.float32)
    moved = perturb(spec, base, 1)
    pairs = zip(jax.tree.leaves(spec, is_leaf=lambda x: isinstance(x, RB.ParamSpec)),
                jax.tree.leaves(base), jax.tree.leaves(moved))
    for s, a, m in pairs:
        assert (np.asarray(a) != m).any() == (s.init != "normal"), s
