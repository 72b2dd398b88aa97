"""The zoo's new mixers on the port against ``repro.zoo``, module by module,
at smoke widths on the CPU: MoE routing and dispatch, RWKV6 time-mix (scan
and chunked) and channel-mix, RG-LRU (conv, scan, decode step, block),
cross-attention, and both routes of the flash path at other positions.

Inputs are numpy-seeded; layer weights are the smoke configs' params with
every ``zeros``/``ones`` leaf perturbed (``torch_zoo_common``), so token
shift, the bonus term and the RG-LRU conv are not zero.  Tolerance: f32
within 1e-5 of max(1, max|ref|); MoE routes identical and their weights
within 1e-6.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_zoo_common import (  # noqa: E402
    MIX_TOL, as_np, cfgs, close, stacked_tree, two_threads)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.zoo.models.attention as RA  # noqa: E402
import repro_torch.zoo.models.attention as TA  # noqa: E402
from repro.zoo.models import moe as RM  # noqa: E402
from repro.zoo.models import rglru as RG  # noqa: E402
from repro.zoo.models import rwkv6 as RW  # noqa: E402
from repro_torch.kernels import flash_attention as TF  # noqa: E402
from repro_torch.zoo.models import moe as TM  # noqa: E402
from repro_torch.zoo.models import rglru as TG  # noqa: E402
from repro_torch.zoo.models import rwkv6 as TW  # noqa: E402

_ = two_threads  # the module-scoped fixture


def _layer(arch, i, key):
    """Layer ``i``'s ``key`` params of the arch's smoke draw as (jnp, torch)
    trees, f32."""
    rc, _ = cfgs(arch)
    tree = stacked_tree(arch)
    period = rc.pattern_period
    n_body = 0 if tree["blocks"] is None else period * (rc.num_layers // period)
    lp = (jax.tree.map(lambda a: a[i // period], tree["blocks"][i % period])
          if i < n_body else tree["tail"][i - n_body])[key]
    return jax.tree.map(jnp.asarray, lp), jax.tree.map(torch.from_numpy, lp)


def _x(shape, seed, scale=1.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
MOE_LAYER = {"qwen3-moe-235b-a22b": 0, "llama4-maverick-400b-a17b": 1}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_and_route(arch):
    rc, tc = cfgs(arch)
    for t in (1, 2, 7, 64, 1000):
        for cf in (0.25, 1.25, 4.0):
            assert TM.capacity(t, dataclasses.replace(tc, capacity_factor=cf)) == RM.capacity(
                t, dataclasses.replace(rc, capacity_factor=cf))
    rp, tp = _layer(arch, MOE_LAYER[arch], "moe")
    xj, xt = _x((96, rc.d_model), 11)
    ri, rw = RM.route(xj, rp["router"], rc)
    ti, tw = TM.route(xt, tp["router"], tc)
    assert ti.dtype == torch.int32 and tuple(ti.shape) == (96, rc.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cf", [4.0, 0.5])  # 0.5 overflows: tokens dropped
@pytest.mark.parametrize("arch,act", [("qwen3-moe-235b-a22b", "swiglu"),
                                      ("qwen3-moe-235b-a22b", "gelu"),
                                      ("llama4-maverick-400b-a17b", "swiglu")])
def test_moe_ffn(arch, act, cf):
    rc, tc = cfgs(arch, capacity_factor=cf, act=act)
    rp, tp = _layer(arch, MOE_LAYER[arch], "moe")
    if act == "gelu":  # the gelu form has no gate
        rp, tp = ({k: v for k, v in p.items() if k != "w_gate"} for p in (rp, tp))
    xj, xt = _x((2, 24, rc.d_model), 12)
    want = RM.moe_ffn(xj, rp, rc)
    got = TM.moe_ffn(xt, tp, tc)
    close(got, want, MIX_TOL)
    # with cf 0.5 some (token, expert) pairs overflow and contribute nothing
    ti, _ = TM.route(xt.reshape(-1, rc.d_model), tp["router"], tc)
    counts = torch.bincount(ti.reshape(-1).long(), minlength=rc.num_experts)
    assert bool((counts > TM.capacity(48, tc)).any()) == (cf < 1)
    close(TM.moe_apply(xt, tp, tc), want, MIX_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_load_balance_loss(arch):
    rc, tc = cfgs(arch)
    rp, tp = _layer(arch, MOE_LAYER[arch], "moe")
    xj, xt = _x((40, rc.d_model), 13)
    want = float(RM.aux_load_balance_loss(xj, rp["router"], rc))
    got = float(TM.aux_load_balance_loss(xt, tp["router"], tc))
    assert abs(got - want) <= MIX_TOL * max(1.0, abs(want))


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _rwkv_state(rc, seed):
    """A carried state: f32 ``s``, bf16 token-shift carry (init_state's dtypes)."""
    nh = rc.mixer_heads_
    hs = rc.d_model // nh
    rng = np.random.default_rng(seed)
    s = (0.5 * rng.standard_normal((2, nh, hs, hs))).astype(np.float32)
    xp = rng.standard_normal((2, rc.d_model)).astype(np.float32)
    ref = {"s": jnp.asarray(s), "x_prev": jnp.asarray(xp, jnp.bfloat16)}
    port = {"s": torch.from_numpy(s), "x_prev": torch.from_numpy(xp).to(torch.bfloat16)}
    return ref, port


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("length", [16, 37, 64])
@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_time_mix(form, length, state):
    rc, tc = cfgs("rwkv6-3b")
    rp, tp = _layer("rwkv6-3b", 0, "rwkv")
    xj, xt = _x((2, length, rc.d_model), 14)
    rs, ts = _rwkv_state(rc, 15) if state else (None, None)
    want, wst = getattr(RW, f"time_mix_{form}")(xj, rp, rc, rs)
    got, gst = getattr(TW, f"time_mix_{form}")(xt, tp, tc, ts)
    close(got, want, MIX_TOL)
    close(gst["s"], wst["s"], MIX_TOL)
    np.testing.assert_array_equal(as_np(gst["x_prev"]), np.asarray(wst["x_prev"]))
    # the two forms agree with each other on the port
    other, ost = getattr(TW, "time_mix_scan" if form == "chunked" else "time_mix_chunked")(
        xt, tp, tc, ts)
    close(other, got, MIX_TOL)
    close(ost["s"], gst["s"], MIX_TOL)


def test_init_state_dtypes():
    rc, tc = cfgs("rwkv6-3b")
    want, got = RW.init_state(rc, 3), TW.init_state(tc, 3)
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert tuple(got[k].shape) == want[k].shape
    rc, tc = cfgs("recurrentgemma-9b")
    want, got = RG.init_state(rc, 3), TG.init_state(tc, 3)
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert tuple(got[k].shape) == want[k].shape


@pytest.mark.parametrize("prev", [False, True])
def test_channel_mix(prev):
    rc, _ = cfgs("rwkv6-3b")
    rp, tp = _layer("rwkv6-3b", 1, "ffn")
    xj, xt = _x((2, 9, rc.d_model), 16)
    pj, pt = _x((2, rc.d_model), 17) if prev else (None, None)
    want, wc = RW.channel_mix(xj, rp, None if pj is None else pj.astype(jnp.bfloat16))
    got, gc = TW.channel_mix(xt, tp, None if pt is None else pt.to(torch.bfloat16))
    close(got, want, MIX_TOL)
    np.testing.assert_array_equal(as_np(gc), np.asarray(wc))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carry", [False, True])
def test_conv1d(carry):
    rc, _ = cfgs("recurrentgemma-9b")
    rp, tp = _layer("recurrentgemma-9b", 0, "rglru")
    xj, xt = _x((2, 11, rc.d_rnn_), 18)
    cj, ct = _x((2, rc.conv_width - 1, rc.d_rnn_), 19) if carry else (None, None)
    want, wc = RG._conv1d(xj, rp["conv_w"], rp["conv_b"], cj)
    got, gc = TG._conv1d(xt, tp["conv_w"], tp["conv_b"], ct)
    close(got, want, MIX_TOL)
    np.testing.assert_array_equal(as_np(gc), np.asarray(wc))


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("length", [1, 13, 64])
def test_rg_lru(length, h0):
    rc, _ = cfgs("recurrentgemma-9b")
    rp, tp = _layer("recurrentgemma-9b", 0, "rglru")
    xj, xt = _x((2, length, rc.d_rnn_), 20)
    hj, ht = _x((2, rc.d_rnn_), 21) if h0 else (None, None)
    want, wfin = RG.rg_lru(xj, rp, hj)
    got, gfin = TG.rg_lru(xt, tp, ht)
    close(got, want, MIX_TOL)
    close(gfin, wfin, MIX_TOL)
    # the doubling scan against the sequential recurrence on the port
    a, gx = TG._gates(xt, tp)
    h = torch.zeros_like(a[:, 0]) if ht is None else ht
    for t in range(length):
        h = a[:, t] * h + gx[:, t]
        close(got[:, t], h, MIX_TOL)


def test_rg_lru_step():
    rc, _ = cfgs("recurrentgemma-9b")
    rp, tp = _layer("recurrentgemma-9b", 1, "rglru")
    xj, xt = _x((2, 1, rc.d_rnn_), 22)
    hj, ht = _x((2, rc.d_rnn_), 23)
    want, wh = RG.rg_lru_step(xj, rp, hj)
    got, gh = TG.rg_lru_step(xt, tp, ht)
    close(got, want, MIX_TOL)
    close(gh, wh, MIX_TOL)


def test_rglru_block_prefill_then_decode():
    """The block over a prompt (no state), then three decode tokens carrying
    the state (h in f32, the conv carry in the activations' dtype)."""
    rc, tc = cfgs("recurrentgemma-9b")
    rp, tp = _layer("recurrentgemma-9b", 0, "rglru")
    xj, xt = _x((2, 10, rc.d_model), 24)
    want, ws = RG.rglru_block(xj, rp, rc)
    got, gs = TG.rglru_block(xt, tp, tc)
    close(got, want, MIX_TOL)
    for step in range(3):
        xj, xt = _x((2, 1, rc.d_model), 25 + step)
        want, ws = RG.rglru_block(xj, rp, rc, ws, decode=True)
        got, gs = TG.rglru_block(xt, tp, tc, gs, decode=True)
        close(got, want, MIX_TOL)
        close(gs["h"], ws["h"], MIX_TOL)
        close(gs["conv"], ws["conv"], MIX_TOL)
    # decode with no state starts from h = 0
    want, _ = RG.rglru_block(xj, rp, rc, None, decode=True)
    got, _ = TG.rglru_block(xt, tp, tc, None, decode=True)
    close(got, want, MIX_TOL)


# ---------------------------------------------------------------------------
# cross-attention and the flash path at other positions
# ---------------------------------------------------------------------------

CROSS = {"whisper-base": 0, "llama-3.2-vision-11b": 4}


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", sorted(CROSS))
def test_cross_attention(arch, flash, monkeypatch):
    """``encode_cross_kv`` then ``cross_attention``; with FLASH_THRESHOLD
    lowered on both sides the port takes K8 (bidirectional, no window: the
    positions do not enter the mask) against the reference's lax schedule."""
    if flash:
        monkeypatch.setattr(RA, "FLASH_THRESHOLD", 1)
        monkeypatch.setattr(TA, "FLASH_THRESHOLD", 1)
    rc, tc = cfgs(arch)
    rp, tp = _layer(arch, CROSS[arch], "cross")
    n = rc.encoder_seq or rc.cross_seq
    ej, et = _x((2, n, rc.d_model), 30, 0.5)
    xj, xt = _x((2, 7, rc.d_model), 31)
    wk, wv = RA.encode_cross_kv(ej, rp, rc)
    gk, gv = TA.encode_cross_kv(et, tp, tc)
    close(gk, wk, MIX_TOL)
    close(gv, wv, MIX_TOL)
    calls = []
    plain = TF.flash_plain
    monkeypatch.setattr(TF, "flash_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    blocks = TA._sdpa_blocks.calls
    want = RA.cross_attention(xj, (wk, wv), rp, rc)
    got = TA.cross_attention(xt, (gk, gv), tp, tc)
    close(got, want, MIX_TOL)
    assert len(calls) == int(flash) and TA._sdpa_blocks.calls == blocks
    with pytest.raises(ValueError, match="encoder input"):
        TA.encode_cross_kv(None, tp, tc)


@pytest.mark.parametrize("arch,kind", [("llama-3.2-vision-11b", "global"),
                                       ("recurrentgemma-9b", "local")])
def test_decode_against_cache_takes_block_schedule(arch, kind, monkeypatch):
    """A decode token against more than FLASH_THRESHOLD cache slots (the
    threshold lowered on both sides): queries and keys at other positions,
    causal (and windowed over a ring for ``local``), so the port runs the
    block schedule, in 1024-query/-key blocks patched down to 8, against the
    reference's lax schedule; K8 does not launch."""
    for mod in (RA, TA):
        monkeypatch.setattr(mod, "Q_CHUNK", 8)
        monkeypatch.setattr(mod, "KV_CHUNK", 8)
    rc, tc = cfgs(arch)
    rp, tp = _layer(arch, {"recurrentgemma-9b": 2, "llama-3.2-vision-11b": 0}[arch], "attn")
    window = rc.sliding_window if kind == "local" else 0
    xj, xt = _x((2, 21, rc.d_model), 32)
    rcache = RA.init_cache(rc, 2, 40, window=window, dtype=jnp.float32)
    tcache = TA.init_cache(tc, 2, 40, window=window, dtype=torch.float32)
    _, rcache = RA.attention(xj, rp, rc, window=window, cache=rcache)
    _, tcache = TA.attention(xt, tp, tc, window=window, cache=tcache)
    monkeypatch.setattr(RA, "FLASH_THRESHOLD", 1)
    monkeypatch.setattr(TA, "FLASH_THRESHOLD", 1)
    calls = []
    plain = TF.flash_plain
    monkeypatch.setattr(TF, "flash_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    blocks = TA._sdpa_blocks.calls
    for step in range(3):
        xj, xt = _x((2, 1, rc.d_model), 33 + step)
        want, rcache = RA.attention(xj, rp, rc, window=window, cache=rcache)
        got, tcache = TA.attention(xt, tp, tc, window=window, cache=tcache)
        close(got, want, MIX_TOL)
    assert TA._sdpa_blocks.calls == blocks + 3 and not calls


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0), (False, 6)])
def test_block_schedule_matches_reference(causal, window, monkeypatch):
    """``_sdpa_blocks`` alone against the reference's ``_sdpa_flash`` with
    explicit positions (an offset query block against ragged padded keys,
    GQA, softcap), f32 and bf16."""
    for mod in (RA, TA):
        monkeypatch.setattr(mod, "Q_CHUNK", 8)
        monkeypatch.setattr(mod, "KV_CHUNK", 8)
    rc, tc = cfgs("llama-3.2-vision-11b", attn_softcap=30.0)
    rng = np.random.default_rng(40)
    q = rng.standard_normal((2, 13, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 29, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 29, 2, 16)).astype(np.float32)
    q_pos = np.arange(16, 29, dtype=np.int32)
    k_pos = np.arange(29, dtype=np.int32)
    k_pos[[3, 7]] = RA.PAD_POS  # slots never written
    for dt in ("float32", "bfloat16"):
        args = [jnp.asarray(a, dt) for a in (q, k, v)]
        want = RA._sdpa_flash(*args, jnp.asarray(q_pos), jnp.asarray(k_pos), rc, 0.25,
                              causal=causal, window=window)
        targs = [torch.from_numpy(a).to(getattr(torch, dt)) for a in (q, k, v)]
        got = TA._sdpa_blocks(*targs, torch.from_numpy(q_pos), torch.from_numpy(k_pos), tc,
                              0.25, causal=causal, window=window)
        assert got.dtype == getattr(torch, dt)
        # bf16: both round scores and the PV product to bf16 at the same
        # points; the sums inside those products differ in order
        close(got, want, MIX_TOL if dt == "float32" else 2**-7)
