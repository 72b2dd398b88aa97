"""K8's plain version against the reference's Pallas flash-attention kernel.

The port's ``flash_attention`` runs its plain version on CPU tensors; the
reference's runs its Pallas kernel with ``interpret=True``.  The same
numpy-seeded inputs go through both, over the cases of
``tests/test_kernels_flash.py``.

Tolerances: f32 within rtol = atol = 2e-5 (the reference's own kernel-vs-
oracle tolerance; the port walks the keys 64 at a time, the reference
``kv_block`` at a time, so the running maxima and the sums differ in order).
bf16, against the reference's kernel in bf16: both round p to bf16 and the
output to bf16, p against the running max of the tiles seen so far, so with
other tile widths an output may move by a few bf16 ulps: within 2^-6 of
max(1, max|ref|).  At the kernel's own tile width (``kv_block=64``) the two
round at the same points and only f32 summation order differs: within one
bf16 ulp of the output, 2^-8 of max(1, max|ref|).  The same holds for
``flash_plain(kv_tile=128)``, the tile of the bf16 wgmma body at hd 64 and
128, against the Pallas kernel at ``kv_block=128``.  The kernel itself is
held against this plain version on the card in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as RF  # noqa: E402
from repro_torch.kernels import flash_attention as TF  # noqa: E402

F32_TOL = 2e-5


def _mk(bh, s, t, hd, seed=0, bh_kv=None):
    rng = np.random.default_rng(seed)
    bh_kv = bh_kv or bh
    return (rng.standard_normal((bh, s, hd)).astype(np.float32),
            rng.standard_normal((bh_kv, t, hd)).astype(np.float32),
            rng.standard_normal((bh_kv, t, hd)).astype(np.float32))


def _both(arrs, bf16=False, **kw):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    ref = RF.flash_attention(*(jnp.asarray(a, jdt) for a in arrs), interpret=True, **kw)
    got = TF.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrs), **kw)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    return got.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("s,t,qb,kb", [
    (256, 256, 128, 128),
    (300, 300, 128, 128),   # padding path
    (128, 512, 64, 128),    # cross-length (q short)
])
@pytest.mark.parametrize("window", [0, 100])
def test_flash_causal_matches_reference(s, t, qb, kb, window):
    got, want = _both(_mk(4, s, t, 64), causal=True, window=window, q_block=qb, kv_block=kb)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_flash_bidirectional_matches_reference():
    got, want = _both(_mk(2, 256, 256, 64), causal=False, q_block=128, kv_block=128)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_flash_softcap_matches_reference():
    got, want = _both(_mk(2, 128, 128, 32, seed=3), softcap=20.0, q_block=64, kv_block=64)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("kv_block,tol", [(128, 2**-6), (64, 2**-8)])
def test_flash_bf16_matches_reference(kv_block, tol):
    got, want = _both(_mk(2, 256, 256, 64, seed=5), bf16=True, q_block=128, kv_block=kv_block)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def test_flash_bidirectional_ragged_raises_as_reference():
    q, k, v = _mk(2, 64, 100, 64)
    with pytest.raises(ValueError, match="T % kv_block"):
        RF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                           kv_block=64)
    with pytest.raises(ValueError, match="T % kv_block"):
        TF.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           causal=False, kv_block=64)


def test_flash_gqa_kv_rows_equal_broadcast():
    """k/v passed once per KV head give the broadcast k/v's result; the CPU
    path launches nothing."""
    q, k, v = (torch.from_numpy(a) for a in _mk(8, 96, 96, 64, seed=2, bh_kv=2))
    before = TF.flash_attention.launches
    got = TF.flash_attention(q, k, v, window=40, softcap=30.0)
    want = TF.flash_attention(q, k.repeat_interleave(4, 0), v.repeat_interleave(4, 0),
                              window=40, softcap=30.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert TF.flash_attention.launches == before
    with pytest.raises(ValueError, match="KV rows"):
        TF.flash_attention(q, torch.cat([k, k[:1]]), torch.cat([v, v[:1]]))


@pytest.mark.parametrize("hd,causal,window", [(64, True, 0), (128, True, 100), (64, False, 0)])
def test_flash_plain_tile_128_matches_reference_bf16(hd, causal, window):
    """The wgmma body's 128-key tile: flash_plain walking 128 keys at a time
    rounds p against the same running maxima as the Pallas kernel at
    ``kv_block=128``, so only f32 summation order differs."""
    arrs = _mk(2, 256, 256, hd, seed=7)
    ref = RF.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrs), causal=causal,
                             window=window, q_block=128, kv_block=128, interpret=True)
    want = np.asarray(ref, np.float32)
    got = TF.flash_plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrs), causal=causal,
                         window=window, kv_tile=128).float().numpy()
    assert np.abs(got - want).max() <= 2**-8 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("hd", TF.HEAD_DIMS)
def test_key_tile_follows_the_body(hd):
    """f32 takes the mma_sync body's 64-key tile at every head dim; bf16 the
    wgmma body's, 128 keys (64 at hd = 256, where O alone fills 128
    registers a thread)."""
    assert TF.BODIES[(torch.float32, hd)] == "mma_sync"
    assert TF.key_tile(torch.float32, hd) == 64
    assert TF.BODIES[(torch.bfloat16, hd)] == "wgmma"
    assert TF.key_tile(torch.bfloat16, hd) == (64 if hd == 256 else 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_walks_the_body_tile(dtype):
    """On the CPU the wrapper is flash_plain at key_tile(dtype, hd), and the
    tile changes the bf16 result (so the default is not a no-op)."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _mk(2, 200, 200, 128, seed=9))
    got = TF.flash_attention(q, k, v, window=150)
    want = TF.flash_plain(q, k, v, window=150, kv_tile=TF.key_tile(dtype, 128))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if dtype == torch.bfloat16:
        assert not torch.equal(got, TF.flash_plain(q, k, v, window=150, kv_tile=64))
