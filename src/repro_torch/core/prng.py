"""The reference's random draws, in numpy: threefry2x32 keys, ``split`` and
``uniform``, bit for bit as ``jax.random`` gives them under its defaults
(the ``threefry2x32`` implementation, ``jax_threefry_partitionable=True``,
32-bit mode).  The port's :func:`repro_torch.core.gnn.init_params` draws
its initial weights through these, so a seed gives the same params in both
packages.

A key is a ``(2,)`` uint32 array, as ``jax.random.key_data`` shows it.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """The threefry2x32 block cipher (20 rounds) of the counter words
    ``(x0, x1)`` under ``key``; returns the two uint32 output words."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32).copy()
    x1 = np.asarray(x1, np.uint32).copy()
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r)
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data.  In 32-bit mode the seed is cut to
    its low 32 bits, so the high word is 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _counters(n: int) -> tuple:
    """A 64-bit ``iota(n)`` cut into its high and low 32-bit words."""
    iota = np.arange(n, dtype=np.uint64)
    return (iota >> np.uint64(32)).astype(np.uint32), iota.astype(np.uint32)


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)``: ``(n, 2)`` uint32 keys."""
    b0, b1 = threefry2x32(k, *_counters(n))
    return np.stack([b0, b1], axis=1)


def uniform(k: np.ndarray, shape: tuple, lo: float, hi: float) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, lo, hi)``.  The reference's
    ``f * (hi - lo) + lo`` is one fused multiply-add on the CPU; the product
    and sum are exact in float64 (a 24-bit by 24-bit product plus a term of
    the same scale), so one rounding to float32 gives the same value."""
    shape = tuple(int(d) for d in shape)
    b0, b1 = threefry2x32(k, *_counters(int(np.prod(shape, dtype=np.int64))))
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = np.float64(hi32 - lo32)
    out = (f.astype(np.float64) * span + np.float64(lo32)).astype(np.float32)
    return np.maximum(lo32, out).reshape(shape)
