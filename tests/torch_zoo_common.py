"""Shared helpers of the zoo port's family tests (``test_torch_zoo_archs.py``,
``test_torch_zoo_mixers.py``): configs on both packages, params with every
``zeros``/``ones`` leaf perturbed, numpy-seeded inputs, tolerances.

The reference inits RG-LRU's conv and RWKV's ``mu``, ``u`` and ``w0`` to
zeros (and norms to ones): at init the conv output is 0, so the RG-LRU block
returns exactly 0, and token shift and the bonus term vanish.  Every
``zeros``/``ones`` leaf therefore gets seeded noise of scale 0.1 before
either package sees the params.  Test modules import this after
``pytest.importorskip("torch")``."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

import torch  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.zoo import configs as RC  # noqa: E402
from repro.zoo.configs import base as RB  # noqa: E402
from repro_torch.zoo import configs as TC  # noqa: E402
from repro_torch.zoo.models import transformer as TT  # noqa: E402

NEW_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "rwkv6-3b",
             "recurrentgemma-9b", "whisper-base", "llama-3.2-vision-11b")
CROSS_ARCHS = ("whisper-base", "llama-3.2-vision-11b")
F32_TOL = 1e-4  # of max(1, max|ref logits|)
MIX_TOL = 1e-5  # of max(1, max|ref|), one module in f32
NOISE = 0.1


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Smoke-size ops gain nothing from more intra-op threads; two leave the
    cores to the test workers running beside the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(RC.get_config(arch, smoke=True), dtype=dtype, **kw),
            dataclasses.replace(TC.get_config(arch, smoke=True), dtype=dtype, **kw))


def perturb(spec, tree, seed: int):
    """``tree`` (arrays shaped as ``spec``'s leaves) as numpy, with seeded
    N(0, NOISE^2) noise added to every ``zeros``/``ones`` leaf."""
    rng = np.random.default_rng(seed)

    def one(s, a):
        a = np.array(a, np.float32)
        if s.init != "normal":
            a += (NOISE * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree.map(one, spec, tree, is_leaf=lambda x: isinstance(x, RB.ParamSpec))


def ref_params(rc, seed=0, stacked=True):
    """The reference's materialised params (stacked for its scan, or per
    depth), perturbed, as a numpy tree."""
    spec = RB.model_spec_tree(rc) if stacked else RB.param_tree(rc)
    return perturb(spec, RB.materialize(spec, jax.random.key(seed), jnp.float32), seed + 100)


@functools.lru_cache(maxsize=None)
def stacked_tree(arch, seed=0):
    """:func:`ref_params` of the arch's smoke config, stacked (the draw does
    not depend on the model's dtype); cached, as the tests only read it."""
    return ref_params(cfgs(arch)[0], seed)


@functools.lru_cache(maxsize=None)
def params(arch, dtype="float32", seed=0):
    """(ref cfg, port cfg, ref params as jnp, port params) from one draw;
    cached, as the tests only read them."""
    rc, tc = cfgs(arch, dtype)
    tree = stacked_tree(arch, seed)
    return rc, tc, jax.tree.map(jnp.asarray, tree), TT.params_from_numpy(tree, tc, "cpu")


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def enc_input(cfg, batch, seed=2):
    """Stub frontend output (B, encoder_seq or cross_seq, d) for the
    cross-attention archs, else None."""
    n = cfg.encoder_seq or cfg.cross_seq
    if not n:
        return None
    return (0.1 * np.random.default_rng(seed).standard_normal((batch, n, cfg.d_model))
            ).astype(np.float32)


def as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def rel(a, b):
    return float(np.linalg.norm(as_np(a) - as_np(b)) / np.linalg.norm(as_np(b)))


def close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    err, lim = np.abs(got - want).max(), tol * max(1.0, np.abs(want).max())
    assert err <= lim, (err, lim)


def jt(x):
    """numpy -> (jnp, torch) pair, or (None, None)."""
    return (None, None) if x is None else (jnp.asarray(x), torch.from_numpy(x))
