"""The zoo's training path on the port against ``repro.training``: the LM
loss and its gradients for every LM arch, the block schedule under grad, the
remat variants, one train step at one and two microbatches, and a bf16 step,
at smoke size on the CPU.

The same params (the reference's ``materialize`` output with every
``zeros``/``ones`` leaf perturbed, bridged through numpy) and numpy-seeded
tokens go through ``jax.value_and_grad(repro.training.train_step.lm_loss)``
and the port's ``lm_loss`` + ``backward()`` over its training form (f32
master leaves in the reference's stacked layout).  Gradients are compared in
that layout.  Tolerances: the loss within 1e-5 relative; the gradients'
relative L2 over all leaves within ``GRAD_L2`` (F32_TOL, 1e-4) and each leaf
within ``GRAD_TOL`` (5e-4) of max(1, max|ref|).  The per-leaf bound is not
F32_TOL because these random-weight models' gradients are ill-conditioned
in f32 where attention has no qk-norm: the reference's own gradients move
8.1e-5 of max(1, max|g|) between its eager and jitted runs (gemma2-9b) and
6.7e-5 between its plain and block schedules (whisper-base), and the port
sits 1-2x that from it.  llama4-maverick's smoke config pads 4 query heads
to 48 (``head_pad_to``) with the padding heads' weights drawn nonzero, and
the reference moves 4.24e-4 between its eager and jitted runs there: that
arch is held to 2e-3 a leaf and 1e-3 in L2.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_zoo_common import (  # noqa: E402
    F32_TOL, as_np, cfgs, close, enc_input, stacked_tree, tokens, two_threads)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.training import optimizer as RO  # noqa: E402
from repro.training import train_step as RTS  # noqa: E402
from repro.zoo import configs as RC  # noqa: E402
from repro.zoo.models import attention as RA  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402
from repro_torch.zoo.configs.base import leaves  # noqa: E402
from repro_torch.zoo.models import attention as TA  # noqa: E402
from repro_torch.zoo.models import transformer as TT  # noqa: E402

_ = two_threads  # the module-scoped fixture

LM_ARCHS = tuple(RC.LM_ARCHS)
#: (per leaf of max(1, max|ref|), relative L2 over all leaves): see the
#: module docstring
GRAD_TOL, GRAD_L2 = 5e-4, F32_TOL
LLAMA4 = "llama4-maverick-400b-a17b"
ARCH_GRAD_TOL = {LLAMA4: (2e-3, 1e-3)}
LOSS_RTOL = 1e-5
SEQ = 13  # tokens a row: 12 inputs and their labels


def _ref_loss_and_grads(rc, tree, tok, enc):
    fn = jax.jit(jax.value_and_grad(
        lambda p, t, e: RTS.lm_loss(p, rc, t, e, remat=False)))
    loss, grads = fn(jax.tree.map(jnp.asarray, tree), jnp.asarray(tok),
                     None if enc is None else jnp.asarray(enc))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_loss_and_grads(tc, tree, tok, enc, **kw):
    params = TT.params_from_numpy(tree, tc, "cpu", trainable=True)
    loss = TTS.lm_loss(params, tc, torch.from_numpy(tok),
                       None if enc is None else torch.from_numpy(enc), **kw)
    loss.backward()
    return loss.item(), [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in leaves(params)]


def _grads_close(got, want, tol=GRAD_TOL, l2=GRAD_L2):
    """Each leaf within ``tol`` of max(1, max|want|) and all leaves together
    within ``l2`` relative L2."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w, tol)
    g = np.concatenate([as_np(x).ravel() for x in got])
    w = np.concatenate([np.asarray(x, np.float32).ravel() for x in want])
    assert np.linalg.norm(g - w) <= l2 * np.linalg.norm(w), np.linalg.norm(g - w) / np.linalg.norm(w)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``lm_loss`` and its gradients (remat on, as the launcher trains)
    against ``jax.value_and_grad`` of the reference's, every leaf of the
    stacked tree, the encoder archs with their stub input."""
    rc, tc = cfgs(arch)
    tree = stacked_tree(arch)
    tok, enc = tokens(rc, (2, SEQ)), enc_input(rc, 2)
    want_loss, want = _ref_loss_and_grads(rc, tree, tok, enc)
    got_loss, got = _port_loss_and_grads(tc, tree, tok, enc, remat=True)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    _grads_close(got, want, *ARCH_GRAD_TOL.get(arch, (GRAD_TOL, GRAD_L2)))
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-9b", "whisper-base"])
def test_block_schedule_under_grad(arch, monkeypatch):
    """With FLASH_THRESHOLD, Q_CHUNK and KV_CHUNK patched small in both
    packages, every attention call (self, windowed, softcapped, the
    encoder's and cross-attention) takes the flash path in several blocks:
    the port's gradients match the reference's lax schedule's,
    ``_sdpa_blocks.grad_calls`` counts every attention call, and K8 is
    never called (patched to raise)."""
    for mod in (RA, TA):
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 16)
        monkeypatch.setattr(mod, "Q_CHUNK", 4)
        monkeypatch.setattr(mod, "KV_CHUNK", 4)

    def no_k8(*a, **k):
        raise AssertionError("K8 called under grad")

    monkeypatch.setattr(TA, "flash_attention", no_k8)
    rc, tc = cfgs(arch)
    tree = stacked_tree(arch)
    tok, enc = tokens(rc, (2, SEQ), seed=3), enc_input(rc, 2)
    want_loss, want = _ref_loss_and_grads(rc, tree, tok, enc)
    calls, grad_calls = TA._sdpa_blocks.calls, TA._sdpa_blocks.grad_calls
    got_loss, got = _port_loss_and_grads(tc, tree, tok, enc, remat=False)
    kinds = tc.layer_kinds()
    n_attn = sum(k in ("global", "local", "cross+global") for k in kinds)
    n_attn += kinds.count("cross+global") + tc.encoder_layers
    assert TA._sdpa_blocks.grad_calls - grad_calls == n_attn
    assert TA._sdpa_blocks.calls == calls
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    _grads_close(got, want)


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-8b", "gemma2-9b"])
def test_remat_variants_bit_equal(arch):
    """Remat off, on (a checkpoint a super-block) and ``remat_group=2``
    (a checkpoint a group of two super-blocks and the blocks inside; qwen2's
    3 super-blocks leave a remainder) give bit-equal loss and gradients."""
    rc, tc = cfgs(arch)
    tree = stacked_tree(arch)
    tok = tokens(rc, (2, SEQ), seed=4)
    base_loss, base = _port_loss_and_grads(tc, tree, tok, None, remat=False)
    for kw in (dict(remat=True), dict(remat=True, remat_group=2),
               dict(remat=False, remat_group=2)):
        loss, grads = _port_loss_and_grads(tc, tree, tok, None, **kw)
        assert loss == base_loss, kw
        assert all(torch.equal(g, b) for g, b in zip(grads, base)), kw


LR = 1e-3


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """One ``make_train_step`` step (AdamW, weight decay 0.1, the launcher's
    optimizer) against the reference's jitted step from the same params and
    batch: loss and grad norm within 1e-5 relative, the moments within
    F32_TOL, the params within 1e-6 absolute except where the gradient is
    under 1e-3 of its leaf's largest (there Adam's first step moves a
    parameter by about lr times the gradient's sign, which the two sides'
    rounding may flip), which are held within 2 lr and counted."""
    arch = "qwen3-8b"
    rc, tc = cfgs(arch)
    tree = stacked_tree(arch)
    tok = tokens(rc, (4, SEQ), seed=5)
    ropt, topt = RO.AdamW(lr=LR, weight_decay=0.1), TO.AdamW(lr=LR, weight_decay=0.1)
    rparams = jax.tree.map(jnp.asarray, tree)
    rstep = jax.jit(RTS.make_train_step(rc, ropt, microbatches=microbatches))
    rgrads = jax.grad(lambda p: RTS.lm_loss(p, rc, jnp.asarray(tok), remat=False))(rparams)
    rp, rstate, rmet = rstep(rparams, ropt.init(rparams), {"tokens": jnp.asarray(tok)})

    tparams = TT.params_from_numpy(tree, tc, "cpu", trainable=True)
    tstep = TTS.make_train_step(tc, topt, microbatches=microbatches)
    tp, tstate, tmet = tstep(tparams, topt.init(leaves(tparams)),
                             {"tokens": torch.from_numpy(tok)})
    assert tp is tparams and all(p.grad is None for p in leaves(tp))
    assert tmet["loss"].item() == pytest.approx(float(rmet["loss"]), rel=1e-5)
    assert tmet["grad_norm"].item() == pytest.approx(float(rmet["grad_norm"]), rel=1e-5)
    assert int(tstate.step) == int(rstate.step) == 1
    for got, want in ((tstate.m, rstate.m), (tstate.v, rstate.v)):
        _grads_close(got, [np.asarray(w) for w in jax.tree.leaves(want)], F32_TOL)
    flipped = 0
    for p, w, g in zip(leaves(tp), jax.tree.leaves(rp), jax.tree.leaves(rgrads)):
        p, w, g = as_np(p.detach()), np.asarray(w), np.abs(np.asarray(g))
        small = g < 1e-3 * g.max()
        err = np.abs(p - w)
        assert (err[~small] <= 1e-6).all(), float(err[~small].max())
        assert (err[small] <= 2 * LR).all()
        flipped += int((err[small] > 1e-6).sum())
    # the count is printed for the record; most small-gradient elements agree
    print(f"microbatches={microbatches}: {flipped} small-gradient params moved apart")


def test_bf16_step_loss_and_finite_grads():
    """bf16 (the configs' own dtype): the port's loss within BF16_LOSS_RTOL
    of the reference's bf16 loss, and every gradient finite.  The two round
    at different points inside their ops (bf16 GEMM accumulation order, the
    reference's bf16 scatter-add of the embedding gradient against the
    port's index backward, bf16 softmax inputs), each about a bf16 ulp
    (2^-8) of a value, over 4 layers; the loss moves about twice that from
    the f32 model's."""
    arch = "qwen3-8b"
    rc, tc = cfgs(arch, dtype="bfloat16")
    rc32, _ = cfgs(arch)
    tree = stacked_tree(arch)
    tok = tokens(rc, (2, SEQ), seed=6)
    want, _ = _ref_loss_and_grads(rc, tree, tok, None)
    want32, _ = _ref_loss_and_grads(rc32, tree, tok, None)
    got, grads = _port_loss_and_grads(tc, tree, tok, None, remat=True)
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)
    assert abs(got - want) <= BF16_LOSS_RTOL * abs(want), (got, want, want32)


#: |port bf16 loss - ref bf16 loss| / |ref bf16 loss|: 2^-7, twice a bf16 ulp
BF16_LOSS_RTOL = 2**-7


def test_params_bridge_round_trip():
    """The inverse bridge: the training form and the serving form (per
    layer, cast to bf16) back to the reference's stacked tree; the training
    form's leaves are f32 parameters requiring grad, in the reference's
    flatten order."""
    for arch in ("qwen2-7b", "recurrentgemma-9b", "whisper-base"):
        rc, tc = cfgs(arch)
        tree = stacked_tree(arch)
        tp = TT.params_from_numpy(tree, tc, "cpu", trainable=True)
        assert all(isinstance(p, torch.nn.Parameter) and p.requires_grad
                   and p.dtype == torch.float32 for p in leaves(tp))
        for got_tree in (TT.params_to_numpy(tp, tc),
                         TT.params_to_numpy(TT.params_from_numpy(tree, tc, "cpu"), tc)):
            got, want = jax.tree.leaves(got_tree), jax.tree.leaves(tree)
            assert len(got) == len(want)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
        bf = dataclasses.replace(tc, dtype="bfloat16")
        got = jax.tree.leaves(TT.params_to_numpy(TT.params_from_numpy(tree, bf, "cpu"), bf))
        want = [np.asarray(torch.from_numpy(np.asarray(w)).to(torch.bfloat16).float())
                for w in jax.tree.leaves(tree)]
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
