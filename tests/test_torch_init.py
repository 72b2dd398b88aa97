"""The port's initial params against the reference's (``repro/core/gnn.py:
init_params``, ``repro/core/pipeline.py:train_model``).

``repro_torch.core.prng`` draws as ``jax.random`` does, so
``init_params(cfg, seed)`` must be bit-equal to the reference's
``init_params(cfg, jax.random.key(seed))``; ``train_model`` then starts where
the reference's does: its first 20 losses within 5e-6 relative (the loss's
f32 sums run in another order: 1.72e-6 at worst on this input), and its
csa-32 accuracy after 200 epochs equal to the reference's.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import Session as RSession  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core import pipeline as RP  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402
from repro_torch.core import pipeline as TP  # noqa: E402
from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 7, 2**31 - 1, 2**32 + 5, 123456]
CONFIGS = {"default": {}, "hidden24": {"hidden": 24}, "layers6": {"num_layers": 6}}
EPOCHS = 200
STEPS = 20


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small graphs train far faster on one thread than on a contended pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_init_params_bit_equal_to_reference(config, seed):
    cfg = CONFIGS[config]
    want = RG.init_params(RG.GNNConfig(**cfg), jax.random.key(seed))
    got = TG.params_to_numpy(TG.init_params(TG.GNNConfig(**cfg), seed))
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        a = np.asarray(a)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_keys_split_and_uniform_match_jax(seed):
    k = prng.key(seed)
    jk = jax.random.key(seed)
    np.testing.assert_array_equal(k, np.asarray(jax.random.key_data(jk)))
    for n in (2, 3, 8):
        np.testing.assert_array_equal(
            prng.split(k, n), np.asarray(jax.random.key_data(jax.random.split(jk, n))))
    for shape, lo, hi in [((5, 7), -0.5, 0.5), ((1000,), -1 / np.sqrt(3), 1 / np.sqrt(3)),
                          ((3, 3, 4), 0.0, 2.0)]:
        want = np.asarray(jax.random.uniform(jk, shape, np.float32, lo, hi))
        assert np.array_equal(prng.uniform(k, shape, lo, hi).view(np.uint32),
                              want.view(np.uint32))


@pytest.fixture(scope="module")
def both_trained():
    tparams, thist = TP.train_model("csa", 8, epochs=EPOCHS, seed=0, device="cpu")
    rparams, rhist = RP.train_model("csa", 8, epochs=EPOCHS, seed=0)
    return dict(tparams=tparams, thist=thist, rparams=rparams, rhist=rhist)


def test_train_model_first_losses_follow_reference():
    """One step per epoch, every loss logged, from the seed-0 init in both
    packages."""
    design = RP.A.make_design("csa", 8, seed=0)
    feats = RP.groot_features(design)
    rbatch = RG.make_batch(design, feats, design.label.astype(np.int32))
    _, rhist = RG.train(RG.init_params(RG.GNNConfig(), jax.random.key(0)), rbatch,
                        epochs=STEPS, log_every=1)
    tdesign = TP.A.make_design("csa", 8, seed=0)
    tbatch = TG.make_batch(tdesign, TP.groot_features(tdesign),
                           tdesign.label.astype(np.int32), device="cpu")
    _, thist = TG.train(TG.init_params(TG.GNNConfig(), 0), tbatch, epochs=STEPS, log_every=1)
    got = np.array([loss for _, loss in thist])
    want = np.array([loss for _, loss in rhist])
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=5e-6)


def test_train_model_reaches_reference_accuracy(both_trained):
    got = Session(both_trained["tparams"], device="cpu").verify(dataset="csa", bits=32)
    want = RSession(both_trained["rparams"]).verify(dataset="csa", bits=32)
    assert got.accuracy == want.accuracy and got.status == want.status
    assert [e for e, _ in both_trained["thist"]] == [e for e, _ in both_trained["rhist"]]
    assert both_trained["thist"][0][1] == pytest.approx(both_trained["rhist"][0][1], rel=1e-6)
