"""The port's training against the reference's (``repro/core/gnn.py``
training, ``repro/training/optimizer.py``, ``repro/training/data.py``,
``repro/core/pipeline.py:train_model``).

From one init (the reference's ``init_params`` crossed through numpy), the
port's AdamW update, loss and training steps must follow the reference's:
updates within 1e-6, losses within 1e-6 relative, 20 training losses within
1e-4 relative (f32 sums in other orders).  The port draws its init as the
reference does (``repro_torch.core.prng``), so its own ``train_model`` is held
to the reference's csa-32 accuracy and to the shipped params' verdict.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aig as RA  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core.features import groot_features as rfeatures  # noqa: E402
from repro.training import data as RD  # noqa: E402
from repro.training import optimizer as RO  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.core import aig as TA  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402
from repro_torch.core import pipeline as TP  # noqa: E402
from repro_torch.core.features import groot_features  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.training import data as TD  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

NPZ = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data" / "groot_csa8.npz"
EPOCHS = 200
STEPS = 20          # training losses held to the reference's
VERIFY_BITS = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small graphs train far faster on one thread than on a contended pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def init_tree():
    """The reference's init at seed 0, as numpy."""
    return jax.tree.map(np.asarray, RG.init_params(RG.GNNConfig(), jax.random.key(0)))


@pytest.fixture(scope="module")
def csa8():
    d = TA.make_design("csa", 8)
    return d, groot_features(d)


@pytest.fixture(scope="module")
def trained(init_tree, csa8):
    """One training of each package from the reference's init: the
    reference's first STEPS losses and its params after EPOCHS, and the
    port's losses (every epoch) and params after EPOCHS."""
    d = RA.make_design("csa", 8)
    rbatch = RG.make_batch(d, rfeatures(d), d.label.astype(np.int32))
    optimizer = RO.AdamW(lr=5e-3, weight_decay=1e-4)
    params = jax.tree.map(jnp.asarray, init_tree)
    state = optimizer.init(params)
    ref_losses = []
    for _ in range(EPOCHS):
        params, state, loss = RG.train_step(params, state, rbatch, optimizer)
        if len(ref_losses) < STEPS:
            ref_losses.append(float(loss))
    design, feats = csa8
    batch = TG.make_batch(design, feats, design.label.astype(np.int32), device="cpu")
    model, hist = TG.train(TG.params_from_numpy(init_tree), batch, epochs=EPOCHS, log_every=1)
    return dict(ref_losses=ref_losses, ref_params=jax.tree.map(np.asarray, params),
                losses=[loss for _, loss in hist], model=model)


def _tensors(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def assert_close(got, want, rel=1e-6):
    """|got - want| <= rel * max|want| (the norm's sum runs in another
    order, so a clipped update moves in its last bits)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_identical_to_reference(grad_scale):
    """Three updates on the same params and gradients: updates, moments,
    params and the global norm within 1e-6 relative (the larger gradients
    are clipped)."""
    rng = np.random.default_rng(0)
    shapes = [(4, 32), (32, 32), (32,), (32, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ref_opt = RO.AdamW(lr=5e-3, weight_decay=1e-4)
    opt = TO.AdamW(lr=5e-3, weight_decay=1e-4)
    rstate, state = ref_opt.init([jnp.asarray(p) for p in params]), opt.init(_tensors(params))
    rparams, tparams = [jnp.asarray(p) for p in params], _tensors(params)
    for _ in range(3):
        grads = [(grad_scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
        want_norm = float(RO.global_norm([jnp.asarray(g) for g in grads]))
        assert float(TO.global_norm(_tensors(grads))) == pytest.approx(want_norm, rel=1e-6)
        rupd, rstate = ref_opt.update([jnp.asarray(g) for g in grads], rstate, rparams)
        upd, state = opt.update(_tensors(grads), state, tparams)
        for got, want in zip(upd + state.m + state.v, list(rupd) + list(rstate.m) +
                             list(rstate.v)):
            assert_close(got.numpy(), want)
        rparams = RO.apply_updates(rparams, rupd)
        tparams = TO.apply_updates(tparams, upd)
        for got, want in zip(tparams, rparams):
            assert_close(got.numpy(), want)
    assert int(state.step) == int(rstate.step) == 3


@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
def test_loss_identical_to_reference(init_tree, csa8, masked):
    design, feats = csa8
    labels = design.label.astype(np.int32)
    rbatch = RG.make_batch(RA.make_design("csa", 8), feats, labels)
    batch = TG.make_batch(design, feats, labels, device="cpu")
    if masked:
        mask = (np.random.default_rng(1).random(design.num_nodes) < 0.5).astype(np.float32)
        rbatch["mask"], batch["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    want = float(RG.loss_fn(jax.tree.map(jnp.asarray, init_tree), rbatch))
    got = TG.loss_fn(TG.params_from_numpy(init_tree), batch)
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_training_losses_follow_reference(trained):
    got = np.array(trained["losses"][:STEPS])
    want = np.array(trained["ref_losses"])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < 0.1 * got[0]


def test_training_from_reference_init_reaches_reference_accuracy(trained):
    """After EPOCHS, the port's params and the reference's (both from the
    reference's init) give the same csa-32 verdict; where the reference's
    reach 0.99, so must the port's."""
    ref = Session(trained["ref_params"], device="cpu").verify(dataset="csa", bits=VERIFY_BITS)
    got = Session(trained["model"], device="cpu").verify(dataset="csa", bits=VERIFY_BITS)
    assert got.status == ref.status
    if ref.accuracy >= 0.99:
        assert got.accuracy >= 0.99, (got.accuracy, ref.accuracy)


def test_train_model_gives_shipped_verdict(trained):
    """The port's own ``train_model`` (the reference's init, drawn in numpy)
    reaches the reference's csa-32 accuracy (``trained``'s reference run is
    the reference's ``train_model``: the same init and steps) and gives the
    shipped params' verdict; its accuracy is printed (``pytest -s``)."""
    from repro.api import Session as RSession

    params, hist = TP.train_model("csa", 8, epochs=EPOCHS, seed=0, device="cpu")
    assert [e for e, _ in hist] == [0, 50, 100, 150, EPOCHS - 1]
    assert hist[-1][1] < hist[0][1]
    got = Session(params, device="cpu").verify(dataset="csa", bits=VERIFY_BITS)
    ref = RSession(trained["ref_params"]).verify(dataset="csa", bits=VERIFY_BITS)
    assert got.accuracy == ref.accuracy and got.status == ref.status
    shipped = Session(NPZ, device="cpu").verify(dataset="csa", bits=VERIFY_BITS)
    print(f"train_model csa-8 {EPOCHS} epochs seed 0: csa-{VERIFY_BITS} {got.status} "
          f"accuracy {got.accuracy:.6f} (shipped params {shipped.status} "
          f"{shipped.accuracy:.6f})")
    assert got.status == shipped.status


def test_session_train_adopts_params_and_drops_cache():
    sess = Session(device="cpu")
    assert not sess.has_params
    with pytest.raises(RuntimeError, match="no params"):
        _ = sess.params
    hist = sess.train("csa", 4, epochs=3)
    assert sess.has_params and len(hist) == 2 and not sess.params.layers[0].w_self.requires_grad
    r = sess.verify(dataset="csa", bits=6, verify=False)
    assert sess.verify(dataset="csa", bits=6, verify=False).cached
    sess.train("csa", 4, epochs=3)
    again = sess.verify(dataset="csa", bits=6, verify=False)
    assert not again.cached and again.num_nodes == r.num_nodes


def test_init_params_uniform_and_seeded():
    cfg = TG.GNNConfig()
    a = TG.init_params(cfg, 3)
    b = TG.init_params(cfg, 3)
    c = TG.init_params(cfg, 4)
    for (name, x), y, z in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert x.requires_grad and torch.equal(x, y)
        if name.endswith(".b"):
            assert not x.any()
            continue
        bound = 1.0 / np.sqrt(x.shape[0])
        assert x.abs().max() <= bound and not torch.equal(x, z)
    ref = RG.init_params(cfg, jax.random.key(3))
    tree = TG.params_to_numpy(a)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, ref)
    for got, want in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_train_leaves_its_input_alone(init_tree, csa8):
    design, feats = csa8
    batch = TG.make_batch(design, feats, design.label.astype(np.int32), device="cpu")
    model = TG.params_from_numpy(init_tree)
    before = [p.clone() for p in model.parameters()]
    trained, hist = TG.train(model, batch, epochs=2)
    assert hist == [] and trained is not model
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), before))
    assert not all(torch.equal(p, q) for p, q in zip(trained.parameters(), before))


@pytest.mark.parametrize("backend", ["groot", "groot_mxu", "groot_fused", "onehot"])
def test_kernel_backend_asked_for_gradient_raises(csa8, backend):
    """Only the plain reference trains: a kernel backend with grad mode on
    and trainable params raises rather than returning a zero gradient, and
    runs without a graph under ``torch.no_grad()``."""
    design, feats = csa8
    g = design.to_edge_graph()
    model = TG.init_params(TG.GNNConfig(), 0)
    tensors = TG.graph_tensors(g, "cpu")
    x = torch.from_numpy(feats)
    agg = ops.make_agg_pair(g.edge_src, g.edge_dst, g.num_nodes, backend, device="cpu",
                            cache=False)
    with pytest.raises(RuntimeError, match="no backward"):
        TG.forward(model, x, *tensors, num_nodes=g.num_nodes, agg=agg)
    with torch.no_grad():
        logits = TG.forward(model, x, *tensors, num_nodes=g.num_nodes, agg=agg)
    assert logits.grad_fn is None
    ref = TG.forward(model, x, *tensors, num_nodes=g.num_nodes)
    grads = torch.autograd.grad(ref.square().sum(), list(model.parameters()))
    assert all(gr.abs().sum() > 0 for gr in grads)
    torch.testing.assert_close(logits, ref.detach(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dataset,bits", [("csa", 8), ("booth", 6)])
def test_graph_batch_identical(dataset, bits):
    got, want = TD.graph_batch(dataset, bits, seed=2), RD.graph_batch(dataset, bits, seed=2)
    for f in ("x", "edge_src", "edge_dst", "edge_inv", "edge_slot", "labels"):
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
