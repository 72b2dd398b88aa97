"""The port's GNN against the reference's: params bridge, logits, predictions.

Inputs and params are made with numpy from a seed and fed to both packages.
The reference's groot walks run their Pallas kernels with ``interpret=True``;
the port's run the kernels' plain versions on the CPU.  f32 logits agree
within rtol = atol = 1e-4 (as the reference's own grouped-vs-ref bound); bf16
streams stay within a max relative error of 0.05 per layer of the f32
logits (the reference's pinned bf16 bound).
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
from repro.core.features import groot_features  # noqa: E402
from repro.kernels import ops as ROPS  # noqa: E402
from repro_torch.core import aig as TA  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from tests.test_forward_plan import MIXTURES  # noqa: E402
from tests.test_plan_properties import graph_from_degrees  # noqa: E402

NPZ = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data" / "groot_csa8.npz"


def _random_tree(num_layers, hidden=16, in_features=4, seed=1):
    rng = np.random.default_rng(seed)
    dims = [in_features] + [hidden] * num_layers
    layers = []
    for i in range(num_layers):
        s = 1.0 / np.sqrt(dims[i])
        layer = {nm: rng.uniform(-s, s, (dims[i], dims[i + 1])).astype(np.float32)
                 for nm in TG.LAYER_WEIGHTS}
        layer["b"] = rng.uniform(-0.1, 0.1, dims[i + 1]).astype(np.float32)
        layers.append(layer)
    head = {"w": rng.uniform(-0.25, 0.25, (hidden, 5)).astype(np.float32),
            "b": rng.uniform(-0.1, 0.1, 5).astype(np.float32)}
    return {"layers": layers, "head": head}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_trees_equal(a, b):
    assert len(a["layers"]) == len(b["layers"])
    for la, lb in zip(a["layers"], b["layers"]):
        assert la.keys() == lb.keys()
        for k in la:
            assert la[k].dtype == lb[k].dtype
            np.testing.assert_array_equal(la[k], lb[k])
    for k in ("w", "b"):
        np.testing.assert_array_equal(a["head"][k], b["head"][k])


def test_params_bridge_round_trips_bit_exactly(tmp_path):
    tree = _random_tree(3, hidden=8)
    model = TG.params_from_numpy(tree)
    assert model.cfg == TG.GNNConfig(in_features=4, hidden=8, num_layers=3)
    _assert_trees_equal(TG.params_to_numpy(model), tree)
    TG.save_params(tree, tmp_path / "p.npz")
    _assert_trees_equal(TG.load_params(tmp_path / "p.npz"), tree)
    shipped = TG.params_from_numpy(TG.load_params(NPZ))
    assert shipped.cfg == TG.GNNConfig()


def _mixture_inputs():
    n, e_t, hd_frac, scale, seed = MIXTURES[2]     # real e_t: deep LD + HD rows
    rng = np.random.default_rng(seed)
    src, dst = graph_from_degrees(rng, n, e_t, hd_frac, scale)
    e = len(src)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    inv = rng.integers(0, 2, e).astype(bool)
    slot = rng.integers(0, 2, e).astype(np.uint8)
    return src.astype(np.int32), dst.astype(np.int32), n, x, inv, slot


# jitted: the interpret-mode Pallas walks run several times faster compiled
_ref_forward_jit = jax.jit(RG.forward, static_argnames=("num_nodes", "agg"))


def _ref_forward(tree, src, dst, n, x, inv, slot, backend, transform=None):
    agg = None if backend is None else ROPS.make_agg_pair(src, dst, n, backend)
    if transform is not None:
        agg = transform(agg)
    return np.asarray(_ref_forward_jit(
        _jax_tree(tree), jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(inv), jnp.asarray(slot), num_nodes=n, agg=agg))


def _port_forward(model, src, dst, n, x, inv, slot, agg, stream_dtype=None):
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    return TG.forward(model, t(x), t(src).long(), t(dst).long(), t(inv), t(slot),
                      num_nodes=n, agg=agg, stream_dtype=stream_dtype).numpy()


@pytest.mark.parametrize("num_layers", [1, 2, 4])
def test_logits_match_reference(num_layers):
    src, dst, n, x, inv, slot = _mixture_inputs()
    tree = _random_tree(num_layers)
    model = TG.params_from_numpy(tree)
    want = _ref_forward(tree, src, dst, n, x, inv, slot, None)
    got = _port_forward(model, src, dst, n, x, inv, slot, None)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    scale = np.maximum(np.abs(want), 1.0)
    for backend in ("groot", "groot_fused"):
        ref = _ref_forward(tree, src, dst, n, x, inv, slot, backend)
        pair = TOPS.make_agg_pair(src, dst, n, backend, device="cpu")
        # hoisted (the main path), pre-hoist grouped, and per-group loop
        for agg in (pair, TOPS.unhoisted(pair), TOPS.ungrouped(pair)):
            got = _port_forward(model, src, dst, n, x, inv, slot, agg)
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4, err_msg=backend)
        bf16 = _port_forward(model, src, dst, n, x, inv, slot, pair, stream_dtype="bfloat16")
        assert np.max(np.abs(bf16 - want) / scale) < 0.05 * num_layers, backend


@pytest.mark.parametrize("backend", ["onehot", "groot", "groot_mxu", "groot_fused"])
def test_per_group_and_mxu_forwards_match_reference(backend):
    """The per-group forward of ``ops.ungrouped(pair)`` (K5 + K6 on groot,
    K5's MXU body on groot_mxu, K7 on groot_fused), the onehot forward and
    the hoisted groot_mxu forward (K4) against the reference's."""
    src, dst, n, x, inv, slot = _mixture_inputs()
    tree = _random_tree(2)
    model = TG.params_from_numpy(tree)
    pair = TOPS.make_agg_pair(src, dst, n, backend, device="cpu")
    want = _ref_forward(tree, src, dst, n, x, inv, slot, backend, ROPS.ungrouped)
    got = _port_forward(model, src, dst, n, x, inv, slot, TOPS.ungrouped(pair))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if backend == "groot_mxu":
        want = _ref_forward(tree, src, dst, n, x, inv, slot, backend)
        got = _port_forward(model, src, dst, n, x, inv, slot, pair)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        scale = np.maximum(np.abs(want), 1.0)
        bf16 = _port_forward(model, src, dst, n, x, inv, slot, pair, stream_dtype="bfloat16")
        assert np.max(np.abs(bf16 - want) / scale) < 0.05 * 2


def test_predict_identical_on_csa16():
    tree = TG.load_params(NPZ)
    design = RA.make_design("csa", 16)
    feats = groot_features(design)
    want = RG.predict(_jax_tree(tree), design, feats, backend="groot")
    assert want.dtype == np.int32
    np.testing.assert_array_equal(RG.predict(_jax_tree(tree), design, feats, backend="ref"), want)
    model = TG.params_from_numpy(tree)
    port_design = TA.make_design("csa", 16)
    for backend in TOPS.BACKENDS:
        got = TG.predict(model, port_design, feats, backend=backend, device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=backend)
