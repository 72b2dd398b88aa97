"""The port's ``Session.verify`` (full-graph route) against the reference's.

With the shipped params (``groot_csa8.npz``, the reference's trained model),
the port on the CPU must give predictions, verdict and accuracy identical to
``repro.api.Session`` on the same backend on csa-12 and booth-8, for each of
the five backends.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Session as RefSession  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402

NPZ = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data" / "groot_csa8.npz"


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree_util.tree_map(jnp.asarray, TG.load_params(NPZ))


@pytest.mark.parametrize("backend", ["ref", "onehot", "groot", "groot_mxu", "groot_fused"])
@pytest.mark.parametrize("dataset,bits", [("csa", 12), ("booth", 8)])
def test_verify_identical_to_reference(ref_params, dataset, bits, backend):
    want = RefSession(ref_params, backend=backend).verify(
        dataset=dataset, bits=bits, return_predictions=True)
    got = Session(NPZ, backend=backend, device="cpu").verify(
        dataset=dataset, bits=bits, return_predictions=True)
    np.testing.assert_array_equal(got.predictions, want.predictions, err_msg=backend)
    assert dataclasses.asdict(got.verdict) == dataclasses.asdict(want.verdict)
    assert (got.status, got.accuracy, got.name) == (want.status, want.accuracy, want.name)
    assert (got.num_nodes, got.num_edges) == (want.num_nodes, want.num_edges)
    assert got.peak_memory_bytes == want.peak_memory_bytes


def test_batched_verify_matches_reference(ref_params):
    want = RefSession(ref_params, batch=2).verify(dataset="csa", bits=6, return_predictions=True)
    got = Session(NPZ, batch=2, backend="groot", device="cpu").verify(
        dataset="csa", bits=6, return_predictions=True)
    assert got.status == want.status == "classified"
    np.testing.assert_array_equal(got.predictions, want.predictions)


def test_explain_is_full_and_matches_reference():
    want = RefSession().explain(dataset="csa", bits=10)
    got = Session(device="cpu").explain(dataset="csa", bits=10)
    assert got.mode == "full"
    for f in ("mode", "backend", "k", "modeled_full_bytes", "modeled_peak_bytes",
              "num_nodes", "num_edges", "reason"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("overrides", [{"num_partitions": 4}, {"memory_budget_bytes": 200_000}])
def test_unported_routes_raise(ref_params, overrides):
    """The streamed route over more than one device (mode "sharded") with
    the one CPU device visible: the routing decision equals the reference's
    field for field, and ``verify`` refuses with the reference's
    ``MeshConfigError`` text; on one device it streams."""
    from repro.launch.mesh import MeshConfigError as RefMeshConfigError
    from repro_torch.launch.mesh import MeshConfigError

    want = RefSession(ref_params, mesh_devices=2, **overrides).explain(dataset="csa", bits=6)
    sess = Session(NPZ, device="cpu", mesh_devices=2, **overrides)
    got = sess.explain(dataset="csa", bits=6)
    assert got.mode == "sharded" and got.mesh_devices == 2
    for f in ("mode", "k", "num_buckets", "buckets", "modeled_peak_bytes",
              "memory_budget_bytes", "mesh_devices", "reason"):
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(RefMeshConfigError) as ref_err:
        RefSession(ref_params, mesh_devices=2, **overrides).verify(dataset="csa", bits=6)
    with pytest.raises(MeshConfigError) as err:
        sess.verify(dataset="csa", bits=6)
    assert str(err.value) == str(ref_err.value) == (
        "mesh_devices=2 out of range: 1 device(s) visible")
    r = Session(NPZ, device="cpu", **overrides).verify(dataset="csa", bits=6)
    assert r.routing.mode == "streamed" and r.exec_stats["launches"] > 0


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(NPZ)
    model = TG.params_from_numpy(TG.load_params(NPZ))
    from repro_torch.core import aig, features

    design = aig.make_design("csa", 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.predict(model, design, features.groot_features(design), backend="groot")
    assert Session(NPZ, device="cpu").device.type == "cpu"
