"""The port's structure keys (CPU): a prepared structure (an ``EdgeGraph``,
a ``Subgraph``) is hashed once and carries its ``plan_cache.keys_of`` memo,
frozen against in-place writes; a packed launch's keys are looked up by its
recipe.  The key values equal ``structure_keys`` of the arrays, and repeated
runs on every route predict as the first run and as the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Session, SessionConfig  # noqa: E402
from repro_torch.core import aig as A  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.core import pipeline as P  # noqa: E402
from repro_torch.core import regrowth as TR  # noqa: E402
from repro_torch.core.features import groot_features  # noqa: E402
from repro_torch.core.graph import EdgeGraph  # noqa: E402
from repro_torch.exec import packing as TK  # noqa: E402
from repro_torch.exec import plan as TX  # noqa: E402
from repro_torch.exec import stream as TS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import plan_cache as pc  # noqa: E402
from repro_torch.obs import REGISTRY, Tracer  # noqa: E402
from repro_torch.service.scheduler import BucketRunner  # noqa: E402

from torch_stream_common import NPZ  # noqa: E402

#: the three routes a prepared csa-12 takes
ROUTES = {
    "full": dict(num_partitions=1),
    "partitioned": dict(num_partitions=4, streaming=False),
    "streamed": dict(num_partitions=4, stream_capacity=2),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return TG.params_from_numpy(TG.load_params(NPZ))


def counts() -> tuple[int, int]:
    return (REGISTRY.counter("plan.key_hashes").value,
            REGISTRY.counter("plan.key_memo_hits").value)


def csa(bits: int):
    d = A.make_design("csa", bits)
    return d.to_edge_graph(), groot_features(d)


@pytest.mark.parametrize("form", ["int32", "int64", "strided", "list", "empty"])
def test_key_values_are_the_reference_graph_key(form):
    """The digests hash the widened arrays in place: the same values as the
    reference's ``graph_key``, whatever form the endpoints come in."""
    pytest.importorskip("jax")
    from repro.kernels import plan_cache as RPC

    rng = np.random.default_rng(5)
    src, dst = (rng.integers(0, 90, 64).astype(np.int32) for _ in range(2))
    src, dst = {"int32": (src, dst), "int64": (src.astype(np.int64), dst.astype(np.int64)),
                "strided": (src[::2], dst[1::2]), "list": (list(src), list(dst)),
                "empty": (src[:0], dst[:0])}[form]
    want = (RPC.graph_key(src, dst, 90), RPC.graph_key(dst, src, 90))
    assert pc.graph_key(src, dst, 90) == want[0]
    assert pc.structure_keys(src, dst, 90) == want
    if form != "list":
        g = EdgeGraph(90, src, dst)
        assert pc.keys_of(g) == want
        assert pc.recipe_keys(("pack_keys", form), src, dst, 90) == want


@pytest.mark.parametrize("kind", ["graph", "subgraph"])
def test_memoized_keys_are_the_structure_keys(kind):
    g, _ = csa(10)
    structures = [g] if kind == "graph" else TR.extract_partitions(
        g, TP.bfs_stripe_partition(g, 3))
    for s in structures:
        want = pc.structure_keys(s.edge_src, s.edge_dst, s.num_nodes)
        hashes, hits = counts()
        keys = pc.keys_of(s)
        assert keys == want and counts() == (hashes + 1, hits)
        assert pc.keys_of(s) is keys and counts() == (hashes + 1, hits + 1)
        assert not s.edge_src.flags.writeable and not s.edge_dst.flags.writeable
        assert s.key_memo[3] is keys


def test_prepared_full_route_hashes_the_first_verify_only(model):
    sess = Session(model, SessionConfig(device="cpu", backend="groot", trace=True,
                                        **ROUTES["full"]))
    prep = sess.prepare(dataset="csa", bits=16)
    moved = []
    for _ in range(3):
        before = counts()
        r = sess.verify(prepared=prep, verify=False, use_cache=False)
        after = counts()
        keys = [s for s in r.trace.spans() if s.name == "plan.key"]
        moved.append((after[0] - before[0], after[1] - before[1],
                      [(s.attrs["bytes"], s.attrs["memo"]) for s in keys]))
    g = prep.graph
    first = 2 * (16 * g.num_edges + 9)
    assert moved == [(1, 0, [(first, "miss")]), (0, 1, [(0, "hit")]), (0, 1, [(0, "hit")])]


def test_a_write_to_a_keyed_graph_raises():
    g, _ = csa(8)
    keys = pc.keys_of(g)
    with pytest.raises(ValueError):
        g.edge_src[0] = 1
    with pytest.raises(ValueError):
        g.edge_dst[:2] += 1
    # replacing an endpoint array (a new, writable object) voids the memo
    g.edge_src = g.edge_src.copy()
    hashes, hits = counts()
    assert pc.keys_of(g) == keys and counts() == (hashes + 1, hits)


def test_a_changed_subgraph_copy_gets_its_own_keys_and_plan():
    g, _ = csa(10)
    sg = TR.extract_partitions(g, TP.bfs_stripe_partition(g, 2))[0]
    pair = ops.make_agg_pair(sg.edge_src, sg.edge_dst, sg.num_nodes, "groot",
                             device="cpu", gkeys=pc.keys_of(sg))
    src = sg.edge_src.copy()
    src[0] = (src[0] + 1) % sg.num_nodes
    changed = dataclasses.replace(sg, edge_src=src)
    assert changed.key_memo is None
    keys = pc.keys_of(changed)
    assert keys == pc.structure_keys(src, sg.edge_dst, sg.num_nodes)
    assert keys[0] != pc.keys_of(sg)[0] and keys[1] != pc.keys_of(sg)[1]
    other = ops.make_agg_pair(src, sg.edge_dst, sg.num_nodes, "groot", device="cpu",
                              gkeys=keys)
    assert other is not pair and other.in_plan is not pair.in_plan
    assert other.in_plan is pc.cached_plan(src, sg.edge_dst, sg.num_nodes, gkey=keys[0])
    assert ops.make_agg_pair(sg.edge_src, sg.edge_dst, sg.num_nodes, "groot",
                             device="cpu", gkeys=pc.keys_of(sg)) is pair


@pytest.mark.parametrize("capacity", [1, 2, 3])
def test_pack_recipe_keys_are_the_packed_arrays_keys(model, capacity):
    g, feats = csa(16)
    budget = P.memory_model_bytes(g.num_nodes, g.num_edges, TG.GNNConfig()) // 2
    sess = Session(model, SessionConfig(device="cpu", backend="groot",
                                        memory_budget_bytes=budget,
                                        stream_capacity=capacity))
    prep = sess.prepare(dataset="csa", bits=16)
    assert prep.num_partitions >= 2
    ex = TS.StreamingExecutor(runner=BucketRunner(model, "groot", device="cpu"),
                              capacity=capacity)
    plan = TX.plan_from_subgraphs(list(prep.subgraphs), prep.num_nodes,
                                  min_nodes=ex.min_nodes, min_edges=ex.min_edges)
    for shape, indices in plan.schedule(capacity):
        b = TK.pack_partitions(plan, indices, prep.feats, shape, capacity, keyed=True)
        arrays = b.arrays
        assert b.gkeys == pc.structure_keys(arrays["edge_src"], arrays["edge_dst"],
                                            arrays["num_nodes"])
    first = ex.run_plan(plan, prep.feats)
    tr = Tracer()
    hashes, hits = counts()
    with tr.activate():
        again = ex.run_plan(plan, prep.feats)
    keys = [s for s in tr.spans() if s.name == "plan.key"]
    lookups = sum(len(ix) + 1 for _, ix in plan.schedule(capacity))   # slots, then the pack
    assert counts() == (hashes, hits + lookups) and len(keys) == lookups
    assert all(s.attrs["bytes"] == 0 and s.attrs["memo"] == "hit" for s in keys)
    np.testing.assert_array_equal(again, first)


def reference_predictions(prep) -> np.ndarray:
    """The reference package's plain (``ref``) predictions of a prepared
    design: its full-graph forward, or its per-subgraph loop."""
    jax = pytest.importorskip("jax")
    from repro.core import gnn as RG
    from repro.core.graph import EdgeGraph as RefEdgeGraph
    from repro.core.regrowth import Subgraph as RefSubgraph

    params = jax.tree_util.tree_map(jax.numpy.asarray, TG.load_params(NPZ))
    if prep.subgraphs is None:
        g = prep.graph
        return np.asarray(RG.predict(params, RefEdgeGraph(
            g.num_nodes, g.edge_src, g.edge_dst, g.edge_inv, g.edge_slot), prep.feats))
    subs = [RefSubgraph(sg.global_ids, sg.num_core, sg.edge_src, sg.edge_dst,
                        sg.edge_inv, sg.edge_slot) for sg in prep.subgraphs]
    return np.asarray(RG.predict_partitioned_loop(params, subs, prep.feats, prep.num_nodes))


@pytest.mark.parametrize("route", list(ROUTES))
def test_repeated_runs_predict_as_the_first_and_the_reference(model, route):
    sess = Session(model, SessionConfig(device="cpu", backend="groot", **ROUTES[route]))
    prep = sess.prepare(dataset="csa", bits=12)
    runs = [sess.verify(prepared=prep, verify=False, use_cache=False,
                        return_predictions=True) for _ in range(3)]
    assert {r.routing.mode for r in runs} == {route}
    want = reference_predictions(prep)
    for r in runs:
        np.testing.assert_array_equal(r.predictions, runs[0].predictions)
        np.testing.assert_array_equal(r.predictions, want)
