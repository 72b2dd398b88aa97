"""The port's partitioned route against the reference's.

Partitioning (``core/partition.py``), boundary re-growth
(``core/regrowth.py``), the partition plan and ``choose_k``
(``exec/plan.py``), the memory model (``core/pipeline.py``) and
the ``streaming=False`` route of ``Session`` must give arrays and decisions
identical to ``repro``'s on the same designs, and predictions, verdict and
accuracy identical to the reference's partitioned loop.
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
from repro.core import aig as RA  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core import partition as RP  # noqa: E402
from repro.core import pipeline as RPL  # noqa: E402
from repro.core import regrowth as RR  # noqa: E402
from repro.core.graph import EdgeGraph as RefEdgeGraph  # noqa: E402
from repro.exec import plan as RX  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.core import aig as A  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.core import pipeline as P  # noqa: E402
from repro_torch.core import regrowth as TR  # noqa: E402
from repro_torch.core.graph import EdgeGraph  # noqa: E402
from repro_torch.exec import plan as TX  # noqa: E402
from repro_torch.kernels import plan_cache as pc  # noqa: E402

NPZ = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data" / "groot_csa8.npz"
DESIGNS = [("csa", 8), ("csa", 32), ("booth", 8)]


def graphs(dataset, bits):
    """The design's graph as the port builds it and as the reference does."""
    return (A.make_design(dataset, bits).to_edge_graph(),
            RA.make_design(dataset, bits).to_edge_graph())


def as_ref(g: EdgeGraph) -> RefEdgeGraph:
    return RefEdgeGraph(g.num_nodes, g.edge_src, g.edge_dst, g.edge_inv, g.edge_slot)


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree_util.tree_map(jnp.asarray, TG.load_params(NPZ))


@pytest.mark.parametrize("k", [1, 2, 4, 16])
@pytest.mark.parametrize("dataset,bits", DESIGNS)
@pytest.mark.parametrize("partitioner", ["multilevel", "bfs"])
def test_part_ids_identical_to_reference(partitioner, dataset, bits, k):
    g, rg = graphs(dataset, bits)
    got = TP.PARTITIONERS[partitioner](g, k, seed=3)
    want = RP.PARTITIONERS[partitioner](rg, k, seed=3)
    assert_same(got, want)
    assert TP.edge_cut(g, got) == RP.edge_cut(rg, want)


@pytest.mark.parametrize("k", [1, 2, 4, 16])
@pytest.mark.parametrize("partitioner", ["multilevel", "bfs"])
def test_part_ids_at_the_edges(partitioner, k):
    """More parts than nodes, a graph with self-loops, and the empty graph."""
    tiny = EdgeGraph(5, np.array([0, 1, 2, 3, 4, 2], np.int32),
                     np.array([1, 2, 3, 4, 4, 0], np.int32))
    empty = EdgeGraph(0, np.zeros(0, np.int32), np.zeros(0, np.int32))
    for g in (tiny, empty):
        got = TP.PARTITIONERS[partitioner](g, k)
        assert_same(got, RP.PARTITIONERS[partitioner](as_ref(g), k))
    assert TR.extract_partitions(empty, TP.PARTITIONERS[partitioner](empty, k)) == []


@pytest.mark.parametrize("regrow,hops", [(False, 1), (True, 1), (True, 2), (True, 4)])
@pytest.mark.parametrize("dataset,bits", [("csa", 16), ("booth", 8)])
def test_subgraphs_identical_to_reference(dataset, bits, regrow, hops):
    g, rg = graphs(dataset, bits)
    part = TP.multilevel_partition(g, 4)
    got = TR.extract_partitions(g, part, regrow=regrow, hops=hops)
    want = RR.extract_partitions(rg, RP.multilevel_partition(rg, 4), regrow=regrow, hops=hops)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.num_core == b.num_core and a.num_halo == b.num_halo
        for f in ("global_ids", "edge_src", "edge_dst", "edge_inv", "edge_slot"):
            assert_same(getattr(a, f), getattr(b, f))
    assert TR.boundary_edge_fraction(g, part) == RR.boundary_edge_fraction(rg, part)


def test_gappy_part_ids_compact_like_the_reference():
    g, rg = graphs("csa", 8)
    part = (np.arange(g.num_nodes) % 3 * 5).astype(np.int32)   # ids 0, 5, 10
    got = TR.extract_partitions(g, part)
    want = RR.extract_partitions(rg, part)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert_same(a.global_ids, b.global_ids)
        assert_same(a.edge_src, b.edge_src)


@pytest.mark.parametrize("hidden,layers", [(32, 4), (16, 2)])
def test_models_and_choose_k_identical_to_reference(hidden, layers):
    cfg = TG.GNNConfig(hidden=hidden, num_layers=layers)
    rcfg = RG.GNNConfig(hidden=hidden, num_layers=layers)
    for n, e in ((0, 0), (1, 0), (1165, 2258), (33_782, 67_000), (8_416_313, 16_826_482),
                 (134_661_008, 269_223_712)):
        assert P.memory_model_bytes(n, e, cfg) == RPL.memory_model_bytes(n, e, rcfg)
        for budget in (1 << 16, 1 << 20, 10**8, 80 * 10**9):
            for kw in ({}, {"capacity": 1}, {"halo_frac": 0.6}, {"max_k": 8}):
                assert TX.choose_k(n, e, cfg, budget, **kw) == \
                    RX.choose_k(n, e, rcfg, budget, **kw), (n, e, budget, kw)


@pytest.mark.parametrize("k,partitioner", [(4, "multilevel"), (7, "bfs")])
def test_plan_from_subgraphs_identical_to_reference(k, partitioner):
    g, rg = graphs("csa", 32)
    subs = TR.extract_partitions(g, TP.PARTITIONERS[partitioner](g, k))
    rsubs = RR.extract_partitions(rg, RP.PARTITIONERS[partitioner](rg, k))
    cfg, rcfg = TG.GNNConfig(), RG.GNNConfig()
    for floors in ({}, {"min_nodes": 4096, "min_edges": 8192}):
        got = TX.plan_from_subgraphs(subs, g.num_nodes, num_edges=g.num_edges, **floors)
        want = RX.plan_from_subgraphs(rsubs, g.num_nodes, num_edges=g.num_edges, **floors)
        assert [(b.n_pad, b.e_pad) for b in got.buckets] == \
            [(b.n_pad, b.e_pad) for b in want.buckets]
        assert_same(got.bucket_of, want.bucket_of)
        assert (got.num_parts, got.num_buckets) == (want.num_parts, want.num_buckets)
        for cap in (1, 2, 3):
            assert got.peak_batch_memory_bytes(cfg, cap) == want.peak_batch_memory_bytes(rcfg, cap)


ROUTES = [
    ({"num_partitions": 4}, "csa", 12),
    ({"num_partitions": 3, "partitioner": "bfs", "regrow_hops": 2}, "booth", 6),
    ({"num_partitions": 4, "regrow": False}, "csa", 12),
    ({"memory_budget_bytes": 400_000}, "csa", 12),         # choose_k, then re-split
    ({"memory_budget_bytes": 400_000, "regrow_hops": 3}, "csa", 12),
    ({"memory_budget_bytes": 1 << 20}, "csa", 6),           # fits: mode "full"
]


@pytest.mark.parametrize("overrides,dataset,bits", ROUTES)
def test_explain_identical_to_reference(overrides, dataset, bits):
    want = RefSession(streaming=False, **overrides).explain(dataset=dataset, bits=bits)
    got = Session(device="cpu", streaming=False, **overrides).explain(dataset=dataset,
                                                                      bits=bits)
    for f in ("mode", "backend", "k", "num_buckets", "buckets", "modeled_full_bytes",
              "modeled_peak_bytes", "memory_budget_bytes", "num_nodes", "num_edges",
              "reason"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("backend", ["ref", "groot"])
def test_partitioned_verify_identical_to_reference(ref_params, backend):
    """The reference's ``groot`` runs its Pallas kernels in interpret mode."""
    kw = dict(backend=backend, streaming=False, num_partitions=4)
    want = RefSession(ref_params, **kw).verify(dataset="csa", bits=12,
                                               return_predictions=True)
    got = Session(NPZ, device="cpu", **kw).verify(dataset="csa", bits=12,
                                                  return_predictions=True)
    assert got.routing.mode == want.routing.mode == "partitioned"
    assert_same(got.predictions, want.predictions)
    assert dataclasses.asdict(got.verdict) == dataclasses.asdict(want.verdict)
    assert (got.status, got.accuracy, got.core_accuracy) == \
        (want.status, want.accuracy, want.core_accuracy)
    assert (got.peak_memory_bytes, got.unpartitioned_memory_bytes, got.boundary_edge_frac) == \
        (want.peak_memory_bytes, want.unpartitioned_memory_bytes, want.boundary_edge_frac)
    assert got.timings["partition"] > 0


@pytest.mark.parametrize("backend", ["ref", "onehot", "groot", "groot_mxu", "groot_fused"])
def test_loop_identical_to_reference_loop(backend):
    """``predict_partitioned_loop`` on one re-grown cut of a batch of two
    designs, every backend, against the reference's loop on ``ref``."""
    g, rg = graphs("booth", 6)
    from repro.core.graph import batch_graphs as ref_batch
    from repro_torch.core.graph import batch_graphs

    g, rg = batch_graphs([g, g]), ref_batch([rg, rg])
    feats = np.random.default_rng(0).standard_normal((g.num_nodes, 4)).astype(np.float32)
    subs = TR.extract_partitions(g, TP.bfs_stripe_partition(g, 5))
    rsubs = RR.extract_partitions(rg, RP.bfs_stripe_partition(rg, 5))
    params = TG.load_params(NPZ)
    want = RG.predict_partitioned_loop(jax.tree_util.tree_map(jnp.asarray, params), rsubs,
                                       feats, rg.num_nodes, "ref")
    got = TG.predict_partitioned_loop(TG.params_from_numpy(params), subs, feats,
                                      g.num_nodes, backend, device="cpu")
    assert_same(got, want)


def test_hops_at_depth_give_the_full_graph_predictions():
    """``hops >= num_layers`` makes every core node see its whole receptive
    field (``repro/core/regrowth.py``): partitioned == full graph."""
    full = Session(NPZ, device="cpu", backend="groot").verify(
        dataset="csa", bits=12, return_predictions=True)
    deep = Session(NPZ, device="cpu", backend="groot", streaming=False, num_partitions=4,
                   regrow_hops=4).verify(dataset="csa", bits=12, return_predictions=True)
    assert deep.routing.mode == "partitioned"
    assert_same(deep.predictions, full.predictions)
    assert deep.status == full.status


def test_loop_keeps_no_plan_on_the_device():
    """After the loop no subgraph plan holds a device copy and the cache
    keeps no subgraph pair; the full-graph route's cached pair is the same
    object before and after."""
    from repro_torch.kernels import ops

    g = A.make_design("csa", 10).to_edge_graph()
    full_pair = ops.make_agg_pair(g.edge_src, g.edge_dst, g.num_nodes, "groot", device="cpu")
    subs = TR.extract_partitions(g, TP.multilevel_partition(g, 4))
    feats = np.ones((g.num_nodes, 4), np.float32)
    params = TG.params_from_numpy(TG.load_params(NPZ))
    before = pc.PLAN_CACHE.snapshot()
    TG.predict_partitioned_loop(params, subs, feats, g.num_nodes, "groot", device="cpu")
    for sg in subs:
        for a, b in ((sg.edge_src, sg.edge_dst), (sg.edge_dst, sg.edge_src)):
            assert pc.cached_plan(a, b, sg.num_nodes)._device == {}
        key = ("pair", pc.graph_key(sg.edge_src, sg.edge_dst, sg.num_nodes), "groot", "cpu")
        assert key not in pc.PLAN_CACHE._data
    assert pc.PLAN_CACHE.snapshot().builds - before.builds == 3 * len(subs)
    assert ops.make_agg_pair(g.edge_src, g.edge_dst, g.num_nodes, "groot",
                             device="cpu") is full_pair
    assert full_pair.in_plan._device


def test_prepared_design_runs_under_other_backends():
    """``verify(prepared=...)`` partitions once and runs any backend."""
    sess = Session(NPZ, device="cpu", backend="groot_fused", streaming=False,
                   num_partitions=4)
    prep = sess.prepare(dataset="csa", bits=10)
    direct = sess.verify(dataset="csa", bits=10, return_predictions=True)
    for backend in ("groot_fused", "ref"):
        r = Session(NPZ, device="cpu", backend=backend, streaming=False,
                    num_partitions=4).verify(prepared=prep, return_predictions=True)
        assert r.routing.backend == backend and r.routing.mode == "partitioned"
        assert_same(r.predictions, direct.predictions)
        assert r.timings["partition"] == prep.timings["partition"]
    assert_same(P.infer(sess.params, prep, device="cpu"), direct.predictions)


def test_verify_prepared_under_streaming_raises():
    """A partitioned ``prepared`` design under a session left at
    ``streaming=True`` takes the streamed route (the loop's predictions);
    asked to shard over more devices than are visible, it raises the
    sharded executor's ``MeshConfigError``."""
    from repro_torch.launch.mesh import MeshConfigError

    prep = Session(NPZ, device="cpu", streaming=False, num_partitions=4).prepare(
        dataset="csa", bits=8)
    with pytest.raises(MeshConfigError,
                       match=r"^mesh_devices=2 out of range: 1 device\(s\) visible$"):
        Session(NPZ, device="cpu", mesh_devices=2).verify(prepared=prep)
    streamed = Session(NPZ, device="cpu").verify(prepared=prep, return_predictions=True)
    looped = Session(NPZ, device="cpu", streaming=False).verify(prepared=prep,
                                                                return_predictions=True)
    assert (streamed.routing.mode, looped.routing.mode) == ("streamed", "partitioned")
    assert_same(streamed.predictions, looped.predictions)
    full = Session(NPZ, device="cpu").prepare(dataset="csa", bits=8)
    assert Session(NPZ, device="cpu").verify(prepared=full).routing.mode == "full"


@pytest.mark.parametrize("backend", ["ref", "groot", "groot_fused"])
def test_loop_copies_each_structure_once(monkeypatch, backend):
    """Two copies of a design cut into four stripes give two structures of
    two subgraphs each: the loop copies each structure's edges and plans to
    the device once, drops them after its last subgraph, and predicts as one
    ``ref`` forward per subgraph alone does."""
    from repro_torch.core.graph import batch_graphs
    from repro_torch.kernels import groot_spmm as gs
    from repro_torch.kernels import ops

    g = A.make_design("csa", 10).to_edge_graph()
    g = batch_graphs([g, g])
    subs = TR.extract_partitions(g, TP.bfs_stripe_partition(g, 4))
    assert TG.structure_groups(subs) == [[0, 2], [1, 3]]
    feats = np.random.default_rng(1).standard_normal((g.num_nodes, 4)).astype(np.float32)
    params = TG.params_from_numpy(TG.load_params(NPZ))
    alone = np.zeros(g.num_nodes, np.int32)
    for sg in subs:
        pred = TG.predict(params, sg.to_edge_graph(), feats[sg.global_ids], "ref",
                          device="cpu")
        alone[sg.global_ids[: sg.num_core]] = pred[: sg.num_core]

    copies = {"graph": 0, "plan": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            copies[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TG, "graph_tensors", counting("graph", TG.graph_tensors))
    monkeypatch.setattr(gs.DevicePlan, "build",
                        classmethod(counting("plan", gs.DevicePlan.build.__func__)))
    order = []
    got = TG.predict_partitioned_loop(params, subs, feats, g.num_nodes, backend,
                                      device="cpu", on_partition=lambda i, sg: order.append(i))
    assert_same(got, alone)
    assert order == [0, 2, 1, 3]
    assert copies == {"graph": 2, "plan": 0 if backend == "ref" else 4}
    if backend != "ref":
        for sg in subs:
            pair = ops.make_agg_pair(sg.edge_src, sg.edge_dst, sg.num_nodes, backend,
                                     device="cpu", cache=False)
            ops.release_device(pair)
            assert pair.in_plan._device == {} and pair.out_plan._device == {}


def test_structure_groups_of_distinct_subgraphs_are_singletons():
    g = A.make_design("csa", 10).to_edge_graph()
    subs = TR.extract_partitions(g, TP.multilevel_partition(g, 4))
    assert TG.structure_groups(subs) == [[0], [1], [2], [3]]
    assert TG.structure_groups([]) == []
