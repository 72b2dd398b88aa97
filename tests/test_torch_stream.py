"""The port's streamed route against the reference's.

Packing (``service/bucketing.py``, ``exec/packing.py``), the plan's
schedule, builder and cache (``exec/plan.py``), ``choose_k_for_caps``, the
traffic model, the fault harness (``faults.py``) and the routing decisions
of ``Session`` in mode "streamed" must equal ``repro``'s on the same
designs.  Streamed predictions must equal the port's own sequential loop bit
for bit (the padding contract keeps every real row's arithmetic) and the
reference's streamed predictions (its ``groot`` kernels run in Pallas
interpret mode).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as RF  # noqa: E402
from repro.api import Session as RefSession  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core import pipeline as RPL  # noqa: E402
from repro.core.graph import EdgeGraph as RefEdgeGraph  # noqa: E402
from repro.exec import packing as RK  # noqa: E402
from repro.exec import plan as RX  # noqa: E402
from repro.exec import stream as RS  # noqa: E402
from repro.service import bucketing as RB  # noqa: E402
from repro_torch import faults as TF  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.core import aig as A  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.core import pipeline as P  # noqa: E402
from repro_torch.core import regrowth as TR  # noqa: E402
from repro_torch.core.features import groot_features  # noqa: E402
from repro_torch.core.graph import EdgeGraph, batch_graphs  # noqa: E402
from repro_torch.exec import packing as TK  # noqa: E402
from repro_torch.exec import plan as TX  # noqa: E402
from repro_torch.exec import stream as TS  # noqa: E402
from repro_torch.kernels import groot_spmm as gs  # noqa: E402
from repro_torch.kernels import plan_cache as pc  # noqa: E402
from repro_torch.service import bucketing as TB  # noqa: E402
from repro_torch.service.scheduler import BucketRunner  # noqa: E402

NPZ = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data" / "groot_csa8.npz"


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def as_ref(g: EdgeGraph) -> RefEdgeGraph:
    return RefEdgeGraph(g.num_nodes, g.edge_src, g.edge_dst, g.edge_inv, g.edge_slot)


@pytest.fixture(scope="module")
def csa12():
    d = A.make_design("csa", 12)
    return d.to_edge_graph(), groot_features(d)


@pytest.fixture(scope="module")
def params():
    return TG.load_params(NPZ)


@pytest.fixture(scope="module")
def model(params):
    return TG.params_from_numpy(params)


@pytest.fixture(scope="module")
def ref_params(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module")
def subgraphs(csa12):
    g, _ = csa12
    return TR.extract_partitions(g, TP.multilevel_partition(g, 4))


@pytest.fixture(scope="module")
def ref_streamed(csa12, subgraphs, ref_params):
    """The reference's streamed predictions at csa-12 k=4, one run per
    (backend, capacity), computed on first use."""
    g, feats = csa12
    rsubs = RX.build_partition_plan(as_ref(g), 4, use_cache=False).subgraphs
    runs = {}

    def get(backend, capacity):
        if (backend, capacity) not in runs:
            runs[backend, capacity] = RS.StreamingExecutor(
                ref_params, backend, capacity=capacity, prefetch=0,
            ).run_subgraphs(list(rsubs), feats, g.num_nodes)
        return runs[backend, capacity]

    return get


# ---------------------------------------------------------------------------
# Host arrays and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [1, 2, 3])
def test_pack_batch_identical_to_reference(csa12, subgraphs, capacity):
    """Work items, packed arrays (real slots and all-padding ones), the
    unpacked predictions and the scatter equal the reference's."""
    g, feats = csa12
    plan = TX.plan_from_subgraphs(subgraphs, g.num_nodes)
    rplan = RX.plan_from_subgraphs(subgraphs, g.num_nodes)
    for shape, indices in plan.schedule(capacity):
        rshape = RB.BucketShape(shape.n_pad, shape.e_pad)
        got = TK.pack_partitions(plan, indices, feats, shape, capacity, keyed=True)
        want = RK.pack_partitions(rplan, indices, feats, rshape, capacity)
        assert got.arrays.keys() == want.arrays.keys() and got.nbytes == want.nbytes
        for k, v in want.arrays.items():
            if isinstance(v, np.ndarray):
                assert_same(got.arrays[k], v)
            else:
                assert got.arrays[k] == v
        assert got.gkeys == pc.structure_keys(got.arrays["edge_src"], got.arrays["edge_dst"],
                                              got.arrays["num_nodes"])
        pred = np.arange(got.arrays["num_nodes"], dtype=np.int32) % 5
        for a, b in zip(TB.unpack_predictions(pred, got.items, shape),
                        RB.unpack_predictions(pred, want.items, rshape)):
            assert_same(a, b)
        out, rout = np.zeros(g.num_nodes, np.int32), np.zeros(g.num_nodes, np.int32)
        assert TK.scatter_core_predictions(out, got, pred) == \
            RK.scatter_core_predictions(rout, want, pred)
        assert_same(out, rout)
    dummy, rdummy = TB.dummy_item(4), RB.dummy_item(4)
    shape = TB.BucketShape(64, 128)
    got = TB.pack_batch([dummy], shape, capacity)
    for k, v in RB.pack_batch([rdummy], RB.BucketShape(64, 128), capacity).items():
        if isinstance(v, np.ndarray):
            assert_same(got[k], v)
        else:
            assert got[k] == v
    assert dummy.bucket() == shape and shape.total(capacity) == (64 * capacity, 128 * capacity)


def test_items_from_prepared_identical_to_reference():
    for kw in ({}, {"num_partitions": 3}):
        prep = P.prepare(P.PipelineConfig(dataset="csa", bits=8, **kw))
        rprep = RPL.prepare(RPL.PipelineConfig(dataset="csa", bits=8, **kw))
        got, want = TB.items_from_prepared(7, prep), RB.items_from_prepared(7, rprep)
        assert len(got) == len(want) == (kw.get("num_partitions") or 1)
        for a, b in zip(got, want):
            assert (a.req_id, a.part_index, a.num_core, a.num_nodes, a.num_edges) == \
                (b.req_id, b.part_index, b.num_core, b.num_nodes, b.num_edges)
            assert (a.bucket().n_pad, a.bucket().e_pad) == (b.bucket().n_pad, b.bucket().e_pad)
            for f in ("feats", "edge_src", "edge_dst", "edge_inv", "edge_slot", "global_ids"):
                assert_same(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("k,partitioner,floors", [
    (4, "multilevel", {}),
    (8, "multilevel", {"min_nodes": 256, "min_edges": 512}),
    (7, "bfs", {}),
])
def test_build_partition_plan_identical_to_reference(csa12, k, partitioner, floors):
    """Subgraphs, buckets, schedule, boundary fraction, modeled peak and
    traffic of the built plan equal the reference's."""
    g, _ = csa12
    got = TX.build_partition_plan(g, k, partitioner=partitioner, seed=1, use_cache=False,
                                  **floors)
    want = RX.build_partition_plan(as_ref(g), k, partitioner=partitioner, seed=1,
                                   use_cache=False, **floors)
    assert (got.k, got.num_parts, got.num_buckets, got.boundary_edge_frac) == \
        (want.k, want.num_parts, want.num_buckets, want.boundary_edge_frac)
    assert [(b.n_pad, b.e_pad) for b in got.buckets] == [(b.n_pad, b.e_pad) for b in want.buckets]
    assert_same(got.bucket_of, want.bucket_of)
    for a, b in zip(got.subgraphs, want.subgraphs):
        assert a.num_core == b.num_core
        for f in ("global_ids", "edge_src", "edge_dst", "edge_inv", "edge_slot"):
            assert_same(getattr(a, f), getattr(b, f))
    cfg = TG.GNNConfig()
    rcfg = RG.GNNConfig()
    for cap in (1, 2, 3):
        assert [((s.n_pad, s.e_pad), ix) for s, ix in got.schedule(cap)] == \
            [((s.n_pad, s.e_pad), ix) for s, ix in want.schedule(cap)]
        assert got.peak_batch_memory_bytes(cfg, cap) == want.peak_batch_memory_bytes(rcfg, cap)
        for kw in ({}, {"hoisted": False}, {"stream_dtype": "bfloat16"}):
            assert got.peak_layer_traffic_bytes(cfg, cap, **kw) == \
                want.peak_layer_traffic_bytes(rcfg, cap, **kw)


def test_traffic_model_and_choose_k_for_caps_identical_to_reference():
    cfg, rcfg = TG.GNNConfig(), RG.GNNConfig()
    for n, e in ((0, 0), (1, 0), (1165, 2258), (8_416_313, 16_826_482),
                 (134_661_008, 269_223_712)):
        for kw in ({}, {"hoisted": False, "segments_in": 6}, {"slots_in": 4096},
                   {"stream_dtype": "bfloat16", "slots_out": 100}):
            assert P.layer_traffic_model_bytes(n, e, cfg, **kw) == \
                RPL.layer_traffic_model_bytes(n, e, rcfg, **kw), (n, e, kw)
        for caps in ((64,), (16_384,), (1 << 20, 1 << 21), (1 << 22, None)):
            for kw in ({}, {"halo_frac": 0.5}, {"min_nodes": 1024}):
                assert TX.choose_k_for_caps(n, e, *caps, **kw) == \
                    RX.choose_k_for_caps(n, e, *caps, **kw), (n, e, caps, kw)


def test_plan_cache_returns_the_same_plan_and_keys_annotations(csa12):
    """A second build is the cached object; the key separates designs that
    differ only in inverter placement (the subgraphs embed the slices)."""
    g, _ = csa12
    p1 = TX.build_partition_plan(g, 4, seed=0)
    before = TX.EXEC_PLAN_CACHE.snapshot()
    assert TX.build_partition_plan(g, 4, seed=0) is p1
    after = TX.EXEC_PLAN_CACHE.snapshot()
    assert (after.builds, after.hits) == (before.builds, before.hits + 1)
    assert TX.build_partition_plan(g, 4, seed=1) is not p1
    ga = EdgeGraph(g.num_nodes, g.edge_src, g.edge_dst, np.zeros(g.num_edges, bool), g.edge_slot)
    gb = EdgeGraph(g.num_nodes, g.edge_src, g.edge_dst, np.ones(g.num_edges, bool), g.edge_slot)
    assert TX._annotation_key(ga) == RX._annotation_key(as_ref(ga))
    assert TX._annotation_key(ga) != TX._annotation_key(gb)
    pa, pb = TX.build_partition_plan(ga, 4), TX.build_partition_plan(gb, 4)
    assert pa is not pb
    assert not pa.subgraphs[0].edge_inv.any() and pb.subgraphs[0].edge_inv.all()


# ---------------------------------------------------------------------------
# Streamed predictions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 1])
@pytest.mark.parametrize("capacity", [1, 2, 3])
@pytest.mark.parametrize("backend", ["ref", "groot"])
def test_stream_equals_loop_and_reference(csa12, subgraphs, model, ref_streamed, backend,
                                          capacity, prefetch):
    """``stream_predict_partitioned`` equals the port's sequential loop bit
    for bit and the reference's streamed run."""
    g, feats = csa12
    got = TS.stream_predict_partitioned(model, subgraphs, feats, g.num_nodes, backend,
                                        capacity=capacity, prefetch=prefetch, device="cpu")
    loop = TG.predict_partitioned_loop(model, subgraphs, feats, g.num_nodes, backend,
                                       device="cpu")
    assert_same(got, loop)
    assert_same(got, ref_streamed(backend, capacity))


@pytest.mark.parametrize("backend", ["ref", "groot", "groot_fused"])
def test_packed_logits_equal_the_loops_bit_for_bit(csa12, subgraphs, model, backend):
    """The padding contract: a packed launch's core-row logits are the
    loop's, bit for bit, on the plain versions."""
    from repro_torch.kernels import ops

    g, feats = csa12
    plan = TX.plan_from_subgraphs(subgraphs, g.num_nodes)

    def logits(graph, x):
        agg = None if backend == "ref" else ops.make_agg_pair(
            graph.edge_src, graph.edge_dst, graph.num_nodes, backend, device="cpu", cache=False)
        return TG.forward(model, torch.as_tensor(x), *TG.graph_tensors(graph, "cpu"),
                          num_nodes=graph.num_nodes, agg=agg)

    for shape, indices in plan.schedule(2):
        arr = TK.pack_partitions(plan, indices, feats, shape, 2).arrays
        packed = logits(EdgeGraph(arr["num_nodes"], arr["edge_src"], arr["edge_dst"],
                                  arr["edge_inv"], arr["edge_slot"]), arr["x"])
        for k, i in enumerate(indices):
            sg = subgraphs[i]
            alone = logits(sg.to_edge_graph(), feats[sg.global_ids])
            rows = packed[k * shape.n_pad:k * shape.n_pad + sg.num_core]
            assert torch.equal(rows, alone[:sg.num_core])


@pytest.mark.parametrize("backend", ["onehot", "groot_mxu", "groot_fused"])
def test_stream_equals_loop_on_the_other_backends(csa12, subgraphs, model, backend):
    g, feats = csa12
    assert_same(TS.stream_predict_partitioned(model, subgraphs, feats, g.num_nodes, backend,
                                              device="cpu"),
                TG.predict_partitioned_loop(model, subgraphs, feats, g.num_nodes, backend,
                                            device="cpu"))


def test_predict_partitioned_shim_warns_and_routes(csa12, subgraphs, model):
    g, feats = csa12
    loop = TG.predict_partitioned_loop(model, subgraphs, feats, g.num_nodes, "groot",
                                       device="cpu")
    for streaming in (True, False):
        with pytest.warns(DeprecationWarning, match="predict_partitioned is deprecated"):
            got = TG.predict_partitioned(model, subgraphs, feats, g.num_nodes, "groot",
                                         streaming=streaming, device="cpu")
        assert_same(got, loop)


@pytest.mark.parametrize("backend", ["ref", "groot"])
def test_stats_identical_to_reference(csa12, model, ref_params, backend):
    """The executor's deterministic probes equal the reference's for the
    same plan: batches, launches, partitions, core rows, staged bytes and
    the modeled and actual peaks; compiles on ``ref`` (one a packed
    signature, what the reference traces)."""
    g, feats = csa12
    prep = P.prepare(P.PipelineConfig(dataset="csa", bits=12, num_partitions=6,
                                      backend=backend))
    rprep = RPL.prepare(RPL.PipelineConfig(dataset="csa", bits=12, num_partitions=6,
                                           backend=backend))
    ex = TS.StreamingExecutor(model, backend, capacity=3, prefetch=2, device="cpu")
    pred, got = P.infer_streaming(model, prep, executor=ex)
    rex = RS.StreamingExecutor(ref_params, backend, capacity=3, prefetch=2)
    rpred, want = RPL.infer_streaming(ref_params, rprep, executor=rex)
    assert_same(pred, rpred)
    keys = ["runs", "batches", "partitions", "core_rows", "launches", "bytes_h2d",
            "capacity_halvings", "resumed_partitions", "modeled_peak_bytes",
            "actual_peak_bytes", "peak_packed_memory_bytes", "num_buckets", "chosen_k",
            "model_drift"] + (["compiles"] if backend == "ref" else [])
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["core_rows"] == g.num_nodes and got["pack_s"] > 0 and got["device_s"] > 0
    stats = ex.stats
    assert stats.overlap_s == max(0.0, stats.pack_s + stats.device_s - stats.wall_s)
    again = P.infer_streaming(model, prep, executor=ex)[1]
    assert again["compiles"] == 0 and again["runs"] == 1 and again["max_queue_depth"] >= 0


def test_groot_runner_holds_one_structure(model):
    """Two copies of csa-10 in four stripes pack (capacity 2) into two
    batches of one structure: the runner copies that structure to the
    device once, builds its plans once (0 builds when the run recurs) and
    holds nothing after the run."""
    from repro_torch.kernels import ops

    g = A.make_design("csa", 10).to_edge_graph()
    g2 = batch_graphs([g, g])
    feats = np.random.default_rng(3).standard_normal((g2.num_nodes, 4)).astype(np.float32)
    subs = TR.extract_partitions(g2, TP.bfs_stripe_partition(g2, 4))
    plan = TX.plan_from_subgraphs(subs, g2.num_nodes)
    assert plan.num_buckets == 1 and [ix for _, ix in plan.schedule(2)] == [[0, 1], [2, 3]]
    runner = BucketRunner(model, "groot", device="cpu")
    ex = TS.StreamingExecutor(runner=runner, capacity=2)
    copies = {"plans": 0, "released": 0}
    build, release = gs.DevicePlan.build.__func__, ops.release_device

    def counting_build(cls, *a, **kw):
        copies["plans"] += 1
        return build(cls, *a, **kw)

    def counting_release(pair):
        copies["released"] += 1
        return release(pair)

    mp = pytest.MonkeyPatch()
    mp.setattr(gs.DevicePlan, "build", classmethod(counting_build))
    mp.setattr(ops, "release_device", counting_release)
    try:
        first = ex.run_plan(plan, feats)
        assert copies == {"plans": 2, "released": 1} and runner._held is None
        assert ex.stats.compiles == 3                  # fanin, fanout, forward plans
        again = ex.run_plan(plan, feats)
        assert ex.stats.compiles == 3 and copies == {"plans": 4, "released": 2}
    finally:
        mp.undo()
    assert_same(again, first)
    assert_same(first, TG.predict_partitioned_loop(model, subs, feats, g2.num_nodes, "groot",
                                                   device="cpu"))
    gkeys = TK.pack_partitions(plan, [0, 1], feats, plan.buckets[0], 2, keyed=True).gkeys
    for key in gkeys:
        assert pc.PLAN_CACHE.peek(("plan", key, gs.E_T))._device == {}


# ---------------------------------------------------------------------------
# Session: mode "streamed"
# ---------------------------------------------------------------------------

DECISION_FIELDS = ("mode", "backend", "stream_dtype", "k", "num_buckets", "buckets",
                   "modeled_full_bytes", "modeled_peak_bytes", "memory_budget_bytes",
                   "num_nodes", "num_edges", "reason")


@pytest.mark.parametrize("backend", ["ref", "groot"])
def test_streamed_verify_identical_to_reference(ref_params, backend):
    """Default ``streaming=True`` with a partition count: the routing
    decision, predictions, verdict and accuracy equal the reference's;
    ``explain()`` gives the decision ``verify`` took."""
    kw = dict(backend=backend, num_partitions=4)
    want = RefSession(ref_params, **kw).verify(dataset="csa", bits=12, use_cache=False,
                                               return_predictions=True)
    sess = Session(NPZ, device="cpu", **kw)
    got = sess.verify(dataset="csa", bits=12, return_predictions=True)
    assert got.routing.mode == want.routing.mode == "streamed"
    for f in DECISION_FIELDS:
        assert getattr(got.routing, f) == getattr(want.routing, f), f
    assert sess.explain(dataset="csa", bits=12) == got.routing
    assert_same(got.predictions, want.predictions)
    assert dataclasses.asdict(got.verdict) == dataclasses.asdict(want.verdict)
    assert (got.status, got.accuracy, got.core_accuracy, got.peak_memory_bytes) == \
        (want.status, want.accuracy, want.core_accuracy, want.peak_memory_bytes)
    for k in ("launches", "partitions", "core_rows", "peak_packed_memory_bytes", "chosen_k"):
        assert got.exec_stats[k] == want.exec_stats[k], k
    loop = Session(NPZ, device="cpu", streaming=False, **kw).verify(
        dataset="csa", bits=12, return_predictions=True)
    assert_same(got.predictions, loop.predictions)


STREAMED_ROUTES = [
    ({"num_partitions": 3, "partitioner": "bfs", "regrow_hops": 2}, "booth", 6),
    ({"num_partitions": 4, "stream_capacity": 3, "min_nodes": 512}, "csa", 12),
    ({"memory_budget_bytes": 400_000}, "csa", 12),          # choose_k, then re-split
    ({"memory_budget_bytes": 400_000, "regrow_hops": 3}, "csa", 12),
    ({"memory_budget_bytes": 2_000_000}, "csa", 24),
    ({"memory_budget_bytes": 1 << 20}, "csa", 6),           # fits: mode "full"
]


@pytest.mark.parametrize("overrides,dataset,bits", STREAMED_ROUTES)
def test_streamed_explain_identical_to_reference(overrides, dataset, bits):
    """The budget route picks mode "streamed" (or "full" where the design
    fits) and the same k, buckets and modeled peak as the reference."""
    want = RefSession(mesh_devices=1, **overrides).explain(dataset=dataset, bits=bits)
    got = Session(device="cpu", **overrides).explain(dataset=dataset, bits=bits)
    for f in DECISION_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def test_budget_route_verifies_through_the_stream(ref_params):
    """A budget of half the full graph's modeled bytes: mode "streamed", the
    packed peak under the budget, and the reference's partitioned loop's
    predictions on the same cut."""
    full = Session(device="cpu").explain(dataset="csa", bits=16).modeled_full_bytes
    sess = Session(NPZ, device="cpu", memory_budget_bytes=full // 2)
    prep = sess.prepare(dataset="csa", bits=16)
    r = sess.verify(prepared=prep, return_predictions=True)
    assert r.routing.mode == "streamed" and r.routing.k > 1
    assert r.exec_stats["peak_packed_memory_bytes"] <= full // 2
    from repro.core import regrowth as RR

    rsubs = [RR.Subgraph(sg.global_ids, sg.num_core, sg.edge_src, sg.edge_dst, sg.edge_inv,
                         sg.edge_slot) for sg in prep.subgraphs]
    want = RG.predict_partitioned_loop(ref_params, rsubs, prep.feats, prep.num_nodes, "ref")
    assert_same(r.predictions, want)


def test_sharded_route_raises():
    with pytest.raises(NotImplementedError, match="sharded route"):
        Session(NPZ, device="cpu", num_partitions=4, mesh_devices=2).verify(dataset="csa",
                                                                          bits=8)
    prep = Session(device="cpu", num_partitions=4).prepare(dataset="csa", bits=8)
    with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
        P.infer_streaming(TG.params_from_numpy(TG.load_params(NPZ)),
                          dataclasses.replace(prep, cfg=dataclasses.replace(
                              prep.cfg, mesh_devices=4)), device="cpu")
    assert P.resolve_mesh_devices(None, "cpu") == 1


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------

SPECS = [
    "exec.launch:nth=2,kind=resource",
    "exec.prefetch:p=0.3,kind=transient,seed=7;exec.launch:every=3,match=parts=2,kind=fatal",
    "service.device:max_fires=2,latency=0.0,kind=latency",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plans_identical_to_reference(spec):
    """The same spec parses, prints and fires on the same calls."""
    got, want = TF.FaultPlan.parse(spec), RF.FaultPlan.parse(spec)
    assert got.to_spec() == want.to_spec() and got.seed == want.seed
    assert [dataclasses.asdict(s) for s in got.specs] == [dataclasses.asdict(s) for s in want.specs]
    fires = []
    for mod, plan in ((TF, got), (RF, want)):
        inj, seen = mod.FaultInjector(plan), []
        for i in range(40):
            site = plan.specs[i % len(plan.specs)].site
            try:
                inj.check(site, tag=f"parts={1 + i % 2}")
                seen.append(None)
            except BaseException as e:  # noqa: BLE001 — the injected kind is compared
                seen.append(type(e).__name__)
        fires.append((seen, inj.stats()))
    assert fires[0] == fires[1]
    with pytest.raises(ValueError, match="unknown fault site"):
        TF.FaultPlan.parse("exec.nowhere:p=1")


def test_is_resource_error_classifies_cuda_oom():
    assert TF.is_resource_error(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                                            "allocate 2.00 GiB"))
    assert TF.is_resource_error(RuntimeError("CUDA out of memory."))
    assert TF.is_resource_error(TF.ResourceFault("injected"))
    assert TF.is_resource_error(MemoryError())
    assert TF.is_resource_error(RuntimeError("RESOURCE_EXHAUSTED: Out of memory"))
    assert not TF.is_resource_error(RuntimeError("CUDA error: an illegal memory access"))
    assert not TF.is_resource_error(ValueError("shape"))


@pytest.mark.parametrize("prefetch", [0, 1])
def test_resource_error_halves_capacity_bit_exact(csa12, subgraphs, model, prefetch):
    g, feats = csa12
    plan = TX.plan_from_subgraphs(subgraphs, g.num_nodes)
    want = TS.StreamingExecutor(model, "groot", capacity=2, prefetch=prefetch,
                                device="cpu").run_plan(plan, feats)
    assert any(len(ix) > 1 for _, ix in plan.schedule(2))
    ex = TS.StreamingExecutor(model, "groot", capacity=2, prefetch=prefetch, device="cpu")
    with TF.injected("exec.launch:nth=1,kind=resource"):
        got = ex.run_plan(plan, feats)
    assert_same(got, want)
    assert ex.stats.capacity_halvings == 1 and ex.stats.launches == plan.num_parts
    with TF.injected("exec.launch:every=1,kind=resource"):
        with pytest.raises(TF.ResourceFault):
            TS.StreamingExecutor(model, "ref", capacity=2, prefetch=prefetch,
                                 device="cpu").run_plan(plan, feats)


def test_halving_beside_the_prefetch_thread_loses_no_update(csa12, model):
    """After a halving the caller's thread repacks while the prefetch thread
    still packs: with the interpreter switching threads every microsecond,
    the staged bytes still add up to every batch each thread packed, and
    the predictions stay the loop's."""
    import sys

    g, feats = csa12
    plan = TX.build_partition_plan(g, 16)
    sched = plan.schedule(2)
    pairs = [(shape, ix) for shape, ix in sched if len(ix) == 2]
    assert len(pairs) >= 4
    # every batch packed at capacity 2, then each pair's parts repacked alone
    want = sum(TK.pack_partitions(plan, ix, feats, shape, 2).nbytes for shape, ix in sched)
    want += sum(TK.pack_partitions(plan, [i], feats, shape, 1).nbytes
                for shape, ix in pairs for i in ix)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            ex = TS.StreamingExecutor(model, "ref", capacity=2, prefetch=3, device="cpu")
            with TF.injected("exec.launch:nth=1,match=parts=2,kind=resource"):
                got = ex.run_plan(plan, feats)
            assert ex.stats.bytes_h2d == want and ex.stats.capacity_halvings == 1
            assert ex.stats.launches == plan.num_parts
            assert_same(got, TG.predict_partitioned_loop(model, plan.subgraphs, feats,
                                                         g.num_nodes, "ref", device="cpu"))
    finally:
        sys.setswitchinterval(interval)


def test_prefetch_death_trips_the_watchdog(csa12, model):
    import time

    g, feats = csa12
    plan = TX.build_partition_plan(g, 6)
    assert len(plan.schedule(1)) > 1
    ex = TS.StreamingExecutor(model, "ref", capacity=1, prefetch=1, device="cpu")
    with TF.injected("exec.prefetch:nth=2,kind=kill"):
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="prefetch thread died"):
            ex.run_plan(plan, feats)
        assert time.perf_counter() - t0 < 30.0
    with TF.injected("exec.prefetch:nth=2,kind=fatal"):
        with pytest.raises(TF.FatalFault):
            ex.run_plan(plan, feats)
    with pytest.raises(Exception):                     # too few feature rows to pack
        ex.run_plan(plan, np.zeros((3, 4), np.float32))
