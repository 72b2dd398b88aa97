"""The port's streamed route against the reference's, part 1: host arrays
and plans (packing, ``items_from_prepared``, ``build_partition_plan``, the
traffic model and ``choose_k_for_caps``, the plan cache), packed logits
against the loop's, executor stats, and the ``groot`` runner's one held
structure.  Inputs and fixtures: ``torch_stream_common.py``.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch_stream_common import *  # noqa: E402,F401,F403 — shared imports and fixtures


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
# Packed launches and the runner
# ---------------------------------------------------------------------------

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
