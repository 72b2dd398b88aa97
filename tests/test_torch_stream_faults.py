"""The port's streamed route against the reference's, part 3: the routing
decisions and verdicts of ``Session`` in mode "streamed", the budget route,
the sharded route's refusal, and the fault harness (plans, capacity halving,
the prefetch watchdog).  Inputs and fixtures: ``torch_stream_common.py``.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch_stream_common import *  # noqa: E402,F401,F403 — shared imports and fixtures


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
