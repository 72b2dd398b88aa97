"""The port's sharded route (``repro_torch.mesh``, mode "sharded") against
the reference's (``repro.mesh``) on the CPU.

The reference fakes devices with ``XLA_FLAGS``; the port names its lanes
(``MeshRunner(devices=["cpu"] * D)``) or stands in for the visible devices
(``repro_torch.launch.mesh.visible_devices``).  Held here: the host mesh's
errors; ``build_mesh_plan`` wave for wave; sharded predictions bit-equal to
the reference's single-device stream on every backend, lane count and
prefetch depth; the compile probe; resume under another lane count after a
fatal fault; a transient fault retried on its lane alone; the prefetch
watchdog; ``Session``'s mode "sharded" field for field; and per-device
release of a plan's device copies.  Inputs and fixtures:
``torch_stream_common.py``.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch_stream_common import *  # noqa: E402,F401,F403 — shared imports and fixtures

from repro import mesh as RM  # noqa: E402
from repro.launch import mesh as RLM  # noqa: E402
from repro_torch import mesh as TM  # noqa: E402
from repro_torch.checkpoint import PartitionJournal  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as TLM  # noqa: E402
from repro_torch.obs import REGISTRY  # noqa: E402

CPU = torch.device("cpu")


def sharded(model, backend, d, **kw):
    """A fresh executor over ``d`` CPU lanes (every probe starts at 0)."""
    runner = TM.MeshRunner(model, backend, devices=[CPU] * d)
    return TM.ShardedStreamingExecutor(runner=runner, **kw)


def waves(mp):
    return [((w.shape.n_pad, w.shape.e_pad), w.lanes) for w in mp.waves]


@pytest.fixture(scope="module")
def csa16():
    d = A.make_design("csa", 16)
    g = d.to_edge_graph()
    return g, groot_features(d), TX.build_partition_plan(g, 8, use_cache=False)


@pytest.fixture(scope="module")
def csa16_ref_stream(csa16, ref_params):
    """The reference's single-device ``ref`` stream of csa-16 k=8."""
    g, feats, _ = csa16
    rplan = RX.build_partition_plan(as_ref(g), 8, use_cache=False)
    return RS.StreamingExecutor(ref_params, "ref", capacity=2).run_plan(rplan, feats)


# -- the host mesh ------------------------------------------------------------

@pytest.mark.parametrize("model_axis,data", [(3, None), (1, 0), (1, 2), (0, None)])
def test_make_host_mesh_errors_equal_the_reference(model_axis, data):
    """One visible device on both sides: the same refusals, word for word."""
    with pytest.raises(RLM.MeshConfigError) as want:
        RLM.make_host_mesh(model_axis, data=data)
    with pytest.raises(TLM.MeshConfigError) as got:
        TLM.make_host_mesh(model_axis, data=data, device="cpu")
    assert str(got.value) == str(want.value)
    assert issubclass(TLM.MeshConfigError, ValueError)


def test_make_host_mesh_data_cap(monkeypatch):
    m = TLM.make_host_mesh(data=1, device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.devices[0, 0] == CPU
    assert TLM.visible_devices("cpu") == [CPU]
    monkeypatch.setattr(TLM, "visible_devices", lambda device=None: [CPU] * 8)
    m = TLM.make_host_mesh(2, data=3, device="cpu")
    assert m.shape == {"data": 3, "model": 2} and m.axis_names == ("data", "model")
    with pytest.raises(TLM.MeshConfigError, match="admit at most 4 data shards"):
        TLM.make_host_mesh(2, data=5, device="cpu")


def test_mesh_runner_refuses_more_devices_than_visible(model):
    with pytest.raises(TLM.MeshConfigError,
                       match=r"^mesh_devices=2 out of range: 1 device\(s\) visible$"):
        TM.MeshRunner(model, "ref", num_devices=2, device="cpu")
    with pytest.raises(TLM.MeshConfigError, match="does not match"):
        TM.MeshRunner(model, "ref", num_devices=3, devices=[CPU, CPU])
    with pytest.raises(ValueError, match="mesh backend"):
        TM.MeshRunner(model, "nosuch", devices=[CPU])
    r = TM.MeshRunner(model, "ref", device="cpu")
    assert r.num_devices == 1 and r.devices == [CPU]
    # the lanes hold copies: the caller's module is never moved or shared
    assert all(lane.params is not model for lane in r._lanes)


# -- MeshPlan -----------------------------------------------------------------

@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("devices", [1, 2, 3, 4])
def test_build_mesh_plan_identical_to_reference(csa16, devices, k, filtered):
    g, _, _ = csa16
    plan = TX.build_partition_plan(g, k, use_cache=False)
    rplan = RX.build_partition_plan(as_ref(g), k, use_cache=False)
    schedule = rschedule = None
    if filtered:
        # the partitions a resumed journal would have restored
        done = {0, 1, 2}

        def keep(s):
            return [(shape, kept) for shape, ix in s
                    if (kept := [i for i in ix if i not in done])]

        schedule, rschedule = keep(plan.schedule(2)), keep(rplan.schedule(2))
    got = TM.build_mesh_plan(plan, devices, 2, schedule=schedule)
    want = RM.build_mesh_plan(rplan, devices, 2, schedule=rschedule)
    assert waves(got) == waves(want)
    assert got.lane_batches == want.lane_batches
    assert got.utilization == want.utilization
    assert got.modeled_speedup == want.modeled_speedup
    assert got.describe() == want.describe()
    assert (got.total_batches, got.num_buckets) == (want.total_batches, want.num_buckets)
    assert got.per_device_peak_bytes(TG.GNNConfig()) == want.per_device_peak_bytes(RG.GNNConfig())


def test_build_mesh_plan_rejects_zero_devices(csa16):
    with pytest.raises(ValueError, match="at least one device"):
        TM.build_mesh_plan(csa16[2], 0, 2)


# -- predictions ----------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 1])
@pytest.mark.parametrize("devices", [1, 2, 4])
@pytest.mark.parametrize("backend", ["ref", "onehot", "groot", "groot_mxu", "groot_fused"])
def test_sharded_equals_reference_stream(csa12, subgraphs, model, ref_streamed, backend,
                                         devices, prefetch):
    """csa-12 cut 4 ways: two packed batches of one bucket, so two lanes
    share one wave; every lane count gives the reference's single-device
    streamed predictions bit for bit (its ``groot*`` kernels in Pallas
    interpret mode)."""
    g, feats = csa12
    plan = TX.plan_from_subgraphs(list(subgraphs), g.num_nodes)
    ex = sharded(model, backend, devices, capacity=2, prefetch=prefetch)
    got = ex.run_plan(plan, feats, gnn_cfg=TG.GNNConfig())
    assert_same(got, ref_streamed(backend, 2))
    mp = TM.build_mesh_plan(plan, devices, 2)
    st = ex.stats
    assert (st.devices, st.waves, st.lane_launches) == (devices, len(mp.waves), mp.total_batches)
    assert st.partitions == plan.num_parts
    assert st.idle_lane_slots == sum(devices - w.active for w in mp.waves)
    assert ex.runner.run_count == len(mp.waves)
    assert ex.runner.lane_run_count == mp.total_batches


@pytest.mark.parametrize("backend", ["ref", "onehot", "groot", "groot_mxu", "groot_fused"])
def test_compile_probe_is_shared_by_the_lanes(csa12, model, backend):
    """First sights are counted across the lanes together: the count at 2
    and 4 lanes equals one lane's, and on the shape-stable backends it
    stays within the bucket count (the reference's pmap traces once for all
    lanes); the stats' delta view is the single-device executor's."""
    g, feats = csa12
    plan = TX.build_partition_plan(g, 8, use_cache=False)
    counts = {}
    for devices in (1, 2, 4):
        ex = sharded(model, backend, devices, capacity=2)
        before = dataclasses.replace(ex.stats)
        ex.run_plan(plan, feats)
        counts[devices] = ex.stats.compiles
        delta = dataclasses.asdict(ex.stats.delta(before))
        assert delta["runs"] == 1 and delta["lane_launches"] == delta["launches"]
        assert delta["devices"] == devices
    assert counts[2] == counts[4] == counts[1] > 0
    if backend in ("ref", "onehot"):
        assert counts[1] <= plan.num_buckets


def test_lanes_share_the_probes_under_thread_switching(csa16, model):
    """Eight lanes with their eight prefetch threads, the interpreter made to
    switch threads every microsecond: no update of the shared probes is
    lost (bytes packed, first sights, lane launches)."""
    import sys

    g, feats, plan = csa16
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ex = sharded(model, "groot", 8, capacity=1, prefetch=2)
        out = ex.run_plan(plan, feats)
    finally:
        sys.setswitchinterval(interval)
    want = TS.StreamingExecutor(model, "groot", capacity=1, prefetch=0,
                                device="cpu").run_plan(plan, feats)
    assert_same(out, want)
    schedule = plan.schedule(1)
    packed = [TK.pack_partitions(plan, ix, feats, shape, 1, keyed=True)
              for shape, ix in schedule]
    assert ex.stats.bytes_h2d == sum(b.nbytes for b in packed)
    assert ex.runner.compile_count == len({b.gkeys for b in packed})
    assert ex.stats.lane_launches == ex.runner.lane_run_count == len(schedule)



def test_instruments_under_the_references_names(csa12, model):
    """The per-lane counters, histograms, gauges and spans carry the
    reference's names; the prefetch threads' pack spans parent under the
    run's stream span."""
    from repro_torch.obs import Tracer

    g, feats = csa12
    plan = TX.build_partition_plan(g, 8, use_cache=False)
    mp = TM.build_mesh_plan(plan, 2, 2)
    names = ("mesh.launches.d0", "mesh.launches.d1", "mesh.bytes_h2d.d0",
             "mesh.bytes_h2d.d1", "mesh.runner_compiles")
    before = {n: REGISTRY.counter(n).value for n in names}
    hists = {n: REGISTRY.histogram(n).count for n in ("mesh.pack_s", "mesh.device_s")}
    ex = sharded(model, "ref", 2, capacity=2, prefetch=1)
    tracer = Tracer()
    with tracer.activate():
        ex.run_plan(plan, feats)
    got = {n: REGISTRY.counter(n).value - before[n] for n in names}
    assert (got["mesh.launches.d0"], got["mesh.launches.d1"]) == mp.lane_batches
    assert got["mesh.bytes_h2d.d0"] > 0 and got["mesh.bytes_h2d.d1"] > 0
    assert got["mesh.runner_compiles"] == ex.runner.compile_count > 0
    assert REGISTRY.histogram("mesh.pack_s").count - hists["mesh.pack_s"] == mp.total_batches
    assert REGISTRY.histogram("mesh.device_s").count - hists["mesh.device_s"] == len(mp.waves)
    for d, util in enumerate(mp.utilization):
        assert REGISTRY.gauge(f"exec.device_utilization.d{d}").value == util
    spans = tracer.spans()
    (stream,) = [sp for sp in spans if sp.name == "mesh.stream"]
    packs = [sp for sp in spans if sp.name == "mesh.pack"]
    assert len(packs) == mp.total_batches
    assert all(sp.parent_id == stream.span_id for sp in packs)
    assert len([sp for sp in spans if sp.name == "mesh.launch"]) == len(mp.waves)


# -- failure domains --------------------------------------------------------------

def test_resume_after_a_fatal_fault_under_another_lane_count(csa16, model, csa16_ref_stream,
                                                              tmp_path):
    """A fatal fault at the third lane launch kills a 4-lane run; a 2-lane
    run restores what it committed, runs only the rest, and clears the
    journal (``tests/test_mesh.py``'s resume case)."""
    g, feats, plan = csa16
    ex = sharded(model, "ref", 4, capacity=2, launch_retries=0)
    with TF.injected("mesh.launch:nth=3,kind=fatal"):
        with pytest.raises(TF.FatalFault):
            ex.run_plan(plan, feats, journal=PartitionJournal(tmp_path, "t"))
    committed = PartitionJournal(tmp_path, "t").open(plan)
    assert committed and len(committed) < plan.num_parts
    journal = PartitionJournal(tmp_path, "t")
    ex2 = sharded(model, "ref", 2, capacity=2)
    assert_same(ex2.run_plan(plan, feats, journal=journal), csa16_ref_stream)
    assert ex2.stats.resumed_partitions == len(committed)
    assert ex2.stats.partitions == plan.num_parts - len(committed)
    assert not journal.open(plan)


def test_transient_on_one_lane_is_retried_alone(csa16, model, csa16_ref_stream):
    g, feats, plan = csa16
    ex = sharded(model, "ref", 4, capacity=2, launch_retries=2, retry_backoff_s=0.01)
    mp = TM.build_mesh_plan(plan, 4, 2)
    with TF.injected("mesh.launch:nth=2,kind=transient,max_fires=1"):
        assert_same(ex.run_plan(plan, feats), csa16_ref_stream)
    assert ex.stats.lane_retries == 1
    # no sibling batch re-packed or re-run: one launch per scheduled batch
    assert ex.stats.lane_launches == ex.stats.batches == mp.total_batches
    assert ex.runner.lane_run_count == mp.total_batches


def test_prefetch_thread_death_is_caught_by_the_watchdog(csa12, model):
    g, feats = csa12
    plan = TX.build_partition_plan(g, 8, use_cache=False)
    assert len(TM.build_mesh_plan(plan, 2, 2).waves) > 1   # the prefetched path
    ex = sharded(model, "ref", 2, capacity=2, prefetch=1)
    deaths = REGISTRY.counter("exec.prefetch_deaths").value
    with TF.injected("exec.prefetch:nth=1,kind=kill"):
        with pytest.raises(RuntimeError, match="mesh prefetch thread for lane 0 died"):
            ex.run_plan(plan, feats)
    assert REGISTRY.counter("exec.prefetch_deaths").value == deaths + 1


# -- Session: mode "sharded" ------------------------------------------------------

def test_session_sharded_route_equals_reference(monkeypatch, ref_params):
    """Four stand-in CPU devices: the routing decision equals the reference's
    ``Session(mesh_devices=4).explain()`` field for field, and the sharded
    run gives mode "streamed"'s predictions."""
    want = RefSession(ref_params, num_partitions=8, mesh_devices=4).explain(
        dataset="csa", bits=12)
    monkeypatch.setattr(TLM, "visible_devices", lambda device=None: [CPU] * 4)
    sess = Session(NPZ, device="cpu", num_partitions=8)
    got = sess.explain(dataset="csa", bits=12)
    for f in ("mode", "backend", "k", "num_buckets", "buckets", "modeled_full_bytes",
              "modeled_peak_bytes", "mesh_devices", "num_nodes", "num_edges", "reason"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.mode == "sharded" and got.mesh_devices == 4
    r = sess.verify(dataset="csa", bits=12, return_predictions=True)
    assert r.routing == got
    assert r.exec_stats["devices"] == 4 and r.exec_stats["waves"] >= 1
    assert r.exec_stats["lane_launches"] == r.exec_stats["launches"] > 0
    assert sess.obs.metrics.gauge("exec.devices").value == 4
    one = sess.options(mesh_devices=1).verify(dataset="csa", bits=12, return_predictions=True)
    assert one.routing.mode == "streamed" and one.routing.mesh_devices == 1
    assert_same(r.predictions, one.predictions)
    assert (r.status, r.accuracy) == (one.status, one.accuracy)


def test_one_visible_device_routes_sharded_and_refuses(ref_params):
    """With the one CPU device, ``mesh_devices=4`` routes "sharded" (as the
    reference's router does) and the run refuses with the reference's
    error; with None it streams."""
    with pytest.raises(RLM.MeshConfigError) as want:
        RefSession(ref_params, num_partitions=8, mesh_devices=4).verify(dataset="csa",
                                                                        bits=12)
    sess = Session(NPZ, device="cpu", num_partitions=8, mesh_devices=4)
    assert sess.explain(dataset="csa", bits=12).mode == "sharded"
    with pytest.raises(TLM.MeshConfigError) as got:
        sess.verify(dataset="csa", bits=12)
    assert str(got.value) == str(want.value) == (
        "mesh_devices=4 out of range: 1 device(s) visible")
    assert Session(NPZ, device="cpu", num_partitions=8).explain(
        dataset="csa", bits=12).mode == "streamed"


# -- per-device release of a plan's copies -----------------------------------------

def test_release_drops_only_the_named_devices_copies(csa12):
    g, _ = csa12
    pair = ops.make_agg_pair(g.edge_src, g.edge_dst, g.num_nodes, "groot", device="cpu",
                             cache=False)
    plan = pair.in_plan
    on_cpu, on_meta = plan.on("cpu"), plan.on("meta")
    assert on_meta.cat_eids.device.type == "meta"
    ops.release_device(pair, "meta")
    assert plan.on("cpu") is on_cpu
    assert plan.on("meta") is not on_meta
    ops.release_device(pair)
    assert plan._device == {} and pair.out_plan._device == {}
