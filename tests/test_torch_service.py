"""The port's service route (``repro_torch.service``, ``Session.submit``,
``cli serve|top|--trace``) against the reference's (``repro.service``).

The cases of ``tests/test_service.py`` and ``test_service_loop.py`` on the
port (CPU), then the same requests through both packages: async results
equal to the port's sync ``Session.verify`` and to the reference's service,
packed predictions bit-equal to the port's unpacked forward and to the
reference's scheduler, and the same cold-compile counts and ``pack_log``
order.

Device-side timing is made deterministic by gating the runner: the device
thread blocks inside its first call until the test releases it.  Every
``result()`` passes a timeout and every engine is closed in a ``finally``
(or a ``with``), so a fault fails a case instead of hanging the run.
"""
from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import cli as TC  # noqa: E402
from repro_torch.api import Session, SessionConfig  # noqa: E402
from repro_torch.core import aig as A  # noqa: E402
from repro_torch.core import gnn  # noqa: E402
from repro_torch.core import pipeline as P  # noqa: E402
from repro_torch.io import aiger  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import start_metrics_server  # noqa: E402
from repro_torch.obs.check import check_trace  # noqa: E402
from repro_torch.service import (  # noqa: E402
    AdmissionError,
    ShapeBucketScheduler,
    SlotPool,
    VerificationService as _VerificationService,
)
from repro_torch.service.bucketing import (  # noqa: E402
    BucketShape,
    WorkItem,
    dummy_item,
    items_from_prepared,
    pack_batch,
    unpack_predictions,
)
from repro_torch.service.scheduler import BucketRunner  # noqa: E402


def VerificationService(params, **kw):
    return _VerificationService(params, device="cpu", **kw)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Small graphs run far faster on few threads than on a contended pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained_params():
    params, _ = P.train_model("csa", 8, epochs=200, device="cpu")
    return params


@pytest.fixture(scope="module")
def rand_params():
    return gnn.init_params(gnn.GNNConfig(), 0)


def make_service(params, **overrides):
    overrides.setdefault("num_partitions", 1)
    overrides.setdefault("prepare_workers", 2)
    return VerificationService(params, _warn=False, **overrides)


class GatedRunner:
    """Wraps a BucketRunner: every call blocks until ``release()``."""

    def __init__(self, inner):
        self._inner = inner
        self._gate = threading.Event()
        self.entered = threading.Event()     # set when a call is blocking

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def release(self):
        self._gate.set()

    def __call__(self, batch):
        self.entered.set()
        assert self._gate.wait(timeout=60.0), "gate never released"
        return self._inner(batch)


def wait_for(cond, timeout=30.0, msg="condition"):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# Bucketing / padding units (tests/test_service.py)
# ---------------------------------------------------------------------------

def test_padded_shape_pow2_with_spare_row():
    n_pad, e_pad = ops.padded_shape(100, 300, min_nodes=16, min_edges=16)
    assert n_pad == 128 and e_pad == 512
    n_pad, _ = ops.padded_shape(128, 1)
    assert n_pad == 256
    assert ops.padded_shape(3, 0) == (16, 16)


def test_pad_graph_arrays_contract():
    src = np.array([0, 1], np.int32)
    dst = np.array([2, 2], np.int32)
    s, d, inv, slot = ops.pad_graph_arrays(src, dst, None, None, 3, 8, 4)
    assert s.tolist() == [0, 1, 7, 7] and d.tolist() == [2, 2, 7, 7]
    assert not inv.any() and not slot.any()
    with pytest.raises(ValueError):
        ops.pad_graph_arrays(src, dst, None, None, 3, 2, 4)


def _item(rid, n, e, seed=0):
    rng = np.random.default_rng(seed)
    return WorkItem(
        req_id=rid, part_index=0,
        feats=rng.standard_normal((n, 4)).astype(np.float32),
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
        edge_inv=None, edge_slot=None, num_core=n,
        global_ids=np.arange(n, dtype=np.int64),
    )


def test_pack_batch_slots_are_disjoint():
    items = [_item(0, 10, 20), _item(1, 14, 30, seed=1)]
    shape = BucketShape(16, 32)
    batch = pack_batch(items, shape, capacity=4)
    assert batch["x"].shape == (64, 4)
    assert batch["edge_src"].shape == (128,)
    for i in range(4):
        sl = slice(i * 32, (i + 1) * 32)
        assert (batch["edge_src"][sl] >= i * 16).all()
        assert (batch["edge_dst"][sl] < (i + 1) * 16).all()
    outs = unpack_predictions(np.arange(64), items, shape)
    assert outs[0].tolist() == list(range(10))
    assert outs[1].tolist() == list(range(16, 30))


# ---------------------------------------------------------------------------
# Service vs sync verify; bucketing efficacy; cache semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_partitions", [1, 4])
def test_service_matches_pipeline(trained_params, num_partitions):
    base = Session(trained_params, SessionConfig(num_partitions=num_partitions,
                                                 device="cpu")).verify(dataset="csa", bits=12)
    with VerificationService(trained_params, num_partitions=num_partitions, _warn=False) as svc:
        r = svc.result(svc.submit_design("csa", 12), timeout=300)
    assert base.verdict is not None
    assert r.status == base.verdict.status
    assert r.core_accuracy == base.core_accuracy and r.accuracy == base.accuracy
    assert r.num_nodes == base.num_nodes


def test_service_aiger_submission_matches_generated(trained_params, tmp_path):
    path = tmp_path / "csa10.aig"
    aiger.dump(A.csa_multiplier(10), path)
    with VerificationService(trained_params, num_partitions=2, _warn=False) as svc:
        r_gen = svc.result(svc.submit_design("csa", 10), timeout=300)
        r_aig = svc.result(svc.submit_aiger(path), timeout=300)
    assert r_aig.status == r_gen.status
    assert r_aig.accuracy == r_gen.accuracy


def test_same_family_workload_compiles_at_most_num_buckets(trained_params):
    widths = [6, 8, 10, 12]
    with VerificationService(trained_params, _warn=False) as svc:
        tickets = [svc.submit_design("csa", b) for b in widths]
        for t in tickets:
            assert svc.result(t, timeout=300).status != "error"
        stats = svc.scheduler.stats()
        assert stats.compile_count <= len(stats.buckets)
        assert stats.compile_count < len(widths) or len(stats.buckets) == len(widths)
        before = svc.scheduler.stats().compile_count
        tickets = [svc.submit_design("csa", b, seed=1) for b in widths]
        for t in tickets:
            svc.result(t, timeout=300)
        assert svc.scheduler.stats().compile_count == before


def test_cache_hit_skips_inference(trained_params):
    with VerificationService(trained_params, _warn=False) as svc:
        r1 = svc.result(svc.submit_design("csa", 8), timeout=300)
        assert not r1.cached
        runs = svc.scheduler.stats().run_count
        r2 = svc.result(svc.submit_design("csa", 8), timeout=300)
        assert r2.cached
        assert r2.status == r1.status and r2.accuracy == r1.accuracy
        assert svc.scheduler.stats().run_count == runs
        assert svc.cache.stats.hits == 1


def test_identical_aiger_files_dedup_via_structural_hash(trained_params):
    data = aiger.dumps(A.csa_multiplier(8))
    with VerificationService(trained_params, _warn=False) as svc:
        r1 = svc.result(svc.submit_aiger(data), timeout=300)
        r2 = svc.result(svc.submit_aiger(data), timeout=300)
    assert not r1.cached and r2.cached


def test_error_requests_are_isolated(trained_params):
    with VerificationService(trained_params, _warn=False) as svc:
        bad = svc.submit_aiger(b"garbage\n")
        good = svc.submit_design("csa", 6)
        r_bad = svc.result(bad, timeout=300)
        r_good = svc.result(good, timeout=300)
    assert r_bad.status == "error" and r_bad.error
    assert r_good.status != "error"


def test_structure_keyed_runner_bounds_structures():
    """A groot runner forgets the structures it has seen past
    ``max_structures`` (the reference drops its jit cache there), and holds
    one structure's device copies at a time."""
    params = gnn.init_params(gnn.GNNConfig(hidden=8, num_layers=1), 0)
    runner = BucketRunner(params, backend="groot", max_structures=2, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(4):
        n, e = 32, 64
        batch = {
            "x": rng.standard_normal((n, 4)).astype(np.float32),
            "edge_src": rng.integers(0, n, e).astype(np.int32),
            "edge_dst": rng.integers(0, n, e).astype(np.int32),
            "edge_inv": np.zeros(e, bool),
            "edge_slot": np.zeros(e, np.uint8),
            "num_nodes": n,
        }
        assert runner(batch).shape == (n,)
    assert runner.structure_clears >= 1
    assert len(runner._structures_seen) <= 2
    runner.release()
    assert runner._held is None


def test_poll_is_nonblocking_and_unknown_ticket_raises(trained_params):
    with VerificationService(trained_params, _warn=False) as svc:
        t = svc.submit_design("csa", 6)
        svc.poll(t)
        r = svc.result(t, timeout=300)
        assert svc.poll(t) is r
        with pytest.raises(KeyError):
            svc.poll(10_000)


# ---------------------------------------------------------------------------
# The continuous-batching loop (tests/test_service_loop.py)
# ---------------------------------------------------------------------------

def test_slot_pool_orders_by_priority_then_arrival():
    pool = SlotPool()
    a, b = BucketShape(64, 128), BucketShape(128, 256)
    pool.admit(a, 1, 0, "a0")
    pool.admit(b, 0, 1, "b0")
    pool.admit(a, 1, 2, "a1")
    assert len(pool) == 3
    assert pool.best_bucket() == b
    assert pool.take(b, 4) == [(0, 1, "b0")]
    assert pool.best_bucket() == a
    assert [p for (_, _, p) in pool.take(a, 1)] == ["a0"]
    assert [p for (_, _, p) in pool.take(a, 4)] == ["a1"]
    assert len(pool) == 0 and pool.best_bucket() is None


def _mid_flight(service, params):
    """R2/R3 prepared while R1's pack is held on the device; returns the
    tickets and the pack log."""
    svc = make_service(params, capacity=2)
    gate = GatedRunner(svc.scheduler.runner)
    svc.scheduler.runner = gate
    try:
        t1 = svc.submit(dataset="csa", bits=4, seed=0, verify=False)
        assert gate.entered.wait(timeout=30.0)
        t2 = svc.submit(dataset="csa", bits=4, seed=1, verify=False)
        t3 = svc.submit(dataset="csa", bits=4, seed=2, verify=False)
        wait_for(lambda: svc._device_q.qsize() >= 2, msg="R2+R3 prepared")
    finally:
        gate.release()
    try:
        rs = [svc.result(t, timeout=60.0) for t in (t1, t2, t3)]
    finally:
        svc.close()
    return (t1, t2, t3), rs, list(svc.scheduler.pack_log)


def test_mid_flight_request_joins_next_pack(rand_params):
    (t1, t2, t3), rs, log = _mid_flight(make_service, rand_params)
    assert [r.status for r in rs] == ["classified"] * 3
    assert [sorted(ids) for (_, ids, _) in log] == [[t1], sorted([t2, t3])]
    assert [fill for (_, _, fill) in log] == [0.5, 1.0]


def test_priority_lane_overtakes_under_saturation(rand_params):
    svc = make_service(rand_params, capacity=1)
    gate = GatedRunner(svc.scheduler.runner)
    svc.scheduler.runner = gate
    try:
        t0 = svc.submit(dataset="csa", bits=4, seed=0, verify=False)
        assert gate.entered.wait(timeout=30.0)
        t_slow = svc.submit(dataset="csa", bits=4, seed=1, verify=False, priority=5)
        wait_for(lambda: svc._device_q.qsize() >= 1, msg="bulk queued")
        t_fast = svc.submit(dataset="csa", bits=4, seed=2, verify=False, priority=0)
        wait_for(lambda: svc._device_q.qsize() >= 2, msg="express queued")
    finally:
        gate.release()
    try:
        for t in (t0, t_slow, t_fast):
            svc.result(t, timeout=60.0)
        order = [ids[0] for (_, ids, _) in svc.scheduler.pack_log]
        assert order == [t0, t_fast, t_slow]
    finally:
        svc.close()


def test_warmup_then_zero_cold_compiles(rand_params):
    g = A.make_design("csa", 4).to_edge_graph()
    shape = ops.padded_shape(g.num_nodes, g.num_edges, min_nodes=64, min_edges=128)
    svc = make_service(rand_params, warmup=True, warmup_shapes=(shape,), capacity=2)
    try:
        st = svc.stats()
        assert svc.scheduler.runner.warmed
        assert st["warm_compiles"] >= 1
        assert st["warmup_s"] > 0.0
        tickets = [svc.submit(dataset="csa", bits=4, seed=s, verify=False) for s in range(4)]
        for t in tickets:
            assert svc.result(t, timeout=60.0).status == "classified"
        st = svc.stats()
        assert st["cold_compiles"] == 0, "a warmed bucket met a new signature"
        assert st["compile_count"] == st["warm_compiles"]
        assert st["obs"]["gauges"]["service.slot_occupancy"]["max"] > 0
        assert st["obs"]["histograms"]["service.admission_s"]["count"] == 4
    finally:
        svc.close()


def test_unwarmed_bucket_counts_cold(rand_params):
    svc = make_service(rand_params, warmup=True, warmup_shapes=((64, 128),))
    try:
        svc.result(svc.submit(dataset="csa", bits=6, seed=0, verify=False), timeout=60.0)
        assert svc.stats()["cold_compiles"] >= 1
    finally:
        svc.close()


def test_scheduler_warm_covers_stream_capacity():
    params = gnn.init_params(gnn.GNNConfig(), 1)
    sched = ShapeBucketScheduler(params, capacity=4, stream_capacity=2,
                                 max_bucket_nodes=256, max_bucket_edges=512, device="cpu")
    n = sched.warm([(64, 128)], stream=True)
    assert n == 2                    # one per (bucket, capacity) layout
    out = sched.run_pack([dummy_item(sched.runner.in_features)], BucketShape(64, 128))
    assert sched.runner.cold_compile_count == 0
    assert set(out) == {(-1, 0)}


def test_tenant_cap_rejects_then_frees(rand_params):
    svc = make_service(rand_params, max_inflight_per_tenant=2)
    gate = GatedRunner(svc.scheduler.runner)
    svc.scheduler.runner = gate
    try:
        t1 = svc.submit(dataset="csa", bits=4, seed=0, verify=False, tenant="acme")
        t2 = svc.submit(dataset="csa", bits=4, seed=1, verify=False, tenant="acme")
        with pytest.raises(AdmissionError):
            svc.submit(dataset="csa", bits=4, seed=2, verify=False, tenant="acme")
        t3 = svc.submit(dataset="csa", bits=4, seed=3, verify=False, tenant="bob")
    finally:
        gate.release()
    try:
        for t in (t1, t2, t3):
            svc.result(t, timeout=60.0)
        t4 = svc.submit(dataset="csa", bits=4, seed=4, verify=False, tenant="acme")
        svc.result(t4, timeout=60.0)
        assert svc.metrics.counter("service.rejected").value == 1
    finally:
        svc.close()


def test_concurrent_duplicates_coalesce_to_one_execution(rand_params):
    svc = make_service(rand_params)
    gate = GatedRunner(svc.scheduler.runner)
    svc.scheduler.runner = gate
    try:
        lead = svc.submit(dataset="csa", bits=4, seed=0, verify=False)
        assert gate.entered.wait(timeout=30.0)
        followers = [svc.submit(dataset="csa", bits=4, seed=0, verify=False)
                     for _ in range(3)]
    finally:
        gate.release()
    try:
        r_lead = svc.result(lead, timeout=60.0)
        r_follow = [svc.result(t, timeout=60.0) for t in followers]
        assert not r_lead.cached
        assert all(r.cached for r in r_follow)
        assert {r.status for r in r_follow} == {r_lead.status}
        assert {r.name for r in r_follow} == {r_lead.name}
        assert sorted(r.req_id for r in r_follow) == sorted(followers)
        assert svc.metrics.counter("service.coalesced").value == 3
        assert svc.scheduler.runner.run_count == 1
    finally:
        svc.close()


def test_coalesce_off_runs_every_request(rand_params):
    svc = make_service(rand_params, coalesce=False)
    gate = GatedRunner(svc.scheduler.runner)
    svc.scheduler.runner = gate
    try:
        tickets = [svc.submit(dataset="csa", bits=4, seed=0, verify=False) for _ in range(2)]
        assert gate.entered.wait(timeout=30.0)
    finally:
        gate.release()
    try:
        rs = [svc.result(t, timeout=60.0) for t in tickets]
        assert svc.metrics.counter("service.coalesced").value == 0
        assert rs[0].status == "classified"
    finally:
        svc.close()


def test_failed_generated_request_is_attributable(rand_params):
    svc = make_service(rand_params)
    try:
        r = svc.result(svc.submit(dataset="no-such-family", bits=8), timeout=60.0)
        assert r.status == "error" and r.error
        assert r.name == "no-such-family:8"
    finally:
        svc.close()


def test_failed_aiger_request_uses_comment_name(rand_params):
    svc = make_service(rand_params)
    try:
        bad = b"not an aiger header\nc\ngroot-name revision_42\n"
        r = svc.result(svc.submit(aiger_bytes=bad), timeout=60.0)
        assert r.status == "error"
        assert r.name == "revision_42"
        r2 = svc.result(svc.submit(aiger_bytes=b"also not aiger\n"), timeout=60.0)
        assert r2.status == "error" and r2.name == "aiger"
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# Failure domains: deadlines, retries, bisection
# ---------------------------------------------------------------------------

def test_deadline_retry_and_bisection(rand_params):
    """A 1 ms deadline fails alone with DeadlineExceeded; a fatal fault
    matched to one design (an AIGER csa-4 named ``poison``) fails its pack,
    which bisects so only that ticket fails; a transient launch fault on a
    lone item is retried away."""
    from repro_torch import faults

    poison = A.make_design("csa", 4)
    poison.name = "poison"
    svc = make_service(rand_params, capacity=4)
    gate = GatedRunner(svc.scheduler.runner)
    svc.scheduler.runner = gate
    faults.install("service.device:match=poison,every=1,kind=fatal")
    try:
        t_late = svc.submit(dataset="csa", bits=5, seed=9, verify=False, deadline_s=1e-3)
        t_hold = svc.submit(dataset="csa", bits=4, seed=0, verify=False)
        assert gate.entered.wait(timeout=30.0)
        packed = [svc.submit(dataset="csa", bits=4, seed=s, verify=False) for s in (1, 2)]
        bad = svc.submit(aiger_bytes=aiger.dumps(poison), verify=False)
        wait_for(lambda: svc._device_q.qsize() >= 3, msg="pack queued")
        gate.release()
        assert svc.result(t_late, timeout=60.0).error.startswith("DeadlineExceeded")
        assert svc.result(t_hold, timeout=60.0).status == "classified"
        assert [svc.result(t, timeout=60.0).status for t in packed] == ["classified"] * 2
        r_bad = svc.result(bad, timeout=60.0)
        assert r_bad.status == "error" and "FatalFault" in r_bad.error
        assert r_bad.name == "poison"
        assert svc.metrics.counter("service.bisections").value >= 1
        assert svc.metrics.counter("service.deadline_exceeded").value == 1
        faults.install("service.device:nth=1,kind=transient")
        r = svc.result(svc.submit(dataset="csa", bits=6, seed=0, verify=False), timeout=60.0)
        assert r.status == "classified"
        assert svc.metrics.counter("service.retries").value == 1
    finally:
        faults.uninstall()
        gate.release()
        svc.close()


def test_sticky_cuda_error_ends_the_worker_instead_of_bisecting(rand_params):
    """A CUDA error (not an out-of-memory) poisons the context: the pack is
    not bisected, the device worker ends and every pending ticket fails."""
    svc = make_service(rand_params, capacity=2)
    gate = GatedRunner(svc.scheduler.runner)
    svc.scheduler.runner = gate
    calls = []

    class Broken:
        """The gated runner, whose second call meets a CUDA error."""

        def __getattr__(self, name):
            return getattr(gate, name)

        def __call__(self, batch):
            calls.append(1)
            if len(calls) > 1:
                raise RuntimeError("ld_grouped_apply: CUDA error 700 at launch")
            return gate(batch)

    svc.scheduler.runner = Broken()
    try:
        t0 = svc.submit(dataset="csa", bits=4, seed=0, verify=False)
        assert gate.entered.wait(timeout=30.0)
        pack = [svc.submit(dataset="csa", bits=4, seed=s, verify=False) for s in (1, 2)]
        wait_for(lambda: svc._device_q.qsize() >= 2, msg="pack queued")
        gate.release()
        # the first ticket finishes, or fails with the worker if its verdict
        # was still on the pool when the worker ended
        assert svc.result(t0, timeout=60.0).status in ("classified", "error")
        for t in pack:
            r = svc.result(t, timeout=60.0)
            assert r.status == "error" and "device worker crashed" in r.error
        assert svc.metrics.counter("service.bisections").value == 0
        assert svc.metrics.counter("service.worker_deaths").value == 1
        assert len(calls) == 2
    finally:
        gate.release()
        svc.close()


# ---------------------------------------------------------------------------
# The same requests through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    jax = pytest.importorskip("jax")
    from repro.core import gnn as RG

    return RG.init_params(RG.GNNConfig(), jax.random.key(0))


@pytest.mark.parametrize("backend", ["ref", "groot"])
def test_packed_predictions_equal_unpacked_and_reference(rand_params, reference, backend):
    """Items of csa-4..8 (csa-8 cut in two) packed two a launch: the port's
    predictions are bit-equal to its unpacked forward of each design and to
    the reference's scheduler on the same items (its ``groot`` through the
    Pallas kernels in interpret mode)."""
    from repro.core import pipeline as RP
    from repro.service.bucketing import items_from_prepared as r_items
    from repro.service.scheduler import ShapeBucketScheduler as RScheduler

    designs = [(4, 1), (6, 1), (8, 2)]
    items, r_its, sync = [], [], {}
    for rid, (bits, k) in enumerate(designs):
        cfg = P.PipelineConfig(dataset="csa", bits=bits, num_partitions=k, backend=backend)
        prep = P.prepare(cfg)
        items += items_from_prepared(rid, prep)
        r_its += r_items(rid, RP.prepare(RP.PipelineConfig(dataset="csa", bits=bits,
                                                           num_partitions=k, backend=backend)))
        if k == 1:
            sync[rid] = gnn.predict(rand_params, prep.graph, prep.feats, backend, device="cpu")
    sched = ShapeBucketScheduler(rand_params, backend=backend, capacity=2, device="cpu")
    got = sched.run_items(items)
    want = RScheduler(reference, backend=backend, capacity=2).run_items(r_its)
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    for rid, pred in sync.items():
        np.testing.assert_array_equal(got[(rid, 0)], pred)
    sched.runner.release()


def test_async_results_equal_sync_and_reference(trained_params):
    """The same tickets through the port's service, its sync verify and the
    reference's service: same status, accuracy and node count."""
    from repro.service import VerificationService as RService

    specs = [("csa", 6, 0), ("csa", 10, 0), ("booth", 8, 0)]
    ref_params = gnn.params_to_numpy(trained_params)
    sess = Session(trained_params, SessionConfig(num_partitions=2, device="cpu"))
    try:
        tickets = [sess.submit(dataset=f, bits=b, seed=s) for f, b, s in specs]
        got = [sess.result(t, timeout=300) for t in tickets]
    finally:
        sess.close()
    sync = [sess.verify(dataset=f, bits=b, seed=s, use_cache=False) for f, b, s in specs]
    with RService(ref_params, num_partitions=2, _warn=False) as rsvc:
        want = [rsvc.result(rsvc.submit(dataset=f, bits=b, seed=s), timeout=300)
                for f, b, s in specs]
    for g, s, w in zip(got, sync, want):
        assert (g.status, g.accuracy, g.num_nodes) == (s.status, s.accuracy, s.num_nodes)
        assert (g.status, g.accuracy, g.num_nodes) == (w.status, w.accuracy, w.num_nodes)


def test_cold_compiles_and_pack_log_equal_reference(rand_params, reference):
    """Warm one bucket, then the gated priority scenario: the pack order and
    the warm/cold compile counts equal the reference's."""
    from repro.service import VerificationService as RService

    def scenario(svc):
        gate = GatedRunner(svc.scheduler.runner)
        svc.scheduler.runner = gate
        try:
            t0 = svc.submit(dataset="csa", bits=4, seed=0, verify=False)
            assert gate.entered.wait(timeout=60.0)
            t1 = svc.submit(dataset="csa", bits=6, seed=1, verify=False, priority=5)
            wait_for(lambda: svc._device_q.qsize() >= 1, timeout=60.0)
            t2 = svc.submit(dataset="csa", bits=4, seed=2, verify=False, priority=0)
            # t2 queued before t3 is submitted: two prepare workers would
            # otherwise race them, and equal priorities pack in arrival order
            wait_for(lambda: svc._device_q.qsize() >= 2, timeout=60.0)
            t3 = svc.submit(dataset="csa", bits=4, seed=3, verify=False, priority=0)
            wait_for(lambda: svc._device_q.qsize() >= 3, timeout=60.0)
        finally:
            gate.release()
        try:
            for t in (t0, t1, t2, t3):
                svc.result(t, timeout=120.0)
            st = svc.stats()
            return ([(s.n_pad, s.e_pad, ids, fill) for s, ids, fill in svc.scheduler.pack_log],
                    st["warm_compiles"], st["cold_compiles"], st["compile_count"])
        finally:
            svc.close()

    kw = dict(num_partitions=1, prepare_workers=2, capacity=2, warmup=True,
              warmup_shapes=((128, 128),), _warn=False)
    got = scenario(VerificationService(rand_params, **kw))
    want = scenario(RService(reference, **kw))
    assert got == want
    assert got[2] >= 1              # csa-6 lands in an unwarmed bucket


def test_session_submit_poll_result_stats_report(rand_params, tmp_path):
    g = A.make_design("csa", 4).to_edge_graph()
    shape = ops.padded_shape(g.num_nodes, g.num_edges, min_nodes=64, min_edges=128)
    sess = Session(rand_params, SessionConfig(device="cpu", warmup=True, trace=True,
                                              warmup_shapes=(shape,)))
    with sess:
        assert sess.warm() == 0      # warmed at construction
        t = sess.submit(dataset="csa", bits=4, verify=False, tenant="a")
        r = sess.result(t, timeout=60.0)
        assert sess.poll(t) is r and r.status == "classified"
        st = sess.stats()["service"]
        assert st["cold_compiles"] == 0 and st["device_calls"] >= 2
        rep = sess.report()
        assert rep.scheduler["warm_compiles"] == st["warm_compiles"]
        assert rep.session["counters"]["service.admitted"] == 1
        sess.verify(dataset="csa", bits=4, verify=False)
        sess.save_trace(tmp_path / "t.json")
        assert {f.req_id for f in sess.flights()} == {t, -1}
    with pytest.raises(RuntimeError, match="closed"):
        sess.submit(dataset="csa", bits=4)
    assert check_trace(json.loads((tmp_path / "t.json").read_text()),
                       ["parse", "plan", "execute", "verdict"], 0.5) == []


# ---------------------------------------------------------------------------
# The command line: serve, top, --trace
# ---------------------------------------------------------------------------

def test_cli_serve_runs_the_workload(capsys, tmp_path):
    path = tmp_path / "bad.aig"
    path.write_bytes(b"garbage\n")
    assert TC.main(["serve", "--designs", "csa:6,csa:8", "--repeat", "2", "--epochs", "20",
                    "--aiger", str(path)], device="cpu") == 0
    out = capsys.readouterr().out
    rows = [ln.split() for ln in out.splitlines() if ln.strip().split()[:1]
            and ln.split()[0].isdigit()]
    assert len(rows) == 6
    assert [r[2] for r in rows if r[1] == "aiger"] == ["error", "error"]
    assert [r[-2] for r in rows[3:] if r[1] != "aiger"] == ["True", "True"]
    assert "served 6 requests" in out


def test_cli_top_reads_stats(capsys):
    stats = {"service": {"device_calls": 7, "compile_count": 3, "cold_compiles": 0,
                         "streamed_items": 1,
                         "flights": {"recorded": 5, "failures": 1, "retained": 5,
                                     "capacity": 256},
                         "obs": {"gauges": {"service.queue_depth": {"value": 2, "max": 4}},
                                 "histograms": {"service.infer_s": {
                                     "count": 3, "p50": 0.01, "p95": 0.02}}}}}
    from repro_torch.obs import MetricsRegistry

    srv = start_metrics_server(MetricsRegistry(), port=0, stats_fn=lambda: stats)
    try:
        assert TC.main(["top", srv.url, "--iterations", "1"]) == 0
    finally:
        srv.close()
    out = capsys.readouterr().out
    assert "device calls     7" in out and "flights: 5 recorded, 1 failed" in out
    assert "infer_s" in out
    assert TC.main(["top", "127.0.0.1:9", "--iterations", "1"]) == 1


def test_cli_verify_trace_writes_chrome_json(capsys, tmp_path):
    path = tmp_path / "trace.json"
    assert TC.main(["verify", "csa:6", "--epochs", "5", "--trace", str(path)],
                   device="cpu") == 0
    assert f"trace written to {path}" in capsys.readouterr().out
    assert check_trace(json.loads(path.read_text()), ["parse", "plan", "execute", "verdict"],
                       0.5) == []
