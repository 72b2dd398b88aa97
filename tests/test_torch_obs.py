"""The port's observability spine (``repro_torch.obs``) against the
reference's (``repro.obs``): the cases of ``tests/test_obs.py``,
``test_obs_flight.py`` and ``test_obs_export.py`` on the port (CPU), and the
same requests through both packages giving the same counter deltas and
flight-record stages.

Every ``result()`` passes a timeout, and every engine is closed in a
``finally`` or a ``with``.
"""
from __future__ import annotations

import copy
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Session as _Session, SessionConfig as _SessionConfig  # noqa: E402
from repro_torch.core import gnn  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    NULL_TRACER,
    REGISTRY,
    CounterGroup,
    FlightRecorder,
    MetricsRegistry,
    Sampler,
    Tracer,
    current_tracer,
    fold_into,
    parse_prometheus,
    record_from_marks,
    render_prometheus,
    span,
    span_coverage,
    spans_from_chrome,
    start_metrics_server,
)
from repro_torch.obs import regress  # noqa: E402
from repro_torch.obs.check import check_trace  # noqa: E402
from repro_torch.obs.export import sanitize_metric_name  # noqa: E402
from repro_torch.obs.flight import stages_from_marks  # noqa: E402
from repro_torch.service.server import VerificationService as _VerificationService  # noqa: E402


def Session(params=None, config=None, **overrides):
    """The port's Session on the CPU."""
    config = _SessionConfig() if config is None else config
    return _Session(params, config.replace(device="cpu"), **overrides)


def SessionConfig(**kw):
    return _SessionConfig(device="cpu", **kw)


def VerificationService(params, **kw):
    return _VerificationService(params, device="cpu", **kw)


def make_service(params, **overrides):
    overrides.setdefault("num_partitions", 1)
    overrides.setdefault("prepare_workers", 2)
    return VerificationService(params, _warn=False, **overrides)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Small graphs run far faster on few threads than on a contended pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rand_params():
    """The reference's seed-0 init (the port draws it bit-equal)."""
    return gnn.init_params(gnn.GNNConfig(), 0)



# ---------------------------------------------------------------------------
# Tracer: nesting, disabled path, export round-trip
# ---------------------------------------------------------------------------

def test_span_nesting_records_parent_ids():
    tr = Tracer()
    with tr.activate():
        with span("outer") as outer:
            with span("inner_a") as a:
                pass
            with span("inner_b", k=3) as b:
                b.set(extra="late")
    spans = {s.name: s for s in tr.spans()}
    assert spans["outer"].parent_id is None
    assert spans["inner_a"].parent_id == outer.span_id
    assert spans["inner_b"].parent_id == outer.span_id
    assert spans["inner_b"].attrs == {"k": 3, "extra": "late"}
    # children recorded before the parent closes, all well-formed
    for s in spans.values():
        assert s.t1 >= s.t0


def test_disabled_path_is_the_shared_noop():
    # no tracer active: module-level span() must not record anywhere
    assert current_tracer() is NULL_TRACER
    ctx = span("anything", k=1)
    with ctx as s:
        assert s.span_id is None
        s.set(ignored=True)  # no-op, no error
    # the no-op context is one shared singleton — zero allocation per span
    assert span("other") is ctx
    assert NULL_TRACER.adopt(42) is NULL_TRACER.activate() is ctx


def test_activate_restores_previous_tracer():
    t1, t2 = Tracer(), Tracer()
    with t1.activate():
        with t2.activate():
            with span("inner"):
                pass
        with span("outer"):
            pass
    assert current_tracer() is NULL_TRACER
    assert [s.name for s in t1.spans()] == ["outer"]
    assert [s.name for s in t2.spans()] == ["inner"]


def test_chrome_export_round_trip(tmp_path):
    tr = Tracer()
    with tr.activate():
        with span("root", design="csa-8"):
            with span("child"):
                pass
    path = tmp_path / "trace.json"
    tr.save(path)
    data = json.loads(path.read_text())
    # metadata event names the thread; X events carry the spans
    assert any(ev["ph"] == "M" for ev in data["traceEvents"])
    back = spans_from_chrome(data)
    orig = tr.spans()
    assert {s["name"] for s in back} == {s.name for s in orig}
    by_name = {s["name"]: s for s in back}
    root, child = by_name["root"], by_name["child"]
    assert child["parent_id"] == root["span_id"]
    assert root["attrs"]["design"] == "csa-8"
    # timestamps survive the µs round-trip to within a microsecond
    o = {s.name: s for s in orig}
    for name, s in by_name.items():
        assert abs((s["t1"] - s["t0"]) - o[name].duration) < 2e-6
    # coverage computes identically on dicts and Span objects
    assert span_coverage(back, root["span_id"]) == pytest.approx(
        span_coverage(orig, o["root"].span_id), abs=1e-6
    )


def test_cross_thread_adoption_parents_under_owner_span():
    tr = Tracer()
    with tr.activate():
        with span("owner") as owner:
            parent = tr.current_id()

            def worker():
                with tr.adopt(parent):
                    with span("worker_span"):
                        pass

            t = threading.Thread(target=worker, name="obs-worker")
            t.start()
            t.join()
    spans = {s.name: s for s in tr.spans()}
    w = spans["worker_span"]
    assert w.parent_id == owner.span_id
    assert w.thread == "obs-worker"
    assert w.tid != spans["owner"].tid


# ---------------------------------------------------------------------------
# Metrics: registry semantics, the PROBE bridge, fold_into
# ---------------------------------------------------------------------------

def test_registry_instruments_and_delta():
    reg = MetricsRegistry()
    reg.counter("a.hits").inc()
    reg.counter("a.hits").inc(2)
    assert reg.counter("a.hits") is reg.counter("a.hits")
    before = reg.snapshot()
    reg.counter("a.hits").inc(5)
    reg.counter("b.new").inc()
    assert reg.delta(before) == {"a.hits": 5, "b.new": 1}
    assert reg.delta(before, prefix="a.") == {"a.hits": 5}

    g = reg.gauge("q.depth")
    g.set(3)
    g.set(1)
    assert (g.value, g.max) == (1, 3)

    h = reg.histogram("lat_s")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    s = h.summary()
    assert s["count"] == 3
    assert s["sum"] == pytest.approx(0.6)
    assert s["min"] == pytest.approx(0.1)
    assert s["p50"] == pytest.approx(0.2)


def test_counter_group_is_the_probe_bridge():
    reg = MetricsRegistry()
    probe = CounterGroup(reg, "k.spmm", ("walks", "bytes"))
    probe["walks"] += 1
    probe["walks"] += 1
    probe["bytes"] += 128
    assert dict(probe) == {"walks": 2, "bytes": 128}
    assert reg.counters("k.spmm.") == {"k.spmm.walks": 2, "k.spmm.bytes": 128}
    for k in probe:          # reset_probe's historic idiom
        probe[k] = 0
    assert reg.counters("k.spmm.") == {"k.spmm.walks": 0, "k.spmm.bytes": 0}


def test_kernel_probe_feeds_global_registry():
    from repro_torch.kernels import groot_spmm

    groot_spmm.reset_probe()
    before = REGISTRY.counters("kernels.spmm.")
    groot_spmm.PROBE["kernel_walks"] += 1
    after = REGISTRY.counters("kernels.spmm.")
    assert after["kernels.spmm.kernel_walks"] == \
        before["kernels.spmm.kernel_walks"] + 1
    assert groot_spmm.probe_snapshot()["kernel_walks"] == 1


def test_fold_into_routes_ints_and_timings():
    reg = MetricsRegistry()
    fold_into(reg, "exec", {"launches": 3, "wall_s": 0.5, "mode": "streamed",
                            "ok": True})
    assert reg.counters() == {"exec.launches": 3}
    assert reg.histogram("exec.wall_s").summary()["count"] == 1


# ---------------------------------------------------------------------------
# Sessions: prefetch-thread parenting, isolation, cached-root tagging
# ---------------------------------------------------------------------------

def test_streamed_verify_parents_pack_spans_across_prefetch_thread(rand_params):
    sess = Session(rand_params, SessionConfig(num_partitions=4, trace=True))
    r = sess.verify(dataset="csa", bits=16, verify=False, use_cache=False)
    assert r.routing.mode == "streamed"
    spans = r.trace.spans()
    stream = [s for s in spans if s.name == "exec.stream"]
    packs = [s for s in spans if s.name == "exec.pack"]
    assert len(stream) == 1 and packs
    for p in packs:
        assert p.parent_id == stream[0].span_id
        assert p.tid != stream[0].tid          # recorded on the prefetch thread
        assert p.thread == "exec-prefetch"
    assert r.trace.coverage() >= 0.95


def test_session_counter_isolation(rand_params):
    s1 = Session(rand_params, SessionConfig(trace=False))
    s2 = Session(rand_params,
                 SessionConfig(num_partitions=2, streaming=False))
    s1.verify(dataset="csa", bits=8, verify=False, use_cache=False)
    c1 = s1.report().session["counters"]
    c2 = s2.report().session["counters"]
    assert c1["session.verifies"] == 1
    assert c1["session.route.full"] == 1
    assert c2 == {}                            # s2 never ran: sees nothing
    s2.verify(dataset="csa", bits=8, verify=False, use_cache=False)
    c1b = s1.report().session["counters"]
    c2b = s2.report().session["counters"]
    assert c1b == c1                           # s2's run invisible to s1
    assert c2b["session.route.partitioned"] == 1


def test_service_queue_depth_gauge_tracks_both_sides(rand_params):
    """``service.queue_depth`` is set on enqueue AND after drain: while
    the device is held mid-pack the gauge's max records the backlog, and
    once the loop drains it the live value returns to zero."""
    
    svc = VerificationService(rand_params, num_partitions=1,
                              prepare_workers=2, _warn=False)
    inner = svc.scheduler.runner
    gate = threading.Event()
    entered = threading.Event()

    class _Gated:
        def __getattr__(self, name):
            return getattr(inner, name)

        def __call__(self, batch):
            entered.set()
            assert gate.wait(timeout=60.0)
            return inner(batch)

    svc.scheduler.runner = _Gated()
    try:
        tickets = [svc.submit(dataset="csa", bits=4, seed=0, verify=False)]
        assert entered.wait(timeout=30.0)      # device held mid-pack
        tickets += [svc.submit(dataset="csa", bits=4, seed=s, verify=False)
                    for s in (1, 2)]
        depth = svc.metrics.gauge("service.queue_depth")
        deadline = time.perf_counter() + 30.0
        while depth.max < 1:                   # both enqueues land behind R1
            assert time.perf_counter() < deadline, "enqueue never moved gauge"
            time.sleep(0.005)
    finally:
        gate.set()
    for t in tickets:
        assert svc.result(t, timeout=60.0).status == "classified"
    # the drain side wrote too: backlog consumed, gauge back to zero
    assert depth.max >= 1
    assert depth.value == 0
    svc.close()


def test_cache_hit_root_is_tagged_and_gate_exempt(rand_params):
    sess = Session(rand_params, SessionConfig(trace=True))
    sess.verify(dataset="csa", bits=8, verify=False)
    r2 = sess.verify(dataset="csa", bits=8, verify=False)
    assert r2.cached
    data = sess.obs.tracer.to_chrome()
    roots = [s for s in spans_from_chrome(data)
             if s["name"] == "session.verify"]
    assert len(roots) == 2
    assert [bool(r["attrs"].get("cached")) for r in sorted(
        roots, key=lambda s: s["t0"])] == [False, True]
    # the gate validates the full root and skips the cached one
    assert check_trace(data, ["parse", "plan", "execute", "verdict"],
                       0.95) == []


def test_trace_disabled_produces_no_handle_and_no_spans(rand_params):
    sess = Session(rand_params, SessionConfig(trace=False))
    r = sess.verify(dataset="csa", bits=8, verify=False, use_cache=False)
    assert r.trace is None
    assert sess.obs.tracer is None
    assert sess.report().spans is None
    with pytest.raises(RuntimeError):
        sess.save_trace("/tmp/never-written.json")


# ---------------------------------------------------------------------------
# Acceptance (slow): csa-64 traced once per route — gate + report counters
# ---------------------------------------------------------------------------

#: per-route (config overrides, expected mode, compile counter, byte counter)
ROUTES = [
    ({"num_partitions": 1}, "full",
     "gnn.forward_traces", "gnn.bytes_staged"),
    ({"num_partitions": 4, "streaming": False}, "partitioned",
     "gnn.forward_traces", "gnn.bytes_staged"),
    ({"num_partitions": 4, "streaming": True}, "streamed",
     "exec.compiles", "exec.bytes_h2d"),
]


@pytest.mark.slow
@pytest.mark.parametrize("overrides,mode,compile_ctr,bytes_ctr", ROUTES,
                         ids=[m for _, m, _, _ in ROUTES])
def test_csa64_traced_verify_acceptance(rand_params, tmp_path, overrides,
                                        mode, compile_ctr, bytes_ctr):
    sess = Session(rand_params,
                   SessionConfig(backend="groot", trace=True, **overrides))
    r = sess.verify(dataset="csa", bits=64, verify=False, use_cache=False)
    assert r.routing.mode == mode

    # trace: write/reload the Chrome JSON and run the exact CI gate
    path = tmp_path / f"csa64_{mode}.json"
    r.trace.save(path)
    data = json.loads(path.read_text())
    assert check_trace(data, ["parse", "plan", "execute", "verdict"],
                       0.95) == []
    assert r.trace.coverage() >= 0.95

    # report: non-zero plan-cache, compile, and byte counters for the route
    rep = sess.report()
    pc = rep.plan_cache
    assert pc["builds"] + pc["hits"] > 0
    assert rep.process.get(compile_ctr, 0) > 0
    assert rep.process.get(bytes_ctr, 0) > 0
    assert rep.session["counters"][f"session.route.{mode}"] == 1
    d = rep.to_dict()
    json.dumps(d)                              # report is json-serialisable
    assert d["session"]["counters"]["session.verifies"] == 1





def check_timeline(rec):
    """The assertable contract: monotonic marks, stages tile the total."""
    times = [t for _, t in rec.marks]
    assert times == sorted(times), f"non-monotonic marks: {rec.marks}"
    assert sum(rec.stages.values()) == pytest.approx(rec.total_s, abs=1e-9)
    assert rec.total_s >= 0.0


# ---------------------------------------------------------------------------
# unit: marks -> stages
# ---------------------------------------------------------------------------

def test_stages_tile_timeline_exactly():
    marks = [("submit", 1.0), ("prepared", 1.25), ("admitted", 1.75),
             ("inferred", 2.0), ("done", 2.125)]
    stages, total = stages_from_marks(marks)
    assert stages == {"prepare": 0.25, "queue_wait": 0.5, "infer": 0.25,
                      "finalize": 0.125}
    assert total == pytest.approx(1.125)
    assert sum(stages.values()) == pytest.approx(total)


def test_cache_hit_timeline_is_one_segment():
    stages, total = stages_from_marks([("submit", 3.0), ("done", 3.5)])
    assert stages == {"finalize": 0.5} and total == pytest.approx(0.5)


def test_record_from_marks_derives_failed_stage():
    # died after "prepared": the failing segment is the queue-wait
    rec = record_from_marks(7, "x", "error",
                            [("submit", 0.0), ("prepared", 1.0)],
                            error="RuntimeError: boom")
    assert rec.failed_stage == "queue_wait"
    assert not rec.ok and rec.error == "RuntimeError: boom"
    check_timeline(rec)
    # an explicit failed_stage wins over derivation
    rec2 = record_from_marks(8, "x", "error", [("submit", 0.0)],
                             failed_stage="prepare")
    assert rec2.failed_stage == "prepare"


def test_record_to_dict_is_json_safe():
    rec = record_from_marks(1, "csa:8", "verified",
                            [("submit", 0.0), ("done", 0.25)],
                            bucket=(64, 128), capacity=2, tenant="acme")
    d = json.loads(json.dumps(rec.to_dict()))
    assert d["bucket"] == [64, 128] and d["tenant"] == "acme"
    assert d["marks"] == [["submit", 0.0], ["done", 0.25]]


# ---------------------------------------------------------------------------
# ring semantics + concurrency (the lost-update satellite)
# ---------------------------------------------------------------------------

def test_ring_bound_and_stats():
    fr = FlightRecorder(capacity=4)
    for i in range(10):
        fr.record(record_from_marks(i, "d", "error" if i % 3 == 0 else "ok",
                                    [("submit", 0.0), ("done", 1.0)]))
    st = fr.stats()
    assert len(fr) == 4 and st["retained"] == 4
    assert st["recorded"] == 10 and st["dropped"] == 6
    assert st["failures"] == 4                       # ids 0, 3, 6, 9
    assert st["last"]["req_id"] == 9
    # the ring keeps the newest records
    assert [r.req_id for r in fr.records()] == [6, 7, 8, 9]
    assert [r.req_id for r in fr.records(failures_only=True)] == [6, 9]


def test_concurrent_flight_records_lose_nothing():
    fr = FlightRecorder(capacity=64)
    threads, per = 8, 250

    def hammer(tid):
        for i in range(per):
            fr.record(record_from_marks(tid * per + i, "d", "ok",
                                        [("submit", 0.0), ("done", 1.0)]))

    ts = [threading.Thread(target=hammer, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    st = fr.stats()
    assert st["recorded"] == threads * per           # no lost updates
    assert st["retained"] == 64 == len(fr)           # bound respected
    assert st["dropped"] == threads * per - 64


def test_concurrent_histogram_observes_lose_nothing():
    reg = MetricsRegistry()
    h = reg.histogram("svc.latency_s")
    threads, per = 8, 500

    def hammer():
        for i in range(per):
            h.observe(i * 1e-4)

    ts = [threading.Thread(target=hammer) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    s = h.summary()
    assert s["count"] == threads * per               # count == observes
    assert s["min"] >= 0.0 and s["max"] <= per * 1e-4
    assert s["min"] <= s["p50"] <= s["p95"] <= s["max"]


def test_dump_roundtrip(tmp_path):
    fr = FlightRecorder(capacity=8)
    fr.record(record_from_marks(0, "a", "verified",
                                [("submit", 0.0), ("done", 1.0)]))
    fr.record(record_from_marks(1, "b", "error", [("submit", 0.0)],
                                error="ValueError: nope"))
    path = tmp_path / "flights.json"
    assert fr.dump(path) == 2
    data = json.loads(path.read_text())
    assert [d["req_id"] for d in data] == [0, 1]
    assert fr.dump(path, failures_only=True) == 1


# ---------------------------------------------------------------------------
# service wiring: every ticket leaves a consistent record
# ---------------------------------------------------------------------------

def test_completed_tickets_yield_consistent_flights(rand_params):
    svc = make_service(rand_params)
    tickets = [svc.submit(dataset="csa", bits=4, seed=s, verify=False)
               for s in range(3)]
    for t in tickets:
        assert svc.result(t, timeout=60.0).status == "classified"
    recs = {r.req_id: r for r in svc.flights.records()}
    assert set(tickets) <= set(recs)
    for t in tickets:
        rec = recs[t]
        assert rec.ok and rec.status == "classified"
        check_timeline(rec)
        assert [s for s, _ in rec.marks] == [
            "submit", "prepared", "admitted", "inferred", "done"
        ]
        # a full run has a queue-wait and all stage segments
        assert set(rec.stages) == {"prepare", "queue_wait", "infer",
                                   "finalize"}
        assert rec.bucket is not None and rec.capacity == svc.config.capacity
        assert not rec.cached and not rec.coalesced and not rec.streamed
    st = svc.stats()
    assert st["flights"]["recorded"] >= 3
    assert st["flights"]["failures"] == 0
    # the peaks satellite: gauge high-water marks surface in stats()
    assert st["peaks"]["service.slot_occupancy"] > 0
    svc.close()


def test_cache_hit_and_coalesced_flights_are_flagged(rand_params):
    svc = make_service(rand_params)
    t1 = svc.submit(dataset="csa", bits=4, seed=0, verify=False)
    svc.result(t1, timeout=60.0)
    t2 = svc.submit(dataset="csa", bits=4, seed=0, verify=False)  # cache hit
    assert svc.result(t2, timeout=60.0).cached
    recs = {r.req_id: r for r in svc.flights.records()}
    assert not recs[t1].cached
    hit = recs[t2]
    assert hit.cached and not hit.coalesced
    check_timeline(hit)
    assert [s for s, _ in hit.marks] == ["submit", "done"]
    svc.close()


def test_failed_ticket_flight_carries_name_cause_and_dumps(
        rand_params, tmp_path):
    svc = make_service(rand_params, flight_dump_dir=str(tmp_path))
    t = svc.submit(dataset="no-such-family", bits=8)
    r = svc.result(t, timeout=60.0)
    assert r.status == "error"
    rec = {x.req_id: x for x in svc.flights.records(failures_only=True)}[t]
    assert rec.name == "no-such-family:8"            # attributable name
    assert rec.error and "no-such-family" in rec.error
    assert rec.failed_stage == "prepare"             # died before "prepared"
    check_timeline(rec)
    # dump-on-failure: the forensic trail survives the process
    dump = tmp_path / f"flight_fail_{t}.json"
    assert dump.exists()
    payload = json.loads(dump.read_text())
    assert payload["failure"]["req_id"] == t
    assert payload["failure"]["error"] == rec.error
    assert any(c["req_id"] == t for c in payload["context"])
    assert svc.stats()["flights"]["failures"] >= 1
    svc.close()


def test_session_flights_cover_sync_and_async(rand_params):
    
    with Session(rand_params, SessionConfig(flight_records=32)) as sess:
        r = sess.verify(dataset="csa", bits=4, verify=False, use_cache=False)
        assert r.status == "classified"
        ticket = sess.submit(dataset="csa", bits=4, seed=1, verify=False)
        sess.result(ticket, timeout=60.0)
        flights = sess.flights()
    ids = [f.req_id for f in flights]
    assert -1 in ids                                  # the sync verify
    assert ticket in ids                              # the service ticket
    sync = next(f for f in flights if f.req_id == -1)
    assert [s for s, _ in sync.marks] == ["submit", "prepared", "inferred",
                                          "done"]
    check_timeline(sync)
    for f in flights:
        check_timeline(f)



def seeded_registry() -> MetricsRegistry:
    reg = MetricsRegistry()
    reg.counter("service.device_calls").inc(7)
    g = reg.gauge("service.queue_depth")
    g.set(3)
    g.set(1)                                  # live value 1, high-water 3
    h = reg.histogram("service.infer_s")
    for v in (0.010, 0.020, 0.030, 0.040):
        h.observe(v)
    return reg


# ---------------------------------------------------------------------------
# Prometheus rendering
# ---------------------------------------------------------------------------

def test_sanitize_metric_name():
    assert sanitize_metric_name("service.queue-depth") == "service_queue_depth"
    assert sanitize_metric_name("exec.h2d bytes") == "exec_h2d_bytes"
    assert sanitize_metric_name("0weird").startswith("_")


def test_prometheus_round_trip():
    text = render_prometheus(seeded_registry())
    parsed = parse_prometheus(text)
    assert parsed["repro_service_device_calls_total"] == 7.0
    # gauges export both the live value and the high-water twin
    assert parsed["repro_service_queue_depth"] == 1.0
    assert parsed["repro_service_queue_depth_max"] == 3.0
    # histogram summary: count/sum plus quantile-labelled lines
    assert parsed["repro_service_infer_s_count"] == 4.0
    assert parsed["repro_service_infer_s_sum"] == pytest.approx(0.1)
    assert parsed['repro_service_infer_s{quantile="0.50"}'] > 0.0
    assert parsed['repro_service_infer_s{quantile="0.95"}'] >= (
        parsed['repro_service_infer_s{quantile="0.50"}']
    )
    # every sample line must be within the exposition grammar
    for line in text.splitlines():
        assert line.startswith("#") or parse_prometheus(line), line


def test_sampler_always_leaves_a_line(tmp_path):
    reg = seeded_registry()
    path = tmp_path / "samples.jsonl"
    s = Sampler(path, reg, interval_s=30.0).start()   # run << interval
    n = s.stop()
    assert n >= 1                                     # the closing bookend
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == n
    last = lines[-1]
    assert last["counters"]["service.device_calls"] == 7
    assert last["gauges"]["service.queue_depth"]["max"] == 3
    assert last["histograms"]["service.infer_s"]["count"] == 4
    assert last["elapsed_s"] >= 0.0


def test_sampler_samples_periodically(tmp_path):
    reg = seeded_registry()
    with Sampler(tmp_path / "s.jsonl", reg, interval_s=0.02,
                 extra=lambda: {"pending": 5}) as s:
        time.sleep(0.2)
    assert s.samples >= 3
    line = json.loads(
        (tmp_path / "s.jsonl").read_text().splitlines()[0])
    assert line["pending"] == 5                       # extra() merged in


def test_metrics_server_scrape():
    reg = seeded_registry()
    srv = start_metrics_server(reg, stats_fn=lambda: {"tickets": 12})
    try:
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=10) as r:
            assert r.status == 200
            parsed = parse_prometheus(r.read().decode())
        assert parsed["repro_service_device_calls_total"] == 7.0
        # the scrape is live, not a snapshot-at-start
        reg.counter("service.device_calls").inc(3)
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=10) as r:
            assert parse_prometheus(r.read().decode())[
                "repro_service_device_calls_total"] == 10.0
        with urllib.request.urlopen(f"{srv.url}/stats", timeout=10) as r:
            assert json.loads(r.read()) == {"tickets": 12}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{srv.url}/nope", timeout=10)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# regression sentry
# ---------------------------------------------------------------------------

def bench_payload(**over) -> dict:
    base = {
        "schema": regress.SCHEMA_VERSION,
        "host": regress.host_info(),
        "suite": "service",
        "ok": True,
        "runtime_s": 10.0,
        "report": {"plan_cache_hit_rate": 0.80},
        "tables": [
            {"mode": "service", "req_per_s": 40.0, "p95_ms": 120.0,
             "cold_compiles": 0, "compiles": 3},
            {"mode": "one-shot", "req_per_s": 10.0, "p95_ms": 300.0,
             "cold_compiles": 0, "compiles": 3},
        ],
    }
    base.update(over)
    return base


def test_flatten_keys_table_rows_by_tag():
    flat = regress.flatten(bench_payload())
    assert flat["tables.service.req_per_s"] == 40.0
    assert flat["tables.one-shot.p95_ms"] == 300.0
    assert flat["runtime_s"] == 10.0
    assert flat["report.plan_cache_hit_rate"] == 0.80
    assert "host.machine" not in " ".join(flat)       # fenced, not compared


def test_compare_unperturbed_passes():
    cmp = regress.compare(bench_payload(), bench_payload(), suite="svc")
    assert cmp.ok and not cmp.skipped_timing
    assert len(cmp.findings) > 0
    table = regress.render_table(cmp)
    assert "0 regression(s)" in table


def test_compare_names_metric_and_tolerance_on_regression():
    fresh = bench_payload()
    fresh["tables"][0]["req_per_s"] = 20.0            # -50% > the 30% floor
    cmp = regress.compare(fresh, bench_payload(), suite="svc")
    assert not cmp.ok
    bad = cmp.regressions[0]
    assert bad.key == "tables.service.req_per_s"
    assert bad.rule.kind == "min_ratio" and bad.rule.tol == 0.30
    table = regress.render_table(cmp)
    assert "tables.service.req_per_s" in table and "REGRESSION" in table
    assert "-30%" in table                            # the tolerance, spelled out


def test_compare_rules():
    # runtimes may grow 50%, no further
    slow = bench_payload(runtime_s=14.9)
    assert regress.compare(slow, bench_payload(), suite="s").ok
    slower = bench_payload(runtime_s=15.1)
    assert not regress.compare(slower, bench_payload(), suite="s").ok
    # cold_compiles must match exactly
    cold = bench_payload()
    cold["tables"][0]["cold_compiles"] = 1
    cmp = regress.compare(cold, bench_payload(), suite="s")
    assert [f.key for f in cmp.regressions] == ["tables.service.cold_compiles"]
    # total compiles may shrink but never grow
    grew = bench_payload()
    grew["tables"][0]["compiles"] = 4
    assert not regress.compare(grew, bench_payload(), suite="s").ok
    shrank = bench_payload()
    shrank["tables"][0]["compiles"] = 2
    assert regress.compare(shrank, bench_payload(), suite="s").ok
    # hit rates may sag 5 points
    sagged = bench_payload(report={"plan_cache_hit_rate": 0.76})
    assert regress.compare(sagged, bench_payload(), suite="s").ok
    cratered = bench_payload(report={"plan_cache_hit_rate": 0.70})
    assert not regress.compare(cratered, bench_payload(), suite="s").ok


def test_schema_mismatch_is_a_hard_failure():
    stale = bench_payload(schema=regress.SCHEMA_VERSION - 1)
    with pytest.raises(ValueError, match="schema mismatch"):
        regress.compare(bench_payload(), stale, suite="svc")


def test_host_mismatch_skips_timing_rules_only():
    other = bench_payload()
    other["host"] = dict(other["host"], machine="arm64", device="tpu")
    fresh = bench_payload(runtime_s=99.0)             # 10x slower...
    fresh["tables"][0]["cold_compiles"] = 1           # ...and a counter break
    cmp = regress.compare(fresh, other, suite="svc")
    assert cmp.skipped_timing and "timing rules skipped" in cmp.note
    # the runtime blowup is forgiven (different machine), the counter is not
    assert [f.key for f in cmp.regressions] == ["tables.service.cold_compiles"]
    with pytest.raises(ValueError, match="host mismatch"):
        regress.compare(fresh, other, suite="svc", strict_host=True)


def test_regress_cli_end_to_end(tmp_path, capsys):
    fresh_p = tmp_path / "BENCH_service.json"
    base_dir = tmp_path / "baselines"
    fresh_p.write_text(json.dumps(bench_payload()))
    # no baseline yet: skip with a notice, exit 0
    assert regress.main([str(fresh_p), "--baseline", str(base_dir)]) == 0
    assert "no baseline" in capsys.readouterr().out
    # bless, then an unperturbed re-run passes
    assert regress.main([str(fresh_p), "--baseline", str(base_dir),
                         "--bless"]) == 0
    assert (base_dir / "BENCH_service.json").exists()
    assert regress.main([str(fresh_p), "--baseline", str(base_dir)]) == 0
    # a perturbed run fails, naming the metric in the output
    bad = bench_payload()
    bad["tables"][0]["req_per_s"] = 1.0
    fresh_p.write_text(json.dumps(bad))
    assert regress.main([str(fresh_p), "--baseline", str(base_dir)]) == 1
    assert "tables.service.req_per_s" in capsys.readouterr().out
    # a suite that itself failed is a regression even if metrics pass
    sick = bench_payload(ok=False, error="boom")
    fresh_p.write_text(json.dumps(sick))
    assert regress.main([str(fresh_p), "--baseline", str(base_dir)]) == 1
    # schema mismatch is exit 2
    stale = copy.deepcopy(bench_payload())
    stale["schema"] = regress.SCHEMA_VERSION - 1
    fresh_p.write_text(json.dumps(stale))
    assert regress.main([str(fresh_p), "--baseline", str(base_dir)]) == 2


def test_committed_baselines_match_sentry_schema():
    """The blessed baselines in-repo must be diffable by this sentry."""
    from pathlib import Path

    base_dir = Path(__file__).resolve().parent.parent / "benchmarks" / "baselines"
    paths = sorted(base_dir.glob("BENCH_*.json"))
    assert paths, f"no blessed baselines under {base_dir}"
    for p in paths:
        payload = json.loads(p.read_text())
        assert payload["schema"] == regress.SCHEMA_VERSION, p.name
        assert payload["ok"] is True, p.name
        assert payload["host"]["machine"], p.name
        # self-comparison of a blessed payload is clean by construction
        assert regress.compare(payload, payload, suite=p.name).ok


# ---------------------------------------------------------------------------
# model-vs-actual memory accounting
# ---------------------------------------------------------------------------

def test_streamed_verify_reports_memory_model(rand_params):
    
    cfg = SessionConfig(num_partitions=4, stream_capacity=2)
    with Session(rand_params, cfg) as sess:
        r = sess.verify(dataset="csa", bits=16, verify=False, use_cache=False)
        assert r.routing.mode == "streamed"
        stats = r.exec_stats
        assert stats["modeled_peak_bytes"] > 0
        assert stats["actual_peak_bytes"] > 0
        assert stats["model_drift"] == pytest.approx(
            stats["actual_peak_bytes"] / stats["modeled_peak_bytes"])
        # the model is an upper bound on a single-bucket plan, and actual
        # should be the same order of magnitude (the whole point of the
        # accounting is to catch this ratio drifting)
        assert 0.01 < stats["model_drift"] <= 1.5
        rep = sess.report()
    mm = rep.memory_model
    assert mm is not None
    assert mm["modeled_peak_bytes"] >= stats["modeled_peak_bytes"]
    assert mm["drift"] == pytest.approx(
        mm["actual_peak_bytes"] / mm["modeled_peak_bytes"])
    # peaks are gauges (high-water), never summed into process counters
    assert "exec.modeled_peak_bytes" not in rep.process
    d = rep.to_dict()
    assert d["memory_model"] == mm
    assert d["process_gauges"]["exec.modeled_peak_bytes"]["max"] > 0


def test_full_mode_has_no_memory_model(rand_params):
    
    with Session(rand_params, SessionConfig(num_partitions=1)) as sess:
        r = sess.verify(dataset="csa", bits=4, verify=False, use_cache=False)
        assert r.routing.mode == "full"
        assert "modeled_peak_bytes" not in r.exec_stats
        assert sess.report().memory_model is None


# ---------------------------------------------------------------------------
# obs.check CLI passthrough
# ---------------------------------------------------------------------------

def test_check_forwards_design_and_repeats(tmp_path, monkeypatch):
    from repro_torch.obs import check

    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": []}))
    seen = {}

    def fake_overhead(design, repeats=3):
        seen.update(design=design, repeats=repeats)
        return {"design": design, "repeats": repeats,
                "untraced_s": 1.0, "traced_s": 1.01, "overhead": 0.01}

    monkeypatch.setattr(check, "measure_overhead", fake_overhead)
    monkeypatch.setattr(check, "check_trace", lambda *a: [])
    rc = check.main([str(trace), "--overhead-gate", "0.05",
                     "--design", "csa-8", "--repeats", "5"])
    assert rc == 0
    assert seen == {"design": "csa-8", "repeats": 5}
    # --overhead-design remains valid spelling for the same destination
    rc = check.main([str(trace), "--overhead-gate", "0.05",
                     "--overhead-design", "csa-4"])
    assert seen["design"] == "csa-4" and seen["repeats"] == 3
    assert rc == 0


# ---------------------------------------------------------------------------
# the same requests through both packages: counters and flights agree
# ---------------------------------------------------------------------------

#: process counters whose meaning is the same in both packages (the port
#: counts plan builds and eager forward signatures where the reference
#: counts jit traces, launches where it counts Pallas traces, and stream
#: bytes at the unpadded feature width)
SHARED_PROCESS_COUNTERS = (
    "exec.bytes_h2d", "exec.launches", "exec.runs", "gnn.bytes_staged",
    "gnn.loop_launches", "io.aiger.bytes", "io.aiger.parses",
    "kernels.spmm.edge_stream_gathers", "kernels.spmm.kernel_walks",
    "kernels.spmm.weight_gathers", "pipeline.partition_cuts", "pipeline.prepares",
    "pipeline.verifications", "scheduler.items_run",
)


def _drive(session_cls, config_cls, params, registry, aiger_bytes, **device):
    """Sync verifies on three routes, a cache hit and an AIGER design, then
    five service tickets: a run, its cache hit, an unknown family, garbage
    AIGER and a parsed AIGER design."""
    before = registry.snapshot()
    sess = session_cls(params, config_cls(num_partitions=2, backend="groot", **device))
    try:
        sess.verify(dataset="csa", bits=8)
        sess.verify(dataset="csa", bits=8)
        sess.options(streaming=False).verify(dataset="csa", bits=6, verify=False)
        sess.verify(aiger_bytes)
        results = []
        for design, kw in [(None, dict(dataset="csa", bits=4)),
                           (None, dict(dataset="csa", bits=4)),
                           (None, dict(dataset="nosuch", bits=4)),
                           (b"garbage\n", {}), (aiger_bytes, {})]:
            r = sess.result(sess.submit(design, **kw), timeout=120.0)
            results.append((r.status, r.cached, r.name, r.accuracy))
    finally:
        sess.close()
    flights = [(f.req_id, f.name, f.status, list(f.stages), f.cached, f.coalesced,
                f.failed_stage, f.bucket, f.capacity, f.streamed) for f in sess.flights()]
    delta = registry.delta(before)
    return dict(process={k: delta.get(k, 0) for k in SHARED_PROCESS_COUNTERS},
                session=sess.report().session["counters"], results=results,
                flights=flights)


def test_counters_and_flights_equal_reference(rand_params):
    jax = pytest.importorskip("jax")
    from repro.api import Session as RSession, SessionConfig as RConfig
    from repro.core import aig as RA
    from repro.core import gnn as RG
    from repro.io import aiger as RAiger
    from repro.obs import REGISTRY as RREGISTRY

    data = RAiger.dumps(RA.make_design("csa", 6))
    want = _drive(RSession, RConfig, RG.init_params(RG.GNNConfig(), jax.random.key(0)),
                  RREGISTRY, data)
    got = _drive(_Session, _SessionConfig, rand_params, REGISTRY, data, device="cpu")
    assert got["results"] == want["results"]
    assert got["flights"] == want["flights"]
    assert got["process"] == want["process"]
    # the session's own counters match but for the executor's compile
    # unit (plan builds in the port, jit traces in the reference)
    for counters in (got["session"], want["session"]):
        assert counters.pop("exec.compiles") > 0
    assert got["session"] == want["session"]
