"""The port's spans inside a request (CPU): what the full route's
``gnn.predict``, the streamed route's ``exec.stream``, ``exec.pack`` and
``exec.launch`` hold, the bytes the ``gnn.stage`` and ``plan.key`` spans
report, and the profiler ranges a span opens only while tracing is on and a
``torch.profiler`` records.
"""
from __future__ import annotations

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._C._profiler import _ExperimentalConfig  # noqa: E402

from repro_torch.api import Session, SessionConfig  # noqa: E402
from repro_torch.core import aig as A  # noqa: E402
from repro_torch.core import features as F  # noqa: E402
from repro_torch.core import gnn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import plan_cache as pc  # noqa: E402
from repro_torch.obs import Tracer, span_coverage  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.service.bucketing import BucketShape, item_from_subgraph, pack_batch  # noqa: E402
from repro_torch.service.scheduler import BucketRunner  # noqa: E402

#: the full route at csa-48: a ``groot`` predict of some tens of ms on the CPU
FULL = dict(backend="groot", num_partitions=1)
#: the streamed route: four partitions, one a launch, prefetched
STREAMED = dict(backend="groot", num_partitions=4, stream_capacity=1, stream_prefetch=1)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return gnn.init_params(gnn.GNNConfig(), 0)


def traced_verify(params, bits: int, *, trace: bool = True, **knobs):
    """The second of two verifies of csa-``bits`` (the first builds the
    plans) and its spans, every thread's."""
    sess = Session(params, SessionConfig(device="cpu", trace=trace, **knobs))
    for _ in range(2):
        r = sess.verify(dataset="csa", bits=bits, verify=False, use_cache=False)
    return r, (r.trace.spans() if trace else [])


def children(spans, parent, *, same_thread: bool = False):
    return [s for s in spans if s.parent_id == parent.span_id
            and (not same_thread or s.tid == parent.tid)]


def only(spans, name):
    got = [s for s in spans if s.name == name]
    assert len(got) == 1, [s.name for s in spans]
    return got[0]


# ---------------------------------------------------------------------------
# The full route
# ---------------------------------------------------------------------------

def test_full_route_predict_holds_stage_key_forward_readback(params):
    r, spans = traced_verify(params, 48, **FULL)
    assert r.routing.mode == "full"
    predict = only(spans, "gnn.predict")
    kids = children(spans, predict)
    assert {s.name for s in kids} == {"gnn.stage", "plan.key", "gnn.forward", "gnn.readback"}
    assert collections.Counter(s.name for s in kids) == {
        "gnn.stage": 2, "plan.key": 1, "gnn.forward": 1, "gnn.readback": 1}
    # each verify prepares a new graph object: its keys are hashed anew
    assert only(kids, "plan.key").attrs["memo"] == "miss"
    assert predict.duration >= 0.010
    assert span_coverage(spans, predict.span_id) >= 0.9


def test_stage_bytes_are_the_staged_tensors(params):
    g = A.make_design("csa", 12).to_edge_graph()
    feats = F.groot_features(A.make_design("csa", 12))
    tr = Tracer()
    with tr.activate():
        gnn.predict(params, g, feats, backend="groot", device="cpu")
    stages = [s for s in tr.spans() if s.name == "gnn.stage"]
    assert [s.attrs["bytes"] for s in stages] == [
        gnn.staged_bytes(gnn.graph_tensors(g, "cpu")),
        np.asarray(feats, np.float32).nbytes]
    assert stages[0].attrs["bytes"] == 16 * g.num_edges + g.edge_inv.nbytes + g.edge_slot.nbytes


def test_plan_key_once_per_hash_with_the_bytes_hashed():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 50, 40).astype(np.int32)
    dst = rng.integers(0, 50, 40)
    tr = Tracer()
    with tr.activate():
        pc.graph_key(src, dst, 50)
        pc.graph_key(list(src[:7]), list(dst[:7]), 50)
        pc.structure_keys(src, dst, 50)
    keys = [s for s in tr.spans() if s.name == "plan.key"]
    hashed = [len(np.int64(50).tobytes() + np.asarray(a, np.int64).tobytes() + b"|"
                  + np.asarray(b, np.int64).tobytes()) for a, b in
              ((src, dst), (src[:7], dst[:7]), (src, dst), (dst, src))]
    assert [s.attrs["bytes"] for s in keys] == hashed == [649, 121, 649, 649]


# ---------------------------------------------------------------------------
# The streamed route
# ---------------------------------------------------------------------------

def test_stream_consumer_waits_or_launches(params):
    r, spans = traced_verify(params, 32, **STREAMED)
    assert r.routing.mode == "streamed" and r.exec_stats["batches"] >= 2
    stream = only(spans, "exec.stream")
    mine = [s for s in spans if s.tid == stream.tid]
    assert {s.name for s in children(mine, stream)} == {"exec.wait", "exec.launch"}
    assert span_coverage(mine, stream.span_id) >= 0.9


def test_pack_holds_gather_and_keys_on_the_prefetch_thread(params):
    _, spans = traced_verify(params, 32, **STREAMED)
    packs = [s for s in spans if s.name == "exec.pack"]
    assert len(packs) >= 2
    for pack in packs:
        assert pack.thread == "exec-prefetch"
        kids = children(spans, pack)
        assert collections.Counter(s.name for s in kids) == {"exec.gather": 1, "plan.key": 2}
        assert all(s.tid == pack.tid for s in kids)
        # the slot's new Subgraph object is hashed; the packed arrays' keys
        # come from the first verify's entry for the same recipe
        assert [s.attrs["memo"] for s in sorted(kids, key=lambda s: s.t0)
                if s.name == "plan.key"] == ["miss", "hit"]


def test_launch_holds_stage_forward_readback(params):
    _, spans = traced_verify(params, 32, **STREAMED)
    launches = [s for s in spans if s.name == "exec.launch"]
    assert len(launches) >= 2
    for launch in launches:
        assert [s.name for s in sorted(children(spans, launch), key=lambda s: s.t0)] == [
            "gnn.stage", "gnn.forward", "gnn.readback"]
        assert span_coverage(spans, launch.span_id) >= 0.9


def test_runner_stage_bytes_count_a_new_structure_once(params):
    g = A.make_design("csa", 8).to_edge_graph()
    feats = np.ones((g.num_nodes, 4), np.float32)
    from repro_torch.core.regrowth import Subgraph

    sub = Subgraph(global_ids=np.arange(g.num_nodes), num_core=g.num_nodes,
                   edge_src=g.edge_src, edge_dst=g.edge_dst, edge_inv=g.edge_inv,
                   edge_slot=g.edge_slot)
    item = item_from_subgraph(0, 0, sub, feats)
    batch = pack_batch([item], BucketShape(512, 1024), 1)
    gkeys = pc.structure_keys(batch["edge_src"], batch["edge_dst"], batch["num_nodes"])
    runner = BucketRunner(params, "groot", device="cpu")
    tr = Tracer()
    with tr.activate():
        runner(batch, gkeys)
        runner(batch, gkeys)
    first, again = [s.attrs["bytes"] for s in tr.spans() if s.name == "gnn.stage"]
    per_launch = sum(batch[k].nbytes for k in ("x", "edge_inv", "edge_slot"))
    held = runner._held
    assert again == per_launch
    assert first == per_launch + held[1].nbytes + held[2].nbytes + \
        ops.device_nbytes(held[3], "cpu")
    assert ops.device_nbytes(held[3], "cpu") > 0
    runner.release()


# ---------------------------------------------------------------------------
# Profiler ranges
# ---------------------------------------------------------------------------

def all_threads_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))


def names_by_thread(items, thread, names) -> list:
    """One sorted name list a thread, over the items whose name is in ``names``."""
    got = collections.defaultdict(list)
    for it in items:
        if it.name in names:
            got[thread(it)].append(it.name)
    return sorted(sorted(v) for v in got.values())


def test_traced_spans_open_one_profiler_range_each_on_their_thread(params):
    sess = Session(params, SessionConfig(device="cpu", trace=True, **STREAMED))
    sess.verify(dataset="csa", bits=16, verify=False, use_cache=False)
    with all_threads_profile() as prof:
        r = sess.verify(dataset="csa", bits=16, verify=False, use_cache=False)
    spans = r.trace.spans()
    names = {s.name for s in spans}
    assert {"exec.pack", "exec.gather", "plan.key", "exec.wait", "gnn.forward"} <= names
    assert len({s.tid for s in spans}) == 2           # the consumer and the prefetch thread
    assert names_by_thread(prof.events(), lambda e: e.thread, names) == \
        names_by_thread(spans, lambda s: s.tid, names)


def test_untraced_spans_reach_no_profiler(params):
    _, spans = traced_verify(params, 32, **STREAMED)
    names = {s.name for s in spans}
    sess = Session(params, SessionConfig(device="cpu", trace=False, **STREAMED))
    with all_threads_profile() as prof:
        sess.verify(dataset="csa", bits=16, verify=False, use_cache=False)
    assert names and not names & {e.name for e in prof.events()}


def test_no_profiler_range_without_a_profiler(params, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened with no profiler on")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for knobs in (FULL, STREAMED):
        _, spans = traced_verify(params, 12, **knobs)
        assert spans


def test_profiler_range_closes_when_the_span_raises():
    tr = Tracer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.activate(), pytest.raises(ValueError):
            with obs_trace.span("raising"):
                raise ValueError("inside")
        with tr.activate(), obs_trace.span("after"):
            pass
    assert [s.name for s in tr.spans()] == ["raising", "after"]
    assert sorted(e.name for e in prof.events() if e.name in {"raising", "after"}) == [
        "after", "raising"]


def test_untraced_routes_record_no_span(params, monkeypatch):
    def refuse(self):
        raise AssertionError(f"span {self.name!r} recorded with tracing off")

    monkeypatch.setattr(obs_trace._SpanCtx, "__enter__", refuse)
    for knobs in (FULL, STREAMED):
        r, _ = traced_verify(params, 12, trace=False, **knobs)
        assert r.trace is None and r.status == "classified"
