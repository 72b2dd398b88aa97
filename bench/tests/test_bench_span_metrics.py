"""The readers of the program's spans, ``key_ms``, ``stage_ms`` and
``wait_share``: on a synthetic context, and in the tiny cells' traced runs
of ``test_bench_harness.py``, where each finds its spans."""
from __future__ import annotations

import importlib.util
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
_spec = importlib.util.spec_from_file_location(
    "bench_harness_cases", Path(__file__).resolve().parent / "test_bench_harness.py")
harness_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(harness_cases)


def reader(name):
    sys.path.insert(0, str(ROOT))
    try:
        from bench import loader

        return loader.reader(name)
    finally:
        sys.path.remove(str(ROOT))


def span(name, t0, t1):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, duration=t1 - t0)


def ctx(spans, requests=2):
    return types.SimpleNamespace(spans=spans, requests=requests)


SPANS = [span("exec.stream", 0.0, 4.0), span("exec.wait", 0.0, 1.5), span("exec.launch", 1.5, 2.0),
         span("plan.key", 0.1, 0.4), span("plan.key", 0.4, 0.5), span("gnn.stage", 1.5, 1.6),
         span("exec.stream", 5.0, 6.0), span("exec.wait", 5.0, 5.5)]


@pytest.mark.parametrize("name,want", [("key_ms", 200.0), ("stage_ms", 50.0),
                                       ("wait_share", 40.0)])
def test_reader_on_synthetic_spans(name, want):
    assert reader(name)(ctx(SPANS)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["key_ms", "stage_ms", "wait_share"])
def test_reader_finds_nothing_without_its_spans(name):
    other = [span("exec.launch", 0.0, 1.0), span("plan", 1.0, 1.1)]
    assert reader(name)(ctx([])) is None
    assert reader(name)(ctx(other)) is None


def test_reader_finds_nothing_without_requests():
    assert reader("key_ms")(ctx(SPANS, requests=0)) is None
    assert reader("stage_ms")(ctx(SPANS, requests=0)) is None


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    sys.path.insert(0, str(ROOT))
    try:
        yield harness_cases._tiny_root(tmp_path_factory.mktemp("bench"))
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.parametrize("cell,streamed", [("tiny.full", False), ("tiny.budget", True)])
def test_traced_run_reads_the_span_metrics(tiny_root, cell, streamed):
    code, res, _, _ = harness_cases._run(tiny_root, cell, trace=1)
    assert code == 0 and res["correct"] is True
    metrics = res["metrics"]
    assert metrics["key_ms"]["value"] > 0 and metrics["key_ms"]["unit"] == "ms"
    assert metrics["stage_ms"]["value"] > 0 and metrics["stage_ms"]["unit"] == "ms"
    assert ("wait_share" in metrics) is streamed
    if streamed:
        assert 0 <= metrics["wait_share"]["value"] <= 100
