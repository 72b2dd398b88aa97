"""Reduces a ``torch.profiler`` trace of a few requests to what the traced
run reports: the seconds in which an operation ran on the device (the union
of its kernel and copy intervals), the device seconds by kernel name, and
the idle gaps, each put down to the innermost span of the program's tracer
that the calling thread was in at the gap's middle."""
from __future__ import annotations

import re
import threading
import time
from collections import defaultdict

import torch


def _union(spans: list) -> list:
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str, width: int = 100) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list, cut to ``width`` characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:min(cut, width)]


def profile(fn, requests: int, spans_of=None) -> dict:
    """Run ``fn`` ``requests`` times under the profiler.  ``spans_of()``
    returns the program tracer's finished spans (``t0``/``t1`` on the
    ``perf_counter`` clock), or None.  The device events are read from the
    profiler's raw results, named and filtered as its event tree
    (``prof.events()``) has them: building that tree takes minutes for the
    10^6 events of a served LM batch, which a run's time limit cannot hold."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    me = threading.get_ident()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.mark"):
            t_mark = time.perf_counter()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(requests):
            fn()
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    events = [e for e in results.events() if not getattr(e, "is_hidden_event", lambda: False)()]
    mark = next(e for e in events if e.name() == "bench.mark")

    def us(t: float) -> float:
        return (mark.start_ns() - base) / 1e3 + (t - t_mark) * 1e6

    w0, w1 = us(t0), us(t1)
    dev, by_name = [], defaultdict(float)
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        a, b = max((e.start_ns() - base) / 1e3, w0), min((e.end_ns() - base) / 1e3, w1)
        if b > a:
            dev.append((a, b))
            by_name[short_name(torch._C._demangle(e.name()))] += (b - a) / 1e6
    busy = _union(dev)
    spans = [s for s in (spans_of() if spans_of else []) if s.tid == me]
    gaps: dict = defaultdict(float)
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            mid = (edge + a) / 2
            inside = [s for s in spans if us(s.t0) <= mid <= us(s.t1)]
            label = min(inside, key=lambda s: s.t1 - s.t0).name if inside else "outside spans"
            gaps[label] += (a - edge) / 1e6
        edge = max(edge, b)
    return {
        "requests": requests,
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernel_s": dict(by_name),
        "gaps": dict(gaps),
    }
