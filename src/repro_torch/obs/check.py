"""CI trace gate: validate an exported Chrome trace, bound tracing cost.

Run after a traced quickstart/verify has written its trace JSON:

    python -m repro_torch.obs.check trace.json \
        --require parse plan execute verdict \
        --coverage 0.95 --overhead-gate 0.05

Checks, in order:

  1. the trace parses back into spans (export round-trip);
  2. at least one ``session.verify`` root exists, and every ``--require``
     name appears among its *direct* children (the pipeline's top-level
     stages made it into the trace);
  3. each root's direct children cover at least ``--coverage`` of the
    root's wall time (no untraced gaps inside a verify);
  4. with ``--overhead-gate``, a self-contained micro-benchmark verifies
     a small design traced and untraced (best-of-N each) and fails when
     traced wall time exceeds untraced by more than the gate fraction.

Exit status 0 = all gates pass; 1 = any failure (message on stderr).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.trace import span_coverage, spans_from_chrome

ROOT_SPAN = "session.verify"


def check_trace(data: dict, require: list[str], coverage: float) -> list[str]:
    """Return a list of failure messages (empty = pass)."""
    failures: list[str] = []
    spans = spans_from_chrome(data)
    if not spans:
        return [f"trace contains no spans (required: {ROOT_SPAN})"]
    roots = [s for s in spans if s["name"] == ROOT_SPAN]
    if not roots:
        names = sorted({s["name"] for s in spans})
        return [f"no {ROOT_SPAN!r} root span found (saw: {names})"]
    # result-LRU hits never run plan/execute/verdict; their roots are
    # tagged cached=True and exempt from the full-pipeline span checks
    full_roots = [r for r in roots if not r["attrs"].get("cached")]
    if not full_roots:
        return [f"every {ROOT_SPAN} span was a cache hit — nothing to gate"]
    for root in full_roots:
        kids = [s for s in spans if s["parent_id"] == root["span_id"]]
        kid_names = {s["name"] for s in kids}
        missing = [n for n in require if n not in kid_names]
        if missing:
            failures.append(
                f"{ROOT_SPAN} span {root['span_id']} is missing required "
                f"child span(s) {missing} (has: {sorted(kid_names)})"
            )
        cov = span_coverage(spans, root["span_id"])
        if cov < coverage:
            failures.append(
                f"{ROOT_SPAN} span {root['span_id']} child coverage "
                f"{cov:.1%} below the {coverage:.0%} gate"
            )
    return failures


def measure_overhead(design: str = "csa-16", repeats: int = 3,
                     sample: bool = True) -> dict:
    """Best-of-N traced vs untraced verify wall time on a small design.

    Uses fresh params and distinct designs-by-cache-key so neither arm
    benefits from the other's result cache; plan/jit caches are warmed by
    an untimed run first, so the comparison isolates tracer cost rather
    than compile noise.  Both arms run with the flight recorder active
    (every ``Session`` records flights) and, with ``sample=True``, a live
    :class:`~repro_torch.obs.export.Sampler` over the session registry — so the
    gate bounds the cost of the FULL observability stack, not just spans.
    The sessions run on ``cuda``, as every entry point of the port.
    """
    import os
    import tempfile
    import time

    from repro_torch.api import Session, SessionConfig
    from repro_torch.core import gnn
    from repro_torch.obs.export import Sampler

    fam, _, bits = design.partition("-")
    params = gnn.init_params(gnn.GNNConfig(), 0)

    def best(trace: bool) -> float:
        sess = Session(params, SessionConfig(trace=trace))
        kw = dict(dataset=fam, bits=int(bits or 16), verify=False,
                  use_cache=False)
        sess.verify(**kw)  # warm compile/plan caches, untimed
        sampler = None
        if sample:
            fd, path = tempfile.mkstemp(suffix=".jsonl")
            os.close(fd)
            sampler = Sampler(path, sess.obs.metrics, interval_s=0.05).start()
        try:
            t = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                sess.verify(**kw)
                t = min(t, time.perf_counter() - t0)
        finally:
            if sampler is not None:
                sampler.stop()
                os.unlink(sampler.path)
        return t

    untraced = best(False)
    traced = best(True)
    return {
        "design": design,
        "repeats": repeats,
        "untraced_s": untraced,
        "traced_s": traced,
        "overhead": (traced - untraced) / untraced if untraced > 0 else 0.0,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace", help="Chrome-trace JSON written by --trace")
    p.add_argument(
        "--require",
        nargs="*",
        default=["parse", "plan", "execute", "verdict"],
        help="span names that must appear as direct children of every "
        f"{ROOT_SPAN} root",
    )
    p.add_argument(
        "--coverage",
        type=float,
        default=0.95,
        help="minimum fraction of each root's wall time its children cover",
    )
    p.add_argument(
        "--overhead-gate",
        type=float,
        default=None,
        help="also micro-benchmark traced-vs-untraced verify and fail "
        "when traced overhead exceeds this fraction (e.g. 0.05)",
    )
    p.add_argument(
        "--overhead-design",
        "--design",
        dest="overhead_design",
        default="csa-16",
        help="design for the overhead micro-benchmark",
    )
    p.add_argument(
        "--repeats",
        type=int,
        default=3,
        help="timed verifies per arm of the overhead micro-benchmark "
        "(best-of-N)",
    )
    args = p.parse_args(argv)

    with open(args.trace) as f:
        data = json.load(f)
    failures = check_trace(data, args.require, args.coverage)

    n_spans = len(spans_from_chrome(data))
    print(f"{args.trace}: {n_spans} spans", file=sys.stderr)

    if args.overhead_gate is not None:
        m = measure_overhead(args.overhead_design, repeats=args.repeats)
        print(
            f"overhead on {m['design']} (x{m['repeats']}, flights+sampler "
            f"on): traced {m['traced_s'] * 1e3:.2f} ms "
            f"vs untraced {m['untraced_s'] * 1e3:.2f} ms "
            f"({m['overhead']:+.1%})",
            file=sys.stderr,
        )
        if m["overhead"] > args.overhead_gate:
            failures.append(
                f"traced overhead {m['overhead']:.1%} exceeds the "
                f"{args.overhead_gate:.0%} gate"
            )

    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    if not failures:
        print("trace gate: OK", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
