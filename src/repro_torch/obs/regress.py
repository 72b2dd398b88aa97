"""Perf-regression sentry: diff fresh BENCH JSONs against blessed baselines.

``benchmarks/run.py --json`` writes one ``BENCH_<suite>.json`` per suite;
until now those were upload-only artifacts with nothing to compare
against, so the perf trajectory across PRs was unobservable.  This module
closes the loop:

    python -m repro_torch.obs.regress BENCH_service.json \
        --baseline benchmarks/baselines/

walks every numeric metric shared by the fresh payload and the committed
baseline, applies a per-metric tolerance rule (runtimes may grow 50%,
throughput may drop 30%, cache hit-rates may sag 5 points, cold-compile
counts must match exactly, total compiles may only shrink), prints a
human table, and exits nonzero naming the first offending metric and its
tolerance — which is exactly the message CI shows on a perf regression.

Environment fencing: payloads carry a ``schema`` version and a ``host``
fingerprint (platform / torch version / device kind — see
:func:`host_info`, stamped by ``benchmarks/run.py``).  A schema mismatch
is a hard failure (the comparison would be meaningless); a *host*
mismatch is a skip-with-notice by default — committed baselines come
from one machine and CI runners are another, and cross-environment
runtime diffs are noise, not signal.  ``--strict-host`` upgrades the
skip to a failure for same-fleet setups.  Counter-equality rules still
run on a host mismatch (they are environment-independent).

Blessing a new baseline after an intentional perf change::

    python -m benchmarks.run --json --suites grouped service partitioned
    python -m repro_torch.obs.regress BENCH_service.json \
        --baseline benchmarks/baselines/ --bless
"""
from __future__ import annotations

import argparse
import fnmatch
import json
import os
import platform
import shutil
import sys
from dataclasses import dataclass
from typing import Optional

#: bump when the BENCH payload layout changes incompatibly; the sentry
#: refuses to diff across schema versions
SCHEMA_VERSION = 2


def host_info() -> dict:
    """Environment fingerprint stamped into every BENCH payload: the torch
    version and, when a card is present, its name."""
    info = {
        "platform": platform.platform(),
        "machine": platform.machine(),
        "python": platform.python_version(),
        "torch": None,
        "device": None,
    }
    try:
        import torch

        info["torch"] = torch.__version__
        info["device"] = (torch.cuda.get_device_name()
                          if torch.cuda.is_available() else "cpu")
    except Exception:  # noqa: BLE001 — fingerprinting must never fail a bench
        pass
    return info


def hosts_comparable(a: Optional[dict], b: Optional[dict]) -> bool:
    """Timing numbers are only comparable on matching machine+device."""
    if not a or not b:
        return False
    keys = ("machine", "device", "torch")
    return all(a.get(k) == b.get(k) for k in keys)


# ---------------------------------------------------------------------------
# tolerance rules


@dataclass(frozen=True)
class Rule:
    """One tolerance policy, matched against the metric's leaf key."""

    pattern: str          # fnmatch over the path's final component
    kind: str             # max_ratio | min_ratio | floor_abs | equal | ceiling
    tol: float = 0.0
    timing: bool = True   # timing rules are skipped on host mismatch

    def check(self, base: float, fresh: float) -> tuple[bool, str]:
        """(ok, human detail).  ``base`` is the blessed value."""
        if self.kind == "max_ratio":
            # fresh may exceed base by at most tol (0.5 -> 1.5x allowed)
            limit = base * (1.0 + self.tol)
            return fresh <= limit or base == 0.0, (
                f"fresh {fresh:.6g} vs base {base:.6g} "
                f"(allowed <= {limit:.6g}, +{self.tol:.0%})"
            )
        if self.kind == "min_ratio":
            limit = base * (1.0 - self.tol)
            return fresh >= limit, (
                f"fresh {fresh:.6g} vs base {base:.6g} "
                f"(allowed >= {limit:.6g}, -{self.tol:.0%})"
            )
        if self.kind == "floor_abs":
            limit = base - self.tol
            return fresh >= limit, (
                f"fresh {fresh:.6g} vs base {base:.6g} "
                f"(allowed >= {limit:.6g}, floor -{self.tol:g})"
            )
        if self.kind == "equal":
            return fresh == base, f"fresh {fresh:g} vs base {base:g} (must be equal)"
        if self.kind == "ceiling":
            return fresh <= base, f"fresh {fresh:g} vs base {base:g} (must not grow)"
        raise ValueError(f"unknown rule kind {self.kind!r}")


#: first match wins; deliberately NO equality rules on timing-racy
#: counters (``coalesced`` varies with scheduler interleaving)
DEFAULT_RULES = (
    Rule("cold_compiles", "equal", timing=False),
    Rule("compiles", "ceiling", timing=False),
    Rule("*hit_rate", "floor_abs", 0.05, timing=False),
    Rule("*accuracy*", "floor_abs", 0.01, timing=False),
    Rule("req_per_s", "min_ratio", 0.30),
    Rule("*throughput*", "min_ratio", 0.30),
    Rule("runtime_s", "max_ratio", 0.50),
    Rule("*wall_s", "max_ratio", 0.50),
    Rule("*_ms", "max_ratio", 0.50),
    Rule("*_s", "max_ratio", 0.50),
)


def rule_for(key: str, rules=DEFAULT_RULES) -> Optional[Rule]:
    leaf = key.rsplit(".", 1)[-1]
    for r in rules:
        if fnmatch.fnmatch(leaf, r.pattern):
            return r
    return None


# ---------------------------------------------------------------------------
# payload flattening


_SKIP_KEYS = {"schema", "host", "error", "title"}


def flatten(payload: dict, prefix: str = "") -> dict[str, float]:
    """Dotted-path -> numeric value over the whole payload.

    Lists of row-dicts (the ``tables`` section) are keyed by each row's
    first value so rows pair up across runs regardless of order; plain
    lists are indexed.  Non-numeric leaves are dropped — the sentry only
    reasons about numbers.
    """
    out: dict[str, float] = {}
    for key, val in payload.items():
        if not prefix and key in _SKIP_KEYS:
            continue
        path = f"{prefix}{key}"
        if isinstance(val, bool):
            out[path] = float(val)
        elif isinstance(val, (int, float)):
            out[path] = float(val)
        elif isinstance(val, dict):
            out.update(flatten(val, prefix=path + "."))
        elif isinstance(val, list):
            for i, item in enumerate(val):
                if isinstance(item, dict):
                    tag = None
                    for v in item.values():
                        if isinstance(v, str):
                            tag = v
                            break
                    sub = tag if tag is not None else str(i)
                    out.update(flatten(item, prefix=f"{path}.{sub}."))
                elif isinstance(item, (int, float)) and not isinstance(item, bool):
                    out[f"{path}.{i}"] = float(item)
    return out


# ---------------------------------------------------------------------------
# comparison


@dataclass(frozen=True)
class Finding:
    key: str
    rule: Rule
    base: float
    fresh: float
    ok: bool
    detail: str


@dataclass
class Comparison:
    suite: str
    findings: list
    skipped_timing: bool = False      # host mismatch -> timing rules idle
    note: str = ""

    @property
    def regressions(self) -> list:
        return [f for f in self.findings if not f.ok]

    @property
    def ok(self) -> bool:
        return not self.regressions


def compare(fresh: dict, base: dict, *, suite: str = "?",
            rules=DEFAULT_RULES, strict_host: bool = False) -> Comparison:
    """Diff two BENCH payloads; raises ValueError on schema mismatch."""
    fs, bs = fresh.get("schema"), base.get("schema")
    if fs != bs:
        raise ValueError(
            f"schema mismatch for {suite}: fresh={fs!r} baseline={bs!r} "
            f"— re-bless the baseline (sentry schema {SCHEMA_VERSION})"
        )
    same_host = hosts_comparable(fresh.get("host"), base.get("host"))
    if not same_host and strict_host:
        raise ValueError(
            f"host mismatch for {suite}: fresh={fresh.get('host')} "
            f"baseline={base.get('host')} (--strict-host)"
        )
    f_flat, b_flat = flatten(fresh), flatten(base)
    findings: list[Finding] = []
    for key in sorted(f_flat.keys() & b_flat.keys()):
        rule = rule_for(key, rules)
        if rule is None:
            continue
        if rule.timing and not same_host:
            continue
        ok, detail = rule.check(b_flat[key], f_flat[key])
        findings.append(Finding(key, rule, b_flat[key], f_flat[key], ok, detail))
    note = "" if same_host else (
        "host differs from baseline; timing rules skipped "
        "(counter rules still enforced)"
    )
    return Comparison(suite=suite, findings=findings,
                      skipped_timing=not same_host, note=note)


def render_table(cmp: Comparison) -> str:
    rows = [("metric", "rule", "baseline", "fresh", "verdict")]
    for f in cmp.findings:
        rows.append((
            f.key,
            f"{f.rule.kind}({f.rule.tol:g})" if f.rule.tol else f.rule.kind,
            f"{f.base:.6g}",
            f"{f.fresh:.6g}",
            "ok" if f.ok else "REGRESSION",
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(5)]
    lines = [f"== regress: {cmp.suite} =="]
    if cmp.note:
        lines.append(f"   note: {cmp.note}")
    for j, r in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    n_bad = len(cmp.regressions)
    lines.append(
        f"{len(cmp.findings)} metrics checked, {n_bad} regression(s)"
        + ("" if cmp.ok else f" — first: {cmp.regressions[0].key} "
           f"[{cmp.regressions[0].detail}]")
    )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI


def _baseline_path(baseline: str, fresh_path: str) -> str:
    # baseline files are always *.json; anything else is a directory
    # (which --bless may still need to create)
    if os.path.isdir(baseline) or not baseline.endswith(".json"):
        return os.path.join(baseline, os.path.basename(fresh_path))
    return baseline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="Gate BENCH_<suite>.json files against blessed baselines.",
    )
    ap.add_argument("fresh", nargs="+",
                    help="freshly generated BENCH_<suite>.json file(s)")
    ap.add_argument("--baseline", required=True,
                    help="baseline file, or directory holding same-named files")
    ap.add_argument("--bless", action="store_true",
                    help="copy the fresh payload(s) over the baseline and exit")
    ap.add_argument("--strict-host", action="store_true",
                    help="fail (instead of skipping timing rules) on host mismatch")
    args = ap.parse_args(argv)

    rc = 0
    for fresh_path in args.fresh:
        base_path = _baseline_path(args.baseline, fresh_path)
        suite = os.path.basename(fresh_path)
        if args.bless:
            os.makedirs(os.path.dirname(base_path) or ".", exist_ok=True)
            shutil.copyfile(fresh_path, base_path)
            print(f"blessed {fresh_path} -> {base_path}")
            continue
        if not os.path.exists(base_path):
            print(f"== regress: {suite} ==\n   no baseline at {base_path}; "
                  f"skipping (bless one with --bless)")
            continue
        with open(fresh_path) as f:
            fresh = json.load(f)
        with open(base_path) as f:
            base = json.load(f)
        try:
            cmp = compare(fresh, base, suite=suite,
                          strict_host=args.strict_host)
        except ValueError as e:
            print(f"== regress: {suite} ==\n   ERROR: {e}")
            rc = 2
            continue
        print(render_table(cmp))
        if not cmp.ok:
            rc = 1
        if not fresh.get("ok", True):
            print(f"   suite itself reported ok=false "
                  f"({fresh.get('error') or 'no error recorded'})")
            rc = rc or 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
