"""One run of one cell: the arguments, the look for the chips the cell asks
for, the runner of the cell's configuration kind, the metric readers, the
result line and the check that the run loaded no JAX.

The runner (``bench/runners/<kind>.py``, found by ``loader.runner``) makes
the inputs from the seed, sets up, runs the measured window and the traced
segment, and judges what the timed path produced against the plain
reference.  Its ``run(args, cell, device)`` returns (exit code, ctx): ``ctx``
holds ``correct``, ``attempted``, ``failed``, ``requests``, ``checks`` (name
-> (value, limit)), ``memory_peak_bytes``, ``profile`` (a
``bench/profile.py`` reduction, or None) and whatever the cell's metric
readers read.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from bench import loader

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="bench/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(argv, *, root: Path, t_start: float,
        device: str | None = None) -> tuple[int, dict | None]:
    """One run; returns (exit code, result).  ``device="cpu"`` skips the look
    for a chip and runs the program's plain versions (the harness's tests)."""
    args = parse(argv)
    args.t_start = t_start
    cell = loader.load_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"bench: {cell.name} needs {cell.chips} CUDA device(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
            return 3, None
        device = "cuda"
    dev = torch.device(device)
    code, ctx = loader.runner(cell.kind).run(args, cell, dev)
    if code != 0:
        return code, None

    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        v = loader.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(ctx.correct),
        "attempted": ctx.attempted,
        "failed": ctx.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": cell.chips,
            "memory_peak_bytes": ctx.memory_peak_bytes,
        },
        "requests": ctx.requests,
    }
    profile = ctx.profile
    if profile is not None:
        result["device"]["busy_s"] = profile["busy_s"]
        result["device"]["window_s"] = profile["window_s"]
        top = sorted(profile["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(profile["gaps"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [list(kv) for kv in top],
                               "idle_gaps": [list(kv) for kv in gaps]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in ctx.checks.items()}
    for k, (v, lim) in ctx.checks.items():
        log(f"check {k} {v!r} limit {lim!r}")
    return 0, result


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, *, root: Path, t_start: float) -> int:
    code, result = run(argv, root=root, t_start=t_start)
    if code != 0:
        return code
    bad = forbidden_modules()
    if bad:
        log(f"bench: the run loaded {', '.join(bad)}; the benchmark measures repro_torch alone")
        return 4
    print(json.dumps(result), flush=True)
    return 0
