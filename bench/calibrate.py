#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, on the chip.

    python3 bench/calibrate.py --workload csa1024.full --seeds 1-12 --out <file.json>

Runs the ``calibrate(cell, seeds, out, device)`` of the runner of the
cell's configuration kind (``bench/runners/<kind>.py``), in one process: for
each seed, the numbers a run compares, read for the program on its timed
path and for controls that compute in the precision below the one the
configuration states (and, where the runner has them, for faults planted
in the program).  A sound limit lies above every program reading and below
every control reading.  Writes one JSON object a reading to ``--out`` and
prints it, then each number's range.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import loader  # noqa: E402


def seeds(spec: str) -> list[int]:
    out = []
    for part in spec.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,9,2147483700")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cell = loader.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    with open(args.out, "w") as fh:
        rows = loader.runner(cell.kind).calibrate(cell, seeds(args.seeds), fh,
                                                  torch.device("cuda"))
    for key in sorted({k for r in rows for k in r if k.startswith(("gap_", "err_"))}):
        vals = [r[key] for r in rows if key in r]
        print(f"{key}: min {min(vals)!r} max {max(vals)!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
