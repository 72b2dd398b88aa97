#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench/run.py --workload csa1024.full --seed 7 --seconds 30 --trace 0

Run from the root of a checkout.  Prints one JSON line last on standard
output (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, and
with ``--trace 1`` ``breakdown``; the numbers compared, with their limits,
under ``checks``), and those numbers again as the last lines of standard
error.  Exits non-zero, printing no result, without the CUDA devices the
cell asks for, or if the run loaded JAX or the JAX package.
"""
import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``bench``) and ``src`` (for ``repro_torch``), in
# place of this script's own directory
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], root=ROOT, t_start=T_START))
