"""A configuration's design, from the frozen generators.

Generating a 1,024-bit multiplier in Python takes tens of seconds, so the
arrays are kept in ``bench/.cache/designs/<generator>-<bits>.npz`` inside the
checkout: a cell's first run there writes them, later runs read them.  The
csa and Booth generators take no seed, so neither does the key."""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from bench.reference.generators import GENERATORS

CACHE = Path(__file__).resolve().parent / ".cache" / "designs"
_ARRAYS = ("kind", "fanin0", "fanin1", "label", "pos")


def load(design: dict) -> dict:
    gen, bits = design["generator"], int(design["bits"])
    path = CACHE / f"{gen}-{bits}.npz"
    if path.exists():
        with np.load(path) as z:
            out = {k: z[k] for k in _ARRAYS}
            out["n_pi"] = int(z["n_pi"])
            out["name"] = str(z["name"])
        return out
    out = GENERATORS[gen](bits)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, n_pi=out["n_pi"], name=out["name"], **{k: out[k] for k in _ARRAYS})
    os.replace(tmp, path)
    return out
