"""Train the reference (JAX) model and export its params for the PyTorch port.

    PYTHONPATH=src python scripts/export_reference_params.py [--out PATH]

Runs ``repro.core.pipeline.train_model("csa", 8, epochs=200, seed=0)`` — the
recipe the reference's own test fixtures use — and writes the params tree
as the flat ``.npz`` that ``repro_torch.core.gnn.load_params`` reads
(default: ``src/repro_torch/data/groot_csa8.npz``).  This script imports the
JAX package; the port itself never does.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

DEFAULT_OUT = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data" / "groot_csa8.npz"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from repro.core import pipeline as P
    from repro_torch.core.gnn import save_params

    params, hist = P.train_model("csa", 8, epochs=args.epochs, seed=args.seed)
    tree = {
        "layers": [{k: np.asarray(v) for k, v in layer.items()} for layer in params["layers"]],
        "head": {k: np.asarray(v) for k, v in params["head"].items()},
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    save_params(tree, args.out)
    print(f"wrote {args.out} ({args.out.stat().st_size} bytes); final loss {hist[-1][1]:.5f}")


if __name__ == "__main__":
    main()
