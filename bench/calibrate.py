#!/usr/bin/env python3
"""Readings that a cell's correctness limit is set from, on the chip.

    python3 bench/calibrate.py --workload csa1024.full --seeds 1-12 --out <file.json>

For each seed, in one process (set-up once), the two numbers a run
compares, read for the program on its timed path (``Session.verify`` as the
window calls it) and for two controls that compute in a lower precision
than the configuration's float32: the reference with TF32 products in the
program's place, and the program with its own bfloat16 edge streams.
``gap``: the widest logit gap of the predicted classes against the
reference's own derivation; ``err``: the logits' relative error against the
reference on the program's own inputs.  A sound limit lies above every
program reading and below every control reading.  Writes one JSON object a
seed to ``--out`` and prints it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import designs, harness, loader  # noqa: E402


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
    dev = torch.device("cuda")
    from repro_torch.api.config import SessionConfig
    from repro_torch.api.session import Session
    from repro_torch.core import aig as A
    from repro_torch.core.gnn import GNNConfig

    config, mix = cell.config, cell.mix
    arrays = designs.load(config["design"])
    design = A.AIG(name=arrays["name"], kind=arrays["kind"], fanin0=arrays["fanin0"],
                   fanin1=arrays["fanin1"], label=arrays["label"], n_pi=arrays["n_pi"],
                   pos=arrays["pos"])
    base = Session(config=SessionConfig(
        dataset=config["design"]["generator"], bits=int(config["design"]["bits"]),
        backend=config["backend"], gnn=GNNConfig(**config["gnn"]), device="cuda",
        **mix["session"]))
    prep = base.prepare(design)
    rows = []
    with open(args.out, "w") as fh:
        for seed in seeds(args.seeds):
            t0 = time.perf_counter()
            params = harness.make_params(config["gnn"], seed, dev)
            base.set_params(harness._numpy_tree(params))
            low = base.options(stream_dtype="bfloat16")
            kw = dict(prepared=prep, verify=False, use_cache=False, return_predictions=True)
            with harness.LogitCapture(params, tf32_control=True) as cap:
                res = base.verify(**kw)
            pred, k = res.predictions, res.routing.k
            with harness.LogitCapture(params) as cap_bf16:
                pred_bf16 = low.verify(**kw).predictions
            logits, _, _, ref_k = harness.reference_logits(arrays, params, config, mix, dev)
            control, _, _, _ = harness.reference_logits(arrays, params, config, mix, dev,
                                                        tf32=True)
            row = {
                "seed": seed,
                "gap_program": harness.logit_gap(logits, pred),
                "gap_tf32": harness.logit_gap(logits, control.argmax(1).cpu().numpy()),
                "gap_program_bf16": harness.logit_gap(logits, pred_bf16),
                "err_program": cap.worst,
                "err_tf32": cap.worst_tf32,
                "err_program_bf16": cap_bf16.worst,
                "differing_program": int((logits.argmax(1).cpu().numpy() != pred).sum()),
                "differing_tf32": int((logits.argmax(1) != control.argmax(1)).sum()),
                "k": k, "reference_k": ref_k, "s": time.perf_counter() - t0,
            }
            del logits, control
            rows.append(row)
            fh.write(json.dumps(row) + "\n")
            fh.flush()
            print(json.dumps(row), flush=True)
    for key in ("gap_program", "gap_tf32", "gap_program_bf16", "err_program", "err_tf32",
                "err_program_bf16"):
        vals = [r[key] for r in rows]
        print(f"{key}: min {min(vals)!r} max {max(vals)!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
