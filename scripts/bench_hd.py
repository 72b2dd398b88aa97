#!/usr/bin/env python3
"""Time K2 and K6 (the HD rows' kernels) over csa-<bits>'s fanout HD rows.

    python3 scripts/bench_hd.py [--bits 1024] [--reps 50] [--seed 0] [--label NAME]

Run from the root of a checkout: it imports that checkout's
``src/repro_torch`` and builds its kernels, and it calls only the wrappers'
public signatures (``hd_grouped_apply``, ``hd_apply``), so the same file
times an older checkout too.  For f32 and bf16 streams at F = 32 and the
4-wide first layer it holds each kernel against its plain version
(|kernel - plain| <= 1e-5 * max(1, max|plain|)) and times it four ways,
K2 with the fanout's two staged group weights, K6 with one weight column:
``call_ms``, one call between CUDA events after a synchronize (median of
``--reps``, as ``chip_smoke.py`` times a kernel: the wrapper's host work
before the launch included); ``stream_ms``, ``--reps`` calls back to back
between two events, over ``--reps`` (the larger of the host's and the
card's time a call); ``device_ms``, the card's time in the wrapper's
kernels a call, from ``torch.profiler`` over ``--reps`` calls; and
``host_ms``, the host's time to enqueue a call.  Prints the card's name and
power limit, one line a shape, and a last line of JSON.  Needs one CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bits", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default=ROOT.name)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_hd: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import gnn
    from repro_torch.core import pipeline as P
    from repro_torch.kernels import groot_spmm as gs
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    g = P.prepare(P.PipelineConfig(dataset="csa", bits=args.bits)).graph
    n = g.num_nodes
    pair = ops.make_agg_pair(g.edge_src, g.edge_dst, n, "groot", device=dev)
    plan = pair.out_plan
    if plan.hd is None:
        print(f"bench_hd: csa-{args.bits} has no HD rows", file=sys.stderr)
        return 2
    src, dst, inv, slot = gnn.graph_tensors(g, dev)
    _, wg_out = gnn.grouped_edge_weights(src, dst, inv, slot, n)
    dp = plan.on(dev)
    n_hd = plan.hd.rows.shape[0]
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def time_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def stream_ms(fn) -> tuple[float, float]:
        """(card-or-host ms a call back to back, host enqueue ms a call)."""
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / args.reps
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps, host

    def device_ms(fn) -> dict:
        """The card's ms a call in each kernel the wrapper launches."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        return {e.key.split("(")[0][-40:]: e.self_device_time_total / 1e3 / args.reps
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total}

    rows = []
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        staged = pair.fwd_plan.stage_out(wg_out, dtype=None if tag == "f32" else dtype)
        _, w_hd = gs.stage_weight(plan, wg_out[:, 0].contiguous(), dtype)
        for feat in (32, 4):
            x = torch.randn((n + 1, feat), generator=gen, device=dev)
            x[-1] = 0
            xs = x.to(dtype)
            runs = {
                "K2": (lambda o: gs.hd_grouped_apply(xs, dp.hd_cols, staged.hd, dp.hd_meta,
                                                     dp.hd_row_chunks, plan.e_t, out=o),
                       lambda: gs.hd_grouped_plain(xs, dp.hd_cols, staged.hd, dp.hd_meta, n_hd,
                                                   plan.e_t)),
                "K6": (lambda o: gs.hd_apply(xs, dp.hd_cols, dp.hd_meta, dp.hd_row_chunks,
                                             plan.e_t, w_hd, out=o),
                       lambda: gs.hd_plain(xs, dp.hd_cols, dp.hd_meta, plan.e_t, w_hd)),
            }
            for kid, (run, plain) in runs.items():
                got = run(None)
                want = plain()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                limit = TOL * max(1.0, want.abs().max().item())
                if not (torch.isfinite(got).all() and err <= limit):
                    print(f"bench_hd: {kid} {tag} F={feat}: error {err:.3e} over {limit:.3e}",
                          file=sys.stderr)
                    return 1
                call = time_ms(lambda: run(got))
                back, host = stream_ms(lambda: run(got))
                by_kernel = device_ms(lambda: run(got))
                dev_ms = sum(by_kernel.values())
                rows.append(dict(kernel=kid, dtype=tag, feat=feat, call_ms=call, stream_ms=back,
                                 device_ms=dev_ms, host_ms=host, device_by_kernel=by_kernel,
                                 max_abs_err=err))
                print(f"{args.label}: {kid} {tag} F={feat:2d} call {call:.4f} ms, back to back "
                      f"{back:.4f}, device {dev_ms:.4f}, host {host:.4f} (max_abs_err "
                      f"{err:.3e}); device by kernel "
                      f"{json.dumps({k: round(v, 4) for k, v in by_kernel.items()})}", flush=True)
                del got, want
    print(json.dumps({"label": args.label, "device": smi, "bits": args.bits,
                      "hd_rows": n_hd, "chunks": plan.hd.num_chunks, "times": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
