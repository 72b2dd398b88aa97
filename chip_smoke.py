#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--bits 1024] [--reps 10] [--seed 0]

Phases (any failure raises and the script exits non-zero):

 1. device    the card's name and power limit (``nvidia-smi``)
 2. build     the CUDA kernels, compiled from ``src/repro_torch/csrc`` (timed)
 3. parity    every kernel of the full-graph path (K1 grouped LD, K2 grouped
              HD, K3 grouped fused LD) against its plain PyTorch version at
              the csa-<bits> shapes: each fanin bucket (G=4), each fanout
              bucket (G=2), the HD chunks; f32 and bf16 streams, hidden
              width 32 and the 4-wide first layer.  Kernel, plain and
              library (``torch.sparse.mm``) times by CUDA events.
 4. forward   the model forward on ``groot``, ``groot_fused`` and ``ref``,
              timed with ``torch.cuda.synchronize()`` around it; logits
              finite, compared with ``ref``.
 5. main path ``repro_torch.api.Session(params=<groot_csa8.npz>, backend=b)
              .verify(dataset="csa", bits=<bits>)`` for ``groot`` and
              ``groot_fused`` with every kernel's launch count set to 0
              just before and read just after, then ``ref`` (no kernel).
              Verdicts must equal ``ref``'s and predictions may differ on at
              most 1e-5 of the nodes.

The line before the last is the ``{"kernels": [...]}`` summary; the last is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device, or run from a
directory that lacks the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM published peaks (dense): HBM3 bandwidth and the f32 rate
# outside the tensor cores, which the kernels' FMA loops run on.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# |kernel - plain| <= TOL * max(1, max|plain|): both sides widen bf16 inputs
# to f32 exactly and accumulate in f32, so only the order of the sums
# differs (a few f32 ulps over at most 1024 terms of mean-normalised weights).
TOL = 1e-5
MAX_PRED_MISMATCH = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of one call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bits", type=int, default=1024,
                    help="csa width; the smallest that runs every kernel is 513")
    ap.add_argument("--reps", type=int, default=10, help="timed launches per shape")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}: "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's kernels run only on the card",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import Session
    from repro_torch.core import gnn
    from repro_torch.core import pipeline as P
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import groot_spmm as gs
    from repro_torch.kernels import fused_sage as fs

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    report: dict = {"bits": args.bits}

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    report["nvidia_smi"] = smi
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    paths = build.build()
    for name in paths:
        build.library(name)
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {', '.join(p.name for p in paths.values())} in {report['build_s']:.1f} s")

    # -- host stages for the design the main path runs -------------------------
    params_path = ROOT / "src" / "repro_torch" / "data" / "groot_csa8.npz"
    model = gnn.params_from_numpy(gnn.load_params(params_path), device=dev)
    t0 = time.perf_counter()
    prep = P.prepare(P.PipelineConfig(dataset="csa", bits=args.bits))
    t_prep = time.perf_counter() - t0
    g = prep.graph
    t0 = time.perf_counter()
    pairs = {b: ops.make_agg_pair(g.edge_src, g.edge_dst, g.num_nodes, b, device=dev)
             for b in ("groot", "groot_fused")}
    t_plan = time.perf_counter() - t0
    in_plan, out_plan = pairs["groot"].in_plan, pairs["groot"].out_plan
    fp = pairs["groot"].fwd_plan
    n = g.num_nodes
    report["design"] = {
        "nodes": n, "edges": g.num_edges, "prepare_s": t_prep, "plans_s": t_plan,
        "fanin_buckets": [(b.deg, b.num_rows) for b in in_plan.buckets],
        "fanout_buckets": [(b.deg, b.num_rows) for b in out_plan.buckets],
        "fanout_hd_rows": 0 if out_plan.hd is None else int(out_plan.hd.rows.shape[0]),
        "fanout_hd_chunks": 0 if out_plan.hd is None else out_plan.hd.num_chunks,
    }
    log(f"design csa-{args.bits}: {json.dumps(report['design'])}")
    if out_plan.hd is None:
        fail(f"csa-{args.bits} has no HD rows: K2 would not run (need bits > {gs.E_T})")

    # -- 3. parity + kernel timing at the main path's shapes -------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    src, dst, inv, slot = gnn.graph_tensors(g, dev)
    wg_in, wg_out = gnn.grouped_edge_weights(src, dst, inv, slot, n)
    w_stack = model.layers[1].stack(gnn.IN_GROUPS)                    # (4, 32, 32)
    w_stack0 = model.layers[0].stack(gnn.IN_GROUPS)                   # (4, 4, 32)
    x32 = torch.randn((n + 1, 32), generator=gen, device=dev)
    x32[-1] = 0
    x4 = torch.randn((n + 1, 4), generator=gen, device=dev)
    x4[-1] = 0
    staged = {}
    for sdt in (None, torch.bfloat16):
        staged[("in", sdt)] = fp.stage_in(wg_in, dtype=sdt)
        staged[("out", sdt)] = fp.stage_out(wg_out, dtype=sdt)

    kernels = {
        "ld_grouped": dict(name="ld_grouped", route="cuda",
                           source="src/repro_torch/csrc/groot_spmm.cu",
                           replaces="src/repro/kernels/groot_spmm.py:513", fn=gs.ld_grouped_apply),
        "hd_grouped": dict(name="hd_grouped", route="cuda",
                           source="src/repro_torch/csrc/groot_spmm.cu",
                           replaces="src/repro/kernels/groot_spmm.py:590", fn=gs.hd_grouped_apply),
        "fused_ld_grouped": dict(name="fused_ld_grouped", route="cuda",
                                 source="src/repro_torch/csrc/fused_sage.cu",
                                 replaces="src/repro/kernels/fused_sage.py:91",
                                 fn=fs.fused_ld_matmul_grouped),
    }
    for k in kernels.values():
        k.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 bytes_ms=0.0, ops_ms=0.0, shapes=[])

    def compare(kname, what, got, want):
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{kname} {what}: non-finite output")
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        ok = err <= TOL * scale
        log(f"parity {kname:17s} {what:34s} max_abs_err {err:.3e} tol {TOL * scale:.3e} "
            f"{'ok' if ok else 'MISS'}")
        kernels[kname]["max_abs_err"] = max(kernels[kname]["max_abs_err"], err)
        if not ok:
            fail(f"{kname} {what}: max abs error {err:.3e} over {TOL * scale:.3e}")

    def account(kname, what, ms, plain_ms, bytes_, flops, timed):
        b_ms, by = bound(bytes_, flops)
        kernels[kname]["shapes"].append(dict(
            what=what, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
            bytes=bytes_, flops=flops))
        if timed:  # the layer the summary line reports: hidden 32, f32 streams
            kernels[kname]["ms"] += ms
            kernels[kname]["plain_ms"] += plain_ms
            kernels[kname]["bound_ms"] += b_ms
            kernels[kname]["bytes_ms"] += bytes_ / PEAK_BYTES_PER_S * 1e3
            kernels[kname]["ops_ms"] += flops / PEAK_F32_FLOPS * 1e3
        log(f"time   {kname:17s} {what:34s} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"bound {b_ms:.4f} ms ({by})")

    def distinct_row_bytes(cols, x):
        return torch.unique(cols).numel() * x.shape[1] * x.element_size()

    for sdt in (None, torch.bfloat16):
        tag = "bf16" if sdt is not None else "f32"
        for x in (x32, x4) if sdt is None else (x32,):
            xs = x if sdt is None else x.to(sdt)
            feat = x.shape[1]
            timed = sdt is None and feat == 32
            reps = args.reps if sdt is None else 2
            for direction, plan in (("fanin", in_plan), ("fanout", out_plan)):
                sw = staged[("in" if direction == "fanin" else "out", sdt)]
                dp = plan.on(dev)
                grp = sw.groups
                for b, cols, wge in zip(plan.buckets, dp.cols, sw.buckets):
                    what = f"{direction} d={b.deg} R={b.num_rows} G={grp} F={feat} {tag}"
                    got = gs.ld_grouped_apply(xs, cols, wge, b.deg)
                    want = gs.ld_grouped_plain(xs, cols, wge, b.deg)
                    compare("ld_grouped", what, got, want)
                    del want
                    ms = cuda_ms(lambda: gs.ld_grouped_apply(xs, cols, wge, b.deg, out=got), reps)
                    plain_ms = cuda_ms(lambda: gs.ld_grouped_plain(xs, cols, wge, b.deg), 2)
                    slots = cols.numel()
                    bytes_ = (distinct_row_bytes(cols, xs) + wge.numel() * wge.element_size()
                              + slots * 4 + got.numel() * 4)
                    account("ld_grouped", what, ms, plain_ms, bytes_, 2.0 * slots * grp * feat, timed)
                    del got
                    if direction == "fanin":
                        ws = w_stack if feat == 32 else w_stack0
                        hid = ws.shape[2]
                        got = fs.fused_ld_matmul_grouped(xs, cols, wge, ws, b.deg)
                        want = fs.fused_ld_grouped_plain(xs, cols, wge, ws, b.deg)
                        compare("fused_ld_grouped", what + f" H={hid}", got, want)
                        del want
                        ms = cuda_ms(lambda: fs.fused_ld_matmul_grouped(xs, cols, wge, ws, b.deg,
                                                                         out=got), reps)
                        plain_ms = cuda_ms(lambda: fs.fused_ld_grouped_plain(xs, cols, wge, ws,
                                                                              b.deg), 2)
                        rows = b.num_rows
                        bytes_ = (distinct_row_bytes(cols, xs) + wge.numel() * wge.element_size()
                                  + slots * 4 + ws.numel() * 4 + got.numel() * 4)
                        flops = 2.0 * slots * grp * feat + 2.0 * rows * grp * feat * hid
                        account("fused_ld_grouped", what + f" H={hid}", ms, plain_ms, bytes_,
                                flops, timed)
                        del got
                if plan.hd is not None:
                    hd = plan.hd
                    what = f"{direction} HD rows={hd.rows.shape[0]} chunks={hd.num_chunks} " \
                           f"G={grp} F={feat} {tag}"
                    args_hd = (xs, dp.hd_cols, sw.hd, dp.hd_meta, dp.hd_row_chunks, plan.e_t)
                    got = gs.hd_grouped_apply(*args_hd)
                    want = gs.hd_grouped_plain(xs, dp.hd_cols, sw.hd, dp.hd_meta,
                                               hd.rows.shape[0], plan.e_t)
                    compare("hd_grouped", what, got, want)
                    ms = cuda_ms(lambda: gs.hd_grouped_apply(*args_hd, out=got), reps)
                    plain_ms = cuda_ms(lambda: gs.hd_grouped_plain(
                        xs, dp.hd_cols, sw.hd, dp.hd_meta, hd.rows.shape[0], plan.e_t), 2)
                    slots = dp.hd_cols.numel()
                    bytes_ = (distinct_row_bytes(dp.hd_cols, xs) + sw.hd.numel() * sw.hd.element_size()
                              + slots * 4 + dp.hd_row_chunks.numel() * 4 + got.numel() * 4)
                    account("hd_grouped", what, ms, plain_ms, bytes_, 2.0 * slots * grp * feat, timed)
                    del got, want
    torch.cuda.empty_cache()

    # library yardstick: one torch.sparse.mm over a (G*N, N) CSR computing
    # the same grouped sums (cuSPARSE; the port never calls it)
    deg_out = torch.bincount(src, minlength=n)

    def csr(rows_of, cols_of, wg, keep):
        grp = wg.shape[1]
        e = torch.nonzero(keep).squeeze(1)
        r = torch.cat([gi * n + rows_of[e] for gi in range(grp)])
        c = torch.cat([cols_of[e]] * grp)
        v = torch.cat([wg[e, gi] for gi in range(grp)])
        return torch.sparse_coo_tensor(torch.stack([r, c]), v, (grp * n, n)).coalesce().to_sparse_csr()

    x32n = x32[:n]
    lib = {}
    for label, rows_of, cols_of, wg, keep in (
        ("fanin_all", dst, src, wg_in, torch.ones_like(dst, dtype=torch.bool)),
        ("fanout_all", src, dst, wg_out, torch.ones_like(src, dtype=torch.bool)),
        ("fanout_ld", src, dst, wg_out, deg_out[src] <= gs.E_T),
        ("fanout_hd", src, dst, wg_out, deg_out[src] > gs.E_T),
    ):
        a = csr(rows_of, cols_of, wg, keep)
        lib[label] = cuda_ms(lambda: torch.sparse.mm(a, x32n), args.reps)
        log(f"library torch.sparse.mm {label:10s} nnz={a.values().numel()} {lib[label]:.4f} ms")
        del a
    torch.cuda.empty_cache()
    # the port's whole grouped walk per direction (K1 + K2 + assembly)
    x32p = x32.contiguous()
    walk = {
        "fanin": cuda_ms(lambda: gs.apply_plan_grouped_staged(in_plan, x32p, staged[("in", None)]),
                         args.reps),
        "fanout": cuda_ms(lambda: gs.apply_plan_grouped_staged(out_plan, x32p, staged[("out", None)]),
                          args.reps),
    }
    log(f"walk (K1+K2+assembly, F=32 f32): {json.dumps(walk)}; "
        f"torch.sparse.mm per direction: fanin {lib['fanin_all']:.4f} ms, "
        f"fanout {lib['fanout_all']:.4f} ms")
    report["walk_ms"] = walk
    report["library_ms"] = lib
    kernels["ld_grouped"]["library_ms"] = lib["fanin_all"] + lib["fanout_ld"]
    kernels["hd_grouped"]["library_ms"] = lib["fanout_hd"]
    kernels["fused_ld_grouped"]["library_ms"] = None
    del staged, x4, x32n
    torch.cuda.empty_cache()

    # -- 4. forward, timed with synchronize around it ---------------------------
    x0 = torch.as_tensor(prep.feats).to(dev)
    logits, fwd = {}, {}
    for b in ("groot", "groot_fused", "ref"):
        agg = None if b == "ref" else pairs[b]

        def run():
            return gnn.forward(model, x0, src, dst, inv, slot, num_nodes=n, agg=agg)

        run()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if out.shape != (n, 5) or not torch.isfinite(out).all():
            fail(f"forward {b}: logits not finite or of shape {tuple(out.shape)}")
        logits[b] = out
        fwd[b] = statistics.median(times) * 1e3
        log(f"forward {b:11s} {fwd[b]:.2f} ms (median of 3, synchronize around it)")
    # where one groot forward's device time goes (kernel names by self time)
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gnn.forward(model, x0, src, dst, inv, slot, num_nodes=n, agg=pairs["groot"])
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    report["forward_peak_bytes_groot"] = torch.cuda.max_memory_allocated()
    # device-side events only: the aten ops that launched them carry the
    # same time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    report["forward_profile_groot"] = dict(wall_ms=prof_wall_ms, device_ms=dev_ms, top=rows[:15])
    log(f"profile groot forward: device {dev_ms:.2f} ms of {prof_wall_ms:.2f} ms wall "
        f"(idle share {1 - dev_ms / prof_wall_ms:.3f}, profiler on)")
    for name, ms, cnt in rows[:10]:
        log(f"  {ms:9.3f} ms  x{cnt:<4d} {name[:90]}")
    report["forward_ms"] = fwd
    max_logit_diff = {b: (logits[b] - logits["ref"]).abs().max().item()
                      for b in ("groot", "groot_fused")}
    report["max_logit_diff_vs_ref"] = max_logit_diff
    log(f"max |logit - ref logit|: {json.dumps(max_logit_diff)}")
    del logits
    torch.cuda.empty_cache()

    # -- 5. main path ------------------------------------------------------------
    for k in kernels.values():
        k["fn"].launches = 0
    results, launches = {}, {}
    for b in ("groot", "groot_fused", "ref"):
        before = {kn: k["fn"].launches for kn, k in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = Session(params=params_path, backend=b).verify(
            dataset="csa", bits=args.bits, return_predictions=True)
        wall = time.perf_counter() - t0
        launches[b] = {kn: k["fn"].launches - before[kn] for kn, k in kernels.items()}
        results[b] = r
        log(f"session.verify backend={b}: status {r.status} accuracy {r.accuracy:.6f} "
            f"wall {wall:.1f} s timings {json.dumps({k: round(v, 3) for k, v in r.timings.items()})} "
            f"launches {json.dumps(launches[b])}")
    total = {kn: k["fn"].launches for kn, k in kernels.items()}
    report["sessions"] = {b: dict(status=r.status, accuracy=r.accuracy, timings=r.timings,
                                  launches=launches[b]) for b, r in results.items()}
    if any(launches["ref"].values()):
        fail(f"the ref backend launched kernels: {launches['ref']}")
    for kn, cnt in total.items():
        if cnt <= 0:
            fail(f"kernel {kn} was not launched on the main path")
    ref = results["ref"]
    for b in ("groot", "groot_fused"):
        r = results[b]
        if r.predictions.shape != (n,):
            fail(f"{b}: predictions of shape {r.predictions.shape}")
        mism = int((r.predictions != ref.predictions).sum())
        log(f"{b}: {mism} of {n} predictions differ from ref (limit {MAX_PRED_MISMATCH:g} of nodes)")
        if r.status != ref.status:
            fail(f"{b}: verdict {r.status} != ref's {ref.status}")
        if mism > MAX_PRED_MISMATCH * n:
            fail(f"{b}: {mism} predictions differ from ref")
        report["sessions"][b]["pred_mismatch_vs_ref"] = mism

    line = []
    for kn, k in kernels.items():
        by = "bytes" if k["bytes_ms"] >= k["ops_ms"] else "operations"
        line.append(dict(
            name=kn, route=k["route"], source=k["source"], replaces=k["replaces"],
            launches=total[kn], max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=by,
            library_ms=k["library_ms"],
        ))
        report.setdefault("kernel_shapes", {})[kn] = k["shapes"]
    report["kernels"] = line
    report["total_s"] = time.perf_counter() - t_all
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"total {report['total_s']:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
