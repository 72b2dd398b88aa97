#!/usr/bin/env python3
"""Where a partition's time goes in the partitioned loop, on one card.

    python3 scripts/profile_partition.py [--bits 1024] [--batch 4] [--k 8] [--reps 3]

Run from the root of a checkout.  Cuts ``--batch`` copies of csa-<bits>
into ``--k`` topological stripes (``partitioner="bfs"``, 1-hop re-growth).
At k = 2 x batch every copy is cut in the same two places, so the stripes
fall into two subgraph structures, the same two as those of 16 copies cut
32 ways.  After a warm-up loop that builds the host plans, it times one
partition of each structure stage by stage, as a loop that drops every
device copy after each partition pays them (median of ``--reps``, the card
synchronised around each stage):

  hash       the three structural hashes the plan-cache lookups take
  pair       the whole aggregation pair of a warm cache: the lookups (and
             their hashes), the plans' layout and their copy to the card
  layout     the host side of the plans' copy (staging index, HD row
             chunks, contiguous bucket columns), fanin and fanout
  plan_h2d   the rest of the plans' copy: the copy to the card
  graph_h2d  the subgraph's edge arrays to the card
  features   the features' gather and copy
  forward    the GNN forward
  d2h        argmax and the copy back

for ``groot`` and ``ref`` (which has no pair).  Then it runs every stripe
through ``gnn.predict_partitioned_loop`` (one structure at a time, its
copies kept across the structure's stripes) and through the loop's
body it ran before (every copy dropped after each stripe), in the
order alone, loop, loop, alone, on both backends, checks that they give the
same predictions, and profiles one run of each on ``groot`` for the card's
time and idle share (profiler on).  Prints the card's name and power
limit, one line a reading, and a last line of JSON (also written to
``chiprun_out/profile_partition.json``).  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "src" / "repro_torch" / "data" / "groot_csa8.npz"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bits", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_partition: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import gnn
    from repro_torch.core import pipeline as P
    from repro_torch.kernels import groot_spmm as gs
    from repro_torch.kernels import ops
    from repro_torch.kernels import plan_cache as pc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    prep = P.prepare(P.PipelineConfig(dataset="csa", bits=args.bits, batch=args.batch,
                                      num_partitions=args.k, partitioner="bfs"))
    subs, feats, n = prep.subgraphs, prep.feats, prep.num_nodes
    groups = gnn.structure_groups(subs)
    print(f"{args.batch} x csa-{args.bits}: {n} nodes, {prep.num_edges} edges, k={len(subs)}; "
          f"prepare {time.perf_counter() - t0:.1f} s (partition {prep.timings['partition']:.1f} s); "
          f"structures {groups}; sizes "
          f"{[(subs[g[0]].num_nodes, subs[g[0]].num_edges) for g in groups]}", flush=True)
    model = gnn.params_from_numpy(gnn.load_params(NPZ), device=dev)
    report: dict = dict(card=smi, bits=args.bits, batch=args.batch, k=len(subs), nodes=n,
                        edges=prep.num_edges, structures=groups,
                        sizes=[(sg.num_nodes, sg.num_edges) for sg in subs])

    def loop(backend, subgraphs, hook=None):
        return gnn.predict_partitioned_loop(model, subgraphs, feats, n, backend, device=dev,
                                            on_partition=hook)

    for backend in ("groot", "ref"):   # warm: host plans, kernels' builds, libraries
        loop(backend, subs)
    torch.cuda.synchronize()

    def tick(times, name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t)
        return out

    def stages(sg, backend) -> dict:
        times: dict = {}
        for _ in range(args.reps):
            g = sg.to_edge_graph()
            agg = None
            if backend != "ref":
                src, dst, nn = g.edge_src, g.edge_dst, g.num_nodes
                tick(times, "hash", lambda: (pc.graph_key(src, dst, nn),
                                             pc.graph_key(dst, src, nn),
                                             pc.graph_key(src, dst, nn)))
                agg = tick(times, "pair", lambda: ops.make_agg_pair(
                    src, dst, nn, backend, device=dev, cache=False))
                plans = (agg.in_plan, agg.out_plan)
                tick(times, "layout", lambda: [
                    (gs.plan_cat_eids(p), None if p.hd is None else p.hd.row_chunks(),
                     [np.ascontiguousarray(b.cols) for b in p.buckets]) for p in plans])
                ops.release_device(agg)
                tick(times, "plan_copy", lambda: [p.on(dev) for p in plans])
            tensors = tick(times, "graph_h2d", lambda: gnn.graph_tensors(g, dev))
            x = tick(times, "features", lambda: torch.as_tensor(
                np.asarray(feats[sg.global_ids], np.float32)).to(dev))
            logits = tick(times, "forward", lambda: gnn.forward(
                model, x, *tensors, num_nodes=g.num_nodes, agg=agg))
            tick(times, "d2h", lambda: logits.argmax(dim=-1).to(torch.int32).cpu().numpy())
            if agg is not None:
                ops.release_device(agg)
            del agg, tensors, x, logits
        med = {k: statistics.median(v) for k, v in times.items()}
        if "plan_copy" in med:
            med["plan_h2d"] = med.pop("plan_copy") - med["layout"]
        return med

    report["stages_s"] = {}
    for gi, grp in enumerate(groups):
        for backend in ("groot", "ref"):
            med = stages(subs[grp[0]], backend)
            report["stages_s"][f"{backend} structure {gi}"] = med
            print(f"{backend} structure {gi} (stripe {grp[0]}, {subs[grp[0]].num_nodes} nodes): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
                  + f"; sum without pair {sum(v for k, v in med.items() if k != 'pair'):.4f} s",
                  flush=True)

    def timed(backend, alone):
        """Seconds a stripe, in order, and the predictions."""
        secs, last = [], [time.perf_counter()]

        def hook(i, sg):
            now = time.perf_counter()
            secs.append(now - last[0])
            last[0] = now

        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        if alone:   # each stripe's pair built and dropped, as the loop did before
            out = np.zeros(n, np.int32)
            for i, sg in enumerate(subs):
                g = sg.to_edge_graph()
                agg = gnn._make_agg(g, backend, dev, cache=False)
                pred = gnn._predict_graph(model, g.num_nodes, gnn.graph_tensors(g, dev),
                                          feats[sg.global_ids], agg, None, dev)
                if agg is not None:
                    ops.release_device(agg)
                del agg
                out[sg.global_ids[: sg.num_core]] = pred[: sg.num_core]
                hook(i, sg)
        else:
            out = loop(backend, subs, hook)
        return secs, out

    report["loops"] = {}
    for backend in ("groot", "ref"):
        runs = {}
        for alone in (True, False, False, True):
            secs, out = timed(backend, alone)
            tag = "alone" if alone else "loop"
            runs.setdefault(tag, []).append(dict(total_s=sum(secs), per_part_s=secs))
            if "pred" not in runs:
                runs["pred"] = out
            elif not np.array_equal(out, runs["pred"]):
                print(f"profile_partition: {backend} {tag} predictions differ", file=sys.stderr)
                return 1
        del runs["pred"]
        report["loops"][backend] = runs
        for tag in ("alone", "loop"):
            print(f"{backend} {tag}: totals {[round(r['total_s'], 4) for r in runs[tag]]} s, "
                  f"median a stripe {[round(statistics.median(r['per_part_s']), 4) for r in runs[tag]]}",
                  flush=True)

    report["profile"] = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for alone in (False, True):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            timed("groot", alone)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        dev_s = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        tag = "alone" if alone else "loop"
        report["profile"][tag] = dict(wall_s=wall, device_s=dev_s, idle_share=1 - dev_s / wall)
        print(f"groot {tag} profiled: device {dev_s:.4f} s of {wall:.4f} s wall, idle share "
              f"{1 - dev_s / wall:.3f} (profiler on)", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_partition.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] for k in ("card", "k", "nodes", "stages_s", "profile")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
