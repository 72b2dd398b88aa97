"""One run of one cell: inputs from the seed, set-up, the measured window,
the traced segment, the comparison with the plain reference, the result line.

The window is one client in a closed loop of whole-design classifications
through the program's front door, ``Session.verify(prepared=...,
verify=False, use_cache=False, return_predictions=True)`` on a design that
set-up prepared.  The mix file gives the session's routing knobs (full graph,
or streamed under a memory budget).  Every request's predictions are judged
once the window has closed, against the reference's logits: the widest gap
by which the logit of a predicted class lies below the reference's best.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from bench import designs, loader, peaks
from bench import profile as prof
from bench.reference import model as ref

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


def make_params(gnn: dict, seed: int, device) -> dict:
    """Weights and biases uniform in +-1/sqrt(fan_in), drawn in one call on
    ``device`` from ``seed``."""
    dims = [gnn["in_features"]] + [gnn["hidden"]] * gnn["num_layers"]
    shapes = []
    for i in range(gnn["num_layers"]):
        shapes += [(f"layers.{i}.{nm}", (dims[i], dims[i + 1]), dims[i])
                   for nm in ref.LAYER_WEIGHTS]
        shapes.append((f"layers.{i}.b", (dims[i + 1],), dims[i]))
    shapes += [("head.w", (gnn["hidden"], gnn["num_classes"]), gnn["hidden"]),
               ("head.b", (gnn["num_classes"],), gnn["hidden"])]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.rand(sum(int(np.prod(s)) for _, s, _ in shapes), generator=gen,
                      device=device, dtype=torch.float32)
    tree: dict = {"layers": [{} for _ in range(gnn["num_layers"])], "head": {}}
    at = 0
    for name, shape, fan_in in shapes:
        n = int(np.prod(shape))
        t = (flat[at:at + n].view(shape) * 2 - 1) / float(np.sqrt(fan_in))
        at += n
        parts = name.split(".")
        if parts[0] == "layers":
            tree["layers"][int(parts[1])][parts[2]] = t
        else:
            tree["head"][parts[1]] = t
    return tree


def _numpy_tree(tree: dict) -> dict:
    return {"layers": [{k: v.cpu().numpy() for k, v in layer.items()}
                       for layer in tree["layers"]],
            "head": {k: v.cpu().numpy() for k, v in tree["head"].items()}}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def partitioned(mix: dict) -> bool:
    s = mix["session"]
    return s.get("memory_budget_bytes") is not None or s.get("num_partitions", 1) > 1


def reference_logits(arrays: dict, params: dict, config: dict, mix: dict, device, *,
                     tf32: bool = False) -> tuple:
    """The reference's logits over every node, its edges (host int64
    arrays) and its partition count (None for a full-graph mix)."""
    kind = torch.as_tensor(arrays["kind"]).to(device)
    f0 = torch.as_tensor(arrays["fanin0"]).to(device)
    f1 = torch.as_tensor(arrays["fanin1"]).to(device)
    x = ref.features(kind, f0, f1)
    src, dst, slot, inv = ref.edges(kind, f0, f1)
    del kind, f0, f1
    n = x.shape[0]
    if not partitioned(mix):
        return ref.forward(params, x, src, dst, slot, inv, n, tf32=tf32), (src, dst), None, None
    s = mix["session"]
    if s.get("partitioner") != "bfs" or not s.get("regrow", True) or s.get("regrow_hops") != 1 \
            or s.get("num_partitions", 1) > 1:
        raise ValueError("the reference partitions by a budget, bfs stripes, 1-hop re-growth")
    part, k = ref.budget_partition(n, src, dst, config["gnn"], s)
    logits = ref.partitioned_logits(params, x, src, dst, slot, inv, part, tf32=tf32)
    return logits, (src, dst), part, k


def logit_gap(logits: torch.Tensor, pred: np.ndarray) -> float:
    """How far the reference's logit of each predicted class lies below its
    best, widest over the nodes; inf for a prediction of the wrong shape or
    outside the classes."""
    n, c = logits.shape
    if pred is None or pred.shape != (n,):
        return float("inf")
    p = torch.as_tensor(pred).to(logits.device, torch.int64)
    if bool(((p < 0) | (p >= c)).any()):
        return float("inf")
    return float((logits.max(dim=1).values - logits.gather(1, p[:, None])[:, 0]).max())


class LogitCapture:
    """While active, every forward of the program (``gnn.forward``, which the
    full-graph predict and the streamed route's packed launches both call)
    is followed by the reference's forward on the same inputs: the
    program's own features and edges, or its packed, padded partitions.
    ``worst`` is the largest ``max|program - reference| / max|reference|``
    over the calls; ``worst_tf32`` the same of the reference computed with
    TF32 products (the control), where asked for."""

    def __init__(self, params: dict, *, tf32_control: bool = False):
        self.params, self.tf32_control = params, tf32_control
        self.calls, self.worst, self.worst_tf32 = 0, 0.0, 0.0

    def __enter__(self):
        from repro_torch.core import gnn

        self._gnn, self._plain = gnn, gnn.forward

        def forward(params, x, edge_src, edge_dst, edge_inv=None, edge_slot=None, *,
                    num_nodes, **kw):
            logits = self._plain(params, x, edge_src, edge_dst, edge_inv, edge_slot,
                                 num_nodes=num_nodes, **kw)
            self._judge(logits, x, edge_src, edge_dst, edge_inv, edge_slot, num_nodes)
            return logits

        gnn.forward = forward
        return self

    def __exit__(self, *exc):
        self._gnn.forward = self._plain

    def _judge(self, logits, x, src, dst, inv, slot, num_nodes):
        """Rows that a self-loop touches are a packed launch's padding rows
        (an AIG has no self-loop; padding edges loop on each slot's dummy
        row, which may gather millions of them): their logits are never
        read, so they are left out."""
        args = (x.float(), src.long(), dst.long(),
                torch.zeros_like(src, dtype=torch.long) if slot is None else slot.long(),
                torch.zeros_like(src, dtype=torch.long) if inv is None else inv.long(),
                int(num_nodes))
        real = torch.ones(int(num_nodes), dtype=torch.bool, device=logits.device)
        real[src[src == dst].long()] = False
        want = ref.forward(self.params, *args)[real]
        scale = float(want.abs().max().clamp_min(1e-30))
        self.calls += 1
        err = (logits.float()[real] - want).abs().max()
        self.worst = max(self.worst, float(err) / scale)
        if self.tf32_control:
            low = ref.forward(self.params, *args, tf32=True)[real]
            self.worst_tf32 = max(self.worst_tf32, float((low - want).abs().max()) / scale)


def forward_counts(edges_, part, num_nodes: int, gnn: dict) -> dict:
    """Model FLOPs and SpMM counts of one request: over the whole graph, or
    summed over the re-grown partitions the request runs."""
    from bench import counts

    src, dst = edges_
    graphs = []
    if part is None:
        graphs.append((src.cpu().numpy(), dst.cpu().numpy(), num_nodes))
    else:
        local = torch.full((num_nodes,), -1, dtype=torch.int64, device=src.device)
        for p in range(int(part.max()) + 1):
            core, halo, keep = ref.regrown(part, src, dst, p)
            ids = torch.cat([core, halo])
            local[ids] = torch.arange(ids.numel(), device=src.device)
            graphs.append((local[src[keep]].cpu().numpy(), local[dst[keep]].cpu().numpy(),
                           ids.numel()))
            local[ids] = -1
    out = {"model_flops": 0, "ld": None, "hd": None}
    for s, d, n in graphs:
        out["model_flops"] += counts.model_flops(n, s.size, gnn)
        one = counts.spmm_counts(s, d, n, gnn)
        for kind in ("ld", "hd"):
            out[kind] = one[kind] if out[kind] is None else {
                key: out[kind][key] + one[kind][key] for key in one[kind]}
    return out


def run(argv, *, root: Path, t_start: float,
        device: str | None = None) -> tuple[int, dict | None]:
    """One run; returns (exit code, result).  ``device="cpu"`` skips the look
    for a chip and runs the program's plain versions (the harness's tests)."""
    args = parse(argv)
    cell = loader.load_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"bench: {cell.name} needs {cell.chips} CUDA device(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
            return 3, None
        device = "cuda"
    dev = torch.device(device)
    config, mix = cell.config, cell.mix

    from repro_torch.api.config import SessionConfig
    from repro_torch.api.session import Session
    from repro_torch.core import aig as A
    from repro_torch.core.gnn import GNNConfig
    from repro_torch.kernels.plan_cache import PLAN_CACHE

    arrays = designs.load(config["design"])
    design = A.AIG(name=arrays["name"], kind=arrays["kind"], fanin0=arrays["fanin0"],
                   fanin1=arrays["fanin1"], label=arrays["label"], n_pi=arrays["n_pi"],
                   pos=arrays["pos"])
    params = make_params(config["gnn"], args.seed, dev)
    session = Session(config=SessionConfig(
        dataset=config["design"]["generator"], bits=int(config["design"]["bits"]),
        backend=config["backend"], gnn=GNNConfig(**config["gnn"]),
        trace=bool(args.trace), device=device, **mix["session"]))
    session.set_params(_numpy_tree(params))
    prep = session.prepare(design)
    prepare_timings = dict(prep.timings)

    def request():
        return session.verify(prepared=prep, verify=False, use_cache=False,
                              return_predictions=True)

    for _ in range(int(mix["warmup_requests"])):
        request()
    _sync(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    tracer = session.obs.tracer

    # -- the measured window: one client, closed loop -----------------------
    latencies, preds, stats, routes, errors = [], [], [], [], []
    attempted = 0
    builds0 = PLAN_CACHE.snapshot().builds
    n_spans0 = len(tracer.spans()) if tracer is not None else 0
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    t_end = t0
    while time.perf_counter() < deadline:
        attempted += 1
        a = time.perf_counter()
        try:
            res = request()
        except Exception as e:  # noqa: BLE001 — a failed request is counted, the loop goes on
            errors.append(repr(e))
            t_end = time.perf_counter()
            continue
        t_end = time.perf_counter()
        latencies.append(t_end - a)
        preds.append(res.predictions)
        stats.append(res.exec_stats)
        routes.append(res.routing)
    window_s = t_end - t0
    if latencies:
        q = np.percentile(np.asarray(latencies) * 1e3, [0, 25, 50, 75, 90, 100])
        log("bench: {} requests, latency ms min/q1/median/q3/p90/max {}".format(
            len(latencies), " ".join(f"{v:.1f}" for v in q)))
    _sync(dev)
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    plan_builds = PLAN_CACHE.snapshot().builds - builds0
    window_spans = tracer.spans()[n_spans0:] if tracer is not None else []

    profile = None
    if args.trace:
        def traced():
            res = request()
            preds.append(res.predictions)
            routes.append(res.routing)

        profile = prof.profile(traced, int(mix["profile_requests"]),
                               tracer.spans if tracer is not None else None)

    # -- the comparison, once the window has closed and the peak is read ----
    # one more request through the same entry, its logits held to the
    # reference's on the very inputs the program ran
    with LogitCapture(params) as cap:
        request()
    del session, prep, request
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    logits, edges_, part, ref_k = reference_logits(arrays, params, config, mix, dev)
    gap = max((logit_gap(logits, p) for p in preds), default=float("inf"))
    checks = {
        "max_logit_gap": (gap, float(config["check"]["max_logit_gap"])),
        "max_logit_error": (cap.worst if cap.calls else float("inf"),
                            float(config["check"]["max_logit_error"])),
        "failed_requests": (len(errors), 0),
    }
    if ref_k is not None:
        checks["partition_count_diff"] = (max((abs(r.k - ref_k) for r in routes), default=0), 0)
    correct = bool(preds) and all(v <= lim for v, lim in checks.values())
    del logits

    ctx = types.SimpleNamespace(
        cell=cell, seed=args.seed, trace=bool(args.trace), peaks=peaks,
        num_nodes=int(arrays["kind"].shape[0]), setup_s=setup_s,
        prepare_timings=prepare_timings, requests=len(latencies),
        attempted=attempted, failed=len(errors), window_s=window_s, latencies=latencies,
        peak_bytes=window_peak if dev.type == "cuda" else None, plan_builds=plan_builds,
        spans=window_spans, exec_stats=[s for s in stats if s], profile=profile,
        counts=None,
    )
    wanted = cell.per_layer if args.trace else cell.end_to_end
    if args.trace:
        ctx.counts = forward_counts(edges_, part, ctx.num_nodes, config["gnn"])
    metrics = {}
    for m in wanted:
        v = loader.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": len(errors),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": cell.chips,
            "memory_peak_bytes": int(max(setup_peak, window_peak)),
        },
        "requests": len(latencies),
    }
    if profile is not None:
        result["device"]["busy_s"] = profile["busy_s"]
        result["device"]["window_s"] = profile["window_s"]
        top = sorted(profile["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(profile["gaps"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [list(kv) for kv in top],
                               "idle_gaps": [list(kv) for kv in gaps]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for e in errors[:3]:
        log(f"bench: request failed: {e}")
    for k, (v, lim) in checks.items():
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
