"""GROOT's GNN: whole-design classification through the program's front door.

The window is one client in a closed loop of whole-design classifications
through ``Session.verify(prepared=..., verify=False, use_cache=False,
return_predictions=True)`` on a design that set-up prepared.  The mix file
gives the session's routing knobs (full graph, or streamed under a memory
budget).  A sample of the window's answers, drawn from the seed (``Sample``),
is judged once the window has closed, with every answer of the traced
requests, against the reference's logits: the widest gap by which the logit
of a predicted class lies below the reference's best.
"""
from __future__ import annotations

import gc
import json
import time
import types

import numpy as np
import torch

from bench import designs, peaks
from bench import profile as prof
from bench.harness import log
from bench.reference import model as ref


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


class Sample:
    """A uniform sample of at most ``size`` of the window's answers, drawn
    from the seed as they come (reservoir sampling).  The window keeps only
    these alive: holding every answer (28.9-33.7 MB of predictions a
    request at 1,024 bits) grew the process by gigabytes over a window and
    faulted in fresh pages on every request's readback."""

    def __init__(self, seed: int, size: int = 8):
        self.size, self.seen, self.kept = size, 0, []
        self._rng = np.random.default_rng(seed)

    def offer(self, answer) -> None:
        self.seen += 1
        if self.seen <= self.size:
            self.kept.append(answer)
        elif (j := int(self._rng.integers(self.seen))) < self.size:
            self.kept[j] = answer


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


def _design(arrays: dict):
    from repro_torch.core import aig as A

    return A.AIG(name=arrays["name"], kind=arrays["kind"], fanin0=arrays["fanin0"],
                 fanin1=arrays["fanin1"], label=arrays["label"], n_pi=arrays["n_pi"],
                 pos=arrays["pos"])


def _session(config: dict, mix: dict, device: str, **kw):
    from repro_torch.api.config import SessionConfig
    from repro_torch.api.session import Session
    from repro_torch.core.gnn import GNNConfig

    return Session(config=SessionConfig(
        dataset=config["design"]["generator"], bits=int(config["design"]["bits"]),
        backend=config["backend"], gnn=GNNConfig(**config["gnn"]), device=device,
        **kw, **mix["session"]))


def run(args, cell, dev: torch.device) -> tuple[int, types.SimpleNamespace]:
    """One run of a GNN cell on ``dev``; returns (0, the readers' context)."""
    from repro_torch.kernels.plan_cache import PLAN_CACHE

    config, mix = cell.config, cell.mix
    arrays = designs.load(config["design"])
    params = make_params(config["gnn"], args.seed, dev)
    session = _session(config, mix, str(dev), trace=bool(args.trace))
    session.set_params(_numpy_tree(params))
    prep = session.prepare(_design(arrays))
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
    setup_s = time.perf_counter() - args.t_start
    tracer = session.obs.tracer

    # -- the measured window: one client, closed loop -----------------------
    latencies, stats, routes, errors = [], [], [], []
    sample = Sample(args.seed)
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
        sample.offer(res.predictions)
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

    preds = sample.kept
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
    for e in errors[:3]:
        log(f"bench: request failed: {e}")

    ctx = types.SimpleNamespace(
        cell=cell, seed=args.seed, trace=bool(args.trace), peaks=peaks,
        num_nodes=int(arrays["kind"].shape[0]), setup_s=setup_s,
        prepare_timings=prepare_timings, requests=len(latencies),
        attempted=attempted, failed=len(errors), window_s=window_s, latencies=latencies,
        peak_bytes=window_peak if dev.type == "cuda" else None, plan_builds=plan_builds,
        spans=window_spans, exec_stats=[s for s in stats if s], profile=profile,
        counts=None, correct=correct, checks=checks,
        memory_peak_bytes=int(max(setup_peak, window_peak)),
    )
    if args.trace:
        ctx.counts = forward_counts(edges_, part, ctx.num_nodes, config["gnn"])
    return 0, ctx


def calibrate(cell, seeds: list, out, dev: torch.device) -> list:
    """For each seed, in one process (set-up once), the two numbers a run
    compares, read for the program on its timed path (``Session.verify`` as
    the window calls it) and for two controls that compute in a lower
    precision than the configuration's float32: the reference with TF32
    products in the program's place, and the program with its own bfloat16
    edge streams.  ``gap``: the widest logit gap of the predicted classes
    against the reference's own derivation; ``err``: the logits' relative
    error against the reference on the program's own inputs.  Writes one
    JSON line a seed to ``out``; returns the rows."""
    config, mix = cell.config, cell.mix
    arrays = designs.load(config["design"])
    base = _session(config, mix, "cuda")
    prep = base.prepare(_design(arrays))
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        params = make_params(config["gnn"], seed, dev)
        base.set_params(_numpy_tree(params))
        low = base.options(stream_dtype="bfloat16")
        kw = dict(prepared=prep, verify=False, use_cache=False, return_predictions=True)
        with LogitCapture(params, tf32_control=True) as cap:
            res = base.verify(**kw)
        pred, k = res.predictions, res.routing.k
        with LogitCapture(params) as cap_bf16:
            pred_bf16 = low.verify(**kw).predictions
        logits, _, _, ref_k = reference_logits(arrays, params, config, mix, dev)
        control, _, _, _ = reference_logits(arrays, params, config, mix, dev, tf32=True)
        row = {
            "seed": seed,
            "gap_program": logit_gap(logits, pred),
            "gap_tf32": logit_gap(logits, control.argmax(1).cpu().numpy()),
            "gap_program_bf16": logit_gap(logits, pred_bf16),
            "err_program": cap.worst,
            "err_tf32": cap.worst_tf32,
            "err_program_bf16": cap_bf16.worst,
            "differing_program": int((logits.argmax(1).cpu().numpy() != pred).sum()),
            "differing_tf32": int((logits.argmax(1) != control.argmax(1)).sum()),
            "k": k, "reference_k": ref_k, "s": time.perf_counter() - t0,
        }
        del logits, control
        rows.append(row)
        out.write(json.dumps(row) + "\n")
        out.flush()
        print(json.dumps(row), flush=True)
    return rows
