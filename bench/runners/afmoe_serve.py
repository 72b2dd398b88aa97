"""The zoo's serving path on an AFMoE decoder (Trinity-Mini): the same
``launch/serve.py`` ``BatchServer`` as ``lm_serve`` (left-padded admission,
one prefill, one decode step a token through the bf16 KV cache: ring caches
of ``sliding_window`` slots on the sliding layers, ``max_seq`` slots on the
full ones; K8 windowed or causal where the prefill's S x T passes the zoo's
flash threshold) with the dropless expert layers of ``zoo/models/moe.py``,
at the sizes the configuration's ``model`` block states.

A run goes as ``lm_serve``'s (its batch generator and capture are imported
from there): set-up draws the weights on the device from the seed
(``reference/afmoe.py`` ``make_weights``; the program serves those very
tensors, one copy on the card) and serves one warm-up batch of the window's
shapes under the program's tracer, which reads the dispatch's counts; the
window is one client in a closed loop of batches; ``--trace 1`` serves one
more batch under the profiler with the tracer active (the dispatch's spans
and counts, which read device values there and only there).  Then one more
batch is served with its longest and shortest rows' logits and every
expert selection kept, and the plain reference judges ``check_requests``
of its rows (those two, and more drawn from the seed).

The reference takes the program's expert choices at each (row, position,
layer) and computes the weights, the experts and all else itself: bf16
rounding swaps near-tied experts (a sixth of the tokens at the first MoE
layer at the published widths, two thirds by the fourth, on the CPU), and
a reference choosing for itself would compute another sum.  The choices are
judged apart (``max_route_regret``).

Checks: ``max_logit_gap`` (how far the reference's logit of a served token
lies below its best), ``max_logit_error`` (the kept rows' logits against the
reference's, over its largest magnitude), ``max_route_regret`` (how far the
score + bias of the worst expert the program chose lies below the
reference's own k-th largest), ``failed_requests`` and ``token_id_range``
(over every window request) as ``lm_serve``'s, and ``dropped_tokens``, the
(token, expert) pairs the router chose that the experts' grouped GEMMs did
not take, over the warm-up batch's every MoE call (0).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import threading
import time
import types
from unittest import mock

import numpy as np
import torch

from bench import counts_afmoe, peaks
from bench import profile as prof
from bench.harness import log
from bench.reference import afmoe
from bench.runners.lm_serve import (
    _capture,
    _kept_rows,
    _requests,
    _served_row,
    _sync,
    _worse,
    batches,
)


def zoo_config(config: dict):
    """The zoo's ``PortModelConfig`` of the configuration's ``arch``, with
    every key of its ``model`` block set as stated there (the block holds
    exactly what ``reference/afmoe.py`` computes)."""
    from repro_torch.zoo.configs import get_config

    model = config["model"]
    afmoe.check_model(model)
    return dataclasses.replace(get_config(config["arch"]),
                               **{**model, "layer_pattern": tuple(model["layer_pattern"])})


@contextlib.contextmanager
def _routes_kept():
    """While active, every expert selection the program makes (``moe.route``'s
    top-k, on the device), in call order."""
    from repro_torch.zoo.models import moe

    kept, route = [], moe.route

    def keeping(*a, **kw):
        top_i, top_w = route(*a, **kw)
        kept.append(top_i)
        return top_i, top_w

    moe.route = keeping
    try:
        yield kept
    finally:
        moe.route = route


def _capture_routed(server, reqs: list, dev) -> dict:
    """``lm_serve._capture`` of one batch, with the program's expert
    selections kept (``routes``: its MoE calls in order, the prefill's and
    then each decode step's)."""
    with _routes_kept() as routes:
        captured = _capture(server, reqs, dev)
    captured["routes"] = routes
    return captured


def _row_routes(routes: list, n_moe: int, batch: int, plen: int, idx: list) -> list:
    """Per MoE layer, the selections (R, plen + steps, k) of the batch's rows
    ``idx``: the prefill's call's, then one a decode step."""
    calls = [routes[i:i + n_moe] for i in range(0, len(routes), n_moe)]
    out = []
    for layer in range(n_moe):
        pre = calls[0][layer].view(batch, plen, -1)[idx]
        steps = [step[layer].view(batch, -1)[idx] for step in calls[1:]]
        out.append(torch.cat([pre, torch.stack(steps, 1)], 1).long() if steps else pre.long())
    return out


def judged_rows(captured: dict, n: int, seed) -> list:
    """The captured batch's rows that are judged: its longest and shortest
    (whose logits were kept), then ``n - 2`` more drawn by ``seed``."""
    kept = _kept_rows(captured["batch"])
    rest = [i for i in range(len(captured["batch"])) if i not in kept]
    rng = np.random.default_rng(seed)
    more = rng.choice(len(rest), size=min(max(n - len(kept), 0), len(rest)), replace=False)
    return kept + sorted(rest[int(i)] for i in more)


def judge(weights: dict, model: dict, captured: dict, idx: list, dev, *,
          control=None) -> dict:
    """The plain reference over the captured batch's rows ``idx`` as the
    server built them (left pads, then the served tokens fed back), each MoE
    layer taking the expert choices the program made there.  Returns
    ``gap`` (the widest gap of a served token: inf where an id lies outside
    the vocabulary), ``err`` (the kept rows' logits against the reference's,
    over its largest magnitude) and ``regret`` (how far the program's worst
    chosen expert lies below the reference's own k-th choice, in score +
    bias).  With ``control``, the reference computed that way stands in for
    the program: its own choices, logits and first tokens, judged alike."""
    batch = captured["batch"]
    plen = max(len(r.prompt) for r in batch)
    reqs = [batch[i] for i in idx]
    rows = torch.as_tensor(np.stack([_served_row(r, plen) for r in reqs]), device=dev)
    n_moe = model["num_layers"] - model["dense_layers"]
    if control is not None:
        c = afmoe.forward(weights, model, rows, plen - 1, control=control)
        have, chosen, first = c["logits"], c["routes"], c["logits"].argmax(-1)
        del c
    else:
        have = None
        chosen = _row_routes(captured["routes"], n_moe, len(batch), plen, idx)
        first = torch.as_tensor(np.stack([r.out for r in reqs]).astype(np.int64), device=dev)
    ref = afmoe.forward(weights, model, rows, plen - 1, routes=chosen)
    want = ref["logits"]
    if bool(((first < 0) | (first >= model["vocab_size"])).any()):
        gap = float("inf")
    else:
        best = want.max(-1).values
        gap = _worse(0.0, float((best - want.gather(-1, first[..., None])[..., 0]).max()))
    err = 0.0
    kept = _kept_rows(batch)
    for j, i in enumerate(idx):
        if i in kept:
            got = have[j] if have is not None else captured["logits"][kept.index(i)].to(dev)
            err = _worse(err, float((got - want[j]).abs().max() / want[j].abs().max()))
    return {"gap": gap, "err": err, "regret": ref["regret"], "moved": ref["bias_moved"]}


def _setup(config: dict, mix: dict, seed: int, dev):
    from repro_torch.launch import serve
    from repro_torch.zoo.models.transformer import params_from_numpy

    model = config["model"]
    cfg = zoo_config(config)
    weights = afmoe.make_weights(model, seed, dev, getattr(torch, model["dtype"]))
    server = serve.BatchServer(cfg, params_from_numpy(weights, cfg, dev), batch=int(mix["batch"]),
                               max_seq=int(mix["prompt_len"]["max"]) + int(mix["max_new"]),
                               device=dev)
    return serve, weights, server


def _expert_spans(tracer) -> list:
    return [s.attrs for s in tracer.spans() if s.name == "moe.experts" and s.attrs]


def _warm(server, reqs, dev) -> dict:
    """Serves the warm-up batch under the program's tracer: the dispatch's
    spans, and the pairs routed but not computed over its MoE calls."""
    from repro_torch.obs.trace import Tracer

    tracer = Tracer()
    with tracer.activate():
        server.serve_batch(reqs)
    _sync(dev)
    spans = _expert_spans(tracer)
    return {"calls": len(spans), "dropped": sum(s["routed"] - s["computed"] for s in spans)}


def _device_by_op(results, prefix: str) -> tuple:
    """From the profiler's raw results: the device seconds of the kernels
    whose launching op began inside one of the program's spans named
    ``prefix``* (the tracer opens a profiler range of each span's name), and
    the device seconds by launching op's name."""
    events = [e for e in results.events() if not getattr(e, "is_hidden_event", lambda: False)()]
    cpu = torch.autograd.DeviceType.CPU
    ranges = sorted((e.start_ns(), e.end_ns()) for e in events
                    if e.device_type() == cpu and e.name().startswith(prefix))
    starts = np.asarray([a for a, _ in ranges], np.int64)
    ends = np.asarray([b for _, b in ranges], np.int64)
    ops = {e.correlation_id(): (e.name(), e.start_ns()) for e in events
           if e.device_type() == cpu and not e.name().startswith(("cuda", prefix))}
    inside, by_op = 0.0, {}
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        op = ops.get(e.linked_correlation_id())
        if op is None:
            continue
        s = (e.end_ns() - e.start_ns()) / 1e9
        by_op[op[0]] = by_op.get(op[0], 0.0) + s
        j = int(np.searchsorted(starts, op[1], side="right")) - 1
        if j >= 0 and op[1] <= ends[j]:
            inside += s
    return inside, by_op


def _traced(server, reqs: list) -> tuple:
    """One batch under the profiler with the program's tracer active; the
    server's prefill and decode calls kept as the spans each idle gap is put
    down to (the program's, thousands a batch, would make that search
    quadratic).
    Returns (``bench/profile.py``'s reduction, the MoE spans' device
    seconds, the device seconds by launching op, the tracer)."""
    from repro_torch.obs.trace import Tracer

    spans, me, tracer = [], threading.get_ident(), Tracer()
    plain = server.prefill, server.decode

    def marked(name, fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            spans.append(types.SimpleNamespace(name=name, t0=t0, t1=time.perf_counter(), tid=me))
            return out

        return call

    kept = []

    class Kept(torch.profiler.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(self)
            return out

    server.prefill, server.decode = marked("serve.prefill", plain[0]), marked("serve.decode",
                                                                             plain[1])
    try:
        with tracer.activate(), mock.patch.object(torch.profiler, "profile", Kept):
            reduced = prof.profile(lambda: server.serve_batch(reqs), 1, lambda: spans)
    finally:
        server.prefill, server.decode = plain
    inside, by_op = _device_by_op(kept[0].profiler.kineto_results, "moe.")
    return reduced, inside, by_op, tracer


def run(args, cell, dev: torch.device) -> tuple[int, types.SimpleNamespace]:
    """One run of an ``afmoe_serve`` cell on ``dev``; returns (0, the
    readers' context)."""
    from repro_torch.kernels.flash_attention import flash_attention

    config, mix = cell.config, cell.mix
    model = config["model"]
    vocab, max_new, b = model["vocab_size"], int(mix["max_new"]), int(mix["batch"])
    serve, weights, server = _setup(config, mix, args.seed, dev)
    warm = _warm(server, _requests(serve, next(batches(mix, vocab, [args.seed, 1])),
                                   int(mix["warmup_new"]), -b), dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - args.t_start
    log(f"bench: set-up {setup_s:.1f} s, {warm['calls']} MoE calls in the warm-up batch")

    # -- the measured window: one client, closed loop of batches ------------
    gen = batches(mix, vocab, args.seed)
    done, plens, finished, errors = [], {}, [], []
    attempted = failed = 0
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    t_end = t0
    while time.perf_counter() < deadline:
        reqs = _requests(serve, next(gen), max_new, attempted)
        attempted += len(reqs)
        try:
            server.serve_batch(reqs)
        except Exception as e:  # noqa: BLE001 — a failed batch is counted, the loop goes on
            errors.append(repr(e))
            failed += len(reqs)
            t_end = time.perf_counter()
            continue
        t_end = time.perf_counter()
        plen = max(len(r.prompt) for r in reqs)
        plens.update((r.rid, plen) for r in reqs)
        finished.append(plen)
        done += reqs
    window_s = t_end - t0
    tokens = sum(len(r.out) for r in done)
    latencies = [r.t_done - r.t_submit for r in done]
    if latencies:
        q = np.percentile(np.asarray(latencies), [0, 25, 50, 75, 100])
        log("bench: {} requests in {} batches, {} tokens in {:.3f} s; batch s min/q1/median/q3/max "
            "{}".format(len(done), len(finished), tokens, window_s,
                        " ".join(f"{v:.3f}" for v in q)))
    _sync(dev)
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    profile = moe_s = by_op = None
    expert_t_min = k8 = None
    if args.trace:
        t = time.perf_counter()
        reqs = _requests(serve, next(gen), max_new, 2 * attempted)
        k8_before = flash_attention.launches
        profile, moe_s, by_op, tracer = _traced(server, reqs)
        k8_launches = flash_attention.launches - k8_before
        spans = _expert_spans(tracer)
        expert_t_min = sum(counts_afmoe.expert_gemms(model, s["computed"], s["experts"])["t_min"]
                           for s in spans)
        k8 = counts_afmoe.k8_prefill(model, b, max(len(r.prompt) for r in reqs))
        decode = [s["experts"] for s in spans if s["routed"] == b * model["top_k"]]
        log(f"bench: traced batch and its reduction {time.perf_counter() - t:.1f} s; "
            f"{len(spans)} MoE calls, {len(decode)} in decode reading "
            f"{np.mean(decode) if decode else 0:.1f} experts a call; K8 launches {k8_launches} "
            f"(counted {k8['launches']})")
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
        log("bench: device s by launching op: " + "; ".join(f"{n} {v:.3f}" for n, v in top))
        if k8_launches != k8["launches"]:
            k8 = None

    # -- the comparison, once the window has closed and the peak is read ----
    batch = _requests(serve, next(gen), max_new, attempted)
    captured = _capture_routed(server, batch, dev)
    del server
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    idx = judged_rows(captured, int(mix["check_requests"]), [args.seed, 2])
    t = time.perf_counter()
    verdict = judge(weights, model, captured, idx, dev)
    log(f"bench: reference over {len(idx)} rows {time.perf_counter() - t:.1f} s; the expert "
        f"bias changes {100 * verdict['moved']:.1f}% of its (position, layer) top-k sets")
    outside = sum(int(((r.out < 0) | (r.out >= vocab)).sum()) for r in done)
    limits = config["check"]
    checks = {
        "max_logit_gap": (verdict["gap"], float(limits["max_logit_gap"])),
        "max_logit_error": (verdict["err"], float(limits["max_logit_error"])),
        "max_route_regret": (verdict["regret"], float(limits["max_route_regret"])),
        "failed_requests": (failed, 0),
        "token_id_range": (outside, 0),
        "dropped_tokens": (warm["dropped"] if warm["calls"] else float("inf"), 0),
    }
    correct = bool(done) and all(v <= lim for v, lim in checks.values())
    for e in errors[:3]:
        log(f"bench: batch failed: {e}")

    # the server pads every batch to its full size
    flops = sum(counts_afmoe.batch_flops(model, b, plen, max_new) for plen in finished)
    ctx = types.SimpleNamespace(
        cell=cell, seed=args.seed, trace=bool(args.trace), peaks=peaks, setup_s=setup_s,
        requests=len(done), attempted=attempted, failed=failed, window_s=window_s,
        latencies=latencies, tokens=tokens, model_flops=flops,
        peak_bytes=window_peak if dev.type == "cuda" else None, profile=profile,
        prefill_s=captured["prefill_s"],
        decode_step_s=captured["decode_s"] / max(captured["steps"], 1),
        moe_device_s=moe_s, device_by_op=by_op, expert_t_min=expert_t_min, k8=k8,
        correct=correct, checks=checks, memory_peak_bytes=int(max(setup_peak, window_peak)),
    )
    return 0, ctx


def calibrate(cell, seeds: list, out, dev: torch.device) -> list:
    """For each seed, one batch of the window's (its first, from the seed)
    through the timed path, judged as a run judges it (``gap_program``,
    ``err_program``, ``regret_program``), then the control, the reference in
    float8 e4m3 in the program's place on the same rows (``*_fp8``); then,
    on the first three seeds, each fault that ``bench/afmoe_faults.py``
    plants under the timed path (``*_<fault>``).  Writes one JSON line a
    reading to ``out``; returns the rows."""
    from bench import afmoe_faults

    config, mix = cell.config, cell.mix
    model = config["model"]
    n = int(mix["check_requests"])
    rows = []

    def reading(seed, fault=None):
        t0 = time.perf_counter()
        with afmoe_faults.planted(fault) if fault else contextlib.nullcontext():
            serve, weights, server = _setup(config, mix, seed, dev)
            batch = _requests(serve, next(batches(mix, model["vocab_size"], seed)),
                              int(mix["max_new"]), 0)
            captured = _capture_routed(server, batch, dev)
        del server
        gc.collect()
        torch.cuda.empty_cache()
        idx = judged_rows(captured, n, [seed, 2])
        tag = fault or "program"
        v = judge(weights, model, captured, idx, dev)
        row = {"seed": seed, **{f"{k}_{tag}": v[k] for k in ("gap", "err", "regret")},
               f"moved_{tag}": v["moved"]}
        if fault is None:
            c = judge(weights, model, captured, idx, dev, control="fp8")
            row.update({f"{k}_fp8": c[k] for k in ("gap", "err", "regret")})
        row.update(rows=len(idx), prefill_s=captured["prefill_s"],
                   decode_step_s=captured["decode_s"] / captured["steps"],
                   s=time.perf_counter() - t0)
        del weights, captured
        gc.collect()
        torch.cuda.empty_cache()
        rows.append(row)
        out.write(json.dumps(row) + "\n")
        out.flush()
        print(json.dumps(row), flush=True)

    for seed in seeds:
        reading(seed)
    for fault in afmoe_faults.FAULTS:
        for seed in seeds[:3]:
            reading(seed, fault)
    return rows
