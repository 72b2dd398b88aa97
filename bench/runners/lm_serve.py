"""The zoo's serving path: ``launch/serve.py``'s ``BatchServer`` (its
prefill, then one decode step a token through the bf16 KV cache; K8 where
the prefill's S x T passes the zoo's flash threshold) on a dense decoder LM
of the zoo, at the sizes the configuration's ``model`` block states.

Set-up draws the weights on the device from the seed (``reference/lm.py``
``make_weights``, in the served dtype; the program loads those very tensors
through ``params_from_numpy``), builds one ``BatchServer`` and serves one
warm-up batch of the window's shapes.  The window is one client in a closed
loop of batches of the mix's ``batch`` requests, drawn from the seed
(``batches``), each through ``server.serve_batch``.  With ``--trace 1`` one
more batch runs under the profiler, the server's prefill and decode calls
marked as spans.  Once the window has closed and the peak is read, one more
batch runs with the server's prefill and decode wrapped to keep the logits
of its longest and shortest rows; the server is freed; and the plain
reference recomputes, in float32, the rows of a sample of the window's
requests (the longest among them) and of those two rows, exactly as the
server built them (left padding included) with the served tokens fed back.

Checks: ``max_logit_gap``, the widest gap by which the reference's logit of
a served token lies below its best at that position, over every judged
row's served tokens (greedy decoding serves the best); ``max_logit_error``,
the kept rows' program logits against the reference's, over the reference's
largest magnitude; ``failed_requests`` and ``token_id_range`` (served ids
outside the vocabulary, over every window request), both 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import threading
import time
import types

import numpy as np
import torch

from bench import counts, peaks
from bench import profile as prof
from bench.harness import log
from bench.reference import lm


def zoo_config(config: dict):
    """The zoo's ``ModelConfig`` of the configuration's ``arch``, with every
    key of its ``model`` block set as stated there; refused where the zoo's
    architecture holds anything the reference does not compute."""
    from repro_torch.zoo.configs import get_config

    cfg = dataclasses.replace(get_config(config["arch"]), **config["model"])
    plain = (cfg.layer_pattern == ("global",) and not cfg.moe and not cfg.qkv_bias
             and not cfg.attn_softcap and not cfg.final_softcap and not cfg.sliding_window
             and not cfg.encoder_layers and not cfg.cross_seq and not cfg.head_pad_to
             and cfg.padded_vocab == cfg.vocab_size)
    if not plain:
        raise ValueError(f"{cfg.name}: bench/reference/lm.py computes a dense decoder only")
    return cfg


def batches(mix: dict, vocab: int, seed):
    """Batches of prompts (int32 id arrays), endlessly, from ``seed``: lengths
    log-normal about ``prompt_len.median`` with ``sigma``, rounded and
    clipped to [min, max], one of each batch at the max so every batch pads
    to the same length; ids uniform over the vocabulary."""
    rng = np.random.default_rng(seed)
    b, spec = int(mix["batch"]), mix["prompt_len"]
    while True:
        n = np.exp(rng.normal(np.log(spec["median"]), spec["sigma"], b))
        n = np.clip(np.rint(n), spec["min"], spec["max"]).astype(np.int64)
        n[rng.integers(b)] = spec["max"]
        yield [rng.integers(0, vocab, k, dtype=np.int64).astype(np.int32) for k in n]


def _requests(serve, prompts, max_new: int, first_rid: int) -> list:
    now = time.perf_counter()
    return [serve.Request(rid=first_rid + i, prompt=p, max_new=max_new, t_submit=now)
            for i, p in enumerate(prompts)]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _kept_rows(reqs: list) -> list:
    """The indices of a batch's longest and shortest prompts."""
    lens = [len(r.prompt) for r in reqs]
    return sorted({int(np.argmax(lens)), int(np.argmin(lens))})


def _capture(server, reqs: list, dev) -> dict:
    """Serves ``reqs`` as one batch with the server's prefill and decode
    wrapped: the logits of the batch's longest and shortest rows at every
    served position, the prefill's seconds (synchronised on both sides) and
    the decode steps' seconds (to the tokens on the host)."""
    rows = _kept_rows(reqs)
    prefill, decode = server.prefill, server.decode
    kept, times = [], {}

    def keep_prefill(params, tokens, *a):
        _sync(dev)
        t0 = time.perf_counter()
        last, cache = prefill(params, tokens, *a)
        kept.append(last[rows].float())
        _sync(dev)
        times["prefill_s"], times["t1"] = time.perf_counter() - t0, time.perf_counter()
        return last, cache

    def keep_decode(params, cache, token):
        nxt, logits, cache = decode(params, cache, token)
        kept.append(logits[rows].float())
        return nxt, logits, cache

    server.prefill, server.decode = keep_prefill, keep_decode
    try:
        server.serve_batch(reqs)
    finally:
        server.prefill, server.decode = prefill, decode
    return {"batch": reqs, "reqs": [reqs[i] for i in rows], "logits": torch.stack(kept, dim=1),
            "prefill_s": times["prefill_s"], "decode_s": time.perf_counter() - times["t1"],
            "steps": len(kept) - 1}


def _traced(server, reqs: list) -> dict:
    """One batch under the profiler, the server's prefill and decode calls
    kept as spans (host clock), so each idle gap is put down to one."""
    spans, me = [], threading.get_ident()
    plain = server.prefill, server.decode

    def marked(name, fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            spans.append(types.SimpleNamespace(name=name, t0=t0, t1=time.perf_counter(), tid=me))
            return out

        return call

    server.prefill, server.decode = marked("serve.prefill", plain[0]), marked("serve.decode",
                                                                             plain[1])
    try:
        return prof.profile(lambda: server.serve_batch(reqs), 1, lambda: spans)
    finally:
        server.prefill, server.decode = plain


def _served_row(r, plen: int) -> np.ndarray:
    """The row the server built for ``r`` (left-padded with id 0 to the
    batch's ``plen``), followed by the tokens it served but the last."""
    pad = np.zeros(plen - len(r.prompt), np.int64)
    return np.concatenate([pad, r.prompt.astype(np.int64), r.out[:-1].astype(np.int64)])


def _worse(a: float, b: float) -> float:
    """The larger reading; inf where either is NaN, which no limit passes."""
    return float("inf") if a != a or b != b else max(a, b)


def judge(weights: dict, model: dict, judged: list, captured: dict, dev, *,
          control=None) -> dict:
    """The reference over the judged requests (``(request, plen)`` pairs)
    and the captured batch's kept rows.  Returns ``gap`` (the widest gap of
    a served token; inf where an id lies outside the vocabulary) and
    ``err`` (the kept rows' logits against the reference's, relative).
    With ``control``, the reference computed that way stands in for the
    program: ``gap`` of the token it puts first at each position, ``err``
    of its logits, both against the float32 reference."""
    vocab = model["vocab_size"]
    plen_c = max(len(r.prompt) for r in captured["batch"])
    items = list(judged) + [(r, plen_c) for r in captured["reqs"]]
    gap, err = 0.0, 0.0
    by_len: dict = {}
    for i, (r, plen) in enumerate(items):
        by_len.setdefault(plen, []).append(i)
    for plen, idx in sorted(by_len.items()):
        rows = torch.as_tensor(np.stack([_served_row(items[i][0], plen) for i in idx]), device=dev)
        want = lm.logits(weights, model, rows, plen - 1)
        if control is not None:
            got = lm.logits(weights, model, rows, plen - 1, control=control)
            first = got.argmax(-1)
        else:
            got = None
            first = torch.as_tensor(np.stack([items[i][0].out for i in idx]).astype(np.int64),
                                    device=dev)
        if bool(((first < 0) | (first >= vocab)).any()):
            gap = float("inf")
        else:
            best = want.max(-1).values
            gap = _worse(gap, float((best - want.gather(-1, first[..., None])[..., 0]).max()))
        for j, i in enumerate(idx):
            if i < len(judged):
                continue
            have = got[j] if got is not None else captured["logits"][i - len(judged)].to(dev)
            err = _worse(err, float((have - want[j]).abs().max() / want[j].abs().max()))
        del want, got
    return {"gap": gap, "err": err}


def _setup(config: dict, mix: dict, seed: int, dev):
    from repro_torch.launch import serve
    from repro_torch.zoo.models.transformer import params_from_numpy

    model = config["model"]
    cfg = zoo_config(config)
    weights = lm.make_weights(model, seed, dev, getattr(torch, model["dtype"]))
    server = serve.BatchServer(cfg, params_from_numpy(weights, cfg, dev), batch=int(mix["batch"]),
                               max_seq=int(mix["prompt_len"]["max"]) + int(mix["max_new"]),
                               device=dev)
    return serve, weights, server


def _sample(rng, done: list, n: int) -> list:
    """``n`` of the finished requests drawn by ``rng``, the longest first."""
    if not done:
        return []
    longest = int(np.argmax([len(r.prompt) for r in done]))
    rest = [i for i in range(len(done)) if i != longest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if n > 1 else []
    return [done[longest]] + [done[rest[int(i)]] for i in pick]


def run(args, cell, dev: torch.device) -> tuple[int, types.SimpleNamespace]:
    """One run of an ``lm_serve`` cell on ``dev``; returns (0, the readers'
    context)."""
    config, mix = cell.config, cell.mix
    model = config["model"]
    vocab, max_new = model["vocab_size"], int(mix["max_new"])
    serve, weights, server = _setup(config, mix, args.seed, dev)
    warm = next(batches(mix, vocab, [args.seed, 1]))
    server.serve_batch(_requests(serve, warm, int(mix["warmup_new"]), -len(warm)))
    _sync(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - args.t_start

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

    profile = None
    if args.trace:
        t = time.perf_counter()
        profile = _traced(server, _requests(serve, next(gen), max_new, 2 * attempted))
        log(f"bench: traced batch and its reduction {time.perf_counter() - t:.1f} s")

    # -- the comparison, once the window has closed and the peak is read ----
    batch = _requests(serve, next(gen), max_new, attempted)
    captured = _capture(server, batch, dev)
    del server
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = _sample(np.random.default_rng([args.seed, 2]), done, int(mix["check_requests"]))
    t = time.perf_counter()
    verdict = judge(weights, model, [(r, plens[r.rid]) for r in sample], captured, dev)
    log(f"bench: reference over {len(sample) + len(captured['reqs'])} rows "
        f"{time.perf_counter() - t:.1f} s")
    outside = sum(int(((r.out < 0) | (r.out >= vocab)).sum()) for r in done)
    checks = {
        "max_logit_gap": (verdict["gap"], float(config["check"]["max_logit_gap"])),
        "max_logit_error": (verdict["err"], float(config["check"]["max_logit_error"])),
        "failed_requests": (failed, 0),
        "token_id_range": (outside, 0),
    }
    correct = bool(done) and all(v <= lim for v, lim in checks.values())
    for e in errors[:3]:
        log(f"bench: batch failed: {e}")

    # the server pads every batch to its full size
    flops = sum(counts.lm_batch_flops(model, int(mix["batch"]), plen, max_new) for plen in finished)
    ctx = types.SimpleNamespace(
        cell=cell, seed=args.seed, trace=bool(args.trace), peaks=peaks, setup_s=setup_s,
        requests=len(done), attempted=attempted, failed=failed, window_s=window_s,
        latencies=latencies, tokens=tokens, model_flops=flops,
        peak_bytes=window_peak if dev.type == "cuda" else None, profile=profile,
        prefill_s=captured["prefill_s"],
        decode_step_s=captured["decode_s"] / max(captured["steps"], 1),
        correct=correct, checks=checks, memory_peak_bytes=int(max(setup_peak, window_peak)),
    )
    return 0, ctx


def calibrate(cell, seeds: list, out, dev: torch.device) -> list:
    """For each seed, one batch of the window's (its first, from the seed)
    through the timed path, judged as a run judges it: ``gap_program`` and
    ``err_program``; then the control, the reference in float8 e4m3 in the
    program's place on the same rows (``gap_fp8``, ``err_fp8``).  Then, on
    the first three seeds, each fault that ``bench/lm_faults.py`` plants
    under the timed path (``gap_<fault>``, ``err_<fault>``).
    Writes one JSON line a reading to ``out``; returns the rows."""
    from bench import lm_faults

    config, mix = cell.config, cell.mix
    model = config["model"]
    n = int(mix["check_requests"])
    rows = []

    def reading(seed, fault=None):
        t0 = time.perf_counter()
        with lm_faults.planted(fault) if fault else contextlib.nullcontext():
            serve, weights, server = _setup(config, mix, seed, dev)
            batch = _requests(serve, next(batches(mix, model["vocab_size"], seed)),
                              int(mix["max_new"]), 0)
            captured = _capture(server, batch, dev)
        del server
        gc.collect()
        torch.cuda.empty_cache()
        plen = max(len(r.prompt) for r in batch)
        kept = {r.rid for r in captured["reqs"]}
        sample = [r for r in _sample(np.random.default_rng([seed, 2]), batch, n)
                  if r.rid not in kept]
        judged = [(r, plen) for r in sample]
        tag = fault or "program"
        v = judge(weights, model, judged, captured, dev)
        row = {"seed": seed, f"gap_{tag}": v["gap"], f"err_{tag}": v["err"]}
        if fault is None:
            c = judge(weights, model, judged, captured, dev, control="fp8")
            row.update(gap_fp8=c["gap"], err_fp8=c["err"])
        row.update(rows=len(judged) + len(captured["reqs"]), prefill_s=captured["prefill_s"],
                   decode_step_s=captured["decode_s"] / captured["steps"],
                   s=time.perf_counter() - t0)
        del weights
        gc.collect()
        torch.cuda.empty_cache()
        rows.append(row)
        out.write(json.dumps(row) + "\n")
        out.flush()
        print(json.dumps(row), flush=True)

    for seed in seeds:
        reading(seed)
    for fault in lm_faults.FAULTS:
        for seed in seeds[:3]:
            reading(seed, fault)
    return rows
