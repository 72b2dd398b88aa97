#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--bits 1024] [--reps 10] [--seed 0]

Phases (any failure raises and the script exits non-zero):

 1. device    the card's name and power limit (``nvidia-smi``)
 2. build     the CUDA kernels, compiled from ``src/repro_torch/csrc`` (timed);
              the compiler's report for the staged bodies (K3 and K7
              ``fused_staged_kernel``, K4 and K5's MXU body
              ``ld_onehot_staged_kernel``, K5's VPU body ``ld_staged_kernel``,
              K2 and K6 ``hd_staged_kernel``: registers, spills and warnings
              of each instantiation) and their HGMMA (K3, K7) or HMMA (K4, K5
              MXU) and LDGSTS counts by ``cuobjdump`` (none fails, as does any
              instantiation of the bodies they replaced: ``fused_kernel``,
              ``ld_mma_kernel``, ``ld_kernel`` at one group, ``hd_kernel``)
 3. parity    every kernel against its plain PyTorch version at the
              csa-<bits> shapes, f32 and bf16 streams, hidden width 32 and
              the 4-wide first layer: K1 grouped LD, K2 grouped HD, K3
              grouped fused LD (each fanin bucket G=4, each fanout bucket
              G=2, the HD chunks); K4 grouped MXU LD (the buckets of degree
              > 1); K5 ungrouped LD (every bucket, with and without a
              weight, VPU and MXU bodies), K6 ungrouped HD, K7 ungrouped
              fused LD (the fanin buckets, with and without a weight).
              Kernel, plain and library (``torch.sparse.mm``; for K2 and K6
              over the HD rows alone) times by CUDA events; K3's and K4's
              bf16 times at F=32 beside their f32 times; K5's VPU and MXU
              bodies timed apart; K2 and K6 timed at F=32 and F=4, f32 and
              bf16, one call and calls back to back, beside their bound and
              their floor without L2 reuse.  Then K3, K4, K5
              and K7 at the widths the staged bodies pad or slice (F = H =
              24 and 64) on the first WIDTH_ROWS rows of every bucket.
 4. spmm      the paper's single SpMM, ``ops.groot_spmm(x, src, dst, n, w)``
              and its transpose, F=32 f32, on ``groot`` and ``groot_mxu``,
              against ``spmm_ref`` and timed beside ``torch.sparse.mm``.
 5. forward   the model forward on ``groot``, ``groot_mxu``,
              ``groot_fused``, the per-group forwards ``ops.ungrouped(pair)``
              on ``groot``, ``groot_mxu`` and ``groot_fused``, and ``ref``,
              timed with ``torch.cuda.synchronize()`` around it; logits
              finite, compared with ``ref``.  Every K3 launch of the
              ``groot_fused`` forward and every K4 launch of the
              ``groot_mxu`` forward counted (one a bucket a layer), and
              every K5 launch (by body) of phase 4 and of the per-group
              forwards and every K7 launch of the per-group ``groot_fused``
              forward (one a bucket a group a layer), and every K2 and K6
              launch of every path that runs them (K2 one a layer of a
              grouped forward and of a ``Session.verify``, K6 one a fanout
              group a layer of a per-group forward and one a fanout
              ``groot_spmm``), all on ``hd_staged_kernel``; the
              ``groot``, ``groot_fused`` and ``groot_mxu`` forwards
              profiled (device time by kernel, idle share).  ``onehot``
              against ``ref`` at csa-32 (its (E, N) one-hot cannot exist at
              csa-1024).
 6. main path ``repro_torch.api.Session(params=<groot_csa8.npz>, backend=b)
              .verify(dataset="csa", bits=<bits>)`` for ``groot``, then
              ``.verify(prepared=...)`` of the same design (generated once)
              for ``groot_mxu``, ``groot_fused`` and ``ref`` (no kernel).
              Verdicts must equal ``ref``'s and predictions may differ on at
              most 1e-5 of the nodes.  Then ``groot_fused`` and
              ``groot_mxu`` at ``hidden`` 24 and 64 (params from a seeded
              numpy generator) at csa-<ONEHOT_BITS>: verdict and predictions
              equal to ``ref``'s on the same params.
 7. serve     K8 (flash attention): the compiler's report for the wgmma
              body (registers, shared memory, spills from ``-Xptxas=-v``)
              and, where ``cuobjdump`` exists, the counts of its HGMMA and
              UTMALDG opcodes (none fails).  K8 against its plain version at
              the key tile of the body each (dtype, hd) takes (``wgmma`` for
              bf16, ``mma_sync`` for f32), f32 and bf16,
              at (a) qwen3-8b prefill (B=4, 32 query heads over 8 KV heads,
              S=T=4096, hd=128, causal), (b) a gemma2-9b local layer (hd=256,
              S=T=8192, window 4096, softcap 50), (c) bidirectional hd=64
              S=T=4096, (d) ragged causal S=T=4000; kernel, plain and (a, c)
              ``scaled_dot_product_attention`` times by CUDA events, and K8
              alone beside SDPA at prefill_32k's length (B=1, S=T=32768,
              bf16).  Then the main path: ``BatchServer(qwen3-8b, batch=4,
              max_seq=4129)`` at full width and depth (36 layers, weights
              from a seeded generator on the card, fan-in scaled, bf16)
              serves 8 numpy-seeded 4,096-token prompts, 32 new tokens each:
              36 K8 launches per prefill, all on the wgmma body, every
              token < vocab, every logit
              finite; prefill and per-token decode times, tokens/s, peak
              memory.  The first batch's prefill runs again on the model's
              plain schedule (``FLASH_THRESHOLD`` raised: no K8 launch), and
              the f32 model's prefill of it on the plain schedule too is the
              yardstick for that bf16 comparison.

 8. partitioned  the partitioned route (``streaming=False``): (a)
              csa-<PART_A_BITS> (640: a smaller design than phases 2-6, whose
              host partitioning fits the time limit) cut PART_K ways (multilevel, 1-hop re-growth), partitioned once
              (``Session.prepare``), then ``Session(backend="groot")
              .verify(prepared=...)`` and ``gnn.predict_partitioned_loop`` on
              ``groot_fused``, ``groot_mxu`` and ``ref`` over the same
              subgraphs: predictions differ from ``ref``'s on at most 1e-5 of
              the nodes, the verdict equals the one ``ref``'s predictions
              give, K1-K4 launch on the partitions, and the loop's device
              peak may not exceed the largest partition's run alone by more
              than 1%; the loop runs one subgraph structure at a time, and
              after a structure's last partition no bytes may be left, nor
              may the bytes left grow within a structure;
              the host partition and re-growth time, boundary-edge fraction,
              modeled and measured peaks, per-partition times, plan-cache
              builds and launches, accuracy and both verdicts.  (b) the
              paper's input,
              PART_BATCH x csa-<bits> (134,661,008 nodes at 1024 bits), cut
              PART_BATCH_K ways in topological stripes, on ``groot``
              (``Session.verify``) and ``ref`` (the loop): predictions within
              1e-5 of the nodes of each other, status ``classified``, the
              measured peak under the card's memory and no more than 1% over
              the largest partition's run alone; printed with its gen,
              partition and per-partition times, modeled full and peak bytes,
              the reduction of the measured peak against the modeled full,
              accuracy, the share of nodes that differ from phase 6's
              full-graph predictions tiled, and the host's peak RSS over (b) alone (the process's
              peak where the kernel will not reset the mark).
 9. streamed  the streamed route (``streaming=True``, the default) on phase
              8's partitionings, through ``Session.verify(prepared=...)``:
              (a) csa-<PART_A_BITS> k=PART_K on ``groot`` (with its verdict),
              ``groot_fused``, ``groot_mxu`` and ``ref``; (b) the PART_BATCH-
              copy input on ``groot`` and ``ref``: bucketed packed launches
              of ``stream_capacity`` slots, a prefetch thread packing the next
              batch.  Each run's buckets, batches and ``exec_stats`` (pack,
              device, wall and overlap seconds, bytes copied, queue depth,
              capacity halvings, modeled against actual peak), plan-cache
              builds and hits, launches, device peak beside each distinct
              packed launch run alone through a fresh ``BucketRunner`` (the
              largest's warm relaunch profiled), the predictions that differ
              from phase 8's loop and the wall time beside the loop's.  Fails
              on predictions over the limit, any capacity halving, bytes left
              after the run, a peak more than 1% over the largest launch
              alone, or a grouped kernel not launched.  Then K2 at (b)'s
              largest packed batch, whose dummy rows carry its padding edges
              (thousands of 512-slot chunks a row), against its plain version
              and timed.  (c) the budget route: csa-<BUDGET_BITS> under half
              its modeled full-graph bytes, ``explain()`` (mode "streamed", k,
              buckets) and the verdict, held to the loop on the same cut.
              (d) csa-<ONEHOT_BITS> cut PART_K ways: each packed launch's
              core-row logits against the loop's, on the kernel backends and
              ``ref`` (within LOGIT_TOL).
10. cli       the command-line verify path: (a) ``Session.train("csa", 8,
              epochs=TRAIN_EPOCHS)`` on the card (no kernel launches: it
              trains on the segment-sum path), its first TRAIN_CHECK_STEPS
              losses within TRAIN_LOSS_RTOL relative of the CPU's from the
              same init, and the card-trained params' verdict on phase 6's
              csa-<bits> design (``groot``) equal to phase 6's; (b) phase 9
              (c)'s budget cut of csa-<BUDGET_BITS> streamed on ``groot``,
              ``groot_fused`` and ``groot_mxu`` with a journal under
              ``chiprun_out/``, killed by an injected fatal fault at the
              second packed launch, then resumed by a fresh session that
              runs only the partitions not committed: predictions bit-equal
              to the uninterrupted run's (and on ``groot`` to phase 9
              (c)'s), the journal gone, no bytes left; (c) that design
              through ``io.aiger.dump``/``load``: arrays and structural hash
              equal; (d) ``python -m repro_torch.cli verify`` on that file
              (``groot``, the same budget as ``--budget-mb``,
              ``--checkpoint-dir``, ``--explain``) and ``explain`` on it, two
              fresh processes at once: exit 0, mode "streamed", the same
              routing lines; then ``Session.verify(file)`` twice in this
              process, the second ``cached=True`` with no kernel launched.
              Training, hashing, parsing and resume times are printed.

11. service   the batched service route: a ``groot`` Session (shipped params,
              ``warmup=True``, ``max_inflight_per_tenant=4``, bucket ceiling
              SERVICE_MAX_BUCKET_NODES) takes, from two tenants while its
              device worker is held on the first pack, csa-<SERVICE_BITS>,
              two more identical csa-128 (coalesced: ``cached=True``), an
              AIGER csa-128, a fifth ticket of one tenant (``AdmissionError``),
              a garbage AIGER named by its ``groot-name`` comment (fails
              alone), a 1 ms deadline (``DeadlineExceeded``), csa-<
              SERVICE_STREAM_BITS> (over the ceiling: partitioned and streamed
              through ``exec``), a priority-0 csa-128 that must overtake, an
              AIGER csa-64 named ``poison`` whose pack a ``kind=fatal`` fault
              fails (bisected: only it fails) and a csa-<SERVICE_RETRY_BITS>
              whose first launch a ``kind=transient`` fault fails (retried);
              then csa-<SERVICE_MIX_BITS> on ``groot_fused`` and ``groot_mxu``.
              Every successful ticket has a sync ``Session.verify``'s status
              and at most MAX_PRED_MISMATCH of its nodes' predictions
              differing; after ``close()`` no worker thread is alive and no
              byte of the engine is left on the card.  Prints the phase wall,
              tickets per second, each ticket's flight stages,
              ``stats()["service"]``, the launches by kernel and the card's
              idle share over the mix (profiler).

Every driven path of phases 4-11 runs with each kernel's launch count set to
0 just before it and read just after; a kernel's ``launches`` in the summary
is the sum over those paths, and every kernel must have been launched.  The
line before the last is the ``{"kernels": [...]}`` summary; the last is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device, or run from a
directory that lacks the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PARAMS_PATH = ROOT / "src" / "repro_torch" / "data" / "groot_csa8.npz"

# NVIDIA H100 SXM published peaks (dense): HBM3 bandwidth and the f32 rate
# outside the tensor cores, which the kernels' FMA loops run on.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# |kernel - plain| <= TOL * max(1, max|plain|): both sides round each
# message-weight product the same way (K1-K3 widen bf16 to f32 exactly, K4-K7
# round the product to the stream dtype) and accumulate in f32, so only the
# order of the sums differs (a few f32 ulps over at most 1024 terms of
# mean-normalised weights), plus what the TF32 splits drop: K4's and K5's
# MXU two-term split of an f32 product at most 2^-22 of it, K3's and K7's
# three-term contraction at most 2 * 2^-21 of each aggregate-weight product,
# which at the model's magnitudes stays far under TOL
# (tests/test_torch_numerics.py).
TOL = 1e-5
MAX_PRED_MISMATCH = 1e-5
# |logits - ref logits| <= LOGIT_TOL * max(1, max|ref logits|) for every
# forward: four layers of f32 sums in other orders (6.3e-5 at most on an
# H100 at csa-1024, PERF.md)
LOGIT_TOL = 1e-3
# the design onehot runs on: its (E, N) one-hot grows with E * N; also the
# design of the hidden-width sessions of phase 6
ONEHOT_BITS = 32
# the hidden widths the staged bodies pad (24) or slice (64), and the rows
# of each csa-<bits> bucket they are held to their plain versions on
WIDTHS = (24, 64)
WIDTH_ROWS = 2**18 + 5
# K8 runs on the tensor cores: bf16 streams at the dense bf16 rate, f32
# streams as three TF32 MMAs per product (high x high, high x residual,
# residual x high), so at a third of the dense TF32 rate
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
F32_MMAS = 3
# K3 contracts on the tensor cores as the same three TF32 products, and
# aggregates with f32 FMAs: its operations are counted at those two rates
# K8 against its plain version, which rounds at the same points and walks the
# same key tiles (``key_tile``: 128 keys on the bf16 wgmma body, 64 at hd 256
# and on the f32 mma_sync body): |kernel - plain| <= FLASH_TOL * max(1,
# max|plain|).
# f32: the kernel's three-TF32 products (split error under 2 * 2^-21 of each),
# exp/tanh ulps and sums over up to 8192 keys in other orders.  bf16: the two
# sides' f32 scores differ in their last bits, so now and then they round a
# p to neighbouring bf16 values, which moves that row's outputs by up to
# 2^-8 * p * |v| / l, two output ulps and more where outputs are small
# (PERF.md): no single output can be held much tighter than one bf16 ulp at
# the largest output.  A rounding fault shows in how many outputs move: at
# most FLASH_OFF_SHARE of them may differ from plain's, which rounds the same
# f32 output (acc / l) once; p or the output truncated moves far more.
FLASH_TOL = {"f32": 5e-5, "bf16": 2**-7}
FLASH_OFF_SHARE = 2**-4
# K8 parity shapes: (label, batch, query heads, KV heads, S = T, hd, causal,
# window, softcap)
FLASH_SHAPES = (
    ("a qwen3-8b prefill", 4, 32, 8, 4096, 128, True, 0, 0.0),
    ("b gemma2-9b local", 1, 16, 8, 8192, 256, True, 4096, 50.0),
    ("c bidirectional", 1, 32, 32, 4096, 64, False, 0, 0.0),
    ("d ragged causal", 1, 32, 8, 4000, 128, True, 0, 0.0),
)
# the serve phase: qwen3-8b, 8 requests of 4,096 prompt tokens, 32 new each
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 4, 4096, 32
# the partitioned phase: (a) csa-<bits> cut PART_K ways (multilevel); (b) the
# paper's input, PART_BATCH copies of csa-<bits>, cut PART_BATCH_K ways in
# topological stripes (two a copy, so re-growth has real boundaries)
PART_K = 4
PART_BATCH, PART_BATCH_K = 16, 32
# (a)'s design: the host's multilevel partitioning of csa-1024 took 120-171 s
# of the script's time limit; csa-640 still has HD rows (its inputs' fanout
# degree 640 > E_T), so every grouped kernel runs on its partitions
PART_A_BITS = 640
# the streamed phase's budget route: csa-<BUDGET_BITS> under half its modeled
# full-graph bytes
BUDGET_BITS = 256
# the command-line phase: Session.train at the reference's train_model
# settings (csa-8, TRAIN_EPOCHS), its first TRAIN_CHECK_STEPS losses within
# TRAIN_LOSS_RTOL relative of the CPU's from the same init (f32 sums in other
# orders: index_add_ adds with atomics on the card); the journal, AIGER and
# the CLI on phase 9 (c)'s csa-<BUDGET_BITS> budget cut (csa-640 took the
# script to 1,096 s of its 1,200), each CLI process given CLI_TIMEOUT_S
TRAIN_EPOCHS, TRAIN_CHECK_STEPS, TRAIN_LOSS_RTOL = 300, 20, 1e-4
CLI_TIMEOUT_S = 300
# the service phase: csa-<b> for b in SERVICE_BITS submitted concurrently to a
# groot Session's batched engine, whose bucket ceiling streams
# csa-<SERVICE_STREAM_BITS>; then SERVICE_MIX_BITS on groot_fused and groot_mxu
SERVICE_BITS = (64, 128, 256)
SERVICE_RETRY_BITS = 96
SERVICE_STREAM_BITS = 512
SERVICE_MAX_BUCKET_NODES = 2**20
SERVICE_MIX_BITS = (64, 128, 256)
SERVICE_TIMEOUT_S = 600


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


def back_to_back_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` with ``reps`` calls queued back to back
    between two CUDA events: the card's time a call wherever the host
    queues them faster than the card runs them (no host time before the
    first launch, unlike :func:`cuda_ms`)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_profile(what: str, fn):
    """Run ``fn`` once under torch.profiler with synchronize around it;
    log and return its device time by kernel (self time, device-side events
    only: the aten ops that launched them carry the same time again) beside
    the wall time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    log(f"profile {what}: device {dev_ms:.2f} ms of {wall_ms:.2f} ms wall "
        f"(idle share {1 - dev_ms / wall_ms:.3f}, profiler on)")
    for name, ms, cnt in rows[:10]:
        log(f"  {ms:9.3f} ms  x{cnt:<4d} {name[:90]}")
    return out, dict(wall_ms=wall_ms, device_ms=dev_ms, top=rows[:15])


def flash_parity(got, want, tag: str) -> dict:
    """K8's output against its plain version's, both in the stream dtype:
    the readings and whether they are within the limits above."""
    err = (got.float() - want.float()).abs().max().item()
    limit = FLASH_TOL[tag] * max(1.0, want.float().abs().max().item())
    par = dict(max_abs_err=err, limit=limit, ok=err <= limit)
    if tag == "bf16":
        par["off_share"] = off = (got != want).float().mean().item()
        par["ok"] = par["ok"] and off <= FLASH_OFF_SHARE
    return par


def bf16_truncated(x32):
    """``x32`` rounded to bf16 toward zero: a planted one-ulp rounding fault."""
    import torch

    return (x32.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)


@contextlib.contextmanager
def plain_schedule(what: str):
    """Run attention on the model's plain schedule (``FLASH_THRESHOLD``
    raised) inside the block; fail if K8 launched there."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.zoo.models import attention as A

    saved, before = A.FLASH_THRESHOLD, fa.flash_attention.launches
    A.FLASH_THRESHOLD = 1 << 62
    try:
        yield
    finally:
        A.FLASH_THRESHOLD = saved
    if fa.flash_attention.launches != before:
        fail(f"{what} launched K8")


def attended_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs that K8's mask keeps: the work the data needs."""
    import numpy as np

    q = np.arange(s)
    hi = np.minimum(q, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def k8_build_report() -> dict:
    """What the compiler made of K8's wgmma body: each instantiation's
    registers, spills and shared memory (``-Xptxas=-v``), and the counts of
    the HGMMA (wgmma) and UTMALDG (TMA load) opcodes in the library's SASS
    where ``cuobjdump`` exists; fails if either count is 0."""
    import re

    from repro_torch.kernels import build

    report: dict = {"ptxas": {}}
    entry = None
    for line in build.build_log("flash_attention").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else None
        elif entry and "flash_wgmma_kernel" in entry and (
                "registers" in line or "spill" in line or "smem" in line):
            hd = re.search(r"flash_wgmma_kernelILi(\d+)E", entry)
            report["ptxas"].setdefault(f"hd{hd.group(1) if hd else '?'}", []).append(
                " ".join(line.replace("ptxas info    :", "").split()))
    for hd, lines in sorted(report["ptxas"].items()):
        log(f"k8 wgmma body {hd}: {'; '.join(lines)}")
    for hd in (64, 128, 256):
        smem = build.library("flash_attention").flash_wgmma_smem(hd)
        report.setdefault("dynamic_smem_bytes", {})[f"hd{hd}"] = smem
    log(f"k8 wgmma body dynamic shared memory (bytes): {json.dumps(report['dynamic_smem_bytes'])}")
    funcs = sass_by_function("flash_attention")
    if funcs:
        sass = "\n".join(funcs.values())
        report["sass_counts"] = {op: len(re.findall(rf"\b{op}\b", sass))
                                 for op in ("HGMMA", "UTMALDG", "UTMASTG")}
        log(f"k8 SASS opcodes (cuobjdump): {json.dumps(report['sass_counts'])}")
        if not report["sass_counts"]["HGMMA"] or not report["sass_counts"]["UTMALDG"]:
            fail(f"K8's library holds no wgmma or no TMA load: {report['sass_counts']}")
    else:
        log("k8 SASS opcodes: no cuobjdump beside nvcc, not counted")
    return report


# the staged bodies: kernel -> (library, its tensor-core opcode or None)
STAGED_BODIES = {"fused_staged_kernel": ("fused_sage", "HGMMA"),
                 "ld_onehot_staged_kernel": ("groot_spmm", "HMMA"),
                 "ld_staged_kernel": ("groot_spmm", None),
                 "hd_staged_kernel": ("groot_spmm", None)}
# each staged kernel of the summary: its body (K5: the VPU body's; its MXU
# body is K4's at one group)
STAGED_KERNELS = {"fused_ld_grouped": "fused_staged_kernel",
                  "ld_grouped_mxu": "ld_onehot_staged_kernel",
                  "ld_bucket": "ld_staged_kernel", "fused_ld": "fused_staged_kernel"}
# instantiations of the bodies the staged ones replaced (none may remain):
# the first K3's and K7's fused_kernel, K5's ld_mma_kernel, ld_kernel at one
# group, K2's and K6's hd_kernel (one block a row)
REPLACED = r"(fused_kernelI|ld_mma_kernelI|ld_kernelI(?:f|13__nv_bfloat16)Li1E|\dhd_kernelI)"


def sass_by_function(lib: str) -> dict:
    """{mangled function name: its SASS text} of one built library, by
    ``cuobjdump -sass`` (empty where the toolkit has no cuobjdump)."""
    import shutil

    from repro_torch.kernels import build

    cuobjdump = shutil.which("cuobjdump") or str(Path(build.nvcc()).parent / "cuobjdump")
    if not Path(cuobjdump).exists():
        return {}
    sass = subprocess.run([cuobjdump, "-sass", str(build.library_path(lib))],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def staged_label(mangled: str):
    """(kernel, label) of a staged body's instantiation from its mangled
    name, e.g. ("fused_staged_kernel", "f32 G=4 F=32 K3"); None for any
    other function."""
    import re

    dt = r"I(f|13__nv_bfloat16)"
    pats = {
        # <T, G, F, kWeighted, kRound>: K3 (1, 0), K7 with a weight (1, 1), K7 (0, 1)
        "fused_staged_kernel": dt + r"Li(\d)ELi(\d+)ELb([01])ELb([01])E",
        # <T, G, F, kWeighted>: K4, K5's MXU body (G = 1)
        "ld_onehot_staged_kernel": dt + r"Li(\d)ELi(\d+)ELb([01])E",
        # <T, F, kWeighted, kRound>: K5 (round), K1 at one group (fmaf)
        "ld_staged_kernel": dt + r"Li(\d+)ELb([01])ELb([01])E",
        # <T, G, F, kWeighted, kRound>: K2 (1, 0), K6 with a weight (1, 1), K6 (0, 1)
        "hd_staged_kernel": dt + r"Li(\d)ELi(\d+)ELb([01])ELb([01])E",
    }
    for kern, pat in pats.items():
        m = re.search(r"\d" + kern + pat, mangled)
        if m is None:
            continue
        g = m.groups()
        t = "f32" if g[0] == "f" else "bf16"
        if kern in ("fused_staged_kernel", "hd_staged_kernel"):
            k = ("K3", "K7") if kern == "fused_staged_kernel" else ("K2", "K6")
            mode = {("1", "0"): k[0], ("1", "1"): f"{k[1]} w", ("0", "1"): k[1]}.get(g[3:], "?")
            return kern, f"{t} G={g[1]} F={g[2]} {mode}"
        if kern == "ld_onehot_staged_kernel":
            return kern, f"{t} G={g[1]} F={g[2]}{' w' if g[3] == '1' else ''}"
        mode = {("1", "1"): "K5 w", ("0", "1"): "K5", ("1", "0"): "K1 G=1"}.get(g[2:], "?")
        return kern, f"{t} F={g[1]} {mode}"
    return None


def staged_build_report() -> dict:
    """What the compiler made of the staged bodies (K3, K4, K5's two, K7;
    K2 and K6's HD body):
    each instantiation's registers and spills (``-Xptxas=-v``), the
    compiler's warnings, and its tensor-core (fused_staged_kernel HGMMA:
    wgmma; ld_onehot_staged_kernel HMMA: mma.sync) and LDGSTS (cp.async)
    counts in the SASS; fails if an instantiation lacks either, or if a
    library still holds an instantiation of a body they replaced
    (:data:`REPLACED`)."""
    import re

    from repro_torch.kernels import build

    report: dict = {kern: {"library": lib, "ptxas": {}, "sass": {}}
                    for kern, (lib, _) in STAGED_BODIES.items()}
    for lib in sorted({lib for lib, _ in STAGED_BODIES.values()}):
        text = build.build_log(lib)
        warnings = [line.strip() for line in text.splitlines() if "warning" in line]
        log(f"compiler warnings for {lib}.cu: {warnings or 'none'}")
        report[f"warnings_{lib}"] = warnings
        entry = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = staged_label(line.split("'")[1]) if "'" in line else None
                if "'" in line and re.search(REPLACED, line.split("'")[1]):
                    fail(f"{lib}: an instantiation of a replaced body remains: {line.strip()}")
            elif entry and ("registers" in line or "spill" in line):
                report[entry[0]]["ptxas"].setdefault(entry[1], []).append(
                    " ".join(line.replace("ptxas info    :", "").split()))
        funcs = sass_by_function(lib)
        for name, sass in funcs.items():
            if re.search(REPLACED, name):
                fail(f"{lib}: an instantiation of a replaced body remains: {name}")
            lab = staged_label(name)
            if lab:
                mma = STAGED_BODIES[lab[0]][1]
                report[lab[0]]["sass"][lab[1]] = {op: len(re.findall(rf"\b{op}\b", sass))
                                                  for op in (mma, "LDGSTS") if op}
        if not funcs:
            log(f"{lib}: no cuobjdump beside nvcc, SASS not counted")
    # the instantiations the csa path runs (F = 32 at hidden 32, F = 4 first)
    path = {"fused_staged_kernel": ("f32 G=4 F=32 K3", "f32 G=4 F=4 K3", "bf16 G=4 F=32 K3",
                                    "f32 G=1 F=32 K7 w", "f32 G=1 F=4 K7 w",
                                    "bf16 G=1 F=32 K7 w"),
            "ld_onehot_staged_kernel": ("f32 G=4 F=32 w", "f32 G=2 F=32 w", "bf16 G=4 F=32 w",
                                        "f32 G=1 F=32 w", "f32 G=1 F=32", "bf16 G=1 F=32 w"),
            "ld_staged_kernel": ("f32 F=32 K5 w", "f32 F=4 K5 w", "f32 F=32 K5",
                                 "bf16 F=32 K5 w"),
            "hd_staged_kernel": ("f32 G=2 F=32 K2", "f32 G=2 F=4 K2", "bf16 G=2 F=32 K2",
                                 "bf16 G=2 F=4 K2", "f32 G=1 F=32 K6 w", "f32 G=1 F=4 K6 w",
                                 "f32 G=1 F=32 K6", "bf16 G=1 F=32 K6 w")}
    for kern, keys in path.items():
        rep = report[kern]
        for key in keys:
            log(f"{kern} {key}: {'; '.join(rep['ptxas'].get(key, ['no report']))}; "
                f"SASS {json.dumps(rep['sass'].get(key, 'not counted'))}")
        rep["spilled"] = sorted(
            k for k, lines in rep["ptxas"].items() for x in lines
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", x)))
        log(f"{kern}: {len(rep['ptxas'])} instantiations, spilling: {rep['spilled'] or 'none'}")
        if rep["sass"] and any(not all(c.values()) for c in rep["sass"].values()):
            fail(f"{kern}: an instantiation without {STAGED_BODIES[kern][1]} or LDGSTS: "
                 f"{rep['sass']}")
        if sass_by_function(STAGED_BODIES[kern][0]) and not rep["sass"]:
            fail(f"{kern}: no instantiation found in {STAGED_BODIES[kern][0]}'s SASS")
    return report


def flash_phase(args, dev, k8: dict) -> dict:
    """K8 against its plain version at the FLASH_SHAPES, f32 and bf16; times
    beside the bound and SDPA; K8 alone at prefill_32k's length."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    build_report = k8_build_report()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for label, b, h, kvh, s, hd, causal, window, cap in FLASH_SHAPES:
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q = torch.randn((b * h, s, hd), generator=gen, device=dev).to(dtype)
            k = torch.randn((b * kvh, s, hd), generator=gen, device=dev).to(dtype)
            v = torch.randn((b * kvh, s, hd), generator=gen, device=dev).to(dtype)
            kw = dict(causal=causal, window=window, softcap=cap)
            body, tile = fa.BODIES[(dtype, hd)], fa.key_tile(dtype, hd)

            def run():
                return fa.flash_attention(q, k, v, kv_block=s, **kw)

            def plain():
                return fa.flash_plain(q, k, v, kv_tile=tile, **kw)

            before = dict(fa.flash_attention.body_launches)
            got = run()
            if fa.flash_attention.body_launches[body] != before[body] + 1:
                fail(f"flash_attention {label} {tag}: not launched on its {body} body")
            want32 = fa.flash_plain(q, k, v, out_dtype=torch.float32, kv_tile=tile, **kw)
            want = want32.to(dtype)
            torch.cuda.synchronize()
            par = flash_parity(got, want, tag)
            ok = bool(torch.isfinite(got).all()) and par["ok"]
            what = f"{label} BH={b * h}/{b * kvh} S=T={s} hd={hd} {tag} {body}/{tile}"
            reading = f"tol {par['limit']:.3e}"
            if tag == "bf16":  # the check must see a planted rounding fault
                planted = flash_parity(bf16_truncated(want32), want, tag)
                par["planted_truncation"] = planted
                ok = ok and not planted["ok"]
                reading += (f", off {par['off_share']:.3e} (limit {FLASH_OFF_SHARE:.3e}); "
                            f"plain truncated: off {planted['off_share']:.3e}")
            log(f"parity flash_attention {what:50s} max_abs_err {par['max_abs_err']:.3e} "
                f"{reading} {'ok' if ok else 'MISS'}")
            k8["max_abs_err"] = max(k8["max_abs_err"], par["max_abs_err"])
            if not ok:
                fail(f"flash_attention {what}: {json.dumps(par)}")
            del got, want, want32
            ms = cuda_ms(run, args.reps)
            plain_ms = cuda_ms(plain, 2)
            lib_ms = None
            if label[0] in "ac":  # no window, no softcap: one SDPA call computes it
                g = h // kvh
                qs = q.view(b, h, s, hd)
                ks = k.view(b, kvh, s, hd).repeat_interleave(g, 1)
                vs = v.view(b, kvh, s, hd).repeat_interleave(g, 1)
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=causal), args.reps)
                del qs, ks, vs
            flops = 4.0 * b * h * hd * attended_pairs(s, s, causal, window)
            bytes_ = 2 * (q.numel() + k.numel()) * q.element_size()  # q, o; k, v
            t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / (PEAK_BF16_FLOPS if tag == "bf16" else PEAK_TF32_FLOPS / F32_MMAS) * 1e3
            row = dict(what=what, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, parity=par,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=bytes_, flops=flops, tflops=flops / ms / 1e9)
            rows.append(row)
            log(f"time   flash_attention {what:50s} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                f"sdpa {'-' if lib_ms is None else f'{lib_ms:.4f} ms'} bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), {row['tflops']:.1f} TFLOP/s")
            if label[0] == "a" and tag == "bf16":  # the main path's shape and dtype
                k8.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=row["bound_ms"],
                          bytes_ms=t_bytes, ops_ms=t_ops)
            del q, k, v
        torch.cuda.empty_cache()
    # prefill_32k's length: no plain version (its scores would take 137 GB)
    b, h, kvh, s, hd = 1, 32, 8, 32768, 128
    q = torch.randn((b * h, s, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b * kvh, s, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b * kvh, s, hd), generator=gen, device=dev).to(torch.bfloat16)
    before = fa.flash_attention.body_launches["wgmma"]
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail("flash_attention at S=T=32768: non-finite output")
    if fa.flash_attention.body_launches["wgmma"] != before + 1:
        fail("flash_attention at S=T=32768: not launched on the wgmma body")
    del out
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 3)
    ks = k.view(b, kvh, s, hd).repeat_interleave(h // kvh, 1)
    vs = v.view(b, kvh, s, hd).repeat_interleave(h // kvh, 1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q.view(b, h, s, hd), ks, vs, is_causal=True), 3)
    flops = 4.0 * b * h * hd * attended_pairs(s, s, True, 0)
    long = dict(what=f"prefill_32k BH={b * h}/{b * kvh} S=T={s} hd={hd} bf16", ms=ms,
                library_ms=lib_ms, bound_ms=flops / PEAK_BF16_FLOPS * 1e3, bound_by="operations",
                tflops=flops / ms / 1e9)
    log(f"time   flash_attention {long['what']:50s} kernel {ms:.3f} ms sdpa {lib_ms:.3f} ms "
        f"bound {long['bound_ms']:.3f} ms (operations), {long['tflops']:.1f} TFLOP/s")
    del q, k, v, ks, vs
    torch.cuda.empty_cache()
    return dict(build=build_report, shapes=rows, prefill_32k=long)


def serve_phase(args, dev, drive, launches: dict, bodies: dict) -> dict:
    """The main path: qwen3-8b served through BatchServer at full width and
    depth, K8 on every prefill layer; then the first batch's prefill on the
    plain schedule and in f32."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.zoo.configs import get_config
    from repro_torch.zoo.configs.base import materialize, param_tree
    from repro_torch.zoo.models.transformer import params_from_numpy
    from repro_torch.zoo.serving.decode import make_prefill_step

    cfg = get_config("qwen3-8b")
    max_seq = SERVE_PROMPT + SERVE_NEW + 1
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    toks0 = torch.as_tensor(np.stack(prompts[:SERVE_BATCH]), device=dev)
    # f32 weights drawn on the card (per-depth tree: fan-in scaled), first the
    # f32 model's prefill of the first batch on the plain schedule (the
    # yardstick, independent of K8), then the bf16 weights
    t0 = time.perf_counter()
    tree = materialize(param_tree(cfg), torch.Generator(device=dev).manual_seed(args.seed))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with plain_schedule("the f32 yardstick prefill"):
        logits32, _ = make_prefill_step(cfg32, max_seq)(params_from_numpy(tree, cfg32, dev),
                                                        toks0)
    params = params_from_numpy(tree, cfg, dev)
    del tree
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    log(f"serve qwen3-8b: {n_params} parameters (bf16), f32 yardstick prefill and weights "
        f"in {setup_s:.1f} s")

    server = BatchServer(cfg, params, batch=SERVE_BATCH, max_seq=max_seq)
    times: dict = {"prefill": [], "decode": []}
    finite = torch.ones((), dtype=torch.bool, device=dev)
    first: dict = {}

    def timed(name, fn, at):
        def run(*a):
            nonlocal finite
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            finite = finite & torch.isfinite(out[at]).all()
            if name not in first:
                first[name] = out[at].float().clone()
            return out
        return run

    server.prefill = timed("prefill", server.prefill, 0)
    server.decode = timed("decode", server.decode, 1)

    def serve_all():
        queue = [Request(rid=i, prompt=p, max_new=SERVE_NEW, t_submit=time.perf_counter())
                 for i, p in enumerate(prompts)]
        done = []
        while queue:
            batch, queue = queue[:SERVE_BATCH], queue[SERVE_BATCH:]
            done += server.serve_batch(batch)
        return done

    torch.cuda.reset_peak_memory_stats()
    done, wall = drive("serve qwen3-8b", serve_all)
    peak = torch.cuda.max_memory_allocated()
    used = {k: v for k, v in launches["serve qwen3-8b"].items() if v}
    n_prefill = len(times["prefill"])
    out = np.stack([r.out for r in done])
    n_tok = out.size
    rep = dict(
        requests=len(done), batch=SERVE_BATCH, prompt_tokens=SERVE_PROMPT, new_tokens=SERVE_NEW,
        wall_s=wall, tokens_per_s=n_tok / wall, prompt_tokens_per_s=
        SERVE_REQUESTS * SERVE_PROMPT / sum(times["prefill"]),
        prefill_ms=[t * 1e3 for t in times["prefill"]],
        decode_ms_per_token=statistics.median(times["decode"]) * 1e3,
        decode_ms_p90=float(np.percentile(times["decode"], 90)) * 1e3,
        peak_bytes=peak, launches=used, setup_s=setup_s, parameters=n_params)
    log(f"serve qwen3-8b: {len(done)} requests, {n_tok} tokens in {wall:.2f} s "
        f"({rep['tokens_per_s']:.1f} tok/s); prefill (B={SERVE_BATCH}, S={SERVE_PROMPT}) "
        f"{', '.join(f'{t:.1f}' for t in rep['prefill_ms'])} ms; decode "
        f"{rep['decode_ms_per_token']:.2f} ms/token (p90 {rep['decode_ms_p90']:.2f}); peak "
        f"{peak / 1e9:.2f} GB; launches {json.dumps(used)}")
    if used.get("flash_attention", 0) != cfg.num_layers * n_prefill or len(used) != 1:
        fail(f"serve: launches {used}, expected flash_attention {cfg.num_layers} per prefill "
             f"x {n_prefill} prefills and no other kernel")
    rep["k8_body_launches"] = body = bodies["serve qwen3-8b"]
    log(f"serve qwen3-8b: K8 launches by body {json.dumps(body)}")
    if body != {"wgmma": cfg.num_layers * n_prefill, "mma_sync": 0}:
        fail(f"serve: K8 launches by body {body}, expected all {cfg.num_layers * n_prefill} "
             f"on the wgmma body")
    if out.shape != (SERVE_REQUESTS, SERVE_NEW) or out.min() < 0 or out.max() >= cfg.vocab_size:
        fail(f"serve: tokens of shape {out.shape} in [{out.min()}, {out.max()}]")
    if not bool(finite):
        fail("serve: non-finite logits")

    # the first batch again on the model's plain schedule (no K8 launch)
    with plain_schedule("the plain-schedule prefill"):
        t0 = time.perf_counter()
        plain, _ = make_prefill_step(cfg, max_seq)(params, toks0)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    k8, plain, f32 = first["prefill"], plain.float(), logits32.float()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    d_k8, d_bf16, d_k8_f32 = rel(k8, plain), rel(plain, f32), rel(k8, f32)
    agree = (k8.argmax(-1) == plain.argmax(-1)).float().mean().item()
    rep.update(plain_prefill_s=plain_s, rel_k8_vs_plain=d_k8, rel_plain_vs_f32=d_bf16,
               rel_k8_vs_f32=d_k8_f32, argmax_agreement=agree)
    # both bf16 prefills sit about d_bf16 from the f32 model's logits, so they
    # may sit up to twice that apart; the two round scores at other points
    # by design (the plain schedule to bf16, K8 keeps f32)
    ok = d_k8 <= 2 * d_bf16 and torch.isfinite(plain).all()
    log(f"serve qwen3-8b: last-position logits, relative L2: K8 vs plain schedule {d_k8:.4e} "
        f"(limit 2 x plain vs f32 = {2 * d_bf16:.4e}), K8 vs f32 {d_k8_f32:.4e}; argmax "
        f"agreement {agree:.2f}; plain prefill {plain_s:.2f} s {'ok' if ok else 'MISS'}")
    if not ok:
        fail(f"serve: K8 prefill logits {d_k8:.4e} from the plain schedule's, over {2 * d_bf16:.4e}")
    del plain, logits32
    # where a K8 prefill's and a decode step's device time goes
    (last, cache), rep["profile_prefill"] = device_profile(
        f"qwen3-8b prefill B={SERVE_BATCH} S={SERVE_PROMPT}",
        lambda: make_prefill_step(cfg, max_seq)(params, toks0))
    tok = last.argmax(-1)[:, None].to(torch.int32)
    tok, _, cache = server.decode(params, cache, tok)  # warm
    _, rep["profile_decode"] = device_profile(
        f"qwen3-8b decode step B={SERVE_BATCH}", lambda: server.decode(params, cache, tok))
    del server, params, cache
    torch.cuda.empty_cache()
    return rep


def random_params(hidden: int, seed: int) -> dict:
    """A ``GNNConfig(hidden=hidden)`` params tree (4 layers from the 4 input
    features, 5 classes) from a seeded numpy generator, each matrix scaled
    by 1 / sqrt(its fan-in)."""
    import numpy as np

    from repro_torch.core import gnn

    rng = np.random.default_rng(seed)
    dims = [gnn.GNNConfig().in_features] + [hidden] * gnn.GNNConfig().num_layers

    def mat(fan_in, fan_out):
        return (rng.standard_normal((fan_in, fan_out)) / np.sqrt(fan_in)).astype(np.float32)

    layers = [{**{nm: mat(a, b) for nm in gnn.LAYER_WEIGHTS},
               "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
              for a, b in zip(dims, dims[1:])]
    classes = gnn.GNNConfig().num_classes
    return {"layers": layers, "head": {"w": mat(hidden, classes),
                                       "b": np.zeros(classes, np.float32)}}


def partition_probe(records: list, kernels: dict, base: int):
    """An ``on_partition`` hook: per partition, its wall time from the end
    of the previous one (host stages, plan build or cache hit, H2D, forward,
    D2H), its plan-cache builds and hits, its launches of each kernel, its
    device peak above ``base`` (the peak is reset after each partition) and
    the allocated bytes it left above ``base``."""
    import torch

    from repro_torch.kernels.plan_cache import PLAN_CACHE

    def counts():
        return {kn: k["fn"].launches for kn, k in kernels.items()}

    last = {"t": time.perf_counter(), "cache": PLAN_CACHE.snapshot(), "n": counts()}
    torch.cuda.reset_peak_memory_stats()

    def hook(i, sg):
        now, snap, n = time.perf_counter(), PLAN_CACHE.snapshot(), counts()
        records.append(dict(
            part=i, nodes=sg.num_nodes, core=sg.num_core, edges=sg.num_edges,
            s=now - last["t"], plan_builds=snap.builds - last["cache"].builds,
            plan_hits=snap.hits - last["cache"].hits,
            launches={kn: n[kn] - last["n"][kn] for kn in n if n[kn] - last["n"][kn]},
            peak_above_base=torch.cuda.max_memory_allocated() - base,
            left_above_base=torch.cuda.memory_allocated() - base))
        torch.cuda.reset_peak_memory_stats()
        last.update(t=time.perf_counter(), cache=snap, n=counts())

    return hook


def loop_summary(tag: str, records: list, subgraphs) -> dict:
    """Log a partitioned loop's per-partition records.  The loop holds one
    subgraph structure at a time (``gnn.structure_groups``): fail if bytes
    are left after a structure's last partition, or if the bytes left grow
    from one partition to the next within a structure."""
    from repro_torch.core import gnn

    for r in records:
        log(f"  {tag} part {r['part']:2d}: {r['nodes']} nodes ({r['core']} core) "
            f"{r['edges']} edges {r['s']:.3f} s, plan builds {r['plan_builds']} hits "
            f"{r['plan_hits']}, peak {r['peak_above_base'] / 2**30:.3f} GiB, left "
            f"{r['left_above_base']} B, launches {json.dumps(r['launches'])}")
    left = {r["part"]: r["left_above_base"] for r in records}
    for grp in gnn.structure_groups(subgraphs):
        held = [left[i] for i in grp]
        if held[-1] > 0 or any(b > a for a, b in zip(held, held[1:])):
            fail(f"{tag}: device bytes left after the partitions {grp} of one structure: "
                 f"{held} (want none after the last, no growth before it)")
    return dict(parts=records, seconds=[r["s"] for r in records],
                peak_above_base=max(r["peak_above_base"] for r in records))


def _vm_hwm_gib():
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return None


def reset_peak_rss() -> bool:
    """Restart this process's peak-RSS mark (``VmHWM``); False where the
    kernel does not allow it or keeps no such mark."""
    try:
        Path("/proc/self/clear_refs").write_text("5")
    except OSError:
        return False
    return _vm_hwm_gib() is not None


def peak_rss_gib() -> float:
    """The process's peak resident set in GiB: ``VmHWM`` (since the last
    :func:`reset_peak_rss`), else ``ru_maxrss`` (the whole process)."""
    hwm = _vm_hwm_gib()
    if hwm is not None:
        return hwm
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def partitioned_phase(args, dev, drive, launches: dict, kernels: dict, model,
                      params_path, full_predictions) -> tuple[dict, dict]:
    """Phase 8: the partitioned route (``streaming=False``) at
    csa-<PART_A_BITS> (a) and at PART_BATCH copies of csa-<bits> (b).
    ``full_predictions`` are phase 6's full-graph ``groot`` predictions at
    csa-<bits>.  Returns the report and, for phase 9, each design's prepared
    partitioning with the loop's predictions, wall times and ``groot``
    status."""
    import numpy as np
    import torch

    from repro_torch.api import Session
    from repro_torch.core import gnn
    from repro_torch.core import pipeline as P

    rep: dict = {}
    card_bytes = torch.cuda.get_device_properties(dev).total_memory

    def loop(tag, backend, prep, subgraphs=None):
        """One ``predict_partitioned_loop`` over ``prep`` (or ``subgraphs``)
        with the per-partition probe; returns (predictions, records, wall s)."""
        records: list = []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        pred, wall = drive(tag, lambda: gnn.predict_partitioned_loop(
            model, prep.subgraphs if subgraphs is None else subgraphs, prep.feats,
            prep.num_nodes, backend, device=dev,
            on_partition=partition_probe(records, kernels, base)))
        return pred, records, wall

    def session(tag, sess, prep):
        records: list = []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r, wall = drive(tag, lambda: sess.verify(
            prepared=prep, return_predictions=True,
            on_partition=partition_probe(records, kernels, base)))
        return r, wall, records

    def mismatch(a, b):
        return int((a != b).sum())

    # -- (a) csa-<PART_A_BITS>, multilevel, k=PART_K ---------------------------
    sess = Session(params=params_path, backend="groot", num_partitions=PART_K,
                   streaming=False, device=dev.type)
    prep = sess.prepare(dataset="csa", bits=PART_A_BITS)
    n = prep.num_nodes
    sizes = [(sg.num_nodes, sg.num_edges) for sg in prep.subgraphs]
    full_b, peak_b = prep.memory_bytes()
    a = dict(nodes=n, edges=prep.num_edges, k=prep.num_partitions, timings=prep.timings,
             boundary_edge_frac=prep.boundary_edge_frac, subgraphs=sizes,
             modeled_full_bytes=full_b, modeled_peak_bytes=peak_b)
    big = max(range(len(sizes)), key=lambda i: sizes[i])
    log(f"partitioned (a) csa-{PART_A_BITS} k={a['k']} multilevel hops 1: gen "
        f"{prep.timings['gen']:.1f} s, partition + re-growth {prep.timings['partition']:.1f} s, "
        f"boundary-edge fraction {prep.boundary_edge_frac:.4f}, largest subgraph "
        f"{sizes[big][0]} nodes {sizes[big][1]} edges (of {n} / {prep.num_edges}); "
        f"modeled full {full_b / 1e9:.3f} GB, peak {peak_b / 1e9:.3f} GB")
    r, wall, rec = session("partitioned session.verify groot", sess, prep)
    a["groot"] = dict(status=r.status, accuracy=r.accuracy, wall_s=wall, timings=r.timings,
                      plan_cache=r.plan_cache, routing=r.routing.mode,
                      launches=launches["partitioned session.verify groot"],
                      loop=loop_summary("groot session", rec, prep.subgraphs))
    peak_loop = a["groot"]["loop"]["peak_above_base"]
    preds, walls = {"groot": r.predictions}, {"groot": wall}
    for b in ("groot_fused", "groot_mxu", "ref"):
        preds[b], rec, walls[b] = loop(f"partitioned loop {b}", b, prep)
        a[b] = dict(launches=launches[f"partitioned loop {b}"], wall_s=walls[b],
                    loop=loop_summary(b, rec, prep.subgraphs))
    # each partition alone: the loop's peak may not exceed the largest of these
    alone = []
    for i, sg in enumerate(prep.subgraphs):
        _, rec, _ = loop(f"partitioned alone {i}", "groot", prep, [sg])
        alone.append(rec[0]["peak_above_base"])
    a["alone_peak_above_base"] = alone
    ref_status = P.verify_prepared(prep, preds["ref"]).status
    a["ref_status"] = ref_status
    for b in ("groot", "groot_fused", "groot_mxu"):
        a[b]["pred_mismatch_vs_ref"] = mism = mismatch(preds[b], preds["ref"])
        log(f"partitioned (a) {b}: {mism} of {n} predictions differ from ref's on the same "
            f"subgraphs (limit {MAX_PRED_MISMATCH:g} of nodes); launches "
            f"{json.dumps({k: v for k, v in a[b]['launches'].items() if v})}")
        if mism > MAX_PRED_MISMATCH * n:
            fail(f"partitioned (a) {b}: {mism} predictions differ from ref")
    for b, kn in (("groot", "ld_grouped"), ("groot", "hd_grouped"),
                  ("groot_fused", "fused_ld_grouped"), ("groot_mxu", "ld_grouped_mxu")):
        if a[b]["launches"][kn] <= 0:
            fail(f"partitioned (a) {b}: {kn} never launched on the partitions")
    if r.status != ref_status:
        fail(f"partitioned (a): groot verdict {r.status} != the verdict ref's predictions "
             f"give ({ref_status})")
    if peak_loop > 1.01 * max(alone):
        fail(f"partitioned (a): the loop's peak {peak_loop} B exceeds the largest partition "
             f"alone ({max(alone)} B) by more than 1%")
    log(f"partitioned (a) groot: status {r.status} (ref's partitioned predictions "
        f"{ref_status}); accuracy {r.accuracy:.6f}; measured peak above the loop's base "
        f"{peak_loop / 2**30:.3f} GiB (largest partition alone {max(alone) / 2**30:.3f} "
        f"GiB); plan cache {json.dumps(r.plan_cache)}; wall {wall:.1f} s")
    rep["a"] = a
    # phase 9 streams the same subgraphs and holds its predictions to these
    handoff = {"a": dict(prep=prep, preds=preds, walls=walls, status=r.status)}
    del sess, r
    torch.cuda.empty_cache()

    # -- (b) PART_BATCH x csa-<bits>, bfs stripes, k=PART_BATCH_K --------------
    kw = dict(batch=PART_BATCH, partitioner="bfs", num_partitions=PART_BATCH_K,
              streaming=False, device=dev.type)
    sess = Session(params=params_path, backend="groot", **kw)
    rss_reset = reset_peak_rss()
    prep = sess.prepare(dataset="csa", bits=args.bits)
    n = prep.num_nodes
    full_b, peak_b = prep.memory_bytes()
    sizes = [(sg.num_nodes, sg.num_edges) for sg in prep.subgraphs]
    b_rep = dict(nodes=n, edges=prep.num_edges, k=prep.num_partitions, timings=prep.timings,
                 boundary_edge_frac=prep.boundary_edge_frac, subgraphs=sizes,
                 modeled_full_bytes=full_b, modeled_peak_bytes=peak_b)
    log(f"partitioned (b) {PART_BATCH} x csa-{args.bits}: {n} nodes {prep.num_edges} edges, "
        f"k={b_rep['k']} bfs hops 1: gen {prep.timings['gen']:.1f} s, partition + re-growth "
        f"{prep.timings['partition']:.1f} s, boundary-edge fraction "
        f"{prep.boundary_edge_frac:.4f}, largest subgraph {max(sizes)}; modeled full "
        f"{full_b / 1e9:.2f} GB, peak {peak_b / 1e9:.3f} GB")
    r, wall, rec = session("partitioned (b) session.verify groot", sess, prep)
    loop_g = loop_summary("(b) groot session", rec, prep.subgraphs)
    ref_pred, rec, ref_wall = loop("partitioned (b) loop ref", "ref", prep)
    loop_r = loop_summary("(b) ref", rec, prep.subgraphs)
    big = max(range(len(sizes)), key=lambda i: sizes[i])
    _, rec, _ = loop("partitioned (b) alone", "groot", prep, [prep.subgraphs[big]])
    alone_b = rec[0]["peak_above_base"]
    mism = mismatch(r.predictions, ref_pred)
    tiled = np.tile(full_predictions, PART_BATCH)
    measured = max(loop_g["peak_above_base"], loop_r["peak_above_base"])
    b_rep.update(
        status=r.status, accuracy=r.accuracy, wall_s=wall, timings=r.timings,
        plan_cache=r.plan_cache, pred_mismatch_vs_ref=mism,
        full_diff_share=mismatch(r.predictions, tiled) / n,
        launches=launches["partitioned (b) session.verify groot"], loop_groot=loop_g,
        loop_ref=loop_r, measured_peak_bytes=measured,
        reduction_vs_modeled_full=1 - measured / full_b,
        largest_alone_peak_bytes=alone_b, host_peak_rss_gib=peak_rss_gib(),
        host_peak_rss_scope="phase 8 (b)" if rss_reset else "process")
    log(f"partitioned (b) groot: status {r.status}, accuracy {r.accuracy:.6f} (paper 99.96%), "
        f"{b_rep['full_diff_share']:.3e} of nodes differ from the full-graph predictions "
        f"tiled {PART_BATCH}x; {mism} of {n} differ from ref's on the same subgraphs; "
        f"measured peak {measured / 2**30:.3f} GiB of {card_bytes / 2**30:.1f}, "
        f"{b_rep['reduction_vs_modeled_full']:.2%} under the modeled full {full_b / 1e9:.2f} GB "
        f"(paper: 59.38% against its own measurement; not a claim); per partition "
        f"{statistics.median(loop_g['seconds']):.3f} s median (groot), "
        f"{statistics.median(loop_r['seconds']):.3f} s (ref); inference {r.timings['inference']:.1f} s; "
        f"plan cache {json.dumps(r.plan_cache)}; largest partition alone "
        f"{alone_b / 2**30:.3f} GiB; host peak RSS {b_rep['host_peak_rss_gib']:.1f} GiB "
        f"({b_rep['host_peak_rss_scope']})")
    if r.status != "classified":
        fail(f"partitioned (b): status {r.status}, expected classified (batch {PART_BATCH})")
    if mism > MAX_PRED_MISMATCH * n:
        fail(f"partitioned (b): {mism} predictions differ between groot and ref")
    if measured >= card_bytes:
        fail(f"partitioned (b): measured peak {measured} B is not under the card's {card_bytes}")
    if loop_g["peak_above_base"] > 1.01 * alone_b:
        fail(f"partitioned (b): the groot loop's peak {loop_g['peak_above_base']} B exceeds "
             f"the largest partition alone ({alone_b} B) by more than 1%")
    for kn in ("ld_grouped", "hd_grouped"):
        if b_rep["launches"][kn] <= 0:
            fail(f"partitioned (b): {kn} never launched on the partitions")
    rep["b"] = b_rep
    handoff["b"] = dict(prep=prep, preds={"groot": r.predictions, "ref": ref_pred},
                        walls={"groot": wall, "ref": ref_wall}, status=r.status)
    del sess, r, tiled
    return rep, handoff


def streamed_phase(args, dev, drive, launches: dict, kernels: dict, params_path,
                   parts: dict) -> tuple[dict, dict]:
    """Phase 9: the streamed route (``streaming=True``, the default) on phase
    8's partitionings, (a) csa-<PART_A_BITS> k=PART_K on every kernel backend and
    ``ref``, (b) PART_BATCH x csa-<bits> in PART_BATCH_K stripes on ``groot``
    and ``ref``, then (c) the budget route at csa-<BUDGET_BITS> and (d) the
    packed launches' logits against the loop's at csa-<ONEHOT_BITS>.  ``parts``
    holds phase 8's prepared designs, loop predictions, wall times and
    statuses.  Returns the report and, for phase 10, (c)'s prepared cut, its
    budget and its ``groot`` predictions."""
    import torch

    from repro_torch.api import Session, route_prepared
    from repro_torch.core import gnn
    from repro_torch.core.graph import EdgeGraph
    from repro_torch.exec.packing import pack_partitions
    from repro_torch.exec.plan import plan_from_subgraphs
    from repro_torch.kernels import groot_spmm as gs
    from repro_torch.kernels import ops
    from repro_torch.kernels import plan_cache as pc
    from repro_torch.service.scheduler import BucketRunner

    rep: dict = {}
    expect = {"groot": ("ld_grouped", "hd_grouped"), "groot_fused": ("fused_ld_grouped",),
              "groot_mxu": ("ld_grouped_mxu",), "ref": ()}

    def alone_peaks(sess, prep, backend):
        """Each distinct packed batch (by the structures of its subgraphs)
        run alone through a fresh runner: its device peak above the bytes
        allocated before it; the warm relaunch of the largest profiled."""
        cfg = sess.config
        plan = plan_from_subgraphs(list(prep.subgraphs), prep.num_nodes,
                                   min_nodes=cfg.min_nodes, min_edges=cfg.min_edges)
        group_of = {i: gi for gi, grp in enumerate(gnn.structure_groups(prep.subgraphs))
                    for i in grp}
        seen, peaks, prof = set(), [], None
        for shape, indices in plan.schedule(cfg.stream_capacity):
            sig = (shape, tuple(group_of[i] for i in indices))
            if sig in seen:
                continue
            seen.add(sig)
            runner = BucketRunner(sess.params, backend, device=dev)
            batch = pack_partitions(plan, indices, prep.feats, shape, cfg.stream_capacity,
                                    keyed=runner.structure_keyed)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            runner(batch.arrays, batch.gkeys)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - base)
            if shape == plan.buckets[-1] and prof is None:
                _, prof = device_profile(f"one warm packed {backend} launch {shape}",
                                         lambda: runner(batch.arrays, batch.gkeys))
            runner.release()
            del runner, batch
        return peaks, prof

    def stream(tag, prep, backend, overrides, check_verdict=False):
        """One ``Session.verify(prepared=prep)`` on the streamed route, held
        to phase 8's loop on the same subgraphs."""
        sess = Session(params=params_path, backend=backend, device=dev.type, **overrides)
        n = prep.num_nodes
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        path = f"streamed {tag} {backend}"
        r, wall = drive(path, lambda: sess.verify(prepared=prep, verify=check_verdict,
                                                  return_predictions=True))
        peak = torch.cuda.max_memory_allocated() - base
        left = torch.cuda.memory_allocated() - base
        loop = parts[tag]["preds"][backend]
        mism = int((r.predictions != loop).sum())
        peaks, prof = alone_peaks(sess, prep, backend)
        st = r.exec_stats
        used = {k: v for k, v in launches[path].items() if v}
        out = dict(mode=r.routing.mode, k=r.routing.k, buckets=r.routing.buckets,
                   status=r.status, accuracy=r.accuracy, wall_s=wall,
                   loop_wall_s=parts[tag]["walls"][backend], timings=r.timings,
                   plan_cache=r.plan_cache, exec_stats=st, launches=used,
                   measured_peak_bytes=peak, left_bytes=left, alone_peak_bytes=peaks,
                   pred_mismatch_vs_loop=mism, warm_launch_profile=prof)
        card_ms = None if prof is None else prof["device_ms"]
        out["card_busy_share_estimate"] = (None if card_ms is None else
                                           st["batches"] * card_ms / 1e3 / st["wall_s"])
        log(f"streamed {tag} {backend}: mode {r.routing.mode} k={r.routing.k} buckets "
            f"{list(r.routing.buckets)} batches {st['batches']} (capacity "
            f"{sess.config.stream_capacity}, prefetch {sess.config.stream_prefetch}); "
            f"status {r.status} accuracy {r.accuracy:.6f}; {mism} of {n} predictions "
            f"differ from phase 8's loop (limit {MAX_PRED_MISMATCH:g} of nodes); wall "
            f"{wall:.2f} s (phase 8 {parts[tag]['walls'][backend]:.2f} s), inference "
            f"{r.timings['inference']:.2f} s")
        log(f"  stats: launches {st['launches']} compiles {st['compiles']} pack "
            f"{st['pack_s']:.3f} s device {st['device_s']:.3f} s wall {st['wall_s']:.3f} s "
            f"overlap {max(0.0, st['pack_s'] + st['device_s'] - st['wall_s']):.3f} s "
            f"bytes_h2d {st['bytes_h2d']} max_queue_depth {st['max_queue_depth']} "
            f"capacity_halvings {st['capacity_halvings']}; modeled peak "
            f"{st['modeled_peak_bytes'] / 1e9:.3f} GB, actual (the model on the launched "
            f"shapes) {st['actual_peak_bytes'] / 1e9:.3f} GB; plan cache "
            f"{json.dumps(r.plan_cache)}; launches {json.dumps(used)}")
        log(f"  device peak {peak / 2**30:.3f} GiB, largest packed launch alone "
            f"{max(peaks) / 2**30:.3f} GiB (distinct batches {len(peaks)}); left after the "
            f"run {left} B; card busy share (launches x one warm launch's card time / "
            f"wall) {out['card_busy_share_estimate']}")
        if mism > MAX_PRED_MISMATCH * n:
            fail(f"{path}: {mism} predictions differ from phase 8's loop")
        if st["capacity_halvings"]:
            fail(f"{path}: {st['capacity_halvings']} capacity halvings")
        if left > 0:
            fail(f"{path}: {left} B left allocated after the run")
        if peak > 1.01 * max(peaks):
            fail(f"{path}: device peak {peak} B over the largest packed launch alone "
                 f"({max(peaks)} B) by more than 1%")
        if r.routing.mode != "streamed":
            fail(f"{path}: routed to mode {r.routing.mode}")
        for kn in expect[backend]:
            if not used.get(kn):
                fail(f"{path}: {kn} never launched on the packed batches")
        if backend == "ref" and used:
            fail(f"{path}: the ref backend launched kernels: {used}")
        if check_verdict and r.status != parts[tag]["status"]:
            fail(f"{path}: verdict {r.status} != phase 8's {parts[tag]['status']}")
        return out

    # -- (a) csa-<PART_A_BITS>, k=PART_K multilevel, every backend -------------
    prep = parts["a"]["prep"]
    rep["a"] = {b: stream("a", prep, b, dict(num_partitions=PART_K),
                          check_verdict=b == "groot")
                for b in ("groot", "groot_fused", "groot_mxu", "ref")}
    del prep
    torch.cuda.empty_cache()

    # -- (b) PART_BATCH x csa-<bits>, PART_BATCH_K bfs stripes -----------------
    prep = parts["b"]["prep"]
    kw = dict(batch=PART_BATCH, partitioner="bfs", num_partitions=PART_BATCH_K)
    rep["b"] = {b: stream("b", prep, b, kw) for b in ("groot", "ref")}
    # K2 on the packed batch's dummy rows: each slot parks its padding edges as
    # self-loops on its last row, thousands of 512-slot chunks a row
    cfg = Session(device=dev.type, **kw).config
    plan = plan_from_subgraphs(list(prep.subgraphs), prep.num_nodes)
    shape, indices = plan.schedule(cfg.stream_capacity)[-1]
    batch = pack_partitions(plan, indices, prep.feats, shape, cfg.stream_capacity, keyed=True)
    arr, n = batch.arrays, batch.arrays["num_nodes"]
    fp = pc.cached_forward_plan(arr["edge_src"], arr["edge_dst"], n, gkeys=batch.gkeys)
    tensors = [torch.from_numpy(arr[k]).to(dev) for k in
               ("edge_src", "edge_dst", "edge_inv", "edge_slot")]
    wg_in, wg_out = gnn.grouped_edge_weights(tensors[0].long(), tensors[1].long(),
                                             tensors[2], tensors[3], n)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x_p = gs.pad_features(torch.randn((n, 32), generator=gen, device=dev))
    k2 = {}
    for direction, plan_d, wg in (("fanin", fp.in_plan, wg_in), ("fanout", fp.out_plan, wg_out)):
        staged = gs.stage_group_weights(plan_d, wg)
        dp = plan_d.on(dev)
        counts = plan_d.hd.row_chunks()[:, 1]
        n_hd = plan_d.hd.rows.shape[0]

        def run():
            return gs.hd_grouped_apply(x_p, dp.hd_cols, staged.hd, dp.hd_meta,
                                       dp.hd_row_chunks, plan_d.e_t)

        def plain():
            return gs.hd_grouped_plain(x_p, dp.hd_cols, staged.hd, dp.hd_meta, n_hd, plan_d.e_t)

        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        del got, want
        kernels["hd_grouped"]["max_abs_err"] = max(kernels["hd_grouped"]["max_abs_err"], err)
        ms, plain_ms = cuda_ms(run, args.reps), cuda_ms(plain, 2)
        k2[direction] = dict(hd_rows=n_hd, chunks=int(counts.sum()),
                             max_chunks_a_row=int(counts.max()), groups=staged.hd.shape[1],
                             max_abs_err=err, ms=ms, plain_ms=plain_ms)
        log(f"K2 {direction} on packed batch {indices} ({shape}): {n_hd} HD rows, "
            f"{int(counts.sum())} chunks, up to {int(counts.max())} a row; max_abs_err "
            f"{err:.3e} (tol {TOL * scale:.3e}); kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if err > TOL * scale:
            fail(f"K2 {direction} at the packed dummy rows: max abs error {err:.3e}")
        del staged
    rep["b"]["k2_dummy_rows"] = k2
    # the runner copies a packed batch from pageable host memory; the same
    # arrays from pinned buffers, and what pinning them costs on the host
    host = [torch.from_numpy(arr[k]) for k in ("x", "edge_src", "edge_dst", "edge_inv",
                                               "edge_slot")]
    h2d: dict = {"bytes": batch.nbytes}
    for label in ("pageable", "pinned", "pageable again"):
        src = host
        if label == "pinned":
            t0 = time.perf_counter()
            src = [t.pin_memory() for t in host]
            h2d["pin_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = [t.to(dev, non_blocking=label == "pinned") for t in src]
        torch.cuda.synchronize()
        h2d[label] = time.perf_counter() - t0
        del on_card, src
    rep["b"]["h2d"] = h2d
    log(f"H2D of one packed batch ({batch.nbytes} B): pageable {h2d['pageable']:.4f} s, "
        f"again {h2d['pageable again']:.4f} s; pinned {h2d['pinned']:.4f} s after "
        f"{h2d['pin_s']:.4f} s of pinning on the host")
    fp.in_plan.release()
    fp.out_plan.release()
    del prep, batch, arr, fp, tensors, wg_in, wg_out, x_p
    torch.cuda.empty_cache()

    # -- (c) the budget route at csa-<BUDGET_BITS> ------------------------------
    full = Session(device=dev.type).explain(dataset="csa", bits=BUDGET_BITS)
    budget = full.modeled_full_bytes // 2
    sess = Session(params=params_path, backend="groot", memory_budget_bytes=budget,
                   device=dev.type)
    t0 = time.perf_counter()
    prep = sess.prepare(dataset="csa", bits=BUDGET_BITS)
    t_prep = time.perf_counter() - t0
    decision = route_prepared(prep, sess.config, dev)
    r, wall = drive("streamed (c) budget groot", lambda: sess.verify(
        prepared=prep, return_predictions=True))
    loop = gnn.predict_partitioned_loop(sess.params, prep.subgraphs, prep.feats,
                                        prep.num_nodes, "groot", device=dev)
    mism = int((r.predictions != loop).sum())
    st = r.exec_stats
    rep["c"] = dict(bits=BUDGET_BITS, budget_bytes=budget, mode=decision.mode, k=decision.k,
                    buckets=decision.buckets, modeled_peak_bytes=decision.modeled_peak_bytes,
                    reason=decision.reason, status=r.status, accuracy=r.accuracy,
                    prepare_s=t_prep, wall_s=wall, exec_stats=st,
                    launches={k: v for k, v in launches["streamed (c) budget groot"].items()
                              if v},
                    pred_mismatch_vs_loop=mism)
    log(f"streamed (c) csa-{BUDGET_BITS} budget {budget} B (half the full graph's modeled "
        f"{full.modeled_full_bytes} B): explain() mode {decision.mode} k={decision.k} buckets "
        f"{list(decision.buckets)} modeled packed peak {decision.modeled_peak_bytes} B; "
        f"verdict {r.status} accuracy {r.accuracy:.6f} (full graph: see phase 6 at "
        f"csa-{args.bits}); {mism} predictions differ from the loop on the same cut; prepare "
        f"{t_prep:.1f} s, verify {wall:.1f} s; launches {st['launches']} capacity_halvings "
        f"{st['capacity_halvings']}")
    if decision.mode != "streamed" or r.routing != decision:
        fail(f"streamed (c): explain() gives {decision.mode}, verify took {r.routing.mode}")
    if st["peak_packed_memory_bytes"] > budget or st["capacity_halvings"]:
        fail(f"streamed (c): packed peak {st['peak_packed_memory_bytes']} B over the "
             f"{budget} B budget, or {st['capacity_halvings']} capacity halvings")
    if mism > MAX_PRED_MISMATCH * prep.num_nodes:
        fail(f"streamed (c): {mism} predictions differ from the loop")

    # -- (d) logits of packed launches against the loop's, csa-<ONEHOT_BITS> ----
    # on the card another row count may pick another GEMM, so the two routes'
    # logits agree to LOGIT_TOL rather than bit for bit
    small = Session(device=dev.type, num_partitions=PART_K).prepare(dataset="csa",
                                                                     bits=ONEHOT_BITS)
    model = gnn.params_from_numpy(gnn.load_params(params_path), device=dev)
    plan = plan_from_subgraphs(list(small.subgraphs), small.num_nodes)

    def logits(g, x, backend):
        agg = None if backend == "ref" else ops.make_agg_pair(
            g.edge_src, g.edge_dst, g.num_nodes, backend, device=dev, cache=False)
        out = gnn.forward(model, torch.as_tensor(x).to(dev), *gnn.graph_tensors(g, dev),
                          num_nodes=g.num_nodes, agg=agg)
        if agg is not None:
            ops.release_device(agg)
        return out

    gaps = {}
    for backend in ("groot", "groot_fused", "groot_mxu", "ref"):
        gap = scale = 0.0
        for shape, indices in plan.schedule(2):
            arr = pack_partitions(plan, indices, small.feats, shape, 2).arrays
            packed = logits(EdgeGraph(arr["num_nodes"], arr["edge_src"], arr["edge_dst"],
                                      arr["edge_inv"], arr["edge_slot"]), arr["x"], backend)
            for k, i in enumerate(indices):
                sg = small.subgraphs[i]
                alone = logits(sg.to_edge_graph(), small.feats[sg.global_ids], backend)
                rows = packed[k * shape.n_pad:k * shape.n_pad + sg.num_core]
                gap = max(gap, (rows - alone[:sg.num_core]).abs().max().item())
                scale = max(scale, alone.abs().max().item())
        gaps[backend] = gap
        if gap > LOGIT_TOL * max(1.0, scale):
            fail(f"streamed (d) {backend}: packed logits differ from the loop's by {gap:.3e}")
    rep["d"] = dict(bits=ONEHOT_BITS, max_logit_gap_vs_loop=gaps)
    log(f"streamed (d) csa-{ONEHOT_BITS} k={PART_K}: largest |packed logit - loop logit| on "
        f"core rows {json.dumps(gaps)} (limit {LOGIT_TOL:g} x max(1, |logit|))")
    return rep, dict(prep=prep, budget=budget, groot=r.predictions)

def cli_phase(args, dev, drive, launches: dict, full_prep, full_groot, budget_cut) -> dict:
    """Phase 10: the command-line verify path.  (a) ``Session.train`` on the
    card (the reference's ``train_model`` settings), its first
    TRAIN_CHECK_STEPS losses against the CPU's from the same init, and the
    card-trained params' csa-<bits> verdict (``full_prep``, phase 6's design)
    against phase 6's (``full_groot``); (b) streamed verifies of phase 9
    (c)'s budget cut of csa-<BUDGET_BITS> (``budget_cut``: the prepared
    design, the budget and phase 9's ``groot`` predictions) killed at their
    second packed launch with a journal under ``chiprun_out/`` and resumed
    by a fresh session, bit-equal to the uninterrupted run; (c) the AIGER
    round trip of that design; (d) ``python -m repro_torch.cli verify`` and
    ``explain`` (two processes at once) on csa-<CLI_BITS> written as a file,
    then the same file verified twice in this process (the second from the
    result cache, no launch)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import faults
    from repro_torch.api import Session
    from repro_torch.core import aig as A
    from repro_torch.core import gnn
    from repro_torch.core.features import groot_features
    from repro_torch.io import aiger

    rep: dict = {}
    t_phase = time.perf_counter()

    # -- (a) train on the card --------------------------------------------------
    sess = Session(device=dev.type, backend="groot")
    hist, wall = drive("cli (a) session.train", lambda: sess.train(
        "csa", 8, epochs=TRAIN_EPOCHS, seed=0))
    if any(launches["cli (a) session.train"].values()):
        fail(f"training launched kernels: {launches['cli (a) session.train']}")
    design8 = A.make_design("csa", 8)
    feats8, labels8 = groot_features(design8), design8.label.astype(np.int32)
    init = gnn.init_params(gnn.GNNConfig(), 0)
    losses = {}
    for where in ("cpu", dev):
        batch = gnn.make_batch(design8, feats8, labels8, device=where)
        _, steps = gnn.train(init.to(where), batch, epochs=TRAIN_CHECK_STEPS, log_every=1)
        losses[str(where)] = np.array([loss for _, loss in steps])
    gap = float(np.max(np.abs(losses[str(dev)] - losses["cpu"]) / np.abs(losses["cpu"])))
    r, verify_wall = drive("cli (a) session.verify trained groot", lambda: Session(
        params=sess.params, backend="groot", device=dev.type).verify(prepared=full_prep))
    rep["a"] = dict(epochs=TRAIN_EPOCHS, train_s=wall, s_per_epoch=wall / TRAIN_EPOCHS,
                    history=hist, first_losses_card=losses[str(dev)].tolist(),
                    first_losses_cpu=losses["cpu"].tolist(), max_rel_loss_gap=gap,
                    status=r.status, accuracy=r.accuracy, shipped_status=full_groot.status,
                    shipped_accuracy=full_groot.accuracy, verify_wall_s=verify_wall,
                    timings=r.timings,
                    launches={k: v for k, v in launches["cli (a) session.verify trained groot"]
                              .items() if v})
    log(f"cli (a) Session.train csa-8 {TRAIN_EPOCHS} epochs on the card: {wall:.2f} s "
        f"({wall / TRAIN_EPOCHS * 1e3:.2f} ms an epoch), loss {hist[0][1]:.4g} -> "
        f"{hist[-1][1]:.4g}; first {TRAIN_CHECK_STEPS} losses within {gap:.2e} relative of "
        f"the CPU's from the same init (limit {TRAIN_LOSS_RTOL:g})")
    log(f"cli (a) card-trained params at csa-{args.bits} on groot: status {r.status} accuracy "
        f"{r.accuracy:.6f} (phase 6, shipped params: {full_groot.status} "
        f"{full_groot.accuracy:.6f}); verify wall {verify_wall:.1f} s (the prepared design "
        f"skips gen) inference {r.timings['inference']:.3f} s verify {r.timings['verify']:.1f} s")
    if gap > TRAIN_LOSS_RTOL:
        fail(f"cli (a): the card's first losses differ from the CPU's by {gap:.2e} relative")
    if r.status != full_groot.status:
        fail(f"cli (a): card-trained verdict {r.status} != phase 6's {full_groot.status}")
    if not rep["a"]["launches"].get("ld_grouped") or not rep["a"]["launches"].get("hd_grouped"):
        fail(f"cli (a): groot verify launched {rep['a']['launches']}")
    del r

    # -- (b) journal: kill at the second packed launch, resume -----------------
    prep = budget_cut["prep"]
    design = prep.design
    jroot = ROOT / "chiprun_out" / "journal"
    shutil.rmtree(jroot, ignore_errors=True)
    t0 = time.perf_counter()
    key = aiger.structural_hash(design)
    hash_s = time.perf_counter() - t0
    kw = dict(memory_budget_bytes=budget_cut["budget"], device=dev.type)
    expect = {"groot": "ld_grouped", "groot_fused": "fused_ld_grouped",
              "groot_mxu": "ld_grouped_mxu"}
    total = prep.num_partitions
    rep["b"] = dict(bits=BUDGET_BITS, nodes=design.num_nodes, k=total, hash_s=hash_s)
    for backend, kname in expect.items():
        whole, whole_wall = drive(f"cli (b) uninterrupted {backend}", lambda: Session(
            params=PARAMS_PATH, backend=backend, **kw).verify(
                prepared=prep, verify=False, return_predictions=True))
        killed = Session(params=PARAMS_PATH, backend=backend, checkpoint_dir=str(jroot), **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()

        def kill():
            with faults.injected("exec.launch:nth=2,kind=fatal"):
                try:
                    killed.verify(prepared=prep, verify=False)
                except faults.FatalFault:
                    return True
            return False

        raised, kill_wall = drive(f"cli (b) killed {backend}", kill)
        torch.cuda.synchronize()
        left_killed = torch.cuda.memory_allocated() - base
        committed = len(list((jroot / key).glob("part_*.npz")))
        resumed = Session(params=PARAMS_PATH, backend=backend, checkpoint_dir=str(jroot), **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        r, wall = drive(f"cli (b) resumed {backend}", lambda: resumed.verify(
            prepared=prep, verify=False, return_predictions=True))
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated() - base
        mism = int((r.predictions != whole.predictions).sum())
        if backend == "groot":
            mism += int((r.predictions != budget_cut["groot"]).sum())
        st = r.exec_stats
        used = {k: v for k, v in launches[f"cli (b) resumed {backend}"].items() if v}
        journal_left = (jroot / key).exists()
        rep["b"][backend] = dict(
            raised=raised, killed_wall_s=kill_wall, committed=committed, total=total,
            resumed_partitions=st["resumed_partitions"], partitions=st["partitions"],
            launches=st["launches"], uninterrupted_launches=whole.exec_stats["launches"],
            kernel_launches=used, wall_s=wall, inference_s=r.timings["inference"],
            uninterrupted_wall_s=whole_wall, pred_mismatch=mism, left_bytes=left,
            left_bytes_killed=left_killed, journal_left=journal_left)
        log(f"cli (b) csa-{BUDGET_BITS} k={total} {backend}: killed at launch 2 after "
            f"{committed} of {total} partitions committed ({kill_wall:.2f} s); resumed "
            f"{st['resumed_partitions']}, ran {st['partitions']} in {st['launches']} launches "
            f"of {whole.exec_stats['launches']}, wall {wall:.2f} s (uninterrupted "
            f"{whole_wall:.2f} s); {mism} predictions differ from the uninterrupted run's"
            f"{' and phase 9 (c)' if backend == 'groot' else ''}; bytes left {left_killed} / "
            f"{left}; journal left {journal_left}; launches {json.dumps(used)}")
        if not raised or not 0 < committed < total:
            fail(f"cli (b) {backend}: the killed run raised {raised}, committed {committed} "
                 f"of {total}")
        if st["resumed_partitions"] != committed or st["partitions"] != total - committed:
            fail(f"cli (b) {backend}: resumed {st['resumed_partitions']} and ran "
                 f"{st['partitions']}, expected {committed} and {total - committed}")
        if mism or journal_left or left > 0 or left_killed > 0:
            fail(f"cli (b) {backend}: {mism} predictions differ, journal left {journal_left}, "
                 f"bytes left {left_killed} / {left}")
        if not used.get(kname):
            fail(f"cli (b) {backend}: {kname} never launched on the resumed run")
        del whole, killed, resumed, r
    shutil.rmtree(jroot, ignore_errors=True)   # empty: each run removed its journal
    log(f"cli (b) structural hash of csa-{BUDGET_BITS} ({design.num_nodes} nodes): "
        f"{hash_s:.3f} s")

    # -- (c) AIGER round trip of that design -------------------------------------
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        path = tmp / f"csa{BUDGET_BITS}.aig"
        t0 = time.perf_counter()
        aiger.dump(design, path)
        dump_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = aiger.load(path)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back_key = aiger.structural_hash(back)
        rehash_s = time.perf_counter() - t0
        same = {f: bool(np.array_equal(getattr(back, f), getattr(design, f)))
                for f in ("kind", "fanin0", "fanin1", "label", "pos")}
        rep["c"] = dict(bits=BUDGET_BITS, bytes=path.stat().st_size, dump_s=dump_s,
                        load_s=load_s, structural_hash_s=rehash_s, equal=same,
                        hash_equal=back_key == key)
        log(f"cli (c) AIGER round trip csa-{BUDGET_BITS}: {rep['c']['bytes']} B, dump "
            f"{dump_s:.3f} s, load {load_s:.3f} s, structural_hash {rehash_s:.3f} s; arrays "
            f"equal {json.dumps(same)}, hashes equal {back_key == key}")
        if not all(same.values()) or back_key != key:
            fail(f"cli (c): round trip arrays {same}, hashes equal {back_key == key}")
        del back

        # -- (d) the CLI on that file, then the result cache in-process ---------
        budget_mb = budget_cut["budget"] / 1e6
        common = ["--backend", "groot", "--budget-mb", repr(budget_mb)]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        ck = ROOT / "chiprun_out" / "cli_journal"
        # both processes at once: explain is host work only, and each pays
        # its own interpreter start and imports
        t0 = time.perf_counter()
        procs = {what: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.cli", what, str(path), *common, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
            for what, extra in (("verify", ("--checkpoint-dir", str(ck), "--explain")),
                                ("explain", ()))}
        outs = {}
        for what, proc in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for other in procs.values():
                    other.kill()
                    other.communicate()
                fail(f"cli (d): {what} ran past {CLI_TIMEOUT_S} s")
            outs[what] = subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr)
        both_s = time.perf_counter() - t0
        v, e = outs["verify"], outs["explain"]
        for what, out in (("verify", v), ("explain", e)):
            log(f"cli (d) `python -m repro_torch.cli {what}` exit {out.returncode}:")
            for line in out.stdout.splitlines():
                log(f"  | {line}")
            if out.returncode:
                log(out.stderr[-4000:])
                fail(f"cli (d): {what} exited {out.returncode}")
        lines = v.stdout.splitlines()
        row = next((ln.split() for ln in lines if ln.split()[:1] == [design.name]), [])
        at = next(i for i, ln in enumerate(lines) if ln.startswith("  routing: "))
        routed = [lines[at][len("  routing: "):]] + lines[at + 1:at + 3]
        e_lines = e.stdout.splitlines()
        explained = [e_lines[0][len(f"{path}: "):]] + e_lines[1:3]
        rep["d"] = dict(bits=BUDGET_BITS, budget_mb=budget_mb, verify_and_explain_s=both_s,
                        row=row, routing=routed, explain=explained,
                        journal_left=ck.exists() and any(ck.iterdir()))
        log(f"cli (d) csa-{BUDGET_BITS} under {budget_mb:.3f} MB: verify and explain in "
            f"{both_s:.1f} s (two fresh processes at once); row {row}; the routing lines equal: "
            f"{routed == explained}; journal left {rep['d']['journal_left']}")
        if row[1:2] != ["streamed"] or routed != explained or rep["d"]["journal_left"]:
            fail(f"cli (d): row {row}, routing {routed} vs explain {explained}, journal left "
                 f"{rep['d']['journal_left']}")
        shutil.rmtree(ck, ignore_errors=True)
        inproc = Session(params=sess.params, backend="groot", device=dev.type,
                         memory_budget_bytes=budget_cut["budget"])
        first, first_wall = drive("cli (d) session.verify file", lambda: inproc.verify(path))
        hit, hit_wall = drive("cli (d) session.verify file again", lambda: inproc.verify(path))
        used = {k: v for k, v in launches["cli (d) session.verify file again"].items() if v}
        rep["d"].update(first_status=first.status, first_mode=first.routing.mode,
                        first_wall_s=first_wall, cached=hit.cached, cached_wall_s=hit_wall,
                        cached_total_s=hit.timings["total"], cached_launches=used,
                        first_launches={k: v for k, v in
                                        launches["cli (d) session.verify file"].items() if v})
        log(f"cli (d) in-process Session.verify(file): {first.routing.mode} {first.status} "
            f"accuracy {first.accuracy:.6f} in {first_wall:.2f} s; again: cached={hit.cached} "
            f"in {hit_wall * 1e3:.2f} ms (of it the structural hash of the parsed file), "
            f"launches {json.dumps(used)}")
        if not hit.cached or used or hit.status != first.status:
            fail(f"cli (d): the repeat verify cached={hit.cached}, launches {used}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rep["phase_s"] = time.perf_counter() - t_phase
    log(f"cli phase: {rep['phase_s']:.1f} s")
    return rep


def service_phase(args, dev, drive, launches: dict) -> dict:
    """Phase 11: the batched service route (``Session.submit``/``result``)
    on the card; see the module docstring.  Fails unless every ticket that
    should succeed matches a sync ``Session.verify`` of the same design and
    config, and the engine leaves no thread and no byte behind."""
    import threading

    import torch

    from repro_torch import faults
    from repro_torch.api import Session, SessionConfig
    from repro_torch.core import aig as A
    from repro_torch.core import gnn
    from repro_torch.exec.plan import choose_k_for_caps
    from repro_torch.io import aiger
    from repro_torch.kernels import ops
    from repro_torch.service import AdmissionError

    rep: dict = {}
    t_phase = time.perf_counter()
    params = gnn.load_params(PARAMS_PATH)
    designs = {b: A.make_design("csa", b) for b in
               sorted(set(SERVICE_BITS) | {SERVICE_RETRY_BITS, SERVICE_STREAM_BITS})}

    def bucket(bits):
        g = designs[bits].to_edge_graph()
        return ops.padded_shape(g.num_nodes, g.num_edges, min_nodes=64, min_edges=128)

    def engine_threads():
        return [t.name for t in threading.enumerate()
                if t.is_alive() and t.name.startswith(("svc-", "exec-prefetch"))]

    class Gate:
        """Holds the device worker inside its first pack until released, so
        the submissions below queue behind it deterministically."""

        def __init__(self, inner):
            self.inner, self.open, self.entered = inner, threading.Event(), threading.Event()

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def __call__(self, batch, gkeys=None):
            self.entered.set()
            if not self.open.wait(timeout=SERVICE_TIMEOUT_S):
                fail("service: the gate was never opened")
            return self.inner(batch, gkeys)

    def capture(svc):
        """The predictions each ticket's finalize receives (on the host)."""
        preds, inner = {}, svc._finalize

        def finalize(req, key, prep, pred, timings):
            preds[req.req_id] = pred.copy()
            return inner(req, key, prep, pred, timings)

        svc._finalize = finalize
        return preds

    def sync_check(tag, backend, tickets, results, preds, cfg_of):
        """Each successful ticket against a sync verify of its design."""
        out = {}
        for name, (t, bits) in tickets.items():
            r = results[name]
            kw = cfg_of(bits)
            want = Session(params, SessionConfig(backend=backend, **kw)).verify(
                designs[bits], return_predictions=True, use_cache=False)
            # a coalesced follower carries its leader's outcome: no run of its own
            mism = (int((preds[t][: want.num_nodes] != want.predictions).sum())
                    if t in preds else 0)
            out[name] = dict(status=r.status, sync_status=want.status, mismatch=mism,
                             nodes=want.num_nodes, accuracy=r.accuracy, cached=r.cached,
                             sync_route=want.routing.mode)
            log(f"service {tag} {name}: {r.status} (sync {want.status}, {want.routing.mode}), "
                f"{mism} of {want.num_nodes} predictions differ")
            if r.status != want.status or mism > MAX_PRED_MISMATCH * want.num_nodes:
                fail(f"service {tag} {name}: status {r.status} vs sync {want.status}, "
                     f"{mism} predictions differ")
        return out

    # -- (a) groot: the concurrent mix ------------------------------------------
    shapes = tuple(sorted({bucket(b) for b in SERVICE_BITS + (SERVICE_RETRY_BITS,)}))
    lo, mid, hi = SERVICE_BITS
    poison = A.make_design("csa", lo)
    poison.name = "poison"
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    cfg = SessionConfig(backend="groot", warmup=True, warmup_shapes=shapes,
                        max_inflight_per_tenant=4, max_bucket_nodes=SERVICE_MAX_BUCKET_NODES,
                        fault_plan=(f"service.device:match=poison,every=1,kind=fatal;"
                                    f"service.device:match=csa:{SERVICE_RETRY_BITS},nth=1,"
                                    f"kind=transient"))
    sess = Session(params, cfg)
    (_, warm_wall) = drive("service (a) warm groot", lambda: sess.warm())
    svc = sess._service_engine()
    rep["warm"] = dict(wall_s=warm_wall, shapes=list(shapes),
                       warm_compiles=svc.stats()["warm_compiles"])
    preds = capture(svc)
    gate = Gate(svc.scheduler.runner)
    svc.scheduler.runner = gate
    tickets: dict = {}
    # finished from their leader's execution (mid_aig hashes to the
    # structure of the mid design, dup2 is generated as dup1 is)
    FOLLOWERS = ("mid_aig", "mid_dup2")

    def submit_all():
        tickets["small"] = (sess.submit(designs[lo], tenant="a"), lo)
        if not gate.entered.wait(timeout=SERVICE_TIMEOUT_S):
            fail("service: the first pack never reached the device")
        tickets["mid"] = (sess.submit(designs[mid], tenant="a"), mid)
        tickets["large"] = (sess.submit(designs[hi], tenant="a"), hi)
        tickets["mid_aig"] = (sess.submit(aiger.dumps(designs[mid]), tenant="a"), mid)
        try:
            sess.submit(designs[lo], tenant="a", seed=5)
            fail("service: a fifth ticket of tenant a was admitted past the cap of 4")
        except AdmissionError as e:
            rep["admission_error"] = str(e)
        tickets["mid_dup1"] = (sess.submit(dataset="csa", bits=mid, tenant="b"), mid)
        tickets["mid_dup2"] = (sess.submit(dataset="csa", bits=mid, tenant="b"), mid)
        extra = dict(
            garbage=sess.submit(b"not an aiger header\nc\ngroot-name garbage_rev\n"),
            deadline=sess.submit(designs[lo], seed=7, deadline_s=1e-3),
            # seed 1: its own cache key, not a follower of the small ticket
            poison=sess.submit(aiger.dumps(poison), seed=1))
        tickets["small_mate"] = (sess.submit(dataset="csa", bits=lo, seed=2), lo)
        tickets["streamed"] = (sess.submit(designs[SERVICE_STREAM_BITS]),
                                      SERVICE_STREAM_BITS)
        tickets["retried"] = (
            sess.submit(dataset="csa", bits=SERVICE_RETRY_BITS), SERVICE_RETRY_BITS)
        tickets["express"] = (sess.submit(dataset="csa", bits=mid, seed=3, priority=0), mid)
        # open the gate once every request but the coalesced followers is
        # prepared (or already failed), so the pool sees them all at once
        waiting = [t for n, (t, _) in tickets.items() if n not in FOLLOWERS] + list(
            extra.values())
        deadline = time.perf_counter() + SERVICE_TIMEOUT_S
        while time.perf_counter() < deadline and not all(
                svc._requests[t].event.is_set() or svc._requests[t].coalesced
                or any(m == "prepared" for m, _ in svc._requests[t].marks)
                for t in waiting if t != tickets["small"][0]):
            time.sleep(0.01)
        gate.open.set()
        results = {name: sess.result(t, timeout=SERVICE_TIMEOUT_S)
                   for name, (t, _) in tickets.items()}
        others = {name: sess.result(t, timeout=SERVICE_TIMEOUT_S) for name, t in extra.items()}
        return results, others, extra

    t0 = time.perf_counter()
    ((results, others, extra), prof), wall = drive(
        "service (a) mix groot", lambda: device_profile("service (a) mix groot", submit_all))
    rep["mix_wall_s"] = wall
    n_tickets = len(results) + len(others)
    rep["tickets_per_s"] = n_tickets / wall
    rep["profile"] = dict(wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                          idle_share=1 - prof["device_ms"] / prof["wall_ms"])
    log(f"service (a): {n_tickets} tickets in {wall:.2f} s ({rep['tickets_per_s']:.2f} "
        f"tickets/s, profiler on), card idle share {rep['profile']['idle_share']:.3f}")
    st = sess.stats()["service"]
    log(f"service (a) stats: {json.dumps(st, default=str)}")
    rep["stats"] = json.loads(json.dumps(st, default=str))
    for name in FOLLOWERS:
        if not results[name].cached:
            fail(f"service: {name} was not coalesced (cached=False)")
    if others["garbage"].status != "error" or others["garbage"].name != "garbage_rev":
        fail(f"service: garbage AIGER gave {others['garbage'].status} named "
             f"{others['garbage'].name!r}")
    if not (others["deadline"].error or "").startswith("DeadlineExceeded"):
        fail(f"service: the 1 ms ticket gave {others['deadline'].error!r}")
    if others["poison"].status != "error" or "FatalFault" not in (others["poison"].error or ""):
        fail(f"service: the poisoned ticket gave {others['poison'].status}")
    failed = [n for n, r in results.items() if r.status == "error"]
    if failed:
        fail(f"service: tickets {failed} failed: {[results[n].error for n in failed]}")
    counters = st["obs"]["counters"]
    for key, least in (("service.bisections", 1), ("service.retries", 1),
                       ("service.coalesced", 1), ("service.rejected", 1),
                       ("service.deadline_exceeded", 1)):
        if counters.get(key, 0) < least:
            fail(f"service: {key} = {counters.get(key, 0)}, expected >= {least}")
    if st["streamed_items"] < 1:
        fail(f"service: csa-{SERVICE_STREAM_BITS} did not stream")
    order = [ids for _, ids, _ in svc.scheduler.pack_log]
    express = tickets["express"][0]
    lead128 = tickets["mid"][0]
    pos = {t: i for i, ids in enumerate(order) for t in ids}
    if pos.get(express, 1 << 30) > pos.get(lead128, -1):
        fail(f"service: the priority-0 ticket did not overtake (pack order {order})")
    flights = {f.req_id: f for f in sess.flights()}
    rep["flights"] = {}
    for name, (t, _) in list(tickets.items()) + [(n, (t, 0)) for n, t in extra.items()]:
        f = flights[t]
        rep["flights"][name] = dict(status=f.status, stages=f.stages, bucket=f.bucket,
                                    streamed=f.streamed, cached=f.cached,
                                    coalesced=f.coalesced, retries=f.retries)
        log(f"service flight {name}: {f.status} stages "
            f"{json.dumps({k: round(v, 4) for k, v in f.stages.items()})} bucket {f.bucket} "
            f"streamed {f.streamed} cached {f.cached} retries {f.retries}")
    used = {k: v for k, v in launches["service (a) mix groot"].items() if v}
    log(f"service (a) launches: {json.dumps(used)}")
    rep["launches"] = used
    for kn in ("ld_grouped", "hd_grouped"):
        if not used.get(kn):
            fail(f"service (a): {kn} did not launch on the groot service path")
    sess.close()
    faults.uninstall()
    del svc, gate
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base_bytes
    alive = engine_threads()
    log(f"service (a) after close: threads alive {alive}, bytes above the level before the "
        f"session {left} (the session's params included)")
    rep["after_close"] = dict(threads=alive, bytes_left=left)
    if alive:
        fail(f"service: threads alive after close: {alive}")
    del sess
    import gc

    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base_bytes
    rep["after_close"]["bytes_left_without_session"] = left
    # (negative where the process-wide plan cache evicted older entries)
    if left > 0:
        fail(f"service: {left} bytes left on the card after close")

    # each successful ticket against a sync verify of its design and config
    g512 = designs[SERVICE_STREAM_BITS].to_edge_graph()
    k = choose_k_for_caps(g512.num_nodes, g512.num_edges, SERVICE_MAX_BUCKET_NODES,
                          min_nodes=64, min_edges=128)
    from repro_torch.exec.plan import build_partition_plan

    while k < g512.num_nodes and any(b.n_pad > SERVICE_MAX_BUCKET_NODES for b in
                                     build_partition_plan(g512, k).buckets):
        k *= 2
    rep["stream_k"] = k

    def cfg_of(bits):
        return dict(num_partitions=k) if bits == SERVICE_STREAM_BITS else {}

    rep["groot"] = sync_check("(a)", "groot", tickets, results, preds, cfg_of)

    # -- (b) groot_fused and groot_mxu: a short mix ----------------------------
    expect = {"groot_fused": "fused_ld_grouped", "groot_mxu": "ld_grouped_mxu"}
    for backend, kn in expect.items():
        s2 = Session(params, backend=backend)
        svc2 = s2._service_engine()
        p2 = capture(svc2)

        def mix():
            ts = {f"csa{b}": (s2.submit(designs[b], tenant="a"), b) for b in SERVICE_MIX_BITS}
            return ts, {n: s2.result(t, timeout=SERVICE_TIMEOUT_S) for n, (t, _) in ts.items()}

        (ts, rs), wall = drive(f"service (b) mix {backend}", mix)
        s2.close()
        used = {k_: v for k_, v in launches[f"service (b) mix {backend}"].items() if v}
        log(f"service (b) {backend}: {len(rs)} tickets in {wall:.2f} s, launches "
            f"{json.dumps(used)}")
        if not used.get(kn):
            fail(f"service (b) {backend}: {kn} did not launch")
        rep[backend] = dict(wall_s=wall, launches=used,
                            tickets=sync_check(f"(b) {backend}", backend, ts, rs, p2,
                                               lambda b: {}))
        del s2, svc2
    rep["phase_s"] = time.perf_counter() - t_phase
    log(f"service phase: {rep['phase_s']:.1f} s")
    return rep


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
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import groot_spmm as gs
    from repro_torch.kernels import flash_attention as fa
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
    report["staged_build"] = staged_build_report()

    # -- host stages for the design the main path runs -------------------------
    params_path = PARAMS_PATH
    model = gnn.params_from_numpy(gnn.load_params(params_path), device=dev)
    t0 = time.perf_counter()
    prep = P.prepare(P.PipelineConfig(dataset="csa", bits=args.bits))
    t_prep = time.perf_counter() - t0
    g = prep.graph
    t0 = time.perf_counter()
    pairs = {b: ops.make_agg_pair(g.edge_src, g.edge_dst, g.num_nodes, b, device=dev)
             for b in ("groot", "groot_mxu", "groot_fused")}
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
        fail(f"csa-{args.bits} has no HD rows: K2 and K6 would not run (need bits > {gs.E_T})")

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

    def kernel(name, source, replaces, fn):
        return dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{source}",
                    replaces=replaces, fn=fn, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                    bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, shapes=[])

    spmm_py = "src/repro/kernels/groot_spmm.py"
    kernels = {k["name"]: k for k in (
        kernel("ld_grouped", "groot_spmm.cu", f"{spmm_py}:513", gs.ld_grouped_apply),
        kernel("hd_grouped", "groot_spmm.cu", f"{spmm_py}:590", gs.hd_grouped_apply),
        kernel("fused_ld_grouped", "fused_sage.cu", "src/repro/kernels/fused_sage.py:91",
               fs.fused_ld_matmul_grouped),
        kernel("ld_grouped_mxu", "groot_spmm.cu", f"{spmm_py}:524", gs.ld_grouped_mxu_apply),
        kernel("ld_bucket", "groot_spmm.cu", f"{spmm_py}:309", gs.ld_bucket_apply),
        kernel("hd", "groot_spmm.cu", f"{spmm_py}:368", gs.hd_apply),
        kernel("fused_ld", "fused_sage.cu", "src/repro/kernels/fused_sage.py:29",
               fs.fused_ld_matmul),
        kernel("flash_attention", "flash_attention.cu",
               "src/repro/kernels/flash_attention.py:36", fa.flash_attention),
    )}

    def compare(kname, what, got, want):
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{kname} {what}: non-finite output")
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        ok = err <= TOL * scale
        log(f"parity {kname:17s} {what:44s} max_abs_err {err:.3e} tol {TOL * scale:.3e} "
            f"{'ok' if ok else 'MISS'}")
        kernels[kname]["max_abs_err"] = max(kernels[kname]["max_abs_err"], err)
        if not ok:
            fail(f"{kname} {what}: max abs error {err:.3e} over {TOL * scale:.3e}")

    def account(kname, what, ms, plain_ms, bytes_, flops, timed, ops_ms=None):
        """Log and sum one launch's time beside its bound: the bytes at
        3.35 TB/s or the operations (``flops`` at the f32 rate, or ``ops_ms``
        where they run at other rates), whichever takes longer."""
        t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3 if ops_ms is None else ops_ms
        b_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        kernels[kname]["shapes"].append(dict(
            what=what, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
            bytes=bytes_, flops=flops))
        if timed:  # the launches the summary line reports (see PERF.md)
            kernels[kname]["ms"] += ms
            kernels[kname]["plain_ms"] += plain_ms
            kernels[kname]["bound_ms"] += b_ms
            kernels[kname]["bytes_ms"] += t_bytes
            kernels[kname]["ops_ms"] += t_ops
        log(f"time   {kname:17s} {what:44s} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"bound {b_ms:.4f} ms ({by})")
        return t_bytes

    def check(kname, what, run, plain, bytes_of, flops, timed, reps, ops_ms=None):
        """Hold one kernel launch against its plain version, then time both
        (reps = 0: parity only); returns (kernel ms, ms the bytes alone
        would take)."""
        got = run(None)
        want = plain()
        compare(kname, what, got, want)
        del want
        if not reps:
            return 0.0, 0.0
        ms = cuda_ms(lambda: run(got), reps)
        plain_ms = cuda_ms(plain, 2)
        return ms, account(kname, what, ms, plain_ms, bytes_of(got), flops, timed, ops_ms)

    def distinct_row_bytes(cols, x):
        return torch.unique(cols).numel() * x.shape[1] * x.element_size()

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    staged_ms = {k: {"f32": 0.0, "bf16": 0.0} for k in ("fused_ld_grouped", "ld_grouped_mxu")}
    k3_fma_bound_ms = 0.0
    # K5's MXU body at F=32 f32, weighted, summed like the VPU body's time
    k5_mxu = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    # ungrouped weight streams per direction: one mean-normalised group column
    w_edge = {"fanin": wg_in[:, 0].contiguous(), "fanout": wg_out[:, 0].contiguous()}
    for sdt in (None, torch.bfloat16):
        tag = "bf16" if sdt is not None else "f32"
        for x in (x32, x4):
            xs = x if sdt is None else x.to(sdt)
            feat = x.shape[1]
            # the summary reports hidden 32 with f32 streams; K3's and K4's
            # bf16 times at F=32 are kept beside them
            timed = sdt is None and feat == 32
            reps = args.reps if timed else 2
            staged_reps = args.reps if feat == 32 else 2
            for direction, plan in (("fanin", in_plan), ("fanout", out_plan)):
                sw = staged[("in" if direction == "fanin" else "out", sdt)]
                w_buckets, w_hd = gs.stage_weight(plan, w_edge[direction], xs.dtype)
                dp = plan.on(dev)
                grp = sw.groups
                ws = w_stack if feat == 32 else w_stack0
                hid = ws.shape[2]
                for b, cols, wge, wb in zip(plan.buckets, dp.cols, sw.buckets, w_buckets):
                    slots, rows = cols.numel(), b.num_rows
                    what = f"{direction} d={b.deg} R={rows} G={grp} F={feat} {tag}"
                    cols_rows = distinct_row_bytes(cols, xs)
                    # K1
                    check("ld_grouped", what,
                          lambda o: gs.ld_grouped_apply(xs, cols, wge, b.deg, out=o),
                          lambda: gs.ld_grouped_plain(xs, cols, wge, b.deg),
                          lambda o: cols_rows + nbytes(wge, cols, o),
                          2.0 * slots * grp * feat, timed, reps)
                    # K4 (the MXU backend sends degree > 1 here)
                    if b.deg > 1:
                        ms, _ = check("ld_grouped_mxu", what,
                                      lambda o: gs.ld_grouped_mxu_apply(xs, cols, wge, b.deg, out=o),
                                      lambda: gs.ld_grouped_mxu_plain(xs, cols, wge, b.deg),
                                      lambda o: cols_rows + nbytes(wge, cols, o),
                                      2.0 * slots * grp * feat, timed, staged_reps)
                        if feat == 32:
                            staged_ms["ld_grouped_mxu"][tag] += ms
                    # K5, both bodies, with and without a weight; the
                    # summary's time is the weighted VPU body, the MXU
                    # body's weighted time is kept beside it
                    for w in (wb, None):
                        for mxu in (False, True) if b.deg > 1 else (False,):
                            body = "mxu" if mxu else "vpu"
                            before = dict(gs.ld_bucket_apply.body_launches)
                            k5_what = (f"{direction} d={b.deg} R={rows} F={feat} {tag} "
                                       f"{body}{'' if w is None else ' w'}")
                            ms, t_bytes = check(
                                "ld_bucket", k5_what,
                                lambda o: gs.ld_bucket_apply(xs, cols, b.deg, w, mxu=mxu, out=o),
                                lambda: gs.ld_bucket_plain(xs, cols, b.deg, w),
                                lambda o: cols_rows + nbytes(w, cols, o),
                                (2.0 if w is not None else 1.0) * slots * feat,
                                timed and w is not None and not mxu, reps)
                            if gs.ld_bucket_apply.body_launches[body] <= before[body]:
                                fail(f"ld_bucket {k5_what}: not launched on its {body} body")
                            if timed and w is not None and mxu:
                                k5_mxu["ms"] += ms
                                k5_mxu["bound_ms"] += t_bytes
                    if direction == "fanin":
                        # K3 and K7: the fused paths fuse the fanin aggregation
                        agg_flops = 2.0 * slots * grp * feat
                        mma_flops = 2.0 * rows * grp * feat * hid
                        ms, t_bytes = check(
                            "fused_ld_grouped", what + f" H={hid}",
                            lambda o: fs.fused_ld_matmul_grouped(xs, cols, wge, ws, b.deg, out=o),
                            lambda: fs.fused_ld_grouped_plain(xs, cols, wge, ws, b.deg),
                            lambda o: cols_rows + nbytes(wge, cols, ws, o),
                            agg_flops + mma_flops, timed, staged_reps,
                            ops_ms=(agg_flops / PEAK_F32_FLOPS
                                    + mma_flops / (PEAK_TF32_FLOPS / F32_MMAS)) * 1e3)
                        if feat == 32:
                            staged_ms["fused_ld_grouped"][tag] += ms
                        if timed:  # the bound with every operation at the f32 FMA rate
                            k3_fma_bound_ms += max(
                                t_bytes, (agg_flops + mma_flops) / PEAK_F32_FLOPS * 1e3)
                        w_mat = ws[0].contiguous()
                        for w in (wb, None):
                            agg_flops = (2.0 if w is not None else 1.0) * slots * feat
                            mma_flops = 2.0 * rows * feat * hid
                            check("fused_ld", f"fanin d={b.deg} R={rows} F={feat} H={hid} {tag}"
                                              f"{'' if w is None else ' w'}",
                                  lambda o: fs.fused_ld_matmul(xs, cols, w_mat, b.deg, w, out=o),
                                  lambda: fs.fused_ld_plain(xs, cols, w_mat, b.deg, w),
                                  lambda o: cols_rows + nbytes(w, cols, w_mat, o),
                                  agg_flops + mma_flops, timed and w is not None, reps,
                                  ops_ms=(agg_flops / PEAK_F32_FLOPS
                                          + mma_flops / (PEAK_TF32_FLOPS / F32_MMAS)) * 1e3)
                if plan.hd is not None:
                    # K2 and K6 timed at both widths and dtypes, beside their
                    # bound and their floor without L2 reuse: each HD row
                    # reading its own copy of each of its real slots' x rows
                    hd = plan.hd
                    n_hd, slots = hd.rows.shape[0], dp.hd_cols.numel()
                    what = f"{direction} HD rows={n_hd} chunks={hd.num_chunks} G={grp} F={feat} {tag}"
                    cols_rows = distinct_row_bytes(dp.hd_cols, xs)
                    real_rows = int((dp.hd_cols != n).sum()) * feat * xs.element_size()

                    def hd_times(kname, what, ms, bound_ms, w, run):
                        groups = 1 if w is None or w.dim() == 1 else w.shape[1]
                        floor = (real_rows + nbytes(w, dp.hd_cols, dp.hd_row_chunks)
                                 + 4 * groups * n_hd * feat) / PEAK_BYTES_PER_S * 1e3
                        out = run(None)
                        queued = back_to_back_ms(lambda: run(out), 4 * args.reps)
                        report.setdefault("hd_times", []).append(dict(
                            kernel=kname, what=what, ms=ms, back_to_back_ms=queued,
                            bound_ms=bound_ms, floor_ms=floor))
                        log(f"hd     {kname:17s} {what:44s} kernel {ms:.4f} ms, back to back "
                            f"{queued:.4f} ms; bound {bound_ms:.4f} ms, without L2 reuse "
                            f"{floor:.4f} ms")

                    def k2(o):
                        return gs.hd_grouped_apply(xs, dp.hd_cols, sw.hd, dp.hd_meta,
                                                   dp.hd_row_chunks, plan.e_t, out=o)

                    ms, b_ms = check(
                        "hd_grouped", what, k2,
                        lambda: gs.hd_grouped_plain(xs, dp.hd_cols, sw.hd, dp.hd_meta, n_hd,
                                                    plan.e_t),
                        lambda o: cols_rows + nbytes(sw.hd, dp.hd_cols, dp.hd_row_chunks, o),
                        2.0 * slots * grp * feat, timed, args.reps)
                    hd_times("hd_grouped", what, ms, b_ms, sw.hd, k2)
                    for w in (w_hd, None):
                        k6_what = (f"{direction} HD rows={n_hd} chunks={hd.num_chunks} F={feat} "
                                   f"{tag}{'' if w is None else ' w'}")

                        def k6(o):
                            return gs.hd_apply(xs, dp.hd_cols, dp.hd_meta, dp.hd_row_chunks,
                                               plan.e_t, w, out=o)

                        ms, b_ms = check(
                            "hd", k6_what, k6,
                            lambda: gs.hd_plain(xs, dp.hd_cols, dp.hd_meta, plan.e_t, w),
                            lambda o: cols_rows + nbytes(w, dp.hd_cols, dp.hd_row_chunks, o),
                            (2.0 if w is not None else 1.0) * slots * feat,
                            timed and w is not None, args.reps)
                        hd_times("hd", k6_what, ms, b_ms, w, k6)
                del w_buckets, w_hd
    torch.cuda.empty_cache()
    report["staged_ms_f32_bf16"] = staged_ms
    report["k3_f32_fma_bound_ms"] = k3_fma_bound_ms
    for kn, t in staged_ms.items():
        log(f"{kn} at F=32, summed over its buckets of one layer: f32 {t['f32']:.4f} ms, "
            f"bf16 {t['bf16']:.4f} ms")
    log(f"fused_ld_grouped bound: {kernels['fused_ld_grouped']['bound_ms']:.4f} ms "
        f"(contraction at {PEAK_TF32_FLOPS / F32_MMAS / 1e12:.0f} TFLOP/s); with every "
        f"operation at the f32 FMA rate, as before: {k3_fma_bound_ms:.4f} ms")

    # the staged bodies at the widths they pad (24) or slice (64): K3, K4,
    # K5 (both bodies) and K7 on the first WIDTH_ROWS rows of every bucket,
    # F = H, f32 and bf16, with and without a weight; the f32 launches timed
    # beside their bounds, their padding and scratch passes included (not
    # in the summary)
    for width in WIDTHS:
        xw = torch.randn((n + 1, width), generator=gen, device=dev)
        xw[-1] = 0
        wsw = torch.randn((len(gnn.IN_GROUPS), width, width), generator=gen,
                          device=dev) / width ** 0.5
        for sdt in (None, torch.bfloat16):
            tag = "bf16" if sdt is not None else "f32"
            xs = xw if sdt is None else xw.to(sdt)
            reps = 3 if sdt is None else 0
            for direction, plan in (("fanin", in_plan), ("fanout", out_plan)):
                sw = staged[("in" if direction == "fanin" else "out", sdt)]
                w_buckets, _ = gs.stage_weight(plan, w_edge[direction], xs.dtype)
                for b, cols, wge, wb in zip(plan.buckets, plan.on(dev).cols, sw.buckets,
                                            w_buckets):
                    rows = min(b.num_rows, WIDTH_ROWS)
                    c, wgr, wr = (t[:rows * b.deg] for t in (cols, wge, wb))
                    grp, slots = wgr.shape[1], rows * b.deg
                    what = f"{direction} d={b.deg} R={rows} F=H={width} {tag}"
                    c_rows = distinct_row_bytes(c, xs) if reps else 0
                    wst = wsw[:grp].contiguous()
                    if direction == "fanin":
                        agg_flops, mma_flops = 2.0 * slots * grp * width, 2.0 * rows * grp * width ** 2
                        check("fused_ld_grouped", what + f" G={grp}",
                              lambda o: fs.fused_ld_matmul_grouped(xs, c, wgr, wst, b.deg, out=o),
                              lambda: fs.fused_ld_grouped_plain(xs, c, wgr, wst, b.deg),
                              lambda o: c_rows + nbytes(wgr, c, wst, o), agg_flops + mma_flops,
                              False, reps, ops_ms=(agg_flops / PEAK_F32_FLOPS + mma_flops / (
                                  PEAK_TF32_FLOPS / F32_MMAS)) * 1e3)
                    if b.deg > 1:
                        check("ld_grouped_mxu", what + f" G={grp}",
                              lambda o: gs.ld_grouped_mxu_apply(xs, c, wgr, b.deg, out=o),
                              lambda: gs.ld_grouped_mxu_plain(xs, c, wgr, b.deg),
                              lambda o: c_rows + nbytes(wgr, c, o), 2.0 * slots * grp * width,
                              False, reps)
                    for w in (wr, None):
                        wt = "" if w is None else " w"
                        for mxu in (False, True) if b.deg > 1 else (False,):
                            check("ld_bucket", what + f" {'mxu' if mxu else 'vpu'}{wt}",
                                  lambda o: gs.ld_bucket_apply(xs, c, b.deg, w, mxu=mxu, out=o),
                                  lambda: gs.ld_bucket_plain(xs, c, b.deg, w),
                                  lambda o: c_rows + nbytes(w, c, o), 2.0 * slots * width,
                                  False, reps)
                        if direction == "fanin":
                            flops = 2.0 * slots * width + 2.0 * rows * width ** 2
                            check("fused_ld", what + wt,
                                  lambda o: fs.fused_ld_matmul(xs, c, wsw[0], b.deg, w, out=o),
                                  lambda: fs.fused_ld_plain(xs, c, wsw[0], b.deg, w),
                                  lambda o: c_rows + nbytes(w, c, wsw[0], o), flops, False, reps)
                del w_buckets
        del xw, xs
        torch.cuda.empty_cache()

    # library yardstick: one torch.sparse.mm over a (G*rows, N) CSR computing
    # the same (grouped) sums (cuSPARSE; the port never calls it): over every
    # node's row, or for K2 and K6 over the HD rows alone (the rows their
    # output holds, numbered as the plan numbers them)
    deg_in = torch.bincount(dst, minlength=n)
    deg_out = torch.bincount(src, minlength=n)
    hd_nodes = torch.nonzero(deg_out > gs.E_T).squeeze(1)
    hd_index = torch.full((n,), -1, dtype=torch.int64, device=dev)
    hd_index[hd_nodes] = torch.arange(hd_nodes.numel(), device=dev)

    def csr(rows_of, cols_of, wg, keep, n_rows=n):
        grp = wg.shape[1]
        e = torch.nonzero(keep).squeeze(1)
        r = torch.cat([gi * n_rows + rows_of[e] for gi in range(grp)])
        c = torch.cat([cols_of[e]] * grp)
        v = torch.cat([wg[e, gi] for gi in range(grp)])
        return torch.sparse_coo_tensor(torch.stack([r, c]), v,
                                       (grp * n_rows, n)).coalesce().to_sparse_csr()

    x32n = x32[:n]
    every = torch.ones_like(dst, dtype=torch.bool)
    ld_out, hd_out = deg_out[src] <= gs.E_T, deg_out[src] > gs.E_T
    lib = {}
    n_hd_rows = hd_nodes.numel()
    for label, rows_of, cols_of, wg, keep, n_rows in (
        ("fanin_all", dst, src, wg_in, every, n),
        ("fanout_all", src, dst, wg_out, every, n),
        ("fanout_ld", src, dst, wg_out, ld_out, n),
        # K2: the (G * n_hd, N) CSR of the HD rows
        ("fanout_hd", hd_index[src], dst, wg_out, hd_out, n_hd_rows),
        # K4's rows: the LD buckets of degree > 1
        ("fanin_deg2+", dst, src, wg_in, deg_in[dst] > 1, n),
        ("fanout_ld_deg2+", src, dst, wg_out, ld_out & (deg_out[src] > 1), n),
        # K5: one weight column, (N, N); K6: (n_hd, N)
        ("fanin_1", dst, src, w_edge["fanin"][:, None], every, n),
        ("fanout_ld_1", src, dst, w_edge["fanout"][:, None], ld_out, n),
        ("fanout_hd_1", hd_index[src], dst, w_edge["fanout"][:, None], hd_out, n_hd_rows),
        # K5's MXU body: one weight column over the LD rows of degree > 1
        ("fanin_deg2+_1", dst, src, w_edge["fanin"][:, None], deg_in[dst] > 1, n),
        ("fanout_ld_deg2+_1", src, dst, w_edge["fanout"][:, None],
         ld_out & (deg_out[src] > 1), n),
    ):
        a = csr(rows_of, cols_of, wg, keep, n_rows)
        lib[label] = cuda_ms(lambda: torch.sparse.mm(a, x32n), args.reps)
        log(f"library torch.sparse.mm {label:17s} rows={a.shape[0]} nnz={a.values().numel()} "
            f"{lib[label]:.4f} ms")
        del a
    torch.cuda.empty_cache()
    # the port's whole grouped walk per direction (K1 + K2 + assembly)
    x32p = x32.contiguous()
    walk = {
        "fanin": cuda_ms(lambda: gs.apply_plan_grouped_staged(in_plan, x32p, staged[("in", None)]),
                         args.reps),
        "fanout": cuda_ms(lambda: gs.apply_plan_grouped_staged(out_plan, x32p, staged[("out", None)]),
                          args.reps),
        "fanin_mxu": cuda_ms(lambda: gs.apply_plan_grouped_staged(
            in_plan, x32p, staged[("in", None)], mxu=True), args.reps),
        "fanout_mxu": cuda_ms(lambda: gs.apply_plan_grouped_staged(
            out_plan, x32p, staged[("out", None)], mxu=True), args.reps),
    }
    log(f"walk (grouped kernels + assembly, F=32 f32): {json.dumps(walk)}; "
        f"torch.sparse.mm per direction: fanin {lib['fanin_all']:.4f} ms, "
        f"fanout {lib['fanout_all']:.4f} ms")
    report["walk_ms"] = walk
    report["library_ms"] = lib
    kernels["ld_grouped"]["library_ms"] = lib["fanin_all"] + lib["fanout_ld"]
    kernels["hd_grouped"]["library_ms"] = lib["fanout_hd"]
    kernels["fused_ld_grouped"]["library_ms"] = None
    kernels["ld_grouped_mxu"]["library_ms"] = lib["fanin_deg2+"] + lib["fanout_ld_deg2+"]
    kernels["ld_bucket"]["library_ms"] = lib["fanin_1"] + lib["fanout_ld_1"]
    k5_mxu["library_ms"] = lib["fanin_deg2+_1"] + lib["fanout_ld_deg2+_1"]
    report["k5_mxu_body"] = k5_mxu
    log(f"ld_bucket mxu body, weighted, F=32 f32, one SpMM pair (buckets of degree > 1): "
        f"kernel {k5_mxu['ms']:.4f} ms bound {k5_mxu['bound_ms']:.4f} ms (bytes) "
        f"torch.sparse.mm {k5_mxu['library_ms']:.4f} ms; vpu body over every bucket "
        f"{kernels['ld_bucket']['ms']:.4f} ms")
    kernels["hd"]["library_ms"] = lib["fanout_hd_1"]
    kernels["fused_ld"]["library_ms"] = None
    del staged, x4
    torch.cuda.empty_cache()

    launches: dict = {}
    bodies: dict = {}
    k5_bodies: dict = {}

    def drive(path, fn):
        """Run one path with every launch count (and K8's and K5's per body)
        set to 0 just before it; record the counts just after."""
        for k in kernels.values():
            k["fn"].launches = 0
        fa.flash_attention.body_launches = dict.fromkeys(fa.flash_attention.body_launches, 0)
        gs.ld_bucket_apply.body_launches = dict.fromkeys(gs.ld_bucket_apply.body_launches, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = {kn: k["fn"].launches for kn, k in kernels.items()}
        bodies[path] = dict(fa.flash_attention.body_launches)
        k5_bodies[path] = dict(gs.ld_bucket_apply.body_launches)
        return out, wall

    def k5_expect(path, plans_groups, mxu):
        """Fail unless the path's K5 launches were one a bucket a group of
        each (plan, groups), on the VPU body, or for ``mxu`` the MXU body at
        degree > 1, and K5's launch count is their sum."""
        want = {"vpu": 0, "mxu": 0}
        for plan, groups in plans_groups:
            for b in plan.buckets:
                want["mxu" if mxu and b.deg > 1 else "vpu"] += groups
        got = k5_bodies[path]
        log(f"{path}: ld_bucket launches by body {json.dumps(got)} (expected {json.dumps(want)})")
        if got != want or launches[path]["ld_bucket"] != sum(want.values()):
            fail(f"{path}: ld_bucket launches by body {got}, "
                 f"{launches[path]['ld_bucket']} in all, expected {want}")
        return got

    def hd_expect(path, kname, n_expect):
        """Fail unless the path launched K2 (``hd_grouped``) or K6 (``hd``)
        ``n_expect`` times; each launch runs their one body,
        hd_staged_kernel (the build report holds no other)."""
        got = launches[path][kname]
        report.setdefault("hd_launches", {})[f"{path} {kname}"] = {
            "hd_staged_kernel": got, "expected": n_expect}
        log(f"{path}: {kname} launches by body {{hd_staged_kernel: {got}}} "
            f"(expected {n_expect})")
        if got != n_expect:
            fail(f"{path}: {got} launches of {kname}, expected {n_expect}")

    # HD launches a layer: K2 once per plan with HD rows (grouped walks), K6
    # once per group of such a plan (4 fanin, 2 fanout; per-group walks)
    hd_plans = [p.hd is not None for p in (in_plan, out_plan)]
    k2_layer, k6_layer = sum(hd_plans), 4 * hd_plans[0] + 2 * hd_plans[1]

    # -- 4. the paper's single SpMM, both directions ----------------------------
    w_rand = torch.rand(g.num_edges, generator=gen, device=dev)
    x32n = x32[:n]
    spmm = {}
    for direction, a_src, a_dst in (("fanin", src, dst), ("fanout", dst, src)):
        want = kref.spmm_ref(x32n, a_src, a_dst, n, w_rand)
        a = torch.sparse_coo_tensor(torch.stack([a_dst, a_src]), w_rand,
                                    (n, n)).coalesce().to_sparse_csr()
        lib_ms = cuda_ms(lambda: torch.sparse.mm(a, x32n), args.reps)
        del a
        for b in ("groot", "groot_mxu"):
            path = f"groot_spmm {b} {direction}"
            got, _ = drive(path, lambda: ops.groot_spmm(x32n, a_src, a_dst, n, w_rand, backend=b))
            k5_expect(path, [(in_plan if direction == "fanin" else out_plan, 1)], b == "groot_mxu")
            hd_expect(path, "hd", int(hd_plans[direction == "fanout"]))
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            ok = bool(torch.isfinite(got).all()) and err <= TOL * scale
            # timed through the cached pair: the one-shot entry point also
            # hashes the edge arrays on the host to find it
            pair = ops.make_agg_pair(a_src.cpu().numpy(), a_dst.cpu().numpy(), n, b, device=dev)
            ms = cuda_ms(lambda: pair.in_agg(x32n, w_rand), args.reps)
            spmm[path] = dict(ms=ms, sparse_mm_ms=lib_ms, max_abs_err=err,
                              launches=launches[path], k5_bodies=k5_bodies[path])
            log(f"{path:30s} {ms:.4f} ms vs torch.sparse.mm {lib_ms:.4f} ms; max_abs_err "
                f"{err:.3e} vs spmm_ref (tol {TOL * scale:.3e}) {'ok' if ok else 'MISS'}; "
                f"launches {json.dumps({k: v for k, v in launches[path].items() if v})}")
            if not ok:
                fail(f"{path}: max abs error {err:.3e} against spmm_ref")
            del got
        del want
    report["groot_spmm"] = spmm
    torch.cuda.empty_cache()

    # -- 5. forward, timed with synchronize around it ---------------------------
    x0 = torch.as_tensor(prep.feats).to(dev)
    aggs = {
        "groot": pairs["groot"], "groot_mxu": pairs["groot_mxu"],
        "groot_fused": pairs["groot_fused"],
        "ungrouped groot": ops.ungrouped(pairs["groot"]),
        "ungrouped groot_mxu": ops.ungrouped(pairs["groot_mxu"]),
        "ungrouped groot_fused": ops.ungrouped(pairs["groot_fused"]),
        "ref": None,
    }
    logits, fwd = {}, {}
    for b, agg in aggs.items():

        def run():
            return gnn.forward(model, x0, src, dst, inv, slot, num_nodes=n, agg=agg)

        out, _ = drive(f"forward {b}", run)
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
        used = {k: v for k, v in launches[f"forward {b}"].items() if v}
        log(f"forward {b:22s} {fwd[b]:.2f} ms (median of 3, synchronize around it) "
            f"launches {json.dumps(used)}")
    # every K3 launch of the groot_fused forward and every K4 launch of the
    # groot_mxu forward is one of the staged body (the only body each has):
    # one per fanin bucket (K3), one per bucket of degree > 1 (K4), a layer
    n_layers = len(model.layers)
    expect = {
        "fused_ld_grouped": ("forward groot_fused", n_layers * len(in_plan.buckets)),
        "ld_grouped_mxu": ("forward groot_mxu", n_layers * sum(
            b.deg > 1 for b in in_plan.buckets + out_plan.buckets)),
    }
    report["staged_launches"] = {}
    for kn, (path, n_expect) in expect.items():
        got = launches[path][kn]
        body = STAGED_KERNELS[kn]
        report["staged_launches"][kn] = {"path": path, body: got, "expected": n_expect}
        log(f"{path}: {kn} launches by body {{{body}: {got}}} (a bucket a layer: {n_expect})")
        if got != n_expect:
            fail(f"{path}: {got} launches of {kn}, expected {n_expect}")
    # the per-group forwards: K5 one a bucket a group a layer (fanin 4
    # groups, fanout 2; on groot_fused the fanin groups run K7 instead)
    report["k5_bodies"] = {}
    for b in ("groot", "groot_mxu", "groot_fused"):
        path = f"forward ungrouped {b}"
        groups = [(out_plan, 2 * n_layers)]
        if b != "groot_fused":
            groups.append((in_plan, 4 * n_layers))
        report["k5_bodies"][path] = k5_expect(path, groups, b == "groot_mxu")
    k7_want = 4 * n_layers * len(in_plan.buckets)
    got = launches["forward ungrouped groot_fused"]["fused_ld"]
    log(f"forward ungrouped groot_fused: fused_ld launches by body "
        f"{{fused_staged_kernel: {got}}} (a fanin bucket a group a layer: {k7_want})")
    if got != k7_want:
        fail(f"forward ungrouped groot_fused: {got} launches of fused_ld, expected {k7_want}")
    for b in ("groot", "groot_mxu", "groot_fused"):
        hd_expect(f"forward {b}", "hd_grouped", n_layers * k2_layer)
        hd_expect(f"forward ungrouped {b}", "hd", n_layers * k6_layer)
    if any(launches["forward ref"].values()):
        fail(f"the ref forward launched kernels: {launches['forward ref']}")
    # where one groot forward's device time goes (kernel names by self time)
    torch.cuda.reset_peak_memory_stats()
    _, report["forward_profile_groot"] = device_profile(
        "groot forward",
        lambda: gnn.forward(model, x0, src, dst, inv, slot, num_nodes=n, agg=pairs["groot"]))
    report["forward_peak_bytes_groot"] = torch.cuda.max_memory_allocated()
    for b in ("groot_fused", "groot_mxu"):  # where K3's and K4's forwards spend theirs
        _, report[f"forward_profile_{b}"] = device_profile(
            f"{b} forward",
            lambda: gnn.forward(model, x0, src, dst, inv, slot, num_nodes=n, agg=pairs[b]))
    report["forward_ms"] = fwd
    max_logit_diff = {b: (logits[b] - logits["ref"]).abs().max().item()
                      for b in aggs if b != "ref"}
    report["max_logit_diff_vs_ref"] = max_logit_diff
    log(f"max |logit - ref logit|: {json.dumps(max_logit_diff)}")
    for b, d in max_logit_diff.items():
        if d > LOGIT_TOL * max(1.0, logits["ref"].abs().max().item()):
            fail(f"forward {b}: logits differ from ref by {d:.3e}")
    del logits
    torch.cuda.empty_cache()
    # onehot materialises an (E, N) one-hot: at csa-<bits> that is
    # E x N floats, so it runs on a small design against ref instead
    small = {}
    log(f"onehot: its (E, N) one-hot at csa-{args.bits} would hold {g.num_edges} x {n} "
        f"floats ({4.0 * g.num_edges * n / 1e12:.0f} TB); run at csa-{ONEHOT_BITS} instead")
    for b in ("onehot", "ref"):
        r, wall = drive(f"session.verify {b} csa-{ONEHOT_BITS}", lambda: Session(
            params=params_path, backend=b).verify(dataset="csa", bits=ONEHOT_BITS,
                                                  return_predictions=True))
        small[b] = r
        log(f"session.verify backend={b} csa-{ONEHOT_BITS}: status {r.status} accuracy "
            f"{r.accuracy:.6f} wall {wall:.1f} s")
    mism = int((small["onehot"].predictions != small["ref"].predictions).sum())
    if small["onehot"].status != small["ref"].status or mism > MAX_PRED_MISMATCH * len(
            small["ref"].predictions):
        fail(f"onehot at csa-{ONEHOT_BITS}: verdict {small['onehot'].status} vs "
             f"{small['ref'].status}, {mism} predictions differ")
    report["onehot_small"] = dict(bits=ONEHOT_BITS, status=small["onehot"].status,
                                  pred_mismatch_vs_ref=mism)

    # -- 6. main path ------------------------------------------------------------
    results = {}
    for b in ("groot", "groot_mxu", "groot_fused", "ref"):
        path = f"session.verify {b}"
        if b == "groot":
            # the full-graph working set, its plans' device copies included
            ops.release_device(pairs["groot"])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        # groot runs the front door from the generator; the others take the
        # design prepared above (the same csa-<bits>, seed 0), so the host
        # generates it once, not four times (about 25 s each)
        r, wall = drive(path, lambda: Session(params=params_path, backend=b).verify(
            **(dict(dataset="csa", bits=args.bits) if b == "groot" else dict(prepared=prep)),
            return_predictions=True))
        if b == "groot":
            full_peak = torch.cuda.max_memory_allocated() - base
            log(f"session.verify groot: device peak {full_peak / 2**30:.3f} GiB above the "
                f"bytes allocated before it")
            report["full_session_peak_bytes"] = full_peak
        results[b] = r
        used = {k: v for k, v in launches[path].items() if v}
        log(f"session.verify backend={b}: status {r.status} accuracy {r.accuracy:.6f} "
            f"wall {wall:.1f} s timings {json.dumps({k: round(v, 3) for k, v in r.timings.items()})} "
            f"launches {json.dumps(used)}")
    report["sessions"] = {b: dict(status=r.status, accuracy=r.accuracy, timings=r.timings,
                                  launches=launches[f"session.verify {b}"])
                          for b, r in results.items()}
    if any(launches["session.verify ref"].values()):
        fail(f"the ref backend launched kernels: {launches['session.verify ref']}")
    for b in ("groot", "groot_mxu", "groot_fused"):
        hd_expect(f"session.verify {b}", "hd_grouped", n_layers * k2_layer)
    mxu_launches = launches["session.verify groot_mxu"]
    for kn in ("ld_grouped_mxu", "ld_grouped", "hd_grouped"):
        if mxu_launches[kn] <= 0:
            fail(f"Session.verify on groot_mxu did not launch {kn}")
    ref = results["ref"]
    for b in ("groot", "groot_mxu", "groot_fused"):
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
    # the hidden widths the staged bodies pad (24) or slice (64): verdict and
    # predictions equal to ref's on the same seeded params
    report["hidden_widths"] = {}
    for hidden in WIDTHS:
        params = gnn.params_from_numpy(random_params(hidden, args.seed), device=dev)
        res = {}
        for b in ("groot_fused", "groot_mxu", "ref"):
            path = f"session.verify {b} hidden={hidden} csa-{ONEHOT_BITS}"
            res[b], wall = drive(path, lambda: Session(params=params, backend=b).verify(
                dataset="csa", bits=ONEHOT_BITS, return_predictions=True))
        for b, kn in (("groot_fused", "fused_ld_grouped"), ("groot_mxu", "ld_grouped_mxu")):
            path = f"session.verify {b} hidden={hidden} csa-{ONEHOT_BITS}"
            r, used = res[b], {k: v for k, v in launches[path].items() if v}
            mism = int((r.predictions != res["ref"].predictions).sum())
            log(f"{path}: status {r.status} (ref {res['ref'].status}), {mism} of "
                f"{len(r.predictions)} predictions differ from ref; launches {json.dumps(used)}")
            report["hidden_widths"][path] = dict(status=r.status, pred_mismatch_vs_ref=mism,
                                                 launches=used)
            if r.status != res["ref"].status or mism or not used.get(kn):
                fail(f"{path}: verdict {r.status} vs ref's {res['ref'].status}, {mism} "
                     f"predictions differ, launches {used}")
        del params

    # -- 7. serve: K8, then qwen3-8b through BatchServer -------------------------
    del pairs, x32, x32p, x0, src, dst, inv, slot, wg_in, wg_out, w_rand
    torch.cuda.empty_cache()
    report["flash"] = flash_phase(args, dev, kernels["flash_attention"])
    report["serve"] = serve_phase(args, dev, drive, launches, bodies)

    # -- 8. partitioned: csa-<bits> cut PART_K ways, then the 16-copy input -------
    report["partitioned"], parts = partitioned_phase(
        args, dev, drive, launches, kernels, model, params_path,
        results["groot"].predictions)

    # -- 9. streamed: phase 8's partitionings as packed launches, the budget route
    report["streamed"], budget_cut = streamed_phase(args, dev, drive, launches, kernels,
                                                    params_path, parts)
    del parts

    # -- 10. the command-line path: train on the card, journal, AIGER, the CLI ---
    report["cli"] = cli_phase(args, dev, drive, launches, prep, results["groot"], budget_cut)
    del budget_cut

    # -- 11. the batched service: concurrent tickets, coalescing, faults -------
    report["service"] = service_phase(args, dev, drive, launches)

    total = {kn: sum(counts[kn] for counts in launches.values()) for kn in kernels}
    report["launches"] = launches
    for kn, cnt in total.items():
        if cnt <= 0:
            fail(f"kernel {kn} was not launched on any driven path")
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
