"""Microbatch pipeline parallelism over a process group (GPipe schedule;
port of ``repro/distributed/pipeline_parallel.py``).

For cross-pod deployments where the "pod" link is latency-bound,
tensor-style collectives (all-reduce per layer) are a poor fit; a pipeline
moves only the (B_mb, S, D) activation cut once per stage per microbatch.

``pipeline_apply(stage_fn, stage_params, x_mb, group)`` runs on every rank
of ``group``, the rank's index in it being its stage:

  * ``stage_params``: this stage's slice (leaves with a leading dim of 1);
  * ``x_mb``: (n_micro, B_mb, ...) microbatched inputs, every rank holds
    them (stage 0 consumes, later stages ignore);
  * the classic rotating-buffer schedule: n_micro + n_stages - 1 ticks,
    each tick every stage applies its layer, then sends its activation to
    the next stage and receives the previous stage's (the reference's
    ``ppermute``: one send/recv pair a rank).

Returns the final-stage outputs, (n_micro, B_mb, ...), on every stage (the
last stage broadcasts them, where the reference rotates them round and
sums).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.zoo.configs.base import tree_map


def _ring(y: torch.Tensor, buf: torch.Tensor, nxt: int, prv: int, group) -> None:
    ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
           dist.P2POp(dist.irecv, buf, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def pipeline_apply(stage_fn: Callable, stage_params, x_mb: torch.Tensor, group=None):
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group) if group is not None else list(range(n_stages))
    nxt, prv = ranks[(stage + 1) % n_stages], ranks[(stage - 1) % n_stages]
    n_micro = x_mb.shape[0]
    ticks = n_micro + n_stages - 1

    params = tree_map(lambda p: p[0], stage_params)
    buf = torch.zeros_like(x_mb[0])                   # rotating activation
    outs = torch.zeros((n_micro,) + tuple(x_mb.shape[1:]), dtype=x_mb.dtype,
                       device=x_mb.device)
    for t in range(ticks):
        # stage 0 ingests a fresh microbatch while t < n_micro
        inp = x_mb[min(t, n_micro - 1)] if stage == 0 else buf
        # bubble guard: stage s works on microbatch (t - s)
        my_mb = t - stage
        active = 0 <= my_mb < n_micro
        y = stage_fn(params, inp) if active else buf
        if active and stage == n_stages - 1:  # the last stage records it
            outs[my_mb] = y
        if n_stages > 1:  # rotate activations to the next stage
            nbuf = torch.empty_like(buf)
            _ring(y, nbuf, nxt, prv, group)
            buf = nbuf
    if n_stages > 1:
        dist.broadcast(outs, src=ranks[n_stages - 1], group=group)
    return outs
