"""Serving launcher (port of ``repro/launch/serve.py``): batched request loop
over prefill + decode steps.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke \\
        --requests 8 --max-new 32

A deliberately small server core, as the reference's:
  * request queue -> fixed-batch admission (left-padded prompts),
  * one prefill per admitted batch, then per-token decode,
  * throughput/latency accounting.

It runs on ``cuda`` unless given ``device="cpu"``.  The flags are the
reference's, ``--smoke`` included: a ``store_true`` flag with
``default=True``, so the CLI always serves the smoke-size config.  It
serves every registered arch; for the cross-attention archs
(``whisper-base``, ``llama-3.2-vision-11b``) it copies the reference's
failure: the server passes no encoder input, so their prefill raises a
``ValueError`` (ROADMAP Queue 3 item 10).  Those archs serve through
``make_prefill_step(cfg, max_seq)(params, tokens, enc_input)`` and
``make_serve_step``, or ``greedy_generate(..., enc_input=...)``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.zoo.configs import get_config
from repro_torch.zoo.configs.base import materialize, model_spec_tree
from repro_torch.zoo.models.transformer import params_from_numpy
from repro_torch.zoo.serving.decode import make_prefill_step, make_serve_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: Optional[np.ndarray] = None
    t_submit: float = 0.0
    t_done: float = 0.0


class BatchServer:
    """Fixed-batch serving core (continuous-batching-lite: a finished
    sequence's slot keeps decoding until the batch drains).  ``params`` are
    the port's weights (:func:`params_from_numpy`) on the server's device."""

    def __init__(self, cfg, params, *, batch: int, max_seq: int, device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"BatchServer on {self.device}: params are on "
                             f"{params['embed'].device}")
        self.cfg, self.params = cfg, params
        self.batch, self.max_seq = batch, max_seq
        self.prefill = make_prefill_step(cfg, max_seq)
        self.decode = make_serve_step(cfg)

    def serve_batch(self, reqs: list) -> list:
        if not 0 < len(reqs) <= self.batch:
            raise ValueError(f"serve_batch takes 1 to {self.batch} requests, got {len(reqs)}")
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.batch, plen), np.int32)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        last_logits, cache = self.prefill(self.params, torch.from_numpy(toks).to(self.device))
        tok = last_logits.argmax(-1)[:, None].to(torch.int32)
        max_new = max(r.max_new for r in reqs)
        outs = [tok]
        for _ in range(max_new - 1):
            tok, _, cache = self.decode(self.params, cache, tok)
            outs.append(tok)
        gen = torch.cat(outs, dim=1).cpu().numpy()
        now = time.perf_counter()
        for i, r in enumerate(reqs):
            r.out = gen[i, : r.max_new]
            r.t_done = now
        return reqs


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=24)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch, smoke=args.smoke)
    tree = materialize(model_spec_tree(cfg), torch.Generator(dev).manual_seed(0), torch.float32)
    params = params_from_numpy(tree, cfg, dev)
    server = BatchServer(
        cfg, params, batch=args.batch,
        max_seq=args.prompt_len + args.max_new + 1, device=dev,
    )
    rng = np.random.default_rng(0)
    queue = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new=args.max_new,
            t_submit=time.perf_counter(),
        )
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    done: list = []
    while queue:
        batch, queue = queue[: args.batch], queue[args.batch:]
        done += server.serve_batch(batch)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in done)
    lat = [r.t_done - r.t_submit for r in done]
    print(
        f"served {len(done)} requests / {n_tok} tokens in {dt:.2f}s "
        f"({n_tok/dt:.1f} tok/s); "
        f"latency p50={np.percentile(lat,50):.2f}s p95={np.percentile(lat,95):.2f}s"
    )


if __name__ == "__main__":
    main()
