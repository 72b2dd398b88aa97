"""Faults planted under the zoo serving path's timed path, each a context
manager that patches the program while it is active (plant it before the
``BatchServer`` is built): what ``bench/calibrate.py`` reads on the chip and
what the harness's tests see turn ``correct`` false.

- ``cache_fp8``: the bf16 KV cache stored as float8 e4m3 (decode reads it);
- ``no_qk_norm``: qk-norm skipped;
- ``drop_layer``: the middle layer left out;
- ``stale_cache``: a decode step that returns its cache unchanged;
- ``token``: every third decode step's tokens altered where they are
  produced;
- ``half_batch``: the second half of a batch left out, its requests handed
  the first half's tokens.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("cache_fp8", "no_qk_norm", "drop_layer", "stale_cache", "token", "half_batch")


class _WithoutQkNorm:
    """A layer's attention weights as ``_project_qkv`` reads them, minus the
    qk-norm gains."""

    def __init__(self, p):
        self.p = p

    def __getitem__(self, key):
        return self.p[key]

    def __contains__(self, key):
        return key not in ("q_norm", "k_norm") and key in self.p


@contextlib.contextmanager
def planted(name: str):
    from repro_torch.launch import serve
    from repro_torch.zoo.models import attention, transformer

    if name not in FAULTS:
        raise KeyError(f"no fault {name!r}; have {FAULTS}")
    saved = [(attention, "_write"), (attention, "_project_qkv"), (transformer, "apply_layer"),
             (serve, "make_serve_step"), (serve.BatchServer, "serve_batch")]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in saved]
    write, project, apply_layer = attention._write, attention._project_qkv, transformer.apply_layer
    make_serve_step, serve_batch = serve.make_serve_step, serve.BatchServer.serve_batch
    if name == "cache_fp8":
        def rounded(t):
            return t.to(torch.float8_e4m3fn).to(t.dtype)

        attention._write = lambda cache, slots, first, k, v: write(cache, slots, first,
                                                                  rounded(k), rounded(v))
    elif name == "no_qk_norm":
        attention._project_qkv = lambda x, p, cfg: project(x, _WithoutQkNorm(p), cfg)
    elif name == "drop_layer":
        calls = [0]

        def dropping(x, lp, cfg, kind, is_moe, cache, enc_out=None, decode=False):
            i = calls[0] % cfg.num_layers
            calls[0] += 1
            if i == cfg.num_layers // 2:
                return x, ({} if cache is None else cache)
            return apply_layer(x, lp, cfg, kind, is_moe, cache, enc_out, decode)

        transformer.apply_layer = dropping
    elif name in ("stale_cache", "token"):
        def make(cfg):
            step, calls = make_serve_step(cfg), [0]

            def faulty(params, cache, token):
                nxt, logits, new = step(params, cache, token)
                calls[0] += 1
                if name == "stale_cache":
                    return nxt, logits, cache
                if calls[0] % 3 == 0:
                    nxt = (nxt + 1) % cfg.vocab_size
                return nxt, logits, new

            return faulty

        serve.make_serve_step = make
    else:
        def half(self, reqs):
            keep = max(1, len(reqs) // 2)
            serve_batch(self, reqs[:keep])
            for i, r in enumerate(reqs[keep:]):
                r.out, r.t_done = reqs[i % keep].out.copy(), reqs[0].t_done
            return reqs

        serve.BatchServer.serve_batch = half
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
