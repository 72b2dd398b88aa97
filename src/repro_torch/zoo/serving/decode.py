"""Serving steps (port of ``repro/zoo/serving/decode.py``): prefill (build
the cache + first logits) and decode (one token against the cache)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding.rules import shard
from repro_torch.zoo.configs.base import ModelConfig
from repro_torch.zoo.models.transformer import init_cache_tree, model_forward


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    """(params, tokens (B,S), enc_input?) -> (last_logits (B,V), cache); the
    cache is bf16, as the reference's.  ``enc_input`` is the cross-attention
    archs' stub frontend output, (B, encoder_seq or cross_seq, d_model)."""

    def prefill_step(params, tokens, enc_input=None):
        cache = init_cache_tree(cfg, tokens.shape[0], max_seq, dtype=torch.bfloat16,
                                device=tokens.device)
        logits, cache = model_forward(params, cfg, tokens, enc_input=enc_input, cache=cache,
                                      last_only=True)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, cache, token (B,1)) -> (next_token (B,1), logits, cache)."""

    def serve_step(params, cache, token):
        logits, cache = model_forward(params, cfg, token, cache=cache, decode=True)
        if cfg.padded_vocab != cfg.vocab_size:  # never sample pad ids
            col = torch.arange(logits.shape[-1], device=logits.device)
            logits = logits.masked_fill(col >= cfg.vocab_size, float("-inf"))
        # the argmax reads the whole vocabulary: gathered where it is split
        nxt = shard(logits[:, -1:], ("batch", None, None)).argmax(-1).to(torch.int32)
        return nxt, logits[:, -1], cache

    return serve_step


def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor, steps: int, *,
                    max_seq: Optional[int] = None, enc_input=None) -> torch.Tensor:
    """Reference generation loop: prefill, then decode steps -> (B, steps)
    tokens.  (The reference's scan also runs one last decode whose token it
    drops; the port skips it.)"""
    b, s = prompt.shape
    max_seq = max_seq or (s + steps)
    prefill = make_prefill_step(cfg, max_seq)
    serve = make_serve_step(cfg)
    last_logits, cache = prefill(params, prompt, enc_input)
    tok = last_logits.argmax(-1)[:, None].to(torch.int32)
    toks = [tok]
    for _ in range(steps - 1):
        tok, _, cache = serve(params, cache, tok)
        toks.append(tok)
    return torch.cat(toks, dim=1)
