"""The assigned input-shape set (LM family: seq_len x global_batch) and the
meta-tensor input specs of each (arch, shape) (port of
``repro/zoo/configs/shapes.py``).

  train_4k      seq 4,096    batch 256   -> train_step
  prefill_32k   seq 32,768   batch 32    -> prefill_step
  decode_32k    seq 32,768   batch 128   -> serve_step (1 new token)
  long_500k     seq 524,288  batch 1     -> serve_step (sub-quadratic only)

A spec is a tensor on the ``meta`` device: shape and dtype, no storage (the
reference's ``ShapeDtypeStruct``).  The decode cache is the port's own
layout, one cache dict per layer (``init_cache_tree``), where the reference
stacks each super-block's caches for its scan; the leaves hold the same
shapes and dtypes once unstacked.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.zoo.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _enc_spec(cfg: ModelConfig, batch: int):
    """Stub modality frontend: precomputed frame/patch embeddings."""
    s_enc = cfg.encoder_seq or cfg.cross_seq
    if not s_enc:
        return None
    return _meta((batch, s_enc, cfg.d_model), torch.bfloat16)


def input_specs(cfg: ModelConfig, shape_name: str, *, spec: "ShapeSpec | None" = None) -> dict:
    """Meta-tensor stand-ins for every model input of this shape (``spec``:
    a shape of its own in place of ``SHAPES[shape_name]``).  For decode
    shapes the cache comes from the cache initialiser itself, built on the
    meta device (no allocation)."""
    sh = spec or SHAPES[shape_name]
    b, s = sh.global_batch, sh.seq_len
    tok = torch.int32
    if sh.kind == "train":
        specs = {"tokens": _meta((b, s + 1), tok)}
    elif sh.kind == "prefill":
        specs = {"tokens": _meta((b, s), tok)}
    else:  # decode: one new token against a cache of seq_len
        from repro_torch.zoo.models.transformer import init_cache_tree

        cache = init_cache_tree(cfg, b, s, dtype=torch.bfloat16, device="meta")
        specs = {"token": _meta((b, 1), tok), "cache": cache}
    enc = _enc_spec(cfg, b)
    if enc is not None and sh.kind != "decode":
        specs["enc_input"] = enc
    return specs


def supported_shapes(cfg: ModelConfig) -> list:
    return [k for k in SHAPES if k not in cfg.skip_shapes]
