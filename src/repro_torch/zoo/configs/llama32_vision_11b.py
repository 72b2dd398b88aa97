"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers (every 5th).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Vision frontend is a STUB per the brief: input_specs() provides
precomputed (B, 1601, d_model) patch embeddings (projector output).
"""
import dataclasses

from repro_torch.zoo.configs.base import ModelConfig

ARCH_ID = "llama-3.2-vision-11b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        cross_seq=1601,
        rope_theta=5e5,
        tie_embeddings=False,
        layer_pattern=("global", "global", "global", "global", "cross+global"),
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=5, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16, cross_seq=16,
    )
