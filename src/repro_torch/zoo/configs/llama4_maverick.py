"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Config interpretation (DESIGN.md §6): the published Maverick interleaves
MoE every 2nd layer (interleave_moe_layer_step=2), which reproduces the
400B-total / 17B-active figures; an all-MoE 48L reading would be ~780B.
"""
import dataclasses

from repro_torch.zoo.configs.base import ModelConfig

ARCH_ID = "llama4-maverick-400b-a17b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        moe=True,
        num_experts=128,
        top_k=1,
        moe_d_ff=8192,
        moe_interleave=2,
        head_pad_to=48,   # 40 heads -> TP16-compatible (zero-pad, exact)
        rope_theta=5e5,
        tie_embeddings=False,
        layer_pattern=("global",),
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16, num_experts=4, moe_d_ff=64, capacity_factor=4.0,
    )
