"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
import dataclasses

from repro_torch.zoo.configs.base import ModelConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151936,
        qk_norm=True,
        moe=True,
        num_experts=128,
        top_k=8,
        moe_d_ff=1536,
        moe_interleave=1,
        rope_theta=1e6,
        tie_embeddings=False,
        layer_pattern=("global",),
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=512, head_dim=16, num_experts=4, top_k=2,
        moe_d_ff=64, capacity_factor=4.0,
    )
