"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
import dataclasses

from repro_torch.zoo.configs.base import ModelConfig

ARCH_ID = "qwen3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=False,
        layer_pattern=("global",),
        skip_shapes=("long_500k",),  # pure full attention (DESIGN.md)
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
    )
