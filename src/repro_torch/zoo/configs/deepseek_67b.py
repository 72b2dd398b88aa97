"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch.  [arXiv:2401.02954; hf]"""
import dataclasses

from repro_torch.zoo.configs.base import ModelConfig

ARCH_ID = "deepseek-67b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=95,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        rope_theta=1e4,
        tie_embeddings=False,
        layer_pattern=("global",),
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=192, vocab_size=512, head_dim=16,
    )
