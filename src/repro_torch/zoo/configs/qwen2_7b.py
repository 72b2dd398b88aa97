"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias.  [arXiv:2407.10671; hf]"""
import dataclasses

from repro_torch.zoo.configs.base import ModelConfig

ARCH_ID = "qwen2-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        head_pad_to=32,   # 28 heads -> TP16-compatible (zero-pad, exact)
        rope_theta=1e6,
        tie_embeddings=False,
        layer_pattern=("global",),
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=160, vocab_size=512, head_dim=16,
    )
