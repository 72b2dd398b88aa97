"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay.  [arXiv:2404.05892; hf]

Attention-free: supports long_500k with O(1) recurrent state.
GROOT-technique note (DESIGN.md §4): inapplicable (dense recurrence,
no sparse adjacency).
"""
import dataclasses

from repro_torch.zoo.configs.base import ModelConfig

ARCH_ID = "rwkv6-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=32,
        d_model=2560,
        num_heads=40,          # rwkv heads = d_model / 64
        num_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        mixer_heads=40,
        tie_embeddings=False,
        layer_pattern=("rwkv",),
        skip_shapes=(),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, mixer_heads=4,
    )
