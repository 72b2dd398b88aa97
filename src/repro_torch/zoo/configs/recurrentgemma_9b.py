"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn, 1:2.  [arXiv:2402.19427; unverified]

Pattern: (rglru, rglru, local-attention[window 2048]) repeating.
Supports long_500k: recurrent state is O(1), attention cache is bounded
by the 2048 window.
"""
import dataclasses

from repro_torch.zoo.configs.base import ModelConfig

ARCH_ID = "recurrentgemma-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        sliding_window=2048,
        d_rnn=4096,
        conv_width=4,
        tie_embeddings=True,
        layer_pattern=("rglru", "rglru", "local"),
        skip_shapes=(),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=512, head_dim=16, sliding_window=8, d_rnn=64,
    )
