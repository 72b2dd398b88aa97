"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating, logit softcap.
[arXiv:2408.00118; hf]"""
import dataclasses

from repro_torch.zoo.configs.base import ModelConfig

ARCH_ID = "gemma2-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        attn_softcap=50.0,
        final_softcap=30.0,
        sliding_window=4096,
        layer_pattern=("local", "global"),
        tie_embeddings=True,
        # skip note: not pure full-attention, but every 2nd (global) layer
        # still needs the full 512k cache -> long_500k skipped (DESIGN.md).
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16, sliding_window=8,
    )
