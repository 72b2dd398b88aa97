"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865 —
enc-dec, conv frontend (stub).  [arXiv:2212.04356; unverified]

The modality frontend is a STUB per the brief: input_specs() provides
precomputed (B, 1500, d_model) frame embeddings.  Adaptation note
(DESIGN.md): real whisper caps decoder positions at 448; the brief's
decode shapes exercise the backbone, so the positional range is extended.
"""
import dataclasses

from repro_torch.zoo.configs.base import ModelConfig

ARCH_ID = "whisper-base"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        num_layers=6,            # decoder depth; + 6 encoder layers below
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        head_pad_to=16,   # 8 heads -> TP16-compatible (zero-pad, exact)
        encoder_layers=6,
        encoder_seq=1500,
        act="gelu",
        tie_embeddings=True,
        layer_pattern=("cross+global",),
        skip_shapes=("long_500k",),  # dense decoder self-attention cache
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, encoder_layers=2, encoder_seq=16,
    )
