"""trinity-mini [moe] (AFMoE): 32L d_model=2048 32H (GQA kv=4) hd=128, two
leading dense layers (SwiGLU 6144), then 30 MoE layers of 128 experts
(width 1024) top-8 plus one shared expert, sigmoid routing with a
selection-only expert bias, weights renormalised and scaled by 2.826; per 4
layers 3 sliding-window (2048) layers with RoPE (theta 1e4) and 1 full layer
with no position encoding; qk-norm, a sigmoid output gate on attention,
sandwich norms, embeddings * sqrt(d_model); vocab=200192, untied.
[hf:arcee-ai/Trinity-Mini config.json; the afmoe modeling code]

An architecture of the port only (``PORT_ARCHS``): the reference has none
of its mechanisms."""
import dataclasses

from repro_torch.zoo.configs.base import PortModelConfig

ARCH_ID = "trinity-mini"


def config() -> PortModelConfig:
    return PortModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=32,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=6144,
        vocab_size=200192,
        qk_norm=True,
        sliding_window=2048,
        rope_theta=1e4,
        layer_pattern=("local", "local", "local", "global"),
        moe=True,
        num_experts=128,
        top_k=8,
        moe_d_ff=1024,
        tie_embeddings=False,
        norm_eps=1e-5,
        dense_layers=2,
        router_score="sigmoid",
        router_bias=True,
        route_scale=2.826,
        shared_experts=1,
        dropless=True,
        attn_out_gate=True,
        rope_local_only=True,
        sandwich_norm=True,
        embed_scale=True,
        skip_shapes=("long_500k",),
    )


def smoke_config() -> PortModelConfig:
    """6 layers (2 dense, then 4 MoE; attention kinds L L L G L L, so the
    MoE layers hold one whole period of 3 local and 1 global), d 64, 4/2
    heads of 16, 8 experts of 32 top-2 and one shared, window 8."""
    return dataclasses.replace(
        config(), num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, num_experts=8, top_k=2, moe_d_ff=32, sliding_window=8,
    )
