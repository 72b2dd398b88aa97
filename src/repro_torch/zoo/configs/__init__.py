"""Architecture registry (port of ``repro/zoo/configs/__init__.py``):
``--arch <id>`` resolution for the launchers and the dry run — the ten LM
architectures (``LM_ARCHS``) and ``groot-gnn``, the paper's GNN."""
from repro_torch.zoo.configs import (
    deepseek_67b,
    gemma2_9b,
    groot_gnn,
    llama32_vision_11b,
    llama4_maverick,
    qwen2_7b,
    qwen3_8b,
    qwen3_moe_235b,
    recurrentgemma_9b,
    rwkv6_3b,
    whisper_base,
)

_MODULES = (
    qwen3_8b,
    qwen2_7b,
    gemma2_9b,
    deepseek_67b,
    llama4_maverick,
    qwen3_moe_235b,
    rwkv6_3b,
    whisper_base,
    llama32_vision_11b,
    recurrentgemma_9b,
    groot_gnn,
)

ARCHS = {m.ARCH_ID: m for m in _MODULES}
LM_ARCHS = {k: v for k, v in ARCHS.items() if k != "groot-gnn"}


def get_config(arch: str, smoke: bool = False):
    mod = ARCHS[arch]
    return mod.smoke_config() if smoke else mod.config()
