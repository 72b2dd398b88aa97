"""Architecture registry (port of ``repro/zoo/configs/__init__.py``): the
dense attention architectures whose layer kinds the port runs.  The MoE,
RWKV6, RG-LRU, whisper, vision and ``groot-gnn`` entries join with their
layers."""
from repro_torch.zoo.configs import deepseek_67b, gemma2_9b, qwen2_7b, qwen3_8b

_MODULES = (qwen3_8b, qwen2_7b, gemma2_9b, deepseek_67b)

ARCHS = {m.ARCH_ID: m for m in _MODULES}


def get_config(arch: str, smoke: bool = False):
    mod = ARCHS[arch]
    return mod.smoke_config() if smoke else mod.config()
