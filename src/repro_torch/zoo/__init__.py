"""``repro_torch.zoo``: the port of ``repro.zoo``, the LLM-era model zoo
(configs, models, serving), off the verification path.

Ported so far: the dense attention architectures (``qwen3-8b``,
``qwen2-7b``, ``gemma2-9b``, ``deepseek-67b``) and their serving path,
prefill and per-token decode; prefills of more than ``FLASH_THRESHOLD``
score elements run attention through the K8 flash kernel.  MoE, RWKV6,
RG-LRU and the encoder/cross-attention layers join with their
architectures later.
"""
