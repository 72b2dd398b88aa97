"""PyTorch/CUDA port of the GROOT verification stack (reference: ``repro``).

Mirrors ``repro``'s layout module for module (``repro_torch/core/gnn.py`` <->
``repro/core/gnn.py``) and imports nothing of it.  The full-graph
``Session.verify`` route runs on an NVIDIA H100 on all five aggregation
backends of the reference (``ref``, ``onehot``, ``groot``, ``groot_mxu``,
``groot_fused``) through seven hand-written CUDA kernels (``csrc/``): K1
grouped LD, K2 grouped HD, K3 grouped fused LD + matmul, K4 grouped LD on
the tensor cores, K5 ungrouped LD, K6 ungrouped HD, K7 ungrouped fused LD +
matmul.  ``repro_torch.zoo`` and ``repro_torch.launch.serve`` carry the
reference's dense LLM serving path (prefill + decode through
``BatchServer``), whose prefills run attention through K8, a flash-attention
kernel.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.
"""
from __future__ import annotations

import torch

# The reference computes in full f32 throughout.  PyTorch leaves f32 matmuls
# in full precision by default but lets cuDNN use TF32 (about three decimal
# digits); pin both off so the port's dense products match the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  There is no quiet CPU path — with no CUDA device and no
    explicit ``device="cpu"`` this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
