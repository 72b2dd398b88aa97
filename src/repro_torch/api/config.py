"""`SessionConfig`: the port's session configuration (port of
``repro/api/config.py``, the fields the full-graph route reads plus
``device``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.gnn import GNNConfig


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Knobs of the full-graph verification route."""

    # design defaults (per-call ``verify(dataset=, bits=, seed=)`` win)
    dataset: str = "csa"
    bits: int = 32
    seed: int = 0
    batch: int = 1
    #: aggregation backend: "ref" | "onehot" | "groot" | "groot_mxu" |
    #: "groot_fused" (onehot materialises an (E, N) one-hot: small designs)
    backend: str = "ref"
    #: staged edge-stream dtype for the hoisted groot* forward (None/f32 or
    #: "bfloat16"; kernels accumulate in f32)
    stream_dtype: Optional[str] = None
    gnn: GNNConfig = dataclasses.field(default_factory=GNNConfig)
    #: a partition count > 1 or a device budget asks for the partitioned /
    #: streamed routes, which are not ported yet (they raise)
    num_partitions: int = 1
    memory_budget_bytes: Optional[int] = None
    #: where inference runs: None means ``cuda`` (and raises without a CUDA
    #: device); "cpu" runs every kernel wrapper's plain PyTorch version
    device: Optional[str] = None

    def pipeline_config(
        self,
        *,
        dataset: Optional[str] = None,
        bits: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        """The ``PipelineConfig`` view (what prepare/infer/verify read)."""
        from repro_torch.core import pipeline as P

        return P.PipelineConfig(
            dataset=self.dataset if dataset is None else dataset,
            bits=self.bits if bits is None else bits,
            batch=self.batch,
            num_partitions=self.num_partitions,
            gnn=self.gnn,
            backend=self.backend,
            seed=self.seed if seed is None else seed,
            memory_budget_bytes=self.memory_budget_bytes,
            stream_dtype=self.stream_dtype,
        )
