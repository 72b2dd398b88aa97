"""`SessionConfig`: the port's session configuration (port of
``repro/api/config.py``: the fields the full-graph and partitioned routes
read, the streamed route's knobs that decide routing, plus ``device``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.gnn import GNNConfig


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Knobs of the full-graph and partitioned verification routes."""

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
    # -- partitioning / re-growth (paper §III-C, Algorithm 1) ---------------
    num_partitions: int = 1
    regrow: bool = True
    regrow_hops: int = 1
    partitioner: str = "multilevel"
    #: route partitioned designs through the streaming executor (True, the
    #: reference's default; not ported yet, so a partition count or a budget
    #: raises) or the sequential per-subgraph loop (False)
    streaming: bool = True
    #: device budget: lets prepare() derive the partition count via
    #: choose_k when num_partitions is not set explicitly
    memory_budget_bytes: Optional[int] = None
    #: partitions per modeled launch (choose_k's and the plan's memory model)
    stream_capacity: int = 2
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
            regrow=self.regrow,
            regrow_hops=self.regrow_hops,
            partitioner=self.partitioner,
            gnn=self.gnn,
            backend=self.backend,
            seed=self.seed if seed is None else seed,
            memory_budget_bytes=self.memory_budget_bytes,
            stream_capacity=self.stream_capacity,
            stream_dtype=self.stream_dtype,
        )
