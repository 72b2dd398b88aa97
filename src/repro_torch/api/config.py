"""`SessionConfig`: the port's session configuration (port of
``repro/api/config.py``: the fields the full-graph, partitioned and
streamed routes, the result cache, the crash-resume journal and the fault
plan read, plus ``device``; the batched service's and tracing fields wait
for the routes that read them, ROADMAP Queue 1, item 6)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.gnn import GNNConfig


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Knobs of the full-graph, partitioned and streamed verification routes."""

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
    #: default) or the sequential per-subgraph loop (False)
    streaming: bool = True
    #: device budget: lets prepare() derive the partition count via
    #: choose_k when num_partitions is not set explicitly
    memory_budget_bytes: Optional[int] = None
    #: same-bucket partitions packed per launch
    stream_capacity: int = 2
    #: packed batches the prefetch thread stages ahead of the device (0:
    #: pack and launch in turn on the caller's thread)
    stream_prefetch: int = 1
    #: devices the streamed route shards over: None = every visible device
    #: of the session's device type, 1 = one device; more than one asks for
    #: the sharded route, which raises (ROADMAP Queue 1, item 7)
    mesh_devices: Optional[int] = None
    #: bucket floors of the streamed plan (the smallest padded slot shape)
    min_nodes: int = 64
    min_edges: int = 128
    #: where inference runs: None means ``cuda`` (and raises without a CUDA
    #: device); "cpu" runs every kernel wrapper's plain PyTorch version
    device: Optional[str] = None
    #: entries of the structural-hash result LRU (``Session.results``)
    cache_capacity: int = 1024
    # -- failure domains (repro_torch.faults) --------------------------------
    #: fault-injection plan for chaos runs: a :class:`repro_torch.faults.
    #: FaultPlan` or its spec string (``"site:p=0.1,kind=transient;..."``).
    #: Installed process-wide when the Session is constructed; None leaves
    #: whatever ``$REPRO_FAULT_PLAN`` installed.  Not in ``cache_key_part``:
    #: faults perturb execution, not the verdict a run would produce.
    fault_plan: Optional[object] = None
    #: crash-safe resume for streamed runs: journal per-partition core
    #: predictions under this directory (keyed by the design's structural
    #: hash); ``resume=False`` wipes any prior journal instead of restoring it
    checkpoint_dir: Optional[str] = None
    resume: bool = True

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
            stream_prefetch=self.stream_prefetch,
            stream_dtype=self.stream_dtype,
            mesh_devices=self.mesh_devices,
            checkpoint_dir=self.checkpoint_dir,
            resume=self.resume,
        )

    def cache_key_part(self) -> tuple:
        """Everything outcome-relevant for the session result LRU."""
        return (
            self.backend, self.stream_dtype, self.gnn, self.batch,
            self.num_partitions, self.regrow, self.regrow_hops,
            self.partitioner, self.streaming, self.memory_budget_bytes,
            self.stream_capacity, self.min_nodes, self.min_edges,
            self.mesh_devices,
        )
