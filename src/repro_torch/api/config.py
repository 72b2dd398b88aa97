"""`SessionConfig`: the port's session configuration (port of
``repro/api/config.py``): the knobs of the full-graph, partitioned, streamed
and batched-service routes, observability, failure domains and the
crash-resume journal, plus ``device``.  :meth:`SessionConfig.pipeline_config`
and :meth:`SessionConfig.service_config` derive the per-layer configs."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.gnn import GNNConfig
from repro_torch.core.pipeline import resolve_backend_alias  # noqa: F401 — re-export


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Every knob of the full/partitioned/streamed/batched stack, flat."""

    # design defaults (per-call ``verify(dataset=, bits=, seed=)`` win)
    dataset: str = "csa"
    bits: int = 32
    seed: int = 0
    batch: int = 1
    #: aggregation backend: "ref" | "onehot" | "groot" | "groot_mxu" |
    #: "groot_fused" (onehot materialises an (E, N) one-hot: small designs).
    #: None means "ref"; ``aggregate=`` is the deprecated alias
    backend: Optional[str] = None
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
    #: of the session's device type, 1 = one device; more than one takes
    #: the sharded route (mode "sharded", ``repro_torch.mesh``)
    mesh_devices: Optional[int] = None
    # -- batched service (repro_torch.service; the submit()/poll() path) ----
    #: same-bucket items packed per device call
    capacity: int = 2
    #: bucket floors (the smallest padded slot shape), also of the streamed plan
    min_nodes: int = 64
    min_edges: int = 128
    #: structure-keyed backends: packed structures a runner remembers
    max_structures: int = 64
    #: bucket ceilings: a larger request is partitioned and streamed
    max_bucket_nodes: Optional[int] = None
    max_bucket_edges: Optional[int] = None
    prepare_workers: int = 2
    max_batch_requests: int = 16
    max_done_retained: int = 4096
    #: warmup: run the (n_pad, e_pad) bucket grid at engine construction so
    #: no submit() meets a signature first.  warmup_shapes pins the grid;
    #: None derives a diagonal one from the bucket bounds.
    warmup: bool = False
    warmup_shapes: Optional[tuple] = None
    #: in-flight coalescing: concurrent same-key submissions share one
    #: execution (followers finish from the leader's result, cached=True)
    coalesce: bool = True
    #: per-tenant admission cap — submit(tenant=...) raises AdmissionError
    #: past this many unfinished requests (None = unlimited)
    max_inflight_per_tenant: Optional[int] = None
    # -- observability (repro_torch.obs) --------------------------------------
    #: record a span tracer around every ``verify()`` (Chrome-trace
    #: exportable via ``Session.save_trace`` / ``SessionResult.trace``).
    #: Not part of ``cache_key_part``: tracing never changes results.
    trace: bool = False
    #: flight recorder: last N per-ticket records kept in the session ring
    #: (``Session.flights()`` / ``stats()["flights"]``)
    flight_records: int = 256
    #: where failed tickets dump their flight record as JSON (None: fall
    #: back to $REPRO_FLIGHT_DUMP_DIR, else no dump)
    flight_dump_dir: Optional[str] = None
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
    #: default per-ticket wall-clock budget (seconds) for the service path;
    #: expired tickets fail with DeadlineExceeded.  None = no deadline;
    #: per-submit ``deadline_s=`` overrides win
    deadline_s: Optional[float] = None
    #: transient device-launch failures replayed per ticket (exponential
    #: backoff, seeded jitter) before the failure is surfaced
    launch_retries: int = 2
    retry_backoff_s: float = 0.05
    #: crash-safe resume for streamed runs: journal per-partition core
    #: predictions under this directory (keyed by the design's structural
    #: hash); ``resume=False`` wipes any prior journal instead of restoring it
    checkpoint_dir: Optional[str] = None
    resume: bool = True

    #: deprecated write-only alias of ``backend`` — consumed (and reset to
    #: None) at construction
    aggregate: Optional[str] = None

    def __post_init__(self):
        backend = resolve_backend_alias(self.backend, self.aggregate, owner="SessionConfig")
        object.__setattr__(self, "backend", backend)
        object.__setattr__(self, "aggregate", None)

    def replace(self, **overrides) -> "SessionConfig":
        return dataclasses.replace(self, **overrides)

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

    def service_config(self):
        """The ``ServiceConfig`` view (what the batched engine reads)."""
        from repro_torch.service.server import ServiceConfig

        return ServiceConfig(
            num_partitions=self.num_partitions,
            regrow=self.regrow,
            partitioner=self.partitioner,
            backend=self.backend,
            capacity=self.capacity,
            max_structures=self.max_structures,
            min_nodes=self.min_nodes,
            min_edges=self.min_edges,
            max_bucket_nodes=self.max_bucket_nodes,
            max_bucket_edges=self.max_bucket_edges,
            stream_capacity=self.stream_capacity,
            prepare_workers=self.prepare_workers,
            cache_capacity=self.cache_capacity,
            max_batch_requests=self.max_batch_requests,
            max_done_retained=self.max_done_retained,
            stream_dtype=self.stream_dtype,
            warmup=self.warmup,
            warmup_shapes=self.warmup_shapes,
            coalesce=self.coalesce,
            max_inflight_per_tenant=self.max_inflight_per_tenant,
            flight_records=self.flight_records,
            flight_dump_dir=self.flight_dump_dir,
            deadline_s=self.deadline_s,
            launch_retries=self.launch_retries,
            retry_backoff_s=self.retry_backoff_s,
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
