"""Partitioned streaming execution (port of ``repro/exec``): run
arbitrarily large AIGs through bucketed, plan-cached, double-buffered
partition batches.

    EdgeGraph ──▶ PartitionPlan (partition + re-growth + pow-2 buckets,
               │   content-hash cached; choose_k picks k from a device
               │   memory budget)
               ├─▶ PackedBatch stream (capacity same-bucket subgraphs per
               │   disjoint-union launch; features staged by the prefetch
               │   thread)
               └─▶ StreamingExecutor (one padded forward per launch; core
                   predictions scattered back to global rows)

The layer the sharded route builds on: ``repro_torch.mesh`` runs the same
packed launches wave by wave over several devices' lanes.
"""
from repro_torch.exec.plan import (  # noqa: F401
    PartitionPlan,
    build_partition_plan,
    choose_k,
    choose_k_for_caps,
    plan_from_subgraphs,
)
from repro_torch.exec.packing import PackedBatch, pack_partitions  # noqa: F401
from repro_torch.exec.stream import (  # noqa: F401
    StreamingExecutor,
    StreamStats,
    stream_predict_partitioned,
)

__all__ = [
    "PartitionPlan", "build_partition_plan", "choose_k", "choose_k_for_caps",
    "plan_from_subgraphs", "PackedBatch", "pack_partitions",
    "StreamingExecutor", "StreamStats", "stream_predict_partitioned",
]
