"""`repro_torch.mesh`: sharded streaming of partition plans over several
devices (port of ``repro/mesh``).

The paper's headline run (a 1,024-bit CSA multiplier, 134M nodes at
batch 16) leans on the fact that re-grown partitions are independent
until verdict aggregation — which makes the packed bucket batches of
``repro_torch.exec`` embarrassingly data-parallel.  This package shards
that stream across lanes, one a device of the data axis of
:func:`repro_torch.launch.mesh.make_host_mesh`:

  :mod:`repro_torch.mesh.plan`    MeshPlan — waves of same-bucket batches,
                                  round-robin over lanes
  :mod:`repro_torch.mesh.runner`  MeshRunner — per-lane params copy,
                                  stream, runner and worker thread; a wave
                                  dispatches every lane before waiting on any
  :mod:`repro_torch.mesh.stream`  ShardedStreamingExecutor — per-lane
                                  prefetch threads/queues, per-lane fault
                                  isolation, journal-composable resume

Lanes exchange nothing, so no collective runs.  On one host device every
path runs with an explicit lane list, ``MeshRunner(devices=["cpu"] * 4)``
or two lanes on one card.
"""
from repro_torch.mesh.plan import MeshPlan, Wave, build_mesh_plan
from repro_torch.mesh.runner import MeshRunner
from repro_torch.mesh.stream import (
    MeshStats,
    ShardedStreamingExecutor,
    shared_mesh_executor,
)

__all__ = [
    "MeshPlan",
    "MeshRunner",
    "MeshStats",
    "ShardedStreamingExecutor",
    "Wave",
    "build_mesh_plan",
    "shared_mesh_executor",
]
