"""Mesh execution plans: sharding a partition stream across devices (port
of ``repro/mesh/plan.py``).

A :class:`MeshPlan` is the device-axis view of a
:class:`~repro_torch.exec.plan.PartitionPlan`: the same bucketed batch
schedule the single-device streaming executor runs, regrouped into *waves*
of up to ``num_devices`` same-bucket packed launches.  Wave ``w`` of a
bucket holds that bucket's batches ``[w*D, (w+1)*D)`` — i.e. batch ``j``
lands on lane ``j % D`` (round-robin), so the load difference between any
two lanes is at most one batch per bucket.

Every batch in a wave shares the bucket's canonical padded shapes
(``capacity`` slots of ``(n_pad, e_pad)``), so every lane of a wave runs the
same padded forward on its own packed arrays: the compile unit stays per
*bucket*, shared by every device.

Partitions stay independent until the core-prediction scatter (GROOT
Alg. 1), so the assignment is pure load balancing: no lane ever needs
another lane's rows, and a :class:`~repro_torch.checkpoint.PartitionJournal`
restored under a different device count simply shrinks the schedule the
waves are built from.  Pure host code.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.exec.plan import PartitionPlan
from repro_torch.service.bucketing import BucketShape


@dataclasses.dataclass(frozen=True)
class Wave:
    """One mesh-wide launch: up to ``num_devices`` same-bucket batches.

    ``lanes[d]`` is the list of plan subgraph indices lane ``d`` packs for
    this wave, or ``None`` when the lane idles (the bucket's batch count
    is not a multiple of the device count).
    """

    shape: BucketShape
    lanes: tuple[Optional[list], ...]

    @property
    def active(self) -> int:
        return sum(1 for l in self.lanes if l is not None)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Device-sharded schedule for one partition plan (immutable)."""

    plan: PartitionPlan
    num_devices: int
    capacity: int
    waves: tuple[Wave, ...]

    @property
    def num_buckets(self) -> int:
        return self.plan.num_buckets

    @property
    def total_batches(self) -> int:
        return sum(w.active for w in self.waves)

    @property
    def lane_batches(self) -> tuple[int, ...]:
        """Packed launches per lane — the balance the round-robin buys."""
        counts = [0] * self.num_devices
        for w in self.waves:
            for d, lane in enumerate(w.lanes):
                if lane is not None:
                    counts[d] += 1
        return tuple(counts)

    @property
    def modeled_speedup(self) -> float:
        """Launch-balance speedup over one device: total batches over the
        busiest lane's batches.  This is the *modeled-launch* metric the
        sharded benchmark gates — host CPU "devices" share physical
        cores, so wall time cannot witness the scaling the assignment
        achieves; the lane balance can."""
        busiest = max(self.lane_batches, default=0)
        return self.total_batches / busiest if busiest else 1.0

    @property
    def utilization(self) -> tuple[float, ...]:
        """Per-lane occupancy: fraction of waves the lane had real work."""
        if not self.waves:
            return tuple(0.0 for _ in range(self.num_devices))
        per = [0] * self.num_devices
        for w in self.waves:
            for d, lane in enumerate(w.lanes):
                per[d] += lane is not None
        return tuple(c / len(self.waves) for c in per)

    def per_device_peak_bytes(self, gnn_cfg) -> int:
        """Modeled device bytes of the largest packed launch ONE lane
        holds — identical to the single-device packed peak, because every
        lane launches the same canonical bucket shapes."""
        return self.plan.peak_batch_memory_bytes(gnn_cfg, self.capacity)

    def describe(self) -> str:
        """The mesh decision, the way ``Session.explain()`` reports it."""
        return (
            f"{self.num_devices} device(s) x k={self.plan.k} x "
            f"{self.num_buckets} bucket(s), {self.total_batches} packed "
            f"batches in {len(self.waves)} wave(s), "
            f"modeled launch speedup {self.modeled_speedup:.2f}x"
        )


def build_mesh_plan(
    plan: PartitionPlan,
    num_devices: int,
    capacity: int,
    *,
    schedule: Optional[list] = None,
) -> MeshPlan:
    """Regroup a plan's batch schedule into device waves.

    ``schedule`` overrides ``plan.schedule(capacity)`` — the sharded
    executor passes the journal-filtered schedule of a resumed run, so
    already-committed partitions never occupy a lane.
    """
    if num_devices < 1:
        raise ValueError(f"need at least one device, got {num_devices}")
    if schedule is None:
        schedule = plan.schedule(capacity)
    # schedule is bucket-major (ascending shape): chunk each bucket's
    # contiguous batch run into waves of num_devices lanes
    waves: list[Wave] = []
    i = 0
    while i < len(schedule):
        shape = schedule[i][0]
        j = i
        while j < len(schedule) and schedule[j][0] == shape:
            j += 1
        batches = [indices for _, indices in schedule[i:j]]
        for at in range(0, len(batches), num_devices):
            chunk = batches[at : at + num_devices]
            chunk += [None] * (num_devices - len(chunk))
            waves.append(Wave(shape=shape, lanes=tuple(chunk)))
        i = j
    return MeshPlan(
        plan=plan, num_devices=num_devices, capacity=capacity,
        waves=tuple(waves),
    )
