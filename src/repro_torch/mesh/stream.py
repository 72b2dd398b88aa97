"""Sharded streaming: the multi-device twin of ``repro_torch.exec.stream``
(port of ``repro/mesh/stream.py``).

:class:`ShardedStreamingExecutor` drives a
:class:`~repro_torch.exec.plan.PartitionPlan` across the lanes of a
:class:`~repro_torch.mesh.runner.MeshRunner`.  One host prefetch thread per
*lane* packs that lane's batches into a bounded per-lane queue — the same
producer/watchdog discipline as the single-device executor, D times — while
the caller thread consumes wave by wave: one same-bucket packed batch per
active lane, launched together, core predictions scattered into the single
global verdict array.

The executor duck-types :class:`~repro_torch.exec.stream.StreamingExecutor`
(``run_plan(plan, features, gnn_cfg=, journal=)`` and a ``stats`` with
``.delta()``), so :func:`repro_torch.core.pipeline.infer_streaming` drives
it unchanged.  Crash-safe resume composes: journal commits are
per-*partition*, so a run killed under one lane count restores under any
other — the restored partitions are filtered out of the schedule BEFORE
waves are formed, and the remainder is re-balanced over the lanes of the
resumed run.

Blast-radius isolation: each lane's launch fires the ``"mesh.launch"`` fault
site and is replayed with seeded backoff on transient failures
(``retry_call`` of the port's ``distributed/fault_tolerance.py``) — a transient
on one lane never re-packs, re-runs, or poisons its sibling lanes' batches.

Instruments (``repro_torch.obs``, under the reference's names): the
``mesh.runner_compiles``, ``mesh.lane_retries``, ``mesh.bytes_h2d.d<d>`` and
``mesh.launches.d<d>`` counters, the ``mesh.pack_s`` and ``mesh.device_s``
histograms, the ``exec.device_utilization.d<d>`` gauges, the ``exec.*``
instruments the single-device executor also writes, and the ``mesh.stream``,
``mesh.pack`` and ``mesh.launch`` spans (the prefetch threads' pack spans
parent under the run's stream span).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Optional

import numpy as np

from repro_torch import faults
from repro_torch.exec.packing import PackedBatch, pack_partitions, scatter_core_predictions
from repro_torch.exec.plan import PartitionPlan
from repro_torch.exec.stream import StreamStats
from repro_torch.mesh.plan import MeshPlan, build_mesh_plan
from repro_torch.mesh.runner import MeshRunner
from repro_torch.obs import REGISTRY, current_tracer, span

from ..distributed.fault_tolerance import is_transient, retry_call


@dataclasses.dataclass
class MeshStats(StreamStats):
    """StreamStats plus the mesh-axis probes (cumulative across runs)."""

    devices: int = 0              # lanes of the last run's mesh
    waves: int = 0                # mesh-wide launches issued
    lane_launches: int = 0        # per-lane launches summed over waves
    idle_lane_slots: int = 0      # lane-waves with no work (imbalance)
    lane_retries: int = 0         # transient lane launches replayed

    def delta(self, before: "MeshStats") -> "MeshStats":
        base = super().delta(before)
        return MeshStats(
            **dataclasses.asdict(base),
            devices=self.devices,
            waves=self.waves - before.waves,
            lane_launches=self.lane_launches - before.lane_launches,
            idle_lane_slots=self.idle_lane_slots - before.idle_lane_slots,
            lane_retries=self.lane_retries - before.lane_retries,
        )


_SENTINEL = object()


class ShardedStreamingExecutor:
    """Streams partition plans wave-by-wave over the lanes of a mesh."""

    def __init__(
        self,
        params=None,
        backend: str = "ref",
        *,
        runner: Optional[MeshRunner] = None,
        num_devices: Optional[int] = None,
        capacity: int = 2,
        prefetch: int = 1,
        min_nodes: int = 64,
        min_edges: int = 128,
        stream_dtype: Optional[str] = None,
        launch_retries: int = 2,
        retry_backoff_s: float = 0.05,
        device=None,
    ):
        """Either ``params`` (a fresh :class:`MeshRunner` over
        ``num_devices`` of ``device``'s type, ``cuda`` unless named) or an
        existing ``runner``."""
        if runner is None:
            if params is None:
                raise ValueError("need params or a MeshRunner")
            runner = MeshRunner(
                params, backend, num_devices=num_devices,
                stream_dtype=stream_dtype, device=device,
            )
        self.runner = runner
        self.num_devices = runner.num_devices
        self.capacity = max(1, capacity)
        self.prefetch = max(0, prefetch)
        self.min_nodes = min_nodes
        self.min_edges = min_edges
        self.launch_retries = max(0, launch_retries)
        self.retry_backoff_s = retry_backoff_s
        self.stats = MeshStats(devices=self.num_devices)
        # D prefetch threads pack at once: their stats updates must not interleave
        self._pack_lock = threading.Lock()
        self.buckets_seen: set = set()

    # -- planning ------------------------------------------------------------

    def mesh_plan(self, plan: PartitionPlan,
                  schedule: Optional[list] = None) -> MeshPlan:
        return build_mesh_plan(
            plan, self.num_devices, self.capacity, schedule=schedule,
        )

    # -- execution -----------------------------------------------------------

    def run_plan(self, plan: PartitionPlan, features: np.ndarray,
                 gnn_cfg=None, journal=None) -> np.ndarray:
        """Stream every partition batch across the mesh; returns the same
        (num_nodes,) int32 global predictions the single-device executor
        produces — bit-identical, because each lane launches the identical
        packed forward the single-device route would have launched.  The
        lanes' held packed structures are released at the end.
        """
        t_wall = time.perf_counter()
        schedule = plan.schedule(self.capacity)
        self.buckets_seen.update(plan.buckets)
        if gnn_cfg is not None:
            modeled = plan.peak_batch_memory_bytes(gnn_cfg, self.capacity)
            self.stats.modeled_peak_bytes = max(
                self.stats.modeled_peak_bytes, modeled
            )
            REGISTRY.gauge("exec.modeled_peak_bytes").set(modeled)
        out = np.zeros(plan.num_nodes, dtype=np.int32)
        if journal is not None:
            restored = journal.restore(plan, out)
            if restored:
                schedule = [
                    (shape, kept)
                    for shape, indices in schedule
                    if (kept := [i for i in indices if i not in restored])
                ]
                self.stats.resumed_partitions += len(restored)
                REGISTRY.counter("exec.resumed_partitions").inc(len(restored))
        mplan = self.mesh_plan(plan, schedule)
        compiles_before = self.runner.compile_count
        tracer = current_tracer()
        D = self.num_devices

        try:
            with tracer.span(
                "mesh.stream",
                partitions=plan.num_parts,
                waves=len(mplan.waves),
                devices=D,
            ) as stream_sp:
                if self.prefetch == 0 or len(mplan.waves) <= 1:
                    for wave in mplan.waves:
                        staged = [
                            self._pack_timed(plan, lane, features, wave.shape, d)
                            if lane is not None else None
                            for d, lane in enumerate(wave.lanes)
                        ]
                        self._launch_wave(wave, staged, out, gnn_cfg, journal)
                else:
                    self._run_prefetched(
                        mplan, plan, features, out, gnn_cfg, journal,
                        stream_sp.span_id, tracer,
                    )
        finally:
            self.runner.release()

        if journal is not None:
            journal.complete()

        self.stats.runs += 1
        self.stats.waves += len(mplan.waves)
        idle = sum(D - w.active for w in mplan.waves)
        self.stats.idle_lane_slots += idle
        run_compiles = self.runner.compile_count - compiles_before
        self.stats.compiles += run_compiles
        wall = time.perf_counter() - t_wall
        self.stats.wall_s += wall
        for d, util in enumerate(mplan.utilization):
            REGISTRY.gauge(f"exec.device_utilization.d{d}").set(util)
        REGISTRY.counter("exec.runs").inc()
        REGISTRY.counter("exec.compiles").inc(run_compiles)
        REGISTRY.histogram("exec.wall_s").observe(wall)
        return out

    # -- internals -----------------------------------------------------------

    def _run_prefetched(self, mplan: MeshPlan, plan, features, out,
                        gnn_cfg, journal, stream_id, tracer) -> None:
        """One producer thread + bounded queue per lane; the caller thread
        consumes wave-aligned: a lane's queue yields its batches in wave
        order, so wave *w* pops exactly the lanes active in *w*."""
        D = self.num_devices
        queues = [queue.Queue(maxsize=max(1, self.prefetch)) for _ in range(D)]
        stop = threading.Event()

        def _put(q, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _producer(d: int):
            with tracer.adopt(stream_id):
                q = queues[d]
                try:
                    for wave in mplan.waves:
                        lane = wave.lanes[d]
                        if lane is None:
                            continue
                        faults.fire(
                            "exec.prefetch",
                            tag=lambda: f"lane={d} parts={len(lane)}",
                        )
                        if not _put(q, self._pack_timed(
                            plan, lane, features, wave.shape, d
                        )):
                            return
                    _put(q, _SENTINEL)
                except faults.WorkerKilled:
                    return       # abrupt death: the watchdog must catch it
                except BaseException as e:  # noqa: BLE001 — forwarded
                    _put(q, e)

        threads = [
            threading.Thread(
                target=_producer, args=(d,), name=f"mesh-prefetch-{d}",
                daemon=True,
            )
            for d in range(D)
        ]
        for th in threads:
            th.start()
        try:
            for wave in mplan.waves:
                staged: list = [None] * D
                for d, lane in enumerate(wave.lanes):
                    if lane is None:
                        continue
                    depth = queues[d].qsize()
                    self.stats.max_queue_depth = max(
                        self.stats.max_queue_depth, depth
                    )
                    got = self._next_batch(queues[d], threads[d], d)
                    if isinstance(got, BaseException):
                        raise got
                    staged[d] = got
                self._launch_wave(wave, staged, out, gnn_cfg, journal)
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=60.0)

    @staticmethod
    def _next_batch(q: queue.Queue, th: threading.Thread, lane: int):
        """Per-lane producer watchdog (see StreamingExecutor._next_batch)."""
        while True:
            try:
                got = q.get(timeout=0.2)
            except queue.Empty:
                if not th.is_alive():
                    REGISTRY.counter("exec.prefetch_deaths").inc()
                    raise RuntimeError(
                        f"mesh prefetch thread for lane {lane} died without "
                        f"delivering a batch or an error "
                        f"(see exec.prefetch_deaths)"
                    ) from None
                continue
            if got is _SENTINEL:
                raise RuntimeError(
                    f"lane {lane} queue exhausted before its wave schedule"
                )
            return got

    def _pack_timed(self, plan, indices, features, shape,
                    lane: int) -> PackedBatch:
        t0 = time.perf_counter()
        with span("mesh.pack", lane=lane, parts=len(indices)) as sp:
            batch = pack_partitions(
                plan, indices, features, shape, self.capacity,
                keyed=self.runner.structure_keyed,
            )
            sp.set(bytes=batch.nbytes)
        dt = time.perf_counter() - t0
        with self._pack_lock:
            self.stats.pack_s += dt
            self.stats.bytes_h2d += batch.nbytes
        REGISTRY.counter("exec.bytes_h2d").inc(batch.nbytes)
        REGISTRY.counter(f"mesh.bytes_h2d.d{lane}").inc(batch.nbytes)
        REGISTRY.histogram("mesh.pack_s").observe(dt)
        return batch

    def _launch_wave(self, wave, staged: list, out: np.ndarray,
                     gnn_cfg, journal) -> None:
        """One mesh-wide launch with per-lane fault/retry isolation."""
        active = [d for d, b in enumerate(staged) if b is not None]
        if not active:
            return
        if gnn_cfg is not None:
            from repro_torch.core.pipeline import memory_model_bytes

            b0 = staged[active[0]]
            actual = memory_model_bytes(
                int(b0.arrays["x"].shape[0]),
                int(b0.arrays["edge_src"].shape[0]),
                gnn_cfg,
            )
            self.stats.actual_peak_bytes = max(
                self.stats.actual_peak_bytes, actual
            )
            REGISTRY.gauge("exec.actual_peak_bytes").set(actual)

        def _retried(attempt, err):
            self.stats.lane_retries += 1
            REGISTRY.counter("mesh.lane_retries").inc()

        t0 = time.perf_counter()
        with span("mesh.launch", wave_active=len(active)):
            # per-lane fire + replay: a transient injected on one lane is
            # retried in isolation — the sibling lanes' staged batches are
            # untouched, and the wave launches once every lane is clear
            for d in active:
                batch = staged[d]
                retry_call(
                    lambda d=d, batch=batch: faults.fire(
                        "mesh.launch",
                        tag=lambda: f"lane={d} parts={len(batch.items)} "
                                    f"shape={batch.shape}",
                    ),
                    retries=self.launch_retries,
                    seed=(id(self), d),
                    base_s=self.retry_backoff_s,
                    should_retry=is_transient,
                    on_retry=_retried,
                )
            preds = retry_call(
                lambda: self.runner.launch_wave(
                    [b.arrays if b is not None else None for b in staged],
                    [b.gkeys if b is not None else None for b in staged],
                ),
                retries=self.launch_retries,
                seed=id(self),
                base_s=self.retry_backoff_s,
                should_retry=is_transient,
                on_retry=_retried,
            )
        dt = time.perf_counter() - t0
        self.stats.device_s += dt
        REGISTRY.histogram("mesh.device_s").observe(dt)
        for d in active:
            batch, pred = staged[d], preds[d]
            self.stats.launches += 1
            self.stats.lane_launches += 1
            self.stats.batches += 1
            self.stats.partitions += len(batch.items)
            self.stats.core_rows += scatter_core_predictions(out, batch, pred)
            REGISTRY.counter("exec.launches").inc()
            REGISTRY.counter(f"mesh.launches.d{d}").inc()
            if journal is not None:
                # same per-partition durability as the single-device path:
                # a crash between waves loses at most the in-flight wave
                for idx, it in zip(batch.indices, batch.items):
                    ids = it.global_ids[: it.num_core]
                    journal.commit(int(idx), ids, out[ids])


#: identity-keyed reuse pool, mirroring ``exec.stream._EXECUTOR_POOL``: one
#: executor (its lanes' params copies, runners and compile probe) per
#: (params identity, knobs, lane devices)
_MESH_POOL: dict[tuple, tuple[object, "ShardedStreamingExecutor"]] = {}
_MESH_POOL_MAX = 8


def shared_mesh_executor(
    params, backend: str, *, num_devices: Optional[int] = None,
    capacity: int = 2, prefetch: int = 1,
    stream_dtype: Optional[str] = None,
    min_nodes: int = 64, min_edges: int = 128,
    launch_retries: int = 2, retry_backoff_s: float = 0.05,
    device=None,
) -> ShardedStreamingExecutor:
    """The process-wide sharded executor for (params identity, knobs, the
    lane devices ``num_devices`` of ``device``'s type resolve to)."""
    from repro_torch.launch import mesh as M

    if stream_dtype == "float32":
        stream_dtype = None
    visible = M.visible_devices(device)
    lanes = tuple(str(d) for d in visible[: len(visible) if num_devices is None
                                          else num_devices])
    key = (id(params), backend, num_devices, capacity, prefetch,
           stream_dtype, min_nodes, min_edges, launch_retries, lanes)
    hit = _MESH_POOL.get(key)
    if hit is not None and hit[0] is params:
        return hit[1]
    ex = ShardedStreamingExecutor(
        params, backend, num_devices=num_devices, capacity=capacity,
        prefetch=prefetch, stream_dtype=stream_dtype,
        min_nodes=min_nodes, min_edges=min_edges,
        launch_retries=launch_retries, retry_backoff_s=retry_backoff_s,
        device=device,
    )
    if len(_MESH_POOL) >= _MESH_POOL_MAX:
        _MESH_POOL.clear()
    _MESH_POOL[key] = (params, ex)
    return ex
