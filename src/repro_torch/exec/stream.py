"""Double-buffered streaming execution of partition plans (port of
``repro/exec/stream.py``).

:class:`StreamingExecutor` turns a :class:`~repro_torch.exec.plan.PartitionPlan`
into a stream of packed launches through one padded forward
(:class:`~repro_torch.service.scheduler.BucketRunner`):

    host prefetch thread                 device (caller thread)
    --------------------                 ----------------------
    pack batch 0  ──queue──▶
    pack batch 1  ──queue──▶             run batch 0, scatter cores
    pack batch 2  ──queue──▶             run batch 1, scatter cores
    ...                                  ...

While the device runs batch *i*, the prefetch thread gathers and pads
batch *i+1*'s features (and, for the structure-keyed ``groot*`` backends,
hashes its packed structure for the plan cache).  The queue depth
(``prefetch``) bounds host memory: the host footprint is O(batch), not
O(design).

Compile discipline: the reference compiles one executable per bucket on the
shape-stable backends ("ref"/"onehot"), so a streamed run compiles at most
``plan.num_buckets`` programs, and per distinct packed structure on the
``groot*`` backends.  The port has no jit; ``StreamStats.compiles`` counts
what the reference would trace (first sight of a packed signature) on the
shape-stable backends and host plan builds on the structure-keyed ones: a
recurring structure builds nothing.

Crash resume: ``run_plan(..., journal=)`` takes a
:class:`~repro_torch.checkpoint.PartitionJournal`, restores the partitions
it committed before the schedule runs, skips them, and commits each
launch's core predictions after its scatter.

Instruments (``repro_torch.obs``, under the reference's names): the
``exec.runs``/``exec.compiles``/``exec.launches``/``exec.bytes_h2d``/
``exec.resumed_partitions``/``exec.capacity_halvings``/``exec.prefetch_deaths``
counters, the ``exec.queue_depth``/``exec.*_peak_bytes``/
``exec.effective_capacity`` gauges and the ``exec.*_s`` histograms of the
process-wide ``REGISTRY``, and the ``exec.stream``/``exec.pack``/
``exec.launch`` spans (the prefetch thread's pack spans parent under the
run's stream span).  :class:`StreamStats` keeps the per-executor numbers.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Optional

import numpy as np

from repro_torch import faults
from repro_torch.core.graph import EdgeGraph
from repro_torch.core.regrowth import Subgraph
from repro_torch.exec.packing import PackedBatch, pack_partitions, scatter_core_predictions
from repro_torch.exec.plan import PartitionPlan, build_partition_plan, plan_from_subgraphs
from repro_torch.obs import REGISTRY, current_tracer, span
from repro_torch.service.scheduler import BucketRunner


@dataclasses.dataclass
class StreamStats:
    """Probe counters for one executor (cumulative across runs)."""

    runs: int = 0                 # run_plan invocations
    batches: int = 0              # packed launches issued
    partitions: int = 0           # subgraphs streamed
    core_rows: int = 0            # core predictions scattered
    compiles: int = 0             # see the module docstring
    launches: int = 0             # device calls
    bytes_h2d: int = 0            # staged host->device transfer bytes
    pack_s: float = 0.0           # host packing time (prefetch thread)
    device_s: float = 0.0         # device execution + readback time
    wall_s: float = 0.0           # end-to-end streamed time
    max_queue_depth: int = 0      # prefetch occupancy high-water mark
    # failure-domain counters: launches replayed at reduced pack capacity
    # after a device resource error, and partitions skipped on a resumed
    # run because a journal already held their core predictions
    capacity_halvings: int = 0
    resumed_partitions: int = 0
    # model-vs-actual memory accounting (high-water marks): what the plan
    # modeled as the packed-launch peak vs the model evaluated on the
    # REAL launched padded shapes — the validation loop for choose_k
    modeled_peak_bytes: int = 0
    actual_peak_bytes: int = 0

    @property
    def overlap_s(self) -> float:
        """Host pack time hidden behind device execution."""
        return max(0.0, self.pack_s + self.device_s - self.wall_s)

    def delta(self, before: "StreamStats") -> "StreamStats":
        """Per-run view: this (cumulative) snapshot minus ``before``.
        High-water marks (``max_queue_depth``, ``*_peak_bytes``) keep the
        later value — a peak has no meaningful difference."""
        return StreamStats(
            runs=self.runs - before.runs,
            batches=self.batches - before.batches,
            partitions=self.partitions - before.partitions,
            core_rows=self.core_rows - before.core_rows,
            compiles=self.compiles - before.compiles,
            launches=self.launches - before.launches,
            bytes_h2d=self.bytes_h2d - before.bytes_h2d,
            pack_s=self.pack_s - before.pack_s,
            device_s=self.device_s - before.device_s,
            wall_s=self.wall_s - before.wall_s,
            capacity_halvings=self.capacity_halvings - before.capacity_halvings,
            resumed_partitions=self.resumed_partitions - before.resumed_partitions,
            max_queue_depth=self.max_queue_depth,
            modeled_peak_bytes=self.modeled_peak_bytes,
            actual_peak_bytes=self.actual_peak_bytes,
        )


_SENTINEL = object()


class StreamingExecutor:
    """Drives partition plans through bucketed, double-buffered launches."""

    def __init__(
        self,
        params=None,
        backend: str = "ref",
        *,
        runner: Optional[BucketRunner] = None,
        capacity: int = 2,
        prefetch: int = 1,
        min_nodes: int = 64,
        min_edges: int = 128,
        stream_dtype: Optional[str] = None,
        device=None,
    ):
        """Either ``params`` (a :class:`~repro_torch.core.gnn.GrootGNN`; a
        fresh runner is built on ``device``, ``cuda`` unless named) or an
        existing ``runner``."""
        if runner is None:
            if params is None:
                raise ValueError("need params or a BucketRunner")
            runner = BucketRunner(params, backend, stream_dtype=stream_dtype, device=device)
        self.runner = runner
        self.capacity = max(1, capacity)
        self.prefetch = max(0, prefetch)
        self.min_nodes = min_nodes
        self.min_edges = min_edges
        self.stats = StreamStats()
        # the prefetch thread and, after a capacity halving, the caller's
        # thread both pack: their stats updates must not interleave
        self._pack_lock = threading.Lock()
        #: every distinct bucket shape streamed through this executor — the
        #: denominator of the compile-count probe (for shape-stable
        #: backends, runner.compile_count <= len(buckets_seen))
        self.buckets_seen: set = set()

    # -- plan construction helpers ------------------------------------------

    def plan_graph(
        self,
        graph: EdgeGraph,
        k: int,
        *,
        regrow: bool = True,
        hops: int = 1,
        partitioner: str = "multilevel",
        seed: int = 0,
    ) -> PartitionPlan:
        return build_partition_plan(
            graph, k, regrow=regrow, hops=hops, partitioner=partitioner,
            seed=seed, min_nodes=self.min_nodes, min_edges=self.min_edges,
        )

    # -- execution ----------------------------------------------------------

    def run_plan(self, plan: PartitionPlan, features: np.ndarray,
                 gnn_cfg=None, journal=None) -> np.ndarray:
        """Stream every partition batch; returns (num_nodes,) int32 global
        predictions with every core row written (halo rows are computed
        under their owning partition).

        ``gnn_cfg`` enables model-vs-actual memory accounting: the plan's
        modeled packed-launch peak and the same analytic model evaluated on
        every REAL launched padded shape land in ``stats``.  The runner's
        device copies of the last packed structure are released at the end.

        ``journal`` (a :class:`repro_torch.checkpoint.PartitionJournal`)
        makes the run crash-safe: each launched partition's core predictions
        are committed as they land, previously committed partitions are
        restored into ``out`` and dropped from the schedule, and the journal
        is cleared once every partition has been written.
        """
        t_wall = time.perf_counter()
        schedule = plan.schedule(self.capacity)
        self.buckets_seen.update(plan.buckets)
        if gnn_cfg is not None:
            modeled = plan.peak_batch_memory_bytes(gnn_cfg, self.capacity)
            self.stats.modeled_peak_bytes = max(self.stats.modeled_peak_bytes, modeled)
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
        compiles_before = self.runner.compile_count
        tracer = current_tracer()
        # per-run degradation state: a device resource error halves the
        # effective pack capacity for the REST of this run (mutated by
        # _launch_degradable), so one undersized device doesn't turn every
        # remaining batch into its own failure
        degrade = {"cap": self.capacity}
        try:
            with tracer.span("exec.stream", partitions=plan.num_parts,
                             batches=len(schedule)) as stream_sp:
                if self.prefetch == 0 or len(schedule) <= 1:
                    # synchronous path (also the degenerate 0/1-batch case)
                    for shape, indices in schedule:
                        batch = self._pack_timed(plan, indices, features, shape)
                        self._launch_degradable(plan, batch, out, features, gnn_cfg,
                                                degrade, journal)
                else:
                    self._run_prefetched(plan, schedule, out, features, gnn_cfg, degrade,
                                         journal, tracer, stream_sp.span_id)
        finally:
            self.runner.release()
        if journal is not None:
            journal.complete()

        self.stats.runs += 1
        # delta, not the runner's cumulative count: a shared runner's
        # earlier work must not be attributed to this stream
        run_compiles = self.runner.compile_count - compiles_before
        self.stats.compiles += run_compiles
        wall = time.perf_counter() - t_wall
        self.stats.wall_s += wall
        REGISTRY.counter("exec.runs").inc()
        REGISTRY.counter("exec.compiles").inc(run_compiles)
        REGISTRY.histogram("exec.wall_s").observe(wall)
        return out

    def _run_prefetched(self, plan, schedule, out, features, gnn_cfg, degrade,
                        journal, tracer, stream_id) -> None:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()  # consumer died: unblock producer

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _producer():
            # pack spans parent under this run's stream span, not under
            # whatever this thread did last
            with tracer.adopt(stream_id):
                try:
                    for shape, indices in schedule:
                        faults.fire("exec.prefetch", tag=lambda: f"parts={len(indices)}")
                        if not _put(self._pack_timed(plan, indices, features, shape)):
                            return
                    _put(_SENTINEL)
                except faults.WorkerKilled:
                    # simulated abrupt thread death: deliver NOTHING — the
                    # consumer-side watchdog must catch this
                    return
                except BaseException as e:  # noqa: BLE001 — forwarded to consumer
                    _put(e)

        th = threading.Thread(target=_producer, name="exec-prefetch", daemon=True)
        th.start()
        try:
            while True:
                depth = q.qsize()
                self.stats.max_queue_depth = max(self.stats.max_queue_depth, depth)
                REGISTRY.gauge("exec.queue_depth").set(depth)
                got = self._next_batch(q, th)
                if got is _SENTINEL:
                    break
                if isinstance(got, BaseException):
                    raise got
                self._launch_degradable(plan, got, out, features, gnn_cfg, degrade, journal)
        finally:
            # a launch failure leaves the producer blocked mid-put; the stop
            # flag makes its bounded put give up promptly
            stop.set()
            th.join(timeout=60.0)

    def run_subgraphs(
        self,
        subgraphs: list[Subgraph],
        features: np.ndarray,
        num_nodes: int,
    ) -> np.ndarray:
        """Stream pre-extracted partitions (``predict_partitioned``'s
        calling convention)."""
        plan = plan_from_subgraphs(
            list(subgraphs), num_nodes,
            min_nodes=self.min_nodes, min_edges=self.min_edges,
        )
        return self.run_plan(plan, features)

    def run_graph(
        self,
        graph: EdgeGraph,
        features: np.ndarray,
        k: int,
        *,
        regrow: bool = True,
        hops: int = 1,
        partitioner: str = "multilevel",
        seed: int = 0,
    ) -> np.ndarray:
        """Plan + stream in one call."""
        plan = self.plan_graph(
            graph, k, regrow=regrow, hops=hops, partitioner=partitioner, seed=seed,
        )
        return self.run_plan(plan, features)

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _next_batch(q: queue.Queue, th: threading.Thread):
        """Bounded-wait queue read with a producer watchdog: a dead
        prefetch thread that delivered neither a batch nor an exception
        fails the run loudly instead of hanging it."""
        while True:
            try:
                return q.get(timeout=0.2)
            except queue.Empty:
                if not th.is_alive():
                    REGISTRY.counter("exec.prefetch_deaths").inc()
                    raise RuntimeError(
                        "prefetch thread died without delivering a batch or an error "
                        "(see exec.prefetch_deaths)"
                    ) from None

    def _pack_timed(self, plan, indices, features, shape,
                    capacity: Optional[int] = None) -> PackedBatch:
        t0 = time.perf_counter()
        with span("exec.pack", parts=len(indices)) as sp:
            batch = pack_partitions(plan, indices, features, shape, capacity or self.capacity,
                                    keyed=self.runner.structure_keyed)
            sp.set(bytes=batch.nbytes)
        dt = time.perf_counter() - t0
        with self._pack_lock:
            self.stats.pack_s += dt
            self.stats.bytes_h2d += batch.nbytes
        REGISTRY.counter("exec.bytes_h2d").inc(batch.nbytes)
        REGISTRY.histogram("exec.pack_s").observe(dt)
        return batch

    def _launch_degradable(self, plan, batch: PackedBatch, out: np.ndarray,
                           features, gnn_cfg, degrade: dict, journal=None) -> None:
        """Launch with graceful capacity degradation.

        On a device resource error (a CUDA out-of-memory and friends,
        classified by :func:`repro_torch.faults.is_resource_error`) the
        effective pack capacity for the rest of the run is halved and the
        failed batch is re-packed as smaller chunks and relaunched.  A
        singleton batch that still hits a resource error cannot shrink
        further, so it propagates.
        """
        cap = max(1, degrade["cap"])
        if len(batch.indices) > cap:
            # capacity already degraded earlier in the run: split batches
            # packed (by the prefetch thread) at the old capacity
            self._relaunch_split(plan, batch, out, features, gnn_cfg, degrade, journal, cap)
            return
        try:
            self._launch(batch, out, gnn_cfg, journal)
        except Exception as e:
            if not faults.is_resource_error(e) or len(batch.indices) <= 1:
                raise
            degrade["cap"] = cap = max(1, min(cap, len(batch.indices)) // 2)
            self.stats.capacity_halvings += 1
            REGISTRY.counter("exec.capacity_halvings").inc()
            REGISTRY.gauge("exec.effective_capacity").set(cap)
            self._relaunch_split(plan, batch, out, features, gnn_cfg, degrade, journal, cap)

    def _relaunch_split(self, plan, batch, out, features, gnn_cfg, degrade, journal,
                        cap: int) -> None:
        indices = list(batch.indices)
        for at in range(0, len(indices), cap):
            repacked = self._pack_timed(plan, indices[at:at + cap], features, batch.shape,
                                        capacity=cap)
            self._launch_degradable(plan, repacked, out, features, gnn_cfg, degrade,
                                    journal)

    def _launch(self, batch: PackedBatch, out: np.ndarray, gnn_cfg=None,
                journal=None) -> None:
        if gnn_cfg is not None:
            # the same analytic model, evaluated on the padded shapes this
            # launch ACTUALLY ships (capacity*n_pad rows, capacity*e_pad edges)
            from repro_torch.core.pipeline import memory_model_bytes

            actual = memory_model_bytes(int(batch.arrays["x"].shape[0]),
                                        int(batch.arrays["edge_src"].shape[0]), gnn_cfg)
            self.stats.actual_peak_bytes = max(self.stats.actual_peak_bytes, actual)
            REGISTRY.gauge("exec.actual_peak_bytes").set(actual)
        t0 = time.perf_counter()
        with span("exec.launch", parts=len(batch.items)):
            faults.fire("exec.launch",
                        tag=lambda: f"parts={len(batch.items)} shape={batch.shape}")
            pred = self.runner(batch.arrays, batch.gkeys)
        dt = time.perf_counter() - t0
        self.stats.device_s += dt
        self.stats.launches += 1
        self.stats.batches += 1
        self.stats.partitions += len(batch.items)
        self.stats.core_rows += scatter_core_predictions(out, batch, pred)
        REGISTRY.counter("exec.launches").inc()
        REGISTRY.histogram("exec.device_s").observe(dt)
        if journal is not None:
            # commit core predictions partition by partition AFTER the
            # scatter: each journal file is written atomically, so a crash
            # between launches loses at most the in-flight batch
            for idx, it in zip(batch.indices, batch.items):
                ids = it.global_ids[: it.num_core]
                journal.commit(int(idx), ids, out[ids])


#: small identity-keyed executor reuse pool: repeated partitioned runs with
#: the same params share one runner (its compile probe and its structure).
#: Entries hold a strong ref to the params, so an ``id()`` can never alias
#: a collected object.
_EXECUTOR_POOL: dict[tuple, tuple[object, StreamingExecutor]] = {}
_EXECUTOR_POOL_MAX = 8


def shared_executor(
    params, backend: str, *, capacity: int = 2, prefetch: int = 1,
    stream_dtype: Optional[str] = None,
    min_nodes: int = 64, min_edges: int = 128, device=None,
) -> StreamingExecutor:
    """The process-wide executor for (params identity, backend, knobs)."""
    if stream_dtype == "float32":
        stream_dtype = None   # numerically identical: share the executor
    key = (id(params), backend, capacity, prefetch, stream_dtype,
           min_nodes, min_edges, None if device is None else str(device))
    hit = _EXECUTOR_POOL.get(key)
    if hit is not None and hit[0] is params:
        return hit[1]
    ex = StreamingExecutor(params, backend, capacity=capacity, prefetch=prefetch,
                           stream_dtype=stream_dtype, min_nodes=min_nodes,
                           min_edges=min_edges, device=device)
    if len(_EXECUTOR_POOL) >= _EXECUTOR_POOL_MAX:
        _EXECUTOR_POOL.clear()
    _EXECUTOR_POOL[key] = (params, ex)
    return ex


def stream_predict_partitioned(
    params,
    subgraphs: list[Subgraph],
    features: np.ndarray,
    num_nodes: int,
    backend: str = "ref",
    *,
    capacity: int = 2,
    prefetch: int = 1,
    stream_dtype: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """One-shot convenience: stream through the shared executor pool.

    Core predictions equal the sequential per-subgraph loop's
    (:func:`repro_torch.core.gnn.predict_partitioned_loop`): the
    padding/packing contract keeps every real row's arithmetic the same.
    """
    ex = shared_executor(params, backend, capacity=capacity, prefetch=prefetch,
                         stream_dtype=stream_dtype, device=device)
    return ex.run_subgraphs(subgraphs, features, num_nodes)
