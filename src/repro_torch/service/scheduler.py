"""Shape-bucketed device scheduler with a compile-count probe (port of
``repro/service/scheduler.py``).

:class:`BucketRunner` runs one packed batch (``bucketing.pack_batch``'s
arrays) through the padded GNN forward and returns its int32 predictions.
Backends come in two classes, as in the reference:

  * **shape-stable** ("ref", "onehot"): the work depends on the padded
    shape only.  The reference compiles one executable per (bucket,
    capacity) signature; the port has no jit, so ``compile_count`` counts
    the first sight of each signature — what the reference would trace.
  * **structure-keyed** (the ``groot*`` backends): each packed batch's
    degree-bucketed plans depend on its structure.  Host plans come from
    the process-wide structural ``PLAN_CACHE`` (a recurring structure
    builds nothing; ``compile_count`` counts the plan builds), keyed by
    ``plan_cache.structure_keys`` that the streaming executor hashes on its
    prefetch thread.  The runner holds the device copies (edge tensors and
    plan indices) of ONE packed structure at a time: a batch of the same
    structure reuses them, a different structure first releases them
    (``ops.release_device``), and :meth:`release` drops them after a run.
    Cached pairs would keep every structure's indices on the card.

After :meth:`BucketRunner.mark_warm` (the service calls it once warmup is
done) a *cold compile* (``cold_compile_count``, the ``service.cold_compiles``
counter) is what the reference would trace afresh: a first-seen packed
signature on the shape-stable backends, a packed structure this runner has
not seen on the structure-keyed ones (its host plans are built then, unless
the process-wide plan cache holds them).  A warmed service keeps it at 0 on
the warmed grid.  Past ``max_structures`` distinct structures the runner
forgets the ones it has seen (the reference drops its jit cache there).

:class:`ShapeBucketScheduler` packs up to ``capacity`` same-bucket items per
device call (:meth:`~ShapeBucketScheduler.run_pack`) and reads back per-item
real-node predictions, streaming an item too large for the bucket ceilings
through the ``repro_torch.exec`` executor; :class:`SlotPool` is the
priority-ordered admission pool the service's device loop feeds packs from.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from collections import defaultdict, deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import gnn
from repro_torch.kernels import ops
from repro_torch.kernels.plan_cache import PLAN_CACHE, structure_keys
from repro_torch.obs import REGISTRY, MetricsRegistry, span
from repro_torch.service.bucketing import (
    BucketShape,
    WorkItem,
    dummy_item,
    pack_batch,
    unpack_predictions,
)

SHAPE_STABLE_BACKENDS = ("ref", "onehot")
STRUCTURE_KEYED_BACKENDS = ("groot", "groot_mxu", "groot_fused")


class BucketRunner:
    """One padded GNN forward per packed batch; counts compiles and calls."""

    def __init__(self, params: gnn.GrootGNN, backend: str = "ref", *,
                 max_structures: int = 64, stream_dtype: Optional[str] = None,
                 metrics: Optional[MetricsRegistry] = None, device=None):
        if backend not in SHAPE_STABLE_BACKENDS + STRUCTURE_KEYED_BACKENDS:
            raise ValueError(
                f"runner backend must be one of {SHAPE_STABLE_BACKENDS} "
                f"(shape-stable) or {STRUCTURE_KEYED_BACKENDS} "
                f"(structure-keyed, via the plan cache), got {backend!r}"
            )
        self.params = params
        self.backend = backend
        self.device = gnn._params_on(params, device)
        # edge-stream dtype for the hoisted groot* forward (None/f32 =
        # bit-exact staging; "bfloat16" halves the staged stream bytes)
        self._stream_dtype = stream_dtype
        # per-engine registry for cold-compile attribution (the service
        # passes its own; standalone runners fall back to a private one)
        self._metrics = metrics if metrics is not None else MetricsRegistry()
        self.compile_count = 0
        self.run_count = 0
        #: set by ``mark_warm()`` once warmup is done; from then on a first
        #: sight is a *cold* compile a user request paid for
        self.warmed = False
        self.cold_compile_count = 0
        self._signatures: set = set()
        #: structures seen (structure-keyed backends), forgotten wholesale
        #: past ``max_structures`` (``structure_clears`` counts it)
        self.max_structures = max_structures
        self._structures_seen: set = set()
        self.structure_clears = 0
        # (gkeys, edge_src, edge_dst, pair) of the structure held on the device
        self._held: Optional[tuple] = None
        self._lock = threading.Lock()

    @property
    def structure_keyed(self) -> bool:
        return self.backend in STRUCTURE_KEYED_BACKENDS

    @property
    def in_features(self) -> int:
        """Model input width — what warmup's dummy feature rows must be."""
        return int(self.params.layers[0].w_self.shape[0])

    def mark_warm(self) -> None:
        """Warmup is done: first sights from here on are cold compiles."""
        self.warmed = True

    def _compiled(self, n: int) -> None:
        if n:
            self.compile_count += n
            REGISTRY.counter("service.runner_compiles").inc(n)

    def _first_sight(self) -> None:
        """A signature or structure the reference would trace afresh."""
        if self.warmed:
            self.cold_compile_count += 1
            REGISTRY.counter("service.cold_compiles").inc()
            self._metrics.counter("service.cold_compiles").inc()

    def release(self) -> None:
        """Drop the held structure's device copies (its host plans stay in
        the plan cache)."""
        with self._lock:
            self._drop()

    def _drop(self) -> None:
        if self._held is not None:
            ops.release_device(self._held[3])
            self._held = None

    def _edges(self, batch: dict) -> tuple:
        return tuple(torch.from_numpy(batch[k]).to(self.device).long()
                     for k in ("edge_src", "edge_dst"))

    def _structure(self, batch: dict, gkeys) -> tuple:
        """(edge_src, edge_dst, pair) of the batch's structure on the device."""
        if gkeys not in self._structures_seen:
            if len(self._structures_seen) >= self.max_structures:
                self._structures_seen.clear()
                self.structure_clears += 1
            self._structures_seen.add(gkeys)
            self._first_sight()
        if self._held is not None and self._held[0] == gkeys:
            return self._held[1:]
        self._drop()
        builds = PLAN_CACHE.snapshot().builds
        src, dst = self._edges(batch)
        pair = ops.make_agg_pair(batch["edge_src"], batch["edge_dst"], batch["num_nodes"],
                                 self.backend, device=self.device, cache=False, gkeys=gkeys)
        self._compiled(PLAN_CACHE.snapshot().builds - builds)
        self._held = (gkeys, src, dst, pair)
        return src, dst, pair

    def __call__(self, batch: dict, gkeys: Optional[tuple] = None) -> np.ndarray:
        """Predictions (int32, one a packed row) of one packed batch.
        ``gkeys`` are the batch's ``structure_keys`` where the caller has
        them (structure-keyed backends hash the batch otherwise)."""
        num_nodes = batch["num_nodes"]
        with self._lock:  # one device stream; keeps the probes race-free
            self.run_count += 1
            if self.structure_keyed:
                if gkeys is None:
                    gkeys = structure_keys(batch["edge_src"], batch["edge_dst"], num_nodes)
                src, dst, agg = self._structure(batch, gkeys)
            else:
                sig = (batch["x"].shape, batch["edge_src"].shape, num_nodes)
                if sig not in self._signatures:
                    self._signatures.add(sig)
                    self._compiled(1)
                    self._first_sight()
                src, dst = self._edges(batch)
                agg = None if self.backend == "ref" else ops.make_agg_pair(
                    batch["edge_src"], batch["edge_dst"], num_nodes, self.backend,
                    device=self.device, cache=False)
            x, inv, slot = (torch.from_numpy(batch[k]).to(self.device)
                            for k in ("x", "edge_inv", "edge_slot"))
            with torch.no_grad():
                logits = gnn.forward(self.params, x, src, dst, inv, slot,
                                     num_nodes=num_nodes, agg=agg,
                                     stream_dtype=self._stream_dtype)
            return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()


@dataclasses.dataclass
class SchedulerStats:
    compile_count: int
    run_count: int
    buckets: list[BucketShape]
    items_run: int
    streamed_items: int = 0
    cold_compiles: int = 0
    warm_compiles: int = 0
    warm_shapes: tuple = ()
    warmup_s: float = 0.0


class SlotPool:
    """Priority-ordered pending work items, grouped by bucket shape.

    The continuous device loop's admission structure: ``admit`` slots a
    prepared item under its bucket; ``best_bucket`` names the bucket whose
    head item is globally most urgent (lowest ``(priority, seq)``); ``take``
    pops up to one pack's worth of that bucket — so a request arriving
    between two device calls joins the very next same-bucket pack instead
    of waiting behind a whole drained wave.  Single-consumer (the device
    thread); producers go through the device queue.
    """

    def __init__(self):
        self._heaps: dict[BucketShape, list] = {}
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def admit(self, shape: BucketShape, priority: int, seq: int, payload) -> None:
        heapq.heappush(self._heaps.setdefault(shape, []), (priority, seq, payload))
        self._size += 1

    def head_key(self, shape: BucketShape) -> tuple:
        """The (priority, seq) of the most urgent item in ``shape``."""
        return self._heaps[shape][0][:2]

    def best_bucket(self) -> Optional[BucketShape]:
        best, best_key = None, None
        for shape, heap in self._heaps.items():
            if not heap:
                continue
            key = heap[0][:2]
            if best_key is None or key < best_key:
                best, best_key = shape, key
        return best

    def take(self, shape: BucketShape, n: int) -> list:
        """Pop up to ``n`` payloads of ``shape`` in (priority, seq) order."""
        heap = self._heaps.get(shape, [])
        out = []
        while heap and len(out) < n:
            out.append(heapq.heappop(heap))
        if not heap:
            self._heaps.pop(shape, None)
        self._size -= len(out)
        return out

    def prune(self, dead) -> int:
        """Drop every payload ``dead(payload)`` accepts; returns the count.

        The device loop prunes slots of failed / deadline-expired requests
        each cycle, so their pool occupancy is released at once rather than
        riding along until their bucket next drains.
        """
        dropped = 0
        for shape in list(self._heaps):
            heap = self._heaps[shape]
            keep = [entry for entry in heap if not dead(entry[2])]
            dropped += len(heap) - len(keep)
            if not keep:
                self._heaps.pop(shape)
            elif len(keep) != len(heap):
                heapq.heapify(keep)
                self._heaps[shape] = keep
        self._size -= dropped
        return dropped


class ShapeBucketScheduler:
    """Groups work items into shape buckets and runs them batched.

    With ``max_bucket_nodes`` set, an item too large for the largest allowed
    bucket is not rejected: it is partitioned with re-growth into
    device-sized pieces that land in (capped) buckets and stream through the
    ``repro_torch.exec`` executor over the SAME :class:`BucketRunner`, so the
    compile-count probe keeps covering them.
    """

    #: bounded log of recent device packs — (bucket, [req ids], fill) —
    #: what the continuous-batching tests assert admission order against
    PACK_LOG_MAX = 256

    def __init__(
        self,
        params,
        *,
        backend: str = "ref",
        capacity: int = 2,
        min_nodes: int = 64,
        min_edges: int = 128,
        max_structures: int = 64,
        max_bucket_nodes: Optional[int] = None,
        max_bucket_edges: Optional[int] = None,
        stream_capacity: int = 2,
        stream_partitioner: str = "multilevel",
        stream_dtype: Optional[str] = None,
        metrics: Optional[MetricsRegistry] = None,
        device=None,
    ):
        assert capacity >= 1
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.runner = BucketRunner(params, backend, max_structures=max_structures,
                                   stream_dtype=stream_dtype, metrics=self.metrics,
                                   device=device)
        self.capacity = capacity
        self.min_nodes = min_nodes
        self.min_edges = min_edges
        self.max_bucket_nodes = max_bucket_nodes
        self.max_bucket_edges = max_bucket_edges
        self.stream_capacity = stream_capacity
        self.stream_partitioner = stream_partitioner
        self._executor = None         # lazy; shares self.runner
        self._buckets_seen: set[BucketShape] = set()
        self._items_run = 0
        self._streamed_items = 0
        self._warm_compiles = 0
        self._warm_shapes: tuple = ()
        self._warmup_s = 0.0
        self.pack_log: deque = deque(maxlen=self.PACK_LOG_MAX)

    def bucket_of(self, item: WorkItem) -> BucketShape:
        return item.bucket(min_nodes=self.min_nodes, min_edges=self.min_edges)

    def _oversized(self, shape: BucketShape) -> bool:
        if self.max_bucket_nodes is not None and shape.n_pad > self.max_bucket_nodes:
            return True
        if self.max_bucket_edges is not None and shape.e_pad > self.max_bucket_edges:
            return True
        return False

    def _stream_item(self, item: WorkItem) -> np.ndarray:
        """Run one oversized item through the partitioned streaming
        executor; returns predictions for every item row (its partitions'
        cores tile the item graph)."""
        from repro_torch.core.graph import EdgeGraph
        from repro_torch.exec.plan import choose_k_for_caps
        from repro_torch.exec.stream import StreamingExecutor

        if self._executor is None:
            self._executor = StreamingExecutor(
                runner=self.runner, capacity=self.stream_capacity,
                min_nodes=self.min_nodes, min_edges=self.min_edges,
            )
        g = EdgeGraph(item.num_nodes, item.edge_src, item.edge_dst,
                      item.edge_inv, item.edge_slot)
        k = choose_k_for_caps(
            g.num_nodes, g.num_edges, self.max_bucket_nodes or g.num_nodes + 1,
            self.max_bucket_edges, min_nodes=self.min_nodes, min_edges=self.min_edges,
        )
        # choose_k_for_caps estimates the halo; actual re-growth can
        # overshoot it, so check the BUILT plan's buckets and re-split finer
        # until every launch really fits the configured ceiling
        plan = self._executor.plan_graph(g, k, regrow=True,
                                         partitioner=self.stream_partitioner, seed=0)
        while k < g.num_nodes and any(self._oversized(shape) for shape in plan.buckets):
            k *= 2
            plan = self._executor.plan_graph(g, k, regrow=True,
                                             partitioner=self.stream_partitioner, seed=0)
        self._streamed_items += 1
        pred = self._executor.run_plan(plan, item.feats)
        self._buckets_seen.update(self._executor.buckets_seen)
        return pred[: item.num_nodes]

    def run_pack(self, chunk: list[WorkItem],
                 shape: BucketShape) -> dict[tuple[int, int], np.ndarray]:
        """One device call: pack <= ``capacity`` same-bucket items, run,
        unpack.  The continuous device loop's unit of work — between two
        ``run_pack`` calls the loop re-drains its queue, which is what admits
        a newly prepared request into the next open slot."""
        assert 0 < len(chunk) <= self.capacity
        self._buckets_seen.add(shape)
        with span("scheduler.batch", bucket=str(shape), n=len(chunk)):
            pred = self.runner(pack_batch(chunk, shape, self.capacity))
        out = {}
        for it, p in zip(chunk, unpack_predictions(pred, chunk, shape)):
            out[(it.req_id, it.part_index)] = p
        self._items_run += len(chunk)
        fill = len(chunk) / self.capacity
        self.pack_log.append((shape, [it.req_id for it in chunk], fill))
        self.metrics.gauge("service.slot_occupancy").set(fill)
        # fill as a distribution, not just the last value
        self.metrics.histogram("service.pack_fill").observe(fill)
        REGISTRY.counter("scheduler.items_run").inc(len(chunk))
        return out

    def run_items(self, items: list[WorkItem]) -> dict[tuple[int, int], np.ndarray]:
        """Run a set of items; returns (req_id, part_index) -> real-node preds.

        Items of the same bucket are packed ``capacity`` at a time; oversized
        items stream through the executor.  (Synchronous convenience over
        :meth:`run_pack`; the service's continuous loop feeds packs one at a
        time instead.)
        """
        by_bucket: dict[BucketShape, list[WorkItem]] = defaultdict(list)
        out: dict[tuple[int, int], np.ndarray] = {}
        with span("scheduler.run_items", items=len(items)):
            for it in items:
                shape = self.bucket_of(it)
                if self._oversized(shape):
                    out[(it.req_id, it.part_index)] = self._stream_item(it)
                    self._items_run += 1
                else:
                    by_bucket[shape].append(it)
            for shape, group in by_bucket.items():
                for i in range(0, len(group), self.capacity):
                    out.update(self.run_pack(group[i : i + self.capacity], shape))
        return out

    def run_one(self, item: WorkItem) -> dict[tuple[int, int], np.ndarray]:
        """Run a single (possibly oversized) item — the streamed route's
        entry for the continuous loop."""
        shape = self.bucket_of(item)
        if self._oversized(shape):
            pred = self._stream_item(item)
            self._items_run += 1
            REGISTRY.counter("scheduler.items_run").inc()
            return {(item.req_id, item.part_index): pred}
        return self.run_pack([item], shape)

    # -- warmup --------------------------------------------------------------

    def warm(self, shapes, *, stream: bool = False) -> int:
        """Warm the bucket grid: one dummy pack per (shape, slot layout), so
        no user request meets a signature first.  ``stream=True`` also warms
        each shape at the streamed route's ``stream_capacity`` slot layout.
        Returns the compiles warmup caused (``compile_count``'s movement) and
        marks the runner warm — every later first sight is a cold compile.
        The runner's held structure is released afterwards."""
        t0 = time.perf_counter()
        before = self.runner.compile_count
        f = self.runner.in_features
        capacities = [self.capacity]
        if stream and self.stream_capacity != self.capacity:
            capacities.append(self.stream_capacity)
        warmed = []
        for n_pad, e_pad in shapes:
            shape = BucketShape(int(n_pad), int(e_pad))
            warmed.append((shape.n_pad, shape.e_pad))
            it = dummy_item(f)
            for cap in capacities:
                self.runner(pack_batch([it], shape, cap))
        self.runner.release()
        n = self.runner.compile_count - before
        self._warm_compiles += n
        self._warm_shapes = tuple(sorted(set(self._warm_shapes) | set(warmed)))
        self._warmup_s += time.perf_counter() - t0
        self.runner.mark_warm()
        self.metrics.counter("service.warmup_compiles").inc(n)
        return n

    def stats(self) -> SchedulerStats:
        return SchedulerStats(
            compile_count=self.runner.compile_count,
            run_count=self.runner.run_count,
            buckets=sorted(self._buckets_seen, key=lambda b: (b.n_pad, b.e_pad)),
            items_run=self._items_run,
            streamed_items=self._streamed_items,
            cold_compiles=self.runner.cold_compile_count,
            warm_compiles=self._warm_compiles,
            warm_shapes=self._warm_shapes,
            warmup_s=self._warmup_s,
        )
