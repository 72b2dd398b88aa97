"""Process-wide structural plan cache (port of ``repro/kernels/plan_cache.py``).

An :class:`~repro_torch.kernels.groot_spmm.SpmmPlan` is a pure function of
the graph structure, so one LRU keyed on a content hash of the edge arrays
serves every caller:

  * ``("plan", graph_key, e_t)``            -> a built ``SpmmPlan``
  * ``("fwd", graph_key, e_t)``             -> a built ``ForwardPlan``
  * ``("pair", graph_key, backend, device)`` -> a built ``AggPair``

Plans carry their device copies (``SpmmPlan.on``), so a recurring structure
neither rebuilds its plan nor copies its indices to the card again.
Thread-safe.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Hashable

import numpy as np

from repro_torch.obs import span


@dataclasses.dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    builds: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PlanCache:
    """LRU of structure-keyed build products (plans, agg pairs)."""

    def __init__(self, capacity: int = 256):
        assert capacity > 0
        self.capacity = capacity
        self._lock = threading.RLock()
        self._data: OrderedDict[Hashable, object] = OrderedDict()
        self.stats = PlanCacheStats()

    def get_or_build(self, key: Hashable, builder: Callable[[], object]) -> object:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.stats.hits += 1
                return self._data[key]
            self.stats.misses += 1
            # build under the lock: building the same plan twice
            # concurrently would hand two callers two different objects
            value = builder()
            self.stats.builds += 1
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.stats.evictions += 1
            return value

    def peek(self, key: Hashable) -> object | None:
        """Lookup without building (counts as hit/miss).  Pair with
        :meth:`add` for SLOW builders that must not run under the cache
        lock (e.g. whole-design partitioning): peek, build outside, add."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.stats.hits += 1
                return self._data[key]
            self.stats.misses += 1
            return None

    def add(self, key: Hashable, value: object) -> object:
        """Insert a value built outside the lock; an earlier racer's entry
        wins (returns the canonical value, preserving same-object reuse)."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                return self._data[key]
            self.stats.builds += 1
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.stats.evictions += 1
            return value

    def snapshot(self) -> PlanCacheStats:
        with self._lock:
            return dataclasses.replace(self.stats)


#: The process-wide instance (pipeline and predict paths share it).
PLAN_CACHE = PlanCache(capacity=256)


def graph_key(edge_src, edge_dst, num_nodes: int) -> str:
    """Content hash of a graph structure (direction-sensitive: the fanin
    and fanout plans of the same graph hash differently, as they must).
    Runs under the ``plan.key`` span, whose ``bytes`` are the bytes hashed."""
    with span("plan.key", bytes=8 * (np.size(edge_src) + np.size(edge_dst)) + 9):
        h = hashlib.sha256()
        h.update(np.int64(num_nodes).tobytes())
        h.update(np.ascontiguousarray(np.asarray(edge_src, dtype=np.int64)).tobytes())
        h.update(b"|")
        h.update(np.ascontiguousarray(np.asarray(edge_dst, dtype=np.int64)).tobytes())
        return h.hexdigest()


def structure_keys(edge_src, edge_dst, num_nodes: int) -> tuple[str, str]:
    """The (fanin, fanout) :func:`graph_key` pair of a structure: what the
    plan cache looks its two direction plans up by.  The streaming executor
    hashes packed batches on its prefetch thread, off the launch path."""
    return (graph_key(edge_src, edge_dst, num_nodes),
            graph_key(edge_dst, edge_src, num_nodes))


def cached_plan(edge_src, edge_dst, num_nodes: int, *, e_t: int | None = None,
                gkey: str | None = None):
    """``build_plan`` through the process-wide cache.  ``gkey`` is the
    structure's :func:`graph_key` where the caller has hashed it already."""
    from repro_torch.kernels.groot_spmm import E_T, build_plan

    e_t = E_T if e_t is None else e_t
    gkey = graph_key(edge_src, edge_dst, num_nodes) if gkey is None else gkey
    key = ("plan", gkey, e_t)
    return PLAN_CACHE.get_or_build(
        key, lambda: build_plan(edge_src, edge_dst, num_nodes, e_t=e_t)
    )


def cached_forward_plan(edge_src, edge_dst, num_nodes: int, *, e_t: int | None = None,
                        gkeys: tuple[str, str] | None = None):
    """The graph's :class:`~repro_torch.kernels.forward_plan.ForwardPlan`
    through the process-wide cache (direction plans come from
    :func:`cached_plan`, so a recurring structure builds nothing).
    ``gkeys`` are :func:`structure_keys` where the caller has them."""
    from repro_torch.kernels.forward_plan import build_forward_plan
    from repro_torch.kernels.groot_spmm import E_T

    e_t = E_T if e_t is None else e_t
    k_in, k_out = gkeys or (graph_key(edge_src, edge_dst, num_nodes), None)
    key = ("fwd", k_in, e_t)
    return PLAN_CACHE.get_or_build(
        key,
        lambda: build_forward_plan(
            cached_plan(edge_src, edge_dst, num_nodes, e_t=e_t, gkey=k_in),
            cached_plan(edge_dst, edge_src, num_nodes, e_t=e_t, gkey=k_out),
        ),
    )
