"""Process-wide structural plan cache (port of ``repro/kernels/plan_cache.py``).

An :class:`~repro_torch.kernels.groot_spmm.SpmmPlan` is a pure function of
the graph structure, so one LRU keyed on a content hash of the edge arrays
serves every caller:

  * ``("plan", graph_key, e_t)``            -> a built ``SpmmPlan``
  * ``("fwd", graph_key, e_t)``             -> a built ``ForwardPlan``
  * ``("pair", graph_key, backend, device)`` -> a built ``AggPair``
  * ``("pack_keys", shape, capacity, slot keys)`` -> a packed launch's
    ``structure_keys`` (:func:`recipe_keys`; a memo, not a build)

Plans carry their device copies (``SpmmPlan.on``), so a recurring structure
neither rebuilds its plan nor copies its indices to the card again.
Thread-safe.

Keys are content hashes, and hashing a 1,024-bit multiplier's edges takes
a few hundred ms, so a prepared structure is hashed once: :func:`keys_of`
memoizes an ``EdgeGraph``'s or a ``Subgraph``'s keys on the object and
sets its ``edge_src``/``edge_dst`` read-only.  A keyed structure's endpoint
arrays are frozen from then on: an in-place write raises ``ValueError``
instead of leaving a stale key (which would select another structure's
plan), and a changed structure is a new object.  Bare arrays
(:func:`graph_key`, :func:`structure_keys`) are hashed on every call.
Every lookup runs under one ``plan.key`` span, whose ``bytes`` are the
bytes hashed (0 on a memo hit) and whose ``memo`` is ``"hit"``, ``"miss"``
or ``"none"`` (bare arrays); each adds one to the ``plan.key_hashes`` or
the ``plan.key_memo_hits`` counter.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Hashable

import numpy as np

from repro_torch.obs import REGISTRY, span


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
            return self._insert(key, value)

    def _insert(self, key: Hashable, value: object) -> object:
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
            return self._insert(key, value)

    def recall(self, key: Hashable) -> object | None:
        """:meth:`peek` for memo entries (structure keys, no plans): counts
        no hit or miss."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                return self._data[key]
            return None

    def remember(self, key: Hashable, value: object) -> object:
        """:meth:`add` for memo entries: counts no build."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                return self._data[key]
            return self._insert(key, value)

    def snapshot(self) -> PlanCacheStats:
        with self._lock:
            return dataclasses.replace(self.stats)


#: The process-wide instance (pipeline and predict paths share it).
PLAN_CACHE = PlanCache(capacity=256)


def _hashed_bytes(edge_src, edge_dst) -> int:
    """The bytes one :func:`graph_key` hashes."""
    return 8 * (np.size(edge_src) + np.size(edge_dst)) + 9


def _digests(edge_src, edge_dst, num_nodes: int, *, both: bool) -> tuple[str, ...]:
    """The sha256 of ``num_nodes`` (int64), ``edge_src`` (int64), ``b"|"``,
    ``edge_dst`` (int64); with ``both`` also that of the reversed pair.
    Each endpoint array is widened once and hashed in place."""
    head = np.int64(num_nodes).tobytes()
    a = np.ascontiguousarray(edge_src, dtype=np.int64)
    b = np.ascontiguousarray(edge_dst, dtype=np.int64)
    out = []
    for first, second in ((a, b), (b, a))[: 2 if both else 1]:
        h = hashlib.sha256(head)
        h.update(first)
        h.update(b"|")
        h.update(second)
        out.append(h.hexdigest())
    return tuple(out)


def graph_key(edge_src, edge_dst, num_nodes: int) -> str:
    """Content hash of a graph structure (direction-sensitive: the fanin
    and fanout plans of the same graph hash differently, as they must).
    Runs under the ``plan.key`` span, whose ``bytes`` are the bytes hashed."""
    with span("plan.key", bytes=_hashed_bytes(edge_src, edge_dst), memo="none"):
        REGISTRY.counter("plan.key_hashes").inc()
        return _digests(edge_src, edge_dst, num_nodes, both=False)[0]


def structure_keys(edge_src, edge_dst, num_nodes: int) -> tuple[str, str]:
    """The (fanin, fanout) :func:`graph_key` pair of a structure: what the
    plan cache looks its two direction plans up by."""
    return (graph_key(edge_src, edge_dst, num_nodes),
            graph_key(edge_dst, edge_src, num_nodes))


def keys_of(structure) -> tuple[str, str]:
    """The :func:`structure_keys` of a prepared structure (an ``EdgeGraph``
    or a ``Subgraph``), hashed on first use and memoized on the object.

    The first call freezes ``edge_src`` and ``edge_dst`` (read-only), so
    the memo cannot go stale through an in-place write.  It holds the arrays
    it was computed from: a memo whose arrays were replaced, made writable
    again, or whose node count changed is hashed anew."""
    src, dst, n = structure.edge_src, structure.edge_dst, structure.num_nodes
    memo = structure.key_memo
    with span("plan.key", bytes=0, memo="hit") as sp:
        if (memo is not None and memo[0] is src and memo[1] is dst and memo[2] == n
                and not src.flags.writeable and not dst.flags.writeable):
            REGISTRY.counter("plan.key_memo_hits").inc()
            return memo[3]
        sp.set(bytes=2 * _hashed_bytes(src, dst), memo="miss")
        REGISTRY.counter("plan.key_hashes").inc()
        src.setflags(write=False)
        dst.setflags(write=False)
        keys = _digests(src, dst, n, both=True)
        structure.key_memo = (src, dst, n, keys)
        return keys


def recipe_keys(recipe: Hashable, edge_src, edge_dst, num_nodes: int) -> tuple[str, str]:
    """The :func:`structure_keys` of arrays that ``recipe`` determines
    (a packed launch's: ``("pack_keys", shape, capacity, slot keys)``),
    looked up by the recipe in :data:`PLAN_CACHE`; on a miss the arrays
    are hashed and the keys kept.  An evicted recipe is hashed again."""
    with span("plan.key", bytes=0, memo="hit") as sp:
        keys = PLAN_CACHE.recall(recipe)
        if keys is not None:
            REGISTRY.counter("plan.key_memo_hits").inc()
            return keys
        sp.set(bytes=2 * _hashed_bytes(edge_src, edge_dst), memo="miss")
        REGISTRY.counter("plan.key_hashes").inc()
        return PLAN_CACHE.remember(recipe, _digests(edge_src, edge_dst, num_nodes, both=True))


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
