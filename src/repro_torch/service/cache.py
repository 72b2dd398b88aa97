"""Structural-hash result cache (port of ``repro/service/cache.py``, host
only).

Verification traffic is heavily duplicated — the same design arrives from
many users (regression farms re-submit identical netlists).  The cache keys
on (structural hash of the AIG, verification config), so a hit returns the
finished verdict without touching the device at all.  LRU-bounded and
thread-safe.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Hashable, Optional

from repro_torch import faults


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class ResultCache:
    def __init__(self, capacity: int = 1024):
        assert capacity > 0
        self.capacity = capacity
        self._lock = threading.Lock()
        self._data: OrderedDict[Hashable, object] = OrderedDict()
        self.stats = CacheStats()

    @staticmethod
    def key(design_hash: str, config_key: Hashable) -> Hashable:
        return (design_hash, config_key)

    def get(self, key: Hashable) -> Optional[object]:
        faults.fire("cache.load")
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.stats.hits += 1
                return self._data[key]
            self.stats.misses += 1
            return None

    def put(self, key: Hashable, value: object) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.stats.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)
