"""Hot-entry LRU cache for the partition-serving layer.

A copy of the reference package's ``serve/cache.py``.  The store
compresses adjacency into row shards (the ``repro_torch.io.compress``
codec); answering a neighbor query means decoding the shard that holds
the vertex's row.  Under the Zipf-skewed workloads a graph service
actually sees, a small set of hot shards absorbs most queries — this
cache keeps their *decoded* arrays so the head of the distribution
never pays the varint decode twice (``chip_smoke.py`` phase 14
measures the p99 win on the card's scale-22 artifact).

Deliberately stdlib-only and thread-safe: the serving host decodes
under concurrent HTTP handler threads, and the monitor-facing hit/miss
counters are part of the serving metrics contract
(``repro_serve_cache_hit_ratio`` in the Prometheus exposition).
"""
from __future__ import annotations

import threading
from collections import OrderedDict


class LRUCache:
    """Bounded LRU mapping with hit/miss/eviction counters.

    ``capacity <= 0`` disables caching entirely (every ``get`` is a
    miss, ``put`` is a no-op) — the cache-off arm of the serve bench.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        """The cached value, or None (counts a hit/miss either way)."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
            return None

    def put(self, key, value) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self._data[key] = value
                return
            self._data[key] = value
            if len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        with self._lock:
            size = len(self._data)
        return {"capacity": self.capacity, "size": size,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_ratio": self.hit_ratio()}

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


__all__ = ["LRUCache"]
