"""LRU slice cache (paper §V-E).

Slots hold whole deserialized slices; eviction is least-recently-used.
``slots=0`` disables caching (the paper's c0 configuration), ``slots=14``
fits one slice per attribute (c14).  ``byte_budget`` optionally bounds the
LRU tier by RESIDENT BYTES as well — eviction runs until both the slot
count and the byte budget hold, which is what a long-lived serving
process needs (slot counts say nothing about slice size).  Hit/miss
counters feed the layout micro-benchmarks; the cache is transparent to
the GoFS API user.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional


def _value_nbytes(val: Any) -> int:
    """Best-effort byte size of a cached slice: ndarray-likes report
    ``nbytes``; containers sum their values; everything else counts 0
    (budgeting is for bulk slice payloads, not tiny metadata)."""
    n = getattr(val, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(val, dict):
        return sum(_value_nbytes(v) for v in val.values())
    if isinstance(val, (list, tuple)):
        return sum(_value_nbytes(v) for v in val)
    return 0


class SliceCache:
    """Thread-safe: a background staging pool and the caller's thread may
    hit the same store concurrently.  The lock guards
    the LRU bookkeeping only; the ``loader`` disk read runs outside it (two
    threads may race the same cold key and both read — harmless, the LRU
    keeps one copy).

    Pinned entries (``pin=True``) live outside both the slot count and the
    byte budget: they are metadata-grade values (tile maps, delta payload
    pools) that every staging pass re-derives from and must never be
    evicted (the no-lost-pins invariant the concurrency stress test
    hammers)."""

    def __init__(self, slots: int = 14, byte_budget: Optional[int] = None):
        self.slots = slots
        self.byte_budget = byte_budget
        self._data: "OrderedDict[str, Any]" = OrderedDict()
        self._sizes: Dict[str, int] = {}
        self._bytes = 0  # resident bytes in the LRU tier
        self._pinned: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: str, loader: Callable[[], Any],
            pin: bool = False) -> Any:
        """``pin=True`` keeps the value resident outside the LRU slots —
        for metadata-grade slices (tile maps, delta payload pools) that
        every staging pass re-derives from; they must survive ``slots=0``
        (the c0 configuration disables *value* caching, not metadata)."""
        if pin:
            with self._lock:
                if key in self._pinned:
                    self.hits += 1
                    return self._pinned[key]
                self.misses += 1
            val = loader()
            with self._lock:
                self._pinned.setdefault(key, val)
                return self._pinned[key]
        if self.slots <= 0:
            with self._lock:
                self.misses += 1
            return loader()
        with self._lock:
            if key in self._data:
                self.hits += 1
                self._data.move_to_end(key)
                return self._data[key]
            self.misses += 1
        val = loader()
        nb = _value_nbytes(val)
        with self._lock:
            if key not in self._data:
                self._data[key] = val
                self._sizes[key] = nb
                self._bytes += nb
            self._evict_locked()
        return val

    def _evict_locked(self) -> None:
        """Evict LRU entries until the slot count AND byte budget hold.
        Caller holds the lock.  A single value larger than the whole
        budget is evicted immediately after insertion — residency is never
        allowed to exceed the budget at lock release."""
        while self._data and (
            len(self._data) > self.slots
            or (self.byte_budget is not None
                and self._bytes > self.byte_budget)
        ):
            k, _ = self._data.popitem(last=False)
            self._bytes -= self._sizes.pop(k, 0)
            self.evictions += 1

    def invalidate(self, predicate: Callable[[str], bool]) -> int:
        """Drop every entry — LRU *and* pinned — whose key satisfies
        ``predicate``.  Returns the number of entries dropped.

        This is the append-observation hook: when a collection grows in
        place, the rewritten tail pack slices and the extended tile-map /
        delta-pool metadata must leave the cache (a stale pinned payload
        pool would silently serve pre-append values forever), while every
        untouched slice stays resident.  Unlike ``clear`` this is
        targeted: survivors keep their LRU position and pin status."""
        dropped = 0
        with self._lock:
            for k in [k for k in self._data if predicate(k)]:
                del self._data[k]
                self._bytes -= self._sizes.pop(k, 0)
                dropped += 1
            for k in [k for k in self._pinned if predicate(k)]:
                del self._pinned[k]
                dropped += 1
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._sizes.clear()
            self._bytes = 0
            self._pinned.clear()

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "resident": len(self._data),
                "resident_bytes": self._bytes,
                "byte_budget": self.byte_budget,
                "pinned": len(self._pinned),
                "evictions": self.evictions,
            }
