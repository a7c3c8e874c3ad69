"""mempool: per-pool memory accounting.

The capability of the reference's mempool (src/common/mempool.cc +
include/mempool.h): named pools accumulate (bytes, items) counters from
the subsystems that allocate under them (bluestore caches, pglog, ...),
dumped for observability — a bookkeeping layer, not an allocator.
"""

from __future__ import annotations

import threading


class MemPool:
    __slots__ = ("name", "_bytes", "_items", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._bytes = 0
        self._items = 0
        self._lock = threading.Lock()

    def add(self, nbytes: int, items: int = 1) -> None:
        with self._lock:
            self._bytes += nbytes
            self._items += items

    def sub(self, nbytes: int, items: int = 1) -> None:
        with self._lock:
            self._bytes -= nbytes
            self._items -= items

    def stats(self) -> dict:
        with self._lock:
            return {"bytes": self._bytes, "items": self._items}


class MemPoolRegistry:
    def __init__(self):
        self._pools: dict[str, MemPool] = {}
        self._lock = threading.Lock()

    def pool(self, name: str) -> MemPool:
        with self._lock:
            p = self._pools.get(name)
            if p is None:
                p = MemPool(name)
                self._pools[name] = p
            return p

    def dump(self) -> dict:
        with self._lock:
            pools = dict(self._pools)
        return {n: p.stats() for n, p in sorted(pools.items())}


_GLOBAL = MemPoolRegistry()


def global_mempools() -> MemPoolRegistry:
    return _GLOBAL
