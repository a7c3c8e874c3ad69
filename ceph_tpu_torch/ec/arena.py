"""DeviceArena: stripe bytes resident on the card, staged once, evicted
by LRU.

The counterpart of the JAX package's ``ceph_tpu/ec/arena.py``: stripe
and shard extents that the hot path feeds back into folded kernel
launches stay resident as device tensors keyed by ``(pg, object, shard,
extent, gen)`` instead of being copied to the card on every op.

Semantics:

- ``put`` stages a host buffer through the shared staging helper
  (utils/staging.device_put_landed — h2d bytes metered) and inserts it
  under the key; a tensor inserts as it is, without re-staging;
- ``get`` is an LRU touch; hits and misses land on the ``ec_kernels``
  registry (``ec_arena_hits`` / ``ec_arena_misses``);
- the byte budget (``ec_arena_max_bytes``, 64 MiB by default) evicts
  least-recently-used entries (``ec_arena_evictions``); eviction only
  drops the device copy — owners keep the host bytes and re-stage on the
  next device read.

Holders must treat returned tensors as IMMUTABLE and never pass them as
a launch's ``out=`` buffer; the batcher's ownership rule (ec/batcher.py
``_PendingOp.dev_owned``) encodes exactly this.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from ..utils import staging
from ..utils.perf import CounterType

#: registered (zeroed) on the ec_kernels registry next to the staging
#: counters — one stable schema whether or not an arena ever filled
COUNTERS = ("ec_arena_hits", "ec_arena_misses", "ec_arena_evictions")
GAUGES = ("ec_arena_bytes",)


def _ensure_counters(pc) -> None:
    # under the staging plane's registration lock: add() RESETS an
    # existing counter, so two arenas constructing concurrently must
    # not both see has()==False
    with staging._REG_LOCK:
        for n in COUNTERS:
            if not pc.has(n):
                pc.add(n)
        for g in GAUGES:
            if not pc.has(g):
                pc.add(g, CounterType.U64)


class DeviceArena:
    """LRU byte-budgeted map of key -> device tensor on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, max_bytes: int = 64 << 20, device="cuda"):
        self._max = int(max_bytes)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceArena: device cuda requested but "
                               "torch.cuda.is_available() is False")
        self._lock = threading.Lock()
        self._lru: collections.OrderedDict = collections.OrderedDict()
        self._bytes = 0
        self._perf = staging.stage_perf()
        _ensure_counters(self._perf)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def get(self, key):
        with self._lock:
            hit = self._lru.get(key)
            if hit is None:
                self._perf.inc("ec_arena_misses")
                return None
            self._lru.move_to_end(key)
            self._perf.inc("ec_arena_hits")
            return hit[0]

    def put(self, key, buf):
        """Insert (staging a host buffer once) and return the device
        tensor.  Replaces any prior entry under the key — the caller
        mutated the bytes, so the old device copy is stale."""
        if isinstance(buf, (bytes, bytearray, memoryview)):
            buf = np.frombuffer(bytes(buf), dtype=np.uint8)
        if isinstance(buf, np.ndarray):
            dev = staging.device_put_landed(
                np.ascontiguousarray(buf, dtype=np.uint8), self.device,
                force=False)
        else:
            dev = buf  # already device-resident: no re-staging
        nbytes = int(dev.numel() * dev.element_size())
        evicted = 0
        with self._lock:
            old = self._lru.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._lru[key] = (dev, nbytes)
            self._bytes += nbytes
            while self._bytes > self._max and len(self._lru) > 1:
                _k, (_d, nb) = self._lru.popitem(last=False)
                self._bytes -= nb
                evicted += 1
            self._perf.set("ec_arena_bytes", self._bytes)
        if evicted:
            self._perf.inc("ec_arena_evictions", evicted)
        return dev

    def drop(self, key) -> None:
        with self._lock:
            old = self._lru.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
                self._perf.set("ec_arena_bytes", self._bytes)

    def drop_where(self, pred) -> int:
        """Drop every entry whose key matches ``pred`` (the
        invalidation fan-out: an object's runs, a PG's objects)."""
        with self._lock:
            victims = [k for k in self._lru if pred(k)]
            for k in victims:
                _d, nb = self._lru.pop(k)
                self._bytes -= nb
            if victims:
                self._perf.set("ec_arena_bytes", self._bytes)
            return len(victims)

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._bytes = 0
            self._perf.set("ec_arena_bytes", 0)
