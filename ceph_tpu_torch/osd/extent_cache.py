"""ECExtentCache: hot shard extents for the partial-write pipeline.

The capability of the reference's ECExtentCache
(src/osd/ECExtentCache.{h,cc}: an LRU of shard extents backing RMW
reads so overlapping partial writes don't re-read what the pipeline
just touched).  The primary consults it before fanning old-byte reads
for a parity-delta overwrite and refills it with the bytes it reads
and writes; anything that mutates shard state outside the primary's
write pipeline (recovery pushes, rollbacks, removes, map changes)
invalidates.

Device plane (the "device-resident stripe plane" promotion): once a
DeviceArena (ec/arena.py) is attached — at construction, or by
``attach_arena`` when the OSD builds a torch pool's codec, one arena a
device — each host run can carry a device mirror in the arena of the
reader's device, keyed
``(pgid, oid, shard, run_off, gen)``
(``gen`` = the shard extent's write generation, so a racing re-stage
of pre-overwrite bytes can never land under a serveable key) — built
LAZILY on the first ``read_device`` (non-torch pools never stage a
byte), then served as zero-copy device slices so RMW old-byte reads
and hot-object degraded reads feed the ECBatcher's folded launches
without a host->device hop per op.  The host bytes remain the source
of truth: any mutation (a ``write`` merging runs, every invalidation
path above, host-LRU eviction) DROPS the device mirror, and an
arena-budget eviction (``ec_arena_max_bytes``) merely degrades the
next device read back to a one-time re-stage — the invalidation
contract is unchanged, the device copy can only ever lag into a miss,
never into stale bytes.
"""

from __future__ import annotations

import collections
import threading

#: the read scale-out counter schema (hot-tier admission telemetry,
#: lease grant/revoke flow, balanced non-primary serving) — registered
#: zeroed at OSD boot so the exporter and the prom recording rules see
#: a standing series per daemon before any read lands
READ_SCALEOUT_COUNTERS = (
    "ec_read_tier_hit", "ec_read_tier_miss",
    "ec_read_tier_admit", "ec_read_tier_evict",
    "read_lease_grant", "read_lease_ride", "read_lease_revoke",
    "balanced_read_serve", "balanced_read_bounce")


def register_read_scaleout_counters(perf) -> None:
    """Register the read scale-out counters on ``perf`` (idempotent:
    re-adding an existing counter would RESET it)."""
    for name in READ_SCALEOUT_COUNTERS:
        if not perf.has(name):
            perf.add(name)


class _Extents:
    """Non-overlapping sorted (off, bytearray, gen) runs for one shard.

    Each run carries the WRITE GENERATION that produced its current
    bytes (a per-shard monotonic counter stamped on the merged run):
    the device plane folds it into the arena key so a reader that
    snapshotted run bytes before a concurrent overwrite can only ever
    re-stage them under the OLD generation's key — never serveable
    again, aged out by the arena LRU — instead of resurrecting stale
    bytes under the live key.  Per-RUN (not per-shard) stamping keeps
    a write to one run from orphaning every other run's arena mirror."""

    __slots__ = ("runs", "gen")

    def __init__(self):
        self.runs: list[tuple[int, bytearray, int]] = []
        self.gen = 0

    def nbytes(self) -> int:
        return sum(len(b) for _o, b, _g in self.runs)

    def write(self, off: int, data: bytes) -> tuple[list[int], int]:
        """Insert/overwrite [off, off+len) and merge adjacent runs.
        Returns (offsets of runs absorbed/replaced by the merge, the
        merged run's offset) so the caller can drop exactly the device
        mirrors whose host bytes changed."""
        self.gen += 1
        end = off + len(data)
        merged_off = off
        buf = bytearray(data)
        keep: list[tuple[int, bytearray, int]] = []
        dirty: list[int] = []
        for roff, rbuf, rgen in self.runs:
            rend = roff + len(rbuf)
            if rend < off or roff > end:
                keep.append((roff, rbuf, rgen))  # untouched: gen kept
                continue
            # overlap/adjacency: fold the old run around the new bytes
            dirty.append(roff)
            if roff < merged_off:
                buf = rbuf[: merged_off - roff] + buf
                merged_off = roff
            if rend > end:
                buf = buf + rbuf[len(rbuf) - (rend - end):]
                end = rend
        keep.append((merged_off, buf, self.gen))
        keep.sort(key=lambda t: t[0])
        self.runs = keep
        return dirty, merged_off

    def read(self, off: int, length: int) -> bytes | None:
        """The exact bytes if FULLY covered, else None."""
        end = off + length
        for roff, rbuf, _g in self.runs:
            if roff <= off and off + length <= roff + len(rbuf):
                return bytes(rbuf[off - roff: end - roff])
        return None

    def covering(self, off: int,
                 length: int) -> tuple[int, bytearray, int] | None:
        """(run offset, run buffer, run gen) of the run fully covering
        the range, else None — the device plane stages WHOLE runs so
        every later slice of the run is a free device view.  The buffer
        is returned WITHOUT copying (the hit path must stay O(1)):
        writes never mutate a run buffer in place — they build fresh
        ones and replace the list — so a reference snapshotted under
        the cache lock stays content-stable outside it."""
        for roff, rbuf, rgen in self.runs:
            if roff <= off and off + length <= roff + len(rbuf):
                return roff, rbuf, rgen
        return None


class ECExtentCache:
    def __init__(self, max_bytes: int = 8 << 20, arena=None,
                 on_evict=None):
        self._max = max_bytes
        self._bytes = 0
        # eviction telemetry hook: called once per whole-object LRU
        # eviction (capacity pressure only — invalidations are not
        # evictions).  Must be cheap and lock-free; fired OUTSIDE the
        # cache lock.
        self._on_evict = on_evict
        self._lock = threading.Lock()
        # key: (pgid, oid) -> shard -> _Extents; LRU by key
        self._lru: collections.OrderedDict = collections.OrderedDict()
        # object version the cached bytes correspond to (the pipeline
        # updates it with every write it caches; external mutation
        # paths invalidate instead)
        self._ver: dict = {}
        # whole-object logical length at that version, when the
        # pipeline knows it (write paths carry total_len) — a
        # cache-served client read needs it to trim stripe padding
        self._len: dict = {}
        # device plane: device mirrors of host runs, keyed
        # (pgid, oid, shard, run_off), one arena a device; none = a
        # host-only cache
        self._arenas: dict = {}
        if arena is not None:
            self.attach_arena(arena)

    def attach_arena(self, arena) -> None:
        """Attach the device plane of ``arena.device`` (once a device:
        an arena already attached there stays).  Runs cached before it
        are staged on their first ``read_device``, like any other."""
        with self._lock:
            self._arenas.setdefault(str(arena.device), arena)

    def arena(self, device):
        """The arena attached for ``device``, or None."""
        return self._arenas.get(str(device))

    def _drop_where(self, pred) -> None:
        for arena in list(self._arenas.values()):
            arena.drop_where(pred)

    def pgids(self) -> set:
        """PGs with cached entries (map-change invalidation scans only
        these, not the whole cluster's placement)."""
        with self._lock:
            return {k[0] for k in self._lru}

    def version(self, pgid, oid: str) -> int | None:
        with self._lock:
            return self._ver.get((pgid, oid))

    def object_len(self, pgid, oid: str) -> int | None:
        """Whole-object length at the cached version (None when no
        write-through recorded it)."""
        with self._lock:
            return self._len.get((pgid, oid))

    def read(self, pgid, oid: str, shard: int, off: int,
             length: int) -> bytes | None:
        with self._lock:
            shards = self._lru.get((pgid, oid))
            if shards is None:
                return None
            ext = shards.get(shard)
            data = ext.read(off, length) if ext is not None else None
            if data is None:
                return None
            self._lru.move_to_end((pgid, oid))
            return data

    def read_device(self, pgid, oid: str, shard: int, off: int,
                    length: int, device):
        """The covered range as a tensor slice on ``device``, staging
        the whole covering run into that device's arena on first touch
        (one h2d per run mutation, then every hit is a zero-copy device
        view) — or None when no arena is attached there or the range
        isn't covered.  Callers must treat the result as immutable and
        never pass it as an ``out=`` buffer (the arena owns the
        tensor)."""
        arena = self.arena(device)
        if arena is None:
            return None
        with self._lock:
            shards = self._lru.get((pgid, oid))
            ext = shards.get(shard) if shards is not None else None
            cov = ext.covering(off, length) if ext is not None else None
            if cov is None:
                return None
            roff, rbuf, gen = cov
            self._lru.move_to_end((pgid, oid))
        # stage OUTSIDE the cache lock (a device_put under it would
        # serialize every reader behind the transfer).  The key carries
        # the shard extent's write GENERATION: a concurrent write bumps
        # it, so if it races this put, the stale bytes land under the
        # old-gen key — unreachable (every later read asks for the new
        # gen and re-stages) and aged out by the arena LRU.  A
        # same-length overwrite without the gen would pass a shape
        # check and serve stale bytes forever.  rbuf is content-stable
        # outside the lock (covering's no-mutation contract).
        key = (pgid, oid, shard, roff, gen)
        dev = arena.get(key)
        if dev is None:
            dev = arena.put(key, rbuf)
        start = off - roff
        return dev[start: start + length]

    def write(self, pgid, oid: str, shard: int, off: int,
              data: bytes, version: int | None = None,
              length: int | None = None) -> None:
        if not data:
            return
        drop_prefixes: set = set()
        drop_objs: set = set()
        with self._lock:
            key = (pgid, oid)
            shards = self._lru.get(key)
            if shards is None:
                shards = {}
                self._lru[key] = shards
            ext = shards.setdefault(shard, _Extents())
            self._bytes -= ext.nbytes()
            dirty, merged_off = ext.write(off, data)
            self._bytes += ext.nbytes()
            # host bytes changed: the absorbed runs' mirrors AND the
            # merged run's (its off may equal an absorbed one's) are
            # stale device copies now — matched by (pg, oid, shard,
            # run_off) PREFIX, gen-agnostic, so mirrors staged under
            # any older generation drop too
            drop_prefixes = {(pgid, oid, shard, o)
                             for o in set(dirty) | {merged_off}}
            if version is not None:
                self._ver[key] = version
            if length is not None:
                self._len[key] = length
            self._lru.move_to_end(key)
            evictions = 0
            while self._bytes > self._max and self._lru:
                k, dropped = self._lru.popitem(last=False)
                self._ver.pop(k, None)
                self._len.pop(k, None)
                self._bytes -= sum(e.nbytes() for e in dropped.values())
                # host LRU evicted the whole object: every arena mirror
                # of it (any shard/run/gen) goes with it
                drop_objs.add((k[0], k[1]))
                evictions += 1
        if drop_prefixes or drop_objs:
            self._drop_where(
                lambda k: k[:4] in drop_prefixes or k[:2] in drop_objs)
        if self._on_evict is not None:
            for _ in range(evictions):
                self._on_evict()

    def drop_shards(self, pgid, oid: str, shards) -> None:
        """Drop specific shards' cached runs (host AND device mirrors),
        leaving the object's other shards cached.  The parity-delta
        write path needs this: deltas are applied shard-locally by the
        parity holders, so the primary never learns the resulting
        parity bytes — cached parity runs from an earlier full/row
        write would claim stale bytes at the advanced version."""
        shards = set(shards)
        with self._lock:
            ent = self._lru.get((pgid, oid))
            if ent is not None:
                for s in [s for s in ent if s in shards]:
                    self._bytes -= ent.pop(s).nbytes()
                if not ent:
                    self._lru.pop((pgid, oid), None)
                    self._ver.pop((pgid, oid), None)
                    self._len.pop((pgid, oid), None)
        self._drop_where(lambda k: k[0] == pgid and k[1] == oid
                         and k[2] in shards)

    def invalidate(self, pgid, oid: str | None = None) -> None:
        with self._lock:
            if oid is not None:
                key = (pgid, oid)
                dropped = self._lru.pop(key, None)
                self._ver.pop(key, None)
                self._len.pop(key, None)
                if dropped:
                    self._bytes -= sum(e.nbytes()
                                       for e in dropped.values())
            else:
                for key in [k for k in self._lru if k[0] == pgid]:
                    dropped = self._lru.pop(key)
                    self._ver.pop(key, None)
                    self._len.pop(key, None)
                    self._bytes -= sum(e.nbytes()
                                       for e in dropped.values())
        # the invalidation CONTRACT extends to the device plane: a
        # recovery push / rollback / remove / map change must evict the
        # device copy with the host one
        if oid is not None:
            self._drop_where(lambda k: k[0] == pgid and k[1] == oid)
        else:
            self._drop_where(lambda k: k[0] == pgid)

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._ver.clear()
            self._len.clear()
            self._bytes = 0
        for arena in list(self._arenas.values()):
            arena.clear()
