"""SstKV: a leveled LSM / SSTable KeyValueDB backend with background
maintenance.

The capability of the reference's RocksDBStore tier (src/kv/
RocksDBStore.cc over RocksDB's LSM): writes land in a WAL-backed
memtable; a full memtable SEALS into an immutable memtable (writes
continue into a fresh one + a fresh WAL segment) and a background
flush thread writes it to an L0 sorted-table file, retiring the sealed
segment; a background compaction thread streams L0 files (overlapping,
newest-first) into non-overlapping L1/L2/... runs with a k-way heap
merge (O(block) RAM, never O(level)); reads resolve against an
atomically-swapped ``(memtables, levels)`` snapshot — they never block
behind a flush or merge — consulting memtable -> sealed memtables ->
L0 newest->oldest -> one file per deeper level, each gated by a bloom
filter, located via a sparse block index and served through a shared
byte-budgeted LRU block cache; tombstones shadow older values and drop
when a compaction reaches the bottom level.

Backpressure (the RocksDB slowdown/stop write-stall roles): when
maintenance falls behind (sealed memtables or L0 files past their
thresholds) writers first pace (brief counted sleeps), then STALL
until the flush/compaction threads catch up — ``kv_stall_us`` +
per-cause counters on the ``kv.<store>`` registry.  Inside the store
commit pipeline the stall lands on the kv-sync thread, which keeps
the commit queue full, which blocks the admission throttle — the
backpressure chain stays honest end to end instead of an unbounded
inline merge under the store lock.

File format (sst_NNNNNNNN.sst — UNCHANGED on disk):
    [records: u32 klen | key | u8 tomb | u32 vlen | value]*
    [bloom bits]
    [index: u32 n | (u32 koff_len | first_key | u64 file_off)*]
    [footer: u64 bloom_off | u64 index_off | u32 n_records |
             u32 crc32c(bloom..index) | magic "SSTB"]

The MANIFEST (levels layout + next file seq) rewrites atomically via
tmp+rename; memtable WAL segments (wal_NNNNNNNN.log, one per
memtable) use the store family's crc-framed fsync'd record contract
with torn-tail discard.  Crash contract: a segment is unlinked only
AFTER its memtable's L0 file is in a durable manifest, and a dead
SST is unlinked only AFTER the manifest that drops it — the crash
windows leave either a replayable segment or an orphan file, and
open-time GC removes any ``sst_*.sst`` absent from the manifest
(after WAL replay).  Composite keys are ``prefix \\x00 key`` so
per-prefix iteration is a contiguous range.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import os
import struct
import threading
import time
import weakref
from collections import OrderedDict

from ..ops.native import crc32c
from ..utils.codec import Decoder, Encoder
from ..utils.perf import PerfCounters, global_perf
from .kvstore import KeyValueDB, KVTransaction, resolve_kv_perf

_MAGIC = b"SSTB"
_TOMB = 1
_BLOCK = 4096              # sparse-index granularity (bytes of records)
_REC_TX = 1


def _ckey(prefix: str, key: str) -> bytes:
    return prefix.encode() + b"\x00" + key.encode()


def _split(ck: bytes) -> tuple[str, str]:
    p, _, k = ck.partition(b"\x00")
    return p.decode(), k.decode()


class _Bloom:
    """Fixed-k bloom filter (BloomFilterPolicy role): ~10 bits/key."""

    K = 3

    def __init__(self, bits: bytearray):
        self.bits = bits

    @classmethod
    def build(cls, keys: list[bytes]) -> "_Bloom":
        m = max(64, 10 * len(keys))
        bits = bytearray((m + 7) // 8)
        bloom = cls(bits)
        for k in keys:
            for h in bloom._hashes(k):
                bits[h >> 3] |= 1 << (h & 7)
        return bloom

    def _hashes(self, key: bytes):
        m = len(self.bits) * 8
        for i in range(self.K):
            d = hashlib.blake2b(key, digest_size=8,
                                salt=bytes([i]) * 16).digest()
            yield int.from_bytes(d, "little") % m

    def maybe(self, key: bytes) -> bool:
        return all(self.bits[h >> 3] & (1 << (h & 7))
                   for h in self._hashes(key))


class BlockCache:
    """Byte-budgeted LRU over PARSED sst blocks, shared across every
    table of one store (the rocksdb shared block-cache role): a hot
    onode probe pays one dict move instead of a file read + reparse.
    Compaction scans bypass it — a merge touching a whole level must
    not evict the working set."""

    #: recently-invalidated table uids remembered so a reader holding
    #: a pre-compaction snapshot can't re-insert a dead table's blocks
    #: after invalidate() ran (they would pin budget unreachably);
    #: bounded — an ancient uid's race window is long past
    DEAD_KEEP = 1024

    def __init__(self, max_bytes: int, perf: PerfCounters | None = None):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._map: OrderedDict[tuple, tuple[list, int]] = OrderedDict()
        self._dead: OrderedDict[int, None] = OrderedDict()
        self._bytes = 0
        self._perf = perf

    def _book(self, name: str, n: int = 1) -> None:
        if self._perf is not None:
            self._perf.inc(name, n)

    def lookup(self, key: tuple):
        with self._lock:
            hit = self._map.get(key)
            if hit is not None:
                self._map.move_to_end(key)
        if hit is not None:
            self._book("kv_cache_hit")
            return hit[0]
        self._book("kv_cache_miss")
        return None

    def insert(self, key: tuple, records: list) -> None:
        if self.max_bytes <= 0:
            return
        nbytes = 64 + sum(len(ck) + len(v) + 48 for ck, _t, v in records)
        evicted = 0
        with self._lock:
            if key[0] in self._dead:
                return  # the table died between lookup and insert
            old = self._map.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._map[key] = (records, nbytes)
            self._bytes += nbytes
            while self._bytes > self.max_bytes and len(self._map) > 1:
                _k, (_r, nb) = self._map.popitem(last=False)
                self._bytes -= nb
                evicted += 1
            nb_now = self._bytes
        if evicted:
            self._book("kv_cache_evict", evicted)
        if self._perf is not None:
            self._perf.set("kv_cache_bytes", nb_now)

    def invalidate(self, uid: int) -> None:
        self.invalidate_many((uid,))

    def invalidate_many(self, uids) -> None:
        """Drop every block of the (dead) tables and refuse late
        inserts for them (a reader racing this on an old snapshot) —
        ONE map scan however many tables died (a wide merge retiring
        a whole level must not hold the cache lock for N scans while
        foreground lookups contend)."""
        doomed = set(uids)
        if not doomed:
            return
        with self._lock:
            for uid in doomed:
                self._dead[uid] = None
            while len(self._dead) > self.DEAD_KEEP:
                self._dead.popitem(last=False)
            for key in [k for k in self._map if k[0] in doomed]:
                _r, nb = self._map.pop(key)
                self._bytes -= nb
            nb_now = self._bytes
        if self._perf is not None:
            self._perf.set("kv_cache_bytes", nb_now)

    def stats(self) -> dict:
        with self._lock:
            return {"bytes": self._bytes, "blocks": len(self._map),
                    "max_bytes": self.max_bytes}


def _parse_records(raw: bytes) -> list[tuple[bytes, int, bytes]]:
    """Decode one block's record run (always record-aligned: index
    entries are cut at record boundaries)."""
    out: list[tuple[bytes, int, bytes]] = []
    pos, n = 0, len(raw)
    while pos < n:
        (klen,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        ck = raw[pos: pos + klen]
        pos += klen
        tomb, vlen = struct.unpack_from("<BI", raw, pos)
        pos += 5
        out.append((ck, tomb, raw[pos: pos + vlen]))
        pos += vlen
    return out


class _Sst:
    """One immutable sorted table: bloom + sparse index resident, data
    read block-at-a-time on demand (via the shared cache).  Reads go
    through ``os.pread`` on a lazily-(re)opened handle: process-wide
    at most ``MAX_OPEN`` LIVE tables keep their fd (an LRU evicts the
    rest — a store past ~1000 tables must not exhaust the fd rlimit;
    the next pread reopens by path).  A table whose path a compaction
    unlinked is PINNED first (``pin_fd``) — its fd is the only
    remaining route to the bytes, so an in-flight reader holding an
    old levels snapshot keeps working."""

    _ids = itertools.count(1)

    #: soft cap of simultaneously-open LIVE sst handles, process-wide
    MAX_OPEN = 512
    _open: "OrderedDict[int, weakref.ref]" = OrderedDict()
    _open_lock = threading.Lock()

    def __init__(self, path: str):
        self.path = path
        self.uid = next(_Sst._ids)
        self._flock = threading.Lock()
        self._pinned = False
        self._f = open(path, "rb")
        self._note_open()
        fd = self._f.fileno()
        end = os.fstat(fd).st_size
        footer = self._pread(28, end - 28)
        bloom_off, index_off, self.n, crc = struct.unpack(
            "<QQII", footer[:-4])
        if footer[-4:] != _MAGIC:
            raise IOError(f"{path}: bad sst magic")
        meta = self._pread(end - 28 - bloom_off, bloom_off)
        if crc32c(meta) != crc:
            raise IOError(f"{path}: sst meta crc mismatch")
        self.bloom = _Bloom(bytearray(meta[:index_off - bloom_off]))
        d = Decoder(meta[index_off - bloom_off:])
        self.index: list[tuple[bytes, int]] = []
        for _ in range(d.u32()):
            first = d.blob()
            off = d.u64()
            self.index.append((first, off))
        self._index_keys = [f for f, _off in self.index]
        self._data_end = bloom_off
        self.nbytes = end
        self.first = self.index[0][0] if self.index else b""
        self.last = self._last_key() if self.index else b""

    def _note_open(self) -> None:
        """Register this table's open handle in the process-wide LRU;
        past MAX_OPEN, close the least-recently-opened UNPINNED live
        handle (its next pread reopens by path — self-correcting for
        hot tables)."""
        with _Sst._open_lock:
            _Sst._open[self.uid] = weakref.ref(self)
            _Sst._open.move_to_end(self.uid)
            if len(_Sst._open) <= _Sst.MAX_OPEN:
                return
            for uid in list(_Sst._open):
                if len(_Sst._open) <= _Sst.MAX_OPEN:
                    break
                if uid == self.uid:
                    continue
                victim = _Sst._open[uid]()
                if victim is None:
                    del _Sst._open[uid]
                    continue
                if victim._pinned:
                    del _Sst._open[uid]  # exempt from the cap
                    continue
                if not victim._flock.acquire(blocking=False):
                    continue  # mid-pread: pick another victim
                try:
                    if victim._f is not None:
                        victim._f.close()
                        victim._f = None
                finally:
                    victim._flock.release()
                del _Sst._open[uid]

    def _drop_open(self) -> None:
        with _Sst._open_lock:
            _Sst._open.pop(self.uid, None)

    def _pread(self, n: int, off: int) -> bytes:
        reopened = False
        with self._flock:
            if self._f is None:  # evicted from the handle LRU
                self._f = open(self.path, "rb")
                reopened = True
            data = os.pread(self._f.fileno(), n, off)
        if reopened:
            self._note_open()
        return data

    def pin_fd(self) -> None:
        """Called by compaction BEFORE unlinking this (dead) table:
        ensure the handle is open and exempt it from the LRU cap —
        once the path is gone the fd is the only route to the bytes
        an in-flight reader snapshot may still need."""
        with self._flock:
            if self._f is None:
                self._f = open(self.path, "rb")
            self._pinned = True
        self._drop_open()

    def close(self) -> None:
        self._drop_open()
        with self._flock:
            try:
                if self._f is not None:
                    self._f.close()
            except OSError:  # pragma: no cover
                pass
            self._f = None  # a later _pread reopens by path

    def __del__(self):  # a compacted-away table closes when the last
        try:            # reader snapshot referencing it is dropped
            self._drop_open()
            if self._f is not None:
                self._f.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def _block_span(self, bi: int) -> tuple[int, int]:
        off = self.index[bi][1]
        end = (self.index[bi + 1][1] if bi + 1 < len(self.index)
               else self._data_end)
        return off, end

    def _load_block(self, bi: int) -> list[tuple[bytes, int, bytes]]:
        off, end = self._block_span(bi)
        return _parse_records(self._pread(end - off, off))

    def _block(self, bi: int,
               cache: BlockCache | None) -> list[tuple[bytes, int, bytes]]:
        if cache is None:
            return self._load_block(bi)
        key = (self.uid, bi)
        records = cache.lookup(key)
        if records is None:
            records = self._load_block(bi)
            cache.insert(key, records)
        return records

    def _last_key(self) -> bytes:
        return self._load_block(len(self.index) - 1)[-1][0]

    def _block_for(self, ck: bytes) -> int:
        """Index of the block that could hold ck (the last block whose
        first key is <= ck; 0 when ck precedes everything)."""
        return max(0, bisect.bisect_right(self._index_keys, ck) - 1)

    @staticmethod
    def write(path: str, items: list[tuple[bytes, int, bytes]]) -> "_Sst":
        """items: sorted (composite_key, tomb, value)."""
        tmp = path + ".tmp"
        index: list[tuple[bytes, int]] = []
        with open(tmp, "wb") as f:
            block_start = 0
            for ck, tomb, val in items:
                off = f.tell()
                if off == 0 or off - block_start >= _BLOCK:
                    index.append((ck, off))
                    block_start = off
                f.write(struct.pack("<I", len(ck)))
                f.write(ck)
                f.write(struct.pack("<BI", tomb, len(val)))
                f.write(val)
            bloom_off = f.tell()
            bloom = _Bloom.build([ck for ck, _t, _v in items])
            e = Encoder()
            e.u32(len(index))
            for first, off in index:
                e.blob(first)
                e.u64(off)
            meta = bytes(bloom.bits) + e.tobytes()
            f.write(meta)
            f.write(struct.pack("<QQII", bloom_off,
                                bloom_off + len(bloom.bits),
                                len(items), crc32c(meta)))
            f.write(_MAGIC)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return _Sst(path)

    def scan(self, start_ck: bytes = b"", stop_ck: bytes | None = None,
             cache: BlockCache | None = None):
        """Yield (ck, tomb, value) for start_ck <= ck < stop_ck —
        streaming block by block (bounded memory: one parsed block at
        a time, never the whole file)."""
        if not self.index:
            return
        for bi in range(self._block_for(start_ck), len(self.index)):
            if stop_ck is not None and self.index[bi][0] >= stop_ck:
                return
            for rec in self._block(bi, cache):
                ck = rec[0]
                if stop_ck is not None and ck >= stop_ck:
                    return
                if ck >= start_ck:
                    yield rec

    def get(self, ck: bytes, cache: BlockCache | None = None):
        """(tomb, value) or None."""
        if not (self.first <= ck <= self.last) or not self.bloom.maybe(ck):
            return None
        records = self._block(self._block_for(ck), cache)
        i = bisect.bisect_left(records, (ck,))
        if i < len(records) and records[i][0] == ck:
            return records[i][1], records[i][2]
        return None


class _State:
    """One atomically-published read snapshot: sealed memtables
    (newest first, frozen dicts) + the level lists (immutable tuples,
    levels[0] newest-first).  Readers load ``store._state`` ONCE and
    resolve against it — a flush or merge publishing a new snapshot
    never blocks them."""

    __slots__ = ("imm", "levels")

    def __init__(self, imm: tuple = (), levels: tuple = ((),)):
        self.imm = imm
        self.levels = levels


def _merge_streams(sources: list):
    """K-way heap merge, newest-wins: ``sources`` are iterators of
    sorted (ck, tomb, value) runs ordered newest FIRST — for equal
    keys the lowest source index pops first (tuple order) and later
    duplicates are skipped.  Streaming: O(k) heap entries resident."""
    import heapq
    heap: list[tuple[bytes, int, tuple, object]] = []
    for si, it in enumerate(sources):
        first = next(it, None)
        if first is not None:
            heap.append((first[0], si, first, it))
    heapq.heapify(heap)
    prev: bytes | None = None
    while heap:
        ck, si, item, it = heapq.heappop(heap)
        nxt = next(it, None)
        if nxt is not None:
            heapq.heappush(heap, (nxt[0], si, nxt, it))
        if ck == prev:
            continue  # an older source's shadowed duplicate
        prev = ck
        yield item


class SstKV(KeyValueDB):
    L0_COMPACT_FILES = 4
    LEVEL_BASE_BYTES = 1 << 20      # L1 target; 10x per deeper level
    LEVEL_FANOUT = 10
    SST_SPLIT_BYTES = 1 << 20       # split compaction output files

    # write-stall thresholds (rocksdb slowdown/stop roles, instance
    # attrs so tests/benches can tune them per store)
    STALL_IMM_SLOWDOWN = 2          # sealed memtables pending: pace
    STALL_IMM_STOP = 4              # ...and stop
    STALL_L0_SLOWDOWN = 8           # L0 files: pace
    STALL_L0_STOP = 16              # ...and stop
    SLOWDOWN_SLEEP_S = 0.002        # per-write pacing delay

    #: crash-test points: names in this class-level set call
    #: ``os._exit(3)`` when reached (subprocess kill tests inject the
    #: PR-14-style mid-maintenance crashes deterministically)
    CRASH_POINTS: frozenset = frozenset()

    def __init__(self, path: str, memtable_bytes: int = 256 * 1024, *,
                 background: bool = True, cache_bytes: int = 8 << 20,
                 name: str | None = None,
                 perf: PerfCounters | None = None):
        os.makedirs(path, exist_ok=True)
        self._dir = path
        self._memtable_bytes = memtable_bytes
        self.background = bool(background)
        self.perf, self._owns_perf = resolve_kv_perf(name, perf)
        self._perf_name = f"kv.{name}" if name is not None else None
        self.cache = BlockCache(cache_bytes, self.perf)
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._mem: dict[bytes, tuple[int, bytes]] = {}  # ck->(tomb,val)
        self._mem_size = 0
        self._state = _State()
        #: sealed (memtable, wal_path) pairs OLDEST first — the flush
        #: thread's work queue; _state.imm mirrors it newest-first
        self._imm_meta: list[tuple[dict, str]] = []
        self._seq = 0
        self._wal_seq = 0
        self._manifest = os.path.join(path, "MANIFEST")
        #: manifest writes happen OUTSIDE the store lock (an fsync
        #: under the cv would stall every submitter behind the
        #: publish) — the pub_seq taken at the state swap orders them
        #: so a slower writer can never clobber a newer manifest
        self._manifest_mutex = threading.Lock()
        self._pub_seq = 0               # under the cv, at state swap
        self._manifest_written = 0      # under _manifest_mutex
        self._stopping = False
        #: set by close() AFTER the thread joins (even timed-out
        #: ones): a maintenance publish that lost the race must NOT
        #: rewrite the manifest from the emptied state — its outputs
        #: become orphans open-time GC removes, its WAL segment stays
        #: replayable
        self._closed = False
        #: maintenance passes in flight (flush/compact from pick to
        #: epilogue INCLUDING dead-file unlinks + counters) — a
        #: publish makes _pick return None before the epilogue runs,
        #: so wait_maintenance_idle needs this to not return early
        self._maint_busy = 0
        self._failed: BaseException | None = None
        self._compact_kick = False
        #: test seams: point-name -> callable, invoked at the same
        #: spots as CRASH_POINTS (wedge a flush to force stalls, etc.)
        self.test_hooks: dict = {}
        self._load_manifest()
        self._gc_stale_tmp()
        self._open_recover()
        self._flush_thread: threading.Thread | None = None
        self._compact_thread: threading.Thread | None = None
        if self.background:
            self._flush_thread = threading.Thread(
                target=self._flush_loop, daemon=True,
                name=f"kv-flush-{name or 'sst'}")
            self._compact_thread = threading.Thread(
                target=self._compact_loop, daemon=True,
                name=f"kv-compact-{name or 'sst'}")
            self._flush_thread.start()
            self._compact_thread.start()
        # a freshly-opened store may already be over a compaction
        # threshold (e.g. crash-recovery flushes piled L0 files)
        with self._cv:
            self._signal_compact_locked()

    # ------------------------------------------------------- manifest/wal
    def _load_manifest(self) -> None:
        if not os.path.exists(self._manifest):
            return
        with open(self._manifest, "rb") as f:
            d = Decoder(f.read())
        self._seq = d.u64()
        levels = []
        for _ in range(d.u32()):
            names = [d.string() for _ in range(d.u32())]
            levels.append(tuple(_Sst(os.path.join(self._dir, n))
                                for n in names))
        self._state = _State(levels=tuple(levels) or ((),))

    def _publish_state_locked(self) -> tuple:
        """Caller holds the cv and just swapped ``self._state``: take
        the (state, file_seq, pub_seq) snapshot ``_write_manifest``
        persists OUTSIDE the lock."""
        self._pub_seq += 1
        return self._state, self._seq, self._pub_seq

    def _write_manifest(self, state: _State, file_seq: int,
                        pub_seq: int) -> None:
        """Durably persist one published state (no store lock held —
        submitters never wait on this fsync).  Concurrent publishers
        serialize on the manifest mutex; a writer that lost the race
        to a NEWER publish skips (the newer manifest already covers
        its swap, so its own unlinks stay safe)."""
        with self._manifest_mutex:
            if pub_seq <= self._manifest_written:
                return
            e = Encoder()
            e.u64(file_seq)
            levels = state.levels
            e.u32(len(levels))
            for level in levels:
                e.u32(len(level))
                for sst in level:
                    e.string(os.path.basename(sst.path))
            tmp = self._manifest + ".tmp"
            with open(tmp, "wb") as f:
                f.write(e.tobytes())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._manifest)
            self._manifest_written = pub_seq

    def _gc_stale_tmp(self) -> None:
        for fn in os.listdir(self._dir):
            if fn.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self._dir, fn))
                except OSError:  # pragma: no cover
                    pass

    def _gc_orphans(self) -> None:
        """Remove sst files present on disk but absent from the
        manifest — the crash window between an sst write and its
        manifest (flush/compaction output) or between a manifest and
        its dead-file unlinks leaks files forever otherwise."""
        live = {os.path.basename(s.path)
                for lvl in self._state.levels for s in lvl}
        for fn in os.listdir(self._dir):
            if not (fn.startswith("sst_") and fn.endswith(".sst")):
                continue
            # keep the seq monotone past every file ever created, so a
            # new file can never collide with a just-GC'd orphan name
            try:
                self._seq = max(self._seq, int(fn[4:-4]))
            except ValueError:  # pragma: no cover - foreign file
                continue
            if fn not in live:
                try:
                    os.remove(os.path.join(self._dir, fn))
                except OSError:  # pragma: no cover
                    pass

    def _wal_segments(self) -> list[str]:
        """On-disk WAL segments, oldest first (the legacy single-file
        name sorts before the numbered segments it predates)."""
        segs = sorted(fn for fn in os.listdir(self._dir)
                      if fn.startswith("wal_") and fn.endswith(".log"))
        legacy = os.path.join(self._dir, "memtable.wal")
        out = [legacy] if os.path.exists(legacy) else []
        for fn in segs:
            try:
                self._wal_seq = max(self._wal_seq, int(fn[4:-4]))
            except ValueError:  # pragma: no cover
                continue
            out.append(os.path.join(self._dir, fn))
        return out

    def _open_recover(self) -> None:
        """Open-time recovery: replay every WAL segment (oldest first)
        into the memtable, GC orphaned ssts, then — if anything
        replayed — flush straight to L0 (the durability point for
        those keys moves into the manifest) and retire ALL segments,
        starting from a clean slate."""
        segs = self._wal_segments()
        for seg in segs:
            self._replay_segment(seg)
        self._gc_orphans()
        if self._mem:
            items = [(ck, t, v)
                     for ck, (t, v) in sorted(self._mem.items())]
            sst = _Sst.write(
                os.path.join(self._dir, self._next_name_locked()), items)
            lv0 = (sst,) + self._state.levels[0]
            self._state = _State(levels=(lv0,) + self._state.levels[1:])
            self._write_manifest(*self._publish_state_locked())
            self.perf.inc("kv_flush")
            self._mem = {}
            self._mem_size = 0
        for seg in segs:
            try:
                os.remove(seg)
            except OSError:  # pragma: no cover
                pass
        self._wal_seq += 1
        self._wal_path = os.path.join(self._dir,
                                      f"wal_{self._wal_seq:08d}.log")
        self._wal = open(self._wal_path, "ab")
        self._set_gauges_locked()

    def _replay_segment(self, path: str) -> None:
        with open(path, "rb") as f:
            raw = f.read()
        pos = 0
        while pos + 8 <= len(raw):
            length, crc = struct.unpack_from("<II", raw, pos)
            payload = raw[pos + 8: pos + 8 + length]
            if len(payload) < length or crc32c(payload) != crc:
                break  # torn tail
            d = Decoder(payload)
            if d.u8() == _REC_TX:
                for _ in range(d.u32()):
                    ck, tomb, val = d.blob(), d.u8(), d.blob()
                    self._mem_put(ck, tomb, val)
            pos += 8 + length
        if pos < len(raw):
            with open(path, "r+b") as f:
                f.truncate(pos)

    def _mem_put(self, ck: bytes, tomb: int, val: bytes) -> None:
        old = self._mem.get(ck)
        if old is not None:
            self._mem_size -= len(ck) + len(old[1])
        self._mem[ck] = (tomb, val)
        self._mem_size += len(ck) + len(val)

    def _crashpoint(self, point: str) -> None:
        hook = self.test_hooks.get(point)
        if hook is not None:
            hook()
        if point in self.CRASH_POINTS:
            os._exit(3)

    def _set_gauges_locked(self) -> None:
        self.perf.set("kv_imm_memtables", len(self._state.imm))
        self.perf.set("kv_l0_files", len(self._state.levels[0]))

    # ----------------------------------------------------------------- api
    def _check_failed_locked(self) -> None:
        if self._failed is not None:
            raise IOError(f"kv maintenance failed: {self._failed!r}")

    def _stall_locked(self) -> None:
        """Write-stall backpressure: pace (slowdown) then block (stop)
        the writer while background maintenance is behind.  Inline
        mode never stalls — maintenance runs in the write itself."""
        if not self.background:
            return
        st = self._state
        n_imm, n_l0 = len(st.imm), len(st.levels[0])
        if n_imm < self.STALL_IMM_SLOWDOWN \
                and n_l0 < self.STALL_L0_SLOWDOWN:
            return
        t0 = time.monotonic()
        if n_imm >= self.STALL_IMM_STOP or n_l0 >= self.STALL_L0_STOP:
            self.perf.inc("kv_stall_memtable"
                          if n_imm >= self.STALL_IMM_STOP
                          else "kv_stall_l0")
            while (self._failed is None and not self._stopping):
                st = self._state
                if len(st.imm) < self.STALL_IMM_STOP \
                        and len(st.levels[0]) < self.STALL_L0_STOP:
                    break
                self._cv.wait(0.5)
            self._check_failed_locked()
        else:
            self.perf.inc("kv_slowdown")
            self._cv.wait(self.SLOWDOWN_SLEEP_S)  # releases the lock
        self.perf.hinc("kv_stall_us", (time.monotonic() - t0) * 1e6)

    def submit(self, tx: KVTransaction, sync: bool = True) -> None:
        with self._cv:
            self._check_failed_locked()
            self._stall_locked()
            if self._stopping or self._wal is None:
                # a writer that was stalled when close() landed (or a
                # straggler submitting after it) must fail cleanly,
                # not dereference the torn-down WAL
                raise IOError("kv store is closing")
            flat: list[tuple[bytes, int, bytes]] = []
            for op, prefix, key, val in tx.ops:
                if op == "put":
                    flat.append((_ckey(prefix, key), 0, val))
                elif op == "rm":
                    flat.append((_ckey(prefix, key), _TOMB, b""))
                else:  # rm_prefix: tombstone every live key in range —
                    # including keys PUT earlier in this same tx
                    # (KVTransaction ops apply in order, as MemKV does).
                    # The doom scan bypasses the block cache: it reads
                    # blocks that are about to be tombstoned — they
                    # must not evict the hot read working set (same
                    # policy as compaction scans)
                    doomed = {_ckey(prefix, k)
                              for k, _v in self._iterate(prefix, "",
                                                         None)}
                    pfx = prefix.encode() + b"\x00"
                    doomed |= {ck for ck, t, _v in flat
                               if ck.startswith(pfx) and not t}
                    flat.extend((ck, _TOMB, b"") for ck in sorted(doomed))
            e = Encoder()
            e.u8(_REC_TX)
            e.u32(len(flat))
            for ck, tomb, val in flat:
                e.blob(ck)
                e.u8(tomb)
                e.blob(val)
            payload = e.tobytes()
            self._wal.write(struct.pack("<II", len(payload),
                                        crc32c(payload)) + payload)
            if sync:
                self._wal.flush()
                os.fsync(self._wal.fileno())
            # lock-free readers must never observe HALF a transaction
            # (e.g. a put already applied but the same tx's rm_prefix
            # tombstone not yet): collapse the tx to its final image
            # and apply it as ONE dict.update — a single C-level call
            # over bytes keys, so CPython readers see pre-tx or
            # post-tx, never in between
            patch: dict[bytes, tuple[int, bytes]] = {}
            for ck, tomb, val in flat:
                patch[ck] = (tomb, val)
            for ck, tv in patch.items():
                old = self._mem.get(ck)
                if old is not None:
                    self._mem_size -= len(ck) + len(old[1])
                self._mem_size += len(ck) + len(tv[1])
            self._mem.update(patch)
            if self._mem_size >= self._memtable_bytes:
                self._seal_locked()

    def sync(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.flush()
                os.fsync(self._wal.fileno())

    def get(self, prefix: str, key: str) -> bytes | None:
        ck = _ckey(prefix, key)
        # lock-free read: load the active memtable FIRST, the snapshot
        # second.  A seal publishes the new snapshot (sealed memtable
        # in imm) BEFORE swapping the active dict, so a reader that
        # sees the fresh (empty) active table is guaranteed to see the
        # sealed one in the snapshot it loads after.
        mem = self._mem
        state = self._state
        hit = mem.get(ck)
        if hit is not None:
            return None if hit[0] else hit[1]
        for imm in state.imm:                  # sealed, newest first
            hit = imm.get(ck)
            if hit is not None:
                return None if hit[0] else hit[1]
        for sst in state.levels[0]:            # L0 newest-first
            hit = sst.get(ck, self.cache)
            if hit is not None:
                return None if hit[0] else hit[1]
        for level in state.levels[1:]:         # non-overlapping
            for sst in level:
                if sst.first <= ck <= sst.last:
                    hit = sst.get(ck, self.cache)
                    if hit is not None:
                        return None if hit[0] else hit[1]
                    break
        return None

    def iterate(self, prefix: str, start: str = ""):
        """Merged newest-wins iteration over memtable + sealed
        memtables + every level — a streaming k-way heap merge over
        the read snapshot (lock held only to copy the active
        memtable's range; sst runs decode one block at a time)."""
        return self._iterate(prefix, start, self.cache)

    def _iterate(self, prefix: str, start: str,
                 cache: BlockCache | None):
        lo = _ckey(prefix, start)
        hi = prefix.encode() + b"\x01"  # end of the prefix's range
        with self._lock:
            mem_items = [(ck, tv[0], tv[1])
                         for ck, tv in sorted(self._mem.items())
                         if lo <= ck < hi]
            state = self._state
        sources = [iter(mem_items)]
        for imm in state.imm:  # frozen after seal: safe unlocked
            sources.append(iter(sorted(
                (ck, tv[0], tv[1]) for ck, tv in imm.items()
                if lo <= ck < hi)))
        for sst in state.levels[0]:
            sources.append(sst.scan(lo, hi, cache))
        for level in state.levels[1:]:
            run = [s for s in level
                   if not (s.last < lo or s.first >= hi)]
            if run:  # non-overlapping: chain is one sorted stream
                sources.append(itertools.chain.from_iterable(
                    s.scan(lo, hi, cache) for s in run))
        for ck, tomb, val in _merge_streams(sources):
            if not tomb:
                yield _split(ck)[1], val

    def wait_maintenance_idle(self, timeout: float = 30.0) -> bool:
        """Block until background maintenance has drained — no sealed
        memtable pending flush, no level over its compaction trigger,
        and no pass still in its post-publish epilogue (unlinks +
        counters land AFTER the manifest publish that flips _pick).
        A bench/test quiesce point (NOT part of the write path): the
        flush/compaction threads notify the cv on every transition."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while (self._imm_meta or self._maint_busy
                   or (self.background
                       and self._pick_compaction_locked() is not None)):
                if self._failed is not None or self._stopping:
                    return False
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.05))
            return True

    def close(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        for t in (self._flush_thread, self._compact_thread):
            if t is not None:
                t.join(timeout=30)
        with self._lock:
            # even after a TIMED-OUT join: a still-running maintenance
            # publish checks this under the lock and aborts instead of
            # rewriting the manifest from the emptied state below
            self._closed = True
            if self._wal:
                self._wal.close()
                self._wal = None
            # NOT s.close(): a lock-free reader may still be mid-pread
            # on a table (get()/iterate() take no lock by design) — the
            # same policy compaction applies to dead tables.  Dropping
            # the store's snapshot reference closes each fd when the
            # last reader's reference drops (_Sst.__del__); reads that
            # START after close see the empty snapshot.
            self._state = _State()
        if self._owns_perf and self._perf_name:
            global_perf().remove(self._perf_name)

    # ------------------------------------------------------ seal + flush
    def _next_name_locked(self) -> str:
        self._seq += 1
        return f"sst_{self._seq:08d}.sst"

    def _seal_locked(self) -> None:
        """Full memtable -> immutable memtable: fsync + close the
        active WAL segment (its bytes may be the ONLY copy of unsynced
        submits), hand the pair to the flush thread, and continue into
        a fresh memtable + fresh segment.  Inline mode flushes (and
        compacts) right here instead — the pre-background behavior."""
        if not self._mem:
            return
        self._wal.flush()
        os.fsync(self._wal.fileno())
        self._wal.close()
        sealed, sealed_path = self._mem, self._wal_path
        self._imm_meta.append((sealed, sealed_path))
        self._state = _State(imm=(sealed,) + self._state.imm,
                             levels=self._state.levels)
        self._mem = {}
        self._mem_size = 0
        self._wal_seq += 1
        self._wal_path = os.path.join(self._dir,
                                      f"wal_{self._wal_seq:08d}.log")
        self._wal = open(self._wal_path, "ab")
        self._set_gauges_locked()
        if self.background:
            self._cv.notify_all()  # wake the flush thread
            return
        # inline maintenance (background=off): the caller's thread
        # pays the flush — and any cascading compaction — right now,
        # booked as kv_*_inline (the cliff the background seam removes)
        self._flush_one(sealed, sealed_path)
        self.perf.inc("kv_flush_inline")
        while True:
            ln = self._pick_compaction_locked()
            if ln is None:
                break
            self._compact_level(ln)
            self.perf.inc("kv_compact_inline")

    def _flush_loop(self) -> None:
        while True:
            with self._cv:
                while not self._imm_meta and not self._stopping:
                    self._cv.wait()
                if self._closed or not self._imm_meta:
                    return  # store torn down / stopping and drained
                mem, wal_path = self._imm_meta[0]  # oldest; popped by
                #                                    _flush_one's publish
                self._maint_busy += 1
            try:
                self._flush_one(mem, wal_path)
            except BaseException as e:  # noqa: BLE001 - disk fail: the
                # store poisons (submit raises; the commit pipeline
                # poisons in turn) rather than silently losing the seal
                with self._cv:
                    self._failed = e
                    self._cv.notify_all()
                from ..utils.log import dout
                dout("kv", 0)("kv flush FAILED (store poisoned): %r", e)
                return
            finally:
                with self._cv:
                    self._maint_busy -= 1
                    self._cv.notify_all()

    def _flush_one(self, mem: dict, wal_path: str) -> None:
        """Write one sealed memtable to L0 (no lock: the memtable is
        frozen), publish manifest+levels under a short critical
        section, then retire the WAL segment (strictly after the
        manifest that makes its contents reachable is durable)."""
        t0 = time.monotonic()
        items = [(ck, t, v) for ck, (t, v) in sorted(mem.items())]
        with self._cv:
            name = self._next_name_locked()
        sst = _Sst.write(os.path.join(self._dir, name), items)
        self._crashpoint("flush.pre_manifest")
        with self._cv:
            if self._closed:
                # close() won the race (timed-out join): publishing
                # now would rewrite the manifest from the emptied
                # state and orphan every live sst.  The new file is
                # the orphan instead; the WAL segment stays for replay
                return
            lv0 = (sst,) + self._state.levels[0]
            imm = tuple(m for m in self._state.imm if m is not mem)
            self._state = _State(imm=imm,
                                 levels=(lv0,) + self._state.levels[1:])
            self._imm_meta = [p for p in self._imm_meta
                              if p[0] is not mem]
            pub = self._publish_state_locked()
            self._set_gauges_locked()
            self._signal_compact_locked()
            self._cv.notify_all()  # stalled writers re-check
        self._write_manifest(*pub)
        self._crashpoint("flush.pre_wal_unlink")
        try:
            os.remove(wal_path)
        except OSError:  # pragma: no cover
            pass
        self.perf.inc("kv_flush")
        self.perf.hinc("kv_flush_us", (time.monotonic() - t0) * 1e6)

    # ---------------------------------------------------------- compaction
    def _pick_compaction_locked(self):
        levels = self._state.levels
        if len(levels[0]) > self.L0_COMPACT_FILES:
            return 0
        limit = self.LEVEL_BASE_BYTES
        for ln in range(1, len(levels)):
            if sum(s.nbytes for s in levels[ln]) > limit:
                return ln
            limit *= self.LEVEL_FANOUT
        return None

    def _signal_compact_locked(self) -> None:
        if self.background and self._pick_compaction_locked() is not None:
            self._compact_kick = True
            self._cv.notify_all()

    def _compact_loop(self) -> None:
        while True:
            with self._cv:
                while not self._compact_kick and not self._stopping:
                    self._cv.wait()
                if self._stopping:
                    return
                self._compact_kick = False
            try:
                while not self._stopping and not self._closed:
                    with self._cv:
                        ln = self._pick_compaction_locked()
                        if ln is not None:
                            self._maint_busy += 1
                    if ln is None:
                        break
                    try:
                        self._compact_level(ln)
                    finally:
                        with self._cv:
                            self._maint_busy -= 1
                            self._cv.notify_all()
            except BaseException as e:  # noqa: BLE001
                with self._cv:
                    self._failed = e
                    self._cv.notify_all()
                from ..utils.log import dout
                dout("kv", 0)(
                    "kv compaction FAILED (store poisoned): %r", e)
                return

    def _compact_level(self, ln: int) -> None:
        """Merge level ln (+ the overlapping files of ln+1) into ln+1
        as a STREAMING k-way merge against an immutable snapshot of
        the level lists — O(one output chunk) resident, never the
        whole level.  Tombstones drop when the output is the
        bottom-most data.  The new manifest publishes under a short
        critical section; dead inputs unlink strictly after it (a
        crash in between leaks orphans that open-time GC removes).
        Scans bypass the block cache — a merge must not evict the
        read working set."""
        t0 = time.monotonic()
        state = self._state  # immutable input snapshot
        levels = state.levels
        while len(levels) <= ln + 1:
            levels = levels + ((),)
        upper = list(levels[ln])
        if not upper:
            return
        lo = min(s.first for s in upper)
        hi = max(s.last for s in upper)
        lower, keep = [], []
        for s in levels[ln + 1]:
            (lower if not (s.last < lo or s.first > hi)
             else keep).append(s)
        bottom = (ln + 2 >= len(levels)
                  or all(not lvl for lvl in levels[ln + 2:]))
        # newest-wins sources: L0 files are newest-first; the lower
        # level is older than everything above it and non-overlapping
        # (one chained sorted stream)
        sources = [s.scan() for s in upper]
        if lower:
            sources.append(itertools.chain.from_iterable(
                s.scan() for s in sorted(lower, key=lambda s: s.first)))
        new_ssts: list[_Sst] = []
        chunk: list[tuple[bytes, int, bytes]] = []
        size = 0
        for ck, tomb, val in _merge_streams(sources):
            if tomb and bottom:
                continue  # tombstone reached the bottom: drop for real
            chunk.append((ck, tomb, val))
            size += len(ck) + len(val)
            if size >= self.SST_SPLIT_BYTES:
                with self._cv:
                    name = self._next_name_locked()
                new_ssts.append(_Sst.write(
                    os.path.join(self._dir, name), chunk))
                chunk, size = [], 0
        if chunk:
            with self._cv:
                name = self._next_name_locked()
            new_ssts.append(_Sst.write(
                os.path.join(self._dir, name), chunk))
        self._crashpoint("compact.pre_manifest")
        dead = upper + lower
        with self._cv:
            if self._closed:
                return  # see _flush_one: a post-close publish would
                #         orphan every live sst; the merge outputs are
                #         the orphans instead (open-time GC)
            cur = list(self._state.levels)
            while len(cur) <= ln + 1:
                cur.append(())
            # L0 may have grown newer files while we merged: keep them
            upper_set = {s.uid for s in upper}
            cur[ln] = tuple(s for s in cur[ln]
                            if s.uid not in upper_set)
            cur[ln + 1] = tuple(sorted(keep + new_ssts,
                                       key=lambda s: s.first))
            self._state = _State(imm=self._state.imm,
                                 levels=tuple(cur))
            pub = self._publish_state_locked()
            self._set_gauges_locked()
            self._cv.notify_all()  # stalled writers re-check
        self._write_manifest(*pub)
        self._crashpoint("compact.pre_unlink")
        self.cache.invalidate_many(s.uid for s in dead)
        for s in dead:
            # NOT s.close(): a lock-free reader may still hold the old
            # snapshot — pin the fd then unlink (removing the name
            # only; preads keep working, the fd closes when the last
            # reference drops)
            s.pin_fd()
            try:
                os.remove(s.path)
            except OSError:  # pragma: no cover
                pass
        self.perf.inc("kv_compact")
        self.perf.hinc("kv_compact_us", (time.monotonic() - t0) * 1e6)

    # ------------------------------------------------------- observability
    def stats(self) -> dict:
        with self._lock:
            st = self._state
            return {"memtable_bytes": self._mem_size,
                    "imm_memtables": len(st.imm),
                    "levels": [len(lv) for lv in st.levels],
                    "files": sum(len(lv) for lv in st.levels),
                    "background": self.background,
                    "flushes": self.perf.get("kv_flush"),
                    "compactions": self.perf.get("kv_compact"),
                    "flushes_inline": self.perf.get("kv_flush_inline"),
                    "compactions_inline":
                        self.perf.get("kv_compact_inline"),
                    "stalls": (self.perf.get("kv_stall_memtable")
                               + self.perf.get("kv_stall_l0")),
                    "slowdowns": self.perf.get("kv_slowdown"),
                    "cache": self.cache.stats()}
