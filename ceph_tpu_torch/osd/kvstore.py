"""KeyValueDB: the KV abstraction + a durable WAL/snapshot store.

The capability of the reference's src/kv/ (KeyValueDB.h interface over
RocksDBStore, consumed by BlueStore metadata and MonitorDBStore):

- `KeyValueDB`: get/put/rm per (prefix, key), atomic transactions,
  ordered iteration within a prefix — the interface BlueStore-shaped
  stores program against;
- `WalKV`: a durable implementation with the store family's WAL
  contract — every transaction appends a crc-framed fsync'd record
  ([u32 len][u32 crc32c][payload]); a torn tail is discarded on open;
  the log compacts to a snapshot when it outgrows the live data (so
  neither the file nor open-replay grows with history).  The snapshot
  rewrite is an inline stall in miniature (the whole live set encodes
  + fsyncs inside submit) — it is COUNTED (``kv_wal_compact_us``) and
  can move behind a background thread (``bg_compact=True``: writers
  keep appending to the live file while the snapshot writes to a tmp;
  frames landed since the snapshot replay into the tmp under a short
  critical section before the rename).
- `SstKV` (sstkv.py): the leveled LSM stack (RocksDB-tier) with
  background memtable flush / compaction threads, a shared block
  cache and counted write stalls.

Every durable backend books maintenance onto one shared counter
schema (``register_kv_counters`` → registry ``kv.<store>``) so the
exporter/metrics-history see a stable shape across backends.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from abc import ABC, abstractmethod

from ..ops.native import crc32c
from ..utils.codec import Decoder, Encoder
from ..utils.perf import CounterType, PerfCounters, global_perf

# --------------------------------------------------------------- kv perf
#: the KV-tier maintenance schema (registry ``kv.<store>``), registered
#: zeroed so scrapes see one stable shape whether or not maintenance has
#: run yet.  ``*_inline`` counters book maintenance performed in the
#: SUBMIT path (the caller's — for the async store pipeline, the
#: kv-sync thread's) — the quantity the background seam drives to zero.
KV_COUNTERS = ("kv_flush", "kv_flush_inline",
               "kv_compact", "kv_compact_inline",
               "kv_stall_memtable", "kv_stall_l0", "kv_slowdown",
               "kv_cache_hit", "kv_cache_miss", "kv_cache_evict",
               "kv_wal_compact", "kv_wal_compact_inline")
KV_HISTOGRAMS = ("kv_flush_us", "kv_compact_us", "kv_stall_us",
                 "kv_wal_compact_us")
KV_GAUGES = ("kv_cache_bytes", "kv_imm_memtables", "kv_l0_files")


def register_kv_counters(perf: PerfCounters) -> None:
    """Idempotently register the KV maintenance counter schema."""
    for n in KV_COUNTERS:
        if not perf.has(n):
            perf.add(n)
    for n in KV_HISTOGRAMS:
        if not perf.has(n):
            perf.add(n, CounterType.HISTOGRAM)
    for n in KV_GAUGES:
        if not perf.has(n):
            perf.add(n, CounterType.U64)


def resolve_kv_perf(name: str | None,
                    perf: PerfCounters | None) -> tuple[PerfCounters, bool]:
    """The booking registry for one KV store: an explicit ``perf``, the
    process-global ``kv.<name>`` when named (owned: the store removes
    it on close), else an anonymous local registry (unit-test stores
    must not grow the exporter's scrape)."""
    if perf is not None:
        pc, owned = perf, False
    elif name is not None:
        pc, owned = global_perf().create(f"kv.{name}"), True
    else:
        pc, owned = PerfCounters("kv.anon"), False
    register_kv_counters(pc)
    return pc, owned


class KVTransaction:
    """Atomic batch (KeyValueDB::Transaction role)."""

    def __init__(self):
        self.ops: list[tuple] = []  # ("put", prefix, key, val)|("rm",..)

    def put(self, prefix: str, key: str, value: bytes) -> "KVTransaction":
        self.ops.append(("put", prefix, key, bytes(value)))
        return self

    def rm(self, prefix: str, key: str) -> "KVTransaction":
        self.ops.append(("rm", prefix, key, b""))
        return self

    def rm_prefix(self, prefix: str) -> "KVTransaction":
        self.ops.append(("rmp", prefix, "", b""))
        return self


class KeyValueDB(ABC):
    @abstractmethod
    def submit(self, tx: KVTransaction, sync: bool = True) -> None:
        """Apply one atomic batch.  ``sync=False`` defers durability:
        the record is written (appended) but not fsync'd — the group-
        commit path submits a whole batch unsynced then calls
        ``sync()`` ONCE (the kv-sync-thread contract)."""

    @abstractmethod
    def get(self, prefix: str, key: str) -> bytes | None: ...

    @abstractmethod
    def iterate(self, prefix: str, start: str = ""): ...

    def sync(self) -> None:
        """Make every prior unsynced submit durable (one fsync)."""

    def put(self, prefix: str, key: str, value: bytes) -> None:
        self.submit(KVTransaction().put(prefix, key, value))

    def rm(self, prefix: str, key: str) -> None:
        self.submit(KVTransaction().rm(prefix, key))

    def stats(self) -> dict:
        """Backend maintenance/occupancy stats (the `kv stats` admin
        surface; durable backends override)."""
        return {}

    def close(self) -> None: ...


_REC_TX, _REC_SNAP = 1, 2


class MemKV(KeyValueDB):
    """In-memory KeyValueDB (tests / volatile stores)."""

    def __init__(self):
        self._data: dict[str, dict[str, bytes]] = {}
        self._lock = threading.RLock()

    def submit(self, tx: KVTransaction, sync: bool = True) -> None:
        with self._lock:
            for op, prefix, key, val in tx.ops:
                if op == "put":
                    self._data.setdefault(prefix, {})[key] = val
                elif op == "rm":
                    self._data.get(prefix, {}).pop(key, None)
                else:
                    self._data.pop(prefix, None)

    def get(self, prefix: str, key: str) -> bytes | None:
        with self._lock:
            return self._data.get(prefix, {}).get(key)

    def iterate(self, prefix: str, start: str = ""):
        with self._lock:
            items = sorted(self._data.get(prefix, {}).items())
        for k, v in items:
            if k >= start:
                yield k, v


class WalKV(MemKV):
    """Durable KV: MemKV state + crc-framed WAL + snapshot compaction
    (the FileStore/DurableMonStore WAL contract over KV semantics).

    Snapshot compaction is counted (``kv_wal_compact_us`` +
    ``kv_wal_compact[_inline]`` on the ``kv.<name>`` registry) and,
    with ``bg_compact=True``, moves off the submit path: a dedicated
    thread snapshots the live data under the lock, encodes + writes
    the tmp file UNLOCKED while writers keep appending to the live
    file (each new frame also lands in a pending buffer), then under a
    short critical section replays the pending frames into the tmp,
    fsyncs and renames.  A crash mid-compaction loses nothing: the
    live file keeps every synced frame until the rename, and the tmp
    is complete (snapshot + pending tail) before it replaces anything.
    ``store_sync_commit=on`` remains the orthogonal escape hatch (no
    group commit ⇒ every submit pays its own fsync, compaction
    included, with the pre-pipeline interleaving)."""

    COMPACT_RATIO = 4  # compact when log bytes > ratio * live bytes

    def __init__(self, path: str, *, name: str | None = None,
                 perf: PerfCounters | None = None,
                 bg_compact: bool = False):
        super().__init__()
        os.makedirs(path, exist_ok=True)
        self._path = os.path.join(path, "kv.wal")
        self._file = None
        self._log_bytes = 0
        self._live_bytes = 0
        self.perf, self._owns_perf = resolve_kv_perf(name, perf)
        self._perf_name = f"kv.{name}" if name is not None else None
        self._bg = bool(bg_compact)
        self._cv = threading.Condition(self._lock)
        self._compacting = False     # bg snapshot in flight
        self._compact_kick = False
        self._pending_frames: list[bytes] = []  # frames since snapshot
        self._stopping = False
        self._compact_thread: threading.Thread | None = None
        # a crash mid-compaction leaves a snapshot-sized tmp the live
        # file supersedes (the rename never happened) — drop it
        try:
            os.remove(self._path + ".tmp")
        except OSError:
            pass
        self._load()
        self._file = open(self._path, "ab")
        if self._bg:
            self._compact_thread = threading.Thread(
                target=self._compact_loop, daemon=True,
                name=f"kv-wal-compact-{name or 'anon'}")
            self._compact_thread.start()

    # -- framing -----------------------------------------------------------
    @staticmethod
    def _frame(payload: bytes) -> bytes:
        return struct.pack("<II", len(payload), crc32c(payload)) + payload

    def _load(self) -> None:
        if not os.path.exists(self._path):
            return
        with open(self._path, "rb") as f:
            raw = f.read()
        pos = 0
        while pos + 8 <= len(raw):
            length, crc = struct.unpack_from("<II", raw, pos)
            payload = raw[pos + 8: pos + 8 + length]
            if len(payload) < length or crc32c(payload) != crc:
                break  # torn tail
            self._apply_payload(payload)
            pos += 8 + length
        if pos < len(raw):
            with open(self._path, "r+b") as f:
                f.truncate(pos)
        self._log_bytes = pos
        self._live_bytes = self._live_size()

    def _apply_payload(self, payload: bytes) -> None:
        d = Decoder(payload)
        kind = d.u8()
        if kind == _REC_TX:
            tx = KVTransaction()
            for _ in range(d.u32()):
                op, prefix, key, val = d.string(), d.string(), \
                    d.string(), d.blob()
                tx.ops.append((op, prefix, key, val))
            MemKV.submit(self, tx)
        elif kind == _REC_SNAP:
            self._data = {}
            for _ in range(d.u32()):
                prefix = d.string()
                self._data[prefix] = d.mapping(Decoder.string,
                                               Decoder.blob)

    def _live_size(self) -> int:
        return sum(len(k) + len(v)
                   for kv in self._data.values()
                   for k, v in kv.items()) or 1

    # -- api ---------------------------------------------------------------
    def submit(self, tx: KVTransaction, sync: bool = True) -> None:
        """Append one crc-framed record (+apply).  ``sync=False`` skips
        the fsync — the group-commit caller batches N submits behind
        ONE ``sync()``; a crash before it loses only unacked records
        (each frame is individually crc-gated, so replay applies the
        committed prefix and discards the torn tail)."""
        e = Encoder()
        e.u8(_REC_TX)
        e.u32(len(tx.ops))
        for op, prefix, key, val in tx.ops:
            e.string(op)
            e.string(prefix)
            e.string(key)
            e.blob(val)
        payload = e.tobytes()
        with self._lock:
            super().submit(tx)
            frame = self._frame(payload)
            self._file.write(frame)
            if self._compacting:
                # a bg snapshot is in flight: this frame postdates it,
                # so it must replay into the tmp before the rename
                self._pending_frames.append(frame)
            if sync:
                self._file.flush()
                os.fsync(self._file.fileno())
            self._log_bytes += len(payload) + 8
            if self._log_bytes > self.COMPACT_RATIO * \
                    max(self._live_bytes, 4096):
                if self._bg:
                    if not self._compacting and not self._compact_kick:
                        self._compact_kick = True
                        self._cv.notify_all()
                else:
                    t0 = time.monotonic()
                    self._compact()
                    self.perf.inc("kv_wal_compact")
                    self.perf.inc("kv_wal_compact_inline")
                    self.perf.hinc("kv_wal_compact_us",
                                   (time.monotonic() - t0) * 1e6)

    def sync(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())

    def _snapshot_frame(self, data: dict) -> bytes:
        e = Encoder()
        e.u8(_REC_SNAP)
        e.u32(len(data))
        for prefix in sorted(data):
            e.string(prefix)
            e.mapping(data[prefix], Encoder.string, Encoder.blob)
        return self._frame(e.tobytes())

    def _compact(self) -> None:
        """Rewrite the file as one snapshot record (tmp+rename) —
        the inline path, caller holds the lock."""
        frame = self._snapshot_frame(self._data)
        tmp = self._path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        if self._file:
            self._file.close()
        os.replace(tmp, self._path)
        self._file = open(self._path, "ab")
        self._log_bytes = len(frame)
        self._live_bytes = self._live_size()

    def _compact_loop(self) -> None:
        """Background snapshot compaction (see class docstring for the
        crash contract)."""
        while True:
            with self._cv:
                while not self._compact_kick and not self._stopping:
                    self._cv.wait()
                if self._stopping:
                    return
                self._compact_kick = False
                # snapshot under the lock: a consistent image of the
                # live data; frames landing after this go to _pending
                self._compacting = True
                self._pending_frames = []
                snap = {p: dict(kv) for p, kv in self._data.items()}
            t0 = time.monotonic()
            f = None
            try:
                frame = self._snapshot_frame(snap)  # UNLOCKED encode
                tmp = self._path + ".tmp"
                f = open(tmp, "wb")
                f.write(frame)
                with self._cv:
                    if self._file is None:  # closed underneath us
                        f.close()
                        os.remove(tmp)
                        self._compacting = False
                        continue
                    # short critical section: tail of frames since the
                    # snapshot, fsync, swap
                    for pf in self._pending_frames:
                        f.write(pf)
                    f.flush()
                    os.fsync(f.fileno())
                    size = f.tell()
                    f.close()
                    self._file.close()
                    os.replace(tmp, self._path)
                    self._file = open(self._path, "ab")
                    self._log_bytes = size
                    self._live_bytes = self._live_size()
                    self._pending_frames = []
                    self._compacting = False
                self.perf.inc("kv_wal_compact")
                self.perf.hinc("kv_wal_compact_us",
                               (time.monotonic() - t0) * 1e6)
            except Exception as e:  # noqa: BLE001 - keep the live file
                # authoritative; a failed compaction only wastes bytes
                # (and must not leak the tmp handle/file)
                if f is not None:
                    try:
                        f.close()
                        os.remove(self._path + ".tmp")
                    except OSError:
                        pass
                with self._cv:
                    self._compacting = False
                    self._pending_frames = []
                from ..utils.log import dout
                dout("kv", 1)("wal bg compaction failed: %r", e)

    def stats(self) -> dict:
        with self._lock:
            return {"log_bytes": self._log_bytes,
                    "live_bytes": self._live_bytes,
                    "compactions": self.perf.get("kv_wal_compact"),
                    "bg_compact": self._bg}

    def close(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._compact_thread is not None:
            self._compact_thread.join(timeout=10)
        with self._lock:
            if self._file:
                self._file.close()
                self._file = None
        if self._owns_perf and self._perf_name:
            global_perf().remove(self._perf_name)


def create_kv(kind: str, path: str | None = None, **kw) -> KeyValueDB:
    """Factory (KeyValueDB::create role): 'mem', 'wal', or 'sst'
    (leveled LSM, the RocksDB-tier backend).  ``kw`` passes backend
    tuning through (name/perf, WalKV ``bg_compact``, SstKV
    ``memtable_bytes``/``cache_bytes``/``background``)."""
    if kind == "mem":
        return MemKV()
    if kind == "wal":
        if not path:
            raise ValueError("wal kv needs a path")
        return WalKV(path, **kw)
    if kind == "sst":
        if not path:
            raise ValueError("sst kv needs a path")
        from .sstkv import SstKV
        return SstKV(path, **kw)
    raise ValueError(f"unknown kv backend {kind!r}")
