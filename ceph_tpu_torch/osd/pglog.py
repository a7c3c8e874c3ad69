"""PGLog: the per-PG durable op log with rollback info.

The capability of the reference's PGLog (src/osd/PGLog.{h,cc}: per-PG
op log enabling log-based delta recovery instead of full backfill,
divergent-entry handling on peering, and EC partial-apply rollback via
stashed rollback info — doc/dev/osd_internals/erasure_coding/
ecbackend.rst:10-27), re-shaped for this runtime:

- entries live in the omap of a reserved meta object inside the PG
  collection, appended in the SAME Transaction as the data mutation, so
  the FileStore WAL makes log+data atomic (a crash never records a
  write without its log entry or vice versa);
- each partial-write entry stashes the OLD extent bytes it overwrote
  (the rollback generation role): a shard that applied a write the rest
  of the stripe never committed can roll back to the agreed version
  instead of poisoning decode;
- the log keeps a bounded tail window (osd_min_pg_log_entries role):
  peers within the window delta-resync by replaying entry object names;
  older peers fall back to the full inventory exchange (backfill).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.codec import Decoder, Encoder
from .objectstore import ObjectId, Transaction

# reserved shard id for PG metadata objects (never collides with EC
# shard ids >= 0 or the replicated marker -1)
PGLOG_OID = ObjectId("__pglog__", shard=-9)


@dataclass
class LogEntry:
    version: int        # pg-wide version of this mutation
    op: str             # write | rows | delta | remove
    oid: str
    shard: int          # the LOCAL shard the mutation touched
    prev_version: int   # object version this apply was based on
    # stashed pre-image for rollback: [(shard_off, old bytes)]; empty
    # for whole-object writes (rollback = drop + rebuild from peers)
    rollback: list = field(default_factory=list)
    old_len: int = -1   # object 'len' attr before the write (-1 unknown)
    old_shard_len: int = -1  # stored shard-stream bytes before the write
    # map epoch of the interval the PRIMARY served this write in (the
    # eversion_t epoch half, src/osd/osd_types.h): two entries at the
    # same version from different epochs are divergent forks and the
    # newer interval wins (src/osd/PGLog.h:1344 merge rule).  0 = legacy
    # entry written before epochs were stamped (never treated as a fork)
    epoch: int = 0

    def encode_bytes(self) -> bytes:
        e = Encoder()

        def body(se: Encoder):
            se.u64(self.version)
            se.string(self.op)
            se.string(self.oid)
            se.i64(self.shard)
            se.i64(self.prev_version)
            se.u32(len(self.rollback))
            for off, data in self.rollback:
                se.u64(off)
                se.blob(bytes(data))
            se.i64(self.old_len)
            se.i64(self.old_shard_len)  # v2 tail
            se.u64(self.epoch)          # v3 tail
        e.versioned(3, 1, body)
        return e.tobytes()

    @classmethod
    def decode_bytes(cls, raw: bytes) -> "LogEntry":
        d = Decoder(raw)

        def body(sd: Decoder, v: int):
            ent = cls(sd.u64(), sd.string(), sd.string(), sd.i64(),
                      sd.i64())
            ent.rollback = [(sd.u64(), sd.blob())
                            for _ in range(sd.u32())]
            ent.old_len = sd.i64()
            if v >= 2:
                ent.old_shard_len = sd.i64()
            if v >= 3:
                ent.epoch = sd.u64()
            return ent
        return d.versioned(3, body)


def _key(version: int) -> str:
    return f"v{version:016x}"


class PGLog:
    """One PG's log view over the store omap.  All mutation goes through
    Transactions the caller queues (atomicity with the data write)."""

    KEEP = 128  # tail window retained (osd_min_pg_log_entries role)

    def __init__(self, store, cid):
        self._store = store
        self._cid = cid
        self._count: int | None = None  # cached entry count (hot path)

    # -- append (rides the caller's Transaction) ---------------------------
    def append_to(self, tx: Transaction, entry: LogEntry) -> None:
        if not self._store.exists(self._cid, PGLOG_OID):
            tx.touch(self._cid, PGLOG_OID)
        tx.omap_setkeys(self._cid, PGLOG_OID,
                        {_key(entry.version): entry.encode_bytes()})
        if self._count is None:
            self._count = len(self._raw())
        self._count += 1

    def trim_to(self, tx: Transaction, keep: int | None = None) -> None:
        """Drop entries beyond the tail window (paxos-trim analogue).
        The cached count keeps the per-write cost O(1); the actual key
        scan only runs when the window overflows."""
        keep = keep or self.KEEP
        if self._count is not None and self._count <= 2 * keep:
            return
        entries = self._raw()
        self._count = len(entries)
        if len(entries) <= keep:
            return
        drop = sorted(entries)[: len(entries) - keep]
        tx.omap_rmkeys(self._cid, PGLOG_OID, drop)
        self._count -= len(drop)

    # -- queries -----------------------------------------------------------
    def _raw(self) -> dict[str, bytes]:
        try:
            omap = self._store.omap_get(self._cid, PGLOG_OID)
        except Exception:  # noqa: BLE001 - no log object yet
            return {}
        # the meta object also carries non-entry keys (e.g. "_lc")
        return {k: v for k, v in omap.items() if k.startswith("v")}

    def entries(self) -> list[LogEntry]:
        raw = self._raw()
        return [LogEntry.decode_bytes(raw[k]) for k in sorted(raw)]

    def last_version(self) -> int:
        raw = self._raw()
        if not raw:
            return 0
        return LogEntry.decode_bytes(raw[max(raw)]).version

    def last_epoch_version(self) -> tuple[int, int]:
        """(epoch, version) of the newest entry — the log head as an
        eversion: the divergence comparator (PGLog.h:1344)."""
        raw = self._raw()
        if not raw:
            return (0, 0)
        e = LogEntry.decode_bytes(raw[max(raw)])
        return (e.epoch, e.version)

    def floor(self) -> int:
        """Oldest version still logged (0 = empty log)."""
        raw = self._raw()
        if not raw:
            return 0
        return LogEntry.decode_bytes(raw[min(raw)]).version

    def entries_after(self, version: int) -> list[LogEntry]:
        return [e for e in self.entries() if e.version > version]

    def entries_for(self, oid: str) -> list[LogEntry]:
        return [e for e in self.entries() if e.oid == oid]

    # -- rollback (the EC partial-apply rollback role) ---------------------
    @staticmethod
    def _undoable(e: LogEntry) -> bool:
        """Entries we can revert in place: stashed pre-images, or pure
        version bumps (a partial write's untouched data shards get an
        empty-extent apply just to move 'v' — nothing to restore)."""
        return bool(e.rollback) or (e.op == "rows" and not e.rollback
                                    and e.prev_version >= 0)

    def rollback_object(self, oid: str, shard: int,
                        to_version: int) -> bool:
        """Undo this shard's applies on `oid` down to `to_version` using
        stashed pre-images, newest first, in ONE transaction (data +
        attrs + log-span removal commit together — a crash mid-rollback
        must never leave rolled-back bytes stamped with the new
        version).  Returns False when any entry in the span lacks
        rollback info (whole-object write or trimmed log) — the caller
        must then drop the shard object and let recovery rebuild it."""
        obj = ObjectId(oid, shard=shard)
        ents = self.entries_for(oid)  # one decode: span + ev lookup
        span = sorted((e for e in ents
                       if e.shard == shard and e.version > to_version),
                      key=lambda e: -e.version)
        if not span:
            return True
        if any(not self._undoable(e) for e in span):
            return False
        # compute the rolled-back content in memory so the digest can
        # ride the same transaction as the writes
        data = bytearray(self._store.read(self._cid, obj).to_bytes())
        for e in span:
            for off, old in e.rollback:
                end = off + len(old)
                if len(data) < end:
                    data.extend(b"\0" * (end - len(data)))
                data[off:end] = old
        final = span[-1]
        if 0 <= final.old_shard_len < len(data):
            # a grown write extended the shard stream: restore its length
            # or decode against peers' shorter streams would misalign
            data = data[: final.old_shard_len]
        attrs = dict(self._store.getattrs(self._cid, obj))
        attrs["v"] = to_version
        # restore the entry-epoch attr too: leaving the discarded
        # interval's stamp on a rolled-back object would ride a later
        # recovery push and resurrect the dead interval's epoch in a
        # fresh log entry (a phantom fork).  0 when the entry at
        # to_version is trimmed/legacy — never treated as a fork.
        attrs["ev"] = next((e.epoch for e in ents
                            if e.version == to_version), 0)
        if final.old_len >= 0:
            attrs["len"] = final.old_len
        from ..ops.native import crc32c
        attrs["d"] = crc32c(bytes(data))
        tx = Transaction()
        for e in span:
            for off, old in e.rollback:
                tx.write(self._cid, obj, off, old)
        if 0 <= final.old_shard_len:
            tx.truncate(self._cid, obj, final.old_shard_len)
        tx.setattrs(self._cid, obj, attrs)
        tx.omap_rmkeys(self._cid, PGLOG_OID,
                       [_key(e.version) for e in span])
        self._store.queue_transaction(tx)
        return True
