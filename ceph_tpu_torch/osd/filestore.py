"""FileStore: a durable, crash-consistent ObjectStore backend.

The capability slot of the reference's BlueStore (SURVEY.md §2.6: atomic
transactions via a write-ahead journal, crash-resume replay, per-blob
checksums verified on read — ref src/os/bluestore/BlueStore.cc deferred
WAL, csum :6080, _verify_csum BlueStore.h:3757), scoped for this round to
a file-per-object layout instead of a raw-block allocator stack:

- every Transaction is encoded (versioned codec) into a WAL record framed
  [u32 len][u32 crc32c][payload], fsync'd, THEN applied to the backing
  files; a torn tail is discarded on replay (crc gate), so mount after a
  crash replays exactly the committed prefix;
- object data lives in one file per object; attrs/omap in a sidecar meta
  file written atomically (tmp+rename); data checksums are crc32c per 4K
  page, stored in the meta and verified on every read;
- the WAL is compacted (truncated) once applied records exceed a
  threshold, with a checkpoint marker (the journal-trim role).

The raw-block allocator + KV metadata design (BlueStore proper) is the
next widening step behind this same factory.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Callable

from ..ops import native
from ..utils.buffer import BufferList
from ..utils.codec import Decoder, Encoder
from .objectstore import (CollectionId, NoSuchCollection, NoSuchObject,
                          ObjectId, ObjectStore, StoreError, Transaction,
                          TxOp, MemStore)

CSUM_BLOCK = 4096
WAL_COMPACT_BYTES = 8 * 1024 * 1024


# ------------------------- transaction (de)serialisation -------------------

def _enc_value(e: Encoder, v) -> None:
    if isinstance(v, bool):
        e.u8(3); e.boolean(v)
    elif isinstance(v, int):
        e.u8(0); e.i64(v)
    elif isinstance(v, (bytes, bytearray)):
        e.u8(1); e.blob(bytes(v))
    elif isinstance(v, str):
        e.u8(2); e.string(v)
    else:
        raise StoreError(f"unencodable attr value {type(v)}")


def _dec_value(d: Decoder):
    tag = d.u8()
    if tag == 0:
        return d.i64()
    if tag == 1:
        return d.blob()
    if tag == 2:
        return d.string()
    if tag == 3:
        return d.boolean()
    raise StoreError(f"bad value tag {tag}")


def _enc_cid(e: Encoder, cid: CollectionId) -> None:
    e.u64(cid.pool); e.u64(cid.pg_seed)


def _dec_cid(d: Decoder) -> CollectionId:
    return CollectionId(d.u64(), d.u64())


def _enc_oid(e: Encoder, oid: ObjectId) -> None:
    e.string(oid.name); e.i64(oid.shard); e.i64(oid.generation)


def _dec_oid(d: Decoder) -> ObjectId:
    return ObjectId(d.string(), d.i64(), d.i64())


def encode_transaction_enc(tx: Transaction) -> Encoder:
    """Segmented WAL-record encoder: large WRITE payloads ride BY
    REFERENCE (``BufferList.contiguous()`` + the segmented
    ``Encoder.blob`` contract) so the group-commit WAL append is a
    vectored write straight out of the rx-carved frame buffer — no
    eager detach copy.  Safe because (a) the transport never reuses a
    carved frame buffer (msg/README.md ownership contract) and (b) the
    pipeline holds the Transaction — and thus the payload — alive
    until the batch commits."""
    e = Encoder()

    def body(se: Encoder):
        se.u32(len(tx.ops))
        for op in tx.ops:
            kind = op[0]
            se.string(kind.value)
            if kind in (TxOp.CREATE_COLLECTION, TxOp.REMOVE_COLLECTION):
                _enc_cid(se, op[1])
                continue
            _enc_cid(se, op[1])
            _enc_oid(se, op[2])
            if kind == TxOp.WRITE:
                se.u64(op[3]); se.blob(op[4].contiguous())
            elif kind == TxOp.ZERO:
                se.u64(op[3]); se.u64(op[4])
            elif kind == TxOp.TRUNCATE:
                se.u64(op[3])
            elif kind in (TxOp.SETATTRS, TxOp.OMAP_SETKEYS):
                se.u32(len(op[3]))
                for k, v in sorted(op[3].items()):
                    se.string(str(k)); _enc_value(se, v)
            elif kind == TxOp.RMATTR:
                se.string(op[3])
            elif kind == TxOp.OMAP_RMKEYS:
                se.seq(op[3], Encoder.string)
            elif kind == TxOp.CLONE:
                _enc_oid(se, op[3])
    e.versioned(1, 1, body)
    return e


def encode_transaction(tx: Transaction) -> bytes:
    return encode_transaction_enc(tx).tobytes()


def decode_transaction(data: bytes) -> Transaction:
    d = Decoder(data)

    def body(sd: Decoder, version: int) -> Transaction:
        tx = Transaction()
        for _ in range(sd.u32()):
            kind = TxOp(sd.string())
            if kind in (TxOp.CREATE_COLLECTION, TxOp.REMOVE_COLLECTION):
                tx.ops.append((kind, _dec_cid(sd)))
                continue
            cid, oid = _dec_cid(sd), _dec_oid(sd)
            if kind in (TxOp.TOUCH, TxOp.REMOVE):
                tx.ops.append((kind, cid, oid))
            elif kind == TxOp.WRITE:
                off = sd.u64()
                tx.ops.append((kind, cid, oid, off, BufferList(sd.blob())))
            elif kind == TxOp.ZERO:
                tx.ops.append((kind, cid, oid, sd.u64(), sd.u64()))
            elif kind == TxOp.TRUNCATE:
                tx.ops.append((kind, cid, oid, sd.u64()))
            elif kind in (TxOp.SETATTRS, TxOp.OMAP_SETKEYS):
                kv = {}
                for _i in range(sd.u32()):
                    k = sd.string(); kv[k] = _dec_value(sd)
                tx.ops.append((kind, cid, oid, kv))
            elif kind == TxOp.RMATTR:
                tx.ops.append((kind, cid, oid, sd.string()))
            elif kind == TxOp.OMAP_RMKEYS:
                tx.ops.append((kind, cid, oid, sd.seq(Decoder.string)))
            elif kind == TxOp.CLONE:
                tx.ops.append((kind, cid, oid, _dec_oid(sd)))
            else:  # pragma: no cover
                raise StoreError(f"bad wal op {kind}")
        return tx
    return d.versioned(1, body)


# --------------------------------- store -----------------------------------

def _esc(name: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else f"%{ord(c):02x}"
                   for c in name)


class FileStore(ObjectStore):
    """Durable ObjectStore: WAL + file-per-object + checksummed reads.

    Internally the live state is a MemStore replica kept in sync with the
    files (fast reads; the files are the durable truth); mount() rebuilds
    the replica from disk then replays any committed WAL tail.
    """

    def __init__(self, path: str):
        self.path = path
        self._wal_path = os.path.join(path, "wal.bin")
        self._ckpt_path = os.path.join(path, "wal.ckpt")
        self._mem = MemStore()
        self._lock = threading.RLock()
        self._wal_file = None
        self._mounted = False
        self._corrupt: set[tuple[CollectionId, ObjectId]] = set()

    # ------------------------------------------------------------- mount
    def mount(self) -> None:
        with self._lock:
            if self._mounted:
                return
            os.makedirs(self.path, exist_ok=True)
            self._mem = MemStore()
            self._mem.mount()
            self._load_from_files()
            self._replay_wal()
            self._wal_file = open(self._wal_path, "ab")
            self._mounted = True

    def umount(self) -> None:
        self.flush()  # drain the commit pipeline before the WAL closes
        with self._lock:
            if self._wal_file:
                self._wal_file.close()
                self._wal_file = None
            self._mounted = False

    # -------------------------------------------------------- durability
    def _tx_cost(self, tx: Transaction) -> int:
        """Throttle accounting: a queued FileStore item pins a FULL
        per-object snapshot (data+attrs+omap, see _tx_snaps), so the
        touched objects' current sizes count toward the admission
        bound — a stream of tiny appends to a huge object must hit
        backpressure on the snapshots it pins, not on its payload."""
        n = super()._tx_cost(tx)
        seen: set[tuple] = set()
        for op in tx.ops:
            kind = op[0]
            if kind in (TxOp.CREATE_COLLECTION, TxOp.REMOVE_COLLECTION,
                        TxOp.REMOVE):
                continue
            keys = [(op[1], op[2])]
            if kind == TxOp.CLONE:
                keys.append((op[1], op[3]))
            for key in keys:
                if key in seen:
                    continue
                seen.add(key)
                try:
                    n += len(self._mem._obj(*key).data)
                except (NoSuchObject, NoSuchCollection):
                    pass  # created by this tx: payload already counted
        return n

    def _snapshot(self, cid: CollectionId, oid: ObjectId):
        """Post-tx image of one object (data, attrs, omap) — or None
        when absent."""
        try:
            obj = self._mem._obj(cid, oid)
        except (NoSuchObject, NoSuchCollection):
            return None
        return (bytes(obj.data), dict(obj.attrs), dict(obj.omap))

    def _tx_snaps(self, tx: Transaction) -> dict:
        """Per-object snapshots AS OF this transaction (taken right
        after its replica apply, under the store lock): the batch
        mirror writes THESE, never the live replica — live state may
        already include later queued transactions whose WAL records
        are not yet fsync'd, and persisting their fragments would
        break the committed-prefix crash contract."""
        snaps: dict = {}
        for op in tx.ops:
            kind = op[0]
            if kind in (TxOp.CREATE_COLLECTION, TxOp.REMOVE_COLLECTION,
                        TxOp.REMOVE):
                continue
            snaps[(op[1], op[2])] = self._snapshot(op[1], op[2])
            if kind == TxOp.CLONE:
                snaps[(op[1], op[3])] = self._snapshot(op[1], op[3])
        return snaps

    def _prepare(self, tx: Transaction):
        """Validate + apply to the memory replica (read-your-writes
        holds on return), encode the WAL record and snapshot the
        touched objects (see _tx_snaps).  Durability — the append,
        the ONE batch fsync, the file mirror and the applied
        checkpoint — happens in ``_commit_batch``."""
        segments = encode_transaction_enc(tx).segments()
        plen = crc = 0
        ref_b = 0
        for s in segments:
            plen += len(s)
            crc = native.crc32c(s, crc)
            if isinstance(s, memoryview):
                ref_b += len(s)
        self._book("store_ingest_ref_bytes", ref_b)
        self._book("store_ingest_copy_bytes", plen - ref_b)
        header = struct.pack("<II", plen, crc)
        with self._lock:
            if not self._mounted:
                raise StoreError("not mounted")
            # validate-before-anything: a rejected tx must never reach
            # the WAL (a durable-but-invalid record would replay later).
            # MemStore.queue_transaction validates then applies
            # atomically under its own lock.
            self._mem.queue_transaction(tx)
            return (header, segments, tx, self._tx_snaps(tx))

    def _commit_batch(self, items: list) -> int:
        """The group commit: every record in one vectored append, ONE
        WAL fsync (the commit point for the whole batch), then each
        dirty object mirrored ONCE and the checkpoint advanced once.

        The mirror writes each dirty object's LAST per-tx snapshot
        from THIS batch (captured at prepare, see _tx_snaps) — never
        the live replica, which may already hold effects of later
        queued transactions whose records are not yet journaled; a
        crash must only ever surface fsync'd-WAL-prefix state."""
        fsyncs = 0
        with self._lock:
            wal = self._wal_file
            if wal is None:
                raise StoreError("not mounted")
            for header, segments, _tx, _snaps in items:
                wal.write(header)
                for s in segments:
                    wal.write(s)
            wal.flush()
            os.fsync(wal.fileno())
            fsyncs += 1
            fsyncs += self._apply_files_batch(items)
            self._write_ckpt(wal.tell())
            fsyncs += 1  # the checkpoint's tmp-file fsync
            self._maybe_compact()
        return fsyncs

    def _write_ckpt(self, offset: int) -> None:
        tmp = self._ckpt_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(offset))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._ckpt_path)

    def _read_ckpt(self) -> int:
        try:
            with open(self._ckpt_path) as f:
                return int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError):
            return 0

    def _replay_wal(self) -> None:
        """Re-apply committed WAL records PAST the applied checkpoint
        (records before it already reached the files); discard a torn
        tail.  Replaying only the unapplied suffix keeps non-idempotent
        ops (clone) correct across clean remounts."""
        if not os.path.exists(self._wal_path):
            return
        with open(self._wal_path, "rb") as f:
            raw = f.read()
        pos = min(self._read_ckpt(), len(raw))
        while pos + 8 <= len(raw):
            ln, crc = struct.unpack_from("<II", raw, pos)
            if pos + 8 + ln > len(raw):
                break  # torn write at the tail
            payload = raw[pos + 8: pos + 8 + ln]
            if native.crc32c(payload) != crc:
                break  # corrupt tail record: stop (crash gate)
            tx = decode_transaction(payload)
            try:
                self._mem.queue_transaction(tx)
                self._apply_files(tx)
            except StoreError:
                pass  # partially applied before the crash; files are truth
            pos += 8 + ln
            self._write_ckpt(pos)
        # truncate any torn tail so future appends are clean
        if pos < len(raw):
            with open(self._wal_path, "r+b") as f:
                f.truncate(pos)
            self._write_ckpt(min(self._read_ckpt(), pos))

    def _maybe_compact(self) -> None:
        if os.path.getsize(self._wal_path) < WAL_COMPACT_BYTES:
            return
        # files fully reflect the WAL; safe to start a fresh journal
        self._wal_file.close()
        with open(self._wal_path, "wb") as f:
            f.flush()
            os.fsync(f.fileno())
        self._wal_file = open(self._wal_path, "ab")
        self._write_ckpt(0)

    # ----------------------------------------------------- file layout
    def _coll_dir(self, cid: CollectionId) -> str:
        return os.path.join(self.path, f"coll_{cid.pool}_{cid.pg_seed:x}")

    def _obj_base(self, cid: CollectionId, oid: ObjectId) -> str:
        return os.path.join(self._coll_dir(cid),
                            f"{_esc(oid.name)}_{oid.shard}_{oid.generation}")

    def _apply_files(self, tx: Transaction) -> None:
        # replay/mount path (single-threaded): the live replica IS the
        # post-tx state, so snapshots taken now are exact
        self._apply_files_batch([(None, None, tx, self._tx_snaps(tx))])

    def _apply_files_batch(self, items: list) -> int:
        """Mirror a whole batch: collection/remove ops in order, then
        each dirty object written ONCE from its LAST per-tx snapshot —
        N same-object writes in a batch cost one mirror, not N, and
        the persisted state is exactly the batch's WAL prefix.
        Returns the fsync count spent."""
        fsyncs = 0
        dirty: dict[tuple[CollectionId, ObjectId], tuple | None] = {}
        for _h, _s, tx, snaps in items:
            for op in tx.ops:
                kind = op[0]
                if kind == TxOp.CREATE_COLLECTION:
                    os.makedirs(self._coll_dir(op[1]), exist_ok=True)
                elif kind == TxOp.REMOVE_COLLECTION:
                    d = self._coll_dir(op[1])
                    if os.path.isdir(d):
                        for f in os.listdir(d):
                            os.unlink(os.path.join(d, f))
                        os.rmdir(d)
                    dirty = {k: v for k, v in dirty.items()
                             if k[0] != op[1]}
                elif kind == TxOp.REMOVE:
                    base = self._obj_base(op[1], op[2])
                    for suffix in (".data", ".meta"):
                        if os.path.exists(base + suffix):
                            os.unlink(base + suffix)
                    dirty.pop((op[1], op[2]), None)
                    self._corrupt.discard((op[1], op[2]))
                else:
                    dirty[(op[1], op[2])] = snaps.get((op[1], op[2]))
                    if kind == TxOp.CLONE:
                        dirty[(op[1], op[3])] = snaps.get(
                            (op[1], op[3]))
        for (cid, oid), snap in dirty.items():
            fsyncs += self._write_object_files(cid, oid, snap)
        return fsyncs

    def _write_object_files(self, cid: CollectionId, oid: ObjectId,
                            snap: tuple | None) -> int:
        """Mirror one object's snapshotted state (data, attrs, omap)
        to disk, with per-page checksums in the meta sidecar.  Returns
        the fsync count spent."""
        if snap is None:  # absent at snapshot time (e.g. removed)
            return 0
        data, attrs, omap = snap
        base = self._obj_base(cid, oid)
        os.makedirs(os.path.dirname(base), exist_ok=True)
        self._corrupt.discard((cid, oid))  # fresh write supersedes rot
        # one native round-trip for the whole page sweep
        csums = native.crc32c_blocks(data, CSUM_BLOCK) if data else []
        tmp = base + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, base + ".data")
        e = Encoder()

        def body(se: Encoder):
            se.u32(len(attrs))
            for k, v in sorted(attrs.items()):
                se.string(str(k)); _enc_value(se, v)
            se.u32(len(omap))
            for k, v in sorted(omap.items()):
                se.string(str(k)); _enc_value(se, v)
            se.u64(len(data))
            se.u32(CSUM_BLOCK)
            se.seq(csums, Encoder.u32)
        e.versioned(1, 1, body)
        with open(tmp, "wb") as f:
            f.write(e.tobytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, base + ".meta")
        return 2  # data tmp + meta tmp

    def _load_from_files(self) -> None:
        if not os.path.isdir(self.path):
            return
        for entry in sorted(os.listdir(self.path)):
            if not entry.startswith("coll_"):
                continue
            _, pool, seed = entry.split("_")
            cid = CollectionId(int(pool), int(seed, 16))
            self._mem.queue_transaction(
                Transaction().create_collection(cid))
            cdir = os.path.join(self.path, entry)
            for fname in sorted(os.listdir(cdir)):
                if not fname.endswith(".meta"):
                    continue
                base = os.path.join(cdir, fname[:-5])
                name_esc, shard, gen = fname[:-5].rsplit("_", 2)
                oid = ObjectId(_unesc(name_esc), int(shard), int(gen))
                attrs, omap, _size, csums = self._read_meta(base)
                data = b""
                if os.path.exists(base + ".data"):
                    with open(base + ".data", "rb") as f:
                        data = f.read()
                # verify page checksums ONCE, at load (reads then serve
                # from the in-RAM replica, which cannot rot)
                got = [native.crc32c(data[i:i + CSUM_BLOCK])
                       for i in range(0, len(data), CSUM_BLOCK)]
                if got != csums:
                    self._corrupt.add((cid, oid))
                tx = Transaction().touch(cid, oid)
                if data:
                    tx.write(cid, oid, 0, data)
                if attrs:
                    tx.setattrs(cid, oid, attrs)
                if omap:
                    tx.omap_setkeys(cid, oid, omap)
                self._mem.queue_transaction(tx)

    @staticmethod
    def _read_meta(base: str):
        with open(base + ".meta", "rb") as f:
            d = Decoder(f.read())

        def body(sd: Decoder, version: int):
            attrs = {sd.string(): _dec_value(sd) for _ in range(sd.u32())}
            omap = {sd.string(): _dec_value(sd) for _ in range(sd.u32())}
            size = sd.u64()
            sd.u32()  # csum block size
            csums = sd.seq(Decoder.u32)
            return attrs, omap, size, csums
        return d.versioned(1, body)

    # ------------------------------------------------------------ reads
    def read(self, cid, oid, offset: int = 0,
             length: int | None = None) -> BufferList:
        if (cid, oid) in self._corrupt:
            # bitrot found at load (BlueStore _verify_csum -> EIO role)
            raise StoreError(f"checksum mismatch on {cid}/{oid}")
        return self._mem.read(cid, oid, offset, length)

    def deep_verify(self, cid, oid) -> bool:
        """Re-read the on-disk object and check every page checksum (the
        deep-scrub primitive).  Returns False (and poisons reads) on
        mismatch."""
        base = self._obj_base(cid, oid)
        if not os.path.exists(base + ".meta"):
            return not self._mem.exists(cid, oid)
        _a, _o, _s, want = self._read_meta(base)
        data = b""
        if os.path.exists(base + ".data"):
            with open(base + ".data", "rb") as f:
                data = f.read()
        got = [native.crc32c(data[i:i + CSUM_BLOCK])
               for i in range(0, len(data), CSUM_BLOCK)]
        if got != want:
            self._corrupt.add((cid, oid))
            return False
        return True

    def stat(self, cid, oid):
        return self._mem.stat(cid, oid)

    def exists(self, cid, oid) -> bool:
        return self._mem.exists(cid, oid)

    def getattrs(self, cid, oid):
        return self._mem.getattrs(cid, oid)

    def omap_get(self, cid, oid):
        return self._mem.omap_get(cid, oid)

    def list_objects(self, cid):
        return self._mem.list_objects(cid)

    def list_collections(self):
        return self._mem.list_collections()


def _unesc(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        if s[i] == "%" and i + 2 < len(s) + 1:
            out.append(chr(int(s[i + 1:i + 3], 16)))
            i += 3
        else:
            out.append(s[i])
            i += 1
    return "".join(out)
