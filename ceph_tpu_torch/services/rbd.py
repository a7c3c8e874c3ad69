"""rbd-lite: block images over RADOS objects with COW snapshots.

The capability slice of the reference's librbd (src/librbd/ — image
create/open/list/remove, an Image handle with read/write/resize, and
snapshots; io dispatch layering striped over rbd_data.* objects).
Re-shaped for this build:

- image metadata lives in a codec-encoded header object
  (`rbd_header.<name>`): size, layout, snapshot table, snap id seq;
- data lives in `rbd_data.<name>.<objno>` pieces addressed through
  FileLayout (stripe_unit/stripe_count/object_size — the same
  file_layout_t algebra CephFS and libradosstriper use);
- snapshots are image-level COW: the FIRST write touching an object
  after a snapshot copies the object's bytes to
  `rbd_data.<name>.<objno>@<snapid>` before applying (the object-snap
  role of SnapMapper/clone-overlap, done at the client like librbd's
  object copy-up).  Reading snapshot s serves each object from its
  oldest copy with id >= s, falling back to the head.  Removing a
  snapshot retires its record (copies stay while an older snapshot
  might read through them) and purges copies when nothing older
  remains.

Exclusive lock + journaling (the librbd exclusive_lock/journal
features, ref src/librbd/Journal.h:41, src/journal/, managed-lock
handoff src/librbd/ManagedLock.cc):

- mutating ops take a cls_lock exclusive lock on the header object
  (cookie = client name).  A contender NOTIFIES the header
  (request_lock, the librbd RequestLock notify); the holder's watch
  releases cooperatively and re-acquires before its own next write —
  the ping-pong handoff of two librbd clients.  A dead holder's lock
  is BROKEN after the handoff times out (blocklist-lite), and its
  journal is replayed before the new holder serves io.
- with the journaling feature, every mutation appends an event to the
  image journal (omap of rbd_journal.<name>: seq -> packed event)
  BEFORE touching data objects, and trims it after apply (commit
  pointer).  Lock acquisition replays any events past the commit
  pointer — a crashed writer's half-applied write is completed, never
  torn (Journal.h's replay-on-open contract).

All ops are synchronous like the rest of the client stack.
"""

from __future__ import annotations

import errno
from dataclasses import dataclass, field

from ..client.rados import RadosClient, RadosError
from ..client.striper import FileLayout
from ..utils.codec import Decoder, Encodable, Encoder

_HEADER = "rbd_header.{name}"
_DATA = "rbd_data.{name}.{objno:016x}"
_SNAP = "rbd_data.{name}.{objno:016x}@{snap}"
_DIR = "rbd_directory"
_JOURNAL = "rbd_journal.{name}"
_LOCK_NAME = "rbd_lock"

FEATURE_JOURNALING = 1
FEATURE_OBJECT_MAP = 2
FEATURE_FAST_DIFF = 4

# object-map states (src/librbd/ObjectMap.h / object_map_types.h):
# nonexistent / exists-dirty (written since the last snapshot) /
# exists-clean (untouched since the last snapshot)
OM_NONEXISTENT, OM_EXISTS, OM_EXISTS_CLEAN = 0, 1, 3
_OMAP = "rbd_object_map.{name}"
_OMAP_SNAP = "rbd_object_map.{name}@{snap}"


class RbdError(Exception):
    pass


@dataclass
class SnapRecord(Encodable):
    snap_id: int
    name: str            # "" once retired (removed but copies retained)
    size: int            # image size when the snapshot was taken
    copied: list = field(default_factory=list)  # objnos with COW copies

    VERSION, COMPAT = 1, 1

    def encode(self, enc: Encoder) -> None:
        def body(e):
            e.u64(self.snap_id)
            e.string(self.name)
            e.u64(self.size)
            e.seq(sorted(self.copied), Encoder.u64)
        enc.versioned(self.VERSION, self.COMPAT, body)

    @classmethod
    def decode(cls, dec: Decoder) -> "SnapRecord":
        def body(d, v):
            return cls(d.u64(), d.string(), d.u64(), d.seq(Decoder.u64))
        return dec.versioned(cls.VERSION, body)


@dataclass
class ImageHeader(Encodable):
    size: int
    object_size: int
    stripe_unit: int
    stripe_count: int
    snap_seq: int = 0
    snaps: list = field(default_factory=list)  # [SnapRecord]
    features: int = 0  # FEATURE_* bits (journaling)

    VERSION, COMPAT = 2, 1

    def encode(self, enc: Encoder) -> None:
        def body(e):
            e.u64(self.size)
            e.u64(self.object_size)
            e.u64(self.stripe_unit)
            e.u64(self.stripe_count)
            e.u64(self.snap_seq)
            e.seq(self.snaps, lambda ee, s: s.encode(ee))
            e.u64(self.features)  # v2 tail
        enc.versioned(self.VERSION, self.COMPAT, body)

    @classmethod
    def decode(cls, dec: Decoder) -> "ImageHeader":
        def body(d, v):
            h = cls(d.u64(), d.u64(), d.u64(), d.u64(), d.u64())
            h.snaps = d.seq(SnapRecord.decode)
            if v >= 2:
                h.features = d.u64()
            return h
        return dec.versioned(cls.VERSION, body)

    def layout(self) -> FileLayout:
        return FileLayout(self.stripe_unit, self.stripe_count,
                          self.object_size)


class RBD:
    """Pool-level image operations (the librbd RBD class shape)."""

    def __init__(self, client: RadosClient):
        self.client = client

    def create(self, pool: str, name: str, size: int,
               object_size: int = 4 * 1024 * 1024,
               stripe_unit: int | None = None,
               stripe_count: int = 1,
               features: int = 0) -> "Image":
        if size < 0:
            raise RbdError("negative size")
        header = _HEADER.format(name=name)
        try:
            self.client.read(pool, header, length=1)
            raise RbdError(f"image {name!r} exists")
        except RadosError:
            pass
        su = stripe_unit or object_size
        h = ImageHeader(size, object_size, su, stripe_count,
                        features=features)
        FileLayout(su, stripe_count, object_size)  # validates
        self.client.write_full(pool, header, h.encode_bytes())
        self._dir_update(pool, add=name)
        return self.open(pool, name)

    def open(self, pool: str, name: str) -> "Image":
        return Image(self.client, pool, name)

    def list(self, pool: str) -> list[str]:
        try:
            raw = self.client.read(pool, _DIR)
        except RadosError:
            return []
        d = Decoder(raw)
        return d.seq(Decoder.string)

    def remove(self, pool: str, name: str) -> None:
        img = self.open(pool, name)
        img.purge()
        self._dir_update(pool, remove=name)

    def _dir_update(self, pool: str, add: str | None = None,
                    remove: str | None = None) -> None:
        names = set(self.list(pool))
        if add:
            names.add(add)
        if remove:
            names.discard(remove)
        e = Encoder()
        e.seq(sorted(names), Encoder.string)
        self.client.write_full(pool, _DIR, e.tobytes())


class Image:
    """An open image handle (librbd Image shape)."""

    def __init__(self, client: RadosClient, pool: str, name: str):
        self.client = client
        self.pool = pool
        self.name = name
        self._owner = client.name  # cls_lock cookie
        self._locked = False
        self._release_asked = False
        self._watching = False
        self._in_op = False
        self._releasing = False  # unlock RPC in flight
        import threading
        self._lk = threading.RLock()  # lock state vs the notify thread
        self._jseq = 0
        self._om_cache = None  # object-map bytes, valid under the lock
        self._load()

    # ------------------------------------------------- exclusive lock
    @property
    def _hoid(self) -> str:
        return _HEADER.format(name=self.name)

    @property
    def _joid(self) -> str:
        return _JOURNAL.format(name=self.name)

    def _journaling(self) -> bool:
        return bool(self.header.features & FEATURE_JOURNALING)

    def _on_header_notify(self, oid, notifier, payload) -> None:
        if payload == b"request_lock" and notifier != self._owner:
            # cooperative handoff (ManagedLock release-on-request): an
            # idle holder lets the contender in NOW; mid-op, the
            # release happens when the op finishes.  Either way we
            # re-acquire before our own next write.
            with self._lk:
                idle = self._locked and not self._in_op
                self._release_asked = not idle
            if idle:
                # the callback runs on the client's dispatch thread —
                # the synchronous unlock RPC must not wait for replies
                # that same thread would deliver
                import threading
                threading.Thread(target=self._release_lock,
                                 daemon=True).start()

    def _ensure_lock(self, timeout: float = 5.0) -> None:
        """Hold the exclusive lock before mutating (librbd
        exclusive_lock).  Contenders ask the holder to release
        (header notify) and finally BREAK a dead holder's lock,
        replaying its journal before serving io."""
        with self._lk:
            if self._locked and self._release_asked:
                self._release_lock()
            if self._locked:
                # refresh the lock stamp AND verify we still own it (a
                # contender may have broken a lock we held while stuck
                # — the no-blocklist analogue of librbd fencing: loss
                # is detected at the next op boundary)
                try:
                    self.client.cls_call(self.pool, self._hoid, "lock",
                                         "lock", {"name": _LOCK_NAME,
                                                  "owner": self._owner,
                                                  "exclusive": True})
                    self._in_op = True
                    return
                except RadosError:
                    self._locked = False  # usurped: fall through
        if not self._watching:
            self.client.watch(self.pool, self._hoid,
                              self._on_header_notify)
            self._watching = True
        import time as _time
        while self._releasing:  # an unlock is mid-flight: let it land
            _time.sleep(0.005)
        deadline = _time.time() + timeout
        asked = False
        while True:
            try:
                self.client.cls_call(self.pool, self._hoid, "lock",
                                     "lock", {"name": _LOCK_NAME,
                                              "owner": self._owner,
                                              "exclusive": True})
                break
            except RadosError as e:
                if _time.time() >= deadline:
                    # break ONLY a holder whose lock stamp has gone
                    # stale (live holders refresh it every op): a
                    # stuck-but-alive writer keeps its lock, a dead
                    # one is dispossessed (blocklist-lite) — its
                    # journal replays below
                    info = self.client.cls_call(
                        self.pool, self._hoid, "lock", "info",
                        {"name": _LOCK_NAME}) or {}
                    stamp = float(info.get("stamp", 0.0))
                    if _time.time() - stamp >= timeout:
                        self.client.cls_call(self.pool, self._hoid,
                                             "lock", "break_lock",
                                             {"name": _LOCK_NAME})
                    else:
                        deadline = stamp + 2 * timeout
                    continue
                if not asked:
                    asked = True
                    self.client.notify(self.pool, self._hoid,
                                       b"request_lock")
                _time.sleep(0.02)
        with self._lk:
            self._locked = True
            self._release_asked = False
            self._in_op = True
        # the header may have moved while someone else held the lock
        # (their snapshots/resizes MUST be visible before we mutate, or
        # a write would skip their snapshot's copy-up)
        self._load()
        if self._journaling():
            self._replay_journal()

    def _release_lock(self) -> None:
        with self._lk:
            if not self._locked:
                return
            # latch BEFORE the RPC: our own next op must not re-acquire
            # in the window where the unlock is in flight (it would
            # mutate while the contender takes the lock from under it);
            # _locked clears only after the unlock landed
            self._releasing = True
        try:
            self.client.cls_call(self.pool, self._hoid, "lock",
                                 "unlock", {"name": _LOCK_NAME,
                                            "owner": self._owner})
        except RadosError:
            pass  # already broken/taken
        finally:
            with self._lk:
                self._locked = False
                self._release_asked = False
                self._releasing = False

    def _end_op(self) -> None:
        with self._lk:
            self._in_op = False
            if self._locked and self._release_asked:
                self._release_lock()

    def lock_owner(self) -> str | None:
        info = self.client.cls_call(self.pool, self._hoid, "lock",
                                    "info", {"name": _LOCK_NAME})
        owners = (info or {}).get("owners") or []
        return owners[0] if owners else None

    def close(self) -> None:
        self._release_lock()
        if self._watching:
            try:
                self.client.unwatch(self.pool, self._hoid)
            except RadosError:
                pass
            self._watching = False

    # ------------------------------------------------------- journal
    def _journal_entries(self) -> tuple[int, list[tuple[int, dict]]]:
        """(committed seq, [(seq, event)] past it, seq-ordered)."""
        from ..msg.wire import unpack_value
        try:
            omap = self.client.omap_get(self.pool, self._joid)
        except RadosError:
            return 0, []
        committed = int.from_bytes(bytes(omap.get("_c", b"")) or b"\0",
                                   "little")
        ents = sorted((int(k[1:], 16), unpack_value(bytes(v)))
                      for k, v in omap.items() if k.startswith("e"))
        return committed, [(s, ev) for s, ev in ents if s > committed]

    def _journal_append(self, event: dict) -> int:
        from ..msg.wire import pack_value
        self._jseq += 1
        self.client.omap_set(self.pool, self._joid,
                             {f"e{self._jseq:016x}": pack_value(event)})
        return self._jseq

    def _journal_commit(self, seq: int) -> None:
        self.client.omap_set(self.pool, self._joid,
                             {"_c": seq.to_bytes(8, "little")})
        # trim only what EVERY registered consumer (the local commit
        # pointer plus mirror peers) has consumed — the journal is the
        # mirroring feed (src/journal/ commit-position semantics)
        floor = min([seq] + list(self._mirror_positions().values()))
        if floor >= seq:
            self.client.omap_rm(self.pool, self._joid,
                                [f"e{seq:016x}"])

    # ------------------------------------------------------ mirroring
    def _mirror_positions(self) -> dict[str, int]:
        try:
            omap = self.client.omap_get(self.pool, self._joid)
        except RadosError:
            return {}
        return {k[3:]: int.from_bytes(bytes(v), "little")
                for k, v in omap.items() if k.startswith("_m.")}

    def mirror_register(self, peer: str) -> None:
        """Register a mirror peer (rbd mirror pool peer add role):
        journal events are retained until the peer's replayer consumes
        them.  Requires the journaling feature."""
        if not self._journaling():
            raise RbdError("mirroring needs the journaling feature")
        if peer not in self._mirror_positions():
            self.client.omap_set(
                self.pool, self._joid,
                {f"_m.{peer}": (0).to_bytes(8, "little")})

    def mirror_unregister(self, peer: str) -> None:
        self.client.omap_rm(self.pool, self._joid, [f"_m.{peer}"])
        self._mirror_trim()

    def _mirror_trim(self) -> None:
        """Drop journal events every consumer has passed."""
        from ..msg.wire import unpack_value  # noqa: F401 - parity import
        try:
            omap = self.client.omap_get(self.pool, self._joid)
        except RadosError:
            return
        committed = int.from_bytes(bytes(omap.get("_c", b"")) or b"\0",
                                   "little")
        floor = min([committed]
                    + list(self._mirror_positions().values()))
        drop = [k for k in omap
                if k.startswith("e") and int(k[1:], 16) <= floor]
        if drop:
            self.client.omap_rm(self.pool, self._joid, drop)

    def _replay_journal(self) -> None:
        """Journal.h replay-on-open: complete events a crashed holder
        journaled but may not have fully applied (apply is idempotent
        — same bytes to the same extents)."""
        committed, pending = self._journal_entries()
        self._jseq = max([committed] + [s for s, _ in pending])
        for seq, ev in pending:
            if ev.get("op") == "write":
                self._apply_write(int(ev["off"]), bytes(ev["data"]))
            elif ev.get("op") == "resize":
                self._load()
                if self.header.size != int(ev["size"]):
                    self._apply_resize(int(ev["size"]))
            self._journal_commit(seq)

    # ------------------------------------------------------------- header
    def _load(self) -> None:
        try:
            raw = self.client.read(self.pool,
                                   _HEADER.format(name=self.name))
        except RadosError as e:
            raise RbdError(f"no image {self.name!r}") from e
        self.header = ImageHeader.decode_bytes(raw)
        # the cached object map is only valid under the lock epoch the
        # header was read in — another owner may have advanced it
        self._om_cache = None

    def _save(self) -> None:
        self.client.write_full(self.pool, _HEADER.format(name=self.name),
                               self.header.encode_bytes())

    def size(self) -> int:
        return self.header.size

    # ---------------------------------------------------------------- io
    def _piece(self, objno: int) -> str:
        return _DATA.format(name=self.name, objno=objno)

    def _snap_piece(self, objno: int, snap_id: int) -> str:
        return _SNAP.format(name=self.name, objno=objno, snap=snap_id)

    def _read_piece(self, oid: str, off: int, length: int) -> bytes:
        try:
            data = self.client.read(self.pool, oid, offset=off,
                                    length=length)
        except RadosError as e:
            if e.code != -errno.ENOENT:
                # an object that exists but could not be read (its PG's
                # new primary still recovering it past the client's
                # EAGAIN retries, EIO) is an I/O error, never zeros
                raise RbdError(f"read {oid}: {e}") from e
            data = b""  # sparse hole: the object was never written
        return data + b"\0" * (length - len(data))

    def _newest_snap(self) -> SnapRecord | None:
        """COW target: the newest record, live OR retired (older live
        snapshots read through newer copies)."""
        return self.header.snaps[-1] if self.header.snaps else None

    def _cow_object(self, objno: int, newest: SnapRecord) -> bool:
        """Copy-up the head object to the newest snapshot before its
        first post-snapshot mutation.  Returns True if the header now
        needs saving."""
        if objno in newest.copied:
            return False
        try:
            old = self.client.read(self.pool, self._piece(objno))
        except RadosError:
            old = b""
        self.client.write_full(self.pool,
                               self._snap_piece(objno, newest.snap_id),
                               old)
        newest.copied.append(objno)
        return True

    def _objects_covering(self, size: int) -> set[int]:
        objs: set[int] = set()
        if size > 0:
            for objno, _o, _t in self.header.layout().file_to_extents(
                    0, size):
                objs.add(objno)
        return objs

    def write(self, off: int, data: bytes) -> None:
        if not data:
            return
        self._ensure_lock()  # also reloads the header on acquisition
        try:
            if off + len(data) > self.header.size:
                raise RbdError("write past end of image (resize first)")
            if self._journaling():
                # journal FIRST (Journal.h write-ahead contract): a
                # crash after this point replays the event; before it,
                # the write never happened — no torn middle survives
                seq = self._journal_append({"op": "write", "off": off,
                                            "data": data})
                self._apply_write(off, data)
                self._journal_commit(seq)
            else:
                self._apply_write(off, data)
        finally:
            self._end_op()

    def _apply_write(self, off: int, data: bytes) -> None:
        layout = self.header.layout()
        newest = self._newest_snap()
        per_obj: dict[int, list] = {}
        pos = 0
        for objno, obj_off, take in layout.file_to_extents(off,
                                                           len(data)):
            per_obj.setdefault(objno, []).append((obj_off, pos, take))
            pos += take
        dirty_header = False
        for objno, extents in per_obj.items():
            if newest is not None:
                dirty_header |= self._cow_object(objno, newest)
            for obj_off, p, take in extents:
                self.client.write(self.pool, self._piece(objno),
                                  data[p:p + take], offset=obj_off)
        if self._om_enabled():
            self._om_mark(per_obj.keys(), OM_EXISTS)
        if dirty_header:
            self._save()

    def read(self, off: int, length: int,
             snap: str | None = None) -> bytes:
        bound = self.header.size if snap is None \
            else self._snap_record(snap).size
        length = max(0, min(length, bound - off))
        if length <= 0:
            return b""
        layout = self.header.layout()
        out = bytearray(length)
        pos = 0
        snap_id = None if snap is None else self._snap_record(snap).snap_id
        if snap_id is None and self._om_enabled():
            if not self._locked:
                # a non-owner's cached map can be stale (another owner
                # may have written under the lock): re-read it
                self._om_cache = None
            om = self._om()
        else:
            om = None
        for objno, obj_off, take in layout.file_to_extents(off, length):
            if om is not None and (objno >= len(om)
                                   or om[objno] == OM_NONEXISTENT):
                pos += take  # object-map says hole: zeros, no round trip
                continue
            oid = self._piece(objno) if snap_id is None \
                else self._resolve_snap_object(objno, snap_id)
            out[pos:pos + take] = self._read_piece(oid, obj_off, take)
            pos += take
        return bytes(out)

    def _resolve_snap_object(self, objno: int, snap_id: int) -> str:
        """Oldest COW copy with id >= snap_id, else the head object —
        the snapshot read-through chain."""
        for rec in self.header.snaps:  # ordered oldest -> newest
            if rec.snap_id >= snap_id and objno in rec.copied:
                return self._snap_piece(objno, rec.snap_id)
        return self._piece(objno)

    # ---------------------------------------------------- object map
    # (src/librbd/ObjectMap.h + the fast-diff feature): one state byte
    # per data object, maintained under the exclusive lock.  Reads skip
    # NONEXISTENT objects with no cluster round trip; snapshots persist
    # a copy and demote EXISTS -> EXISTS_CLEAN, so "dirty since snap X"
    # is answered from the maps alone (fast_diff) — no data reads.
    def _om_enabled(self) -> bool:
        return bool(self.header.features & FEATURE_OBJECT_MAP)

    def _om_oid(self, snap_id: int | None = None) -> str:
        if snap_id is None:
            return _OMAP.format(name=self.name)
        return _OMAP_SNAP.format(name=self.name, snap=snap_id)

    def _om_len(self) -> int:
        objs = self._objects_covering(self.header.size)
        return (max(objs) + 1) if objs else 0

    def _om(self) -> bytearray:
        m = self._om_cache
        if m is None:
            rebuilt = False
            try:
                raw = self.client.read(self.pool, self._om_oid())
                m = bytearray(raw)
            except RadosError:
                # missing/never built: rebuild from reality (the
                # `rbd object-map rebuild` path on feature enable)
                m = self._om_rebuild_locked()
                rebuilt = True
            n = self._om_len()
            if len(m) < n:
                m = m + bytearray(n - len(m))
            self._om_cache = m
            if rebuilt:
                # persist NOW: _om_mark's no-change fast path must be
                # able to trust that the stored object exists
                self._om_save()
        return m

    def _om_save(self) -> None:
        if self._om_cache is not None:
            self.client.write_full(self.pool, self._om_oid(),
                                   bytes(self._om_cache))

    def _om_mark(self, objnos, state: int) -> None:
        if not self._om_enabled():
            return
        m = self._om()
        changed = False
        for objno in objnos:
            if objno >= len(m):
                m.extend(bytearray(objno + 1 - len(m)))
            if m[objno] != state:
                m[objno] = state
                changed = True
        if changed:
            # steady-state rewrites of an already-EXISTS object pay no
            # extra round trip
            self._om_save()

    def _om_rebuild_locked(self) -> bytearray:
        m = bytearray(self._om_len())
        for objno in range(len(m)):
            try:
                self.client.stat(self.pool, self._piece(objno))
                m[objno] = OM_EXISTS
            except RadosError:
                m[objno] = OM_NONEXISTENT
        return m

    def _om_drop_snap(self, rec: SnapRecord) -> None:
        """Removing a snapshot must MERGE its dirty bits into the next
        younger map (or the head) before its map goes away — else
        fast_diff across the removed snapshot under-reports changes
        (the data path's retire/read-through logic has the same
        obligation for bytes)."""
        try:
            removed = self.client.read(self.pool,
                                       self._om_oid(rec.snap_id))
        except RadosError:
            removed = b""
        younger = next((r for r in self.header.snaps
                        if r.snap_id > rec.snap_id), None)
        if removed:
            if younger is not None:
                try:
                    tgt = bytearray(self.client.read(
                        self.pool, self._om_oid(younger.snap_id)))
                except RadosError:
                    tgt = bytearray()
                for i, v in enumerate(removed):
                    if v == OM_EXISTS and i < len(tgt) \
                            and tgt[i] == OM_EXISTS_CLEAN:
                        tgt[i] = OM_EXISTS
                self.client.write_full(
                    self.pool, self._om_oid(younger.snap_id),
                    bytes(tgt))
            else:
                m = self._om()
                dirty = [i for i, v in enumerate(removed)
                         if v == OM_EXISTS and i < len(m)
                         and m[i] == OM_EXISTS_CLEAN]
                if dirty:
                    self._om_mark(dirty, OM_EXISTS)
        try:
            self.client.remove(self.pool, self._om_oid(rec.snap_id))
        except RadosError:
            pass

    def _om_resync(self) -> None:
        """Rare geometry-changing ops (resize, rollback) re-derive the
        map from reality rather than patching it incrementally."""
        if self._om_enabled():
            self._om_cache = self._om_rebuild_locked()
            self._om_save()

    def rebuild_object_map(self) -> int:
        """`rbd object-map rebuild`: re-derive the map from the actual
        data objects (feature enable on an existing image, or repair
        after an invalid-map event).  Returns the object count."""
        self._ensure_lock()
        try:
            self._om_cache = self._om_rebuild_locked()
            self._om_save()
            return len(self._om_cache)
        finally:
            self._end_op()

    def fast_diff(self, from_snap: str | None = None) -> list[dict]:
        """Changed object extents since `from_snap` (None = since
        creation), computed purely from object maps — the fast-diff
        feature's deltas-without-reading-data contract (object
        granularity; offsets are objno * object_size).  Dirtiness
        composes across snapshots: snapshot S's map carries EXISTS
        (dirty) for exactly the objects written between S-1 and S."""
        if not (self.header.features & FEATURE_FAST_DIFF) \
                or not self._om_enabled():
            raise RbdError("fast-diff requires the object-map + "
                           "fast-diff features")
        self._load()  # also invalidates the cached map
        head = self._om()
        n = len(head)
        if from_snap is None:
            changed = [i for i in range(n) if head[i] != OM_NONEXISTENT]
        else:
            rec = self._snap_record(from_snap)
            try:
                fmap = self.client.read(self.pool,
                                        self._om_oid(rec.snap_id))
            except RadosError:
                fmap = b""
            later = []
            for r in self.header.snaps:
                if r.snap_id > rec.snap_id:
                    try:
                        later.append(self.client.read(
                            self.pool, self._om_oid(r.snap_id)))
                    except RadosError:
                        pass
            later.append(bytes(head))
            changed = []
            for i in range(n):
                dirty = any(i < len(m) and m[i] == OM_EXISTS
                            for m in later)
                was = i < len(fmap) and fmap[i] != OM_NONEXISTENT
                now = head[i] != OM_NONEXISTENT
                if dirty or was != now:
                    changed.append(i)
        osize = self.header.object_size
        return [{"objno": i, "offset": i * osize, "length": osize,
                 "exists": head[i] != OM_NONEXISTENT}
                for i in changed]

    # ------------------------------------------------------------- resize
    def _zero_tail(self, new_size: int, old_size: int) -> None:
        """Zero the KEPT objects' stale ranges beyond new_size (up to
        the object-SET boundary — with striping, a kept object holds
        file ranges across the whole set span) so a later grow reads
        zeros, not resurrection."""
        layout = self.header.layout()
        span = layout.stripe_count * layout.object_size
        set_end = -(-new_size // span) * span
        tail = min(old_size, set_end) - new_size
        if tail > 0:
            prev = self.header.size
            self.header.size = max(prev, new_size + tail)
            self.write(new_size, b"\0" * tail)
            self.header.size = prev

    def resize(self, new_size: int) -> None:
        if new_size < 0:
            raise RbdError("negative size")
        self._ensure_lock()
        try:
            if self._journaling():
                seq = self._journal_append({"op": "resize",
                                            "size": new_size})
                self._apply_resize(new_size)
                self._journal_commit(seq)
            else:
                self._apply_resize(new_size)
        finally:
            self._end_op()

    def _apply_resize(self, new_size: int) -> None:
        old = self.header.size
        if new_size < old:
            # trim: COW whole objects into the newest snapshot (a live
            # snapshot must keep reading the frozen bytes), then drop
            # them; zero the kept partial range
            keep_objs = self._objects_covering(new_size)
            newest = self._newest_snap()
            dirty = False
            for objno in sorted(self._objects_covering(old) - keep_objs):
                if newest is not None:
                    dirty |= self._cow_object(objno, newest)
                try:
                    self.client.remove(self.pool, self._piece(objno))
                except RadosError:
                    pass
            if dirty:
                self._save()
            self._zero_tail(new_size, old)
        self.header.size = new_size  # _om_resync sizes off the header
        self._om_resync()
        self.header.size = new_size
        self._save()

    # ---------------------------------------------------------- snapshots
    def _snap_record(self, name: str) -> SnapRecord:
        for rec in self.header.snaps:
            if rec.name == name:
                return rec
        raise RbdError(f"no snapshot {name!r}")

    def snap_create(self, name: str) -> int:
        self._ensure_lock()
        try:
            return self._snap_create(name)
        finally:
            self._end_op()

    def _snap_create(self, name: str) -> int:
        if any(r.name == name for r in self.header.snaps):
            raise RbdError(f"snapshot {name!r} exists")
        self.header.snap_seq += 1
        rec = SnapRecord(self.header.snap_seq, name, self.header.size)
        self.header.snaps.append(rec)
        if self._om_enabled():
            # persist the snapshot's map, then demote dirty -> clean:
            # the head map's EXISTS bytes now mean "written since THIS
            # snapshot" (the fast-diff bookkeeping)
            m = self._om()
            self.client.write_full(self.pool,
                                   self._om_oid(rec.snap_id), bytes(m))
            for i, v in enumerate(m):
                if v == OM_EXISTS:
                    m[i] = OM_EXISTS_CLEAN
            self._om_save()
        self._save()
        return rec.snap_id

    def snap_list(self) -> list[dict]:
        return [{"id": r.snap_id, "name": r.name, "size": r.size}
                for r in self.header.snaps if r.name]

    def snap_remove(self, name: str) -> None:
        self._ensure_lock()
        try:
            self._snap_remove_locked(name)
        finally:
            self._end_op()

    def _snap_remove_locked(self, name: str) -> None:
        rec = self._snap_record(name)
        if self._om_enabled():
            self._om_drop_snap(rec)
        older_live = any(r.name and r.snap_id < rec.snap_id
                        for r in self.header.snaps)
        if older_live:
            rec.name = ""  # retire: older snapshots read through it
        else:
            for objno in rec.copied:
                try:
                    self.client.remove(
                        self.pool,
                        self._snap_piece(objno, rec.snap_id))
                except RadosError:
                    pass
            self.header.snaps.remove(rec)
        # purge retired records nothing can read through anymore
        while self.header.snaps:
            first = self.header.snaps[0]
            if first.name:
                break
            for objno in first.copied:
                try:
                    self.client.remove(
                        self.pool,
                        self._snap_piece(objno, first.snap_id))
                except RadosError:
                    pass
            self.header.snaps.pop(0)
        self._save()

    def snap_rollback(self, name: str) -> None:
        """head := the image content at the snapshot (librbd rollback).
        Rollback is itself a mutation: objects copy-up to snapshots
        NEWER than the target first, so those snapshots stay frozen."""
        self._ensure_lock()
        try:
            self._snap_rollback_locked(name)
        finally:
            self._end_op()

    def _snap_rollback_locked(self, name: str) -> None:
        rec = self._snap_record(name)
        cur = self.header.size
        newest = self._newest_snap()
        cow_target = newest if (newest is not None
                                and newest.snap_id > rec.snap_id) \
            else None
        restore = self._objects_covering(rec.size)
        beyond = self._objects_covering(cur) - restore
        dirty = False
        for objno in sorted(restore | beyond):
            if cow_target is not None:
                dirty |= self._cow_object(objno, cow_target)
            if objno in beyond:
                # head shrinks back to the snapshot's extent
                try:
                    self.client.remove(self.pool, self._piece(objno))
                except RadosError:
                    pass
                continue
            src = self._resolve_snap_object(objno, rec.snap_id)
            if src == self._piece(objno):
                continue  # head unchanged since the snapshot
            try:
                content = self.client.read(self.pool, src)
            except RadosError:
                content = b""
            self.client.write_full(self.pool, self._piece(objno), content)
        if dirty:
            self._save()
        # restored copies may carry bytes past the snapshot's size; zero
        # the kept range so a later grow reads zeros
        self._zero_tail(rec.size, max(cur, rec.size))
        self.header.size = rec.size
        self._save()
        self._om_resync()

    # -------------------------------------------------------------- purge
    def purge(self) -> None:
        layout = self.header.layout()
        span = max(self.header.size,
                   max((r.size for r in self.header.snaps), default=0))
        objs = set()
        if span:
            for objno, _o, _t in layout.file_to_extents(0, span):
                objs.add(objno)
        for objno in objs:
            try:
                self.client.remove(self.pool, self._piece(objno))
            except RadosError:
                pass
            for rec in self.header.snaps:
                if objno in rec.copied:
                    try:
                        self.client.remove(
                            self.pool,
                            self._snap_piece(objno, rec.snap_id))
                    except RadosError:
                        pass
        if self._om_enabled():
            try:
                self.client.remove(self.pool, self._om_oid())
            except RadosError:
                pass
            for rec in self.header.snaps:
                try:
                    self.client.remove(self.pool,
                                       self._om_oid(rec.snap_id))
                except RadosError:
                    pass
        try:
            self.client.remove(self.pool,
                               _HEADER.format(name=self.name))
        except RadosError:
            pass


# --------------------------------------------------------------- mirroring
def mirror_replay(src: Image, dst: Image, peer: str) -> int:
    """One rbd-mirror replayer pass (src/tools/rbd_mirror/ image
    replayer role): apply the src image's journal events past this
    peer's commit position onto dst, advance the position, trim.
    Returns how many events were applied.  Event application is
    idempotent (same bytes to the same extents), so a crashed replayer
    simply re-runs."""
    positions = src._mirror_positions()
    if peer not in positions:
        raise RbdError(f"peer {peer!r} not registered")
    pos = positions[peer]
    try:
        omap = src.client.omap_get(src.pool, src._joid)
    except RadosError:
        return 0
    from ..msg.wire import unpack_value
    events = sorted((int(k[1:], 16), unpack_value(bytes(v)))
                    for k, v in omap.items() if k.startswith("e"))
    applied = 0
    for seq, ev in events:
        if seq <= pos:
            continue
        if ev.get("op") == "write":
            off, data = int(ev["off"]), bytes(ev["data"])
            if off + len(data) > dst.header.size:
                dst._apply_resize(off + len(data))
            dst._apply_write(off, data)
        elif ev.get("op") == "resize":
            dst._apply_resize(int(ev["size"]))
        pos = seq
        applied += 1
    src.client.omap_set(src.pool, src._joid,
                        {f"_m.{peer}": pos.to_bytes(8, "little")})
    src._mirror_trim()
    return applied
