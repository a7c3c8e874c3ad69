"""RADOS self-managed snapshots: SnapSet clones, SnapMapper, trimming.

The PrimaryLogPG snapshot machinery (ref src/osd/PrimaryLogPG.cc
make_writeable — clone-on-first-write-after-snap, SnapSet bookkeeping in
src/osd/osd_types.h, snapid resolution in find_object_context, SnapMapper
in src/osd/SnapMapper.{h,cc}, trimming in src/osd/PrimaryLogPG.cc
SnapTrimmer), redesigned for this codebase's single-dispatch daemons:

- the client sends a SnapContext (seq + snap ids) on writes and a snapid
  on reads (MOSDOp v2 tail);
- on the first write after a new snap, the primary stages a `clone` op
  into the SAME store transaction as the write: the head is cloned to
  ObjectId(name, generation=snapid) (COW is free on BlueStore), the
  head's "ss" attr (SnapSet: seq, clone list, sizes, overlaps) is
  updated, and the PG-local SnapMapper object's omap gains a
  snapid->name row for trim lookup;
- replicas perform the identical clone via a "_snap" rider on the
  sub-write's attrs (deterministic: the primary ships the new SnapSet
  bytes, replicas don't recompute);
- clones travel recovery, scrub, and the PG log under a VIRTUAL NAME
  ("name\\0g<gen>"), so every (name, shard)-keyed subsystem handles them
  unchanged — `to_oid`/`vname` translate at the store boundary;
- deleting a head that has clones (or a live SnapContext) leaves a
  WHITEOUT head (attr "wh"=1, size 0) so the SnapSet survives — the
  reference's snapdir object role; a later write resurrects the head;
- snap removal is a map change (pool.removed_snaps): each primary trims
  asynchronously — remove the clone, update the SnapSet, tombstone the
  virtual name so recovery never resurrects it.

EC pools take the same machinery SHARD-WISE: every helper carries a
shard id (-1 = replicated head), the clone op copies each shard object
to its generation variant (the encoded bytes of the head at snap time
ARE the clone's encoded bytes — no re-encode), the SnapSet rides every
shard's attrs like "len"/"wh" already do, and the rider travels on the
EC sub-ops.  Rollback is per-shard clone->head copy; trim removes each
shard's clone object.  (The reference keeps EC snapshots behind the
overwrite journal — src/osd/PrimaryLogPG.cc snap paths + SnapMapper.cc;
here the rollback-capable pglog plays that role.)
"""

from __future__ import annotations

from ..msg.messages import MOSDOpReply, MSubWrite, PgId
from ..msg.wire import pack_value as _pack, unpack_value as _unpack
from ..ops.native import crc32c as _crc32c
from .objectstore import (CollectionId, NoSuchCollection, NoSuchObject,
                          ObjectId, Transaction)
from .pglog import LogEntry

ENOENT, EINVAL = -2, -22

_VSEP = "\x00g"
SNAPMAPPER = "_snapmapper"  # per-PG local metadata object (shard -2)


# ----------------------------------------------------- virtual-name algebra
def vname(name: str, gen: int = -1) -> str:
    """Flatten (name, generation) into the single string every
    (name, shard)-keyed subsystem (inventory, pushes, scrub, tombstones,
    PG log) already carries."""
    return name if gen < 0 else f"{name}{_VSEP}{gen}"


def vname_of(oid: ObjectId) -> str:
    return vname(oid.name, oid.generation)


def split_vname(n: str) -> tuple[str, int]:
    base, sep, g = n.partition(_VSEP)
    if not sep:
        return n, -1
    try:
        return base, int(g)
    except ValueError:
        return n, -1


def to_oid(n: str, shard: int = -1) -> ObjectId:
    base, gen = split_vname(n)
    return ObjectId(base, shard=shard, generation=gen)


def _sub_intervals(iv: list, off: int, length: int) -> list:
    """Subtract [off, off+length) from an interval list (clone_overlap
    maintenance, interval_set::subtract role)."""
    out = []
    lo, hi = off, off + length
    for s, ln in iv:
        e = s + ln
        if e <= lo or s >= hi:
            out.append([s, ln])
            continue
        if s < lo:
            out.append([s, lo - s])
        if e > hi:
            out.append([hi, e - hi])
    return out


class SnapMixin:
    """Mixed into OSDDaemon: clone-on-write, snap reads, trimming."""

    def _init_snaps(self) -> None:
        # (pool, seed, snapid) this OSD has trimmed AS PRIMARY.  Keyed
        # per-PG so a failover makes the new primary re-trim (the trim is
        # idempotent — the SnapMapper omap records what is left to do).
        self._trimmed_snaps: set[tuple[int, int, int]] = set()

    # ------------------------------------------------------------ SnapSet
    def _smap_oid(self) -> ObjectId:
        return ObjectId(SNAPMAPPER, shard=-2)

    def _load_ss(self, cid: CollectionId, name: str,
                 shard: int = -1) -> dict | None:
        try:
            raw = self.store.getattrs(
                cid, ObjectId(name, shard=shard)).get("ss")
        except (NoSuchObject, NoSuchCollection):
            return None
        return _unpack(raw) if raw else None

    def _ec_load_ss(self, pgid: PgId, name: str) -> dict | None:
        """SnapSet from ANY shard copy (the primary may hold any
        position; a behind shard may lack the attr)."""
        cid = CollectionId(pgid.pool, pgid.seed)
        for shard in range(self.osdmap.pools[pgid.pool].size):
            ss = self._load_ss(cid, name, shard=shard)
            if ss is not None:
                return ss
        return None

    def _head_whiteout(self, cid: CollectionId, name: str,
                       shard: int = -1) -> bool:
        try:
            return bool(self.store.getattrs(
                cid, ObjectId(name, shard=shard)).get("wh"))
        except (NoSuchObject, NoSuchCollection):
            return False

    def _ec_whiteout(self, pgid: PgId, name: str) -> bool:
        cid = CollectionId(pgid.pool, pgid.seed)
        for shard in range(self.osdmap.pools[pgid.pool].size):
            try:
                a = self.store.getattrs(cid, ObjectId(name, shard=shard))
            except (NoSuchObject, NoSuchCollection):
                continue
            return bool(a.get("wh"))
        return False

    # --------------------------------------------- clone-on-write staging
    def _snap_prepare(self, pgid: PgId, m) -> tuple[Transaction | None,
                                                    dict | None]:
        """Primary, before a head write/remove: stage the make_writeable
        work.  Returns (pre_tx, rider) — pre_tx prepends to the write's
        transaction, rider travels to replicas in the sub-write attrs."""
        if not m.snap_seq:
            return None, None
        if self.osdmap.pools[pgid.pool].kind == "ec":
            return None, self._snap_prepare_ec(pgid, m)
        cid = CollectionId(pgid.pool, pgid.seed)
        name = m.oid
        head = ObjectId(name)
        newest = max(m.snaps) if m.snaps else m.snap_seq
        if not self.store.exists(cid, head):
            # creating write under a snapc: record the birth seq so (a)
            # later writes under the SAME snapc don't spuriously clone
            # content written after the snap, and (b) reads at snapids
            # from before the birth answer ENOENT
            ss = {"seq": max(m.snap_seq, newest), "clones": [],
                  "sz": {}, "ov": {}, "born": max(m.snap_seq, newest)}
            ss_b = _pack(ss)
            tx = Transaction()
            tx.setattrs(cid, head, {"ss": ss_b})
            return tx, {"clone": -1, "ss": ss_b, "v": -1}
        ss = self._load_ss(cid, name) or \
            {"seq": 0, "clones": [], "sz": {}, "ov": {}}
        whiteout = self._head_whiteout(cid, name)
        if whiteout:
            # resurrection: a new birth epoch — snapids in the dead
            # window (after the last clone, before now) stay ENOENT
            ss["born"] = max(ss.get("born", 0), m.snap_seq, newest)
        need_clone = (m.snap_seq > ss["seq"] and newest not in ss["clones"]
                      and not whiteout)
        # overlap shrink applies on EVERY head write once clones exist
        written: tuple[int, int] | None = None
        if m.op == "write":
            written = (m.offset, len(m.data))
        elif m.op in ("write_full", "remove", "snap_rollback"):
            try:
                # raw (logical) size: overlap intervals live in raw space
                old_size = self._obj_raw_size(cid, head)
            except (NoSuchObject, NoSuchCollection):
                old_size = 0
            written = (0, max(old_size, len(getattr(m, "data", b""))))
        tx = Transaction()
        cloneid = -1
        clone_v = -1
        if need_clone:
            cloneid = newest
            clone = ObjectId(name, generation=cloneid)
            tx.clone(cid, head, clone)
            size = self._obj_raw_size(cid, head)
            ss["clones"] = sorted(set(ss["clones"]) | {cloneid})
            ss["sz"][cloneid] = size
            ss["ov"][cloneid] = [[0, size]]
            clone_v = self._next_version(pgid)
            self._log_apply(tx, pgid, LogEntry(
                clone_v, "write", vname(name, cloneid), -1,
                prev_version=-1))
            tx.omap_setkeys(cid, self._smap_oid(),
                            {f"{cloneid:016x}.{name}": b""})
        ss["seq"] = max(ss["seq"], m.snap_seq, newest)
        if written and ss["clones"]:
            top = ss["clones"][-1]
            ss["ov"][top] = _sub_intervals(
                ss["ov"].get(top, []), written[0], written[1])
        ss_b = _pack(ss)
        tx.setattrs(cid, head, {"ss": ss_b})
        rider = {"clone": cloneid, "ss": ss_b, "v": clone_v}
        return tx, rider

    def _snap_prepare_ec(self, pgid: PgId, m) -> dict | None:
        """Primary, EC pool: compute the make_writeable decision and
        the final SnapSet.  Returns the rider every shard holder
        (primary included) applies locally via _snap_apply_rider — the
        clone itself is per-shard (the encoded head bytes at snap time
        ARE the clone's encoded bytes), so no pre-tx is staged here."""
        name = m.oid
        newest = max(m.snaps) if m.snaps else m.snap_seq
        existing = self._ec_object_len(pgid, name)
        if existing is None:
            ss = {"seq": max(m.snap_seq, newest), "clones": [],
                  "sz": {}, "ov": {},
                  "born": max(m.snap_seq, newest)}
            return {"clone": -1, "ss": _pack(ss), "v": -1}
        ss = self._ec_load_ss(pgid, name) or \
            {"seq": 0, "clones": [], "sz": {}, "ov": {}}
        whiteout = self._ec_whiteout(pgid, name)
        if whiteout:
            ss["born"] = max(ss.get("born", 0), m.snap_seq, newest)
        need_clone = (m.snap_seq > ss["seq"]
                      and newest not in ss["clones"] and not whiteout)
        written: tuple[int, int] | None = None
        if m.op == "write":
            written = (m.offset, len(m.data))
        elif m.op in ("write_full", "remove", "snap_rollback"):
            written = (0, max(existing, len(getattr(m, "data", b""))))
        cloneid = clone_v = -1
        if need_clone:
            cloneid = newest
            ss["clones"] = sorted(set(ss["clones"]) | {cloneid})
            ss["sz"][cloneid] = existing
            ss["ov"][cloneid] = [[0, existing]]
            clone_v = self._next_version(pgid)
        ss["seq"] = max(ss["seq"], m.snap_seq, newest)
        if written and ss["clones"]:
            top = ss["clones"][-1]
            ss["ov"][top] = _sub_intervals(
                ss["ov"].get(top, []), written[0], written[1])
        return {"clone": cloneid, "ss": _pack(ss), "v": clone_v}

    def _snap_apply_rider(self, pgid: PgId, name: str,
                          rider: dict, shard: int = -1) -> Transaction:
        """Any holder: rebuild the primary's snap pre-tx
        deterministically from the rider (ships the final SnapSet
        bytes).  shard >= 0 clones/stamps that EC shard object."""
        cid = CollectionId(pgid.pool, pgid.seed)
        head = ObjectId(name, shard=shard)
        tx = Transaction()
        cloneid = int(rider.get("clone", -1))
        clone = ObjectId(name, shard=shard, generation=cloneid)
        if cloneid >= 0 and self.store.exists(cid, head) and \
                not self.store.exists(cid, clone):
            tx.clone(cid, head, clone)
            self._log_apply(tx, pgid, LogEntry(
                int(rider.get("v", -1)), "write", vname(name, cloneid),
                shard, prev_version=-1))
            tx.omap_setkeys(cid, self._smap_oid(),
                            {f"{cloneid:016x}.{name}": b""})
        if not self.store.exists(cid, head):
            # creating write: the SnapSet (with its birth seq) must land
            # WITH the object, or the next write under the same snapc
            # sees no ss and stages a spurious clone of post-snap data
            tx.touch(cid, head)
        tx.setattrs(cid, head, {"ss": bytes(rider["ss"])})
        return tx

    # ------------------------------------------------------- read resolve
    def _snap_resolve(self, cid: CollectionId, name: str,
                      snapid: int) -> ObjectId | None:
        """find_object_context role: which object serves a read at
        snapid?  None = ENOENT."""
        if snapid == 0:
            if self._head_whiteout(cid, name):
                return None
            return ObjectId(name)
        ss = self._load_ss(cid, name)
        clones = (ss or {}).get("clones", [])
        covering = [c for c in clones if c >= snapid]
        if covering:
            target = ObjectId(name, generation=min(covering))
            if self.store.exists(cid, target):
                return target
            return None
        # before the object's birth (created under a later snapc, or
        # resurrected after a whiteout): it did not exist at that snap
        if ss and snapid <= ss.get("born", 0):
            return None
        # newer than every clone: the head is the living state
        if self._head_whiteout(cid, name):
            return None
        return ObjectId(name)

    def _ec_snap_resolve(self, pgid: PgId, name: str,
                         snapid: int) -> str | None:
        """find_object_context for EC pools: which VNAME serves a read
        at snapid?  None = ENOENT.  Existence is judged from the
        SnapSet, not per-shard probes — degraded clones decode from the
        surviving shards like any other object."""
        if snapid == 0:
            return None if self._ec_whiteout(pgid, name) else name
        ss = self._ec_load_ss(pgid, name)
        clones = (ss or {}).get("clones", [])
        covering = [c for c in clones if c >= snapid]
        if covering:
            return vname(name, min(covering))
        if ss and snapid <= ss.get("born", 0):
            return None
        if self._ec_whiteout(pgid, name):
            return None
        return name

    # ------------------------------------------------------- extended ops
    def _op_list_snaps(self, conn, m, pgid: PgId, up: list) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        if self.osdmap.pools[pgid.pool].kind == "ec":
            if self._ec_object_len(pgid, m.oid) is None:
                conn.send(MOSDOpReply(m.tid, ENOENT,
                                      epoch=self.osdmap.epoch))
                return
            ss = self._ec_load_ss(pgid, m.oid) or \
                {"seq": 0, "clones": [], "sz": {}, "ov": {}}
            out = dict(ss)
            out["head"] = not self._ec_whiteout(pgid, m.oid)
            conn.send(MOSDOpReply(m.tid, 0, data=_pack(out),
                                  epoch=self.osdmap.epoch))
            return
        if not self.store.exists(cid, ObjectId(m.oid)):
            conn.send(MOSDOpReply(m.tid, ENOENT, epoch=self.osdmap.epoch))
            return
        ss = self._load_ss(cid, m.oid) or \
            {"seq": 0, "clones": [], "sz": {}, "ov": {}}
        out = dict(ss)
        out["head"] = not self._head_whiteout(cid, m.oid)
        conn.send(MOSDOpReply(m.tid, 0, data=_pack(out),
                              epoch=self.osdmap.epoch))

    def _op_snap_rollback(self, conn, m, pgid: PgId, up: list) -> None:
        """Roll the head back to its state at snapid (the rados rollback
        op: PrimaryLogPG _rollback_to)."""
        key = (pgid, m.oid)

        def thunk(conn=conn, m=m, pgid=pgid, key=key):
            up2 = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
            self._do_snap_rollback(conn, m, pgid, up2, lock_key=key)

        self._obj_lock(key, thunk)

    def _do_snap_rollback(self, conn, m, pgid: PgId, up: list,
                          lock_key) -> None:
        if self.osdmap.pools[pgid.pool].kind == "ec":
            self._do_snap_rollback_ec(conn, m, pgid, up, lock_key)
            return
        cid = CollectionId(pgid.pool, pgid.seed)
        name = m.oid
        # rollback is a head WRITE: it goes through make_writeable, so
        # head state owed to a newer snapshot gets its clone first
        snap_tx, rider = self._snap_prepare(pgid, m)
        ss = (_unpack(bytes(rider["ss"])) if rider is not None
              else self._load_ss(cid, name)) or \
            {"seq": 0, "clones": [], "sz": {}, "ov": {}}
        covering = [c for c in ss["clones"] if c >= m.snapid]
        if not covering:
            if self._snap_resolve(cid, name, m.snapid) is None and \
                    self.store.exists(cid, ObjectId(name)):
                # the object did NOT exist at snapid (born later, or
                # whiteout window): rolling back means it ceases to
                # exist — a replicated remove (find_object_context
                # pre-birth + PrimaryLogPG _rollback_to ENOENT path)
                self._rep_remove(conn, m, pgid, up)
                self._obj_unlock(lock_key)
                return
            # head already IS the state at snapid (or nothing exists)
            code = 0 if (self.store.exists(cid, ObjectId(name))
                         and not self._head_whiteout(cid, name)) else ENOENT
            conn.send(MOSDOpReply(m.tid, code, epoch=self.osdmap.epoch))
            self._obj_unlock(lock_key)
            return
        cloneid = min(covering)
        version = self._next_version(pgid)
        ss_b = _pack(ss)
        self._apply_snap_rollback(pgid, name, cloneid, ss_b, version,
                                  pre_tx=snap_tx)
        peers = [u for u in up if u is not None and u != self.osd_id]
        if not peers:
            conn.send(MOSDOpReply(m.tid, 0, version=version,
                                  epoch=self.osdmap.epoch))
            self._obj_unlock(lock_key)
            return
        tid = next(self._tids)
        from .daemon import _PendingWrite
        pw = _PendingWrite(m.client, m.tid, len(peers), version)
        pw.span = getattr(m, '_span', None)
        pw.lock_key = lock_key
        self._pending_writes[tid] = pw
        payload = _pack({"cloneid": cloneid, "ss": ss_b,
                         "rider": rider})
        for peer in peers:
            self.messenger.send_message(
                f"osd.{peer}",
                MSubWrite(tid, pgid, name, -1, version, "snap_rollback",
                          payload, epoch=self._entry_epoch()))

    def _apply_snap_rollback(self, pgid: PgId, name: str, cloneid: int,
                             ss_b: bytes, version: int,
                             pre_tx: Transaction | None = None,
                             shard: int = -1,
                             total_len: int = -1) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        head = ObjectId(name, shard=shard)
        clone = ObjectId(name, shard=shard, generation=cloneid)
        if not self.store.exists(cid, clone):
            return
        tx = Transaction()
        if pre_tx is not None:  # make_writeable clone of the current head
            tx.append(pre_tx)
        data = self.store.read(cid, clone).to_bytes()
        clone_attrs = dict(self.store.getattrs(cid, clone))
        if self.store.exists(cid, head):
            tx.remove(cid, head)
        tx.clone(cid, clone, head)
        # the clone's copied attrs carry a STALE SnapSet and version:
        # restamp with the live ones (and clear any whiteout).  EC
        # shards carry the WHOLE-object length in "len" (the snapshot's
        # size from the SnapSet), not the shard-stream length.  The
        # clone op copies the STORED bytes (and their cz/crl extent
        # metadata): d covers them as stored, and a compressed clone's
        # logical length is its recorded raw length.
        rep_len = (int(clone_attrs["crl"]) if "cz" in clone_attrs
                   else len(data))
        tx.setattrs(cid, head, {"ss": ss_b, "v": version, "wh": 0,
                                "ev": self._entry_epoch(),
                                "len": (total_len if shard >= 0
                                        and total_len >= 0
                                        else rep_len),
                                "d": _crc32c(data)})
        self._log_apply(tx, pgid, LogEntry(version, "write", name, shard,
                                           prev_version=-1))
        self.store.queue_transaction(tx)

    def _do_snap_rollback_ec(self, conn, m, pgid: PgId, up: list,
                             lock_key) -> None:
        """EC rollback: each shard copies its clone object back over
        its head shard — the clone's encoded bytes ARE the head's bytes
        at snap time, so no decode/re-encode round trip is needed."""
        name = m.oid
        _tx, rider = self._snap_prepare(pgid, m)  # may clone the head
        ss = (_unpack(bytes(rider["ss"])) if rider is not None
              else self._ec_load_ss(pgid, name)) or \
            {"seq": 0, "clones": [], "sz": {}, "ov": {}}
        covering = [c for c in ss["clones"] if c >= m.snapid]
        if not covering:
            exists = self._ec_object_len(pgid, name) is not None
            if exists and \
                    self._ec_snap_resolve(pgid, name, m.snapid) is None:
                # born after the snap: rollback removes it (pre-birth)
                self._ec_remove(conn, m, pgid, up, lock_key=lock_key)
                return
            code = 0 if (exists and not self._ec_whiteout(pgid, name)) \
                else ENOENT
            conn.send(MOSDOpReply(m.tid, code, epoch=self.osdmap.epoch))
            self._obj_unlock(lock_key)
            return
        cloneid = min(covering)
        total = int(ss.get("sz", {}).get(cloneid, 0))
        version = self._next_version(pgid)
        ss_b = _pack(ss)
        payload = _pack({"cloneid": cloneid, "ss": ss_b,
                         "rider": rider, "total": total})
        tid = next(self._tids)
        remote = sum(1 for o in up
                     if o is not None and o != self.osd_id)
        if remote:  # registered before any send (sharded dispatch)
            from .daemon import _PendingWrite
            pw = _PendingWrite(m.client, m.tid, remote, version)
            pw.span = getattr(m, '_span', None)
            pw.lock_key = lock_key
            self._pending_writes[tid] = pw
        epoch = self._entry_epoch()
        for shard, osd in enumerate(up):
            if osd is None:
                continue
            if osd == self.osd_id:
                pre = (self._snap_apply_rider(pgid, name, rider,
                                              shard=shard)
                       if rider is not None else None)
                self._apply_snap_rollback(pgid, name, cloneid, ss_b,
                                          version, pre_tx=pre,
                                          shard=shard, total_len=total)
            else:
                self.messenger.send_message(
                    f"osd.{osd}",
                    MSubWrite(tid, pgid, name, shard, version,
                              "snap_rollback", payload, epoch=epoch))
        self._ec_cache.invalidate(pgid, name)
        if remote == 0:
            conn.send(MOSDOpReply(m.tid, 0, version=version,
                                  epoch=self.osdmap.epoch))
            self._obj_unlock(lock_key)
            return

    # ----------------------------------------------------------- whiteout
    def _apply_whiteout(self, pgid: PgId, name: str, version: int,
                        pre_tx: Transaction | None = None,
                        shard: int = -1) -> None:
        """Delete a head that has clones: the object becomes a zero-size
        whiteout so the SnapSet survives (the snapdir role).  For EC,
        each shard object whiteouts independently (shard >= 0)."""
        cid = CollectionId(pgid.pool, pgid.seed)
        head = ObjectId(name, shard=shard)
        tx = Transaction()
        if pre_tx is not None:
            tx.append(pre_tx)
        if not self.store.exists(cid, head):
            return
        tx.truncate(cid, head, 0)
        tx.setattrs(cid, head, {"wh": 1, "v": version, "len": 0,
                                "d": _crc32c(b""),
                                "ev": self._entry_epoch()})
        self._log_apply(tx, pgid, LogEntry(version, "write", name, shard,
                                           prev_version=-1))
        self.store.queue_transaction(tx)

    # ---------------------------------------------------------- trimming
    def _snap_trim_check(self) -> None:
        """After a map update: trim clones of newly removed snaps on
        every PG this OSD leads (SnapTrimmer role; idempotent)."""
        if self.osdmap is None:
            return
        for pool in list(self.osdmap.pools.values()):
            for snapid in pool.removed_snaps:
                self._trim_snap(pool, snapid)

    def _trim_snap(self, pool, snapid: int) -> None:
        for seed in range(pool.pg_num):
            up = self.osdmap.pg_to_up_osds(pool.pool_id, seed)
            if self._primary_of(up) != self.osd_id:
                continue
            key = (pool.pool_id, seed, snapid)
            if key in self._trimmed_snaps:
                continue
            self._trimmed_snaps.add(key)
            pgid = PgId(pool.pool_id, seed)
            cid = CollectionId(pool.pool_id, seed)
            try:
                smap = self.store.omap_get(cid, self._smap_oid())
            except (NoSuchObject, NoSuchCollection):
                continue
            prefix = f"{snapid:016x}."
            for k in sorted(smap):
                if not k.startswith(prefix):
                    continue
                name = k[len(prefix):]
                key = (pgid, name)

                def thunk(name=name, pgid=pgid, snapid=snapid, key=key):
                    try:
                        self._trim_one(pgid, name, snapid)
                    finally:
                        self._obj_unlock(key)

                self._obj_lock(key, thunk)

    def _trim_one(self, pgid: PgId, name: str, snapid: int) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        is_ec = self.osdmap.pools[pgid.pool].kind == "ec"
        version = self._next_version(pgid)
        ss = (self._ec_load_ss(pgid, name) if is_ec
              else self._load_ss(cid, name)) or \
            {"seq": 0, "clones": [], "sz": {}, "ov": {}}
        ss["clones"] = [c for c in ss["clones"] if c != snapid]
        ss["sz"].pop(snapid, None)
        ss["ov"].pop(snapid, None)
        drop_head = (not ss["clones"]
                     and (self._ec_whiteout(pgid, name) if is_ec
                          else self._head_whiteout(cid, name)))
        ss_b = _pack(ss)
        up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
        payload = _pack({"snapid": snapid, "ss": ss_b,
                         "drop_head": drop_head})
        tid = next(self._tids)
        epoch = self._entry_epoch()
        if is_ec:
            # per-shard: each holder trims its own shard clone object
            for shard, osd in enumerate(up):
                if osd is None:
                    continue
                if osd == self.osd_id:
                    self._apply_trim(pgid, name, snapid, ss_b,
                                     drop_head, version, shard=shard)
                else:
                    self.messenger.send_message(
                        f"osd.{osd}",
                        MSubWrite(tid, pgid, name, shard, version,
                                  "trim_clone", payload, epoch=epoch))
        else:
            self._apply_trim(pgid, name, snapid, ss_b, drop_head,
                             version)
            for peer in up:
                if peer is not None and peer != self.osd_id:
                    self.messenger.send_message(
                        f"osd.{peer}",
                        MSubWrite(tid, pgid, name, -1, version,
                                  "trim_clone", payload, epoch=epoch))
        self.perf.inc("snap_trims")

    def _apply_trim(self, pgid: PgId, name: str, snapid: int, ss_b: bytes,
                    drop_head: bool, version: int,
                    shard: int = -1) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        clone = ObjectId(name, shard=shard, generation=snapid)
        head = ObjectId(name, shard=shard)
        tx = Transaction()
        if self.store.exists(cid, clone):
            tx.remove(cid, clone)
        if self.store.exists(cid, head):
            if drop_head:
                tx.remove(cid, head)
            else:
                tx.setattrs(cid, head, {"ss": ss_b})
        try:
            if f"{snapid:016x}.{name}" in self.store.omap_get(
                    cid, self._smap_oid()):
                tx.omap_rmkeys(cid, self._smap_oid(),
                               [f"{snapid:016x}.{name}"])
        except (NoSuchObject, NoSuchCollection):
            pass
        self._log_apply(tx, pgid, LogEntry(
            version, "remove", vname(name, snapid), shard,
            prev_version=-1))
        if not tx.empty():
            self.store.queue_transaction(tx)
        self._record_tombstone(pgid, vname(name, snapid), version)
        if drop_head:
            self._record_tombstone(pgid, name, version)
