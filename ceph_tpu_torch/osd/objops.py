"""Extended object ops: omap, watch/notify, object classes.

The PrimaryLogPG op breadth beyond read/write/remove/stat (ref
PrimaryLogPG::do_osd_ops op-switch :6163 — omap get/set/rm ops,
watch/notify via src/osd/Watch.cc, `call` into object classes), as a
mixin on OSDDaemon.

EC pools: omap and user xattrs are supported via full replication to
EVERY shard holder's shard object (the ECOmapJournal capability,
doc/dev/osd_internals/erasure_coding: metadata rides the same
versioned, journaled, rollback-able path as shard data and survives
any k-of-n subset; recovery pushes carry it).  Data-mutating steps in
compound ops and data-mutating cls effects stay EINVAL on EC (they
belong to the stripe pipeline); watch/notify is primary-local soft
state (clients re-register on map change, the linger-op semantic) and
works on either pool kind.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..msg.messages import (MNotifyAck, MOSDOpReply, MSubWrite,
                            MWatchNotify, PgId)
from ..msg.wire import pack_value as _pack, unpack_value as _unpack
from ..ops.native import crc32c as _crc32c
from . import classes as cls_mod
from .objectstore import CollectionId, NoSuchObject, ObjectId, Transaction

EIO, ENOENT, EINVAL = -5, -2, -22
EEXIST, ERANGE = -17, -34

# user xattrs live in the object attr dict under this prefix so they can
# never collide with the internal v/d/len bookkeeping attrs
_XATTR_PREFIX = "u:"


def _user_xattrs(attrs: dict) -> dict:
    return {k[len(_XATTR_PREFIX):]: bytes(v) for k, v in attrs.items()
            if isinstance(k, str) and k.startswith(_XATTR_PREFIX)}


@dataclass
class _PendingNotify:
    client: str
    client_tid: int
    waiting: set
    acked: list = field(default_factory=list)
    stamp: float = field(default_factory=time.time)


class ObjOpsMixin:
    """Mixed into OSDDaemon; dispatches the extended replicated ops."""

    WATCH_TIMEOUT = 30.0  # Watch.cc timeout role; clients renew

    def _init_objops(self) -> None:
        # (pgid, oid) -> {client: (cookie, expires)}  (Watch.cc state)
        self._watchers: dict[tuple, dict[str, tuple]] = {}
        self._pending_notifies: dict[int, _PendingNotify] = {}

    # ------------------------------------------------------ shard routing
    def _is_ec(self, pgid: PgId) -> bool:
        return self.osdmap.pools[pgid.pool].kind == "ec"

    def _my_shard(self, pgid: PgId) -> int:
        up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
        return up.index(self.osd_id) if self.osd_id in up else 0

    def _local_obj(self, pgid: PgId, oid: str) -> ObjectId:
        """The store object this OSD holds for `oid`: plain on
        replicated pools, MY shard object on EC (metadata replicates to
        every shard holder — the ECOmapJournal durability model)."""
        if self._is_ec(pgid):
            return ObjectId(oid, shard=self._my_shard(pgid))
        return ObjectId(oid)

    def _meta_fanout(self, pgid: PgId, up: list) -> list[tuple[int, int]]:
        """(peer_osd, shard_for_peer) for a metadata mutation: every
        shard holder on EC, every replica on replicated pools."""
        out = []
        for pos, osd in enumerate(up):
            if osd is None or osd == self.osd_id:
                continue
            out.append((osd, pos if self._is_ec(pgid) else -1))
        return out

    # ---------------------------------------------------------- dispatch
    EXTENDED_OPS = ("omap_get", "omap_set", "omap_rm", "watch",
                    "unwatch", "notify", "call", "list_snaps",
                    "snap_rollback", "multi_write", "multi_read",
                    "getxattrs")

    def _handle_extended_op(self, conn, m, pgid: PgId, up: list) -> None:
        handler = {
            "omap_get": self._op_omap_get,
            "omap_set": self._op_omap_mut,
            "omap_rm": self._op_omap_mut,
            "watch": self._op_watch,
            "unwatch": self._op_watch,
            "notify": self._op_notify,
            "call": self._op_call,
            "list_snaps": self._op_list_snaps,
            "snap_rollback": self._op_snap_rollback,
            "multi_write": self._op_multi_write,
            "multi_read": self._op_multi_read,
            "getxattrs": self._op_getxattrs,
        }[m.op]
        handler(conn, m, pgid, up)

    # -------------------------------------------------------------- omap
    def _op_omap_get(self, conn, m, pgid: PgId, up: list) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        try:
            omap = self.store.omap_get(cid, self._local_obj(pgid, m.oid))
        except NoSuchObject:
            conn.send(MOSDOpReply(m.tid, ENOENT,
                                  epoch=self.osdmap.epoch))
            return
        conn.send(MOSDOpReply(m.tid, 0, data=_pack(omap),
                              epoch=self.osdmap.epoch))

    def _op_omap_mut(self, conn, m, pgid: PgId, up: list) -> None:
        """omap_set (data = packed {key: bytes}) / omap_rm (data =
        packed [keys]); replicated like any write — on EC, to every
        shard holder's shard object."""
        payload = _unpack(m.data)
        version = self._next_version(pgid)
        my_shard = self._my_shard(pgid) if self._is_ec(pgid) else -1
        if not self._apply_omap(pgid, m.oid, m.op, payload, version,
                                create_ok=(m.op == "omap_set"),
                                shard=my_shard):
            conn.send(MOSDOpReply(m.tid, ENOENT,
                                  epoch=self.osdmap.epoch))
            return
        fanout = self._meta_fanout(pgid, up)
        if not fanout:
            conn.send(MOSDOpReply(m.tid, 0, version=version,
                                  epoch=self.osdmap.epoch))
            return
        tid = next(self._tids)
        from .daemon import _PendingWrite
        self._pending_writes[tid] = _PendingWrite(
            m.client, m.tid, len(fanout), version)
        self._pending_writes[tid].span = getattr(m, '_span', None)
        for peer, shard in fanout:
            self.messenger.send_message(
                f"osd.{peer}",
                MSubWrite(tid, pgid, m.oid, shard, version, m.op,
                          m.data, epoch=self._entry_epoch(),
                          tenant=m.tenant))

    def _apply_omap(self, pgid: PgId, oid: str, op: str, payload,
                    version: int, create_ok: bool = False,
                    shard: int = -1) -> bool:
        from .pglog import LogEntry
        cid = CollectionId(pgid.pool, pgid.seed)
        obj = ObjectId(oid, shard=shard)
        tx = Transaction()
        exists = self.store.exists(cid, obj)
        if not exists:
            if not create_ok:
                return False
            tx.touch(cid, obj)
        if op == "omap_set":
            tx.omap_setkeys(cid, obj, {str(k): bytes(v)
                                       for k, v in payload.items()})
        else:
            keys = [str(k) for k in payload]
            have = set(self.store.omap_get(cid, obj))
            tx.omap_rmkeys(cid, obj, [k for k in keys if k in have])
        data = self.store.read(cid, obj).to_bytes() if exists else b""
        # d covers the STORED bytes (compressed or not) — content is
        # untouched by an omap op, so this recompute is a no-op refresh
        attrs = {"v": version, "d": _crc32c(data)}
        if shard >= 0 and exists:
            # EC shard convention: "len" holds the TOTAL object length
            # (set by the stripe write path) — preserve it
            old_len = self.store.getattrs(cid, obj).get("len")
            attrs["len"] = old_len if old_len is not None else len(data)
        elif exists:
            # replicated "len" keeps RAW semantics (a compressed blob's
            # stored size is not its logical size)
            attrs["len"] = self._obj_raw_size(cid, obj)
        else:
            attrs["len"] = len(data)
        tx.setattrs(cid, obj, attrs)
        # every versioned mutation logs (last-complete must stay
        # contiguous; delta recovery replays the object WITH its omap)
        self._log_apply(tx, pgid, LogEntry(version, "omap", oid, shard,
                                           prev_version=-1))
        self.store.queue_transaction(tx)
        return True

    # ------------------------------------------------------ watch/notify
    def _op_watch(self, conn, m, pgid: PgId, up: list) -> None:
        key = (pgid, m.oid)
        watchers = self._watchers.setdefault(key, {})
        if m.op == "watch":
            # offset carries the cookie; registration doubles as renewal
            watchers[m.client] = (m.offset,
                                  time.time() + self.WATCH_TIMEOUT)
        else:
            watchers.pop(m.client, None)
            if not watchers:
                self._watchers.pop(key, None)
        conn.send(MOSDOpReply(m.tid, 0, epoch=self.osdmap.epoch))

    def _op_notify(self, conn, m, pgid: PgId, up: list) -> None:
        watchers = dict(self._watchers.get((pgid, m.oid), {}))
        watchers.pop(m.client, None)  # don't notify the notifier
        if not watchers:
            conn.send(MOSDOpReply(m.tid, 0, data=_pack([]),
                                  epoch=self.osdmap.epoch))
            return
        nid = next(self._tids)
        self._pending_notifies[nid] = _PendingNotify(
            m.client, m.tid, waiting=set(watchers))
        for watcher in watchers:
            self.messenger.send_message(
                watcher, MWatchNotify(nid, pgid.pool, m.oid, m.client,
                                      m.data))

    def _handle_notify_ack(self, conn, m: MNotifyAck) -> None:
        pn = self._pending_notifies.get(m.notify_id)
        if pn is None:
            return
        pn.waiting.discard(m.watcher)
        pn.acked.append(m.watcher)
        if pn.waiting:
            return
        del self._pending_notifies[m.notify_id]
        self.messenger.send_message(
            pn.client,
            MOSDOpReply(pn.client_tid, 0, data=_pack(sorted(pn.acked)),
                        epoch=self.osdmap.epoch))

    def _sweep_notifies(self, now: float, max_age: float) -> None:
        # expire watchers that stopped renewing (crashed clients must
        # not make every notify wait out the timeout forever)
        for key, watchers in list(self._watchers.items()):
            for client, (_c, expires) in list(watchers.items()):
                if now > expires:
                    watchers.pop(client, None)
            if not watchers:
                self._watchers.pop(key, None)
        for nid, pn in list(self._pending_notifies.items()):
            if now - pn.stamp > max_age:
                del self._pending_notifies[nid]
                # partial completion: report who DID ack (the reference
                # returns a timeout list alongside)
                self.messenger.send_message(
                    pn.client,
                    MOSDOpReply(pn.client_tid, 0,
                                data=_pack(sorted(pn.acked)),
                                epoch=self.osdmap.epoch
                                if self.osdmap else 0))

    # ---------------------------------------------------- object classes
    def _op_call(self, conn, m, pgid: PgId, up: list) -> None:
        """`call cls.method(input)`: run the class method against the
        object, then apply its queued effects through the replicated
        write path (ClassHandler + do_osd_ops `call`).  On EC pools the
        method sees omap/xattr state but NOT assembled stripe data
        (ctx.data is empty), and data-mutating effects are rejected —
        the built-in metadata classes (cls_lock, cls_version) are
        exactly this shape."""
        req = _unpack(m.data)
        cid = CollectionId(pgid.pool, pgid.seed)
        is_ec = self._is_ec(pgid)
        obj = self._local_obj(pgid, m.oid)
        exists = self.store.exists(cid, obj)
        data = (self._read_obj_raw(cid, obj)[0]
                if exists and not is_ec else b"")
        omap = self.store.omap_get(cid, obj) if exists else {}
        ctx = cls_mod.ClsContext(data, omap, exists)
        try:
            out = cls_mod.call(req["cls"], req["method"], ctx,
                               req.get("input"))
        except cls_mod.ClsError as e:
            conn.send(MOSDOpReply(m.tid, e.code,
                                  data=_pack(str(e)),
                                  epoch=self.osdmap.epoch))
            return
        except Exception as e:  # noqa: BLE001 - class bug must still reply
            conn.send(MOSDOpReply(m.tid, EIO, data=_pack(repr(e)),
                                  epoch=self.osdmap.epoch))
            return
        if is_ec and ctx.new_data is not None:
            conn.send(MOSDOpReply(m.tid, EINVAL,
                                  data=_pack("cls data write on EC"),
                                  epoch=self.osdmap.epoch))
            return
        mutated = (ctx.new_data is not None or ctx.omap_set
                   or ctx.omap_rm)
        if not mutated:
            conn.send(MOSDOpReply(m.tid, 0, data=_pack(out),
                                  epoch=self.osdmap.epoch))
            return
        version = self._next_version(pgid)
        effects = {"data": ctx.new_data, "set": dict(ctx.omap_set),
                   "rm": sorted(ctx.omap_rm)}
        self._apply_cls_effects(pgid, m.oid, effects, version,
                                shard=self._my_shard(pgid) if is_ec
                                else -1)
        fanout = self._meta_fanout(pgid, up)
        if not fanout:
            conn.send(MOSDOpReply(m.tid, 0, data=_pack(out),
                                  version=version,
                                  epoch=self.osdmap.epoch))
            return
        tid = next(self._tids)
        from .daemon import _PendingWrite
        pw = _PendingWrite(m.client, m.tid, len(fanout), version)
        pw.span = getattr(m, '_span', None)
        pw.reply_data = _pack(out)
        self._pending_writes[tid] = pw
        for peer, shard in fanout:
            self.messenger.send_message(
                f"osd.{peer}",
                MSubWrite(tid, pgid, m.oid, shard, version,
                          "cls_effects", _pack(effects),
                          epoch=self._entry_epoch(),
                          tenant=m.tenant))

    def _apply_cls_effects(self, pgid: PgId, oid: str, effects: dict,
                           version: int, shard: int = -1) -> None:
        from .pglog import LogEntry
        cid = CollectionId(pgid.pool, pgid.seed)
        obj = ObjectId(oid, shard=shard)
        tx = Transaction()
        exists = self.store.exists(cid, obj)
        if not exists:
            tx.touch(cid, obj)
        if effects.get("data") is not None:
            tx.truncate(cid, obj, 0)
            tx.write(cid, obj, 0, effects["data"])
            # raw rewrite of a possibly-compressed blob: drop the
            # stale extent metadata (setattrs merges)
            tx.rmattr(cid, obj, "cz")
            tx.rmattr(cid, obj, "crl")
            data = bytes(effects["data"])
        else:
            data = self.store.read(cid, obj).to_bytes() if exists \
                else b""
        if effects.get("set"):
            tx.omap_setkeys(cid, obj, {str(k): bytes(v) for k, v
                                       in effects["set"].items()})
        if effects.get("rm"):
            have = set(self.store.omap_get(cid, obj)) if exists else set()
            tx.omap_rmkeys(cid, obj,
                           [k for k in effects["rm"] if k in have])
        # digest/len must track the NEW content or deep scrub flags a
        # phantom mismatch and stat() reports the stale length
        attrs = {"v": version, "d": _crc32c(data)}
        if shard >= 0 and exists and effects.get("data") is None:
            old_len = self.store.getattrs(cid, obj).get("len")
            attrs["len"] = old_len if old_len is not None else len(data)
        elif exists and effects.get("data") is None:
            attrs["len"] = self._obj_raw_size(cid, obj)
        else:
            attrs["len"] = len(data)
        tx.setattrs(cid, obj, attrs)
        self._log_apply(tx, pgid, LogEntry(version, "cls", oid, shard,
                                           prev_version=-1))
        self.store.queue_transaction(tx)

    # -------------------------------------------------------- user xattrs
    def _op_getxattrs(self, conn, m, pgid: PgId, up: list) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        try:
            attrs = self.store.getattrs(cid, self._local_obj(pgid, m.oid))
        except NoSuchObject:
            conn.send(MOSDOpReply(m.tid, ENOENT, epoch=self.osdmap.epoch))
            return
        if attrs.get("wh"):  # whiteout tombstone = logically absent
            conn.send(MOSDOpReply(m.tid, ENOENT, epoch=self.osdmap.epoch))
            return
        conn.send(MOSDOpReply(m.tid, 0, data=_pack(_user_xattrs(attrs)),
                              epoch=self.osdmap.epoch))

    # ------------------------------------------------------- compound ops
    # The do_osd_ops batching contract (PrimaryLogPG::do_osd_ops executes
    # the op vector in order inside one transaction; any failing step
    # unwinds the whole op): guards are checked against a simulated object
    # state, mutations fold into ONE effects record, and nothing touches
    # the store until every step has passed.

    def _op_multi_read(self, conn, m, pgid: PgId, up: list) -> None:
        steps = _unpack(m.data)
        cid = CollectionId(pgid.pool, pgid.seed)
        is_ec = self._is_ec(pgid)
        obj = self._local_obj(pgid, m.oid)
        if is_ec and any(st.get("op") == "read" for st in steps):
            # stripe data reads belong to the EC read pipeline (use the
            # plain read op); metadata steps are served here
            conn.send(MOSDOpReply(m.tid, EINVAL,
                                  epoch=self.osdmap.epoch))
            return
        exists = (self.store.exists(cid, obj)
                  and not self._head_whiteout(cid, m.oid))
        data: bytes | None = None  # loaded on the first step that needs it

        def cur() -> bytes:
            nonlocal data
            if data is None:
                data = (self._read_obj_raw(cid, obj)[0]
                        if exists else b"")
            return data

        def size() -> int:
            if data is not None:
                return len(data)
            attrs = self.store.getattrs(cid, obj) if exists else {}
            ln = attrs.get("len")  # NOT .get(k, len(cur())): the
            # default would evaluate eagerly and always load the body
            return int(ln) if ln is not None else len(cur())

        results = []
        for st in steps:
            op = st.get("op")
            if op == "assert_exists":
                if not exists:
                    conn.send(MOSDOpReply(m.tid, ENOENT,
                                          epoch=self.osdmap.epoch))
                    return
                results.append(None)
            elif op == "read":
                if not exists:
                    conn.send(MOSDOpReply(m.tid, ENOENT,
                                          epoch=self.osdmap.epoch))
                    return
                off = int(st.get("off", 0))
                ln = int(st.get("len", 0)) or len(cur()) - off
                results.append(cur()[off:off + max(ln, 0)])
            elif op == "stat":
                if not exists:
                    conn.send(MOSDOpReply(m.tid, ENOENT,
                                          epoch=self.osdmap.epoch))
                    return
                results.append(size())
            elif op == "omap_get":
                results.append(self.store.omap_get(cid, obj)
                               if exists else {})
            elif op == "getxattrs":
                results.append(_user_xattrs(
                    self.store.getattrs(cid, obj) if exists else {}))
            else:
                conn.send(MOSDOpReply(m.tid, EINVAL,
                                      epoch=self.osdmap.epoch))
                return
        conn.send(MOSDOpReply(m.tid, 0, data=_pack(results),
                              epoch=self.osdmap.epoch))

    def _op_multi_write(self, conn, m, pgid: PgId, up: list) -> None:
        key = (pgid, m.oid)

        def thunk(conn=conn, m=m, pgid=pgid, key=key):
            self._exec_multi_write(conn, m, pgid, key)

        self._obj_lock(key, thunk)

    def _exec_multi_write(self, conn, m, pgid: PgId, key: tuple) -> None:
        """Runs under the object write lock.  Every reply path must
        either hand the lock to a _PendingWrite (released on final ack)
        or release it here."""
        steps = _unpack(m.data)
        cid = CollectionId(pgid.pool, pgid.seed)
        is_ec = self._is_ec(pgid)
        obj = self._local_obj(pgid, m.oid)
        if is_ec and any(st.get("op") in ("write_full", "write",
                                          "append", "truncate", "zero",
                                          "remove")
                         for st in steps):
            # stripe data mutations belong to the EC write pipeline
            conn.send(MOSDOpReply(m.tid, EINVAL,
                                  epoch=self.osdmap.epoch))
            self._obj_unlock(key)
            return
        present = self.store.exists(cid, obj)
        attrs = self.store.getattrs(cid, obj) if present else {}
        was_whiteout = present and bool(attrs.get("wh"))
        # a whiteout'd head is logically absent (snapshot tombstone)
        exists = present and not was_whiteout
        cur_version = int(attrs.get("v", 0))
        # body loads lazily: omap/xattr-only batches on a large object
        # must not pay a full read
        data = b""
        loaded = not exists

        def cur() -> bytes:
            nonlocal data, loaded
            if not loaded:
                data = self._read_obj_raw(cid, obj)[0]
                loaded = True
            return data

        def fail(code: int) -> None:
            conn.send(MOSDOpReply(m.tid, code, epoch=self.osdmap.epoch))
            self._obj_unlock(key)

        # simulate, folding mutations into the final-state effects record
        eff = {"remove": False, "create": not exists, "data": None,
               "set": {}, "rm": [], "xset": {}, "xrm": []}
        touched = False
        for st in steps:
            op = st.get("op")
            if eff["remove"]:
                # a final-state effects record cannot express
                # remove-then-mutate (stale omap would survive on
                # replicas): remove must be the batch's last step
                return fail(EINVAL)
            if op == "assert_exists":
                if not exists:
                    return fail(ENOENT)
            elif op == "assert_version":
                if cur_version != int(st.get("ver", -1)):
                    return fail(ERANGE)
            elif op == "create":
                if exists and st.get("excl"):
                    return fail(EEXIST)
                exists, touched = True, True
            elif op == "write_full":
                data, loaded = bytes(st["data"]), True
                exists = touched = True
                eff["data"] = data
            elif op == "write":
                off = int(st.get("off", 0))
                buf = bytes(st["data"])
                base = cur()
                if off > len(base):
                    base = base + b"\x00" * (off - len(base))
                data = base[:off] + buf + base[off + len(buf):]
                exists = touched = True
                eff["data"] = data
            elif op == "append":
                data = cur() + bytes(st["data"])
                exists = touched = True
                eff["data"] = data
            elif op == "truncate":
                size = int(st.get("size", 0))
                base = cur()
                data = (base[:size] if size <= len(base)
                        else base + b"\x00" * (size - len(base)))
                exists = touched = True
                eff["data"] = data
            elif op == "zero":
                off, ln = int(st.get("off", 0)), int(st.get("len", 0))
                base = cur()
                if off < len(base) and ln > 0:
                    end = min(off + ln, len(base))
                    data = base[:off] + b"\x00" * (end - off) + base[end:]
                    eff["data"] = data
                exists = touched = True
            elif op == "remove":
                if not exists:
                    return fail(ENOENT)
                exists, touched = False, True
                data, loaded = b"", True
                eff.update(remove=True, create=False, data=None,
                           set={}, rm=[], xset={}, xrm=[])
            elif op == "setxattr":
                eff["xset"][str(st["name"])] = bytes(st["value"])
                exists = touched = True
            elif op == "rmxattr":
                name = str(st["name"])
                eff["xset"].pop(name, None)
                eff["xrm"].append(name)
                touched = True
            elif op == "omap_set":
                eff["set"].update({str(k): bytes(v)
                                   for k, v in st["kv"].items()})
                eff["rm"] = [k for k in eff["rm"] if k not in st["kv"]]
                exists = touched = True
            elif op == "omap_rm":
                for k in st["keys"]:
                    eff["set"].pop(str(k), None)
                    eff["rm"].append(str(k))
                touched = True
            else:
                return fail(EINVAL)
        if eff["remove"]:
            eff["create"] = False
        if not touched:  # pure-guard batch: nothing to write or replicate
            conn.send(MOSDOpReply(m.tid, 0, version=cur_version,
                                  epoch=self.osdmap.epoch))
            self._obj_unlock(key)
            return

        # snapshots: the batch's net effect is one head write — stage
        # clone-on-write exactly like _rep_write/_rep_remove do
        # (make_writeable; the rider replicates the staged clone)
        from types import SimpleNamespace
        if eff["remove"]:
            shim_op = "remove"
        elif eff["data"] is not None:
            shim_op = "write_full"
        else:
            shim_op = "attr"  # omap/xattr only: clone, but no overlap shrink
        shim = SimpleNamespace(
            oid=m.oid, op=shim_op, offset=0,
            data=eff["data"] if eff["data"] is not None else b"",
            snap_seq=getattr(m, "snap_seq", 0),
            snaps=list(getattr(m, "snaps", []) or []))
        snap_tx, rider = self._snap_prepare(pgid, shim)
        if eff["remove"]:
            # a head with clones (or one staged this instant) must
            # whiteout, not vanish — its SnapSet serves snapshot reads
            ss = self._load_ss(cid, m.oid) or {}
            if ss.get("clones") or (rider is not None
                                    and rider.get("clone", -1) >= 0):
                eff["remove"] = False
                eff["whiteout"] = True
        if was_whiteout and not eff["remove"] and not eff.get("whiteout"):
            eff["clear_wh"] = True  # resurrection clears the tombstone

        version = self._next_version(pgid)
        self._apply_multi_effects(pgid, m.oid, eff, version,
                                  pre_tx=snap_tx,
                                  shard=self._my_shard(pgid) if is_ec
                                  else -1)
        up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
        fanout = self._meta_fanout(pgid, up)
        if not fanout:
            conn.send(MOSDOpReply(m.tid, 0, version=version,
                                  epoch=self.osdmap.epoch))
            self._obj_unlock(key)
            return
        tid = next(self._tids)
        from .daemon import _PendingWrite
        pw = _PendingWrite(m.client, m.tid, len(fanout), version)
        pw.span = getattr(m, '_span', None)
        pw.lock_key = key
        self._pending_writes[tid] = pw
        payload = _pack(eff)
        sub_attrs = {"_snap": rider} if rider is not None else {}
        for peer, shard in fanout:
            self.messenger.send_message(
                f"osd.{peer}",
                MSubWrite(tid, pgid, m.oid, shard, version,
                          "multi_effects", payload,
                          attrs=dict(sub_attrs),
                          epoch=self._entry_epoch(),
                          tenant=m.tenant))

    def _apply_multi_effects(self, pgid: PgId, oid: str, eff: dict,
                             version: int, pre_tx=None,
                             shard: int = -1) -> None:
        """Apply one compound-write effects record in ONE transaction
        (primary and replicas run the identical code; pre_tx carries the
        staged clone-on-write from _snap_prepare / the replica rider)."""
        from .pglog import LogEntry
        if eff.get("whiteout"):
            self._apply_whiteout(pgid, oid, version, pre_tx=pre_tx)
            return
        if eff.get("remove"):
            self._apply_remove(pgid, oid, shard, version)
            return
        cid = CollectionId(pgid.pool, pgid.seed)
        obj = ObjectId(oid, shard=shard)
        tx = pre_tx if pre_tx is not None else Transaction()
        exists = self.store.exists(cid, obj)
        if not exists:
            tx.touch(cid, obj)
            if not eff.get("create") and eff.get("data") is None:
                # replica lagging a previous create: the touch above
                # materializes it, deltas below still apply cleanly
                pass
        if eff.get("data") is not None:
            tx.truncate(cid, obj, 0)
            tx.write(cid, obj, 0, bytes(eff["data"]))
            tx.rmattr(cid, obj, "cz")
            tx.rmattr(cid, obj, "crl")
            data = bytes(eff["data"])
        else:
            data = None  # content untouched: existing d/len stay valid
        if eff.get("set"):
            tx.omap_setkeys(cid, obj, {str(k): bytes(v)
                                       for k, v in eff["set"].items()})
        if eff.get("rm"):
            have = set(self.store.omap_get(cid, obj)) if exists else set()
            tx.omap_rmkeys(cid, obj,
                           [k for k in eff["rm"] if k in have])
        if data is not None:
            newattrs = {"v": version, "d": _crc32c(data),
                        "len": len(data)}
        elif exists:
            newattrs = {"v": version}
        else:  # fresh object with no data step (e.g. bare create)
            newattrs = {"v": version, "d": _crc32c(b""), "len": 0}
        if eff.get("clear_wh"):
            newattrs["wh"] = 0
        for name, value in (eff.get("xset") or {}).items():
            newattrs[_XATTR_PREFIX + str(name)] = bytes(value)
        tx.setattrs(cid, obj, newattrs)
        if eff.get("xrm") and exists:
            have = self.store.getattrs(cid, obj)
            for name in eff["xrm"]:
                k = _XATTR_PREFIX + str(name)
                if k in have and k not in newattrs:
                    tx.rmattr(cid, obj, k)
        self._log_apply(tx, pgid, LogEntry(version, "multi", oid, shard,
                                           prev_version=-1))
        self.store.queue_transaction(tx)
