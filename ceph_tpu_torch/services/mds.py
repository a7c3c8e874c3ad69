"""mds-lite: journaled metadata server with capability leases.

The capability slice of the reference MDS core (src/mds/):

- **MDLog / EMetaBlob** (MDLog.cc, journal/EMetaBlob.cc): every
  metadata mutation is appended to a durable RADOS-backed journal
  BEFORE it touches the dentry tables; a crash between journal append
  and apply replays on the next start (Journaler replay role), so the
  namespace can never lose an acked mutation.  Applied entries are
  expired and trimmed in segments (LogSegment trim role).
- **Capabilities** (Capability.h, Locker.cc): a client opens a file and
  is granted caps — "r" lets it cache reads, "w" lets it buffer
  writes.  Conflicting opens REVOKE outstanding caps first: the holder
  flushes its buffered state synchronously before the new grant is
  issued (the cap revoke round-trip).  Grants carry a lease TTL; an
  expired lease is reclaimable without a round-trip (session-death
  safety).

Multi-active: `MdsCluster` runs N ranks over the same pool with
DIRECTORY-SUBTREE authority partitioning (MDCache subtree map +
Migrator roles): every op routes to the rank owning the dentry's
parent directory (longest-prefix match over a durable subtree map),
`export_subtree` hands a subtree to another rank (caps on the moved
subtree are revoked; the map update is durable), and `balance()`
re-exports the hottest subtree off the busiest rank (MDBalancer).
Because dentry tables live in shared RADOS omap objects, migration is
an authority transfer — no cache or journal copying, the part of the
reference's Migrator that exists only because its metadata is cached
per-MDS.  Cross-rank renames take both ranks' locks in rank order and
journal in both (apply is idempotent, so dual-journal replay is safe).

The daemons are in-process objects shared by FsClient mounts (the
fs.py data path stays client->RADOS, exactly the reference's split:
metadata through the MDS, file bytes never touch it).  MdsCluster
exposes the same surface as MdsDaemon, so FsClient mounts either.
"""

from __future__ import annotations

import posixpath
import threading
import time
import uuid

from ..client.rados import RadosClient, RadosError
from ..msg.wire import pack_value, unpack_value

_DIR_OID = "fs_dir.{path}"
_SNAPDIR_OID = "fs_snapdir.{snapid:x}.{path}"
_SNAPTABLE_OID = "fs_snaptable"
_JOURNAL_OID = "mds_journal.{rank}"
_APPLIED_KEY = "_applied"          # journal omap: high-water of applied seqs
_TRIM_EVERY = 64                   # expire applied entries in batches


class FsError(Exception):
    def __init__(self, code: int, what: str):
        super().__init__(what)
        self.code = code


def _norm(path: str) -> str:
    return posixpath.normpath("/" + path.strip().lstrip("/"))


class _Session:
    def __init__(self, client_id: str, revoke_cb, vt=None,
                 ticket_provider=None):
        self.client_id = client_id
        self.revoke_cb = revoke_cb   # revoke_cb(path) -> None (flush+drop)
        self.vt = vt                 # VerifiedTicket (auth clusters)
        # () -> fresh ticket blob; lets a long-lived mount re-present a
        # renewed mds ticket instead of bricking at TTL expiry
        self.ticket_provider = ticket_provider


class MdsDaemon:
    LEASE_TTL = 30.0  # seconds; mirrors mds_session_cap lease behavior

    def __init__(self, client: RadosClient, pool: str, rank: int = 0,
                 auth=None, standby: bool = False):
        self.client = client
        self.pool = pool
        self.rank = rank
        # cephx gate (Server::handle_client_session + MDSAuthCaps
        # enforcement role): sessions must present an "mds" service
        # ticket; namespace mutations and file opens check the
        # session's caps with path restrictions.  The data plane is
        # additionally bound by the entity's pool caps at the OSDs.
        self.auth = auth
        # per-top-level-prefix op accounting (MDBalancer pop counters)
        self.dir_ops: dict[str, int] = {}
        self._lock = threading.RLock()
        self._sessions: dict[str, _Session] = {}
        # path -> {client_id: (caps "r"/"rw", expires_at)}
        self._caps: dict[str, dict[str, tuple[str, float]]] = {}
        self._journal_oid = _JOURNAL_OID.format(rank=rank)
        self._seq = 0
        self._applied = 0
        self._ensure_root()
        if not standby:
            self.replay()
        # standby-replay construction defers the journal apply to
        # promotion: a hot spare must never APPLY while the active
        # serves (re-applying an old entry behind the active's newer
        # write would clobber shared dentry tables) — it only keeps
        # its journal view warm (StandbyReplayMds below).

    # ------------------------------------------------------------- journal
    def _ensure_root(self) -> None:
        try:
            self.client.omap_get(self.pool, _DIR_OID.format(path="/"))
        except RadosError:
            self.client.omap_set(self.pool, _DIR_OID.format(path="/"), {})

    def _journal_entries(self) -> dict:
        try:
            return self.client.omap_get(self.pool, self._journal_oid)
        except RadosError:
            return {}

    def replay(self) -> int:
        """Re-apply journal entries past the applied high-water (MDLog
        replay on MDS start).  Apply is idempotent, so a crash anywhere
        in journal->apply->mark is safe.  Returns entries replayed."""
        raw = self._journal_entries()
        self._applied = int(raw.get(_APPLIED_KEY, b"0") or 0)
        seqs = sorted(int(k, 16) for k in raw if k != _APPLIED_KEY)
        self._seq = max(seqs) if seqs else self._applied
        replayed = 0
        for seq in seqs:
            if seq <= self._applied:
                continue
            self._apply(unpack_value(raw[f"{seq:016x}"]))
            self._mark_applied(seq)
            replayed += 1
        return replayed

    def _account(self, path: str) -> None:
        top = "/" + _norm(path).split("/", 2)[1] if _norm(path) != "/" \
            else "/"
        self.dir_ops[top] = self.dir_ops.get(top, 0) + 1

    def submit(self, op: dict) -> None:
        """Journal, then apply, then advance the applied mark — the
        EMetaBlob submit_entry/flush contract (durability before ack)."""
        self._account(op.get("path") or op.get("src") or "/")
        with self._lock:
            self._seq += 1
            seq = self._seq
            self.client.omap_set(self.pool, self._journal_oid,
                                 {f"{seq:016x}": pack_value(op)})
            self._apply(op)
            self._mark_applied(seq)

    def _mark_applied(self, seq: int) -> None:
        self._applied = max(self._applied, seq)
        self.client.omap_set(self.pool, self._journal_oid,
                             {_APPLIED_KEY: str(self._applied).encode()})
        if seq % _TRIM_EVERY == 0:
            self._trim()

    def _trim(self) -> None:
        """Expire applied entries (LogSegment trim): the journal stays
        bounded; only the unapplied tail matters for recovery."""
        raw = self._journal_entries()
        dead = [k for k in raw
                if k != _APPLIED_KEY and int(k, 16) <= self._applied]
        if dead:
            self.client.omap_rm(self.pool, self._journal_oid, dead)

    # -------------------------------------------------- dentry-table apply
    # All mutations are expressed as idempotent journal ops: re-applying
    # any prefix/suffix after a crash converges to the same state.
    def _dir_oid(self, path: str) -> str:
        return _DIR_OID.format(path=_norm(path))

    def _raw_entries(self, dirpath: str) -> dict | None:
        try:
            return self.client.omap_get(self.pool, self._dir_oid(dirpath))
        except RadosError:
            return None

    def _apply(self, op: dict) -> None:
        kind = op["op"]
        if kind == "mkdir":
            path = op["path"]
            self.client.omap_set(self.pool, self._dir_oid(path), {})
            self._apply_set_entry(path, op["ent"])
        elif kind == "set_entry":
            self._apply_set_entry(op["path"], op["ent"])
        elif kind == "rm_entry":
            parent, name = posixpath.split(_norm(op["path"]))
            self.client.omap_rm(self.pool, self._dir_oid(parent), [name])
        elif kind == "rmdir":
            path = op["path"]
            try:
                self.client.remove(self.pool, self._dir_oid(path))
            except RadosError:
                pass  # replay after the remove landed
            parent, name = posixpath.split(_norm(path))
            self.client.omap_rm(self.pool, self._dir_oid(parent), [name])
        elif kind == "rename":
            self._apply_rename(op["src"], op["dst"], op["ent"])
        elif kind == "mksnap":
            self._apply_mksnap(op["path"], op["name"], op["snapid"])
        elif kind == "rmsnap":
            self._apply_rmsnap(op["path"], op["name"], op["snapid"])
        elif kind == "rollback_snap":
            self._apply_rollback_snap(op["path"], op["snapid"])
        else:  # pragma: no cover - forward-compat guard
            raise FsError(-22, f"unknown journal op {kind!r}")

    # ------------------------------------------------- snapshots (realm)
    # The SnapServer + SnapRealm capability (src/mds/SnapServer.h:32,
    # src/mds/SnapRealm.h) re-shaped: snapids come from the mon's
    # self-managed pool snaps (data-object COW happens in the OSDs via
    # the SnapContext clients attach), the snap TABLE is a journaled
    # omap object shared by every rank, and the directory-tree METADATA
    # at snap time is frozen by copying the subtree's dentry omaps to
    # per-snapid objects.  Simplification vs the reference: the write
    # SnapContext is filesystem-global, not per-realm — a post-snapshot
    # write anywhere clones the touched objects (extra clones, same
    # correctness; trim removes them).
    def _snapdir_oid(self, snapid: int, path: str) -> str:
        return _SNAPDIR_OID.format(snapid=snapid, path=_norm(path))

    def snap_table(self) -> dict[tuple[str, str], int]:
        """{(dirpath, snapname): snapid} — the live snap table."""
        try:
            omap = self.client.omap_get(self.pool, _SNAPTABLE_OID)
        except RadosError:
            return {}
        out = {}
        for k, v in omap.items():
            rec = unpack_value(bytes(v))
            out[(rec["path"], rec["name"])] = int(rec["snapid"])
        return out

    def snap_context(self) -> tuple[int, list]:
        """(seq, snapids newest-first) for the data-pool write
        SnapContext — what clients attach so the OSDs clone-on-write
        (the snaprealm get_snap_context role).  Cached (the reference
        caches it with client caps): the per-WRITE cost must not be a
        snap-table omap scan; mksnap/rmsnap invalidate."""
        cached = getattr(self, "_snapc_cache", None)
        if cached is not None:
            return cached
        ids = sorted(self.snap_table().values(), reverse=True)
        self._snapc_cache = (ids[0] if ids else 0, ids)
        return self._snapc_cache

    def _snapc_invalidate(self) -> None:
        self._snapc_cache = None

    def snaps_of(self, dirpath: str) -> dict[str, int]:
        dirpath = _norm(dirpath)
        return {name: sid for (p, name), sid in
                self.snap_table().items() if p == dirpath}

    def snap_covering(self, path: str, name: str) -> tuple[str, int]:
        """Closest ancestor dir with a snapshot `name` (snaprealm
        resolution: a realm covers its whole subtree)."""
        path = _norm(path)
        table = self.snap_table()
        probe = path
        while True:
            sid = table.get((probe, name))
            if sid is not None:
                return probe, sid
            if probe == "/":
                raise FsError(-2, f"no snapshot {name!r} over {path!r}")
            probe = posixpath.split(probe)[0]

    def snap_create(self, dirpath: str, name: str,
                    client_id=None) -> int:
        self._check(client_id, "w", dirpath)
        dirpath = _norm(dirpath)
        if self.lookup(dirpath)["type"] != "dir":
            raise FsError(-20, f"{dirpath!r} is not a directory")
        if name in self.snaps_of(dirpath):
            raise FsError(-17, f"snapshot {name!r} exists")
        # flush every client's buffered data under the realm first: the
        # pool snapshot freezes what the OSDs HOLD, not client caches
        self._revoke_subtree(dirpath, exclude=None)
        self.invalidate(dirpath)
        snapid = self.client.selfmanaged_snap_create(self.pool)
        self.submit({"op": "mksnap", "path": dirpath, "name": name,
                     "snapid": snapid})
        return snapid

    def _apply_mksnap(self, dirpath, name, snapid) -> None:
        self._snapc_invalidate()
        self._freeze_tree(dirpath, snapid)
        self.client.omap_set(self.pool, _SNAPTABLE_OID, {
            f"{snapid:016x}": pack_value({"path": _norm(dirpath),
                                          "name": name,
                                          "snapid": snapid})})

    def _freeze_tree(self, dirpath: str, snapid: int) -> None:
        """Copy the subtree's dentry omaps to the snapshot objects
        (idempotent; replay-safe)."""
        ents = self._raw_entries(dirpath)
        if ents is None:
            return
        self.client.omap_set(self.pool,
                             self._snapdir_oid(snapid, dirpath),
                             dict(ents) or {"_": b""})
        for nm, raw in ents.items():
            if unpack_value(raw)["type"] == "dir":
                self._freeze_tree(posixpath.join(_norm(dirpath), nm),
                                  snapid)

    def snap_remove(self, dirpath: str, name: str,
                    client_id=None) -> None:
        self._check(client_id, "w", dirpath)
        dirpath = _norm(dirpath)
        sid = self.snaps_of(dirpath).get(name)
        if sid is None:
            raise FsError(-2, f"no snapshot {name!r} on {dirpath!r}")
        self.submit({"op": "rmsnap", "path": dirpath, "name": name,
                     "snapid": sid})
        # retire the pool snap: OSDs trim the data clones
        self.client.selfmanaged_snap_remove(self.pool, sid)

    def _apply_rmsnap(self, dirpath, name, snapid) -> None:
        self._snapc_invalidate()
        self._thaw_tree(dirpath, snapid)
        self.client.omap_rm(self.pool, _SNAPTABLE_OID,
                            [f"{snapid:016x}"])

    def _thaw_tree(self, dirpath: str, snapid: int) -> None:
        ents = self.snap_entries_raw(snapid, dirpath)
        for nm, raw in (ents or {}).items():
            if nm != "_" and unpack_value(raw)["type"] == "dir":
                self._thaw_tree(posixpath.join(_norm(dirpath), nm),
                                snapid)
        try:
            self.client.remove(self.pool,
                               self._snapdir_oid(snapid, dirpath))
        except RadosError:
            pass

    # -- snapshot READ surface (the .snap view) -------------------------
    def snap_entries_raw(self, snapid: int, dirpath: str) -> dict | None:
        try:
            omap = self.client.omap_get(
                self.pool, self._snapdir_oid(snapid, dirpath))
        except RadosError:
            return None
        omap.pop("_", None)
        return omap

    def snap_entries(self, snapid: int, dirpath: str) -> dict:
        raw = self.snap_entries_raw(snapid, dirpath)
        if raw is None:
            raise FsError(-2, f"no such directory in snapshot")
        return {k: unpack_value(v) for k, v in raw.items()}

    def snap_lookup(self, snapid: int, snap_root: str,
                    path: str) -> dict:
        path = _norm(path)
        if path == _norm(snap_root):
            return {"type": "dir"}
        parent, nm = posixpath.split(path)
        ent = self.snap_entries(snapid, parent).get(nm)
        if ent is None:
            raise FsError(-2, f"no entry {path!r} in snapshot")
        return ent

    # -- rollback --------------------------------------------------------
    def snap_rollback(self, dirpath: str, name: str,
                      client_id=None) -> None:
        self._check(client_id, "w", dirpath)
        """Restore the subtree (metadata + file data) to its state at
        the snapshot; survives failover because the op is journaled and
        apply is idempotent."""
        dirpath = _norm(dirpath)
        sid = self.snaps_of(dirpath).get(name)
        if sid is None:
            raise FsError(-2, f"no snapshot {name!r} on {dirpath!r}")
        self._revoke_subtree(dirpath, exclude=None)
        self.invalidate(dirpath)
        self.submit({"op": "rollback_snap", "path": dirpath,
                     "snapid": sid})

    def _apply_rollback_snap(self, dirpath: str, snapid: int) -> None:
        self._rollback_tree(dirpath, snapid)

    def _rollback_tree(self, dirpath: str, snapid: int) -> None:
        dirpath = _norm(dirpath)
        frozen = self.snap_entries_raw(snapid, dirpath)
        if frozen is None:
            return
        live = self._raw_entries(dirpath) or {}
        # drop entries born after the snapshot
        dead = [nm for nm in live if nm not in frozen]
        if dead:
            for nm in dead:
                ent = unpack_value(live[nm])
                if ent["type"] == "dir":
                    self._drop_dir_tree(posixpath.join(dirpath, nm))
            self.client.omap_rm(self.pool, self._dir_oid(dirpath), dead)
        # restore the frozen entries (sizes/inos) + recurse; file DATA
        # rolls back via the rados per-object snap_rollback op
        self.client.omap_set(self.pool, self._dir_oid(dirpath),
                             dict(frozen))
        for nm, raw in frozen.items():
            ent = unpack_value(raw)
            sub = posixpath.join(dirpath, nm)
            if ent["type"] == "dir":
                try:
                    self.client.omap_get(self.pool, self._dir_oid(sub))
                except RadosError:
                    self.client.omap_set(self.pool,
                                         self._dir_oid(sub), {})
                self._rollback_tree(sub, snapid)
        # file DATA rolls back client-side (FsClient.snap_rollback):
        # the layout lives with the mount, and the rados per-piece
        # snap_rollback op is idempotent — a crashed roller re-runs

    def _apply_set_entry(self, path: str, ent: dict) -> None:
        parent, name = posixpath.split(_norm(path))
        self.client.omap_set(self.pool, self._dir_oid(parent),
                             {name: pack_value(ent)})

    def _apply_rename(self, src: str, dst: str, ent: dict) -> None:
        if ent["type"] == "dir":
            self._copy_dir_tree(src, dst)
        self._apply_set_entry(dst, ent)
        parent, name = posixpath.split(_norm(src))
        self.client.omap_rm(self.pool, self._dir_oid(parent), [name])
        if ent["type"] == "dir":
            self._drop_dir_tree(src)

    def _copy_dir_tree(self, src: str, dst: str) -> None:
        ents = self._raw_entries(src)
        if ents is None:
            return  # replay: source tree already moved
        self.client.omap_set(self.pool, self._dir_oid(dst), dict(ents))
        for name, raw in ents.items():
            if unpack_value(raw)["type"] == "dir":
                self._copy_dir_tree(posixpath.join(src, name),
                                    posixpath.join(dst, name))

    def _drop_dir_tree(self, src: str) -> None:
        ents = self._raw_entries(src)
        for name, raw in (ents or {}).items():
            if unpack_value(raw)["type"] == "dir":
                self._drop_dir_tree(posixpath.join(src, name))
        try:
            self.client.remove(self.pool, self._dir_oid(src))
        except RadosError:
            pass

    # --------------------------------------------------- metadata service
    def entries(self, dirpath: str) -> dict:
        raw = self._raw_entries(dirpath)
        if raw is None:
            raise FsError(-2, f"no such directory {dirpath!r}")
        return {k: unpack_value(v) for k, v in raw.items()}

    def lookup(self, path: str) -> dict:
        path = _norm(path)
        if path == "/":
            return {"type": "dir"}
        parent, name = posixpath.split(path)
        ent = self.entries(parent).get(name)
        if ent is None:
            raise FsError(-2, f"no such entry {path!r}")
        return ent

    def mkdir(self, path: str, client_id=None) -> None:
        self._check(client_id, "w", path)
        with self._lock:
            path = _norm(path)
            parent, name = posixpath.split(path)
            if name in self.entries(parent):
                raise FsError(-17, f"{path!r} exists")
            self.submit({"op": "mkdir", "path": path,
                         "ent": {"type": "dir", "mtime": time.time()}})

    def rmdir(self, path: str, client_id=None) -> None:
        self._check(client_id, "w", path)
        with self._lock:
            path = _norm(path)
            if path == "/":
                raise FsError(-22, "cannot remove the root")
            ent = self.lookup(path)
            if ent["type"] != "dir":
                raise FsError(-20, f"{path!r} is not a directory")
            if self.entries(path):
                raise FsError(-39, f"{path!r} not empty")
            self.submit({"op": "rmdir", "path": path})

    def create(self, path: str, client_id=None) -> dict:
        self._check(client_id, "w", path)
        with self._lock:
            path = _norm(path)
            parent, name = posixpath.split(path)
            if name in self.entries(parent):
                raise FsError(-17, f"{path!r} exists")
            ent = {"type": "file", "size": 0, "ino": uuid.uuid4().hex,
                   "mtime": time.time()}
            self.submit({"op": "set_entry", "path": path, "ent": ent})
            return ent

    def set_entry(self, path: str, ent: dict, client_id=None) -> None:
        self._check(client_id, "w", path)
        with self._lock:
            self.submit({"op": "set_entry", "path": _norm(path),
                         "ent": ent})

    def rm_entry(self, path: str, client_id=None) -> None:
        self._check(client_id, "w", path)
        with self._lock:
            self.submit({"op": "rm_entry", "path": _norm(path)})

    def rename(self, src: str, dst: str, client_id=None) -> None:
        self._check(client_id, "w", src)
        self._check(client_id, "w", dst)
        with self._lock:
            src, dst = _norm(src), _norm(dst)
            if dst == src or dst.startswith(src + "/"):
                raise FsError(-22,
                              f"cannot move {src!r} into itself "
                              f"({dst!r})")
            ent = self.lookup(src)
            parent, name = posixpath.split(dst)
            if name in self.entries(parent):
                raise FsError(-17, f"{dst!r} exists")
            self._revoke_subtree(src, exclude=None)
            self.submit({"op": "rename", "src": src, "dst": dst,
                         "ent": ent})

    # ------------------------------------------------------- capabilities
    def _check(self, client_id, need: str, path: str) -> None:
        """Session caps gate (MDSAuthCaps::is_capable role): verify the
        caller's session ticket is live and its caps cover `need` at
        `path`.  An expired ticket renews through the session's
        provider (the client re-presents a fresh mon-issued ticket)
        before failing.  No-op on auth-free clusters."""
        if self.auth is None:
            return
        sess = self._sessions.get(client_id)
        if sess is None or sess.vt is None:
            raise FsError(-13, f"no authenticated session {client_id!r}")
        if time.time() > sess.vt.valid_until:
            vt = (self.auth.verify(sess.ticket_provider())
                  if sess.ticket_provider is not None else None)
            if vt is None:
                raise FsError(-13,
                              f"mds ticket expired for {client_id!r}")
            sess.vt = vt
        if not sess.vt.caps.allows(need, path=_norm(path)):
            raise FsError(-13, f"{sess.vt.entity}: mds caps deny "
                               f"{need!r} at {path!r}")

    def check_caps(self, client_id, need: str, path: str) -> None:
        """Public pre-flight gate: callers that mutate DATA before
        metadata (unlink, write) must check caps first, or a denied
        caller destroys file contents the path restriction protects."""
        self._check(client_id, need, path)

    def register_session(self, client_id: str, revoke_cb,
                         ticket: bytes = b"",
                         ticket_provider=None) -> None:
        vt = None
        if self.auth is not None:
            vt = self.auth.verify(ticket)
            if vt is None:
                raise FsError(-13, "mount refused: no/invalid/expired "
                                   "mds ticket")
        with self._lock:
            self._sessions[client_id] = _Session(client_id, revoke_cb,
                                                 vt, ticket_provider)

    def unregister_session(self, client_id: str) -> None:
        with self._lock:
            self._sessions.pop(client_id, None)
            for holders in self._caps.values():
                holders.pop(client_id, None)

    def open(self, client_id: str, path: str, mode: str) -> dict:
        """Grant caps on a file (Locker issue path): mode "r" wants
        cached reads, "w"/"rw" buffered writes.  Conflicting holders
        are revoked (synchronously flushed) first.  Returns the entry
        plus the granted caps + lease expiry."""
        path = _norm(path)
        want_w = "w" in mode
        self._check(client_id, "rw" if want_w else "r", path)
        with self._lock:
            ent = self.lookup(path)
            if ent["type"] != "file":
                raise FsError(-21, f"{path!r} is a directory")
            now = time.time()
            holders = self._caps.setdefault(path, {})
            # expired leases are reclaimable without a round-trip
            for cid, (_c, exp) in list(holders.items()):
                if exp < now or cid not in self._sessions:
                    del holders[cid]
            revoke = []
            for cid, (caps, _exp) in holders.items():
                if cid == client_id:
                    continue
                if want_w or "w" in caps:
                    # multiple readers share; any writer is exclusive
                    revoke.append(cid)
            for cid in revoke:
                self._revoke_one(path, cid)
            ent = self.lookup(path)  # revokes may have flushed size
            caps = "rw" if want_w else "r"
            expires = now + self.LEASE_TTL
            holders[client_id] = (caps, expires)
            return {"ent": ent, "caps": caps, "expires": expires}

    def release(self, client_id: str, path: str) -> None:
        with self._lock:
            holders = self._caps.get(_norm(path), {})
            holders.pop(client_id, None)

    def _revoke_one(self, path: str, client_id: str) -> None:
        """Call the holder's revoke callback (it flushes buffered writes
        through the normal data+set_entry path), then drop the cap.
        RLock: the flush may re-enter set_entry on this thread."""
        sess = self._sessions.get(client_id)
        if sess is not None:
            try:
                sess.revoke_cb(path)
            except Exception:  # noqa: BLE001 - a dead client must not wedge opens
                pass
        self._caps.get(path, {}).pop(client_id, None)

    def _revoke_subtree(self, path: str, exclude: str | None) -> None:
        """Renames invalidate cached paths under the moved subtree."""
        for cap_path in list(self._caps):
            if cap_path == path or cap_path.startswith(path + "/"):
                for cid in list(self._caps[cap_path]):
                    if cid != exclude:
                        self._revoke_one(cap_path, cid)

    def invalidate(self, path: str, exclude: str | None = None) -> None:
        """Revoke every cap on `path` (used by cap-less mutation APIs —
        write_file/truncate/unlink — so 'r' holders cannot keep serving
        pre-mutation cache)."""
        path = _norm(path)
        with self._lock:
            for cid in list(self._caps.get(path, {})):
                if cid != exclude:
                    self._revoke_one(path, cid)

    def caps_held(self, path: str) -> dict:
        with self._lock:
            return {cid: caps for cid, (caps, _e)
                    in self._caps.get(_norm(path), {}).items()}


_SUBTREE_OID = "mds_subtreemap"


class _OrderedLocks:
    """Acquire a fixed list of locks in order; release in reverse."""

    def __init__(self, locks):
        self._locks = locks

    def __enter__(self):
        for lk in self._locks:
            lk.acquire()
        return self

    def __exit__(self, *exc):
        for lk in reversed(self._locks):
            lk.release()


class StandbyReplayMds:
    """Hot spare for one rank (the mds standby-replay role,
    src/mds/MDSRank standby_replay): tails the active's journal
    continuously so promotion costs only the UNAPPLIED delta, not a
    cold construction + full journal scan.

    Shape difference from the reference, deliberate: our dentry tables
    live in shared RADOS omap (not per-MDS memory), so the standby must
    never APPLY while the active serves — re-applying an old entry
    behind the active's newer write would clobber shared state.  It
    polls the journal to keep its view (and the object's read path)
    warm and tracks the lag; promote() performs one replay() that
    applies exactly the entries the dead active journaled but never
    marked applied (the crash window), then the daemon serves."""

    def __init__(self, client: RadosClient, pool: str, rank: int = 0,
                 auth=None, poll: float = 0.05):
        self.mds = MdsDaemon(client, pool, rank=rank, auth=auth,
                             standby=True)
        self.lag = 0          # journaled-but-unapplied entries seen
        self._promoted = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._tail, args=(poll,),
            name=f"mds-standby-{rank}", daemon=True)
        self._thread.start()

    def _tail(self, poll: float) -> None:
        while not self._stop.wait(poll):
            try:
                raw = self.mds._journal_entries()
                applied = int(raw.get(_APPLIED_KEY, b"0") or 0)
                self.lag = sum(1 for k in raw
                               if k != _APPLIED_KEY
                               and int(k, 16) > applied)
            except Exception:  # noqa: BLE001 - cluster hiccup; re-poll
                pass

    def promote(self) -> tuple[MdsDaemon, int]:
        """Take over the rank: stop tailing, apply the unapplied tail
        (the dead active's crash window), return the live daemon and
        how many entries the takeover had to replay."""
        self._stop.set()
        self._thread.join(timeout=5)
        replayed = self.mds.replay()
        self._promoted = True
        return self.mds, replayed

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


class MdsCluster:
    """N active ranks with subtree authority partitioning (see module
    docstring).  Drop-in for MdsDaemon in FsClient."""

    def __init__(self, client: RadosClient, pool: str, n_ranks: int = 2,
                 auth=None):
        self.client = client
        self.pool = pool
        self.ranks = [MdsDaemon(client, pool, rank=i, auth=auth)
                      for i in range(n_ranks)]
        self._maplock = threading.RLock()
        try:
            raw = client.omap_get(pool, _SUBTREE_OID)
            self._map = {k: int(unpack_value(v)) for k, v in raw.items()}
        except RadosError:
            self._map = {}
        if "/" not in self._map:
            self._map["/"] = 0
            self._save_map()

    def _save_map(self) -> None:
        self.client.omap_set(self.pool, _SUBTREE_OID,
                             {k: pack_value(v)
                              for k, v in self._map.items()})

    # ------------------------------------------------------- authority map
    def authority_rank(self, dirpath: str) -> int:
        """Longest-prefix subtree match for a DIRECTORY path (the
        MDCache subtree map get_subtree_root walk)."""
        dirpath = _norm(dirpath)
        with self._maplock:
            best, best_len = 0, -1
            for root, rank in self._map.items():
                if (dirpath == root or root == "/"
                        or dirpath.startswith(root + "/")):
                    if len(root) > best_len:
                        best, best_len = rank, len(root)
            return best

    def _dir_auth(self, dirpath: str) -> MdsDaemon:
        return self.ranks[self.authority_rank(dirpath)]

    def _entry_auth(self, path: str) -> MdsDaemon:
        """Ops on a dentry route to its PARENT directory's authority
        (the dentry lives in the parent's table, as in the MDS)."""
        path = _norm(path)
        if path == "/":
            return self.ranks[0]
        return self._dir_auth(posixpath.split(path)[0])

    # ------------------------------------------- export/import + balancer
    def export_subtree(self, path: str, to_rank: int) -> None:
        """Hand authority for `path` (a directory) to another rank
        (Migrator export_dir): revoke caps under the subtree at the old
        authority, then commit the durable map update."""
        path = _norm(path)
        if not 0 <= to_rank < len(self.ranks):
            raise FsError(-22, f"no such rank {to_rank}")
        old = self._dir_auth(path)
        if old.lookup(path)["type"] != "dir":
            raise FsError(-20, f"{path!r} is not a directory")
        old._revoke_subtree(path, exclude=None)
        with self._maplock:
            self._map[path] = to_rank
            self._save_map()
        # the moved subtree's heat moves WITH it: stale counters on the
        # old rank would keep it looking busy forever
        top = "/" + path.split("/", 2)[1] if path != "/" else "/"
        heat = old.dir_ops.pop(top, 0)
        dst = self.ranks[to_rank]
        dst.dir_ops[top] = dst.dir_ops.get(top, 0) + heat

    def balance(self) -> dict | None:
        """One MDBalancer pass: move the hottest exportable subtree off
        the busiest rank to the least busy.  Returns the move made.
        Counters HALVE each pass (the balancer's decaying load
        average), so one historical burst cannot drive moves forever."""
        for r in self.ranks:
            for k in list(r.dir_ops):
                r.dir_ops[k] //= 2
                if not r.dir_ops[k]:
                    del r.dir_ops[k]
        loads = [sum(r.dir_ops.values()) for r in self.ranks]
        src = max(range(len(self.ranks)), key=lambda i: loads[i])
        dst = min(range(len(self.ranks)), key=lambda i: loads[i])
        if src == dst or loads[src] == 0:
            return None
        candidates = sorted(self.ranks[src].dir_ops.items(),
                            key=lambda kv: -kv[1])
        for top, _heat in candidates:
            if top != "/" and self.authority_rank(top) == src:
                try:
                    self.export_subtree(top, dst)
                except FsError:
                    continue
                return {"subtree": top, "from": src, "to": dst}
        return None

    # ------------------------------------------------ snapshot routing
    def snap_create(self, dirpath: str, name: str,
                    client_id=None) -> int:
        a = self._entry_auth(dirpath)
        for r in self.ranks:          # flush EVERY rank's caps under it
            r._revoke_subtree(_norm(dirpath), exclude=None)
        sid = a.snap_create(dirpath, name, client_id=client_id)
        for r in self.ranks:
            r._snapc_invalidate()
        return sid

    def snap_remove(self, dirpath: str, name: str,
                    client_id=None) -> None:
        self._entry_auth(dirpath).snap_remove(dirpath, name,
                                              client_id=client_id)
        for r in self.ranks:
            r._snapc_invalidate()

    def snap_rollback(self, dirpath: str, name: str,
                      client_id=None) -> None:
        a = self._entry_auth(dirpath)
        for r in self.ranks:
            r._revoke_subtree(_norm(dirpath), exclude=None)
        a.snap_rollback(dirpath, name, client_id=client_id)

    def snaps_of(self, dirpath: str):
        return self.ranks[0].snaps_of(dirpath)

    def snap_context(self):
        return self.ranks[0].snap_context()

    def snap_covering(self, path: str, name: str):
        return self.ranks[0].snap_covering(path, name)

    def snap_entries(self, snapid: int, dirpath: str):
        return self.ranks[0].snap_entries(snapid, dirpath)

    def snap_lookup(self, snapid: int, snap_root: str, path: str):
        return self.ranks[0].snap_lookup(snapid, snap_root, path)

    # --------------------------------------- MdsDaemon-compatible surface
    def register_session(self, client_id: str, revoke_cb,
                         ticket: bytes = b"",
                         ticket_provider=None) -> None:
        for r in self.ranks:
            r.register_session(client_id, revoke_cb, ticket,
                               ticket_provider)

    def check_caps(self, client_id, need: str, path: str) -> None:
        # sessions are registered on every rank: rank 0 sees the same
        # ticket state as the authoritative rank
        self.ranks[0].check_caps(client_id, need, path)

    def unregister_session(self, client_id: str) -> None:
        for r in self.ranks:
            r.unregister_session(client_id)

    def lookup(self, path: str) -> dict:
        return self._entry_auth(path).lookup(path)

    def entries(self, dirpath: str) -> dict:
        return self._dir_auth(dirpath).entries(dirpath)

    def mkdir(self, path: str, client_id=None) -> None:
        self._entry_auth(path).mkdir(path, client_id=client_id)

    def rmdir(self, path: str, client_id=None) -> None:
        self._entry_auth(path).rmdir(path, client_id=client_id)

    def create(self, path: str, client_id=None) -> dict:
        return self._entry_auth(path).create(path, client_id=client_id)

    def set_entry(self, path: str, ent: dict, client_id=None) -> None:
        self._entry_auth(path).set_entry(path, ent, client_id=client_id)

    def rm_entry(self, path: str, client_id=None) -> None:
        self._entry_auth(path).rm_entry(path, client_id=client_id)

    def open(self, client_id: str, path: str, mode: str) -> dict:
        auth = self._entry_auth(path)
        auth._account(path)
        return auth.open(client_id, path, mode)

    def release(self, client_id: str, path: str) -> None:
        self._entry_auth(path).release(client_id, path)

    def invalidate(self, path: str, exclude: str | None = None) -> None:
        self._entry_auth(path).invalidate(path, exclude)

    # FsFile io paths take mds._lock BEFORE handle._lock (fs.py lock
    # order).  For a cluster that must mean the RANK locks — in rank
    # order — so the global order (rank0 < rank1 < ... < handles) holds
    # for every path: rank.open takes (one rank, handle), flushes take
    # (all ranks in order, handle), cross-rank rename takes (two ranks
    # in order, handles via revoke).  No cycle exists.
    @property
    def _lock(self):
        return _OrderedLocks([r._lock for r in self.ranks])

    def _rename_subtree_map(self, src: str, dst: str) -> None:
        """Rewrite durable subtree-map keys at/under src to dst paths —
        a moved subtree keeps its authority assignment (Migrator keeps
        subtree bounds across rename); without this the moved tree
        silently reverts to rank 0 and a later mkdir at the old path
        inherits a stale rank."""
        with self._maplock:
            moved, old_keys = {}, []
            for root in list(self._map):
                if root == src or root.startswith(src + "/"):
                    moved[dst + root[len(src):]] = self._map.pop(root)
                    old_keys.append(root)
            if moved:
                self._map.update(moved)
                # write the merged map FIRST: a crash between the two
                # ops then leaves a transient stale old-path key, never
                # a lost assignment.  Remove exactly the keys we moved —
                # another live MdsCluster on the same pool may have
                # persisted keys this instance hasn't loaded, and they
                # must survive.
                self._save_map()
                self.client.omap_rm(self.pool, _SUBTREE_OID, old_keys)

    def rename(self, src: str, dst: str, client_id=None) -> None:
        """Renames take ALL rank locks in RANK ORDER (no ABBA between
        two renames) because the moved subtree may contain interior
        subtree roots whose caps live at ranks other than the two
        parents' — those must be revoked too, and the authority-map
        rewrite must be atomic with the namespace change (a lookup
        between them would route to a stale rank).  The op is journaled
        at both parents' ranks — apply is idempotent, so each rank's
        replay converges (the slave-request rename role)."""
        src, dst = _norm(src), _norm(dst)
        # sessions are registered on every rank; rank 0 carries the
        # same ticket state as the authoritative ranks
        self.ranks[0]._check(client_id, "w", src)
        self.ranks[0]._check(client_id, "w", dst)
        if dst == src or dst.startswith(src + "/"):
            raise FsError(-22,
                          f"cannot move {src!r} into itself ({dst!r})")

        def _involved():
            a, b = self._entry_auth(src), self._entry_auth(dst)
            # lock only the ranks the rename can touch: the two
            # parents' plus any rank holding authority INSIDE the moved
            # subtree (interior subtree roots — their cached caps must
            # be revoked too).  The common same-rank,
            # no-interior-subtree rename stays cheap instead of
            # barriering the whole cluster.
            with self._maplock:
                interior = {rank for root, rank in self._map.items()
                            if root == src
                            or root.startswith(src + "/")}
            return a, b, sorted({a.rank, b.rank} | interior)

        a, b, involved = _involved()
        while True:
            with _OrderedLocks([self.ranks[i]._lock
                                for i in involved]):
                # a concurrent export_subtree()/balance() may have moved
                # authority into the subtree between the snapshot and
                # the lock grab — that rank would be neither locked nor
                # revoked, and its buffered client data would survive
                # the rename.  Re-derive under the locks; widen+retry
                # until the set is stable — then hold _maplock through
                # the body so no export can move authority mid-rename
                # (export takes rank locks before _maplock, same order
                # as here, so this cannot deadlock).
                with self._maplock:
                    a, b, needed = _involved()
                    if needed == involved:
                        self._locked_rename(a, b, involved, src, dst)
                        return
                involved = needed

    def _locked_rename(self, a, b, involved, src: str, dst: str) -> None:
        """The rename body; caller holds every involved rank lock."""
        ent = a.lookup(src)
        parent, name = posixpath.split(dst)
        if name in b.entries(parent):
            raise FsError(-17, f"{dst!r} exists")
        for i in involved:
            self.ranks[i]._revoke_subtree(src, exclude=None)
        op = {"op": "rename", "src": src, "dst": dst, "ent": ent}
        a.submit(op)
        if b is not a:
            b.submit(op)  # idempotent re-apply; journals both
        self._rename_subtree_map(src, dst)
        # heat follows ONLY when the top-level entry itself moved
        # (export_subtree's pattern); renaming one deep entry must
        # not drain its old top-level dir's counters
        if src != "/" and src == "/" + src.split("/", 2)[1]:
            new_top = "/" + dst.split("/", 2)[1]
            if new_top != src:
                for i in involved:
                    r = self.ranks[i]
                    heat = r.dir_ops.pop(src, 0)
                    if heat:
                        r.dir_ops[new_top] = (
                            r.dir_ops.get(new_top, 0) + heat)
