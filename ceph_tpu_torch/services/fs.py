"""fs-lite: a POSIX-ish file layer over RADOS, metadata via mds-lite.

The capability slice of CephFS (src/mds + src/client/Client.cc):
metadata ops route through an MdsDaemon whose mutations are MDLog-
journaled (services/mds.py) — directories are omap-backed dentry
tables, and an MDS crash/restart replays the journal.  File DATA never
touches the MDS: it stripes over RADOS objects via the same
file_layout_t algebra the reference's Striper uses (Client ->
Objecter -> OSD).

Capabilities: `open()` returns an FsFile holding caps from the MDS —
"r" caches the file content client-side (cached reads, Fc/Fr role),
"w" buffers writes locally (Fb/Fw role) until flush/close/revoke.  A
conflicting open on another mount revokes first: the holder flushes
synchronously, so readers-after-writers always see flushed bytes.

Multi-active subtree partitioning is the next widening; snapshots are
not implemented.
"""

from __future__ import annotations

import posixpath
import threading
import time
import uuid

from ..client.rados import RadosClient, RadosError
from ..client.striper import FileLayout, StripedObject
from .mds import FsError, MdsDaemon, _norm

_DATA_PREFIX = "fs_data.{ino}"

__all__ = ["FsClient", "FsError", "FsFile", "MdsDaemon"]


class FsFile:
    """An open file handle under caps (the Fh + cap-ref role)."""

    def __init__(self, fs: "FsClient", path: str, ent: dict, caps: str):
        self._fs = fs
        self.path = path
        self.ino = ent["ino"]
        self.caps = caps
        self._size = ent["size"]
        self._cache: bytes | None = None       # "r": whole-file cache
        self._buffered: list[tuple[int, bytes]] = []  # "w": write-back
        self._lock = threading.RLock()
        self.cache_reads = 0    # served from cache (observability/tests)
        self.closed = False

    # ---------------------------------------------------------------- io
    # Lock order is ALWAYS mds._lock -> handle._lock (both RLocks): the
    # revoke path (MdsDaemon.open holds mds._lock, calls _on_revoke
    # which takes h._lock) and the io paths below (which call back into
    # the MDS) would otherwise ABBA-deadlock across two mounts.
    def read(self, offset: int = 0, length: int | None = None) -> bytes:
        with self._fs.mds._lock, self._lock:
            self._assert_open()
            if "r" not in self.caps and not self._buffered:
                # no lease: the size may have moved under us — re-stat
                # from the MDS (the uncapped read goes to authority)
                self._size = int(self._fs.mds.lookup(self.path)
                                 .get("size", 0))
            if length is None:
                length = max(0, self._size - offset)
            length = max(0, min(length, self._size - offset))
            if self._buffered:
                # read-your-writes through the buffer: flatten first
                self._flush_locked()
            if "r" in self.caps:
                if self._cache is None:
                    self._cache = self._fs._data(self.ino).read(
                        0, self._size)
                else:
                    self.cache_reads += 1
                return self._cache[offset:offset + length]
            return self._fs._data(self.ino).read(offset, length)

    def write(self, data: bytes, offset: int | None = None) -> None:
        with self._fs.mds._lock, self._lock:
            self._assert_open()
            if "w" not in self.caps:
                raise FsError(-9, f"{self.path!r} not open for write")
            if offset is None:
                offset = self._size
            self._buffered.append((offset, bytes(data)))
            self._size = max(self._size, offset + len(data))
            self._cache = None  # cache no longer covers the new extent

    def flush(self) -> None:
        with self._fs.mds._lock, self._lock:
            self._assert_open()
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buffered:
            return
        self._fs._snapc_sync()  # buffered data lands under the live snapc
        so = self._fs._data(self.ino)
        for offset, data in self._buffered:
            so.write(offset, data)
        self._buffered.clear()
        ent = self._fs.mds.lookup(self.path)
        if self._size != ent.get("size"):
            ent["size"] = max(int(ent.get("size", 0)), self._size)
            ent["mtime"] = time.time()
            self._fs.mds.set_entry(self.path, ent,
                                   client_id=self._fs.client_id)
        self._size = ent["size"]

    def close(self) -> None:
        with self._fs.mds._lock, self._lock:
            if self.closed:
                return
            self._flush_locked()
            self.closed = True
        self._fs._close_handle(self)

    def _assert_open(self) -> None:
        if self.closed:
            raise FsError(-9, f"{self.path!r} is closed")

    def __enter__(self) -> "FsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class FsClient:
    """One mounted filesystem view (libcephfs Client shape).  Shares an
    MdsDaemon with other mounts; creates a private one when none is
    given (still journaled — single-mount callers get crash safety for
    free)."""

    def __init__(self, client: RadosClient, pool: str,
                 layout: FileLayout | None = None,
                 mds: MdsDaemon | None = None,
                 client_id: str | None = None):
        self.client = client
        self.pool = pool
        self.layout = layout or FileLayout(stripe_unit=65536,
                                           stripe_count=4,
                                           object_size=1 << 22)
        self.mds = mds or MdsDaemon(client, pool)
        self.client_id = client_id or f"fsclient-{uuid.uuid4().hex[:8]}"
        self._handles: dict[str, list[FsFile]] = {}
        self._hlock = threading.Lock()
        self.mds.register_session(
            self.client_id, self._on_revoke,
            ticket=client.service_ticket("mds"),
            ticket_provider=lambda: client.service_ticket("mds"))

    def unmount(self) -> None:
        with self._hlock:
            handles = [h for hs in self._handles.values() for h in hs]
        for h in handles:
            h.close()
        self.mds.unregister_session(self.client_id)

    # ------------------------------------------------------------ helpers
    def _data(self, ino: str) -> StripedObject:
        return StripedObject(self.client, self.pool,
                             _DATA_PREFIX.format(ino=ino), self.layout)

    def _on_revoke(self, path: str) -> None:
        """MDS cap revoke: flush buffered writes, drop caches (the
        client-side CHECK_CAPS/flush path)."""
        with self._hlock:
            handles = list(self._handles.get(path, []))
        for h in handles:
            with h._lock:
                if not h.closed:
                    h._flush_locked()
                h._cache = None
                h.caps = ""

    def _close_handle(self, h: FsFile) -> None:
        with self._hlock:
            hs = self._handles.get(h.path, [])
            if h in hs:
                hs.remove(h)
            if not hs:
                self._handles.pop(h.path, None)
        self.mds.release(self.client_id, h.path)

    # ------------------------------------------------------ open/caps API
    def open(self, path: str, mode: str = "r") -> FsFile:
        """Open with caps: "r" (cached reads), "w"/"rw" (buffered
        writes); "w" creates if missing."""
        path = _norm(path)
        if "w" in mode:
            try:
                self.mds.lookup(path)
            except FsError:
                self.create(path)
        grant = self.mds.open(self.client_id, path, mode)
        h = FsFile(self, path, grant["ent"], grant["caps"])
        with self._hlock:
            self._handles.setdefault(path, []).append(h)
        return h

    # ----------------------------------------------------- .snap routing
    def _split_snap(self, path: str):
        """CephFS-style snapshot paths: <realm>/.snap/<name>[/<rest>].
        Returns (snapid, snap_root, resolved_path) or None for live
        paths; resolution walks up to the covering realm (snaprealm
        semantics)."""
        parts = _norm(path).split("/")
        if ".snap" not in parts:
            return None
        i = parts.index(".snap")
        realm = _norm("/".join(parts[:i])) or "/"
        if i + 1 >= len(parts):
            raise FsError(-21, ".snap itself is not a file")
        name = parts[i + 1]
        rest = "/".join(parts[i + 2:])
        root, sid = self.mds.snap_covering(realm, name)
        resolved = _norm(posixpath.join(realm, rest)) if rest \
            else _norm(realm)
        return sid, root, resolved

    def _snapc_sync(self) -> None:
        """Attach the filesystem's live SnapContext before data writes
        so the OSDs clone-on-first-write-after-snap (the snaprealm
        get_snap_context -> ioctx write-ctx path)."""
        seq, snaps = self.mds.snap_context()
        self.client.set_snap_context(self.pool, seq, snaps)

    def _read_snap_data(self, ent: dict, snapid: int, offset: int,
                        length: int) -> bytes:
        out = bytearray(length)
        pos = 0
        prefix = _DATA_PREFIX.format(ino=ent["ino"])
        for objno, obj_off, take in self.layout.file_to_extents(
                offset, length):
            try:
                piece = self.client.read(
                    self.pool, f"{prefix}.{objno:016x}",
                    offset=obj_off, length=take, snapid=snapid)
            except RadosError:
                piece = b""
            out[pos:pos + len(piece)] = piece
            pos += take
        return bytes(out)

    # ---------------------------------------------------- snapshot verbs
    def snap_create(self, path: str, name: str) -> int:
        # flush THIS mount's buffers under the realm before freezing
        for p, hs in list(self._handles.items()):
            if p == _norm(path) or p.startswith(_norm(path) + "/"):
                for h in list(hs):
                    if not h.closed:
                        h.flush()
        return self.mds.snap_create(path, name, client_id=self.client_id)

    def snap_list(self, path: str) -> dict:
        return self.mds.snaps_of(path)

    def snap_remove(self, path: str, name: str) -> None:
        self.mds.snap_remove(path, name, client_id=self.client_id)

    def snap_rollback(self, path: str, name: str) -> None:
        """Restore the subtree to the snapshot: journaled metadata
        rollback at the MDS, then per-piece data rollback driven here
        (idempotent — re-run after any crash)."""
        path = _norm(path)
        sid = self.mds.snaps_of(path).get(name)
        if sid is None:
            raise FsError(-2, f"no snapshot {name!r} on {path!r}")
        # capture the LIVE tree before metadata rollback: files that
        # grew after the snapshot need their beyond-snap pieces rolled
        # (the OSD removes pre-birth pieces), and files born after the
        # snapshot lose their dentries — their data is purged here
        live = {}
        self._collect_files(path, live)
        self.mds.snap_rollback(path, name, client_id=self.client_id)
        survivors: dict[str, int] = {}
        self._rollback_data(path, sid, live, survivors)
        for ino, size in live.items():
            if ino not in survivors:
                # born after the snapshot: dentry gone, purge the data
                prefix = _DATA_PREFIX.format(ino=ino)
                for objno in ({o for o, _x, _t in
                               self.layout.file_to_extents(0, size)}
                              if size else set()):
                    try:
                        self.client.remove(self.pool,
                                           f"{prefix}.{objno:016x}")
                    except RadosError:
                        pass

    def _collect_files(self, dirpath: str, out: dict) -> None:
        try:
            ents = self.mds.entries(dirpath)
        except FsError:
            return
        for nm, ent in ents.items():
            sub = posixpath.join(dirpath, nm)
            if ent["type"] == "dir":
                self._collect_files(sub, out)
            else:
                out[ent["ino"]] = int(ent.get("size", 0))

    def _rollback_data(self, dirpath: str, snapid: int,
                       live: dict, survivors: dict) -> None:
        for nm, ent in self.mds.entries(dirpath).items():
            sub = posixpath.join(dirpath, nm)
            if ent["type"] == "dir":
                self._rollback_data(sub, snapid, live, survivors)
                continue
            size = int(ent.get("size", 0))
            survivors[ent["ino"]] = size
            # roll the pieces covering the LARGER of snap-time and live
            # size: the OSD restores in-snap pieces and REMOVES pieces
            # born after the snap (pre-birth rollback semantics)
            span = max(size, live.get(ent["ino"], 0))
            prefix = _DATA_PREFIX.format(ino=ent["ino"])
            pieces = {objno for objno, _o, _t
                      in self.layout.file_to_extents(0, span)} if span \
                else set()
            for objno in pieces:
                try:
                    self.client.snap_rollback(
                        self.pool, f"{prefix}.{objno:016x}", snapid)
                except RadosError:
                    pass  # piece did not exist at snap time

    # ---------------------------------------------------------- directory
    def mkdir(self, path: str) -> None:
        if self._split_snap(path) is not None:
            raise FsError(-30, "snapshots are read-only")
        self.mds.mkdir(path, client_id=self.client_id)

    def listdir(self, path: str) -> list[str]:
        parts = _norm(path).split("/")
        if parts[-1] == ".snap":
            realm = _norm("/".join(parts[:-1])) or "/"
            self._assert_dir(realm)
            return sorted(self.mds.snaps_of(realm))
        snap = self._split_snap(path)
        if snap is not None:
            sid, _root, resolved = snap
            return sorted(self.mds.snap_entries(sid, resolved))
        self._assert_dir(path)
        return sorted(self.mds.entries(_norm(path)))

    def rmdir(self, path: str) -> None:
        self.mds.rmdir(path, client_id=self.client_id)

    def _assert_dir(self, path: str) -> None:
        ent = self.mds.lookup(path)
        if ent["type"] != "dir":
            raise FsError(-20, f"{path!r} is not a directory")

    # --------------------------------------------------------------- files
    def create(self, path: str) -> None:
        if self._split_snap(path) is not None:
            raise FsError(-30, "snapshots are read-only")
        self.mds.create(path, client_id=self.client_id)

    def write_file(self, path: str, data: bytes, offset: int = 0) -> None:
        if self._split_snap(path) is not None:
            raise FsError(-30, "snapshots are read-only")
        # caps BEFORE the data mutation: a path-denied caller must not
        # touch the file bytes and only then fail on the dentry update
        self.mds.check_caps(self.client_id, "w", path)
        self._snapc_sync()
        ent = self.mds.lookup(path)
        if ent["type"] != "file":
            raise FsError(-21, f"{path!r} is a directory")
        # cap-less mutation: revoke holders first (their caches/buffers
        # must not survive a write they never saw)
        self.mds.invalidate(path)
        self._data(ent["ino"]).write(offset, data)
        ent["size"] = max(ent["size"], offset + len(data))
        ent["mtime"] = time.time()
        self.mds.set_entry(path, ent, client_id=self.client_id)

    def read_file(self, path: str, offset: int = 0,
                  length: int | None = None) -> bytes:
        snap = self._split_snap(path)
        if snap is not None:
            sid, root, resolved = snap
            ent = self.mds.snap_lookup(sid, root, resolved)
            if ent["type"] != "file":
                raise FsError(-21, f"{path!r} is a directory")
            size = int(ent.get("size", 0))
            if length is None:
                length = max(0, size - offset)
            length = max(0, min(length, size - offset))
            return self._read_snap_data(ent, sid, offset, length)
        ent = self.mds.lookup(path)
        if ent["type"] != "file":
            raise FsError(-21, f"{path!r} is a directory")
        if length is None:
            length = max(0, ent["size"] - offset)
        length = max(0, min(length, ent["size"] - offset))
        return self._data(ent["ino"]).read(offset, length)

    def truncate(self, path: str, size: int) -> None:
        self.mds.check_caps(self.client_id, "w", path)
        ent = self.mds.lookup(path)
        if ent["type"] != "file":
            raise FsError(-21, f"{path!r} is a directory")
        self.mds.invalidate(path)
        ent = self.mds.lookup(path)  # revokes may have flushed size
        if size > ent["size"]:
            self._data(ent["ino"]).write(
                ent["size"], b"\0" * (size - ent["size"]))
        elif size < ent["size"]:
            # zero the cut region so a later grow reads POSIX holes,
            # not resurrected pre-truncate bytes
            self._data(ent["ino"]).write(
                size, b"\0" * (ent["size"] - size))
        ent["size"] = size
        ent["mtime"] = time.time()
        self.mds.set_entry(path, ent, client_id=self.client_id)

    def unlink(self, path: str) -> None:
        # caps BEFORE the data purge: rm_entry's own gate fires only
        # after the object data would already be gone
        self.mds.check_caps(self.client_id, "w", path)
        ent = self.mds.lookup(path)
        if ent["type"] != "file":
            raise FsError(-21, f"{path!r} is a directory (use rmdir)")
        self.mds.invalidate(path)
        self._data(ent["ino"]).remove()
        self.mds.rm_entry(path, client_id=self.client_id)

    def stat(self, path: str) -> dict:
        snap = self._split_snap(path)
        if snap is not None:
            sid, root, resolved = snap
            ent = dict(self.mds.snap_lookup(sid, root, resolved))
            ent.setdefault("size", 0)
            return ent
        ent = dict(self.mds.lookup(path))
        ent.setdefault("size", 0)
        return ent

    def rename(self, src: str, dst: str) -> None:
        """Same-type rename; directory renames move the SUBTREE (the
        single-rank slice of the MDS rename machinery)."""
        self.mds.rename(src, dst, client_id=self.client_id)
