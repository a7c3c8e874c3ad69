"""SMB gateway: an SMB2 server exporting CephFS trees as shares.

The capability slice of the reference's SMB integration (the smb mgr
module orchestrating Samba over CephFS shares — ceph's SMB story is
"serve the filesystem over SMB"): this module implements the SERVER
itself for the SMB2 wire dialect 2.0.2 with guest authentication,
backed by FsClient (so MDS journaling, caps leases, snapshots and the
rest of the fs stack apply — the gateway is just another fs mount,
the same layering the NBD and NVMe-oF gateways use for rbd).

Wire shape (MS-SMB2): a 4-byte NetBIOS session header (type 0x00 +
24-bit length) frames each message; every SMB2 message starts with the
64-byte sync header [\\xfeSMB][hdrlen=64][credit charge][status]
[command][credits][flags][next][message id][tree id][session id]
[signature].  Implemented commands:

- NEGOTIATE (0x00) -> dialect 0x0202, guest security
- SESSION_SETUP (0x01) -> a session id (guest; no NTLM exchange)
- TREE_CONNECT (0x03) / TREE_DISCONNECT (0x04): \\\\host\\share ->
  tree id; each share is one FsClient subtree
- CREATE (0x05): UTF-16LE paths, open/create/overwrite dispositions,
  directory or file; returns a 16-byte file id
- CLOSE (0x06), READ (0x08), WRITE (0x09), FLUSH (0x07)
- QUERY_DIRECTORY (0x0e): FileDirectoryInformation entries
- SET_INFO (0x11): FileDispositionInformation (delete-on-close)

The paired SmbClient drives it in tests — the in-repo-initiator
pattern of the NBD/NVMe gateways.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import uuid

from ..msg.tcp import _recv_exact
from .fs import FsClient
from .mds import FsError

DIALECT = 0x0202

# commands
NEGOTIATE, SESSION_SETUP, LOGOFF, TREE_CONNECT, TREE_DISCONNECT = \
    0x00, 0x01, 0x02, 0x03, 0x04
CREATE, CLOSE, FLUSH, READ, WRITE = 0x05, 0x06, 0x07, 0x08, 0x09
QUERY_DIRECTORY, SET_INFO = 0x0E, 0x11

STATUS_OK = 0x00000000
STATUS_NOT_FOUND = 0xC0000034        # OBJECT_NAME_NOT_FOUND
STATUS_COLLISION = 0xC0000035        # OBJECT_NAME_COLLISION
STATUS_NO_SUCH_FILE = 0xC000000F
STATUS_ACCESS_DENIED = 0xC0000022
STATUS_NOT_SUPPORTED = 0xC00000BB
STATUS_BAD_NETWORK_NAME = 0xC00000CC
STATUS_DIR_NOT_EMPTY = 0xC0000101
STATUS_FILE_IS_A_DIRECTORY = 0xC00000BA
STATUS_INVALID = 0xC000000D
STATUS_NO_MORE_FILES = 0x80000006

# create dispositions
FILE_OPEN, FILE_CREATE, FILE_OPEN_IF = 1, 2, 3
FILE_OVERWRITE, FILE_OVERWRITE_IF = 4, 5
FILE_DIRECTORY_FILE = 0x01


def _smb2_hdr(command: int, status: int, message_id: int,
              session_id: int, tree_id: int,
              flags: int = 0x01) -> bytes:  # SERVER_TO_REDIR
    return (b"\xfeSMB" + struct.pack("<HHI", 64, 0, status)
            + struct.pack("<HHIIQ", command, 1, flags, 0, message_id)
            + struct.pack("<IIQ", 0, tree_id, session_id)  # rsvd+tid+sid
            + b"\x00" * 16)


def _parse_hdr(raw: bytes) -> dict:
    assert raw[:4] == b"\xfeSMB"
    (command,) = struct.unpack_from("<H", raw, 12)
    (message_id,) = struct.unpack_from("<Q", raw, 24)
    (tree_id,) = struct.unpack_from("<I", raw, 36)
    (session_id,) = struct.unpack_from("<Q", raw, 40)
    return {"command": command, "mid": message_id,
            "tid": tree_id, "sid": session_id}


def _filetime(ts: float) -> int:
    return int((ts + 11644473600) * 10_000_000)


class _Open:
    def __init__(self, path: str, is_dir: bool, fs: FsClient):
        self.path = path
        self.is_dir = is_dir
        self.fs = fs
        self.delete_on_close = False
        self.enum_done = False  # QUERY_DIRECTORY single-pass cursor


class SmbServer:
    """One SMB2 endpoint; shares map share-name -> (pool, subtree)."""

    def __init__(self, client_factory, host: str = "127.0.0.1",
                 port: int = 0):
        """client_factory() -> a fresh RadosClient for each share's
        FsClient mount (server threads must not share the caller's
        client)."""
        self._client_factory = client_factory
        self._shares: dict[str, FsClient] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="smb-server", daemon=True)
        self._thread.start()

    # ------------------------------------------------- control plane
    def add_share(self, name: str, pool: str,
                  mds=None) -> None:
        """Export a pool's filesystem as \\\\host\\name (the smb mgr
        module's share-create role)."""
        fs = FsClient(self._client_factory(), pool, mds=mds)
        with self._lock:
            old = self._shares.get(name.lower())
            self._shares[name.lower()] = fs
        if old is not None:
            old.unmount()  # the replaced mount's MDS session must die

    def remove_share(self, name: str) -> None:
        with self._lock:
            fs = self._shares.pop(name.lower(), None)
        if fs is not None:
            fs.unmount()

    def list_shares(self) -> list[str]:
        with self._lock:
            return sorted(self._shares)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            for fs in self._shares.values():
                try:
                    fs.unmount()
                except Exception:  # noqa: BLE001
                    pass
            self._shares.clear()

    # --------------------------------------------------- connections
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(sock,),
                             daemon=True).start()

    def _recv_msg(self, sock) -> bytes | None:
        head = _recv_exact(sock, 4)
        if head is None:
            return None
        length = struct.unpack(">I", b"\x00" + head[1:])[0]
        return _recv_exact(sock, length)

    def _send_msg(self, sock, hdr_body: bytes) -> None:
        sock.sendall(struct.pack(">I", len(hdr_body)) + hdr_body)

    def _serve(self, sock: socket.socket) -> None:
        sessions: set[int] = set()
        trees: dict[int, str] = {}          # tree id -> share name
        opens: dict[bytes, _Open] = {}      # file id -> open state
        next_ids = {"sid": 0x100, "tid": 1}
        try:
            while not self._stop.is_set():
                msg = self._recv_msg(sock)
                if msg is None or len(msg) < 64:
                    return
                hdr = _parse_hdr(msg)
                body = msg[64:]
                out = self._dispatch(hdr, body, sessions, trees,
                                     opens, next_ids)
                self._send_msg(sock, out)
        except (ConnectionError, OSError, AssertionError):
            pass
        finally:
            # a dropped connection closes every handle: pending
            # delete-on-close dispositions must still fire (SMB2
            # disconnect semantics)
            for op in opens.values():
                if op.delete_on_close:
                    try:
                        if op.is_dir:
                            op.fs.rmdir(op.path)
                        else:
                            op.fs.unlink(op.path)
                    except Exception:  # noqa: BLE001
                        pass
            try:
                sock.close()
            except OSError:
                pass

    # ------------------------------------------------------ dispatch
    def _err(self, hdr, status: int) -> bytes:
        # error response body: StructureSize 9 + reserved + 1 byte
        return _smb2_hdr(hdr["command"], status, hdr["mid"],
                         hdr["sid"], hdr["tid"]) + \
            struct.pack("<HHI", 9, 0, 0) + b"\x00"

    def _share_fs(self, trees, hdr) -> FsClient | None:
        name = trees.get(hdr["tid"])
        if name is None:
            return None
        with self._lock:
            return self._shares.get(name)

    def _dispatch(self, hdr, body, sessions, trees, opens,
                  next_ids) -> bytes:
        cmd = hdr["command"]
        try:
            if cmd == NEGOTIATE:
                out = struct.pack("<HHHH", 65, 1, DIALECT, 0)
                out += uuid.uuid4().bytes
                out += struct.pack("<IIII", 0, 1 << 20, 1 << 20,
                                   1 << 20)  # caps, maxtrans/read/write
                out += struct.pack("<QQ", _filetime(time.time()), 0)
                out += struct.pack("<HHI", 0, 0, 0)  # no security blob
                return _smb2_hdr(cmd, STATUS_OK, hdr["mid"], 0, 0) + out
            if cmd == SESSION_SETUP:
                sid = next_ids["sid"]
                next_ids["sid"] += 1
                sessions.add(sid)
                # flags: SMB2_SESSION_FLAG_IS_GUEST
                out = struct.pack("<HHHH", 9, 1, 0, 0)
                return _smb2_hdr(cmd, STATUS_OK, hdr["mid"], sid, 0) \
                    + out
            if hdr["sid"] not in sessions:
                return self._err(hdr, STATUS_ACCESS_DENIED)
            if cmd == TREE_CONNECT:
                (path_off, path_len) = struct.unpack_from("<HH", body,
                                                          4)
                raw = body[path_off - 64:path_off - 64 + path_len]
                unc = raw.decode("utf-16le")
                share = unc.rsplit("\\", 1)[-1].lower()
                with self._lock:
                    known = share in self._shares
                if not known:
                    return self._err(hdr, STATUS_BAD_NETWORK_NAME)
                tid = next_ids["tid"]
                next_ids["tid"] += 1
                trees[tid] = share
                # share type 1 (disk), no flags, caps, max access
                out = struct.pack("<HBBIII", 16, 1, 0, 0, 0,
                                  0x001F01FF)
                return _smb2_hdr(cmd, STATUS_OK, hdr["mid"],
                                 hdr["sid"], tid) + out
            if cmd == TREE_DISCONNECT:
                trees.pop(hdr["tid"], None)
                return _smb2_hdr(cmd, STATUS_OK, hdr["mid"],
                                 hdr["sid"], hdr["tid"]) \
                    + struct.pack("<HH", 4, 0)
            fs = self._share_fs(trees, hdr)
            if fs is None:
                return self._err(hdr, STATUS_BAD_NETWORK_NAME)
            if cmd == CREATE:
                return self._create(hdr, body, fs, opens)
            if cmd == CLOSE:
                return self._close(hdr, body, fs, opens)
            if cmd == READ:
                return self._read(hdr, body, fs, opens)
            if cmd == WRITE:
                return self._write(hdr, body, fs, opens)
            if cmd == FLUSH:
                return _smb2_hdr(cmd, STATUS_OK, hdr["mid"],
                                 hdr["sid"], hdr["tid"]) \
                    + struct.pack("<HH", 4, 0)
            if cmd == QUERY_DIRECTORY:
                return self._query_dir(hdr, body, fs, opens)
            if cmd == SET_INFO:
                return self._set_info(hdr, body, fs, opens)
            return self._err(hdr, STATUS_NOT_SUPPORTED)
        except FsError as e:
            status = {-2: STATUS_NOT_FOUND, -17: STATUS_COLLISION,
                      -39: STATUS_DIR_NOT_EMPTY,
                      -21: STATUS_FILE_IS_A_DIRECTORY,
                      -13: STATUS_ACCESS_DENIED}.get(
                          e.code, STATUS_INVALID)
            return self._err(hdr, status)
        except Exception:  # noqa: BLE001 - degraded cluster
            return self._err(hdr, STATUS_INVALID)

    # ------------------------------------------------------ commands
    def _create(self, hdr, body, fs: FsClient, opens) -> bytes:
        # canonical 56-byte CREATE request: ...[36:40]=disposition,
        # [40:44]=options, [44:46]=name offset, [46:48]=name length
        (disposition,) = struct.unpack_from("<I", body, 36)
        (options,) = struct.unpack_from("<I", body, 40)
        (name_off, name_len) = struct.unpack_from("<HH", body, 44)
        raw = body[name_off - 64:name_off - 64 + name_len]
        name = raw.decode("utf-16le")
        path = "/" + name.replace("\\", "/").strip("/")
        want_dir = bool(options & FILE_DIRECTORY_FILE)
        try:
            ent = fs.stat(path) if path != "/" else {"type": "dir",
                                                     "size": 0}
            exists = True
        except FsError:
            ent = None
            exists = False
        if exists and disposition == FILE_CREATE:
            return self._err(hdr, STATUS_COLLISION)
        if not exists:
            if disposition == FILE_OPEN:
                return self._err(hdr, STATUS_NOT_FOUND)
            if want_dir:
                fs.mkdir(path)
                ent = {"type": "dir", "size": 0}
            else:
                fs.create(path)
                ent = {"type": "file", "size": 0}
        elif disposition in (FILE_OVERWRITE, FILE_OVERWRITE_IF) \
                and ent["type"] == "file":
            fs.truncate(path, 0)
            ent = dict(ent, size=0)
        is_dir = ent["type"] == "dir"
        fid = uuid.uuid4().bytes
        opens[fid] = _Open(path, is_dir, fs)
        now = _filetime(time.time())
        out = struct.pack("<HBBI", 89, 0, 0, 1)   # create action: opened
        out += struct.pack("<QQQQ", now, now, now, now)
        size = int(ent.get("size", 0))
        out += struct.pack("<QQ", size, size)
        out += struct.pack("<II", 0x10 if is_dir else 0x80, 0)
        out += fid
        out += struct.pack("<II", 0, 0)           # no create contexts
        return _smb2_hdr(CREATE, STATUS_OK, hdr["mid"], hdr["sid"],
                         hdr["tid"]) + out

    def _get_open(self, body, opens,
                  fid_off: int) -> tuple[_Open | None, bytes]:
        fid = body[fid_off:fid_off + 16]
        return opens.get(fid), fid

    def _close(self, hdr, body, fs: FsClient, opens) -> bytes:
        op, fid = self._get_open(body, opens, 8)
        if op is None:
            return self._err(hdr, STATUS_INVALID)
        opens.pop(fid, None)
        if op.delete_on_close:
            if op.is_dir:
                fs.rmdir(op.path)
            else:
                fs.unlink(op.path)
        # 60-byte CLOSE response: size/flags/reserved + 4 FILETIMEs +
        # alloc + eof + attributes
        out = struct.pack("<HHI", 60, 0, 0) + b"\x00" * 52
        return _smb2_hdr(CLOSE, STATUS_OK, hdr["mid"], hdr["sid"],
                         hdr["tid"]) + out

    def _read(self, hdr, body, fs: FsClient, opens) -> bytes:
        (length,) = struct.unpack_from("<I", body, 4)
        (offset,) = struct.unpack_from("<Q", body, 8)
        op, _fid = self._get_open(body, opens, 16)
        if op is None:
            return self._err(hdr, STATUS_INVALID)
        if op.is_dir:
            return self._err(hdr, STATUS_FILE_IS_A_DIRECTORY)
        data = fs.read_file(op.path, offset, length)
        # data offset is from the SMB2 header start: 64 + 16
        out = struct.pack("<HBBIII", 17, 80, 0, len(data), 0, 0) + data
        return _smb2_hdr(READ, STATUS_OK, hdr["mid"], hdr["sid"],
                         hdr["tid"]) + out

    def _write(self, hdr, body, fs: FsClient, opens) -> bytes:
        (data_off, length) = struct.unpack_from("<HI", body, 2)
        (offset,) = struct.unpack_from("<Q", body, 8)
        op, _fid = self._get_open(body, opens, 16)
        if op is None:
            return self._err(hdr, STATUS_INVALID)
        data = body[data_off - 64:data_off - 64 + length]
        fs.write_file(op.path, data, offset=offset)
        out = struct.pack("<HHIIHH", 17, 0, len(data), 0, 0, 0)
        return _smb2_hdr(WRITE, STATUS_OK, hdr["mid"], hdr["sid"],
                         hdr["tid"]) + out

    def _query_dir(self, hdr, body, fs: FsClient, opens) -> bytes:
        op, _fid = self._get_open(body, opens, 8)
        if op is None or not op.is_dir:
            return self._err(hdr, STATUS_INVALID)
        flags = body[3] if len(body) > 3 else 0
        if flags & 0x01:  # SMB2_RESTART_SCANS
            op.enum_done = False
        if op.enum_done:
            return self._err(hdr, STATUS_NO_MORE_FILES)
        op.enum_done = True
        names = fs.listdir(op.path)
        entries = b""
        for i, name in enumerate(names):
            ent = fs.stat(op.path.rstrip("/") + "/" + name)
            enc = name.encode("utf-16le")
            is_dir = ent["type"] == "dir"
            size = int(ent.get("size", 0))
            now = _filetime(ent.get("mtime", time.time()))
            # FileDirectoryInformation (class 0x01)
            rec = struct.pack("<II", 0, i)
            rec += struct.pack("<QQQQ", now, now, now, now)
            rec += struct.pack("<QQ", size, size)
            rec += struct.pack("<II", 0x10 if is_dir else 0x80,
                               len(enc))
            rec += enc
            pad = (-len(rec)) % 8
            rec += b"\x00" * pad
            if i < len(names) - 1:
                rec = struct.pack("<I", len(rec)) + rec[4:]
            entries += rec
        if not entries:
            return self._err(hdr, STATUS_NO_SUCH_FILE)
        out = struct.pack("<HHI", 9, 72, len(entries)) + entries
        return _smb2_hdr(QUERY_DIRECTORY, STATUS_OK, hdr["mid"],
                         hdr["sid"], hdr["tid"]) + out

    def _set_info(self, hdr, body, fs: FsClient, opens) -> bytes:
        info_type = body[2]
        file_class = body[3]
        (blen,) = struct.unpack_from("<I", body, 4)
        (boff,) = struct.unpack_from("<H", body, 8)
        op, _fid = self._get_open(body, opens, 16)
        if op is None:
            return self._err(hdr, STATUS_INVALID)
        buf = body[boff - 64:boff - 64 + blen]
        if info_type == 1 and file_class == 13:  # DispositionInformation
            op.delete_on_close = bool(buf and buf[0])
            return _smb2_hdr(SET_INFO, STATUS_OK, hdr["mid"],
                             hdr["sid"], hdr["tid"]) \
                + struct.pack("<H", 2)
        return self._err(hdr, STATUS_NOT_SUPPORTED)


class SmbClient:
    """Minimal SMB2 host for tests/tools (the smbclient role against
    this server): negotiate, guest session, tree connect, and file ops."""

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port), timeout=10)
        self._mid = 0
        self.sid = 0
        self.tid = 0
        st, _h, body = self._cmd(NEGOTIATE,
                                 struct.pack("<HHHH", 36, 1, 0, 0)
                                 + b"\x00" * 28
                                 + struct.pack("<H", DIALECT))
        assert st == STATUS_OK
        (self.dialect,) = struct.unpack_from("<H", body, 4)
        st, hdr, _ = self._cmd(SESSION_SETUP,
                               struct.pack("<HBBIIHHQ", 25, 0, 0, 0,
                                           0, 0, 0, 0))
        assert st == STATUS_OK
        self.sid = hdr["sid"]

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    # ------------------------------------------------------- framing
    def _cmd(self, command: int, payload: bytes,
             tid: int | None = None) -> tuple[int, dict, bytes]:
        self._mid += 1
        hdr = (b"\xfeSMB" + struct.pack("<HHI", 64, 0, 0)
               + struct.pack("<HHIIQ", command, 1, 0, 0, self._mid)
               + struct.pack("<IIQ", 0,
                             tid if tid is not None else self.tid,
                             self.sid)
               + b"\x00" * 16)
        msg = hdr + payload
        self.sock.sendall(struct.pack(">I", len(msg)) + msg)
        head = _recv_exact(self.sock, 4)
        assert head is not None, "server hung up"
        length = struct.unpack(">I", b"\x00" + head[1:])[0]
        raw = _recv_exact(self.sock, length)
        assert raw is not None, "server hung up mid-message"
        (status,) = struct.unpack_from("<I", raw, 8)
        return status, _parse_hdr(raw), raw[64:]

    # ------------------------------------------------------ commands
    def tree_connect(self, share: str) -> None:
        unc = f"\\\\server\\{share}".encode("utf-16le")
        payload = struct.pack("<HHHH", 9, 0, 64 + 8, len(unc)) + unc
        st, hdr, _ = self._cmd(TREE_CONNECT, payload, tid=0)
        assert st == STATUS_OK, hex(st)
        self.tid = hdr["tid"]

    def _create(self, path: str, disposition: int,
                directory: bool = False) -> bytes:
        name = path.strip("/").replace("/", "\\").encode("utf-16le")
        fixed = struct.pack("<HBBI", 57, 0, 0, 2)   # imp level
        fixed += struct.pack("<QQ", 0, 0)           # flags, reserved
        fixed += struct.pack("<II", 0x001F01FF, 0)  # access, attrs
        fixed += struct.pack("<II", 7, disposition)  # share, disp
        fixed += struct.pack("<I",
                             FILE_DIRECTORY_FILE if directory else 0)
        fixed += struct.pack("<HH", 64 + 56, len(name))
        fixed += struct.pack("<II", 0, 0)           # no contexts
        assert len(fixed) == 56, len(fixed)
        st, _h, body = self._cmd(CREATE, fixed + name)
        if st != STATUS_OK:
            raise OSError(hex(st))
        return body[64:80]  # the 16-byte file id

    def open(self, path: str) -> bytes:
        return self._create(path, FILE_OPEN)

    def create_file(self, path: str) -> bytes:
        return self._create(path, FILE_CREATE)

    def mkdir(self, path: str) -> bytes:
        return self._create(path, FILE_CREATE, directory=True)

    def close_file(self, fid: bytes, delete: bool = False) -> None:
        if delete:
            # SET_INFO: StructureSize 33, type 1 (file), class 13
            # (DispositionInformation), buffer = one truthy byte at
            # offset 64 + 32 (right after the fixed part + file id)
            payload = struct.pack("<HBBIHHI", 33, 1, 13, 1, 64 + 32,
                                  0, 0) + fid + b"\x01"
            st, _h, _b = self._cmd(SET_INFO, payload)
            assert st == STATUS_OK, hex(st)
        st, _h, _b = self._cmd(CLOSE, struct.pack("<HHI", 24, 0, 0)
                               + fid)
        assert st == STATUS_OK, hex(st)

    def write(self, fid: bytes, offset: int, data: bytes) -> None:
        fixed = struct.pack("<HHIQ", 49, 64 + 48, len(data), offset)
        fixed += fid + struct.pack("<IIHHI", 0, 0, 0, 0, 0)
        assert len(fixed) == 48, len(fixed)
        st, _h, _b = self._cmd(WRITE, fixed + data)
        assert st == STATUS_OK, hex(st)

    def read(self, fid: bytes, offset: int, length: int) -> bytes:
        fixed = struct.pack("<HBBIQ", 49, 0, 0, length, offset)
        fixed += fid + struct.pack("<IIIHH", 0, 0, 0, 0, 0) + b"\x00"
        st, _h, body = self._cmd(READ, fixed)
        assert st == STATUS_OK, hex(st)
        (data_off,) = struct.unpack_from("<B", body, 2)
        (dlen,) = struct.unpack_from("<I", body, 4)
        return body[data_off - 64:data_off - 64 + dlen]

    def listdir(self, fid: bytes) -> list[dict]:
        fixed = struct.pack("<HBBI", 33, 1, 0, 0)
        fixed += fid
        pattern = "*".encode("utf-16le")
        fixed += struct.pack("<HHI", 64 + 32, len(pattern), 1 << 16)
        st, _h, body = self._cmd(QUERY_DIRECTORY, fixed + pattern)
        if st in (STATUS_NO_SUCH_FILE, STATUS_NO_MORE_FILES):
            return []
        assert st == STATUS_OK, hex(st)
        (out_off, out_len) = struct.unpack_from("<HI", body, 2)
        buf = body[out_off - 64:out_off - 64 + out_len]
        out = []
        pos = 0
        while pos < len(buf):
            (nxt,) = struct.unpack_from("<I", buf, pos)
            size = struct.unpack_from("<Q", buf, pos + 40)[0]
            attrs = struct.unpack_from("<I", buf, pos + 56)[0]
            (nlen,) = struct.unpack_from("<I", buf, pos + 60)
            name = buf[pos + 64:pos + 64 + nlen].decode("utf-16le")
            out.append({"name": name, "size": size,
                        "dir": bool(attrs & 0x10)})
            if nxt == 0:
                break
            pos += nxt
        return out
