"""rbd-nbd: export RBD images over the NBD protocol.

The capability of the reference's rbd-nbd (src/tools/rbd_nbd/ — expose
an rbd image as a network block device so any NBD client, the Linux
kernel's included, can mount it): a fixed-newstyle NBD server over the
Image read/write/flush surface.

Protocol (the published NBD spec, fixed-newstyle negotiation):
  S: NBDMAGIC IHAVEOPT <u16 handshake flags: FIXED_NEWSTYLE>
  C: <u32 client flags>
  C: IHAVEOPT <u32 option> <u32 len> <data>     (loop)
     NBD_OPT_EXPORT_NAME -> S: <u64 size> <u16 transmission flags>
                               + 124 zero pad; enter transmission
  transmission: C: <magic 0x25609513> <u16 flags> <u16 type>
                   <u64 handle> <u64 offset> <u32 length> [data]
                S: <magic 0x67446698> <u32 error> <u64 handle> [data]

Writes honor the image's exclusive-lock/journaling features (they go
through Image.write); one connection serves one export at a time, the
server hosts many connections.
"""

from __future__ import annotations

import socket
import struct
import threading

from ..msg.tcp import _recv_exact
from .rbd import RBD, RbdError

NBDMAGIC = 0x4E42444D41474943          # "NBDMAGIC"
IHAVEOPT = 0x49484156454F5054          # "IHAVEOPT"
FLAG_FIXED_NEWSTYLE = 1 << 0
CFLAG_FIXED_NEWSTYLE = 1 << 0

OPT_EXPORT_NAME = 1
OPT_ABORT = 2
OPT_LIST = 3

REP_MAGIC = 0x3E889045565A9
REP_ACK = 1
REP_SERVER = 2
REP_ERR_UNSUP = (1 << 31) | 1

REQ_MAGIC = 0x25609513
REPLY_MAGIC = 0x67446698

CMD_READ = 0
CMD_WRITE = 1
CMD_DISC = 2
CMD_FLUSH = 3
CMD_TRIM = 4

TFLAG_HAS_FLAGS = 1 << 0
TFLAG_SEND_FLUSH = 1 << 2
TFLAG_SEND_TRIM = 1 << 5

EIO = 5
EINVAL = 22
ENOSPC = 28

MAX_REQUEST = 32 << 20  # spec-suggested sanity cap per request
CFLAG_NO_ZEROES = 1 << 1


class NbdServer:
    """Serve every image of one pool as NBD exports (rbd-nbd role)."""

    def __init__(self, client, pool: str, host: str = "127.0.0.1",
                 port: int = 0):
        self.client = client
        self.pool = pool
        self.rbd = RBD(client)
        self._ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._ls.bind((host, port))
        self._ls.listen(16)
        self.port = self._ls.getsockname()[1]
        self._stopping = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="nbd-accept", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopping = True
        try:
            self._ls.close()
        except OSError:
            pass

    # ------------------------------------------------------------ accept
    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                sock, _addr = self._ls.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(sock,),
                             name="nbd-conn", daemon=True).start()

    # ------------------------------------------------------- negotiation
    def _serve_conn(self, sock: socket.socket) -> None:
        try:
            sock.sendall(struct.pack(">QQH", NBDMAGIC, IHAVEOPT,
                                     FLAG_FIXED_NEWSTYLE))
            raw = _recv_exact(sock, 4)
            if raw is None:
                return
            (cflags,) = struct.unpack(">I", raw)
            img = self._negotiate(sock, cflags)
            if img is not None:
                self._transmission(sock, img)
        except OSError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _negotiate(self, sock: socket.socket, cflags: int):
        while True:
            hdr = _recv_exact(sock, 16)
            if hdr is None:
                return None
            magic, opt, ln = struct.unpack(">QII", hdr)
            data = _recv_exact(sock, ln) if ln else b""
            if magic != IHAVEOPT or data is None:
                return None
            if opt == OPT_EXPORT_NAME:
                name = data.decode("utf-8", "replace")
                try:
                    img = self.rbd.open(self.pool, name)
                except RbdError:
                    return None  # spec: option has no error reply path
                tflags = (TFLAG_HAS_FLAGS | TFLAG_SEND_FLUSH
                          | TFLAG_SEND_TRIM)
                # NO_ZEROES clients (the Linux kernel's nbd-client
                # negotiates it) must NOT receive the 124-byte pad, or
                # transmission desynchronises by exactly that much
                pad = b"" if cflags & CFLAG_NO_ZEROES else b"\0" * 124
                sock.sendall(struct.pack(">QH", img.size(), tflags)
                             + pad)
                return img
            if opt == OPT_LIST:
                for name in self.rbd.list(self.pool):
                    payload = struct.pack(">I", len(name.encode())) \
                        + name.encode()
                    sock.sendall(struct.pack(
                        ">QIII", REP_MAGIC, opt, REP_SERVER,
                        len(payload)) + payload)
                sock.sendall(struct.pack(">QIII", REP_MAGIC, opt,
                                         REP_ACK, 0))
            elif opt == OPT_ABORT:
                sock.sendall(struct.pack(">QIII", REP_MAGIC, opt,
                                         REP_ACK, 0))
                return None
            else:
                sock.sendall(struct.pack(">QIII", REP_MAGIC, opt,
                                         REP_ERR_UNSUP, 0))

    # ------------------------------------------------------ transmission
    def _transmission(self, sock: socket.socket, img) -> None:
        try:
            while True:
                hdr = _recv_exact(sock, 28)
                if hdr is None:
                    return
                magic, _flags, cmd, handle, offset, length = \
                    struct.unpack(">IHHQQI", hdr)
                if magic != REQ_MAGIC:
                    return
                if length > MAX_REQUEST and cmd != CMD_DISC:
                    # a u32 straight off the wire must not size an
                    # allocation (4 GiB trim/read would OOM the host)
                    if cmd == CMD_WRITE:
                        return  # can't resync past an unread payload
                    self._reply(sock, EINVAL, handle)
                    continue
                if cmd == CMD_READ:
                    try:
                        data = img.read(offset, length)
                        data += b"\0" * (length - len(data))
                        self._reply(sock, 0, handle, data)
                    except RbdError:
                        self._reply(sock, EINVAL, handle)
                elif cmd == CMD_WRITE:
                    payload = _recv_exact(sock, length)
                    if payload is None:
                        return
                    try:
                        img.write(offset, payload)
                        self._reply(sock, 0, handle)
                    except RbdError:
                        self._reply(sock, ENOSPC, handle)
                elif cmd == CMD_FLUSH:
                    # Image.write is synchronous through librados-style
                    # all-ack commits: nothing is buffered server-side
                    self._reply(sock, 0, handle)
                elif cmd == CMD_TRIM:
                    try:
                        img.write(offset, b"\0" * length)
                        self._reply(sock, 0, handle)
                    except RbdError:
                        self._reply(sock, EIO, handle)
                elif cmd == CMD_DISC:
                    return
                else:
                    self._reply(sock, EINVAL, handle)
        finally:
            img.close()

    @staticmethod
    def _reply(sock: socket.socket, error: int, handle: int,
               data: bytes = b"") -> None:
        sock.sendall(struct.pack(">IIQ", REPLY_MAGIC, error, handle)
                     + data)


class NbdClient:
    """Minimal fixed-newstyle NBD client (the kernel's wire dialect) —
    the other half of the gateway, used by smoke/tests and usable as a
    library client."""

    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=10)
        magic, opt, flags = struct.unpack(
            ">QQH", _recv_exact(self.sock, 18))
        assert magic == NBDMAGIC and opt == IHAVEOPT
        self.sock.sendall(struct.pack(">I", 1))  # fixed-newstyle
        self._handle = 0

    def list_exports(self):
        self.sock.sendall(struct.pack(">QII", IHAVEOPT, OPT_LIST, 0))
        names = []
        while True:
            magic, opt, rep, ln = struct.unpack(
                ">QIII", _recv_exact(self.sock, 20))
            payload = _recv_exact(self.sock, ln) if ln else b""
            if rep == REP_ACK:
                return names
            assert rep == REP_SERVER
            (nlen,) = struct.unpack(">I", payload[:4])
            names.append(payload[4:4 + nlen].decode())

    def go(self, name):
        data = name.encode()
        self.sock.sendall(struct.pack(">QII", IHAVEOPT,
                                      OPT_EXPORT_NAME, len(data))
                          + data)
        size, tflags = struct.unpack(">QH",
                                     _recv_exact(self.sock, 10))
        _recv_exact(self.sock, 124)
        return size, tflags

    def _cmd(self, cmd, offset=0, length=0, data=b""):
        self._handle += 1
        self.sock.sendall(struct.pack(
            ">IHHQQI", REQ_MAGIC, 0, cmd, self._handle, offset,
            length) + data)
        if cmd == CMD_DISC:
            return 0, b""
        magic, err, handle = struct.unpack(
            ">IIQ", _recv_exact(self.sock, 16))
        assert magic == REPLY_MAGIC and handle == self._handle
        body = _recv_exact(self.sock, length) \
            if cmd == CMD_READ and err == 0 else b""
        return err, body

    def read(self, offset, length):
        err, data = self._cmd(CMD_READ, offset, length)
        assert err == 0, err
        return data

    def write(self, offset, data):
        err, _ = self._cmd(CMD_WRITE, offset, len(data), data)
        return err

    def flush(self):
        return self._cmd(CMD_FLUSH)[0]

    def trim(self, offset, length):
        return self._cmd(CMD_TRIM, offset, length)[0]

    def close(self):
        try:
            self._cmd(CMD_DISC)
        finally:
            self.sock.close()
