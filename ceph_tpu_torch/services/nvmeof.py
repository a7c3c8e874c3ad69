"""NVMe-oF gateway: an NVMe/TCP target exporting rbd images.

The capability slice of the reference's NVMe-oF gateway
(Ceph's src/nvmeof/ — a control plane deploying an NVMe/TCP
target whose namespaces are rbd images; the data plane there is SPDK):
this module implements the TARGET itself over the NVMe/TCP binary
framing, plus the control surface (add/remove/list namespaces) the
reference drives over gRPC.

Wire shape (NVMe/TCP transport spec): every PDU starts with an 8-byte
common header [type u8][flags u8][hlen u8][pdo u8][plen u32le].
Implemented PDUs: ICReq(0x00)/ICResp(0x01), CapsuleCmd(0x04) carrying
a 64-byte SQE (+ optional in-capsule data), CapsuleResp(0x05) carrying
a 16-byte CQE, and C2HData(0x07) for read payloads.  Commands:

- Fabrics (opcode 0x7f): Connect (attach admin/io queue, return a
  controller id), Property Get/Set (CAP/VS/CC/CSTS — the register
  surface an initiator uses to enable the controller);
- Admin queue: Identify (CNS 01h controller, 00h namespace, 02h active
  namespace list), Set Features (number of queues), Keep Alive;
- IO queues: Read(02h)/Write(01h)/Flush(00h) in 512-byte LBAs, striped
  through the rbd Image data path (exclusive lock, snapshots, object
  map and journaling all apply — the gateway is just another librbd
  client, exactly the reference's layering).

The paired NvmeInitiator speaks the same framing for tests and tools —
the same in-repo-initiator pattern the NBD gateway uses.
"""

from __future__ import annotations

import socket
import struct
import threading

from ..msg.tcp import _recv_exact
from .rbd import RBD, RbdError

LBA_SHIFT = 9                 # 512-byte LBAs
LBA_SIZE = 1 << LBA_SHIFT

# PDU types
ICREQ, ICRESP = 0x00, 0x01
CAPSULE_CMD, CAPSULE_RESP = 0x04, 0x05
H2C_DATA, C2H_DATA = 0x06, 0x07

# opcodes
OP_FLUSH, OP_WRITE, OP_READ = 0x00, 0x01, 0x02
OP_IDENTIFY, OP_SET_FEATURES, OP_KEEP_ALIVE = 0x06, 0x09, 0x18
OP_FABRICS = 0x7F
FCTYPE_PROP_SET, FCTYPE_CONNECT, FCTYPE_PROP_GET = 0x00, 0x01, 0x04

SC_SUCCESS = 0x0
SC_INVALID_OPCODE = 0x1
SC_INVALID_FIELD = 0x2
SC_INVALID_NS = 0xB
SC_INTERNAL = 0x6
SC_LBA_RANGE = 0x80          # NVM command set: LBA Out of Range
MAX_NLB = 65536              # the 16-bit NLB field's ceiling

DISC_NQN = "nqn.2014-08.org.nvmexpress.discovery"


def _hdr(ptype: int, hlen: int, plen: int, pdo: int = 0,
         flags: int = 0) -> bytes:
    return struct.pack("<BBBBI", ptype, flags, hlen, pdo, plen)


def _cqe(cid: int, status: int, dw0: int = 0, sqid: int = 0,
         sqhd: int = 0) -> bytes:
    # 16-byte completion: result dw0, rsvd, sqhd, sqid, cid, status
    # (phase bit irrelevant on fabrics; status in bits 1..15)
    return struct.pack("<IIHHHH", dw0, 0, sqhd, sqid, cid,
                       status << 1)


class _Sqe:
    """Decoded 64-byte submission queue entry."""

    def __init__(self, raw: bytes):
        self.raw = raw
        self.opcode = raw[0]
        self.flags = raw[1]
        (self.cid,) = struct.unpack_from("<H", raw, 2)
        (self.nsid,) = struct.unpack_from("<I", raw, 4)
        self.cdw10, self.cdw11, self.cdw12, self.cdw13, self.cdw14, \
            self.cdw15 = struct.unpack_from("<6I", raw, 40)


class NvmeofTarget:
    """One NVMe/TCP subsystem whose namespaces are rbd images (the
    gateway role of src/nvmeof/: control plane + target)."""

    def __init__(self, client, pool: str,
                 nqn: str = "nqn.2016-06.io.ceph-tpu:sub1",
                 host: str = "127.0.0.1", port: int = 0):
        self.client = client
        self.pool = pool
        self.nqn = nqn
        self.rbd = RBD(client)
        self._lock = threading.Lock()
        self._namespaces: dict[int, str] = {}   # nsid -> image name
        self._images: dict[int, object] = {}    # nsid -> open Image
        self._next_ctrl = 1
        self._stop = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="nvmeof-target",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------- control plane
    # (the gRPC namespace_add/namespace_list surface of the reference's
    # gateway, as direct calls)
    def add_namespace(self, image: str, nsid: int | None = None) -> int:
        with self._lock:
            if nsid is None:
                nsid = max(self._namespaces, default=0) + 1
            if nsid in self._namespaces:
                raise ValueError(f"nsid {nsid} in use")
            img = self.rbd.open(self.pool, image)  # raises if absent
            self._namespaces[nsid] = image
            self._images[nsid] = img
            return nsid

    def remove_namespace(self, nsid: int) -> None:
        with self._lock:
            self._namespaces.pop(nsid)
            img = self._images.pop(nsid, None)
        if img is not None:
            img.close()

    def list_namespaces(self) -> dict[int, str]:
        with self._lock:
            return dict(self._namespaces)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            for img in self._images.values():
                try:
                    img.close()
                except Exception:  # noqa: BLE001
                    pass
            self._images.clear()

    # --------------------------------------------------- connections
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(sock,),
                                 daemon=True)
            t.start()

    def _serve(self, sock: socket.socket) -> None:
        try:
            if not self._handshake(sock):
                return
            props = {0x14: 0}  # CC register (controller configuration)
            while not self._stop.is_set():
                head = _recv_exact(sock, 8)
                if head is None:
                    return
                ptype, _fl, hlen, pdo, plen = struct.unpack("<BBBBI",
                                                            head)
                body = _recv_exact(sock, plen - 8)
                if body is None:
                    return
                if ptype != CAPSULE_CMD or len(body) < 64:
                    continue  # tolerate keep-alive/no-op PDUs
                sqe = _Sqe(body[:64])
                data = body[hlen - 8 + max(0, pdo - hlen):] \
                    if plen > hlen else b""
                self._dispatch(sock, sqe, data, props)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _handshake(self, sock: socket.socket) -> bool:
        head = _recv_exact(sock, 8)
        if head is None:
            return False
        ptype, _f, _h, _p, plen = struct.unpack("<BBBBI", head)
        if ptype != ICREQ:
            return False
        if _recv_exact(sock, plen - 8) is None:
            return False
        # ICResp: pfv 0, cpda 0, digests off, maxh2cdata 1 MiB
        payload = struct.pack("<HHBBI", 0, 0, 0, 0, 1 << 20)
        payload += b"\x00" * (120 - len(payload))
        sock.sendall(_hdr(ICRESP, 128, 128) + payload)
        return True

    # ------------------------------------------------------ dispatch
    def _reply(self, sock, cid: int, status: int, dw0: int = 0) -> None:
        cqe = _cqe(cid, status, dw0)
        sock.sendall(_hdr(CAPSULE_RESP, 24, 24) + cqe)

    def _c2h(self, sock, cid: int, data: bytes) -> None:
        # one C2HData PDU: ccid, datao, datal, rsvd then the payload
        head = struct.pack("<HHII", cid, 0, 0, len(data))
        pdu = _hdr(C2H_DATA, 24, 24 + len(data), pdo=24,
                   flags=0x0C)  # LAST_PDU | SUCCESS
        sock.sendall(pdu + head + b"\x00" * 4 + data)

    def _dispatch(self, sock, sqe: _Sqe, data: bytes, props) -> None:
        try:
            if sqe.opcode == OP_FABRICS:
                self._fabrics(sock, sqe, data, props)
            elif sqe.opcode == OP_IDENTIFY:
                self._identify(sock, sqe)
            elif sqe.opcode == OP_SET_FEATURES:
                # number-of-queues (feature 0x07): grant what was asked
                self._reply(sock, sqe.cid, SC_SUCCESS,
                            dw0=sqe.cdw11)
            elif sqe.opcode == OP_KEEP_ALIVE:
                self._reply(sock, sqe.cid, SC_SUCCESS)
            elif sqe.opcode == OP_FLUSH:
                self._reply(sock, sqe.cid, SC_SUCCESS)
            elif sqe.opcode == OP_WRITE:
                self._write(sock, sqe, data)
            elif sqe.opcode == OP_READ:
                self._read(sock, sqe)
            else:
                self._reply(sock, sqe.cid, SC_INVALID_OPCODE)
        except RbdError:
            self._reply(sock, sqe.cid, SC_INTERNAL)

    def _fabrics(self, sock, sqe: _Sqe, data: bytes, props) -> None:
        fctype = sqe.raw[4]
        if fctype == FCTYPE_CONNECT:
            with self._lock:
                ctrl = self._next_ctrl
                self._next_ctrl += 1
            # dw0 low 16 bits carry the controller id
            self._reply(sock, sqe.cid, SC_SUCCESS, dw0=ctrl)
        elif fctype == FCTYPE_PROP_GET:
            off = sqe.cdw11
            if off == 0x00:      # CAP low dword: MQES=1023
                # (fabrics Property Get here returns 32 bits via dw0;
                # the CCS/MPSMIN high dword is not representable and
                # this pair's initiator only reads the low half)
                val = 1023
            elif off == 0x08:    # VS 1.4
                val = 0x00010400
            elif off == 0x1C:    # CSTS: ready iff CC.EN
                val = 1 if props.get(0x14, 0) & 1 else 0
            else:
                val = props.get(off, 0)
            self._reply(sock, sqe.cid, SC_SUCCESS,
                        dw0=val & 0xFFFFFFFF)
        elif fctype == FCTYPE_PROP_SET:
            props[sqe.cdw11] = sqe.cdw12
            self._reply(sock, sqe.cid, SC_SUCCESS)
        else:
            self._reply(sock, sqe.cid, SC_INVALID_FIELD)

    def _identify(self, sock, sqe: _Sqe) -> None:
        cns = sqe.cdw10 & 0xFF
        buf = bytearray(4096)
        if cns == 0x01:          # controller
            struct.pack_into("<HH", buf, 0, 0xC3F0, 0x1AF4)  # vid/ssvid
            buf[4:24] = b"CEPHTPU-NVME-SN0001 "[:20]
            buf[24:64] = b"ceph-tpu nvmeof gateway".ljust(40)[:40]
            buf[64:72] = b"r5      "
            struct.pack_into("<I", buf, 516, len(self._namespaces))
            nqn = self.nqn.encode()
            buf[768:768 + len(nqn)] = nqn
        elif cns == 0x00:        # namespace
            img = self._images.get(sqe.nsid)
            if img is None:
                self._reply(sock, sqe.cid, SC_INVALID_NS)
                return
            img._load()
            blocks = img.size() >> LBA_SHIFT
            struct.pack_into("<QQQ", buf, 0, blocks, blocks, blocks)
            buf[25] = 0          # nlbaf=0 -> one LBA format
            struct.pack_into("<I", buf, 128, LBA_SHIFT << 16)  # lbads
        elif cns == 0x02:        # active namespace id list
            ids = sorted(n for n in self._namespaces
                         if n > sqe.nsid)[:1024]
            for i, nsid in enumerate(ids):
                struct.pack_into("<I", buf, i * 4, nsid)
        else:
            self._reply(sock, sqe.cid, SC_INVALID_FIELD)
            return
        self._c2h(sock, sqe.cid, bytes(buf))
        self._reply(sock, sqe.cid, SC_SUCCESS)

    def _io_image(self, sqe: _Sqe):
        img = self._images.get(sqe.nsid)
        return img

    def _write(self, sock, sqe: _Sqe, data: bytes) -> None:
        img = self._io_image(sqe)
        if img is None:
            self._reply(sock, sqe.cid, SC_INVALID_NS)
            return
        slba = sqe.cdw10 | (sqe.cdw11 << 32)
        nlb = (sqe.cdw12 & 0xFFFF) + 1
        want = nlb * LBA_SIZE
        if len(data) < want:
            self._reply(sock, sqe.cid, SC_INVALID_FIELD)
            return
        img._load()
        if (slba + nlb) * LBA_SIZE > img.size():
            self._reply(sock, sqe.cid, SC_LBA_RANGE)
            return
        img.write(slba * LBA_SIZE, data[:want])
        self._reply(sock, sqe.cid, SC_SUCCESS)

    def _read(self, sock, sqe: _Sqe) -> None:
        img = self._io_image(sqe)
        if img is None:
            self._reply(sock, sqe.cid, SC_INVALID_NS)
            return
        slba = sqe.cdw10 | (sqe.cdw11 << 32)
        nlb = (sqe.cdw12 & 0xFFFF) + 1
        img._load()
        if (slba + nlb) * LBA_SIZE > img.size():
            # a short/empty clamped read with SC_SUCCESS would silently
            # corrupt consumers that assume full-length reads
            self._reply(sock, sqe.cid, SC_LBA_RANGE)
            return
        try:
            data = img.read(slba * LBA_SIZE, nlb * LBA_SIZE)
        except RbdError:
            self._reply(sock, sqe.cid, SC_INTERNAL)
            return
        self._c2h(sock, sqe.cid, data)
        self._reply(sock, sqe.cid, SC_SUCCESS)


class NvmeInitiator:
    """Minimal NVMe/TCP host for tests and tooling (the nvme-cli role
    against this target): connect, enable the controller, identify,
    and issue LBA reads/writes."""

    def __init__(self, host: str, port: int,
                 nqn: str = "nqn.2016-06.io.ceph-tpu:sub1"):
        self.sock = socket.create_connection((host, port), timeout=10)
        self.nqn = nqn
        self._cid = 0
        self._icreq()
        self.ctrl_id = self._connect()
        # enable the controller: CC.EN=1, then poll CSTS.RDY
        self.prop_set(0x14, 1)
        assert self.prop_get(0x1C) & 1, "controller never became ready"

    # ---------------------------------------------------------- pdus
    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _icreq(self) -> None:
        payload = struct.pack("<HHBBI", 0, 0, 0, 0, 0)
        payload += b"\x00" * (120 - len(payload))
        self.sock.sendall(_hdr(ICREQ, 128, 128) + payload)
        head = _recv_exact(self.sock, 8)
        ptype, _f, _h, _p, plen = struct.unpack("<BBBBI", head)
        assert ptype == ICRESP, hex(ptype)
        _recv_exact(self.sock, plen - 8)

    def _next_cid(self) -> int:
        self._cid = (self._cid + 1) & 0xFFFF
        return self._cid

    def _sqe(self, opcode: int, nsid: int = 0, cdw10: int = 0,
             cdw11: int = 0, cdw12: int = 0, fctype: int | None = None,
             ) -> bytes:
        raw = bytearray(64)
        raw[0] = opcode
        cid = self._next_cid()
        struct.pack_into("<H", raw, 2, cid)
        if fctype is not None:
            raw[4] = fctype
        else:
            struct.pack_into("<I", raw, 4, nsid)
        struct.pack_into("<6I", raw, 40, cdw10, cdw11, cdw12, 0, 0, 0)
        return bytes(raw)

    def _capsule(self, sqe: bytes, data: bytes = b"") -> None:
        plen = 8 + 64 + len(data)
        pdo = 72 if data else 0
        self.sock.sendall(_hdr(CAPSULE_CMD, 72, plen, pdo=pdo)
                          + sqe + data)

    def _collect(self) -> tuple[int, int, bytes]:
        """Read PDUs until the completion arrives; returns (status,
        dw0, concatenated C2H data)."""
        data = b""
        while True:
            head = _recv_exact(self.sock, 8)
            assert head is not None, "target hung up"
            ptype, _f, hlen, pdo, plen = struct.unpack("<BBBBI", head)
            body = _recv_exact(self.sock, plen - 8)
            assert body is not None, "target hung up mid-PDU"
            if ptype == C2H_DATA:
                data += body[max(0, pdo - 8):]
            elif ptype == CAPSULE_RESP:
                dw0, _r, _sqhd, _sqid, _cid, status = struct.unpack(
                    "<IIHHHH", body[:16])
                return status >> 1, dw0, data

    def _cmd(self, sqe: bytes, data: bytes = b"") -> tuple[int, int,
                                                           bytes]:
        self._capsule(sqe, data)
        return self._collect()

    # ------------------------------------------------------ commands
    def _connect(self) -> int:
        st, dw0, _ = self._cmd(self._sqe(OP_FABRICS,
                                         fctype=FCTYPE_CONNECT))
        assert st == SC_SUCCESS, st
        return dw0 & 0xFFFF

    def prop_get(self, off: int) -> int:
        st, dw0, _ = self._cmd(self._sqe(OP_FABRICS, cdw11=off,
                                         fctype=FCTYPE_PROP_GET))
        assert st == SC_SUCCESS, st
        return dw0

    def prop_set(self, off: int, val: int) -> None:
        st, _d, _ = self._cmd(self._sqe(OP_FABRICS, cdw11=off,
                                        cdw12=val,
                                        fctype=FCTYPE_PROP_SET))
        assert st == SC_SUCCESS, st

    def identify_controller(self) -> dict:
        st, _d, buf = self._cmd(self._sqe(OP_IDENTIFY, cdw10=0x01))
        assert st == SC_SUCCESS and len(buf) >= 1024
        return {"sn": buf[4:24].decode().strip(),
                "model": buf[24:64].decode().strip(),
                "nn": struct.unpack_from("<I", buf, 516)[0],
                "subnqn": buf[768:1024].split(b"\x00")[0].decode()}

    def identify_namespace(self, nsid: int) -> dict:
        st, _d, buf = self._cmd(self._sqe(OP_IDENTIFY, nsid=nsid,
                                          cdw10=0x00))
        if st != SC_SUCCESS:
            raise KeyError(nsid)
        nsze = struct.unpack_from("<Q", buf, 0)[0]
        lbads = (struct.unpack_from("<I", buf, 128)[0] >> 16) & 0xFF
        return {"nsze": nsze, "lba_size": 1 << lbads}

    def list_namespaces(self) -> list[int]:
        st, _d, buf = self._cmd(self._sqe(OP_IDENTIFY, cdw10=0x02))
        assert st == SC_SUCCESS
        out = []
        for i in range(0, len(buf), 4):
            (nsid,) = struct.unpack_from("<I", buf, i)
            if nsid == 0:
                break
            out.append(nsid)
        return out

    def write(self, nsid: int, slba: int, data: bytes) -> None:
        assert len(data) % LBA_SIZE == 0 and data
        total = len(data) // LBA_SIZE
        done = 0
        while done < total:  # the NLB field is 16-bit: split here
            nlb = min(MAX_NLB, total - done)
            chunk = data[done * LBA_SIZE:(done + nlb) * LBA_SIZE]
            at = slba + done
            st, _d, _ = self._cmd(
                self._sqe(OP_WRITE, nsid=nsid,
                          cdw10=at & 0xFFFFFFFF, cdw11=at >> 32,
                          cdw12=nlb - 1), chunk)
            assert st == SC_SUCCESS, st
            done += nlb

    def read(self, nsid: int, slba: int, nlb: int) -> bytes:
        out = b""
        done = 0
        while done < nlb:
            n = min(MAX_NLB, nlb - done)
            at = slba + done
            st, _d, data = self._cmd(
                self._sqe(OP_READ, nsid=nsid,
                          cdw10=at & 0xFFFFFFFF, cdw11=at >> 32,
                          cdw12=n - 1))
            assert st == SC_SUCCESS, st
            out += data
            done += n
        return out

    def flush(self, nsid: int) -> None:
        st, _d, _ = self._cmd(self._sqe(OP_FLUSH, nsid=nsid))
        assert st == SC_SUCCESS

    def keep_alive(self) -> None:
        st, _d, _ = self._cmd(self._sqe(OP_KEEP_ALIVE))
        assert st == SC_SUCCESS
