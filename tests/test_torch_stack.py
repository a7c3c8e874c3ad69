"""The pluggable transport Stack seam: PosixStack / UringStack behind
TcpNetwork, on the port (the JAX package's tests/test_stack.py on
ceph_tpu_torch, less its build smoke of native/'s ``make uring``, which
the JAX package's copy runs).

Pins the four contracts the seam lives by:

- BYTE IDENTITY: the bytes a frame puts on the wire do not depend on
  the stack — every corpus message sent through a PosixTransport and a
  UringTransport produces exactly the legacy ``encode_frame`` stream.
- FALLBACK: ``ms_stack=uring`` on a box without io_uring degrades to
  posix with a recorded reason and keeps serving (``auto`` degrades
  silently); a bad stack name is a config error, not a fallback.
- RESILIENCE: partial sends and dribbled reads resume on both stacks;
  a peer killed mid-connection breaks one transport, not the
  messenger (session resume redelivers on a fresh connection).
- MEASUREMENT: the uring transport keeps the zero-copy counter
  contract of test_wire_zero_copy.py (plaintext/auth: 0 flattens,
  0 rx copies; secure: bounded) and books the new syscall telemetry
  (msg_syscalls_{tx,rx}, msg_uring_{sqe_batch,reg_buf_recycled}).
"""

import socket
import struct
import threading
import time

import pytest

from ceph_tpu_torch.msg import messages as M
from ceph_tpu_torch.msg import uring
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger, Policy
from ceph_tpu_torch.msg.stack import (PosixStack, PosixTransport, UringStack,
                                UringTransport, make_stack)
from ceph_tpu_torch.msg.wire import encode_frame, frame_encoder

PG = M.PgId(3, 7)
BIG = bytes(range(256)) * 64  # 16 KiB >= SEG_REF_MIN

uring_only = pytest.mark.skipif(
    not uring.available(),
    reason=f"io_uring unavailable: {uring.unavailable_reason()}")

STACKS = ["posix", pytest.param("uring", marks=uring_only)]


# ------------------------------------------------------------- helpers
class _Sink(Dispatcher):
    def __init__(self):
        self.got = []

    def ms_dispatch(self, conn, msg):
        self.got.append(msg)
        return True


def _wire_pair(**net_kw):
    from ceph_tpu_torch.msg.tcp import TcpNetwork
    net = TcpNetwork(**net_kw)
    a = Messenger(net, "zc.tx", Policy.lossless_peer())
    b = Messenger(net, "zc.rx", Policy.lossless_peer())
    sink = _Sink()
    b.add_dispatcher(sink)
    a.start()
    b.start()
    net.set_addr("zc.rx", net.addr_of("zc.rx"))
    return net, a, b, sink


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _drain(net, a, b):
    a.shutdown()
    b.shutdown()
    net.stop()


def _transport(kind, sock, sink=None):
    return (PosixTransport(sock, sink=sink) if kind == "posix"
            else UringTransport(sock, sink=sink))


def _read_all(sock, n, out):
    sock.settimeout(30)
    while len(out) < n:
        chunk = sock.recv(1 << 16)
        if not chunk:
            return
        out += chunk


# ------------------------------------------------------- byte identity
@pytest.mark.parametrize("kind", STACKS)
def test_wire_bytes_are_stack_independent(kind):
    """Every corpus message type sent through the transport produces
    EXACTLY the legacy encode_frame stream — so posix and uring put
    identical bytes on the wire, and corpus_wire/ stays the oracle for
    both."""
    from ceph_tpu_torch.tools.dencoder import message_samples
    msgs = list(message_samples().values())
    msgs.append(M.MSubWrite(1, PG, "obj", -1, 9, "write", BIG,
                            {"v": 9}))  # a referenced-payload frame
    legacy = b"".join(encode_frame("alice", "bob", m) for m in msgs)
    a, b = socket.socketpair()
    t = _transport(kind, a)
    rx = bytearray()
    reader = threading.Thread(target=_read_all, args=(b, len(legacy), rx),
                              daemon=True)
    reader.start()
    try:
        for m in msgs:
            enc = frame_encoder("alice", "bob", m)
            t.sendv([struct.pack("<I", enc.nbytes)] + enc.segments())
        reader.join(timeout=30)
        assert bytes(rx) == legacy
    finally:
        t.close()
        b.close()


# ------------------------------------------------------------ fallback
def test_forced_uring_without_support_degrades_to_posix(monkeypatch):
    """ms_stack=uring on a box without the extension/kernel: posix with
    a recorded reason, never an error; auto degrades silently."""
    monkeypatch.setattr(uring, "unavailable_reason",
                        lambda: "forced-off (test)")
    monkeypatch.setattr(uring, "available", lambda: False)
    st, reason = make_stack("uring")
    assert isinstance(st, PosixStack) and not isinstance(st, UringStack)
    assert reason == "forced-off (test)"
    st, reason = make_stack("auto")
    assert st.name == "posix" and reason is None
    with pytest.raises(ValueError):
        make_stack("dpdk")
    # e2e: a net ASKED for uring still serves, and says why it couldn't
    net, a, b, sink = _wire_pair(stack="uring")
    try:
        assert net.stack_name == "posix"
        assert net.stack_fallback == "forced-off (test)"
        assert a.send_message(
            "zc.rx", M.MSubWrite(1, PG, "o", -1, 1, "write", BIG))
        assert _wait(lambda: len(sink.got) == 1)
        assert sink.got[0].data == BIG
    finally:
        _drain(net, a, b)


@uring_only
def test_requested_uring_is_satisfied_when_available():
    st, reason = make_stack("uring")
    assert isinstance(st, UringStack) and reason is None
    st, reason = make_stack("auto")
    assert isinstance(st, UringStack) and reason is None


# ------------------------------------------- uring counter contracts
@uring_only
def test_uring_plaintext_zero_copy_and_syscall_counters():
    """The zero-copy contract survives the stack swap: a plaintext
    1 MiB payload crosses a uring hop with zero Python-side copies,
    lands as a carved view over a registered slot, and the syscall /
    batch / recycle telemetry books against the right messengers."""
    net, a, b, sink = _wire_pair(stack="uring")
    try:
        assert net.stack_name == "uring" and net.stack_fallback is None
        payload = bytes(bytearray(range(256)) * 4096)  # 1 MiB
        n = 4
        for i in range(n):
            assert a.send_message(
                "zc.rx", M.MSubWrite(i, PG, f"o{i}", -1, 1, "write",
                                     payload))
        assert _wait(lambda: len(sink.got) == n)
        conn = net._out[net.addr_of("zc.rx")]
        assert isinstance(conn.t, UringTransport)
        for m in sink.got:
            assert isinstance(m.data, memoryview)  # carved, not copied
            assert m.data == payload
        tx = a.perf.dump()
        rx = b.perf.dump()
        assert tx["msg_tx_flatten_copies"] == 0
        assert rx["msg_rx_copy_copies"] == 0
        assert tx["msg_syscalls_tx"] >= 1          # enters, not frames
        assert 1 <= tx["msg_uring_sqe_batch"] <= n
        assert rx["msg_syscalls_rx"] >= n
        # drop the carves: the registered slots recycle for new frames
        sink.got.clear()
        for i in range(n):
            assert a.send_message(
                "zc.rx", M.MSubWrite(n + i, PG, f"r{i}", -1, 1, "write",
                                     payload))
        assert _wait(lambda: len(sink.got) == n)
        assert b.perf.dump()["msg_uring_reg_buf_recycled"] >= 1
    finally:
        _drain(net, a, b)


@uring_only
def test_uring_auth_mode_still_zero_copy():
    net, a, b, sink = _wire_pair(stack="uring", auth_secret=b"zc-secret")
    try:
        payload = b"\x5a" * (256 << 10)
        assert a.send_message(
            "zc.rx", M.MSubWrite(1, PG, "o", -1, 1, "write", payload))
        assert _wait(lambda: len(sink.got) == 1)
        assert sink.got[0].data == payload
        assert a.perf.dump()["msg_tx_flatten_copies"] == 0
        assert b.perf.dump()["msg_rx_copy_copies"] == 0
    finally:
        _drain(net, a, b)


@uring_only
def test_uring_secure_mode_copies_are_bounded_and_counted():
    net, a, b, sink = _wire_pair(stack="uring", auth_secret=b"zc-secret",
                                 secure=True)
    try:
        payload = b"\xc3" * (256 << 10)
        n = 3
        for i in range(n):
            assert a.send_message(
                "zc.rx", M.MSubWrite(i, PG, f"o{i}", -1, 1, "write",
                                     payload))
        assert _wait(lambda: len(sink.got) == n)
        for m in sink.got:
            assert m.data == payload
        tx = a.perf.dump()
        rx = b.perf.dump()
        assert 1 * n <= tx["msg_tx_flatten_copies"] <= 2 * n
        assert rx["msg_rx_copy_copies"] == n
        assert tx["msg_syscalls_tx"] >= 1
    finally:
        _drain(net, a, b)


@uring_only
def test_registered_pool_recycles_only_when_unreferenced():
    """The refcount gate on the rx pool: a slot is handed out again
    only once every carved view over it has died; a busy pool falls
    back to fresh heap instead of blocking or aliasing."""
    a, b = socket.socketpair()
    t = UringTransport(a)
    try:
        mv1 = t.get_rx_buffer(1024)
        assert mv1.obj is t._slots[0]
        mv2 = t.get_rx_buffer(1024)
        assert mv2.obj is t._slots[1]
        # both slots pinned by live views: fresh heap, no recycle
        mv3 = t.get_rx_buffer(1024)
        assert mv3.obj is not t._slots[0] and mv3.obj is not t._slots[1]
        assert t.rx_counters["msg_uring_reg_buf_recycled"] == 0
        mv1.release()
        mv4 = t.get_rx_buffer(1024)
        assert mv4.obj is t._slots[0]
        assert t.rx_counters["msg_uring_reg_buf_recycled"] == 1
        # slot 1 is STILL pinned by mv2 — never handed out twice
        mv5 = t.get_rx_buffer(1024)
        assert mv5.obj is not t._slots[1]
        for mv in (mv2, mv3, mv4, mv5):
            mv.release()
    finally:
        b.close()
        t.release_rx()
        t.close()


# ------------------------------------------------ partial IO resilience
@pytest.mark.parametrize("kind", STACKS)
def test_partial_send_resumes_until_delivered(kind):
    """A multi-MiB frame through tiny socket buffers: the transport
    resumes mid-segment (posix loop / uring short-completion requeue)
    until every byte lands, in order."""
    a, b = socket.socketpair()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8192)
    b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8192)
    booked = {}

    def sink(counter, n):
        booked[counter] = booked.get(counter, 0) + n

    t = _transport(kind, a, sink=sink)
    from ceph_tpu_torch.msg.stack import _IOV_CAP
    # more segments than one iovec gather can carry AND more bytes
    # than the socket buffers hold: both resume paths must fire
    segs = [bytes([i & 0xFF]) * 4096 for i in range(_IOV_CAP + 8)]
    want = b"".join(segs)
    rx = bytearray()
    reader = threading.Thread(target=_read_all, args=(b, len(want), rx),
                              daemon=True)
    reader.start()
    try:
        t.sendv(segs)
        reader.join(timeout=30)
        assert bytes(rx) == want
        assert _wait(lambda: booked.get("msg_syscalls_tx", 0) >= 1)
        if kind == "posix":
            # > _IOV_CAP segments CANNOT be one sendmsg call
            assert booked["msg_syscalls_tx"] >= 2
        else:
            assert booked.get("msg_uring_sqe_batch", 0) >= 1
    finally:
        t.close()
        b.close()


@pytest.mark.parametrize("kind", STACKS)
def test_dribbled_frame_reassembles(kind):
    """A peer that trickles a frame byte-by-byte: recv_head/recv_body
    fill their buffers exactly (recv_into loop / WAITALL), no short
    reads surface to the framing layer."""
    a, b = socket.socketpair()
    t = _transport(kind, a)
    body = bytes(range(256)) * 31 + b"tail"  # 7940 B, odd size
    raw = struct.pack("<I", len(body)) + body

    def dribble():
        for i in range(0, len(raw), 7):
            b.sendall(raw[i:i + 7])
            if i < 70:  # stall the first few chunks
                time.sleep(0.002)
    writer = threading.Thread(target=dribble, daemon=True)
    writer.start()
    try:
        head = memoryview(bytearray(4))
        assert t.recv_head(head)
        (length,) = struct.unpack("<I", head)
        assert length == len(body)
        mv = t.get_rx_buffer(length)
        assert t.recv_body(mv)
        assert bytes(mv) == body
        assert t.rx_counters["msg_syscalls_rx"] >= 1
        writer.join(timeout=10)
    finally:
        b.close()    # EOF completes any linked next-header read
        t.release_rx()
        t.close()


@pytest.mark.parametrize("kind", STACKS)
def test_peer_kill_mid_connection_survives(kind):
    """Killing the socket under a live connection breaks ONE transport;
    session resume redelivers the in-flight tail on a fresh connection
    and the messenger keeps serving — on either stack.  The uring tx is
    STAGED (async), so a frame accepted just before the death is
    discovered sits in the resume ring until the next send reconnects —
    later traffic, not the doomed send itself, drives the replay."""
    from ceph_tpu_torch.msg.messages import MMonSubscribe
    net, a, b, sink = _wire_pair(stack=kind)
    try:
        assert a.send_message("zc.rx", MMonSubscribe("m1"))
        assert _wait(lambda: len(sink.got) == 1)
        conn = net._out[net.addr_of("zc.rx")]
        if kind == "uring":
            assert isinstance(conn.t, UringTransport)
        conn.sock.shutdown(socket.SHUT_RDWR)
        a.send_message("zc.rx", MMonSubscribe("m2"))  # rides the ring
        deadline = time.time() + 20.0
        probes = 0
        while time.time() < deadline and \
                not any(m.what == "m2" for m in sink.got):
            a.send_message("zc.rx", MMonSubscribe(f"p{probes}"))
            probes += 1
            _wait(lambda: any(m.what == "m2" for m in sink.got),
                  timeout=0.5)
        whats = [m.what for m in sink.got]
        assert whats[:2] == ["m1", "m2"], whats  # ring replay, in order
        assert net.resumed >= 1
    finally:
        _drain(net, a, b)
