"""Pluggable transport stacks for the TCP messenger (the reference's
NetworkStack seam: Stack.cc:74 selecting PosixStack / RDMA / DPDK).

A *stack* turns an established, handshaken socket into a *transport* —
the object the messenger uses for framed IO:

- ``sendv(segs)``: vectored tx of one frame held as a segment list,
  straight from the callers' buffers (no assembly); raises OSError on a
  dead peer.
- ``recv_head(mv)`` / ``recv_body(mv)``: rx landing into caller-owned
  buffers; False on EOF/reset.
- ``get_rx_buffer(n)``: the buffer a payload-bearing frame lands in.
  The transport owns the *allocation policy* (the uring stack hands out
  pre-pinned registered-pool slices); the CALLER owns the lifetime —
  decode carves zero-copy views over it, and a pool slot recycles only
  once every carved view has died (refcount-gated, counted as
  ``msg_uring_reg_buf_recycled``).

Two phases on purpose: ``wrap(sock)`` yields a plain blocking posix
transport that the auth / session-resume handshakes run on (simple,
timeout-driven, byte-oriented), and ``activate(t, sink)`` upgrades the
connection to the stack's framed fast path once the handshakes are
done.  PosixStack's activate is the identity; UringStack's swaps in an
io_uring transport — and degrades to the posix transport (logged, never
an error) when a ring cannot be created.

Syscall telemetry: every transport books ``msg_syscalls_tx`` /
``msg_uring_sqe_batch`` through its ``sink`` (the sending entity's perf
registry, bound at activate) and accumulates ``msg_syscalls_rx`` /
``msg_uring_reg_buf_recycled`` in ``rx_counters`` for the read loop to
book per-frame against the receiving entity — the counters that prove
the "one enter per frame batch" story instead of asserting it.
"""

from __future__ import annotations

import ctypes
import socket
import sys
import threading

from ..utils.log import dout

_IOV_CAP = 512           # segments per sendmsg call (under IOV_MAX)
_SQE_SEGS = 1024         # iovec entries per SENDMSG SQE
_TX_STAGE_MAX = 64 << 20  # staged-tx byte bound before sendv blocks
_RX_SLOTS = 2            # registered rx slots per connection
_RX_SLOT_BYTES = 2 << 20  # each; larger frames fall back to fresh heap


def _recv_into(sock: socket.socket, mv: memoryview) -> bool:
    """Fill mv exactly from the socket (recv_into: no per-chunk
    accumulation copies).  False on EOF/reset."""
    got, n = 0, len(mv)
    while got < n:
        try:
            r = sock.recv_into(mv[got:])
        except OSError:  # peer reset / socket closed under us
            return False
        if not r:
            return False
        got += r
    return True


def _sendmsg_all(sock: socket.socket, segs: list) -> int:
    """Vectored sendall: gather the segment list straight from the
    callers' buffers (scatter-gather IO — the kernel's iovec copy is
    the only one), resuming mid-segment on partial sends.  Raises
    OSError on a dead peer like sendall.  Returns the syscall count."""
    if getattr(sock, "sendmsg", None) is None:
        # non-POSIX socket (or a test stub): assemble and stream
        sock.sendall(b"".join(segs))
        return 1
    n_sys = 0
    mvs = [memoryview(s) for s in segs if len(s)]
    i = 0
    while i < len(mvs):
        sent = sock.sendmsg(mvs[i:i + _IOV_CAP])
        n_sys += 1
        while sent > 0:
            seg = mvs[i]
            if sent >= len(seg):
                sent -= len(seg)
                i += 1
            else:
                mvs[i] = seg[sent:]
                sent = 0
    return n_sys


# -- zero-copy buffer pinning ---------------------------------------------
class _PyBufferStruct(ctypes.Structure):
    _fields_ = [("buf", ctypes.c_void_p), ("obj", ctypes.c_void_p),
                ("len", ctypes.c_ssize_t), ("itemsize", ctypes.c_ssize_t),
                ("readonly", ctypes.c_int), ("ndim", ctypes.c_int),
                ("format", ctypes.c_char_p),
                ("shape", ctypes.POINTER(ctypes.c_ssize_t)),
                ("strides", ctypes.POINTER(ctypes.c_ssize_t)),
                ("suboffsets", ctypes.POINTER(ctypes.c_ssize_t)),
                ("internal", ctypes.c_void_p)]


# Function objects of our own over the two symbols: the ones
# ctypes.pythonapi hands out are shared by the whole process, and another
# module that sets their argtypes to its own buffer struct (the JAX
# package's copy of this one) would break every call made here.
_GetBuffer = ctypes.PYFUNCTYPE(
    ctypes.c_int, ctypes.py_object, ctypes.POINTER(_PyBufferStruct),
    ctypes.c_int)(("PyObject_GetBuffer", ctypes.pythonapi))
_ReleaseBuffer = ctypes.PYFUNCTYPE(
    None, ctypes.POINTER(_PyBufferStruct))(
    ("PyBuffer_Release", ctypes.pythonapi))


class _Pin:
    """Zero-copy (address, length) of any bytes-like object, exported
    via the buffer protocol and held alive until release() — what an
    in-flight SQE's iovec points at.  Works for bytes, bytearray, AND
    offset memoryview slices (the encoder's by-reference payload
    segments), which the c_char_p tricks cannot handle."""

    __slots__ = ("_pb", "addr", "nbytes", "_held")

    def __init__(self, obj, writable: bool = False):
        self._pb = _PyBufferStruct()
        # pythonapi (PyDLL) re-raises the buffer error for us on rc != 0
        _GetBuffer(obj, ctypes.byref(self._pb), 1 if writable else 0)
        self._held = True
        self.addr = self._pb.buf
        self.nbytes = self._pb.len

    def release(self) -> None:
        if self._held:
            self._held = False
            _ReleaseBuffer(ctypes.byref(self._pb))


# -- posix transport -------------------------------------------------------
class PosixTransport:
    """The blocking-socket transport: sendmsg gather tx, recv_into rx.
    Also the handshake-phase transport for EVERY stack (wrap returns
    one), so auth/resume stay simple byte-oriented code."""

    __slots__ = ("sock", "sink", "rx_counters", "vectored")

    def __init__(self, sock: socket.socket, sink=None):
        self.sock = sock
        self.sink = sink  # inc(counter, n) -> tx-side syscall booking
        self.rx_counters = {"msg_syscalls_rx": 0,
                            "msg_uring_reg_buf_recycled": 0}
        self.vectored = getattr(sock, "sendmsg", None) is not None

    def sendv(self, segs: list) -> None:
        n_sys = _sendmsg_all(self.sock, segs)
        if self.sink is not None and n_sys:
            self.sink("msg_syscalls_tx", n_sys)

    def _recv(self, mv: memoryview) -> bool:
        got, n = 0, len(mv)
        sock = self.sock
        while got < n:
            try:
                r = sock.recv_into(mv[got:])
            except OSError:
                return False
            self.rx_counters["msg_syscalls_rx"] += 1
            if not r:
                return False
            got += r
        return True

    def recv_head(self, mv: memoryview) -> bool:
        return self._recv(mv)

    def recv_body(self, mv: memoryview) -> bool:
        return self._recv(mv)

    def get_rx_buffer(self, length: int) -> memoryview:
        return memoryview(bytearray(length))

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def release_rx(self) -> None:
        pass


# -- io_uring transport ----------------------------------------------------
class UringTransport:
    """io_uring-backed framed IO for one connection.

    tx: ``sendv`` only STAGES the frame (segment refs, no copy) and a
    per-connection drainer thread concatenates everything staged into
    one SENDMSG SQE gather per <=1024 segments — one ``io_uring_enter``
    per frame *batch*, not per frame.  MSG_WAITALL makes the kernel
    retry partial sends internally, so one CQE covers the whole gather.
    Frame order is staging order (callers stage under the conn send
    lock) and the drainer keeps a single chain in flight per socket, so
    frames cannot interleave on the wire — byte stream identical to the
    posix transport's.

    rx: bodies complete into slices of a pre-pinned registered buffer
    pool via RECV+MSG_WAITALL; each body SQE carries IOSQE_IO_LINK with
    the NEXT frame's 4-byte header read queued behind it, so steady
    state costs ~one enter per frame.  A short completion is EOF/error
    by construction (WAITALL) and kills the connection — the session
    resume layer owns continuation, not the transport.

    Two rings per connection (tx for the drainer, rx for the read
    loop): each ring is single-consumer, so completions never route
    across threads."""

    vectored = True

    def __init__(self, sock: socket.socket, sink=None):
        from . import uring as _uring
        L = _uring.lib()
        if L.ct_uring_probe() != 0:
            raise _uring.UringUnavailable("io_uring_setup refused")
        self._L = L
        self.sock = sock
        self.sink = sink
        self.rx_counters = {"msg_syscalls_rx": 0,
                            "msg_uring_reg_buf_recycled": 0}
        self._fd = sock.fileno()
        self._tx = L.ct_uring_create(64)
        self._rx = L.ct_uring_create(16)
        if not self._tx or not self._rx:
            self._destroy_rings()
            raise _uring.UringUnavailable("ring mmap failed")
        # rx state (single-threaded: the connection's read loop)
        self._slots: list[bytearray] = []   # lazy registered pool
        self._slot_pins: list[_Pin] = []
        self._slot_base: list[int] = []
        self._slot_used: list[bool] = []
        self._head_buf = bytearray(4)
        self._head_pin = _Pin(self._head_buf, writable=True)
        self._rx_tok = 0
        self._rx_done: dict[int, int] = {}
        self._rx_inflight = 0
        self._pending_head: int | None = None
        self._rx_released = False
        # tx state (staged by senders, drained by one thread)
        self._tx_cv = threading.Condition()
        self._tx_staged: list[list] = []
        self._tx_staged_bytes = 0
        self._tx_inflight = 0
        self._dead = False
        self._closed = False
        self._tx_thread = threading.Thread(
            target=self._drain_loop, daemon=True,
            name=f"uring-tx-{self._fd}")
        self._tx_thread.start()

    # -- tx ---------------------------------------------------------------
    def sendv(self, segs: list) -> None:
        frame = [s for s in segs if len(s)]
        total = sum(len(s) for s in frame)
        with self._tx_cv:
            while (self._tx_staged_bytes >= _TX_STAGE_MAX
                   and not self._dead):
                self._tx_cv.wait()
            if self._dead:
                raise OSError("uring transport dead")
            self._tx_staged.append(frame)
            self._tx_staged_bytes += total
            self._tx_cv.notify_all()

    def _drain_loop(self) -> None:
        while True:
            with self._tx_cv:
                while not self._tx_staged and not self._dead:
                    self._tx_cv.wait()
                batch = self._tx_staged
                self._tx_staged = []
                self._tx_staged_bytes = 0
                self._tx_cv.notify_all()
                if not batch:
                    return  # dead and drained
            if not self._send_batch(batch):
                self._mark_dead()
                return

    def _send_batch(self, batch: list) -> bool:
        """One gathered submission for every frame staged since the
        last drain.  True on full delivery to the socket."""
        L = self._L
        pins, addrs, lens = [], [], []
        try:
            for frame in batch:
                for seg in frame:
                    p = _Pin(seg)
                    pins.append(p)
                    addrs.append(p.addr)
                    lens.append(p.nbytes)
            enters = 0
            i = 0
            while i < len(addrs):
                n = min(_SQE_SEGS, len(addrs) - i)
                a = (ctypes.c_ulonglong * n)(*addrs[i:i + n])
                ln = (ctypes.c_ulonglong * n)(*lens[i:i + n])
                want = sum(lens[i:i + n])
                tok = i + 1
                if L.ct_uring_prep_sendmsg(self._tx, self._fd, a, ln,
                                           n, tok) != 0:
                    return False
                self._tx_inflight += 1
                res = None
                done: dict[int, int] = {}
                while tok not in done:
                    rc = L.ct_uring_submit(self._tx, 1)
                    enters += 1
                    self._tx_reap(done)
                    if rc < 0 and tok not in done:
                        return False
                res = done[tok]
                if res < 0:
                    return False
                while res < want:
                    # WAITALL short completion: error-adjacent (signal
                    # mid-op); resume the remainder like the posix loop
                    if res <= 0:
                        return False
                    skip = res
                    j = i
                    while skip >= lens[j]:
                        skip -= lens[j]
                        j += 1
                    ra = [addrs[j] + skip] + addrs[j + 1:i + n]
                    rl = [lens[j] - skip] + lens[j + 1:i + n]
                    a = (ctypes.c_ulonglong * len(ra))(*ra)
                    ln = (ctypes.c_ulonglong * len(rl))(*rl)
                    want = sum(rl)
                    addrs[j:i + n] = ra
                    lens[j:i + n] = rl
                    i = j
                    n = len(ra)
                    tok += 1000000
                    if L.ct_uring_prep_sendmsg(
                            self._tx, self._fd, a, ln, n, tok) != 0:
                        return False
                    self._tx_inflight += 1
                    done.clear()
                    while tok not in done:
                        rc = L.ct_uring_submit(self._tx, 1)
                        enters += 1
                        self._tx_reap(done)
                        if rc < 0 and tok not in done:
                            return False
                    res = done[tok]
                    if res < 0:
                        return False
                i += n
            if self.sink is not None:
                self.sink("msg_syscalls_tx", enters)
                self.sink("msg_uring_sqe_batch", 1)
            return True
        finally:
            for p in pins:
                p.release()

    def _tx_reap(self, done: dict) -> None:
        toks = (ctypes.c_ulonglong * 32)()
        res = (ctypes.c_longlong * 32)()
        n = self._L.ct_uring_reap(self._tx, toks, res, 32)
        for k in range(max(n, 0)):
            done[toks[k]] = res[k]
            self._tx_inflight -= 1

    def _mark_dead(self) -> None:
        with self._tx_cv:
            self._dead = True
            self._tx_staged = []
            self._tx_staged_bytes = 0
            self._tx_cv.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    # -- rx (read-loop thread only) ---------------------------------------
    def _next_rx_tok(self) -> int:
        self._rx_tok += 1
        return self._rx_tok

    def _rx_reap(self) -> None:
        toks = (ctypes.c_ulonglong * 32)()
        res = (ctypes.c_longlong * 32)()
        n = self._L.ct_uring_reap(self._rx, toks, res, 32)
        for k in range(max(n, 0)):
            self._rx_done[toks[k]] = res[k]
            self._rx_inflight -= 1

    def _rx_wait(self, tok: int) -> int:
        while tok not in self._rx_done:
            rc = self._L.ct_uring_submit(self._rx, 1)
            self.rx_counters["msg_syscalls_rx"] += 1
            self._rx_reap()
            if rc < 0 and tok not in self._rx_done:
                return -1
        return self._rx_done.pop(tok)

    def recv_head(self, mv: memoryview) -> bool:
        if self._rx is None:
            return False
        if self._pending_head is not None:
            tok, self._pending_head = self._pending_head, None
        else:
            tok = self._next_rx_tok()
            if self._L.ct_uring_prep_recv(
                    self._rx, self._fd, self._head_pin.addr, 4,
                    1, 0, tok) != 0:
                return False
            self._rx_inflight += 1
        if self._rx_wait(tok) != 4:
            return False
        mv[:4] = self._head_buf
        return True

    def recv_body(self, mv: memoryview) -> bool:
        if self._rx is None:
            return False
        pin = _Pin(mv, writable=True)
        try:
            tok = self._next_rx_tok()
            if self._L.ct_uring_prep_recv(
                    self._rx, self._fd, pin.addr, len(mv),
                    1, 1, tok) != 0:  # link the next header behind it
                return False
            self._rx_inflight += 1
            htok = self._next_rx_tok()
            if self._L.ct_uring_prep_recv(
                    self._rx, self._fd, self._head_pin.addr, 4,
                    1, 0, htok) == 0:
                self._rx_inflight += 1
                self._pending_head = htok
            return self._rx_wait(tok) == len(mv)
        finally:
            pin.release()

    def get_rx_buffer(self, length: int) -> memoryview:
        if length <= _RX_SLOT_BYTES:
            if not self._slots:
                self._init_rx_pool()
            for i in range(len(self._slots)):
                # a slot is free when nothing outside the transport
                # holds a view over it: the carved payload views from
                # past frames each keep a reference to the exporting
                # bytearray, so refcount-at-baseline == every consumer
                # is done == safe to overwrite.  (Indexed loop, not
                # enumerate: enumerate's reused result tuple would hold
                # one extra reference and defeat the gate.)
                s = self._slots[i]
                if sys.getrefcount(s) == self._slot_base[i]:
                    if self._slot_used[i]:
                        self.rx_counters[
                            "msg_uring_reg_buf_recycled"] += 1
                    self._slot_used[i] = True
                    return memoryview(s)[:length]
        return memoryview(bytearray(length))

    def _init_rx_pool(self) -> None:
        self._slots = [bytearray(_RX_SLOT_BYTES)
                       for _ in range(_RX_SLOTS)]
        self._slot_pins = [_Pin(s, writable=True) for s in self._slots]
        addrs = (ctypes.c_ulonglong * _RX_SLOTS)(
            *[p.addr for p in self._slot_pins])
        lens = (ctypes.c_ulonglong * _RX_SLOTS)(
            *[p.nbytes for p in self._slot_pins])
        # registration pre-pins the pool's pages for the ring lifetime
        # (no per-op pin/unpin churn); failure is fine — ops address
        # the same memory either way
        self._L.ct_uring_register_buffers(self._rx, addrs, lens,
                                          _RX_SLOTS)
        self._slot_base = [sys.getrefcount(s) for s in self._slots]
        self._slot_used = [False] * _RX_SLOTS

    def release_rx(self) -> None:
        """Tear down the rx ring — called by the read-loop thread (the
        ring's only user) at loop exit, after close() shut the socket
        down so any in-flight recv completes promptly."""
        if self._rx is None or self._rx_released:
            return
        self._rx_released = True
        tries = 0
        while self._rx_inflight > 0 and tries < 64:
            rc = self._L.ct_uring_submit(self._rx, 1)
            self._rx_reap()
            if rc < 0:
                break
            tries += 1
        self._L.ct_uring_destroy(self._rx)
        self._rx = None
        self._head_pin.release()
        for p in self._slot_pins:
            p.release()
        self._slot_pins = []

    # -- lifecycle ---------------------------------------------------------
    def _destroy_rings(self) -> None:
        if getattr(self, "_tx", None):
            self._L.ct_uring_destroy(self._tx)
            self._tx = None
        if getattr(self, "_rx", None):
            self._L.ct_uring_destroy(self._rx)
            self._rx = None

    def close(self) -> None:
        with self._tx_cv:
            if self._closed:
                return
            self._closed = True
            self._dead = True
            self._tx_cv.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        # wake the drainer if it is blocked waiting on a CQE: a NOP
        # guarantees one more completion (prep/submit share the C-side
        # ring mutex with the drainer, so this is safe concurrently)
        if self._tx:
            try:
                self._L.ct_uring_prep_nop(self._tx, 0)
                self._L.ct_uring_submit(self._tx, 0)
            except OSError:
                pass
        self._tx_thread.join(timeout=5)
        if self._tx_thread.is_alive():
            return  # drainer wedged: leak the ring rather than race it
        tries = 0
        done: dict = {}
        while self._tx_inflight > 0 and tries < 64:
            rc = self._L.ct_uring_submit(self._tx, 1)
            self._tx_reap(done)
            if rc < 0:
                break
            tries += 1
        self._L.ct_uring_destroy(self._tx)
        self._tx = None
        try:
            self.sock.close()
        except OSError:
            pass


# -- stacks ----------------------------------------------------------------
class PosixStack:
    """The default stack: everything rides the blocking posix
    transport, byte-identical to the pre-seam messenger."""

    name = "posix"

    def wrap(self, sock: socket.socket) -> PosixTransport:
        """The handshake-phase transport for a fresh socket."""
        return PosixTransport(sock)

    def activate(self, t: PosixTransport, sink=None):
        """Upgrade a handshaken connection to the framed fast path."""
        t.sink = sink
        return t


class UringStack(PosixStack):
    """io_uring fast path; per-CONNECTION fallback to the posix
    transport when a ring cannot be created (fd limits, seccomp mid-
    flight) — degraded, logged, never an error."""

    name = "uring"

    def activate(self, t: PosixTransport, sink=None):
        try:
            return UringTransport(t.sock, sink=sink)
        except Exception as e:  # noqa: BLE001 - any failure -> posix
            dout("msg", 1)("stack: uring activation failed (%r); "
                           "connection stays on posix", e)
            t.sink = sink
            return t


def make_stack(kind: str = "posix") -> tuple[PosixStack, str | None]:
    """Build the configured stack.  Returns (stack, fallback_reason):
    reason is None when the request was satisfied; ``ms_stack=uring``
    on a box without the extension/kernel support yields
    (PosixStack, reason) with a logged event — degraded service beats
    no service.  ``auto`` probes and picks quietly."""
    kind = (kind or "posix").lower()
    if kind not in ("posix", "uring", "auto"):
        raise ValueError(f"unknown ms_stack {kind!r}")
    if kind in ("uring", "auto"):
        from . import uring as _uring
        reason = _uring.unavailable_reason()
        if reason is None:
            return UringStack(), None
        if kind == "uring":
            dout("msg", 1)("stack: ms_stack=uring unavailable (%s); "
                           "falling back to posix", reason)
            return PosixStack(), reason
    return PosixStack(), None
