"""TCP transport: the process/host boundary for the messenger layer.

The role of the reference's AsyncMessenger + PosixStack + frames_v2
(src/msg/async/AsyncMessenger.cc, frames_v2.h): entity-addressed
messengers exchanging length-framed, codec-encoded messages over real
sockets, so daemons can live in different processes/hosts.  The
contract (deliver/enqueue/partition/drop) is identical to LocalNetwork;
`tests` run the same cluster suites over either transport.

Addressing (the MonMap/OSDMap address plumbing):
- every local Messenger binds a listening socket; `addr_of(name)` is its
  "host:port" to publish (MOSDBoot.addr -> OsdInfo.addr -> map pushes);
- `set_addr` seeds remote entities (a client/daemon only needs the mon
  address a priori — everything else arrives with the maps);
- replies ride the connection the request arrived on (learned reply
  routes — the Connection identity of AsyncMessenger), so transient
  entities like clients need no listener of their own to be reachable.
"""

from __future__ import annotations

import hmac
import hashlib
import secrets as _secrets
import socket
import struct
import threading
import time

import collections
import secrets

from ..utils.codec import SEG_REF_MIN
from ..utils.log import dout
from .messenger import Network
# transport seam: low-level IO + the pluggable stacks live in stack.py;
# _IOV_CAP/_recv_into/_sendmsg_all are re-exported here for the tests
# and services that import them from tcp
from .stack import (_IOV_CAP, PosixTransport,  # noqa: F401 - re-export
                    _recv_into, _sendmsg_all, make_stack)
from .wire import decode_frame, frame_encoder

_AUTH_MAGIC = b"CTPX1\0"
_RESM_MAGIC = b"RESM"
_TAG_LEN = 16
_RING_MAX = 512          # replayable frames kept per session
_RING_MAX_BYTES = 32 << 20  # payload-byte budget per session ring
_STASH_MAX = 64          # dead sessions kept for resume
#: frames up to this size are received into ONE reusable buffer (and
#: decoded fully-detached); larger frames get a fresh buffer so decode
#: can carve zero-copy views that stay valid by refcount after the
#: read loop moves on.  Equal to the carve threshold on purpose: a
#: frame small enough for the reuse buffer cannot contain a carvable
#: blob, so reuse never aliases a live payload.
_RECV_REUSE_MAX = SEG_REF_MIN


def _mac(key: bytes, *parts) -> bytes:
    return hmac.new(key, b"".join(parts), hashlib.sha256).digest()


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray(n)
    if not _recv_into(sock, memoryview(buf)):
        return None
    return bytes(buf)


def _payload_nbytes(plain) -> int:
    """Byte length of a ring payload: bytes or a tuple of segments."""
    if isinstance(plain, tuple):
        return sum(len(s) for s in plain)
    return len(plain)


class _SessState:
    """Resumable session state that OUTLIVES any one socket (the
    ProtocolV2 connection cookie + out_queue/replay role): sequenced
    sent frames in a bounded ring, and the last seq received."""

    __slots__ = ("cookie", "send_seq", "recv_seq", "ring", "ring_bytes",
                 "lock")

    def __init__(self):
        self.cookie = secrets.token_bytes(16)
        self.send_seq = 0
        self.recv_seq = 0
        # ring holds (seq, flags, plain_payload) where the payload is
        # bytes OR a tuple of bytes-like segments (zero-copy sends ring
        # the segment list itself — no assembly just to be replayable),
        # bounded both by entry count and payload bytes — recovery
        # pushes can be huge frames, so a count-only cap could pin GiB
        # of plaintext per session (the reference bounds replay state
        # by bytes too).  Mutations under self.lock (the state outlives
        # any one conn).
        self.ring: collections.deque = collections.deque()
        self.ring_bytes = 0
        self.lock = threading.Lock()

    def ring_append(self, seq: int, flags: int, plain) -> None:
        """Append under self.lock, evicting oldest past either budget.
        The newest entry is never evicted — send_payload's RINGED
        contract promises the just-appended frame is replayable, so one
        oversized frame may transiently exceed the byte budget rather
        than be silently lost."""
        self.ring.append((seq, flags, plain))
        self.ring_bytes += _payload_nbytes(plain)
        while len(self.ring) > 1 and (len(self.ring) > _RING_MAX or
                                      self.ring_bytes > _RING_MAX_BYTES):
            self.ring_bytes -= _payload_nbytes(self.ring.popleft()[2])

    def ring_floor(self) -> int:
        return self.ring[0][0] if self.ring else self.send_seq + 1

    def ring_drop(self, seq: int) -> None:
        """Remove one entry (a frame the caller delivered another way —
        a later resume replay must not deliver it twice)."""
        with self.lock:
            for item in list(self.ring):
                if item[0] == seq:
                    self.ring.remove(item)
                    self.ring_bytes -= _payload_nbytes(item[2])
                    return


class _Conn:
    """One live connection + send lock (shared by both directions).
    Holds a TRANSPORT (stack.py) rather than a raw socket; a raw
    socket is accepted and wrapped as a posix transport so handshake
    code and tests can build one directly."""

    __slots__ = ("t", "lock", "alive", "session_key", "state",
                 "enc_send", "enc_recv", "enc_send_n", "enc_recv_n")

    def __init__(self, sock):
        self.t = (sock if hasattr(sock, "sendv")
                  else PosixTransport(sock))
        self.lock = threading.Lock()
        self.alive = True
        self.session_key: bytes | None = None  # cephx-lite session
        self.state: _SessState | None = None   # resume session
        # secure-mode per-direction cipher keys + frame counters
        self.enc_send: bytes | None = None
        self.enc_recv: bytes | None = None
        self.enc_send_n = 0
        self.enc_recv_n = 0

    @property
    def sock(self) -> socket.socket:
        """The underlying socket — handshakes (auth, session resume)
        run on it directly, before the stack's framed fast path is
        activated."""
        return self.t.sock

    @sock.setter
    def sock(self, sock) -> None:
        # tests swap the socket out from under a live conn; rewrap it
        self.t = (sock if hasattr(sock, "sendv")
                  else PosixTransport(sock, sink=getattr(
                      self.t, "sink", None)))

    def arm_secure(self, role: str) -> None:
        """Derive per-direction ChaCha20 keys from the cephx session key
        (crypto_onwire rx/tx stream role).  role: "c" connector."""
        a = _mac(self.session_key, b"enc-c2s")
        b = _mac(self.session_key, b"enc-s2c")
        self.enc_send, self.enc_recv = (a, b) if role == "c" else (b, a)

    def seal_segments(self, segs: list) -> tuple[list, int, int]:
        """Seal a frame held as a segment list.  Plaintext and
        auth-only (HMAC) modes never assemble — the MAC folds over the
        segments incrementally and rides as one more segment.  Secure
        mode is the ONLY Python-side assembly point on the tx path:
        the join + cipher output are the (counted) flatten copies.
        Returns (sealed_segments, flattened_bytes, flatten_copies)."""
        flat_b = flat_c = 0
        if self.enc_send is not None:
            from ..ops.native import chacha20_xor
            if len(segs) == 1:
                plain = segs[0]
                if not isinstance(plain, bytes):
                    # the cipher detaches non-bytes input internally —
                    # count that copy too (honest counters)
                    flat_b += len(plain)
                    flat_c += 1
            else:
                plain = b"".join(segs)
                flat_b += len(plain)
                flat_c += 1
            nonce = b"\x00" * 4 + self.enc_send_n.to_bytes(8, "little")
            self.enc_send_n += 1
            sealed = chacha20_xor(self.enc_send, nonce, plain)
            flat_b += len(sealed)
            flat_c += 1
            segs = [sealed]
        if self.session_key is not None:
            h = hmac.new(self.session_key, digestmod=hashlib.sha256)
            for s in segs:
                h.update(s)
            segs = list(segs) + [h.digest()[:_TAG_LEN]]
        return segs, flat_b, flat_c

    def unseal(self, payload) -> bytes | memoryview | None:
        """Verify-and-strip the MAC tag (a zero-copy slice) + decrypt
        (secure mode: a fresh plaintext buffer).  Accepts bytes or a
        memoryview over the receive buffer."""
        if self.session_key is not None:
            if len(payload) < _TAG_LEN:
                return None
            payload, tag = payload[:-_TAG_LEN], payload[-_TAG_LEN:]
            # digest the buffer in place (no b"".join materialization:
            # auth-only rx stays genuinely zero-copy, like the tx MAC)
            want = hmac.new(self.session_key, payload,
                            hashlib.sha256).digest()[:_TAG_LEN]
            if not hmac.compare_digest(bytes(tag), want):
                return None
        if self.enc_recv is not None:
            from ..ops.native import chacha20_xor
            nonce = b"\x00" * 4 + self.enc_recv_n.to_bytes(8, "little")
            self.enc_recv_n += 1
            payload = chacha20_xor(self.enc_recv, nonce, payload)
        return payload

    SENT, DEAD, RINGED = 1, 0, -1

    def send_payload(self, flags: int, plain,
                     on_flatten=None) -> tuple[int, int]:
        """Sequence (resume mode), seal, frame, send — atomically, so
        seq order on the wire matches ring order.  ``plain`` is bytes
        or a LIST of bytes-like segments; segments go to the socket via
        vectored sendmsg without assembly (the resume ring references
        them too — callers must not mutate referenced buffers after
        submitting, and a ringed bytearray cannot be RESIZED until the
        ring evicts it: BufferError by design, not silent replay
        corruption).  ``on_flatten(nbytes, copies)`` is invoked when
        sealing had to assemble (secure mode).  Returns (rc, seq):
        SENT; DEAD (nothing ringed); or RINGED (seq is in the ring but
        the socket died — a session resume will replay it; the caller
        must either trust the replay OR ring_drop(seq) before sending
        the frame any other way, or the peer gets it twice)."""
        segs = ([plain] if isinstance(plain, (bytes, bytearray,
                                              memoryview))
                else list(plain))
        with self.lock:
            if not self.alive:
                return self.DEAD, 0
            seq = 0
            if self.state is not None:
                with self.state.lock:
                    self.state.send_seq += 1
                    seq = self.state.send_seq
                    self.state.ring_append(seq, flags, tuple(segs))
                segs = [struct.pack("<Q", seq)] + segs
            segs, flat_b, flat_c = self.seal_segments(segs)
            total = sum(len(s) for s in segs)
            if len(segs) > 1 and not self.t.vectored:
                # no vectored IO on this transport: the sendv fallback
                # joins the frame — count the assembly
                flat_b += total
                flat_c += 1
            if flat_c and on_flatten is not None:
                on_flatten(flat_b, flat_c)
            try:
                self.t.sendv(
                    [struct.pack("<I", total | flags)] + segs)
                return self.SENT, seq
            except OSError:
                self.alive = False
                return (self.RINGED if seq else self.DEAD), seq

    def replay_from(self, last_recv: int, on_flatten=None) -> bool:
        """Resend ring entries the peer never saw (resume replay).
        ``on_flatten`` keeps replayed assemblies visible on the same
        copy counters as first sends.  Attribution caveat: the ring
        does not record each frame's original sender, so replay copies
        book against the entity whose reconnect drove the resume (the
        dialing sender client-side, the listener owner server-side) —
        an approximation on shared connections, acceptable because the
        counters exist to catch hot-path copies, not to bill the rare
        reconnect burst."""
        with self.lock:
            if not self.alive or self.state is None:
                return False
            with self.state.lock:
                pending = list(self.state.ring)
            no_vec = not self.t.vectored
            for seq, flags, plain in pending:
                if seq <= last_recv:
                    continue
                segs = (list(plain) if isinstance(plain, tuple)
                        else [plain])
                segs, flat_b, flat_c = self.seal_segments(
                    [struct.pack("<Q", seq)] + segs)
                total = sum(len(s) for s in segs)
                if no_vec and len(segs) > 1:
                    # the fallback join below is an assembly too
                    flat_b += total
                    flat_c += 1
                if flat_c and on_flatten is not None:
                    on_flatten(flat_b, flat_c)
                try:
                    self.t.sendv(
                        [struct.pack("<I", total | flags)] + segs)
                except OSError:
                    self.alive = False
                    return False
            return True

    def close(self) -> None:
        self.alive = False
        self.t.close()


_COMPRESSED = 0x8000_0000  # frame-length flag bit (msgr v2
# compression_onwire role: payload compressed, u32 raw length follows)


class TcpNetwork(Network):
    def __init__(self, host: str = "127.0.0.1", seed: int = 0,
                 compress: str = "none", compress_min: int = 4096,
                 auth_secret: bytes | None = None,
                 secure: bool = False, resume: bool = True,
                 auth_rotation: float = 0.0, clock=None,
                 stack: str = "posix"):
        super().__init__(seed)
        self._host = host
        # pluggable transport stack (ms_stack: posix|uring|auto); an
        # unsatisfiable request degrades to posix with a logged event
        # and the reason recorded — byte-identical wire either way
        self._stack, self.stack_fallback = make_stack(stack)
        self.stack_name = self._stack.name
        # msgr2 secure mode (crypto_onwire role): ChaCha20 per-direction
        # streams keyed from the cephx session key, under the existing
        # per-frame HMAC tag (encrypt-then-MAC)
        if secure and auth_secret is None:
            raise ValueError("secure mode requires auth_secret")
        self._secure = secure
        # ProtocolV2 session resume: sequenced frames + replay ring; a
        # reconnect replays the tail the peer never received
        self._resume = resume
        self._stash: dict[bytes, _SessState] = {}   # cookie -> dead sess
        # live server-side sessions: a reconnect may arrive BEFORE the
        # zombie connection's read loop has noticed the death and
        # stashed its state — resume takes over from the live table too
        self._states: dict[bytes, tuple[_SessState, "_Conn"]] = {}
        self._by_addr: dict[str, tuple[bytes, _SessState]] = {}
        # ^ client side: addr -> (server_cookie, my session state)
        self.resumed = 0  # observability: successful resumes
        # cephx-lite (src/auth/cephx role): shared-secret mutual
        # challenge/response on connect derives a per-connection session
        # key; every frame carries a truncated HMAC tag under it.  A
        # peer without the secret can neither connect nor forge frames.
        self._auth_secret = auth_secret
        # rotating service keys (CephxKeyServer.h:165 role): the wire
        # secret is a per-GENERATION key derived from the base secret,
        # generations advance every auth_rotation seconds, and only the
        # current one +- one grace generation authenticates — so a
        # captured per-epoch key (or a ticket minted under it) ages out
        # instead of working forever.  Deployment difference vs the
        # reference, stated plainly: real cephx distributes fresh RANDOM
        # rotating keys from the monitor; with one pre-shared secret the
        # epochs are HKDF-derived from it, which bounds key/ticket
        # lifetime but cannot survive base-secret compromise.
        self._auth_rotation = float(auth_rotation or 0.0)
        self._auth_clock = clock or time.time
        # on-wire compression (ProtocolV2 compression_onwire role):
        # config-driven algorithm, applied to frames past the threshold;
        # both endpoints of a deployment share the setting
        self._compressor = None
        self._compress_min = compress_min
        if compress and compress != "none":
            from ..compress import factory as _cfactory
            self._compressor = _cfactory(compress)
        self._listeners: dict[str, socket.socket] = {}
        self._addrs: dict[str, str] = {}   # entity -> "host:port"
        self._routes: dict[str, _Conn] = {}  # learned reply routes
        self._out: dict[str, _Conn] = {}     # outgoing conns by addr
        self._net_lock = threading.RLock()
        # serializes dialing PER ADDRESS: two racing connects must not
        # both adopt (and replay) the same resumable session state; a
        # global lock would let one unreachable peer stall every dial
        self._dial_locks: dict[str, threading.Lock] = {}
        self._stopping = False

    # -- registry / addressing --------------------------------------------
    def register(self, m) -> None:
        super().register(m)
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self._host, 0))
        ls.listen(64)
        port = ls.getsockname()[1]
        with self._net_lock:
            self._listeners[m.name] = ls
            self._addrs[m.name] = f"{self._host}:{port}"
        threading.Thread(target=self._accept_loop, args=(m.name, ls),
                         name=f"tcp-accept-{m.name}", daemon=True).start()

    def unregister(self, name: str) -> None:
        super().unregister(name)
        with self._net_lock:
            ls = self._listeners.pop(name, None)
        if ls is not None:
            try:
                ls.close()
            except OSError:
                pass

    def addr_of(self, name: str) -> str:
        with self._net_lock:
            return self._addrs.get(name, name)

    def set_addr(self, name: str, addr: str) -> None:
        if addr and ":" in addr:
            with self._net_lock:
                self._addrs[name] = addr

    def stop(self) -> None:
        self._stopping = True
        with self._net_lock:
            conns = list(self._out.values()) + list(self._routes.values())
            listeners = list(self._listeners.values())
            self._out.clear()
            self._routes.clear()
            self._listeners.clear()
        for ls in listeners:
            try:
                ls.close()
            except OSError:
                pass
        for c in conns:
            c.close()

    # -- cephx-lite handshake ---------------------------------------------
    def _auth_generation(self) -> int:
        if self._auth_rotation <= 0:
            return 0
        return int(self._auth_clock() // self._auth_rotation)

    def _epoch_secret(self, gen: int) -> bytes:
        """The per-generation service key (rotating-key derivation)."""
        if self._auth_rotation <= 0:
            return self._auth_secret
        return _mac(self._auth_secret, b"rot",
                    gen.to_bytes(8, "little"))

    def _auth_server(self, sock: socket.socket) -> bytes | None:
        """Server leg of the challenge/response; returns the session key
        or None on failure.  The client names its key GENERATION in the
        hello; only the current generation +- one authenticates (expired
        tickets are refused, the rotating-secrets window)."""
        sock.settimeout(5)
        try:
            hello = _recv_exact(sock, len(_AUTH_MAGIC) + 8 + 16)
            if hello is None or not hello.startswith(_AUTH_MAGIC):
                return None
            gen = int.from_bytes(
                hello[len(_AUTH_MAGIC):len(_AUTH_MAGIC) + 8], "little")
            if self._auth_rotation > 0 and \
                    abs(gen - self._auth_generation()) > 1:
                return None  # expired (or far-future) generation
            key = self._epoch_secret(gen)
            nonce_c = hello[len(_AUTH_MAGIC) + 8:]
            nonce_s = _secrets.token_bytes(16)
            sock.sendall(nonce_s + _mac(key, b"srv", nonce_c, nonce_s))
            proof = _recv_exact(sock, 32)
            want = _mac(key, b"cli", nonce_s, nonce_c)
            if proof is None or not hmac.compare_digest(proof, want):
                return None
            return _mac(key, b"ses", nonce_c, nonce_s)
        except OSError:
            return None
        finally:
            sock.settimeout(None)

    def _auth_client(self, sock: socket.socket) -> bytes | None:
        sock.settimeout(5)
        try:
            gen = self._auth_generation()
            key = self._epoch_secret(gen)
            nonce_c = _secrets.token_bytes(16)
            sock.sendall(_AUTH_MAGIC + gen.to_bytes(8, "little")
                         + nonce_c)
            reply = _recv_exact(sock, 16 + 32)
            if reply is None:
                return None
            nonce_s, proof = reply[:16], reply[16:]
            want = _mac(key, b"srv", nonce_c, nonce_s)
            if not hmac.compare_digest(proof, want):
                return None
            sock.sendall(_mac(key, b"cli", nonce_s, nonce_c))
            return _mac(key, b"ses", nonce_c, nonce_s)
        except OSError:
            return None
        finally:
            sock.settimeout(None)

    # -- receive side ------------------------------------------------------
    def _accept_loop(self, owner: str, ls: socket.socket) -> None:
        while not self._stopping:
            try:
                sock, _peer = ls.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(sock, owner),
                             name=f"tcp-read-{owner}", daemon=True).start()

    def _serve_conn(self, sock: socket.socket, owner: str) -> None:
        conn = _Conn(self._stack.wrap(sock))
        if self._auth_secret is not None:
            key = self._auth_server(sock)
            if key is None:
                dout("msg", 1)("tcp %s: auth handshake failed", owner)
                conn.close()
                return
            conn.session_key = key
            if self._secure:
                conn.arm_secure("s")
        if self._resume and not self._resume_server(conn, owner):
            conn.close()
            return
        # handshakes done: upgrade to the stack's framed fast path
        # (posix: identity; uring: rings + registered buffers).  Sends
        # on this conn are replies from the listener's owner — book
        # their tx syscalls there.
        conn.t = self._stack.activate(conn.t, self._perf_sink(owner))
        self._read_loop(conn)

    def _perf_flatten(self, name: str):
        """Flatten-counter callback booked against a local entity's
        messenger registry (None when the entity is not local)."""
        m = self.lookup(name)
        if m is None:
            return None

        def flatten(nbytes: int, copies: int = 1) -> None:
            m.perf.inc("msg_tx_flatten_bytes", nbytes)
            m.perf.inc("msg_tx_flatten_copies", copies)
        return flatten

    def _perf_sink(self, name: str | None):
        """Transport syscall-counter callback booked against a local
        entity's messenger registry (None when not local) — the tx
        half of the stack telemetry (msg_syscalls_tx and friends)."""
        m = self.lookup(name) if name else None
        if m is None:
            return None
        perf = m.perf

        def sink(counter: str, n: int) -> None:
            perf.inc(counter, n)
        return sink

    # -- session resume handshake -----------------------------------------
    # client: RESM | peer_cookie(16, zeros=fresh) | last_recv(u64)
    # server: RESM | my_cookie(16) | flag(u8: 1=resumed) | last_recv(u64)
    # On resume both sides replay ring entries past the peer's last_recv.
    def _resume_server(self, conn: _Conn, owner: str | None = None) -> bool:
        sock = conn.sock
        sock.settimeout(5)
        try:
            blk = _recv_exact(sock, len(_RESM_MAGIC) + 16 + 8)
            if blk is None or not blk.startswith(_RESM_MAGIC):
                return False
            peer_cookie = blk[len(_RESM_MAGIC):len(_RESM_MAGIC) + 16]
            (last_recv,) = struct.unpack("<Q", blk[-8:])
            state = None
            zombie = None
            with self._net_lock:
                prev = self._stash.pop(peer_cookie, None)
                if prev is None and peer_cookie in self._states:
                    # takeover: the old conn hasn't died visibly yet
                    prev, zombie = self._states.pop(peer_cookie)
                    zombie.state = None  # its cleanup must not stash
                if prev is not None and last_recv + 1 >= \
                        prev.ring_floor():
                    state = prev
            if zombie is not None:
                zombie.close()
            resumed = state is not None
            if state is None:
                state = _SessState()
            conn.state = state
            with self._net_lock:
                self._states[state.cookie] = (state, conn)
            sock.sendall(_RESM_MAGIC + state.cookie
                         + bytes([1 if resumed else 0])
                         + struct.pack("<Q", state.recv_seq))
            if resumed:
                self.resumed += 1
                conn.replay_from(
                    last_recv,
                    on_flatten=self._perf_flatten(owner)
                    if owner else None)
            return True
        except OSError:
            return False
        finally:
            sock.settimeout(None)

    def _resume_client(self, conn: _Conn, addr: str,
                       on_flatten=None) -> bool:
        sock = conn.sock
        sock.settimeout(5)
        try:
            with self._net_lock:
                prev = self._by_addr.get(addr)
            cookie = prev[0] if prev else b"\x00" * 16
            state = prev[1] if prev else _SessState()
            sock.sendall(_RESM_MAGIC + cookie
                         + struct.pack("<Q", state.recv_seq))
            blk = _recv_exact(sock, len(_RESM_MAGIC) + 16 + 1 + 8)
            if blk is None or not blk.startswith(_RESM_MAGIC):
                return False
            srv_cookie = blk[len(_RESM_MAGIC):len(_RESM_MAGIC) + 16]
            resumed = blk[len(_RESM_MAGIC) + 16] == 1
            (srv_last,) = struct.unpack("<Q", blk[-8:])
            if not resumed:
                state = _SessState()  # server lost us: fresh numbering
            conn.state = state
            with self._net_lock:
                self._by_addr[addr] = (srv_cookie, state)
            if resumed:
                self.resumed += 1
                conn.replay_from(srv_last, on_flatten=on_flatten)
            return True
        except OSError:
            return False
        finally:
            sock.settimeout(None)

    MAX_FRAME = 256 << 20  # recovery pushes batch objects; cap garbage

    def _read_loop(self, conn: _Conn) -> None:
        t = conn.t
        head = memoryview(bytearray(4))
        # small-frame reuse buffer: acks/heartbeats/map chatter recv
        # into ONE buffer (no per-frame alloc) and decode fully
        # detached; payload-bearing frames (> _RECV_REUSE_MAX) recv
        # into a transport-provided FRESH buffer (posix: heap; uring: a
        # registered-pool slice) so decode can carve zero-copy views
        # over it — the views refcount-pin the buffer, and this loop
        # never touches it again (the carve ownership contract)
        reuse = memoryview(bytearray(_RECV_REUSE_MAX))
        rx_ctr = t.rx_counters
        while not self._stopping and conn.alive:
            sys0 = rx_ctr["msg_syscalls_rx"]
            rec0 = rx_ctr["msg_uring_reg_buf_recycled"]
            if not t.recv_head(head):
                break
            (length,) = struct.unpack("<I", head)
            compressed = bool(length & _COMPRESSED)
            length &= ~_COMPRESSED
            if length > self.MAX_FRAME:
                # a non-protocol peer (port scan, probe): drop before
                # attempting a multi-GB buffer
                dout("msg", 1)("tcp: oversized frame header (%d)", length)
                break
            if length <= _RECV_REUSE_MAX:
                mv = reuse[:length]
                owned = False  # reused next frame: decode must detach
            else:
                mv = t.get_rx_buffer(length)
                owned = True   # fresh buffer: decode may carve views
            if not t.recv_body(mv):
                break
            rx_b = rx_c = 0  # receive-side payload copies (counted)
            # verify-and-strip signature + decrypt (cephx signing /
            # secure-mode stream); the tag strip is a zero-copy slice,
            # the decrypt materializes a fresh owned buffer
            payload = conn.unseal(mv.toreadonly())
            if payload is None:
                dout("msg", 0)("tcp: BAD frame signature; dropping "
                               "connection")
                break
            if conn.enc_recv is not None:
                rx_b += len(payload)
                rx_c += 1
                payload = memoryview(payload)
                owned = True
            # snapshot: a resume takeover may null conn.state mid-frame
            state = conn.state
            if state is not None:
                if len(payload) < 8:
                    break
                (seq,) = struct.unpack("<Q", payload[:8])
                payload = payload[8:]
                if seq <= state.recv_seq:
                    continue  # resume replay of a frame we already have
                if seq != state.recv_seq + 1:
                    # a hole the wire can't have produced: the sender
                    # lied/lost frames — force a reconnect+resume
                    dout("msg", 1)("tcp: seq gap (%d after %d)", seq,
                                   state.recv_seq)
                    break
                state.recv_seq = seq
            if compressed:
                if self._compressor is None or len(payload) < 4:
                    dout("msg", 1)("tcp: compressed frame but no "
                                   "compressor configured")
                    break
                (rawlen,) = struct.unpack("<I", payload[:4])
                if rawlen > self.MAX_FRAME:
                    dout("msg", 1)("tcp: oversized decompressed frame "
                                   "(%d)", rawlen)
                    break
                try:
                    payload = self._compressor.decompress(
                        payload[4:], max_out=rawlen)
                except Exception as e:  # noqa: BLE001 - bad peer data
                    dout("msg", 1)("tcp: undecompressable frame: %r", e)
                    break
                if len(payload) != rawlen:
                    dout("msg", 1)("tcp: decompressed size mismatch")
                    break
                rx_b += rawlen
                rx_c += 1
                owned = True  # decompression output: a fresh buffer
            try:
                # carve-on-decode only over buffers this loop will
                # never reuse; the reuse-buffer path detaches
                src, dst, msg = decode_frame(
                    payload, carve_min=SEG_REF_MIN if owned else 0)
            except Exception as e:  # noqa: BLE001 - poisoned frame
                dout("msg", 0)("tcp: undecodable frame: %r", e)
                break
            with self._net_lock:
                self._routes[src] = conn  # answer on the inbound pipe
            target = self.lookup(dst)
            if target is not None and not target._stopped:
                if rx_c:
                    target.perf.inc("msg_rx_copy_bytes", rx_b)
                    target.perf.inc("msg_rx_copy_copies", rx_c)
                d_sys = rx_ctr["msg_syscalls_rx"] - sys0
                d_rec = rx_ctr["msg_uring_reg_buf_recycled"] - rec0
                if d_sys:
                    target.perf.inc("msg_syscalls_rx", d_sys)
                if d_rec:
                    target.perf.inc("msg_uring_reg_buf_recycled", d_rec)
                target._enqueue(src, msg)
            else:
                dout("msg", 10)("tcp: no local entity %s for %s", dst,
                                type(msg).__name__)
        conn.close()
        t.release_rx()  # this thread is the rx ring's only user
        with self._net_lock:
            for k in [k for k, v in self._routes.items() if v is conn]:
                del self._routes[k]
            state = conn.state
            if state is not None and \
                    self._states.get(state.cookie, (None, None))[1] is conn:
                # stash for resume; bounded (oldest evicted).  Only
                # server-registered sessions: a client-side state is
                # resumed via _by_addr, and stashing its (peer-unknown)
                # cookie would evict genuinely resumable sessions
                del self._states[state.cookie]
                self._stash[state.cookie] = state
                while len(self._stash) > _STASH_MAX:
                    self._stash.pop(next(iter(self._stash)))

    # -- send side ---------------------------------------------------------
    def _connect(self, addr: str, on_flatten=None,
                 src: str | None = None) -> _Conn | None:
        host, _, port = addr.rpartition(":")
        try:
            sock = socket.create_connection((host, int(port)), timeout=5)
        except OSError:
            return None
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(self._stack.wrap(sock))
        if self._auth_secret is not None:
            key = self._auth_client(sock)
            if key is None:
                dout("msg", 1)("tcp: auth to %s failed", addr)
                conn.close()
                return None
            conn.session_key = key
            if self._secure:
                conn.arm_secure("c")
        if self._resume and not self._resume_client(conn, addr,
                                                    on_flatten):
            dout("msg", 1)("tcp: resume handshake to %s failed", addr)
            conn.close()
            return None
        # handshakes (and any resume replay) done on the blocking
        # socket: upgrade to the stack's framed fast path.  Tx syscalls
        # book against the dialing entity — exact for dedicated pipes,
        # an attribution approximation on shared ones (same caveat as
        # replay_from's flatten booking).
        conn.t = self._stack.activate(conn.t, self._perf_sink(src))
        # outgoing pipes are bidirectional: replies come back on them
        threading.Thread(target=self._read_loop, args=(conn,),
                         name=f"tcp-read-out-{addr}", daemon=True).start()
        return conn

    def _conn_for(self, dst: str, on_flatten=None,
                  src: str | None = None) -> _Conn | None:
        with self._net_lock:
            route = self._routes.get(dst)
            if route is not None and route.alive:
                return route
            addr = self._addrs.get(dst)
            if addr is None:
                return None
            conn = self._out.get(addr)
            if conn is not None and conn.alive:
                return conn
        with self._net_lock:
            dial = self._dial_locks.setdefault(addr, threading.Lock())
        with dial:
            with self._net_lock:  # re-check under the dial lock
                conn = self._out.get(addr)
                if conn is not None and conn.alive:
                    return conn
            conn = self._connect(addr, on_flatten, src)
            if conn is None:
                return None
            with self._net_lock:
                self._out[addr] = conn
        return conn

    def deliver(self, src: str, dst: str, msg) -> bool:
        if self._stopping:
            return False
        # same-process shortcut ONLY to detect stopped local targets the
        # way LocalNetwork does; data still rides the socket
        if self._blocked(src, dst):
            self.note_wire_drop(dst)
            dout("msg", 10)("dropped %s -> %s: %s", src, dst,
                            type(msg).__name__)
            return True  # silently dropped, like a lossy wire
        if self.latency:
            time.sleep(self.latency)
        # segmented framing: large data payloads ride the segment list
        # by reference — in plaintext/auth modes they reach sendmsg
        # with ZERO Python-side assembly (msg_tx_flatten_* counts every
        # copy the frame does take: compression join, secure-mode seal)
        enc = frame_encoder(src, dst, msg)
        total = enc.nbytes
        sender = self.lookup(src)
        perf = sender.perf if sender is not None else None

        def flatten(nbytes: int, copies: int = 1) -> None:
            if perf is not None:
                perf.inc("msg_tx_flatten_bytes", nbytes)
                perf.inc("msg_tx_flatten_copies", copies)

        flags = 0
        if self._compressor is not None and total >= self._compress_min:
            payload = enc.tobytes()
            flatten(total)  # compression needs contiguous input
            packed = self._compressor.compress(payload)
            if len(packed) + 4 < len(payload):  # only when it wins
                segs = [struct.pack("<I", total), packed]
                flags = _COMPRESSED
            else:
                segs = [payload]
        else:
            segs = enc.segments()
        conn = self._conn_for(dst, flatten, src)
        if conn is None:
            return False
        rc, seq = conn.send_payload(flags, segs, on_flatten=flatten)
        if rc == _Conn.SENT:
            return True
        old_state = conn.state
        # stale cached pipe: retry once on a fresh connection (which
        # resumes the session and replays the ring tail)
        with self._net_lock:
            for table in (self._routes, self._out):
                for k in [k for k, v in table.items() if v is conn]:
                    del table[k]
        conn2 = self._conn_for(dst, flatten, src)
        if conn2 is None:
            return False
        if rc == _Conn.RINGED:
            if conn2.state is old_state:
                # the frame rode the resume replay — re-sending would
                # duplicate it under a fresh seq
                return True
            # sending via a DIFFERENT session (e.g. an inbound route):
            # pull the frame out of the old ring or a later resume of
            # that session would deliver it a second time
            old_state.ring_drop(seq)
        return conn2.send_payload(flags, segs,
                                  on_flatten=flatten)[0] == _Conn.SENT
