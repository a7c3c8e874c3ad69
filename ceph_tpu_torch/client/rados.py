"""RadosClient: the librados-shaped client + objecter.

The capability of the reference's client stack (librados IoCtx API
src/librados/librados_c.cc; Objecter op engine src/osdc/Objecter.cc:
op_submit :2412 -> _calc_target :3082 computes the PG/primary from the
osdmap via CRUSH -> _send_op :3597, resend on map change): the client
subscribes to the monitor for maps, computes placement itself (pure
function of the map — no lookup service), sends MOSDOp to the primary,
and retries with a refreshed map on ESTALE/timeout.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import zlib

from ..mon.maps import OSDMap
from ..auth.cephx import AuthContext, canonical_command, op_proof
from ..msg.messages import (MAuth, MAuthReply, MMapPush, MMonCommand,
                            MMonCommandReply, MPGList, MPGListReply,
                            MMonSubscribe, MOSDOp, MOSDOpReply, MScrubRequest,
                            MScrubResult, PgId, MNotifyAck, MWatchNotify)
from ..msg.messenger import Dispatcher, Messenger, Network, Policy
from ..msg.wire import pack_value, unpack_value
from ..utils.log import dout


class RadosError(Exception):
    def __init__(self, code: int, what: str = ""):
        super().__init__(f"rados error {code}: {what}")
        self.code = code


class TimeoutError_(RadosError):
    def __init__(self, what: str):
        super().__init__(-110, what)  # ETIMEDOUT


class Completion:
    """The rados_completion_t shape: poll, wait, or get a callback."""

    def __init__(self, callback=None):
        self._ev = threading.Event()
        self._cb = callback
        self._result = None
        self._error: RadosError | None = None

    def _finish(self, result, error) -> None:
        self._result, self._error = result, error
        self._ev.set()
        if self._cb is not None:
            try:
                self._cb(self)
            except Exception:  # noqa: BLE001 - user callback must not kill aio
                pass

    def is_complete(self) -> bool:
        return self._ev.is_set()

    def wait_for_complete(self, timeout: float | None = None) -> bool:
        return self._ev.wait(timeout)

    def get_return_value(self):
        """Result on success; raises the op's RadosError on failure
        (the C API returns negative errno; exceptions are this client's
        error convention throughout)."""
        if not self._ev.is_set():
            raise RadosError(-11, "aio not complete")
        if self._error is not None:
            raise self._error
        return self._result


class RadosClient(Dispatcher):
    def __init__(self, network: Network, name: str = "client.0",
                 mon: str = "mon.0", timeout: float = 10.0,
                 mons: list | None = None,
                 auth_entity: str | None = None,
                 auth_key: bytes | None = None,
                 tenant: str | None = None,
                 lease_cache_bytes: int = 16 << 20):
        self.name = name
        # balanced-read spread: a stable per-client nonce folded into
        # the shard-holder pick, so different clients fan one hot
        # object across different holders while ONE client stays
        # sticky (cache-friendly on the serving OSD)
        self._client_nonce = zlib.crc32(name.encode())
        # lease-covered object bytes: byte-budgeted LRU; repeat reads
        # under a live lease are served HERE — zero RADOS ops.  Keys
        # are (pool_id, oid) for whole-object entries and (pool_id,
        # oid, offset, length) for ranged entries riding the object's
        # grant; _lease_index maps (pool_id, oid) -> its range keys so
        # one revoke drops every entry.  Dropped on the server's
        # "_lease" write-revoke notify, on this client's own writes,
        # and at expiry (the hard staleness bound).
        self._lease_cache: collections.OrderedDict = \
            collections.OrderedDict()
        self._lease_index: dict[tuple, set] = {}
        self._lease_cache_bytes = 0
        self._lease_cache_max = int(lease_cache_bytes)
        self._lease_lock = threading.Lock()
        self.lease_hits = 0
        self.lease_misses = 0
        # fault injection for tests: swallow "_lease" revoke notifies
        # (the client then serves staleness bounded by the lease TTL)
        self.drop_lease_revokes = False
        # multi-tenant QoS identity (qos/dmclock.py): with a tenant
        # set, every op carries dmclock (delta, rho) tags computed by
        # a per-client ServiceTracker and the tenant name, and every
        # reply's served-phase feeds the tracker back — the client
        # half of per-tenant mclock shaping.  None = untagged ops
        # (the default stream), zero per-op cost.
        self.tenant = tenant or None
        if self.tenant:
            from ..qos.dmclock import ServiceTracker
            self.qos_tracker: ServiceTracker | None = ServiceTracker()
        else:
            self.qos_tracker = None
        # cephx identity (CephXTicketManager role): with a key, every
        # op carries a mon-issued ticket + proof; tickets renew
        # automatically as they approach expiry
        self.auth = (AuthContext(auth_entity or name, auth_key)
                     if auth_key is not None else None)
        self._auth_ttl = 0.0
        self._auth_refreshed_at = float("-inf")
        self._auth_no_caps: set = set()
        self._auth_lock = threading.Lock()
        self.mons = list(mons) if mons else [mon]
        self.mon = self.mons[0]
        self._mon_idx = 0
        self.timeout = timeout
        self.messenger = Messenger(network, name, Policy.lossless_peer())
        self.messenger.add_dispatcher(self)
        self.osdmap: OSDMap | None = None
        self._tids = itertools.count(1)
        # per-pool write SnapContext: pool_id -> (seq, [snap ids desc])
        self._snapc: dict[int, tuple[int, list]] = {}
        self._waiters: dict[int, threading.Event] = {}
        self._replies: dict[int, object] = {}
        self._map_cond = threading.Condition()
        # (pool_id, oid) -> (callback, cookie) — re-asserted on map change
        self._watches: dict[tuple, tuple] = {}
        self._cookies = itertools.count(1)
        self._watch_renewer = None
        self._closed = False
        from ..utils.tracer import Tracer
        self.tracer = Tracer(name)
        # tracing switches: `tracing` forces a span on EVERY op (the
        # debugging mode); otherwise the tracer's sample_rate head-
        # samples roots (trace_sample_rate — the always-on mode; the
        # harness seeds it from config, tracer.set_sample_rate retunes)
        self.tracing = False  # per-client switch: ops carry spans
        self._aio_exec = None
        self._aio_init_lock = threading.Lock()
        self._aio_outstanding: set = set()

    # ------------------------------------------------------------ lifecycle
    def connect(self) -> "RadosClient":
        self.messenger.start()
        deadline = time.time() + self.timeout
        while True:
            self.messenger.send_message(self.mon, MMonSubscribe("osdmap"))
            with self._map_cond:
                # wait for a POPULATED map (monitors push epoch-0 empty
                # maps to unwedge cold daemons; clients keep waiting)
                if self._map_cond.wait_for(
                        lambda: self.osdmap is not None
                        and self.osdmap.epoch > 0,
                        timeout=min(2.0, self.timeout)):
                    return self
            if time.time() > deadline:
                raise TimeoutError_("no osdmap from any monitor")
            self._rotate_mon()

    def _rotate_mon(self) -> None:
        self._mon_idx += 1
        self.mon = self.mons[self._mon_idx % len(self.mons)]
        # keep the map feed alive: the previous mon may be the dead one
        # we were subscribed to
        self.messenger.send_message(self.mon, MMonSubscribe("osdmap"))

    def close(self) -> None:
        self._closed = True
        if getattr(self, "_aio_exec", None) is not None:
            self._aio_exec.shutdown(wait=False)
        self.messenger.shutdown()

    # ------------------------------------------------------------- dispatch
    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MMapPush):
            changed = False
            with self._map_cond:
                from ..mon.maps import apply_map_push
                m, request = apply_map_push(self.osdmap, msg)
                if request == "full":
                    self.messenger.send_message(
                        self.mon, MMonSubscribe("osdmap"))
                elif request == "chain":
                    self.messenger.send_message(
                        self.mon,
                        MMonSubscribe("osdmap",
                                      have_epoch=self.osdmap.epoch))
                if m is not None and (self.osdmap is None
                                      or m.epoch > self.osdmap.epoch):
                    self.osdmap = m
                    changed = True
                    # the OSDMap is the address book (as in the
                    # reference): a STANDALONE client on a fresh wire
                    # transport learns daemon endpoints from it (no-op
                    # on the in-proc network / shared addr books)
                    net = self.messenger.network
                    for peer, info in m.osds.items():
                        if getattr(info, "addr", ""):
                            net.set_addr(f"osd.{peer}", info.addr)
                self._map_cond.notify_all()
            if changed and self._watches:
                # linger-op role: watches are primary-local soft state,
                # re-assert them after any map change
                self._reregister_watches()
            return True
        if isinstance(msg, MWatchNotify):
            if msg.notifier == "_lease":
                # server-side write revoke of a read lease: drop the
                # cached object bytes so the next read goes to RADOS.
                # notify_id 0 carries no ack collection server-side,
                # but ack anyway — harmless, and symmetric with real
                # notifies.  Fault-injection hook: tests set
                # drop_lease_revokes to model a LOST revoke; staleness
                # is then bounded by the lease TTL.
                if not self.drop_lease_revokes:
                    self._lease_drop(msg.pool, msg.oid)
                conn.send(MNotifyAck(msg.notify_id, self.name))
                return True
            cb = self._watches.get((msg.pool, msg.oid), (None, 0))[0]
            try:
                if cb is not None:
                    cb(msg.oid, msg.notifier, msg.payload)
            finally:
                conn.send(MNotifyAck(msg.notify_id, self.name))
            return True
        if isinstance(msg, (MOSDOpReply, MMonCommandReply, MScrubResult,
                            MAuthReply, MPGListReply)):
            ev = self._waiters.get(msg.tid)
            if ev is not None:
                self._replies[msg.tid] = msg
                ev.set()
            return True
        return False

    # ------------------------------------------------------------ plumbing
    def _rpc(self, target: str, msg, tid: int, timeout: float | None = None):
        ev = threading.Event()
        self._waiters[tid] = ev
        try:
            self.messenger.send_message(target, msg)
            if not ev.wait(timeout or self.timeout):
                raise TimeoutError_(f"rpc to {target} tid {tid}")
            return self._replies.pop(tid)
        finally:
            self._waiters.pop(tid, None)
            self._replies.pop(tid, None)

    def _wait_epoch_past(self, epoch: int, timeout: float) -> None:
        with self._map_cond:
            self._map_cond.wait_for(
                lambda: self.osdmap is not None
                and self.osdmap.epoch > epoch, timeout=timeout)

    # ----------------------------------------------------------- mon admin
    # ------------------------------------------------------------- cephx
    AUTH_SERVICES = ("mon", "osd", "mds")

    def _auth_refresh(self) -> None:
        """Fetch fresh service tickets, hunting across monitors: the
        current mon being dead must not strand a data-only client whose
        ticket is expiring (any mon serves MAuth)."""
        with self._auth_lock:
            last: Exception | None = None
            for _attempt in range(max(2, len(self.mons))):
                tid = next(self._tids)
                nonce, ts_ms, proof = self.auth.build_request(
                    list(self.AUTH_SERVICES))
                try:
                    reply = self._rpc(
                        self.mon,
                        MAuth(tid, self.auth.entity,
                              list(self.AUTH_SERVICES),
                              nonce, ts_ms, proof),
                        tid, timeout=min(self.timeout, 3.0))
                except TimeoutError_ as e:
                    last = e
                    self._rotate_mon()
                    continue
                if reply.result != 0:
                    raise RadosError(
                        reply.result,
                        f"auth refused for {self.auth.entity}")
                self._auth_ttl = reply.ttl or 0.0
                granted = set()
                for svc, blob, sealed, tnonce in reply.tickets:
                    self.auth.accept(svc, blob, sealed, tnonce)
                    granted.add(svc)
                # services the mon did NOT grant (no caps there, or an
                # auth-free cluster): remembered so they cost one round
                # trip per window, not one per op
                self._auth_no_caps = set(self.AUTH_SERVICES) - granted
                self._auth_refreshed_at = time.monotonic()
                return
            raise last or TimeoutError_("auth refresh")

    def _ticket(self, service: str) -> tuple:
        """(ticket_blob, session_key); renews through the mon when the
        cached ticket is missing or nearing expiry.  A (b"", None)
        return means the entity holds no caps for the service (or the
        cluster runs auth-free with a keyed client) — the op goes out
        unticketed and the daemon decides.  A refresh that yields no
        ticket for the service is remembered briefly so a capless
        service costs one mon round trip per window, not one per op."""
        if self.auth.needs_renewal(service, self._auth_ttl or 1.0):
            if service in self._auth_no_caps and \
                    time.monotonic() - self._auth_refreshed_at < 30.0:
                return b"", None  # negative-cached: mon said no caps
            try:
                self._auth_refresh()
            except TimeoutError_:
                pass  # every mon down; a still-valid ticket may serve
        return self.auth.ticket_for(service) or (b"", None)

    def service_ticket(self, service: str) -> bytes:
        """Current ticket blob for a service (renewed through the mon
        as needed); empty on an auth-free cluster or when the entity
        holds no caps for the service — the daemon then refuses."""
        if self.auth is None:
            return b""
        blob, _session = self._ticket(service)
        return blob

    def mon_command(self, cmd: dict) -> dict:
        """Send a command; rotate monitors on timeout and retry on a
        no-quorum answer (the MonClient hunt-for-mon behavior)."""
        last: RadosError | None = None
        auth_retried = False
        for _attempt in range(max(3, 3 * len(self.mons))):
            tid = next(self._tids)
            msg = MMonCommand(tid, cmd)
            if self.auth is not None:
                blob, session = self._ticket("mon")
                if session is not None:
                    msg.ticket = blob
                    msg.proof = op_proof(session, tid,
                                         canonical_command(cmd))
            try:
                reply = self._rpc(self.mon, msg, tid,
                                  timeout=min(self.timeout, 3.0))
            except TimeoutError_ as e:
                last = e
                self._rotate_mon()
                continue
            if reply.result == -11:  # election in progress
                last = RadosError(-11, str(reply.data))
                time.sleep(0.2)
                self._rotate_mon()
                continue
            if reply.result == -13 and self.auth is not None \
                    and not auth_retried:
                # ticket may have expired mid-flight (or rotation edge):
                # force one renewal, then retry once
                auth_retried = True
                self.auth.tickets.pop("mon", None)
                last = RadosError(-13, str(reply.data))
                continue
            if reply.result != 0:
                raise RadosError(reply.result, str(reply.data))
            return reply.data
        raise last or RadosError(-110, "mon command retries exhausted")

    def create_pool(self, name: str, kind: str = "replicated",
                    size: int = 3, pg_num: int = 8,
                    ec_profile: dict | None = None) -> int:
        data = self.mon_command({
            "prefix": "osd pool create", "name": name, "kind": kind,
            "size": size, "pg_num": pg_num, "ec_profile": ec_profile or {}})
        # placement changes with the new pool; wait for our map to catch up
        self._wait_epoch_past(0, self.timeout)
        with self._map_cond:
            self._map_cond.wait_for(
                lambda: data["pool_id"] in self.osdmap.pools,
                timeout=self.timeout)
        return data["pool_id"]

    def status(self) -> dict:
        return self.mon_command({"prefix": "status"})

    # ------------------------------------------------------------ object IO
    def _pool_id(self, pool_name: str) -> int:
        if self.osdmap is None:
            raise RadosError(-108, "not connected")
        for p in self.osdmap.pools.values():
            if p.name == pool_name:
                return p.pool_id
        raise RadosError(-2, f"no pool {pool_name!r}")

    def _primary_for(self, pool_id: int, oid: str) -> str:
        seed = self.osdmap.object_to_pg(pool_id, oid)
        up = self.osdmap.pg_to_up_osds(pool_id, seed)
        for u in up:
            if u is not None:
                return f"osd.{u}"
        raise RadosError(-5, f"pg {pool_id}.{seed:x} has no up osds")

    def _read_target(self, pool_id: int, oid: str) -> tuple[str, bool]:
        """(target, balanced) for a plain read.  Pools with
        ``read_policy=balance`` hash (oid, client nonce) across the
        acting set's up holders so the hot-object read load spreads;
        ``balanced`` is True only when the pick is NOT the primary —
        a bounced (-116) balanced read flips to the primary
        immediately, no map wait, because our map was never the
        problem (the holder is mid-write/behind and the primary
        arbitrates)."""
        pool = self.osdmap.pools.get(pool_id)
        if pool is None or str(pool.ec_profile.get(
                "read_policy", "primary")).lower() != "balance":
            return self._primary_for(pool_id, oid), False
        seed = self.osdmap.object_to_pg(pool_id, oid)
        up = self.osdmap.pg_to_up_osds(pool_id, seed)
        holders = [u for u in up if u is not None]
        if not holders:
            raise RadosError(-5, f"pg {pool_id}.{seed:x} has no up osds")
        pick = holders[zlib.crc32(
            f"{oid}/{self._client_nonce}".encode()) % len(holders)]
        return f"osd.{pick}", pick != holders[0]

    # ----------------------------------------------------- client lease cache
    def _lease_pop_locked(self, key: tuple):
        """Remove one cache entry (whole or ranged key) and keep the
        byte budget and the per-object range index consistent."""
        ent = self._lease_cache.pop(key, None)
        if ent is None:
            return None
        self._lease_cache_bytes -= len(ent[0])
        if len(key) == 4:
            idx = self._lease_index.get(key[:2])
            if idx is not None:
                idx.discard(key)
                if not idx:
                    del self._lease_index[key[:2]]
        return ent

    def _lease_drop(self, pool_id: int, oid: str) -> None:
        with self._lease_lock:
            self._lease_pop_locked((pool_id, oid))
            for key in list(self._lease_index.get((pool_id, oid), ())):
                self._lease_pop_locked(key)

    def _lease_get(self, pool_id: int, oid: str, offset: int,
                   length: int) -> bytes | None:
        """Lease-covered object bytes (range-trimmed with the server's
        read semantics), or None when uncached/expired.  A whole-object
        entry serves ANY range; a ranged read missing it may still hit
        its exact (offset, length) entry from a prior ride.  Expiry
        here is the HARD staleness bound: a lost revoke can serve stale
        bytes for at most one lease window, and always a torn-free
        snapshot (entry bytes cached atomically)."""
        now = time.time()
        with self._lease_lock:
            ent = self._lease_cache.get((pool_id, oid))
            if ent is not None:
                data, expires = ent
                if now >= expires:
                    self._lease_pop_locked((pool_id, oid))
                else:
                    self._lease_cache.move_to_end((pool_id, oid))
                    if length:
                        return data[offset:offset + length]
                    return data[offset:] if offset else data
            if offset or length:
                key = (pool_id, oid, offset, length)
                ent = self._lease_cache.get(key)
                if ent is not None:
                    data, expires = ent
                    if now >= expires:
                        self._lease_pop_locked(key)
                    else:
                        self._lease_cache.move_to_end(key)
                        return data
        return None

    def _lease_put(self, pool_id: int, oid: str, data,
                   ttl: float, offset: int = 0,
                   length: int = 0) -> None:
        data = bytes(data)
        if ttl <= 0 or len(data) > self._lease_cache_max:
            return
        ranged = bool(offset or length)
        key = (pool_id, oid, offset, length) if ranged \
            else (pool_id, oid)
        expires = time.time() + ttl
        with self._lease_lock:
            self._lease_pop_locked(key)
            self._lease_cache[key] = (data, expires)
            self._lease_cache_bytes += len(data)
            if ranged:
                self._lease_index.setdefault(
                    (pool_id, oid), set()).add(key)
            while self._lease_cache_bytes > self._lease_cache_max \
                    and self._lease_cache:
                self._lease_pop_locked(next(iter(self._lease_cache)))

    _WRITE_OPS = ("write", "write_full", "remove", "snap_rollback",
                  "multi_write")

    def _op(self, pool_name: str, oid: str, op: str, data: bytes = b"",
            offset: int = 0, length: int = 0, snapid: int = 0):
        pool_id = self._pool_id(pool_name)
        if self.tracing:
            root = self.tracer.start(f"client-op {op}", oid=oid,
                                     pool=pool_name)
        else:
            # head sampling: None at zero cost when the rate is 0,
            # a propagating span with probability sample_rate, or a
            # local-only unsampled span (flight-recorder ring)
            root = self.tracer.sample_root(f"client-op {op}", oid=oid,
                                           pool=pool_name)
        try:
            return self._op_attempts(pool_id, pool_name, oid, op, data,
                                     offset, length, snapid, root)
        finally:
            if root is not None:
                root.finish()

    def _op_attempts(self, pool_id, pool_name, oid, op, data,
                     offset, length, snapid, root):
        last_error: RadosError | None = None
        auth_retried = False
        if op in self._WRITE_OPS or op == "call":
            # our own mutation: the cached lease bytes are dead the
            # moment we decide to write — don't wait for the server's
            # revoke notify to race our next read
            self._lease_drop(pool_id, oid)
        balance_ok = op == "read" and not snapid
        force_primary = False
        for attempt in range(12):
            balanced = False
            if balance_ok and not force_primary:
                target, balanced = self._read_target(pool_id, oid)
            else:
                target = self._primary_for(pool_id, oid)
            tid = next(self._tids)
            m = MOSDOp(tid, self.name, pool_id, oid, op, offset, length,
                       data, self.osdmap.epoch, snapid=snapid,
                       # the head decision rides the wire: only a
                       # SAMPLED root propagates its context (one draw
                       # covers the whole fan-out; unsampled spans
                       # stay local for retroactive slow-op retention)
                       trace=root.ctx if root is not None
                       and root.sampled else ())
            if self.tenant:
                # dmclock tags: how much service this tenant received
                # cluster-wide since its last request to THIS osd —
                # the server advances its tenant clocks by rho/R and
                # delta/W, so N osds grant ONE reservation, not N
                m.tenant = self.tenant
                m.qdelta, m.qrho = self.qos_tracker.tags_for(target)
            if op in self._WRITE_OPS:
                seq, snaps = self._snapc.get(pool_id, (0, []))
                m.snap_seq, m.snaps = seq, list(snaps)
            if self.auth is not None:
                blob, session = self._ticket("osd")
                if session is not None:
                    m.ticket = blob
                    m.proof = op_proof(session, m.tid, m.pool, m.oid,
                                       m.op, m.offset, m.length, m.data)
            try:
                reply = self._rpc(target, m, tid)
            except TimeoutError_ as e:
                # primary may have died; wait for a newer map and retry
                # (the Objecter resend-on-map-change behaviour)
                dout("client", 5)("%s: rpc timeout to %s, retrying",
                                 self.name, target)
                if self.qos_tracker is not None:
                    # reconnect reset: the osd's dmclock state for us
                    # dies with the connection — restart at (1, 1)
                    self.qos_tracker.forget(target)
                last_error = e
                if balanced:
                    # the balanced holder may be dead while the
                    # primary is fine — fall back to it on the retry
                    force_primary = True
                self._wait_epoch_past(self.osdmap.epoch, self.timeout)
                continue
            if self.qos_tracker is not None:
                # phase feedback: reservation-phase service elsewhere
                # is what advances rho on the NEXT osd we talk to
                self.qos_tracker.note_reply(
                    target, getattr(reply, "qphase", 0))
            if reply.result == -11:  # EAGAIN: PG peering/recovering
                time.sleep(min(0.05 * 2 ** attempt, 1.0))
                last_error = RadosError(-11, "pg peering")
                continue
            if reply.result == -116:  # ESTALE: not primary under its map
                if balanced:
                    # balanced-read bounce: the holder declined (object
                    # mid-write, behind, or policy says no) — flip to
                    # the primary NOW, no map wait; our map isn't stale
                    force_primary = True
                    last_error = RadosError(-116, "balanced bounce")
                    continue
                if reply.epoch > self.osdmap.epoch:
                    self._wait_epoch_past(reply.epoch - 1, self.timeout)
                else:
                    # the OSD is the stale one; give its map time to arrive
                    time.sleep(0.05 * (attempt + 1))
                last_error = RadosError(-116, "stale map")
                continue
            if reply.result == -13 and self.auth is not None \
                    and not auth_retried:
                # expiry/rotation edge: drop the cached ticket, renew
                # via _ticket on the retry, refuse again -> EACCES out
                auth_retried = True
                self.auth.tickets.pop("osd", None)
                last_error = RadosError(-13, f"{op} {pool_name}/{oid}")
                continue
            if reply.result < 0:
                raise RadosError(reply.result, f"{op} {pool_name}/{oid}")
            if op == "read" and not snapid \
                    and getattr(reply, "lease", 0.0) > 0:
                # whole-object read under a granted lease: cache the
                # bytes; repeat reads inside the window never leave
                # the client.  A RANGED reply carrying a lease rode an
                # existing grant — cached under its exact range key,
                # revoked together with the whole object.
                self._lease_put(pool_id, oid, reply.data, reply.lease,
                                offset=offset, length=length)
            return reply
        raise last_error or RadosError(-5, "retries exhausted")

    def list_objects(self, pool: str) -> list[str]:
        """Every live object head in the pool (the librados
        NObjectIterator / `rados ls` role): one pgls per PG against its
        primary, retried on stale primaries like any op."""
        pool_id = self._pool_id(pool)
        names: set[str] = set()
        for seed in range(self.osdmap.pools[pool_id].pg_num):
            pgid = PgId(pool_id, seed)
            for attempt in range(12):
                up = self.osdmap.pg_to_up_osds(pool_id, seed)
                primary = next((u for u in up if u is not None), None)
                if primary is None:
                    raise RadosError(-5, f"pg {pgid} has no up osds")
                tid = next(self._tids)
                m = MPGList(tid, pgid, self.osdmap.epoch)
                if self.auth is not None:
                    blob, session = self._ticket("osd")
                    if session is not None:
                        m.ticket = blob
                        m.proof = op_proof(session, tid, pool_id, seed,
                                           "pgls")
                try:
                    reply = self._rpc(f"osd.{primary}", m, tid)
                except TimeoutError_:
                    # dead primary: wait for the map to move, retry
                    # (the same resend-on-map-change the op path does)
                    self._wait_epoch_past(self.osdmap.epoch,
                                          self.timeout)
                    continue
                if reply.result == -11:  # peering/catching up
                    time.sleep(min(0.05 * 2 ** attempt, 1.0))
                    continue
                if reply.result == -116:
                    if reply.epoch > self.osdmap.epoch:
                        self._wait_epoch_past(reply.epoch - 1,
                                              self.timeout)
                    else:
                        time.sleep(0.05 * (attempt + 1))
                    continue
                if reply.result < 0:
                    raise RadosError(reply.result, f"pgls {pgid}")
                names.update(reply.names)
                break
            else:
                raise RadosError(-116, f"pgls {pgid}: retries exhausted")
        return sorted(names)

    def scrub_pg(self, pool: str, seed: int, deep: bool = False,
                 repair: bool = False) -> MScrubResult:
        """Scrub one PG via its primary (the `ceph pg scrub/deep-scrub/
        repair` verbs); retries on stale-primary like any op."""
        pool_id = self._pool_id(pool)
        pgid = PgId(pool_id, seed)
        for attempt in range(8):
            up = self.osdmap.pg_to_up_osds(pool_id, seed)
            primary = next((u for u in up if u is not None), None)
            if primary is None:
                raise RadosError(-5, f"pg {pgid} has no up osds")
            tid = next(self._tids)
            reply = self._rpc(f"osd.{primary}",
                              MScrubRequest(tid, self.name, pgid, deep,
                                            repair), tid)
            if reply.result == -116:
                time.sleep(0.05 * (attempt + 1))
                continue
            return reply
        raise RadosError(-116, f"scrub {pgid}: primary stayed stale")

    def scrub_pool(self, pool: str, deep: bool = False,
                   repair: bool = False) -> list:
        """Scrub every PG of a pool; returns all inconsistencies."""
        pool_id = self._pool_id(pool)
        issues = []
        for seed in range(self.osdmap.pools[pool_id].pg_num):
            res = self.scrub_pg(pool, seed, deep, repair)
            issues.extend(res.inconsistencies)
        return issues

    def write_full(self, pool: str, oid: str, data: bytes) -> int:
        """Replace the whole object (rados write_full semantics)."""
        return self._op(pool, oid, "write_full", bytes(data)).version

    def write(self, pool: str, oid: str, data: bytes, offset: int = 0) -> int:
        """Partial overwrite at an offset (rados_write semantics): EC pools
        take the parity-delta/rmw path, replicated pools apply in place."""
        return self._op(pool, oid, "write", bytes(data),
                        offset=offset).version

    def read(self, pool: str, oid: str, offset: int = 0,
             length: int = 0, snapid: int = 0) -> bytes:
        """snapid > 0 reads the object's state as of that snapshot
        (rados_ioctx_snap_set_read role)."""
        if not snapid:
            cached = self._lease_get(self._pool_id(pool), oid,
                                     offset, length)
            if cached is not None:
                self.lease_hits += 1  # served locally: zero RADOS ops
                return cached
            self.lease_misses += 1
        data = self._op(pool, oid, "read", offset=offset,
                        length=length, snapid=snapid).data
        # the librados boundary promises bytes: a zero-copy carve over
        # the rx frame buffer detaches HERE — the one ingest copy into
        # user space (the daemon-internal wire path stays copy-free)
        return bytes(data) if isinstance(data, memoryview) else data

    def remove(self, pool: str, oid: str) -> None:
        self._op(pool, oid, "remove")

    def stat(self, pool: str, oid: str) -> int:
        reply = self._op(pool, oid, "stat")
        return int.from_bytes(reply.data, "little")

    # ------------------------------------------ self-managed snapshots
    def set_snap_context(self, pool: str, seq: int, snaps: list) -> None:
        """Explicit SnapContext for writes to this pool (newest-first
        snap ids; the rados_ioctx_selfmanaged_snap_set_write_ctx role)."""
        self._snapc[self._pool_id(pool)] = (int(seq),
                                            sorted(snaps, reverse=True))

    def selfmanaged_snap_create(self, pool: str) -> int:
        """Mint a snapshot id from the monitor and fold it into this
        client's write SnapContext."""
        rep = self.mon_command({"prefix":
                                "osd pool selfmanaged-snap-create",
                                "pool": pool})
        snapid = int(rep["snapid"])
        pid = self._pool_id(pool)
        seq, snaps = self._snapc.get(pid, (0, []))
        self._snapc[pid] = (max(seq, snapid),
                            sorted(set(snaps) | {snapid}, reverse=True))
        return snapid

    def selfmanaged_snap_remove(self, pool: str, snapid: int) -> None:
        """Publish the snap's removal (OSDs trim its clones async)."""
        self.mon_command({"prefix": "osd pool selfmanaged-snap-remove",
                          "pool": pool, "snapid": int(snapid)})
        pid = self._pool_id(pool)
        seq, snaps = self._snapc.get(pid, (0, []))
        self._snapc[pid] = (seq, [s for s in snaps if s != snapid])

    def list_snaps(self, pool: str, oid: str) -> dict:
        """SnapSet of one object: {seq, clones, sz, ov, head}."""
        return self._unpack(self._op(pool, oid, "list_snaps").data)

    def snap_rollback(self, pool: str, oid: str, snapid: int) -> None:
        """Roll the head back to its state at snapid."""
        self._op(pool, oid, "snap_rollback", snapid=snapid)


    # ------------------------------------------ extended ops (do_osd_ops)
    _pack = staticmethod(pack_value)
    _unpack = staticmethod(unpack_value)

    def omap_set(self, pool: str, oid: str, kv: dict) -> None:
        self._op(pool, oid, "omap_set",
                 self._pack({str(k): bytes(v) for k, v in kv.items()}))

    def omap_get(self, pool: str, oid: str) -> dict:
        return self._unpack(self._op(pool, oid, "omap_get").data)

    def omap_rm(self, pool: str, oid: str, keys) -> None:
        self._op(pool, oid, "omap_rm", self._pack([str(k) for k in keys]))

    WATCH_RENEW = 10.0  # server expiry is 30s; renew well inside it

    def watch(self, pool: str, oid: str, callback) -> int:
        """Register interest in notifies on the object (librados watch):
        callback(oid, notifier, payload) runs on the dispatch thread.
        A renewal thread keeps the server-side watch alive (Watch.cc
        timeout semantics)."""
        cookie = next(self._cookies)
        self._watches[(self._pool_id(pool), oid)] = (callback, cookie)
        self._op(pool, oid, "watch", offset=cookie)
        if self._watch_renewer is None:
            self._watch_renewer = threading.Thread(
                target=self._renew_watches, name=f"{self.name}-rewatch",
                daemon=True)
            self._watch_renewer.start()
        return cookie

    def _renew_watches(self) -> None:
        while not self._closed and self._watches:
            time.sleep(self.WATCH_RENEW)
            if self._closed:
                return
            self._reregister_watches()

    def unwatch(self, pool: str, oid: str) -> None:
        self._watches.pop((self._pool_id(pool), oid), None)
        self._op(pool, oid, "unwatch")

    def notify(self, pool: str, oid: str, payload: bytes = b"") -> list:
        """Fan a notify to every watcher; returns who acked (librados
        notify2 shape)."""
        return self._unpack(
            self._op(pool, oid, "notify", bytes(payload)).data)

    def cls_call(self, pool: str, oid: str, cls: str, method: str,
                 input_=None):
        """Execute an object-class method server-side (rados exec)."""
        reply = self._op(pool, oid, "call",
                         self._pack({"cls": cls, "method": method,
                                     "input": input_}))
        return self._unpack(reply.data)

    # ------------------------------------------------ compound operations
    def operate(self, pool: str, oid: str, op) -> int:
        """Execute an ObjectWriteOperation atomically (librados
        rados_write_op_operate): all steps apply in one OSD transaction
        under the object's write lock, or none do.  Returns the object's
        new version."""
        return self._op(pool, oid, "multi_write",
                        self._pack(op.steps)).version

    def operate_read(self, pool: str, oid: str, op) -> list:
        """Execute an ObjectReadOperation; returns one result per step
        in order (rados_read_op_operate)."""
        return self._unpack(
            self._op(pool, oid, "multi_read", self._pack(op.steps)).data)

    # ---------------------------------------------------------- user xattrs
    def setxattr(self, pool: str, oid: str, name: str,
                 value: bytes) -> None:
        from .operations import ObjectWriteOperation
        self.operate(pool, oid,
                     ObjectWriteOperation().setxattr(name, value))

    def rmxattr(self, pool: str, oid: str, name: str) -> None:
        from .operations import ObjectWriteOperation
        self.operate(pool, oid, ObjectWriteOperation().rmxattr(name))

    def getxattrs(self, pool: str, oid: str) -> dict:
        return self._unpack(self._op(pool, oid, "getxattrs").data)

    def getxattr(self, pool: str, oid: str, name: str) -> bytes:
        xattrs = self.getxattrs(pool, oid)
        if name not in xattrs:
            raise RadosError(-61, f"no xattr {name!r}")  # ENODATA
        return xattrs[name]

    # ------------------------------------------------------------------ aio
    # The librados aio surface (rados_aio_write/read/operate + completion
    # callbacks, src/librados/IoCtxImpl.cc aio_* entry points).  The
    # reference's Objecter is callback-driven end-to-end; here the sync
    # op path (with its map-change retry machinery) runs on a small
    # client-owned executor and completes a Completion — same external
    # contract, much less machinery to keep correct.
    _AIO_WORKERS = 8

    def _aio_pool(self):
        # double-checked under a lock: two threads racing the first aio
        # must not build two executors (and lose one's outstanding set)
        if self._aio_exec is None:
            with self._aio_init_lock:
                if self._aio_exec is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._aio_exec = ThreadPoolExecutor(
                        max_workers=self._AIO_WORKERS,
                        thread_name_prefix=f"{self.name}-aio")
        return self._aio_exec

    def _aio_submit(self, fn, *args, callback=None) -> "Completion":
        comp = Completion(callback)
        pool = self._aio_pool()
        self._aio_outstanding.add(comp)

        def run():
            try:
                comp._finish(fn(*args), None)
            except RadosError as e:
                comp._finish(None, e)
            except Exception as e:  # noqa: BLE001 - must not lose the waiter
                comp._finish(None, RadosError(-5, repr(e)))
            finally:
                self._aio_outstanding.discard(comp)

        pool.submit(run)
        return comp

    def aio_write_full(self, pool: str, oid: str, data: bytes,
                       callback=None) -> "Completion":
        return self._aio_submit(self.write_full, pool, oid, data,
                                callback=callback)

    def aio_write(self, pool: str, oid: str, data: bytes, offset: int = 0,
                  callback=None) -> "Completion":
        return self._aio_submit(self.write, pool, oid, data, offset,
                                callback=callback)

    def aio_read(self, pool: str, oid: str, offset: int = 0,
                 length: int = 0, callback=None) -> "Completion":
        return self._aio_submit(self.read, pool, oid, offset, length,
                                callback=callback)

    def aio_remove(self, pool: str, oid: str, callback=None) -> "Completion":
        return self._aio_submit(self.remove, pool, oid, callback=callback)

    def aio_stat(self, pool: str, oid: str, callback=None) -> "Completion":
        return self._aio_submit(self.stat, pool, oid, callback=callback)

    def aio_operate(self, pool: str, oid: str, op,
                    callback=None) -> "Completion":
        return self._aio_submit(self.operate, pool, oid, op,
                                callback=callback)

    def aio_operate_read(self, pool: str, oid: str, op,
                         callback=None) -> "Completion":
        return self._aio_submit(self.operate_read, pool, oid, op,
                                callback=callback)

    def aio_flush(self, timeout: float | None = None) -> None:
        """Block until every outstanding aio completes
        (rados_aio_flush); raises ETIMEDOUT if any op is still in
        flight at the deadline — flush returning means flushed."""
        deadline = time.time() + (timeout or self.timeout)
        for comp in list(self._aio_outstanding):
            if not comp.wait_for_complete(
                    max(0.0, deadline - time.time())):
                raise TimeoutError_("aio_flush: ops still in flight")

    def _reregister_watches(self) -> None:
        """Re-assert watches after a map change.  Runs the registration
        through _op (with its EAGAIN/peering retries) on a SIDE thread:
        the dispatch thread must not block on replies it itself
        delivers."""
        watches = list(self._watches.items())

        def rereg():
            for (pool_id, oid), (_cb, cookie) in watches:
                if (pool_id, oid) not in self._watches:
                    continue  # unwatched meanwhile
                pool_name = next(
                    (p.name for p in self.osdmap.pools.values()
                     if p.pool_id == pool_id), None)
                if pool_name is None:
                    continue
                try:
                    self._op(pool_name, oid, "watch", offset=cookie)
                except RadosError:
                    pass  # retried on the next map change

        threading.Thread(target=rereg, name=f"{self.name}-rewatch",
                         daemon=True).start()
