"""OSD daemon: the data-plane server.

The role of the reference's OSD + PrimaryLogPG + PGBackend stack
(src/osd/OSD.cc op ingress :7690->dequeue :9979; PrimaryLogPG::do_op :2588
/ do_osd_ops :6163; ReplicatedBackend primary-copy 2PC; ECBackend shard
fan-out ECCommon.cc:950-1090; heartbeats OSD.cc:5823; peering/recovery
PeeringState — SURVEY.md §2.5) collapsed into one single-dispatch-thread
daemon per OSD:

- client ops arrive on the messenger dispatch thread and run as
  non-blocking state machines (pending write/read tables keyed by tid —
  the in_progress_ops role of ECCommon);
- replicated pools: primary applies locally, fans MSubWrite to replicas,
  acks the client when all commit (primary-copy 2PC);
- EC pools: primary splits+encodes the stripe through the pool's EC plugin
  (the CUDA kernels underneath), fans shard writes, and reads/decodes with
  reconstruction when shards are missing (degraded reads);
- heartbeats ping peers; silence past the grace window produces failure
  reports to the monitor (adaptive grace is monitor-side);
- on map change the primary runs recovery-lite: inventory peers
  (MPGQuery/MPGInfo), push stale/missing whole objects, and rebuild EC
  shards onto spare devices from k survivors.  (Log-based delta recovery
  and rollback generations are the next widening step; versions are
  tracked per object now.)
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import ec
from ..ec.batcher import ECBatcher
from ..ec.stripe import StripeInfo, plan_write
from ..mon.maps import OSDMap
from ..msg.messages import (MFailureReport, MLeaseRegister, MMapPush,
                            MMonSubscribe,
                            MNotifyAck, MOSDBoot, MOSDOp, MOSDOpReply,
                            MOSDPing, MOSDPingReply, MPGInfo, MPGList,
                            MPGListReply, MPGPull,
                            MOSDPGTemp,
                            MPGPush, MPGQuery, MPGRollback,
                            MRecoveryReserve, MStatsReport,
                            MSubDelta, MSubPartialWrite, MSubRead,
                            MSubReadN, MSubReadReply, MSubReadReplyN,
                            MSubWrite, MSubWriteReply, MWatchNotify,
                            PgId)
from ..utils.reserver import AsyncReserver
from ..msg.messenger import Dispatcher, Messenger, Network, Policy
from ..ops import cuda_lib
from ..ops.native import crc32c as native_crc32c
from ..utils.config import Config, default_config
from ..utils.event_log import EventLog
from ..utils.interval import IntervalSet
from ..utils.log import dout
from ..utils.metrics_history import MetricsHistory
from ..utils import staging
from ..utils.perf import CounterType, global_perf
from ..utils.tracked_op import OpTracker
from ..utils.tracer import Tracer
from ..msg.messages import (MScrubMap, MScrubRequest, MScrubShard)
from .objectstore import (CollectionId, NoSuchObject, ObjectId, ObjectStore,
                          StoreError, Transaction)
from ..ec.arena import DeviceArena
from .extent_cache import ECExtentCache, register_read_scaleout_counters
from .intervals import INTERVALS_KEY, Interval, LES_KEY, PastIntervals
from . import compression
from .objops import ObjOpsMixin
from .pglog import PGLOG_OID, LogEntry, PGLog
from .scheduler import (ClassParams, PHASE_NONE, ShardedScheduler,
                        current_service)
from .scrub import FaultInjection, ScrubMixin
from .snaps import SnapMixin, split_vname, to_oid, vname, vname_of

EIO, ENOENT, ESTALE, EAGAIN, EINVAL, EACCES = -5, -2, -116, -11, -22, -13


@dataclass
class _PendingWrite:
    client: str
    client_tid: int
    acks_needed: int
    version: int
    failed: int = 0
    retry: int = 0  # version-conflict sub-op refusals (client retries)
    lock_key: tuple | None = None  # per-object write lock to release
    span: object = None  # op span closed when the client reply leaves
    qphase: int = 0  # mclock phase served under (rides the reply)
    pq_ctx: object = None  # perf-query booking (async reply drains)
    # the OSDs the op's sub-writes went to: a map that marks one of them
    # down fails the op at once (_reset_ops_on_down)
    members: tuple = ()
    stamp: float = field(default_factory=time.time)


@dataclass
class _PendingRead:
    client: str | None
    client_tid: int
    pool: int
    oid: str
    total_shards: int
    chunks: dict = field(default_factory=dict)  # shard -> np.uint8 array
    attrs: dict = field(default_factory=dict)   # merged shard attrs (len/v)
    shard_vers: dict = field(default_factory=dict)  # shard -> version attr
    shard_attrs: dict = field(default_factory=dict)  # shard -> its attrs
    omaps: dict = field(default_factory=dict)  # shard -> replicated omap
    replies: int = 0
    offset: int = 0
    length: int = 0
    row_base: int = 0      # ro byte addr of the first row covered (range
    row_len: int = 0       # reads); row_len = shard-stream bytes per shard
    stat_only: bool = False  # reply with the object length, not data
    # recovery reads carry a completion callback instead of a client
    on_done: object = None
    # sub-chunk repair reads (CLAY MSR) need EVERY helper's slices, not
    # just k chunks: completion waits for all replies
    want_all: bool = False
    span: object = None    # op span (traced reads): decode stage parent
    qphase: int = 0  # mclock phase served under (rides the reply)
    pq_ctx: object = None  # perf-query booking (async reply drains)
    # balanced (non-primary) serve: a torn/no-agreed-k-set outcome
    # bounces ESTALE back to the client (re-target the primary) instead
    # of the primary path's requery + EAGAIN
    balanced: bool = False
    # object-write sequence at fan-out (the PR-5 read barrier): the
    # hot-tier admission fence — bytes fetched before a write landed
    # must never be admitted as current
    wmarker: int = 0
    # shard -> the OSD its sub-read went to, until it answers: a map that
    # marks that OSD down answers for it, as a failed read
    # (_reset_ops_on_down)
    asked: dict = field(default_factory=dict)
    stamp: float = field(default_factory=time.time)


class _SpanConn:
    """Send-handle that closes the op's span when the client reply
    goes out (whatever async path produced it)."""

    def __init__(self, conn, span):
        self._conn = conn
        self._span = span

    def send(self, msg) -> bool:
        if isinstance(msg, MOSDOpReply):
            self._span.tag("result", msg.result)
            self._span.finish()
        return self._conn.send(msg)


class _PhaseConn:
    """Send-handle that stamps the mclock service phase onto the
    client reply (the dmclock feedback channel: qphase tells the
    tenant's ServiceTracker whether this op consumed reservation or
    proportional share).  Wraps once at dispatch so every reply path —
    including async EC ack drains on other threads — carries it."""

    def __init__(self, conn, phase: int):
        self._conn = conn
        self._phase = phase

    def send(self, msg) -> bool:
        if isinstance(msg, MOSDOpReply) and not msg.qphase:
            msg.qphase = self._phase
        return self._conn.send(msg)


class _PerfQueryCtx:
    """One client op's perf-query attribution record, shared between
    the wrapped conn (direct ``conn.send`` replies) and the pending
    write/read drains (``_handle_sub_write_reply`` / ``_finish_ec_read``
    reply via ``messenger.send_message`` and never see the wrapped
    conn — the same split the span/qphase stashes exist for).
    ``finish`` is one-shot: whichever reply edge fires books the op,
    the other finds ``_done`` set — no double count however the op
    completes.  Allocated ONLY when queries are active — the unqueried
    dispatch path stays a single ``pq.active`` attribute check with
    zero allocations (the exemplar/tracer discipline, gated by
    bench.py --ec-batch)."""

    __slots__ = ("_pq", "_tenant", "_pool", "_pgid", "_op", "_oid",
                 "_bytes_in", "_t0", "_done")

    def __init__(self, pq, tenant: str, pool: int, pgid,
                 op: str, oid: str, bytes_in: int):
        self._pq = pq
        self._tenant = tenant
        self._pool = pool
        self._pgid = pgid
        self._op = op
        self._oid = oid
        self._bytes_in = bytes_in
        self._t0 = time.perf_counter()
        self._done = False

    def finish(self, bytes_out: int) -> None:
        if self._done:
            return
        self._done = True
        self._pq.observe(
            self._tenant, self._pool, self._pgid, self._op, self._oid,
            self._bytes_in, bytes_out,
            (time.perf_counter() - self._t0) * 1e6)


class _PerfQueryConn:
    """Send-handle that books a client op into the active perf queries
    when its reply goes out over the dispatch conn: the reply edge is
    the one point where latency AND bytes_out are both known.  Async
    drains (which bypass the conn) finish the same one-shot ctx off
    the pending entry instead."""

    __slots__ = ("_conn", "_ctx")

    def __init__(self, conn, ctx: _PerfQueryCtx):
        self._conn = conn
        self._ctx = ctx

    def send(self, msg) -> bool:
        if isinstance(msg, MOSDOpReply):
            self._ctx.finish(len(msg.data))
        return self._conn.send(msg)


class _ClientConn:
    """Send-handle towards a client entity (for re-entrant op paths)."""

    def __init__(self, daemon: "OSDDaemon", client: str):
        self._daemon = daemon
        self._client = client

    def send(self, msg) -> bool:
        return self._daemon.messenger.send_message(self._client, msg)


#: perf counters the sub-read aggregator maintains on the OSD's
#: registry — ALWAYS registered (zeroed) even when read coalescing is
#: off, so `perf dump` and the exporter expose one stable schema
READ_AGG_COUNTERS = ("ec_read_msgs", "ec_read_fetches",
                     "ec_read_coalesced_subreads", "ec_read_dup_hits",
                     "ec_read_union_merges", "ec_read_stale_rejects",
                     "ec_read_flush_window", "ec_read_flush_size",
                     "ec_read_flush_idle",
                     # recovery-class lanes (repair-plane sub-chunk
                     # fetches riding the aggregator): sub-reads
                     # submitted and MSubReadN messages sent, so the
                     # msgs-per-helper drop on a wide storm is a
                     # counter fact, not a code-reading exercise
                     "ec_read_repair_subreads", "ec_read_repair_msgs")
READ_AGG_HISTOGRAMS = ("ec_read_fetches_per_msg",
                       "ec_read_subreads_per_msg")


class _ReadFetch:
    """One wire fetch riding an MSubReadN: a (pgid, oid, shard,
    extents) store read on the peer, possibly shared by several
    pending reads (duplicate collapse / union-range merge)."""

    __slots__ = ("fid", "pgid", "oid", "shard", "extents", "waiters",
                 "tspans", "fspan_id", "stamp", "marker", "klass")

    def __init__(self, fid, pgid, oid, shard, extents, marker=0,
                 klass="client"):
        self.fid = fid
        self.pgid = pgid
        self.oid = oid
        self.shard = shard
        self.klass = klass
        self.extents = extents      # None (whole shard) or merged
        # union: tuple of disjoint sorted (off, len)
        self.waiters: list = []     # [(tid, requested extents|None)]
        self.tspans: list = []      # ec-read-wait spans (traced ops)
        self.fspan_id = 0           # flush span id once sent
        self.stamp = time.time()
        # read barrier: the daemon's object-write sequence observed at
        # creation — a later read may ride this fetch IN FLIGHT only if
        # its object saw no acked write since (read-after-write)
        self.marker = marker


def _merge_extents(a: tuple, b: tuple) -> tuple:
    """Union of two interval sets: overlapping/touching (off, len)
    ranges coalesce, so N small reads of one hot shard object become
    ONE store read covering them all."""
    iv = IntervalSet()
    for off, ln in (*a, *b):
        iv.insert(off, ln)
    return tuple((s, e - s) for s, e in iv)


def _extents_cover(union: tuple | None, want: tuple | None) -> bool:
    """Whether a fetch for `union` can serve a request for `want`
    (whole-shard fetches serve anything; a ranged fetch serves ranges
    fully inside its merged intervals)."""
    if union is None:
        return True
    if want is None:
        return False
    iv = IntervalSet((off, off + ln) for off, ln in union)
    return all(iv.contains(off, ln) for off, ln in want)


def _carve_extents(union: tuple | None, data: bytes,
                   want: tuple | None) -> bytes:
    """Slice one waiter's requested extents out of the fetch's reply
    buffer.  The peer zero-pads every requested slice to its length
    (absent tail bytes of a padded stripe row are zeros), so carving
    from the union buffer is byte-identical to a direct ranged read."""
    if want == union or want is None:
        return data
    parts = []
    if union is None:
        # whole-shard buffer: direct offsets, zero-padded per slice
        for off, ln in want:
            seg = data[off:off + ln]
            if len(seg) < ln:
                # bytes(seg): seg may be a carved memoryview (the rx
                # zero-copy path), which cannot concatenate in place
                seg = bytes(seg) + b"\0" * (ln - len(seg))
            parts.append(seg)
        return b"".join(parts)
    bases = []  # start offset of each union interval in the buffer
    pos = 0
    for io, il in union:
        bases.append(pos)
        pos += il
    for off, ln in want:
        for (io, il), base in zip(union, bases):
            if io <= off and off + ln <= io + il:
                parts.append(data[base + off - io: base + off - io + ln])
                break
        else:  # cannot happen: waiters are merged into the union
            parts.append(b"\0" * ln)
    return b"".join(parts)


class SubReadAggregator:
    """Per-(peer, pg) MSubRead coalescing (the message half of the EC
    read pipeline; same spirit as the ECBatcher's folded launches).

    Concurrent sub-reads headed to the same OSD for the same pg queue
    here for a small window (``ec_read_window_us``) and leave as ONE
    ``MSubReadN``; the peer answers every item in one
    ``MSubReadReplyN``.  Lanes split by pg — not just peer — because
    the vectorized message carries its pgid for the peer's sharded op
    queue: the whole batch executes on that pg's scheduler shard,
    serialized against the pg's write applies exactly like a plain
    ``MSubRead`` (a pg-less message would land on the default shard
    and could read a stripe mid-apply).  Two further
    collapses ride the queue: a read identical to (or covered by) an
    in-flight fetch of the same ``(pgid, oid, shard)`` attaches as a
    waiter instead of refetching (duplicate collapse), and overlapping
    extents for one shard object merge into a union range so N small
    reads of a hot object become one store read.  ``window_us == 0``
    is pass-through — the daemon sends plain per-op ``MSubRead``s,
    bit-identical to the unbatched path.

    Unlike the ECBatcher no submitter blocks: the fan-out is already
    async (replies route through ``_on_shard_read``), so flushing is
    driven by a per-peer one-shot timer (armed by the first queued
    fetch) or a size threshold (``ec_read_max_items``).

    Tracing: a traced op's sub-reads get ``ec-read-wait`` spans
    (queued -> flushed, ``flush_span``/``flush_reason``/``dup``
    cross-tags) and each flush ONE shared ``ec-read-flush`` span —
    the same fan-in reconstruction contract as the batcher's
    ``ec-batch-wait``/``ec-flush`` pair."""

    def __init__(self, daemon: "OSDDaemon", *, window_us: float = 150.0,
                 max_items: int = 64, perf=None):
        self._daemon = daemon
        self.window_us = float(window_us)
        self.max_items = int(max_items)
        self._perf = perf
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._fids = itertools.count(1)
        # lane = (peer, pgid): one MSubReadN never mixes pgs
        self._queued: dict[tuple, list[_ReadFetch]] = {}
        self._qindex: dict[tuple, _ReadFetch] = {}
        # lane -> monotonic flush deadline, drained by ONE persistent
        # flusher thread (started lazily on the first submit): a
        # threading.Timer per lane-window costs a thread spawn per
        # flush, which on a loaded box dwarfs the window itself
        self._deadlines: dict[tuple, float] = {}
        self._flusher: threading.Thread | None = None
        self._inflight: dict[int, _ReadFetch] = {}
        self._inflight_keys: dict[tuple, list[_ReadFetch]] = {}
        # persistent completion pool (lazily created): multi-delivery
        # replies fan their completions here so same-signature decodes
        # coalesce in the ECBatcher — a thread spawn per completion
        # costs more than the window on a loaded box
        self._pool = None
        self._stopped = False

    @staticmethod
    def _key(peer, pgid, oid, shard, whole: bool,
             klass: str = "client") -> tuple:
        return (peer, pgid, oid, shard, whole, klass)

    def _inc(self, name: str, n: int = 1) -> None:
        if self._perf is not None:
            self._perf.inc(name, n)

    # ------------------------------------------------------------ submit
    def submit(self, peer: str, tid: int, pgid, oid: str, shard: int,
               extents: list | None, trace: tuple | None = None,
               klass: str = "client") -> None:
        """Queue one sub-read for `peer`; the reply reaches the
        daemon's _on_shard_read exactly as a plain MSubReadReply
        would.  ``klass`` splits lanes (and rides the MSubReadN) so a
        recovery storm's repair-plane fetches coalesce per helper yet
        queue under the peer's recovery reservation — client and
        recovery reads never share a wire message."""
        want = (None if extents is None
                else tuple((int(o), int(ln)) for o, ln in extents))
        if klass == "recovery":
            self._inc("ec_read_repair_subreads")
        key = self._key(peer, pgid, oid, shard, want is None, klass)
        tspan = None
        if trace is not None:
            tracer, ctx = trace
            tspan = tracer.start("ec-read-wait", parent=ctx, peer=peer,
                                 shard=shard)
        # a ranged read can also ride a WHOLE-shard fetch of the same
        # shard object (the whole stream covers any slice; recovery
        # whole-reads and client range reads of one hot object meet
        # here), so ranged lookups consult the whole-shard key too
        keys = (key,) if want is None else (
            key, self._key(peer, pgid, oid, shard, True, klass))
        flush_peer = False
        with self._lock:
            if self._stopped:
                if tspan is not None:
                    tspan.tag("stopped", 1)
                    tspan.finish()
                return
            # duplicate collapse vs an IN-FLIGHT fetch: the wire read
            # is already on its way — ride its reply.  Read barrier:
            # the fetch may predate an acked write (its reply could
            # carry pre-write bytes for ALL k shards and pass version
            # agreement), so a read only rides if the object saw no
            # acked write since the fetch was created — otherwise it
            # pays for a fresh wire fetch, exactly like the per-op path
            for k in keys:
                for f in self._inflight_keys.get(k, ()):
                    if not _extents_cover(f.extents, want):
                        continue
                    if self._daemon._obj_written_since((pgid, oid),
                                                      f.marker):
                        self._inc("ec_read_stale_rejects")
                        continue
                    f.waiters.append((tid, want))
                    self._inc("ec_read_dup_hits")
                    if tspan is not None:
                        tspan.tag("dup", 1)
                        if f.fspan_id:
                            tspan.tag("flush_span", f.fspan_id)
                        tspan.finish()
                    return
            f = None
            for k in keys:
                f = self._qindex.get(k)
                if f is not None:
                    break
            if f is not None:
                # queued fetch for the same shard object: collapse —
                # identical/covered extents are a pure dup hit, others
                # merge into a union range (one store read on the peer)
                if want is not None and not _extents_cover(f.extents,
                                                           want):
                    f.extents = _merge_extents(f.extents, want)
                    self._inc("ec_read_union_merges")
                else:
                    self._inc("ec_read_dup_hits")
                f.waiters.append((tid, want))
                if tspan is not None:
                    f.tspans.append(tspan)
            else:
                f = _ReadFetch(next(self._fids), pgid, oid, shard, want,
                               marker=self._daemon._obj_write_marker(),
                               klass=klass)
                f.waiters.append((tid, want))
                if tspan is not None:
                    f.tspans.append(tspan)
                lane = (peer, pgid, klass)
                q = self._queued.setdefault(lane, [])
                q.append(f)
                self._qindex[key] = f
                if len(q) >= self.max_items:
                    self._deadlines.pop(lane, None)
                    flush_peer = True
                elif len(q) == 1:
                    self._deadlines[lane] = (time.monotonic()
                                             + self.window_us * 1e-6)
                    if self._flusher is None:
                        self._flusher = threading.Thread(
                            target=self._flush_loop, daemon=True,
                            name=f"ec-read-agg-{self._daemon.name}")
                        self._flusher.start()
                    self._cv.notify_all()
        if flush_peer:
            self._flush((peer, pgid, klass), reason="size")

    def _flush_loop(self) -> None:
        """The single flusher: sleeps to the EARLIEST lane deadline,
        flushes every due lane, repeats.  One thread per aggregator —
        never one per window."""
        while True:
            due = []
            with self._cv:
                while not self._stopped:
                    if not self._deadlines:
                        self._cv.wait()
                        continue
                    now = time.monotonic()
                    due = [ln for ln, d in self._deadlines.items()
                           if d <= now]
                    if due:
                        for ln in due:
                            self._deadlines.pop(ln, None)
                        break
                    self._cv.wait(min(self._deadlines.values()) - now)
                if self._stopped:
                    return
            for lane in due:
                self._flush(lane)

    # ------------------------------------------------------------- flush
    def _flush(self, lane: tuple, reason: str | None = None) -> None:
        peer, pgid, klass = lane
        with self._lock:
            self._deadlines.pop(lane, None)
            fetches = self._queued.pop(lane, [])
            for f in fetches:
                self._qindex.pop(
                    self._key(peer, f.pgid, f.oid, f.shard,
                              f.extents is None, f.klass), None)
                self._inflight[f.fid] = f
                self._inflight_keys.setdefault(
                    self._key(peer, f.pgid, f.oid, f.shard,
                              f.extents is None, f.klass), []).append(f)
        if not fetches:
            return
        n_subreads = sum(len(f.waiters) for f in fetches)
        if reason is None:
            reason = ("window" if len(fetches) > 1 or n_subreads > 1
                      else "idle")
        fspan = None
        tops = [sp for f in fetches for sp in f.tspans]
        if tops:
            lead = tops[0]
            fspan = lead._tracer.start(
                "ec-read-flush", parent=lead.ctx, peer=peer,
                n_items=len(fetches), n_subreads=n_subreads,
                reason=reason)
            for f in fetches:
                f.fspan_id = fspan.span_id
                for sp in f.tspans:
                    sp.tag("flush_span", fspan.span_id)
                    sp.tag("flush_reason", reason)
                    sp.finish()
                f.tspans = []
        self._inc("ec_read_msgs")
        self._inc("ec_read_fetches", len(fetches))
        self._inc("ec_read_coalesced_subreads", n_subreads)
        self._inc(f"ec_read_flush_{reason}")
        if klass == "recovery":
            self._inc("ec_read_repair_msgs")
        if self._perf is not None:
            self._perf.hinc("ec_read_fetches_per_msg", len(fetches))
            self._perf.hinc("ec_read_subreads_per_msg", n_subreads)
        items = [(f.fid, f.oid, f.shard,
                  None if f.extents is None else list(f.extents))
                 for f in fetches]
        try:
            sent = self._daemon.messenger.send_message(
                peer, MSubReadN(items, pgid, klass=klass))
        except Exception:  # noqa: BLE001 - racing daemon shutdown
            sent = False
        if fspan is not None:
            fspan.tag("sent", bool(sent))
            fspan.finish()
        if not sent:
            # peer gone: no reply will ever come — drop the fetches now
            # (the pending reads complete from the surviving shards or
            # expire through the normal sweep, same as a dropped
            # MSubRead)
            with self._lock:
                for f in fetches:
                    self._drop_locked(peer, f)

    def _drop_locked(self, peer: str, f: _ReadFetch) -> None:
        self._inflight.pop(f.fid, None)
        key = self._key(peer, f.pgid, f.oid, f.shard, f.extents is None,
                        f.klass)
        lst = self._inflight_keys.get(key)
        if lst is not None:
            if f in lst:
                lst.remove(f)
            if not lst:
                self._inflight_keys.pop(key, None)

    # ------------------------------------------------------------- reply
    def on_reply(self, peer: str, items: list) -> None:
        """Route one MSubReadReplyN: resolve each fetch, carve every
        waiter's slices out of the union buffer, and deliver through
        the daemon's normal shard-read completion.  When one reply
        completes MANY pending reads their completions run on their
        own threads, so degraded decodes triggered by the same wire
        message coalesce in the ECBatcher instead of serializing
        behind each other's batch windows."""
        resolved = []  # (fetch, shard, result, data, attrs)
        with self._lock:
            for fid, shard, result, data, attrs in items:
                f = self._inflight.get(fid)
                if f is None:
                    continue
                self._drop_locked(peer, f)
                resolved.append((f, shard, result, data, attrs))
        # carve OUTSIDE the lock: the per-waiter slice copies are the
        # expensive part and must not stall concurrent submit()/flush
        # traffic on this OSD (a dropped fetch's waiter list is ours
        # alone once it leaves the in-flight index)
        deliveries = []  # (tid, shard, result, data, attrs)
        for f, shard, result, data, attrs in resolved:
            for tid, want in f.waiters:
                payload = (_carve_extents(f.extents, data, want)
                           if result == 0 else data)
                deliveries.append((tid, shard, result, payload, attrs))
        if len(deliveries) <= 1:
            for d in deliveries:
                self._daemon._on_shard_read(*d)
            return
        # fan the completions out without blocking the dispatch worker
        # (a degraded completion sits out the decode batch window), on
        # persistent pool threads so same-signature decodes triggered
        # by ONE wire message coalesce in the ECBatcher instead of
        # serializing
        pool = self._pool
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor
            with self._lock:
                if self._stopped:
                    pool = None  # shutting down: never recreate
                else:
                    if self._pool is None:
                        self._pool = ThreadPoolExecutor(
                            max_workers=8,
                            thread_name_prefix=(
                                f"ec-read-{self._daemon.name}"))
                    pool = self._pool
        if pool is None:
            for d in deliveries:
                self._daemon._on_shard_read(*d)
            return
        for d in deliveries:
            try:
                pool.submit(self._daemon._on_shard_read, *d)
            except RuntimeError:
                # stop() shut the pool down between our read of
                # self._pool and this submit: deliver inline so no
                # pending read silently hangs until the sweep
                self._daemon._on_shard_read(*d)

    # ---------------------------------------------------------- lifecycle
    def pending(self) -> int:
        with self._lock:
            return (sum(len(q) for q in self._queued.values())
                    + len(self._inflight))

    def sweep(self, now: float, max_age: float) -> None:
        """Heartbeat-thread GC: drop in-flight fetches whose peer died
        after the send (their waiters' pending reads expire through
        the daemon's own sweep; this only frees the fetch state)."""
        with self._lock:
            for fid, f in list(self._inflight.items()):
                if now - f.stamp > max_age:
                    self._inflight.pop(fid, None)
            for key, lst in list(self._inflight_keys.items()):
                lst[:] = [f for f in lst if f.fid in self._inflight]
                if not lst:
                    self._inflight_keys.pop(key, None)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._deadlines.clear()
            pool, self._pool = self._pool, None
            self._cv.notify_all()
        if pool is not None:
            pool.shutdown(wait=False)


class OSDDaemon(ObjOpsMixin, ScrubMixin, SnapMixin, Dispatcher):
    def __init__(self, osd_id: int, network: Network,
                 mon: str = "mon.0", store: ObjectStore | None = None,
                 cfg: Config | None = None, host: str | None = None,
                 mons: list | None = None, auth=None):
        self.osd_id = osd_id
        # cephx gate (OSD::ms_verify_authorizer + OSDCap enforcement
        # role): a ServiceVerifier for the "osd" service, or None for
        # an authorization-free cluster
        self.auth = auth
        self.name = f"osd.{osd_id}"
        self.host = host or f"host{osd_id}"
        self._mons = list(mons) if mons else [mon]
        self._mon_idx = 0
        self.mon = self._mons[0]
        self.cfg = cfg or default_config()
        self.store = store or ObjectStore.create("memstore")
        # KV metadata tier: fill unset knobs (backend, memtable/cache
        # budgets, background maintenance) from config and land the
        # maintenance telemetry on kv.<daemon> — before mount, which
        # is what opens the KV (a no-op for KV-less backends)
        self.store.configure_kv(self.cfg, name=self.name)
        self.store.mount()
        # async group-commit pipeline (store_sync_commit=on pins the
        # inline path): queue_transaction returns after the in-RAM
        # apply; client/EC/recovery commit replies ride the on_commit
        # continuations (commit_barrier) so op workers never block on
        # a device fsync, and N concurrent writers share one
        # (mclock-only: completion continuations re-enter through the
        # sharded scheduler to keep the per-PG serialization invariant;
        # fifo's inline dispatch has no shard to route them to)
        self._store_async = str(
            self.cfg["store_sync_commit"]).lower() not in (
            "on", "true", "1", "yes") \
            and self.cfg["osd_op_queue"] == "mclock"
        if self._store_async:
            self.store.enable_async(
                name=self.name,
                throttle_bytes=self.cfg["store_throttle_bytes"],
                throttle_ops=self.cfg["store_throttle_ops"],
                window_us=self.cfg["store_batch_window_us"],
                window_min_us=self.cfg["store_batch_window_min_us"],
                window_max_us=self.cfg["store_batch_window_max_us"],
                target_txns=self.cfg["store_batch_target_txns"],
                adaptive=str(self.cfg["store_batch_adaptive"]).lower()
                == "on")
        # fifo op-queue mode executes client ops INLINE on the dispatch
        # thread with no per-PG serialization — it is only safe with
        # exactly one worker (mclock mode re-serializes through the
        # ShardedScheduler, so it gets the full worker count)
        n_workers = (1 if self.cfg["osd_op_queue"] == "fifo"
                     else self.cfg["ms_dispatch_workers"])
        self.messenger = Messenger(
            network, self.name,
            Policy.stateless_server(self.cfg["osd_client_message_cap"]),
            workers=n_workers)
        self.messenger.add_dispatcher(self)
        # dedicated heartbeat endpoint (the hb_front/hb_back messenger
        # role, src/ceph_osd.cc:550-630): liveness probes must never queue
        # behind bulk shard IO on the data dispatch thread
        self.hb_messenger = Messenger(network, f"{self.name}.hb",
                                      Policy.lossless_peer())
        self.hb_messenger.add_dispatcher(self)
        self.osdmap: OSDMap | None = None
        self._tids = itertools.count(1)
        # pending tables are touched by the dispatch thread AND the
        # heartbeat sweep; ownership transfers happen under this lock
        self._pending_lock = threading.Lock()
        self._pending_writes: dict[int, _PendingWrite] = {}
        self._pending_reads: dict[int, _PendingRead] = {}
        self._pg_versions: dict[PgId, int] = {}
        self._ec_codecs: dict[int, ec.ErasureCode] = {}
        self._stripes: dict[int, StripeInfo] = {}
        self._pglogs: dict[PgId, PGLog] = {}
        self._pg_lc: dict[PgId, int] = {}  # last-complete contiguity pt
        # past-intervals peering state (PeeringState.h:1485 PastIntervals
        # + last_epoch_started fence): membership history per PG, durable
        # in the PG meta omap, driving the prior-set query on promotion
        self._past_intervals: dict[PgId, PastIntervals] = {}
        self._pg_les: dict[PgId, int] = {}
        self._peering_epoch: dict[PgId, int] = {}  # epoch of the round
        # non-blocking fence rounds: after recovery drains, the les
        # fence needs one clean round of answers — but routine recovery
        # completion must not re-block client IO, so these rounds drain
        # a shadow waiting set instead of the peering gate
        self._fence_round: dict[PgId, set[int]] = {}
        # epoch the in-flight sub-op was minted under by its primary —
        # per-thread because non-mclock dispatch runs handlers on the
        # connection reader threads concurrently
        self._sub_epoch = threading.local()
        # peering reconciliation: collected peer inventories + log
        # positions this round
        self._peer_invs: dict[PgId, dict[int, dict]] = {}
        self._peer_lcs: dict[PgId, dict[int, int]] = {}
        self._reconcile_at: dict[PgId, float] = {}
        # the version counter when the PG's last blocking round closed:
        # versions past it are this primary's writes of the interval,
        # which the round's inventories predate (_reconcile_ec)
        self._round_closed_at: dict[PgId, int] = {}
        # hot shard extents for the partial-write pipeline
        # (ECExtentCache role): serves the delta path's old-byte reads,
        # the rmw row reads and hot-object client reads.  The attached
        # DeviceArena is the device half of the stripe plane: runs a
        # torch-pool read feeds back into a folded launch stay resident
        # on the card under ec_arena_max_bytes instead of re-staging
        # per op, and every invalidation path below evicts the device
        # copy with the host one.  _pool_codec builds one arena a
        # device, on the device of a torch pool's codec: an OSD that
        # serves only native or numpy pools never stages a byte
        self._ec_arena_lock = threading.Lock()
        #: the last ops the osd_op_timeout sweep failed, described
        self.timed_out_ops: collections.deque = collections.deque(
            maxlen=32)
        #: ops that waited on an OSD a map marked down, answered at once
        #: (_reset_ops_on_down: writes EAGAIN, sub-reads as failed reads)
        self.ops_reset_on_down = 0
        #: the newest epoch of a peering query this OSD answered, a PG:
        #: a client op it admitted under an older map is refused
        #: (EAGAIN), since the new primary peered on an inventory
        #: without that op (Ceph's replica leaves an interval it has
        #: answered for; _handle_pg_query, _handle_client_op)
        self._answered_epoch: dict[PgId, int] = {}
        #: a PG's guard: the inventory an answer walks and a client
        #: op's check-and-apply never interleave (the deferred answer
        #: runs on a timer thread, not the PG's shard)
        self._pg_guards: dict[PgId, threading.RLock] = {}
        #: client ops refused because they were admitted under a map
        #: older than a peering query answered for their PG
        self.ops_refused_handed_over = 0
        self._ec_cache = ECExtentCache(
            on_evict=lambda: self.perf.inc("ec_read_tier_evict"))
        # hot-read tier admission state (zipf-aware second-hit
        # promotion): an object's first read only RECORDS it here; the
        # second read within the LRU window admits its shards into
        # _ec_cache so later reads assemble from cache/card.  Bounded
        # LRU — a scan workload churns through without admitting.
        self._tier_seen: collections.OrderedDict = collections.OrderedDict()
        self._tier_lock = threading.Lock()
        # read-lease state (this OSD as the GRANTING server, primary or
        # balanced holder): per-object read-rate EWMA drives the grant
        # decision; _lease_grants tracks outstanding grants so a write
        # can fan "_lease" revokes.  On a balanced holder the grant is
        # also registered at the primary (MLeaseRegister) — the primary
        # orders writes, so it must know every grant.
        self._lease_lock = threading.Lock()
        self._read_ewma: collections.OrderedDict = collections.OrderedDict()
        self._lease_grants: dict[tuple, dict[str, float]] = {}
        # (pgid, oid) -> count of sub-writes currently being applied on
        # THIS shard holder (guarded by _wbar_lock): the hot-tier
        # admission fence for balanced holders, where the primary-only
        # _obj_locks registry can't see writes in flight
        self._subw_inflight: dict[tuple, int] = {}
        self._hb_last: dict[int, float] = {}
        self._last_map = time.time()  # osd_beacon staleness clock
        self._hb_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._tombstones: dict[PgId, dict[str, int]] = {}
        # peering-lite state (PeeringState FSM role): PGs whose primary is
        # waiting for member inventories block IO with EAGAIN, and objects
        # the primary knows it is behind on stay blocked until pulled
        self._peering: dict[PgId, set[int]] = {}
        self._stale_objects: dict[PgId, dict[str, int]] = {}
        # epoch whose FULL application (collections ensured, PGs
        # split/merged) has completed — self.osdmap.epoch moves at the
        # START of _handle_map, and peering answers must not race the
        # split/merge window in between
        self._applied_epoch = 0
        # freshly-split PGs (parents and children): their members share
        # the parent's last-complete, so the LEAN peering path would
        # skip the inventory exchange that redistributes shards — force
        # full inventories until one round closes clean
        self._split_fresh: set[PgId] = set()
        # per-object write serialization for multi-phase EC ops (the obc
        # lock / ECExtentCache ordering role): queued thunks per key
        self._obj_locks: dict[tuple, object] = {}
        # read barrier for the sub-read aggregator's in-flight dup
        # collapse: last acked-write sequence per (pgid, oid), bounded
        # LRU; _obj_wfloor upper-bounds every evicted entry so a miss
        # stays conservative (see _obj_written_since)
        self._wbar_lock = threading.Lock()
        self._obj_wseq = 0
        self._obj_wlast: collections.OrderedDict = collections.OrderedDict()
        self._obj_wfloor = 0
        self._requery_at: dict[tuple, float] = {}
        self._requery_timers: dict[tuple, object] = {}
        # (pgid, name, shard, target) -> whether a later round wanted it
        # too: the shard rebuilds a peering round scheduled whose fetch
        # has not returned (_claim_rebuild)
        self._rebuilds_out: dict[tuple, bool] = {}
        self._pending_scrubs: dict = {}
        # background deep-scrub state per hosted PG (cursor persists in
        # the PG's scrub meta object; this is only the pacing side)
        self._scrub_auto: dict = {}
        # recovery reservations + initiation throttle (AsyncReserver /
        # osd_max_backfills / osd_recovery_max_active roles): bulk
        # recovery data movement queues behind a per-PG local
        # reservation, a per-(PG,target) remote grant, and a bounded
        # in-flight op count with optional sleep pacing
        self._local_reserver = AsyncReserver(self.cfg["osd_max_backfills"])
        self._remote_reserver = AsyncReserver(self.cfg["osd_max_backfills"])
        self._local_waiting: dict[PgId, list] = {}
        self._remote_waiting: dict[tuple, list] = {}
        self._remote_held: set = set()
        self._remote_pending_at: dict[tuple, float] = {}
        self._recovery_q: collections.deque = collections.deque()
        self._recovery_inflight = 0
        self._recovery_pg_ops: dict[PgId, int] = {}
        self.inject = FaultInjection()
        # slow-op complaint threshold + historic ring are operator
        # knobs (the reference's osd_op_complaint_time /
        # osd_op_history_size), not hardcoded tracker defaults.  The
        # on_slow hook is the flight recorder: an op crossing the
        # complaint time (at finish or mid-flight via the tick sweep)
        # journals a slow_op cluster event after its trace — sampled
        # or retroactively promoted — is already retained.
        self.op_tracker = OpTracker(
            history_size=self.cfg["osd_op_history_size"],
            slow_op_seconds=self.cfg["osd_op_complaint_time"],
            on_slow=self._note_slow_op)
        # cluster event journal (LogClient role): PG state transitions,
        # recovery progress, scrub results and batcher regime changes
        # emitted here ride the stats reports to the mon, which merges
        # them into the cluster log (`dump_cluster_log` / event_tool)
        self.events = EventLog(self.name,
                               keep=self.cfg["osd_event_log_size"])
        # per-PG recovery storm accounting feeding the recovery channel
        # (and, through the mon, the mgr progress module): ops scheduled
        # vs completed since the storm opened; guarded by _pending_lock
        self._rec_progress: dict[PgId, dict] = {}
        self._init_objops()
        self._init_snaps()
        self._handlers = {
            MScrubRequest: self._handle_scrub_request,
            MScrubShard: self._handle_scrub_shard,
            MScrubMap: self._handle_scrub_map,
            MMapPush: self._handle_map,
            MOSDOp: self._handle_client_op,
            MSubWrite: self._handle_sub_write,
            MSubPartialWrite: self._handle_sub_partial_write,
            MSubDelta: self._handle_sub_delta,
            MSubWriteReply: self._handle_sub_write_reply,
            MSubRead: self._handle_sub_read,
            MSubReadN: self._handle_sub_read_n,
            MSubReadReply: self._handle_sub_read_reply,
            MSubReadReplyN: self._handle_sub_read_reply_n,
            MPGList: self._handle_pg_list,
            MOSDPing: self._handle_ping,
            MOSDPingReply: self._handle_ping_reply,
            MPGQuery: self._handle_pg_query,
            MPGInfo: self._handle_pg_info,
            MPGPull: self._handle_pg_pull,
            MPGPush: self._handle_pg_push,
            MPGRollback: self._handle_pg_rollback,
            MRecoveryReserve: self._handle_recovery_reserve,
            MNotifyAck: self._handle_notify_ack,
            MLeaseRegister: self._handle_lease_register,
        }
        self.perf = global_perf().create(self.name)
        # head-sampled distributed tracing: trace_sample_rate draws the
        # root decision (config-LIVE via the observer — `config set`
        # over the admin socket retunes a running daemon), and the
        # trace_sampled/trace_dropped/trace_leaked counters land on
        # this registry so the exporter and metrics history see them
        self.tracer = Tracer(self.name,
                             sample_rate=self.cfg["trace_sample_rate"],
                             perf=self.perf)
        self.cfg.observe("trace_sample_rate",
                         lambda _n, v: self.tracer.set_sample_rate(v))
        # recovery-storm root spans (per-PG, opened at storm start,
        # finished at recovery_done) — guarded by _pending_lock
        self._rec_spans: dict[PgId, object] = {}
        # metrics history: periodic snapshots of this daemon's perf
        # registries (its own + its messengers'), sampled on the
        # heartbeat tick and shipped inside the stats reports for the
        # mon to merge (utils/metrics_history.py)
        self.metrics_history = MetricsHistory(
            keep=self.cfg["metrics_history_keep"],
            downsample_age=self.cfg["metrics_history_downsample_age"])
        self._metrics_sampled_at = 0.0
        # dynamic perf queries (telemetry/perf_query): the attribution
        # accumulator bank on the client-op dispatch path, converged
        # from the OSDMap's perf_queries tail; snapshots ride the
        # stats reports for the mon to merge
        from ..telemetry.perf_query import PerfQuerySet
        self.perf_queries = PerfQuerySet()
        # admin-socket directory for cross-daemon trace collection
        # (the PR-7 shared resolver); set by the harness / osd_main
        # when admin sockets exist
        self.asok_dir: str | None = None
        self.perf.add_many(["op_w", "op_r", "op_rw_bytes", "subop_w",
                            "subop_r", "recovery_push", "recovery_delta",
                            "rollbacks", "failure_reports",
                            "scrubs", "scrub_errors", "ec_cache_hit",
                            "ec_cache_miss", "ec_read_cache_hit",
                            # client and recovery ops failed by the
                            # osd_op_timeout sweep
                            "op_timeouts",
                            "ec_rmw_cache_serves", "map_inc", "map_full",
                            "snap_trims",
                            # repair-bandwidth accounting: bytes fetched
                            # over the wire to rebuild shards vs bytes
                            # of shard actually rebuilt — the repair-
                            # bytes-per-lost-byte ratio per daemon —
                            # plus how rebuilds were served (narrow
                            # locality set / sub-chunk ranges / whole-
                            # shard wide) and narrow attempts that had
                            # to retry wide
                            "recovery_fetch_bytes",
                            "recovery_rebuilt_bytes",
                            "recovery_narrow_rebuilds",
                            "recovery_subchunk_rebuilds",
                            "recovery_wide_retries",
                            # continuous folded deep scrub (osd/scrub.py
                            # auto-scrub scheduler + the ECBatcher
                            # verify op kind)
                            "scrub_verified_bytes",
                            "scrub_verify_launches",
                            "scrub_mismatches",
                            "scrub_digest_missing",
                            "scrub_auto_chunks"])
        # inline store compression decision/ratio telemetry
        self.perf.add_many(compression.COUNTERS)
        # read scale-out: hot-tier admission telemetry, lease
        # grant/revoke flow, balanced (non-primary) read serving —
        # shared schema with tools/prom_rules.py's rate rules
        register_read_scaleout_counters(self.perf)
        self.perf.add("op_lat", CounterType.TIME)
        # end-to-end client-op latency as a pow2 histogram (the SLO
        # `client_op` signal); sampled ops pin exemplars on buckets.
        # The tracker predates the registry, hence the late bind.
        self.perf.add("op_lat_us", CounterType.HISTOGRAM)
        self.op_tracker.bind_perf(self.perf, "op_lat_us")
        # cross-op EC batching (ec/batcher.py): concurrent stripe
        # encodes/decodes sharing a (matrix, k, m) signature coalesce
        # into ONE folded kernel launch within a small window; engaged
        # per codec by _ec_batch_on (torch backend only by default), with
        # the window self-sizing from the observed ops-per-launch when
        # ec_batch_adaptive is on and the folded launch fanning across
        # the device mesh per the codec's ec_shard resolution.  The
        # batcher registers its launch/flush/shard counters on this
        # OSD's perf registry — zeroed even when batching is off, so
        # `perf dump` and the exporter expose one stable schema.
        self._ec_batcher = ECBatcher(
            window_us=self.cfg["ec_batch_window_us"],
            max_bytes=self.cfg["ec_batch_max_bytes"],
            adaptive=self.cfg["ec_batch_adaptive"] == "on",
            target_ops=self.cfg["ec_batch_target_ops"],
            window_min_us=self.cfg["ec_batch_window_min_us"],
            window_max_us=self.cfg["ec_batch_window_max_us"],
            perf=self.perf, events=self.events)
        # sub-read aggregator (the message half of the EC read
        # pipeline): concurrent MSubReads headed to one peer coalesce
        # into MSubReadN wire messages within ec_read_window_us, with
        # duplicate in-flight fetches collapsed and overlapping hot-
        # object extents merged into union ranges.  Engaged per pool by
        # _ec_read_coalesce_on; counters registered zeroed regardless,
        # one stable perf/exporter schema.
        self.perf.add_many(READ_AGG_COUNTERS)
        for h in READ_AGG_HISTOGRAMS:
            self.perf.add(h, CounterType.HISTOGRAM)
        self._read_agg = SubReadAggregator(
            self, window_us=self.cfg["ec_read_window_us"],
            max_items=self.cfg["ec_read_max_items"], perf=self.perf)
        # op scheduler (OpScheduler/mClockScheduler role): the messenger
        # thread classifies+enqueues; ONE dequeue worker executes
        # handlers, preserving single-threaded handler semantics while
        # recovery/scrub traffic is QoS-shaped against client ops
        # peering traffic (MPGQuery/MPGInfo/MPGRollback) is deliberately
        # NOT background: client IO blocks on peering completing, so
        # throttling it would be a priority inversion (the reference
        # serves peering at immediate priority).  Recovery QoS shapes
        # the BULK payload movement: pushes and pulls.
        # end-to-end class tagging: client sub-reads queue as client
        # work on the serving peer, recovery shard fetches (MSubRead
        # klass="recovery") and pushes/pulls as recovery — so a rebuild
        # storm's READS are shaped by the same knobs as its pushes.
        # Sub-writes and replies stay system: they complete client ops
        # already admitted under the client class, and double-queueing
        # the commit path behind a limit would just inflate latency.
        self._op_classes = {
            MOSDOp: "client",
            MSubRead: "client", MSubReadN: "client",
            MPGPush: "recovery", MPGPull: "recovery",
            MScrubRequest: "scrub", MScrubShard: "scrub",
            MScrubMap: "scrub",
        }
        self._use_mclock = self.cfg["osd_op_queue"] == "mclock"
        # always constructed (zeroed QoS counter schema even under
        # fifo); per-class served/dropped/depth/qwait land on self.perf.
        # Tenant profiles arrive with the OSDMap (we have none at
        # construction); unknown tenants ride the default profile and
        # counter cardinality is LRU-bounded by osd_qos_max_tenants.
        self.scheduler = ShardedScheduler(
            self._run_scheduled, self._mclock_params(),
            shards=self.cfg["osd_op_num_shards"],
            name=f"mclock-{self.name}", perf=self.perf,
            max_tenants=self.cfg["osd_qos_max_tenants"])

    def _mclock_params(self) -> dict[str, ClassParams]:
        """Current (R, W, L) per QoS class from config — built at
        construction and re-read by the `reset_mclock` verb so a
        reservation sweep can retune a LIVE daemon."""
        return {
            "client": ClassParams(self.cfg["osd_mclock_client_res"],
                                  self.cfg["osd_mclock_client_wgt"],
                                  self.cfg["osd_mclock_client_lim"]),
            "recovery": ClassParams(
                self.cfg["osd_mclock_recovery_res"],
                self.cfg["osd_mclock_recovery_wgt"],
                self.cfg["osd_mclock_recovery_lim"]),
            "scrub": ClassParams(self.cfg["osd_mclock_scrub_res"],
                                 self.cfg["osd_mclock_scrub_wgt"],
                                 self.cfg["osd_mclock_scrub_lim"]),
            # system (maps, sub-ops, replies): effectively unthrottled
            "system": ClassParams(1e9, 1e6, 0.0),
        }

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._use_mclock:
            self.scheduler.start()
        self.messenger.start()
        self.hb_messenger.start()
        net = self.messenger.network
        self.messenger.send_message(
            self.mon,
            MOSDBoot(self.osd_id, self.host, net.addr_of(self.name),
                     hb_addr=net.addr_of(self.hb_messenger.name)))
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name=f"hb-{self.name}", daemon=True)
        self._hb_thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._pending_lock:
            timers = list(self._requery_timers.values())
            self._requery_timers.clear()
        for t in timers:
            t.cancel()  # a dead daemon must not keep querying peers
        self._read_agg.stop()
        # drain the store commit pipeline: queued acks fire (or are
        # dropped by the dead messenger) before the sockets close, and
        # the per-store registry leaves the global collection with us
        if self._store_async:
            self.store.disable_async()
        self.messenger.shutdown()
        self.hb_messenger.shutdown()
        if self._use_mclock:
            self.scheduler.shutdown()
        # leave the global collection like the messengers and KV tier
        # do: a later daemon reusing this name (same-process restart,
        # or the next test cluster) must start from zeroed counters,
        # not inherit this incarnation's trace_sampled/op counts
        global_perf().remove(self.name)

    # -------------------------------------------------- admin socket verbs
    def admin_command(self, cmd: str, **kw):
        """Per-daemon operator commands (the AdminSocket capability,
        src/common/admin_socket.cc: perf dump, dump_ops_in_flight, ...)."""
        if cmd == "perf dump":
            return self.perf.dump()
        if cmd == "dump_ops_in_flight":
            return self.op_tracker.dump_ops_in_flight()
        if cmd == "dump_tracing":
            tid = kw.get("trace_id")
            return self.tracer.dump(int(tid) if tid is not None
                                    else None)
        if cmd == "dump_historic_ops":
            return self.op_tracker.dump_historic_ops()
        if cmd == "dump_slow_ops":
            return self.op_tracker.slow_ops()
        if cmd == "dump_historic_slow_ops":
            # the flight-recorder face: each traced entry carries its
            # full merged trace — local ring + every peer daemon's via
            # the shared admin-socket resolver — so "what did this
            # slow op actually do" is answerable after the fact.
            # `max` tail-caps the entries; peers are queried ONCE for
            # the whole trace-id set (a slow-op storm must not turn
            # this verb into entries x peers serial round-trips)
            entries = [dict(d)
                       for d in self.op_tracker.dump_historic_slow_ops()]
            cap = int(kw.get("max", 0) or 0)
            if cap and len(entries) > cap:
                entries = entries[-cap:]
            if kw.get("traces", True):
                tids = {int(d["trace_id"]) for d in entries
                        if d.get("trace_id")}
                index = self._collect_traces(tids) if tids else {}
                for d in entries:
                    tid = d.get("trace_id")
                    if tid:
                        d["trace"] = index.get(int(tid), [])
            return entries
        if cmd == "dump_metrics_history":
            return self.metrics_history.dump(
                registry=kw.get("registry"),
                max_samples=int(kw.get("max", 0) or 0))
        if cmd == "metrics_query":
            return self.metrics_history.query(
                kw.get("registry") or self.name, kw["counter"],
                since_s=float(kw.get("since_s", 60.0)),
                until_s=float(kw.get("until_s", 0.0)),
                start_ts=(float(kw["start_ts"])
                          if kw.get("start_ts") is not None else None),
                end_ts=(float(kw["end_ts"])
                        if kw.get("end_ts") is not None else None))
        if cmd == "dump_kernel_profile":
            from ..utils.perf import kernel_profiler
            return kernel_profiler().dump()
        if cmd == "dump_perf_queries":
            # the dynamic perf-query accumulator bank: active specs +
            # this daemon's cumulative rows (the mon's merged view is
            # `perf query report`)
            return self.perf_queries.dump()
        if cmd == "dump_events":
            return self.events.recent(
                n=int(kw["max"]) if kw.get("max") else None,
                channel=kw.get("channel"))
        if cmd == "dump_messenger":
            return {"data": self.messenger.dump_state(),
                    "hb": self.hb_messenger.dump_state()}
        if cmd == "dump_kv_stats":
            # the KV metadata tier's maintenance face (memtable seal
            # depth, level shape, stall/cache tallies); None-shaped for
            # backends without one (memstore/filestore)
            return {"store": type(self.store).__name__.lower(),
                    "kv": self.store.kv_stats()}
        if cmd == "config show":
            return self.cfg.dump()
        if cmd == "dump_op_queue":
            return {"mode": "mclock" if self._use_mclock else "fifo",
                    "shards": len(self.scheduler.shards),
                    "depth": self.scheduler.queue_depth(),
                    "depths": self.scheduler.queue_depths(),
                    "served": dict(self.scheduler.served),
                    "dropped": dict(self.scheduler.dropped),
                    "tenants": self.scheduler.tenant_depths(),
                    "tenant_served":
                        dict(self.scheduler.tenant_served)}
        if cmd == "reset_mclock":
            # re-read osd_mclock_* from config and retune the LIVE
            # scheduler (the reservation-sweep knob AND the adaptive
            # controller's actuator: `config set` the new values, then
            # this verb applies them without a restart); the tenant
            # profile book re-pushes from the current map too
            params = self._mclock_params()
            for klass, p in params.items():
                self.scheduler.set_params(klass, p)
            if self.osdmap is not None:
                from ..qos.profiles import params_from_map
                self.scheduler.set_tenant_profiles(params_from_map(
                    getattr(self.osdmap, "qos_profiles", {})))
            return {"applied": {k: {"reservation": p.reservation,
                                    "weight": p.weight,
                                    "limit": p.limit}
                                for k, p in params.items()}}
        if cmd == "config set":
            self.cfg.set(kw["name"], kw["value"])
            return {"success": True}
        if cmd == "status":
            return {"osd": self.osd_id,
                    "epoch": self.osdmap.epoch if self.osdmap else 0,
                    "num_pgs": sum(1 for _ in self._pools_pgs_for_me()),
                    "pending_writes": len(self._pending_writes),
                    "pending_reads": len(self._pending_reads)}
        raise ValueError(f"unknown admin command {cmd!r}")

    # ------------------------------------------------------------- dispatch
    def ms_dispatch(self, conn, msg) -> bool:
        handler = self._handlers.get(type(msg))
        if handler is None:
            return False
        # heartbeats stay inline on their own messenger thread: liveness
        # must never queue behind the op scheduler
        if not self._use_mclock or isinstance(msg, (MOSDPing,
                                                    MOSDPingReply)):
            self._sub_epoch.v = 0  # fresh epoch pin per dispatched op
            handler(conn, msg)
            return True
        # a message-carried class wins (recovery-tagged MSubReads);
        # the static table covers everything else
        klass = getattr(msg, "klass", None) \
            or self._op_classes.get(type(msg), "system")
        if klass not in ("client", "recovery", "scrub", "system"):
            klass = "system"  # never KeyError on a peer's future tag
        # only a client's message takes the lossy QUEUE_CAP drop (its
        # client resends): a peer's sub-op reply or peering answer has
        # no retry, and dropping one wedged its op until osd_op_timeout
        # or its PG's peering until the next map
        force = not conn.peer.startswith("client.")
        if klass == "system" and isinstance(
                msg, (MSubWrite, MSubPartialWrite, MSubDelta)) \
                and getattr(msg, "tenant", ""):
            # tenant-tagged replication sub-ops: the shard OSD queues
            # the apply under the originating op's tenant so replica-
            # side load is shaped like the primary's.  force — the
            # commit path has no retry; a QUEUE_CAP drop would wedge
            # the primary's pending write forever.
            klass = "client"
            force = True
        # tenant-tagged client ops land in per-tenant dmclock
        # sub-queues; the shipped (delta, rho) pair advances the
        # tenant's clocks multi-server-correctly (qos/dmclock.py)
        tenant = getattr(msg, "tenant", "") if klass == "client" else ""
        tags = (getattr(msg, "qdelta", 0),
                getattr(msg, "qrho", 0)) if tenant else None
        # sampled-trace ops stamp their trace_id on the queue-wait
        # entry so the mclock_qwait_us_* bucket they land in carries
        # the exemplar
        tr = getattr(msg, "trace", None)
        self.scheduler.enqueue(klass, (handler, conn, msg),
                               key=self._shard_key(msg),
                               tenant=tenant or None, tags=tags,
                               force=force,
                               trace_id=tr[0] if tr else None)
        return True

    def _shard_key(self, msg):
        """Sharded-OpWQ routing key: EVERYTHING about one PG — client
        ops, sub-ops, acks, pushes — executes on one shard, so the
        single-worker ordering every handler was written under still
        holds per PG while distinct PGs run in parallel.  (Object-level
        keys are NOT enough: two objects of one PG would race on the
        unlocked PGLog/lc state, and a sub-op ack could outrun the
        primary's own local apply.)"""
        pgid = getattr(msg, "pgid", None)
        if pgid is not None:
            return (pgid.pool, pgid.seed)
        if isinstance(msg, MOSDOp):
            if self.osdmap is not None and \
                    msg.pool in self.osdmap.pools:
                return (msg.pool,
                        self.osdmap.object_to_pg(msg.pool, msg.oid))
            return (msg.pool, 0)  # no map yet: handler EAGAINs anyway
        return None  # maps/boot/admin: the stable default shard

    def _run_scheduled(self, klass: str, item) -> None:
        handler, conn, msg = item
        self._sub_epoch.v = 0  # fresh epoch pin per dispatched op
        if isinstance(msg, MOSDOp):
            # the scheduler worker published what it is serving just
            # before this call (same thread): remember the phase so
            # the reply can carry it back to the dmclock client
            phase = current_service()[1]
            if phase != PHASE_NONE:
                msg._qos_phase = phase
        handler(conn, msg)

    # ------------------------------------------------------------- mapping
    def _handle_map(self, conn, msg: MMapPush) -> None:
        # ANY push — even a stale/equal epoch answering a beacon
        # re-subscribe — proves the mon link is alive; without this a
        # quiescent cluster's beacons rotate monitors forever
        self._last_map = time.time()
        old = self.osdmap
        from ..mon.maps import apply_map_push
        newmap, request = apply_map_push(old, msg)
        if newmap is None:
            # inc we cannot use: ask for a full map (no map yet — the
            # boot race where our own boot-commit's inc arrives first)
            # or the missing chain (gap)
            if request == "full":
                self.messenger.send_message(
                    self.mon, MMonSubscribe("osdmap"))
            elif request == "chain":
                self.messenger.send_message(
                    self.mon, MMonSubscribe("osdmap",
                                            have_epoch=old.epoch))
            return
        self.perf.inc("map_full" if msg.map_bytes else "map_inc")
        if old is not None and newmap.epoch <= old.epoch:
            return
        self._ready_ec_pools(newmap)
        self.osdmap = newmap
        self._last_map = time.time()
        # tenant QoS profiles ride the map like pool options: push the
        # committed book into the live schedulers on change (unknown
        # tenants keep falling into the default profile)
        new_profiles = getattr(newmap, "qos_profiles", {})
        if old is None or getattr(old, "qos_profiles",
                                  {}) != new_profiles:
            from ..qos.profiles import params_from_map
            self.scheduler.set_tenant_profiles(
                params_from_map(new_profiles))
        # dynamic perf queries converge the same way: the committed
        # query set rides the map; unchanged specs keep their
        # accumulators counting
        new_queries = getattr(newmap, "perf_queries", {})
        if old is None or getattr(old, "perf_queries",
                                  {}) != new_queries:
            self.perf_queries.set_queries(new_queries)
        # drop cached extents only for CACHED PGs whose membership
        # actually changed (an unrelated epoch bump must not cold the
        # cache, and the check is O(cached PGs), not O(cluster PGs))
        if old is None:
            self._ec_cache.clear()
        else:
            for pgid in self._ec_cache.pgids():
                if pgid.pool not in newmap.pools or \
                        pgid.pool not in old.pools or \
                        pgid.seed >= old.pools[pgid.pool].pg_num:
                    self._ec_cache.invalidate(pgid)
                    continue
                if newmap.pg_to_up_osds(pgid.pool, pgid.seed) != \
                        old.pg_to_up_osds(pgid.pool, pgid.seed):
                    self._ec_cache.invalidate(pgid)
        dout("osd", 5)("%s: map epoch %d", self.name, newmap.epoch)
        # learn peer addresses from the map (wire transports; no-op
        # in-proc) — the OSDMap is the address book, as in the reference
        net = self.messenger.network
        for peer, info in newmap.osds.items():
            if info.addr:
                net.set_addr(f"osd.{peer}", info.addr)
            if info.hb_addr:
                net.set_addr(f"osd.{peer}.hb", info.hb_addr)
        # forget heartbeat stamps for peers that (re)joined: a stale
        # pre-death stamp must not flash a revived daemon back down
        for peer, info in newmap.osds.items():
            was_up = old is not None and old.osds.get(peer) is not None \
                and old.osds[peer].up
            if info.up and not was_up:
                self._hb_last.pop(peer, None)
            if not info.up:
                self._hb_last.pop(peer, None)
        # if the map says I am down but I am alive, re-assert (osd re-boot)
        # if the map says I am down — or does not know me at all (my boot
        # was dropped during a mon election) — re-assert
        me = newmap.osds.get(self.osd_id)
        if (me is None or not me.up) and not self._stop.is_set():
            self.messenger.send_message(
                self.mon,
                MOSDBoot(self.osd_id, self.host, net.addr_of(self.name),
                         hb_addr=net.addr_of(self.hb_messenger.name)))
        self._ensure_collections()
        self._reservation_map_change(newmap)
        self._reset_ops_on_down(newmap)
        if old is None or newmap.epoch > old.epoch:
            self._split_pgs(old, newmap)
            self._merge_pgs(old, newmap)
            self._note_intervals()
            try:
                self._start_recovery()
            finally:
                # applied once this map's peering rounds are armed:
                # until then a client op sees the new map but no peering
                # gate (_handle_client_op refuses it), and a peer's
                # query waits
                self._applied_epoch = newmap.epoch
            self._notify_demoted(old)
            self._snap_trim_check()

    def _reservation_map_change(self, newmap: OSDMap) -> None:
        """A recovery target marked down can never grant: fail its
        waiting ops open NOW (the sweep's timeout is the slow path for
        silent deaths the map has not caught yet)."""
        rescued = []
        with self._pending_lock:
            for key in list(self._remote_waiting):
                _pg, target = key
                o = newmap.osds.get(target)
                if o is None or not o.up:
                    self._remote_pending_at.pop(key, None)
                    self._remote_held.add(key)
                    rescued.append((key[0],
                                    self._remote_waiting.pop(key)))
        for pgid, thunks in rescued:
            for t, nb in thunks:
                self._recovery_enqueue(pgid, t, nb)

    def _reset_ops_on_down(self, osdmap: OSDMap | None) -> None:
        """An op waiting on an OSD that ``osdmap`` marks down would wait
        out the osd_op_timeout sweep (Ceph resets a PG's in-flight ops at
        an interval change instead).  A write whose sub-write went there
        fails NOW with EAGAIN, which the client retries on the new map;
        a read's sub-read there is answered as a failed read, so the read
        completes on what the live members send, as it would had that
        OSD refused.  Run on every map, and on every sweep for an op
        registered on the map before (its op thread read the map as it
        changed)."""
        if osdmap is None:
            return
        down = {o for o, info in osdmap.osds.items() if not info.up}
        if not down:
            return
        reset, lost = [], []
        with self._pending_lock:
            for tid, pw in list(self._pending_writes.items()):
                if down.intersection(pw.members):
                    self._pending_writes.pop(tid, None)
                    reset.append(pw)
            for tid, pr in list(self._pending_reads.items()):
                lost += [(tid, shard) for shard, osd in pr.asked.items()
                         if osd in down]
        if reset or lost:
            with self._pending_lock:
                self.ops_reset_on_down += len(reset) + len(
                    {tid for tid, _s in lost})
        self._fail_writes(reset, EAGAIN, osdmap.epoch)
        for tid, shard in lost:
            self._on_shard_read(tid, shard, EIO, b"", {})

    def _fail_writes(self, pws: list, result: int, epoch: int) -> None:
        """Answer the clients of writes taken out of _pending_writes with
        ``result``: each may have landed on some members only, so it is
        noted as a (possibly torn) write and its cached extents dropped,
        and its object lock goes to the next op."""
        for pw in pws:
            self._note_obj_write(pw.lock_key)  # possibly-torn write
            if pw.lock_key is not None:
                self._ec_cache.invalidate(*pw.lock_key)
            if pw.pq_ctx is not None:
                pw.pq_ctx.finish(0)
            self.messenger.send_message(
                pw.client, MOSDOpReply(pw.client_tid, result,
                                       version=pw.version, epoch=epoch))
            self._obj_unlock(pw.lock_key)

    def _notify_demoted(self, old: OSDMap | None) -> None:
        """If I hold objects for PGs I am no longer an up member of, tell
        the current primary what I have (the MNotifyRec / past-intervals
        role): my stranded shards can then be migrated, not lost.  Only
        PGs whose membership actually dropped me are scanned."""
        for cid in self.store.list_collections():
            if cid.pool not in self.osdmap.pools:
                continue
            pool = self.osdmap.pools[cid.pool]
            if cid.pg_seed >= pool.pg_num:
                continue
            up = self.osdmap.pg_to_up_osds(cid.pool, cid.pg_seed)
            if self.osd_id in [u for u in up if u is not None]:
                continue
            if old is not None and cid.pool in old.pools \
                    and cid.pg_seed < old.pools[cid.pool].pg_num \
                    and old.pools[cid.pool].pg_num == pool.pg_num:
                # (a just-split child seed did not EXIST in the old map,
                # and across ANY pg_num change a fold/split just moved
                # objects into this collection — in both cases the old
                # up set says nothing about what we now hold, so fall
                # through and notify the primary of our shards.  A
                # merge-target primary may have closed its peering
                # round against PRE-fold answers; this notify is what
                # heals that hole.)
                old_up = old.pg_to_up_osds(cid.pool, cid.pg_seed)
                if self.osd_id not in [u for u in old_up if u is not None]:
                    continue  # was not a member before either: no change
            primary = self._primary_of(up)
            if primary is None or primary == self.osd_id:
                continue
            pgid = PgId(cid.pool, cid.pg_seed)
            inv = self._inventory(pgid)
            if inv:
                ents = self._pglog(pgid).entries()  # one decode
                self.messenger.send_message(
                    f"osd.{primary}",
                    MPGInfo(pgid, self.osd_id, -2, inv,
                            dict(self._tombstones.get(pgid, {})),
                            head_epoch=ents[-1].epoch if ents else 0,
                            log_evs={e.version: e.epoch
                                     for e in ents},
                            les=self._les(pgid)))

    def _pools_pgs_for_me(self):
        """(pool, pg_seed, up_set, my_positions) for PGs mapping to me."""
        if self.osdmap is None:
            return
        for pool_id, pool in self.osdmap.pools.items():
            for seed in range(pool.pg_num):
                up = self.osdmap.pg_to_up_osds(pool_id, seed)
                if self.osd_id in [u for u in up if u is not None]:
                    yield pool_id, seed, up

    def _ensure_collections(self) -> None:
        have = set(self.store.list_collections())
        for pool_id, seed, _up in self._pools_pgs_for_me():
            cid = CollectionId(pool_id, seed)
            if cid not in have:
                tx = Transaction().create_collection(cid)
                self.store.queue_transaction(tx)

    def _primary_of(self, up: list) -> int | None:
        for u in up:
            if u is not None:
                return u
        return None

    # ----------------------------------------------------------- client ops
    # op -> required cap bits (OSDCap semantics: r read, w mutate,
    # x object-class execution)
    _READ_OPS = frozenset({"read", "stat", "omap_get", "list_snaps",
                           "multi_read", "getxattrs"})
    _EXEC_OPS = frozenset({"call"})

    def _auth_denied(self, m: MOSDOp, pool_name: str) -> str | None:
        """Why this op must be refused (None = authorized).  Ticket
        signature/expiry, per-op proof under the ticket's session key,
        then the entity's caps against the pool."""
        import hmac as _hmac

        from ..auth.cephx import op_proof
        vt = self.auth.verify(m.ticket)
        if vt is None:
            return "no/invalid/expired osd ticket"
        want = op_proof(vt.session_key, m.tid, m.pool, m.oid, m.op,
                        m.offset, m.length, m.data)
        if not _hmac.compare_digest(want, m.proof):
            return "bad op proof"
        if m.op in self._READ_OPS:
            need = "r"
        elif m.op in self._EXEC_OPS:
            need = "x"
        else:
            need = "w"
        if not vt.caps.allows(need, pool=pool_name):
            return (f"entity {vt.entity} lacks caps {need!r} on pool "
                    f"{pool_name}")
        return None

    def _handle_client_op(self, conn, m: MOSDOp) -> None:
        if self.osdmap is None or m.pool not in self.osdmap.pools:
            # the client's map may be AHEAD of ours (pool just created,
            # our push still in flight): EAGAIN retries; only a pool
            # unknown at the client's own epoch is truly ENOENT
            my_epoch = self.osdmap.epoch if self.osdmap else 0
            err = EAGAIN if m.epoch > my_epoch else ENOENT
            conn.send(MOSDOpReply(m.tid, err, epoch=my_epoch))
            return
        pool = self.osdmap.pools[m.pool]
        if self.auth is not None:
            why = self._auth_denied(m, pool.name)
            if why is not None:
                dout("osd", 2)("osd.%d: op %s from %s DENIED: %s",
                               self.osd_id, m.op, m.client, why)
                conn.send(MOSDOpReply(m.tid, EACCES,
                                      epoch=self.osdmap.epoch))
                return
        # the map this op is admitted under (the primary check below)
        admit_epoch = self.osdmap.epoch
        seed = self.osdmap.object_to_pg(m.pool, m.oid)
        up = self.osdmap.pg_to_up_osds(m.pool, seed)
        pgid = PgId(m.pool, seed)
        balanced = False
        if self._primary_of(up) != self.osd_id:
            # balanced reads (pool read_policy=balance): a non-primary
            # shard holder serves plain head reads itself — everything
            # else (writes, snap reads, pools that did not opt in)
            # bounces ESTALE so the client re-targets the primary
            if self._balanced_read_ok(m, pool, up):
                balanced = True
            else:
                conn.send(MOSDOpReply(m.tid, ESTALE,
                                      epoch=self.osdmap.epoch))
                return
        if self._applied_epoch < admit_epoch:
            # the map is published but its peering rounds are not armed
            # yet (_handle_map): as a new primary I would answer from a
            # store that has not peered, ENOENT for an acked write
            conn.send(MOSDOpReply(m.tid, EAGAIN, epoch=self.osdmap.epoch))
            return
        # peering gate: block IO until inventories (and the objects we are
        # known to be behind on) have caught up — read-your-writes safety
        if pgid in self._peering or (
                m.oid in self._stale_objects.get(pgid, ())):
            conn.send(MOSDOpReply(m.tid, EAGAIN, epoch=self.osdmap.epoch))
            return
        with self._pg_guard(pgid):
            if self._answered_epoch.get(pgid, 0) > admit_epoch:
                # I answered a newer map's peering query for this PG:
                # its new primary closed peering on my inventory, which
                # lacks this op.  Acked here, a write would be unknown
                # to that primary, which answers ENOENT for it.  The
                # client retries on the new map.
                self.ops_refused_handed_over += 1
                conn.send(MOSDOpReply(m.tid, EAGAIN,
                                      epoch=self.osdmap.epoch))
                return
            self._run_client_op(conn, m, pool, pgid, up, balanced)

    def _pg_guard(self, pgid: PgId) -> threading.RLock:
        g = self._pg_guards.get(pgid)
        if g is None:
            g = self._pg_guards.setdefault(pgid, threading.RLock())
        return g

    def _run_client_op(self, conn, m: MOSDOp, pool, pgid: PgId, up: list,
                       balanced: bool) -> None:
        """An admitted client op: the lease revoke, its span, and the
        handler of its op and pool kind."""
        if m.op in self._LEASE_REVOKE_OPS:
            # write choke point (primary only — mutations never ride the
            # balanced path): drop + notify every outstanding read lease
            # on the object BEFORE the mutation dispatches, so a leased
            # client's staleness window is revoke-latency, not TTL
            self._lease_revoke(pgid, m.oid)
        if m.trace:
            # distributed span (tracer.h role): the op's span on THIS
            # daemon; closed when the client reply leaves, however many
            # async stages the op spans.  Sub-ops fan out under its ctx.
            span = self.tracer.start(f"osd-op {m.op}", parent=m.trace,
                                     oid=m.oid, pg=str(pgid))
        else:
            # head sampling for context-less ops (a client that does
            # not trace): None at zero cost when the rate is 0; a
            # propagating root with probability trace_sample_rate; or
            # an unsampled local span the flight recorder can promote
            # retroactively if this op turns slow
            span = self.tracer.sample_root(f"osd-op {m.op}", oid=m.oid,
                                           pg=str(pgid))
        # an unsampled span is op-owned (nothing else will close it);
        # sampled spans close when the client reply leaves (_SpanConn)
        own_span = span is not None and not span.sampled
        if span is not None and span.sampled:
            m._span = span
            conn = _SpanConn(conn, span)
        qphase = getattr(m, "_qos_phase", PHASE_NONE)
        if qphase != PHASE_NONE:
            # dmclock feedback: the reply carries the phase this op was
            # served under, whichever async path eventually sends it
            conn = _PhaseConn(conn, qphase)
        if self.perf_queries.active:
            # dynamic perf queries: attribution accumulates at the
            # reply edge; queries-off cost is this one attr check.
            # The ctx ALSO rides the op (m._pq_ctx -> pending entry)
            # so async drains that reply via the messenger book it.
            pq_ctx = _PerfQueryCtx(self.perf_queries, m.tenant,
                                   m.pool, pgid, m.op, m.oid,
                                   len(m.data))
            m._pq_ctx = pq_ctx
            conn = _PerfQueryConn(conn, pq_ctx)
        self.perf.inc("op_rw_bytes", len(m.data))
        with self.op_tracker.create(f"{m.op} {m.oid}", span=span) as op:
            if pool.kind == "ec":
                if m.op in ("write", "write_full"):
                    self.perf.inc("op_w")
                    key = (pgid, m.oid)
                    full = m.op == "write_full"

                    def wthunk(conn=conn, m=m, pgid=pgid, key=key,
                               full=full):
                        up2 = self.osdmap.pg_to_up_osds(
                            pgid.pool, pgid.seed)
                        self._ec_write(conn, m, pgid, up2, full=full,
                                       lock_key=key)

                    self._obj_lock(key, wthunk)
                elif m.op == "read":
                    self.perf.inc("op_r")
                    self._ec_read(conn, m, pgid, up, balanced=balanced)
                elif m.op == "remove":
                    key = (pgid, m.oid)

                    def rthunk(conn=conn, m=m, pgid=pgid, key=key):
                        up2 = self.osdmap.pg_to_up_osds(
                            pgid.pool, pgid.seed)
                        self._ec_remove(conn, m, pgid, up2, lock_key=key)

                    self._obj_lock(key, rthunk)
                elif m.op == "stat":
                    self._stat(conn, m, pgid, shard=0)
                elif m.op in self.EXTENDED_OPS:
                    self._handle_extended_op(conn, m, pgid, up)
                else:
                    conn.send(MOSDOpReply(m.tid, EINVAL,
                                          epoch=self.osdmap.epoch))
            else:
                if m.op in ("write", "write_full"):
                    self.perf.inc("op_w")
                    self._rep_write(conn, m, pgid, up,
                                    full=m.op == "write_full")
                elif m.op == "read":
                    self.perf.inc("op_r")
                    self._rep_read(conn, m, pgid, balanced=balanced)
                elif m.op == "remove":
                    self._rep_remove(conn, m, pgid, up)
                elif m.op == "stat":
                    self._stat(conn, m, pgid, shard=-1)
                elif m.op in self.EXTENDED_OPS:
                    self._handle_extended_op(conn, m, pgid, up)
                else:
                    conn.send(MOSDOpReply(m.tid, EINVAL,
                                          epoch=self.osdmap.epoch))
            op.mark("dispatched")
        if own_span:
            # idempotent; a span promoted mid-dispatch (slow-op
            # retention) closes into the done ring here
            span.finish()

    # -- per-object write serialization ------------------------------------
    def _obj_lock(self, key: tuple, thunk) -> None:
        """Run thunk now if the object is idle, else queue it.  Queue
        state is guarded by _pending_lock because the sweep (heartbeat
        thread) can release locks; thunks run outside the lock."""
        with self._pending_lock:
            q = self._obj_locks.get(key)
            if q is None:
                q = collections.deque()
                self._obj_locks[key] = q
            q.append(thunk)
            run = len(q) == 1
        if run:
            self._run_locked_thunk(key, thunk)

    def _run_locked_thunk(self, key: tuple, thunk) -> None:
        """Run a queued write; a thrown thunk must release the lock or
        every later write to the object wedges behind it forever."""
        self._sub_epoch.v = 0  # fresh epoch pin per deferred op
        try:
            thunk()
        except Exception:
            self._obj_unlock(key)
            raise

    def _obj_unlock(self, key: tuple | None) -> None:
        if key is None:
            return
        nxt = None
        with self._pending_lock:
            q = self._obj_locks.get(key)
            if not q:
                return
            q.popleft()
            if q:
                nxt = q[0]
            else:
                del self._obj_locks[key]
        if nxt:
            self._run_locked_thunk(key, nxt)  # start the next queued write

    # -- read barrier (aggregator in-flight dup collapse) ------------------
    _OBJ_WLAST_CAP = 4096

    def _obj_write_marker(self) -> int:
        """Current object-write sequence (racy read is fine: a stale
        low value only makes _obj_written_since more conservative)."""
        return self._obj_wseq

    def _note_obj_write(self, key: tuple | None) -> None:
        """Record an acked (or torn) write to `key` = (pgid, oid).
        MUST run before the client sees the ack: an aggregator fetch
        created before this point may carry pre-write bytes, so reads
        issued after the ack must not ride it."""
        if key is None:
            return
        with self._wbar_lock:
            self._obj_wseq += 1
            self._obj_wlast[key] = self._obj_wseq
            self._obj_wlast.move_to_end(key)
            while len(self._obj_wlast) > self._OBJ_WLAST_CAP:
                _, seq = self._obj_wlast.popitem(last=False)
                if seq > self._obj_wfloor:
                    self._obj_wfloor = seq

    def _obj_written_since(self, key: tuple, marker: int) -> bool:
        """Whether (pgid, oid) saw an acked write after sequence
        `marker`.  An evicted entry answers via the floor — possibly a
        false positive (rejecting a safe ride), never a false negative
        (4096 distinct objects must be written within one fetch's
        lifetime for the floor to pass a clean fetch's marker)."""
        with self._wbar_lock:
            return self._obj_wlast.get(key, self._obj_wfloor) > marker

    def _next_version(self, pgid: PgId) -> int:
        # reachable from the dispatch thread AND the heartbeat sweep (via
        # _obj_unlock -> queued write thunk): the RMW must be atomic or two
        # writes in one PG can mint the same version
        with self._pending_lock:
            v = self._pg_versions.get(pgid, 0) + 1
            self._pg_versions[pgid] = v
            return v

    def _record_tombstone(self, pgid: PgId, name: str, version: int) -> None:
        """Deletion marker so recovery never resurrects removed objects
        (the role of PGLog delete entries)."""
        ts = self._tombstones.setdefault(pgid, {})
        ts[name] = max(ts.get(name, 0), version)

    # -- replicated pool ---------------------------------------------------
    def _rep_write(self, conn, m: MOSDOp, pgid: PgId, up: list,
                   full: bool = True) -> None:
        # snapshots: clone-on-first-write-after-snap + SnapSet upkeep,
        # staged into the SAME transaction as the write (make_writeable)
        snap_tx, rider = self._snap_prepare(pgid, m)
        version = self._next_version(pgid)
        cid = CollectionId(pgid.pool, pgid.seed)
        existed = self.store.exists(cid, ObjectId(m.oid))
        was_whiteout = existed and self._head_whiteout(cid, m.oid)
        extra_attrs = {"wh": 0} if was_whiteout else {}
        partial = not full and (m.offset > 0 or (
            existed and m.offset + len(m.data) < self._obj_raw_size(
                cid, ObjectId(m.oid))))
        if partial:
            self._apply_partial(pgid, m.oid, -1, [(m.offset, m.data)],
                                version, create_ok=True, pre_tx=snap_tx,
                                extra_attrs=extra_attrs)
            if existed:
                op, payload, off = "write_partial", m.data, m.offset
            else:
                # object just created here: replicas may lack it entirely,
                # so replicate the full (zero-prefixed) content instead of
                # a partial they could not apply (raw: the wire never
                # carries compressed bytes)
                payload, _ = self._read_obj_raw(cid, ObjectId(m.oid))
                op, off = "write", 0
        else:
            op, payload, off = "write", m.data, 0
            self._apply_write(pgid, m.oid, -1, m.data,
                              dict(extra_attrs, v=version,
                                   len=len(m.data)), pre_tx=snap_tx)
        peers = [u for u in up if u is not None and u != self.osd_id]
        tid = next(self._tids)
        if not peers:
            # single-copy pool: the client reply IS the durability ack —
            # it rides the commit pipeline's finisher (inline when sync)
            self.store.commit_barrier(lambda: conn.send(
                MOSDOpReply(m.tid, 0, version=version,
                            epoch=self.osdmap.epoch)))
            return
        # +1 ack for the primary's own store commit (the barrier below)
        self._pending_writes[tid] = _PendingWrite(
            m.client, m.tid, len(peers) + 1, version, members=tuple(peers))
        self._pending_writes[tid].span = getattr(m, '_span', None)
        self._pending_writes[tid].qphase = getattr(m, '_qos_phase', 0)
        self._pending_writes[tid].pq_ctx = getattr(m, '_pq_ctx', None)
        self._local_commit_ack(tid, pgid)
        sub_attrs = dict(extra_attrs)
        if rider is not None:
            sub_attrs["_snap"] = rider
        for peer in peers:
            self.messenger.send_message(
                f"osd.{peer}",
                MSubWrite(tid, pgid, m.oid, -1, version, op, payload,
                          attrs=dict(sub_attrs), offset=off,
                          epoch=self._entry_epoch(),
                          trace=self._tctx(m), tenant=m.tenant))

    def _rep_read(self, conn, m: MOSDOp, pgid: PgId,
                  balanced: bool = False) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        try:
            # snapid resolution (find_object_context): head, a clone, or
            # a whiteout'd ENOENT
            target = self._snap_resolve(cid, m.oid, m.snapid)
            if target is None:
                # balanced: this replica may simply not have caught up
                # (recovery lag outside the _stale_objects inventory) —
                # bounce to the primary, whose answer is authoritative,
                # instead of fabricating ENOENT
                err = ESTALE if balanced else ENOENT
                if balanced:
                    self.perf.inc("balanced_read_bounce")
                conn.send(MOSDOpReply(m.tid, err,
                                      epoch=self.osdmap.epoch))
                return
            try:
                data = self._inflate(
                    self.store.read(cid, target).to_bytes(),
                    self.store.getattrs(cid, target))
            except ValueError:
                conn.send(MOSDOpReply(m.tid, EIO,
                                      epoch=self.osdmap.epoch))
                return
            if m.length:
                data = data[m.offset:m.offset + m.length]
            elif m.offset:
                data = data[m.offset:]
            if balanced:
                self.perf.inc("balanced_read_serve")
            lease = self._lease_maybe_grant(pgid, m.oid, m.client,
                                            whole=not m.length
                                            and not m.offset
                                            and not m.snapid)
            conn.send(MOSDOpReply(m.tid, 0, data=data,
                                  epoch=self.osdmap.epoch, lease=lease))
        except NoSuchObject:
            if balanced:
                self.perf.inc("balanced_read_bounce")
                conn.send(MOSDOpReply(m.tid, ESTALE,
                                      epoch=self.osdmap.epoch))
                return
            conn.send(MOSDOpReply(m.tid, ENOENT, epoch=self.osdmap.epoch))

    def _rep_remove(self, conn, m: MOSDOp, pgid: PgId, up: list) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        if not self.store.exists(cid, ObjectId(m.oid)) or \
                self._head_whiteout(cid, m.oid):
            conn.send(MOSDOpReply(m.tid, ENOENT, epoch=self.osdmap.epoch))
            return
        # a head with clones (or a live SnapContext that first needs a
        # clone) must leave its SnapSet behind: whiteout, not remove
        snap_tx, rider = self._snap_prepare(pgid, m)
        ss = self._load_ss(cid, m.oid)
        # whiteout only when clones actually exist (or one is being
        # staged right now) — a snapc alone must not leave a permanent
        # zero-clone whiteout behind
        whiteout = bool((ss or {}).get("clones")) or (
            rider is not None and rider.get("clone", -1) >= 0)
        version = self._next_version(pgid)
        if whiteout:
            self._apply_whiteout(pgid, m.oid, version, pre_tx=snap_tx)
            sub_op, sub_attrs = "whiteout", (
                {"_snap": rider} if rider is not None else {})
        else:
            self._apply_remove(pgid, m.oid, -1, version)
            sub_op, sub_attrs = "remove", {}
        peers = [u for u in up if u is not None and u != self.osd_id]
        tid = next(self._tids)
        if not peers:
            self.store.commit_barrier(lambda: conn.send(
                MOSDOpReply(m.tid, 0, version=version,
                            epoch=self.osdmap.epoch)))
            return
        # +1 ack: the local whiteout/remove commit (barrier below)
        self._pending_writes[tid] = _PendingWrite(
            m.client, m.tid, len(peers) + 1, version, members=tuple(peers))
        self._pending_writes[tid].span = getattr(m, '_span', None)
        self._pending_writes[tid].qphase = getattr(m, '_qos_phase', 0)
        self._pending_writes[tid].pq_ctx = getattr(m, '_pq_ctx', None)
        self._local_commit_ack(tid, pgid)
        for peer in peers:
            self.messenger.send_message(
                f"osd.{peer}",
                MSubWrite(tid, pgid, m.oid, -1, version, sub_op,
                          attrs=dict(sub_attrs),
                          epoch=self._entry_epoch(),
                          trace=self._tctx(m), tenant=m.tenant))

    def _stat(self, conn, m: MOSDOp, pgid: PgId, shard: int) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        oid = ObjectId(m.oid, shard=shard)
        # EC stat probes local shards first (primary may hold any shard)
        candidates = [oid] if shard < 0 else [
            ObjectId(m.oid, shard=s)
            for s in range(self.osdmap.pools[pgid.pool].size)]
        for cand in candidates:
            try:
                attrs = self.store.getattrs(cid, cand)
            except NoSuchObject:
                continue
            if attrs.get("wh"):
                # whiteout head (any shard): logically deleted — and
                # authoritatively so; never fall through to the remote
                # stat fan (peers hold the same whiteout)
                conn.send(MOSDOpReply(m.tid, ENOENT,
                                      epoch=self.osdmap.epoch))
                return
            size = int(attrs.get("len", 0))
            conn.send(MOSDOpReply(m.tid, 0,
                                  data=size.to_bytes(8, "little"),
                                  epoch=self.osdmap.epoch))
            return
        if shard >= 0:
            # recovery window: this primary holds nothing yet — ask the
            # shard holders (stat must agree with the readable object)
            up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
            tid = next(self._tids)
            pr = _PendingRead(m.client, m.tid, pgid.pool, m.oid,
                              total_shards=sum(1 for u in up
                                               if u is not None),
                              stat_only=True)
            pr.qphase = getattr(m, '_qos_phase', 0)
            pr.pq_ctx = getattr(m, '_pq_ctx', None)
            self._pending_reads[tid] = pr
            self._fan_shard_reads(tid, pgid, m.oid, up)
            return
        conn.send(MOSDOpReply(m.tid, ENOENT, epoch=self.osdmap.epoch))

    # -- EC pool -----------------------------------------------------------
    def _pool_codec(self, pool_id: int, pool=None) -> ec.ErasureCode:
        codec = self._ec_codecs.get(pool_id)
        if codec is None:
            pool = pool or self.osdmap.pools[pool_id]
            profile = dict(pool.ec_profile)
            plugin = profile.pop("plugin", self.cfg["ec_plugin"])
            profile.setdefault("backend", self.cfg["ec_backend"])
            # device fan-out for folded batch launches (mesh-sharded
            # flushes); pool ec-profile key 'shard' wins over the option
            profile.setdefault("shard", self.cfg["ec_shard"])
            # kernel realization / per-signature auto-tuning (profile
            # key 'kernel' wins over the ec_kernel option)
            profile.setdefault("kernel", self.cfg["ec_kernel"])
            codec = ec.factory(plugin, profile)
            if getattr(codec, "_backend", None) == "torch":
                self._ec_device_plane(codec.device)
            self._ec_codecs[pool_id] = codec
        return codec

    def _ec_device_plane(self, device: torch.device) -> None:
        """Ready the device half of the stripe plane for a torch pool
        on ``device``, before its codec is cached: on the card, load
        the CUDA library (built at first use, seconds cold); then give
        the extent cache a DeviceArena on that device, once a device,
        each under ec_arena_max_bytes."""
        if device.type == "cuda":
            cuda_lib.lib()
        with self._ec_arena_lock:
            if self._ec_cache.arena(device) is None:
                self._ec_cache.attach_arena(DeviceArena(
                    self.cfg["ec_arena_max_bytes"], device=device))

    def _ready_ec_pools(self, newmap: OSDMap) -> None:
        """Build the codec of every EC pool ``newmap`` brings, before
        the map is published to the op handlers, so that a torch pool's
        library load and arena (``_ec_device_plane``) happen before its
        first client op.  A codec that fails to build is logged here
        and raises again on the op path, where the JAX package builds
        it."""
        for pool_id, pool in newmap.pools.items():
            if pool.kind != "ec" or pool_id in self._ec_codecs:
                continue
            try:
                self._pool_codec(pool_id, pool)
            except Exception as e:  # noqa: BLE001 - see the docstring
                dout("osd", 0)("%s: pool %d codec not built: %r",
                               self.name, pool_id, e)

    def _ec_batch_on(self, codec) -> bool:
        """Whether this codec's stripe work routes through the cross-op
        batcher: pool ec-profile key 'batch' wins, then the ec_batch
        option; 'auto' engages on the torch backend only (numpy/native
        launches are cheap CPU calls — coalescing would only add the
        window latency) and only under the sharded mclock scheduler —
        fifo mode runs client ops inline on ONE dispatch thread, so a
        second op can never be in flight to coalesce with and the
        window would be pure added latency."""
        mode = str(codec.profile.get("batch",
                                     self.cfg["ec_batch"])).lower()
        if mode in ("on", "true", "1", "yes"):
            return True
        if mode in ("off", "false", "0", "no"):
            return False
        return (getattr(codec, "_backend", None) == "torch"
                and self._use_mclock)

    def _ec_encode(self, codec, streams, with_csums: bool, m=None):
        """One encode launch for one op — or, when batching is engaged,
        a slot in a folded launch shared with concurrent ops.  Returns
        (parity, csums); csums is None when the codec has no fused path
        and with_csums was not requested.  A traced op (``m`` carries a
        span) wraps the call in an ``ec-encode`` span whose children —
        ``ec-batch-wait`` + the shared ``ec-flush`` — decompose where
        the encode time went (window wait vs launch)."""
        span = getattr(m, "_span", None) if m is not None else None
        if self._ec_batch_on(codec):
            if span is not None:
                with self.tracer.start("ec-encode",
                                       parent=span.ctx) as sp:
                    return self._ec_batcher.encode(
                        codec, streams, with_csums=with_csums,
                        trace=(self.tracer, sp.ctx))
            return self._ec_batcher.encode(codec, streams,
                                           with_csums=with_csums)
        with (self.tracer.start("ec-encode", parent=span.ctx)
              if span is not None else contextlib.nullcontext()):
            if with_csums:
                enc_csum = getattr(codec, "encode_chunks_with_csums",
                                   None)
                if enc_csum is not None:
                    return enc_csum(streams)
            return codec.encode_chunks(streams), None

    def _ec_decode(self, codec, want, chunks, span=None):
        """Decode wanted shards — coalesced with concurrent decodes of
        the same erasure signature when batching is engaged.  ``span``
        (the op's span, when traced) wraps the call in an ``ec-decode``
        span with the same batch-wait/flush decomposition underneath."""
        if self._ec_batch_on(codec):
            if span is not None:
                with self.tracer.start("ec-decode",
                                       parent=span.ctx) as sp:
                    return self._ec_batcher.decode(
                        codec, want, chunks,
                        trace=(self.tracer, sp.ctx))
            return self._ec_batcher.decode(codec, want, chunks)
        with (self.tracer.start("ec-decode", parent=span.ctx)
              if span is not None else contextlib.nullcontext()):
            return codec.decode(want, chunks)

    def _ec_repair(self, codec, lost: int, helpers: dict, L: int,
                   span=None):
        """Sub-chunk MSR repair (CLAY) — coalesced with concurrent
        repairs of the same lost shard when batching is engaged (a
        storm rebuilding one downed OSD's shard across many objects is
        exactly one repair signature)."""
        if self._ec_batch_on(codec):
            if span is not None:
                with self.tracer.start("ec-repair",
                                       parent=span.ctx) as sp:
                    return self._ec_batcher.repair(
                        codec, lost, helpers, L,
                        trace=(self.tracer, sp.ctx))
            return self._ec_batcher.repair(codec, lost, helpers, L)
        with (self.tracer.start("ec-repair", parent=span.ctx)
              if span is not None else contextlib.nullcontext()):
            return codec.repair_chunk(lost, helpers, L)

    def _rec_trace(self, pgid: PgId) -> tuple:
        """Wire trace context of this PG's recovery-storm root span —
        () when the storm was not sampled.  Rides MPGPush/MPGPull so
        peers parent their per-push/pull apply spans under the storm
        root (cross-daemon recovery waterfalls)."""
        with self._pending_lock:
            sp = self._rec_spans.get(pgid)
        return sp.ctx if sp is not None else ()

    # ----------------------------------------------------------- pg log
    def _pglog(self, pgid: PgId) -> PGLog:
        pl = self._pglogs.get(pgid)
        if pl is None:
            pl = PGLog(self.store, CollectionId(pgid.pool, pgid.seed))
            self._pglogs[pgid] = pl
        return pl

    def _lc(self, pgid: PgId) -> int:
        """last-complete: highest version through which this OSD has seen
        EVERY pg mutation gaplessly (the log's authority point)."""
        lc = self._pg_lc.get(pgid)
        if lc is None:
            cid = CollectionId(pgid.pool, pgid.seed)
            try:
                raw = self.store.omap_get(cid, PGLOG_OID).get("_lc")
                lc = int.from_bytes(raw, "little") if raw else 0
            except Exception:  # noqa: BLE001 - no log object yet
                lc = 0
            self._pg_lc[pgid] = lc
        return lc

    def _set_lc(self, pgid: PgId, lc: int,
                tx: Transaction | None = None) -> None:
        self._pg_lc[pgid] = lc
        cid = CollectionId(pgid.pool, pgid.seed)
        own = tx is None
        if own:
            tx = Transaction()
        if not self.store.exists(cid, PGLOG_OID):
            tx.touch(cid, PGLOG_OID)
        tx.omap_setkeys(cid, PGLOG_OID,
                        {"_lc": lc.to_bytes(8, "little")})
        if own:
            self.store.queue_transaction(tx)

    @staticmethod
    def _tctx(m) -> tuple:
        """Trace context for sub-ops of this client op (the ZTracer
        child-span propagation, ECCommon.cc:1046-1051)."""
        span = getattr(m, "_span", None)
        return span.ctx if span is not None else ()

    def _entry_epoch(self) -> int:
        """Epoch to stamp a fresh log entry with: the minting primary's
        epoch when this thread is applying a sub-op (it rode the
        message), else my own current map epoch PINNED on first use —
        one logical op must mint ONE epoch for its local entry and
        every sub-message even if a map push lands on another thread
        mid-fan-out (two stamps for the same version would read as a
        fork next peering round).  The pin is cleared at each dispatch/
        thunk boundary."""
        e = getattr(self._sub_epoch, "v", 0)
        if not e:
            e = self.osdmap.epoch if self.osdmap is not None else 0
            self._sub_epoch.v = e
        return e

    def _log_apply(self, tx: Transaction, pgid: PgId,
                   entry: LogEntry) -> None:
        """Append a log entry in the SAME transaction as its data write
        and advance the contiguity point when versions arrive in order
        (a gap means we missed a mutation: last-complete stays put and
        peering falls back to the inventory exchange)."""
        if entry.epoch == 0:
            entry.epoch = self._entry_epoch()
        pl = self._pglog(pgid)
        pl.append_to(tx, entry)
        pl.trim_to(tx)
        lc = self._lc(pgid)
        if entry.version == lc + 1:
            self._set_lc(pgid, entry.version, tx=tx)

    # -- past intervals + the last-epoch-started fence ---------------------
    def _pi(self, pgid: PgId) -> PastIntervals:
        pi = self._past_intervals.get(pgid)
        if pi is None:
            cid = CollectionId(pgid.pool, pgid.seed)
            try:
                raw = self.store.omap_get(cid, PGLOG_OID).get(
                    INTERVALS_KEY)
                pi = (PastIntervals.decode_bytes(raw) if raw
                      else PastIntervals())
            except Exception:  # noqa: BLE001 - no log object yet
                pi = PastIntervals()
            self._past_intervals[pgid] = pi
        return pi

    def _save_pi(self, pgid: PgId) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        tx = Transaction()
        if not self.store.exists(cid, PGLOG_OID):
            tx.touch(cid, PGLOG_OID)
        tx.omap_setkeys(cid, PGLOG_OID,
                        {INTERVALS_KEY: self._pi(pgid).encode_bytes()})
        self.store.queue_transaction(tx)

    def _les(self, pgid: PgId) -> int:
        """last_epoch_started: the newest epoch this PG completed
        peering at (the interval fence — history older than it can no
        longer hold writes the current membership missed)."""
        les = self._pg_les.get(pgid)
        if les is None:
            cid = CollectionId(pgid.pool, pgid.seed)
            try:
                raw = self.store.omap_get(cid, PGLOG_OID).get(LES_KEY)
                les = int.from_bytes(raw, "little") if raw else 0
            except Exception:  # noqa: BLE001 - no log object yet
                les = 0
            self._pg_les[pgid] = les
        return les

    def _set_les(self, pgid: PgId, les: int) -> None:
        if les <= self._les(pgid):
            return
        self._pg_les[pgid] = les
        cid = CollectionId(pgid.pool, pgid.seed)
        tx = Transaction()
        if not self.store.exists(cid, PGLOG_OID):
            tx.touch(cid, PGLOG_OID)
        tx.omap_setkeys(cid, PGLOG_OID,
                        {LES_KEY: les.to_bytes(8, "little")})
        self.store.queue_transaction(tx)
        # the fence moved: trim history that can no longer matter
        pi = self._pi(pgid)
        pi.trim_to(les)
        self._save_pi(pgid)

    # ------------------------------------------------------------ pg split
    def _split_pgs(self, old: OSDMap | None, new: OSDMap) -> None:
        """A pool's pg_num grew: rehash every LOCAL parent collection
        into its children (OSD::split_pgs role, ref src/osd/OSD.h:1999
        + the OSDMap stable-mod split math in src/osd/OSDMap.cc).

        With modulo placement and new_pg_num a multiple of old_pg_num,
        an object at parent seed s moves to exactly one child seed in
        {s + k*old_pg_num} — so each holder of the parent can split
        LOCALLY, with no cross-daemon traffic.  Children inherit the
        parent's PGLog subsequence (entries for their objects), its
        last-complete point, its les fence and its PastIntervals
        (PGLog::split_into semantics): the child primaries then peer
        against the parent's membership history and the normal
        recovery/notify machinery moves shards to their CRUSH homes."""
        if old is None:
            return
        for pool_id, pool in new.pools.items():
            oldp = old.pools.get(pool_id)
            if oldp is None or pool.pg_num <= oldp.pg_num:
                continue
            oldn = oldp.pg_num
            for cid in list(self.store.list_collections()):
                if cid.pool != pool_id or cid.pg_seed >= oldn:
                    continue
                self._split_collection(pool_id, cid.pg_seed, oldn,
                                       pool.pg_num)
            # Force the next peering round of every PG of the grown
            # pool I lead to exchange FULL inventories: split members
            # inherit the parent's last-complete, so the lean path
            # would hide the shard redistribution entirely.
            for seed in range(pool.pg_num):
                up_s = new.pg_to_up_osds(pool_id, seed)
                if self._primary_of(up_s) == self.osd_id:
                    self._split_fresh.add(PgId(pool_id, seed))
            # Seed every NEW child PG I am an up member of with the
            # parent's membership as a maybe-active closed interval —
            # even when I never held the parent.  Without this a child
            # primary landing on a fresh OSD has an empty prior set,
            # peers trivially against nothing, and serves ENOENT while
            # the parent's holders still carry the objects.
            for child_seed in range(oldn, pool.pg_num):
                child_up = new.pg_to_up_osds(pool_id, child_seed)
                if self.osd_id not in [u for u in child_up
                                       if u is not None]:
                    continue
                parent_seed = child_seed % oldn
                parent_up = old.pg_to_up_osds(pool_id, parent_seed)
                child_pg = PgId(pool_id, child_seed)
                pi = self._pi(child_pg)
                first = min(old.epoch, new.epoch - 1)
                if not any(i.first == first and i.up == list(parent_up)
                           for i in pi.intervals):
                    pi.intervals.insert(0, Interval(
                        first, new.epoch - 1, list(parent_up),
                        self._primary_of(parent_up)))
                    self._save_pi(child_pg)

    def _split_collection(self, pool_id: int, parent_seed: int,
                          oldn: int, newn: int) -> None:
        from ..parallel.placement import pg_of_object
        from .snaps import split_vname
        parent_pg = PgId(pool_id, parent_seed)
        parent_cid = CollectionId(pool_id, parent_seed)
        # objects that re-hash away from the parent, grouped by child
        moves: dict[int, list[ObjectId]] = {}
        try:
            oids = list(self.store.list_objects(parent_cid))
        except Exception:  # noqa: BLE001 - collection vanished
            return
        for oid in oids:
            if oid.shard <= -2:
                continue  # PG metadata (pglog/snapmapper) stays put
            seed = pg_of_object(oid.name, newn)
            if seed != parent_seed:
                moves.setdefault(seed, []).append(oid)
        if not moves:
            return
        dout("osd", 2)("osd.%d: splitting pg %s: %d objects -> %s",
                       self.osd_id,
                       parent_pg,
                       sum(len(v) for v in moves.values()),
                       sorted(moves))
        parent_log = self._pglog(parent_pg).entries()
        parent_lc = self._lc(parent_pg)
        parent_les = self._les(parent_pg)
        parent_pi_raw = self._pi(parent_pg).encode_bytes()
        parent_tomb = self._tombstones.get(parent_pg, {})
        have = set(self.store.list_collections())
        moved_versions = []
        for child_seed, oids in sorted(moves.items()):
            child_pg = PgId(pool_id, child_seed)
            child_cid = CollectionId(pool_id, child_seed)
            tx = Transaction()
            if child_cid not in have:
                tx.create_collection(child_cid)
                have.add(child_cid)
            for oid in oids:
                data = self.store.read(parent_cid, oid)
                tx.touch(child_cid, oid)
                if data:
                    tx.write(child_cid, oid, 0, data)
                attrs = self.store.getattrs(parent_cid, oid)
                if attrs:
                    tx.setattrs(child_cid, oid, dict(attrs))
                omap = self.store.omap_get(parent_cid, oid)
                if omap:
                    tx.omap_setkeys(child_cid, oid, dict(omap))
                tx.remove(parent_cid, oid)
            # the child's slice of the parent's log (split_into): the
            # version numbering keeps the parent's sequence (gaps are
            # fine — peering falls back to inventories across gaps)
            child_log = self._pglog(child_pg)
            for e in parent_log:
                if pg_of_object(split_vname(e.oid)[0], newn) \
                        == child_seed:
                    child_log.append_to(tx, e)
                    moved_versions.append(e.version)
            meta = {"_lc": parent_lc.to_bytes(8, "little"),
                    LES_KEY: parent_les.to_bytes(8, "little"),
                    INTERVALS_KEY: parent_pi_raw}
            if not self.store.exists(child_cid, PGLOG_OID):
                tx.touch(child_cid, PGLOG_OID)
            tx.omap_setkeys(child_cid, PGLOG_OID, meta)
            self.store.queue_transaction(tx)
            # in-memory state for the child: fresh decodes + filtered
            # tombstones (cheap; loaded lazily elsewhere anyway)
            self._pglogs.pop(child_pg, None)
            self._pg_lc[child_pg] = parent_lc
            self._pg_les[child_pg] = parent_les
            self._past_intervals.pop(child_pg, None)
            tomb = {k: v for k, v in parent_tomb.items()
                    if pg_of_object(split_vname(k[0])[0], newn)
                    == child_seed}
            if tomb:
                self._tombstones[child_pg] = tomb
        # rewrite the parent: drop moved log entries + tombstones so a
        # later delta-replay cannot resurrect moved objects here
        if moved_versions:
            tx = Transaction()
            from .pglog import _key as _log_key
            tx.omap_rmkeys(parent_cid, PGLOG_OID,
                           [_log_key(v) for v in moved_versions])
            self.store.queue_transaction(tx)
            self._pglogs.pop(parent_pg, None)
        if parent_tomb:
            keep = {k: v for k, v in parent_tomb.items()
                    if pg_of_object(split_vname(k[0])[0], newn)
                    == parent_seed}
            self._tombstones[parent_pg] = keep
        self._ec_cache.invalidate(parent_pg)

    def _merge_pgs(self, old: OSDMap | None, new: OSDMap) -> None:
        """A pool's pg_num SHRANK (to a divisor of the old value): every
        source PG with seed >= new_pg_num folds into seed % new_pg_num
        (the pg merge of OSDMap.cc; with modulo placement and new | old,
        h % new == (h % old) % new, so each source merges whole into
        exactly one surviving PG).  Matching the reference's merge
        semantics, the combined PG's log is NOT continuable: logs reset,
        the les fence drops, PastIntervals of both halves concatenate,
        and the next peering round runs on full inventories (the
        _split_fresh force).

        Folding is keyed on LOCAL collections out of range of the NEW
        map — not on observing the shrink epoch — so an OSD that was
        down across the merge still folds its strays on revival
        (out-of-range seeds are invisible to _notify_demoted and would
        otherwise leak forever)."""
        for pool_id, pool in new.pools.items():
            newn = pool.pg_num
            by_target: dict[int, list[int]] = {}
            for cid in list(self.store.list_collections()):
                if cid.pool == pool_id and cid.pg_seed >= newn:
                    by_target.setdefault(cid.pg_seed % newn,
                                         []).append(cid.pg_seed)
            for tgt_seed, src_seeds in sorted(by_target.items()):
                self._merge_sources(pool_id, tgt_seed,
                                    sorted(src_seeds))
            oldp = old.pools.get(pool_id) if old is not None else None
            if oldp is None or newn >= oldp.pg_num:
                continue
            oldn = oldp.pg_num
            for seed in range(newn):
                up_s = new.pg_to_up_osds(pool_id, seed)
                if self._primary_of(up_s) == self.osd_id:
                    self._split_fresh.add(PgId(pool_id, seed))
                if self.osd_id not in [u for u in up_s
                                       if u is not None]:
                    continue
                # Seed every surviving PG I am a member of with each
                # folded source's OLD membership as a maybe-active
                # interval: a target primary that never held a source
                # collection would otherwise peer with an empty prior
                # set and serve ENOENT while the source's holders still
                # carry the objects (the same hole the split fix
                # closes for children).
                tgt_pg = PgId(pool_id, seed)
                pi = self._pi(tgt_pg)
                changed = False
                first = min(old.epoch, new.epoch - 1)
                for src_seed in range(seed + newn, oldn, newn):
                    src_up = old.pg_to_up_osds(pool_id, src_seed)
                    if any(i.first == first and i.up == list(src_up)
                           for i in pi.intervals):
                        continue
                    pi.intervals.insert(0, Interval(
                        first, new.epoch - 1, list(src_up),
                        self._primary_of(src_up)))
                    changed = True
                if changed:
                    self._save_pi(tgt_pg)

    def _merge_sources(self, pool_id: int, tgt_seed: int,
                       src_seeds: list[int]) -> None:
        """Fold every listed source collection into the target in ONE
        transaction, with one log reset and one PastIntervals rewrite
        however many sources share the target."""
        tgt_pg = PgId(pool_id, tgt_seed)
        tgt_cid = CollectionId(pool_id, tgt_seed)
        have = set(self.store.list_collections())
        tx = Transaction()
        if tgt_cid not in have:
            tx.create_collection(tgt_cid)
        tgt_pi = self._pi(tgt_pg)
        moved = 0
        with self._pending_lock:
            vmax = self._pg_versions.get(tgt_pg, 0)
        for src_seed in src_seeds:
            src_pg = PgId(pool_id, src_seed)
            src_cid = CollectionId(pool_id, src_seed)
            try:
                oids = list(self.store.list_objects(src_cid))
            except Exception:  # noqa: BLE001 - collection vanished
                continue
            for oid in oids:
                if oid.shard <= -2:
                    continue  # PG meta dies with the source
                data = self.store.read(src_cid, oid)
                tx.touch(tgt_cid, oid)
                if data:
                    tx.write(tgt_cid, oid, 0, data)
                attrs = self.store.getattrs(src_cid, oid)
                if attrs:
                    tx.setattrs(tgt_cid, oid, dict(attrs))
                omap = self.store.omap_get(src_cid, oid)
                if omap:
                    tx.omap_setkeys(tgt_cid, oid, dict(omap))
                tx.remove(src_cid, oid)
                moved += 1
            # concatenate membership history; the source's open
            # interval closes at the epoch before this map
            src_pi = self._pi(src_pg)
            tgt_pi.intervals.extend(src_pi.intervals)
            if src_pi.cur_up:
                tgt_pi.intervals.append(Interval(
                    src_pi.cur_first,
                    max(src_pi.cur_first, self.osdmap.epoch - 1),
                    list(src_pi.cur_up), src_pi.cur_primary))
            tx.remove_collection(src_cid)
            self._pglogs.pop(src_pg, None)
            self._past_intervals.pop(src_pg, None)
            with self._pending_lock:
                vmax = max(vmax, self._pg_versions.pop(src_pg, 0))
            src_tomb = self._tombstones.pop(src_pg, {})
            if src_tomb:
                tgt = self._tombstones.setdefault(tgt_pg, {})
                for k, v in src_tomb.items():
                    tgt[k] = max(tgt.get(k, -1), v)
            self._ec_cache.invalidate(src_pg)
        # the merged log is un-continuable: reset the TARGET's entries
        # and contiguity point; peering rebuilds authority from full
        # inventories (version floors recover from object "v" attrs)
        try:
            logkeys = [k for k in self.store.omap_get(tgt_cid,
                                                      PGLOG_OID)
                       if not k.startswith("_")]
        except Exception:  # noqa: BLE001 - no log object yet
            logkeys = []
        if logkeys:
            tx.omap_rmkeys(tgt_cid, PGLOG_OID, logkeys)
        if not self.store.exists(tgt_cid, PGLOG_OID):
            tx.touch(tgt_cid, PGLOG_OID)
        tx.omap_setkeys(tgt_cid, PGLOG_OID, {
            "_lc": (0).to_bytes(8, "little"),
            LES_KEY: (0).to_bytes(8, "little"),
            INTERVALS_KEY: tgt_pi.encode_bytes()})
        self.store.queue_transaction(tx)
        dout("osd", 2)("osd.%d: merged pgs %s into %s (%d objects)",
                       self.osd_id,
                       [f"{pool_id}.{s:x}" for s in src_seeds],
                       tgt_pg, moved)
        self._pglogs.pop(tgt_pg, None)
        self._pg_lc[tgt_pg] = 0
        self._pg_les[tgt_pg] = 0
        with self._pending_lock:
            self._pg_versions[tgt_pg] = vmax
        self._ec_cache.invalidate(tgt_pg)

    def _note_intervals(self) -> None:
        """Record membership changes for every PG I host or hold data
        for (PastIntervals::check_new_interval role) — durably, in the
        PG meta omap, so a revived OSD still knows who served while it
        was away."""
        if self.osdmap is None:
            return
        mine = {(pool_id, seed)
                for pool_id, seed, _up in self._pools_pgs_for_me()}
        for cid in self.store.list_collections():
            if cid.pool in self.osdmap.pools and \
                    cid.pg_seed < self.osdmap.pools[cid.pool].pg_num:
                mine.add((cid.pool, cid.pg_seed))
        for pool_id, seed in mine:
            up = self.osdmap.pg_to_up_osds(pool_id, seed)
            pgid = PgId(pool_id, seed)
            pi = self._pi(pgid)
            if pi.note(self.osdmap.epoch, up, self._primary_of(up)):
                self._save_pi(pgid)

    def _pool_stripe(self, pool_id: int) -> StripeInfo:
        """The pool's stripe geometry (ECUtil stripe_info_t role): a FIXED
        page-aligned chunk_size from the profile's stripe_unit, so objects
        are many interleaved stripe rows, not one unbounded stripe."""
        si = self._stripes.get(pool_id)
        if si is None:
            codec = self._pool_codec(pool_id)
            pool = self.osdmap.pools[pool_id]
            unit = int(pool.ec_profile.get(
                "stripe_unit", self.cfg["osd_ec_stripe_unit"]))
            si = StripeInfo(codec.k, codec.m, unit)
            self._stripes[pool_id] = si
        return si

    def _ec_object_len(self, pgid: PgId, oid: str) -> int | None:
        cid = CollectionId(pgid.pool, pgid.seed)
        for shard in range(self.osdmap.pools[pgid.pool].size):
            try:
                attrs = self.store.getattrs(cid, ObjectId(oid, shard=shard))
                if "len" in attrs:
                    return int(attrs["len"])
            except NoSuchObject:
                continue
        return None

    def _ec_write(self, conn, m: MOSDOp, pgid: PgId, up: list,
                  full: bool = True, lock_key: tuple | None = None) -> None:
        codec = self._pool_codec(pgid.pool)
        pool = self.osdmap.pools[pgid.pool]
        alive = [u for u in up if u is not None]
        if len(alive) < max(pool.min_size, codec.k):
            # below min_size: refuse the write (EAGAIN -> client retries
            # until recovery restores redundancy) rather than accepting
            # data with no margin to survive the next failure
            conn.send(MOSDOpReply(m.tid, EAGAIN, epoch=self.osdmap.epoch))
            self._obj_unlock(lock_key)
            return
        total = None if full else self._ec_object_len(pgid, m.oid)
        si = self._pool_stripe(pgid.pool)
        # snapshots: shard-wise clone-on-first-write-after-snap — the
        # rider rides every shard mutation of this op (make_writeable)
        _ign, rider = self._snap_prepare(pgid, m)
        if not full:
            object_size = total if total is not None else 0
            end = m.offset + len(m.data)
            if m.offset == 0 and end >= object_size:
                pass  # covers the whole object: same as write_full below
            else:
                # sub-object overwrite: the ECTransaction WritePlan
                # decision (full rows / parity delta / rmw) over the
                # stripe_info_t geometry
                plan = plan_write(si, object_size, m.offset, len(m.data),
                                  codec.get_flags())
                padded_end = si.object_chunk_size(object_size) * si.k
                if plan.mode == "full_stripe":
                    row0, nrows = si.rows_of_range(m.offset, len(m.data))
                    buf = bytearray(nrows * si.stripe_width)
                    start = m.offset - row0 * si.stripe_width
                    buf[start:start + len(m.data)] = m.data
                    self._ec_write_rows(
                        conn, m, pgid, up, codec, si, row0, bytes(buf),
                        max(object_size, end), create=object_size == 0,
                        prev_version=self._ec_object_version(pgid, m.oid)
                        if object_size else -1,
                        lock_key=lock_key, rider=rider)
                elif (plan.mode == "parity_delta" and end <= padded_end
                        and None not in up):
                    # delta only valid against rows that exist on EVERY
                    # shard; growth into new rows and degraded sets fall
                    # back to row-rmw
                    self._ec_partial_write(conn, m, pgid, up, codec, si,
                                           object_size, lock_key,
                                           rider=rider)
                else:
                    self._ec_rmw_rows(conn, m, pgid, up, codec, si,
                                      object_size, lock_key,
                                      rider=rider)
                return
        version = self._next_version(pgid)
        # whole-object (re)write: scatter the buffer into the RAID-0
        # shard streams and encode ALL rows in ONE kernel launch (the
        # batching seam of ECUtil::shard_extent_map_t::encode).  The
        # per-shard CRC32C rides the same pass (Checksummer.h:13 role):
        # on the torch backend both leave the device together, and every
        # shard holder stores the pre-computed digest instead of
        # re-sweeping the bytes on CPU.
        self._ec_cache.invalidate(pgid, m.oid)  # version moves past it
        streams = si.ro_scatter(m.data)
        parity, csums = self._ec_encode(codec, streams, with_csums=True,
                                        m=m)
        # write-through data AND parity streams at the new version: the
        # rewrite just produced the authoritative bytes, so hot-object
        # reads, rmw old-byte reads and the delta path's old-parity
        # reads all serve from cache (the failure paths — local below,
        # remote ack drain — invalidate)
        for shard in range(codec.chunk_count):
            if up[shard] is not None:
                chunk = streams[shard] if shard < codec.k \
                    else parity[shard - codec.k]
                self._ec_cache.write(pgid, m.oid, shard, 0,
                                     chunk.tobytes(), version=version,
                                     length=len(m.data))
        attrs = {"v": version, "len": len(m.data)}
        if self._ec_whiteout(pgid, m.oid):
            attrs["wh"] = 0  # write resurrects a whiteout'd head
        sub_attrs = dict(attrs)
        if rider is not None:
            sub_attrs["_snap"] = rider
        tid = next(self._tids)
        # the pending entry must exist BEFORE any sub-op leaves: with
        # sharded dispatch a reply can be processed on another shard
        # worker ahead of this handler's next line (round-4 regression:
        # late registration dropped the ack and the op timed out)
        remote = sum(1 for s, o in enumerate(up)
                     if o is not None and o != self.osd_id)
        if remote:
            pw = _PendingWrite(m.client, m.tid, remote, version,
                               lock_key=lock_key, members=tuple(up))
            pw.span = getattr(m, '_span', None)
            pw.qphase = getattr(m, '_qos_phase', 0)
            pw.pq_ctx = getattr(m, '_pq_ctx', None)
            self._pending_writes[tid] = pw
        for shard, osd in enumerate(up):
            if osd is None:
                continue  # degraded write: hole shard skipped
            chunk = streams[shard] if shard < codec.k \
                else parity[shard - codec.k]
            # zero-copy wire path: a contiguous staged chunk (the
            # batcher's single metered d2h output) rides the frame by
            # reference — Encoder.blob refs the memoryview, sendmsg
            # gathers it; nothing mutates a flush output after the
            # fact.  Non-contiguous scatter views still flatten here.
            data = chunk.data if chunk.flags.c_contiguous \
                else chunk.tobytes()
            if csums is not None:
                attrs = dict(attrs, dcsum=int(csums[shard]))
                sub_attrs = dict(sub_attrs, dcsum=int(csums[shard]))
            if osd == self.osd_id:
                pre = (self._snap_apply_rider(pgid, m.oid, rider,
                                              shard=shard)
                       if rider is not None else None)
                tctx = self._tctx(m)
                try:
                    if tctx:
                        with self.tracer.start("sub-write write",
                                               parent=tctx, shard=shard,
                                               oid=m.oid) as sp, \
                                self.tracer.start("store-commit",
                                                  parent=sp.ctx):
                            self._apply_write(pgid, m.oid, shard, data,
                                              attrs, pre_tx=pre)
                    else:
                        self._apply_write(pgid, m.oid, shard, data,
                                          attrs, pre_tx=pre)
                except BaseException:
                    # the write-through above published these bytes at
                    # the new version; a failed local apply must not
                    # leave them serveable (the lock is released by
                    # _run_locked_thunk's unwind)
                    self._ec_cache.invalidate(pgid, m.oid)
                    raise
            else:
                self.messenger.send_message(
                    f"osd.{osd}",
                    MSubWrite(tid, pgid, m.oid, shard, version, "write",
                              data, dict(sub_attrs),
                              epoch=self._entry_epoch(),
                              trace=self._tctx(m), tenant=m.tenant))
        if remote == 0:
            conn.send(MOSDOpReply(m.tid, 0, version=version,
                                  epoch=self.osdmap.epoch))
            self._obj_unlock(lock_key)
            return

    # -- EC partial writes (parity delta / rmw; ECTransaction WritePlan) ---
    def _ec_object_version(self, pgid: PgId, oid: str) -> int:
        """The primary's local view of the object's version (any local
        shard's v attr; -1 if it holds none)."""
        cid = CollectionId(pgid.pool, pgid.seed)
        best = -1
        for shard in range(self.osdmap.pools[pgid.pool].size):
            try:
                attrs = self.store.getattrs(cid, ObjectId(oid, shard=shard))
                best = max(best, int(attrs.get("v", 0)))
            except NoSuchObject:
                continue
        return best

    def _ec_write_rows(self, conn, m: MOSDOp, pgid: PgId, up: list, codec,
                       si: StripeInfo, row0: int, row_bytes: bytes,
                       new_len: int, create: bool = False,
                       prev_version: int = -1,
                       lock_key: tuple | None = None,
                       rider: dict | None = None) -> None:
        """Encode and store whole stripe rows [row0, row0+n) — the
        full-stripe branch of the WritePlan: no reads; every shard
        (parity included) takes an extent write at the row offsets,
        conditional on prev_version (a stale shard refuses with EAGAIN
        and the client retries once recovery has caught it up)."""
        version = self._next_version(pgid)
        self._ec_cache.invalidate(pgid, m.oid)  # version moves past it
        streams = si.ro_scatter(row_bytes)
        parity, _csums = self._ec_encode(codec, streams,
                                         with_csums=False, m=m)
        base = row0 * si.chunk_size
        tid = next(self._tids)
        remote = sum(1 for o in up
                     if o is not None and o != self.osd_id)
        pw = None
        if remote:
            # registered BEFORE any send: a reply may run on another
            # shard worker immediately (sharded-dispatch ordering).
            # +1 ack for the primary's own store commit (the barrier
            # registered after the local tallies below).
            pw = _PendingWrite(m.client, m.tid, remote + 1, version,
                               lock_key=lock_key, members=tuple(up))
            pw.span = getattr(m, '_span', None)
            pw.qphase = getattr(m, '_qos_phase', 0)
            pw.pq_ctx = getattr(m, '_pq_ctx', None)
            self._pending_writes[tid] = pw
        local_failed = local_retry = 0
        for shard, osd in enumerate(up):
            if osd is None or osd != self.osd_id:
                continue
            chunk = streams[shard] if shard < codec.k \
                else parity[shard - codec.k]
            ext = [(base, chunk.tobytes())]
            pre = (self._snap_apply_rider(pgid, m.oid, rider,
                                          shard=shard)
                   if rider else None)
            code = self._apply_partial(pgid, m.oid, shard, ext, version,
                                       create_ok=create,
                                       total_len=new_len,
                                       prev_version=prev_version,
                                       pre_tx=pre)
            if code == EAGAIN:
                local_retry += 1
            elif code != 0:
                local_failed += 1
        if pw is not None:
            # local tallies land before any send, so a full ack drain
            # computes the true result; the commit barrier fires the
            # +1 local ack once those applies are durable
            pw.failed += local_failed
            pw.retry += local_retry
            self._local_commit_ack(tid, pgid)
        # write-through the freshly encoded rows, parity included (the
        # device-resident stripe plane's hot-read feed: the next
        # overlapping read or rmw of these rows serves from cache —
        # device-side on a torch pool — instead of fanning to the
        # stores); failure paths invalidate (below for local-only
        # writes, the sub-write ack drain for remote ones).  This MUST
        # precede the sends: a remote shard can fail and drain every
        # ack (invalidating) before this thread resumes, and a
        # write-through landing after that invalidation would re-
        # publish the failed write's bytes with no one left to drop
        # them.
        for shard in range(codec.chunk_count):
            if up[shard] is not None:
                chunk = streams[shard] if shard < codec.k \
                    else parity[shard - codec.k]
                self._ec_cache.write(pgid, m.oid, shard, base,
                                     chunk.tobytes(), version=version,
                                     length=new_len)
        for shard, osd in enumerate(up):
            if osd is None or osd == self.osd_id:
                continue
            chunk = streams[shard] if shard < codec.k \
                else parity[shard - codec.k]
            ext = [(base, chunk.tobytes())]
            self.messenger.send_message(
                f"osd.{osd}",
                MSubPartialWrite(tid, pgid, m.oid, shard, version, ext,
                                 total_len=new_len, create=create,
                                 prev_version=prev_version,
                                 epoch=self._entry_epoch(),
                                 snap=rider or {},
                                 trace=self._tctx(m),
                                 tenant=m.tenant))
        if remote == 0:
            result = EIO if local_failed else (EAGAIN if local_retry else 0)
            if result != 0:
                self._ec_cache.invalidate(pgid, m.oid)

            def _finish_local() -> None:
                # parity-delta fallback arrives over a bare _ClientConn
                # (no dispatch wrappers): book the one-shot ctx here —
                # harmless when conn IS wrapped (finish dedups)
                ctx = getattr(m, "_pq_ctx", None)
                if ctx is not None:
                    ctx.finish(0)
                conn.send(MOSDOpReply(m.tid, result, version=version,
                                      epoch=self.osdmap.epoch))
                self._obj_unlock(lock_key)
            # the client reply (and the unlock's next-thunk run) wait
            # for durability, on the pg's shard
            self._on_store_commit(pgid, _finish_local)

    def _ec_partial_write(self, conn, m: MOSDOp, pgid: PgId, up: list,
                          codec, si: StripeInfo, object_size: int,
                          lock_key: tuple | None = None,
                          rider: dict | None = None) -> None:
        """Parity-delta overwrite: read ONLY the old bytes being replaced,
        write the new bytes to their data-shard extents, and fold
        coef*delta into every parity shard at the same shard offsets — no
        stripe re-encode, no k-wide read (ECUtil.cc:519-566 role)."""
        segs = si.ro_range_segments(m.offset, len(m.data))
        per_shard: dict[int, list] = {}
        for shard, soff, ln, ro in segs:
            per_shard.setdefault(shard, []).append((soff, ln, ro))
        new_len = max(object_size, m.offset + len(m.data))
        tid = next(self._tids)

        def on_old(pr) -> None:
            if pr is None or any(s not in pr.chunks for s in per_shard):
                ctx = getattr(m, "_pq_ctx", None)
                if ctx is not None:
                    ctx.finish(0)
                self.messenger.send_message(
                    m.client, MOSDOpReply(m.tid, EIO,
                                          epoch=self.osdmap.epoch))
                self._obj_unlock(lock_key)
                return
            vers = {pr.shard_vers.get(s) for s in per_shard}
            if len(vers) != 1 or None in vers:
                # touched shards disagree on version (stale revived
                # shard): deltas computed from those bytes would poison
                # parity — take the row-rmw path, which decodes from a
                # version-agreed set instead
                self._ec_rmw_rows(_ClientConn(self, m.client), m, pgid,
                                  up, codec, si, object_size, lock_key,
                                  rider=rider)
                return
            prev = vers.pop()
            version = self._next_version(pgid)
            wtid = next(self._tids)
            remote_n = sum(1 for o in up
                           if o is not None and o != self.osd_id)
            pw = None
            if remote_n:
                # registered before any send (sharded-dispatch rule);
                # +1 ack for the primary's own store commit
                pw = _PendingWrite(m.client, m.tid, remote_n + 1,
                                   version, lock_key=lock_key,
                                   members=tuple(up))
                pw.span = getattr(m, '_span', None)
                pw.qphase = getattr(m, '_qos_phase', 0)
                pw.pq_ctx = getattr(m, '_pq_ctx', None)
                self._pending_writes[wtid] = pw
            deltas: dict[int, list[tuple[int, bytes]]] = {}
            news: dict[int, list[tuple[int, bytes]]] = {}
            for shard, exts in per_shard.items():
                blob = pr.chunks[shard]
                pos = 0
                for soff, ln, ro in exts:
                    old = np.asarray(blob[pos:pos + ln], dtype=np.uint8)
                    if old.size < ln:  # reading past a short shard: zeros
                        old = np.concatenate(
                            [old, np.zeros(ln - old.size, np.uint8)])
                    new = np.frombuffer(
                        m.data[ro - m.offset: ro - m.offset + ln],
                        dtype=np.uint8)
                    delta = codec.encode_delta(old, new)
                    deltas.setdefault(shard, []).append(
                        (soff, delta.tobytes()))
                    news.setdefault(shard, []).append((soff, new.tobytes()))
                    pos += ln
            local_failed = local_retry = 0

            def tally(code: int) -> None:
                nonlocal local_failed, local_retry
                if code == EAGAIN:
                    local_retry += 1
                elif code != 0:
                    local_failed += 1

            flat = [(ds, soff, dbytes) for ds, lst in deltas.items()
                    for soff, dbytes in lst]
            # LOCAL applies first (their tallies must be recorded on the
            # pending entry before any ack can drain it)
            for shard, osd in enumerate(up):
                if osd != self.osd_id:
                    continue
                pre = (self._snap_apply_rider(pgid, m.oid, rider,
                                              shard=shard)
                       if rider else None)
                if shard < codec.k:
                    tally(self._apply_partial(pgid, m.oid, shard,
                                              news.get(shard, []),
                                              version, total_len=new_len,
                                              prev_version=prev,
                                              pre_tx=pre))
                else:
                    tally(self._apply_delta_local(pgid, m.oid, shard,
                                                  flat, version,
                                                  total_len=new_len,
                                                  prev_version=prev,
                                                  pre_tx=pre))
            if pw is not None:
                pw.failed += local_failed
                pw.retry += local_retry
                self._local_commit_ack(wtid, pgid)
            # cache maintenance BEFORE any send (a remote failure can
            # drain every ack — invalidating — before this thread
            # resumes; a write-through landing after that would re-
            # publish the failed bytes): drop cached PARITY runs (the
            # deltas are applied shard-locally by the parity holders,
            # so the primary never sees the resulting parity — cached
            # parity bytes from an earlier full/row write would be
            # stale at the advanced version), then refill the data-
            # shard runs just written (the next overlapping overwrite
            # skips the read fan); failure paths invalidate
            self._ec_cache.drop_shards(
                pgid, m.oid, range(codec.k, codec.chunk_count))
            for shard, lst in news.items():
                for soff, nb in lst:
                    self._ec_cache.write(pgid, m.oid, shard, soff, nb,
                                         version=version,
                                         length=new_len)
            # data shards: new bytes (touched) or version bump (untouched)
            for shard, osd in enumerate(up):
                if osd is None or osd == self.osd_id:
                    continue
                if shard < codec.k:
                    self.messenger.send_message(
                        f"osd.{osd}",
                        MSubPartialWrite(wtid, pgid, m.oid, shard, version,
                                         news.get(shard, []),
                                         total_len=new_len,
                                         prev_version=prev,
                                         epoch=self._entry_epoch(),
                                         snap=rider or {},
                                         trace=self._tctx(m),
                                         tenant=m.tenant))
                else:
                    # parity: one delta message covering all data deltas
                    self.messenger.send_message(
                        f"osd.{osd}",
                        MSubDelta(wtid, pgid, m.oid, shard, version,
                                  list(flat), total_len=new_len,
                                  prev_version=prev,
                                  epoch=self._entry_epoch(),
                                  snap=rider or {},
                                  trace=self._tctx(m),
                                  tenant=m.tenant))
            if remote_n == 0:
                result = EIO if local_failed \
                    else (EAGAIN if local_retry else 0)
                if result != 0:
                    self._ec_cache.invalidate(pgid, m.oid)

                def _finish_local() -> None:
                    self.messenger.send_message(
                        m.client,
                        MOSDOpReply(m.tid, result, version=version,
                                    epoch=self.osdmap.epoch))
                    self._obj_unlock(lock_key)
                self._on_store_commit(pgid, _finish_local)

        # extent-cache fast path (ECExtentCache role): if EVERY touched
        # segment is cached at a known version, skip the read fan-out
        cver = self._ec_cache.version(pgid, m.oid)
        if cver is not None:
            cached: dict[int, np.ndarray] = {}
            for shard, exts in per_shard.items():
                parts = []
                for soff, ln, _ro in exts:
                    b = self._ec_cache.read(pgid, m.oid, shard, soff, ln)
                    if b is None:
                        break
                    parts.append(b)
                else:
                    cached[shard] = np.frombuffer(b"".join(parts),
                                                  dtype=np.uint8)
                    continue
                break
            if len(cached) == len(per_shard):
                self.perf.inc("ec_cache_hit")
                pr = _PendingRead(None, 0, pgid.pool, m.oid,
                                  total_shards=len(per_shard))
                pr.chunks = cached
                pr.shard_vers = {s: cver for s in per_shard}
                on_old(pr)
                return
        self.perf.inc("ec_cache_miss")
        pr = _PendingRead(None, 0, pgid.pool, m.oid,
                          total_shards=len(per_shard), on_done=on_old)
        self._pending_reads[tid] = pr
        coalesce = self._ec_read_coalesce_on(pgid.pool)
        span = getattr(m, "_span", None)
        trace = (self.tracer, span.ctx) if span is not None else None
        self._note_asked(tid, {shard: up[shard] for shard in per_shard})
        for shard, exts in per_shard.items():
            osd = up[shard]
            want = [(soff, ln) for soff, ln, _ro in exts]
            if osd == self.osd_id:
                self._deliver_local_shard_read(tid, pgid, m.oid, shard,
                                               want)
            elif coalesce:
                self._read_agg.submit(f"osd.{osd}", tid, pgid, m.oid,
                                      shard, want, trace=trace)
            else:
                self.messenger.send_message(
                    f"osd.{osd}", MSubRead(tid, pgid, m.oid, shard, want))

    def _ec_rmw_rows(self, conn, m: MOSDOp, pgid: PgId, up: list, codec,
                     si: StripeInfo, object_size: int,
                     lock_key: tuple | None = None,
                     rider: dict | None = None) -> None:
        """Read-modify-write over the touched stripe rows ONLY (never the
        whole object): read the rows' shard extents from >= k shards
        (decoding when degraded), merge the new bytes, re-encode the rows,
        store them (ECCommon RMWPipeline + ECExtentCache read role)."""
        row0, nrows = si.rows_of_range(m.offset, len(m.data))
        old_rows = si.object_chunk_size(object_size) // si.chunk_size
        read_rows = min(nrows, max(0, old_rows - row0))
        end = m.offset + len(m.data)
        new_len = max(object_size, end)
        if read_rows <= 0:
            # touched rows hold no live data: append-style full rows
            buf = bytearray(nrows * si.stripe_width)
            start = m.offset - row0 * si.stripe_width
            buf[start:start + len(m.data)] = m.data
            self._ec_write_rows(conn, m, pgid, up, codec, si, row0,
                                bytes(buf), new_len,
                                create=object_size == 0,
                                prev_version=self._ec_object_version(
                                    pgid, m.oid) if object_size else -1,
                                lock_key=lock_key, rider=rider)
            return
        want_len = read_rows * si.chunk_size
        ext = [(row0 * si.chunk_size, want_len)]
        tid = next(self._tids)

        def on_read(pr) -> None:
            have = dict(pr.chunks) if pr is not None else {}
            vmax = -1
            if pr is not None and pr.shard_vers:
                # merge only against a version-AGREED read set: a stale
                # revived shard's old rows must not be re-encoded into the
                # new stripe and stamped current
                vmax = max(pr.shard_vers.values())
                have = {s: c for s, c in have.items()
                        if pr.shard_vers.get(s) == vmax}
            for s in list(have):
                c = have[s]
                if c.size < want_len:
                    have[s] = np.concatenate(
                        [c, np.zeros(want_len - c.size, np.uint8)])
            if len(have) < codec.k:
                # no agreed decodable set right now: transient if a stale
                # shard is still being recovered, so let the client retry
                err = EAGAIN if (pr is not None
                                 and len(pr.chunks) >= codec.k) else EIO
                self.messenger.send_message(
                    m.client, MOSDOpReply(m.tid, err,
                                          epoch=self.osdmap.epoch))
                self._obj_unlock(lock_key)
                return
            data_ids = list(range(codec.k))
            if all(i in have for i in data_ids):
                streams = [have[i] for i in data_ids]
            else:
                dec = self._ec_decode(codec, data_ids, have,
                                      span=getattr(m, "_span", None))
                streams = [dec[i] for i in data_ids]
            old = si.ro_assemble(streams).tobytes()
            buf = bytearray(nrows * si.stripe_width)
            buf[: len(old)] = old[: len(buf)]
            start = m.offset - row0 * si.stripe_width
            buf[start:start + len(m.data)] = m.data
            self._ec_write_rows(_ClientConn(self, m.client), m, pgid, up,
                                codec, si, row0, bytes(buf), new_len,
                                prev_version=vmax, lock_key=lock_key,
                                rider=rider)

        # extent-cache serve (the stripe plane's rmw feed): the touched
        # rows' old bytes were written through by the previous write,
        # so a hot-object rmw skips the k-wide read fan-out entirely —
        # on_read sees a synthetic version-agreed k-set and proceeds
        # straight to merge + re-encode (whose encode input then stages
        # once in the batcher's device ingest)
        cver = self._ec_cache.version(pgid, m.oid)
        if cver is not None:
            cached: dict[int, np.ndarray] = {}
            for shard in range(codec.k):
                b = self._ec_cache.read(pgid, m.oid, shard,
                                        row0 * si.chunk_size, want_len)
                if b is None:
                    break
                cached[shard] = np.frombuffer(b, dtype=np.uint8)
            else:
                self.perf.inc("ec_rmw_cache_serves")
                served = _PendingRead(None, 0, pgid.pool, m.oid,
                                      total_shards=codec.k)
                served.chunks = cached
                served.shard_vers = {s: cver for s in cached}
                on_read(served)
                return
        pr = _PendingRead(None, 0, pgid.pool, m.oid,
                          total_shards=sum(1 for u in up if u is not None),
                          on_done=on_read)
        self._pending_reads[tid] = pr
        self._fan_shard_reads(tid, pgid, m.oid, up, extents=ext)

    def _apply_partial(self, pgid: PgId, oid: str, shard: int,
                       extents: list, version: int,
                       create_ok: bool = False,
                       total_len: int | None = None,
                       prev_version: int = -1,
                       pre_tx: Transaction | None = None,
                       extra_attrs: dict | None = None) -> int:
        """Apply extent overwrites to one shard chunk + refresh v/digest.
        Returns 0, ENOENT, or EAGAIN (no change on nonzero).

        ENOENT when the object is absent and create_ok is not set: a
        lagging replica/shard must NEVER fabricate a zero-filled chunk
        stamped with the new version — recovery's version gate would then
        consider it current forever.  Only the primary creating a
        genuinely new object passes create_ok.

        EAGAIN when prev_version >= 0 and the stored shard is at a
        DIFFERENT version: the primary computed these extents against
        prev_version bytes, so applying them over stale (or newer) data
        would desynchronize the stripe while stamping it current."""
        cid = CollectionId(pgid.pool, pgid.seed)
        obj = to_oid(oid, shard)
        tx = Transaction()
        if pre_tx is not None:
            tx.append(pre_tx)
        exists = self.store.exists(cid, obj)
        old_attrs: dict = {}
        if not exists:
            if not create_ok:
                return ENOENT
            tx.touch(cid, obj)
        else:
            old_attrs = dict(self.store.getattrs(cid, obj))
            if prev_version >= 0 and \
                    int(old_attrs.get("v", 0)) != prev_version:
                return EAGAIN
            # extent writes (and their rollback pre-images) operate in
            # raw space: a compressed stored blob rewrites raw first
            # and stays raw until the next whole-object ingest
            old_attrs = self._inflate_in_place(cid, obj, old_attrs)
        # stash the pre-images being overwritten (the PGLog rollback
        # generation role): a torn partial write rolls back via these
        rollback = []
        old_shard_len = -1
        if exists:
            old_shard_len = self.store.stat(cid, obj)["size"]
            for coff, data in extents:
                old = self.store.read(cid, obj, coff,
                                      len(data)).to_bytes()
                old += b"\0" * (len(data) - len(old))
                rollback.append((coff, old))
        ev = self._entry_epoch()
        for coff, data in extents:
            tx.write(cid, obj, coff, data)
        self._log_apply(tx, pgid, LogEntry(
            version, "rows", oid, shard,
            prev_version=int(old_attrs.get("v", -1)),
            rollback=rollback,
            old_len=int(old_attrs.get("len", -1)),
            old_shard_len=old_shard_len, epoch=ev))
        self.store.queue_transaction(tx)
        data = self.store.read(cid, obj).to_bytes()
        attrs = dict(self.store.getattrs(cid, obj))
        if extra_attrs:
            attrs.update(extra_attrs)
        if attrs.get("wh"):
            attrs["wh"] = 0  # extents land = the object lives again
        attrs["v"] = version
        attrs["ev"] = ev
        attrs["d"] = native_crc32c(data)
        if shard < 0:
            # replicated: the object IS the data; track its size for stat
            attrs["len"] = len(data)
        elif total_len is not None and total_len >= 0:
            # EC shards carry "len" = whole-object length; growing partial
            # writes move it forward
            attrs["len"] = max(int(attrs.get("len", 0)), total_len)
        self.store.queue_transaction(
            Transaction().setattrs(cid, obj, attrs))
        return 0

    def _apply_delta_local(self, pgid: PgId, oid: str, parity_shard: int,
                           extents: list, version: int,
                           total_len: int | None = None,
                           prev_version: int = -1,
                           pre_tx: Transaction | None = None) -> int:
        """Fold coef*delta extents into the stored parity chunk via the
        plugin's apply_delta (one chunk read/write for the whole batch).
        Returns 0, ENOENT (parity chunk absent — shard not yet
        recovered), or EAGAIN (stored version != prev_version: folding a
        delta into stale parity would poison it while stamping it
        current)."""
        codec = self._pool_codec(pgid.pool)
        cid = CollectionId(pgid.pool, pgid.seed)
        obj = ObjectId(oid, shard=parity_shard)
        if not self.store.exists(cid, obj):
            return ENOENT
        cur_attrs = dict(self.store.getattrs(cid, obj))
        if prev_version >= 0 and int(cur_attrs.get("v", 0)) != \
                prev_version:
            return EAGAIN
        # delta folds are raw-space extent arithmetic: inflate a
        # compressed parity chunk before folding into it
        self._inflate_in_place(cid, obj, cur_attrs)
        # fold deltas over ONE union-range buffer: extents from different
        # data shards overlap in parity space (same stripe row), and the
        # folds must accumulate — read the covering range once, fold all,
        # write it back (and only this range is stashed for rollback,
        # not the whole parity stream)
        lo = min(coff for _ds, coff, _d in extents)
        hi = max(coff + len(d) for _ds, coff, d in extents)
        old = self.store.read(cid, obj, lo, hi - lo).to_bytes()
        old += b"\0" * ((hi - lo) - len(old))
        buf = np.frombuffer(old, dtype=np.uint8).copy()
        for ds, coff, dbytes in extents:
            view = buf[coff - lo: coff - lo + len(dbytes)]
            codec.apply_delta(np.frombuffer(dbytes, dtype=np.uint8), ds,
                              {parity_shard: view})
        return self._apply_partial(pgid, oid, parity_shard,
                                   [(lo, buf.tobytes())], version,
                                   total_len=total_len, pre_tx=pre_tx)

    def _handle_sub_partial_write(self, conn, m: MSubPartialWrite) -> None:
        self.perf.inc("subop_w")
        self._sub_epoch.v = m.epoch
        self._subw_begin(m.pgid, m.oid)
        try:
            pre = (self._snap_apply_rider(m.pgid, m.oid, m.snap,
                                          shard=m.shard)
                   if m.snap else None)
            code = self._apply_partial(
                m.pgid, m.oid, m.shard, m.extents, m.version,
                create_ok=m.create,
                total_len=m.total_len if m.total_len >= 0 else None,
                prev_version=m.prev_version, pre_tx=pre)
        finally:
            self._sub_epoch.v = 0
            self._subw_end(m.pgid, m.oid)
        if code == 0:
            self._pg_versions[m.pgid] = max(
                self._pg_versions.get(m.pgid, 0), m.version)
            self.store.commit_barrier(lambda: conn.send(
                MSubWriteReply(m.tid, m.pgid, m.shard, self.osd_id, 0)))
        else:
            # refusal: nothing was applied, nothing to wait on
            conn.send(MSubWriteReply(m.tid, m.pgid, m.shard, self.osd_id,
                                     code))

    def _handle_sub_delta(self, conn, m: MSubDelta) -> None:
        self.perf.inc("subop_w")
        self._sub_epoch.v = m.epoch
        self._subw_begin(m.pgid, m.oid)
        try:
            pre = (self._snap_apply_rider(m.pgid, m.oid, m.snap,
                                          shard=m.parity_shard)
                   if m.snap else None)
            code = self._apply_delta_local(
                m.pgid, m.oid, m.parity_shard, m.extents, m.version,
                total_len=m.total_len if m.total_len >= 0 else None,
                prev_version=m.prev_version, pre_tx=pre)
        finally:
            self._sub_epoch.v = 0
            self._subw_end(m.pgid, m.oid)
        if code == 0:
            self._pg_versions[m.pgid] = max(
                self._pg_versions.get(m.pgid, 0), m.version)
            self.store.commit_barrier(lambda: conn.send(
                MSubWriteReply(m.tid, m.pgid, m.parity_shard,
                               self.osd_id, 0)))
        else:
            conn.send(MSubWriteReply(m.tid, m.pgid, m.parity_shard,
                                     self.osd_id, code))

    # -- read scale-out: balanced reads + client read leases ---------------
    # client ops that mutate object DATA bytes (and so must revoke
    # outstanding read leases at dispatch).  omap/xattr/watch mutations
    # deliberately absent: the leased bytes are unchanged.
    _LEASE_REVOKE_OPS = ("write", "write_full", "remove",
                         "snap_rollback", "multi_write", "call")
    _LEASE_NOTIFIER = "_lease"
    _READ_EWMA_CAP = 4096

    def _read_policy(self, pool) -> str:
        return str(pool.ec_profile.get("read_policy",
                                       "primary")).lower()

    def _balanced_read_ok(self, m: MOSDOp, pool, up: list) -> bool:
        """Whether THIS non-primary OSD may serve m under the pool's
        read_policy=balance: plain head reads only (snap reads bounce
        to the primary — clone-resolution state lives there), and only
        while the map says we hold a shard of the object's PG."""
        return (m.op == "read" and not getattr(m, "snapid", 0)
                and any(u == self.osd_id for u in up)
                and self._read_policy(pool) == "balance")

    def _lease_maybe_grant(self, pgid: PgId, oid: str, client: str,
                           whole: bool = True) -> float:
        """Advance the object's read-rate EWMA and, when it crosses
        osd_read_lease_rate on a WHOLE-object read, grant `client` a
        TTL lease (returned; 0.0 = no grant) and remember the grant so
        a write can revoke it.  A RANGED read never starts a lease but
        RIDES one the object already carries: the client joins the
        existing grant window (max outstanding expiry — never extended)
        so its cached range stays revocable, and the reply carries the
        remaining time.  On a balanced holder the grant is also
        registered at the primary — the ordering point for writes —
        fire-and-forget (a lost register is bounded by the TTL)."""
        ttl = float(self.cfg["osd_read_lease_ttl"])
        if ttl <= 0.0 or not client:
            return 0.0
        now = time.time()
        key = (pgid, oid)
        with self._lease_lock:
            rate, last = self._read_ewma.get(key, (0.0, now))
            dt = max(now - last, 1e-6)
            # dt-scaled EWMA with a ~1s time constant: rate converges
            # to the instantaneous read rate within about a second of
            # sustained traffic, so only genuinely hot objects grant
            alpha = min(1.0, dt)
            rate = (1.0 - alpha) * rate + alpha / dt
            self._read_ewma[key] = (rate, now)
            self._read_ewma.move_to_end(key)
            while len(self._read_ewma) > self._READ_EWMA_CAP:
                self._read_ewma.popitem(last=False)
            if not whole:
                g = self._lease_grants.get(key)
                horizon = max(g.values()) if g else 0.0
                if horizon <= now:
                    return 0.0
                # ride: join the object's live window, don't extend it
                g[client] = max(g.get(client, 0.0), horizon)
                expires = horizon
            else:
                if rate < float(self.cfg["osd_read_lease_rate"]):
                    return 0.0
                expires = now + ttl
                self._lease_grants.setdefault(key, {})[client] = expires
        self.perf.inc("read_lease_ride" if not whole
                      else "read_lease_grant")
        if self.osdmap is not None:
            up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
            primary = self._primary_of(up)
            if primary is not None and primary != self.osd_id:
                self.messenger.send_message(
                    f"osd.{primary}",
                    MLeaseRegister(pgid, oid, client, expires))
        return expires - now

    def _handle_lease_register(self, conn, m: MLeaseRegister) -> None:
        with self._lease_lock:
            g = self._lease_grants.setdefault((m.pgid, m.oid), {})
            g[m.client] = max(g.get(m.client, 0.0), m.expires)

    def _lease_revoke(self, pgid: PgId, oid: str) -> None:
        """Drop every outstanding read lease on the object and ping
        the holders ("_lease" notify, notify_id 0 = no ack collection:
        the TTL bounds a lost ping).  Called at the primary's write
        choke point and by shard holders observing sub-writes."""
        with self._lease_lock:
            grants = self._lease_grants.pop((pgid, oid), None)
        if not grants:
            return
        now = time.time()
        for client, expires in grants.items():
            if expires <= now:
                continue
            self.perf.inc("read_lease_revoke")
            self.messenger.send_message(
                client, MWatchNotify(0, pgid.pool, oid,
                                     self._LEASE_NOTIFIER))

    def _sweep_leases(self, now: float) -> None:
        with self._lease_lock:
            for key in list(self._lease_grants):
                g = self._lease_grants[key]
                for c in [c for c, e in g.items() if e <= now]:
                    del g[c]
                if not g:
                    del self._lease_grants[key]

    # -- hot-read tier: sub-write fence + second-hit admission -------------
    def _subw_begin(self, pgid: PgId, oid: str) -> None:
        """A sub-write apply is starting on this shard holder: block
        hot-tier admission of the object until _subw_end publishes the
        write (note + invalidate), closing the window where a read
        that fetched pre-write bytes could admit them as current."""
        key = (pgid, oid)
        with self._wbar_lock:
            self._subw_inflight[key] = \
                self._subw_inflight.get(key, 0) + 1

    def _subw_end(self, pgid: PgId, oid: str) -> None:
        """Sub-write applied: publish it (write-seq note — the fence
        balanced reads and admission check against), drop any cached
        bytes the write outdated, revoke locally-issued leases, THEN
        clear the in-flight mark (order matters: an admission that
        misses the in-flight mark must see the note instead)."""
        key = (pgid, oid)
        self._note_obj_write(key)
        self._ec_cache.invalidate(pgid, oid)
        self._lease_revoke(pgid, oid)
        with self._wbar_lock:
            n = self._subw_inflight.get(key, 0) - 1
            if n > 0:
                self._subw_inflight[key] = n
            else:
                self._subw_inflight.pop(key, None)

    def _subw_busy(self, pgid: PgId, oid: str) -> bool:
        with self._wbar_lock:
            return (pgid, oid) in self._subw_inflight

    def _tier_on(self) -> bool:
        return str(self.cfg["ec_read_tier"]).lower() not in (
            "off", "false", "0", "no")

    def _tier_admit_ok(self, pgid: PgId, oid: str) -> bool:
        """Second-hit promotion (zipf-aware admission): the first read
        of an object only RECORDS it in a bounded LRU window; a repeat
        read while still in the window admits.  A one-pass scan churns
        through the window without ever admitting."""
        if not self._tier_on():
            return False
        key = (pgid, oid)
        with self._tier_lock:
            if key in self._tier_seen:
                self._tier_seen.move_to_end(key)
                return True
            self._tier_seen[key] = True
            cap = int(self.cfg["ec_read_tier_seen_cap"])
            while len(self._tier_seen) > cap:
                self._tier_seen.popitem(last=False)
            return False

    def _tier_admit(self, pr: "_PendingRead", pgid: PgId,
                    streams: list, vmax: int, total: int) -> None:
        """Admit the k data-shard streams of a just-served whole-object
        read into the extent cache (and through it the device arena).
        Fenced twice: skip while a sub-write apply is in flight, and
        UNDO if the write-seq moved past the marker captured at read
        fan-out — either way stale bytes can never sit under a
        serveable (version, length) key."""
        key = (pgid, pr.oid)
        if self._subw_busy(pgid, pr.oid):
            return
        with self._pending_lock:
            if self._obj_locks.get(key):
                return  # primary-side write pipeline active
        for shard, s in enumerate(streams):
            self._ec_cache.write(pgid, pr.oid, shard, 0,
                                 s.tobytes(), version=vmax,
                                 length=total)
        if self._subw_busy(pgid, pr.oid) or \
                self._obj_written_since(key, pr.wmarker):
            self._ec_cache.invalidate(pgid, pr.oid)
        else:
            self.perf.inc("ec_read_tier_admit")

    def _ec_read(self, conn, m: MOSDOp, pgid: PgId, up: list,
                 balanced: bool = False) -> None:
        si = self._pool_stripe(pgid.pool)
        target = m.oid
        if getattr(m, "snapid", 0):
            # snapshot read: resolve to the clone vname serving snapid
            # (find_object_context role; the shard reads then address
            # each shard's generation object via to_oid)
            target = self._ec_snap_resolve(pgid, m.oid, m.snapid)
            if target is None:
                conn.send(MOSDOpReply(m.tid, ENOENT,
                                      epoch=self.osdmap.epoch))
                return
        elif self._ec_whiteout(pgid, m.oid):
            conn.send(MOSDOpReply(m.tid, ENOENT,
                                  epoch=self.osdmap.epoch))
            return
        if target != m.oid:
            import dataclasses
            m = dataclasses.replace(m, oid=target)
        elif not getattr(m, "snapid", 0) and \
                self._ec_read_serve_cached(conn, m, pgid, si,
                                           balanced=balanced):
            return  # hot-object read served from the extent cache
        if not getattr(m, "snapid", 0) and self._tier_on():
            self.perf.inc("ec_read_tier_miss")
        tid = next(self._tids)
        extents = None
        row_base = row_len = 0
        if m.length:
            # range read: fetch only the stripe rows covering the range
            # (the shard_extent_set_t construction of a ReadPipeline op)
            row0, nrows = si.rows_of_range(m.offset, m.length)
            row_base = row0 * si.stripe_width
            row_len = nrows * si.chunk_size
            extents = [(row0 * si.chunk_size, row_len)]
        pr = _PendingRead(m.client, m.tid, pgid.pool, m.oid,
                          total_shards=sum(1 for u in up if u is not None),
                          offset=m.offset, length=m.length,
                          row_base=row_base, row_len=row_len)
        pr.span = getattr(m, "_span", None)
        pr.qphase = getattr(m, '_qos_phase', 0)
        pr.pq_ctx = getattr(m, '_pq_ctx', None)
        pr.balanced = balanced
        pr.wmarker = self._obj_write_marker()
        self._pending_reads[tid] = pr
        if pr.span is not None:
            # the fan-out stage of a traced read: local shard reads run
            # inside it, remote sub-reads queue their ec-read-wait
            # spans under it (the READ counterpart of ec-encode)
            with self.tracer.start("ec-subread-fanout",
                                   parent=pr.span.ctx, oid=m.oid) as sp:
                self._fan_shard_reads(tid, pgid, m.oid, up,
                                      extents=extents,
                                      trace=(self.tracer, sp.ctx))
        else:
            self._fan_shard_reads(tid, pgid, m.oid, up, extents=extents)

    def _ec_read_serve_cached(self, conn, m: MOSDOp, pgid: PgId,
                              si: StripeInfo,
                              balanced: bool = False) -> bool:
        """Serve a head-object client read entirely from the extent
        cache (the device-resident stripe plane's hot-read path): when
        every data shard's covering stream is cached at a known
        version, the read never fans to the stores or the wire — and
        on a torch pool the shard rows assemble on the card from the arena's
        device mirrors, leaving as one metered d2h copy.  Returns
        False (caller fans out) on any gap; the invalidation contract
        (recovery pushes, rollbacks, removes, map changes, failed
        writes) keeps a True serve byte-identical to the store path."""
        if str(self.cfg["ec_read_cache_serve"]).lower() in (
                "off", "false", "0", "no"):
            return False
        # write-seq fence (balanced holders have no _obj_locks view of
        # the primary's pipeline, but they DO observe sub-write applies
        # — _subw_end notes them): captured before the version check,
        # re-checked after assembly
        wmarker = self._obj_write_marker()
        if self._subw_busy(pgid, m.oid):
            return False
        with self._pending_lock:
            if self._obj_locks.get((pgid, m.oid)):
                # a write/remove is in flight on the object: its
                # write-through populated the cache at the NEW version
                # before the shard acks drained, and serving that would
                # expose bytes the client was never acked (a failed
                # drain invalidates them away again).  Fall out to the
                # store path, which the sharded op queue serializes
                # with the applies.
                return False
        total = self._ec_cache.object_len(pgid, m.oid)
        if self._ec_cache.version(pgid, m.oid) is None or not total:
            return False
        codec = self._pool_codec(pgid.pool)
        if m.length:
            row0, nrows = si.rows_of_range(m.offset, m.length)
            soff, slen = row0 * si.chunk_size, nrows * si.chunk_size
            row_base = row0 * si.stripe_width
        else:
            soff, slen = 0, si.object_chunk_size(total)
            row_base = 0
        span = getattr(m, "_span", None)
        with (self.tracer.start("ec-cache-serve", parent=span.ctx,
                                oid=m.oid)
              if span is not None else contextlib.nullcontext()):
            ro = self._ec_cached_ro(codec, si, pgid, m.oid, soff, slen)
        if ro is None:
            return False
        with self._pending_lock:
            if self._obj_locks.get((pgid, m.oid)):
                # TOCTOU re-check: a write that registered AFTER the
                # guard above may have invalidated + written through
                # its (unacked) new version while we assembled — the
                # assembled bytes are only guaranteed committed if no
                # write appeared during assembly.  (A write registering
                # after THIS check hasn't touched the cache yet, so the
                # assembled bytes are the committed pre-write state.)
                return False
        if self._subw_busy(pgid, m.oid) or \
                self._obj_written_since((pgid, m.oid), wmarker):
            # a sub-write landed (or is landing) while we assembled:
            # the bytes may be the outdated pre-write state
            return False
        self.perf.inc("ec_read_cache_hit")
        self.perf.inc("ec_read_tier_hit")
        if balanced:
            self.perf.inc("balanced_read_serve")
        if m.length:
            # identical trimming to _finish_ec_read's range leg
            limit = max(0, min(len(ro), total - row_base))
            start = m.offset - row_base
            payload = ro[:limit][start:start + m.length]
        else:
            payload = ro[:total]
            if m.offset:
                payload = payload[m.offset:]
        lease = self._lease_maybe_grant(pgid, m.oid, m.client,
                                        whole=not m.length
                                        and not m.offset)
        conn.send(MOSDOpReply(m.tid, 0, data=payload,
                              epoch=self.osdmap.epoch, lease=lease))
        return True

    def _ec_cached_ro(self, codec, si: StripeInfo, pgid: PgId, oid: str,
                      soff: int, slen: int) -> bytes | None:
        """The k data-shard streams [soff, soff+slen) interleaved back
        into ro bytes, from the extent cache only — device-assembled
        (views of the arena's runs, one metered d2h for the payload)
        when every stream is arena-resident on a torch pool,
        host-assembled otherwise.  None = not fully cached.  A failed
        device assembly raises: only a stream that is not cached
        falls through to the host."""
        if getattr(codec, "_backend", None) == "torch":
            devs = []
            for shard in range(codec.k):
                d = self._ec_cache.read_device(pgid, oid, shard, soff,
                                               slen, codec.device)
                if d is None:
                    devs = None
                    break
                devs.append(d)
            if devs is not None:
                rows = slen // si.chunk_size
                ro_dev = torch.stack(devs).reshape(
                    codec.k, rows, si.chunk_size).transpose(
                    0, 1).reshape(-1)
                (ro,) = staging.fetch_recorded(
                    [ro_dev], sig="sync/cache-read")
                return ro.tobytes()
        parts = []
        for shard in range(codec.k):
            b = self._ec_cache.read(pgid, oid, shard, soff, slen)
            if b is None:
                return None
            parts.append(np.frombuffer(b, dtype=np.uint8))
        return si.ro_assemble(parts).tobytes()

    def _ec_read_coalesce_on(self, pool_id: int) -> bool:
        """Whether this pool's remote sub-reads route through the
        per-peer aggregator: pool ec-profile key 'read_coalesce' wins,
        then the ec_read_coalesce option; 'auto' engages under the
        sharded mclock scheduler (reads fan out async, so concurrent
        bursts overlap and the window buys message fan-in; a 0 window
        is always pass-through)."""
        if self._read_agg.window_us <= 0:
            return False
        codec = self._pool_codec(pool_id)
        mode = str(codec.profile.get(
            "read_coalesce", self.cfg["ec_read_coalesce"])).lower()
        if mode in ("on", "true", "1", "yes"):
            return True
        if mode in ("off", "false", "0", "no"):
            return False
        return self._use_mclock

    def _fan_shard_reads(self, tid: int, pgid: PgId, oid: str,
                         up: list, extents: list | None = None,
                         trace: tuple | None = None,
                         klass: str = "client") -> None:
        # recovery fetches bypass the client-read aggregator AND carry
        # their class on the wire: the serving peer queues them under
        # its recovery reservation/limit, not in the client lane
        coalesce = klass == "client" \
            and self._ec_read_coalesce_on(pgid.pool)
        self._note_asked(tid, {shard: osd for shard, osd in enumerate(up)})
        for shard, osd in enumerate(up):
            if osd is None:
                continue
            if osd == self.osd_id:
                self._deliver_local_shard_read(tid, pgid, oid, shard,
                                               extents)
            elif coalesce:
                self._read_agg.submit(f"osd.{osd}", tid, pgid, oid,
                                      shard, extents, trace=trace)
            else:
                self.messenger.send_message(
                    f"osd.{osd}", MSubRead(tid, pgid, oid, shard,
                                           extents, klass=klass))

    def _read_shard_slices(self, cid, obj, extents: list | None) -> bytes:
        """Whole shard stream, or the concatenation of the requested
        slices read RANGED from the store (a 4K range read of a huge
        object must not materialize the whole shard), each zero-padded to
        its requested length (absent tail bytes of a padded stripe row
        are zeros)."""
        if not extents:
            return self.store.read(cid, obj).to_bytes()
        parts = []
        for off, ln in extents:
            seg = self.store.read(cid, obj, off, ln).to_bytes()
            if len(seg) < ln:
                seg += b"\0" * (ln - len(seg))
            parts.append(seg)
        return b"".join(parts)

    #: shard attrs a RANGED client sub-read ships: the verification /
    #: assembly set only (version agreement, whole-object length, the
    #: stored digest, whiteout) — user attrs, SnapSets and the rest of
    #: the attr dict stay home.  Whole-shard recovery reads keep the
    #: full dict + omap (a rebuilt shard must land WITH its metadata).
    _RANGED_READ_ATTRS = ("v", "len", "d", "dcsum", "wh")

    def _read_one_sub(self, pgid: PgId, oid: str, shard: int,
                      extents: list | None):
        """Serve one sub-read against the local store: (result, data,
        attrs) with MSubReadReply semantics — shared by the per-op and
        vectorized handlers and the local fast path."""
        cid = CollectionId(pgid.pool, pgid.seed)
        obj = to_oid(oid, shard)  # vname-aware (clone shards)
        try:
            attrs = dict(self.store.getattrs(cid, obj))
            if "cz" in attrs:
                # compressed shard: inflate (whole blob — compressed
                # extents have no ranged form) and serve RAW slices;
                # the wire carries raw bytes only, so the extent
                # metadata stays home
                raw = self._inflate(self.store.read(cid, obj).to_bytes(),
                                    attrs)
                attrs.pop("cz")
                attrs.pop("crl", None)
                if extents:
                    parts = []
                    for off, ln in extents:
                        seg = raw[off:off + ln]
                        if len(seg) < ln:
                            seg += b"\0" * (ln - len(seg))
                        parts.append(seg)
                    data = b"".join(parts)
                else:
                    data = raw
            else:
                data = self._read_shard_slices(cid, obj, extents)
            if extents is None:
                # whole-shard reads serve recovery: the object's
                # replicated omap rides along so a rebuilt shard lands
                # WITH metadata (ECOmapJournal recovery contract)
                omap = self.store.omap_get(cid, obj)
                if omap:
                    attrs["_omap"] = omap
            else:
                # ranged client reads ship only the shard-verification
                # attrs, not the whole dict
                attrs = {k: attrs[k] for k in self._RANGED_READ_ATTRS
                         if k in attrs}
            return 0, data, attrs
        except NoSuchObject:
            return ENOENT, b"", {}
        except (StoreError, ValueError):
            # checksum-poisoned shard (FileStore csum verify) or a
            # compressed blob that no longer inflates: report EIO
            # promptly so decode proceeds from the remaining shards
            return EIO, b"", {}

    def _deliver_local_shard_read(self, tid, pgid, oid, shard,
                                  extents: list | None = None) -> None:
        result, data, attrs = self._read_one_sub(pgid, oid, shard,
                                                 extents)
        self._on_shard_read(tid, shard, result, data, attrs)

    def _handle_sub_read(self, conn, m: MSubRead) -> None:
        self.perf.inc("subop_r")
        result, data, attrs = self._read_one_sub(m.pgid, m.oid, m.shard,
                                                 m.extents)
        conn.send(MSubReadReply(m.tid, m.pgid, m.oid, m.shard,
                                self.osd_id, result, data, attrs))

    def _handle_sub_read_n(self, conn, m: MSubReadN) -> None:
        """Vectorized sub-read: serve every coalesced fetch and answer
        them all in ONE MSubReadReplyN.  Runs on m.pgid's scheduler
        shard (every item shares the pg), serialized against the pg's
        write applies like a plain MSubRead."""
        replies = []
        for fid, oid, shard, extents in m.items:
            self.perf.inc("subop_r")
            result, data, attrs = self._read_one_sub(m.pgid, oid, shard,
                                                     extents)
            replies.append((fid, shard, result, data, attrs))
        conn.send(MSubReadReplyN(self.osd_id, replies, m.pgid))

    def _handle_sub_read_reply(self, conn, m: MSubReadReply) -> None:
        self._on_shard_read(m.tid, m.shard, m.result, m.data, m.attrs)

    def _handle_sub_read_reply_n(self, conn, m: MSubReadReplyN) -> None:
        self._read_agg.on_reply(f"osd.{m.from_osd}", m.items)

    def _note_asked(self, tid: int, asked: dict) -> None:
        """Record on pending read ``tid`` the OSD each shard's sub-read
        goes to (this OSD's own shards need no record)."""
        with self._pending_lock:
            pr = self._pending_reads.get(tid)
            if pr is not None:
                pr.asked.update({s: o for s, o in asked.items()
                                 if o is not None and o != self.osd_id})

    def _on_shard_read(self, tid, shard, result, data, attrs) -> None:
        with self._pending_lock:
            pr = self._pending_reads.get(tid)
            if pr is None:
                return
            pr.asked.pop(shard, None)
            pr.replies += 1
            if result == 0:
                pr.chunks[shard] = np.frombuffer(data, dtype=np.uint8)
                if attrs:
                    attrs = dict(attrs)
                    omap = attrs.pop("_omap", None)
                    if omap is not None:
                        pr.omaps[shard] = omap
                    pr.attrs.update(attrs)
                    pr.shard_attrs[shard] = dict(attrs)
                    if "v" in attrs:
                        pr.shard_vers[shard] = int(attrs["v"])
            k = self._pool_codec(pr.pool).k
            if pr.on_done is None and pr.shard_vers:
                # client-facing reads only decode a version-AGREED k-set
                # (the ECCommon read-consistency role, ECCommon.h:352-420):
                # a degraded read racing a partial write must not assemble
                # chunks from different versions
                vmax = max(pr.shard_vers.values())
                agreed = sum(1 for v in pr.shard_vers.values() if v == vmax)
                if agreed < k and pr.replies < pr.total_shards:
                    return
            elif (pr.want_all or len(pr.chunks) < k) \
                    and pr.replies < pr.total_shards:
                # finish as soon as enough chunks to decode are present —
                # no waiting for parity stragglers (ReadPipeline returns
                # at k); callback readers judge sufficiency themselves.
                # want_all readers (sub-chunk repairs: the MSR solve
                # consumes every helper) always wait the full fan-out.
                return
            self._pending_reads.pop(tid, None)
        self._finish_ec_read(pr)

    def _finish_ec_read(self, pr: _PendingRead) -> None:
        codec = self._pool_codec(pr.pool)
        done = pr.on_done
        if done:
            # callback readers (recovery, partial writes) judge chunk
            # sufficiency themselves — they may want fewer than k
            done(pr)
            return
        si = self._pool_stripe(pr.pool)
        epoch = self.osdmap.epoch if self.osdmap else 0
        chunks = pr.chunks
        total = self._ec_total_len(pr)
        if pr.shard_vers and chunks:
            vmax = max(pr.shard_vers.values())
            agreed = {s: c for s, c in chunks.items()
                      if pr.shard_vers.get(s) == vmax}
            if len(agreed) < codec.k and len(chunks) >= codec.k:
                # no complete version-agreed k-set: either a racing write
                # (transient — its commit completes the set) or a torn
                # stripe awaiting rollback/rebuild
                if pr.balanced:
                    # a balanced holder does not arbitrate torn state —
                    # the usual cause is simply a write in flight, and
                    # the primary serializes reads against its own
                    # pipeline.  Bounce the client there; no requery
                    # (a routine race must not trigger full peering).
                    self.perf.inc("balanced_read_bounce")
                    if pr.client:
                        if pr.pq_ctx is not None:
                            pr.pq_ctx.finish(0)
                        self.messenger.send_message(
                            pr.client,
                            MOSDOpReply(pr.client_tid, ESTALE,
                                        epoch=epoch, qphase=pr.qphase))
                    return
                # primary: kick a FULL reconciliation (lean peering
                # hides per-object versions) and have the client retry
                # rather than decode torn data
                if self.osdmap is not None:
                    seed = self.osdmap.object_to_pg(pr.pool, pr.oid)
                    self._requery_pg(PgId(pr.pool, seed), force_full=True)
                if pr.client:
                    if pr.pq_ctx is not None:
                        pr.pq_ctx.finish(0)
                    self.messenger.send_message(
                        pr.client, MOSDOpReply(pr.client_tid, EAGAIN,
                                               epoch=epoch,
                                               qphase=pr.qphase))
                return
            chunks = agreed
            # total length must come from an agreed shard, not the merged
            # last-reply-wins attrs (a stale straggler could clobber the
            # grown length and truncate the payload)
            for s in chunks:
                a = pr.shard_attrs.get(s, {})
                if "len" in a:
                    total = int(a["len"])
                    break
        if len(chunks) < codec.k:
            # no shard at all anywhere -> the object does not exist
            # (authoritative even on a balanced holder: the fan-out
            # covered the same acting set the primary would read);
            # some-but-too-few shards -> unrecoverable here — a
            # balanced holder bounces to the primary, which arbitrates
            # (recovery may be mid-flight), instead of minting EIO
            err = ENOENT if not pr.chunks else EIO
            if err == EIO and pr.balanced:
                self.perf.inc("balanced_read_bounce")
                err = ESTALE
            if pr.client:
                if pr.pq_ctx is not None:
                    pr.pq_ctx.finish(0)
                self.messenger.send_message(
                    pr.client, MOSDOpReply(pr.client_tid, err, epoch=epoch,
                                           qphase=pr.qphase))
            return
        if pr.stat_only:
            if pr.client:
                size = int(total or 0)
                if pr.pq_ctx is not None:
                    pr.pq_ctx.finish(8)
                self.messenger.send_message(
                    pr.client,
                    MOSDOpReply(pr.client_tid, 0,
                                data=size.to_bytes(8, "little"),
                                epoch=epoch, qphase=pr.qphase))
            return
        # equalize stream lengths (a straggling short shard pads; decode
        # is positional so padding is safe)
        stream_len = max(c.size for c in chunks.values())
        chunks = {s: (c if c.size == stream_len else np.concatenate(
            [c, np.zeros(stream_len - c.size, np.uint8)]))
            for s, c in chunks.items()}
        data_ids = list(range(codec.k))
        if all(i in chunks for i in data_ids):
            streams = [chunks[i] for i in data_ids]
        else:
            decoded = self._ec_decode(codec, data_ids, dict(chunks),
                                      span=pr.span)
            streams = [decoded[i] for i in data_ids]
        ro = si.ro_assemble(streams).tobytes()
        if pr.client and not pr.row_len and total and pr.shard_vers \
                and self.osdmap is not None:
            # hot-read tier: second hit on a whole-object client read
            # promotes the k data streams into the extent cache (and
            # lazily the device arena) at the agreed version
            seed = self.osdmap.object_to_pg(pr.pool, pr.oid)
            tpg = PgId(pr.pool, seed)
            if self._tier_admit_ok(tpg, pr.oid):
                self._tier_admit(pr, tpg, streams,
                                 max(pr.shard_vers.values()),
                                 int(total))
        if pr.row_len:
            # range read: ro covers [row_base, row_base + len(ro))
            limit = len(ro) if total is None \
                else max(0, min(len(ro), total - pr.row_base))
            avail = ro[:limit]
            start = pr.offset - pr.row_base
            payload = avail[start:start + pr.length] if pr.length \
                else avail[start:]
        else:
            payload = ro[:total] if total is not None else ro
            if pr.length:
                payload = payload[pr.offset:pr.offset + pr.length]
            elif pr.offset:
                payload = payload[pr.offset:]
        if pr.client:
            if pr.balanced:
                self.perf.inc("balanced_read_serve")
            lease = 0.0
            if self.osdmap is not None:
                seed = self.osdmap.object_to_pg(pr.pool, pr.oid)
                lease = self._lease_maybe_grant(
                    PgId(pr.pool, seed), pr.oid, pr.client,
                    whole=not pr.offset and not pr.length)
            if pr.pq_ctx is not None:
                pr.pq_ctx.finish(len(payload))
            self.messenger.send_message(
                pr.client,
                MOSDOpReply(pr.client_tid, 0, data=payload, epoch=epoch,
                            qphase=pr.qphase, lease=lease))

    def _ec_total_len(self, pr: _PendingRead) -> int | None:
        if "len" in pr.attrs:
            return int(pr.attrs["len"])
        if self.osdmap is None:
            return None
        seed = self.osdmap.object_to_pg(pr.pool, pr.oid)
        return self._ec_object_len(PgId(pr.pool, seed), pr.oid)

    def _ec_remove(self, conn, m: MOSDOp, pgid: PgId, up: list,
                   lock_key: tuple | None = None) -> None:
        # a head with clones (or a snapc staging one) must leave its
        # SnapSet behind: per-shard whiteout, not removal (snapdir role)
        _ign, rider = self._snap_prepare(pgid, m)
        ss = self._ec_load_ss(pgid, m.oid)
        whiteout = bool((ss or {}).get("clones")) or (
            rider is not None and rider.get("clone", -1) >= 0)
        version = self._next_version(pgid)
        if not whiteout:
            self._record_tombstone(pgid, m.oid, version)
        tid = next(self._tids)
        remote = sum(1 for o in up
                     if o is not None and o != self.osd_id)
        if remote:  # registered before any send (sharded dispatch);
            # +1 ack for the primary's own store commit
            pw = _PendingWrite(m.client, m.tid, remote + 1, version,
                               lock_key=lock_key, members=tuple(up))
            pw.span = getattr(m, '_span', None)
            pw.qphase = getattr(m, '_qos_phase', 0)
            pw.pq_ctx = getattr(m, '_pq_ctx', None)
            self._pending_writes[tid] = pw
        sub_attrs = {"_snap": rider} if rider is not None else {}
        for shard, osd in enumerate(up):
            if osd is None:
                continue
            if osd == self.osd_id:
                if whiteout:
                    pre = (self._snap_apply_rider(pgid, m.oid, rider,
                                                  shard=shard)
                           if rider is not None else None)
                    self._apply_whiteout(pgid, m.oid, version,
                                         pre_tx=pre, shard=shard)
                else:
                    self._apply_remove(pgid, m.oid, shard, version)
            else:
                self.messenger.send_message(
                    f"osd.{osd}",
                    MSubWrite(tid, pgid, m.oid, shard, version,
                              "whiteout" if whiteout else "remove",
                              attrs=dict(sub_attrs),
                              epoch=self._entry_epoch(),
                              trace=self._tctx(m), tenant=m.tenant))
        if remote == 0:
            def _finish_local() -> None:
                conn.send(MOSDOpReply(m.tid, 0, version=version,
                                      epoch=self.osdmap.epoch))
                self._obj_unlock(lock_key)
            self._on_store_commit(pgid, _finish_local)
        else:
            self._local_commit_ack(tid, pgid)

    # -- inline compression (osd/compression.py) ---------------------------
    def _compression_policy(self, pool: int):
        """The pool's resolved at-rest compression policy (None = store
        raw).  Cached per (pool, map epoch); a malformed profile on a
        live map degrades to raw rather than failing every write."""
        pm = getattr(self, "_comp_policies", None)
        if pm is None:
            pm = self._comp_policies = {}
        epoch = self.osdmap.epoch if self.osdmap is not None else 0
        hit = pm.get(pool)
        if hit is not None and hit[0] == epoch:
            return hit[1]
        pol = None
        try:
            spec = self.osdmap.pools.get(pool) if self.osdmap else None
            if spec is not None:
                pol = compression.CompressionPolicy.from_pool(
                    spec, self.cfg)
        except Exception as e:  # noqa: BLE001 - bad profile: store raw
            dout("osd", 1)("%s: pool %d compression profile invalid "
                           "(%r); storing raw", self.name, pool, e)
        pm[pool] = (epoch, pol)
        return pol

    def _inflate(self, data: bytes, attrs: dict) -> bytes:
        """Raw bytes of one stored blob (identity when uncompressed)."""
        if "cz" not in attrs:
            return data
        return compression.decompress(data, attrs["cz"],
                                      int(attrs["crl"]), perf=self.perf)

    def _read_obj_raw(self, cid, obj) -> tuple[bytes, dict]:
        """(raw bytes, stored attrs) of one object — the helper every
        read seam that needs RAW content goes through (wire payloads,
        extent arithmetic, cls/op contexts).  Attrs are returned as
        stored: callers shipping them strip cz/crl via _push_attrs."""
        attrs = dict(self.store.getattrs(cid, obj))
        data = self.store.read(cid, obj).to_bytes()
        return self._inflate(data, attrs), attrs

    def _obj_raw_size(self, cid, obj) -> int:
        """Logical (raw) size of a stored object: the recorded raw
        length when compressed, else the store's stat size."""
        try:
            attrs = self.store.getattrs(cid, obj)
        except NoSuchObject:
            attrs = {}
        if "cz" in attrs:
            return int(attrs["crl"])
        return self.store.stat(cid, obj)["size"]

    def _inflate_in_place(self, cid, obj, attrs: dict) -> dict:
        """Rewrite a compressed stored object RAW (same version) so the
        extent paths — partial writes, parity delta folds, rollback
        pre-images — operate in raw space.  Every replica/shard runs
        the same inflate on the same op, so stores stay byte-identical.
        Returns the refreshed attrs."""
        if "cz" not in attrs:
            return attrs
        raw = self._inflate(self.store.read(cid, obj).to_bytes(), attrs)
        attrs = dict(attrs)
        attrs.pop("cz")
        attrs.pop("crl", None)
        attrs["d"] = native_crc32c(raw)
        tx = Transaction()
        tx.truncate(cid, obj, 0)
        tx.write(cid, obj, 0, raw)
        tx.rmattr(cid, obj, "cz")
        tx.rmattr(cid, obj, "crl")
        tx.setattrs(cid, obj, {"d": attrs["d"]})
        self.store.queue_transaction(tx)
        return attrs

    # -- sub-op handling (shard/replica side) ------------------------------
    def _apply_write(self, pgid: PgId, oid: str, shard: int, data: bytes,
                     attrs: dict, omap: dict | None = None,
                     pre_tx: Transaction | None = None) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        obj = to_oid(oid, shard)
        oid = vname_of(obj)  # canonical: log/tombstones use the vname
        # stored digest for deep scrub (per-blob csum, BlueStore role);
        # a device-computed csum from the fused encode pass arrives as
        # "dcsum" and skips the CPU re-sweep (scrub still re-verifies)
        dc = attrs.get("dcsum")
        # inline compression: whole-shard replace is the store's ingest
        # boundary, and the decision is a pure function of (pool
        # policy, raw bytes) — every holder of these bytes lands the
        # SAME stored form regardless of how they arrived (client op,
        # recovery push, scrub repair), which replica digest compare
        # relies on.  The wire always carries raw bytes.
        comp = None
        if data:
            pol = self._compression_policy(pgid.pool)
            if pol is not None and pol.mode == "aggressive":
                comp = pol.maybe_compress(data, perf=self.perf)
        if comp is not None:
            data, cattrs = comp
            # the stored digest covers the STORED bytes (scrub never
            # inflates); the fused-graph dcsum covered the raw bytes,
            # so it cannot stand in here
            attrs = dict(attrs, d=native_crc32c(data), **cattrs)
        else:
            attrs = dict(attrs, d=int(dc) if dc is not None
                         else native_crc32c(data))
        attrs.pop("dcsum", None)
        # entry epoch: a recovery push carries the authority's stamp in
        # "ev" (it must survive verbatim or the re-pushed entry forks
        # again); otherwise the minting/sub-op epoch
        ev = int(attrs.get("ev", 0)) or self._entry_epoch()
        attrs["ev"] = ev
        tx = Transaction()
        if cid not in self.store.list_collections():
            tx.create_collection(cid)
        if pre_tx is not None:
            tx.append(pre_tx)
        tx.touch(cid, obj)
        tx.truncate(cid, obj, 0)
        tx.write(cid, obj, 0, data)
        if "cz" not in attrs:
            # a raw overwrite of a previously-compressed object must
            # not leave stale extent metadata behind (setattrs merges)
            tx.rmattr(cid, obj, "cz")
            tx.rmattr(cid, obj, "crl")
        tx.setattrs(cid, obj, {k: v for k, v in attrs.items()})
        if omap is not None:
            # recovery pushes carry the object's omap: REPLACE ours
            try:
                old_keys = list(self.store.omap_get(cid, obj))
            except NoSuchObject:
                old_keys = []
            if old_keys:
                tx.omap_rmkeys(cid, obj, old_keys)
            if omap:
                tx.omap_setkeys(cid, obj, {str(k): bytes(v)
                                           for k, v in omap.items()})
        if "v" in attrs:
            try:
                old = self.store.getattrs(cid, obj)
            except NoSuchObject:
                old = {}
            # whole-object replace: no pre-image stash (rollback of a
            # full write = drop the shard object and rebuild from peers)
            self._log_apply(tx, pgid, LogEntry(
                int(attrs["v"]), "write", oid, shard,
                prev_version=int(old.get("v", -1)),
                old_len=int(old.get("len", -1)), epoch=ev))
        self.store.queue_transaction(tx)

    def _handle_sub_write(self, conn, m: MSubWrite) -> None:
        self.perf.inc("subop_w")
        if m.shard in self.inject.drop_shard_writes:
            # armed write-drop (ECInject write_error role): ack without
            # applying — a lost apply that scrub must later catch
            conn.send(MSubWriteReply(m.tid, m.pgid, m.shard, self.osd_id))
            return
        self._sub_epoch.v = m.epoch
        # omap mutations leave the object's DATA bytes unchanged: no
        # lease revoke, no extent-cache invalidation, no read fence
        mutates = not m.op.startswith("omap")
        if mutates:
            self._subw_begin(m.pgid, m.oid)
        try:
            if m.trace:
                # per-sub-op child span + the store-commit grandchild
                # (the ZTracer spans through EC sub-ops,
                # ECCommon.cc:1046-1051; the tree a collector merges:
                # client-op -> osd-op -> sub-write -> store-commit)
                with self.tracer.start(f"sub-write {m.op}",
                                       parent=m.trace,
                                       shard=m.shard,
                                       oid=m.oid) as sp:
                    with self.tracer.start("store-commit",
                                           parent=sp.ctx):
                        self._do_sub_write(conn, m)
            else:
                self._do_sub_write(conn, m)
        finally:
            self._sub_epoch.v = 0
            if mutates:
                self._subw_end(m.pgid, m.oid)

    def _do_sub_write(self, conn, m: MSubWrite) -> None:
        attrs = dict(m.attrs)
        rider = attrs.pop("_snap", None)
        pre_tx = (self._snap_apply_rider(m.pgid, m.oid, rider,
                                         shard=m.shard)
                  if rider is not None else None)
        if m.op == "write":
            self._apply_write(m.pgid, m.oid, m.shard, m.data,
                              dict(attrs, v=m.version), pre_tx=pre_tx)
        elif m.op == "write_partial":
            code = self._apply_partial(m.pgid, m.oid, m.shard,
                                       [(m.offset, m.data)], m.version,
                                       pre_tx=pre_tx, extra_attrs=attrs)
            if code != 0:
                # replica lacks the object (recovery lag): refuse rather
                # than fabricate a zero-prefixed copy at the new version
                conn.send(MSubWriteReply(m.tid, m.pgid, m.shard,
                                         self.osd_id, code))
                return
        elif m.op == "whiteout":
            self._apply_whiteout(m.pgid, m.oid, m.version, pre_tx=pre_tx,
                                 shard=m.shard)
        elif m.op == "snap_rollback":
            from ..msg.wire import unpack_value
            p = unpack_value(m.data)
            r = p.get("rider")
            rb_pre = (self._snap_apply_rider(m.pgid, m.oid, r,
                                             shard=m.shard)
                      if r else None)
            self._apply_snap_rollback(m.pgid, m.oid, int(p["cloneid"]),
                                      bytes(p["ss"]), m.version,
                                      pre_tx=rb_pre, shard=m.shard,
                                      total_len=int(p.get("total", -1)))
        elif m.op == "trim_clone":
            from ..msg.wire import unpack_value
            p = unpack_value(m.data)
            self._apply_trim(m.pgid, m.oid, int(p["snapid"]),
                             bytes(p["ss"]), bool(p["drop_head"]),
                             m.version, shard=m.shard)
        elif m.op == "remove":
            self._apply_remove(m.pgid, m.oid, m.shard, m.version)
        elif m.op in ("omap_set", "omap_rm"):
            from ..msg.wire import unpack_value
            self._apply_omap(m.pgid, m.oid, m.op, unpack_value(m.data),
                             m.version, create_ok=True, shard=m.shard)
        elif m.op == "cls_effects":
            from ..msg.wire import unpack_value
            self._apply_cls_effects(m.pgid, m.oid, unpack_value(m.data),
                                    m.version, shard=m.shard)
        elif m.op == "multi_effects":
            from ..msg.wire import unpack_value
            self._apply_multi_effects(m.pgid, m.oid,
                                      unpack_value(m.data), m.version,
                                      pre_tx=pre_tx, shard=m.shard)
        self._pg_versions[m.pgid] = max(
            self._pg_versions.get(m.pgid, 0), m.version)
        # the ack IS the durability promise: ride the commit pipeline's
        # finisher (in submission order) so it leaves only once the
        # apply's transactions are fsync'd — inline when sync-pinned
        self.store.commit_barrier(lambda: conn.send(
            MSubWriteReply(m.tid, m.pgid, m.shard, self.osd_id)))

    def _apply_remove(self, pgid: PgId, oid: str, shard: int,
                      version: int) -> None:
        cid = CollectionId(pgid.pool, pgid.seed)
        obj = to_oid(oid, shard)
        oid = vname_of(obj)
        tx = Transaction()
        if self.store.exists(cid, obj):
            tx.remove(cid, obj)
        self._log_apply(tx, pgid, LogEntry(version, "remove", oid, shard,
                                           prev_version=-1))
        self.store.queue_transaction(tx)
        self._ec_cache.invalidate(pgid, oid)
        self._record_tombstone(pgid, oid, version)

    def _on_store_commit(self, pgid: PgId, fn) -> None:
        """Run ``fn`` once everything queued in the store SO FAR is
        durable, ON pgid's scheduler shard — the finisher thread must
        never execute PG-state work itself (per-PG serialization is a
        shard-thread invariant).  Inline in sync mode: nothing is
        pending and the caller already holds the shard."""
        if not self._store_async:
            fn()
            return

        def fire() -> None:
            # force past the lossy QUEUE_CAP: a dropped completion has
            # no retry path — the reply would never leave and the
            # object lock would wedge forever
            self.scheduler.enqueue(
                "system", (lambda _c, _m: fn(), None, None),
                key=(pgid.pool, pgid.seed), force=True)
        self.store.commit_barrier(fire)

    def _local_commit_ack(self, tid: int, pgid: PgId) -> None:
        """Count the primary's OWN store commit as one ack on a pending
        write: registered as a commit barrier AFTER the local applies,
        so the finisher fires it once those transactions are durable
        (inline in sync mode — identical accounting to the pre-pipeline
        path).  The synthetic shard -2 rides the normal ack drain so
        result/fence/unlock/reply logic stays in one place."""
        self._on_store_commit(pgid, lambda: self._handle_sub_write_reply(
            None, MSubWriteReply(tid, pgid, -2, self.osd_id, 0)))

    def _handle_sub_write_reply(self, conn, m: MSubWriteReply) -> None:
        if m.result == EAGAIN:
            # a shard refused a conditional apply (it is stale): kick
            # recovery NOW — without this the shard only heals on the
            # next map epoch, and the client's retries spin meanwhile
            self._requery_pg(m.pgid)
        with self._pending_lock:
            pw = self._pending_writes.get(m.tid)
            if pw is None:
                return
            if m.result == EAGAIN:
                pw.retry += 1  # version conflict: transient, retryable
            elif m.result != 0:
                pw.failed += 1
            pw.acks_needed -= 1
            if pw.acks_needed > 0:
                return
            self._pending_writes.pop(m.tid, None)
        result = EIO if pw.failed else (EAGAIN if pw.retry else 0)
        # even a failed write may have mutated some shards (torn):
        # fence the aggregator's in-flight dup collapse either way,
        # BEFORE the client can observe the outcome
        self._note_obj_write(pw.lock_key)
        if result != 0 and pw.lock_key is not None:
            # a failed/torn write leaves cached extents untrustworthy
            self._ec_cache.invalidate(*pw.lock_key)
        if pw.span is not None:
            pw.span.tag("result", result)
            pw.span.finish()
        rdata = getattr(pw, "reply_data", b"") if result == 0 else b""
        if pw.pq_ctx is not None:
            # perf-query booking: this drain replies via the messenger,
            # so the dispatch-time conn wrapper never sees it
            pw.pq_ctx.finish(len(rdata))
        self.messenger.send_message(
            pw.client,
            MOSDOpReply(pw.client_tid, result, data=rdata,
                        version=pw.version,
                        epoch=self.osdmap.epoch if self.osdmap else 0,
                        qphase=pw.qphase))
        self._obj_unlock(pw.lock_key)

    # ----------------------------------------------------------- heartbeats
    def _heartbeat_loop(self) -> None:
        interval = self.cfg["osd_heartbeat_interval"]
        grace = self.cfg["osd_heartbeat_grace"]
        ticks = 0
        while not self._stop.wait(interval):
            now = time.time()
            self._sub_epoch.v = 0  # fresh epoch pin per hb-thread sweep
            # osd-beacon role (runs even before the FIRST map arrives):
            # map silence means the mon dropped our subscription (marked
            # us down / lost our boot during an election) or died —
            # rotate monitors, re-subscribe, and re-assert boot if the
            # map we hold doesn't show us up
            if now - self._last_map > 2 * grace:
                self._last_map = now  # debounce
                self._mon_idx += 1
                self.mon = self._mons[self._mon_idx % len(self._mons)]
                self.messenger.send_message(self.mon, MMonSubscribe())
                me = self.osdmap.osds.get(self.osd_id) \
                    if self.osdmap else None
                if me is None or not me.up:
                    net = self.messenger.network
                    self.messenger.send_message(
                        self.mon,
                        MOSDBoot(self.osd_id, self.host,
                                 net.addr_of(self.name),
                                 hb_addr=net.addr_of(
                                     self.hb_messenger.name)))
            if self.osdmap is None:
                continue
            self._sweep_pending(now)
            # flight recorder: an op that crossed the complaint time
            # while STILL IN FLIGHT journals its slow_op event (and
            # retains its trace) now — a wedged op may never finish
            try:
                self.op_tracker.note_inflight_slow()
            except Exception as e:  # noqa: BLE001 - never kill the thread
                dout("osd", 1)("%s: slow-op sweep failed: %r",
                               self.name, e)
            # metrics history: periodic snapshot of this daemon's perf
            # registries into the fixed-budget ring (shipped with the
            # stats reports, merged mon-side)
            m_int = self.cfg["metrics_history_interval_s"]
            if m_int > 0 and now - self._metrics_sampled_at >= m_int:
                self._metrics_sampled_at = now
                try:
                    self.metrics_history.sample(
                        self._metrics_registries(), ts=now)
                except Exception as e:  # noqa: BLE001
                    dout("osd", 1)("%s: metrics sample failed: %r",
                                   self.name, e)
            ticks += 1
            # active pg_temp overrides I lead: keep peering rounds
            # turning until the real primary verifies in sync and the
            # override clears (nothing else re-queries once the
            # recovery pushes have landed)
            for (pool, seed) in list(self.osdmap.pg_temp):
                spec = self.osdmap.pools.get(pool)
                if spec is None or spec.kind == "ec":
                    continue
                up_t = self.osdmap.pg_to_up_osds(pool, seed)
                if self._primary_of(up_t) == self.osd_id:
                    self._requery_pg(PgId(pool, seed))
            for peer in self.osdmap.up_osds():
                if peer == self.osd_id:
                    continue
                self.hb_messenger.send_message(
                    f"osd.{peer}.hb",
                    MOSDPing(self.osd_id, self.osdmap.epoch, now))
                # seed the clock at first observation so a peer that never
                # answers a single ping still gets reported
                last = self._hb_last.setdefault(peer, now)
                if now - last > grace:
                    self.perf.inc("failure_reports")
                    self.messenger.send_message(
                        self.mon,
                        MFailureReport(peer, self.osd_id,
                                       self.osdmap.epoch, now - last))
            # stats AFTER pings (the walk must never delay liveness), every
            # 5th tick, time-budgeted, and never allowed to kill the thread
            if ticks % 5 == 0:
                try:
                    self._report_stats(budget=max(grace / 4, 0.05))
                except Exception as e:  # noqa: BLE001
                    dout("osd", 1)("%s: stats report failed: %r",
                                   self.name, e)
            # background deep scrub: arm due PGs (chunks run on the
            # shard threads under the scrub mclock class, not here)
            try:
                self._scrub_tick(now)
            except Exception as e:  # noqa: BLE001
                dout("osd", 1)("%s: scrub tick failed: %r",
                               self.name, e)

    def _sweep_pending(self, now: float, max_age: float | None = None) -> None:
        """Fail ops whose sub-ops never completed (peer died mid-op) so
        clients get an error instead of a timeout and tables don't leak."""
        if max_age is None:
            max_age = self.cfg["osd_op_timeout"]
        self._reset_ops_on_down(self.osdmap)
        epoch = self.osdmap.epoch if self.osdmap else 0
        expired_w, expired_r = [], []
        with self._pending_lock:
            for tid, pw in list(self._pending_writes.items()):
                if now - pw.stamp > max_age:
                    self._pending_writes.pop(tid, None)
                    expired_w.append(pw)
            for tid, pr in list(self._pending_reads.items()):
                if now - pr.stamp > max_age:
                    self._pending_reads.pop(tid, None)
                    expired_r.append(pr)
        if expired_w or expired_r:
            self.perf.inc("op_timeouts", len(expired_w) + len(expired_r))
        for pw in expired_w:
            self.timed_out_ops.append({
                "at": now, "op": "write", "client": pw.client,
                "object": repr(pw.lock_key), "acks_missing": pw.acks_needed,
                "members": list(pw.members)})
        for pr in expired_r:
            self.timed_out_ops.append({
                "at": now, "op": "recovery read" if pr.on_done else "read",
                "client": pr.client, "object": f"{pr.pool}/{pr.oid}",
                "replies": pr.replies, "of": pr.total_shards,
                "chunks": sorted(pr.chunks),
                "versions": sorted(set(pr.shard_vers.values()))})
        self._fail_writes(expired_w, EIO, epoch)
        for pr in expired_r:
            self._finish_ec_read(pr)  # decodes if >= k arrived, else err
        self._read_agg.sweep(now, max_age)
        self._sweep_notifies(now, max_age)
        self._sweep_leases(now)
        self._sweep_reservations(now)

    # --------------------------------------- flight recorder / telemetry
    def _note_slow_op(self, op) -> None:
        """OpTracker on_slow hook (fires once per op, off the tracker
        lock): journal the SLOW_OPS complaint as a slow_op cluster
        event.  The op's trace — head-sampled or retroactively
        promoted from the unsampled ring — is already retained by the
        tracker, so the event's trace_id resolves via
        dump_historic_slow_ops / dump_tracing."""
        dur = round(op.age(), 3)
        fields = {"desc": op.desc, "dur_s": dur, "done": bool(op.done)}
        if op.span is not None:
            fields["trace_id"] = op.span.trace_id
            fields["trace_sampled"] = bool(op.span.sampled)
        self.events.emit(
            "slow_op",
            f"slow op: {op.desc} blocked {dur:.3f}s (complaint time "
            f"{self.cfg['osd_op_complaint_time']}s)",
            severity="warn", **fields)

    def _collect_traces(self, trace_ids: set) -> dict:
        """Merged spans per trace id: this daemon's rings plus ONE
        full-ring fetch per peer admin socket in asok_dir (the PR-7
        shared resolver's directory) filtered against the whole id
        set — the round-trip count is O(peers), independent of how
        many slow ops are being resolved.  Deduped by span_id,
        start-ordered per trace."""
        by_tid: dict = {int(t): {} for t in trace_ids}

        def take(spans) -> None:
            for s in spans:
                if not isinstance(s, dict):
                    continue
                m = by_tid.get(s.get("trace_id"))
                if m is not None:
                    m.setdefault(s.get("span_id"), s)

        for tid in by_tid:
            take(self.tracer.spans_for(tid))
        if self.asok_dir and by_tid:
            import glob as _glob
            import os

            from ..utils.admin_socket import admin_request
            for path in sorted(_glob.glob(
                    os.path.join(self.asok_dir, "*.asok"))):
                if os.path.basename(path) == f"{self.name}.asok":
                    continue  # our rings were read directly above
                try:
                    spans = admin_request(path, "dump_tracing")
                except (OSError, RuntimeError):
                    continue  # mon sockets / dead daemons: keep going
                if isinstance(spans, list):
                    take(spans)
        return {tid: sorted(m.values(), key=lambda s: s["start"])
                for tid, m in by_tid.items()}

    def _metrics_registries(self) -> dict:
        """The registries this daemon's metrics history snapshots: its
        own perf counters (op/EC-batch/QoS/trace schema) and its data
        messenger's (dispatch latency, drops)."""
        return {self.name: self.perf,
                self.messenger.perf.name: self.messenger.perf}

    def _report_stats(self, budget: float = 0.5) -> None:
        """Usage/perf summary to the monitor (MMgrReport/PGStats role).
        The store walk is time-budgeted; a partial walk reports what it
        covered with partial=True rather than stalling heartbeats."""
        objects = nbytes = pgs = 0
        pool_objects: dict[int, int] = {}  # autoscaler input (per pool)
        partial = False
        t0 = time.monotonic()
        for cid in self.store.list_collections():
            pgs += 1
            for oid in self.store.list_objects(cid):
                try:
                    nbytes += self.store.stat(cid, oid)["size"]
                    objects += 1
                    if oid.shard > -2:  # user data, not PG meta
                        pool_objects[cid.pool] = \
                            pool_objects.get(cid.pool, 0) + 1
                except Exception:  # noqa: BLE001 - deleted under our feet
                    continue
            if time.monotonic() - t0 > budget:
                partial = True
                break
        # SLOW_OPS feed (the dump_historic_slow_ops -> health mux path):
        # currently-blocked slow ops drive the mon's HEALTH_WARN (they
        # clear when the ops finish); the cumulative count and the worst
        # offenders ride along for the per-daemon health detail
        slow = self.op_tracker.slow_summary()
        # messenger summary (monotonic counters only: queue depth moves
        # both ways and the mon's cluster_* aggregation types counters)
        mperf = self.messenger.perf
        # ship the pending journal WINDOW, not a drained batch: a
        # partition/lossy wire drops reports SILENTLY (deliver()=True),
        # so events re-ship with every report until they age out and
        # the mon dedupes by per-daemon lseq — at-least-once across
        # any outage shorter than osd_event_resend_s
        events = self.events.pending()
        self.messenger.send_message(
            self.mon,
            MStatsReport(self.osd_id,
                         self.osdmap.epoch if self.osdmap else 0,
                         {"pgs": pgs, "objects": objects, "bytes": nbytes,
                          "pool_objects": pool_objects,
                          "partial": partial,
                          # daemon wall clock at send: the mon's skew
                          # estimate (receive_time - sent_at, one-way)
                          # feeds the daemon_clock_skew_s gauge and
                          # trace_tool's waterfall normalization
                          "sent_at": time.time(),
                          "op_w": self.perf.get("op_w"),
                          "op_r": self.perf.get("op_r"),
                          "recovery_push": self.perf.get("recovery_push"),
                          "scrub_errors": self.perf.get("scrub_errors"),
                          "slow_ops": slow["inflight"],
                          "slow_ops_total": slow["total"],
                          "slow_ops_worst": slow["worst"],
                          "msg_dispatched": mperf.get("msg_dispatched"),
                          "msg_drop_wire": mperf.get("msg_drop_wire"),
                          "msg_drop_backpressure":
                              mperf.get("msg_drop_backpressure"),
                          # journal entries ride along (the LogClient
                          # piggyback); the mon merges + dedupes them
                          # into the cluster log
                          "events": events,
                          # metrics-history increments ride the same
                          # at-least-once window (seq-deduped mon-side)
                          "metrics": self.metrics_history.pending(
                              self.cfg["osd_event_resend_s"]),
                          # dynamic perf-query partials: cumulative
                          # seq-tagged snapshots, re-shipped whole
                          # every report (newest-seq-wins mon-side);
                          # key absent entirely when no query is active
                          **({"perf_queries": pq_snap}
                             if (pq_snap :=
                                 self.perf_queries.snapshot())
                             else {})}))
        self.events.prune(self.cfg["osd_event_resend_s"])

    def _handle_ping(self, conn, m: MOSDPing) -> None:
        conn.send(MOSDPingReply(self.osd_id, m.stamp))

    def _handle_ping_reply(self, conn, m: MOSDPingReply) -> None:
        self._hb_last[m.sender] = time.time()

    # ------------------------------------- recovery reservations/throttle
    # Bulk recovery data movement (pushes, shard rebuilds, migrations)
    # funnels through _recovery_op: the op waits for the PG's LOCAL
    # backfill reservation, then a REMOTE grant from its target OSD,
    # then an osd_recovery_max_active initiation slot (paced by
    # osd_recovery_sleep).  Peering/inventory traffic stays immediate —
    # client IO blocks on it (reference serves peering unthrottled).

    def _recovery_prio(self, pgid: PgId) -> int:
        # client IO blocked on missing objects = forced-recovery urgency
        return 255 if self._stale_objects.get(pgid) else 180

    def _rec_weight(self, pgid: PgId, name: str) -> int:
        """Byte weight of one recovery op on `name` (the ROADMAP
        backfill-vs-recovery split): progress items weight by object
        BYTES rather than op count, so ETAs stay accurate when object
        sizes are skewed (one 4 MiB object vs a thousand 4 KiB ones).
        Falls back to weight 1 when no local copy knows the length."""
        cid = CollectionId(pgid.pool, pgid.seed)
        try:  # replicated: the object IS the data
            return max(1, int(self.store.stat(cid,
                                              to_oid(name))["size"]))
        except (NoSuchObject, StoreError):
            pass
        try:  # EC: any local shard's whole-object len attr
            n = self._ec_object_len(pgid, name)
        except Exception:  # noqa: BLE001 - weighting must never block
            n = None
        return max(1, int(n)) if n else 1

    def _recovery_op(self, pgid: PgId, target: int | None, thunk,
                     nbytes: int = 0) -> None:
        prio = self._recovery_prio(pgid)
        nbytes = max(1, int(nbytes))  # byte weight; 1 = size unknown
        storm_opened = False
        with self._pending_lock:
            self._recovery_pg_ops[pgid] = \
                self._recovery_pg_ops.get(pgid, 0) + 1
            # recovery-storm journal accounting: ops scheduled vs done
            # since the storm opened (the progress module's feed),
            # byte-weighted alongside the raw op counts.  A storm
            # closes when the in-flight count drains to zero; a later
            # wave opens a NEW storm (its own progress item).
            rp = self._rec_progress.get(pgid)
            if rp is None:
                rp = self._rec_progress[pgid] = {
                    "total": 0, "done": 0, "total_b": 0, "done_b": 0,
                    "emitted": 0.0, "start_ts": time.time()}
                storm_opened = True
                # recovery storms are ROOT ops for the head sampler:
                # one draw per storm, finished at recovery_done.  The
                # draw + store happen INSIDE the lock that opened the
                # storm — storing after release races a storm that
                # drains to zero on another thread first, orphaning
                # the span (a sampled orphan would sit in the live
                # table until evicted with a FALSE leaked tag).  The
                # tracer lock is a leaf; holding _pending_lock over
                # it cannot deadlock.
                rspan = self.tracer.sample_root(
                    "recovery-storm", pg=self._pgstr(pgid))
                if rspan is not None:
                    self._rec_spans[pgid] = rspan
            rp["total"] += 1
            rp["total_b"] += nbytes
            self._local_waiting.setdefault(pgid, []).append(
                lambda: self._remote_gate(pgid, target, prio, thunk,
                                          nbytes))
        if storm_opened:
            self.events.emit(
                "recovery", f"pg {self._pgstr(pgid)} recovery start",
                event="recovery_start", pg=self._pgstr(pgid),
                done=0, total=rp["total_b"], done_ops=0,
                total_ops=rp["total"], start_ts=rp["start_ts"])
        self._local_reserver.request(
            pgid, prio, lambda: self._flush_local_waiting(pgid))
        if self._local_reserver.held(pgid):
            # request() was a no-op (already held): drain ourselves
            self._flush_local_waiting(pgid)

    def _flush_local_waiting(self, pgid: PgId) -> None:
        with self._pending_lock:
            thunks = self._local_waiting.pop(pgid, [])
        for t in thunks:
            t()

    def _remote_gate(self, pgid: PgId, target: int | None, prio: int,
                     thunk, nbytes: int = 0) -> None:
        if target is None or target == self.osd_id:
            self._recovery_enqueue(pgid, thunk, nbytes)
            return
        key = (pgid, target)
        with self._pending_lock:
            if key in self._remote_held:
                held, first = True, False
            else:
                held = False
                w = self._remote_waiting.setdefault(key, [])
                w.append((thunk, nbytes))
                first = len(w) == 1
                if first:
                    self._remote_pending_at[key] = time.time()
        if held:
            self._recovery_enqueue(pgid, thunk, nbytes)
        elif first:
            self.messenger.send_message(
                f"osd.{target}",
                MRecoveryReserve(pgid, self.osd_id, "request", prio))

    def _handle_recovery_reserve(self, conn, m: MRecoveryReserve) -> None:
        key = (m.pgid, m.from_osd)
        if m.action == "request":
            self._remote_reserver.request(
                key, m.priority,
                lambda: self.messenger.send_message(
                    f"osd.{m.from_osd}",
                    MRecoveryReserve(m.pgid, self.osd_id, "grant")))
        elif m.action == "grant":
            with self._pending_lock:
                self._remote_pending_at.pop(key, None)
                thunks = self._remote_waiting.pop(key, [])
                # a grant landing after a fail-open timeout drained this
                # PG's ops must hand the slot straight back, not leak it
                stale = (not thunks
                         and m.pgid not in self._recovery_pg_ops)
                if not stale:
                    self._remote_held.add(key)
            if stale:
                self.messenger.send_message(
                    f"osd.{m.from_osd}",
                    MRecoveryReserve(m.pgid, self.osd_id, "release"))
                return
            self.events.emit(
                "recovery",
                f"pg {self._pgstr(m.pgid)} remote reservation granted "
                f"by osd.{m.from_osd}",
                event="reservation_grant", pg=self._pgstr(m.pgid),
                target=m.from_osd, waiting_ops=len(thunks))
            for t, nb in thunks:
                self._recovery_enqueue(m.pgid, t, nb)
        elif m.action == "release":
            self._remote_reserver.release(key)

    def _recovery_enqueue(self, pgid: PgId, thunk,
                          nbytes: int = 0) -> None:
        with self._pending_lock:
            self._recovery_q.append((pgid, thunk, nbytes))
        self._pump_recovery()

    def _pump_recovery(self) -> None:
        sleep = self.cfg["osd_recovery_sleep"]
        while True:
            with self._pending_lock:
                if (self._recovery_inflight
                        >= self.cfg["osd_recovery_max_active"]
                        or not self._recovery_q):
                    return
                self._recovery_inflight += 1
                pgid, thunk, nbytes = self._recovery_q.popleft()
            self._sub_epoch.v = 0  # fresh epoch pin per recovery op
            try:
                thunk()
            except Exception:  # noqa: BLE001 - one op must not wedge the pump
                dout("osd", 0)("%s: recovery op failed for %s",
                               self.name, pgid)
            finally:
                with self._pending_lock:
                    self._recovery_inflight -= 1
                self._recovery_op_done(pgid, nbytes)
            if sleep > 0:
                t = threading.Timer(sleep, self._pump_recovery)
                t.daemon = True
                t.start()
                return

    def _recovery_op_done(self, pgid: PgId, nbytes: int = 0) -> None:
        release_local = False
        targets: list[tuple] = []
        ev = None
        rspan = None
        now = time.time()
        with self._pending_lock:
            n = self._recovery_pg_ops.get(pgid, 1) - 1
            rp = self._rec_progress.get(pgid)
            if rp is not None:
                rp["done"] += 1
                rp["done_b"] += max(1, int(nbytes))
            if n <= 0:
                rspan = self._rec_spans.pop(pgid, None)
                self._recovery_pg_ops.pop(pgid, None)
                release_local = True
                targets = [k for k in self._remote_held if k[0] == pgid]
                for k in targets:
                    self._remote_held.discard(k)
                if rp is not None:
                    self._rec_progress.pop(pgid, None)
                    ev = ("recovery_done", dict(rp))
            else:
                self._recovery_pg_ops[pgid] = n
                if rp is not None and now - rp["emitted"] >= \
                        self.cfg["osd_recovery_progress_interval"]:
                    rp["emitted"] = now
                    ev = ("recovery_progress", dict(rp))
        if ev is not None:
            kind, rp = ev
            # done/total ride BYTE-weighted (the progress tracker's
            # percent/ETA feed); the raw op counts stay alongside
            self.events.emit(
                "recovery",
                f"pg {self._pgstr(pgid)} "
                f"{'recovery done' if kind == 'recovery_done' else 'recovering'}"
                f" ({rp['done']}/{rp['total']} ops, "
                f"{rp['done_b']}/{rp['total_b']} weighted bytes)",
                event=kind, pg=self._pgstr(pgid), done=rp["done_b"],
                total=rp["total_b"],
                remaining=rp["total_b"] - rp["done_b"],
                done_ops=rp["done"], total_ops=rp["total"],
                start_ts=rp["start_ts"])
        if rspan is not None:
            if ev is not None and ev[0] == "recovery_done":
                rspan.tag("done_ops", ev[1]["done"])
                rspan.tag("done_bytes", ev[1]["done_b"])
            rspan.finish()
        if release_local:
            self._local_reserver.release(pgid)
            for pg, target in targets:
                self.messenger.send_message(
                    f"osd.{target}",
                    MRecoveryReserve(pg, self.osd_id, "release"))

    def _sweep_reservations(self, now: float) -> None:
        """Heartbeat-thread GC: fail open on remote grants that never
        came (target dead/partitioned — recovery must not wedge), and
        free remote slots whose requesting primary went down."""
        timeout = self.cfg["osd_recovery_reserve_timeout"]
        expired = []
        with self._pending_lock:
            for key, at in list(self._remote_pending_at.items()):
                if now - at > timeout:
                    del self._remote_pending_at[key]
                    self._remote_held.add(key)
                    expired.append((key, self._remote_waiting.pop(key, [])))
        for (pgid, _t), thunks in expired:
            for t, nb in thunks:
                self._recovery_enqueue(pgid, t, nb)
        if self.osdmap is not None:
            for key in self._remote_reserver.keys():
                _pg, requester = key
                o = self.osdmap.osds.get(requester)
                if o is None or not o.up:
                    self._remote_reserver.release(key)

    # ------------------------------------------------------ peering/recovery
    def _osd_alive(self, osd: int) -> bool:
        info = self.osdmap.osds.get(osd) if self.osdmap else None
        return info is not None and info.up

    @staticmethod
    def _pgstr(pgid: PgId) -> str:
        """Journal/operator-facing PG name (the pool.seed-hex form the
        mon's commit descriptions already use)."""
        return f"{pgid.pool}.{pgid.seed:x}"

    def _peer_query_set(self, pgid: PgId, up) -> set[int]:
        """Who a peering round must hear from: the up members PLUS
        every alive OSD that was a member of a maybe-active interval
        since the les fence (PastIntervals prior-set construction,
        PeeringState.h:1485).  An interval with NO surviving member
        contributes the -1 Down sentinel, wedging the PG until a
        revival/new map."""
        peers = {osd for osd in up
                 if osd is not None and osd != self.osd_id}
        pi, les = self._pi(pgid), self._les(pgid)
        prior = pi.prior_osds(since=les, exclude=self.osd_id)
        peers |= {o for o in prior if self._osd_alive(o)}
        for itv in pi.intervals:
            if itv.last < les or not itv.maybe_went_active():
                continue
            members = {o for o in itv.up if o is not None}
            if self.osd_id in members:
                continue  # I was there: I hold that history myself
            if members and not any(self._osd_alive(o)
                                   for o in members):
                dout("osd", 1)("%s: %s down — interval [%d,%d] has "
                               "no surviving member", self.name,
                               pgid, itv.first, itv.last)
                peers.add(-1)
        return peers

    def _start_recovery(self) -> None:
        """Primary-side: inventory peers for my PGs (recovery-lite).  PGs
        wait in 'peering' (IO blocked with EAGAIN) until every alive up
        member has answered, so a freshly-promoted primary cannot serve
        stale data (the GetInfo/GetMissing phase of the peering FSM).

        The query set is the up members PLUS every alive OSD that was a
        member of a maybe-active interval since the last peering fence
        (PastIntervals prior-set construction, PeeringState.h:1485): a
        re-promoted primary must hear from holders that took writes
        while it was away.  An interval with NO surviving member blocks
        the PG entirely (the reference's Down state) until one revives
        or the membership changes."""
        with self._pending_lock:
            # rebuilds planned on the old map: the new rounds plan anew
            self._rebuilds_out.clear()
        for pool_id, seed, up in self._pools_pgs_for_me():
            if self._primary_of(up) != self.osd_id:
                pg = PgId(pool_id, seed)
                self._peering.pop(pg, None)
                self._fence_round.pop(pg, None)
                self._peer_invs.pop(pg, None)
                self._peer_lcs.pop(pg, None)
                self._round_closed_at.pop(pg, None)
                continue
            pgid = PgId(pool_id, seed)
            # fresh round: stale cached inventories/log-positions must
            # not feed rollback decisions (they could roll back writes
            # committed since they were collected) — and a stale shadow
            # fence round must not close against the NEW epoch's round
            # (its answers would fence an epoch whose prior-set queries
            # never completed)
            self._peer_invs.pop(pgid, None)
            self._peer_lcs.pop(pgid, None)
            self._round_closed_at.pop(pgid, None)
            self._fence_round.pop(pgid, None)
            self._peering_epoch[pgid] = self.osdmap.epoch
            peers = self._peer_query_set(pgid, up)
            if peers:
                self._peering[pgid] = set(peers)
                self.events.emit(
                    "pg", f"pg {self._pgstr(pgid)} peering start",
                    pg=self._pgstr(pgid), state="peering",
                    epoch=self.osdmap.epoch, peers=len(peers),
                    down=-1 in peers)
            else:
                self._peering.pop(pgid, None)
                # trivially peered (no peers to hear from): fence now
                self._set_les(pgid, self.osdmap.epoch)
            ents = self._pglog(pgid).entries()  # one decode
            last = ents[-1].version if ents else 0
            floor_v = ents[0].version if ents else 0
            for osd in peers:
                if osd < 0:
                    continue  # the Down sentinel, not a peer
                self.messenger.send_message(
                    f"osd.{osd}",
                    MPGQuery(pgid, self.osdmap.epoch,
                             primary_last=last,
                             primary_floor=floor_v,
                             force_full=pgid in self._split_fresh
                             or self._ec_positions_moved(pgid, up)))
            # also reconcile my own shard inventory immediately
            self._handle_pg_info(None, self._my_pg_info(pgid))

    def _ec_positions_moved(self, pgid: PgId, up: list) -> bool:
        """Whether an EC PG's placement moved a member of its previous
        interval to another shard position: the placement re-draws
        around a down device and can swap two survivors.  Such a
        member's log is complete, so a lean peering round finds it in
        sync and never rebuilds the shard of its new position; the round
        must compare full inventories."""
        pool = self.osdmap.pools.get(pgid.pool)
        pi = self._pi(pgid)
        if pool is None or pool.kind != "ec" or not pi.intervals:
            return False
        prev = pi.intervals[-1].up
        return any(osd is not None and osd in prev and prev.index(osd) != i
                   for i, osd in enumerate(up))

    def _my_pg_info(self, pgid: PgId) -> MPGInfo:
        ents = self._pglog(pgid).entries()  # one decode for head + evs
        return MPGInfo(pgid, self.osd_id, -2, self._inventory(pgid),
                       dict(self._tombstones.get(pgid, {})),
                       last_complete=self._lc(pgid),
                       head_epoch=ents[-1].epoch if ents else 0,
                       log_evs={e.version: e.epoch for e in ents},
                       les=self._les(pgid))

    def _inventory(self, pgid: PgId) -> dict:
        cid = CollectionId(pgid.pool, pgid.seed)
        out = {}
        try:
            for oid in self.store.list_objects(cid):
                if oid.shard <= -2:
                    continue  # PG metadata (pglog/snapmapper), not user data
                attrs = self.store.getattrs(cid, oid)
                v = attrs.get("v", 0)
                # clones ride every (name, shard) subsystem as vnames
                out[(vname_of(oid), oid.shard)] = v
        except Exception:  # noqa: BLE001 - collection may not exist yet
            pass
        return out

    def _handle_pg_list(self, conn, m: MPGList) -> None:
        """List this PG's live object heads (librados pgls role).
        Primary-only, auth-gated like a read."""
        if self.osdmap is None or m.pgid.pool not in self.osdmap.pools:
            # the client's map may be AHEAD (pool just created): EAGAIN
            # retries; only a pool unknown at its own epoch is ENOENT
            my_epoch = self.osdmap.epoch if self.osdmap else 0
            err = EAGAIN if m.epoch > my_epoch else ENOENT
            conn.send(MPGListReply(m.tid, m.pgid, err, epoch=my_epoch))
            return
        up = self.osdmap.pg_to_up_osds(m.pgid.pool, m.pgid.seed)
        if self._primary_of(up) != self.osd_id:
            conn.send(MPGListReply(m.tid, m.pgid, ESTALE,
                                   epoch=self.osdmap.epoch))
            return
        if m.pgid in self._peering:
            # a freshly promoted primary's store may still be missing
            # not-yet-recovered heads: an authoritative listing must
            # wait for peering, exactly like client IO does
            conn.send(MPGListReply(m.tid, m.pgid, EAGAIN,
                                   epoch=self.osdmap.epoch))
            return
        if self.auth is not None:
            import hmac as _hmac

            from ..auth.cephx import op_proof
            vt = self.auth.verify(m.ticket)
            pool_name = self.osdmap.pools[m.pgid.pool].name
            want = (op_proof(vt.session_key, m.tid, m.pgid.pool,
                             m.pgid.seed, "pgls")
                    if vt is not None else b"")
            if vt is None or not _hmac.compare_digest(want, m.proof) \
                    or not vt.caps.allows("r", pool=pool_name):
                conn.send(MPGListReply(m.tid, m.pgid, EACCES,
                                       epoch=self.osdmap.epoch))
                return
        cid = CollectionId(m.pgid.pool, m.pgid.seed)
        dead = self._tombstones.get(m.pgid, {})
        is_ec = self._is_ec(m.pgid)
        names: set[str] = set()
        try:
            for oid in self.store.list_objects(cid):
                if oid.shard <= -2 or oid.generation >= 0:
                    continue  # PG metadata / snapshot clones
                if oid.name in names:
                    continue
                if is_ec and self._ec_whiteout(m.pgid, oid.name):
                    continue
                if oid.name in dead:
                    # deletes win unless the head was re-written SINCE
                    try:
                        v = int(self.store.getattrs(cid, oid).get("v", 0))
                    except Exception:  # noqa: BLE001
                        v = 0
                    if dead[oid.name] >= v:
                        continue
                names.add(oid.name)
        except Exception:  # noqa: BLE001 - collection vanished mid-walk
            # a partial walk must NOT masquerade as a complete listing
            conn.send(MPGListReply(m.tid, m.pgid, EAGAIN,
                                   epoch=self.osdmap.epoch))
            return
        conn.send(MPGListReply(m.tid, m.pgid, 0, sorted(names),
                               epoch=self.osdmap.epoch))

    def _handle_pg_query(self, conn, m: MPGQuery) -> None:
        if self.osdmap is not None and m.epoch > self._applied_epoch \
                and not self._stop.is_set() \
                and getattr(m, "_defers", 0) < 40:
            # The primary peers at an epoch I have not applied yet — my
            # inventory may be PRE-SPLIT (the child collection does not
            # exist until the map lands), and an empty answer would
            # close the primary's round as "peer holds nothing".  Ask
            # the mon for the map (once) and defer the answer until it
            # lands.  Bounded: after ~4s of deferral answer with what I
            # have — the primary's requery machinery reconciles later,
            # and an unreachable mon must not spin timers forever.
            if not getattr(m, "_defers", 0):
                self.messenger.send_message(
                    self.mon, MMonSubscribe("osdmap",
                                            have_epoch=self.osdmap.epoch))
            m._defers = getattr(m, "_defers", 0) + 1

            def retry(conn=conn, m=m):
                if not self._stop.is_set():
                    self._handle_pg_query(conn, m)
            t = threading.Timer(0.1, retry)
            t.daemon = True
            t.start()
            return
        with self._pg_guard(m.pgid):
            # from here on no client op admitted under an older map
            # runs in this PG (_handle_client_op): the answer below is
            # all the new primary learns of this member's writes
            if m.epoch > self._answered_epoch.get(m.pgid, 0):
                self._answered_epoch[m.pgid] = m.epoch
            self._answer_pg_query(conn, m)

    def _answer_pg_query(self, conn, m: MPGQuery) -> None:
        # ONE log decode feeds head/floor/evs (the peering hot path —
        # every query/info otherwise re-reads the whole omap window)
        ents = self._pglog(m.pgid).entries()
        lc = self._lc(m.pgid)
        last = ents[-1].version if ents else 0
        head_epoch = ents[-1].epoch if ents else 0
        # LEAN fast path (log-based GetLog): my log is gapless through lc
        # and the primary can delta-replay from there — skip the
        # O(objects) inventory walk entirely.  head_epoch rides along so
        # the primary can detect a fork at my head (same version, other
        # interval) and demand the full log.
        inv = None
        if lc == 0:
            inv = self._inventory(m.pgid)  # walked once, reused below
        if (not m.force_full and m.primary_last >= 0
                and lc == last
                and lc <= m.primary_last
                and (lc + 1 >= m.primary_floor or lc == m.primary_last)
                and (lc > 0 or not inv)):
            # (lc == 0 with a NON-empty collection excluded: a freshly
            # merged/reset PG has an empty LOG but full data — a lean
            # "in sync at v0" answer would hide every object it holds.
            # A truly empty lc==0 PG stays lean: forcing inventories
            # there made the primary schedule spurious rebuilds that
            # raced scrub repair.)
            conn.send(MPGInfo(m.pgid, self.osd_id, -2, {},
                              dict(self._tombstones.get(m.pgid, {})),
                              last_complete=lc, lean=True,
                              head_epoch=head_epoch,
                              les=self._les(m.pgid)))
            return
        if inv is None:
            inv = self._inventory(m.pgid)
        conn.send(MPGInfo(m.pgid, self.osd_id, -2, inv,
                          dict(self._tombstones.get(m.pgid, {})),
                          last_complete=lc, head_epoch=head_epoch,
                          log_evs={e.version: e.epoch for e in ents},
                          les=self._les(m.pgid)))

    def _rearm_peering(self, pgid: PgId, block: bool = True) -> None:
        """Run another peering round.  block=True (a fork surfaced —
        possibly after the round closed): the PG re-peers with IO
        re-blocked until a round completes CLEAN.  block=False (routine
        recovery completion): the les fence still needs one clean round
        of answers, but client IO keeps flowing — the answers drain a
        shadow waiting set instead of the peering gate."""
        up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
        if self._primary_of(up) != self.osd_id:
            return
        # the SAME prior-set construction as _start_recovery: a re-armed
        # round dropping the Down sentinel (or unanswered prior holders)
        # would close clean, fence, and trim the very interval evidence
        # that wedged the PG
        peers = self._peer_query_set(pgid, up)
        if not peers:
            return
        if not block and -1 in peers:
            # a Down interval outlaws the fence anyway: nothing to do
            return
        self._peering_epoch[pgid] = self.osdmap.epoch
        if block:
            self._fence_round.pop(pgid, None)
            self._peering[pgid] = set(peers)
            self.events.emit(
                "pg", f"pg {self._pgstr(pgid)} peering start (re-peer)",
                pg=self._pgstr(pgid), state="peering",
                epoch=self.osdmap.epoch, peers=len(peers), repeer=True)
        else:
            self._fence_round[pgid] = set(peers)
        # queries go out DIRECTLY: _requery_pg's debounce could swallow
        # a second rearm inside its window, leaving an armed wait set
        # nobody will ever drain (client IO wedged until the next epoch)
        ents = self._pglog(pgid).entries()
        last = ents[-1].version if ents else 0
        floor_v = ents[0].version if ents else 0
        for osd in peers:
            if osd < 0:
                continue  # the Down sentinel, not a peer
            self.messenger.send_message(
                f"osd.{osd}",
                MPGQuery(pgid, self.osdmap.epoch,
                         primary_last=last, primary_floor=floor_v,
                         force_full=block))

    def _merge_peer_log(self, pgid: PgId, m: MPGInfo) -> bool:
        """Divergent-entry merge (PGLog.h:1344 _merge_divergent_entries
        re-shaped): the same version logged under two different epochs
        is a fork — the entry from the NEWER interval is authoritative
        (the older interval's primary lost quorum before committing it,
        or the newer interval could never have re-minted the version).
        Discard the loser's tail from the fork point and let normal
        recovery re-push the authority's content.  Returns True when a
        fork was found and resolution scheduled (the caller must not
        schedule normal recovery off this info)."""
        pl = self._pglog(pgid)
        ents = pl.entries()  # one decode feeds every rule below
        my_evs = {e.version: e.epoch for e in ents}
        my_last = ents[-1].version if ents else 0
        my_les = self._les(pgid)
        if m.lean:
            # lean infos carry only the head; a fork at the peer's head
            # version is detectable, but the fork POINT needs its whole
            # log — demand a full answer and resolve on that
            if m.head_epoch <= 0 or m.last_complete <= 0:
                return False
            mine = my_evs.get(m.last_complete, 0)
            same_v_fork = mine > 0 and mine != m.head_epoch
            # a head BEYOND my log from an interval older than my fence
            # is a phantom tail (never committed) — also needs full log
            phantom_head = (m.last_complete > my_last
                            and 0 < m.head_epoch < my_les)
            # MY entries beyond the peer's head from intervals older
            # than the peer's fence are phantoms of my own — delta-
            # pushing them to the lean peer would resurrect a dead
            # interval's writes; discard them instead (resolvable
            # directly, no full log needed)
            mine_ph = sorted(v for v, e in my_evs.items()
                             if v > m.last_complete and 0 < e < m.les)
            if mine_ph:
                d = mine_ph[0]
                dout("osd", 1)("%s: %s MY phantom tail from v%d "
                               "(epoch %d < lean peer les %d): "
                               "discarding", self.name, pgid, d,
                               my_evs[d], m.les)
                self._rearm_peering(pgid)
                self._discard_divergent(pgid, self.osd_id, d - 1, m.les)
                self._handle_pg_info(None, m)
                return True
            if not same_v_fork and not phantom_head:
                return False
            dout("osd", 1)("%s: %s head fork at v%d with osd.%d "
                           "(epoch %d vs %d, les %d): demanding full "
                           "log", self.name, pgid, m.last_complete,
                           m.from_osd, m.head_epoch, mine, my_les)
            self._rearm_peering(pgid)
            self.messenger.send_message(
                f"osd.{m.from_osd}",
                MPGQuery(pgid, self.osdmap.epoch,
                         primary_last=my_last,
                         primary_floor=ents[0].version if ents else 0,
                         force_full=True))
            return True
        if not m.log_evs:
            return False
        conflicts = sorted(
            v for v, pe in m.log_evs.items()
            if pe and my_evs.get(v, 0) and my_evs[v] != pe)
        if conflicts:
            d = conflicts[0]
            if my_evs[d] > m.log_evs[d]:
                # the peer's tail is the dead interval's: it must
                # discard from the fork point; its post-rollback info
                # re-enters here and normal recovery re-pushes mine
                dout("osd", 1)("%s: %s osd.%d divergent from v%d "
                               "(epoch %d < %d): discarding its tail",
                               self.name, pgid, m.from_osd, d,
                               m.log_evs[d], my_evs[d])
                self._rearm_peering(pgid)
                self._discard_divergent(pgid, m.from_osd, d - 1,
                                        my_evs[d], m.objects)
                return True
            # I am the divergent one (re-promoted after my interval
            # died): discard my own tail, then re-process this info
            # with fresh state — peer objects I now miss get pulled
            dout("osd", 1)("%s: %s MY log divergent from v%d (epoch "
                           "%d < %d): discarding my tail", self.name,
                           pgid, d, my_evs[d], m.log_evs[d])
            self._rearm_peering(pgid)
            self._discard_divergent(pgid, self.osd_id, d - 1,
                                    m.log_evs[d],
                                    authority={m.from_osd: m.objects})
            self._handle_pg_info(None, m)
            return True
        # phantom tails (find_best_info's les-first rule): entries one
        # side holds BEYOND the other's head, stamped with an interval
        # older than the other's les fence, never committed — an
        # interval went active without them.  Adopting them would
        # resurrect writes whose absence was already served to readers.
        phantom_peer = sorted(v for v, pe in m.log_evs.items()
                              if v > my_last and 0 < pe < my_les)
        if phantom_peer and self._stale_objects.get(pgid):
            # my own log is known-incomplete (pulls outstanding): my
            # fence cannot judge anyone — wait for recovery to finish
            phantom_peer = []
        if phantom_peer:
            d = phantom_peer[0]
            dout("osd", 1)("%s: %s osd.%d phantom tail from v%d "
                           "(epoch %d < les %d): discarding", self.name,
                           pgid, m.from_osd, d, m.log_evs[d], my_les)
            self._rearm_peering(pgid)
            self._discard_divergent(pgid, m.from_osd, d - 1, my_les,
                                    m.objects)
            return True
        peer_last = max(m.log_evs) if m.log_evs else 0
        phantom_mine = sorted(v for v, e in my_evs.items()
                              if v > peer_last and 0 < e < m.les)
        if phantom_mine:
            d = phantom_mine[0]
            dout("osd", 1)("%s: %s MY phantom tail from v%d (epoch %d "
                           "< peer les %d): discarding", self.name,
                           pgid, d, my_evs[d], m.les)
            self._rearm_peering(pgid)
            self._discard_divergent(pgid, self.osd_id, d - 1, m.les,
                                    authority={m.from_osd: m.objects})
            self._handle_pg_info(None, m)
            return True
        return False

    def _discard_divergent(self, pgid: PgId, member: int, to_version: int,
                           max_epoch: int, member_inv: dict | None = None,
                           authority: dict | None = None) -> None:
        """Have ``member`` (this OSD or a peer) discard its log past
        ``to_version`` (PGLog.h:1344's divergent-entry merge).  An EC
        shard copy that the discard cannot roll back in place (no
        pre-image) is kept unless this primary directs its drop, one
        MPGRollback per object, and it directs one only where the PG
        can rebuild it (``_rebuildable_copies``).  ``authority`` adds
        the inventory of the peer whose log won, when it is not this
        OSD."""
        if member_inv is None:
            member_inv = self._inventory(pgid)
        drops = self._rebuildable_copies(pgid, member, member_inv,
                                         to_version, authority or {})
        msgs = [MPGRollback(pgid, "", -3, to_version, divergent=True,
                            max_epoch=max_epoch)]
        msgs += [MPGRollback(pgid, name, shard, to_version)
                 for name, shard in drops]
        for msg in msgs:
            if member == self.osd_id:
                self._handle_pg_rollback(None, msg)
            else:
                self.messenger.send_message(f"osd.{member}", msg)

    def _rebuildable_copies(self, pgid: PgId, member: int, member_inv: dict,
                            to_version: int, authority: dict) -> list:
        """The EC shard copies ``member`` holds past ``to_version`` that
        k other positions of the up set hold at the version the PG keeps
        (the newest of theirs), by the inventories this primary has:
        the copies a divergent discard may drop for a rebuild.  A copy
        fewer than k other positions hold is the PG's last word on its
        object, and stays.  A chosen copy leaves ``member``'s recorded
        inventory, so a later discard in the round never counts it."""
        pool = self.osdmap.pools.get(pgid.pool) if self.osdmap else None
        if pool is None or pool.kind != "ec":
            return []
        k = self._pool_codec(pgid.pool).k
        up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
        invs = dict(self._peer_invs.get(pgid, {}))
        invs[self.osd_id] = self._inventory(pgid)
        invs.update(authority)
        invs.pop(member, None)
        drops = []
        for (name, shard), v in member_inv.items():
            if shard < 0 or v <= to_version:
                continue
            held = [invs[osd][(name, pos)]
                    for pos, osd in enumerate(up)
                    if pos != shard and osd is not None and osd in invs
                    and (name, pos) in invs[osd]]
            if held and held.count(max(held)) >= k:
                drops.append((name, shard))
        recorded = self._peer_invs.get(pgid, {}).get(member, {})
        for key in drops:
            recorded.pop(key, None)
        return drops

    def _handle_pg_info(self, conn, m: MPGInfo) -> None:
        """Primary: compare a peer's state against authority and schedule
        recovery — by log replay (delta) when the peer's last-complete is
        inside our log window, by inventory compare otherwise."""
        if self.osdmap is None or m.pgid.pool not in self.osdmap.pools:
            return
        pool = self.osdmap.pools[m.pgid.pool]
        up = self.osdmap.pg_to_up_osds(m.pgid.pool, m.pgid.seed)
        if self._primary_of(up) != self.osd_id:
            return
        peer_inv = m.objects
        my_inv = self._inventory(m.pgid)
        # merge tombstone knowledge both ways (deletes must win races)
        for name, v in m.tombstones.items():
            self._record_tombstone(m.pgid, name, v)
        dead = self._tombstones.get(m.pgid, {})
        # the version counter passes every version this round heard of
        # (inventory, log head, tombstones) before the answer can close
        # the round and open the PG to writes: a primary whose counter
        # or store is fresh must not mint a version a member holds (the
        # newest entry may be a delete, which no inventory shows)
        heard = [*peer_inv.values(), m.last_complete,
                 max(m.log_evs, default=0),
                 max(m.tombstones.values(), default=0)]
        with self._pending_lock:  # _next_version's read-modify-write
            self._pg_versions[m.pgid] = max(
                self._pg_versions.get(m.pgid, 0), *heard)
        waiting = self._peering.get(m.pgid)
        done_peering = False
        if waiting is not None:
            waiting.discard(m.from_osd)
            if not waiting:
                # set before the gate opens: every version past it is
                # minted after the round's inventories were taken
                self._round_closed_at[m.pgid] = self._pg_versions.get(
                    m.pgid, 0)
                del self._peering[m.pgid]
                done_peering = True
        fence = self._fence_round.get(m.pgid)
        fence_done = False
        if fence is not None:
            fence.discard(m.from_osd)
            if not fence:
                del self._fence_round[m.pgid]
                fence_done = True  # shadow round closed clean
        if m.last_complete >= 0:
            self._peer_lcs.setdefault(m.pgid, {})[m.from_osd] = \
                m.last_complete
        if m.from_osd != self.osd_id and \
                self._merge_peer_log(m.pgid, m):
            # a fork was found: resolution (divergent-head discard +
            # re-push from authority) is in flight; scheduling normal
            # recovery (or a lean checkpoint) off this info would bless
            # the divergent log.  The les fence deliberately does NOT
            # advance here: trimming the interval history before the
            # fork is resolved would lose the evidence that the prior
            # holder must be consulted again after a crash.
            return
        # peering bookkeeping: note objects I am behind on (they stay
        # blocked until the pull lands) — AFTER the fork check, so a
        # divergent peer's doomed versions never wedge the stale gate
        my_best: dict[str, int] = {}
        for (name, _s), v in my_inv.items():
            my_best[name] = max(my_best.get(name, -1), v)
        stale = self._stale_objects.setdefault(m.pgid, {})
        for (name, _s), v in peer_inv.items():
            if v > my_best.get(name, -1) and dead.get(name, -1) < v:
                stale[name] = max(stale.get(name, 0), v)
        if done_peering:
            # one full post-split round has closed: lean peering is
            # trustworthy again
            self._split_fresh.discard(m.pgid)
            self.events.emit(
                "pg", f"pg {self._pgstr(m.pgid)} peering done",
                pg=self._pgstr(m.pgid),
                state="degraded" if stale else "active",
                epoch=self._peering_epoch.get(m.pgid, 0),
                stale_objects=len(stale))
        if (done_peering or fence_done) and not stale:
            # every member (incl. prior-interval holders) answered a
            # round that closed with no fork and nothing known-missing:
            # the PG is peered — fence + trim the history.  The fence
            # advances to the epoch of the round that COMPLETED (not
            # the live map epoch: a straggler racing a map push must
            # not fence an epoch whose prior-set query never ran), and
            # ONLY via a closing round: fork resolution re-arms the
            # round (below), so a fence can never be taken off the
            # hollow mid-resolution state — round 4's first cut did,
            # and the bogus fence made the phantom rule discard
            # committed writes on a temp-primary.
            self._set_les(m.pgid,
                          self._peering_epoch.get(m.pgid, 0))
        if m.lean:
            self._delta_recover(m.pgid, pool, up, m.from_osd,
                                m.last_complete, dead)
            if m.last_complete >= self._pglog(m.pgid).last_version():
                self._maybe_clear_pg_temp(m.pgid, m.from_osd)
        else:
            self._peer_invs.setdefault(m.pgid, {})[m.from_osd] = peer_inv
            if pool.kind == "ec":
                scheduled = self._recover_ec(m.pgid, pool, up, m.from_osd,
                                             peer_inv, my_inv, dead)
            else:
                scheduled = self._recover_replicated(
                    m.pgid, up, m.from_osd, peer_inv, my_inv, dead)
            if scheduled == 0 and m.from_osd != self.osd_id and \
                    m.from_osd in [u for u in up if u is not None]:
                # verified in sync: checkpoint so future peering rounds
                # take the lean path
                self.messenger.send_message(
                    f"osd.{m.from_osd}",
                    MPGPush(m.pgid, -2, {}, {},
                            checkpoint=self._pglog(m.pgid).last_version()))
                self._maybe_clear_pg_temp(m.pgid, m.from_osd)
        if pool.kind == "ec" and (done_peering
                                  or m.pgid not in self._peering):
            # reconcile on completion AND on post-peering updates: a
            # pre-rollback inventory arriving late must not re-wedge the
            # stale gate on a version that was rolled back.  Debounced —
            # a recovery batch triggers one pass, not one per info.
            now = time.monotonic()
            if done_peering or \
                    now - self._reconcile_at.get(m.pgid, 0.0) > 0.25:
                self._reconcile_at[m.pgid] = now
                # the lc-based PG-level rollback only trusts a COMPLETE
                # fresh round (done_peering): partial or cached lc views
                # must never roll back writes committed since collection
                self._reconcile_ec(m.pgid, pool, up,
                                   lc_authority=done_peering)

    def _maybe_clear_pg_temp(self, pgid: PgId, peer: int) -> None:
        """If a pg_temp override is active and the REAL primary (the up
        set's head with no temp applied) just verified in sync, the
        override has served its purpose — ask the mon to clear it."""
        key = (pgid.pool, pgid.seed)
        if not self.osdmap.pg_temp.get(key):
            return
        real = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed,
                                         ignore_temp=True)
        if peer == self._primary_of(real):
            self.messenger.send_message(
                self.mon, MOSDPGTemp(self.osd_id, pgid, []))

    def _delta_recover(self, pgid: PgId, pool, up, peer: int,
                       peer_lc: int, dead: dict) -> None:
        """Log-based delta recovery: replay MY entries after the peer's
        last-complete and push exactly those objects (PGLog delta resync
        instead of whole-inventory backfill)."""
        pl = self._pglog(pgid)
        entries = pl.entries_after(peer_lc)
        if not entries:
            return
        self.perf.inc("recovery_delta")
        names: dict[str, int] = {}
        removes: dict[str, int] = {}
        for e in entries:
            if e.op == "remove":
                removes[e.oid] = max(removes.get(e.oid, 0), e.version)
                names.pop(e.oid, None)
            else:
                names[e.oid] = max(names.get(e.oid, -1), e.version)
        for name, v in list(names.items()):
            if dead.get(name, -1) >= v:
                removes[name] = dead[name]
                del names[name]
        if removes and peer != self.osd_id:
            self.messenger.send_message(
                f"osd.{peer}", MPGPush(pgid, -3, {}, removes,
                                       trace=self._rec_trace(pgid)))
        if pool.kind == "ec":
            for shard, osd in enumerate(up):
                if osd != peer:
                    continue
                for name, v in names.items():
                    if not self._claim_rebuild(pgid, name, shard, peer):
                        continue  # an earlier round's rebuild is on it
                    self._recovery_op(
                        pgid, peer,
                        lambda name=name, shard=shard, v=v:
                        self._rebuild_shard(pgid, name, shard, peer, v),
                        nbytes=self._rec_weight(pgid, name))
        elif peer != self.osd_id:
            def push_delta(pgid=pgid, peer=peer, names=dict(names)):
                cid = CollectionId(pgid.pool, pgid.seed)
                push = {}
                for name, v in names.items():
                    obj = to_oid(name)
                    try:
                        data, attrs = self._read_obj_raw(cid, obj)
                        push[name] = (int(attrs.get("v", v)), data, None,
                                      self.store.omap_get(cid, obj),
                                      self._push_attrs(attrs))
                    except NoSuchObject:
                        continue
                if push:
                    self.perf.inc("recovery_push", len(push))
                    self.messenger.send_message(
                        f"osd.{peer}",
                        MPGPush(pgid, -1, push,
                                trace=self._rec_trace(pgid)))

            self._recovery_op(pgid, peer, push_delta,
                              nbytes=sum(self._rec_weight(pgid, n)
                                         for n in names))

    def _recover_replicated(self, pgid, up, peer, peer_inv, my_inv,
                            dead) -> int:
        if peer == self.osd_id:
            return 0
        peer_is_member = peer in [u for u in up if u is not None]
        cid = CollectionId(pgid.pool, pgid.seed)
        push, pull, deletes = [], [], {}
        for (name, shard), v in my_inv.items():
            if dead.get(name, -1) >= v:
                continue  # deleted; never resurrect
            if not peer_is_member:
                continue  # demoted holders only feed pulls, not pushes
            pv = peer_inv.get((name, shard), -1)
            if pv < v:
                push.append((name, shard))
        for (name, shard), pv in peer_inv.items():
            if dead.get(name, -1) >= pv:
                deletes[name] = dead[name]  # peer missed the remove
            elif my_inv.get((name, shard), -1) < pv:
                pull.append(name)
        # locally apply missed removes too
        for (name, shard), v in my_inv.items():
            if dead.get(name, -1) >= v:
                obj = to_oid(name, shard)
                if self.store.exists(cid, obj):
                    self.store.queue_transaction(
                        Transaction().remove(cid, obj))
        if push or deletes:
            self.perf.inc("recovery_push", len(push))

            def push_objs(pgid=pgid, peer=peer, push=list(push),
                          deletes=dict(deletes)):
                # read at EXECUTION time: the op may queue behind
                # reservations, and a stale closure would pin memory and
                # push bytes the receiver's version guard just discards
                out = {}
                for name, shard in push:
                    obj = to_oid(name, shard)
                    try:
                        data, attrs = self._read_obj_raw(cid, obj)
                        out[name] = (int(attrs.get("v", 0)), data, None,
                                     self.store.omap_get(cid, obj),
                                     self._push_attrs(attrs))
                    except NoSuchObject:
                        continue
                if out or deletes:
                    self.messenger.send_message(
                        f"osd.{peer}",
                        MPGPush(pgid, -1, out, deletes,
                                trace=self._rec_trace(pgid)))

            self._recovery_op(pgid, peer, push_objs,
                              nbytes=sum(self._rec_weight(pgid, n)
                                         for n, _s in push))
        if pull:
            # the primary itself is behind (e.g. revived empty): pull,
            # and ask the mon to keep the caught-up peer serving in the
            # meantime (pg_temp — clients follow the acting set).
            # Pulls unblock client IO, so they ride the reservation
            # queue at forced priority (stale objects exist by now).
            # pulled objects have no local copy to size: weight by name
            # count (1 each) rather than pretending to know their bytes
            self._recovery_op(
                pgid, peer,
                lambda pull=list(pull): self.messenger.send_message(
                    f"osd.{peer}",
                    MPGPull(pgid, pull, trace=self._rec_trace(pgid))),
                nbytes=len(pull))
            if peer_is_member:
                temp = [peer] + [u for u in up
                                 if u is not None and u != peer]
                self.messenger.send_message(
                    self.mon, MOSDPGTemp(self.osd_id, pgid, temp))
        return len(push) + len(deletes) + len(pull)

    def _handle_pg_pull(self, conn, m: MPGPull) -> None:
        # a sampled storm's pull serve becomes a child span of the
        # requesting primary's storm root (the carried wire ctx)
        span_ctx = (self.tracer.start("recovery-pull-serve",
                                      parent=tuple(m.trace),
                                      pg=self._pgstr(m.pgid),
                                      n_objects=len(m.names))
                    if m.trace else contextlib.nullcontext())
        with span_ctx:
            cid = CollectionId(m.pgid.pool, m.pgid.seed)
            push = {}
            for name in m.names:
                obj = to_oid(name)
                try:
                    data, attrs = self._read_obj_raw(cid, obj)
                    push[name] = (int(attrs.get("v", 0)), data, None,
                                  self.store.omap_get(cid, obj),
                                  self._push_attrs(attrs))
                except NoSuchObject:
                    continue
            if push:
                conn.send(MPGPush(m.pgid, -1, push, force=m.force,
                                  trace=tuple(m.trace)))

    def _recover_ec(self, pgid, pool, up, peer, peer_inv, my_inv,
                    dead) -> int:
        """Rebuild missing shards on `peer` from k survivors.  Returns
        how much recovery work was scheduled (0 = peer verified in
        sync)."""
        scheduled = 0
        # authority object set: union of all shard inventories we know of
        # (primary's own + this peer's); keyed by name -> version
        names: dict[str, int] = {}
        for (name, _s), v in list(my_inv.items()) + list(peer_inv.items()):
            names[name] = max(names.get(name, -1), v)
        # deletes win: drop dead names from recovery, purge stray shards
        deletes = {}
        for name in list(names):
            if dead.get(name, -1) >= names[name]:
                deletes[name] = dead[name]
                del names[name]
        if deletes:
            cid = CollectionId(pgid.pool, pgid.seed)
            for name in deletes:
                for (iname, shard), _v in list(my_inv.items()):
                    if iname == name:
                        obj = ObjectId(name, shard=shard)
                        if self.store.exists(cid, obj):
                            self.store.queue_transaction(
                                Transaction().remove(cid, obj))
            if peer != self.osd_id:
                self.messenger.send_message(
                    f"osd.{peer}", MPGPush(pgid, -3, {}, deletes,
                                           trace=self._rec_trace(pgid)))
        scheduled += len(deletes)
        if peer not in [u for u in up if u is not None]:
            # demoted holder (notify path): migrate its stranded shards to
            # the current position holders; the version gate on the push
            # side dedups if the holder already caught up
            for (name, shard), v in peer_inv.items():
                if dead.get(name, -1) >= v or shard >= len(up):
                    continue
                holder = up[shard]
                if holder is None or holder == peer:
                    continue
                self._recovery_op(
                    pgid, holder,
                    lambda name=name, shard=shard, v=v, holder=holder:
                    self._fetch_and_push(pgid, name, shard, peer,
                                         holder, v),
                    nbytes=self._rec_weight(pgid, name))
                scheduled += 1
            return scheduled
        for shard, osd in enumerate(up):
            if osd == peer:
                for name, version in names.items():
                    if peer_inv.get((name, shard), -1) >= version:
                        continue  # peer current for its shard
                    scheduled += 1
                    if not self._claim_rebuild(pgid, name, shard, peer):
                        continue  # an earlier round's rebuild is on it
                    self._recovery_op(
                        pgid, peer,
                        lambda name=name, shard=shard, version=version:
                        self._rebuild_shard(pgid, name, shard, peer,
                                            version),
                        nbytes=self._rec_weight(pgid, name))
            elif osd == self.osd_id:
                # the peer's inventory may reveal objects where MY OWN
                # shard is missing/stale (e.g. primary revived empty)
                for name, version in names.items():
                    if my_inv.get((name, shard), -1) >= version:
                        continue
                    scheduled += 1
                    if not self._claim_rebuild(pgid, name, shard,
                                               self.osd_id):
                        continue
                    self._recovery_op(
                        pgid, None,
                        lambda name=name, shard=shard, version=version:
                        self._rebuild_shard(pgid, name, shard,
                                            self.osd_id, version),
                        nbytes=self._rec_weight(pgid, name))
        return scheduled

    def _claim_rebuild(self, pgid, name: str, shard: int,
                       target: int) -> bool:
        """Whether a peering round schedules the rebuild of ``name``'s
        ``shard`` onto ``target``: not while an earlier round's rebuild
        of it is queued or its fetch is out.  A recovering primary
        re-queries its PG every 0.25 s and each member's inventory reply
        runs _recover_ec over every shard still missing, so without the
        claim a PG of N missing objects fetches each of them O(N) times
        (N^2 whole-shard reads: an RBD image's objects all place in one
        PG).  The fetch's return gives the claim back (_release_rebuild;
        the osd_op_timeout sweep returns a fetch that never completes),
        and a map change drops every claim (_start_recovery)."""
        key = (pgid, name, shard, target)
        with self._pending_lock:
            if key in self._rebuilds_out:
                self._rebuilds_out[key] = True  # see _rebuild_shard
                return False
            self._rebuilds_out[key] = False
        return True

    def _release_rebuild(self, pgid, name: str, shard: int,
                         target: int) -> bool:
        """The rebuild's fetch is back: give its claim back, and say
        whether a later round wanted the rebuild while it was out."""
        with self._pending_lock:
            return self._rebuilds_out.pop((pgid, name, shard, target),
                                          False)

    def _reconcile_ec(self, pgid: PgId, pool, up,
                      lc_authority: bool = False) -> None:
        """After a peering round collected full inventories: find torn
        objects — ones whose newest version has FEWER than k shards (a
        partial write the stripe can never decode) — and roll the ahead
        shards back to the newest version k shards can serve (the EC
        rollback/rollforward decision of PGLog + rollback generations)."""
        codec = self._pool_codec(pgid.pool)
        invs = dict(self._peer_invs.get(pgid, {}))
        invs[self.osd_id] = self._inventory(pgid)
        holders = {shard: osd for shard, osd in enumerate(up)
                   if osd is not None}
        # PG-LEVEL torn detection from log positions (covers lean peers
        # whose inventories never traveled): the stripe can only decode
        # through the k-th highest last-complete; any member logged past
        # that point applied writes the stripe can never serve
        lcs = dict(self._peer_lcs.get(pgid, {}))
        lcs[self.osd_id] = self._lc(pgid)
        # only members with log EVIDENCE count: a freshly promoted spare
        # (lc 0, empty log) never saw the writes — its emptiness must not
        # drag the decode point down and roll back COMMITTED data on the
        # survivors (that would destroy the very shards recovery needs)
        member_lcs = {osd: lc for osd, lc in lcs.items()
                      if osd in holders.values() and lc > 0}
        if lc_authority and len(member_lcs) >= codec.k:
            decode_point = sorted(member_lcs.values(),
                                  reverse=True)[codec.k - 1]
            # versions past the decode point are being rolled back: stop
            # gating reads on pushes that will never come
            stale = self._stale_objects.get(pgid)
            if stale:
                for name, ver in list(stale.items()):
                    if ver > decode_point:
                        stale.pop(name)
            for osd, lc in member_lcs.items():
                if lc <= decode_point:
                    continue
                dout("osd", 1)("%s: %s member osd.%d logged to v%d past "
                               "decode point v%d: rolling back",
                               self.name, pgid, osd, lc, decode_point)
                msg = MPGRollback(pgid, "", -3, decode_point)
                if osd == self.osd_id:
                    self._handle_pg_rollback(None, msg)
                else:
                    self.messenger.send_message(f"osd.{osd}", msg)
        # per object: shard -> newest version any inventory reports
        # (per_obj: a copy an OSD off the up set still holds helps a
        # roll-forward), and the version each up holder reports at its
        # own position (up_obj: the k-support a rollback target also
        # needs, since a rollback drops copies it cannot undo)
        per_obj: dict[str, dict[int, int]] = {}
        up_obj: dict[str, dict[int, int]] = {}
        for osd, inv in invs.items():
            for (name, shard), v in inv.items():
                if shard < 0:
                    continue
                cur = per_obj.setdefault(name, {})
                cur[shard] = max(cur.get(shard, -1), v)
                if holders.get(shard) == osd:
                    up_obj.setdefault(name, {})[shard] = v
        dead = self._tombstones.get(pgid, {})
        closed_at = self._round_closed_at.get(pgid)
        for name, vs in per_obj.items():
            if not vs or dead.get(name, -1) >= max(vs.values()):
                continue
            vmax = max(vs.values())
            if sum(1 for v in vs.values() if v == vmax) >= codec.k:
                continue  # newest version decodable: roll-forward path
            if closed_at is not None and vmax > closed_at:
                # a write of this interval, in flight or acked since
                # the inventories were taken: those inventories cannot
                # show it on its other shards, so they cannot call it
                # torn (it is judged, if it tears, in the next round)
                continue
            # newest version k shards hold EXACTLY (shards at a newer
            # version carry different bytes and only help if they roll
            # back, which is what we're about to ask of them), counted
            # over every copy and over the up set's positions: a target
            # only copies off the up set support, or one below a version
            # they hold at k, is no rollback target
            target = max((v for v in set(vs.values())
                          if sum(1 for x in vs.values() if x == v)
                          >= codec.k), default=None)
            ups = list(up_obj.get(name, {}).values())
            if target is None or target == vmax \
                    or ups.count(target) < codec.k:
                continue  # nothing decodable — scrub/EIO territory
            ahead = {s: v for s, v in up_obj[name].items() if v > target}
            dout("osd", 1)("%s: torn EC object %s/%s: rolling %s back "
                           "to v%d", self.name, pgid, name, sorted(ahead),
                           target)
            for shard in ahead:
                holder = holders[shard]
                msg = MPGRollback(pgid, name, shard, target)
                if holder == self.osd_id:
                    self._handle_pg_rollback(None, msg)
                else:
                    self.messenger.send_message(f"osd.{holder}", msg)

    def _handle_pg_rollback(self, conn, m: MPGRollback) -> None:
        """Shard holder: undo applies on `oid` past to_version using the
        pglog pre-images; without pre-images, drop the shard copy so
        recovery rebuilds it from the version k shards agree on."""
        self.perf.inc("rollbacks")
        cid = CollectionId(m.pgid.pool, m.pgid.seed)
        pl = self._pglog(m.pgid)
        if m.oid == "":
            # PG-level: undo EVERYTHING this shard logged past the
            # decode point (first entry past the point per object gives
            # the version to return to)
            span = sorted((e for e in pl.entries()
                           if e.version > m.to_version),
                          key=lambda e: e.version)
            groups: dict[tuple, list[LogEntry]] = {}
            for e in span:
                groups.setdefault((e.oid, e.shard), []).append(e)
            for (oid, shard), group in groups.items():
                if m.divergent and m.max_epoch > 0 and \
                        group[-1].epoch >= m.max_epoch:
                    # this object's NEWEST write belongs to an interval
                    # that survived the fork (e.g. committed after a
                    # rejoin): its content must be kept — only the
                    # phantom entries below it are scrubbed from the
                    # log (log hygiene without data loss)
                    from .pglog import _key
                    phantom = [e for e in group
                               if e.epoch < m.max_epoch]
                    if phantom:
                        self.store.queue_transaction(
                            Transaction().omap_rmkeys(
                                cid, PGLOG_OID,
                                [_key(e.version) for e in phantom]))
                    continue
                # PG-level undo is PRE-IMAGE ONLY: dropping a full-write
                # shard here could destroy the only copy of its position
                # without verifying the target version is decodable —
                # that call belongs to the per-object reconcile, which
                # checks k-support first.  A divergent discard drops a
                # replicated copy (the authority re-pushes its own
                # content, PGLog.h:1344); an EC shard copy it cannot
                # undo is kept, with its entries cleaned, and dropped
                # only by a per-object rollback the primary sends where
                # k other positions can rebuild it (_discard_divergent)
                undone = self._rollback_one(
                    m.pgid, pl, cid, oid, shard, group[0].prev_version,
                    allow_drop=m.divergent and shard < 0)
                if m.divergent and not undone and shard >= 0:
                    from .pglog import _key
                    self.store.queue_transaction(
                        Transaction().omap_rmkeys(
                            cid, PGLOG_OID,
                            [_key(e.version) for e in group]))
        else:
            self._rollback_one(m.pgid, pl, cid, m.oid, m.shard,
                               m.to_version)
        if self._lc(m.pgid) > m.to_version:
            self._set_lc(m.pgid, m.to_version)
        # surface the new state to the primary so it can verify/rebuild
        if self.osdmap is None or m.pgid.pool not in self.osdmap.pools:
            return
        up = self.osdmap.pg_to_up_osds(m.pgid.pool, m.pgid.seed)
        primary = self._primary_of(up)
        if primary is None:
            return
        info = self._my_pg_info(m.pgid)
        if primary == self.osd_id:
            self._handle_pg_info(None, info)
        else:
            self.messenger.send_message(f"osd.{primary}", info)

    def _rollback_one(self, pgid: PgId, pl: PGLog, cid, oid: str,
                      shard: int, to_version: int,
                      allow_drop: bool = True) -> bool:
        """Undo one object's applies past to_version: pre-images when
        stashed, else (allow_drop) drop the shard copy for rebuild;
        to_version < 0 means the object was CREATED past the point —
        drop it.  Returns whether the copy was rolled back in place."""
        obj = ObjectId(oid, shard=shard)
        ok = False
        if to_version >= 0:
            try:
                ok = pl.rollback_object(oid, shard, to_version)
            except Exception as e:  # noqa: BLE001
                dout("osd", 1)("%s: rollback %s/%s failed: %r", self.name,
                               pgid, oid, e)
            if ok and self.store.exists(cid, obj):
                # no entry left to undo (a divergent discard cleaned
                # them, or the log trimmed them) is no rollback while
                # the copy still stands past the point
                ok = int(self.store.getattrs(cid, obj).get("v", 0)) \
                    <= to_version
        if not ok and not allow_drop:
            return False
        if not ok:
            span = [e for e in pl.entries_for(oid)
                    if e.shard == shard and e.version > max(to_version, -1)]
            tx = Transaction()
            if self.store.exists(cid, obj):
                tx.remove(cid, obj)
            if span:
                from .pglog import _key
                tx.omap_rmkeys(cid, PGLOG_OID,
                               [_key(e.version) for e in span])
            if tx.ops:
                self.store.queue_transaction(tx)
        self._ec_cache.invalidate(pgid, oid)
        dout("osd", 2)("%s: rolled %s/%s shard %d back to v%d (%s)",
                       self.name, pgid, oid, shard, to_version,
                       "pre-images" if ok else "dropped for rebuild")
        return ok

    def _fetch_and_push(self, pgid, name, shard, src: int, dst: int,
                        version: int) -> None:
        """Copy one shard from a demoted holder to its current position
        holder (direct migration — no decode needed)."""
        tid = next(self._tids)
        # storm ctx captured NOW: the storm accounting can drain (the
        # scheduling thunk returns before the async reads do) and pop
        # the root span before on_done fires
        tctx = self._rec_trace(pgid)

        def on_done(pr) -> None:
            if pr is None or shard not in pr.chunks:
                return
            total = self._ec_total_len(pr)
            self.perf.inc("recovery_push")
            omap = pr.omaps.get(shard)
            extra = (self._push_attrs(pr.shard_attrs[shard])
                     if shard in pr.shard_attrs else {})
            self.messenger.send_message(
                f"osd.{dst}",
                MPGPush(pgid, shard,
                        {name: (version, pr.chunks[shard].tobytes(),
                                total, omap, extra)},
                        trace=tctx))

        pr = _PendingRead(None, 0, pgid.pool, name, total_shards=1,
                          on_done=on_done, asked={shard: src})
        self._pending_reads[tid] = pr
        self.messenger.send_message(
            f"osd.{src}",
            MSubRead(tid, pgid, name, shard, klass="recovery"))

    def _ec_narrow_on(self) -> bool:
        return str(self.cfg["osd_ec_repair_narrow"]).lower() != "off"

    def _rebuild_fetch_set(self, codec, shard: int,
                           fan: list) -> set[int] | None:
        """Positions a single-shard rebuild actually needs to read —
        the codec's minimum_to_decode set when it is NARROWER than a
        k-wide read (LRC: the lost chunk's locality group; SHEC: one
        shingle window).  None = read every holder (plain RS reads k+
        survivors anyway, and multi-failure/scrub paths want the full
        inventory)."""
        avail = [s for s, src in enumerate(fan)
                 if src is not None and s != shard
                 and s < codec.chunk_count]
        try:
            need = codec.minimum_to_decode([shard], avail)
        except Exception:  # noqa: BLE001 - undecodable now: wide fan
            return None
        need = [s for s in need if s != shard]
        if len(need) >= codec.k:
            return None
        return set(need)

    def _rebuild_shard(self, pgid, name, shard, peer, version,
                       force: bool = False, wide: bool = False) -> None:
        """Reconstruct one shard from survivors, then push it.

        Repair-bandwidth-optimal fetch (osd_ec_repair_narrow): a plain
        single-failure rebuild asks the codec what it MINIMALLY needs —
        a sub-chunk codec at the MSR point (CLAY, d=k+m-1) reads only
        the alpha/q repair-plane byte ranges from each helper
        (_rebuild_shard_subchunk), a locality code reads one narrow
        group (LRC: |group| < k shards; SHEC: one shingle) — and only
        falls back to the k-wide whole-shard fan-out (``wide=True``,
        today's behavior) when the narrow read cannot produce a
        version-agreed decodable set."""
        up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
        codec = self._pool_codec(pgid.pool)
        narrow = self._ec_narrow_on() and not force and not wide
        # shard -> source OSD: the position holder when it (plausibly)
        # has the shard, else ANY holder the collected inventories
        # revealed — after a PG split the shards sit on strays and
        # wrong positions until recovery completes, and a purely
        # positional fan-out would never gather k survivors.
        invs = dict(self._peer_invs.get(pgid, {}))
        invs[self.osd_id] = self._inventory(pgid)
        fan = []
        for s, u in enumerate(up):
            src = None
            if u is not None and u != peer and \
                    (u not in invs or (name, s) in invs[u]):
                src = u
            if src is None:
                src = next((osd_id for osd_id, inv in invs.items()
                            if osd_id != peer and (name, s) in inv),
                           None)
            fan.append(src)
        if narrow and self._rebuild_shard_subchunk(pgid, name, shard,
                                                   peer, version, fan,
                                                   up, codec):
            return
        fetch = self._rebuild_fetch_set(codec, shard, fan) \
            if narrow else None
        if fetch is not None:
            # the lost position itself stays in the fan: a stray still
            # holding the shard supplies it directly (no decode at all)
            fan = [src if (s in fetch or s == shard) else None
                   for s, src in enumerate(fan)]
        tid = next(self._tids)
        # storm ctx captured NOW, not at push time: the storm's op
        # accounting drains when the scheduling thunks return (the
        # shard reads are async), which can pop the root span before
        # on_done runs
        tctx = self._rec_trace(pgid)

        retried = []

        def retry_wide() -> None:
            # narrow read insufficient (stale/missing group member):
            # one wide retry — the full fan-out sees every holder
            retried.append(True)
            self.perf.inc("recovery_wide_retries")
            self._rebuild_shard(pgid, name, shard, peer, version,
                                force=force, wide=True)

        def enough(cand: dict) -> bool:
            if shard in cand and not force:
                return True
            return (fetch <= set(cand) if fetch is not None
                    else len(cand) >= codec.k)

        def on_done(pr) -> None:
            # a round that wanted this rebuild while the fetch was out
            # knew more members' inventories than the fetch's fan did:
            # if the fetch fell short, rebuild again as that round would
            wanted = self._release_rebuild(pgid, name, shard, peer)
            if not finish(pr) and wanted and not retried and \
                    self._claim_rebuild(pgid, name, shard, peer):
                self._recovery_op(
                    pgid, None if peer == self.osd_id else peer,
                    lambda: self._rebuild_shard(pgid, name, shard, peer,
                                                version),
                    nbytes=self._rec_weight(pgid, name))

        def finish(pr) -> bool:
            """Push the rebuilt shard; whether it was pushed."""
            if pr is None or not enough(pr.chunks):
                # not enough survivors NOW; a narrow read retries wide,
                # else a later peering/requery round retries (never
                # leave a hole with no retry scheduled)
                if fetch is not None:
                    retry_wide()
                else:
                    self._requery_pg(pgid)
                return False
            chunks = pr.chunks
            push_version = version
            if pr.shard_vers:
                # rebuild only from a version-AGREED survivor set: mixing
                # a stale shard into the decode would fabricate garbage
                # stamped with the new version
                vmax = max(pr.shard_vers.values())
                cand = {s: c for s, c in chunks.items()
                        if pr.shard_vers.get(s) == vmax}
                if enough(cand):
                    chunks = cand
                    # stamp what the agreed set actually decodes — NOT
                    # the requested version: a rebuild scheduled from a
                    # pre-rollback inventory would otherwise fabricate
                    # old bytes labelled with the rolled-back version,
                    # re-tearing the stripe it was meant to heal
                    push_version = vmax
                elif fetch is not None:
                    retry_wide()
                    return False
                else:
                    self._requery_pg(pgid, force_full=True)
                    return False  # no consistent set yet: requery retries
            if shard in chunks and not force:
                rebuilt = chunks[shard]
            else:
                # scrub repair must NOT trust the (possibly corrupt)
                # existing shard copy: always re-derive it
                chunks = {i: c for i, c in chunks.items() if i != shard} \
                    if force else chunks
                if not enough(chunks):
                    self._requery_pg(pgid)
                    return False
                try:
                    out = self._ec_decode(codec, [shard], dict(chunks))
                except Exception:  # noqa: BLE001 - narrow set fell short
                    if fetch is not None:
                        retry_wide()
                        return False
                    raise
                rebuilt = out[shard]
                self.perf.inc("recovery_fetch_bytes",
                              sum(c.nbytes for c in chunks.values()))
                self.perf.inc("recovery_rebuilt_bytes", rebuilt.nbytes)
                if fetch is not None:
                    self.perf.inc("recovery_narrow_rebuilds")
            total = self._ec_total_len(pr)
            self.perf.inc("recovery_push")
            # metadata travels with the rebuild — from a SURVIVING
            # shard's reply when available (the pushing primary's own
            # copy may itself be the one missing)
            omap, extra = self._ec_meta_for(pgid, name)
            for s in chunks:
                if s in pr.omaps:
                    omap = pr.omaps[s]
                    break
            src = next((s for s in chunks if s in pr.shard_attrs), None)
            if src is not None:
                extra = self._push_attrs(pr.shard_attrs[src])
            self.messenger.send_message(
                f"osd.{peer}",
                MPGPush(pgid, shard,
                        {name: (push_version, rebuilt.tobytes(), total,
                                omap, extra)},
                        force=force, trace=tctx))
            return True

        pr = _PendingRead(None, 0, pgid.pool, name,
                          total_shards=sum(1 for u in fan
                                           if u is not None),
                          on_done=on_done)
        self._pending_reads[tid] = pr
        self._fan_shard_reads(tid, pgid, name, fan, klass="recovery")

    def _subchunk_repair_plan(self, pgid: PgId, name: str, shard: int,
                              fan: list, up: list, peer: int,
                              codec) -> dict | None:
        """Fetch plan for a sub-chunk (CLAY MSR) rebuild of `shard`, or
        None when the bandwidth-optimal repair does not apply: needs
        the REQUIRE_SUB_CHUNKS repair surface at the MSR point (m == q,
        i.e. d = k+m-1), a live source for EVERY other position (the
        column solve consumes all n-1 helpers), a known object length,
        and a chunk size the plane grid divides.  A position the
        inventory scan left sourceless still tries its live map holder
        — a lean peering round simply hasn't shipped that inventory
        yet, and a holder genuinely missing the object answers ENOENT,
        which retries wide (the designed fallback)."""
        from ..ec.interface import Flags as ECFlags
        if not (codec.get_flags() & ECFlags.REQUIRE_SUB_CHUNKS):
            return None
        if not hasattr(codec, "repair_chunk") \
                or getattr(codec, "q", None) != codec.m:
            return None
        n = codec.chunk_count
        if shard >= n or len(up) < n:
            return None
        sources: dict[int, int] = {}
        for s in range(n):
            if s == shard:
                continue
            src = fan[s] if s < len(fan) else None
            if src is None and up[s] is not None and up[s] != peer:
                src = up[s]
            if src is None:
                return None
            sources[s] = src
        helpers = sorted(sources)
        if len(helpers) != n - 1:
            return None
        total = self._ec_object_len(pgid, name)
        if not total:
            return None
        si = self._pool_stripe(pgid.pool)
        # sub-chunk layout: the write path encodes the WHOLE write's
        # shard stream as ONE codec chunk (streams are (k, rows*cs)),
        # and the degraded-read decode splits whole streams the same
        # way — so the repair plan's plane grid spans the whole shard
        # stream too (sub-chunk = stream/alpha), NOT per stripe row.
        # Both are exact for full-stream writes, the only write shape
        # REQUIRE_SUB_CHUNKS pools take through this daemon.
        shard_len = si.object_chunk_size(total)
        alpha = codec.alpha
        if shard_len <= 0 or shard_len % alpha:
            return None
        sub = shard_len // alpha
        planes = codec.repair_planes(shard)
        # contiguous plane indices merge into few ranged extents
        runs: list[tuple[int, int]] = []
        start = prev = planes[0]
        for z in planes[1:]:
            if z == prev + 1:
                prev = z
                continue
            runs.append((start, prev - start + 1))
            start = prev = z
        runs.append((start, prev - start + 1))
        extents = [(z0 * sub, cnt * sub) for z0, cnt in runs]
        return {"helpers": helpers, "sources": sources,
                "extents": extents, "planes": planes,
                "shard_len": shard_len, "sub": sub}

    def _rebuild_shard_subchunk(self, pgid, name, shard, peer, version,
                                fan: list, up: list, codec) -> bool:
        """Bandwidth-optimal single-shard rebuild for sub-chunk codecs
        (CLAY at d = k+m-1): fetch only the alpha/q repair-plane byte
        ranges from each of the n-1 helpers — (n-1)/q of the bytes a
        k-wide whole-shard read moves — and solve the lost chunk with
        the codec's repair path (folded across the storm by the
        batcher).  Returns False when the plan does not apply (caller
        falls through to the plain fan-out); any mid-flight
        insufficiency retries wide."""
        plan = self._subchunk_repair_plan(pgid, name, shard, fan, up,
                                          peer, codec)
        if plan is None:
            return False
        # the rebuilt shard must land WITH its replicated metadata, and
        # ranged replies ship only the verification attrs — so the
        # metadata must come from a local shard copy; without one the
        # wide whole-shard read (which carries omap+attrs) is the
        # correct path
        omap, extra = self._ec_meta_for(pgid, name)
        if not extra and omap is None:
            return False
        helpers, extents = plan["helpers"], plan["extents"]
        sub, P = plan["sub"], len(plan["planes"])
        per_helper = P * sub
        tid = next(self._tids)
        # storm ctx captured now (see _rebuild_shard)
        tctx = self._rec_trace(pgid)

        def retry_wide() -> None:
            self.perf.inc("recovery_wide_retries")
            self._rebuild_shard(pgid, name, shard, peer, version,
                                wide=True)

        def on_done(pr) -> None:
            self._release_rebuild(pgid, name, shard, peer)
            if pr is None or not all(
                    h in pr.chunks and pr.chunks[h].size == per_helper
                    for h in helpers):
                retry_wide()
                return
            push_version = version
            if pr.shard_vers:
                # the MSR solve mixes every helper's symbols: ALL n-1
                # must agree on one version (cf. the agreed-k rule)
                vers = {pr.shard_vers.get(h) for h in helpers}
                if len(vers) != 1 or None in vers:
                    retry_wide()
                    return
                push_version = vers.pop()
            sub_arrs = {h: np.asarray(pr.chunks[h],
                                      dtype=np.uint8).reshape(P, sub)
                        for h in helpers}
            try:
                rebuilt = self._ec_repair(codec, shard, sub_arrs,
                                          plan["shard_len"])
            except Exception:  # noqa: BLE001 - solve failed: go wide
                retry_wide()
                return
            self.perf.inc("recovery_fetch_bytes",
                          per_helper * len(helpers))
            self.perf.inc("recovery_rebuilt_bytes", rebuilt.nbytes)
            self.perf.inc("recovery_subchunk_rebuilds")
            self.perf.inc("recovery_push")
            total = self._ec_total_len(pr)
            self.messenger.send_message(
                f"osd.{peer}",
                MPGPush(pgid, shard,
                        {name: (push_version, rebuilt.tobytes(), total,
                                omap, extra)},
                        trace=tctx))

        pr = _PendingRead(None, 0, pgid.pool, name,
                          total_shards=len(helpers), on_done=on_done,
                          want_all=True)
        self._pending_reads[tid] = pr
        # repair-plane extents ride the per-(peer, pg) aggregator when
        # read coalescing is on (ROADMAP wide-codes follow-on (c)): a
        # storm rebuilding many objects sends ONE MSubReadN per helper
        # per window — recovery-class lanes, so the peer still queues
        # the batch under its recovery reservation — instead of one
        # MSubRead per (object, helper)
        coalesce = self._ec_read_coalesce_on(pgid.pool)
        self._note_asked(tid, {s: plan["sources"][s] for s in helpers})
        for s in helpers:
            osd = plan["sources"][s]
            if osd == self.osd_id:
                self._deliver_local_shard_read(tid, pgid, name, s,
                                               extents)
            elif coalesce:
                self._read_agg.submit(f"osd.{osd}", tid, pgid, name, s,
                                      list(extents), klass="recovery")
            else:
                self.messenger.send_message(
                    f"osd.{osd}",
                    MSubRead(tid, pgid, name, s, list(extents),
                             klass="recovery"))
        return True

    def _ec_meta_for(self, pgid: PgId, name: str):
        """(omap, user attrs) from MY shard copy of an EC object —
        rides recovery pushes so rebuilt shards carry the replicated
        metadata (the ECOmapJournal recovery contract)."""
        up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
        myshard = up.index(self.osd_id) if self.osd_id in up else 0
        cid = CollectionId(pgid.pool, pgid.seed)
        obj = to_oid(name, myshard)
        try:
            omap = self.store.omap_get(cid, obj)
            extra = self._push_attrs(self.store.getattrs(cid, obj))
        except NoSuchObject:
            return None, {}
        return (omap or None), extra

    def _push_attrs(self, attrs: dict) -> dict:
        """Attrs worth carrying on a recovery push: everything the apply
        side does not recompute (v/len/d, and the compression extent
        metadata cz/crl — pushes ship raw bytes and the receiver's
        _apply_write re-decides compression for its own store) —
        SnapSets, whiteouts, user attrs survive recovery this way."""
        return {k: v for k, v in attrs.items()
                if k not in ("v", "len", "d", "cz", "crl")}

    def _handle_pg_push(self, conn, m: MPGPush) -> None:
        # per-push child span of the sender's storm root (the carried
        # wire ctx): a sampled recovery storm's merged waterfall shows
        # every push apply cross-daemon (ROADMAP telemetry (b))
        if m.trace:
            with self.tracer.start("recovery-push-apply",
                                   parent=tuple(m.trace),
                                   pg=self._pgstr(m.pgid),
                                   n_objects=len(m.objects),
                                   n_deletes=len(m.deletes),
                                   nbytes=sum(len(p[1]) for p
                                              in m.objects.values())):
                self._apply_pg_push(conn, m)
            return
        self._apply_pg_push(conn, m)

    def _apply_pg_push(self, conn, m: MPGPush) -> None:
        cid = CollectionId(m.pgid.pool, m.pgid.seed)
        for name, version in m.deletes.items():
            self._record_tombstone(m.pgid, name, version)
            base, gen = split_vname(name)
            for oid in (list(self.store.list_objects(cid))
                        if cid in self.store.list_collections() else []):
                # a head tombstone must not nuke clones (they die only by
                # snap trim, under their own vname tombstones)
                if oid.name == base and (oid.generation == gen
                                         or (gen < 0
                                             and oid.generation < 0)):
                    self.store.queue_transaction(
                        Transaction().remove(cid, oid))
        dead = self._tombstones.get(m.pgid, {})
        for name in m.objects:
            self._ec_cache.invalidate(m.pgid, name)
        for name, payload in m.objects.items():
            if dead.get(name, -1) >= payload[0]:
                continue  # delete raced ahead of this push
            # never clobber a NEWER local copy with a stale recovery push
            # (a rebuild computed from a pre-overwrite inventory snapshot);
            # scrub repairs force through (same-version corrupt copies)
            shard_id = m.shard if m.shard >= 0 else -1
            if not m.force:
                try:
                    cur = self.store.getattrs(cid, to_oid(name, shard_id))
                    if int(cur.get("v", -1)) >= payload[0]:
                        continue
                except NoSuchObject:
                    pass
            if m.shard >= 0:
                version, data, total = payload[0], payload[1], payload[2]
                attrs = {"v": version}
                if total is not None:
                    attrs["len"] = total
                if len(payload) > 4 and payload[4]:
                    attrs.update(payload[4])  # user attrs ride along
                self._apply_write(m.pgid, name, m.shard, data, attrs,
                                  omap=payload[3]
                                  if len(payload) > 3 else None)
            else:
                version, data = payload[0], payload[1]
                omap = payload[3] if len(payload) > 3 else None
                attrs = {"v": version, "len": len(data)}
                if len(payload) > 4 and payload[4]:
                    attrs.update(payload[4])  # ss/wh/user attrs
                self._apply_write(m.pgid, name, -1, data, attrs,
                                  omap=omap)
        self._pg_versions[m.pgid] = max(
            self._pg_versions.get(m.pgid, 0),
            max((p[0] for p in m.objects.values()), default=0))
        # pushed objects are no longer stale-blocked
        stale = self._stale_objects.get(m.pgid)
        if stale:
            for name in list(m.objects) + list(m.deletes):
                stale.pop(name, None)
            if not stale and m.pgid not in self._peering:
                # recovery just drained the last known-missing object:
                # run one clean (non-blocking) round so the les fence
                # (which only advances via a closing round) catches up
                self._rearm_peering(m.pgid, block=False)
        if m.checkpoint >= 0 and m.checkpoint > self._lc(m.pgid):
            # the primary verified we need nothing through this version:
            # future peering rounds can take the lean (log) path
            self._set_lc(m.pgid, m.checkpoint)
        # if I am this PG's primary, newly-landed data may need forwarding
        # to members whose inventories were processed earlier: re-query,
        # debounced so a recovery batch triggers one round, not O(objects)
        self._requery_pg(m.pgid)

    def _requery_pg(self, pgid: PgId, force_full: bool = False) -> None:
        """Primary: re-run the inventory exchange for one PG (debounced)
        so recovery reconciles stale/missing shards without waiting for
        the next map epoch.  force_full demands inventories even from
        in-sync (lean) peers — needed when a version-split read shows
        the PG is torn and reconciliation requires the full picture."""
        if self.osdmap is None or pgid.pool not in self.osdmap.pools:
            return
        now = time.monotonic()
        # force_full has its own debounce lane so a routine requery just
        # before it cannot swallow the full-inventory demand
        key = (pgid, force_full)
        if now - self._requery_at.get(key, 0.0) < 0.2:
            # DEFER, never drop: a swallowed kick that happens to be the
            # last event in a recovery chain leaves a permanent fixed
            # point (the thrash missing_shard hole) — re-fire once the
            # window passes instead
            def fire(key=key, pgid=pgid, force_full=force_full):
                with self._pending_lock:
                    self._requery_timers.pop(key, None)
                if not self._stop.is_set():
                    self._requery_pg(pgid, force_full)
            with self._pending_lock:
                if key not in self._requery_timers:
                    t = threading.Timer(0.25, fire)
                    t.daemon = True
                    self._requery_timers[key] = t
                    t.start()
            return
        with self._pending_lock:
            stale = self._requery_timers.pop(key, None)
        if stale is not None:
            stale.cancel()  # superseded: must not re-fire redundantly
        up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
        if self._primary_of(up) != self.osd_id:
            return
        self._requery_at[key] = now
        ents = self._pglog(pgid).entries()  # one decode
        last = ents[-1].version if ents else 0
        floor_v = ents[0].version if ents else 0
        for osd in up:
            if osd is not None and osd != self.osd_id:
                self.messenger.send_message(
                    f"osd.{osd}",
                    MPGQuery(pgid, self.osdmap.epoch,
                             primary_last=last,
                             primary_floor=floor_v,
                             force_full=force_full))
