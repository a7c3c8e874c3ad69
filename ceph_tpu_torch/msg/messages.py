"""Message types for the client/OSD/monitor protocols.

The role of the reference's src/messages/ (M* classes over the wire codec
— SURVEY.md layer 2) for the TPU build's protocols: client IO (MOSDOp /
MOSDOpReply, ref MOSDOp), shard sub-ops (MSubWrite/MSubRead — the role of
MOSDRepOp and MOSDECSubOpWrite/Read, ref src/osd/ECMsgTypes.h), heartbeats
and failure reports (MOSDPing / MFailureReport, ref OSD::handle_osd_ping +
MOSDFailure), map distribution (MMapPush), monitor commands, and
peering/recovery (MPGQuery/MPGInfo/MPGPush).

All are dataclasses; the wire-critical ones are Encodable (versioned
codec).  In-proc transports pass the objects; wire transports call
encode_message/decode_message.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.codec import Decoder, Encodable, Encoder


@dataclass(frozen=True, order=True)
class PgId:
    pool: int
    seed: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.seed:x}"


# --------------------------------------------------------------- client IO
@dataclass
class MOSDOp(Encodable):
    tid: int
    client: str
    pool: int
    oid: str
    op: str  # write_full (replace) | write (partial at offset) | read | remove | stat
    offset: int = 0
    length: int = 0
    data: bytes = b""
    epoch: int = 0  # client's map epoch (staleness check)
    # v2 tail: self-managed snapshots (SnapContext on writes, snapid on
    # reads — the osd_op_t snapc/snapid role).  snapid 0 = head.
    snapid: int = 0
    snap_seq: int = 0
    snaps: list = field(default_factory=list)  # newest-first snap ids
    # v3 tail: trace context (trace_id, span_id) — the tracer.h span
    # propagation role; empty = tracing off for this op
    trace: tuple = ()
    # v4 tail: cephx ticket + per-op proof (MOSDOp session auth role);
    # empty = cluster runs without authorization
    ticket: bytes = b""
    proof: bytes = b""
    # v5 tail: client-side dmclock tags (qos/dmclock.py ServiceTracker
    # role) — tenant names the mclock sub-queue this op bills to;
    # qdelta/qrho say how many responses (total / reservation-phase)
    # this tenant received cluster-wide since its last request to THIS
    # osd, so the server advances its tenant clocks multi-server-
    # correctly with no global clock.  Empty tenant = untagged: the op
    # rides the default stream and the tags are ignored.
    tenant: str = ""
    qdelta: int = 0
    qrho: int = 0

    VERSION, COMPAT = 5, 1

    def encode(self, enc: Encoder) -> None:
        def body(e):
            e.u64(self.tid); e.string(self.client); e.u64(self.pool)
            e.string(self.oid); e.string(self.op); e.u64(self.offset)
            e.u64(self.length); e.blob(self.data); e.u64(self.epoch)
            e.u64(self.snapid); e.u64(self.snap_seq)   # v2 tail
            e.seq(self.snaps, Encoder.u64)
            e.seq(list(self.trace), Encoder.u64)       # v3 tail
            e.blob(self.ticket); e.blob(self.proof)    # v4 tail
            e.string(self.tenant)                      # v5 tail
            e.u64(self.qdelta); e.u64(self.qrho)
        enc.versioned(self.VERSION, self.COMPAT, body)

    @classmethod
    def decode(cls, dec: Decoder) -> "MOSDOp":
        def body(d, v):
            m = cls(d.u64(), d.string(), d.u64(), d.string(), d.string(),
                    d.u64(), d.u64(), d.blob(), d.u64())
            if v >= 2:
                m.snapid = d.u64()
                m.snap_seq = d.u64()
                m.snaps = d.seq(Decoder.u64)
            if v >= 3:
                m.trace = tuple(d.seq(Decoder.u64))
            if v >= 4:
                m.ticket = d.blob()
                m.proof = d.blob()
            if v >= 5:
                m.tenant = d.string()
                m.qdelta = d.u64()
                m.qrho = d.u64()
            return m
        return dec.versioned(cls.VERSION, body)


@dataclass
class MOSDOpReply(Encodable):
    tid: int
    result: int  # 0 ok, negative errno-style
    data: bytes = b""
    version: int = 0
    epoch: int = 0  # responder's map epoch (client refreshes if newer)
    # v2 tail: the mclock phase this op was served under (qos/dmclock
    # PHASE_*: 0 none/fifo, 1 reservation, 2 weight) — the feedback the
    # client-side ServiceTracker folds into its rho bookkeeping
    qphase: int = 0
    # v3 tail: read-lease grant, seconds of validity from receipt
    # (0 = no lease).  Granted by the serving OSD on hot whole-object
    # reads; the client may serve the returned bytes from its local
    # cache until revoke (watch/notify "_lease" ping) or expiry.
    lease: float = 0.0

    VERSION, COMPAT = 3, 1

    def encode(self, enc: Encoder) -> None:
        def body(e):
            e.u64(self.tid); e.i64(self.result); e.blob(self.data)
            e.u64(self.version); e.u64(self.epoch)
            e.u8(self.qphase)                          # v2 tail
            e.f64(self.lease)                          # v3 tail
        enc.versioned(self.VERSION, self.COMPAT, body)

    @classmethod
    def decode(cls, dec: Decoder) -> "MOSDOpReply":
        def body(d, v):
            m = cls(d.u64(), d.i64(), d.blob(), d.u64(), d.u64())
            if v >= 2:
                m.qphase = d.u8()
            if v >= 3:
                m.lease = d.f64()
            return m
        return dec.versioned(cls.VERSION, body)


# ------------------------------------------------------------- shard subops
@dataclass
class MSubWrite:
    """Primary -> shard OSD write (MOSDRepOp / MOSDECSubOpWrite role)."""

    tid: int
    pgid: PgId
    oid: str
    shard: int          # -1 replicated, >=0 EC shard id
    version: int
    op: str             # write | write_partial | remove
    data: bytes = b""
    attrs: dict = field(default_factory=dict)
    offset: int = 0     # write_partial only
    trace: tuple = ()   # (trace_id, span_id) — ZTracer sub-op span parent
    # map epoch the primary minted this write's version under: the
    # replica stamps its log entry with it so both sides agree on the
    # entry's interval (the eversion epoch, src/osd/osd_types.h)
    epoch: int = 0
    # originating client op's tenant: the shard OSD queues the apply
    # under the same dmclock tenant as the primary did, so replica-side
    # load is shaped by the same reservation/weight knobs.  Appended
    # with a default — old archived bytes decode compatibly.
    tenant: str = ""


@dataclass
class MSubPartialWrite:
    """Primary -> shard OSD: overwrite extents inside the shard stream
    (the partial-write leg of the EC RMW pipeline, ECTransaction role).
    Extents are shard-stream offsets under the stripe_info_t RAID-0
    layout (ref ECUtil.h:452-800)."""

    tid: int
    pgid: PgId
    oid: str
    shard: int
    version: int
    extents: list  # [(shard_off, bytes)]
    total_len: int = -1  # new whole-object length; -1 = leave unchanged
    create: bool = False  # primary-sanctioned create (fresh object rows)
    # conditional apply: the object version the primary based this write
    # on; a shard holding a DIFFERENT version must refuse (EAGAIN) so a
    # stale revived shard can never absorb extents computed against newer
    # data and be stamped current (the rollback-generation consistency
    # role, doc/dev/osd_internals/erasure_coding/ecbackend.rst:10-27)
    prev_version: int = -1  # -1 = unconditional
    epoch: int = 0  # primary's minting epoch (see MSubWrite.epoch)
    # snapshot rider (make_writeable, shard-wise): the shard clones its
    # head object to the generation variant and stores the shipped
    # SnapSet before applying the extents.  Empty = no snap work.
    snap: dict = field(default_factory=dict)
    trace: tuple = ()  # (trace_id, span_id) — ZTracer sub-op span parent
    tenant: str = ""   # originating tenant (see MSubWrite.tenant)


@dataclass
class MSubDelta:
    """Primary -> parity-shard OSD: fold data-shard deltas into the
    stored parity stream (apply_delta wire leg; ECUtil
    encode_parity_delta ECUtil.cc:519-566 role)."""

    tid: int
    pgid: PgId
    oid: str
    parity_shard: int   # this recipient's shard id
    version: int
    extents: list  # [(data_shard, shard_off, delta bytes)]
    total_len: int = -1  # new whole-object length; -1 = leave unchanged
    prev_version: int = -1  # conditional apply (see MSubPartialWrite)
    epoch: int = 0  # primary's minting epoch (see MSubWrite.epoch)
    snap: dict = field(default_factory=dict)  # see MSubPartialWrite.snap
    trace: tuple = ()  # see MSubPartialWrite.trace
    tenant: str = ""   # originating tenant (see MSubWrite.tenant)


@dataclass
class MSubWriteReply:
    tid: int
    pgid: PgId
    shard: int
    from_osd: int
    result: int = 0


@dataclass
class MSubRead:
    """Primary -> shard OSD read (ECSubRead role).  extents=None reads
    the whole shard stream; otherwise the reply carries the concatenation
    of the requested [(shard_off, len)] slices, each zero-padded to its
    requested length (absent tail bytes of a padded stripe are zeros).

    klass is the mclock scheduler class the SERVING peer should queue
    this read under (the reference tags replica ops with the
    originating op's QoS class): client fan-outs ride "client",
    recovery shard fetches ride "recovery" so a rebuild storm's reads
    are shaped by the same reservation/limit knobs as its pushes.
    Appended with a default — old archived bytes decode compatibly."""

    tid: int
    pgid: PgId
    oid: str
    shard: int
    extents: list | None = None
    klass: str = "client"


@dataclass
class MSubReadReply:
    tid: int
    pgid: PgId
    oid: str
    shard: int
    from_osd: int
    result: int = 0
    data: bytes = b""
    attrs: dict = field(default_factory=dict)


@dataclass
class MSubReadN:
    """Primary -> shard OSD: MANY coalesced sub-reads of ONE pg in one
    message (the read-pipeline counterpart of the ECBatcher's folded
    launches: concurrent MSubReads headed to the same peer merge into
    one wire message instead of one per op).  Each item is one wire
    fetch — (fetch_id, oid, shard, extents) with MSubRead's extents
    semantics — and the peer answers ALL of them in one
    MSubReadReplyN.  fetch_id is an aggregator-local cookie: several
    pending reads (tids) may wait on one fetch (duplicate collapse),
    so the reply routes by fetch, not tid.  pgid rides the MESSAGE so
    the peer's sharded op queue serializes the whole batch with that
    pg's write applies, exactly like a plain MSubRead — which is why
    one message never mixes pgs.

    klass mirrors MSubRead's: the mclock class the SERVING peer queues
    the whole batch under — recovery repair-plane fetches coalesce per
    helper (one MSubReadN per storm window instead of one MSubRead per
    object) and still ride the peer's recovery reservation/limit.
    Trailing append with a default: archived bytes decode compatibly,
    and one message never mixes classes (lanes split by klass)."""

    items: list  # [(fetch_id, oid, shard, extents|None)]
    pgid: PgId | None = None
    klass: str = "client"


@dataclass
class MSubReadReplyN:
    """Shard OSD -> primary: the vectorized reply — one (fetch_id,
    result, data, attrs) per MSubReadN item, slices concatenated and
    zero-padded exactly as MSubReadReply would carry them."""

    from_osd: int
    items: list  # [(fetch_id, shard, result, data, attrs)]
    pgid: PgId | None = None


# ------------------------------------------------------- health / heartbeat
@dataclass
class MOSDPing:
    sender: int
    epoch: int
    stamp: float


@dataclass
class MOSDPingReply:
    sender: int
    stamp: float


@dataclass
class MFailureReport:
    target: int
    reporter: int
    epoch: int
    failed_for: float


# ---------------------------------------------------------------- maps/mon
@dataclass
class MMapPush:
    """Monitor -> subscriber: a map update.  Routine commits travel as
    INCREMENTALS (inc_bytes, applied iff the receiver sits at
    base_epoch); boots, subscriptions, and catch-up gaps get the full
    map (map_bytes).  Exactly one of the two is populated."""

    epoch: int
    map_bytes: bytes = b""   # encoded OSDMap
    inc_bytes: bytes = b""   # encoded OSDMapIncremental
    base_epoch: int = -1     # the epoch inc_bytes applies on top of


@dataclass
class MMonSubscribe:
    what: str = "osdmap"
    # the receiver's current epoch: lets the mon serve the gap as a
    # chain of incrementals instead of a full map (-1 = send full)
    have_epoch: int = -1


@dataclass
class MOSDPGTemp:
    """OSD -> mon: request (or clear) a temporary acting set for one PG
    while its new primary backfills (MOSDPGTemp role)."""

    osd_id: int
    pgid: PgId
    osds: list  # proposed acting set; empty = clear the override


@dataclass
class MOSDBoot:
    osd_id: int
    host: str
    addr: str       # data-plane messenger address (transport-specific)
    hb_addr: str = ""  # heartbeat messenger address


@dataclass
class MMonCommand:
    tid: int
    cmd: dict
    # cephx mon-service ticket + proof over (tid, canonical cmd);
    # empty = cluster runs without authorization
    ticket: bytes = b""
    proof: bytes = b""


@dataclass
class MMonCommandReply:
    tid: int
    result: int
    data: dict = field(default_factory=dict)


@dataclass
class MPGList:
    """Client -> PG primary: list the object heads of one PG (the
    librados NObjectIterator / pgls role).  Carries the cephx osd
    ticket + proof over (tid, pool, seed, "pgls") on auth clusters."""

    tid: int
    pgid: PgId
    epoch: int = 0
    ticket: bytes = b""
    proof: bytes = b""


@dataclass
class MPGListReply:
    tid: int
    pgid: PgId
    result: int = 0
    names: list = field(default_factory=list)
    epoch: int = 0


# ------------------------------------------------------------------- cephx
@dataclass
class MAuth:
    """Client -> mon: prove knowledge of the entity key, get service
    tickets (the CEPHX_GET_AUTH_SESSION_KEY request role).  One round
    trip: `proof` is an HMAC under the entity key over (entity, nonce,
    ts_ms, services); replay is harmless because the reply's session
    keys are sealed under the entity key."""

    tid: int
    entity: str
    services: list
    nonce: bytes
    ts_ms: int
    proof: bytes


@dataclass
class MAuthReply:
    tid: int
    result: int  # 0 ok, -13 EACCES
    # list of (service, ticket_blob, sealed_session_key, nonce)
    tickets: list = field(default_factory=list)
    ttl: float = 0.0


# --------------------------------------------------------- peering/recovery
@dataclass
class MPGQuery:
    """Primary -> peer: peering info request.  Carries the primary's
    log head/floor so an in-sync peer can answer LEAN (no O(objects)
    inventory walk — the log-based GetInfo/GetLog fast path)."""

    pgid: PgId
    epoch: int
    primary_last: int = -1   # primary's pglog last_version
    primary_floor: int = -1  # oldest version still in the primary's log
    force_full: bool = False  # demand a full inventory regardless


@dataclass
class MPGInfo:
    pgid: PgId
    from_osd: int
    shard: int
    objects: dict  # (name, shard) -> version  (empty when lean)
    tombstones: dict = field(default_factory=dict)  # name -> delete version
    last_complete: int = -1  # contiguity point of this peer's pglog
    lean: bool = False  # no inventory attached: delta-resync from my log
    # divergence-detection payload (PGLog.h:1344 merge inputs): the
    # epoch of the sender's newest entry, and (full infos only) the
    # version -> epoch map of its whole log tail window.  Two logs
    # holding the same version under different epochs forked; the
    # newer interval's entry is authoritative.
    head_epoch: int = 0
    log_evs: dict = field(default_factory=dict)  # version -> epoch
    # the sender's last_epoch_started fence: entries another log holds
    # beyond this sender's head with an epoch older than this fence
    # never committed (an interval went active without them) and must
    # be discarded, not adopted (find_best_info's les-first comparator)
    les: int = 0


@dataclass
class MPGPull:
    """Primary -> peer: send me these whole objects (I am behind)."""

    pgid: PgId
    names: list
    force: bool = False  # scrub repair: replace my same-version bad copy
    # (trace_id, span_id) of the requesting storm's root span: the
    # serving peer parents its pull-serve span under it, so a sampled
    # recovery storm's waterfall shows per-pull child spans
    # cross-daemon.  Appended with a default — old bytes decode
    # compatibly (generic codec skip-unknown-tail).
    trace: tuple = ()


@dataclass
class MPGPush:
    """Recovery payload: objects to apply, plus an optional log
    CHECKPOINT — set only when the primary has verified the peer needs
    nothing, letting it fast-path future peering rounds."""

    pgid: PgId
    shard: int
    objects: dict  # name -> (version, data bytes[, total_len])
    deletes: dict = field(default_factory=dict)  # name -> delete version
    force: bool = False  # scrub repair: overwrite same-version bad copies
    checkpoint: int = -1  # peer may advance last_complete to this
    # (trace_id, span_id) of the pushing storm's root span — the
    # receiving peer's apply work becomes a per-push child span of the
    # storm root (ROADMAP telemetry follow-on (b)).  Appended with a
    # default: old archived bytes decode compatibly.
    trace: tuple = ()


@dataclass
class MRecoveryReserve:
    """Backfill/recovery reservation handshake (MBackfillReserve /
    MRecoveryReserve role, src/messages/MBackfillReserve.h): the primary
    REQUESTs a remote-reserver slot from a recovery target before moving
    bulk data at it; the target GRANTs when its osd_max_backfills slots
    allow; the primary RELEASEs when the PG's recovery ops drain."""

    pgid: PgId
    from_osd: int
    action: str  # request | grant | release
    priority: int = 180


@dataclass
class MPGRollback:
    """Primary -> shard holder: your shard applied writes on `oid` past
    the version the stripe can decode at (< k shards committed them) —
    roll back to `to_version` using your pglog pre-images, or drop the
    shard object for rebuild (the EC rollback-generation role,
    doc/dev/osd_internals/erasure_coding/ecbackend.rst:10-27)."""

    pgid: PgId
    oid: str
    shard: int
    to_version: int
    # divergent-entry discard (PGLog._merge_divergent_entries role):
    # the entries past to_version belong to a dead interval and never
    # committed — drop objects lacking pre-images instead of keeping
    # them (the authority re-pushes its own content right after)
    divergent: bool = False
    # epoch of the surviving interval the discard was judged against:
    # entries past to_version stamped with an epoch >= this one belong
    # to a LATER interval than the fork and are committed — their
    # objects' content must be kept (only the phantom log entries
    # below them are removed).  <= 0: discard unconditionally.
    max_epoch: int = 0


# ----------------------------------------------------- mon quorum (Raft-lite)
@dataclass
class MMonPing:
    """Mon <-> mon liveness + role advertisement (the Elector's
    connectivity stream role).  Leader pings carry its COMMIT pointer
    in `version`; follower status pings carry the follower's ACCEPTED
    version (a cumulative accept-ack) with `lterm` = the pterm of its
    newest accepted entry, so the leader can verify the acked prefix
    matches its own log before counting the ack."""

    name: str
    term: int
    role: str   # leader | follower | electing
    version: int
    stamp: float
    lterm: int = 0


@dataclass
class MMonElect:
    """Candidate -> peers: I propose myself for `term` (Elector
    propose).  Voters compare (lterm, version, -rank) — the Raft
    §5.4.1 last-log comparator: term of the newest log entry first,
    then log length."""

    term: int
    version: int  # candidate's accepted (log-end) version
    rank: int
    name: str
    lterm: int = 0  # pterm of the candidate's newest log entry
    # quantized connectivity score (ConnectionTracker role): under the
    # "connectivity" election strategy, voters prefer candidates that
    # can actually SEE the cluster — a half-partitioned or flapping
    # mon defers to a better-connected one.  Default 0 = pessimistic:
    # a sender that never scored (older version, fresh boot) must not
    # outrank honest candidates on optimism
    connectivity: int = 0


@dataclass
class MMonVote:
    """Peer -> candidate: deferral/ack for `term` (Elector ack)."""

    term: int
    rank: int
    name: str
    version: int


@dataclass
class MMonClaim:
    """Winner -> peers: I am the leader for `term` (Elector victory)."""

    term: int
    version: int
    name: str


@dataclass
class MMonPropose:
    """Leader -> follower: ACCEPT one store entry (the Paxos begin
    phase).  The entry is durably accepted — NOT applied — by the
    follower; `commit` piggybacks the leader's commit pointer (the
    Paxos commit phase), advancing the follower's applied prefix.
    `pterm` is the term the entry was proposed under (a new leader
    re-proposes inherited entries restamped with its own term, so a
    deposed leader's divergent tail is detected by pterm mismatch and
    truncated — Raft's AppendEntries conflict rule)."""

    term: int
    version: int
    key: str
    value: bytes
    desc: str
    pterm: int = 0
    commit: int = 0


@dataclass
class MMonPropAck:
    """Follower -> leader: I have durably accepted every entry up to
    `version` (cumulative, so a lost ack is healed by the next).
    `pterm` is the pterm of the acker's entry AT `version`: the leader
    counts the ack only if that matches its own entry there (the
    prevLogTerm-style proof that the acked prefix is the same log, not
    a deposed leader's divergent tail of equal length)."""

    term: int
    version: int
    name: str
    pterm: int = 0


@dataclass
class MMonSyncReq:
    """Lagging mon -> leader: send me commits after `from_version`
    (MonitorDBStore sync role)."""

    from_version: int
    name: str


@dataclass
class MMonSyncEntries:
    term: int
    entries: list  # [(version, desc, key, value bytes)]
    # full-sync path for peers older than the leader's log window
    # (MonitorDBStore full sync role): adopt the snapshot, then entries
    snap_version: int = 0
    snap_kv: dict | None = None


@dataclass
class MMonForward:
    """Follower -> leader: a client/daemon message proxied to the
    quorum leader (Monitor forward_request role).  `frame` is a full
    wire frame (encode_frame) of the original message."""

    orig: str   # original sender entity (reply target)
    frame: bytes


@dataclass
class MMonFwdReply:
    """Leader -> forwarding follower: relay this reply frame to the
    original sender over your connection to them."""

    orig: str
    frame: bytes


# ------------------------------------------------------------ watch/notify
@dataclass
class MWatchNotify:
    """Primary -> watching client: a notify fired on an object you
    watch (src/osd/Watch.cc role)."""

    notify_id: int
    pool: int
    oid: str
    notifier: str
    payload: bytes = b""


@dataclass
class MNotifyAck:
    """Watching client -> primary: notify processed."""

    notify_id: int
    watcher: str


@dataclass
class MLeaseRegister:
    """Balanced-read holder -> PG primary: I granted `client` a read
    lease on this object, expiring at `expires` (wall-clock).  The
    primary is the ordering point for writes, so it must know every
    outstanding grant to fan "_lease" revokes on mutation; fire and
    forget — a lost register is bounded by the lease TTL safety net."""

    pgid: PgId
    oid: str
    client: str
    expires: float


# ------------------------------------------------------------- mgr stats
@dataclass
class MStatsReport:
    """Daemon -> monitor: periodic usage/perf summary (the MMgrReport /
    PGStats flow feeding `ceph status` and exporters).

    Two telemetry increments piggyback inside ``stats``, both shipped
    at-least-once (re-sent every report for osd_event_resend_s, the
    mon dedupes by per-daemon sequence):

    - ``events``: the journal window (utils/event_log) — PG/recovery/
      scrub/batch narrative plus the flight recorder's ``slow_op``
      complaints, merged into the mon's paxos-journaled cluster log;
    - ``metrics``: the metrics-history window
      (utils/metrics_history) — {registry: [snapshot, ...]} rings the
      mon merges into the store behind dump_metrics_history /
      metrics_query."""

    osd_id: int
    epoch: int
    stats: dict  # {"pgs", "objects", "bytes", "op_w", "op_r", ...}


# ------------------------------------------------------------------ scrub
@dataclass
class MScrubRequest:
    """Client/operator -> primary: scrub this PG (shallow or deep)."""

    tid: int
    client: str
    pgid: PgId
    deep: bool = False
    repair: bool = False


@dataclass
class MScrubShard:
    """Primary -> shard member: send me your scrub map for this PG.

    Carries its QoS class so the member's dispatcher queues the map
    generation under the scrub mclock reservation (a message-carried
    ``klass`` wins over the static per-type table)."""

    tid: int
    pgid: PgId
    deep: bool
    klass: str = "scrub"


@dataclass
class MScrubMap:
    """Shard member -> primary: per-object metadata (+ digests if deep)."""

    tid: int
    pgid: PgId
    from_osd: int
    objects: dict  # (name, shard) -> {size, version[, digest]}


@dataclass
class MScrubResult:
    tid: int
    pgid: PgId
    result: int
    inconsistencies: list
    repaired: int = 0


# ------------------------------------------------------------ wire helpers
_WIRE_TYPES: dict[int, type] = {1: MOSDOp, 2: MOSDOpReply}
_WIRE_IDS = {t: i for i, t in _WIRE_TYPES.items()}


def encode_message(msg) -> bytes:
    """Frame an Encodable message for a wire transport."""
    e = Encoder()
    e.u16(_WIRE_IDS[type(msg)])
    msg.encode(e)
    return e.tobytes()


def decode_message(data: bytes):
    d = Decoder(data)
    t = _WIRE_TYPES[d.u16()]
    return t.decode(d)
