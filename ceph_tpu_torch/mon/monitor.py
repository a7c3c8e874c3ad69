"""Monitor: the control plane's source of cluster-map truth.

The capability of the reference's Monitor + PaxosService stack
(src/mon/Monitor.cc command dispatch, OSDMonitor map mutations incl.
prepare_failure :3393 with reporter thresholds and adaptive grace
:3261-3266, pool create -> EC profile -> plugin factory :1977,
MonitorDBStore versioned persistence MonitorDBStore.h:44, Paxos
replication Paxos.cc, Elector.cc leader election, forwarded requests):

- every map mutation is a versioned commit in a MonStore (the Paxos
  log's shape); `DurableMonStore` persists commits through a crc-framed
  fsync'd append-only log (the FileStore WAL framing) so a restarted
  monitor resumes with every pool/epoch intact;
- multiple monitors form a quorum with MAJORITY-ACK commit (the
  Paxos.cc collect/accept/commit shape, Raft-flavored): the Elector
  picks the leader by most-complete ACCEPTED log (ties to lowest
  rank), the leader durably accepts each mutation locally and
  proposes it; followers durably accept and ack; the entry commits —
  becomes visible to subscribers and releases gated client replies —
  only once a majority has accepted it.  A new leader re-stamps and
  re-proposes the inherited accepted tail (higher-ballot re-propose),
  divergent tails from deposed leaders are truncated by proposed-term
  mismatch, a minority-partitioned leader steps down after its lease,
  and lagging peers catch up via entry/snapshot sync.  No committed
  epoch can be lost or forked across any surviving majority;
- failure detection: reporter-count thresholds + report-window span +
  uptime-adaptive grace, as before (leader-local soft state).

The port's copy differs from ``ceph_tpu/mon/monitor.py`` in one place:
``osd pool create`` checks an EC profile with a codec built on the host
(``host_check_profile``), whatever backend and device the profile names;
the pool keeps the caller's profile.
"""

from __future__ import annotations

import collections
import hmac as _hmac
import json
import os
import queue
import struct
import threading
import time

from .. import ec
from ..auth.caps import CapsError
from ..auth.cephx import (ServiceVerifier, canonical_command as
                          _canonical_cmd, op_proof)
from ..msg.messages import (MAuth, MAuthReply, MFailureReport, MMapPush,
                            MMonClaim, MMonCommand, MMonCommandReply,
                            MMonElect, MMonForward, MMonFwdReply, MMonPing,
                            MMonPropAck, MMonPropose, MMonSubscribe,
                            MMonSyncEntries, MMonSyncReq, MMonVote,
                            MOSDBoot, MOSDPGTemp, MStatsReport)
from ..msg.messenger import Dispatcher, Messenger, Network, Policy
from ..msg.wire import decode_frame, encode_frame
from ..ops import native
from ..utils.config import Config, default_config
from ..utils.event_log import ClusterLog, make_event
from ..utils.log import dout
from ..utils.metrics_history import MetricsHistoryStore
from .maps import OSDMap, PoolSpec
from .mgr import ProgressTracker

_FORWARDED = (MOSDBoot, MMonCommand, MFailureReport, MStatsReport,
              MOSDPGTemp)


def host_check_profile(profile: dict) -> dict:
    """The plugin profile ``osd pool create`` builds its check codec
    from: the caller's profile less ``plugin`` and ``device``, with
    ``backend`` set to ``auto`` (``native``, or ``numpy`` without the
    native library), so the check runs on the host."""
    out = {k: v for k, v in profile.items()
           if k not in ("plugin", "backend", "device")}
    out["backend"] = "auto"
    return out


class MonStore:
    """Versioned commit log + latest-state KV (MonitorDBStore's shape),
    plus an ACCEPTED tail — entries durably accepted but not yet known
    majority-committed (the Paxos accepted-proposal state,
    src/mon/Paxos.cc collect/accept vs commit).  The committed log
    keeps a bounded TAIL window (paxos-trim role): lagging peers within
    the window sync by entries, older ones by snapshot."""

    LOG_KEEP = 256

    def __init__(self):
        self.version = 0
        self.log: list[tuple[int, str, str, bytes]] = []
        self.kv: dict[str, bytes] = {}
        # accepted-but-uncommitted tail: (version, pterm, desc, key, value)
        self.accepted: list[tuple[int, int, str, str, bytes]] = []
        # election-safety state that must survive a crash: the term of
        # the newest log entry (Raft's lastLogTerm half of the voting
        # comparator), the current term, and who we voted for in it (a
        # restarted mon must never vote twice in one term — that is how
        # two leaders happen)
        self.last_term = 0
        self.cur_term = 0
        self.voted_for = ""

    # -- committed prefix --------------------------------------------------
    def commit(self, key: str, value: bytes, desc: str) -> int:
        return self.commit_at(self.version + 1, key, value, desc)

    def commit_at(self, version: int, key: str, value: bytes,
                  desc: str) -> int:
        """Apply a replicated commit at an exact version (follower
        path); versions must be gapless and in order."""
        if version != self.version + 1:
            raise ValueError(f"commit v{version} onto v{self.version}")
        if self.accepted and self.accepted[0][0] == version:
            # the commit supersedes (or confirms) the accepted head; a
            # CONTENT mismatch means the rest of the tail chains off a
            # deposed leader's divergent history — discard it all
            ent = self.accepted.pop(0)
            if ent[3] != key or ent[4] != value:
                self.accepted = []
        self.version = version
        self.log.append((version, desc, key, value))
        self.kv[key] = value
        if len(self.log) > 2 * self.LOG_KEEP:
            self._trim()
        return version

    def _trim(self) -> None:
        self.log = self.log[-self.LOG_KEEP:]

    def oldest_logged(self) -> int:
        """Lowest version still in the tail window (0 = everything)."""
        return self.log[0][0] if self.log else self.version + 1

    def entries_after(self, version: int) -> list:
        return [e for e in self.log if e[0] > version]

    def reset_to(self, version: int, kv: dict) -> None:
        """Adopt a leader snapshot (MonitorDBStore full-sync role)."""
        self.version = version
        self.kv = dict(kv)
        self.log = []
        self.accepted = []

    # -- accepted tail (quorum replication) --------------------------------
    @property
    def accepted_version(self) -> int:
        """Highest version this store has durably accepted (>= committed
        version; the log-completeness score for elections)."""
        return self.accepted[-1][0] if self.accepted else self.version

    def accept_at(self, version: int, pterm: int, key: str, value: bytes,
                  desc: str) -> None:
        """Durably stage an entry (Paxos accept).  Gapless on top of
        the accepted tail."""
        if version != self.accepted_version + 1:
            raise ValueError(
                f"accept v{version} onto v{self.accepted_version}")
        self.accepted.append((version, pterm, desc, key, value))
        self.last_term = max(self.last_term, pterm)

    def entry_pterm(self, version: int) -> int | None:
        """pterm of the accepted entry at `version`, None if absent."""
        for e in self.accepted:
            if e[0] == version:
                return e[1]
        return None

    def set_term(self, term: int, voted_for: str) -> None:
        """Record the current term + vote (durably in the subclass)."""
        self.cur_term = term
        self.voted_for = voted_for

    def note_term(self, term: int) -> None:
        """Adopting entries from a leader at `term` (sync path) makes
        our log as recent as that term for election purposes."""
        self.last_term = max(self.last_term, term)

    def truncate_accepted(self, from_version: int) -> bool:
        """Drop accepted entries >= from_version (a deposed leader's
        divergent tail being overwritten).  True if anything dropped."""
        keep = [e for e in self.accepted if e[0] < from_version]
        dropped = len(keep) != len(self.accepted)
        self.accepted = keep
        return dropped

    def restamp_accepted(self, pterm: int) -> None:
        """New leader: re-stamp inherited entries with its own term
        before re-proposing them (the Paxos higher-ballot re-propose),
        so acks gathered at the new term commit them safely."""
        self.accepted = [(v, pterm, d, k, val)
                         for (v, _t, d, k, val) in self.accepted]
        if self.accepted:
            self.last_term = max(self.last_term, pterm)

    def commit_accepted_upto(self, upto: int,
                             pterm: int | None = None) -> list:
        """Commit the consecutive accepted prefix with version <= upto
        (and, when given, pterm == pterm — entries accepted under an
        older term must be re-proposed by the current leader before they
        may commit, never committed by a stale pointer).  Returns the
        committed (version, desc, key, value) entries."""
        out = []
        while self.accepted and self.accepted[0][0] <= upto and \
                (pterm is None or self.accepted[0][1] == pterm):
            v, _t, d, k, val = self.accepted[0]
            # base-class apply on purpose: the durable subclass journals
            # the commit POINT, not a second copy of the payload
            MonStore.commit_at(self, v, k, val, d)
            out.append((v, d, k, val))
        return out

    def close(self) -> None:
        pass


# durable record kinds
_REC_COMMIT, _REC_SNAPSHOT = 1, 2
_REC_ACCEPT, _REC_CUPTO, _REC_TRUNC, _REC_RESTAMP, _REC_TERM = 3, 4, 5, 6, 7


class DurableMonStore(MonStore):
    """MonStore persisted via the crc-framed WAL contract of FileStore:
    [u32 len][u32 crc32c][payload], fsync'd per commit; a torn tail is
    discarded on load, so restart resumes the committed prefix.  The
    file is compacted to a snapshot + tail when the log window trims, so
    neither the file nor restart replay grows with cluster age."""

    def __init__(self, path: str):
        super().__init__()
        os.makedirs(path, exist_ok=True)
        self._path = os.path.join(path, "monstore.bin")
        self._file = None
        self._load()
        self._file = open(self._path, "ab")

    # -- framing -----------------------------------------------------------
    @staticmethod
    def _frame(payload: bytes) -> bytes:
        return struct.pack("<II", len(payload),
                           native.crc32c(payload)) + payload

    def _load(self) -> None:
        if not os.path.exists(self._path):
            return
        with open(self._path, "rb") as f:
            raw = f.read()
        pos = 0
        while pos + 8 <= len(raw):
            length, crc = struct.unpack_from("<II", raw, pos)
            payload = raw[pos + 8: pos + 8 + length]
            if len(payload) < length or native.crc32c(payload) != crc:
                break  # torn tail: the crash cut this record short
            self._apply_payload(payload)
            pos += 8 + length
        if pos < len(raw):
            with open(self._path, "r+b") as f:
                f.truncate(pos)

    def _apply_payload(self, payload: bytes) -> None:
        from ..utils.codec import Decoder
        d = Decoder(payload)
        kind = d.u8()
        if kind == _REC_COMMIT:
            version, desc, key, value = d.u64(), d.string(), d.string(), \
                d.blob()
            MonStore.commit_at(self, version, key, value, desc)
        elif kind == _REC_SNAPSHOT:
            version = d.u64()
            kv = {d.string(): d.blob() for _ in range(d.u32())}
            MonStore.reset_to(self, version, kv)
            if d.remaining():
                # election-state tail (added later): a store compacted
                # by the pre-change code ends here — default, don't crash
                self.last_term = d.u64()
                self.cur_term = d.u64()
                self.voted_for = d.string()
        elif kind == _REC_ACCEPT:
            version, pterm = d.u64(), d.u64()
            desc, key, value = d.string(), d.string(), d.blob()
            MonStore.accept_at(self, version, pterm, key, value, desc)
        elif kind == _REC_CUPTO:
            MonStore.commit_accepted_upto(self, d.u64())
        elif kind == _REC_TRUNC:
            MonStore.truncate_accepted(self, d.u64())
        elif kind == _REC_RESTAMP:
            MonStore.restamp_accepted(self, d.u64())
        elif kind == _REC_TERM:
            self.cur_term = d.u64()
            self.voted_for = d.string()
            self.last_term = d.u64()

    @staticmethod
    def _commit_payload(version, key, value, desc) -> bytes:
        from ..utils.codec import Encoder
        e = Encoder()
        e.u8(_REC_COMMIT)
        e.u64(version)
        e.string(desc)
        e.string(key)
        e.blob(value)
        return e.tobytes()

    def _append(self, payload: bytes) -> None:
        self._file.write(self._frame(payload))
        self._file.flush()
        os.fsync(self._file.fileno())

    def commit_at(self, version: int, key: str, value: bytes,
                  desc: str) -> int:
        before = len(self.log)
        v = super().commit_at(version, key, value, desc)
        self._append(self._commit_payload(version, key, value, desc))
        if len(self.log) < before:  # window trimmed: compact the file
            self._compact()
        return v

    def reset_to(self, version: int, kv: dict) -> None:
        super().reset_to(version, kv)
        self._compact()

    # -- accepted tail: each transition is one fsync'd record --------------
    def accept_at(self, version: int, pterm: int, key: str, value: bytes,
                  desc: str) -> None:
        """The durable accept IS this monitor's Paxos promise — it must
        hit disk before the ack leaves (Paxos.cc handle_begin journals
        before sending accept)."""
        from ..utils.codec import Encoder
        super().accept_at(version, pterm, key, value, desc)
        e = Encoder()
        e.u8(_REC_ACCEPT)
        e.u64(version)
        e.u64(pterm)
        e.string(desc)
        e.string(key)
        e.blob(value)
        self._append(e.tobytes())

    def commit_accepted_upto(self, upto: int,
                             pterm: int | None = None) -> list:
        """Journals only the commit POINT — the payload is already in
        the accept record, so commit costs O(1) bytes, not a second
        copy of the map."""
        from ..utils.codec import Encoder
        before = len(self.log)
        out = super().commit_accepted_upto(upto, pterm)
        if out:
            e = Encoder()
            e.u8(_REC_CUPTO)
            e.u64(out[-1][0])
            self._append(e.tobytes())
            if len(self.log) < before:
                self._compact()
        return out

    def truncate_accepted(self, from_version: int) -> bool:
        from ..utils.codec import Encoder
        dropped = super().truncate_accepted(from_version)
        if dropped:
            e = Encoder()
            e.u8(_REC_TRUNC)
            e.u64(from_version)
            self._append(e.tobytes())
        return dropped

    def restamp_accepted(self, pterm: int) -> None:
        from ..utils.codec import Encoder
        super().restamp_accepted(pterm)
        if self.accepted:
            e = Encoder()
            e.u8(_REC_RESTAMP)
            e.u64(pterm)
            self._append(e.tobytes())

    def _persist_term(self) -> None:
        from ..utils.codec import Encoder
        e = Encoder()
        e.u8(_REC_TERM)
        e.u64(self.cur_term)
        e.string(self.voted_for)
        e.u64(self.last_term)
        self._append(e.tobytes())

    def set_term(self, term: int, voted_for: str) -> None:
        """The durable vote IS the promise: it must hit disk before the
        vote message leaves, or a restarted mon can vote twice in one
        term and elect two leaders."""
        super().set_term(term, voted_for)
        self._persist_term()

    def note_term(self, term: int) -> None:
        if term > self.last_term:
            super().note_term(term)
            self._persist_term()

    def _compact(self) -> None:
        """Rewrite the file as one snapshot of the CURRENT (version, kv)
        plus the accepted tail, atomically (tmp+rename).  The in-memory
        tail window still serves peer entry-sync; restart replay is
        O(kv), not O(history)."""
        from ..utils.codec import Encoder
        e = Encoder()
        e.u8(_REC_SNAPSHOT)
        e.u64(self.version)
        e.u32(len(self.kv))
        for k in sorted(self.kv):
            e.string(k)
            e.blob(self.kv[k])
        e.u64(self.last_term)
        e.u64(self.cur_term)
        e.string(self.voted_for)
        tmp = self._path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self._frame(e.tobytes()))
            for version, pterm, desc, key, value in self.accepted:
                a = Encoder()
                a.u8(_REC_ACCEPT)
                a.u64(version)
                a.u64(pterm)
                a.string(desc)
                a.string(key)
                a.blob(value)
                f.write(self._frame(a.tobytes()))
            f.flush()
            os.fsync(f.fileno())
        if self._file:
            self._file.close()
        os.replace(tmp, self._path)
        self._file = open(self._path, "ab")

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


class _RelayConn:
    """Reply path for a forwarded request: the leader answers through
    the follower that proxied it (Monitor forward_request reply flow)."""

    def __init__(self, mon: "MonitorLite", forwarder: str, orig: str):
        self._mon = mon
        self._forwarder = forwarder
        self.peer = orig

    def send(self, msg) -> bool:
        frame = encode_frame(self._mon.name, self.peer, msg)
        return self._mon.messenger.send_message(
            self._forwarder, MMonFwdReply(self.peer, frame))


class MonitorLite(Dispatcher):
    def __init__(self, network: Network, name: str = "mon.0",
                 cfg: Config | None = None,
                 peers: tuple | list = (), path: str | None = None,
                 key_server=None):
        self.name = name
        self.cfg = cfg or default_config()
        self.peers = [p for p in peers if p != name]
        self._rank = int(name.rsplit(".", 1)[1]) if "." in name else 0
        self.messenger = Messenger(network, name,
                                   Policy.stateless_server(),
                                   workers=self.cfg["ms_dispatch_workers"])
        self.messenger.add_dispatcher(self)
        self.store: MonStore = DurableMonStore(path) if path else MonStore()
        self.osdmap = OSDMap()
        if self.store.kv.get("osdmap"):
            self.osdmap = OSDMap.decode_bytes(self.store.kv["osdmap"])
        # AuthMonitor role: per-entity keys + caps, replicated through
        # the paxos store under "authdb"; None = authorization off.
        # The durable kv wins over the constructor seed — entities
        # added by `auth` commands must survive a mon restart.
        self.key_server = key_server
        self._mon_verifier = None
        if key_server is not None:
            if self.store.kv.get("authdb"):
                key_server.load_db(self.store.kv["authdb"])
            self._mon_verifier = ServiceVerifier(
                "mon", key_server.service_secrets["mon"],
                key_server.rotation, key_server.clock)
        self._subscribers: set[str] = set()
        # incremental distribution: snapshot of the map as of the last
        # commit (diff base) + a ring of recent incrementals keyed by
        # their base epoch, for subscriber catch-up chains
        self._prev_map: OSDMap | None = None
        self._inc_ring: dict[int, tuple[int, bytes]] = {}
        # failure accounting: target -> reporter -> (first, last) stamps
        self._failure_reports: dict[int, dict[int, tuple[float, float]]] = {}
        self._boot_times: dict[int, float] = {}
        self._lock = threading.RLock()
        self._osd_stats: dict[int, dict] = {}
        # cluster event journal (LogMonitor role): daemon journals ride
        # the stats reports and merge here; the mon adds its own map /
        # lifecycle / health-transition events.  Served by the
        # `dump_cluster_log` verb, tailed by tools/event_tool.py.
        # Journaled through the paxos store (key "clusterlog",
        # debounced by mon_clog_persist_interval_s) so the log — and
        # the slow_op flight-recorder events in it — survives a mon
        # restart (LogMonitor parity).
        self.cluster_log = ClusterLog(
            keep=self.cfg["mon_cluster_log_size"])
        if self.store.kv.get("clusterlog"):
            try:
                self.cluster_log.restore(
                    json.loads(self.store.kv["clusterlog"].decode()))
            except (ValueError, UnicodeDecodeError):
                pass  # corrupt snapshot: start the ring fresh
        self._clog_persisted_seq = self.cluster_log.last_seq
        self._clog_persisted_at = 0.0
        # mon-side merged metrics history (utils/metrics_history.py):
        # per-daemon registry snapshots ride the stats reports and
        # merge here, served by dump_metrics_history / metrics_query
        # and the perf_history CLI; staleness feeds the exporter gauge
        self.metrics_history = MetricsHistoryStore(
            keep=self.cfg["mon_metrics_history_keep"],
            downsample_age=self.cfg["metrics_history_downsample_age"])
        # dynamic perf queries (telemetry/perf_query): per-daemon
        # cumulative snapshots ride the stats reports and merge here
        # (newest-seq-wins), served by `perf query report` and
        # tools/top_tool.py; a pgid-keyed standing query additionally
        # persists per-PG load vectors into the metrics-history store
        # (registry "pg_load") for the balancer to sense
        from ..telemetry.perf_query import PerfQueryStore
        self.perf_queries = PerfQueryStore()
        self._pg_load_seq = 0
        self._pg_load_persisted_at = 0.0
        # batch-thrash health feed: (merge-monotonic ts, daemon) per
        # `batch` channel event while the check is ENABLED (nothing
        # accumulates at the count=0 default), pruned to the warn
        # window on every health evaluation; maxlen backstops a
        # misconfigured window so the feed can never grow unbounded
        self._batch_events: collections.deque = collections.deque(
            maxlen=4096)
        # progress items derived from the recovery event channel (the
        # mgr progress module's engine lives monitor-side so the
        # exporter and `status` see it without a running MgrDaemon)
        self.progress = ProgressTracker(
            linger=self.cfg["mgr_progress_linger"])
        self._last_health: dict[str, str] = {}  # check -> severity
        # externally-registered health checks (mgr modules — the slo
        # module's SLO_BURN lands here): name -> check dict, merged
        # into _health_checks so raise/clear transitions journal
        # through the same mux as the built-ins
        self._ext_health: dict[str, dict] = {}
        # per-daemon clock-skew estimate from stats-report send stamps
        # (receive_time - sent_at; includes the one-way wire delay,
        # fine for waterfall alignment at ms granularity)
        self._clock_skew: dict[str, float] = {}
        # per-daemon highest journal lseq merged: daemons RE-SHIP their
        # pending window with every report (silent wire drops make a
        # delivery signal untrustworthy), so the log dedupes here
        self._event_lseq: dict[int, int] = {}
        # quorum state (single mon = permanent leader, zero overhead).
        # term + vote resume from the durable store: a restarted mon
        # must not vote twice in a term it already voted in
        self._term = self.store.cur_term
        self._role = "leader" if not self.peers else "electing"
        self._leader: str | None = name if not self.peers else None
        self._votes: set[str] = set()
        self._voted: tuple[int, str] | None = (
            (self.store.cur_term, self.store.voted_for)
            if self.store.voted_for else None)
        self._election_at = 0.0
        self._leader_seen = time.monotonic()
        # majority-ack commit state (leader-side): version -> acker
        # names; a proposal becomes a commit only when a majority has
        # durably accepted it (Paxos.cc accept/commit split)
        self._pending_acks: dict[int, set[str]] = {}
        # version -> (base_epoch, inc_bytes, raw) stashed at propose
        # time, published to subscribers at commit time
        self._pending_inc: dict[int, tuple] = {}
        # version -> [(conn, reply)] client replies gated on commit: a
        # client must never see success for a mutation that can still
        # be rolled back by a leader change
        self._reply_on_commit: dict[int, list] = {}
        self._peer_seen: dict[str, float] = {}
        # connectivity scores (the ConnectionTracker role,
        # src/mon/ConnectionTracker.h): EWMA of each peer link's
        # liveness, sampled every quorum tick; my own candidacy
        # advertises the MEAN — a flapping or half-partitioned mon
        # scores low and defers to better-connected candidates under
        # the "connectivity" election strategy
        self._conn_scores: dict[str, float] = {}
        self._link_seen: dict[str, float] = {}  # tracker input (any term)
        self._became_leader = 0.0
        self._stop = threading.Event()
        # per-destination sender lanes: a blocking connect to one dead
        # peer must not head-of-line-block pings/proposals to the others
        self._outqs: dict[str, queue.Queue] = {}
        self._outq_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._handlers = {
            MOSDBoot: self._handle_boot,
            MMonSubscribe: self._handle_subscribe,
            MFailureReport: self._handle_failure,
            MMonCommand: self._handle_command,
            MStatsReport: self._handle_stats,
            MOSDPGTemp: self._handle_pg_temp,
            MMonPing: self._handle_mon_ping,
            MMonElect: self._handle_elect,
            MMonVote: self._handle_vote,
            MMonClaim: self._handle_claim,
            MMonPropose: self._handle_propose,
            MMonPropAck: self._handle_propack,
            MMonSyncReq: self._handle_sync_req,
            MMonSyncEntries: self._handle_sync_entries,
            MMonForward: self._handle_forward,
            MMonFwdReply: self._handle_fwd_reply,
            MAuth: self._handle_auth,
        }

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self.messenger.start()
        if self.peers:
            t = threading.Thread(target=self._quorum_loop,
                                 name=f"{self.name}-quorum", daemon=True)
            t.start()
            self._threads.append(t)
            self._start_election()

    def stop(self) -> None:
        self._stop.set()
        with self._outq_lock:
            for q in self._outqs.values():
                q.put(None)
        self.messenger.shutdown()
        # flush the cluster log through the store before it closes: a
        # clean shutdown must not lose mon-side events journaled since
        # the last debounced persist (crash windows stay bounded by
        # the stats-report cadence)
        try:
            with self._lock:
                self._maybe_persist_clog(force=True)
        except Exception:  # noqa: BLE001 - closing store never blocks stop
            pass
        self.store.close()

    @property
    def is_leader(self) -> bool:
        return self._role == "leader"

    # ------------------------------------------------- ordered async sends
    def _sender_loop(self, dst: str, q: queue.Queue) -> None:
        """Per-destination ordered sender: a wire transport's blocking
        connect to a dead peer must never stall commits NOR delay pings
        and proposals to healthy peers (the lanes keep per-peer FIFO so
        proposal versions arrive in order)."""
        while True:
            msg = q.get()
            if msg is None or self._stop.is_set():
                return
            try:
                self.messenger.send_message(dst, msg)
            except Exception as e:  # noqa: BLE001
                dout("mon", 5)("send to %s failed: %r", dst, e)

    def _post(self, dst: str, msg) -> None:
        with self._outq_lock:
            q = self._outqs.get(dst)
            if q is None:
                q = queue.Queue()
                self._outqs[dst] = q
                t = threading.Thread(target=self._sender_loop,
                                     args=(dst, q),
                                     name=f"{self.name}-tx-{dst}",
                                     daemon=True)
                t.start()
                self._threads.append(t)
        q.put(msg)

    # ------------------------------------------------------------- dispatch
    def ms_dispatch(self, conn, msg) -> bool:
        handler = self._handlers.get(type(msg))
        if handler is None:
            return False
        if isinstance(msg, _FORWARDED) and not self.is_leader:
            self._forward_to_leader(conn, msg)
            return True
        handler(conn, msg)
        return True

    def _forward_to_leader(self, conn, msg) -> None:
        """Follower: proxy a client/daemon request to the quorum leader
        (Monitor::forward_request role)."""
        if isinstance(msg, MOSDBoot):
            # the follower may push maps to this daemon later: learn its
            # address regardless of who leads
            self.messenger.network.set_addr(f"osd.{msg.osd_id}", msg.addr)
        leader = self._leader
        if leader is None:
            if isinstance(msg, MMonCommand):
                conn.send(MMonCommandReply(msg.tid, -11,
                                           {"error": "no quorum"}))
            return  # boots/reports retry via beacons
        frame = encode_frame(conn.peer, leader, msg)
        self._post(leader, MMonForward(conn.peer, frame))

    def _handle_forward(self, conn, m: MMonForward) -> None:
        if not self.is_leader:
            return  # stale leadership view; sender will retry
        src, _dst, inner = decode_frame(m.frame[4:])
        handler = self._handlers.get(type(inner))
        if handler is not None:
            handler(_RelayConn(self, conn.peer, m.orig), inner)

    def _handle_fwd_reply(self, conn, m: MMonFwdReply) -> None:
        _src, _dst, inner = decode_frame(m.frame[4:])
        self.messenger.send_message(m.orig, inner)

    # ------------------------------------------------------- quorum engine
    def _score(self) -> tuple:
        """Most-complete log wins; ties to the lowest rank
        (ElectionLogic).  (last entry's term, ACCEPTED version) — the
        Raft §5.4.1 comparator: any majority-committed entry is
        accepted on at least one member of every majority, and term-
        before-length stops a long divergent stale-term tail from
        beating newer committed history."""
        return self._make_score(self.store.last_term,
                                self.store.accepted_version,
                                self._connectivity_bucket(),
                                self._rank)

    def _make_score(self, lterm: int, version: int, connectivity: int,
                    rank: int) -> tuple:
        """The vote comparator, ONE shape for self-score and candidate
        alike.  Connectivity ranks BELOW log completeness: the Raft
        §5.4.1 safety argument (a majority-committed entry lives on
        some member of every majority, so the most complete log must
        win) cannot be traded for link quality — the score only breaks
        ties between equally complete candidates, which is where a
        flapping mon loses."""
        if self.cfg["mon_election_strategy"] == "connectivity":
            return (lterm, version, connectivity, -rank)
        return (lterm, version, -rank)

    def _connectivity(self) -> float:
        if not self.peers:
            return 1.0
        return sum(self._conn_scores.get(p, 0.0)
                   for p in self.peers) / len(self.peers)

    def _connectivity_bucket(self) -> int:
        """Quantized (tenths) so hair-width score differences don't
        destabilize elections (the strategy's half-epsilon rule)."""
        return int(round(self._connectivity() * 10))

    def _majority(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    def _quorum_loop(self) -> None:
        interval = self.cfg["osd_heartbeat_interval"]
        lease = 2 * self.cfg["osd_heartbeat_grace"]
        while not self._stop.wait(interval):
            now = time.monotonic()
            with self._lock:
                for p in self.peers:
                    seen = self._link_seen.get(p)
                    alive = 1.0 if (seen is not None
                                    and now - seen < lease) else 0.0
                    # unknown links start PESSIMISTIC: a freshly booted
                    # or rejoining mon must not outrank incumbents on
                    # optimism — it earns its score by observing pings
                    cur = self._conn_scores.get(p, 0.0)
                    self._conn_scores[p] = 0.9 * cur + 0.1 * alive
                role = self._role
                if role == "leader" and self.peers:
                    # a partitioned minority leader must stop serving:
                    # it can neither commit nor prove its maps aren't
                    # stale (Paxos lease expiry -> bootstrap)
                    alive = 1 + sum(1 for t in self._peer_seen.values()
                                    if now - t < lease)
                    if alive < self._majority() and \
                            now - self._became_leader > lease:
                        dout("mon", 1)("%s: lost quorum contact, "
                                       "stepping down", self.name)
                        self._demote(to_role="electing")
                        role = "electing"
            if role == "leader":
                ping = MMonPing(self.name, self._term, "leader",
                                self.store.version, time.time())
                for p in self.peers:
                    self._post(p, ping)
            elif role == "follower":
                # status ping to EVERY peer: the leader consumes the
                # accept-ack, everyone samples the link for the
                # connectivity tracker
                acc = self.store.accepted
                ping = MMonPing(self.name, self._term, "follower",
                                self.store.accepted_version,
                                time.time(),
                                lterm=(acc[-1][1] if acc
                                       else self.store.last_term))
                for p in self.peers:
                    self._post(p, ping)
                if now - self._leader_seen > lease:
                    dout("mon", 1)("%s: leader lease expired", self.name)
                    self._start_election()
            elif role == "electing":
                # rank-staggered retry so colliding candidacies settle
                if now - self._election_at > 0.4 + 0.1 * self._rank:
                    self._start_election()

    def _demote(self, to_role: str = "follower") -> None:
        """Leave leadership: fail commit-gated replies (the client
        retries against the new leader) and drop leader-only state.
        The accepted tail STAYS — entries a majority accepted will be
        re-proposed and committed by the next leader.  Caller holds
        _lock."""
        self._role = to_role
        if to_role != "leader":
            self._leader = None
        fails = []
        for waiters in self._reply_on_commit.values():
            for conn, reply in waiters:
                reply.result = -11  # EAGAIN: retry at new leader
                reply.data = {"error": "leadership lost mid-commit"}
                fails.append((conn, reply))
        self._send_replies(fails)
        self._reply_on_commit.clear()
        self._pending_acks.clear()
        self._pending_inc.clear()
        self._peer_seen.clear()
        # the working map may expose an epoch that never committed —
        # drop back to committed state; if the tail commits after all,
        # _commit_from_leader re-applies it
        self._rollback_visible_map()

    def _start_election(self) -> None:
        with self._lock:
            if not self.peers:
                return
            if self._role == "leader":
                self._demote(to_role="electing")
            self._term += 1
            self._role = "electing"
            self._leader = None
            self._votes = {self.name}
            self._voted = (self._term, self.name)  # my vote is spent
            self.store.set_term(self._term, self.name)  # durable FIRST
            self._election_at = time.monotonic()
            term, version = self._term, self.store.accepted_version
            lterm = self.store.last_term
        dout("mon", 3)("%s: election term %d (v%d)", self.name, term,
                       version)
        conn_b = self._connectivity_bucket()
        for p in self.peers:
            self._post(p, MMonElect(term, version, self._rank, self.name,
                                    lterm=lterm, connectivity=conn_b))

    def _handle_elect(self, conn, m: MMonElect) -> None:
        with self._lock:
            if m.term < self._term:
                return
            if m.term > self._term:
                self._term = m.term
                self._votes = set()
                self.store.set_term(m.term, "")  # durable term adoption
                if self._role == "leader":
                    self._demote(to_role="electing")
            cand = self._make_score(m.lterm, m.version,
                                    m.connectivity, m.rank)
            if cand >= self._score():
                # at most ONE vote per term (the Raft votedFor rule —
                # without it two candidates can both reach majority in
                # the same term and split-brain)
                if self._voted and self._voted[0] == m.term \
                        and self._voted[1] != m.name:
                    return
                # defer to a better (or equally-good, lower-rank)
                # candidate
                if self._role == "leader":
                    self._demote()
                self._voted = (m.term, m.name)
                self.store.set_term(m.term, m.name)  # durable BEFORE send
                self._leader_seen = time.monotonic()
                self._post(m.name, MMonVote(m.term, self._rank, self.name,
                                            self.store.accepted_version))
                return
        # I am strictly better: counter-candidacy at a higher term
        self._start_election()

    def _handle_vote(self, conn, m: MMonVote) -> None:
        claim = False
        with self._lock:
            self._peer_seen[m.name] = time.monotonic()
            if m.term != self._term or self._role != "electing":
                return
            self._votes.add(m.name)
            if len(self._votes) >= self._majority():
                self._role = "leader"
                self._leader = self.name
                self._became_leader = time.monotonic()
                self._peer_seen = {}
                # inherit the accepted tail: re-stamp with my term and
                # re-propose, so majority-accepted-but-uncommitted
                # entries from the old leader finish committing (the
                # Paxos collect->begin-with-higher-ballot phase; Raft's
                # leader-completes-uncommitted-entries rule)
                self.store.restamp_accepted(self._term)
                self._pending_acks = {e[0]: {self.name}
                                      for e in self.store.accepted}
                self._pending_inc.clear()
                self._inc_ring.clear()
                # leader's working map = newest accepted state, so the
                # epoch chain continues from the inherited tail
                for e in reversed(self.store.accepted):
                    if e[3] == "osdmap":
                        self.osdmap = OSDMap.decode_bytes(e[4])
                        break
                self._prev_map = (self.osdmap.deepcopy()
                                  if self.store.kv.get("osdmap")
                                  or self.store.accepted else None)
                claim = True
                dout("mon", 1)("%s: leader for term %d (votes %s)",
                               self.name, self._term, sorted(self._votes))
        if claim:
            for p in self.peers:
                self._post(p, MMonClaim(self._term,
                                        self.store.accepted_version,
                                        self.name))
            for (v, pterm, desc, key, value) in list(self.store.accepted):
                prop = MMonPropose(self._term, v, key, value, desc,
                                   pterm=pterm,
                                   commit=self.store.version)
                for p in self.peers:
                    self._post(p, prop)

    def _handle_claim(self, conn, m: MMonClaim) -> None:
        with self._lock:
            if m.term < self._term:
                return
            if self._role == "leader" and m.name != self.name:
                # deposed: incrementals minted under the old term may
                # describe commits the new leader never saw
                self._inc_ring.clear()
                self._demote()
            if m.term > self._term:
                self._term = m.term
                self.store.set_term(m.term, "")
            self._role = "follower"
            self._leader = m.name
            self._leader_seen = time.monotonic()
            behind = m.version > self.store.accepted_version
        if behind:
            self._post(m.name, MMonSyncReq(self.store.version, self.name))

    def _ack_covers(self, version: int, pterm: int) -> bool:
        """Does a cumulative ack up to (version, pterm) prove the acker
        holds MY log prefix?  True iff its newest acked entry matches
        mine there (prevLogTerm check) — an equal-length divergent tail
        from a deposed leader must never be counted toward a commit.
        Caller holds _lock."""
        if version <= self.store.version:
            return True  # covers only committed prefix: no pending gated
        mine = self.store.entry_pterm(version)
        return mine is not None and mine == pterm

    def _count_ack(self, name: str, version: int, pterm: int) -> None:
        """Record a verified cumulative accept-ack.  Caller holds
        _lock and sends the returned replies afterwards."""
        if not self._ack_covers(version, pterm):
            return
        for v, acks in self._pending_acks.items():
            if v <= version:
                acks.add(name)

    def _handle_mon_ping(self, conn, m: MMonPing) -> None:
        with self._lock:
            # link-quality observation feeds the connectivity tracker
            # on EVERY mon regardless of role or TERM — but in its own
            # map: _peer_seen is QUORUM accounting (term-guarded), and
            # counting a term-mismatched ping there would let a stale
            # minority leader believe it still has quorum contact and
            # never step down
            self._link_seen[m.name] = time.monotonic()
        if m.role == "follower":
            # follower status ping: liveness + cumulative accept-ack
            # (version = its accepted_version), so a lost MMonPropAck
            # is healed by the next status ping
            sends = []
            with self._lock:
                if self.is_leader and m.term == self._term:
                    self._peer_seen[m.name] = time.monotonic()
                    self._count_ack(m.name, m.version, m.lterm)
                    sends = self._advance_commit()
            self._send_replies(sends)
            return
        if m.role != "leader":
            return
        reply = None
        behind = False
        with self._lock:
            if m.term < self._term:
                return
            if m.term > self._term:
                self._term = m.term
                self.store.set_term(m.term, "")
            if m.name != self.name:
                if self._role == "leader":
                    self._inc_ring.clear()
                    self._demote()
                self._role = "follower"
                self._leader = m.name
                self._leader_seen = time.monotonic()
                # m.version is the leader's COMMIT pointer: apply the
                # accepted prefix it covers (entries accepted under the
                # current term only — see commit_accepted_upto)
                self._commit_from_leader(m.version, m.term)
                behind = m.version > self.store.version
                acc = self.store.accepted
                reply = MMonPing(self.name, self._term, "follower",
                                 self.store.accepted_version, time.time(),
                                 lterm=(acc[-1][1] if acc
                                        else self.store.last_term))
        if reply:
            self._post(m.name, reply)
        if behind:
            self._post(m.name, MMonSyncReq(self.store.version, self.name))

    # ---------------------------------------------------------- replication
    def _handle_propose(self, conn, m: MMonPropose) -> None:
        """Follower accept phase: durably stage the entry, reconcile
        divergent tails by pterm (Raft AppendEntries conflict rule),
        apply the piggybacked commit pointer, and ack cumulatively."""
        with self._lock:
            if m.term < self._term:
                return
            if self._role == "leader" and \
                    (m.term > self._term or conn.peer != self.name):
                self._inc_ring.clear()
                self._demote()
            if m.term > self._term:
                self._term = m.term
                self.store.set_term(m.term, "")
            self._leader_seen = time.monotonic()
            av = self.store.accepted_version
            if m.version <= self.store.version:
                pass  # already committed; re-ack below
            elif m.version <= av:
                ent = next(e for e in self.store.accepted
                           if e[0] == m.version)
                if ent[1] != m.pterm:
                    # divergent tail from a deposed leader: everything
                    # from the conflict on is junk — replace it
                    self.store.truncate_accepted(m.version)
                    self._rollback_visible_map()
                    self.store.accept_at(m.version, m.pterm, m.key,
                                         m.value, m.desc)
            elif m.version == av + 1:
                self.store.accept_at(m.version, m.pterm, m.key,
                                     m.value, m.desc)
            else:
                # gap: catch up out-of-band; do NOT ack what we lack
                self._commit_from_leader(m.commit, m.term)
                self._post(self._leader or conn.peer,
                           MMonSyncReq(self.store.version, self.name))
                return
            self._commit_from_leader(m.commit, m.term)
            acked = self.store.accepted_version
            acc = self.store.accepted
            apt = acc[-1][1] if acc else self.store.last_term
        self._post(conn.peer, MMonPropAck(m.term, acked, self.name,
                                          pterm=apt))

    def _rollback_visible_map(self) -> None:
        """After truncating an accepted tail that included osdmap
        entries, the visible map must drop back to committed state (a
        deposed leader may have exposed an epoch that never existed).
        With no committed map at all (cluster bootstrap), fall back to
        the empty epoch-0 map.  Caller holds _lock."""
        if self.osdmap.epoch <= self.store.version:
            return
        raw = self.store.kv.get("osdmap")
        if raw is not None:
            self.osdmap = OSDMap.decode_bytes(raw)
            self._prev_map = self.osdmap.deepcopy()
        else:
            self.osdmap = OSDMap()
            self._prev_map = None
        self._inc_ring.clear()

    def _commit_from_leader(self, upto: int, term: int) -> None:
        """Advance the applied prefix to the leader's commit pointer.
        Only entries accepted under `term` qualify — an older-term tail
        must first be re-proposed (restamped) by the current leader,
        else a stale pointer could commit a deposed leader's divergent
        entry at the same version (fork).  Caller holds _lock."""
        for version, desc, key, value in \
                self.store.commit_accepted_upto(upto, pterm=term):
            if key == "osdmap":
                self.osdmap = OSDMap.decode_bytes(value)
                self._prev_map = self.osdmap.deepcopy()
                push = MMapPush(self.osdmap.epoch, value)
                for sub in list(self._subscribers):
                    self._post(sub, push)
            elif key == "authdb" and self.key_server is not None:
                self.key_server.load_db(value)

    def _handle_sync_req(self, conn, m: MMonSyncReq) -> None:
        if not self.is_leader:
            return
        with self._lock:
            self._peer_seen[m.name] = time.monotonic()
        if m.from_version + 1 < self.store.oldest_logged():
            # peer is older than the trimmed log window: full sync
            self._post(m.name, MMonSyncEntries(
                self._term, [], snap_version=self.store.version,
                snap_kv=dict(self.store.kv)))
        else:
            entries = self.store.entries_after(m.from_version)
            if entries:
                self._post(m.name,
                           MMonSyncEntries(self._term, list(entries)))
        # replay the accepted tail as proposals so the peer can accept
        # and ack it (it may hold the vote that commits these)
        for (v, pterm, desc, key, value) in list(self.store.accepted):
            self._post(m.name,
                       MMonPropose(self._term, v, key, value, desc,
                                   pterm=pterm,
                                   commit=self.store.version))

    def _handle_sync_entries(self, conn, m: MMonSyncEntries) -> None:
        with self._lock:
            if m.snap_kv is not None and \
                    m.snap_version > self.store.version:
                # adopting someone else's history: any incrementals this
                # mon minted while (wrongly) leading describe commits
                # that were rolled back — serving them would diverge a
                # subscriber's map permanently
                self._inc_ring.clear()
                self.store.reset_to(m.snap_version, m.snap_kv)
                if self.key_server is not None and \
                        self.store.kv.get("authdb"):
                    self.key_server.load_db(self.store.kv["authdb"])
                if self.store.kv.get("osdmap"):
                    self.osdmap = OSDMap.decode_bytes(
                        self.store.kv["osdmap"])
                    push = MMapPush(self.osdmap.epoch,
                                    self.store.kv["osdmap"])
                    for sub in list(self._subscribers):
                        self._post(sub, push)
            if m.snap_kv is not None and self.store.kv.get("osdmap"):
                self._prev_map = self.osdmap.deepcopy()
            applied = False
            for version, desc, key, value in m.entries:
                if version != self.store.version + 1:
                    continue
                self._apply_replicated(version, key, value, desc)
                applied = True
            if applied or m.snap_kv is not None:
                # our log is now as recent as the serving leader's term
                # — election comparator (lastLogTerm) must reflect that
                self.store.note_term(m.term)

    def _apply_replicated(self, version: int, key: str, value: bytes,
                          desc: str) -> None:
        """Follower: append a replicated commit and make it visible
        (map decode + push to local subscribers).  Caller holds _lock."""
        self.store.commit_at(version, key, value, desc)
        if key == "osdmap":
            self.osdmap = OSDMap.decode_bytes(value)
            # keep the diff base fresh so a promotion to leader can
            # continue the incremental stream seamlessly
            self._prev_map = self.osdmap.deepcopy()
            push = MMapPush(self.osdmap.epoch, value)
            for sub in list(self._subscribers):
                self._post(sub, push)
        elif key == "authdb" and self.key_server is not None:
            self.key_server.load_db(value)
        elif key == "clusterlog":
            # adopt the leader's journaled log when it is newer than
            # ours (restore() refuses to roll the ring backwards) —
            # a promoted follower then serves the same history
            try:
                self.cluster_log.restore(json.loads(value.decode()))
            except (ValueError, UnicodeDecodeError):
                pass

    # ------------------------------------------------------------ map flow
    INC_RING_KEEP = 128

    def _commit_map(self, desc: str) -> None:
        """Leader: stage the next map epoch.  Single-mon commits
        immediately; in a quorum the epoch is durably ACCEPTED locally
        and proposed to the peers — it becomes a commit (published to
        subscribers, client replies released) only when a majority has
        accepted it (_advance_commit).  Caller holds _lock."""
        old = self._prev_map
        v = self.store.accepted_version + 1
        self.osdmap.epoch = v
        raw = self.osdmap.encode_bytes()
        if old is not None:
            inc_b = self.osdmap.diff_from(old).encode_bytes()
            base = old.epoch
        else:
            inc_b, base = None, None
        self._prev_map = self.osdmap.deepcopy()
        dout("mon", 3)("epoch %d: %s", v, desc)
        self._clog("osdmap", f"osdmap e{v}: {desc}", epoch=v)
        self._note_health()
        if not self.peers:
            self.store.commit("osdmap", raw, desc)
            self._publish_map(v, base, inc_b, raw)
            return
        self.store.accept_at(v, self._term, "osdmap", raw, desc)
        self._pending_acks[v] = {self.name}
        self._pending_inc[v] = (base, inc_b, raw)
        prop = MMonPropose(self._term, v, "osdmap", raw, desc,
                           pterm=self._term, commit=self.store.version)
        for p in self.peers:
            self._post(p, prop)

    def _publish_map(self, epoch: int, base: int | None,
                     inc_b: bytes | None, raw: bytes) -> None:
        """Make a COMMITTED epoch visible: incremental-ring bookkeeping
        + subscriber push.  Routine pushes travel as incrementals (full
        maps only on boot/subscribe/catch-up gaps); a receiver not at
        the base epoch asks back with its have_epoch."""
        if base is not None and inc_b is not None:
            self._inc_ring[base] = (epoch, inc_b)
            if len(self._inc_ring) > self.INC_RING_KEEP:
                for k in sorted(self._inc_ring)[:-self.INC_RING_KEEP]:
                    del self._inc_ring[k]
            push = MMapPush(epoch, inc_bytes=inc_b, base_epoch=base)
        else:
            push = MMapPush(epoch, raw)
        for sub in list(self._subscribers):
            self._post(sub, push)

    def _handle_propack(self, conn, m: MMonPropAck) -> None:
        sends = []
        with self._lock:
            if not self.is_leader or m.term != self._term:
                return
            self._peer_seen[m.name] = time.monotonic()
            self._count_ack(m.name, m.version, m.pterm)
            sends = self._advance_commit()
        self._send_replies(sends)

    def _send_replies(self, sends: list) -> None:
        """Deliver gated client replies OFF the monitor lock and off
        the dispatch thread: one wedged client connection must never
        stall the quorum handlers behind _lock."""
        for conn, reply in sends:
            threading.Thread(
                target=lambda c=conn, r=reply: self._safe_send(c, r),
                name=f"{self.name}-reply", daemon=True).start()

    @staticmethod
    def _safe_send(conn, msg) -> None:
        try:
            conn.send(msg)
        except Exception:  # noqa: BLE001 - client gone; it will retry
            pass

    def _advance_commit(self) -> list:
        """Leader: commit every consecutive head version a majority has
        accepted, publish the committed epochs, and tell followers the
        new commit pointer.  Caller holds _lock and must pass the
        returned gated client replies to _send_replies AFTER releasing
        it."""
        committed = []
        while True:
            v = self.store.version + 1
            acks = self._pending_acks.get(v)
            if acks is None or len(acks) < self._majority():
                break
            committed.extend(
                self.store.commit_accepted_upto(v, pterm=self._term))
            self._pending_acks.pop(v, None)
        if not committed:
            return []
        sends = []
        for (v, desc, key, raw) in committed:
            if key == "osdmap":
                base, inc_b, full = self._pending_inc.pop(
                    v, (None, None, raw))
                self._publish_map(v, base, inc_b, full)
            sends.extend(self._reply_on_commit.pop(v, []))
        # immediate commit-pointer broadcast (don't wait for the next
        # status ping): followers apply + push to their subscribers
        ping = MMonPing(self.name, self._term, "leader",
                        self.store.version, time.time())
        for p in self.peers:
            self._post(p, ping)
        return sends

    def _handle_boot(self, conn, m: MOSDBoot) -> None:
        # teach the transport where this daemon lives (wire transports;
        # no-op in-proc) so map-driven sends resolve after a mon restart
        self.messenger.network.set_addr(f"osd.{m.osd_id}", m.addr)
        if m.hb_addr:
            self.messenger.network.set_addr(f"osd.{m.osd_id}.hb",
                                            m.hb_addr)
        with self._lock:
            if m.osd_id not in self.osdmap.osds:
                self.osdmap.add_osd(m.osd_id, m.host, m.addr,
                                    hb_addr=m.hb_addr)
            self.osdmap.mark_up(m.osd_id, m.addr, hb_addr=m.hb_addr)
            self._boot_times[m.osd_id] = time.time()
            self._failure_reports.pop(m.osd_id, None)
            # subscribe the ENTITY, not its transport address (addr is a
            # host:port on wire transports)
            self._subscribers.add(f"osd.{m.osd_id}")
            # a rebooted daemon restarts its journal sequence at 1: the
            # dedup cursor must follow or every new event looks old
            self._event_lseq.pop(m.osd_id, None)
            # ...and its metrics-history sample seq likewise
            self.metrics_history.reset_daemon(f"osd.{m.osd_id}")
            # ...and its perf-query snapshot: the revived daemon's
            # rows restart from zero, and dropping the pre-crash
            # cumulative snapshot here is what keeps a kill/revive
            # from double-counting in `perf query report`
            self.perf_queries.reset_daemon(f"osd.{m.osd_id}")
            # ...and its progress items: storms it opened before this
            # boot never report done
            self.progress.close_daemon(f"osd.{m.osd_id}")
            self._clog("cluster", f"osd.{m.osd_id} boot (host "
                                  f"{m.host})", osd=m.osd_id)
            self._commit_map(f"osd.{m.osd_id} boot")

    def _handle_subscribe(self, conn, m: MMonSubscribe) -> None:
        with self._lock:
            self._subscribers.add(conn.peer)
            have = getattr(m, "have_epoch", -1)
            # catch-up gap: serve the chain of incrementals from the
            # receiver's epoch if the ring still covers it (OSDMonitor
            # send_incremental role); otherwise — or for a fresh
            # subscriber — the full map.  Push even an empty epoch-0 map:
            # a daemon whose boot was dropped during an election sees
            # itself absent and re-asserts.
            # serve COMMITTED state only: the working map may sit at an
            # accepted-but-uncommitted epoch that a leader change can
            # still roll back
            cur = self.osdmap
            if self.peers and cur.epoch > self.store.version:
                raw = self.store.kv.get("osdmap")
                cur = (OSDMap.decode_bytes(raw) if raw is not None
                       else OSDMap())
            if 0 <= have < cur.epoch:
                chain = []
                base = have
                while base != cur.epoch:
                    step = self._inc_ring.get(base)
                    if step is None:
                        chain = None
                        break
                    new_epoch, inc_b = step
                    chain.append(MMapPush(new_epoch, inc_bytes=inc_b,
                                          base_epoch=base))
                    base = new_epoch
                if chain is not None:
                    for push in chain:
                        conn.send(push)
                    return
            conn.send(MMapPush(cur.epoch, cur.encode_bytes()))

    def _handle_pg_temp(self, conn, m: MOSDPGTemp) -> None:
        """Commit (or clear) a temporary acting set requested by a
        backfilling primary (OSDMonitor::preprocess_pgtemp role)."""
        with self._lock:
            key = (m.pgid.pool, m.pgid.seed)
            pool = self.osdmap.pools.get(m.pgid.pool)
            if pool is None or pool.kind == "ec":
                # EC placement is position-stable and ignores pg_temp; a
                # committed entry there could never clear
                return
            osds = [int(o) for o in m.osds]
            if osds:
                known = [o for o in osds if o in self.osdmap.osds]
                if known != osds or self.osdmap.pg_temp.get(key) == osds:
                    return
                self.osdmap.pg_temp[key] = osds
                self._commit_map(
                    f"pg_temp {m.pgid.pool}.{m.pgid.seed:x} -> {osds} "
                    f"(osd.{m.osd_id})")
            elif key in self.osdmap.pg_temp:
                del self.osdmap.pg_temp[key]
                self.osdmap.primary_temp.pop(key, None)
                self._commit_map(
                    f"pg_temp {m.pgid.pool}.{m.pgid.seed:x} cleared "
                    f"(osd.{m.osd_id})")

    # -- failure detection (prepare_failure / check_failure role) ----------
    def _grace_for(self, target: int) -> float:
        """Adaptive grace: base + log-ish scale by uptime (the intent of
        OSDMonitor::get_grace_time — long-stable daemons get more slack)."""
        base = self.cfg["osd_heartbeat_grace"]
        uptime = time.time() - self._boot_times.get(target, time.time())
        return base + min(base, uptime / 600.0)

    def _handle_failure(self, conn, m: MFailureReport) -> None:
        with self._lock:
            info = self.osdmap.osds.get(m.target)
            if info is None or not info.up:
                return
            now = time.time()
            reps = self._failure_reports.setdefault(m.target, {})
            first, _ = reps.get(m.reporter, (now, now))
            reps[m.reporter] = (first, now)
            # prune stale reporters
            for r in [r for r, (_, last) in reps.items()
                      if now - last > 4 * self.cfg["osd_heartbeat_grace"]]:
                del reps[r]
            distinct = len(reps)
            longest = max(now - f for f, _ in reps.values())
            # reports must SPAN a window, not just arrive in a burst —
            # protects against one stale-stamp flurry marking a daemon down
            if (distinct >= self.cfg["mon_osd_min_down_reporters"]
                    and longest >= self._grace_for(m.target) / 4
                    and m.failed_for >= self._grace_for(m.target)):
                self.osdmap.mark_down(m.target)
                del self._failure_reports[m.target]
                self._osd_stats.pop(m.target, None)  # no stale usage
                self.progress.close_daemon(f"osd.{m.target}")
                self._subscribers.discard(f"osd.{m.target}")
                self._clog("cluster",
                           f"osd.{m.target} marked down "
                           f"({distinct} reporters)", severity="warn",
                           osd=m.target, reporters=distinct)
                self._commit_map(
                    f"osd.{m.target} down ({distinct} reporters)")

    # ------------------------------------------------------------- commands
    # mon cap classification: read-only verbs need r, auth-database
    # verbs need full caps (MonCap "allow *" semantics), every other
    # mutation needs w
    _READONLY_CMDS = frozenset({"status", "osd dump", "osd stats",
                                "auth list", "dump_cluster_log",
                                "progress", "dump_metrics_history",
                                "metrics_query", "osd qos ls",
                                "clock_skew", "perf query ls",
                                "perf query report"})

    def _mon_cmd_denied(self, m: MMonCommand):
        """(errno, detail) if the command must be refused, else None.
        Verifies the mon-service ticket, the per-command proof, and the
        entity's mon caps (MonCap::is_capable role)."""
        vt = self._mon_verifier.verify(m.ticket)
        if vt is None:
            return -13, {"error": "access denied: no/invalid/expired "
                                  "mon ticket"}
        want = op_proof(vt.session_key, m.tid, _canonical_cmd(m.cmd))
        if not _hmac.compare_digest(want, m.proof):
            return -13, {"error": "access denied: bad command proof"}
        prefix = str(m.cmd.get("prefix", ""))
        if prefix in self._READONLY_CMDS:
            need = "r"
        elif prefix.startswith("auth"):
            need = "rwx"
        else:
            need = "w"
        if not vt.caps.allows(need):
            return -13, {"error": f"access denied: {vt.entity} lacks "
                                  f"mon caps {need!r}"}
        return None

    def _handle_auth(self, conn, m: MAuth) -> None:
        """Ticket mint (AuthMonitor::prep_auth role).  Any mon serves —
        issuance reads the replicated entity table and mutates
        nothing."""
        if self.key_server is None:
            conn.send(MAuthReply(m.tid, 0))
            return
        ks = self.key_server
        with self._lock:
            ok = ks.verify_request(m.entity, m.nonce, m.ts_ms,
                                   list(m.services), m.proof)
            tickets = []
            if ok:
                for svc in m.services:
                    out = ks.issue(m.entity, svc)
                    if out is not None:
                        blob, sealed, nonce = out
                        tickets.append((svc, blob, sealed, nonce))
        if not ok:
            dout("mon", 2)("%s: auth request for %r REFUSED", self.name,
                           m.entity)
            conn.send(MAuthReply(m.tid, -13))
            return
        conn.send(MAuthReply(m.tid, 0, tickets, ks.ttl))

    def _commit_auth(self, desc: str) -> None:
        """Stage the entity table under the same accept/commit quorum
        as the osdmap (caller holds _lock; leader only)."""
        raw = self.key_server.encode_db()
        if not self.peers:
            self.store.commit("authdb", raw, desc)
            return
        v = self.store.accepted_version + 1
        self.store.accept_at(v, self._term, "authdb", raw, desc)
        self._pending_acks[v] = {self.name}
        prop = MMonPropose(self._term, v, "authdb", raw, desc,
                           pterm=self._term, commit=self.store.version)
        for p in self.peers:
            self._post(p, prop)

    def _handle_command(self, conn, m: MMonCommand) -> None:
        if not self.is_leader:
            # reachable on a mid-election mon addressed directly
            conn.send(MMonCommandReply(m.tid, -11, {"error": "not leader"}))
            return
        if self._mon_verifier is not None:
            denied = self._mon_cmd_denied(m)
            if denied is not None:
                conn.send(MMonCommandReply(m.tid, denied[0], denied[1]))
                return
        with self._lock:
            pre = self.store.accepted_version
            try:
                result, data = self._run_command(m.cmd)
            except Exception as e:  # noqa: BLE001 - must not kill mon
                result, data = -22, {"error": repr(e)}
            post = self.store.accepted_version
            # mon-originated journal entries (pool creates, mark-downs,
            # health flips from the command path) must not wait for an
            # OSD stats report to persist — an all-OSDs-down incident
            # is exactly the narrative the durable log exists for.
            # AFTER _run_command: any commit it staged has already
            # claimed its version, so the debounced persist cannot
            # steal one mid-flight.
            self._maybe_persist_clog()
            reply = MMonCommandReply(m.tid, result, data)
            if result == 0 and post > self.store.version and post > pre \
                    and self.peers:
                # the mutation is proposed but not yet majority-
                # committed: gate the success reply on the commit, so a
                # client never acts on an epoch a leader change can
                # still roll back
                self._reply_on_commit.setdefault(post, []).append(
                    (conn, reply))
                return
        conn.send(reply)

    def _run_command(self, cmd: dict):
        prefix = cmd.get("prefix")
        if prefix == "osd pool create":
            return self._pool_create(cmd)
        if prefix == "osd down":
            target = int(cmd["id"])
            with self._lock:
                self.osdmap.mark_down(target)
                self._osd_stats.pop(target, None)
                self.progress.close_daemon(f"osd.{target}")
                # a down daemon stops being a push target until it
                # re-boots (a dead host's stale addr must not stall
                # future commits behind connect timeouts)
                self._subscribers.discard(f"osd.{target}")
                self._clog("cluster", f"osd.{target} marked down "
                                      f"(operator)", severity="warn",
                           osd=target)
                self._commit_map(f"osd.{target} down (forced)")
            return 0, {}
        if prefix == "osd out":
            target = int(cmd["id"])
            with self._lock:
                self.osdmap.mark_out(target)
                self._osd_stats.pop(target, None)
                self._commit_map(f"osd.{target} out")
            return 0, {}
        if prefix == "osd pg-upmap":
            pool_id, seed = int(cmd["pool"]), int(cmd["seed"])
            osds = [int(x) for x in cmd["osds"]]
            with self._lock:
                pool = self.osdmap.pools.get(pool_id)
                if pool is None:
                    return -2, {"error": f"no pool {pool_id}"}
                if len(osds) != pool.size or len(set(osds)) != len(osds):
                    return -22, {"error":
                                 f"need {pool.size} distinct osds"}
                unknown = [o for o in osds if o not in self.osdmap.osds]
                if unknown:
                    return -22, {"error": f"unknown osds {unknown}"}
                self.osdmap.pg_upmap[(pool_id, seed)] = osds
                self._commit_map(f"pg-upmap {pool_id}.{seed} -> {osds}")
            return 0, {}
        if prefix == "osd pg-temp":
            pool_id, seed = int(cmd["pool"]), int(cmd["seed"])
            osds = [int(x) for x in cmd.get("osds", [])]
            with self._lock:
                if pool_id not in self.osdmap.pools:
                    return -2, {"error": f"no pool {pool_id}"}
                if self.osdmap.pools[pool_id].kind == "ec":
                    return -22, {"error": "pg-temp: EC placement is "
                                 "position-stable (no temp overrides)"}
                key = (pool_id, seed)
                if osds:
                    self.osdmap.pg_temp[key] = osds
                else:
                    self.osdmap.pg_temp.pop(key, None)
                    self.osdmap.primary_temp.pop(key, None)
                self._commit_map(f"pg-temp {pool_id}.{seed:x} {osds}")
            return 0, {}
        if prefix == "osd primary-temp":
            pool_id, seed = int(cmd["pool"]), int(cmd["seed"])
            with self._lock:
                if pool_id not in self.osdmap.pools:
                    return -2, {"error": f"no pool {pool_id}"}
                key = (pool_id, seed)
                who = int(cmd.get("id", -1))
                if who >= 0:
                    self.osdmap.primary_temp[key] = who
                else:
                    self.osdmap.primary_temp.pop(key, None)
                self._commit_map(f"primary-temp {pool_id}.{seed:x} {who}")
            return 0, {}
        if prefix == "osd rm-pg-upmap":
            pool_id, seed = int(cmd["pool"]), int(cmd["seed"])
            with self._lock:
                if self.osdmap.pg_upmap.pop((pool_id, seed), None) \
                        is None:
                    return -2, {"error": "no such upmap"}
                self._commit_map(f"rm-pg-upmap {pool_id}.{seed}")
            return 0, {}
        if prefix == "osd primary-affinity":
            target, aff = int(cmd["id"]), float(cmd["weight"])
            if not 0.0 <= aff <= 1.0:
                return -22, {"error": "affinity must be in [0, 1]"}
            with self._lock:
                info = self.osdmap.osds.get(target)
                if info is None:
                    return -2, {"error": f"no osd.{target}"}
                info.primary_affinity = aff
                self._commit_map(f"osd.{target} primary-affinity {aff}")
            return 0, {}
        if prefix == "osd pool set-pg-num":
            # live PG split (pg_num scaling — OSD::split_pgs role, ref
            # src/osd/OSD.h:1999 + pg-split math in src/osd/OSDMap.cc).
            # Growth only, and only to a multiple of the current pg_num:
            # with modulo placement that makes every object's new seed a
            # deterministic child of its old one (the stable-mod split),
            # so holders split locally and recovery moves the rest.
            with self._lock:
                pool = self._pool_by_name(cmd["pool"])
                if pool is None:
                    return -2, {"error": f"no pool {cmd['pool']!r}"}
                new = int(cmd["pg_num"])
                if new <= 0:
                    return -22, {"error": "pg_num must be positive"}
                if new == pool.pg_num:
                    return 0, {"pg_num": new}
                if new > pool.pg_num and new % pool.pg_num:
                    return -22, {"error": f"pg_num {new} must be a "
                                          f"multiple of {pool.pg_num}"}
                if new < pool.pg_num and pool.pg_num % new:
                    return -22, {"error": f"pg_num {new} must divide "
                                          f"{pool.pg_num} (merge folds "
                                          f"seed s into s mod new)"}
                old_num = pool.pg_num
                pool.pg_num = new
                verb = "split" if new > old_num else "merge"
                self._commit_map(
                    f"pool {pool.name} pg_num {old_num} -> {new} "
                    f"({verb})")
            return 0, {"pg_num": new}
        if prefix == "osd pool set-compression":
            # per-pool compression options ride the pool's profile
            # mapping in the OSDMap (same channel as read_policy):
            # every OSD's write path converges on the next map push.
            # Objects already stored keep their on-disk form — the
            # policy only governs writes from here on.
            from ..osd.compression import POOL_OPTS, validate_pool_opts
            with self._lock:
                pool = self._pool_by_name(cmd["pool"])
                if pool is None:
                    return -2, {"error": f"no pool {cmd['pool']!r}"}
                prof = dict(pool.ec_profile or {})
                for opt in POOL_OPTS:
                    if opt in cmd:
                        prof[opt] = str(cmd[opt])
                try:
                    validate_pool_opts(prof)
                except (ValueError, TypeError) as e:
                    return -22, {"error": f"bad compression options: {e}"}
                pool.ec_profile = prof
                self._commit_map(
                    f"pool {pool.name} compression "
                    f"{prof.get('compression_mode', 'none')}")
            return 0, {opt: prof[opt] for opt in POOL_OPTS
                       if opt in prof}
        if prefix == "osd pool selfmanaged-snap-create":
            # mint a pool-unique snap id (pg_pool_t::snap_seq role)
            with self._lock:
                pool = self._pool_by_name(cmd["pool"])
                if pool is None:
                    return -2, {"error": f"no pool {cmd['pool']!r}"}
                pool.snap_seq += 1
                snapid = pool.snap_seq
                self._commit_map(f"pool {pool.name} snap {snapid}")
            return 0, {"snapid": snapid, "seq": snapid}
        if prefix == "osd pool selfmanaged-snap-remove":
            with self._lock:
                pool = self._pool_by_name(cmd["pool"])
                if pool is None:
                    return -2, {"error": f"no pool {cmd['pool']!r}"}
                snapid = int(cmd["snapid"])
                if snapid <= 0 or snapid > pool.snap_seq:
                    return -22, {"error": f"bad snapid {snapid}"}
                if snapid not in pool.removed_snaps:
                    pool.removed_snaps.append(snapid)
                    self._commit_map(
                        f"pool {pool.name} snap {snapid} removed")
            return 0, {}
        if prefix == "osd qos set-profile":
            # tenant QoS profile (qos/profiles.py grammar): committed
            # into the OSDMap like pool options — every OSD's
            # scheduler converges on the next map push, no per-daemon
            # config fan-out
            from ..qos.profiles import TenantProfile
            try:
                prof = TenantProfile(
                    str(cmd["name"]),
                    reservation=float(cmd.get("res", 0.0)),
                    weight=float(cmd.get("wgt", 1.0)),
                    limit=float(cmd.get("lim", 0.0)))
            except (KeyError, TypeError, ValueError) as e:
                return -22, {"error": f"bad qos profile: {e}"}
            with self._lock:
                self.osdmap.qos_profiles[prof.name] = prof.to_dict()
                self._clog("qos", f"qos profile {prof.name} set "
                                  f"({prof.spec()})",
                           tenant=prof.name, **prof.to_dict())
                self._commit_map(f"qos profile {prof.name} "
                                 f"({prof.spec()})")
            return 0, {"profile": {prof.name: prof.to_dict()}}
        if prefix == "osd qos rm-profile":
            name = str(cmd.get("name", ""))
            with self._lock:
                if self.osdmap.qos_profiles.pop(name, None) is None:
                    return -2, {"error": f"no qos profile {name!r}"}
                self._clog("qos", f"qos profile {name} removed",
                           tenant=name)
                self._commit_map(f"qos profile {name} removed")
            return 0, {}
        if prefix == "osd qos ls":
            with self._lock:
                return 0, {"profiles": {n: dict(p) for n, p in
                                        sorted(self.osdmap
                                               .qos_profiles.items())}}
        if prefix == "perf query add":
            # dynamic perf query (telemetry/perf_query): committed
            # into the OSDMap like qos profiles — every OSD's
            # PerfQuerySet converges on the next map push
            from ..telemetry.perf_query import PerfQuerySpec
            key_by = cmd.get("key_by") or "tenant"
            if isinstance(key_by, str):
                key_by = [k.strip() for k in key_by.split(",")
                          if k.strip()]
            counters = cmd.get("counters")
            if isinstance(counters, str):
                counters = [c.strip() for c in counters.split(",")
                            if c.strip()]
            with self._lock:
                qid = 1 + max(self.osdmap.perf_queries, default=0)
                try:
                    spec = PerfQuerySpec(
                        qid=qid, key_by=tuple(key_by),
                        counters=tuple(counters) if counters
                        else ("ops", "bytes_in", "bytes_out", "lat"),
                        top_n=int(cmd.get("top_n", 32)),
                        prefix_len=int(cmd.get("prefix_len", 8)))
                except (TypeError, ValueError) as e:
                    return -22, {"error": f"bad perf query: {e}"}
                self.osdmap.perf_queries[qid] = spec.to_dict()
                self._clog("perf", f"perf query {qid} added "
                                   f"(key_by {','.join(spec.key_by)})",
                           qid=qid)
                self._commit_map(f"perf query {qid} added")
            return 0, {"qid": qid, "spec": spec.to_dict()}
        if prefix == "perf query rm":
            qid = int(cmd["qid"])
            with self._lock:
                if self.osdmap.perf_queries.pop(qid, None) is None:
                    return -2, {"error": f"no perf query {qid}"}
                self._clog("perf", f"perf query {qid} removed",
                           qid=qid)
                self._commit_map(f"perf query {qid} removed")
            return 0, {}
        if prefix == "perf query ls":
            with self._lock:
                return 0, {"queries": {str(q): dict(s) for q, s in
                                       sorted(self.osdmap
                                              .perf_queries.items())},
                           "reporting": self.perf_queries.daemons()}
        if prefix == "perf query report":
            qid = int(cmd["qid"])
            with self._lock:
                if qid not in self.osdmap.perf_queries:
                    return -2, {"error": f"no perf query {qid}"}
            try:
                return 0, self.perf_queries.report(
                    qid, sort=str(cmd.get("sort", "ops")),
                    limit=int(cmd.get("limit", 0) or 0))
            except ValueError as e:
                return -22, {"error": str(e)}
        if prefix == "balancer optimize":
            return self._balancer_optimize(int(cmd.get("max_moves", 10)))
        if prefix == "osd dump":
            return 0, self._dump()
        if prefix == "status":
            up = self.osdmap.up_osds()
            agg = {"objects": 0, "bytes": 0, "op_w": 0, "op_r": 0,
                   "recovery_push": 0, "scrub_errors": 0}
            for s in self._osd_stats.values():
                for k in agg:
                    agg[k] += s.get(k, 0)
            checks = self._health_checks(up)
            # raw sums count each replica/shard; objects are logical-ish
            return 0, {"epoch": self.osdmap.epoch,
                       "num_osds": len(self.osdmap.osds),
                       "num_up": len(up),
                       "pools": sorted(p.name for p in
                                       self.osdmap.pools.values()),
                       "usage": agg,
                       "quorum": {"leader": self._leader,
                                  "term": self._term,
                                  "role": self._role},
                       "health": ("HEALTH_WARN" if checks
                                  else "HEALTH_OK"),
                       "checks": checks,
                       "progress": self.progress.active()}
        if prefix == "osd stats":
            return 0, {f"osd.{i}": dict(s)
                       for i, s in sorted(self._osd_stats.items())}
        if prefix == "dump_cluster_log":
            # the merged journal (`ceph log last` / `ceph -W` source):
            # channel filter + since-seq cursor for follow mode
            return 0, self.cluster_log.dump(
                channel=cmd.get("channel"),
                since=int(cmd.get("since", 0) or 0),
                max_events=int(cmd.get("max", 0) or 0))
        if prefix == "progress":
            return 0, self.progress.ls()
        if prefix == "clock_skew":
            # the offsets trace_tool subtracts when merging
            # cross-daemon waterfalls (also the daemon_clock_skew_s
            # exporter gauge feed)
            return 0, self.clock_skew()
        if prefix == "dump_metrics_history":
            # the merged in-cluster time series (perf_history source)
            return 0, self.metrics_history.dump(
                registry=cmd.get("registry"),
                max_samples=int(cmd.get("max", 0) or 0))
        if prefix == "metrics_query":
            # delta/rate (+ pow-2 quantiles) of one counter over an
            # arbitrary retrospective window — "what was mclock_qwait
            # doing five minutes ago", answered in-cluster
            if not cmd.get("registry") or not cmd.get("counter"):
                return -22, {"error": "need registry + counter"}
            return 0, self.metrics_history.query(
                str(cmd["registry"]), str(cmd["counter"]),
                since_s=float(cmd.get("since_s", 60.0)),
                until_s=float(cmd.get("until_s", 0.0)),
                start_ts=(float(cmd["start_ts"])
                          if cmd.get("start_ts") is not None else None),
                end_ts=(float(cmd["end_ts"])
                        if cmd.get("end_ts") is not None else None))
        if prefix.startswith("auth"):
            return self._auth_command(prefix, cmd)
        return -22, {"error": f"unknown command {prefix!r}"}

    def _auth_command(self, prefix: str, cmd: dict):
        """The `ceph auth ...` verb family (AuthMonitor command role).
        Mutations replicate the whole entity table under "authdb"."""
        ks = self.key_server
        if ks is None:
            return -95, {"error": "authorization disabled on this "
                                  "cluster"}
        if prefix == "auth list":
            with self._lock:
                return 0, {"entities": ks.list_entities()}
        if prefix == "auth get-or-create":
            name = str(cmd["entity"])
            caps = {str(k): str(v)
                    for k, v in (cmd.get("caps") or {}).items()}
            with self._lock:
                existed = name in ks.entities
                try:
                    key = ks.get_or_create(name, caps or None)
                except CapsError as e:
                    return -22, {"error": str(e)}
                if caps or not existed:
                    self._commit_auth(f"auth get-or-create {name}")
                return 0, {"entity": name, "key": key.hex(),
                           "caps": dict(ks.entities[name]["caps"])}
        if prefix == "auth caps":
            name = str(cmd["entity"])
            caps = {str(k): str(v)
                    for k, v in (cmd.get("caps") or {}).items()}
            with self._lock:
                if name not in ks.entities:
                    return -2, {"error": f"no entity {name!r}"}
                try:
                    ks.add(name, caps)
                except CapsError as e:
                    return -22, {"error": str(e)}
                self._commit_auth(f"auth caps {name}")
                return 0, {"entity": name, "caps": caps}
        if prefix == "auth del":
            name = str(cmd["entity"])
            with self._lock:
                if not ks.remove(name):
                    return -2, {"error": f"no entity {name!r}"}
                self._commit_auth(f"auth del {name}")
                return 0, {}
        return -22, {"error": f"unknown command {prefix!r}"}

    def _balancer_optimize(self, max_moves: int = 10):
        """Even out replicated-PG membership counts with pg_upmap moves
        (the mgr balancer module's upmap mode, scoped to membership
        counts; respects host failure domains)."""
        with self._lock:
            osds = {o.osd_id: o for o in self.osdmap.osds.values()
                    if o.in_cluster and o.up}
            if len(osds) < 2:
                return 0, {"moves": []}
            counts = {o: 0 for o in osds}
            mapping = {}
            for pool_id, pool in self.osdmap.pools.items():
                for seed in range(pool.pg_num):
                    up = [d for d in self.osdmap.pg_to_up_osds(pool_id,
                                                               seed)
                          if d is not None]
                    mapping[(pool_id, seed)] = up
                    for d in up:
                        if d in counts:
                            counts[d] += 1
            moves = []
            for _ in range(max_moves):
                hi = max(counts, key=lambda o: counts[o])
                lo = min(counts, key=lambda o: counts[o])
                if counts[hi] - counts[lo] <= 1:
                    break
                moved = False
                for (pid, seed), up in mapping.items():
                    if self.osdmap.pools[pid].kind != "replicated":
                        continue
                    if hi not in up or lo in up:
                        continue
                    # never co-locate replicas on one host
                    hosts = {osds[d].host for d in up
                             if d != hi and d in osds}
                    if osds[lo].host in hosts:
                        continue
                    new = [lo if d == hi else d for d in up]
                    self.osdmap.pg_upmap[(pid, seed)] = new
                    mapping[(pid, seed)] = new
                    counts[hi] -= 1
                    counts[lo] += 1
                    moves.append({"pg": f"{pid}.{seed}", "from": hi,
                                  "to": lo})
                    moved = True
                    break
                if not moved:
                    break
            if moves:
                self._commit_map(f"balancer: {len(moves)} upmap moves")
            return 0, {"moves": moves}

    def _health_checks(self, up: list) -> dict:
        """The health mux (the reference's health check map feeding
        `ceph status`): OSD_DOWN from the map, SLOW_OPS folded from the
        daemons' stats reports (dump_historic_slow_ops -> mon path) —
        driven by CURRENTLY blocked ops, so the warning clears on its
        own when they finish and the next report lands.  Caller holds
        _lock."""
        checks: dict[str, dict] = {}
        n_down = len(self.osdmap.osds) - len(up)
        if n_down > 0:
            checks["OSD_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{n_down} osds down"}
        slow_daemons = {
            f"osd.{i}": {"slow_ops": int(s.get("slow_ops", 0)),
                         "slow_ops_total": int(
                             s.get("slow_ops_total", 0)),
                         "worst": list(s.get("slow_ops_worst", []))}
            for i, s in sorted(self._osd_stats.items())
            if s.get("slow_ops", 0)}
        if slow_daemons:
            total = sum(d["slow_ops"] for d in slow_daemons.values())
            oldest = max(
                (w["age_seconds"] for d in slow_daemons.values()
                 for w in d["worst"]), default=0.0)
            checks["SLOW_OPS"] = {
                "severity": "HEALTH_WARN",
                "summary": (f"{total} slow ops, oldest "
                            f"{oldest:.1f}s, daemons "
                            f"{sorted(slow_daemons)}"),
                "detail": slow_daemons}
        # BATCH_THRASH: repeated batcher regime churn (adaptive-window
        # resizes / fused-csum fall-throughs on the `batch` channel)
        # promoted to a health warning when a daemon exceeds the
        # config-gated threshold inside the sliding window.  Off by
        # default (count=0) until real-chip numbers set the bar; the
        # check self-clears as merge-stamped events age past the
        # window on later reports.
        warn_n = self.cfg["mon_batch_thrash_warn_count"]
        # prune UNCONDITIONALLY: a live count->0 reconfigure must not
        # strand the fed window in memory
        cutoff = time.time() - \
            self.cfg["mon_batch_thrash_warn_window_s"]
        while self._batch_events and \
                self._batch_events[0][0] < cutoff:
            self._batch_events.popleft()
        if warn_n > 0:
            per_daemon: dict[str, int] = {}
            for _ts, daemon in self._batch_events:
                per_daemon[daemon] = per_daemon.get(daemon, 0) + 1
            hot = {d: c for d, c in sorted(per_daemon.items())
                   if c >= warn_n}
            if hot:
                checks["BATCH_THRASH"] = {
                    "severity": "HEALTH_WARN",
                    "summary": (f"EC batcher thrashing on "
                                f"{sorted(hot)}: "
                                f"{sum(hot.values())} regime events "
                                f"in the last "
                                f"{self.cfg['mon_batch_thrash_warn_window_s']:g}s"),
                    "detail": hot}
        # externally-registered checks (mgr modules) merge last; the
        # registrant owns raise/clear by setting/clearing its entry
        checks.update({n: dict(c)
                       for n, c in self._ext_health.items()})
        return checks

    def set_health_check(self, name: str, check: dict | None) -> None:
        """Raise (check dict with severity/summary/detail) or clear
        (None) an externally-owned health check — the mgr modules'
        entry into the health mux.  Transitions journal through
        _note_health exactly like the built-ins."""
        with self._lock:
            if check is None:
                self._ext_health.pop(name, None)
            else:
                self._ext_health[name] = dict(check)
            self._note_health()

    def clock_skew(self) -> dict:
        """Per-daemon clock-skew estimates (seconds; positive = the
        daemon's clock reads BEHIND the mon's by that much plus the
        one-way delay).  Lock-free snapshot: callers include
        _run_command (which already holds _lock) and the exporter's
        HTTP thread (which does not) — a plain dict copy is atomic
        enough for a telemetry gauge."""
        return dict(self._clock_skew)

    def _clog(self, channel: str, message: str, severity: str = "info",
              **fields) -> None:
        """The mon's own journal entries (map commits, daemon
        lifecycle, health transitions) go straight into the merged
        cluster log — no shipping hop."""
        self.cluster_log.append(
            make_event(self.name, channel, message, severity, **fields))

    def _note_health(self) -> None:
        """Journal health-check TRANSITIONS (raised / cleared) — the
        cluster-log narrative of what `ceph status` only shows as
        current state.  Caller holds _lock."""
        checks = self._health_checks(self.osdmap.up_osds())
        cur = {name: c.get("severity", "HEALTH_WARN")
               for name, c in checks.items()}
        for name, sev in cur.items():
            if self._last_health.get(name) != sev:
                self._clog("health",
                           f"{sev} {name}: "
                           f"{checks[name].get('summary', '')}",
                           severity="warn", check=name, status=sev)
        for name in self._last_health:
            if name not in cur:
                self._clog("health", f"{name} cleared",
                           check=name, status="HEALTH_OK")
        self._last_health = cur

    def _handle_stats(self, conn, m: MStatsReport) -> None:
        stats = dict(m.stats)
        # journal entries rode along (LogClient piggyback): merge them
        # into the cluster log IN ORDER and feed the recovery channel
        # to the progress tracker; they must not linger in _osd_stats
        # (the `osd stats` / aggregation surfaces are numeric)
        events = stats.pop("events", None) or []
        # metrics-history increments ride the same at-least-once
        # window; the store dedupes by per-(daemon, registry) seq
        metrics = stats.pop("metrics", None)
        if metrics:
            self.metrics_history.merge(f"osd.{m.osd_id}", metrics)
        # dynamic perf-query partials: newest-seq-wins per daemon
        # (cumulative snapshots, so re-delivery replaces exactly)
        pq = stats.pop("perf_queries", None)
        if pq:
            if self.perf_queries.merge(f"osd.{m.osd_id}", pq):
                self._maybe_persist_pg_load()
        sent_at = stats.pop("sent_at", None)
        with self._lock:
            if isinstance(sent_at, (int, float)):
                # receive-time minus send-stamp: wall-clock offset plus
                # the one-way wire delay (small in-cluster); smoothed
                # lightly so one delayed report doesn't jerk waterfall
                # alignment
                raw = time.time() - float(sent_at)
                prev = self._clock_skew.get(f"osd.{m.osd_id}")
                self._clock_skew[f"osd.{m.osd_id}"] = round(
                    raw if prev is None else 0.5 * prev + 0.5 * raw, 6)
            self._osd_stats[m.osd_id] = stats
            seen = self._event_lseq.get(m.osd_id, 0)
            now = time.time()
            for ev in events:
                if not isinstance(ev, dict):
                    continue
                lseq = ev.get("lseq")
                if isinstance(lseq, int):
                    if lseq <= seen:
                        continue  # re-shipped window: already merged
                    seen = lseq
                # feed the NORMALIZED copy append() returns — the raw
                # report dict may carry junk a tracker should not see
                norm = self.cluster_log.append(ev)
                if norm["channel"] in ("recovery", "scrub"):
                    self.progress.on_event(norm)
                elif norm["channel"] == "batch" and \
                        self.cfg["mon_batch_thrash_warn_count"] > 0:
                    # batch-thrash health feed (merge-time stamps keep
                    # the window monotone under clock skew); only fed
                    # while the check is enabled — a live enable
                    # starts counting from that moment
                    self._batch_events.append((now, norm["daemon"]))
            self._event_lseq[m.osd_id] = seen
            self._note_health()
            self._maybe_persist_clog()

    def _maybe_persist_pg_load(self, force: bool = False) -> None:
        """Persist the merged per-PG load view of any pgid-keyed
        standing query into the metrics-history store (daemon "mon",
        registry "pg_load": pg_ops_<pgid>/pg_bytes_<pgid> flat
        counters) — the load-sensing feed the upmap balancer reads
        through the SAME metrics_query surface as every other series.
        Debounced by mon_pg_load_persist_interval_s (0 disables)."""
        interval = self.cfg["mon_pg_load_persist_interval_s"]
        if interval <= 0:
            return
        now = time.monotonic()
        if not force and now - self._pg_load_persisted_at < interval:
            return
        load: dict[str, int] = {}
        for qid, spec in self.osdmap.perf_queries.items():
            if tuple(spec.get("key_by", ())) == ("pgid",):
                load.update(self.perf_queries.pg_load(qid))
        if not load:
            return
        self._pg_load_persisted_at = now
        self._pg_load_seq += 1
        self.metrics_history.merge("mon", {"pg_load": [
            {"seq": self._pg_load_seq, "ts": time.time(),
             "counters": load}]})

    def _maybe_persist_clog(self, force: bool = False) -> None:
        """Journal the in-memory cluster log through the paxos store
        (LogMonitor parity: dump_cluster_log — and the slow_op events
        in it — survive a mon restart).  Debounced by
        mon_clog_persist_interval_s and skipped when nothing new was
        sequenced.  Caller holds _lock; leader only (followers adopt
        the replicated snapshot in _apply_replicated).  NEVER called
        from inside a map/auth commit — a nested commit would steal
        the version the outer one already claimed."""
        if not self.is_leader:
            return
        now = time.monotonic()
        if not force and now - self._clog_persisted_at < \
                self.cfg["mon_clog_persist_interval_s"]:
            return
        snap = self.cluster_log.snapshot(
            max_events=self.cfg["mon_cluster_log_size"])
        if snap["seq"] == self._clog_persisted_seq and not force:
            return
        self._clog_persisted_at = now
        self._clog_persisted_seq = snap["seq"]
        raw = json.dumps(snap).encode()
        desc = f"clusterlog @{snap['seq']}"
        if not self.peers:
            self.store.commit("clusterlog", raw, desc)
            return
        v = self.store.accepted_version + 1
        self.store.accept_at(v, self._term, "clusterlog", raw, desc)
        self._pending_acks[v] = {self.name}
        prop = MMonPropose(self._term, v, "clusterlog", raw, desc,
                           pterm=self._term, commit=self.store.version)
        for p in self.peers:
            self._post(p, prop)

    def _pool_by_name(self, name: str):
        for p in self.osdmap.pools.values():
            if p.name == name:
                return p
        return None

    def _pool_create(self, cmd: dict):
        name = cmd["name"]
        with self._lock:
            if any(p.name == name for p in self.osdmap.pools.values()):
                return -17, {"error": f"pool {name!r} exists"}
            kind = cmd.get("kind", "replicated")
            pg_num = int(cmd.get("pg_num",
                                 self.cfg["osd_pool_default_pg_num"]))
            if kind == "ec":
                # profiles are string->string on the wire; coerce up front
                # so a malformed profile can never poison map encoding
                profile = {str(k): str(v) for k, v in
                           (cmd.get("ec_profile") or {}).items()}
                plugin = profile.get("plugin", self.cfg["ec_plugin"])
                # validate the profile by instantiating the plugin — the
                # OSDMonitor::get_erasure_code step (:1977).  The codec
                # is built on the host whatever the profile's backend and
                # device say: the check reads only k, m, the granularity
                # and the stripe geometry, none of which depends on the
                # backend, and the monitor's dispatch thread must not
                # allocate on (or need) a card.  The stored profile stays
                # the caller's.
                codec = ec.factory(plugin, host_check_profile(profile))
                # the stripe geometry contract is part of profile
                # validation (ECUtil EC_ALIGN_SIZE + plugin minimum
                # granularity): reject here, not on the OSD dispatch
                # thread at first IO
                from ..ec.stripe import StripeInfo
                try:
                    unit = int(profile.get(
                        "stripe_unit", self.cfg["osd_ec_stripe_unit"]))
                    StripeInfo(codec.k, codec.m, unit)
                except (ValueError, TypeError) as e:
                    return -22, {"error": f"bad stripe_unit: {e}"}
                gran = codec.get_minimum_granularity()
                if gran > 1 and unit % gran:
                    import math
                    ok_unit = gran * 4096 // math.gcd(gran, 4096)
                    return -22, {"error":
                                 f"stripe_unit {unit} must be a multiple "
                                 f"of the plugin granularity {gran} "
                                 f"(smallest page-aligned: {ok_unit})"}
                size = codec.k + codec.m
                # k+1 so an acked write survives one immediate failure
                # (the reference's EC min_size default)
                min_size = min(codec.k + 1, size)
            else:
                # replicated pools still carry pass-through pool options
                # (read_policy etc.) in the profile mapping — same
                # string->string coercion as the EC path so map encoding
                # can never be poisoned
                profile = {str(k): str(v) for k, v in
                           (cmd.get("ec_profile") or {}).items()}
                size = int(cmd.get("size", self.cfg["osd_pool_default_size"]))
                min_size = max(1, size - 1)
            # per-pool compression options (compression_mode/algorithm/
            # required_ratio/min_blob_size) validate at create time — a
            # bad algorithm name must fail THIS command, not every
            # OSD's write path at first IO
            try:
                from ..osd.compression import validate_pool_opts
                validate_pool_opts(profile)
            except (ValueError, TypeError) as e:
                return -22, {"error": f"bad compression options: {e}"}
            spec = PoolSpec(self.osdmap.next_pool_id, name, kind, size,
                            min_size, pg_num, profile)
            self.osdmap.add_pool(spec)
            try:
                self._commit_map(f"pool create {name} ({kind})")
            except Exception:
                # never leave a phantom pool that wedges future commits
                self.osdmap.pools.pop(spec.pool_id, None)
                raise
            return 0, {"pool_id": spec.pool_id, "size": size,
                       "pg_num": pg_num}

    def _dump(self) -> dict:
        return {
            "epoch": self.osdmap.epoch,
            "osds": [{"id": o.osd_id, "up": o.up, "in": o.in_cluster,
                      "host": o.host, "weight": o.weight}
                     for o in sorted(self.osdmap.osds.values(),
                                     key=lambda x: x.osd_id)],
            "pools": [{"id": p.pool_id, "name": p.name, "kind": p.kind,
                       "size": p.size, "pg_num": p.pg_num,
                       "ec_profile": dict(p.ec_profile)}
                      for p in sorted(self.osdmap.pools.values(),
                                      key=lambda x: x.pool_id)],
        }
