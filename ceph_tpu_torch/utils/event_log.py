"""Cluster event journal: bounded structured per-daemon logs merged
into one mon-side cluster log.

The capability of the reference's cluster log (src/common/LogClient +
src/mon/LogMonitor: daemons append structured entries to a local
bounded journal, ship them to the monitor piggybacked on their regular
reports, and the mon merges them into the channel-filtered log `ceph
-W` tails): every daemon owns an EventLog; events it emits (PG state
transitions, recovery progress, window resizes, health flips) ride the
existing MStatsReport to the monitor, which sequences them into one
ClusterLog ring served by the `dump_cluster_log` admin verb and tailed
by tools/event_tool.py.

An event is a plain dict — it crosses the wire inside the stats report
and the admin-socket JSON unchanged:

    {"ts": float, "daemon": "osd.3", "channel": "pg",
     "severity": "info"|"warn"|"error", "message": str,
     "fields": {...}}           # + "seq" once the mon sequences it

Channels (the `ceph -W <channel>` filter axis):

- ``cluster``  daemon lifecycle: boots, mark-downs
- ``osdmap``   map epoch commits (one event per epoch, desc attached)
- ``pg``       peering rounds: start / done per PG
- ``recovery`` recovery storms: start / progress / done + reservation
  grants — the feed the mgr progress module derives its items from
- ``scrub``    scrub completions (errors counted)
- ``batch``    EC batcher: adaptive-window resizes, shard fall-through
- ``health``   health-check transitions (raised / cleared)
- ``slow_op``  flight recorder: an op crossed osd_op_complaint_time
  (fields carry the op description, duration and — when traced — the
  trace_id whose merged spans dump_historic_slow_ops attaches)

Journals are bounded on BOTH sides: a daemon that cannot reach the mon
drops its oldest pending events (counted, never blocking the heartbeat
thread), and the mon ring keeps the newest ``keep`` merged events.
Delivery is at-least-once: the pending window re-ships with every
report (reports drop SILENTLY on a lossy wire/partition, so no
delivery signal is trusted) until ``prune()`` ages entries out, and
the mon dedupes by the per-daemon ``lseq`` each event carries.
"""

from __future__ import annotations

import threading
import time
from collections import deque

INFO = "info"
WARN = "warn"
ERROR = "error"

CHANNELS = ("cluster", "osdmap", "pg", "recovery", "scrub", "batch",
            "health", "slow_op")


def make_event(daemon: str, channel: str, message: str,
               severity: str = INFO, ts: float | None = None,
               **fields) -> dict:
    """One journal entry.  Field values must stay JSON/codec-plain
    (str/int/float/bool) — events cross the stats-report wire and the
    admin socket as-is."""
    return {"ts": time.time() if ts is None else float(ts),
            "daemon": daemon, "channel": channel,
            "severity": severity, "message": message,
            "fields": dict(fields)}


class EventLog:
    """Per-daemon journal: a bounded ring of recent events (the local
    ``dump_events`` window) plus a bounded pending list awaiting the
    next stats report (the LogClient send queue)."""

    def __init__(self, daemon: str, keep: int = 1024):
        self.daemon = daemon
        self.keep = int(keep)
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.keep)
        self._pending: list[dict] = []
        self._lseq = 0
        self.dropped = 0  # pending overflow (mon unreachable too long)

    def emit(self, channel: str, message: str, severity: str = INFO,
             **fields) -> dict:
        ev = make_event(self.daemon, channel, message, severity,
                        **fields)
        with self._lock:
            # per-daemon shipping sequence: events RE-SHIP with every
            # report until pruned (at-least-once — a lossy wire or
            # partition drops reports SILENTLY, so a delivered signal
            # cannot be trusted either way); the mon dedupes by lseq
            self._lseq += 1
            ev["lseq"] = self._lseq
            self._ring.append(ev)
            self._pending.append(ev)
            if len(self._pending) > self.keep:
                # never block a hot path on a dead mon: shed oldest
                shed = len(self._pending) - self.keep
                del self._pending[:shed]
                self.dropped += shed
        return ev

    def pending(self) -> list[dict]:
        """Snapshot of the unshipped window (stats-report payload) —
        NOT consumed: entries stay pending (and re-ship) until prune()
        ages them out, surviving silently-dropped reports."""
        with self._lock:
            return list(self._pending)

    def prune(self, max_age: float, now: float | None = None) -> None:
        """Age out pending entries older than ``max_age`` seconds —
        each event re-ships for roughly that long (every report inside
        the window), bounding both memory and the retransmission."""
        cutoff = (time.time() if now is None else now) - max_age
        with self._lock:
            self._pending = [e for e in self._pending
                             if e["ts"] >= cutoff]

    def recent(self, n: int | None = None,
               channel: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._ring)
        if channel:
            evs = [e for e in evs if e.get("channel") == channel]
        return evs[-n:] if n else evs


class ClusterLog:
    """Mon-side merged journal: every appended event gets a cluster-wide
    monotonic ``seq`` (the tail cursor `event_tool --follow` polls on)
    and lands in one bounded ring with channel filters."""

    def __init__(self, keep: int = 4096):
        self.keep = int(keep)
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.keep)
        self._seq = 0

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def append(self, ev: dict) -> dict:
        """Sequence + retain one event (a dict shaped by make_event;
        foreign dicts are normalized so a malformed report can never
        poison the ring for every later reader — a junk ts or a
        non-dict fields value degrades to a default, never raises)."""
        try:
            ts = float(ev.get("ts") or 0) or time.time()
        except (TypeError, ValueError):
            ts = time.time()
        fields = ev.get("fields")
        ev = {"ts": ts,
              "daemon": str(ev.get("daemon", "?")),
              "channel": str(ev.get("channel", "cluster")),
              "severity": str(ev.get("severity", INFO)),
              "message": str(ev.get("message", "")),
              "fields": dict(fields) if isinstance(fields, dict)
              else {}}
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
        return ev

    def snapshot(self, max_events: int = 0) -> dict:
        """JSON-plain state for paxos-store journaling (LogMonitor
        parity): the newest ``max_events`` ring entries (0 = all) plus
        the sequence cursor, restorable after a mon restart."""
        with self._lock:
            evs = list(self._ring)
            seq = self._seq
        if max_events and len(evs) > int(max_events):
            evs = evs[-int(max_events):]
        return {"seq": seq, "events": evs}

    def restore(self, snap: dict) -> bool:
        """Adopt a journaled snapshot — only when it is NEWER than the
        in-memory log (a follower with freshly merged entries must not
        roll its ring back under a stale replication).  Returns True
        when adopted."""
        try:
            seq = int(snap.get("seq", 0))
            evs = [e for e in snap.get("events", ())
                   if isinstance(e, dict)]
        except (TypeError, ValueError, AttributeError):
            return False
        with self._lock:
            if seq <= self._seq:
                return False
            self._ring.clear()
            self._ring.extend(evs)
            self._seq = seq
        return True

    def dump(self, channel: str | None = None, since: int = 0,
             max_events: int = 0) -> dict:
        """The ``dump_cluster_log`` document: events with seq > since,
        optionally channel-filtered, newest-last; ``last_seq`` is the
        follow cursor (it advances even when filters hide the new
        events, so a tail never re-reads)."""
        with self._lock:
            evs = list(self._ring)
            last = self._seq
        if since:
            evs = [e for e in evs if e["seq"] > int(since)]
        if channel:
            evs = [e for e in evs if e["channel"] == channel]
        if max_events and len(evs) > int(max_events):
            evs = evs[-int(max_events):]
        return {"events": evs, "last_seq": last}
