"""mClock-style op scheduler: QoS between client, recovery, and scrub —
and, inside the client class, between named TENANTS.

The capability of the reference's OpScheduler + mClockScheduler
(src/osd/scheduler/OpScheduler.h:37, mClockScheduler.cc, vendored
dmclock): ops are tagged per class with reservation / weight / limit
(R, W, L) tags and served reservation-first, then by weighted
proportional share among classes under their limit — so background
recovery and scrub cannot starve client IO, yet keep a guaranteed
floor when the client is idle.

Tenant sub-queues (the dmclock server half, dmclock_server.h role):
client ops carrying a tenant tag land in dynamic per-tenant sub-queues
under the client class.  Tenant tags are assigned at ARRIVAL using the
client-shipped (delta, rho) pair (qos/dmclock.py):

    r_tag = max(prev_r, now - rho/R) + rho/R     (reservation clock)
    p_tag = prev_p + delta/W                     (proportional clock)

so a tenant also being served by OTHER OSDs advances its clocks here
without any cross-server coordination — the multi-server dmclock
correctness property.  Untagged client traffic rides the plain client
queue as the DEFAULT tenant stream.  Tenant profiles (qos/profiles.py)
arrive via the OSDMap; unknown tenants get the default profile.

Sharding (the reference's sharded OpWQ, osd_op_num_shards): ops hash
by PG to one of N independent scheduler shards, each with its own
dmclock state and dequeue worker — PGs execute in parallel inside one
OSD while everything touching one object stays ordered on its shard.
The messenger dispatch thread only classifies and enqueues.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from dataclasses import dataclass

from ..qos.dmclock import (PHASE_NONE, PHASE_RESERVATION,
                           PHASE_WEIGHT, TAG_CAP)
from ..qos.profiles import DEFAULT_TENANT
from ..utils.perf import CounterType, PerfCounters

#: clamp on wire-carried dmclock tags (THE client-side cap, imported:
#: a hostile delta must not fast-forward a tenant's clocks to
#: infinity, and the two ends must agree on the bound)
_TAG_CAP = TAG_CAP

_TENANT_METRIC_RE = re.compile(r"[^a-z0-9_]")


def _tenant_metric(tenant: str) -> str:
    """Sanitized exporter-label stem for a tenant name."""
    return _TENANT_METRIC_RE.sub("_", tenant.lower())[:32] or "default"


#: thread-local service context: the dequeue worker publishes what it
#: is serving (class, phase, tenant) just before running the handler,
#: so the handler — which runs synchronously on the same thread — can
#: stamp the phase onto the op's reply (the dmclock feedback channel)
_service_tls = threading.local()


def current_service() -> tuple[str | None, int, str | None]:
    """(klass, phase, tenant) of the op the CURRENT thread is serving;
    (None, PHASE_NONE, None) off the scheduler workers (fifo mode)."""
    return (getattr(_service_tls, "klass", None),
            getattr(_service_tls, "phase", PHASE_NONE),
            getattr(_service_tls, "tenant", None))


@dataclass
class ClassParams:
    reservation: float  # guaranteed ops/sec (0 = none)
    weight: float       # proportional share when past reservation
    limit: float        # max ops/sec (0 = unlimited)


def register_qos_counters(perf: PerfCounters, classes) -> None:
    """Per-class QoS counters on a daemon registry — the exporter face
    of the scheduler's Python dicts (served/dropped were invisible to a
    live scrape before this).  Idempotent: shards share one registry,
    and re-adding would RESET live counters (PerfCounters.has)."""
    for c in classes:
        for name in (f"mclock_served_{c}", f"mclock_dropped_{c}"):
            if not perf.has(name):
                perf.add(name)
        if not perf.has(f"mclock_depth_{c}"):
            perf.add(f"mclock_depth_{c}", CounterType.U64)
        if not perf.has(f"mclock_qwait_us_{c}"):
            # enqueue->service wait: the quantity QoS actually moves —
            # prom_rules.py stands p50/p99 recording rules on these
            perf.add(f"mclock_qwait_us_{c}", CounterType.HISTOGRAM)


def register_tenant_counters(perf: PerfCounters, tenants) -> None:
    """Per-tenant served/depth/qwait series (``mclock_*_tenant_<t>``).
    The DEFAULT tenant registers at scheduler construction so the
    zeroed schema is stable across backends; named tenants register
    lazily, LRU-bounded by osd_qos_max_tenants — beyond the bound they
    fold into the default series (bounded exporter cardinality)."""
    for t in tenants:
        t = _tenant_metric(t)
        if not perf.has(f"mclock_served_tenant_{t}"):
            perf.add(f"mclock_served_tenant_{t}")
        if not perf.has(f"mclock_depth_tenant_{t}"):
            perf.add(f"mclock_depth_tenant_{t}", CounterType.U64)
        if not perf.has(f"mclock_qwait_us_tenant_{t}"):
            perf.add(f"mclock_qwait_us_tenant_{t}",
                     CounterType.HISTOGRAM)


class MClockScheduler:
    """Single-server dmclock over named classes (+ tenant sub-queues
    under the client class).

    Class tag rules (dmclock paper / mClockScheduler.cc):
      r_tag = max(now, prev_r + 1/R)    (reservation clock)
      p_tag = max(now, prev_p + 1/W)    (proportional virtual clock)
      l_tag = max(now, prev_l + 1/L)    (limit clock)
    Serve: earliest r_tag <= now first; otherwise smallest p_tag among
    classes whose l_tag <= now; otherwise wait for the nearest tag.
    When the client class wins, a second-level dmclock pick chooses
    among its tenant streams by the arrival-assigned tags.
    """

    #: per-class queue bound: a rate-limited class must not buffer an
    #: unbounded backlog of full message payloads (drops are the lossy
    #: messenger semantic; recovery retries via requery rounds)
    QUEUE_CAP = 512

    #: the client class (the only one with tenant sub-queues)
    CLIENT = "client"

    def __init__(self, handler, classes: dict[str, ClassParams],
                 name: str = "mclock", clock=time.monotonic,
                 perf: PerfCounters | None = None,
                 tenant_profiles: dict[str, ClassParams] | None = None,
                 max_tenants: int = 64):
        self._handler = handler
        self._classes = {}
        for c, p in classes.items():
            self._classes[c] = self._clamp(p)
        self._clock = clock
        self.dropped: dict[str, int] = {c: 0 for c in classes}
        self._queues: dict[str, collections.deque] = {
            c: collections.deque() for c in classes}
        # parallel enqueue stamps feeding the per-class wait histogram;
        # tests that append to _queues directly simply record no stamp
        self._stamps: dict[str, collections.deque] = {
            c: collections.deque() for c in classes}
        self._tags = {c: {"r": 0.0, "p": 0.0, "l": 0.0} for c in classes}
        # ---- tenant sub-queue state (client class only) ----
        self._tparams: dict[str, ClassParams] = {
            t: self._clamp(p)
            for t, p in (tenant_profiles or {}).items()}
        self._max_tenants = max(1, int(max_tenants))
        # tenant -> deque of (item, stamp, r_tag|None, p_tag)
        self._tqueues: dict[str, collections.deque] = {}
        self._ttags: dict[str, dict] = {}   # tenant -> {"r","p","l"}
        self._ttouch: dict[str, float] = {}  # tenant -> last enqueue
        self.tenant_served: dict[str, int] = {}
        self.tenant_dropped: dict[str, int] = {}
        self.tenant_evicted = 0   # LRU evictions (profile state dropped)
        self.tenant_folded = 0    # ops folded into the default stream
        # client-stream virtual time: the proportional round of the
        # most recent client serve.  A stream that registers (or goes
        # idle->busy) while NOTHING else is queued seeds its p clock
        # here — joining the current round — instead of starting at 0
        # and outranking every stream that has been paying share all
        # along (symmetrically: untagged history must not starve a
        # new tenant, and tenant history must not starve untagged)
        self._client_vtime = 0.0
        # metric names are registered at most max_tenants deep, EVER:
        # tenants past the bound account into the default series
        self._tenant_metrics: set[str] = set()
        # cached pick of the client sub-stream, computed by _pick under
        # the lock and consumed by _dequeue_locked in the same hold
        self._client_choice: tuple | None = None
        self._cv = threading.Condition()
        self._stop = False
        self.served: dict[str, int] = {c: 0 for c in classes}
        self._perf = perf
        if perf is not None:
            register_qos_counters(perf, classes)
            register_tenant_counters(perf, (DEFAULT_TENANT,))
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)

    @staticmethod
    def _clamp(p: ClassParams) -> ClassParams:
        if p.limit > 0 and p.reservation > p.limit:
            # limit is the hard upper bound: a reservation above it
            # would silently exceed the configured cap
            return ClassParams(p.limit, p.weight, p.limit)
        return p

    def set_params(self, klass: str, p: ClassParams) -> None:
        """Live QoS reconfiguration (the `config set osd_mclock_*` +
        reset path): swap one class's (R, W, L) under the lock; queued
        items keep their positions, tags re-pace from the next pick.
        A class this scheduler has not served yet AUTO-REGISTERS with
        the clamped params — `reset_mclock` against a daemon that
        never saw (say) scrub traffic must configure the class, not
        500 the admin socket with a KeyError."""
        with self._cv:
            if klass not in self._classes:
                self._queues[klass] = collections.deque()
                self._stamps[klass] = collections.deque()
                self._tags[klass] = {"r": 0.0, "p": 0.0, "l": 0.0}
                self.served.setdefault(klass, 0)
                self.dropped.setdefault(klass, 0)
                if self._perf is not None:
                    register_qos_counters(self._perf, (klass,))
            self._classes[klass] = self._clamp(p)
            self._cv.notify_all()

    def set_tenant_profiles(self,
                            profiles: dict[str, ClassParams]) -> None:
        """Swap the named tenant profile book (the OSDMap push): live
        tenant streams re-pace from their next arrival; tenants the new
        book no longer names fall back to the default profile."""
        with self._cv:
            self._tparams = {t: self._clamp(p)
                             for t, p in (profiles or {}).items()}
            self._cv.notify_all()

    def start(self) -> None:
        self._thread.start()

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            # reconcile the depth gauges for items dying in the queues:
            # the registry is injected and may outlive this scheduler
            # (an embedding daemon shutting the scheduler down without
            # dying itself), so an unreconciled gauge would stay
            # inflated forever on later scrapes
            for c, q in self._queues.items():
                if q and self._perf is not None:
                    self._perf.inc(f"mclock_depth_{c}", -len(q))
                q.clear()
                self._stamps[c].clear()
            for t, q in self._tqueues.items():
                if q and self._perf is not None:
                    self._perf.inc(f"mclock_depth_{self.CLIENT}",
                                   -len(q))
                    self._perf.inc(
                        f"mclock_depth_tenant_{self._tenant_key(t)}",
                        -len(q))
                q.clear()
            self._cv.notify_all()
        if self._thread.ident is not None:  # never-started: no join
            self._thread.join(timeout=5)

    # ------------------------------------------------------ tenant plumbing
    def _tenant_key(self, tenant: str) -> str:
        """Metric stem this tenant's counters land on: its own name
        while the registered set is under the cardinality bound, the
        default series beyond it."""
        m = _tenant_metric(tenant)
        if m in self._tenant_metrics:
            return m
        if len(self._tenant_metrics) < self._max_tenants:
            self._tenant_metrics.add(m)
            if self._perf is not None:
                register_tenant_counters(self._perf, (m,))
            return m
        return _tenant_metric(DEFAULT_TENANT)

    def _tenant_params(self, tenant: str) -> ClassParams:
        p = self._tparams.get(tenant)
        if p is None:
            p = self._tparams.get(DEFAULT_TENANT)
        return p if p is not None else ClassParams(0.0, 1.0, 0.0)

    def _register_tenant_locked(self, tenant: str,
                                now: float) -> bool:
        """Admit a tenant stream, LRU-evicting an IDLE stream when at
        the osd_qos_max_tenants bound.  Returns False when no stream
        can be admitted (every existing one has queued work) — the
        caller folds the op into the default/untagged stream instead
        of growing state without bound."""
        if tenant in self._tqueues:
            return True
        if len(self._tqueues) >= self._max_tenants:
            idle = [t for t, q in self._tqueues.items() if not q]
            if not idle:
                return False
            victim = min(idle, key=lambda t: self._ttouch.get(t, 0.0))
            del self._tqueues[victim]
            self._ttags.pop(victim, None)
            self._ttouch.pop(victim, None)
            # fold the victim's tallies into the default key: these
            # dicts must stay bounded under tenant-name churn (the
            # wire-supplied name is never validated — a hostile client
            # rotating names must not grow per-shard state forever)
            for book in (self.tenant_served, self.tenant_dropped):
                n = book.pop(victim, 0)
                if n:
                    book[DEFAULT_TENANT] = \
                        book.get(DEFAULT_TENANT, 0) + n
            self.tenant_evicted += 1
        self._tqueues[tenant] = collections.deque()
        self._ttags.setdefault(tenant,
                               {"r": 0.0, "p": self._client_vtime,
                                "l": 0.0})
        self._ttouch[tenant] = now
        return True

    def _busy_tenant_p_floor(self) -> float | None:
        """min proportional tag among busy client sub-streams (idle ->
        busy catch-up base, same rule as the class level).  The
        untagged stream's floor is the DEFAULT tenant's sub-clock —
        the class-level p tag lives in a different clock domain
        (1/W_class per serve vs 1/W_tenant) and would set a floor
        orders of magnitude off."""
        floors = [q[0][3] for q in self._tqueues.values() if q]
        if self._queues[self.CLIENT]:
            t = self._ttags.setdefault(DEFAULT_TENANT,
                                       {"r": 0.0, "p": 0.0, "l": 0.0})
            floors.append(t["p"])
        return min(floors) if floors else None

    def _enqueue_tenant_locked(self, tenant: str, item,
                               tags, now: float,
                               trace_id=None, force: bool = False) -> bool:
        """Queue one tenant-tagged client op with arrival-time dmclock
        tags.  Returns False when the op should ride the untagged
        stream instead (tenant table full of busy streams).  ``force``
        bypasses the QUEUE_CAP drop, as in ``enqueue``."""
        if not self._register_tenant_locked(tenant, now):
            self.tenant_folded += 1
            return False
        q = self._tqueues[tenant]
        if len(q) >= self.QUEUE_CAP and not force:
            self.dropped[self.CLIENT] += 1
            self.tenant_dropped[tenant] = \
                self.tenant_dropped.get(tenant, 0) + 1
            if self._perf is not None:
                self._perf.inc(f"mclock_dropped_{self.CLIENT}")
            return True  # consumed (dropped) — do not re-route
        p = self._tenant_params(tenant)
        t = self._ttags[tenant]
        delta = min(_TAG_CAP, max(1, int(tags[0]) if tags else 1))
        rho = min(_TAG_CAP, max(1, int(tags[1]) if tags else 1))
        if not q:
            # idle->busy: catch the proportional clock up to the busy
            # minimum — or the current round when nothing is queued —
            # so an idle tenant cannot burst unfairly
            floor = self._busy_tenant_p_floor()
            if floor is None:
                floor = self._client_vtime
            t["p"] = max(t["p"], floor)
        r_tag = None
        if p.reservation > 0:
            # rho responses were served by reservation ELSEWHERE since
            # this tenant's last op here: advance the clock by rho/R,
            # bounded-burst floored at now - 1/R like the class level
            r_tag = max(t["r"], now - 1.0 / p.reservation) \
                + rho / p.reservation
            t["r"] = r_tag
        # arrival-time proportional tag: advanced here for EVERY op,
        # with the increment REMEMBERED so a reservation-phase serve
        # can refund it (dmclock's P-tag compensation: service paid
        # for by the reservation clock must not also consume the
        # tenant's proportional share — without the refund a tenant
        # whose burst rode its reservation starts every later
        # weight-phase round behind tenants that never reserved)
        p_cost = delta / max(p.weight, 1e-9)
        p_tag = t["p"] + p_cost
        t["p"] = p_tag
        q.append((item, now, r_tag, p_tag, p_cost, trace_id))
        self._ttouch[tenant] = now
        if self._perf is not None:
            self._perf.inc(f"mclock_depth_{self.CLIENT}")
            self._perf.inc(
                f"mclock_depth_tenant_{self._tenant_key(tenant)}")
        self._cv.notify()
        return True

    def _client_ready(self, now: float):
        """Second-level dmclock pick among the client sub-streams.
        Returns (choice, wake): choice is ("tenant", name, phase) or
        ("untagged", None, None) when something is serveable now, else
        None with the earliest wake instant among blocked streams."""
        best_r = None    # (r_tag, tenant)
        best_p = None    # (p_tag, tenant | None)
        wake = None
        if self._queues[self.CLIENT]:
            # the untagged stream = the DEFAULT tenant: service-time
            # paced from the default profile's tags
            p = self._tenant_params(DEFAULT_TENANT)
            t = self._ttags.setdefault(DEFAULT_TENANT,
                                       {"r": 0.0, "p": 0.0, "l": 0.0})
            if p.limit > 0 and t["l"] > now:
                wake = t["l"] if wake is None else min(wake, t["l"])
            else:
                if p.reservation > 0 and t["r"] <= now:
                    best_r = (t["r"], None)
                elif p.reservation > 0 and t["r"] > now:
                    wake = t["r"] if wake is None \
                        else min(wake, t["r"])
                if best_p is None or t["p"] < best_p[0]:
                    best_p = (t["p"], None)
        for tenant, q in self._tqueues.items():
            if not q:
                continue
            p = self._tenant_params(tenant)
            t = self._ttags[tenant]
            if p.limit > 0 and t["l"] > now:
                wake = t["l"] if wake is None else min(wake, t["l"])
                continue
            _item, _stamp, r_tag, p_tag, _pc, _tid = q[0]
            if r_tag is not None:
                if r_tag <= now and (best_r is None
                                     or r_tag < best_r[0]):
                    best_r = (r_tag, tenant)
                elif r_tag > now:
                    wake = r_tag if wake is None else min(wake, r_tag)
            if best_p is None or p_tag < best_p[0]:
                best_p = (p_tag, tenant)
        if best_r is not None:
            who = best_r[1]
            if who is None:
                return ("untagged", None, PHASE_RESERVATION), None
            return ("tenant", who, PHASE_RESERVATION), None
        if best_p is not None:
            who = best_p[1]
            if who is None:
                return ("untagged", None, PHASE_WEIGHT), None
            return ("tenant", who, PHASE_WEIGHT), None
        return None, wake

    def _class_catchup_locked(self, klass: str) -> None:
        """Idle->busy: catch the class's proportional clock up to the
        busy minimum so an idle class cannot burst unfairly.  Depth
        counts tenant sub-queues too — in BOTH directions: a client
        class whose work all lives in tenant streams is busy (its p
        must be in everyone else's floor) and is NOT idle (its own p
        must not be yanked up).  Runs for EVERY enqueue path of an
        idle class, tenant-tagged included."""
        if self._cls_depth_locked(klass) != 0:
            return
        busy = [self._tags[c]["p"] for c in self._queues
                if c != klass and self._cls_depth_locked(c)]
        if busy:
            t = self._tags[klass]
            t["p"] = max(t["p"], min(busy))

    # ---------------------------------------------------------------- API
    def enqueue(self, klass: str, item, tenant: str | None = None,
                tags: tuple | None = None, force: bool = False,
                trace_id=None) -> None:
        """``force`` bypasses the lossy QUEUE_CAP drop: completion
        continuations (store commit acks/replies) have no retry path —
        dropping one would wedge its object lock forever — and their
        count is bounded by in-flight ops, not by hostile senders.

        ``trace_id`` rides the queue-wait stamp when the op belongs to
        a SAMPLED trace, landing as the bucket exemplar on the
        ``mclock_qwait_us_*`` histogram at dequeue."""
        with self._cv:
            now = self._clock()
            self._class_catchup_locked(klass)
            if klass == self.CLIENT and tenant \
                    and tenant != DEFAULT_TENANT:
                if self._enqueue_tenant_locked(tenant, item, tags,
                                               now, trace_id=trace_id,
                                               force=force):
                    return
                # fold-through: ride the untagged stream below
            q = self._queues[klass]
            if len(q) >= self.QUEUE_CAP and not force:
                self.dropped[klass] += 1
                if self._perf is not None:
                    self._perf.inc(f"mclock_dropped_{klass}")
                return  # lossy backpressure; senders retry/requery
            if not q and klass == self.CLIENT:
                # the untagged stream's own sub-clock catches up to
                # the busy tenant floor (or the current round when
                # nothing is queued) on idle->busy — a burst of
                # untagged ops must not outrank tenants that have
                # been paying proportional share all along
                floors = [qq[0][3]
                          for qq in self._tqueues.values() if qq]
                floor = min(floors) if floors \
                    else self._client_vtime
                td = self._ttags.setdefault(
                    DEFAULT_TENANT, {"r": 0.0, "p": 0.0, "l": 0.0})
                td["p"] = max(td["p"], floor)
            q.append(item)
            self._stamps[klass].append((now, trace_id))
            if self._perf is not None:
                self._perf.inc(f"mclock_depth_{klass}")
            self._cv.notify()

    def _cls_depth_locked(self, klass: str) -> int:
        n = len(self._queues[klass])
        if klass == self.CLIENT:
            n += sum(len(q) for q in self._tqueues.values())
        return n

    def queue_depth(self, klass: str | None = None) -> int:
        with self._cv:
            if klass is not None:
                return self._cls_depth_locked(klass)
            return sum(self._cls_depth_locked(c) for c in self._queues)

    def queue_depths(self) -> dict[str, int]:
        with self._cv:
            return {c: self._cls_depth_locked(c) for c in self._queues}

    def tenant_depths(self) -> dict[str, int]:
        with self._cv:
            out = {t: len(q) for t, q in self._tqueues.items()}
            if self._queues.get(self.CLIENT):
                out[DEFAULT_TENANT] = out.get(DEFAULT_TENANT, 0) \
                    + len(self._queues[self.CLIENT])
            return out

    def tenant_served_snapshot(self) -> dict[str, int]:
        """Locked copy for monitor paths: the worker inserts first-
        seen tenant keys concurrently, and iterating the live dict
        from a sampler/admin thread can blow up mid-walk."""
        with self._cv:
            return dict(self.tenant_served)

    # ------------------------------------------------------------ worker
    def _pick(self, now: float):
        """(klass, phase) to serve now, or (None, wake_at).

        Tags hold NEXT-ELIGIBLE instants: "r" the next reservation
        service, "l" the next limit-allowed service; "p" is a virtual
        round number compared only among busy classes.  For the client
        class the second-level tenant pick must also be serveable —
        its choice is cached for _dequeue_locked (same lock hold)."""
        self._client_choice = None
        client_wake = None
        client_ok = True
        if self.CLIENT in self._queues \
                and self._cls_depth_locked(self.CLIENT):
            # consult the sub-pick when tenant streams hold work, OR
            # when a committed DEFAULT profile carries a reservation/
            # limit (the untagged stream's pacing lives in the sub-
            # pick — it must not depend on unrelated tenants being
            # busy); otherwise the plain path stays byte-identical to
            # the pre-tenant logic
            dp = self._tparams.get(DEFAULT_TENANT)
            if any(q for q in self._tqueues.values()) \
                    or (dp is not None
                        and (dp.reservation > 0 or dp.limit > 0)):
                choice, client_wake = self._client_ready(now)
                self._client_choice = choice
                client_ok = choice is not None
        best_r = None
        wake = client_wake
        for c, q in self._queues.items():
            if not self._cls_depth_locked(c):
                continue
            if c == self.CLIENT and not client_ok:
                continue
            p = self._classes[c]
            if p.reservation > 0:
                r_next = self._tags[c]["r"]
                if r_next <= now and (best_r is None
                                      or r_next < best_r[1]):
                    best_r = (c, r_next)
                elif r_next > now:
                    wake = r_next if wake is None else min(wake, r_next)
        if best_r is not None:
            return best_r[0], "reservation"
        best_p = None
        for c, q in self._queues.items():
            if not self._cls_depth_locked(c):
                continue
            if c == self.CLIENT and not client_ok:
                continue
            p = self._classes[c]
            if p.limit > 0 and self._tags[c]["l"] > now:
                l_next = self._tags[c]["l"]
                wake = l_next if wake is None else min(wake, l_next)
                continue
            p_tag = self._tags[c]["p"]
            if best_p is None or p_tag < best_p[1]:
                best_p = (c, p_tag)
        if best_p is not None:
            return best_p[0], "weight"
        return None, wake

    def _account(self, c: str, phase: str, now: float) -> None:
        p = self._classes[c]
        t = self._tags[c]
        if p.reservation > 0 and phase == "reservation":
            # bounded burst of one: an idle class's clock resets near now
            t["r"] = max(t["r"], now - 1.0 / p.reservation) \
                + 1.0 / p.reservation
        if p.limit > 0:
            t["l"] = max(t["l"], now - 1.0 / p.limit) + 1.0 / p.limit
        if phase == "weight":
            # reservation-phase service must NOT also consume the
            # class's proportional share (the dmclock P-tag compensation)
            t["p"] = t["p"] + 1.0 / max(p.weight, 1e-9)

    def _account_tenant(self, tenant: str, phase_code: int,
                        now: float) -> None:
        """Service-time accounting for a sub-stream: the limit clock
        paces here (arrival tags already advanced r/p at enqueue for
        named tenants; the untagged/default stream paces all three)."""
        p = self._tenant_params(tenant)
        t = self._ttags.setdefault(tenant,
                                   {"r": 0.0, "p": 0.0, "l": 0.0})
        if p.limit > 0:
            t["l"] = max(t["l"], now - 1.0 / p.limit) + 1.0 / p.limit
        if tenant == DEFAULT_TENANT:
            # untagged items carry no arrival tags: pace like a class
            if p.reservation > 0 and phase_code == PHASE_RESERVATION:
                t["r"] = max(t["r"], now - 1.0 / p.reservation) \
                    + 1.0 / p.reservation
            if phase_code == PHASE_WEIGHT:
                t["p"] = t["p"] + 1.0 / max(p.weight, 1e-9)

    def _book_service_locked(self, tenant: str, stamp: float | None,
                             now: float, exemplar=None) -> None:
        self.tenant_served[tenant] = \
            self.tenant_served.get(tenant, 0) + 1
        if self._perf is not None:
            key = self._tenant_key(tenant)
            self._perf.inc(f"mclock_served_tenant_{key}")
            if tenant != DEFAULT_TENANT:
                self._perf.inc(f"mclock_depth_tenant_{key}", -1)
            if stamp is not None:
                self._perf.hinc(f"mclock_qwait_us_tenant_{key}",
                                max(0.0, now - stamp) * 1e6,
                                exemplar=exemplar)

    def _dequeue_locked(self, klass: str, res: str, now: float):
        """Pop + account the op the class-level pick chose.  Returns
        (item, phase_code, tenant) — phase is the TENANT-level phase
        for client ops (what the dmclock client's rho consumes)."""
        phase_code = PHASE_RESERVATION if res == "reservation" \
            else PHASE_WEIGHT
        tenant = None
        stamp = None
        if klass == self.CLIENT and self._client_choice is not None:
            kind, who, sub_phase = self._client_choice
            if kind == "tenant":
                q = self._tqueues[who]
                item, stamp, _r, _p, _pc, tid = q.popleft()
                tenant = who
                phase_code = sub_phase
                if sub_phase == PHASE_RESERVATION and _pc > 0.0:
                    # P-tag compensation (the dmclock rule the class
                    # level already applies in _account): this op was
                    # served by the RESERVATION clock, so refund the
                    # proportional advance its arrival charged — from
                    # the tenant's stored tag AND from every op still
                    # queued behind it (their tags were computed on
                    # top of the refunded increment).  The round clock
                    # (_client_vtime) does not advance either: the op
                    # consumed no proportional share.
                    t = self._ttags[who]
                    t["p"] -= _pc
                    if q:
                        self._tqueues[who] = collections.deque(
                            (it, st, r, pt - _pc, pc, ti)
                            for it, st, r, pt, pc, ti in q)
                else:
                    self._client_vtime = max(self._client_vtime, _p)
                self._account(klass, res, now)
                self._account_tenant(who, sub_phase, now)
                self.served[klass] += 1
                if self._perf is not None:
                    self._perf.inc(f"mclock_served_{klass}")
                    self._perf.inc(f"mclock_depth_{klass}", -1)
                    if stamp is not None:
                        self._perf.hinc(f"mclock_qwait_us_{klass}",
                                        max(0.0, now - stamp) * 1e6,
                                        exemplar=tid)
                self._book_service_locked(who, stamp, now,
                                          exemplar=tid)
                return item, phase_code, tenant
            # untagged pick: fall through to the plain pop below,
            # using the sub-pick's phase for the default stream
            phase_code = sub_phase
            tenant = DEFAULT_TENANT
        item = self._queues[klass].popleft()
        self._account(klass, res, now)
        if klass == self.CLIENT:
            self._account_tenant(DEFAULT_TENANT, phase_code, now)
            self._client_vtime = max(
                self._client_vtime,
                self._ttags[DEFAULT_TENANT]["p"])
        self.served[klass] += 1
        tid = None
        if self._perf is not None:
            self._perf.inc(f"mclock_served_{klass}")
            self._perf.inc(f"mclock_depth_{klass}", -1)
            if self._stamps[klass]:
                stamp, tid = self._stamps[klass].popleft()
                self._perf.hinc(f"mclock_qwait_us_{klass}",
                                max(0.0, now - stamp) * 1e6,
                                exemplar=tid)
        elif self._stamps[klass]:
            stamp, tid = self._stamps[klass].popleft()
        if klass == self.CLIENT:
            self._book_service_locked(DEFAULT_TENANT, stamp, now,
                                      exemplar=tid)
            tenant = DEFAULT_TENANT
        return item, phase_code, tenant

    def _run(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._stop:
                        return
                    now = self._clock()
                    klass, res = self._pick(now)
                    if klass is not None:
                        item, phase_code, tenant = \
                            self._dequeue_locked(klass, res, now)
                        break
                    timeout = None if res is None \
                        else max(0.001, res - now)
                    self._cv.wait(timeout=timeout)
            _service_tls.klass = klass
            _service_tls.phase = phase_code
            _service_tls.tenant = tenant
            try:
                self._handler(klass, item)
            except Exception:  # noqa: BLE001 - worker must survive
                from ..utils.log import dout
                import traceback
                dout("osd", 0)("scheduler handler error: %s",
                               traceback.format_exc())
            finally:
                _service_tls.klass = None
                _service_tls.phase = PHASE_NONE
                _service_tls.tenant = None


class ShardedScheduler:
    """N MClockScheduler shards keyed by placement group (the sharded
    OpWQ of src/osd/scheduler/: per-PG parallelism inside one OSD,
    per-shard dmclock QoS, per-object ordering preserved because a
    given key always lands on the same shard)."""

    def __init__(self, handler, classes: dict[str, ClassParams],
                 shards: int = 2, name: str = "mclock",
                 perf: PerfCounters | None = None,
                 tenant_profiles: dict[str, ClassParams] | None = None,
                 max_tenants: int = 64):
        # every shard increments the SAME per-class counters: the
        # registry aggregates naturally, one schema per daemon
        n = max(1, shards)
        self.shards = [MClockScheduler(
            handler, dict(classes), name=f"{name}-s{i}", perf=perf,
            tenant_profiles=self._split_profiles(tenant_profiles, n),
            max_tenants=max_tenants)
            for i in range(n)]

    @staticmethod
    def _split_profiles(profiles, n: int):
        """A committed tenant reservation/limit is a PER-OSD figure:
        each of the N independent shard schedulers enforces 1/N of it,
        so the shards' floors SUM to the committed number instead of
        multiplying it (class-level osd_mclock_* knobs are documented
        per-shard; tenant profiles are operator-facing and are not).
        Weights are ratios — unscaled."""
        if not profiles or n <= 1:
            return profiles
        return {t: ClassParams(p.reservation / n, p.weight,
                               p.limit / n)
                for t, p in profiles.items()}

    def start(self) -> None:
        for s in self.shards:
            s.start()

    def shutdown(self) -> None:
        for s in self.shards:
            s.shutdown()

    def set_params(self, klass: str, p: ClassParams) -> None:
        for s in self.shards:
            s.set_params(klass, p)

    def set_tenant_profiles(self,
                            profiles: dict[str, ClassParams]) -> None:
        split = self._split_profiles(profiles, len(self.shards))
        for s in self.shards:
            s.set_tenant_profiles(split)

    def enqueue(self, klass: str, item, key=None,
                tenant: str | None = None,
                tags: tuple | None = None, force: bool = False,
                trace_id=None) -> None:
        shard = self.shards[hash(key) % len(self.shards)] \
            if key is not None else self.shards[0]
        shard.enqueue(klass, item, tenant=tenant, tags=tags,
                      force=force, trace_id=trace_id)

    def queue_depth(self, klass: str | None = None) -> int:
        return sum(s.queue_depth(klass) for s in self.shards)

    def queue_depths(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for s in self.shards:
            for c, n in s.queue_depths().items():
                out[c] = out.get(c, 0) + n
        return out

    def tenant_depths(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for s in self.shards:
            for t, n in s.tenant_depths().items():
                out[t] = out.get(t, 0) + n
        return out

    @property
    def served(self) -> dict:
        out: dict[str, int] = {}
        for s in self.shards:
            for c, n in s.served.items():
                out[c] = out.get(c, 0) + n
        return out

    @property
    def tenant_served(self) -> dict:
        out: dict[str, int] = {}
        for s in self.shards:
            for t, n in s.tenant_served_snapshot().items():
                out[t] = out.get(t, 0) + n
        return out

    @property
    def dropped(self) -> dict:
        out: dict[str, int] = {}
        for s in self.shards:
            for c, n in s.dropped.items():
                out[c] = out.get(c, 0) + n
        return out
