"""Client-side dmclock: per-tenant (delta, rho) tag bookkeeping.

The capability of the reference's vendored dmclock ServiceTracker
(src/dmclock/src/dmclock_client.h): a client talking to MANY servers
must tell each server how much service it received *elsewhere* since
its last request to that server, or every server would grant the
tenant its full reservation independently and the cluster-wide floor
would multiply by the server count.  The protocol needs no global
clock — only two monotone counters per client:

- ``delta``: responses received from ANY server since the last request
  to this server (+1 for the request being tagged) — advances the
  server's proportional (weight) tag by ``delta / W``;
- ``rho``: the subset of those responses served in the RESERVATION
  phase (+1) — advances the server's reservation tag by ``rho / R``.

Servers learn the phase they served each op under from the trailing
``qphase`` field on op replies; the tracker folds those back in via
``note_reply``.  Per-server state resets on reconnect (``forget``) and
decays when a server goes idle-cold (``idle_age_s``) — a tenant that
stopped talking to an OSD for minutes must restart from (1, 1), not
replay an ancient backlog of foreign service into its first tag.
"""

from __future__ import annotations

import threading
import time

#: service-phase codes carried in MOSDOpReply.qphase (0 = scheduler
#: off / untagged: the op never crossed a dmclock queue)
PHASE_NONE = 0
PHASE_RESERVATION = 1
PHASE_WEIGHT = 2

#: sanity clamp on wire-carried tags: a buggy or hostile client must
#: not be able to fast-forward a server's clocks arbitrarily far
TAG_CAP = 10_000


class ServiceTracker:
    """One tenant's view of its own cluster-wide service.

    One instance per client (the client IS one tenant); thread-safe —
    the aio pool sends ops from several threads at once.
    """

    def __init__(self, idle_age_s: float = 300.0,
                 clock=time.monotonic):
        self.idle_age_s = float(idle_age_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._delta_total = 0   # responses received, any phase
        self._rho_total = 0     # responses served by reservation
        # server -> {"delta_seen", "rho_seen", "last"}: the totals at
        # the moment of the last request to that server
        self._servers: dict[str, dict] = {}
        self._last_sweep = clock()

    # ------------------------------------------------------------ feedback
    def note_reply(self, server: str, phase: int) -> None:
        """Fold one op reply's phase into the totals (any server)."""
        with self._lock:
            self._delta_total += 1
            if phase == PHASE_RESERVATION:
                self._rho_total += 1

    # ------------------------------------------------------------- tagging
    def tags_for(self, server: str) -> tuple[int, int]:
        """(delta, rho) for the next request to ``server``; both count
        the request itself, so the floor is (1, 1) — a client's very
        first op, or its first after a reset, carries the neutral tag."""
        now = self._clock()
        with self._lock:
            if now - self._last_sweep > self.idle_age_s:
                self._sweep_locked(now)
            st = self._servers.get(server)
            if st is None:
                st = self._servers[server] = {
                    "delta_seen": self._delta_total,
                    "rho_seen": self._rho_total, "last": now}
                return 1, 1
            if now - st["last"] > self.idle_age_s:
                # idle decay: restart the pair, don't replay history
                st["delta_seen"] = self._delta_total
                st["rho_seen"] = self._rho_total
                st["last"] = now
                return 1, 1
            delta = min(TAG_CAP,
                        self._delta_total - st["delta_seen"] + 1)
            rho = min(TAG_CAP, self._rho_total - st["rho_seen"] + 1)
            st["delta_seen"] = self._delta_total
            st["rho_seen"] = self._rho_total
            st["last"] = now
            return delta, rho

    def forget(self, server: str) -> None:
        """Reconnect reset: the server's dmclock state died with its
        old process (or our connection), so the pair restarts at the
        neutral (1, 1) on the next request."""
        with self._lock:
            self._servers.pop(server, None)

    def _sweep_locked(self, now: float) -> None:
        self._last_sweep = now
        for s, st in list(self._servers.items()):
            if now - st["last"] > self.idle_age_s:
                del self._servers[s]

    # -------------------------------------------------------- introspection
    def totals(self) -> tuple[int, int]:
        """(delta_total, rho_total) — test/diagnostic surface."""
        with self._lock:
            return self._delta_total, self._rho_total

    def tracked_servers(self) -> list[str]:
        with self._lock:
            return sorted(self._servers)
