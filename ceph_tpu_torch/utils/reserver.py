"""AsyncReserver: priority-ordered bounded grant slots.

The capability of the reference's AsyncReserver<T> (src/common/
AsyncReserver.h: request_reservation queues by priority, up to
max_allowed reservations are granted concurrently, release/cancel frees
a slot and grants the next-highest-priority waiter) — the primitive
under the OSD's local/remote backfill reservers
(src/osd/OSD.h local_reserver/remote_reserver; osd_max_backfills).

Grant callbacks run on the caller's thread (request or release); they
must be quick and must not re-enter the reserver while holding their
own locks that a release path could also take.

Preemption of lower-priority holders (MAX_PRIORITY forced backfill) is
not implemented; waiters simply queue above them.
"""

from __future__ import annotations

import heapq
import itertools
import threading


class AsyncReserver:
    def __init__(self, max_allowed: int = 1):
        self.max_allowed = max(1, int(max_allowed))
        self._lock = threading.Lock()
        self._held: set = set()
        self._pending: list = []            # heap of (-prio, seq, key)
        self._cbs: dict = {}                # key -> on_grant
        self._seq = itertools.count()
        self.grant_waits = 0                # waiters that ever queued

    def request(self, key, priority: int, on_grant) -> None:
        """Queue a reservation; on_grant() fires when a slot is free
        (possibly immediately, on this thread).  Re-requesting a held or
        pending key is a no-op."""
        grant = False
        with self._lock:
            if key in self._held or key in self._cbs:
                return
            if len(self._held) < self.max_allowed and not self._pending:
                self._held.add(key)
                grant = True
            else:
                self.grant_waits += 1
                heapq.heappush(self._pending,
                               (-int(priority), next(self._seq), key))
                self._cbs[key] = on_grant
        if grant:
            on_grant()

    def release(self, key) -> None:
        """Free a held slot (or cancel a pending request); grants the
        next waiter in priority order."""
        grants = []
        with self._lock:
            if key in self._cbs and key not in self._held:
                # cancel-while-pending: drop lazily (skipped on pop)
                del self._cbs[key]
            self._held.discard(key)
            while (self._pending
                   and len(self._held) < self.max_allowed):
                _, _, nxt = heapq.heappop(self._pending)
                cb = self._cbs.pop(nxt, None)
                if cb is None:
                    continue  # cancelled while pending
                self._held.add(nxt)
                grants.append(cb)
        for cb in grants:
            cb()

    def held(self, key) -> bool:
        with self._lock:
            return key in self._held

    def keys(self) -> list:
        """Currently-held keys (for liveness GC by the owner)."""
        with self._lock:
            return list(self._held)

    def stats(self) -> dict:
        with self._lock:
            return {"held": len(self._held),
                    "pending": len(self._cbs) - sum(
                        1 for k in self._cbs if k in self._held),
                    "grant_waits": self.grant_waits}
