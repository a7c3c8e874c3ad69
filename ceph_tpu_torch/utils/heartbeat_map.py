"""HeartbeatMap: internal worker-thread watchdog.

The capability of the reference's HeartbeatMap
(src/common/HeartbeatMap.{h,cc}): worker threads register and check in
with a grace window; a thread that stops checking in past its grace is
reported unhealthy (health warnings), and past the suicide grace the
configured callback fires (the reference aborts the daemon so an
external supervisor restarts it).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class _Handle:
    name: str
    grace: float
    suicide_grace: float
    last: float = field(default_factory=time.monotonic)


class HeartbeatMap:
    def __init__(self, on_suicide=None, clock=time.monotonic):
        self._handles: dict[str, _Handle] = {}
        self._lock = threading.Lock()
        self._on_suicide = on_suicide
        self._clock = clock

    def add_worker(self, name: str, grace: float,
                   suicide_grace: float = 0.0) -> None:
        with self._lock:
            self._handles[name] = _Handle(name, grace, suicide_grace,
                                          self._clock())

    def remove_worker(self, name: str) -> None:
        with self._lock:
            self._handles.pop(name, None)

    def touch(self, name: str) -> None:
        """Worker check-in (reset_timeout role)."""
        with self._lock:
            h = self._handles.get(name)
            if h is not None:
                h.last = self._clock()

    def is_healthy(self, name: str | None = None) -> bool:
        now = self._clock()
        with self._lock:
            if name is not None:
                h = self._handles.get(name)
                if h is None:
                    return False  # unregistered/dead worker is NOT healthy
                handles = [h]
            else:
                handles = list(self._handles.values())
        return all(now - h.last <= h.grace for h in handles)

    def unhealthy_workers(self) -> list[dict]:
        now = self._clock()
        with self._lock:
            handles = list(self._handles.values())
        return [{"name": h.name, "stalled_for": now - h.last,
                 "grace": h.grace}
                for h in handles if now - h.last > h.grace]

    def check(self) -> list[dict]:
        """Periodic sweep: returns unhealthy workers and fires the
        suicide callback for any past its suicide grace."""
        bad = self.unhealthy_workers()
        now = self._clock()
        with self._lock:
            doomed = [h for h in self._handles.values()
                      if h.suicide_grace > 0
                      and now - h.last > h.suicide_grace]
        for h in doomed:
            if self._on_suicide is not None:
                self._on_suicide(h.name)
        return bad
