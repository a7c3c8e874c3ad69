"""Throttle: counted backpressure (src/common/Throttle.{h,cc} capability —
SURVEY.md §2.2; wired like the OSD's client message caps,
src/ceph_osd.cc:590-596)."""

from __future__ import annotations

import threading


class Throttle:
    def __init__(self, name: str, max_value: int):
        self.name = name
        self._max = max_value
        self._current = 0
        self._cond = threading.Condition()

    @property
    def current(self) -> int:
        return self._current

    @property
    def max(self) -> int:
        return self._max

    def reset_max(self, max_value: int) -> None:
        with self._cond:
            self._max = max_value
            self._cond.notify_all()

    def get(self, count: int = 1, timeout: float | None = None) -> bool:
        """Block until `count` units fit under the cap; False on timeout.
        Oversized requests (> max) are admitted alone, as the reference
        does, rather than deadlocking."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._current + count <= self._max
                or self._current == 0,
                timeout=timeout)
            if not ok:
                return False
            self._current += count
            return True

    def try_get(self, count: int = 1) -> bool:
        with self._cond:
            if self._current + count <= self._max or self._current == 0:
                self._current += count
                return True
            return False

    def put(self, count: int = 1) -> None:
        with self._cond:
            self._current = max(0, self._current - count)
            self._cond.notify_all()

    def past_midpoint(self) -> bool:
        return self._current * 2 >= self._max
