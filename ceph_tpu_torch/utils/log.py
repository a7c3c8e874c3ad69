"""Structured logging with per-subsystem levels and a crash-dump ring.

The capability of the reference's dout/Log (src/log/Log.cc async ring
logger, src/common/dout.h gather macros, src/common/subsys.h per-subsystem
levels — SURVEY.md §2.2): cheap level checks per subsystem, and a bounded
in-memory "recent" ring that can be dumped on crash at higher verbosity
than what went to disk.  Built over the stdlib logging sinks.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

SUBSYS_DEFAULTS = {
    "osd": 1, "mon": 1, "msg": 0, "ec": 1, "client": 1, "store": 1,
    "pg": 1, "bench": 1, "crush": 1,
}


class LogEntry:
    __slots__ = ("stamp", "subsys", "level", "message")

    def __init__(self, subsys: str, level: int, message: str):
        self.stamp = time.time()
        self.subsys = subsys
        self.level = level
        self.message = message

    def format(self) -> str:
        return (f"{time.strftime('%H:%M:%S', time.localtime(self.stamp))}"
                f".{int(self.stamp % 1 * 1000):03d} {self.level:2d} "
                f"{self.subsys}: {self.message}")


class ClusterLogger:
    """Per-process logger: subsystem levels + recent ring."""

    def __init__(self, recent_size: int = 10000, default_level: int = 1):
        self._levels = dict(SUBSYS_DEFAULTS)
        self._default = default_level
        self._recent: collections.deque[LogEntry] = collections.deque(
            maxlen=recent_size)
        self._lock = threading.Lock()
        self._py = logging.getLogger("ceph_tpu")

    def set_level(self, subsys: str, level: int) -> None:
        self._levels[subsys] = level

    def should_log(self, subsys: str, level: int) -> bool:
        return level <= self._levels.get(subsys, self._default)

    def log(self, subsys: str, level: int, message: str) -> None:
        entry = LogEntry(subsys, level, message)
        with self._lock:
            self._recent.append(entry)  # ring keeps high-verbosity history
        if self.should_log(subsys, level):
            self._py.log(logging.DEBUG if level > 1 else logging.INFO,
                         "%s: %s", subsys, message)

    def dout(self, subsys: str, level: int = 1):
        """Gather-style helper: log.dout("osd", 5)("message %s", x)."""
        def emit(fmt: str, *args) -> None:
            self.log(subsys, level, fmt % args if args else fmt)
        return emit

    def dump_recent(self, max_entries: int | None = None) -> list[str]:
        """The crash-dump path: the ring at full verbosity."""
        with self._lock:
            entries = list(self._recent)
        if max_entries:
            entries = entries[-max_entries:]
        return [e.format() for e in entries]


_GLOBAL = ClusterLogger()


def global_logger() -> ClusterLogger:
    return _GLOBAL


def dout(subsys: str, level: int = 1):
    return _GLOBAL.dout(subsys, level)
