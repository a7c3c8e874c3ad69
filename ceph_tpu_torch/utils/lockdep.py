"""Lockdep: runtime lock-order validation (deadlock detection).

The capability of the reference's lockdep (src/common/lockdep.cc —
mutexes registered by name; every acquisition records the set of locks
already held, building a global order graph; an acquisition that would
create a CYCLE in that graph is reported as a potential ABBA deadlock
the moment the ordering is violated, not the day both threads race):

- wrap(lock, name) / Lockdep.mutex(name) give named, checked locks;
- per-thread held-stacks feed a global edge set (held -> acquiring);
- a new edge that closes a cycle raises (tests) or logs (daemons),
  with both conflicting orders' names;
- re-entrant acquisition of an RLock by its holder is exempt, as in
  the reference (recursive mutexes register differently).

Off by default (zero overhead unless enabled) — the thrash/unit suites
turn it on around the structures whose ordering matters (MDS rank
locks vs the subtree map lock, OSD pending vs store locks).
"""

from __future__ import annotations

import threading

_STATE = threading.local()


class LockOrderError(RuntimeError):
    pass


class Lockdep:
    """A lock-order registry: one per validated domain (or use the
    module-level global())."""

    def __init__(self, raise_on_cycle: bool = True):
        self._edges: dict[str, set[str]] = {}   # held -> then-acquired
        self._where: dict[tuple, str] = {}
        self._lock = threading.Lock()
        self.raise_on_cycle = raise_on_cycle
        self.violations: list[str] = []
        self.enabled = True

    # ---------------------------------------------------------- tracking
    def _held(self) -> list:
        stack = getattr(_STATE, "stack", None)
        if stack is None:
            stack = _STATE.stack = []
        return stack

    def _reaches(self, src: str, dst: str) -> bool:
        seen, todo = set(), [src]
        while todo:
            cur = todo.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            todo.extend(self._edges.get(cur, ()))
        return False

    def note_acquire(self, name: str, owner_reentrant: bool) -> None:
        if not self.enabled:
            return
        stack = self._held()
        if owner_reentrant and name in [n for n, _d in stack]:
            stack.append((name, True))  # recursive re-entry: exempt
            return
        with self._lock:
            for held, _deep in stack:
                if held == name:
                    continue
                # adding held -> name; a path name -> held means the
                # REVERSE order exists somewhere: cycle = ABBA
                if self._reaches(name, held):
                    msg = (f"lock order violation: acquiring "
                           f"{name!r} while holding {held!r}, but the "
                           f"order {name!r} -> {held!r} was also "
                           f"observed (potential ABBA deadlock)")
                    self.violations.append(msg)
                    if self.raise_on_cycle:
                        raise LockOrderError(msg)
                self._edges.setdefault(held, set()).add(name)
        stack.append((name, False))

    def note_release(self, name: str) -> None:
        if not self.enabled:
            return
        stack = self._held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                del stack[i]
                return

    # ---------------------------------------------------------- factories
    def wrap(self, lock, name: str) -> "CheckedLock":
        return CheckedLock(self, lock, name)

    def mutex(self, name: str, recursive: bool = False) -> "CheckedLock":
        lk = threading.RLock() if recursive else threading.Lock()
        return CheckedLock(self, lk, name, recursive=recursive)


class CheckedLock:
    """A context-manager lock that reports acquisition order."""

    def __init__(self, dep: Lockdep, lock, name: str,
                 recursive: bool | None = None):
        self._dep = dep
        self._lock = lock
        self.name = name
        self._recursive = (isinstance(lock, type(threading.RLock()))
                           if recursive is None else recursive)

    def acquire(self, *a, **kw):
        self._dep.note_acquire(self.name, self._recursive)
        try:
            return self._lock.acquire(*a, **kw)
        except BaseException:
            self._dep.note_release(self.name)
            raise

    def release(self):
        self._lock.release()
        self._dep.note_release(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


_GLOBAL: Lockdep | None = None


def global_lockdep() -> Lockdep:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = Lockdep()
    return _GLOBAL
