"""Lockdep (src/common/lockdep.cc role): lock-order cycle detection at
the moment of violation, not when the deadlock finally races.  The JAX
package's tests/test_lockdep.py on ceph_tpu_torch."""

import threading

import pytest

from ceph_tpu_torch.utils.lockdep import Lockdep, LockOrderError


def test_consistent_order_passes():
    dep = Lockdep()
    a, b, c = dep.mutex("a"), dep.mutex("b"), dep.mutex("c")
    for _ in range(3):
        with a, b, c:
            pass
    assert dep.violations == []


def test_abba_detected_without_deadlocking():
    dep = Lockdep()
    a, b = dep.mutex("a"), dep.mutex("b")
    with a, b:
        pass
    # the reverse order is the classic ABBA — detected in ONE thread,
    # no second thread (or actual deadlock) required
    with pytest.raises(LockOrderError):
        with b:
            with a:
                pass


def test_cycle_through_intermediate():
    dep = Lockdep()
    a, b, c = dep.mutex("a"), dep.mutex("b"), dep.mutex("c")
    with a, b:
        pass
    with b, c:
        pass
    with pytest.raises(LockOrderError):
        with c:
            with a:  # a->b->c exists; c->a closes the cycle
                pass


def test_recursive_reentry_exempt():
    dep = Lockdep()
    r = dep.mutex("r", recursive=True)
    with r:
        with r:  # same-thread re-entry: not an ordering event
            pass
    assert dep.violations == []


def test_per_thread_stacks():
    dep = Lockdep()
    a, b = dep.mutex("a"), dep.mutex("b")
    errs = []

    def t1():
        with a:
            with b:
                pass

    th = threading.Thread(target=t1)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    # this thread holds nothing: acquiring b alone records no a->b
    # reversal
    with b:
        pass
    assert dep.violations == []


def test_mds_rank_lock_order_validated():
    """The ordering contract the MDS rename/export machinery documents
    (rank locks in RANK ORDER, then _maplock) holds under lockdep."""
    dep = Lockdep()
    ranks = [dep.mutex(f"rank{i}", recursive=True) for i in range(3)]
    maplock = dep.mutex("maplock", recursive=True)
    # rename pattern: ordered rank locks, then the map lock
    with ranks[0], ranks[1], maplock:
        pass
    # export pattern: one rank, then the map lock
    with ranks[2], maplock:
        pass
    assert dep.violations == []
    # the FORBIDDEN pattern (maplock before a rank lock) trips
    with pytest.raises(LockOrderError):
        with maplock:
            with ranks[0]:
                pass
