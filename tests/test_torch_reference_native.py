"""The JAX package's native library in a fresh checkout, and the tests'
guard against that library's build race.

Without ``native/build/`` (a fresh checkout), every xdist worker imports
``tests/test_native.py`` while it collects, and that module's
``native.available()`` runs the reference loader's ``make -s``, which
holds only a thread lock (``ceph_tpu/ops/native.py:59-66``).  Six makes
then write one ``libcephtpu.so``.  A worker that opens the file while
another make's linker is still writing it fails with "file too short",
and the reference keeps that failure for the worker's life: every later
use of the library there fails, and each JAX-package cluster test on a
native EC pool in that worker waits out its client's retries (about
220 s a test).  That is what cut the tier-1 run at its limit.

This module is collected after ``test_native.py`` in every worker, and
xdist schedules no test before every worker has collected.  On import it
clears such a kept failure and loads the library again, under a file
lock, until a whole library loads or a deadline passes
(``reload_reference_native``).  The reference's files stay as they are.
A worker whose ``test_native.py`` collection saw the failure still skips
that file's cases there (its skip condition is fixed at import)."""

import ctypes
import fcntl
import os
import shutil
import sys
import threading
import time

import pytest

from ceph_tpu.ops import native as ref_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the lock the workers' reloads take in turn (the port's build
#: directory is git-ignored; the reference's is left to its loader)
LOCK_PATH = os.path.join(REPO, "ceph_tpu_torch", "build",
                         "reference_native.lock")

#: how long a worker's reload may wait for the other workers' makes
RELOAD_DEADLINE_S = 180.0


def _lock(path: str, deadline: float):
    """An open file holding an exclusive flock on ``path``, or None once
    ``deadline`` (monotonic) has passed without it."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    f = open(path, "a")
    while True:
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return f
        except BlockingIOError:
            if time.monotonic() >= deadline:
                f.close()
                return None
            time.sleep(0.05)


def reload_reference_native(native=ref_native,
                            deadline_s: float = RELOAD_DEADLINE_S,
                            period: float = 0.25,
                            lock_path: str = LOCK_PATH) -> bool:
    """Clear a load failure ``native`` (the reference's loader) keeps,
    and load again every ``period`` s until a whole library loads
    (True) or ``deadline_s`` passes (False: the last failure is kept, as
    before).  A loader that kept no failure is left alone (True).  The
    reference's io_uring binding keeps its own copy of the failure; it
    is cleared with it."""
    if not isinstance(native._LIB_RESULT, Exception):
        return True
    deadline = time.monotonic() + deadline_s
    lockf = _lock(lock_path, deadline)
    if lockf is None:
        return False
    try:
        while True:
            native._LIB_RESULT = None
            try:
                native.lib()
                break
            except native.NativeUnavailable:
                if time.monotonic() >= deadline:
                    return False
                time.sleep(period)
    finally:
        lockf.close()
    uring = sys.modules.get("ceph_tpu.msg.uring")
    if uring is not None and isinstance(uring._LIB_RESULT, Exception) \
            and "native library unavailable" in str(uring._LIB_RESULT):
        uring._LIB_RESULT = None
    return True


RELOADED_AT_COLLECTION = reload_reference_native()

#: the library the reference loads in this checkout
REF_SO = ref_native._SO_PATH


# ------------------------------------------------------------------ tests
@pytest.fixture
def fake_checkout(tmp_path, monkeypatch):
    """The reference loader pointed at a native directory of its own
    under tmp_path, with no sources (never stale once the library is
    there) and nothing loaded; returns the library path it reads."""
    ndir = tmp_path / "native"
    (ndir / "build").mkdir(parents=True)
    so = ndir / "build" / "libcephtpu.so"
    monkeypatch.setattr(ref_native, "_NATIVE_DIR", str(ndir))
    monkeypatch.setattr(ref_native, "_SO_PATH", str(so))
    monkeypatch.setattr(ref_native, "_LIB_RESULT", None)
    return so


def test_the_reference_library_loads_in_every_worker():
    """After collection, this worker holds a loaded reference library
    (the reload at import found nothing to clear, or cleared it)."""
    assert RELOADED_AT_COLLECTION
    assert ref_native.available()
    assert isinstance(ref_native.lib(), ctypes.CDLL)


def test_a_kept_failure_is_cleared_once_the_library_is_whole(
        fake_checkout, tmp_path):
    """A load that read a half-written library fails "file too short"
    and is kept; the reload waits, and loads the library once another
    make has finished writing it."""
    with open(REF_SO, "rb") as f:
        whole = f.read()
    fake_checkout.write_bytes(whole[:32])
    with pytest.raises(ref_native.NativeUnavailable, match="too short"):
        ref_native.lib()
    assert isinstance(ref_native._LIB_RESULT, Exception)

    def finish_the_link():
        time.sleep(0.5)
        part = tmp_path / "part.so"
        part.write_bytes(whole)
        os.replace(part, fake_checkout)

    t = threading.Thread(target=finish_the_link, daemon=True)
    t.start()
    t0 = time.monotonic()
    assert reload_reference_native(deadline_s=30.0, period=0.05,
                                   lock_path=str(tmp_path / "lock"))
    t.join(timeout=10)
    assert time.monotonic() - t0 < 30.0
    assert ref_native.lib()._name == str(fake_checkout)
    assert ref_native.lib().ct_gf_mul(3, 7) == 9


def test_a_library_never_whole_gives_up_at_the_deadline(fake_checkout,
                                                         tmp_path):
    """A library that stays half-written: the reload returns False
    within its deadline and the failure is kept, as the loader kept
    it."""
    fake_checkout.write_bytes(b"\x7fELF" + bytes(28))
    with pytest.raises(ref_native.NativeUnavailable):
        ref_native.lib()
    t0 = time.monotonic()
    assert not reload_reference_native(deadline_s=1.0, period=0.05,
                                       lock_path=str(tmp_path / "lock"))
    assert time.monotonic() - t0 < 5.0
    assert isinstance(ref_native._LIB_RESULT, ref_native.NativeUnavailable)


def test_a_held_lock_gives_up_at_the_deadline(fake_checkout, tmp_path):
    """Another worker holding the reload's lock past the deadline: the
    reload returns False in time instead of waiting on the lock for
    good."""
    fake_checkout.write_bytes(b"")
    with pytest.raises(ref_native.NativeUnavailable):
        ref_native.lib()
    lock = str(tmp_path / "lock")
    holder = _lock(lock, time.monotonic() + 5)
    assert holder is not None
    try:
        t0 = time.monotonic()
        assert not reload_reference_native(deadline_s=1.0, period=0.05,
                                           lock_path=lock)
        assert time.monotonic() - t0 < 5.0
    finally:
        holder.close()


def test_a_loader_that_kept_no_failure_is_left_alone(fake_checkout):
    """Nothing loaded yet, or a library loaded: the reload touches
    neither."""
    assert reload_reference_native(deadline_s=0.0) is True
    assert ref_native._LIB_RESULT is None
    shutil.copyfile(REF_SO, fake_checkout)
    loaded = ref_native.lib()
    assert reload_reference_native(deadline_s=0.0) is True
    assert ref_native._LIB_RESULT is loaded
