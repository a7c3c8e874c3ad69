"""Every wait of the port's harness that a test can reach ends by a
deadline: past it, the wait raises, or kills and reaps, and never
blocks for good.  Each case stages a child or a thread that never ends
(fakes in place of processes, so nothing depends on the box's speed)
and times the wait against its bound."""

import io
import os
import subprocess
import threading
import time

import numpy as np
import pytest

from ceph_tpu_torch.load import generator
from ceph_tpu_torch.load.profiles import LegSpec
from ceph_tpu_torch.parallel import dcn_worker, dryrun
from ceph_tpu_torch.tools import vstart


class _SilentServer:
    """A fork server that runs and never reports an exit."""

    def __init__(self, alive=True):
        self.calls = 0
        self.proc = type("P", (), {"poll": (lambda _s: None) if alive
                                   else (lambda _s: 0)})()

    def exit_code(self, pid):
        return None

    def wait_exit(self, pid, timeout):
        self.calls += 1
        if self.proc.poll() is None:
            time.sleep(timeout or 0)
        return None


class _Unreapable:
    """A child that ignores SIGKILL's reap: every bounded wait times
    out."""

    pid = 999_999
    returncode = None
    stdin = stdout = stderr = None

    def __init__(self):
        self.killed = 0
        self.waits = []

    def poll(self):
        return None

    def kill(self):
        self.killed += 1

    terminate = kill

    def wait(self, timeout=None):
        self.waits.append(timeout)
        if timeout is None:
            raise AssertionError("an unbounded wait")
        raise subprocess.TimeoutExpired("unreapable", timeout)

    def communicate(self, timeout=None):
        return self.wait(timeout)


def test_forked_osd_wait_without_timeout_ends_at_its_deadline(monkeypatch):
    """``ForkedOSD.wait()`` on a server that never reports the exit of a
    running OSD raises TimeoutExpired at WAIT_DEADLINE_S."""
    monkeypatch.setattr(vstart, "WAIT_DEADLINE_S", 0.5)
    osd = vstart.ForkedOSD(_SilentServer(), os.getpid())
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        osd.wait()
    assert 0.4 < time.monotonic() - t0 < 5.0


def test_forked_osd_wait_after_its_server_died_is_paced_and_bounded():
    """The server gone and the OSD still running: the wait polls the
    pid at a pace (it spun before) and raises at its timeout."""
    import os
    server = _SilentServer(alive=False)
    osd = vstart.ForkedOSD(server, os.getpid())
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        osd.wait(timeout=0.5)
    assert time.monotonic() - t0 < 5.0
    assert server.calls <= 20


def test_kill_and_reap_raises_on_a_child_that_is_not_reaped():
    proc = _Unreapable()
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        vstart.kill_and_reap(proc, timeout=0.2)
    assert proc.killed == 1 and proc.waits == [0.2]
    assert time.monotonic() - t0 < 5.0


def test_kill_osd_of_an_unreapable_child_raises():
    """``MiniCluster.kill_osd`` reaps with a deadline."""
    cluster = vstart.MiniCluster(n_osds=0)
    proc = cluster.procs[3] = _Unreapable()
    with pytest.raises(subprocess.TimeoutExpired):
        cluster.kill_osd(3, mark_down=False)
    assert proc.waits == [vstart.REAP_DEADLINE_S]
    cluster.stop()


def test_cluster_stop_tears_everything_down_then_names_the_unreaped():
    """``MiniCluster.stop`` with a child that survives SIGKILL's reap:
    the monitor, the admin sockets and the network still stop, then it
    raises naming the child."""
    cluster = vstart.MiniCluster(n_osds=1).start()
    proc = cluster.procs[5] = _Unreapable()
    with pytest.raises(RuntimeError, match=r"\[5\] not reaped"):
        cluster.stop()
    assert proc.waits == [5, vstart.REAP_DEADLINE_S]
    assert all(o._stop.is_set() for o in cluster.osds.values())


def test_fork_server_stop_reaps_with_a_deadline():
    """``ForkServer.stop`` on a server that ignores its closed stdin
    and SIGKILL's reap raises instead of waiting for good."""
    server = vstart.ForkServer.__new__(vstart.ForkServer)
    server.proc = _Unreapable()
    server.proc.stdin = io.BytesIO()
    with pytest.raises(subprocess.TimeoutExpired):
        server.stop()
    assert server.proc.waits == [10, vstart.REAP_DEADLINE_S]


def test_load_generator_collect_reaps_with_a_deadline():
    """A load worker that outlives its legs and is not reaped after
    SIGKILL: ``collect`` reports both and returns."""
    gen = generator.LoadGenerator("127.0.0.1:1", "p", 1,
                                  [LegSpec(name="w", profile="mixed",
                                           duration_s=0.0)],
                                  procs=1)
    proc = _Unreapable()
    gen.procs_alive = [proc]
    gen.start_at = time.time() - 10
    t0 = time.monotonic()
    out = gen.collect(grace=0.0)
    assert time.monotonic() - t0 < 5.0
    assert not out["ok"]
    assert "no exit" in out["worker_errors"][0]
    assert "not reaped" in out["worker_errors"][1]
    assert proc.waits[:2] == [1.0, generator.REAP_DEADLINE_S]


def test_dcn_launch_cleanup_reaps_with_a_deadline(monkeypatch):
    """A dcn worker that outlives the launch and then its reap: the
    cleanup's wait is bounded too."""
    procs = []

    def popen(*a, **kw):
        procs.append(_Unreapable())
        return procs[-1]

    # the launcher's own view of subprocess, not the process-wide module
    fake = type("Subprocess", (), {"Popen": staticmethod(popen),
                                   "PIPE": subprocess.PIPE,
                                   "TimeoutExpired":
                                   subprocess.TimeoutExpired})
    monkeypatch.setattr(dcn_worker, "subprocess", fake)
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        dcn_worker.launch(num_processes=2, device="cpu", timeout=0.1)
    assert time.monotonic() - t0 < 5.0
    assert procs[0].waits == [0.1, dcn_worker.REAP_DEADLINE_S]


def test_dryrun_batcher_leg_raises_when_a_writer_never_returns(
        monkeypatch):
    """A batcher writer stuck for good: ``batcher_leg`` raises at
    JOIN_DEADLINE_S instead of joining it for good."""
    from ceph_tpu_torch.ec.batcher import ECBatcher

    release = threading.Event()
    monkeypatch.setattr(ECBatcher, "encode",
                        lambda *a, **kw: release.wait(30))
    monkeypatch.setattr(dryrun, "JOIN_DEADLINE_S", 0.3)
    payloads = [np.zeros((8, 64), np.uint8) for _ in range(2)]
    t0 = time.monotonic()
    try:
        with pytest.raises(TimeoutError, match="still runs"):
            dryrun.batcher_leg(1, "cpu", payloads)
    finally:
        release.set()
    assert time.monotonic() - t0 < 10.0
