"""The port's deployment tool (ceph_tpu_torch.tools.cephadm): the cases
of the JAX package's tests/test_rolling_restart.py on the port, its OSD
children the port's ``tools.osd_main`` processes, started with no card
(``device="cpu"``); and the port's additions: the children's admin
sockets and ``dump_process`` verb (``admin_dir``), and a child that
stops when the process that spawned it is gone (``--parent-pid``).

The fixture builds its ``CephAdm`` first and deploys inside the ``try``
whose ``finally`` tears it down: a deploy that times out leaves no child
running (the JAX package's fixture deploys before its ``yield``, so a
failed deploy never reaches its teardown)."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from ceph_tpu_torch.tools import osd_main, vstart
from ceph_tpu_torch.tools.cephadm import CephAdm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- the cases of tests/test_rolling_restart.py -------------------------------
RNG = np.random.default_rng(31)


@pytest.fixture
def adm(tmp_path):
    spec = {"osds": [{"id": i, "store": "filestore"}
                     for i in range(4)],
            "pools": [{"name": "up", "size": 2, "pg_num": 8}]}
    # a loaded CI box can stall a child interpreter past a 2s grace,
    # and the resulting down/up flap cascades re-peer everything for
    # minutes — use a grace that tolerates scheduler starvation
    a = CephAdm(spec, str(tmp_path / "cluster"),
                cfg_overrides={"osd_heartbeat_grace": 5.0},
                device="cpu", admin_dir=str(tmp_path / "asok"))
    try:
        a.deploy()
        yield a
    finally:
        a.teardown()


def test_deploy_and_inventory(adm):
    inv = adm.ls()
    assert [d["daemon"] for d in inv] == \
        ["mon.0", "osd.0", "osd.1", "osd.2", "osd.3"]
    assert all(d["state"] == "running" for d in inv)
    assert all(d["up"] for d in inv if d["type"] == "osd")


def test_rolling_restart_under_load(adm):
    """THE upgrade acceptance test: write before, keep writing DURING
    the staircase, verify everything after — no lost object, no
    client-visible downtime beyond op retries."""
    client = adm.cluster.client()
    objs = {}
    for i in range(12):
        data = RNG.integers(0, 256, 8_000, dtype=np.uint8).tobytes()
        objs[f"pre{i}"] = data
        client.write_full("up", f"pre{i}", data)

    stop = threading.Event()
    errors: list[Exception] = []
    written_during: dict[str, bytes] = {}

    def loader():
        i = 0
        wclient = adm.cluster.client()
        while not stop.is_set():
            name = f"live{i}"
            data = bytes([i % 256]) * 2_000
            # the availability contract allows op RETRIES during the
            # degraded window (a size=2 PG blocks writes while its
            # restarting member is down); what may never happen is an
            # acked write failing to read back
            for attempt in range(4):
                try:
                    wclient.write_full("up", name, data)
                    break
                except Exception as e:  # noqa: BLE001
                    if stop.is_set():
                        # an UNACKED write failing while the test tears
                        # down is within contract — don't record it
                        return
                    if attempt == 3:
                        errors.append(e)
                        return
                    time.sleep(0.5)
            try:
                assert wclient.read("up", name) == data
                written_during[name] = data
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return
            i += 1
            time.sleep(0.05)

    t = threading.Thread(target=loader, daemon=True)
    t.start()
    try:
        order = adm.rolling_restart()
    finally:
        stop.set()
        t.join(timeout=30)
    assert order == [0, 1, 2, 3]
    assert not errors, f"client IO failed mid-upgrade: {errors[0]!r}"
    assert written_during, "loader never completed a write"
    # every object — pre-existing and written mid-staircase — survives.
    # Post-staircase recovery finishes on its own schedule: poll, and
    # only a PERMANENTLY unreadable object fails
    expect = {**objs, **written_during}
    deadline = time.time() + 30
    remaining = dict(expect)
    errs: dict = {}
    while remaining and time.time() < deadline:
        for name in list(remaining):
            try:
                if client.read("up", name) == remaining[name]:
                    del remaining[name]
            except Exception as e:  # noqa: BLE001 - still recovering
                errs[name] = repr(e)[:70]
        if remaining:
            time.sleep(0.3)
    if remaining:
        pid = client._pool_id("up")
        detail = {n: (client.osdmap.object_to_pg(pid, n),
                      client.osdmap.pg_to_up_osds(
                          pid, client.osdmap.object_to_pg(pid, n)),
                      errs.get(n)) for n in sorted(remaining)[:6]}
        raise AssertionError(f"stuck: {detail}")
    assert client.scrub_pool("up", deep=True) == []
    inv = adm.ls()
    assert all(d["state"] == "running" for d in inv)


# -- the port's additions -----------------------------------------------------
def test_children_answer_dump_process(adm):
    """With ``admin_dir`` every child has an admin socket, and
    ``dump_process`` returns its pid, its launch counts (none: a
    replicated pool), its OSD's faults and no CUDA library load."""
    pids = {d["daemon"]: d["pid"] for d in adm.ls()}
    for osd_id in range(4):
        st = adm.cluster.admin(f"osd.{osd_id}", "dump_process")
        assert st["pid"] == pids[f"osd.{osd_id}"]
        assert st["launches"]["plain"] == 0
        assert set(st["faults"]) == {"op_timeouts", "dropped"}
        assert st["ops_refused_handed_over"] >= 0
        assert st["cuda_lib"] == {}
        assert st["ec_pools"] == []
        # forked by CephAdm's fork server; no card
        start = st["start"]
        assert start["forked"] is True
        assert start["started_at"] <= start["built_at"] \
            <= start["card_at"] <= start["booted_at"]
        assert st["cuda"] == {"context": False, "reserved": 0}
    assert adm.cluster.admin("osd.0", "status")["osd"] == 0


def test_a_failed_deploy_leaves_no_child(tmp_path, monkeypatch):
    """A deploy whose children never come up raises, and the caller's
    teardown stops every child it had spawned."""
    spec = {"osds": [{"id": i, "store": "memstore"} for i in range(2)],
            "pools": []}
    a = CephAdm(spec, str(tmp_path), device="cpu")
    spawned = []
    spawn = a._spawn
    monkeypatch.setattr(a, "_spawn", lambda o: spawned.append(spawn(o))
                        or spawned[-1])

    def never_up(self, n, timeout=10.0):
        if n:  # the monitor alone (n = 0) starts as it does
            raise TimeoutError(f"only 0/{n} up")

    monkeypatch.setattr(vstart.MiniCluster, "wait_for_up", never_up)
    try:
        with pytest.raises(TimeoutError):
            a.deploy()
    finally:
        a.teardown()
    assert len(spawned) == 2
    assert all(p.poll() is not None for p in spawned)


def test_children_are_told_their_parent(tmp_path, monkeypatch):
    """spawn_osd_process passes this process's pid as ``--parent-pid``."""
    cluster = vstart.MiniCluster(n_osds=0, transport="tcp").start()
    seen = []

    class Stop(Exception):
        pass

    def fake_popen(argv, **kw):
        seen.append((argv, kw))
        raise Stop

    try:
        monkeypatch.setattr(subprocess, "Popen", fake_popen)
        with pytest.raises(Stop):
            cluster.spawn_osd_process(0)
    finally:
        monkeypatch.undo()
        cluster.stop()
    (argv, _kw), = seen
    assert argv[argv.index("--parent-pid") + 1] == str(os.getpid())


def test_watch_parent_stops_when_the_parent_is_gone():
    """The child's watch sets its stop event once the pid it was given
    is no longer its parent, and not while it is."""
    stop = threading.Event()
    t = threading.Thread(target=osd_main._watch_parent,
                         args=(os.getppid(), stop, 0.01), daemon=True)
    t.start()
    assert not stop.wait(0.2)
    stop.set()
    t.join(5)
    gone = threading.Event()
    osd_main._watch_parent(os.getppid() + 1 if os.getppid() > 1 else 2,
                           gone, 0.01)
    assert gone.is_set()


def test_an_orphaned_child_exits(tmp_path):
    """An osd_main child whose spawner dies without stopping it exits by
    itself: a shell starts it with --parent-pid of the shell and exits
    at once; the child, handed to another parent, stops within a few
    seconds (it never reaches a monitor)."""
    pidfile = tmp_path / "pid"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run(
        ["sh", "-c", f"{sys.executable} -m ceph_tpu_torch.tools.osd_main "
                     "--id 0 --mon-addr 127.0.0.1:1 --parent-pid $$ "
                     f">/dev/null 2>&1 & echo $! > {pidfile}"],
        env=env, check=True, timeout=30)
    pid = int(pidfile.read_text())
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if not vstart.pid_running(pid):
            return
        time.sleep(0.1)
    os.kill(pid, 9)
    raise AssertionError(f"orphaned osd_main {pid} still running")


def test_forked_osds_outlive_no_dead_fork_server(tmp_path):
    """An OSD forked by the fork server runs the port's osd_main in a
    process of its own (its pid is not the server's); when the server is
    killed, the OSD stops by itself (it watches the server, its
    parent)."""
    cluster = vstart.MiniCluster(n_osds=0, transport="tcp").start()
    try:
        proc = cluster.spawn_osd_process(
            0, env={"CUDA_VISIBLE_DEVICES": ""}, fork=True)
        cluster.wait_for_up(1, timeout=60)
        server, = cluster._fork_servers.values()
        assert proc.pid != server.proc.pid and proc.poll() is None
        assert vstart.pid_running(proc.pid)
        server.proc.kill()
        server.proc.wait(timeout=30)
        deadline = time.monotonic() + 30
        while vstart.pid_running(proc.pid):
            assert time.monotonic() < deadline, "the forked OSD outlived " \
                                                "its server"
            time.sleep(0.1)
    finally:
        cluster.stop()

