"""The port's file client (ceph_tpu_torch.services.fs) over its MDS,
held against the JAX package on the CPU.

- The cases of the JAX package's tests/test_fs.py and
  tests/test_fs_snapshots.py on the port (the MDS's own cases are in
  test_torch_mds.py).
- The same file-system operations, with the clock and the inode ids
  pinned, leave the same RADOS objects, bytes, xattrs and omap in a
  port cluster as in a reference cluster, and give the same answers.
"""

import itertools
import time as _time
import types

import numpy as np
import pytest

import ceph_tpu.services.fs as ref_fs
import ceph_tpu.services.mds as ref_mds
import ceph_tpu.tools.vstart as ref_vstart
import ceph_tpu_torch.services.fs as port_fs
import ceph_tpu_torch.services.mds as port_mds
from ceph_tpu_torch.services.fs import FsClient, FsError
from ceph_tpu_torch.services.mds import MdsCluster, MdsDaemon
from ceph_tpu_torch.tools.vstart import MiniCluster
from tests.test_cluster import make_cfg as ref_make_cfg
from tests.test_torch_cluster import make_cfg

# -- the cases of tests/test_fs.py --------------------------------------------
RNG = np.random.default_rng(44)


@pytest.fixture
def fs_io():
    c = MiniCluster(n_osds=6, cfg=make_cfg()).start()
    client = c.client()
    client.create_pool("fs", size=3, pg_num=2)
    yield c, FsClient(client, "fs")
    c.stop()


def test_tree_and_file_io(fs_io):
    _c, f = fs_io
    f.mkdir("/home")
    f.mkdir("/home/user")
    assert f.listdir("/") == ["home"]
    assert f.listdir("/home") == ["user"]
    f.create("/home/user/data.bin")
    data = RNG.integers(0, 256, 2_000_000, dtype=np.uint8).tobytes()
    f.write_file("/home/user/data.bin", data)
    assert f.read_file("/home/user/data.bin") == data
    assert f.read_file("/home/user/data.bin", 500_000, 1000) == \
        data[500_000:501_000]
    # partial overwrite + grow
    f.write_file("/home/user/data.bin", b"PATCH", offset=100)
    assert f.read_file("/home/user/data.bin", 95, 15) == \
        data[95:100] + b"PATCH" + data[105:110]
    st = f.stat("/home/user/data.bin")
    assert st["type"] == "file" and st["size"] == len(data)
    f.truncate("/home/user/data.bin", 100)
    assert f.stat("/home/user/data.bin")["size"] == 100
    f.truncate("/home/user/data.bin", 200)
    assert f.read_file("/home/user/data.bin", 100, 100) == b"\0" * 100


def test_errors(fs_io):
    _c, f = fs_io
    with pytest.raises(FsError):
        f.listdir("/missing")
    with pytest.raises(FsError):
        f.mkdir("/a/b")  # parent missing
    f.mkdir("/a")
    with pytest.raises(FsError):
        f.mkdir("/a")  # exists
    f.create("/a/f")
    with pytest.raises(FsError):
        f.create("/a/f")
    with pytest.raises(FsError):
        f.rmdir("/a")  # not empty
    with pytest.raises(FsError):
        f.unlink("/a")  # is a dir
    f.unlink("/a/f")
    f.rmdir("/a")
    assert f.listdir("/") == []


def test_rename_moves_subtrees(fs_io):
    _c, f = fs_io
    f.mkdir("/proj")
    f.mkdir("/proj/src")
    f.create("/proj/src/main.py")
    f.write_file("/proj/src/main.py", b"print('hi')")
    f.create("/proj/readme")
    f.write_file("/proj/readme", b"docs")
    f.rename("/proj", "/project")
    assert f.listdir("/") == ["project"]
    assert f.listdir("/project") == ["readme", "src"]
    assert f.read_file("/project/src/main.py") == b"print('hi')"
    with pytest.raises(FsError):
        f.listdir("/proj")
    # file rename
    f.rename("/project/readme", "/project/README.md")
    assert f.read_file("/project/README.md") == b"docs"


def test_files_survive_osd_failure(fs_io):
    c, f = fs_io
    f.mkdir("/d")
    f.create("/d/x")
    data = RNG.integers(0, 256, 800_000, dtype=np.uint8).tobytes()
    f.write_file("/d/x", data)
    victim = sorted(c.osds)[0]
    epoch = c.mon.osdmap.epoch
    c.kill_osd(victim)
    c.wait_for_epoch(epoch + 1)
    c.settle(0.8)
    assert f.read_file("/d/x") == data
    assert f.listdir("/d") == ["x"]


def test_truncate_hole_and_rename_into_self(fs_io):
    _c, f = fs_io
    f.create("/f")
    f.write_file("/f", b"\xAA" * 200)
    f.truncate("/f", 100)
    f.write_file("/f", b"x", offset=180)
    assert f.read_file("/f", 100, 80) == b"\0" * 80  # POSIX hole
    f.mkdir("/a")
    f.mkdir("/a/b")
    with pytest.raises(FsError):
        f.rename("/a", "/a/b/c")
    assert f.listdir("/a") == ["b"]  # tree intact

# -- the cases of tests/test_fs_snapshots.py ----------------------------------
@pytest.fixture
def cluster():
    c = MiniCluster(n_osds=3, cfg=make_cfg()).start()
    yield c
    c.stop()


@pytest.fixture
def fs(cluster):
    client = cluster.client()
    client.create_pool("fsdata", size=2, pg_num=2)
    f = FsClient(client, "fsdata")
    yield f
    f.unmount()


def test_snapshot_read_through_dot_snap(fs):
    fs.mkdir("/proj")
    fs.create("/proj/a.txt")
    fs.write_file("/proj/a.txt", b"version-one" * 100)
    fs.snap_create("/proj", "s1")
    fs.write_file("/proj/a.txt", b"version-TWO" * 120)
    assert fs.read_file("/proj/a.txt") == b"version-TWO" * 120
    assert fs.read_file("/proj/.snap/s1/a.txt") == b"version-one" * 100
    assert fs.listdir("/proj/.snap") == ["s1"]
    assert fs.listdir("/proj/.snap/s1") == ["a.txt"]
    st = fs.stat("/proj/.snap/s1/a.txt")
    assert st["size"] == len(b"version-one" * 100)


def test_snapshot_freezes_tree_shape(fs):
    fs.mkdir("/d")
    fs.mkdir("/d/sub")
    fs.create("/d/sub/x")
    fs.write_file("/d/sub/x", b"frozen")
    fs.snap_create("/d", "snap")
    fs.create("/d/newfile")
    fs.unlink("/d/sub/x")
    fs.rmdir("/d/sub") if not fs.listdir("/d/sub") else None
    assert "newfile" not in fs.listdir("/d/.snap/snap")
    assert fs.listdir("/d/.snap/snap/sub") == ["x"]
    assert fs.read_file("/d/.snap/snap/sub/x") == b"frozen"


def test_snapshots_read_only(fs):
    fs.mkdir("/d")
    fs.create("/d/f")
    fs.snap_create("/d", "s")
    with pytest.raises(FsError):
        fs.write_file("/d/.snap/s/f", b"nope")
    with pytest.raises(FsError):
        fs.create("/d/.snap/s/new")
    with pytest.raises(FsError):
        fs.mkdir("/d/.snap/s/newdir")


def test_snapshot_rollback(fs):
    fs.mkdir("/r")
    fs.create("/r/keep")
    fs.write_file("/r/keep", b"old-bytes" * 500)
    fs.snap_create("/r", "pre")
    fs.write_file("/r/keep", b"NEW-BYTES" * 600)
    fs.create("/r/born-later")
    fs.write_file("/r/born-later", b"doomed")
    fs.snap_rollback("/r", "pre")
    assert fs.read_file("/r/keep") == b"old-bytes" * 500
    assert "born-later" not in fs.listdir("/r")
    # the snapshot still reads after rollback
    assert fs.read_file("/r/.snap/pre/keep") == b"old-bytes" * 500


def test_snapshot_survives_mds_failover(cluster):
    """The judge's bar: snapshot (and its rollback) survive MDS
    failover — everything is journaled, the standby replays."""
    client = cluster.client()
    client.create_pool("fsdata", size=2, pg_num=2)
    fs1 = FsClient(client, "fsdata")
    fs1.mkdir("/w")
    fs1.create("/w/f")
    fs1.write_file("/w/f", b"snapdata" * 200)
    fs1.snap_create("/w", "s1")
    fs1.write_file("/w/f", b"later-on" * 300)
    # MDS dies; a standby replays the journal (fresh daemon, same pool)
    mds2 = MdsDaemon(client, "fsdata")
    fs2 = FsClient(client, "fsdata", mds=mds2)
    assert fs2.read_file("/w/.snap/s1/f") == b"snapdata" * 200
    assert fs2.read_file("/w/f") == b"later-on" * 300
    fs2.snap_rollback("/w", "s1")
    assert fs2.read_file("/w/f") == b"snapdata" * 200
    fs2.unmount()
    fs1.unmount()


def test_snapshot_remove_trims(fs):
    fs.mkdir("/t")
    fs.create("/t/f")
    fs.write_file("/t/f", b"abc" * 100)
    fs.snap_create("/t", "s")
    fs.write_file("/t/f", b"xyz" * 150)
    fs.snap_remove("/t", "s")
    assert fs.snap_list("/t") == {}
    with pytest.raises(FsError):
        fs.read_file("/t/.snap/s/f")
    assert fs.read_file("/t/f") == b"xyz" * 150


def test_snapshot_multirank_cluster(cluster):
    """Snapshots work over a multi-active MDS cluster (revokes fan to
    every rank; the table object is shared)."""
    client = cluster.client()
    client.create_pool("fsdata", size=2, pg_num=2)
    mc = MdsCluster(client, "fsdata", n_ranks=2)
    fs = FsClient(client, "fsdata", mds=mc)
    fs.mkdir("/a")
    fs.create("/a/f")
    fs.write_file("/a/f", b"multi" * 100)
    mc.export_subtree("/a", 1)  # authority on rank 1
    fs.snap_create("/a", "s1")
    fs.write_file("/a/f", b"after" * 120)
    assert fs.read_file("/a/.snap/s1/f") == b"multi" * 100
    fs.unmount()


# ---------------------------------------- the port against the JAX package
def _pinned(monkeypatch, modules, seed: int):
    """The modules' clock fixed and their uuid4 one seeded sequence, so
    two file systems that make the same calls write the same bytes."""
    clock = types.SimpleNamespace(
        **{k: getattr(_time, k) for k in dir(_time) if not k.startswith("_")})
    clock.time = lambda: 1_760_000_000.0
    counter = itertools.count()
    fake_uuid = types.SimpleNamespace(uuid4=lambda: types.SimpleNamespace(
        hex=f"{seed:08x}{next(counter):024x}"))
    for module in modules:
        monkeypatch.setattr(module, "time", clock)
        monkeypatch.setattr(module, "uuid", fake_uuid)


def _fs_session(fs_mod, client) -> dict:
    """A tree, a striped file, a rename, a snapshot, an overwrite past
    it, a truncate and an unlink; returns what the reads give."""
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, 5_000_000, dtype=np.uint8).tobytes()
    fs = fs_mod.FsClient(client, "fs", client_id="fsclient-0")
    try:
        fs.mkdir("/a")
        fs.mkdir("/a/b")
        fs.create("/a/b/big")
        fs.write_file("/a/b/big", big)
        fs.create("/a/small")
        fs.write_file("/a/small", b"small file" * 30)
        fs.rename("/a/small", "/a/b/moved")
        fs.snap_create("/a", "s1")
        fs.write_file("/a/b/big", b"after the snapshot", 4_194_000)
        fs.truncate("/a/b/moved", 100)
        fs.create("/a/gone")
        fs.unlink("/a/gone")
        return {"tree": {p: fs.listdir(p) for p in ("/", "/a", "/a/b")},
                "big": fs.read_file("/a/b/big"),
                "snap_big": fs.read_file("/a/.snap/s1/b/big"),
                "moved": fs.read_file("/a/b/moved"),
                "snap_moved": fs.read_file("/a/.snap/s1/b/moved"),
                "stat": fs.stat("/a/b/big")["size"],
                "snaps": sorted(fs.snap_list("/a"))}
    finally:
        fs.unmount()


def _rados_state(client, pool: str) -> dict:
    return {oid: (client.read(pool, oid), client.getxattrs(pool, oid),
                  client.omap_get(pool, oid))
            for oid in sorted(client.list_objects(pool))}


def test_fs_ops_leave_the_references_rados_state(monkeypatch):
    """The same file-system operations on a port cluster and on a
    reference cluster: equal answers, and the same RADOS object names,
    bytes, xattrs and omap in the file system's pool."""
    out = {}
    for pkg, mods, cluster, cfg in (
            ("port", (port_fs, port_mds), MiniCluster, make_cfg),
            ("ref", (ref_fs, ref_mds), ref_vstart.MiniCluster,
             ref_make_cfg)):
        _pinned(monkeypatch, mods, seed=11)
        c = cluster(n_osds=4, cfg=cfg()).start()
        try:
            client = c.client()
            client.create_pool("fs", size=2, pg_num=4)
            out[pkg] = (_fs_session(mods[0], client),
                        _rados_state(client, "fs"))
        finally:
            c.stop()
    (port_answers, port_state), (ref_answers, ref_state) = \
        out["port"], out["ref"]
    assert port_answers == ref_answers
    assert list(port_state) == list(ref_state)
    assert len(ref_state) >= 4
    assert any(omap for _d, _x, omap in ref_state.values())
    for oid in ref_state:
        assert port_state[oid] == ref_state[oid], oid
