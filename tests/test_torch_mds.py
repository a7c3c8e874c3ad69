"""The port's metadata server (ceph_tpu_torch.services.mds): the cases of
the JAX package's tests/test_mds.py, tests/test_mds_multi.py and
tests/test_mds_standby.py on the port, each file's cluster under its own
fixture name (the file client's cases, and the state held against the
JAX package, are in test_torch_fs.py)."""

import time

import numpy as np
import pytest

from ceph_tpu_torch.msg.wire import pack_value
from ceph_tpu_torch.services.fs import FsClient, FsError
from ceph_tpu_torch.services.mds import (_JOURNAL_OID, MdsCluster,
                                         MdsDaemon, StandbyReplayMds)
from ceph_tpu_torch.tools.vstart import MiniCluster
from tests.test_torch_cluster import make_cfg

# -- the cases of tests/test_mds.py -------------------------------------------
@pytest.fixture(scope="module")
def mds_cluster():
    c = MiniCluster(n_osds=4, cfg=make_cfg()).start()
    client = c.client()
    client.create_pool("fs", size=3, pg_num=4)
    yield c
    c.stop()


# ---------------------------------------------------------------- journal
def test_journal_replays_unapplied_tail(mds_cluster):
    """Crash between journal append and dentry apply: the next MDS
    start replays the tail and the namespace converges."""
    client = mds_cluster.clients[0]
    mds = MdsDaemon(client, "fs")
    mds.mkdir("/j")
    mds.create("/j/seen")
    # simulate the crash window: journal an op but die before apply
    from ceph_tpu_torch.msg.wire import pack_value
    mds._seq += 1
    client.omap_set("fs", mds._journal_oid,
                    {f"{mds._seq:016x}": pack_value(
                        {"op": "set_entry", "path": "/j/lost",
                         "ent": {"type": "file", "size": 0,
                                 "ino": "deadbeef", "mtime": 0}})})
    # "restart": a fresh daemon over the same pool replays the tail
    mds2 = MdsDaemon(client, "fs")
    ents = mds2.entries("/j")
    assert "seen" in ents and "lost" in ents
    assert ents["lost"]["ino"] == "deadbeef"
    # replay is idempotent: a third start changes nothing
    assert MdsDaemon(client, "fs").entries("/j").keys() == ents.keys()


def test_journal_trims_applied_entries(mds_cluster):
    client = mds_cluster.clients[0]
    mds = MdsDaemon(client, "fs")
    mds.mkdir("/trim")
    for i in range(130):  # > 2 * _TRIM_EVERY
        mds.create(f"/trim/f{i}")
    raw = client.omap_get("fs", mds._journal_oid)
    live = [k for k in raw if k != "_applied"]
    from ceph_tpu_torch.services import mds as mds_mod
    assert len(live) <= mds_mod._TRIM_EVERY + 1, \
        f"journal unbounded: {len(live)} entries"


# ------------------------------------------------------------ capabilities
def test_read_caps_cache_and_writer_revoke(mds_cluster):
    client = mds_cluster.clients[0]
    mds = MdsDaemon(client, "fs")
    m1 = FsClient(client, "fs", mds=mds, client_id="m1")
    m2 = FsClient(client, "fs", mds=mds, client_id="m2")
    m1.mkdir("/caps")
    m1.create("/caps/f")
    m1.write_file("/caps/f", b"one")
    r = m2.open("/caps/f", "r")
    assert r.read() == b"one"
    assert r.read() == b"one" and r.cache_reads >= 1  # cached
    # a writer elsewhere revokes the read cap; reader falls back
    w = m1.open("/caps/f", "w")
    assert r.caps == ""  # revoked
    w.write(b"two!", offset=0)
    assert r.read() == b"one"  # writer still buffering (not flushed)
    w.flush()
    assert r.read(0, 4) == b"two!"  # uncached read sees flushed bytes
    w.close()
    m1.unmount(); m2.unmount()


def test_buffered_writes_flush_on_conflict(mds_cluster):
    """A second opener forces the writer's buffered bytes down
    synchronously BEFORE its grant — readers-after-writers see data."""
    client = mds_cluster.clients[0]
    mds = MdsDaemon(client, "fs")
    m1 = FsClient(client, "fs", mds=mds, client_id="w")
    m2 = FsClient(client, "fs", mds=mds, client_id="r")
    m1.mkdir("/wb")
    w = m1.open("/wb/f", "w")
    w.write(b"buffered-but-not-flushed")
    # nothing on RADOS yet (write-back)
    assert m2.read_file("/wb/f") == b""
    r = m2.open("/wb/f", "r")   # conflicting open -> revoke -> flush
    assert r.read() == b"buffered-but-not-flushed"
    assert w.caps == ""  # writer lost its caps
    w.close(); r.close()
    m1.unmount(); m2.unmount()


def test_rename_revokes_subtree_caps(mds_cluster):
    client = mds_cluster.clients[0]
    mds = MdsDaemon(client, "fs")
    m1 = FsClient(client, "fs", mds=mds, client_id="a")
    m1.mkdir("/mv")
    m1.create("/mv/f")
    m1.write_file("/mv/f", b"x")
    h = m1.open("/mv/f", "r")
    assert h.read() == b"x"
    m1.rename("/mv", "/moved")
    assert h.caps == ""  # stale path: caps revoked
    assert m1.read_file("/moved/f") == b"x"
    m1.unmount()


def test_open_missing_and_closed_handle(mds_cluster):
    client = mds_cluster.clients[0]
    mds = MdsDaemon(client, "fs")
    m = FsClient(client, "fs", mds=mds, client_id="x")
    with pytest.raises(FsError):
        m.open("/nope", "r")
    m.mkdir("/h")
    with m.open("/h/f", "w") as f:
        f.write(b"ctx")
    assert m.read_file("/h/f") == b"ctx"
    with pytest.raises(FsError):
        f.read()
    m.unmount()

# -- the cases of tests/test_mds_multi.py -------------------------------------
@pytest.fixture(scope="module")
def multi_cluster():
    c = MiniCluster(n_osds=4, cfg=make_cfg()).start()
    client = c.client()
    client.create_pool("fs", size=3, pg_num=4)
    yield c
    c.stop()


def test_export_routes_ops_to_new_rank(multi_cluster):
    client = multi_cluster.clients[0]
    mds = MdsCluster(client, "fs", n_ranks=2)
    fs = FsClient(client, "fs", mds=mds, client_id="m0")
    fs.mkdir("/proj")
    fs.mkdir("/other")
    mds.export_subtree("/proj", 1)
    assert mds.authority_rank("/proj") == 1
    assert mds.authority_rank("/proj/deep/er") == 1
    assert mds.authority_rank("/other") == 0
    before = mds.ranks[1]._seq
    fs.create("/proj/f")
    fs.write_file("/proj/f", b"routed")
    assert mds.ranks[1]._seq > before  # journaled at rank 1
    r0 = mds.ranks[0]._seq
    fs.create("/other/g")
    assert mds.ranks[0]._seq > r0
    assert fs.read_file("/proj/f") == b"routed"
    fs.unmount()


def test_subtree_map_is_durable(multi_cluster):
    client = multi_cluster.clients[0]
    mds = MdsCluster(client, "fs", n_ranks=2)
    fs = FsClient(client, "fs", mds=mds, client_id="m1")
    try:
        fs.mkdir("/durablemap")
    except FsError:
        pass
    mds.export_subtree("/durablemap", 1)
    fs.unmount()
    # a fresh multi_cluster instance (mds restart) reloads the map
    mds2 = MdsCluster(client, "fs", n_ranks=2)
    assert mds2.authority_rank("/durablemap") == 1


def test_export_revokes_caps(multi_cluster):
    client = multi_cluster.clients[0]
    mds = MdsCluster(client, "fs", n_ranks=2)
    fs = FsClient(client, "fs", mds=mds, client_id="m2")
    fs.mkdir("/capx")
    fs.create("/capx/f")
    fs.write_file("/capx/f", b"x")
    h = fs.open("/capx/f", "r")
    assert h.read() == b"x"
    mds.export_subtree("/capx", 1)
    assert h.caps == ""  # old authority revoked the lease
    # reads still work (routed to the new authority)
    assert h.read() == b"x"
    h.close()
    fs.unmount()


def test_cross_rank_rename(multi_cluster):
    client = multi_cluster.clients[0]
    mds = MdsCluster(client, "fs", n_ranks=2)
    fs = FsClient(client, "fs", mds=mds, client_id="m3")
    fs.mkdir("/zoneA")
    fs.mkdir("/zoneB")
    mds.export_subtree("/zoneB", 1)
    fs.mkdir("/zoneA/sub")
    fs.create("/zoneA/sub/f")
    fs.write_file("/zoneA/sub/f", b"moved-bytes")
    fs.rename("/zoneA/sub", "/zoneB/sub")   # rank0 -> rank1 subtree
    assert fs.read_file("/zoneB/sub/f") == b"moved-bytes"
    with pytest.raises(FsError):
        fs.stat("/zoneA/sub")
    assert "sub" in fs.listdir("/zoneB")
    # both ranks journaled the rename; a replay of either converges
    mds2 = MdsCluster(client, "fs", n_ranks=2)
    fs2 = FsClient(client, "fs", mds=mds2, client_id="m3b")
    assert fs2.read_file("/zoneB/sub/f") == b"moved-bytes"
    fs2.unmount()
    fs.unmount()


def test_balancer_moves_hot_subtree(multi_cluster):
    client = multi_cluster.clients[0]
    mds = MdsCluster(client, "fs", n_ranks=2)
    fs = FsClient(client, "fs", mds=mds, client_id="m4")
    fs.mkdir("/hot")
    for i in range(40):  # rank 0 gets hammered under /hot
        fs.create(f"/hot/f{i}")
    move = mds.balance()
    assert move is not None and move["subtree"] == "/hot"
    assert mds.authority_rank("/hot") == move["to"] != move["from"]
    # namespace intact and ops now route to the new rank
    before = mds.ranks[move["to"]]._seq
    fs.create("/hot/after-balance")
    assert mds.ranks[move["to"]]._seq > before
    assert len(fs.listdir("/hot")) == 41
    fs.unmount()


def test_multi_mount_caps_across_ranks(multi_cluster):
    """The writer-flush-before-reader-grant contract holds when the
    file's subtree lives on a non-zero rank."""
    client = multi_cluster.clients[0]
    mds = MdsCluster(client, "fs", n_ranks=2)
    m1 = FsClient(client, "fs", mds=mds, client_id="w5")
    m2 = FsClient(client, "fs", mds=mds, client_id="r5")
    m1.mkdir("/xr")
    mds.export_subtree("/xr", 1)
    w = m1.open("/xr/f", "w")
    w.write(b"buffered-on-rank-1")
    r = m2.open("/xr/f", "r")   # conflicting open -> revoke -> flush
    assert r.read() == b"buffered-on-rank-1"
    assert w.caps == ""
    w.close(); r.close()
    m1.unmount(); m2.unmount()


def test_rename_moves_subtree_authority(multi_cluster):
    """Renaming a directory that is (or contains) a subtree root moves
    the durable authority assignment with it (ADVICE r2: stale _map keys
    made the moved tree revert to rank 0)."""
    client = multi_cluster.clients[0]
    mds = MdsCluster(client, "fs", n_ranks=2)
    fs = FsClient(client, "fs", mds=mds, client_id="rn")
    fs.mkdir("/team")
    fs.mkdir("/team/sub")
    mds.export_subtree("/team/sub", 1)
    assert mds.authority_rank("/team/sub") == 1
    fs.rename("/team", "/squad")
    assert mds.authority_rank("/squad/sub") == 1
    # the old path no longer carries an assignment: a fresh dir there
    # inherits its parent's (rank 0), not the moved subtree's
    fs.mkdir("/team")
    fs.mkdir("/team/sub")
    assert mds.authority_rank("/team/sub") == 0
    # and a fresh MdsCluster loading the durable map agrees
    mds2 = MdsCluster(client, "fs", n_ranks=2)
    assert mds2.authority_rank("/squad/sub") == 1
    assert mds2.authority_rank("/team/sub") == 0
    fs.unmount()


def test_rename_revokes_interior_subtree_caps(multi_cluster):
    """Caps held at an interior subtree's authority rank (not either
    parent's rank) are revoked by a rename — the writer's buffered data
    must be flushed before a reader opens through the new path."""
    client = multi_cluster.clients[0]
    mds = MdsCluster(client, "fs", n_ranks=2)
    w = FsClient(client, "fs", mds=mds, client_id="wi")
    r = FsClient(client, "fs", mds=mds, client_id="ri")
    w.mkdir("/grp")
    w.mkdir("/grp/sub")
    mds.export_subtree("/grp/sub", 1)
    h = w.open("/grp/sub/f", "w")
    h.write(b"buffered-at-rank-1")
    # both parents of this rename live at rank 0; the caps live at rank 1
    w.rename("/grp", "/org")
    assert h.caps == ""  # revoked (and flushed) by the rename
    rd = r.open("/org/sub/f", "r")
    assert rd.read() == b"buffered-at-rank-1"
    h.close(); rd.close()
    w.unmount(); r.unmount()

# -- the cases of tests/test_mds_standby.py -----------------------------------
RNG = np.random.default_rng(61)


@pytest.fixture
def standby_cluster():
    c = MiniCluster(n_osds=4, cfg=make_cfg()).start()
    client = c.client()
    client.create_pool("fsp", size=2, pg_num=4)
    yield c, client
    c.stop()


def test_standby_promotion_after_clean_active(standby_cluster):
    c, client = standby_cluster
    active = MdsDaemon(client, "fsp")
    fs = FsClient(client, "fsp", mds=active)
    fs.mkdir("/a")
    fs.create("/a/f")
    fs.write_file("/a/f", b"before failover")
    standby = StandbyReplayMds(c.client(), "fsp")
    time.sleep(0.2)  # tailing; active is fully applied
    assert standby.lag == 0
    fs.unmount()
    promoted, replayed = standby.promote()
    # clean shutdown: nothing in the crash window
    assert replayed == 0
    fs2 = FsClient(client, "fsp", mds=promoted)
    assert fs2.read_file("/a/f") == b"before failover"
    fs2.mkdir("/post")        # the promoted rank serves mutations
    assert sorted(fs2.listdir("/")) == ["a", "post"]
    fs2.unmount()


def test_standby_applies_only_the_crash_window(standby_cluster):
    """THE standby-replay property: the active journaled two mutations
    and died before applying them; the promoted standby replays exactly
    those two — not the whole journal — and the namespace includes
    them."""
    c, client = standby_cluster
    active = MdsDaemon(client, "fsp")
    fs = FsClient(client, "fsp", mds=active)
    for i in range(20):       # a real journal history, all applied
        fs.mkdir(f"/d{i}")
    standby = StandbyReplayMds(c.client(), "fsp")
    time.sleep(0.2)
    # simulate the crash window: journal two ops WITHOUT applying
    # (the active died between journal-append and apply)
    seq = active._seq
    client.omap_set("fsp", _JOURNAL_OID.format(rank=0), {
        f"{seq + 1:016x}": pack_value(
            {"op": "mkdir", "path": "/crashed1",
             "ent": {"type": "dir", "mtime": 0.0}}),
        f"{seq + 2:016x}": pack_value(
            {"op": "set_entry", "path": "/crashed1/file",
             "ent": {"type": "file", "size": 0, "ino": "deadbeef",
                     "mtime": 0.0}}),
    })
    deadline = time.time() + 5
    while standby.lag != 2 and time.time() < deadline:
        time.sleep(0.05)
    assert standby.lag == 2   # the tail sees the un-applied window
    fs.unmount()
    promoted, replayed = standby.promote()
    assert replayed == 2      # ONLY the crash window, not 20+ entries
    fs2 = FsClient(client, "fsp", mds=promoted)
    assert "crashed1" in fs2.listdir("/")
    assert fs2.listdir("/crashed1") == ["file"]
    assert sorted(fs2.listdir("/"))[:3] == ["crashed1", "d0", "d1"]
    fs2.unmount()


def test_standby_never_applies_while_active_lives(standby_cluster):
    """The shared-table safety property: a tailing standby must not
    write the dentry tables — mutations land exactly once, from the
    active."""
    c, client = standby_cluster
    active = MdsDaemon(client, "fsp")
    fs = FsClient(client, "fsp", mds=active)
    standby = StandbyReplayMds(c.client(), "fsp")
    for i in range(30):
        fs.mkdir(f"/x{i}")
        fs.create(f"/x{i}/f")
    time.sleep(0.3)           # standby tailing through live mutations
    assert standby.lag == 0   # active keeps itself applied
    # the standby never advanced its own applied state
    assert standby.mds._applied == 0
    fs.rename("/x0/f", "/x1/g")
    assert fs.listdir("/x1") == ["f", "g"]
    standby.stop()
    fs.unmount()


# ---------------------------------------- the port against the JAX package
def _two_rank_session(fs_mod, mds_mod, client) -> dict:
    """Two active ranks: a tree on rank 0, /a exported to rank 1, writes
    on both, a rename across the ranks, a snapshot of /a and a write
    past it; returns what the reads and the subtree map give."""
    mc = mds_mod.MdsCluster(client, "fs", n_ranks=2)
    fs = fs_mod.FsClient(client, "fs", mds=mc, client_id="fsclient-0")
    try:
        fs.mkdir("/a")
        fs.mkdir("/b")
        fs.create("/a/f")
        fs.write_file("/a/f", b"rank zero" * 50)
        mc.export_subtree("/a", 1)
        fs.create("/a/g")
        fs.write_file("/a/g", b"rank one" * 40)
        fs.mkdir("/a/sub")
        fs.create("/b/h")
        fs.write_file("/b/h", b"crosses ranks")
        fs.rename("/b/h", "/a/sub/h")
        fs.snap_create("/a", "s1")
        fs.write_file("/a/f", b"after the snapshot")
        return {"tree": {p: fs.listdir(p) for p in ("/", "/a", "/a/sub",
                                                    "/b")},
                "auth": {p: mc.authority_rank(p)
                         for p in ("/", "/a", "/a/sub", "/b")},
                "f": fs.read_file("/a/f"), "g": fs.read_file("/a/g"),
                "h": fs.read_file("/a/sub/h"),
                "snap_f": fs.read_file("/a/.snap/s1/f")}
    finally:
        fs.unmount()


def _standby_session(fs_mod, mds_mod, client, standby_client) -> dict:
    """An active rank 0 with a tailing standby; the active journals two
    mutations and dies before applying them; the standby is promoted,
    replays that crash window and serves a mkdir."""
    active = mds_mod.MdsDaemon(client, "fs")
    fs = fs_mod.FsClient(client, "fs", mds=active, client_id="fsclient-0")
    for i in range(6):
        fs.mkdir(f"/d{i}")
    fs.create("/d0/f")
    fs.write_file("/d0/f", b"before failover")
    standby = mds_mod.StandbyReplayMds(standby_client, "fs")
    seq = active._seq
    client.omap_set("fs", mds_mod._JOURNAL_OID.format(rank=0), {
        f"{seq + 1:016x}": pack_value(
            {"op": "mkdir", "path": "/crashed1",
             "ent": {"type": "dir", "mtime": 0.0}}),
        f"{seq + 2:016x}": pack_value(
            {"op": "set_entry", "path": "/crashed1/file",
             "ent": {"type": "file", "size": 0, "ino": "deadbeef",
                     "mtime": 0.0}})})
    deadline = time.time() + 5
    while standby.lag != 2 and time.time() < deadline:
        time.sleep(0.02)
    promoted, replayed = standby.promote()
    fs2 = fs_mod.FsClient(client, "fs", mds=promoted,
                          client_id="fsclient-1")
    try:
        fs2.mkdir("/post")
        return {"replayed": replayed, "root": sorted(fs2.listdir("/")),
                "crashed": fs2.listdir("/crashed1"),
                "f": fs2.read_file("/d0/f")}
    finally:
        fs2.unmount()


@pytest.mark.parametrize("session", ["two_ranks", "standby_replay"])
def test_mds_sessions_leave_the_references_rados_state(monkeypatch,
                                                       session):
    """The same MDS session on a port cluster and on a reference
    cluster, with the clock and the inode ids pinned: equal answers, and
    the same RADOS object names, bytes, xattrs and omap (the ranks'
    journals, dentry tables, subtree map and snapshot table)."""
    import ceph_tpu.services.fs as ref_fs
    import ceph_tpu.services.mds as ref_mds
    import ceph_tpu.tools.vstart as ref_vstart
    import ceph_tpu_torch.services.fs as port_fs
    import ceph_tpu_torch.services.mds as port_mds
    from tests.test_cluster import make_cfg as ref_make_cfg
    from tests.test_torch_fs import _pinned, _rados_state

    out = {}
    for pkg, mods, cluster, cfg in (
            ("port", (port_fs, port_mds), MiniCluster, make_cfg),
            ("ref", (ref_fs, ref_mds), ref_vstart.MiniCluster,
             ref_make_cfg)):
        _pinned(monkeypatch, mods, seed=12)
        c = cluster(n_osds=4, cfg=cfg()).start()
        try:
            client = c.client()
            client.create_pool("fs", size=2, pg_num=4)
            if session == "two_ranks":
                answers = _two_rank_session(*mods, client)
            else:
                answers = _standby_session(*mods, client, c.client())
            out[pkg] = (answers, _rados_state(client, "fs"))
        finally:
            c.stop()
    (port_answers, port_state), (ref_answers, ref_state) = \
        out["port"], out["ref"]
    assert port_answers == ref_answers
    assert list(port_state) == list(ref_state)
    assert any(oid.startswith("mds") or "journal" in oid
               for oid in ref_state), list(ref_state)
    assert any(omap for _d, _x, omap in ref_state.values())
    for oid in ref_state:
        assert port_state[oid] == ref_state[oid], oid
