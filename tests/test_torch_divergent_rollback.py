"""The divergent rollback that lost EC objects, staged at its smallest.

In the gateway's saturation smoke (EC k=2 m=1, a kill and a revive under
gateway traffic) peering found "forks" that were no forks: a recovery
push of an object whose last update was an omap update carried no entry
epoch ("ev"), so its receiver logged the pushed, committed version under
its own map epoch.  The merge rule takes the newer epoch as the
authority, so the members that held the committed history discarded it
from that version on, and the discard dropped every EC shard copy it
could not roll back in place, down to fewer than k shards of an object.
The repair, in the port only:

- (c) an omap, object-class or compound update stamps its entry epoch
  on the object as a whole write does, so a pushed copy is logged under
  the epoch it was committed in;
- (a) a primary's version counter passes every version a peering answer
  shows it (inventory, log head, tombstones), so a primary with a fresh
  counter never mints a version a member holds (the newest entry may be
  a delete, which no inventory shows);
- (b) a divergent discard keeps an EC shard copy it cannot roll back in
  place unless the primary, which has the inventories, directs its drop
  because k other positions of the up set hold the object at the version
  the PG keeps; the torn-object reconcile counts a rollback target's
  k-support over the up set's positions only;
- the torn-object reconcile judges no write this primary made since its
  last blocking peering round closed (the round's inventories predate
  it): it called such writes torn and dropped the primary's own copy,
  again after each rebuild, the "reconcile churn" of both saturation
  smokes.

Each staging runs on the JAX package too, which keeps the fault.
"""

import importlib
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.load import scenarios
from ceph_tpu_torch.services.rgw import RgwGateway

EC = {"plugin": "jerasure", "k": "2", "m": "1", "backend": "numpy"}
PKGS = {"port": "ceph_tpu_torch", "ref": "ceph_tpu"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def make_cfg(pkg: str, **over):
    """``tests/test_torch_osd_seams.py``'s settings, host EC backend."""
    cfg = mod(pkg, "utils.config").default_config()
    cfg.apply_dict({"osd_heartbeat_interval": 0.05,
                    "osd_heartbeat_grace": 0.5,
                    "osd_op_num_shards": 2,
                    "ms_dispatch_workers": 2,
                    "ec_backend": "native", **over})
    return cfg


def wait_for(cond, what: str, deadline_s: float = 30.0):
    end = time.monotonic() + deadline_s
    while True:
        try:
            if cond():
                return
        except Exception:  # noqa: BLE001 - not there yet
            pass
        assert time.monotonic() < end, what
        time.sleep(0.05)


# ------------------------------------------------- the staging on one OSD
def bare_primary(pkg: str):
    """An OSD built but not started, primary of pg 1.0 of an EC k=2 m=1
    pool on a map of 3 OSDs at epoch 5, holding shard 0 of ``idx`` (an
    omap object, three omap updates v1-v3) and of ``gone`` (v4, removed
    at v5): its log's newest entry is the delete."""
    maps = mod(pkg, "mon.maps")
    daemon = mod(pkg, "osd.daemon")
    omap = maps.OSDMap()
    for i in range(3):
        omap.add_osd(i, f"host{i}")
        omap.mark_up(i)
    omap.pools[1] = maps.PoolSpec(1, "p", "ec", 3, 2, 1, dict(EC))
    omap.epoch = 5
    up = omap.pg_to_up_osds(1, 0)
    osd = daemon.OSDDaemon(up[0], mod(pkg, "msg.messenger").LocalNetwork(),
                           cfg=make_cfg(pkg))
    osd.osdmap = omap
    osd._ensure_collections()
    pg = daemon.PgId(1, 0)
    for v in (1, 2, 3):
        osd._apply_omap(pg, "idx", "omap_set", {f"k{v}": bytes([v]) * 8},
                        v, create_ok=True, shard=0)
    osd._apply_omap(pg, "gone", "omap_set", {"a": b"b"}, 4,
                    create_ok=True, shard=0)
    osd._apply_remove(pg, "gone", 0, 5)
    return osd, pg, up


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("answer", ["own", "member"])
def test_a_fresh_counter_mints_past_every_head_it_heard(pkg, answer):
    """(a) The primary's counter is fresh (a restart) and the PG's newest
    entry is a delete at v5.  ``own``: its own answer (its store, its log
    through v5); ``member``: a member's full answer of a log through v5.
    The next version is 6 in the port.  The JAX package raises its
    counter from inventories only and mints 4, the version of ``gone``'s
    update, which the PG's log holds."""
    osd, pg, up = bare_primary(pkg)
    M = mod(pkg, "msg.messages")
    try:
        if answer == "own":
            osd._handle_pg_info(None, osd._my_pg_info(pg))
        else:
            osd._pg_versions.clear()
            osd._handle_pg_info(None, M.MPGInfo(
                pg, up[1], -2, {("idx", 1): 3}, {}, last_complete=5,
                head_epoch=5, log_evs={v: 5 for v in range(1, 6)},
                les=5))
        assert osd._next_version(pg) == (6 if pkg == "port" else 4)
    finally:
        osd.stop()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_divergent_discard_keeps_a_copy_without_pre_image(pkg):
    """(b), the member's side.  The primary orders a PG-level divergent
    discard from v0 (its log won a fork at v1).  ``idx``'s entries are
    omap updates, with no pre-image.  The port keeps the copy, with its
    bytes, omap and version, and cleans its log entries; only a
    per-object rollback, which the primary sends where k other
    positions hold the object, drops it.  The JAX package drops it."""
    osd, pg, _up = bare_primary(pkg)
    M = mod(pkg, "msg.messages")
    ostore = mod(pkg, "osd.objectstore")
    cid = ostore.CollectionId(1, 0)
    obj = ostore.ObjectId("idx", shard=0)
    try:
        osd._handle_pg_rollback(None, M.MPGRollback(
            pg, "", -3, 0, divergent=True, max_epoch=7))
        if pkg == "ref":
            assert not osd.store.exists(cid, obj)
            return
        assert osd.store.omap_get(cid, obj) == {
            f"k{v}": bytes([v]) * 8 for v in (1, 2, 3)}
        assert osd.store.getattrs(cid, obj)["v"] == 3
        assert [e.oid for e in osd._pglog(pg).entries()] == []
        # a per-object rollback finds no entry to undo while the copy
        # stands past the point: that is a drop, not a rollback
        osd._handle_pg_rollback(None, M.MPGRollback(pg, "idx", 0, 0))
        assert not osd.store.exists(cid, obj)
    finally:
        osd.stop()


@pytest.mark.parametrize("third,dropped", [
    (None, []),                      # one other position: fewer than k
    (("idx", 2, 2), []),             # k others, not at one version
    (("idx", 2, 3), [("idx", 1)]),   # k others at the kept version
    (("idx", 1, 3), []),             # a copy at the member's position
])
def test_the_primary_directs_a_drop_only_where_k_others_rebuild(third,
                                                               dropped):
    """(b), the primary's side.  Up set [primary, member, third]; the
    primary holds shard 0 of ``idx`` at v3, the member shard 1 at v3,
    past the discard point v0.  The primary may have the member's copy
    dropped only where k=2 OTHER positions of the up set hold ``idx`` at
    their newest version: a copy at the member's own position elsewhere
    never counts.  A copy it directs dropped leaves the member's
    recorded inventory."""
    osd, pg, up = bare_primary("port")
    try:
        member = up[1]
        osd._peer_invs[pg] = {member: {("idx", 1): 3}}
        if third is not None:
            osd._peer_invs[pg][up[2]] = {third[:2]: third[2]}
        got = osd._rebuildable_copies(pg, member, {("idx", 1): 3}, 0, {})
        assert got == dropped
        assert (("idx", 1) in osd._peer_invs[pg][member]) == (not dropped)
    finally:
        osd.stop()


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("up_v", [1, 2])
def test_a_torn_rollback_target_needs_k_up_positions(pkg, up_v):
    """(b), the torn-object reconcile.  The primary holds shard 0 of
    ``idx`` at v3, past the rest; two OSDs off the up set hold shards 1
    and 2 at v2; the up set's positions 1 and 2 hold v``up_v``.  At
    ``up_v`` 2 the up set holds the target v2 at k=2 and the primary's
    copy, which has no pre-image, is dropped for a rebuild.  At ``up_v``
    1 only the copies off the up set hold v2: the port keeps the copy;
    the JAX package counts them and drops it."""
    osd, pg, up = bare_primary(pkg)
    ostore = mod(pkg, "osd.objectstore")
    cid, obj = ostore.CollectionId(1, 0), ostore.ObjectId("idx", shard=0)
    try:
        osd._peer_invs[pg] = {up[1]: {("idx", 1): up_v},
                              up[2]: {("idx", 2): up_v},
                              7: {("idx", 1): 2}, 8: {("idx", 2): 2}}
        pool = osd.osdmap.pools[1]
        osd._reconcile_ec(pg, pool, up)
        kept = osd.store.exists(cid, obj)
        assert kept == (pkg == "port" and up_v == 1)
    finally:
        osd.stop()


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("closed_at", [2, 3])
def test_a_write_of_the_interval_is_not_called_torn(pkg, closed_at):
    """The reconcile churn of the saturation smokes.  The primary's
    shard 0 of ``idx`` is at v3; the up set's other positions were
    inventoried at v2.  The round closed with the counter at
    ``closed_at``.  At 2, v3 is this primary's write since the round:
    the inventories predate it, and the port keeps the copy.  The JAX
    package calls it torn and drops the copy, whose next rebuild a later
    write tears again, until the point's recovery misses its deadline.
    At 3, v3 predates the round, which saw it on one shard: torn,
    dropped in both packages."""
    osd, pg, up = bare_primary(pkg)
    ostore = mod(pkg, "osd.objectstore")
    cid, obj = ostore.CollectionId(1, 0), ostore.ObjectId("idx", shard=0)
    try:
        osd._peer_invs[pg] = {up[1]: {("idx", 1): 2}, up[2]: {("idx", 2): 2}}
        osd._round_closed_at = {pg: closed_at}
        osd._reconcile_ec(pg, osd.osdmap.pools[1], up)
        kept = osd.store.exists(cid, obj)
        assert kept == (pkg == "port" and closed_at == 2)
    finally:
        osd.stop()


# ------------------------------------------------------ the staging in a cluster
def holders_logs(c, pid: int) -> dict:
    """osd -> {version: epoch} of pg ``pid``.0's log."""
    daemon = type(next(iter(c.osds.values())))
    pg = importlib.import_module(daemon.__module__).PgId(pid, 0)
    return {i: {e.version: e.epoch for e in o._pglog(pg).entries()}
            for i, o in c.osds.items()}


def raises(fn, *args) -> bool:
    try:
        fn(*args)
    except Exception:  # noqa: BLE001 - the error is the answer
        return True
    return False


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_pushed_omap_object_keeps_its_epoch_and_both_objects_read(
        pkg, monkeypatch):
    """(c) EC k=2 m=1, one PG, 4 OSDs.  An omap object (``idx``, created
    and updated by ``omap_set`` as the gateway's index objects are) and
    a whole-written object (``d``) are committed at one epoch.  The up
    set's last member is killed, so the spare joins with an empty view
    and recovery pushes it both objects; the killed OSD comes back with
    a fresh store, and the up set takes it back.  Then a write.

    In the port no peering round finds a fork: every member logs each
    version under the epoch it was committed in.  The new write's
    version is past every version the PG held, and both objects read
    back with their bytes and omap.  In the JAX package the push logged
    ``idx``'s version under the spare's epoch, the primary took that for
    the newer interval's, discarded its own history from there and had
    the members discard theirs, and ``d`` is lost (its read fails)."""
    torch.set_num_threads(1)
    vstart = mod(pkg, "tools.vstart")
    dmod = mod(pkg, "osd.daemon")
    forks = []
    merge = dmod.OSDDaemon._merge_peer_log

    def counted(self, pgid, m):
        found = merge(self, pgid, m)
        if found:
            forks.append((self.osd_id, m.from_osd))
        return found

    monkeypatch.setattr(dmod.OSDDaemon, "_merge_peer_log", counted)
    c = vstart.MiniCluster(n_osds=4, cfg=make_cfg(pkg)).start()
    try:
        cl = c.client()
        cl.create_pool("p", kind="ec", pg_num=1, ec_profile=dict(EC))
        pid = cl._pool_id("p")
        want = {f"k{i}": bytes([i]) * 8 for i in range(3)}
        for k, v in want.items():
            cl.omap_set("p", "idx", {k: v})
        data = np.random.default_rng(20).integers(
            0, 256, 10240, dtype=np.uint8).tobytes()
        cl.write_full("p", "d", data)
        up0 = cl.osdmap.pg_to_up_osds(pid, 0)
        spare = ({0, 1, 2, 3} - set(up0)).pop()
        head = max(max(log, default=0)
                   for log in holders_logs(c, pid).values())
        victim = up0[-1]
        # each map change's peering rounds run out before the next
        c.kill_osd(victim)
        time.sleep(3.0)
        assert len(holders_logs(c, pid)[spare]) >= 2
        c.revive_osd(victim)
        time.sleep(4.0)
        assert c.client().osdmap.pg_to_up_osds(pid, 0) == up0
        reader = c.client()
        reader.write_full("p", "after", b"z" * 100)
        if pkg == "ref":
            wait_for(lambda: raises(reader.read, "p", "d"),
                     "d stayed readable", 20.0)
            return
        primary = c.osds[up0[0]]
        wait_for(lambda: all(
            max(holders_logs(c, pid)[o], default=0) > head for o in up0)
            and not primary._peering, "the write never settled")
        time.sleep(1.0)  # the rounds a fork would set off
        assert forks == []
        assert reader.omap_get("p", "idx") == want
        assert reader.read("p", "d") == data
        assert reader.read("p", "after") == b"z" * 100
        logs = holders_logs(c, pid)
        after = [v for log in logs.values() for v in log if v > head]
        assert after and min(after) > head
        for v in range(1, head + 1):
            assert len({log[v] for log in logs.values() if v in log}) <= 1
    finally:
        c.stop()


def test_the_rgw_saturation_point_recovers_and_reads_back(monkeypatch):
    """The gateway smoke's point (``bench_root --saturate --smoke
    --frontend rgw``'s configuration, as
    ``experiments/rgw_rollback_trace.py`` runs it, seed 0): a kill and a
    fresh revive under gateway traffic.  Recovery completes, the sweep
    did not retry the point, and before the cluster stops every RADOS
    object of the pool reads back, its data and its omap (the gateway's
    index and log objects, and every data piece), and every object of
    the bucket answers a GET through the gateway.

    The bodies are not compared: the workers PUT the same keys at once,
    and the gateway's PUT (both packages) drops the key's data, writes
    it and sets the index entry in three steps, so concurrent PUTs of a
    key can leave an index entry whose size the data does not match."""
    torch.set_num_threads(1)
    seen = {}
    real = scenarios._run_point_on

    def run_on(c, cfg):
        row = real(c, cfg)
        cl = c.client()
        for name in cl.list_objects("sat"):
            seen[name] = (len(cl.read("sat", name)),
                          len(cl.omap_get("sat", name)))
        gw = RgwGateway(cl, "sat", listen=False)
        seen["gets"] = [gw.get_object("sat", f"o{i:04d}")[2]
                        for i in range(cfg.objects)]
        return row

    monkeypatch.setattr(scenarios, "_run_point_on", run_on)
    base = scenarios.ScenarioConfig(
        profile="small_mixed", procs=2, clients=12, objects=16,
        ramp_rates=(40.0,), ramp_leg_s=1.0, steady_s=2.0, thrash_s=4.0,
        kill_after_s=0.6, recovery_deadline_s=30.0, seed=0)
    base.frontend = "rgw"
    row = scenarios.run_sweep(points=[{
        "id": "smoke", "osd_mclock_recovery_res": 16.0,
        "osd_mclock_recovery_lim": 32.0}], base=base)
    (point,) = row["points"]
    assert "retried" not in point
    assert point["recovery"]["completed"], point["recovery"]
    assert all(point["invariants"].values()), point["invariants"]
    assert seen.pop("gets") == [200] * 16
    # the index objects, each holding one entry per key
    for name in ("rgw_buckets", "rgw_index.sat", "rgw_bilog.sat"):
        assert seen.get(name, (0, 0))[1] > 0, (name, sorted(seen))


def test_a_retried_point_keeps_why_its_first_attempt_failed(monkeypatch):
    """``run_sweep`` retries a point once; the row it keeps is the
    retry's, so it carries the first attempt's invariants and recovery
    (``first_attempt``), and a recovery that missed its deadline says
    what still held it (``recovery["stuck"]``, from
    ``_recovery_stuck``)."""
    rows = iter([
        {"invariants": {"recovery_completes": False},
         "recovery": {"completed": False, "stuck": {"progress": ["x"]}}},
        {"invariants": {"recovery_completes": True},
         "recovery": {"completed": True}, "steady": {}}])
    monkeypatch.setattr(scenarios, "run_point", lambda cfg: next(rows))
    row = scenarios.run_sweep(points=[{"id": "p"}],
                              base=scenarios.ScenarioConfig(thrash=False))
    (point,) = row["points"]
    assert point["retried"] is True
    assert point["first_attempt"] == {
        "invariants": {"recovery_completes": False},
        "recovery": {"completed": False, "stuck": {"progress": ["x"]}}}


def test_a_stuck_recovery_names_what_holds_it():
    torch.set_num_threads(1)
    vstart = mod("port", "tools.vstart")
    c = vstart.MiniCluster(n_osds=3, cfg=make_cfg("port")).start()
    try:
        cl = c.client()
        cl.create_pool("p", kind="ec", pg_num=1, ec_profile=dict(EC))
        cl.write_full("p", "x", b"x" * 4096)
        osd = next(iter(c.osds.values()))
        osd._rebuilds_out[(mod("port", "osd.daemon").PgId(1, 0), "x", 2,
                           7)] = False
        stuck = scenarios._recovery_stuck(c, time.time())
        assert stuck["progress"] == []
        assert set(stuck) == {"progress"} | {f"osd.{i}" for i in c.osds}
        assert stuck[f"osd.{osd.osd_id}"]["rebuilds_out"] == [
            "1.0:x/2->osd.7"]
        assert all(v["inflight"] == 0 and v["queued"] == 0
                   and v["storms"] == {}
                   for k, v in stuck.items() if k != "progress")
    finally:
        c.stop()


def progress_event(daemon: str, kind: str, pg: str, ts: float) -> dict:
    return {"daemon": daemon, "ts": ts,
            "fields": {"event": kind, "pg": pg, "start_ts": ts,
                       "done": 1, "total": 4}}


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_down_osd_closes_its_progress_items(pkg):
    """What held the rados smoke's recovery open on the card after its
    data had recovered: every OSD idle, but the monitor's progress
    tracker still showing storms the killed OSD opened before its kill
    (a deep-scrub cycle), which never report done, for the tracker's
    60 s staleness timeout, past the point's 30 s deadline.  In the port
    marking the OSD down, and booting it again, completes its open items
    as stale; other daemons' items stay.  The JAX package keeps them
    active."""
    torch.set_num_threads(1)
    vstart = mod(pkg, "tools.vstart")
    c = vstart.MiniCluster(n_osds=3, cfg=make_cfg(pkg)).start()
    try:
        now = time.time()
        for daemon, kind, pg in (("osd.2", "scrub_start", "1.1"),
                                 ("osd.2", "recovery_start", "1.2"),
                                 ("osd.1", "recovery_start", "1.3")):
            c.mon.progress.on_event(progress_event(daemon, kind, pg, now))
        c.client().mon_command({"prefix": "osd down", "id": 2})
        owners = sorted(it["message"] for it in c.mon.progress.active())
        if pkg == "ref":
            assert owners == ["Deep scrub pg 1.1 (osd.2)",
                              "Recovery pg 1.2 (osd.2)",
                              "Recovery pg 1.3 (osd.1)"]
            return
        assert owners == ["Recovery pg 1.3 (osd.1)"]
        assert {it["message"]: it.get("stale") for it in
                c.mon.progress.items() if "osd.2" in it["message"]} == {
            "Deep scrub pg 1.1 (osd.2)": True,
            "Recovery pg 1.2 (osd.2)": True}
        c.mon.progress.on_event(progress_event("osd.1", "scrub_start",
                                               "1.4", now))
        c.kill_osd(1, mark_down=False)
        c.revive_osd(1)
        wait_for(lambda: not c.mon.progress.active(),
                 "osd.1's items outlived its boot")
    finally:
        c.stop()
