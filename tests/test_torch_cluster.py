"""The port's cluster (``MiniCluster``, its OSDs and the client) on
``torch`` pools with ``device=cpu``, held against the JAX package's.

- Shard parity: one seeded workload (full and partial writes to a
  ``tpu`` k=4 m=2 pool, two shard OSDs killed, degraded reads) runs on a
  JAX-package cluster with ``ec_backend=native`` and on a port cluster
  with ``torch`` on the CPU; the clients read the same bytes, and every
  surviving OSD stores the same shards with the same attributes (the
  CRC32C digest ``d`` among them), object by object.  The entry epochs
  (``ev``, and the PG log that carries them) depend on timing and are
  not compared.
- The EC cases of the JAX package's ``tests/test_cluster.py``,
  ``test_scrub_fold.py`` and ``test_ec_read_pipeline.py`` that cross a
  device seam, on torch pools.  Where those wait a fixed time
  (``settle``), these poll for what they wait for, with a deadline.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ceph_tpu.tools.vstart as ref_vstart
import ceph_tpu.utils.config as ref_config
import ceph_tpu_torch.tools.vstart as port_vstart
from ceph_tpu_torch import ec
from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.ec.batcher import ECBatcher
from ceph_tpu_torch.ec.verify import verifier
from ceph_tpu_torch.ops import ec_kernels, gf256
from ceph_tpu_torch.ops.checksum import crc32c_extend_zeros, crc32c_ref
from ceph_tpu_torch.osd.objectstore import CollectionId, ObjectId
from ceph_tpu_torch.osd.pglog import PGLOG_OID
from ceph_tpu_torch.utils.config import default_config

RNG = np.random.default_rng(77)
#: the tpu plugin on the torch backend on the CPU
TORCH_CPU = {"backend": "torch", "device": "cpu"}
WAIT_S = 30.0


def make_cfg(config=default_config, **over):
    """The JAX package's ``tests/test_cluster.py`` settings: heartbeat
    0.05 s, grace 0.5 s, 2 op shards, 2 dispatch workers."""
    cfg = config()
    cfg.apply_dict({"osd_heartbeat_interval": 0.05,
                    "osd_heartbeat_grace": 0.5,
                    "osd_op_num_shards": 2,
                    "ms_dispatch_workers": 2, **over})
    return cfg


def wait_until(what: str, done, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not done():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} not within {timeout} s")
        time.sleep(0.02)


def wait_for_map(cluster, client, epoch: int) -> None:
    """The monitors, then the client, hold map ``epoch``: a read sent on
    an older map goes to a dead primary and waits out the op timeout."""
    cluster.wait_for_epoch(epoch, timeout=WAIT_S)
    wait_until(f"{client.name} at map epoch {epoch}",
               lambda: client.osdmap.epoch >= epoch)


def tpu(k: int, m: int, **profile) -> dict:
    return {"plugin": "tpu", "k": str(k), "m": str(m), **TORCH_CPU,
            **profile}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """A torch pool on the CPU runs the kernels' plain versions: hundreds
    of small torch ops a launch.  Each op of a pool of intra-op threads
    leaves those threads spinning on the cores that the cluster's
    heartbeats need, and the monitor marks OSDs down; one thread keeps
    the cluster's timing that of a native pool's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def big_cluster():
    """8 OSDs (the JAX package's copy has 12): k=4 m=2 with two spares;
    each OSD's heartbeats take the interpreter lock from the plain
    versions' ops, so fewer OSDs keep a torch pool's writes short."""
    c = port_vstart.MiniCluster(n_osds=8, cfg=make_cfg()).start()
    yield c
    c.stop()


# ---------------------------------------------------------- shard parity
PARTIAL = ((100, 500), (5000, 9000), (16_000, 4096), (40_000, 3000))


def parity_workload(vstart, cfg, profile: dict) -> tuple[dict, dict]:
    """Full writes of 4 objects, a partial write into each (one past the
    end), two shard OSDs killed with no spare to rebuild on, then every
    object read back degraded.  Returns (the client's reads, every
    surviving OSD's shards and attributes)."""
    rng = np.random.default_rng(7)
    c = vstart.MiniCluster(n_osds=6, cfg=cfg).start()
    try:
        cl = c.client()
        cl.create_pool("ec", kind="ec", pg_num=2, ec_profile=profile)
        objs = {}
        for i in range(4):
            data = rng.integers(0, 256, 30_000 + 7000 * i,
                                dtype=np.uint8).tobytes()
            cl.write_full("ec", f"o{i}", data)
            objs[f"o{i}"] = bytearray(data)
        for i, (off, n) in enumerate(PARTIAL):
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            cl.write("ec", f"o{i}", data, offset=off)
            buf = objs[f"o{i}"]
            buf.extend(bytes(max(0, off - len(buf))))
            buf[off:off + n] = data
        healthy = {n: cl.read("ec", n) for n in objs}
        epoch = c.mon.osdmap.epoch
        for victim in (1, 4):
            c.kill_osd(victim)
        wait_for_map(c, cl, epoch + 2)
        reads = {n: (healthy[n], cl.read("ec", n),
                     cl.read("ec", n, offset=2000, length=7000))
                 for n in objs}
        for n, buf in objs.items():
            assert reads[n] == (bytes(buf), bytes(buf),
                                bytes(buf[2000:9000])), n
        shards = {}
        for osd_id, osd in sorted(c.osds.items()):
            for cid in osd.store.list_collections():
                for oid in osd.store.list_objects(cid):
                    if oid.name == PGLOG_OID.name:
                        continue
                    attrs = dict(osd.store.getattrs(cid, oid))
                    attrs.pop("ev", None)
                    shards[(osd_id, cid.pool, cid.pg_seed, oid.name,
                            oid.shard, oid.generation)] = (
                        osd.store.read(cid, oid).to_bytes(), attrs)
        return reads, shards
    finally:
        c.stop()


def test_port_cluster_stores_the_references_shards():
    ref_reads, ref_shards = parity_workload(
        ref_vstart, make_cfg(ref_config.default_config,
                             ec_backend="native"),
        {"plugin": "tpu", "k": "4", "m": "2"})
    plain = ec_kernels.launch_counts()["plain"]
    reads, shards = parity_workload(port_vstart, make_cfg(), tpu(4, 2))
    assert ec_kernels.launch_counts()["plain"] > plain  # ran on torch
    assert reads == ref_reads
    assert sorted(shards) == sorted(ref_shards)
    assert {k[3] for k in shards} == {"o0", "o1", "o2", "o3"}
    assert {k[0] for k in shards} == {0, 2, 3, 5}
    for key, (data, attrs) in ref_shards.items():
        assert shards[key][0] == data, key
        assert "d" in attrs and shards[key][1] == attrs, key


# ------------------------------- tests/test_cluster.py's EC cases on torch
def test_ec_pool_write_read(big_cluster):
    client = big_cluster.client()
    client.create_pool("ecpool", kind="ec", pg_num=4,
                       ec_profile={"plugin": "jerasure", "k": "4",
                                   "m": "2", **TORCH_CPU})
    payload = RNG.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    client.write_full("ecpool", "bigobj", payload)
    assert client.read("ecpool", "bigobj") == payload
    assert client.stat("ecpool", "bigobj") == len(payload)


def test_ec_degraded_read_after_osd_loss(big_cluster):
    """Write, kill two OSDs, read back with reconstruction
    (qa/standalone/erasure-code/test-erasure-code.sh)."""
    client = big_cluster.client()
    client.create_pool("ecpool", kind="ec", pg_num=2,
                       ec_profile=tpu(4, 2))
    objs = {f"obj{i}": RNG.integers(0, 256, 50_000,
                                    dtype=np.uint8).tobytes()
            for i in range(4)}
    for name, data in objs.items():
        client.write_full("ecpool", name, data)
    victims = sorted(big_cluster.osds)[:2]
    epoch = big_cluster.mon.osdmap.epoch
    for v in victims:
        big_cluster.kill_osd(v)
    wait_for_map(big_cluster, client, epoch + 2)
    for name, data in objs.items():
        assert client.read("ecpool", name) == data, name


def test_ec_loss_beyond_m_fails(big_cluster):
    client = big_cluster.client()
    client.create_pool("ec31", kind="ec", pg_num=1, ec_profile=tpu(3, 1))
    payload = b"x" * 10_000
    client.write_full("ec31", "obj", payload)
    pool_id = client._pool_id("ec31")
    up = big_cluster.mon.osdmap.pg_to_up_osds(
        pool_id, big_cluster.mon.osdmap.object_to_pg(pool_id, "obj"))
    epoch = big_cluster.mon.osdmap.epoch
    for v in [u for u in up if u is not None][:2]:
        big_cluster.kill_osd(v)
    wait_for_map(big_cluster, client, epoch + 2)
    # spares may rebuild from survivors before the second loss lands:
    # full recovery or a clean error, never wrong data
    try:
        assert client.read("ec31", "obj") == payload
    except RadosError as e:
        assert e.code in (-5, -11, -110)


def test_recovery_rebuilds_shards_on_spare(big_cluster):
    client = big_cluster.client()
    client.create_pool("ecpool", kind="ec", pg_num=1, ec_profile=tpu(4, 2))
    pool_id = client._pool_id("ecpool")
    payload = RNG.integers(0, 256, 30_000, dtype=np.uint8).tobytes()
    client.write_full("ecpool", "obj", payload)
    m = big_cluster.mon.osdmap
    seed = m.object_to_pg(pool_id, "obj")
    victim = m.pg_to_up_osds(pool_id, seed)[1]
    epoch = m.epoch
    big_cluster.kill_osd(victim)
    wait_for_map(big_cluster, client, epoch + 1)
    spare = big_cluster.mon.osdmap.pg_to_up_osds(pool_id, seed)[1]
    assert spare is not None and spare != victim
    # the spare must come to hold shard 1, rebuilt from survivors
    store = big_cluster.osds[spare].store
    wait_until("shard 1 rebuilt on the spare",
               lambda: store.exists(CollectionId(pool_id, seed),
                                    ObjectId("obj", shard=1)))
    assert client.read("ecpool", "obj") == payload


def test_tpu_plugin_pool_in_cluster(big_cluster):
    """The flagship tpu plugin on the torch backend serving a live EC
    pool, degraded read included."""
    client = big_cluster.client()
    client.create_pool("tpupool", kind="ec", pg_num=2,
                       ec_profile=tpu(4, 2))
    payload = RNG.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    client.write_full("tpupool", "obj", payload)
    assert client.read("tpupool", "obj") == payload
    pool_id = client._pool_id("tpupool")
    seed = big_cluster.mon.osdmap.object_to_pg(pool_id, "obj")
    up = big_cluster.mon.osdmap.pg_to_up_osds(pool_id, seed)
    epoch = big_cluster.mon.osdmap.epoch
    big_cluster.kill_osd(up[0])
    wait_for_map(big_cluster, client, epoch + 1)
    assert client.read("tpupool", "obj") == payload


def test_ec_ranged_read(big_cluster):
    client = big_cluster.client()
    client.create_pool("ecr", kind="ec", pg_num=2, ec_profile=tpu(4, 2))
    payload = RNG.integers(0, 256, 25_600, dtype=np.uint8).tobytes()
    client.write_full("ecr", "obj", payload)
    assert client.read("ecr", "obj", offset=500, length=100) == \
        payload[500:600]
    assert client.read("ecr", "obj", offset=25_000) == payload[25_000:]


def test_repeat_reads_are_served_from_the_arena(big_cluster):
    """The hot-read tier on a torch pool: a full write leaves the
    object's streams in the primary's extent cache, and its reads
    assemble from the arena, the second without staging again."""
    client = big_cluster.client()
    client.create_pool("hot", kind="ec", pg_num=1, ec_profile=tpu(4, 2))
    payload = RNG.integers(0, 256, 60_000, dtype=np.uint8).tobytes()
    client.write_full("hot", "obj", payload)
    pool_id = client._pool_id("hot")
    seed = big_cluster.mon.osdmap.object_to_pg(pool_id, "obj")
    primary = big_cluster.osds[
        big_cluster.mon.osdmap.pg_to_up_osds(pool_id, seed)[0]]
    arena = primary._ec_cache.arena("cpu")
    assert arena is not None and arena.device.type == "cpu"
    served = primary.perf.get("ec_read_cache_hit")
    hits = arena._perf.get("ec_arena_hits")
    assert client.read("hot", "obj") == payload
    assert client.read("hot", "obj") == payload
    assert primary.perf.get("ec_read_cache_hit") - served == 2
    assert arena._perf.get("ec_arena_hits") - hits >= 4


# ------------------------- tests/test_scrub_fold.py's EC cases on torch
def scrub_cfg(**over):
    # fifo queue: a forced tick runs the whole cycle inline
    return make_cfg(osd_op_queue="fifo", osd_scrub_fold="device",
                    osd_scrub_chunk_max=8, **over)


def force_scrub(osd):
    """Arm and run one background deep-scrub cycle on every hosted PG."""
    osd._scrub_tick(time.time())
    for st in osd._scrub_auto.values():
        st["due"] = 0.0
    osd._scrub_tick(time.time())


def test_folded_verify_ec_pool():
    """EC shards (parity included) carry stored digests and fold through
    the verify seam; ``osd_scrub_fold=device`` runs the plain version of
    the CRC kernel on this host."""
    c = port_vstart.MiniCluster(n_osds=4, cfg=scrub_cfg()).start()
    try:
        client = c.client()
        client.create_pool("ec", kind="ec", pg_num=1, ec_profile=tpu(2, 1))
        payload = RNG.integers(0, 256, 9000, dtype=np.uint8).tobytes()
        client.write_full("ec", "obj", payload)
        pool_id = client._pool_id("ec")
        seed = c.mon.osdmap.object_to_pg(pool_id, "obj")
        up = c.mon.osdmap.pg_to_up_osds(pool_id, seed)
        cid = CollectionId(pool_id, seed)
        for shard, osd_id in enumerate(up):
            osd = c.osds[osd_id]
            wait_until(f"osd.{osd_id} holds shard {shard}",
                       lambda: osd.store.exists(
                           cid, ObjectId("obj", shard=shard)))
            plain = ec_kernels.launch_counts()["plain"]
            force_scrub(osd)
            assert osd.perf.get("scrub_mismatches") == 0
            assert osd.perf.get("scrub_verified_bytes") > 0
            assert ec_kernels.launch_counts()["plain"] > plain
    finally:
        c.stop()


def test_folded_matches_python_loop_on_bitflip():
    """A bit flip is caught by the folded verify on the torch path
    exactly as by the per-object loop: same victim, no false positive
    on 40 ragged objects."""
    objs = [RNG.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in RNG.integers(1, 6000, 40)]
    digests = [crc32c_ref(o) for o in objs]
    victim = 17
    bad = bytearray(objs[victim])
    bad[len(bad) // 2] ^= 0x10
    objs[victim] = bytes(bad)
    loop_bad = [i for i, (o, d) in enumerate(zip(objs, digests))
                if crc32c_ref(o) != d]
    ver = verifier("device", device="cpu")
    batcher = ECBatcher(window_us=0.0)
    buckets: dict[int, list] = {}
    for i, o in enumerate(objs):
        n = len(o)
        buckets.setdefault(4 if n <= 4 else 1 << (n - 1).bit_length(),
                           []).append(i)
    folded_bad = []
    for blen, idxs in sorted(buckets.items()):
        rows = np.zeros((len(idxs), blen), dtype=np.uint8)
        expected = np.empty(len(idxs), dtype=np.uint32)
        for r, i in enumerate(idxs):
            rows[r, :len(objs[i])] = np.frombuffer(objs[i], dtype=np.uint8)
            expected[r] = crc32c_extend_zeros(digests[i],
                                              blen - len(objs[i]))
        digs = batcher.verify(ver, rows)
        for r in np.nonzero(digs != expected)[0]:
            i = idxs[int(r)]
            if crc32c_ref(objs[i]) != digests[i]:
                folded_bad.append(i)
    assert loop_bad == [victim]
    assert sorted(folded_bad) == loop_bad


# ------------------- tests/test_ec_read_pipeline.py's cases on torch
def test_batcher_folded_decode_sharing_one_launch():
    """Same-signature decodes submitted together share one folded
    inverse-matrix launch, byte-exact per op."""
    codec = ec.factory("tpu", {"k": 4, "m": 2, **TORCH_CPU})
    L, n = 2048, 4
    cases = []
    for _ in range(n):
        data = RNG.integers(0, 256, (4, L), dtype=np.uint8)
        parity = gf256.encode_region(codec.matrix, data)
        chunks = {i: data[i] for i in range(4) if i != 1}
        chunks.update({4 + j: parity[j] for j in range(2)})
        cases.append((data, chunks))
    b = ECBatcher(window_us=200_000, max_bytes=64 << 20)
    results = [None] * n
    barrier = threading.Barrier(n)

    def reader(i):
        barrier.wait(timeout=WAIT_S)
        results[i] = b.decode(codec, [0, 1, 2, 3], dict(cases[i][1]))

    threads = [threading.Thread(target=reader, args=(i,))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    assert b.stats["launches"] == 1
    for (data, _), out in zip(cases, results):
        for i in range(4):
            assert np.array_equal(np.asarray(out[i]), data[i])


def read_cfg(**over):
    return make_cfg(ec_read_coalesce="on",
                    # the extent-cache serve would shortcut the fan-out
                    ec_read_cache_serve="off",
                    ec_read_window_us=500.0, **over)


@pytest.fixture
def read_cluster():
    """6 OSDs, k=4 m=2 and no spare: a killed OSD's shards stay lost, so
    degraded reads stay degraded."""
    c = port_vstart.MiniCluster(n_osds=6, cfg=read_cfg()).start()
    cl = c.client()
    cl.create_pool("ecr", kind="ec", pg_num=4, ec_profile=tpu(4, 2))
    yield c, cl
    c.stop()


def write_set(cl, n=4, size=24_000):
    payloads = {}
    for i in range(n):
        data = bytes(RNG.integers(0, 256, size, dtype=np.uint8))
        payloads[f"o{i}"] = data
        cl.write_full("ecr", f"o{i}", data)
    return payloads


def burst(c, payloads, readers=4, rounds=1):
    clients = [c.client() for _ in range(readers)]
    errors = []

    def reader(r):
        try:
            for _ in range(rounds):
                for name in sorted(payloads):
                    assert clients[r].read("ecr", name) == payloads[name]
        except Exception as e:  # noqa: BLE001 - surfaced by the test
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(r,))
               for r in range(readers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=4 * WAIT_S)
        assert not t.is_alive()
    return errors


def test_e2e_healthy_burst_byte_identity_and_coalescing(read_cluster):
    c, cl = read_cluster
    payloads = write_set(cl)
    errors = burst(c, payloads, rounds=2)
    assert not errors, errors[:3]
    tot = {}
    for osd in c.osds.values():
        for k, v in osd.perf.dump().items():
            if k.startswith("ec_read") and isinstance(v, (int, float)):
                tot[k] = tot.get(k, 0) + v
    assert tot["ec_read_msgs"] > 0
    assert tot["ec_read_coalesced_subreads"] + tot["ec_read_dup_hits"] \
        > tot["ec_read_msgs"]


def test_e2e_degraded_read_byte_identity(read_cluster):
    c, cl = read_cluster
    payloads = write_set(cl)
    epoch = c.mon.osdmap.epoch
    c.kill_osd(5)  # no spares: every PG it held a shard for decodes
    wait_for_map(c, cl, epoch + 1)
    plain = ec_kernels.launch_counts()["plain"]
    errors = burst(c, payloads)
    assert not errors, errors[:3]
    assert ec_kernels.launch_counts()["plain"] > plain  # torch decodes


# ------------------------------------------------- tools/vstart on the port
def test_spawned_osd_runs_the_ports_osd_main(monkeypatch):
    """``spawn_osd_process`` starts ``ceph_tpu_torch.tools.osd_main``
    with the port's root on the child's path."""
    import os
    import subprocess

    import ceph_tpu_torch

    seen = {}

    class FakePopen:
        def __init__(self, argv, env=None):
            seen.update(argv=argv, env=env)

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    c = port_vstart.MiniCluster(n_osds=0, cfg=make_cfg(), transport="tcp")
    try:
        c.mon.start()
        c.spawn_osd_process(3)
    finally:
        c.procs.clear()
        c.stop()
    assert seen["argv"][1:3] == ["-m", "ceph_tpu_torch.tools.osd_main"]
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(ceph_tpu_torch.__file__)))
    assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == root


# ------------------------------- recovery of a member moved by the re-draw
def test_ec_positions_moved_needs_a_member_at_another_position():
    """The OSD forces full-inventory peering on an EC PG exactly when a
    member of the previous interval holds another shard position."""
    from ceph_tpu_torch.mon.maps import OSDMap, PoolSpec
    from ceph_tpu_torch.msg.messages import PgId
    from ceph_tpu_torch.msg.messenger import LocalNetwork
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    from ceph_tpu_torch.osd.intervals import Interval

    osd = OSDDaemon(0, LocalNetwork(), cfg=make_cfg())
    try:
        omap = OSDMap()
        omap.pools[1] = PoolSpec(1, "ec", "ec", 4, 3, 1, tpu(3, 1))
        omap.pools[2] = PoolSpec(2, "rep", "replicated", 3, 2, 1, {})
        osd.osdmap = omap
        pg, rep = PgId(1, 0), PgId(2, 0)
        assert not osd._ec_positions_moved(pg, [0, 1, 2, 3])  # no history
        osd._pi(pg).intervals.append(Interval(1, 4, [0, 1, 2, 3], 0))
        assert not osd._ec_positions_moved(pg, [0, 1, 2, 3])
        assert not osd._ec_positions_moved(pg, [0, 5, 2, 3])  # a spare
        assert not osd._ec_positions_moved(pg, [0, None, 2, 3])
        assert osd._ec_positions_moved(pg, [0, 3, 2, 5])  # 3 moved
        osd._pi(rep).intervals.append(Interval(1, 4, [0, 1, 2], 0))
        assert not osd._ec_positions_moved(rep, [1, 0, 2])
    finally:
        osd.stop()


def test_swapped_members_get_their_new_shards():
    """An EC PG whose map swaps two members' positions (here by
    ``osd pg-upmap``; the placement's re-draw around a down device does
    it too) peers on full inventories, rebuilds each member's new shard
    and serves reads.  The JAX package's lean round finds both members
    in sync: the shards are never rebuilt and every read of the PG
    fails with EIO."""
    c = port_vstart.MiniCluster(n_osds=4,
                                cfg=make_cfg(ec_backend="native")).start()
    try:
        cl = c.client()
        cl.create_pool("ec", kind="ec", pg_num=1, ec_profile={
            "plugin": "tpu", "k": "2", "m": "1"})
        pool_id = cl._pool_id("ec")
        payloads = {f"o{i}": RNG.integers(0, 256, 5000 + i,
                                         dtype=np.uint8).tobytes()
                    for i in range(3)}
        for name, data in payloads.items():
            cl.write_full("ec", name, data)
        up = c.mon.osdmap.pg_to_up_osds(pool_id, 0)
        epoch = c.mon.osdmap.epoch
        cl.mon_command({"prefix": "osd pg-upmap", "pool": pool_id,
                        "seed": 0, "osds": [up[1], up[0], up[2]]})
        wait_for_map(c, cl, epoch + 1)
        assert c.mon.osdmap.pg_to_up_osds(pool_id, 0) == \
            [up[1], up[0], up[2]]
        cid = CollectionId(pool_id, 0)

        def rebuilt():
            now = c.mon.osdmap.pg_to_up_osds(pool_id, 0)
            return all(c.osds[now[shard]].store.exists(
                cid, ObjectId(name, shard=shard))
                for name in payloads for shard in range(3))

        wait_until("the swapped members' shards rebuilt", rebuilt)
        for name, data in payloads.items():
            assert cl.read("ec", name) == data
    finally:
        c.stop()
