"""The port's block images (ceph_tpu_torch.services.rbd), held against
the JAX package on the CPU.

- The cases of the JAX package's tests/test_rbd.py and
  tests/test_rbd_objectmap.py on the port; the EC-pool thrash case runs
  on the reference's native pool and on a torch pool with
  ``device=cpu`` (the port's EC write, read and recovery paths on the
  plain versions of the kernels).
- ``ImageHeader`` and ``SnapRecord``: equal bytes from seeded values,
  and each package decodes the other's.
- State carried across: the same image operations (create, a write
  spanning objects, a snapshot, a resize, a write, a rollback, the
  object map) on a reference cluster and on a port cluster leave the
  same RADOS objects, bytes, xattrs and omap; an image's objects copied
  from one package's cluster into the other's open and read back equal,
  in both directions.
"""

import numpy as np
import pytest
import torch

import ceph_tpu.services.rbd as ref_rbd
import ceph_tpu.tools.vstart as ref_vstart
import ceph_tpu_torch.services.rbd as port_rbd
from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.osd.objectstore import CollectionId, ObjectId
from ceph_tpu_torch.services.rbd import (FEATURE_FAST_DIFF,
                                         FEATURE_OBJECT_MAP, OM_EXISTS,
                                         OM_EXISTS_CLEAN, OM_NONEXISTENT,
                                         RBD, RbdError)
from ceph_tpu_torch.tools.vstart import MiniCluster
from tests.test_cluster import make_cfg as ref_make_cfg
from tests.test_torch_cluster import make_cfg, wait_until

# the torch pool's plain versions: one intra-op thread, so the OSDs'
# heartbeats keep their cores
torch.set_num_threads(1)

# -- the cases of tests/test_rbd.py -------------------------------------------
RNG = np.random.default_rng(88)


@pytest.fixture
def cluster():
    c = MiniCluster(n_osds=8, cfg=make_cfg()).start()
    yield c
    c.stop()


#: the EC pools of the thrash case: the reference's, on the host, and a
#: torch pool on the CPU
EC_BACKENDS = {"ec": {"backend": "native"},
               "ec-torch": {"backend": "torch", "device": "cpu"}}


def _mkpool(client, kind="replicated"):
    if kind in EC_BACKENDS:
        client.create_pool("rbd", kind="ec", pg_num=2,
                           ec_profile={"plugin": "jerasure", "k": "4",
                                       "m": "2", **EC_BACKENDS[kind]})
    else:
        client.create_pool("rbd", size=3, pg_num=2)


def test_image_lifecycle_and_io(cluster):
    client = cluster.client()
    _mkpool(client)
    rbd = RBD(client)
    img = rbd.create("rbd", "disk0", 8 * 1024 * 1024,
                     object_size=1024 * 1024)
    assert rbd.list("rbd") == ["disk0"]
    assert img.size() == 8 * 1024 * 1024
    # cross-object writes land byte-exact
    data = RNG.integers(0, 256, 3_000_000, dtype=np.uint8).tobytes()
    img.write(500_000, data)  # spans objects 0..3
    assert img.read(500_000, len(data)) == data
    assert img.read(0, 100) == b"\0" * 100  # sparse reads as zeros
    # bounds are enforced
    with pytest.raises(RbdError):
        img.write(img.size() - 10, b"x" * 20)
    with pytest.raises(RbdError):
        rbd.create("rbd", "disk0", 1)
    rbd.remove("rbd", "disk0")
    assert rbd.list("rbd") == []
    with pytest.raises(RbdError):
        rbd.open("rbd", "disk0")


def test_image_striped_layout(cluster):
    client = cluster.client()
    _mkpool(client)
    rbd = RBD(client)
    img = rbd.create("rbd", "fast", 4 * 1024 * 1024,
                     object_size=1024 * 1024, stripe_unit=65536,
                     stripe_count=4)
    data = RNG.integers(0, 256, 1_000_000, dtype=np.uint8).tobytes()
    img.write(123_456, data)
    assert img.read(123_456, len(data)) == data


def test_resize_trims_and_zeroes(cluster):
    client = cluster.client()
    _mkpool(client)
    img = RBD(client).create("rbd", "d", 4 * 1024 * 1024,
                             object_size=1024 * 1024)
    img.write(0, b"\xAB" * (3 * 1024 * 1024))
    img.resize(1_500_000)
    assert img.size() == 1_500_000
    img.resize(4 * 1024 * 1024)
    # regrown space reads zeros, not stale bytes
    assert img.read(1_500_000, 1_000_000) == b"\0" * 1_000_000
    assert img.read(0, 1_500_000) == b"\xAB" * 1_500_000


def test_snapshots_cow_and_rollback(cluster):
    client = cluster.client()
    _mkpool(client)
    img = RBD(client).create("rbd", "snappy", 2 * 1024 * 1024,
                             object_size=512 * 1024)
    v1 = RNG.integers(0, 256, 1_200_000, dtype=np.uint8).tobytes()
    img.write(0, v1)
    img.snap_create("s1")
    patch = b"\xEE" * 400_000
    img.write(300_000, patch)  # COW copies the touched objects
    head = bytearray(v1)
    head[300_000:700_000] = patch
    assert img.read(0, len(v1)) == bytes(head)
    assert img.read(0, len(v1), snap="s1") == v1  # snapshot is frozen
    img.snap_create("s2")
    img.write(0, b"\x11" * 200_000)
    assert img.read(0, len(v1), snap="s1") == v1
    assert img.read(0, len(v1), snap="s2") == bytes(head)
    assert [s["name"] for s in img.snap_list()] == ["s1", "s2"]
    # rollback to s1 restores head content
    img.snap_rollback("s1")
    assert img.read(0, len(v1)) == v1
    # removing the newest snap keeps the older one readable
    img.snap_remove("s2")
    assert img.read(0, len(v1), snap="s1") == v1
    img.snap_remove("s1")
    assert img.snap_list() == []


def test_shrink_preserves_snapshot_data(cluster):
    """Trimmed objects must COW into the newest snapshot first."""
    client = cluster.client()
    _mkpool(client)
    img = RBD(client).create("rbd", "d", 4 * 1024 * 1024,
                             object_size=1024 * 1024)
    data = RNG.integers(0, 256, 4 * 1024 * 1024,
                        dtype=np.uint8).tobytes()
    img.write(0, data)
    img.snap_create("s1")
    img.resize(1024 * 1024)
    assert img.read(0, 4 * 1024 * 1024, snap="s1") == data
    img.resize(4 * 1024 * 1024)
    assert img.read(1024 * 1024, 3 * 1024 * 1024) == \
        b"\0" * (3 * 1024 * 1024)
    assert img.read(0, 4 * 1024 * 1024, snap="s1") == data


def test_rollback_preserves_newer_snapshots(cluster):
    """Rollback is a mutation: snapshots newer than the target must
    copy-up before the head is overwritten."""
    client = cluster.client()
    _mkpool(client)
    img = RBD(client).create("rbd", "d", 1024 * 1024,
                             object_size=256 * 1024)
    v1 = RNG.integers(0, 256, 1024 * 1024, dtype=np.uint8).tobytes()
    img.write(0, v1)
    img.snap_create("s1")
    v2 = RNG.integers(0, 256, 1024 * 1024, dtype=np.uint8).tobytes()
    img.write(0, v2)
    img.snap_create("s2")  # no writes after s2: no copies yet
    img.snap_rollback("s1")
    assert img.read(0, len(v1)) == v1
    assert img.read(0, len(v2), snap="s2") == v2  # s2 stayed frozen


def test_striped_shrink_zeroes_whole_object_set(cluster):
    """With striping, kept objects hold ranges across the whole object
    set; shrink must zero them all (no resurrection on regrow)."""
    client = cluster.client()
    _mkpool(client)
    img = RBD(client).create("rbd", "d", 4 * 1024 * 1024,
                             object_size=1024 * 1024,
                             stripe_unit=65536, stripe_count=4)
    data = RNG.integers(0, 256, 4 * 1024 * 1024,
                        dtype=np.uint8).tobytes()
    img.write(0, data)
    img.resize(100 * 1024)
    img.resize(4 * 1024 * 1024)
    assert img.read(0, 100 * 1024) == data[:100 * 1024]
    rest = img.read(100 * 1024, 4 * 1024 * 1024 - 100 * 1024)
    assert rest == b"\0" * len(rest)


def test_rollback_to_smaller_then_grow_reads_zeros(cluster):
    client = cluster.client()
    _mkpool(client)
    img = RBD(client).create("rbd", "d", 2 * 1024 * 1024,
                             object_size=512 * 1024)
    img.write(0, b"\xAA" * (2 * 1024 * 1024))
    img.resize(512 * 1024)
    img.snap_create("small")
    img.resize(2 * 1024 * 1024)
    img.write(512 * 1024, b"\xBB" * (512 * 1024))
    img.snap_rollback("small")
    assert img.size() == 512 * 1024
    img.resize(2 * 1024 * 1024)
    tail = img.read(512 * 1024, 3 * 512 * 1024)
    assert tail == b"\0" * len(tail)


@pytest.mark.parametrize("kind", sorted(EC_BACKENDS))
def test_image_on_ec_pool_survives_thrash(cluster, kind):
    """The judge gate: an image on an EC pool keeps byte-exact reads
    through OSD kills and revives."""
    client = cluster.client()
    _mkpool(client, kind=kind)
    img = RBD(client).create("rbd", "vm0", 4 * 1024 * 1024,
                             object_size=512 * 1024)
    data = bytearray(RNG.integers(0, 256, 2_500_000,
                                  dtype=np.uint8).tobytes())
    img.write(0, bytes(data))
    img.snap_create("base")
    cluster.settle(0.5)
    victims = sorted(cluster.osds)[:2]
    epoch = cluster.mon.osdmap.epoch
    for v in victims:
        cluster.kill_osd(v)
    cluster.wait_for_epoch(epoch + 2)
    cluster.settle(1.0)
    # degraded: head and snapshot both byte-exact
    assert img.read(0, len(data)) == bytes(data)
    patch = RNG.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    img.write(1_000_000, patch)
    data[1_000_000:1_300_000] = patch
    assert img.read(0, len(data)) == bytes(data)
    # revive and settle: still byte-exact, snapshot intact
    for v in victims:
        cluster.revive_osd(v)
    cluster.settle(1.5)
    assert img.read(0, len(data)) == bytes(data)
    snap_view = img.read(0, 2_500_000, snap="base")
    assert snap_view[:1_000_000] == bytes(data[:1_000_000])
    assert snap_view[1_300_000:] == bytes(data[1_300_000:])


def test_exclusive_lock_handoff(cluster):
    """Two clients contending for one image behave like librbd's
    exclusive-lock handoff: the writer holds the cls_lock, a contender
    requests it via header notify, the idle holder releases, and
    ownership ping-pongs with every write landing."""
    c1, c2 = cluster.client(), cluster.client()
    c1.create_pool("rbd", size=2, pg_num=2)
    from ceph_tpu_torch.services.rbd import RBD
    img1 = RBD(c1).create("rbd", "img", 8 << 20)
    img2 = RBD(c2).open("rbd", "img")
    img1.write(0, b"A" * 4096)
    assert img1.lock_owner() == c1.name
    # contender acquires via cooperative handoff (c1 idle)
    img2.write(4096, b"B" * 4096)
    assert img2.lock_owner() == c2.name
    # and back
    img1.write(8192, b"C" * 4096)
    assert img1.lock_owner() == c1.name
    assert img2.read(0, 3 * 4096) == \
        b"A" * 4096 + b"B" * 4096 + b"C" * 4096
    img1.close()
    img2.close()


def test_dead_holder_lock_broken(cluster):
    """A crashed holder's lock is broken after the handoff times out;
    the new holder takes over (blocklist-lite)."""
    c1, c2 = cluster.client(), cluster.client()
    c1.create_pool("rbd", size=2, pg_num=1)
    from ceph_tpu_torch.services.rbd import RBD
    img1 = RBD(c1).create("rbd", "img", 4 << 20)
    img1.write(0, b"x" * 512)
    assert img1.lock_owner() == c1.name
    # crash: the holder vanishes without releasing (no close())
    c1.close()
    img2 = RBD(c2).open("rbd", "img")
    img2._ensure_lock(timeout=1.0)
    img2._end_op()
    assert img2.lock_owner() == c2.name
    img2.write(512, b"y" * 512)
    assert img2.read(0, 1024) == b"x" * 512 + b"y" * 512
    img2.close()


def test_journal_replay_completes_crashed_write(cluster):
    """Journaling: a write journaled but never applied (crash between
    journal append and data write) is REPLAYED when the next client
    acquires the lock — the Journal.h replay-on-open contract."""
    from ceph_tpu_torch.msg.wire import pack_value
    from ceph_tpu_torch.services.rbd import FEATURE_JOURNALING, RBD
    c1, c2 = cluster.client(), cluster.client()
    c1.create_pool("rbd", size=2, pg_num=1)
    img1 = RBD(c1).create("rbd", "img", 4 << 20,
                          features=FEATURE_JOURNALING)
    img1.write(0, b"base" * 1024)
    # simulate the crash window: append a journal event WITHOUT
    # applying it, then kill the client (lock left held)
    img1._ensure_lock()
    seq = img1._journal_append({"op": "write", "off": 8192,
                                "data": b"Z" * 4096})
    c1.close()
    # the next opener breaks the dead lock and replays the journal
    img2 = RBD(c2).open("rbd", "img")
    img2._ensure_lock(timeout=1.0)
    img2._end_op()
    assert img2.read(8192, 4096) == b"Z" * 4096, \
        "journaled write was not replayed"
    # the journal is trimmed up to the replayed event
    committed, pending = img2._journal_entries()
    assert committed >= seq and pending == []
    img2.close()


def test_journal_trims_after_normal_writes(cluster):
    from ceph_tpu_torch.services.rbd import FEATURE_JOURNALING, RBD
    c = cluster.client()
    c.create_pool("rbd", size=2, pg_num=1)
    img = RBD(c).create("rbd", "img", 4 << 20,
                        features=FEATURE_JOURNALING)
    for i in range(5):
        img.write(i * 4096, bytes([i]) * 4096)
    committed, pending = img._journal_entries()
    assert pending == [], "journal entries leaked past commit"
    assert committed == 5
    assert img.read(3 * 4096, 4096) == b"\x03" * 4096
    img.close()


def test_mirror_replay_to_peer_image(cluster):
    """Journal-based mirroring (rbd_mirror role): events are retained
    for the registered peer, a replayer pass applies them to the peer
    image byte-exactly, and consumed events are trimmed."""
    from ceph_tpu_torch.services.rbd import (FEATURE_JOURNALING, RBD,
                                       mirror_replay)
    c = cluster.client()
    c.create_pool("rbd", size=2, pg_num=2)
    c.create_pool("rbd-peer", size=2, pg_num=2)
    src = RBD(c).create("rbd", "img", 8 << 20,
                        features=FEATURE_JOURNALING)
    src.mirror_register("siteB")
    dst = RBD(c).create("rbd-peer", "img", 8 << 20)
    src.write(0, b"first" * 1000)
    src.write(1 << 20, b"second" * 1000)
    # events retained for the peer even though locally committed
    _c, pending_all = src._journal_entries()
    try:
        omap = c.omap_get("rbd", "rbd_journal.img")
    except Exception:
        omap = {}
    assert sum(1 for k in omap if k.startswith("e")) == 2, \
        "journal trimmed before the mirror peer consumed it"
    n = mirror_replay(src, dst, "siteB")
    assert n == 2
    assert dst.read(0, 5000) == src.read(0, 5000)
    assert dst.read(1 << 20, 6000) == src.read(1 << 20, 6000)
    # consumed + trimmed
    omap = c.omap_get("rbd", "rbd_journal.img")
    assert not [k for k in omap if k.startswith("e")]
    # incremental: only NEW events replay next pass
    src.write(2 << 20, b"third")
    assert mirror_replay(src, dst, "siteB") == 1
    assert dst.read(2 << 20, 5) == b"third"
    src.close()
    dst.close()

# -- the cases of tests/test_rbd_objectmap.py ---------------------------------
OM_RNG = np.random.default_rng(17)
MiB = 1024 * 1024
FEATS = FEATURE_OBJECT_MAP | FEATURE_FAST_DIFF


@pytest.fixture
def img_cluster():
    c = MiniCluster(n_osds=4, cfg=make_cfg()).start()
    client = c.client()
    client.create_pool("rbd", size=2, pg_num=4)
    rbd = RBD(client)
    img = rbd.create("rbd", "om0", 8 * MiB, object_size=MiB,
                     features=FEATS)
    yield c, client, rbd, img
    img.close()
    c.stop()


def test_map_tracks_writes_and_serves_hole_reads(img_cluster):
    c, client, rbd, img = img_cluster
    data = OM_RNG.integers(0, 256, 2 * MiB, dtype=np.uint8).tobytes()
    img.write(3 * MiB, data)                  # objects 3 and 4
    m = img._om()
    assert m[3] == OM_EXISTS and m[4] == OM_EXISTS
    assert m[0] == OM_NONEXISTENT and m[7] == OM_NONEXISTENT
    # hole read is served from the map (zeros) and the written range
    # is byte-exact through the skip logic
    assert img.read(0, MiB) == b"\0" * MiB
    assert img.read(3 * MiB, 2 * MiB) == data
    # a write beats the map back to EXISTS after snapshots clean it
    assert img.read(2 * MiB, 3 * MiB) == b"\0" * MiB + data[:2 * MiB]


def test_snapshot_demotes_to_clean_and_fast_diff(img_cluster):
    c, client, rbd, img = img_cluster
    img.write(0, b"a" * MiB)
    img.write(5 * MiB, b"b" * MiB)
    img.snap_create("s1")
    m = img._om()
    assert m[0] == OM_EXISTS_CLEAN and m[5] == OM_EXISTS_CLEAN
    # nothing written since s1: empty fast diff
    assert img.fast_diff("s1") == []
    img.write(5 * MiB, b"c" * MiB)            # dirty one object
    img.write(7 * MiB, b"d" * 1024)           # and create another
    diff = img.fast_diff("s1")
    assert sorted(d["objno"] for d in diff) == [5, 7]
    assert all(d["exists"] for d in diff)
    # full-history diff = every existing object
    assert sorted(d["objno"] for d in img.fast_diff()) == [0, 5, 7]


def test_fast_diff_composes_across_snapshots(img_cluster):
    c, client, rbd, img = img_cluster
    img.write(0, b"x" * MiB)
    img.snap_create("s1")
    img.write(1 * MiB, b"y" * MiB)            # between s1 and s2
    img.snap_create("s2")
    img.write(2 * MiB, b"z" * MiB)            # after s2
    # since s1: both the s1->s2 write and the post-s2 write
    assert sorted(d["objno"] for d in img.fast_diff("s1")) == [1, 2]
    # since s2: only the head-dirty object
    assert sorted(d["objno"] for d in img.fast_diff("s2")) == [2]


def test_rebuild_object_map(img_cluster):
    c, client, rbd, img = img_cluster
    img.write(2 * MiB, b"e" * MiB)
    # wipe the map object: open-time load must rebuild from reality
    client.remove("rbd", "rbd_object_map.om0")
    img2 = rbd.open("rbd", "om0")
    n = img2.rebuild_object_map()
    assert n == 8
    m = img2._om()
    assert m[2] == OM_EXISTS
    assert m[0] == OM_NONEXISTENT
    assert img2.read(2 * MiB, MiB) == b"e" * MiB
    img2.close()


def test_fast_diff_requires_features(img_cluster):
    c, client, rbd, img = img_cluster
    plain = rbd.create("rbd", "nofeat", 2 * MiB, object_size=MiB)
    with pytest.raises(RbdError):
        plain.fast_diff()
    plain.close()


# ---------------------------------------- the port against the JAX package
def _snap(mod, rng):
    return mod.SnapRecord(int(rng.integers(1, 1 << 40)),
                          "".join(rng.choice(list("abc-_.09"), 6)),
                          int(rng.integers(0, 1 << 50)),
                          sorted(rng.choice(1 << 20, 3,
                                            replace=False).tolist()))


def _header(mod, seed):
    """A seeded ImageHeader (with snapshots) of package ``mod``."""
    rng = np.random.default_rng(seed)
    snaps = [_snap(mod, rng) for _ in range(int(rng.integers(0, 4)))]
    return mod.ImageHeader(int(rng.integers(0, 1 << 50)),
                           1 << int(rng.integers(12, 26)),
                           1 << int(rng.integers(12, 20)),
                           int(rng.integers(1, 8)),
                           snap_seq=int(rng.integers(0, 1 << 30)),
                           snaps=snaps, features=int(rng.integers(0, 8)))


def _plain(h) -> dict:
    d = dict(vars(h))
    if "snaps" in d:
        d["snaps"] = [vars(s) for s in d["snaps"]]
    return d


@pytest.mark.parametrize("seed", range(6))
def test_image_structs_equal_both_ways(seed):
    """The same seeded header and snapshot record encode to the same
    bytes in both packages, and each decodes the other's."""
    ref_h, port_h = _header(ref_rbd, seed), _header(port_rbd, seed)
    raw = ref_h.encode_bytes()
    assert port_h.encode_bytes() == raw
    assert _plain(port_rbd.ImageHeader.decode_bytes(raw)) == _plain(ref_h)
    assert _plain(ref_rbd.ImageHeader.decode_bytes(
        port_h.encode_bytes())) == _plain(port_h)
    for ref_s, port_s in zip(ref_h.snaps, port_h.snaps):
        raw = ref_s.encode_bytes()
        assert port_s.encode_bytes() == raw
        assert vars(port_rbd.SnapRecord.decode_bytes(raw)) == vars(ref_s)
        assert vars(ref_rbd.SnapRecord.decode_bytes(raw)) == vars(port_s)


#: the image of the carried-state cases: 1 MiB objects, the object map,
#: fast-diff and the journal
IMAGE = dict(size=6 << 20, object_size=1 << 20)


def _image_session(mod, client) -> dict:
    """Create, a write spanning objects, a snapshot, a resize, a write
    past the old end, a rollback to the snapshot; returns what the
    image reads and reports."""
    rng = np.random.default_rng(5)
    feats = (mod.FEATURE_OBJECT_MAP | mod.FEATURE_FAST_DIFF
             | mod.FEATURE_JOURNALING)
    img = mod.RBD(client).create("rbd", "vm", IMAGE["size"],
                                 object_size=IMAGE["object_size"],
                                 features=feats)
    img.write(700_000, rng.bytes(1_500_000))
    img.snap_create("s1")
    img.resize(9 << 20)
    img.write(7 << 20, rng.bytes(300_000))
    img.snap_rollback("s1")
    img.write(3 << 20, rng.bytes(5000))
    out = _image_view(img)
    img.close()
    return out


def _image_view(img) -> dict:
    return {"size": img.size(), "head": img.read(0, img.size()),
            "snap": img.read(0, img.size(), snap="s1"),
            "snaps": img.snap_list(), "diff": img.fast_diff(),
            "diff_s1": img.fast_diff("s1")}


def _rados_state(client, pool: str) -> dict:
    return {oid: (client.read(pool, oid), client.getxattrs(pool, oid),
                  client.omap_get(pool, oid))
            for oid in sorted(client.list_objects(pool))}


def _cluster(pkg: str):
    if pkg == "ref":
        return ref_vstart.MiniCluster(n_osds=4, cfg=ref_make_cfg()).start()
    return MiniCluster(n_osds=4, cfg=make_cfg()).start()


def test_image_ops_leave_the_references_rados_state():
    """The same image operations on a reference cluster and on a port
    cluster: equal reads and reports, and the same RADOS object names,
    bytes, xattrs and omap in the image's pool."""
    out = {}
    for pkg, mod in (("port", port_rbd), ("ref", ref_rbd)):
        c = _cluster(pkg)
        try:
            client = c.client()
            client.create_pool("rbd", size=2, pg_num=4)
            out[pkg] = (_image_session(mod, client),
                        _rados_state(client, "rbd"))
        finally:
            c.stop()
    (port_view, port_state), (ref_view, ref_state) = out["port"], out["ref"]
    assert port_view == ref_view
    assert list(port_state) == list(ref_state)
    assert any("@" in oid for oid in ref_state)      # a COW copy
    assert "rbd_object_map.vm" in ref_state
    for oid in ref_state:
        assert port_state[oid] == ref_state[oid], oid


@pytest.mark.parametrize("src,dst", [("ref", "port"), ("port", "ref")])
def test_image_objects_open_in_the_other_package(src, dst):
    """An image written by one package, its objects copied object by
    object (bytes, xattrs, omap) into the other package's cluster, opens
    there and reads back equal: head, snapshot, sizes and diffs."""
    mods = {"ref": ref_rbd, "port": port_rbd}
    c = _cluster(src)
    try:
        client = c.client()
        client.create_pool("rbd", size=2, pg_num=4)
        view = _image_session(mods[src], client)
        state = _rados_state(client, "rbd")
    finally:
        c.stop()
    c = _cluster(dst)
    try:
        client = c.client()
        client.create_pool("rbd", size=2, pg_num=4)
        for oid, (data, xattrs, omap) in state.items():
            client.write_full("rbd", oid, data)
            for name, value in xattrs.items():
                client.setxattr("rbd", oid, name, value)
            if omap:
                client.omap_set("rbd", oid, omap)
        rbd = mods[dst].RBD(client)
        assert rbd.list("rbd") == ["vm"]
        img = rbd.open("rbd", "vm")
        try:
            assert _image_view(img) == view
        finally:
            img.close()
    finally:
        c.stop()

def test_image_recovery_fetches_each_lost_shard_a_few_times(monkeypatch):
    """An image's objects all place in one PG (the placement hashes a
    name's first 8 bytes and its length, in both packages), so the loss
    of that PG's primary leaves every object of the image to rebuild in
    one PG under a new primary.  Each round of inventories it collects
    schedules every shard still missing; the port claims a rebuild
    while its fetch is out (osd/daemon.py _claim_rebuild), so each lost
    shard is fetched a few times, not once a round (without the claim,
    10-23 times here and about 60 at 32 objects of 4 MiB).  The image
    reads back exact."""
    from ceph_tpu_torch.osd import daemon

    fans: dict = {}
    real = daemon.OSDDaemon._fan_shard_reads

    def counted(self, tid, pgid, oid, up, extents=None, trace=None,
                klass="client"):
        if klass == "recovery":
            fans[oid] = fans.get(oid, 0) + 1
        return real(self, tid, pgid, oid, up, extents=extents, trace=trace,
                    klass=klass)

    monkeypatch.setattr(daemon.OSDDaemon, "_fan_shard_reads", counted)
    c = MiniCluster(n_osds=8, cfg=make_cfg(ec_backend="native")).start()
    try:
        client = c.client()
        client.create_pool("rbd", kind="ec", pg_num=4, ec_profile={
            "plugin": "jerasure", "k": "4", "m": "2"})
        n, size = 24, 256 << 10
        data = RNG.integers(0, 256, n * size, dtype=np.uint8).tobytes()
        img = RBD(client).create("rbd", "vm", n * size, object_size=size)
        img.write(0, data)
        pool_id = client._pool_id("rbd")
        omap = c.mon.osdmap
        seed = omap.object_to_pg(pool_id, "rbd_data.vm.0000000000000000")
        assert {omap.object_to_pg(pool_id, f"rbd_data.vm.{i:016x}")
                for i in range(n)} == {seed}
        victim = omap.pg_to_up_osds(pool_id, seed)[0]  # the primary
        epoch = omap.epoch
        c.kill_osd(victim)
        c.wait_for_epoch(epoch + 1)
        cid = CollectionId(pool_id, seed)

        def rebuilt():
            up = c.mon.osdmap.pg_to_up_osds(pool_id, seed)
            return all(c.osds[up[0]].store.exists(
                cid, ObjectId(f"rbd_data.vm.{i:016x}", shard=0))
                for i in range(n))

        wait_until("the lost shards rebuilt", rebuilt)
        assert img.read(0, n * size) == data
        img.close()
    finally:
        c.stop()
    data_fans = [v for k, v in fans.items() if k.startswith("rbd_data")]
    assert len(data_fans) == n
    assert max(data_fans) <= 4, sorted(fans.items())


def test_image_on_clay_pool_rebuilds_by_subchunks_and_gives_claims_back():
    """An image on a CLAY pool at the MSR point (k=2, m=2, d=3) loses a
    non-primary OSD of its one PG, and the map puts a spare in its
    place: the primary rebuilds each lost shard there from the sub-chunk
    repair planes of the other three (osd/daemon.py
    _rebuild_shard_subchunk), every rebuild's claim is given back when
    its fetch returns (no OSD holds one once the shards are back, on the
    same map), and the image reads back exact."""
    c = MiniCluster(n_osds=5, cfg=make_cfg(ec_backend="native")).start()
    try:
        client = c.client()
        client.create_pool("rbd", kind="ec", pg_num=2, ec_profile={
            "plugin": "clay", "k": "2", "m": "2", "d": "3"})
        n, size = 8, 64 << 10
        data = RNG.integers(0, 256, n * size, dtype=np.uint8).tobytes()
        img = RBD(client).create("rbd", "vm", n * size, object_size=size)
        img.write(0, data)
        pool_id = client._pool_id("rbd")
        omap = c.mon.osdmap
        seed = omap.object_to_pg(pool_id, "rbd_data.vm.0000000000000000")
        victim = omap.pg_to_up_osds(pool_id, seed)[1]
        epoch = omap.epoch
        c.kill_osd(victim)
        c.wait_for_epoch(epoch + 1)
        cid = CollectionId(pool_id, seed)

        def rebuilt():
            spare = c.osds.get(c.mon.osdmap.pg_to_up_osds(pool_id, seed)[1])
            return spare is not None and all(spare.store.exists(
                cid, ObjectId(f"rbd_data.vm.{i:016x}", shard=1))
                for i in range(n))

        wait_until("the lost shards rebuilt", rebuilt)
        rebuilt_on = c.mon.osdmap.epoch
        assert sum(o.perf.get("recovery_subchunk_rebuilds")
                   for o in c.osds.values()) >= n
        wait_until("every rebuild's claim given back", lambda: not any(
            o._rebuilds_out for o in c.osds.values()), timeout=10)
        # the same map: no map change dropped the claims
        assert c.mon.osdmap.epoch == rebuilt_on
        assert img.read(0, n * size) == data
        img.close()
    finally:
        c.stop()


@pytest.mark.parametrize("code", [-5, -11, -110])
def test_image_read_that_fails_raises_and_only_a_hole_reads_zeros(
        monkeypatch, code):
    """A read of an image object that exists but fails (EIO; EAGAIN once
    the client's retries run out, as while a PG's new primary recovers
    it; a timeout) raises RbdError in the port (services/rbd.py
    Image._read_piece: only ENOENT is a hole), where the JAX package
    turns every RADOS error into zeros, a silent wrong read.  An object
    never written reads as zeros in both."""
    n, size = 2, 64 << 10
    data = RNG.integers(0, 256, size, dtype=np.uint8).tobytes()
    got = {}
    for pkg, mod, cluster, cfg in (
            ("port", port_rbd, MiniCluster, make_cfg),
            ("ref", ref_rbd, ref_vstart.MiniCluster, ref_make_cfg)):
        c = cluster(n_osds=4, cfg=cfg()).start()
        try:
            client = c.client()
            client.create_pool("rbd", size=3, pg_num=2)
            img = mod.RBD(client).create("rbd", "vm", n * size,
                                         object_size=size)
            img.write(0, data)  # object 1 is never written
            real = client.read
            error = type(client).read.__globals__["RadosError"]

            def failing(pool, oid, *args, **kw):
                if oid == "rbd_data.vm.0000000000000000":
                    raise error(code, f"read {pool}/{oid}")
                return real(pool, oid, *args, **kw)

            monkeypatch.setattr(client, "read", failing)
            hole = img.read(size, size)
            try:
                got[pkg] = (hole, img.read(0, size))
            except mod.RbdError:
                got[pkg] = (hole, None)
            monkeypatch.setattr(client, "read", real)
            assert img.read(0, size) == data
        finally:
            c.stop()
    assert got["port"] == (bytes(size), None)
    assert got["ref"] == (bytes(size), bytes(size))
