"""The port's deployment tool (ceph_tpu_torch.tools.cephadm) held against
the JAX package's (ceph_tpu.tools.cephadm) on the CPU.

One spec is deployed with each package: 4 OSDs on filestore, each a
child process of its package's ``tools.osd_main``, a replicated pool of
size 2 and an EC pool of k=2 m=1 with chip_smoke.py phase 21's profile
(``plugin tpu``, ``reed_sol_van``; the port's adds ``device=cpu`` and
its children start with ``device="cpu"``, the reference's resolves its
backend as on any CPU host).  The same seeded objects are written
through each package's client, then each package runs its rolling
restart.  Compared, as only what does not depend on the children's
clocks: the inventory less pids and store paths, the restart order,
each object's PG and up set, each pool's object names and the bytes
each package's client reads back, and, for the EC pool, each shard's
bytes as the member's filestore holds them after the teardown (neither
client exposes a shard read).  Both packages' deep scrubs must come back
clean.  Every wait has a deadline; the case builds its ``CephAdm`` first
and deploys inside the ``try`` whose ``finally`` tears it down, so a
deploy that fails leaves no child running."""

import os
import time

import numpy as np

from ceph_tpu.osd import objectstore as ref_objectstore
from ceph_tpu.tools.cephadm import CephAdm as RefCephAdm
from ceph_tpu_torch.osd import objectstore
from ceph_tpu_torch.tools.cephadm import CephAdm

SEED = 41
#: chip_smoke.py phase 21's profile at k=2 m=1
PROFILE = {"plugin": "tpu", "technique": "reed_sol_van", "k": "2",
           "m": "1"}
POOLS = ("rep", "ec")
OBJECTS = 6
#: the port's tests/test_torch_cephadm.py grace: a loaded box can stall
#: a child interpreter past CephAdm's 2 s
CFG = {"osd_heartbeat_grace": 5.0}
#: seconds to wait for an object to read back after the staircase
READ_WAIT_S = 30.0


def spec(port: bool) -> dict:
    profile = dict(PROFILE, device="cpu") if port else dict(PROFILE)
    return {"osds": [{"id": i, "store": "filestore"} for i in range(4)],
            "pools": [{"name": "rep", "size": 2, "pg_num": 8},
                      {"name": "ec", "kind": "ec", "pg_num": 8,
                       "ec_profile": profile}]}


def seeded_objects() -> dict[str, dict[str, bytes]]:
    """pool -> name -> bytes, the same for both packages; lengths that
    are not whole stripes."""
    rng = np.random.default_rng(SEED)
    return {pool: {f"{pool}{i}": rng.integers(
        0, 256, 5000 + 997 * i, dtype=np.uint8).tobytes()
        for i in range(OBJECTS)} for pool in POOLS}


def read_back(client, pool: str, names) -> dict[str, bytes]:
    """Each object's bytes; an object still recovering after the
    staircase is read again until READ_WAIT_S has passed."""
    out: dict[str, bytes] = {}
    deadline = time.monotonic() + READ_WAIT_S
    for name in names:
        while True:
            try:
                out[name] = client.read(pool, name)
                break
            except Exception:  # noqa: BLE001 - recovering; deadline below
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
    return out


def store_shards(base: str, store_mod, placement: dict,
                 pool_id: int) -> dict:
    """(name, shard) -> the shard's bytes in the filestore of the OSD
    the placement puts it on, each store mounted once after the
    teardown."""
    by_osd: dict[int, list] = {}
    for name, (seed, up) in placement.items():
        for shard, osd in enumerate(up):
            by_osd.setdefault(osd, []).append((name, seed, shard))
    out = {}
    for osd, wanted in sorted(by_osd.items()):
        store = store_mod.ObjectStore.create(
            "filestore", path=os.path.join(base, f"osd.{osd}"))
        store.mount()
        try:
            for name, seed, shard in wanted:
                out[(name, shard)] = store.read(
                    store_mod.CollectionId(pool_id, seed),
                    store_mod.ObjectId(name, shard=shard)).to_bytes()
        finally:
            store.umount()
    return out


def deploy_write_restart(adm, base: str, store_mod) -> dict:
    """Deploy, write the seeded objects, run the rolling restart, and
    gather what the comparison reads; tears the cluster down whatever
    happens."""
    objs = seeded_objects()
    out: dict = {}
    try:
        adm.deploy()
        client = adm.cluster.client()
        for pool in POOLS:
            for name, data in objs[pool].items():
                client.write_full(pool, name, data)
        out["order"] = adm.rolling_restart()
        out["ls"] = [{k: v for k, v in d.items() if k not in ("pid",
                                                               "store")}
                     for d in adm.ls()]
        out["placement"], out["names"], out["bytes"] = {}, {}, {}
        for pool in POOLS:
            pid = client._pool_id(pool)
            omap = client.osdmap
            out["placement"][pool] = {
                name: (omap.object_to_pg(pid, name),
                       list(omap.pg_to_up_osds(
                           pid, omap.object_to_pg(pid, name))))
                for name in objs[pool]}
            out["names"][pool] = sorted(client.list_objects(pool))
            out["bytes"][pool] = read_back(client, pool, sorted(objs[pool]))
        out["scrub"] = {pool: client.scrub_pool(pool, deep=True)
                        for pool in POOLS}
        out["ec_pool_id"] = client._pool_id("ec")
    finally:
        adm.teardown()
    out["shards"] = store_shards(base, store_mod, out["placement"]["ec"],
                                 out["ec_pool_id"])
    out["objs"] = objs
    return out


def test_port_deploys_and_restarts_as_the_reference(tmp_path):
    """The same spec and seeded writes through each package's CephAdm
    and rolling restart: equal inventories, restart orders, placements,
    object names and bytes, and EC shard bytes; clean deep scrubs."""
    runs = {}
    for pkg, make, store_mod in (
            ("ref", lambda base: RefCephAdm(spec(False), base,
                                            cfg_overrides=CFG),
             ref_objectstore),
            ("port", lambda base: CephAdm(spec(True), base,
                                          cfg_overrides=CFG, device="cpu"),
             objectstore)):
        base = str(tmp_path / pkg)
        adm = make(base)
        runs[pkg] = deploy_write_restart(adm, base, store_mod)
    ref, port = runs["ref"], runs["port"]
    assert ref["scrub"] == {"rep": [], "ec": []}
    assert port["scrub"] == {"rep": [], "ec": []}
    assert port["ls"] == ref["ls"]
    assert [d["daemon"] for d in ref["ls"]] == \
        ["mon.0", "osd.0", "osd.1", "osd.2", "osd.3"]
    assert all(d["state"] == "running" for d in ref["ls"])
    assert port["order"] == ref["order"] == [0, 1, 2, 3]
    assert port["placement"] == ref["placement"]
    assert port["names"] == ref["names"]
    for pool in POOLS:
        assert ref["names"][pool] == sorted(ref["objs"][pool])
        assert ref["bytes"][pool] == ref["objs"][pool]
        assert port["bytes"][pool] == ref["bytes"][pool], pool
    assert len(ref["shards"]) == 3 * OBJECTS
    assert port["shards"].keys() == ref["shards"].keys()
    for key, data in ref["shards"].items():
        assert port["shards"][key] == data, key
