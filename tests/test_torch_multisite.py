"""The port's multisite sync (ceph_tpu_torch.services.multisite) over its
S3 gateway, held against the JAX package on the CPU.

- The cases of the JAX package's tests/test_multisite.py, and its
  tests/test_rgw.py::test_versioning_multisite_sync, on the port.
- Across packages: a zone of one package syncs from a zone of the other
  (the agent of the receiving zone's package tails the source's bucket
  index log over HTTP); puts, an overwrite, a delete and a multipart
  object arrive equal.
"""

import time

import numpy as np
import pytest

import ceph_tpu.services.multisite as ref_multisite
import ceph_tpu.services.rgw as ref_rgw
import ceph_tpu.tools.vstart as ref_vstart
import ceph_tpu_torch.services.multisite as port_multisite
import ceph_tpu_torch.services.rgw as port_rgw
from ceph_tpu_torch.services.multisite import ZoneSyncAgent
from ceph_tpu_torch.services.rgw import RgwGateway
from ceph_tpu_torch.tools.vstart import MiniCluster
from tests.test_cluster import make_cfg as ref_make_cfg
from tests.test_torch_cluster import make_cfg
from tests.test_torch_rgw import _req, gateway  # noqa: F401 - a fixture

# -- the cases of tests/test_multisite.py -------------------------------------
@pytest.fixture
def zones():
    """Two independent clusters, each with a gateway, cross-syncing."""
    ca = MiniCluster(n_osds=4, cfg=make_cfg()).start()
    cb = MiniCluster(n_osds=4, cfg=make_cfg()).start()
    ca.client().create_pool("rgw", size=3, pg_num=2)
    cb.client().create_pool("rgw", size=3, pg_num=2)
    gwa = RgwGateway(ca.clients[0], "rgw", zone="zone-a")
    gwb = RgwGateway(cb.clients[0], "rgw", zone="zone-b")
    a2b = ZoneSyncAgent("127.0.0.1", gwa.port, gwb, "zone-a",
                        interval=0.05).start()
    b2a = ZoneSyncAgent("127.0.0.1", gwb.port, gwa, "zone-b",
                        interval=0.05).start()
    yield gwa, gwb, a2b, b2a
    a2b.stop(); b2a.stop()
    gwa.stop(); gwb.stop()
    ca.stop(); cb.stop()


def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def test_put_delete_replicate_across_zones(zones):
    gwa, gwb, _a2b, _b2a = zones
    assert _req(gwa, "PUT", "/shared")[0] == 200
    _req(gwa, "PUT", "/shared/doc.txt", body=b"from zone a")
    # bucket + object appear in zone b
    assert _wait(lambda: _req(gwb, "GET", "/shared/doc.txt")[0] == 200)
    assert _req(gwb, "GET", "/shared/doc.txt")[1] == b"from zone a"
    # delete replicates too
    _req(gwa, "DELETE", "/shared/doc.txt")
    assert _wait(lambda: _req(gwb, "GET", "/shared/doc.txt")[0] == 404)


def test_active_active_no_ping_pong(zones):
    gwa, gwb, a2b, b2a = zones
    _req(gwa, "PUT", "/aa")
    assert _wait(lambda: _req(gwb, "HEAD", "/aa")[0] == 200)
    # writes originate on BOTH sides
    _req(gwa, "PUT", "/aa/from-a", body=b"A")
    _req(gwb, "PUT", "/aa/from-b", body=b"B")
    assert _wait(lambda: _req(gwb, "GET", "/aa/from-a")[0] == 200)
    assert _wait(lambda: _req(gwa, "GET", "/aa/from-b")[0] == 200)
    assert _req(gwb, "GET", "/aa/from-a")[1] == b"A"
    assert _req(gwa, "GET", "/aa/from-b")[1] == b"B"
    # convergence is quiescent: applied counts stop growing (no loop)
    time.sleep(0.4)
    base = (a2b.applied, b2a.applied)
    time.sleep(0.6)
    assert (a2b.applied, b2a.applied) == base, "replication ping-pong"


def test_lww_conflict_resolution(zones):
    gwa, gwb, _a2b, _b2a = zones
    _req(gwa, "PUT", "/cf")
    assert _wait(lambda: _req(gwb, "HEAD", "/cf")[0] == 200)
    _req(gwa, "PUT", "/cf/k", body=b"older")
    time.sleep(0.3)  # ensure the b write is strictly newer
    _req(gwb, "PUT", "/cf/k", body=b"newer-wins")
    # both zones converge on the newer write
    assert _wait(lambda: _req(gwa, "GET", "/cf/k")[1] == b"newer-wins")
    assert _wait(lambda: _req(gwb, "GET", "/cf/k")[1] == b"newer-wins")


def test_marker_resume_after_agent_restart(zones):
    gwa, gwb, a2b, _b2a = zones
    _req(gwa, "PUT", "/mk")
    _req(gwa, "PUT", "/mk/one", body=b"1")
    assert _wait(lambda: _req(gwb, "GET", "/mk/one")[0] == 200)
    a2b.stop()
    applied_before = a2b.applied
    # changes while the agent is down
    _req(gwa, "PUT", "/mk/two", body=b"2")
    # a FRESH agent resumes from the durable marker: only the new entry
    fresh = ZoneSyncAgent("127.0.0.1", gwa.port, gwb, "zone-a",
                          interval=0.05).start()
    try:
        assert _wait(lambda: _req(gwb, "GET", "/mk/two")[0] == 200)
        assert fresh.applied <= 2, \
            f"re-applied old entries: {fresh.applied}"
        assert applied_before >= 1
    finally:
        fresh.stop()


def test_multipart_object_replicates(zones):
    gwa, gwb, _a2b, _b2a = zones
    _req(gwa, "PUT", "/mp")
    st, body, _ = _req(gwa, "POST", "/mp/big?uploads")
    upload_id = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0] \
        .decode()
    p1, p2 = b"x" * 100_000, b"y" * 50_000
    etags = {}
    for n, p in ((1, p1), (2, p2)):
        _st, _b, hdrs = _req(
            gwa, "PUT", f"/mp/big?partNumber={n}&uploadId={upload_id}",
            body=p)
        etags[n] = hdrs["ETag"].strip('"')
    xml = "<CompleteMultipartUpload>" + "".join(
        f'<Part><PartNumber>{n}</PartNumber><ETag>"{etags[n]}"</ETag>'
        f"</Part>" for n in (1, 2)) + "</CompleteMultipartUpload>"
    assert _req(gwa, "POST", f"/mp/big?uploadId={upload_id}",
                body=xml.encode())[0] == 200
    # the completed manifest object lands in zone b byte-exact
    assert _wait(lambda: _req(gwb, "GET", "/mp/big")[0] == 200)
    assert _req(gwb, "GET", "/mp/big")[1] == p1 + p2

# -- tests/test_rgw.py::test_versioning_multisite_sync ------------------------
def test_versioning_multisite_sync(gateway):
    """Versioned generations and delete markers replicate exactly
    (the bilog carries version ids; data-sync fetches by versionId)."""
    import time as _time
    c, gw = gateway
    from ceph_tpu_torch.services.multisite import ZoneSyncAgent
    client2 = c.client()
    client2.create_pool("rgw2", size=3, pg_num=2)
    gw2 = RgwGateway(client2, "rgw2", zone="zone-b")
    try:
        for g in (gw, gw2):
            g.create_bucket("vb")
            g.set_versioning("vb", True)
        agent = ZoneSyncAgent("127.0.0.1", gw.port, gw2, "zone-a",
                              interval=0.05)
        agent.start()
        try:
            gw.put_object("vb", "doc", b"v-one")
            gw.put_object("vb", "doc", b"v-two")
            deadline = _time.time() + 10
            while _time.time() < deadline:
                if len(gw2.versions_of("vb", "doc")) == 2:
                    break
                _time.sleep(0.1)
            vs2 = gw2.versions_of("vb", "doc")
            assert len(vs2) == 2, vs2
            assert {m["version_id"] for m in vs2} == \
                {m["version_id"] for m in gw.versions_of("vb", "doc")}
            data, meta, _ = gw2.get_object("vb", "doc")
            assert data == b"v-two"
            # marker replicates
            gw.delete_object("vb", "doc")
            deadline = _time.time() + 10
            while _time.time() < deadline:
                try:
                    gw2.head_object("vb", "doc")
                except KeyError:
                    break
                _time.sleep(0.1)
            with pytest.raises(KeyError):
                gw2.head_object("vb", "doc")
        finally:
            agent.stop()
    finally:
        gw2.stop()


# -- the port against the JAX package -----------------------------------------
PKGS = {"ref": (ref_vstart.MiniCluster, ref_make_cfg, ref_rgw,
                ref_multisite),
        "port": (MiniCluster, make_cfg, port_rgw, port_multisite)}


@pytest.mark.parametrize("src,dst", [("ref", "port"), ("port", "ref")])
def test_zone_syncs_from_the_other_package(src, dst):
    """A zone of ``dst``'s package, with its package's agent, syncs from
    a zone of ``src``'s: puts, an overwrite, a delete and a multipart
    object arrive equal, and nothing flows back."""
    rng = np.random.default_rng(95)
    big = rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    zones, gws = [], []
    agent = None
    try:
        for pkg, zone in ((src, "zone-a"), (dst, "zone-b")):
            mc, cfg, rgw_mod, _ms = PKGS[pkg]
            c = mc(n_osds=4, cfg=cfg()).start()
            zones.append(c)
            c.client().create_pool("rgw", size=2, pg_num=2)
            gws.append(rgw_mod.RgwGateway(c.clients[0], "rgw", zone=zone))
        gwa, gwb = gws
        for g in gws:
            g.create_bucket("b")
        agent = PKGS[dst][3].ZoneSyncAgent("127.0.0.1", gwa.port, gwb,
                                           "zone-a", interval=0.05).start()
        gwa.put_object("b", "k1", b"one")
        gwa.put_object("b", "k2", b"two")
        gwa.put_object("b", "k1", b"one again")
        gwa.delete_object("b", "k2")
        upload = gwa.initiate_multipart("b", "mp")
        etags = [gwa.put_part("b", "mp", upload, i + 1, part)
                 for i, part in enumerate((big[:60_000], big[60_000:]))]
        gwa.complete_multipart("b", "mp", upload,
                               [(i + 1, e) for i, e in enumerate(etags)])

        def synced():
            try:
                return (gwb.get_object("b", "k1")[0] == b"one again"
                        and gwb.get_object("b", "mp")[0] == big)
            except KeyError:
                return False

        deadline = time.time() + 15
        while not synced() and time.time() < deadline:
            time.sleep(0.05)
        assert synced()
        with pytest.raises(KeyError):
            gwb.get_object("b", "k2")
        assert gwb.list_objects_xml("b").count(b"<Key>") == 2
    finally:
        if agent is not None:
            agent.stop()
        for g in gws:
            g.stop()
        for c in zones:
            c.stop()
