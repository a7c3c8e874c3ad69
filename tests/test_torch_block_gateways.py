"""The port's block gateways (ceph_tpu_torch.services.nbd and .nvmeof),
held against the JAX package on the CPU.

- The cases of the JAX package's tests/test_nbd.py and
  tests/test_nvmeof.py on the port.
- Across packages: each package's NbdClient against each package's
  NbdServer, and each NvmeInitiator against each NvmeofTarget, run the
  same session; the four pairs give the same replies and bytes, and
  leave the same bytes in the exported image.
"""

import numpy as np
import pytest

import ceph_tpu.services.nbd as ref_nbd
import ceph_tpu.services.nvmeof as ref_nvmeof
import ceph_tpu.services.rbd as ref_rbd
import ceph_tpu.tools.vstart as ref_vstart
import ceph_tpu_torch.services.nbd as port_nbd
import ceph_tpu_torch.services.nvmeof as port_nvmeof
import ceph_tpu_torch.services.rbd as port_rbd
from ceph_tpu_torch.services.nbd import NbdClient, NbdServer
from ceph_tpu_torch.services.nvmeof import (LBA_SIZE, NvmeInitiator,
                                            NvmeofTarget)
from ceph_tpu_torch.services.rbd import RBD
from ceph_tpu_torch.tools.vstart import MiniCluster
from tests.test_cluster import make_cfg as ref_make_cfg
from tests.test_torch_cluster import make_cfg

# -- the cases of tests/test_nbd.py -------------------------------------------
@pytest.fixture
def cluster():
    c = MiniCluster(n_osds=4, cfg=make_cfg()).start()
    yield c
    c.stop()


def test_nbd_export_read_write(cluster):
    client = cluster.client()
    client.create_pool("rbd", size=2, pg_num=2)
    RBD(client).create("rbd", "disk", 8 << 20)
    srv = NbdServer(cluster.client(), "rbd")
    try:
        nbd = NbdClient(srv.port)
        assert nbd.list_exports() == ["disk"]
        size, tflags = nbd.go("disk")
        assert size == 8 << 20 and tflags & 1
        assert nbd.write(4096, b"B" * 8192) == 0
        assert nbd.flush() == 0
        assert nbd.read(4096, 8192) == b"B" * 8192
        assert nbd.read(0, 4096) == b"\0" * 4096  # sparse
        # trim zeroes
        assert nbd.trim(4096, 4096) == 0
        assert nbd.read(4096, 8192) == b"\0" * 4096 + b"B" * 4096
        # out-of-device write errors, device stays up
        assert nbd.write(8 << 20, b"x" * 512) != 0
        assert nbd.read(8192, 10) == b"B" * 10
        nbd.close()
        # the written bytes are REAL rbd image content
        img = RBD(cluster.client()).open("rbd", "disk")
        assert img.read(8192, 4096) == b"B" * 4096
        img.close()
    finally:
        srv.stop()


def test_nbd_two_clients_exclusive_lock(cluster):
    """Two NBD connections to one image ride the rbd exclusive-lock
    handoff underneath — both see a consistent device."""
    client = cluster.client()
    client.create_pool("rbd", size=2, pg_num=1)
    RBD(client).create("rbd", "disk", 4 << 20)
    srv = NbdServer(cluster.client(), "rbd")
    try:
        a, b = NbdClient(srv.port), NbdClient(srv.port)
        a.go("disk")
        b.go("disk")
        assert a.write(0, b"A" * 4096) == 0
        assert b.write(4096, b"B" * 4096) == 0
        assert a.read(4096, 4096) == b"B" * 4096
        assert b.read(0, 4096) == b"A" * 4096
        a.close()
        b.close()
    finally:
        srv.stop()

# -- the cases of tests/test_nvmeof.py ----------------------------------------
RNG = np.random.default_rng(71)
MiB = 1024 * 1024


@pytest.fixture
def tgt():
    c = MiniCluster(n_osds=4, cfg=make_cfg()).start()
    client = c.client()
    client.create_pool("rbd", size=2, pg_num=4)
    rbd = RBD(client)
    rbd.create("rbd", "vol0", 8 * MiB, object_size=MiB).close()
    rbd.create("rbd", "vol1", 4 * MiB, object_size=MiB).close()
    t = NvmeofTarget(client, "rbd")
    t.add_namespace("vol0")
    t.add_namespace("vol1")
    yield c, client, rbd, t
    t.stop()
    c.stop()


def test_connect_identify(tgt):
    c, client, rbd, t = tgt
    ini = NvmeInitiator("127.0.0.1", t.port)
    try:
        assert ini.ctrl_id >= 1
        info = ini.identify_controller()
        assert info["subnqn"] == "nqn.2016-06.io.ceph-tpu:sub1"
        assert info["nn"] == 2
        assert ini.list_namespaces() == [1, 2]
        ns1 = ini.identify_namespace(1)
        assert ns1 == {"nsze": 8 * MiB // LBA_SIZE,
                       "lba_size": LBA_SIZE}
        assert ini.identify_namespace(2)["nsze"] == 4 * MiB // LBA_SIZE
        with pytest.raises(KeyError):
            ini.identify_namespace(9)
        ini.keep_alive()
    finally:
        ini.close()


def test_block_io_roundtrip(tgt):
    c, client, rbd, t = tgt
    ini = NvmeInitiator("127.0.0.1", t.port)
    try:
        data = RNG.integers(0, 256, 64 * LBA_SIZE,
                            dtype=np.uint8).tobytes()
        ini.write(1, 100, data)
        ini.flush(1)
        assert ini.read(1, 100, 64) == data
        # unwritten LBAs read back as zeros
        assert ini.read(1, 4000, 2) == b"\x00" * (2 * LBA_SIZE)
        # partial overwrite at an interior LBA
        patch = b"\xAB" * LBA_SIZE
        ini.write(1, 110, patch)
        got = ini.read(1, 100, 64)
        assert got[:10 * LBA_SIZE] == data[:10 * LBA_SIZE]
        assert got[10 * LBA_SIZE:11 * LBA_SIZE] == patch
        assert got[11 * LBA_SIZE:] == data[11 * LBA_SIZE:]
    finally:
        ini.close()


def test_namespaces_isolate_and_map_to_rbd(tgt):
    """The gateway is just another librbd client: NVMe writes are the
    SAME bytes an rbd Image handle reads (and vice versa)."""
    c, client, rbd, t = tgt
    ini = NvmeInitiator("127.0.0.1", t.port)
    try:
        ini.write(1, 0, b"\x11" * LBA_SIZE)
        ini.write(2, 0, b"\x22" * LBA_SIZE)
        assert ini.read(1, 0, 1) == b"\x11" * LBA_SIZE
        assert ini.read(2, 0, 1) == b"\x22" * LBA_SIZE
        img = rbd.open("rbd", "vol0")
        assert img.read(0, LBA_SIZE) == b"\x11" * LBA_SIZE
        img.write(LBA_SIZE, b"\x33" * LBA_SIZE)  # rbd-side write...
        img.close()
        assert ini.read(1, 1, 1) == b"\x33" * LBA_SIZE  # ...nvme-visible
    finally:
        ini.close()


def test_two_initiators_and_control_plane(tgt):
    c, client, rbd, t = tgt
    a = NvmeInitiator("127.0.0.1", t.port)
    b = NvmeInitiator("127.0.0.1", t.port)
    try:
        assert a.ctrl_id != b.ctrl_id   # distinct controllers
        a.write(1, 0, b"\x44" * LBA_SIZE)
        assert b.read(1, 0, 1) == b"\x44" * LBA_SIZE
        # control plane: remove a namespace; IO on it now refuses
        assert t.list_namespaces() == {1: "vol0", 2: "vol1"}
        t.remove_namespace(2)
        with pytest.raises(AssertionError):
            b.read(2, 0, 1)
        rbd.create("rbd", "vol2", 2 * MiB, object_size=MiB).close()
        nsid = t.add_namespace("vol2")
        assert nsid == 2  # max+1 allocation: {1} -> 2 here
        assert b.identify_namespace(2)["nsze"] == 2 * MiB // LBA_SIZE
    finally:
        a.close()
        b.close()


def test_out_of_range_io_refused(tgt):
    """Clamped short reads with SC_SUCCESS would silently corrupt
    consumers: out-of-range LBAs must error (LBA Out of Range)."""
    c, client, rbd, t = tgt
    ini = NvmeInitiator("127.0.0.1", t.port)
    try:
        nsze = ini.identify_namespace(1)["nsze"]
        with pytest.raises(AssertionError):
            ini.read(1, nsze - 1, 4)       # tail-straddling read
        with pytest.raises(AssertionError):
            ini.write(1, nsze, b"x" * LBA_SIZE)
        # the last in-range LBA still works
        ini.write(1, nsze - 1, b"z" * LBA_SIZE)
        assert ini.read(1, nsze - 1, 1) == b"z" * LBA_SIZE
    finally:
        ini.close()


# ---------------------------------------- the port against the JAX package
PKGS = {"ref": (ref_vstart.MiniCluster, ref_make_cfg, ref_rbd, ref_nbd,
                ref_nvmeof),
        "port": (MiniCluster, make_cfg, port_rbd, port_nbd, port_nvmeof)}
PAIRS = [(c, s) for s in PKGS for c in PKGS]
PAYLOAD = np.random.default_rng(93).integers(0, 256, 3 * 4096 + 100,
                                             dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def clusters():
    """One cluster of each package, each with a replicated "rbd" pool
    holding two 4 MiB images for each client package: one for the NBD
    sessions, one for the NVMe/TCP sessions."""
    out = {}
    try:
        for pkg, (mc, cfg, rbd, _nbd, _nvme) in PKGS.items():
            c = mc(n_osds=4, cfg=cfg()).start()
            out[pkg] = c
            client = c.client()
            client.create_pool("rbd", size=2, pg_num=2)
            for name in [f"{kind}-{who}" for kind in ("disk", "vol")
                         for who in PKGS]:
                rbd.RBD(client).create("rbd", name, 4 << 20,
                                       object_size=1 << 20).close()
        yield out
    finally:
        for c in out.values():
            c.stop()


def _image_bytes(server_pkg: str, cluster, name: str) -> bytes:
    img = PKGS[server_pkg][2].RBD(cluster.client()).open("rbd", name)
    try:
        return img.read(0, 64 << 10)
    finally:
        img.close()


def _nbd_session(nbd, name: str) -> list:
    """Every NBD verb, each reply kept."""
    out = [nbd.list_exports(), nbd.go(name)]
    out.append(nbd.write(4096, PAYLOAD))
    out.append(nbd.flush())
    out.append(nbd.read(4096, len(PAYLOAD)))
    out.append(nbd.read(0, 4096))
    out.append(nbd.trim(8192, 4096))
    out.append(nbd.read(4096, len(PAYLOAD)))
    out.append(nbd.write(4 << 20, b"x" * 512) != 0)
    out.append(nbd.read(4 << 20 - 10, 10))
    return out


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS)
def test_nbd_pairs_across_packages(clusters, client_pkg, server_pkg):
    """Each package's NbdClient against each package's NbdServer gives
    the replies and image bytes the port gives within itself."""
    def run(client_pkg, server_pkg):
        cluster = clusters[server_pkg]
        srv = PKGS[server_pkg][3].NbdServer(cluster.client(), "rbd")
        try:
            nbd = PKGS[client_pkg][3].NbdClient(srv.port)
            try:
                replies = _nbd_session(nbd, f"disk-{client_pkg}")
            finally:
                nbd.close()
        finally:
            srv.stop()
        return replies, _image_bytes(server_pkg, cluster,
                                     f"disk-{client_pkg}")

    got = run(client_pkg, server_pkg)
    # the port within itself, on the port's image of the same client
    # (written again: the session is idempotent)
    want = run("port", "port") if (client_pkg, server_pkg) != (
        "port", "port") else got
    assert got == want
    assert got[0][4] == PAYLOAD


def _nvme_session(mod, port: int, nsid: int) -> list:
    """Connect, identify, write, flush, read back, an out-of-range read
    refused; each reply kept."""
    ini = mod.NvmeInitiator("127.0.0.1", port)
    try:
        out = [ini.identify_controller(), ini.list_namespaces(),
               ini.identify_namespace(nsid)]
        ini.write(nsid, 7, PAYLOAD[:5 * LBA_SIZE])
        ini.flush(nsid)
        out.append(ini.read(nsid, 6, 7))
        nsze = out[2]["nsze"]
        try:
            ini.read(nsid, nsze - 1, 4)
            out.append("read past the end served")
        except AssertionError:
            out.append("refused")
        ini.keep_alive()
        return out
    finally:
        ini.close()


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS)
def test_nvmeof_pairs_across_packages(clusters, client_pkg, server_pkg):
    """Each package's NvmeInitiator against each package's NvmeofTarget
    gives the replies and image bytes the port gives within itself."""
    def run(client_pkg, server_pkg):
        cluster = clusters[server_pkg]
        t = PKGS[server_pkg][4].NvmeofTarget(cluster.client(), "rbd")
        try:
            nsids = {who: t.add_namespace(f"vol-{who}") for who in PKGS}
            replies = _nvme_session(PKGS[client_pkg][4], t.port,
                                    nsids[client_pkg])
        finally:
            t.stop()
        return replies, _image_bytes(server_pkg, cluster,
                                     f"vol-{client_pkg}")

    got = run(client_pkg, server_pkg)
    want = run("port", "port") if (client_pkg, server_pkg) != (
        "port", "port") else got
    assert got == want
    assert got[0][3] == b"\0" * LBA_SIZE + PAYLOAD[:5 * LBA_SIZE] \
        + b"\0" * LBA_SIZE
    assert got[0][4] == "refused"
