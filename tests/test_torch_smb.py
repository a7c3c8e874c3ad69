"""The port's SMB share (ceph_tpu_torch.services.smb) over its file
client, held against the JAX package on the CPU.

- The cases of the JAX package's tests/test_smb.py on the port.
- Across packages: each package's SmbClient against each package's
  SmbServer runs the same session; the four pairs give the same
  replies, and the files land in the share's file system the same.
"""

import numpy as np
import pytest

import ceph_tpu.services.fs as ref_fs
import ceph_tpu.services.smb as ref_smb
import ceph_tpu.tools.vstart as ref_vstart
import ceph_tpu_torch.services.fs as port_fs
import ceph_tpu_torch.services.smb as port_smb
from ceph_tpu_torch.services.smb import SmbClient, SmbServer
from ceph_tpu_torch.tools.vstart import MiniCluster
from tests.test_cluster import make_cfg as ref_make_cfg
from tests.test_torch_cluster import make_cfg

# -- the cases of tests/test_smb.py -------------------------------------------
RNG = np.random.default_rng(41)


@pytest.fixture
def smb():
    c = MiniCluster(n_osds=4, cfg=make_cfg()).start()
    c.client().create_pool("fsp", size=2, pg_num=4)
    srv = SmbServer(lambda: c.client())
    srv.add_share("docs", "fsp")
    yield c, srv
    srv.stop()
    c.stop()


def test_negotiate_session_tree(smb):
    c, srv = smb
    cl = SmbClient("127.0.0.1", srv.port)
    try:
        assert cl.dialect == 0x0202
        assert cl.sid >= 0x100
        cl.tree_connect("docs")
        assert cl.tid >= 1
        cl2 = SmbClient("127.0.0.1", srv.port)
        try:
            with pytest.raises(AssertionError):
                cl2.tree_connect("nope")
        finally:
            cl2.close()
    finally:
        cl.close()


def test_file_io_roundtrip(smb):
    c, srv = smb
    cl = SmbClient("127.0.0.1", srv.port)
    try:
        cl.tree_connect("docs")
        d = cl.mkdir("reports")
        cl.close_file(d)
        f = cl.create_file("reports/q3.bin")
        data = RNG.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
        cl.write(f, 0, data[:200_000])
        cl.write(f, 200_000, data[200_000:])
        cl.close_file(f)
        f = cl.open("reports/q3.bin")
        got = b""
        off = 0
        while off < len(data):
            chunk = cl.read(f, off, 65536)
            if not chunk:
                break
            got += chunk
            off += len(chunk)
        assert got == data
        cl.close_file(f)
        # the same bytes are visible through a direct fs mount
        from ceph_tpu_torch.services.fs import FsClient
        fs = FsClient(c.client(), "fsp")
        assert fs.read_file("/reports/q3.bin") == data
        fs.write_file("/reports/q3.bin", b"PATCH", offset=10)
        fs.unmount()
        f = cl.open("reports/q3.bin")
        assert cl.read(f, 10, 5) == b"PATCH"
        cl.close_file(f)
    finally:
        cl.close()


def test_directory_listing_and_delete(smb):
    c, srv = smb
    cl = SmbClient("127.0.0.1", srv.port)
    try:
        cl.tree_connect("docs")
        cl.close_file(cl.mkdir("a"))
        cl.close_file(cl.create_file("a/x.txt"))
        f = cl.create_file("a/y.txt")
        cl.write(f, 0, b"hello")
        cl.close_file(f)
        root = cl.open("/")
        names = {e["name"]: e for e in cl.listdir(root)}
        cl.close_file(root)
        assert set(names) == {"a"} and names["a"]["dir"]
        d = cl.open("a")
        entries = {e["name"]: e for e in cl.listdir(d)}
        cl.close_file(d)
        assert set(entries) == {"x.txt", "y.txt"}
        assert entries["y.txt"]["size"] == 5
        assert not entries["x.txt"]["dir"]
        # delete-on-close removes the file
        f = cl.open("a/x.txt")
        cl.close_file(f, delete=True)
        d = cl.open("a")
        assert [e["name"] for e in cl.listdir(d)] == ["y.txt"]
        cl.close_file(d)
        # open of the deleted file now refuses
        with pytest.raises(OSError):
            cl.open("a/x.txt")
    finally:
        cl.close()


def test_create_semantics(smb):
    c, srv = smb
    cl = SmbClient("127.0.0.1", srv.port)
    try:
        cl.tree_connect("docs")
        cl.close_file(cl.create_file("f1"))
        with pytest.raises(OSError):   # FILE_CREATE collides
            cl.create_file("f1")
        with pytest.raises(OSError):   # FILE_OPEN of absent
            cl.open("missing")
        # share control plane
        assert srv.list_shares() == ["docs"]
        srv.remove_share("docs")
        cl2 = SmbClient("127.0.0.1", srv.port)
        try:
            with pytest.raises(AssertionError):
                cl2.tree_connect("docs")
        finally:
            cl2.close()
    finally:
        cl.close()


def test_enumeration_cursor_and_disconnect_delete(smb):
    """Conformant-client behaviors: repeated QUERY_DIRECTORY ends with
    STATUS_NO_MORE_FILES (no infinite duplicate listings), and a
    dropped connection still fires pending delete-on-close."""
    c, srv = smb
    cl = SmbClient("127.0.0.1", srv.port)
    try:
        cl.tree_connect("docs")
        cl.close_file(cl.create_file("once"))
        root = cl.open("/")
        assert [e["name"] for e in cl.listdir(root)] == ["once"]
        assert cl.listdir(root) == []     # cursor exhausted
        cl.close_file(root)
        # mark for deletion, then DROP the connection without CLOSE
        f = cl.open("once")
        payload = __import__("struct").pack(
            "<HBBIHHI", 33, 1, 13, 1, 64 + 32, 0, 0) + f + b"\x01"
        st, _h, _b = cl._cmd(0x11, payload)
        assert st == 0
    finally:
        cl.close()                        # disconnect fires the delete
    import time as _t
    deadline = _t.time() + 5
    while _t.time() < deadline:
        cl3 = SmbClient("127.0.0.1", srv.port)
        try:
            cl3.tree_connect("docs")
            root = cl3.open("/")
            names = [e["name"] for e in cl3.listdir(root)]
            cl3.close_file(root)
            if "once" not in names:
                return
        finally:
            cl3.close()
        _t.sleep(0.1)
    raise AssertionError("delete-on-close never fired on disconnect")


# -- the port against the JAX package -----------------------------------------
PKGS = {"ref": (ref_vstart.MiniCluster, ref_make_cfg, ref_smb, ref_fs),
        "port": (MiniCluster, make_cfg, port_smb, port_fs)}
PAIRS = [(c, s) for s in PKGS for c in PKGS]
PAYLOAD = np.random.default_rng(94).integers(0, 256, 150_000,
                                             dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def servers():
    """One cluster of each package with an SmbServer of that package,
    and one share (a replicated pool) for each client package."""
    out = {}
    try:
        for pkg, (mc, cfg, smb_mod, _fs) in PKGS.items():
            c = mc(n_osds=4, cfg=cfg()).start()
            out[pkg] = (c, None)
            for who in PKGS:
                c.client().create_pool(f"share-{who}", size=2, pg_num=2)
            srv = smb_mod.SmbServer(lambda c=c: c.client())
            out[pkg] = (c, srv)
            for who in PKGS:
                srv.add_share(f"docs-{who}", f"share-{who}")
        yield out
    finally:
        for c, srv in out.values():
            if srv is not None:
                srv.stop()
            c.stop()


def _smb_session(mod, port: int, share: str, top: str) -> list:
    """Negotiate, connect the share, a directory ``top``, a file written
    in two pieces and read back, a listing, a refused create of an
    existing file and a delete on close; each reply kept (file ids by
    length)."""
    cl = mod.SmbClient("127.0.0.1", port)
    try:
        out = [cl.dialect, cl.sid >= 0x100]
        cl.tree_connect(share)
        d = cl.mkdir(top)
        cl.close_file(d)
        f = cl.create_file(f"{top}/file.bin")
        out.append(len(f))
        cl.write(f, 0, PAYLOAD[:100_000])
        cl.write(f, 100_000, PAYLOAD[100_000:])
        cl.close_file(f)
        f = cl.open(f"{top}/file.bin")
        out.append(b"".join(cl.read(f, off, 65536)
                            for off in range(0, len(PAYLOAD), 65536)))
        cl.close_file(f)
        d = cl.open(top)
        out.append(sorted((e["name"], e["size"], e["dir"])
                          for e in cl.listdir(d)))
        cl.close_file(d)
        try:
            cl.create_file(f"{top}/file.bin")
            out.append("created twice")
        except OSError as e:
            out.append(str(e))
        f = cl.create_file(f"{top}/scratch")
        cl.close_file(f, delete=True)
        d = cl.open(top)
        out.append(sorted(e["name"] for e in cl.listdir(d)))
        cl.close_file(d)
        return out
    finally:
        cl.close()


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS)
def test_smb_pairs_across_packages(servers, client_pkg, server_pkg):
    """Each package's SmbClient against each package's SmbServer gives
    the replies the port gives within itself, and the file the session
    wrote reads back through the server package's file client."""
    share = client_pkg

    def run(client_pkg, server_pkg, top):
        c, srv = servers[server_pkg]
        replies = _smb_session(PKGS[client_pkg][2], srv.port,
                               f"docs-{share}", top)
        fs = PKGS[server_pkg][3].FsClient(c.client(), f"share-{share}")
        try:
            return (replies, fs.read_file(f"/{top}/file.bin"),
                    fs.listdir(f"/{top}"))
        finally:
            fs.unmount()

    got = run(client_pkg, server_pkg, f"from-{server_pkg}")
    assert got[0][3] == got[1] == PAYLOAD
    # the port within itself, in a directory of its own
    want = run("port", "port", f"want-{server_pkg}")
    assert got == want
