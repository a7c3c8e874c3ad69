"""smoke: one-command end-to-end self-check of the whole framework.

Boots an in-process cluster and drives every subsystem the way a user
would — EC pools with snapshots, divergence recovery, rbd with
journaling over NBD, versioned S3 with IAM + STS + notifications +
the Swift dialect, CephFS .snap views and standby-replay, cephx caps
enforcement, live pg_num scaling (split + merge), the NVMe/TCP
gateway, the mgr dashboard, distributed tracing, and the EC audit —
printing a scorecard.  Exit 0 iff every check passed.

    python -m ceph_tpu_torch.tools.smoke            # full run (~1 min)
    python -m ceph_tpu_torch.tools.smoke --quick    # core slice only
    python -m ceph_tpu_torch.tools.smoke --quick --device cpu

``--device {cuda,cpu}`` (default ``cuda``) says where the scorecard's EC
pool computes: its codec is the port's ``torch`` backend on the card,
or on the CPU (the plain versions of the kernels, one torch thread).
``cuda`` with no card exits 2 and never carries on on the CPU.  The
kernel check runs the fused encode+CRC of ``StripeCodec(4, 2)`` on
``--device``: on the card a region kernel and the CRC32C kernel.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--osds", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from .bench_root import bench_device
    try:
        dev = bench_device(args.device)
    except RuntimeError as e:
        print(f"smoke: {e}", file=sys.stderr)
        return 2
    import torch
    if dev.type == "cpu":
        # the plain versions' many small ops otherwise leave intra-op
        # threads spinning on the cores the heartbeats need
        torch.set_num_threads(1)

    from ..tools.vstart import MiniCluster
    from ..utils.config import default_config

    cfg = default_config()
    cfg.apply_dict({"osd_heartbeat_interval": 0.05,
                    "osd_heartbeat_grace": 0.5,
                    "osd_op_num_shards": 2,
                    "ec_backend": "torch"})
    # the EC pool's codec on --device (the torch backend's default
    # device is the card)
    ec_device = {} if dev.type == "cuda" else {"device": "cpu"}

    results: list[tuple[str, bool, str]] = []

    def check(name: str):
        def deco(fn):
            t0 = time.time()
            try:
                fn()
                results.append((name, True,
                                f"{time.time() - t0:.1f}s"))
            except Exception as e:  # noqa: BLE001 - scorecard boundary
                results.append((name, False, repr(e)))
                traceback.print_exc()
            return fn
        return deco

    c = MiniCluster(n_osds=args.osds, cfg=cfg).start()
    try:
        client = c.client()

        @check("ec pool io + degraded read")
        def _ec():
            import numpy as np
            client.create_pool("ec", kind="ec", pg_num=2,
                               ec_profile={"plugin": "jerasure",
                                           "k": "3", "m": "2",
                                           **ec_device})
            data = np.random.default_rng(1).integers(
                0, 256, 500_000, dtype=np.uint8).tobytes()
            client.write_full("ec", "obj", data)
            assert client.read("ec", "obj") == data
            up = c.mon.osdmap.pg_to_up_osds(
                client._pool_id("ec"),
                c.mon.osdmap.object_to_pg(client._pool_id("ec"),
                                          "obj"))
            codecs = [(cd._backend, cd.device.type)
                      for i in up for cd in c.osds[i]._ec_codecs.values()]
            assert codecs and all(cd == ("torch", dev.type)
                                  for cd in codecs), codecs
            c.kill_osd(up[1])
            c.settle(1.0)
            assert client.read("ec", "obj") == data  # reconstruction
            c.revive_osd(up[1])
            c.settle(1.0)

        @check("ec snapshots + rollback")
        def _snap():
            v1 = b"gen-one" * 1000
            client.write_full("ec", "snapobj", v1)
            sid = client.selfmanaged_snap_create("ec")
            client.write_full("ec", "snapobj", b"gen-two" * 1200)
            assert client.read("ec", "snapobj", snapid=sid) == v1
            client.snap_rollback("ec", "snapobj", sid)
            assert client.read("ec", "snapobj") == v1
            client.selfmanaged_snap_remove("ec", sid)

        @check("deep scrub + ec audit")
        def _audit():
            from .ec_consistency import run as audit
            deadline = time.time() + 15
            issues = audit(client, "ec")
            while issues and time.time() < deadline:
                c.settle(1.0)
                issues = audit(client, "ec")
            assert issues == [], issues

        @check("distributed tracing span tree")
        def _trace():
            from ..utils.tracer import build_tree
            tc = c.client()
            tc.tracing = True
            tc.write_full("ec", "traced", b"spans!" * 100)
            root = next(s for s in tc.tracer.dump()
                        if s["name"].startswith("client-op"))
            spans = {s["span_id"]: s for s in
                     c.collect_trace(root["trace_id"])
                     + tc.tracer.spans_for(root["trace_id"])}
            tree = build_tree(list(spans.values()))
            assert tree and tree[0]["children"], "no span tree"

        if not args.quick:
            @check("rbd journaling over nbd")
            def _rbd():
                from ..services.nbd import NbdClient, NbdServer
                from ..services.rbd import FEATURE_JOURNALING, RBD
                client.create_pool("rbd", size=2, pg_num=2)
                RBD(client).create("rbd", "disk", 8 << 20,
                                   features=FEATURE_JOURNALING)
                srv = NbdServer(c.client(), "rbd")
                try:
                    nbd = NbdClient(srv.port)
                    size, _ = nbd.go("disk")
                    assert size == 8 << 20
                    assert nbd.write(4096, b"N" * 8192) == 0
                    assert nbd.read(4096, 8192) == b"N" * 8192
                    nbd.close()
                finally:
                    srv.stop()

            @check("rgw versioning + lifecycle + policy")
            def _rgw():
                import http.client

                from ..services.rgw import RgwGateway
                client.create_pool("rgw", size=2, pg_num=2)
                gw = RgwGateway(c.client(), "rgw")
                try:
                    def req(m, p, body=None):
                        conn = http.client.HTTPConnection(
                            "127.0.0.1", gw.port, timeout=10)
                        conn.request(m, p, body=body)
                        r = conn.getresponse()
                        d = r.read()
                        conn.close()
                        return r.status, d
                    assert req("PUT", "/b")[0] == 200
                    req("PUT", "/b?versioning",
                        "<VersioningConfiguration><Status>Enabled"
                        "</Status></VersioningConfiguration>")
                    req("PUT", "/b/k", b"one")
                    req("PUT", "/b/k", b"two")
                    st, xml = req("GET", "/b?versions")
                    assert st == 200
                    assert xml.count(b"<Version>") == 2
                    assert gw.lc_process()["expired"] == 0
                    pol = {"Statement": [{"Effect": "Allow",
                                          "Principal": "*",
                                          "Action": ["s3:*"]}]}
                    gw.set_bucket_policy("b", pol)
                    assert gw.get_bucket_policy("b") == pol
                finally:
                    gw.stop()

            @check("cephfs .snap views")
            def _fs():
                from ..services.fs import FsClient
                client.create_pool("fsdata", size=2, pg_num=2)
                fs = FsClient(c.client(), "fsdata")
                try:
                    fs.mkdir("/d")
                    fs.create("/d/f")
                    fs.write_file("/d/f", b"frozen" * 100)
                    fs.snap_create("/d", "s1")
                    fs.write_file("/d/f", b"thawed" * 120)
                    assert fs.read_file("/d/.snap/s1/f") == \
                        b"frozen" * 100
                    assert fs.listdir("/d/.snap") == ["s1"]
                finally:
                    fs.unmount()

            @check("mgr dashboard + modules")
            def _mgr():
                import http.client
                import json as _json

                from ..mon.mgr import MgrDaemon
                mgr = MgrDaemon(c.mon,
                                modules=("status", "dashboard")).start()
                try:
                    port = mgr.module("dashboard").port
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", port, timeout=5)
                    conn.request("GET", "/api/status")
                    st = _json.loads(conn.getresponse().read())
                    assert st["osds"]["total"] == args.osds
                finally:
                    mgr.stop()

            @check("pg split + merge round trip")
            def _scale():
                client.create_pool("scale", size=2, pg_num=2)
                objs = {f"sc{i}": bytes([i]) * 2000 for i in range(16)}
                for n, d in objs.items():
                    client.write_full("scale", n, d)
                for target in (8, 2):
                    client.mon_command({"prefix": "osd pool set-pg-num",
                                        "pool": "scale",
                                        "pg_num": target})
                    deadline = time.time() + 20
                    left = dict(objs)
                    while left and time.time() < deadline:
                        for n in list(left):
                            try:
                                if client.read("scale", n) == left[n]:
                                    del left[n]
                            except Exception:  # noqa: BLE001
                                pass
                        time.sleep(0.2)
                    assert not left, (target, sorted(left)[:3])

            @check("cephx caps enforced at osd/mon")
            def _auth():
                from ..client.rados import RadosError
                ac = MiniCluster(n_osds=3, cfg=cfg, auth=True).start()
                try:
                    admin = ac.client()
                    admin.create_pool("ax", size=2, pg_num=2)
                    admin.create_pool("ay", size=2, pg_num=2)
                    out = admin.mon_command({
                        "prefix": "auth get-or-create",
                        "entity": "client.lim",
                        "caps": {"mon": "allow r",
                                 "osd": "allow rw pool=ax"}})
                    lim = ac.client(entity="client.lim",
                                    key=bytes.fromhex(out["key"]))
                    lim.write_full("ax", "o", b"mine")
                    assert lim.read("ax", "o") == b"mine"
                    for op in (lambda: lim.write_full("ay", "o", b"x"),
                               lambda: lim.create_pool("az", size=2,
                                                       pg_num=1)):
                        try:
                            op()
                            raise AssertionError("not denied")
                        except RadosError as e:
                            assert e.code == -13, e
                finally:
                    ac.stop()

            @check("rgw notifications + sts + swift")
            def _rgw2():
                import http.client as _hc

                from ..services.rgw import RgwGateway
                client.create_pool("rgw2", size=2, pg_num=2)
                g = RgwGateway(c.client(), "rgw2",
                               users={"AKIAA": "sek"})
                try:
                    g.create_bucket("b")
                    g.set_bucket_owner("b", "AKIAA")
                    g.create_topic("t")
                    g.put_bucket_notification("b", [
                        {"id": "n", "topic": "t",
                         "events": ["s3:ObjectCreated:*"]}])
                    g.put_object("b", "k", b"v")
                    evs = g.pull_events("t")
                    assert [e["eventName"] for e in evs] == \
                        ["s3:ObjectCreated:Put"]
                    g.create_role("r", trust=["AKIAA"], policy={
                        "Statement": [{"Effect": "Allow",
                                       "Action": ["s3:GetObject"],
                                       "Resource": ["b"]}]})
                    creds = g.assume_role("AKIAA", "r", duration=30)
                    assert g.sts_principal(
                        creds["access_key"],
                        creds["session_token"]) == "sts:r"
                    # swift: token mint + object round trip
                    conn = _hc.HTTPConnection("127.0.0.1", g.port,
                                              timeout=5)
                    conn.request("GET", "/auth/v1.0",
                                 headers={"X-Auth-User": "AKIAA",
                                          "X-Auth-Key": "sek"})
                    tok = dict(conn.getresponse().headers)[
                        "X-Auth-Token"]
                    conn.close()
                    h = {"X-Auth-Token": tok}
                    conn = _hc.HTTPConnection("127.0.0.1", g.port,
                                              timeout=5)
                    conn.request("GET", "/swift/v1/b/k", headers=h)
                    r = conn.getresponse()
                    assert (r.status, r.read()) == (200, b"v")
                    conn.close()
                finally:
                    g.stop()

            @check("nvme-of target over rbd")
            def _nvme():
                from ..services.nvmeof import (LBA_SIZE, NvmeInitiator,
                                               NvmeofTarget)
                from ..services.rbd import RBD
                client.create_pool("nvme", size=2, pg_num=2)
                RBD(client).create("nvme", "lun0", 4 << 20,
                                   object_size=1 << 20).close()
                t = NvmeofTarget(c.client(), "nvme")
                ini = None
                try:
                    t.add_namespace("lun0")
                    ini = NvmeInitiator("127.0.0.1", t.port)
                    assert ini.identify_controller()["nn"] == 1
                    ini.write(1, 10, b"\x5a" * (4 * LBA_SIZE))
                    assert ini.read(1, 10, 4) == b"\x5a" * (4 * LBA_SIZE)
                finally:
                    if ini is not None:
                        ini.close()
                    t.stop()

            @check("smb share over cephfs")
            def _smb():
                from ..services.smb import SmbClient, SmbServer
                client.create_pool("smbfs", size=2, pg_num=2)
                srv = SmbServer(lambda: c.client())
                cl = None
                try:
                    srv.add_share("share", "smbfs")
                    cl = SmbClient("127.0.0.1", srv.port)
                    cl.tree_connect("share")
                    f = cl.create_file("hello.txt")
                    cl.write(f, 0, b"smoke over smb")
                    cl.close_file(f)
                    f = cl.open("hello.txt")
                    assert cl.read(f, 0, 64) == b"smoke over smb"
                    cl.close_file(f)
                finally:
                    if cl is not None:
                        cl.close()
                    srv.stop()

            @check("mds standby-replay promotion")
            def _standby():
                from ..services.fs import FsClient
                from ..services.mds import MdsDaemon, StandbyReplayMds
                client.create_pool("fsx", size=2, pg_num=2)
                active = MdsDaemon(client, "fsx")
                fs = FsClient(client, "fsx", mds=active)
                standby = None
                fs2 = None
                try:
                    fs.mkdir("/w")
                    fs.create("/w/f")
                    fs.write_file("/w/f", b"warm")
                    standby = StandbyReplayMds(c.client(), "fsx")
                    time.sleep(0.2)
                    fs.unmount()
                    fs = None
                    promoted, replayed = standby.promote()
                    assert replayed == 0  # clean handoff: no window
                    fs2 = FsClient(client, "fsx", mds=promoted)
                    assert fs2.read_file("/w/f") == b"warm"
                finally:
                    # a mid-check failure must not leave the tail
                    # thread polling or sessions registered
                    if standby is not None:
                        standby.stop()
                    for handle in (fs, fs2):
                        if handle is not None:
                            try:
                                handle.unmount()
                            except Exception:  # noqa: BLE001
                                pass

        @check(f"kernel parity (fused encode+crc on {dev.type})")
        def _kernel():
            import numpy as np

            from ..models.stripe_codec import StripeCodec
            from ..ops import native
            codec = StripeCodec(k=4, m=2)
            fn = codec.encode_csum_graph(4096)
            data = np.random.default_rng(2).integers(
                0, 256, (4, 8192), dtype=np.uint8)
            parity, csums = fn(torch.from_numpy(data).to(dev))
            parity, csums = parity.cpu().numpy(), csums.cpu().numpy()
            assert np.array_equal(
                parity, native.encode_region(codec.matrix, data))
            stack = np.concatenate([data, parity])
            assert [[int(x) for x in row] for row in csums] == [
                [native.crc32c(bytes(row[j:j + 4096]))
                 for j in range(0, row.size, 4096)] for row in stack]
    finally:
        c.stop()

    width = max(len(n) for n, _ok, _d in results)
    failed = 0
    for name, ok, detail in results:
        mark = "PASS" if ok else "FAIL"
        failed += 0 if ok else 1
        print(f"  {name:<{width}}  {mark}  {detail}")
    print(f"smoke: {len(results) - failed}/{len(results)} subsystems ok")
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
