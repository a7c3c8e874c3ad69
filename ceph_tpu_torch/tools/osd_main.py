"""Standalone OSD daemon process — the ceph-osd binary role.

The reference boots each OSD as its own process (src/ceph_osd.cc:124
main: global_init, ObjectStore::create, messengers, OSD::init).  Here:
parse flags, build a TcpNetwork seeded with the monitor address, mount
the object store, start the daemon, run until SIGTERM/SIGINT.

Used by the vstart harness's process mode (MiniCluster.spawn_osd_process)
and directly:

    python -m ceph_tpu_torch.tools.osd_main --id 3 --mon-addr 127.0.0.1:6789
"""

from __future__ import annotations

import argparse
import json
import signal
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ceph_tpu_torch OSD daemon")
    ap.add_argument("--id", type=int, required=True, dest="osd_id")
    ap.add_argument("--mon-addr", required=True,
                    help="host:port of the monitor's messenger")
    ap.add_argument("--mon-name", default="mon.0")
    ap.add_argument("--host", default=None,
                    help="failure-domain host label")
    ap.add_argument("--store", default="memstore",
                    choices=("memstore", "filestore", "bluestore"))
    ap.add_argument("--store-path", default=None)
    ap.add_argument("--cfg", default="{}",
                    help="JSON object of config overrides")
    ap.add_argument("--admin-socket", default=None,
                    help="unix socket path for `ceph daemon` commands")
    ap.add_argument("--auth-secret-hex", default=None,
                    help="cephx-lite shared secret (hex)")
    ap.add_argument("--compress", default="none",
                    help="on-wire compression algorithm")
    ap.add_argument("--secure", action="store_true",
                    help="msgr2-secure-mode on-wire encryption")
    ap.add_argument("--bind-ip", default="127.0.0.1",
                    help="address this daemon's messengers bind — a "
                         "distinct loopback per host models the "
                         "multi-host deployment (public_addr role)")
    args = ap.parse_args(argv)

    from ..msg.tcp import TcpNetwork
    from ..osd.daemon import OSDDaemon
    from ..osd.objectstore import ObjectStore
    from ..utils.config import default_config

    cfg = default_config()
    cfg.apply_dict(json.loads(args.cfg))
    secret = bytes.fromhex(args.auth_secret_hex) \
        if args.auth_secret_hex is not None else None
    net = TcpNetwork(host=args.bind_ip, auth_secret=secret,
                     compress=args.compress, secure=args.secure,
                     stack=cfg["ms_stack"])
    net.set_addr(args.mon_name, args.mon_addr)
    store_kw = {"path": args.store_path} if args.store_path else {}
    store = ObjectStore.create(args.store, **store_kw)
    osd = OSDDaemon(args.osd_id, net, mon=args.mon_name, store=store,
                    cfg=cfg, host=args.host)

    admin = None
    if args.admin_socket:
        import os as _os

        from ..utils.admin_socket import AdminSocketServer
        # peers' sockets share this directory (the asok convention):
        # the flight recorder merges cross-daemon traces through it
        osd.asok_dir = _os.path.dirname(_os.path.abspath(
            args.admin_socket)) or None
        admin = AdminSocketServer(
            args.admin_socket,
            lambda prefix, **kw: osd.admin_command(prefix, **kw))

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    osd.start()
    stop.wait()
    if admin is not None:
        admin.stop()
    osd.stop()
    net.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
