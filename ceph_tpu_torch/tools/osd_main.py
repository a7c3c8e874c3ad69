"""Standalone OSD daemon process — the ceph-osd binary role.

The reference boots each OSD as its own process (src/ceph_osd.cc:124
main: global_init, ObjectStore::create, messengers, OSD::init).  Here:
parse flags, build a TcpNetwork seeded with the monitor address, mount
the object store, start the daemon, run until SIGTERM/SIGINT.

Used by the vstart harness's process mode (MiniCluster.spawn_osd_process)
and directly:

    python -m ceph_tpu_torch.tools.osd_main --id 3 --mon-addr 127.0.0.1:6789

Three additions of the port: the admin socket also answers
``dump_process`` (``process_status``: what belongs to the process rather
than to the daemon, its kernels' launches above all); ``--parent-pid``
makes the child stop when that process is no longer its parent, so a
harness that dies without stopping its OSDs leaves none running; and

    python -m ceph_tpu_torch.tools.osd_main --fork-server

imports what an OSD needs once and then forks each OSD a harness asks
for (``fork_server``; vstart's ``ForkServer`` is its other end): on a
card's host ``import torch`` alone takes seconds, which a forked OSD does
not pay again.  The server touches no CUDA, so each forked OSD opens its
own context.
"""

from __future__ import annotations

import time

#: wall-clock seconds of this module's first line, before the imports
_STARTED_AT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402


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
    ap.add_argument("--parent-pid", type=int, default=None,
                    help="stop when this process is no longer the "
                         "parent (the harness that spawned this OSD "
                         "died without stopping it)")
    args = ap.parse_args(argv)

    from ..msg.tcp import TcpNetwork
    from ..osd.daemon import OSDDaemon
    from ..osd.objectstore import ObjectStore
    from ..utils.config import default_config

    _START["imported_at"] = time.time()

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
    _START["built_at"] = time.time()

    admin = None
    if args.admin_socket:
        from ..utils.admin_socket import AdminSocketServer
        # peers' sockets share this directory (the asok convention):
        # the flight recorder merges cross-daemon traces through it
        osd.asok_dir = os.path.dirname(os.path.abspath(
            args.admin_socket)) or None
        admin = AdminSocketServer(
            args.admin_socket,
            lambda prefix, **kw: (process_status(osd)
                                  if prefix == "dump_process"
                                  else osd.admin_command(prefix, **kw)))

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    if args.parent_pid is not None:
        threading.Thread(target=_watch_parent, args=(args.parent_pid, stop),
                         name="parent-watch", daemon=True).start()
    if cfg["ec_backend"] == "torch":
        _ready_card()
    _START["card_at"] = time.time()
    osd.start()
    _START["booted_at"] = time.time()
    stop.wait()
    if admin is not None:
        admin.stop()
    osd.stop()
    net.stop()
    return 0


#: wall-clock stamps of this process's start: its first line (or its
#: fork), the end of its imports, the daemon built (its store mounted),
#: the card readied, its boot sent; ``forked`` when a fork server
#: started it
_START = {"started_at": _STARTED_AT, "forked": False}

#: the modules every OSD imports, which the fork server imports once
PRELOAD = ("ceph_tpu_torch.msg.tcp", "ceph_tpu_torch.osd.daemon",
           "ceph_tpu_torch.osd.objectstore", "ceph_tpu_torch.osd.filestore",
           "ceph_tpu_torch.osd.bluestore", "ceph_tpu_torch.utils.config",
           "ceph_tpu_torch.utils.admin_socket", "ceph_tpu_torch.ec",
           "ceph_tpu_torch.ec.matrix_code", "ceph_tpu_torch.ops.cuda_lib")


def fork_server(argv=None) -> int:
    """Import PRELOAD, then serve a harness over stdin and stdout, one
    JSON object a line.  A request ``{"id": n, "argv": [...]}`` forks a
    child that runs ``main(argv)`` (with ``--parent-pid`` of this server
    appended, so it stops if the server dies) and is answered ``{"id":
    n, "pid": p}``; each child's exit is reported as ``{"exited": p,
    "rc": r}``.  The server exits when its stdin closes or its parent
    (``--parent-pid``) is gone; its children then stop by themselves.
    It stays single-threaded and never touches CUDA, so a fork is safe
    and each child opens its own context."""
    import importlib
    import select

    ap = argparse.ArgumentParser(description="OSD fork server")
    ap.add_argument("--fork-server", action="store_true")
    ap.add_argument("--parent-pid", type=int, default=None)
    args = ap.parse_args(argv)
    for mod in PRELOAD:
        importlib.import_module(mod)
    out = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)  # what the children print goes to stderr, not the pipe
    me, stdin, buf, live = os.getpid(), sys.stdin.fileno(), b"", set()

    def tell(obj: dict) -> None:
        out.write(json.dumps(obj) + "\n")

    while True:
        while live:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                break
            if pid == 0:
                break
            live.discard(pid)
            tell({"exited": pid, "rc": os.waitstatus_to_exitcode(status)})
        if args.parent_pid is not None and os.getppid() != args.parent_pid:
            return 0
        if not select.select([stdin], [], [], 0.05)[0]:
            continue
        chunk = os.read(stdin, 1 << 16)
        if not chunk:
            return 0
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            req = json.loads(line)
            pid = os.fork()
            if pid == 0:
                _forked_child(req["argv"] + ["--parent-pid", str(me)],
                              out)
            live.add(pid)
            tell({"id": req["id"], "pid": pid})


def _forked_child(argv: list, pipe) -> None:
    """The fork server's child: drop the server's pipes, run the OSD,
    exit with its code (never return into the server's loop)."""
    rc = 1
    try:
        pipe.close()
        devnull = os.open(os.devnull, os.O_RDONLY)
        os.dup2(devnull, 0)
        os.close(devnull)
        _START.update(started_at=time.time(), forked=True)
        rc = main(argv)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    except BaseException:  # noqa: BLE001 - printed; the exit code says it
        traceback.print_exc()
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc or 0)


def _ready_card() -> None:
    """Where this process sees a card, load the CUDA library and open
    the card's context before the OSD boots: the codecs of the map's
    pools on the card then build at once, and the OSD is not up, with
    peers waiting on it, while it opens the card."""
    import torch

    if torch.cuda.is_available():
        from ..ops import cuda_lib

        cuda_lib.lib()
        torch.zeros(1, device="cuda")


def _watch_parent(pid: int, stop: threading.Event,
                  period: float = 0.5) -> None:
    """Set ``stop`` once ``pid`` is no longer this process's parent (it
    died, and the child was handed to another)."""
    while not stop.wait(period):
        if os.getppid() != pid:
            stop.set()


def process_status(osd) -> dict:
    """The ``dump_process`` admin verb: the process's pid; the launches
    of every kernel and plain version made in it
    (``ec_kernels.launch_counts``); the fused encode+CRC launches (its
    ``csum/`` signatures in the kernel profiler), the kernel picks of its
    codecs and the EC pools whose codecs the OSD holds; the CUDA
    library's first load (``cuda_lib.LOAD_LOG``: seconds, and whether it
    built); whether the process holds a CUDA context and the bytes its
    caching allocator holds on the card; the wall-clock stamps of the
    process's start (``_START``); the ops answered at once because a map
    marked their member down; the client ops refused because their PG
    was handed to a newer map's primary after they were admitted
    (``ops_refused_handed_over``); and the OSD's ops that waited out
    ``osd_op_timeout`` (the last described) and messages dropped by its
    messenger's throttle and its op queues' caps."""
    import torch

    from ..ops import cuda_lib, ec_kernels
    from ..utils.perf import kernel_profiler

    prof = kernel_profiler().dump()
    context = torch.cuda.is_initialized()
    return {
        "pid": os.getpid(),
        "launches": ec_kernels.launch_counts(),
        "fused": sum(agg["device"] + agg["compile"]
                     for sig, agg in prof["signatures"].items()
                     if sig.startswith("csum/")),
        "picks": prof["picks"],
        "ec_pools": sorted(osd._ec_codecs),
        "cuda_lib": dict(cuda_lib.LOAD_LOG),
        "cuda": {"context": context,
                 "reserved": torch.cuda.memory_reserved() if context
                 else 0},
        "start": dict(_START),
        "timed_out": list(osd.timed_out_ops),
        "ops_reset_on_down": osd.ops_reset_on_down,
        "ops_refused_handed_over": osd.ops_refused_handed_over,
        "faults": {
            "op_timeouts": osd.perf.get("op_timeouts"),
            "dropped": (osd.messenger.perf.get("msg_drop_backpressure")
                        + sum(osd.scheduler.dropped.values()))}}


if __name__ == "__main__":
    raise SystemExit(fork_server() if "--fork-server" in sys.argv[1:]
                     else main())
