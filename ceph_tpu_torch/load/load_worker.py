"""One PROCESS of the saturation load generator.

The client-side analogue of parallel/dcn_worker.py's spawn-and-
rendezvous plumbing: N of these run as real child processes (the
multi-process half of "heavy traffic from millions of users" — client
load that does NOT share the cluster's GIL), each simulating
``concurrency`` librados clients over real TCP against a MiniCluster.

Rendezvous protocol (generator.py is the parent):

1. worker connects its clients, prints ``{"ready": true, ...}``;
2. parent, once EVERY worker is ready, writes ``{"go": <epoch>}`` to
   each stdin — all workers start their leg clocks at the same instant,
   so the parent can thrash the cluster at a known offset into a leg;
3. worker runs the legs against ABSOLUTE deadlines derived from the go
   timestamp, then prints one result JSON line (mergeable LegResults).

CLI::

    python -m ceph_tpu_torch.load.load_worker --mon-addr 127.0.0.1:PORT \
        --worker-id 0 --spec '{"pool": ..., "legs": [...], ...}'
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time


def _run_closed_leg(leg, clients, objects, pool, rng, result, deadline,
                    lock) -> None:
    """Closed loop: one op in flight per simulated client; throughput
    self-limits as latency grows (the classic benchmark mode)."""
    from .profiles import get_profile
    prof = get_profile(leg.profile)

    def client_loop(idx: int) -> None:
        cl = clients[idx % len(clients)]
        crng = random.Random(rng.random())
        zipf = _zipf(prof, objects, crng)
        size = prof.size_sampler(crng)
        while time.time() < deadline:
            klass = prof.op_class(crng)
            oid = objects[zipf.sample()]
            with lock:
                result.offered += 1
            t0 = time.perf_counter()
            try:
                if klass == "read":
                    cl.read(pool, oid)
                else:
                    cl.write_full(pool, oid, os.urandom(size()))
            except Exception:  # noqa: BLE001 - thrash legs WILL error
                with lock:
                    result.errors += 1
                continue
            lat_us = (time.perf_counter() - t0) * 1e6
            with lock:
                result.achieved += 1
                result.hist(_hist_key(cl, klass)).record(lat_us)

    threads = [threading.Thread(target=client_loop, args=(i,),
                                daemon=True)
               for i in range(leg.concurrency)]
    t0 = time.time()
    for t in threads:
        t.start()
    # the join budget is AGGREGATE and bounded WELL below a leg width:
    # a few clients stuck in a thrash retry chain must not stall the
    # worker per-thread or eat the NEXT leg's absolute window down to
    # zero — stragglers are daemons, their late completions still land
    # in THIS leg's result object.  (A single op riding out one rpc
    # timeout is the common straggler; multi-leg tenant timelines
    # cannot afford waiting out a whole retry chain.)
    join_by = deadline + min(6.0, max(1.0, leg.duration_s / 4))
    for t in threads:
        t.join(timeout=max(0.0, join_by - time.time()))
    result.wall_s = time.time() - t0


def _run_open_leg(leg, clients, objects, pool, rng, result, deadline,
                  lock) -> None:
    """Open loop: Poisson arrivals at the offered rate regardless of
    completions — latency is measured from the op's INTENDED arrival
    instant, so queueing delay past the knee shows up in the histogram
    (the saturation probe closed loops cannot express)."""
    from concurrent.futures import ThreadPoolExecutor

    from .profiles import get_profile
    prof = get_profile(leg.profile)
    zipf = _zipf(prof, objects, rng)
    size = prof.size_sampler(rng)
    pool_exec = ThreadPoolExecutor(
        max_workers=max(1, leg.concurrency),
        thread_name_prefix=f"load-{leg.name}")
    futures = []
    t_start = time.time()

    def one_op(klass: str, oid: str, nbytes: int, arrival: float,
               idx: int) -> None:
        cl = clients[idx % len(clients)]
        try:
            if klass == "read":
                cl.read(pool, oid)
            else:
                cl.write_full(pool, oid, os.urandom(nbytes))
        except Exception:  # noqa: BLE001
            with lock:
                result.errors += 1
            return
        lat_us = (time.time() - arrival) * 1e6
        with lock:
            result.achieved += 1
            result.hist(_hist_key(cl, klass)).record(max(1.0, lat_us))

    next_at = t_start
    i = 0
    rate = max(0.1, leg.rate)
    # arrivals stop a drain-grace short of the leg boundary, and the
    # drain runs only UP TO the boundary: a saturated step must not
    # push its backlog into the next leg's absolute window (ops still
    # in flight at the boundary stay offered-but-unachieved — exactly
    # the achieved-under-offered signal saturation is detected by)
    grace = min(1.0, max(0.3, leg.duration_s * 0.25))
    gen_until = deadline - grace
    while next_at < gen_until:
        delay = next_at - time.time()
        if delay > 0:
            time.sleep(delay)
        with lock:
            result.offered += 1
        futures.append(pool_exec.submit(
            one_op, prof.op_class(rng), objects[zipf.sample()],
            size(), next_at, i))
        i += 1
        next_at += rng.expovariate(rate) if rate > 0 else 1.0
    while time.time() < deadline and any(not f.done()
                                         for f in futures):
        time.sleep(0.02)
    for f in futures:
        f.cancel()  # boundary reached: drop what never started
    pool_exec.shutdown(wait=False)
    result.wall_s = time.time() - t_start


def _zipf(prof, objects, rng):
    from .profiles import ZipfSampler
    return ZipfSampler(len(objects), prof.zipf_alpha, rng)


def _hist_key(cl, klass: str) -> str:
    """Histogram key for one op: tenant-prefixed ("gold:read") when
    the worker mixes tenants — competing tenants run inside ONE
    process so OS scheduling starves them EQUALLY, and the per-tenant
    split stays readable in the merged result."""
    return getattr(cl, "_hist_prefix", "") + klass


class _RgwClient:
    """RadosClient-shaped adapter over the RgwGateway object path (the
    S3 front-end leg of the harness): the leg runners call
    read/write_full exactly as they do against librados, so the load
    model — profiles, histograms, invariants — is front-end agnostic
    by construction.  Drives the gateway's store methods directly
    (put_object/get_object), the same code path the HTTP handlers
    call, without paying an HTTP hop the QoS layer never sees."""

    def __init__(self, client, pool: str, bucket: str):
        self._client = client
        self._gw = None
        self._pool = pool
        self._bucket = bucket

    def _gateway(self):
        if self._gw is None:
            from ..services.rgw import RgwGateway
            # store-only: the load loop measures the object path, not
            # an HTTP hop the QoS layer never sees (and N listeners
            # per worker would be pure waste)
            self._gw = RgwGateway(self._client, self._pool,
                                  listen=False)
        return self._gw

    def read(self, pool: str, oid: str) -> bytes:
        data, _meta, _code = self._gateway().get_object(self._bucket,
                                                        oid)
        return data

    def write_full(self, pool: str, oid: str, data: bytes) -> int:
        self._gateway().put_object(self._bucket, oid, data)
        return 0

    def close(self) -> None:
        self._client.close()


def _cuda_initialized() -> bool:
    """Whether this process created a CUDA context (torch loaded and
    initialized); False where torch was never imported."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="saturation load worker")
    ap.add_argument("--mon-addr", required=True)
    ap.add_argument("--worker-id", type=int, required=True)
    ap.add_argument("--spec", required=True,
                    help="JSON: {pool, objects, legs: [LegSpec...], "
                         "seed}")
    args = ap.parse_args(argv)

    # a worker is a TCP client and never creates a CUDA context: the
    # generator spawns it with CUDA_VISIBLE_DEVICES empty, which holds
    # for any torch import, this module's or one that ran before it
    # (setting it here would be too late for the latter)
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")

    from ..client.rados import RadosClient
    from ..msg.tcp import TcpNetwork
    from .profiles import LegResult, LegSpec

    spec = json.loads(args.spec)
    legs = [LegSpec.from_dict(d) for d in spec["legs"]]
    objects = [f"o{i:04d}" for i in range(int(spec["objects"]))]
    pool = spec["pool"]
    rng = random.Random(int(spec.get("seed", 0)) * 7919
                        + args.worker_id)
    n_clients = max(l.concurrency for l in legs)
    # a short rpc timeout keeps thrash legs honest: an op in flight to
    # a just-killed OSD re-targets after this, not after 15 idle
    # seconds — the latency lands in the histogram either way
    timeout = float(spec.get("client_timeout", 15.0))

    net = TcpNetwork()
    net.set_addr("mon.0", args.mon_addr)
    # tenant identity: one name for the whole worker, or a LIST
    # assigned round-robin per client — competing tenants sharing one
    # process starve equally under CPU pressure, so their server-side
    # split stays a scheduler measurement, not an OS-scheduling one
    tenants = spec.get("tenants") \
        or ([spec.get("tenant")] if spec.get("tenant") else [])
    multi = len(set(tenants)) > 1
    frontend = spec.get("frontend", "rados")
    clients = []
    try:
        for i in range(n_clients):
            tenant = tenants[i % len(tenants)] if tenants else None
            # connect with a generous deadline (cold cluster + N
            # workers racing startup), then drop to the leg-honest op
            # timeout once the map is in hand
            cl = RadosClient(
                net, f"client.ldw{args.worker_id}x{i}",
                mons=["mon.0"], timeout=max(timeout, 8.0),
                tenant=tenant).connect()
            cl.timeout = timeout
            if frontend == "rgw":
                # S3 front-end leg: same leg runners, the ops go
                # through the RgwGateway object path (bucket == pool
                # name; the scenario pre-created bucket + objects)
                cl = _RgwClient(cl, pool, pool)
            cl._hist_prefix = f"{tenant}:" if (multi and tenant) \
                else ""
            clients.append(cl)
    except Exception as e:  # noqa: BLE001 - report, don't traceback-spam
        print(json.dumps({"worker": args.worker_id, "ok": False,
                          "error": f"connect: {e!r}"}), flush=True)
        return 1

    if _cuda_initialized():
        for cl in clients:
            cl.close()
        net.stop()
        print(json.dumps({"worker": args.worker_id, "ok": False,
                          "error": "a CUDA context was created in the "
                                   "load worker"}), flush=True)
        return 1
    print(json.dumps({"ready": True, "worker": args.worker_id,
                      "clients": n_clients, "tenants": tenants,
                      "frontend": frontend}), flush=True)
    line = sys.stdin.readline()
    try:
        t0 = float(json.loads(line)["go"])
    except (json.JSONDecodeError, KeyError, ValueError, TypeError):
        print(json.dumps({"worker": args.worker_id, "ok": False,
                          "error": f"bad go line: {line!r}"}),
              flush=True)
        return 1

    total = sum(l.duration_s for l in legs)
    # watchdog: a wedged cluster must never hang the worker past the
    # parent's patience (the parent also kills, belt and braces).
    # DAEMON, and cancelled on the way out — a live Timer is a
    # non-daemon thread that would block interpreter shutdown
    watchdog = threading.Timer(max(0.0, t0 - time.time()) + total
                               + 90.0, lambda: os._exit(3))
    watchdog.daemon = True
    watchdog.start()

    results: dict[str, LegResult] = {}
    lock = threading.Lock()
    deadline = t0
    for leg in legs:
        deadline += leg.duration_s
        wait = t0 if not results else None
        if wait is not None and (d := wait - time.time()) > 0:
            time.sleep(d)  # aligned start across every worker
        res = results[leg.name] = LegResult()
        runner = _run_open_leg if leg.mode == "open" \
            else _run_closed_leg
        runner(leg, clients, objects, pool, rng, res, deadline, lock)

    for cl in clients:
        try:
            cl.close()
        except Exception:  # noqa: BLE001
            pass
    net.stop()
    watchdog.cancel()
    print(json.dumps({"worker": args.worker_id, "ok": True,
                      "legs": {n: r.to_dict()
                               for n, r in results.items()}}),
          flush=True)
    sys.stdout.flush()
    # hard exit: open-loop legs leave non-daemon executor threads
    # stuck in timeout/retry chains against a saturated (or thrashed)
    # cluster — the results are already on stdout, and waiting for
    # those threads to drain would read as a deadlock-invariant trip
    # in the parent
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
