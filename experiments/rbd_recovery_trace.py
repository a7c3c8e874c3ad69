#!/usr/bin/env python3
"""Trace ``chip_smoke.py`` phase 20's image leg on the CPU: an RBD image
whose objects all place in one PG of a tpu k=8 m=3 pool on 14 OSDs,
written, overwritten around a snapshot, then that PG's first two OSDs
(its primary among them) lost and the head read back while recovery
runs.  One run a seed; for each it prints:

- the leg's outcome (passed, or the error the leg raised);
- every object of the head read back wrong, the chunks the primary
  decoded it from (shard -> version, CRC) and the shards the OSDs hold
  at that moment, so the wrong chunk shows by shard and holder;
- every op the osd_op_timeout sweep failed: the OSD, the object, a
  client read or a recovery fetch, the shards asked for and from whom,
  and the shards that had answered;
- every read of an image object that failed with a RADOS error, which
  the image turns into zeros (``Image._read_piece``: a sparse hole);
- the recovery fetches of each lost shard (most, and all).

``--no-claim`` lets every inventory round fetch every missing shard
again, as the daemon did before its rebuild claims.

    python3 experiments/rbd_recovery_trace.py --seeds 0 1 2 \
        --objects 128 --object-mib 1
    python3 experiments/rbd_recovery_trace.py --device cuda --seeds 0 1
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import threading
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--objects", type=int, default=128)
    p.add_argument("--object-mib", type=int, default=4)
    p.add_argument("--gateway-mib", type=int, default=8)
    p.add_argument("--overwrites", type=int, default=2048)
    p.add_argument("--snap-overwrites", type=int, default=256)
    p.add_argument("--pg-num", type=int, default=64)
    p.add_argument("--op-timeout", type=float, default=None,
                   help="osd_op_timeout (OSD_CONFIG's 20 s by default)")
    p.add_argument("--no-claim", action="store_true")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    p.add_argument("--max-rss-gib", type=float, default=24.0,
                   help="end the run when this process holds more")
    a = p.parse_args(argv)

    import numpy as np
    import torch

    torch.set_num_threads(1)
    import chip_smoke
    from ceph_tpu_torch.client.rados import RadosError
    from ceph_tpu_torch.osd import daemon
    from ceph_tpu_torch.services import rbd
    from ceph_tpu_torch.tools import vstart

    def guard():
        # the storm without claims grows quadratically with the objects
        while True:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
            if rss > a.max_rss_gib * (1 << 30):
                print(f"ended: {rss / (1 << 30):.1f} GiB resident",
                      flush=True)
                os._exit(3)
            time.sleep(1.0)
    threading.Thread(target=guard, daemon=True).start()

    OSD = daemon.OSDDaemon
    lock = threading.Lock()
    state: dict = {}

    def reset():
        state.update(cluster=None, reads={}, fans={}, errors=[],
                     fetches=collections.Counter(), expired=[], wrong=[])

    real_start = vstart.MiniCluster.start

    def start(self, *args, **kw):
        state["cluster"] = self
        return real_start(self, *args, **kw)

    real_fan = OSD._fan_shard_reads

    def fan(self, tid, pgid, oid, up, extents=None, trace=None,
            klass="client"):
        with lock:
            state["fans"][(self.osd_id, tid)] = list(up)
            if klass == "recovery":
                state["fetches"][oid] += 1
        return real_fan(self, tid, pgid, oid, up, extents=extents,
                        trace=trace, klass=klass)

    real_finish = OSD._finish_ec_read

    def finish(self, pr):
        if pr.on_done is None and pr.client and \
                pr.oid.startswith("rbd_data"):
            seen = {s: (pr.shard_vers.get(s), zlib.crc32(c.tobytes()),
                        int(c.size)) for s, c in pr.chunks.items()}
            with lock:
                state["reads"].setdefault(pr.oid, collections.deque(
                    maxlen=3)).append((self.osd_id, round(
                        time.time() - pr.stamp, 3), seen))
        return real_finish(self, pr)

    real_sweep = OSD._sweep_pending

    def sweep(self, now, max_age=None):
        age = self.cfg["osd_op_timeout"] if max_age is None else max_age
        with self._pending_lock:
            old = [(tid, pr) for tid, pr in self._pending_reads.items()
                   if now - pr.stamp > age]
            for tid, pr in old:
                state["expired"].append({
                    "osd": self.osd_id, "oid": pr.oid,
                    "kind": "recovery" if pr.on_done else "client",
                    "asked": state["fans"].get((self.osd_id, tid)),
                    "answered": sorted(pr.chunks), "replies": pr.replies,
                    "of": pr.total_shards, "want_all": pr.want_all})
            wexp = sum(1 for pw in self._pending_writes.values()
                       if now - pw.stamp > age)
            if wexp:
                state["expired"].append({"osd": self.osd_id,
                                         "writes": wexp})
        return real_sweep(self, now, max_age)

    def piece(self, oid, off, length):
        # Image._read_piece, with each error it turns into zeros kept
        try:
            data = self.client.read(self.pool, oid, offset=off,
                                    length=length)
        except RadosError as e:
            with lock:
                state["errors"].append((oid, str(e)))
            data = b""
        return data + b"\0" * (length - len(data))

    real_differ = chip_smoke._blocks_differ

    def differ(got, image, at, before, after):
        why = real_differ(got, image, at, before, after)
        obj = a.object_mib << 20
        oid = f"rbd_data.vm.{at // obj:016x}"
        c = state["cluster"]
        held = {}
        for osd in list(c.osds.values()):
            for cid in osd.store.list_collections():
                for o in osd.store.list_objects(cid):
                    if o.name == oid and o.generation < 0:
                        at_ = osd.store.getattrs(cid, o)
                        held[f"osd.{osd.osd_id}/{o.shard}"] = (
                            int(at_.get("v", -1)), zlib.crc32(
                                osd.store.read(cid, o).to_bytes()))
        with lock:
            state["wrong"].append({"oid": oid, "why": why,
                                   "reads": list(state["reads"].get(
                                       oid, [])), "held": held})
        return why

    vstart.MiniCluster.start = start
    OSD._fan_shard_reads = fan
    OSD._finish_ec_read = finish
    OSD._sweep_pending = sweep
    rbd.Image._read_piece = piece
    chip_smoke._blocks_differ = differ
    if a.no_claim:
        OSD._claim_rebuild = lambda self, *args, **kw: True
    if a.op_timeout is not None:
        chip_smoke.OSD_CONFIG["osd_op_timeout"] = a.op_timeout

    if a.device == "cuda":
        chip_smoke.phase_device()  # the card's name and power limit
        chip_smoke.phase_build()
    obj = a.object_mib << 20
    over = dict(image=a.objects * obj, object_size=obj, threads=8,
                gateway=a.gateway_mib << 20, request=1 << 20,
                overwrites=a.overwrites, snap_overwrites=a.snap_overwrites,
                pg_num=a.pg_num)
    bad = 0
    for seed in a.seeds:
        reset()
        t0 = time.perf_counter()
        try:
            _counts, res = chip_smoke.phase_services_rbd(
                torch.device(a.device), np.random.default_rng(seed),
                **over)
            outcome = (f"passed: degraded reads {res['degraded_s']:.1f} s,"
                       f" recovery {res['recovery_s']:.1f} s, faults "
                       f"{res['faults']}")
        except AssertionError as e:
            bad += 1
            outcome = f"FAILED: {e}"
        fetches = [v for k, v in state["fetches"].items()
                   if k.startswith("rbd_data")]
        print(f"seed {seed}: {a.objects} objects of {a.object_mib} MiB, "
              f"claims {'off' if a.no_claim else 'on'}: {outcome}; "
              f"{time.perf_counter() - t0:.1f} s; recovery fetches "
              f"{sum(fetches)}, at most {max(fetches, default=0)} an "
              f"object", flush=True)
        for w in state["wrong"]:
            print("  wrong read:", json.dumps(w, default=str), flush=True)
        errs = [e for e in state["errors"] if e[0].startswith("rbd_data")]
        print(f"  image reads that failed (zeros): {len(errs)} "
              f"{errs[:6]}", flush=True)
        kinds = collections.Counter(
            (e.get("kind", "write"), e["osd"]) for e in state["expired"])
        print(f"  timed out: {dict(kinds)}", flush=True)
        for e in state["expired"][:6]:
            print("  ", json.dumps(e, default=str), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
