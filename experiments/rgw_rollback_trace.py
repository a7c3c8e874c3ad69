#!/usr/bin/env python3
"""Why the rgw saturation smoke's recovery can miss its deadline: run
the smoke's point (``bench_root --saturate --smoke --frontend rgw``:
4 OSDs, EC k=2 m=1, 12 clients through the gateway, a kill and revive)
on the CPU, ``--points`` times with seeds 0, 1, ..., in the port or in
the JAX package (``--pkg ref``), and print for each point:

- whether recovery completed, and its items;
- the rebuild most often scheduled (object, shard, target OSD, version)
  and how often, beside all rebuilds scheduled;
- where that object's shards are at the end (OSD -> shard, version);
- every removal of a shard of the gateway's index objects and the call
  that made it (``_rollback_one`` under ``_handle_pg_rollback``: a
  rollback dropping the copy for a rebuild).

    python3 experiments/rgw_rollback_trace.py --pkg port --points 6
    JAX_PLATFORMS=cpu python3 experiments/rgw_rollback_trace.py --pkg ref
"""

from __future__ import annotations

import argparse
import collections
import importlib
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: the gateway's omap objects whose removals are listed
WATCH = ("rgw_index.sat", "rgw_buckets", "rgw_bilog.sat")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pkg", choices=("port", "ref"), default="port")
    p.add_argument("--points", type=int, default=1)
    args = p.parse_args(argv)
    root = "ceph_tpu_torch" if args.pkg == "port" else "ceph_tpu"
    scenarios = importlib.import_module(f"{root}.load.scenarios")
    dmod = importlib.import_module(f"{root}.osd.daemon")
    ostore = importlib.import_module(f"{root}.osd.objectstore")
    rebuilds: collections.Counter = collections.Counter()
    removes: list = []
    t0 = [time.monotonic()]

    real_rebuild = dmod.OSDDaemon._rebuild_shard

    def rebuild(self, pgid, name, shard, peer, version, *a, **kw):
        rebuilds[(str(pgid), name, shard, peer, version)] += 1
        return real_rebuild(self, pgid, name, shard, peer, version, *a, **kw)
    dmod.OSDDaemon._rebuild_shard = rebuild

    real_queue = ostore.ObjectStore.queue_transaction

    def queue(self, tx, *a, **kw):
        for op in tx.ops:
            if op[0] == ostore.TxOp.REMOVE and op[2].name in WATCH:
                calls = [f.name for f in traceback.extract_stack(limit=4)]
                removes.append((round(time.monotonic() - t0[0], 2),
                                str(op[1]), op[2].name, op[2].shard,
                                ">".join(calls[:-1])))
        return real_queue(self, tx, *a, **kw)
    ostore.ObjectStore.queue_transaction = queue

    real_run = scenarios._run_point_on

    def run_on(c, cfg):
        t0[0] = time.monotonic()
        row = real_run(c, cfg)
        top = rebuilds.most_common(1)
        name = top[0][0][1] if top else None
        where = {}
        for oid, o in c.osds.items():
            for cid in o.store.list_collections():
                for ob in o.store.list_objects(cid):
                    if ob.name == name:
                        where.setdefault(oid, []).append(
                            (ob.shard, o.store.getattrs(cid, ob).get("v")))
        row["trace"] = {"top": top, "all": sum(rebuilds.values()),
                        "where": where}
        return row
    scenarios._run_point_on = run_on

    for seed in range(args.points):
        rebuilds.clear()
        removes.clear()
        cfg = scenarios.ScenarioConfig(
            profile="small_mixed", procs=2, clients=12, objects=16,
            ramp_rates=(40.0,), ramp_leg_s=1.0, steady_s=2.0, thrash_s=4.0,
            kill_after_s=0.6, recovery_deadline_s=30.0, point_id="smoke",
            mclock={"osd_mclock_recovery_res": 16.0,
                    "osd_mclock_recovery_lim": 32.0}, seed=seed)
        cfg.frontend = "rgw"
        row = scenarios.run_point(cfg)
        tr = row["trace"]
        print(f"{args.pkg} seed {seed}: recovery completed "
              f"{row['recovery']['completed']}, items "
              f"{row['recovery']['items']}; rebuilds {tr['all']}, most "
              f"often {tr['top']}; its shards at the end (osd: shard, v) "
              f"{tr['where']}", flush=True)
        for r in removes:
            print(f"  removed at {r[0]} s: pg {r[1]} {r[2]} shard {r[3]} "
                  f"by {r[4]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
