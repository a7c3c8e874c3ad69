#!/usr/bin/env python3
"""Why the rgw saturation smoke's recovery can miss its deadline: run
the smoke's point (``bench_root --saturate --smoke --frontend rgw``:
4 OSDs, EC k=2 m=1, 12 clients through the gateway, a kill and revive)
on the CPU, ``--points`` times with seeds 0, 1, ..., in the port or in
the JAX package (``--pkg ref``), and print for each point
(``--frontend rados``: the point of ``--saturate --smoke``):

- whether recovery completed, and its items;
- the rebuild most often scheduled (object, shard, target OSD, version)
  and how often, beside all rebuilds scheduled;
- where that object's shards are at the end (OSD -> shard, version);
- each fork ``_merge_peer_log`` finds: the primary and the member, the
  version, the primary's and the member's epoch of it, both ``les``
  fences and both log heads;
- each version a primary minted that an up member of its PG already
  holds in its log (a version minted twice), with that member's head;
- every removal of an object's shard under a rollback, with the
  ``MPGRollback`` that made it (``oid``, ``divergent``, ``max_epoch``,
  ``to_version``) and how many OTHER shard positions of the object the
  live OSDs then held; a removal with fewer than k others is one
  nothing can rebuild.

The last line sums the points: recovery completed, removals, removals
with fewer than k others, and versions minted twice.

    python3 experiments/rgw_rollback_trace.py --pkg port --points 6
    JAX_PLATFORMS=cpu python3 experiments/rgw_rollback_trace.py --pkg ref
"""

from __future__ import annotations

import argparse
import collections
import importlib
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: the smoke's pool is EC k=2 m=1
K = 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pkg", choices=("port", "ref"), default="port")
    p.add_argument("--points", type=int, default=1)
    p.add_argument("--first-seed", type=int, default=0)
    p.add_argument("--frontend", choices=("rgw", "rados"), default="rgw",
                   help="rados: the point of --saturate --smoke, whose "
                   "clients write objects through librados")
    args = p.parse_args(argv)
    root = "ceph_tpu_torch" if args.pkg == "port" else "ceph_tpu"
    scenarios = importlib.import_module(f"{root}.load.scenarios")
    dmod = importlib.import_module(f"{root}.osd.daemon")
    ostore = importlib.import_module(f"{root}.osd.objectstore")
    pglog = importlib.import_module(f"{root}.osd.pglog")
    rebuilds: collections.Counter = collections.Counter()
    forks: collections.Counter = collections.Counter()
    mints: collections.Counter = collections.Counter()
    removes: list = []
    t0 = [time.monotonic()]
    cluster = [None]
    here = threading.local()  # the MPGRollback this thread is applying
    d = dmod.OSDDaemon

    real_rebuild = d._rebuild_shard

    def rebuild(self, pgid, name, shard, peer, version, *a, **kw):
        rebuilds[(str(pgid), name, shard, peer, version)] += 1
        return real_rebuild(self, pgid, name, shard, peer, version, *a, **kw)
    d._rebuild_shard = rebuild

    real_merge = d._merge_peer_log

    def merge(self, pgid, m):
        ents = self._pglog(pgid).entries()
        mine = {e.version: e.epoch for e in ents}
        head = ents[-1].version if ents else 0
        if m.lean:
            peer = {m.last_complete: m.head_epoch}
        else:
            peer = dict(m.log_evs or {})
        at = sorted(v for v, pe in peer.items()
                    if pe and mine.get(v, 0) and mine[v] != pe)
        if at:
            v = at[0]
            forks[(str(pgid), self.osd_id, m.from_osd, v, mine[v], peer[v],
                   self._les(pgid), m.les, head,
                   max(peer) if peer else 0, bool(m.lean))] += 1
        return real_merge(self, pgid, m)
    d._merge_peer_log = merge

    real_mint = d._next_version

    def mint(self, pgid):
        v = real_mint(self, pgid)
        c = cluster[0]
        if c is not None and self.osdmap is not None:
            up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
            for osd in up:
                o = c.osds.get(osd) if osd is not None else None
                if o is None or o is self:
                    continue
                pl = o._pglog(pgid)
                raw = pl._raw()
                if pglog._key(v) in raw:
                    ev = pl.last_epoch_version()
                    was = pglog.LogEntry.decode_bytes(raw[pglog._key(v)])
                    mints[(str(pgid), self.osd_id, osd, self._les(pgid),
                           v, was.epoch, ev[1], ev[0])] += 1
        return v
    d._next_version = mint

    real_rollback = d._handle_pg_rollback

    def rollback(self, conn, m):
        outer = getattr(here, "m", None)
        here.m = m
        try:
            return real_rollback(self, conn, m)
        finally:
            here.m = outer
    d._handle_pg_rollback = rollback

    real_queue = ostore.ObjectStore.queue_transaction

    def queue(self, tx, *a, **kw):
        m = getattr(here, "m", None)
        for op in tx.ops:
            if m is None or op[0] != ostore.TxOp.REMOVE \
                    or op[2].shard < 0:
                continue
            name, shard = op[2].name, op[2].shard
            others = set()
            for o in list((cluster[0].osds if cluster[0] else {})
                          .values()):
                if o.store is self:
                    continue
                try:
                    for ob in o.store.list_objects(op[1]):
                        if ob.name == name and ob.shard != shard \
                                and ob.shard >= 0:
                            others.add(ob.shard)
                except Exception:  # noqa: BLE001 - no such collection
                    pass
            removes.append((round(time.monotonic() - t0[0], 2),
                            str(op[1]), name, shard,
                            (m.oid, m.divergent, m.max_epoch,
                             m.to_version), len(others)))
        return real_queue(self, tx, *a, **kw)
    ostore.ObjectStore.queue_transaction = queue

    real_run = scenarios._run_point_on

    def run_on(c, cfg):
        t0[0] = time.monotonic()
        cluster[0] = c
        try:
            row = real_run(c, cfg)
        finally:
            cluster[0] = None
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

    total = collections.Counter()
    for seed in range(args.first_seed, args.first_seed + args.points):
        rebuilds.clear()
        forks.clear()
        mints.clear()
        removes.clear()
        cfg = scenarios.ScenarioConfig(
            profile="small_mixed", procs=2, clients=12, objects=16,
            ramp_rates=(40.0,), ramp_leg_s=1.0, steady_s=2.0, thrash_s=4.0,
            kill_after_s=0.6, recovery_deadline_s=30.0, point_id="smoke",
            mclock={"osd_mclock_recovery_res": 16.0,
                    "osd_mclock_recovery_lim": 32.0}, seed=seed)
        cfg.frontend = args.frontend
        row = scenarios.run_point(cfg)
        tr = row["trace"]
        lost = [r for r in removes if r[5] < K]
        total["points"] += 1
        total["completed"] += bool(row["recovery"]["completed"])
        total["removals"] += len(removes)
        total["removals_below_k"] += len(lost)
        total["minted_twice"] += sum(mints.values())
        total["forks"] += sum(forks.values())
        print(f"{args.pkg} seed {seed}: recovery completed "
              f"{row['recovery']['completed']}, items "
              f"{row['recovery']['items']}; rebuilds {tr['all']}, most "
              f"often {tr['top']}; its shards at the end (osd: shard, v) "
              f"{tr['where']}; forks {sum(forks.values())}, versions "
              f"minted twice {sum(mints.values())}, removals "
              f"{len(removes)} ({len(lost)} with fewer than k={K} "
              f"others)", flush=True)
        for (pg, prim, peer, v, e_p, e_m, les_p, les_m, h_p, h_m,
             lean), n in sorted(forks.items()):
            print(f"  fork x{n}: pg {pg} primary osd.{prim} (v{v}@{e_p}, "
                  f"les {les_p}, head v{h_p}) vs osd.{peer} (v{v}@{e_m}, "
                  f"les {les_m}, head v{h_m}{', lean' if lean else ''})",
                  flush=True)
        for (pg, prim, peer, les_p, v, was, hv, he), n in \
                sorted(mints.items()):
            print(f"  minted x{n} a version a member holds: pg {pg} "
                  f"primary osd.{prim} (les {les_p}) minted v{v}, osd."
                  f"{peer} holds v{v}@{was} (head v{hv}@{he})", flush=True)
        for r in removes:
            oid, div, me, tv = r[4]
            print(f"  removed at {r[0]} s: pg {r[1]} {r[2]} shard {r[3]} "
                  f"({r[5]} other shards live) by MPGRollback(oid="
                  f"{oid!r}, divergent={div}, max_epoch={me}, "
                  f"to_version={tv})", flush=True)
    print(f"{args.pkg} total: recovery completed {total['completed']} of "
          f"{total['points']}; forks {total['forks']}; removals "
          f"{total['removals']}, {total['removals_below_k']} with fewer "
          f"than k={K} other shards; versions minted twice "
          f"{total['minted_twice']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
