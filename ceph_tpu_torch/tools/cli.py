"""`ceph`-style operator CLI.

The role of the reference's `ceph` command (mon command dispatch +
Formatter output — SURVEY.md §2 layer 12).  The cluster is in-process in
round 1, so the CLI operates in two modes:
- as a library: `Cli(cluster)` wraps a live MiniCluster;
- `python -m ceph_tpu_torch.tools.cli <cmd>` boots a demo cluster (vstart
  analogue), runs the command, prints JSON, and tears down.

Commands: status | health | osd dump | osd perf | pg scrub <pool> <seed>
| df | config show.
"""

from __future__ import annotations

import argparse
import json
import sys


class Cli:
    def __init__(self, cluster):
        self.cluster = cluster
        self.client = cluster.client() if not cluster.clients \
            else cluster.clients[0]

    def status(self) -> dict:
        return self.client.status()

    def health(self) -> dict:
        st = self.client.status()
        checks = []
        if st["num_up"] < st["num_osds"]:
            checks.append({"check": "OSD_DOWN",
                           "detail": f"{st['num_osds'] - st['num_up']} "
                                     "osds down"})
        return {"status": st["health"], "checks": checks}

    def osd_dump(self) -> dict:
        return self.client.mon_command({"prefix": "osd dump"})

    def osd_perf(self) -> dict:
        return {o.name: o.admin_command("perf dump")
                for o in self.cluster.osds.values()}

    def df(self) -> dict:
        """Per-pool logical objects + stored (logical) vs used (raw,
        including replica/EC copies) bytes — the `ceph df` split."""
        names = {p.pool_id: p.name
                 for p in self.client.osdmap.pools.values()} \
            if self.client.osdmap else {}
        pools: dict = {}
        logical: dict = {}
        for o in self.cluster.osds.values():
            for cid in o.store.list_collections():
                key = names.get(cid.pool, str(cid.pool))
                p = pools.setdefault(key, {"objects": 0, "stored": 0,
                                           "used": 0})
                seen = logical.setdefault(key, set())
                for oid in o.store.list_objects(cid):
                    size = o.store.stat(cid, oid)["size"]
                    p["used"] += size
                    if oid.name not in seen:
                        seen.add(oid.name)
                        p["objects"] += 1
                        attrs = o.store.getattrs(cid, oid)
                        p["stored"] += int(attrs.get("len", size))
        return {"pools": pools}

    def pg_scrub(self, pool: str, seed: int, deep: bool = True) -> dict:
        res = self.client.scrub_pg(pool, seed, deep=deep)
        return {"pg": f"{pool}.{seed}", "deep": deep,
                "inconsistencies": res.inconsistencies}

    def config_show(self) -> dict:
        return self.cluster.cfg.dump()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("command", nargs="+",
                   help="status | health | osd dump | osd perf | df | "
                        "config show | pg scrub <pool> <seed> | "
                        "daemon <socket-path> <command...>")
    p.add_argument("--osds", type=int, default=4,
                   help="demo cluster size (in-proc vstart)")
    args = p.parse_args(argv)

    # `ceph daemon <asok> <verb...> [key=value ...]`: talk to a LIVE
    # daemon's admin socket — no demo cluster involved.  Bare words form
    # the verb; key=value tokens become arguments (e.g.
    # `daemon x.asok config set name=osd_op_timeout value=9.5`).
    if args.command[0] == "daemon":
        if len(args.command) < 3:
            print("usage: daemon <socket-path> <verb...> [key=value ...]",
                  file=sys.stderr)
            return 2
        from ..utils.admin_socket import admin_request
        words, kwargs = [], {}
        for tok in args.command[2:]:
            if "=" in tok:
                key, val = tok.split("=", 1)
                kwargs[key] = val
            else:
                words.append(tok)
        try:
            out = admin_request(args.command[1], " ".join(words),
                                **kwargs)
        except (OSError, RuntimeError) as e:
            print(f"admin command failed: {e}", file=sys.stderr)
            return 1
        print(json.dumps(out, indent=2, default=str))
        return 0

    # validate BEFORE paying the demo-cluster boot
    cmd = " ".join(args.command)
    simple = {"status", "health", "osd dump", "osd perf", "df",
              "config show"}
    is_scrub = (len(args.command) == 4 and args.command[:2] ==
                ["pg", "scrub"] and args.command[3].isdigit())
    if cmd not in simple and not is_scrub:
        print(f"unknown command: {cmd!r}\n"
              "usage: status | health | osd dump | osd perf | df | "
              "config show | pg scrub <pool> <seed>", file=sys.stderr)
        return 2

    from ..tools.vstart import MiniCluster
    from ..utils.config import default_config

    cfg = default_config()
    cfg.apply_dict({"osd_heartbeat_interval": 0.1})
    cluster = MiniCluster(n_osds=args.osds, cfg=cfg).start()
    try:
        cli = Cli(cluster)
        if cmd == "status":
            out = cli.status()
        elif cmd == "health":
            out = cli.health()
        elif cmd == "osd dump":
            out = cli.osd_dump()
        elif cmd == "osd perf":
            out = cli.osd_perf()
        elif cmd == "df":
            out = cli.df()
        elif cmd == "config show":
            out = cli.config_show()
        else:  # pg scrub <pool> <seed>
            out = cli.pg_scrub(args.command[2], int(args.command[3]))
        print(json.dumps(out, indent=2, default=str))
        return 0
    finally:
        cluster.stop()


if __name__ == "__main__":
    sys.exit(main())
