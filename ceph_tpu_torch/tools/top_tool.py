"""top_tool: live "who is loading the cluster" view over perf queries.

The read face of the dynamic perf-query subsystem (telemetry/
perf_query.py): a standing query registered with ``perf query add``
groups client IO by tenant/pool/pgid/op-class/object-prefix at every
OSD, the per-daemon partials merge monitor-side, and this tool renders
the merged ``perf query report`` as a sorted table — the role of the
reference's `rbd perf image iotop` / `ceph osd perf query` pairing::

    # register a tenant-grouped standing query, then watch it
    python -m ceph_tpu_torch.tools.top_tool --asok /tmp/asok/mon.0.asok ls
    python -m ceph_tpu_torch.tools.top_tool --asok /tmp/asok/mon.0.asok \\
        show --qid 1 --sort bytes --limit 10
    python -m ceph_tpu_torch.tools.top_tool --asok /tmp/asok/mon.0.asok \\
        show --qid 1 --watch 2

``--watch N`` refreshes every N seconds (ANSI home+clear between
frames) until interrupted — the live TUI mode.  Rendering is pure
(``render_top`` takes the report document), so the table formatting
unit-tests without a cluster.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

_SORTS = ("ops", "bytes", "p99")


def _request(asok: str, prefix: str, **kw):
    """One admin round-trip, unwrapping the mon's (errno, data) verb
    shape (the MiniCluster.admin contract)."""
    from ..utils.admin_socket import admin_request
    result = admin_request(asok, prefix, **kw)
    if isinstance(result, list) and len(result) == 2 \
            and isinstance(result[0], int):
        if result[0] != 0:
            raise RuntimeError(f"{prefix}: {result[1]}")
        result = result[1]
    return result


def _fmt_bytes(n: int) -> str:
    v = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if v < 1024 or unit == "TiB":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024
    return f"{v:.1f}TiB"


def render_top(report: dict, sort: str = "ops", limit: int = 0) -> str:
    """The table body for one ``perf query report`` document: one row
    per key (the mon already sorted/limited when asked, but the tool
    re-sorts so a cached document renders consistently under a
    different --sort)."""
    if sort not in _SORTS:
        raise ValueError(f"sort must be one of {_SORTS}, got {sort!r}")
    key_by = report.get("key_by") or []
    rows = list(report.get("rows") or [])
    keyer = {"ops": lambda r: r["ops"],
             "bytes": lambda r: r["bytes_in"] + r["bytes_out"],
             "p99": lambda r: r["p99_us"]}[sort]
    rows.sort(key=keyer, reverse=True)
    if limit > 0:
        rows = rows[:limit]
    key_hdr = "/".join(key_by) or "key"
    key_w = max([len(key_hdr)]
                + [len("/".join(r.get("key") or [])) for r in rows])
    header = (f"{key_hdr:<{key_w}}  {'ops':>10}  {'in':>10}  "
              f"{'out':>10}  {'avg_us':>9}  {'p50_us':>9}  "
              f"{'p99_us':>9}")
    lines = [f"perf query {report.get('qid', '?')} — "
             f"{len(rows)} rows, sorted by {sort}, daemons: "
             f"{', '.join(report.get('daemons') or []) or '(none)'}",
             header, "-" * len(header)]
    for r in rows:
        key = "/".join(r.get("key") or [])
        lines.append(
            f"{key:<{key_w}}  {r['ops']:>10}  "
            f"{_fmt_bytes(r['bytes_in']):>10}  "
            f"{_fmt_bytes(r['bytes_out']):>10}  "
            f"{r['avg_us']:>9.1f}  {r['p50_us']:>9.1f}  "
            f"{r['p99_us']:>9.1f}")
    return "\n".join(lines)


def ls(asok: str) -> dict:
    return _request(asok, "perf query ls")


def show(asok: str, qid: int, sort: str, limit: int) -> str:
    report = _request(asok, "perf query report", qid=qid, sort=sort,
                      **({"limit": limit} if limit else {}))
    return render_top(report, sort=sort, limit=limit)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="live per-tenant/pool/PG IO attribution over "
                    "standing perf queries (perf query report)")
    p.add_argument("--asok", required=True,
                   help="monitor admin socket (the merged store)")
    p.add_argument("--json", action="store_true")
    sub = p.add_subparsers(dest="mode", required=True)
    sub.add_parser("ls", help="standing queries + reporting daemons")
    sp = sub.add_parser("show", help="render one query's merged top")
    sp.add_argument("--qid", type=int, required=True)
    sp.add_argument("--sort", choices=_SORTS, default="ops")
    sp.add_argument("--limit", type=int, default=0)
    sp.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                    help="refresh every SECS seconds until ^C")
    args = p.parse_args(argv)
    if args.mode == "ls":
        doc = ls(args.asok)
        if args.json:
            print(json.dumps(doc))
        else:
            for qid, spec in sorted((doc.get("queries") or {}).items()):
                print(f"query {qid}: key_by="
                      f"{','.join(spec.get('key_by') or [])} "
                      f"counters={','.join(spec.get('counters') or [])} "
                      f"top_n={spec.get('top_n')}")
            print(f"reporting: "
                  f"{', '.join(doc.get('reporting') or []) or '(none)'}")
        return 0
    if args.json:
        report = _request(args.asok, "perf query report", qid=args.qid,
                          sort=args.sort,
                          **({"limit": args.limit} if args.limit
                             else {}))
        print(json.dumps(report))
        return 0
    if args.watch > 0:
        try:
            while True:
                frame = show(args.asok, args.qid, args.sort, args.limit)
                # home + clear-below keeps the refresh flicker-free
                sys.stdout.write("\x1b[H\x1b[J" + frame + "\n")
                sys.stdout.flush()
                time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0
    print(show(args.asok, args.qid, args.sort, args.limit))
    return 0


if __name__ == "__main__":
    sys.exit(main())
