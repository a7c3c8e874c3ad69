"""perf_history: the metrics-history CLI — table + sparkline views
over the in-cluster time series.

The read side of utils/metrics_history.py: every daemon keeps a
fixed-budget ring of perf-registry snapshots and ships it to the
monitor, so "what was mclock_qwait_us doing five minutes ago" is
answerable without an external TSDB.  This tool talks to either
surface over the shared admin-socket resolver — an OSD socket serves
its local ring (``dump_metrics_history`` / ``metrics_query`` daemon
verbs), the mon socket serves the merged store (same verbs as mon
commands)::

    # what registries/counters does the cluster hold history for?
    python -m ceph_tpu_torch.tools.perf_history --asok /tmp/asok/mon.0.asok ls

    # one counter's trajectory: per-interval rate sparkline + stats
    python -m ceph_tpu_torch.tools.perf_history --asok /tmp/asok/mon.0.asok \\
        show --registry osd.0 --counter op_w --since-s 300

    # window query (delta/rate; histograms add p50/p99)
    python -m ceph_tpu_torch.tools.perf_history --asok /tmp/asok/mon.0.asok \\
        query --registry osd.0 --counter mclock_qwait_us_client \\
        --since-s 120 --until-s 60
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.metrics_history import counter_delta, query_samples

SPARK = "▁▂▃▄▅▆▇█"


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


def sparkline(values: list[float], width: int = 48) -> str:
    """Unicode block sparkline, downsampled to ``width`` columns."""
    if not values:
        return ""
    if len(values) > width:
        # bucket-mean downsample keeps the envelope honest
        step = len(values) / width
        binned = []
        for i in range(width):
            lo = int(i * step)
            hi = max(lo + 1, int((i + 1) * step))
            chunk = values[lo:hi]
            binned.append(sum(chunk) / len(chunk))
        values = binned
    hi = max(values)
    if hi <= 0:
        return SPARK[0] * len(values)
    return "".join(SPARK[min(len(SPARK) - 1,
                             int(v / hi * (len(SPARK) - 1) + 0.5))]
                   for v in values)


def interval_rates(samples: list[dict], counter: str) -> list[float]:
    """Per-interval rate series of one counter across consecutive
    snapshots (the sparkline feed)."""
    rows = [s for s in samples if counter in (s.get("counters") or {})]
    rates = []
    for a, b in zip(rows, rows[1:]):
        dt = max(1e-9, float(b["ts"]) - float(a["ts"]))
        d = counter_delta(a["counters"][counter],
                          b["counters"][counter])
        rates.append(d["delta"] / dt)
    return rates


def ls(asok: str) -> dict:
    """Registries + counters the history holds (newest sample each)."""
    doc = _request(asok, "dump_metrics_history", max=1)
    out = {}
    for reg, rows in sorted((doc.get("registries") or {}).items()):
        out[reg] = sorted((rows[-1].get("counters") or {}).keys()) \
            if rows else []
    return out


def show(asok: str, registry: str, counter: str,
         since_s: float, width: int = 48) -> str:
    """Table + sparkline for one counter over the window."""
    doc = _request(asok, "dump_metrics_history", registry=registry)
    rows = (doc.get("registries") or {}).get(registry) or []
    import time as _time
    cutoff = _time.time() - since_s
    rows = [s for s in rows if float(s.get("ts", 0)) >= cutoff]
    q = query_samples(rows, counter)
    lines = [f"{registry}/{counter} over the last {since_s:g}s "
             f"({q.get('samples', 0)} samples)"]
    if "error" in q:
        lines.append(f"  {q['error']}")
        return "\n".join(lines)
    rates = interval_rates(rows, counter)
    lines.append(f"  delta {q['delta']:g}   rate "
                 f"{q['rate_per_s']:g}/s   span {q['span_s']:g}s")
    if "p50" in q:
        lines.append(f"  p50 {q['p50']:.1f}   p99 {q['p99']:.1f}   "
                     f"count_delta {q.get('count_delta', 0)}")
    # bucket exemplars: sampled trace_ids captured in-window, the
    # metrics->traces pivot (feed these to trace_tool --exemplar)
    for b, ring in sorted((q.get("exemplars") or {}).items()):
        ids = ", ".join(f"{e['trace_id']:016x}@{e['value']:.0f}us"
                        for e in ring[:3])
        lines.append(f"  exemplar le=2^{b}: {ids}")
    if rates:
        lines.append(f"  rate/interval |{sparkline(rates, width)}| "
                     f"max {max(rates):g}/s")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="query the in-cluster metrics history "
                    "(dump_metrics_history / metrics_query verbs)")
    p.add_argument("--asok", required=True,
                   help="daemon admin socket (mon.0 = merged store, "
                        "osd.N = local ring)")
    p.add_argument("--json", action="store_true")
    sub = p.add_subparsers(dest="mode", required=True)
    sub.add_parser("ls", help="registries + counters held")
    sp = sub.add_parser("show", help="table + sparkline for a counter")
    sp.add_argument("--registry", required=True)
    sp.add_argument("--counter", required=True)
    sp.add_argument("--since-s", type=float, default=300.0)
    sp.add_argument("--width", type=int, default=48)
    qp = sub.add_parser("query", help="window delta/rate/quantiles")
    qp.add_argument("--registry", required=True)
    qp.add_argument("--counter", required=True)
    qp.add_argument("--since-s", type=float, default=60.0)
    qp.add_argument("--until-s", type=float, default=0.0)
    args = p.parse_args(argv)
    if args.mode == "ls":
        doc = ls(args.asok)
        if args.json:
            print(json.dumps(doc))
        else:
            for reg, counters in doc.items():
                print(f"{reg}: {len(counters)} counters")
                for c in counters:
                    print(f"  {c}")
        return 0
    if args.mode == "show":
        if args.json:
            doc = _request(args.asok, "metrics_query",
                           registry=args.registry, counter=args.counter,
                           since_s=args.since_s)
            print(json.dumps(doc))
        else:
            print(show(args.asok, args.registry, args.counter,
                       args.since_s, width=args.width))
        return 0
    doc = _request(args.asok, "metrics_query", registry=args.registry,
                   counter=args.counter, since_s=args.since_s,
                   until_s=args.until_s)
    print(json.dumps(doc) if args.json
          else "\n".join(f"{k}: {v}" for k, v in sorted(doc.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
