"""Critical-path trace tooling: merge per-daemon span rings, print a
waterfall, aggregate per-stage self-time.

The collector+analysis half of the tracing story (utils/tracer.py is
the recording half): every daemon keeps a bounded local span ring and
answers ``dump_tracing`` over its admin socket; this tool plays the
jaeger-query role — merge the rings for one trace id into a tree,
render it as a text waterfall (offset/duration bars per span), and
aggregate MANY traces into per-stage p50/p99 tables of total and SELF
time (a span's duration minus its children's — the time the stage
itself burned, which is what finds the next optimization; the EC
batcher measurement papers in PAPERS.md live on exactly this
decomposition).

CLI::

    python -m ceph_tpu_torch.tools.trace_tool --asok-dir /tmp/asok \
        --trace-id 123456

queries every ``*.asok`` in the directory, merges the rings (clock
skew normalized via the mon's ``clock_skew`` estimates), prints the
waterfall, the per-stage table, and the critical-path blocking chain.
``--exemplar <trace_id>`` is the metrics->traces pivot: feed it a
trace_id straight out of a histogram bucket exemplar
(``metrics_query`` / perf_history / the OpenMetrics scrape).
``--blame`` aggregates every complete trace in the rings into the
per-stage critical-path blame table (utils/critical_path.py).  The library half (merge_spans /
waterfall / stage_stats) is what ``bench_root --ec-batch --trace`` and
the tests drive directly.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from ..utils.critical_path import (blame, critical_path,
                                   format_blame_table)
from ..utils.tracer import build_tree


def merge_spans(span_lists, skew: dict | None = None) -> list[dict]:
    """Merge per-daemon/per-client span dumps for one trace, dropping
    duplicates (a collector may see the same ring twice).  ``skew``
    maps service names to estimated wall-clock offsets in seconds
    (mon ``clock_skew`` command / ``daemon_clock_skew_s`` gauge) —
    each span's timestamps are shifted onto the monitor's clock, so a
    cross-daemon waterfall's bars line up even when daemon clocks
    drift (span dicts are copied; the source rings stay untouched)."""
    seen: set[int] = set()
    out: list[dict] = []
    for spans in span_lists:
        for s in spans:
            if s["span_id"] not in seen:
                seen.add(s["span_id"])
                off = (skew or {}).get(s.get("service"))
                if off:
                    s = dict(s, start=s["start"] - off,
                             end=(s["end"] - off) if s["end"] else 0.0)
                out.append(s)
    return out


def _walk(nodes, depth=0):
    for n in nodes:
        yield n, depth
        yield from _walk(n["children"], depth + 1)


def waterfall(spans: list[dict], width: int = 40) -> str:
    """Text waterfall for one trace: the span tree with per-span
    offset/duration bars on a shared time axis (roots at t=0)."""
    tree = build_tree(merge_spans([spans]))
    if not tree:
        return "(no spans)"
    t0 = min(n["start"] for n, _ in _walk(tree))
    t1 = max((n["end"] or n["start"]) for n, _ in _walk(tree))
    total = max(t1 - t0, 1e-9)
    rows = []
    for n, depth in _walk(tree):
        off = n["start"] - t0
        dur = ((n["end"] or t1) - n["start"])
        left = int(off / total * width)
        bar = max(1, int(dur / total * width))
        lane = " " * left + "#" * min(bar, width - left)
        name = "  " * depth + n["name"]
        flags = " (in flight)" if n.get("in_flight") else ""
        tag = ""
        if "flush_span" in n.get("tags", {}):
            tag = f" ->flush:{n['tags']['flush_span'] & 0xFFFF:x}"
        rows.append((name, lane, off * 1e3, dur * 1e3,
                     n["service"], flags + tag))
    namew = max(len(r[0]) for r in rows)
    lines = [f"trace {tree[0]['trace_id']}: "
             f"{len(rows)} spans, {total * 1e3:.3f} ms total"]
    for name, lane, off, dur, svc, extra in rows:
        lines.append(f"{name:<{namew}} |{lane:<{width}}| "
                     f"+{off:8.3f}ms {dur:8.3f}ms  {svc}{extra}")
    return "\n".join(lines)


def _dur_ms(n: dict) -> float:
    """A span's duration for aggregation: finished spans from their
    own start/end; an in-flight span (end=0 — the hung-op case the
    dumps exist to surface) uses the dur_ms the dumping tracer
    measured to its now, so hung stages show their real age instead
    of a zero that would point the operator at the wrong stage."""
    if n.get("end"):
        return (n["end"] - n["start"]) * 1e3
    return float(n.get("dur_ms", 0.0))


def self_times(spans: list[dict]) -> list[dict]:
    """Per span: total duration and SELF time (duration minus the sum
    of direct children's durations, floored at 0 — overlapping async
    children can exceed the parent's wall time)."""
    tree = build_tree(merge_spans([spans]))
    out = []
    for n, _ in _walk(tree):
        dur = _dur_ms(n)
        child = sum(_dur_ms(c) for c in n["children"])
        out.append({"name": n["name"], "service": n["service"],
                    "dur_ms": dur, "self_ms": max(0.0, dur - child)})
    return out


def _pct(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


def stage_stats(traces: list[list[dict]]) -> dict[str, dict]:
    """Aggregate many traces into per-stage (span name) statistics:
    count, p50/p99 of total duration and of self time.  THE table a
    perf PR gets graded against — 'where does an op's latency go' with
    enough samples for tail behavior."""
    per_stage: dict[str, list[dict]] = {}
    for spans in traces:
        for row in self_times(spans):
            per_stage.setdefault(row["name"], []).append(row)
    out = {}
    for name, rows in sorted(per_stage.items()):
        durs = sorted(r["dur_ms"] for r in rows)
        selfs = sorted(r["self_ms"] for r in rows)
        out[name] = {
            "count": len(rows),
            "p50_ms": round(_pct(durs, 0.50), 3),
            "p99_ms": round(_pct(durs, 0.99), 3),
            "self_p50_ms": round(_pct(selfs, 0.50), 3),
            "self_p99_ms": round(_pct(selfs, 0.99), 3),
        }
    return out


def format_stage_table(stats: dict[str, dict]) -> str:
    """The per-stage decomposition table, render-ready."""
    header = (f"{'stage':<24} {'count':>6} {'p50_ms':>9} {'p99_ms':>9} "
              f"{'self_p50':>9} {'self_p99':>9}")
    lines = [header, "-" * len(header)]
    for name, s in stats.items():
        lines.append(f"{name:<24} {s['count']:>6} {s['p50_ms']:>9.3f} "
                     f"{s['p99_ms']:>9.3f} {s['self_p50_ms']:>9.3f} "
                     f"{s['self_p99_ms']:>9.3f}")
    return "\n".join(lines)


def collect_skew(asok_dir: str) -> dict[str, float]:
    """Fetch the monitor's per-daemon clock-skew estimates (the
    ``clock_skew`` mon command, fed by stats-report send stamps) from
    whichever socket in the directory answers it.  Daemon sockets
    raise on the unknown verb and are skipped; no mon = no
    normalization (empty dict)."""
    from ..utils.admin_socket import admin_request
    for path in sorted(glob.glob(os.path.join(asok_dir, "*.asok"))):
        try:
            doc = admin_request(path, "clock_skew")
        except (OSError, RuntimeError):
            continue
        if isinstance(doc, list) and len(doc) == 2 \
                and isinstance(doc[0], int):
            # mon command shape: (errno, data)
            doc = doc[1] if doc[0] == 0 else None
        if isinstance(doc, dict):
            return {str(k): float(v) for k, v in doc.items()}
    return {}


def collect_from_asok(asok_dir: str, trace_id: int, skip: tuple = (),
                      skew: dict | None = None) -> list[dict]:
    """Query every daemon admin socket in the directory for its local
    spans of one trace and merge (the operator-facing collector).
    ``skip`` names socket basenames to leave out — a daemon collecting
    a trace for its own flight recorder already has its local ring and
    must not round-trip to itself.  ``skew`` (service -> seconds, see
    ``collect_skew``) aligns per-daemon clocks in the merge."""
    from ..utils.admin_socket import admin_request
    dumps = []
    for path in sorted(glob.glob(os.path.join(asok_dir, "*.asok"))):
        if os.path.basename(path) in skip:
            continue
        try:
            spans = admin_request(path, "dump_tracing",
                                  trace_id=trace_id)
        except (OSError, RuntimeError):
            continue  # mon sockets / dead daemons: skip, keep merging
        if isinstance(spans, list):
            # a mon socket answers unknown verbs with an (errno,
            # detail) pair — also a list; only span dicts merge
            dumps.append([s for s in spans
                          if isinstance(s, dict) and "span_id" in s])
    return merge_spans(dumps, skew=skew)


def collect_all_traces(asok_dir: str,
                       skew: dict | None = None) -> list[list[dict]]:
    """Every COMPLETE trace currently held in the cluster's span rings
    (the ``--blame`` population): dump each daemon's full ring, merge
    with skew alignment, group by trace_id, and keep traces whose root
    span finished — in-flight ops would blame their current stage for
    time it has not lost yet."""
    from ..utils.admin_socket import admin_request
    dumps = []
    for path in sorted(glob.glob(os.path.join(asok_dir, "*.asok"))):
        try:
            spans = admin_request(path, "dump_tracing")
        except (OSError, RuntimeError):
            continue
        if isinstance(spans, list):
            dumps.append([s for s in spans
                          if isinstance(s, dict) and "span_id" in s])
    by_trace: dict[int, list[dict]] = {}
    for s in merge_spans(dumps, skew=skew):
        by_trace.setdefault(s["trace_id"], []).append(s)
    out = []
    for tid in sorted(by_trace):
        spans = by_trace[tid]
        # roots as build_tree sees them: true roots plus orphans whose
        # parent lives in an uncollected ring (the client tracer has
        # no admin socket, so its children promote to roots here)
        ids = {s["span_id"] for s in spans}
        roots = [s for s in spans
                 if not s["parent_id"] or s["parent_id"] not in ids]
        if roots and all(s["end"] for s in roots):
            out.append(spans)
    return out


def slow_op_report(asok: str, max_ops: int = 0) -> list[dict]:
    """The flight-recorder read side: fetch one OSD's
    ``dump_historic_slow_ops`` (traces attached by the daemon via the
    shared resolver) and return render-ready records — the historic
    entry plus its span list."""
    from ..utils.admin_socket import admin_request
    entries = admin_request(asok, "dump_historic_slow_ops")
    if not isinstance(entries, list):
        return []
    out = [e for e in entries if isinstance(e, dict)]
    return out[-max_ops:] if max_ops else out


def format_slow_ops(entries: list[dict], width: int = 40) -> str:
    """Waterfall per historic slow op (the dump_historic_slow_ops ->
    trace_tool workflow): op description + duration, then the merged
    trace rendered like any other."""
    if not entries:
        return "(no historic slow ops)"
    blocks = []
    for e in entries:
        head = (f"slow op: {e.get('description', '?')} "
                f"({e.get('age_seconds', 0):.3f}s)")
        spans = e.get("trace") or []
        blocks.append(head + "\n" + (waterfall(spans, width=width)
                                     if spans else "(no trace retained)"))
    return "\n\n".join(blocks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="merge per-daemon span rings for a trace id and "
                    "print a waterfall + per-stage decomposition; or "
                    "--slow-ops to replay an OSD's slow-op flight "
                    "recorder")
    p.add_argument("--asok-dir",
                   help="directory of daemon *.asok admin sockets")
    p.add_argument("--trace-id", type=int)
    p.add_argument("--exemplar", type=int, metavar="TRACE_ID",
                   help="replay an exemplar trace_id (from a histogram "
                        "bucket / metrics_query): waterfall + the "
                        "critical-path blocking chain")
    p.add_argument("--blame", action="store_true",
                   help="aggregate every complete trace in the span "
                        "rings into a per-stage critical-path blame "
                        "table")
    p.add_argument("--no-skew", action="store_true",
                   help="skip mon clock-skew normalization of merged "
                        "span timestamps")
    p.add_argument("--slow-ops", metavar="ASOK",
                   help="an OSD admin socket: print every historic "
                        "slow op with its retained trace waterfall")
    p.add_argument("--json", action="store_true",
                   help="emit the merged spans + stage stats as JSON")
    args = p.parse_args(argv)
    if args.slow_ops:
        entries = slow_op_report(args.slow_ops)
        if args.json:
            print(json.dumps(entries, default=str))
        else:
            print(format_slow_ops(entries))
        return 0 if entries else 1
    if args.exemplar is not None and args.trace_id is None:
        args.trace_id = args.exemplar
    if not args.asok_dir or (args.trace_id is None and not args.blame):
        p.error("--asok-dir and --trace-id/--exemplar required "
                "(or --blame / --slow-ops)")
    skew = {} if args.no_skew else collect_skew(args.asok_dir)
    if args.blame:
        traces = collect_all_traces(args.asok_dir, skew=skew)
        table = blame(traces)
        if args.json:
            print(json.dumps({"traces": len(traces), "blame": table}))
        else:
            print(f"blame over {len(traces)} complete traces:")
            print(format_blame_table(table))
        return 0 if traces else 1
    spans = collect_from_asok(args.asok_dir, args.trace_id, skew=skew)
    if not spans:
        print(f"no spans for trace {args.trace_id}", file=sys.stderr)
        return 1
    stats = stage_stats([spans])
    path = critical_path(spans)
    if args.json:
        print(json.dumps({"spans": spans, "stages": stats,
                          "critical_path": path}, default=str))
    else:
        print(waterfall(spans))
        print()
        print(format_stage_table(stats))
        print()
        print("critical path (blocking chain, self-time each):")
        for e in path:
            print(f"  {e['name']:<24} {e['service']:<10} "
                  f"{e['self_ms']:>9.3f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
