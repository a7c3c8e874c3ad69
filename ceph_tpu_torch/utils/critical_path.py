"""Critical-path attribution over span DAGs: which stage BLOCKED the
op, not just which stage ran longest.

``stage_stats`` (trace_tool) answers "how long did each stage take";
this module answers the sharper question a latency investigation
actually needs: along the blocking chain from the root op's end back
to its start, how much wall time does each stage own AFTER its
children are accounted for?  A parent that spends 5 ms waiting on a
2 ms child has 3 ms of critical-path SELF time — that 3 ms is the
parent's own doing (queueing, GIL, host compute) and is where the next
optimization lives.  Concurrent siblings that overlap the chosen chain
contribute nothing: they were not blocking.

Algorithm (the standard backward walk over a span tree): start a
cursor at the root's end; repeatedly descend into the child whose end
is latest but still at-or-before the cursor — any gap between that
child's end and the cursor is time the parent itself burned on the
critical path — then move the cursor to the child's start and recurse
into the child the same way.  Time from the cursor back to the node's
own start, once no child covers it, is also the node's self-time.
Attributed self-times therefore partition the root's wall time (up to
clamping of children that leak past their parent — async completions
racing teardown, or residual clock skew in cross-daemon merges).

``blame`` aggregates many traces' critical paths into the table a perf
PR gets graded against: per-stage total/share/percentiles of
critical-path self-time, sorted by who owns the most blocked time.
"""

from __future__ import annotations

__all__ = ["critical_path", "blame", "format_blame_table"]


def _end_s(n: dict) -> float:
    """A span's end on the shared clock; an in-flight span (end=0)
    extends to start + the dumping tracer's measured dur_ms, so a hung
    stage owns its real age on the path instead of vanishing."""
    if n.get("end"):
        return float(n["end"])
    return float(n["start"]) + float(n.get("dur_ms", 0.0)) / 1e3


def _attribute(node: dict, hi: float, entries: list[dict]) -> None:
    """Attribute the window [node.start, hi] of the blocking chain.
    ``hi`` clamps the node to the portion of the chain it can own —
    a child leaking past its parent (or past an earlier sibling on the
    chain) is trimmed, keeping the attributed times a partition."""
    start = float(node["start"])
    cursor = min(_end_s(node), hi)
    self_s = 0.0
    # latest-ending child first: the backward walk picks, at each
    # cursor position, the child whose end is closest below it
    for child in sorted(node["children"], key=_end_s, reverse=True):
        if cursor <= start:
            break
        c_end = min(_end_s(child), cursor)
        c_start = max(float(child["start"]), start)
        if c_end <= c_start:
            continue  # entirely outside the remaining window
        # gap between the child's end and the cursor: nothing was
        # running below the node there — the node's own self-time
        self_s += max(0.0, cursor - c_end)
        _attribute(child, c_end, entries)
        cursor = c_start
    self_s += max(0.0, cursor - start)
    entries.append({"name": node["name"], "service": node["service"],
                    "span_id": node["span_id"], "start": start,
                    "self_ms": round(self_s * 1e3, 3)})


def critical_path(spans: list[dict]) -> list[dict]:
    """The blocking chain of one merged trace: chronologically ordered
    ``{name, service, span_id, start, self_ms}`` entries whose self_ms
    sum to (at most) the root's wall time.  Of several roots (orphans
    promote to roots when their parent span aged out of a ring), the
    longest one is the op — the others are fragments."""
    from .tracer import build_tree
    tree = build_tree(spans)
    if not tree:
        return []
    root = max(tree, key=lambda n: _end_s(n) - n["start"])
    entries: list[dict] = []
    _attribute(root, _end_s(root), entries)
    entries.sort(key=lambda e: e["start"])
    return entries


def blame(traces: list[list[dict]]) -> dict[str, dict]:
    """Aggregate many traces' critical paths into a per-stage blame
    table: who owns the blocked time, cluster-wide.  Keys are span
    names (the stage vocabulary stage_stats already uses); ``share``
    is the stage's fraction of ALL attributed critical-path time."""
    per: dict[str, list[float]] = {}
    svc: dict[str, str] = {}
    for spans in traces:
        for e in critical_path(spans):
            per.setdefault(e["name"], []).append(e["self_ms"])
            svc.setdefault(e["name"], e["service"])
    grand = sum(sum(v) for v in per.values()) or 1e-9
    out = {}
    for name, vals in per.items():
        vals = sorted(vals)
        total = sum(vals)
        out[name] = {
            "service": svc[name],
            "count": len(vals),
            "self_total_ms": round(total, 3),
            "share": round(total / grand, 4),
            "self_p50_ms": round(
                vals[min(len(vals) - 1,
                         int(0.50 * (len(vals) - 1) + 0.5))], 3),
            "self_max_ms": round(vals[-1], 3),
        }
    return dict(sorted(out.items(),
                       key=lambda kv: -kv[1]["self_total_ms"]))


def format_blame_table(table: dict[str, dict]) -> str:
    """Render-ready blame table, biggest owner of blocked time first."""
    header = (f"{'stage':<24} {'service':<10} {'count':>6} "
              f"{'self_total':>11} {'share':>7} {'self_p50':>9} "
              f"{'self_max':>9}")
    lines = [header, "-" * len(header)]
    for name, s in table.items():
        lines.append(
            f"{name:<24} {s['service']:<10} {s['count']:>6} "
            f"{s['self_total_ms']:>9.3f}ms {s['share']:>6.1%} "
            f"{s['self_p50_ms']:>9.3f} {s['self_max_ms']:>9.3f}")
    return "\n".join(lines)
