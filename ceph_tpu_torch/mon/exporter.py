"""Prometheus exporter: cluster + per-daemon metrics over HTTP.

The capability of the reference's metrics path (mgr prometheus module +
standalone src/exporter/ DaemonMetricCollector.cc scraping admin
sockets): an HTTP endpoint serving /metrics in the prometheus text
exposition format, fed by the in-process PerfCounters collection and
the monitor's cluster state (map epoch, osd up/in, aggregated usage).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.perf import global_perf

_PREFIX = "ceph_tpu"


def _sanitize(name: str) -> str:
    return "".join(ch if ch.isalnum() or ch == "_" else "_"
                   for ch in name)


def render_metrics(mon=None, openmetrics: bool = False) -> str:
    """The prometheus text format body (flat counters + labeled
    per-daemon series, sum/count pairs for timers).

    Samples are COLLECTED first and rendered grouped per metric: the
    text exposition format requires every sample of a metric in one
    group under a single HELP/TYPE header — the old per-daemon outer
    loop interleaved one metric's series across daemons, which strict
    parsers (promtool, the client_python text parser) reject.

    ``openmetrics=True`` renders the OpenMetrics 1.0 flavor instead:
    identical families and sample lines, a ``# EOF`` terminator, and
    histogram ``_bucket`` lines annotated with their bucket's newest
    exemplar (``# {trace_id="..."} value ts``) — the classic 0.0.4
    exposition never carries exemplars, so exemplar-free scrapes stay
    byte-identical to the pre-exemplar schema."""
    # metric -> {"help", "type", "samples": [(labels, value, exemplar)]}
    groups: dict[str, dict] = {}

    def emit(metric: str, value, labels: dict | None = None,
             help_: str | None = None, typ: str = "gauge",
             exemplar: tuple | None = None):
        m = f"{_PREFIX}_{_sanitize(metric)}"
        g = groups.get(m)
        if g is None:
            g = groups[m] = {"help": help_ or f"{metric}",
                             "type": typ, "samples": []}
        g["samples"].append((dict(labels) if labels else {}, value,
                             exemplar))

    if mon is not None:
        # snapshot under the monitor lock: the HTTP thread must not
        # iterate dicts the dispatch thread mutates mid-scrape
        with mon._lock:
            up = sum(1 for o in mon.osdmap.osds.values() if o.up)
            in_ = sum(1 for o in mon.osdmap.osds.values()
                      if o.in_cluster)
            n_osds = len(mon.osdmap.osds)
            n_pools = len(mon.osdmap.pools)
            epoch = mon.osdmap.epoch
            stats_copy = {i: dict(s)
                          for i, s in mon._osd_stats.items()}
        emit("osdmap_epoch", epoch,
             help_="current OSDMap epoch", typ="counter")
        emit("osd_total", n_osds, help_="known OSDs")
        emit("osd_up", up, help_="up OSDs")
        emit("osd_in", in_, help_="in OSDs")
        emit("pools", n_pools, help_="pools")
        emit("mon_is_leader", 1 if mon.is_leader else 0,
             help_="1 when this monitor leads the quorum")
        agg: dict[str, float] = {}
        for stats in stats_copy.values():
            for k, v in stats.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    agg[k] = agg.get(k, 0) + v
        for k, v in sorted(agg.items()):
            emit(f"cluster_{k}", v,
                 help_=f"sum of per-osd reported {k}")
        # SLOW_OPS per daemon (the health mux's exporter face): ops
        # currently blocked past osd_op_complaint_time, as reported in
        # the daemon's latest stats heartbeat
        for i, stats in sorted(stats_copy.items()):
            emit("daemon_slow_ops", int(stats.get("slow_ops", 0)),
                 {"daemon": f"osd.{i}"},
                 help_="ops currently slower than "
                       "osd_op_complaint_time", typ="gauge")
        # metrics-history staleness (the in-cluster TSDB's liveness
        # face): seconds since each daemon's newest merged snapshot —
        # the gauge the prom recording rules alert on (a wedged
        # sampler or partitioned daemon goes stale here first)
        hist = getattr(mon, "metrics_history", None)
        if hist is not None:
            for daemon, age in sorted(hist.staleness().items()):
                emit("metrics_history_staleness_s", age,
                     {"daemon": daemon},
                     help_="seconds since the daemon's newest merged "
                           "metrics-history snapshot", typ="gauge")
        # per-daemon clock skew estimated from stats-report send
        # stamps (mon receive time - daemon sent_at, one-way): the
        # offset trace_tool subtracts when merging cross-daemon
        # waterfalls
        skew = getattr(mon, "clock_skew", None)
        if callable(skew):
            for daemon, off in sorted(skew().items()):
                emit("daemon_clock_skew_s", off, {"daemon": daemon},
                     help_="estimated daemon wall-clock offset vs the "
                           "monitor (stats-report one-way delay "
                           "included)", typ="gauge")
        # progress gauges (the mgr progress module's exporter face):
        # one series per derived item, present while the item is live
        # (or lingering complete), GONE once it clears
        prog = getattr(mon, "progress", None)
        if prog is not None:
            for item_id, pct in sorted(prog.percent_gauges().items()):
                emit("progress_percent", pct, {"item": item_id},
                     help_="recovery/backfill progress percent "
                           "(mgr progress item)", typ="gauge")
        # perf-query AGGREGATES only, labeled by query id: the scrape
        # surface is bounded by the number of standing queries, never
        # by the key cardinality inside them (a hostile tenant-name
        # churn grows a query's overflow fold, not the exporter) —
        # named rows live behind `perf query report` / top_tool
        pq = getattr(mon, "perf_queries", None)
        if pq is not None:
            for qid, a in sorted(pq.aggregates().items()):
                lab = {"query": str(qid)}
                emit("perf_query_ops_total", a["ops"], lab,
                     help_="total ops matched by the standing perf "
                           "query (all keys + overflow)",
                     typ="counter")
                emit("perf_query_bytes_total",
                     a["bytes_in"] + a["bytes_out"], lab,
                     help_="total bytes moved under the standing perf "
                           "query", typ="counter")
                emit("perf_query_keys", a["keys"], lab,
                     help_="distinct named keys currently tracked "
                           "(top-N bounded)", typ="gauge")
                emit("perf_query_overflow_ops", a["overflow_ops"],
                     lab,
                     help_="ops folded into the overflow bucket past "
                           "the query's top-N bound", typ="counter")
    # per-daemon perf counters (the MMgrReport/DaemonMetricCollector feed)
    for daemon, reg in sorted(global_perf().registries().items()):
        counters = reg.dump()
        gauges = reg.gauge_names()
        for cname, val in counters.items():
            base = f"daemon_{_sanitize(cname)}"
            if isinstance(val, dict):
                for sub in ("sum", "count", "sum_seconds"):
                    if sub in val:
                        emit(f"{base}_{sub}", val[sub],
                             {"daemon": daemon},
                             help_=f"perf counter {cname} {sub}",
                             typ="counter")
                if "buckets_pow2" in val:
                    # pow-2 histograms rendered as CUMULATIVE le-labeled
                    # buckets (bucket b covers [2^(b-1), 2^b), so its
                    # upper bound is 2^b) + the +Inf total — the shape
                    # histogram_quantile() consumes, which is what the
                    # prom_rules.py recording rules are built on.  The
                    # +Inf series is emitted even for an empty histogram
                    # so the metric NAME exists in every scrape (the
                    # recording rules reference a stable schema).
                    exs = {int(k): v for k, v in
                           (val.get("exemplars") or {}).items()}
                    acc = 0
                    for b, n in sorted(val["buckets_pow2"].items()):
                        acc += n
                        ring = exs.get(b)
                        emit(f"{base}_bucket", acc,
                             {"daemon": daemon, "le": str(2 ** b)},
                             help_=f"perf histogram {cname} cumulative "
                                   "pow-2 buckets",
                             typ="counter",
                             exemplar=(ring[-1] if ring else None))
                    emit(f"{base}_bucket", val.get("count", acc),
                         {"daemon": daemon, "le": "+Inf"},
                         help_=f"perf histogram {cname} cumulative "
                               "pow-2 buckets",
                         typ="counter")
            elif isinstance(val, (int, float)):
                # settable (U64) counters move both ways: typing them
                # counter would make rate() nonsense — the registry's
                # own type decides, not a naming convention
                typ = "gauge" if cname in gauges else "counter"
                emit(base, val, {"daemon": daemon},
                     help_=f"perf counter {cname}", typ=typ)
    lines: list[str] = []
    for m, g in groups.items():
        lines.append(f"# HELP {m} {g['help']}")
        lines.append(f"# TYPE {m} {g['type']}")
        for labels, value, exemplar in g["samples"]:
            lab = ""
            if labels:
                pairs = ",".join(f'{k}="{v}"' for k, v in sorted(
                    labels.items()))
                lab = "{" + pairs + "}"
            # exact rendering: %g truncates to 6 significant digits,
            # which corrupts byte counters past ~1e6 (rate()/delta()
            # go wrong)
            if isinstance(value, bool):
                value = int(value)
            line = f"{m}{lab} {value}" if isinstance(value, int) \
                else f"{m}{lab} {float(value)!r}"
            if openmetrics and exemplar is not None:
                # OpenMetrics exemplar suffix on the bucket line:
                # `# {trace_id="..."} observed_value capture_ts`
                line += (f' # {{trace_id="{exemplar["trace_id"]}"}}'
                         f' {float(exemplar["value"])!r}'
                         f' {float(exemplar["ts"])!r}')
            lines.append(line)
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """HTTP /metrics endpoint (port 0 = ephemeral; .port tells)."""

    def __init__(self, mon=None, host: str = "127.0.0.1", port: int = 0):
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API
                path, _, query = self.path.partition("?")
                if path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                # content negotiation: OpenMetrics (exemplar-bearing)
                # on an explicit Accept or ?openmetrics=1; classic
                # 0.0.4 otherwise — exemplar syntax would break 0.0.4
                # parsers
                om = ("application/openmetrics-text"
                      in (self.headers.get("Accept") or "")) \
                    or "openmetrics=1" in query
                body = render_metrics(
                    exporter.mon, openmetrics=om).encode("utf-8")
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8" if om
                    else "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self.mon = mon
        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-exporter",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
