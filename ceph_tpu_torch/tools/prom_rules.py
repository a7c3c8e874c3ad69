"""Prometheus recording rules for the exporter's pow-2 latency
histograms.

The exporter renders every pow-2 histogram as cumulative ``le``-labeled
``_bucket`` series (mon/exporter.py), which is exactly the shape
``histogram_quantile()`` consumes — so p50/p99 recording rules are one
expression per quantile.  This tool emits the rule file a real scrape
stack loads (the ROADMAP "histogram-quantile recording rules" item):

    python -m ceph_tpu_torch.tools.prom_rules > ceph_tpu_rules.yml

The generated rules reference ONLY metric names the exporter actually
emits — pinned by tests/test_torch_ops_tools.py against a live
render_metrics() pass, so a histogram rename can never silently strand
a dashboard on a dead series.
"""

from __future__ import annotations

import json
import re
import sys

PREFIX = "ceph_tpu"

#: the pow2-µs latency histograms worth standing quantile series for:
#: the EC kernel decomposition (compile cliffs / device compute / host
#: sync), the messenger dispatch latency, and the mclock scheduler's
#: per-class queue-wait (the QoS quantity the saturation harness's
#: reservation sweeps move — client vs recovery wait under load).
#: mclock_qwait_us_tenant_default is the per-TENANT family's anchor:
#: it exists zeroed on every daemon from boot (scheduler construction
#: registers it), so the rule never strands — named tenants' series
#: (mclock_qwait_us_tenant_<name>) appear as tenants register, bounded
#: by osd_qos_max_tenants, and ride the same bucket contract
#: ...plus the object-store commit pipeline's two latency halves
#: (store.<daemon> registries, osd/objectstore.py): store_queue_us =
#: enqueue -> batch cut (the coalescing wait), store_commit_us = the
#: group commit itself (vectored WAL append + the batch's one fsync)
#: ...plus the KV metadata tier's maintenance histograms (kv.<store>
#: registries, osd/kvstore.py schema): kv_flush_us / kv_compact_us =
#: background memtable flush and level-merge walls, kv_stall_us =
#: write-stall time writers paid while maintenance was behind (the
#: p99 cliff the background seam removes), kv_wal_compact_us = the
#: wal backend's snapshot-compaction wall
#: ...plus the exemplar-era op-path histograms: op_lat_us =
#: whole-op latency from the OpTracker (the client_op SLO signal),
#: ec_batch_wait_us / ec_batch_flush_us = the batcher's queued->flushed
#: wait and the folded launch wall (per-op and per-flush halves of the
#: coalescing trade)
HISTOGRAMS = ("kernel_compile_us", "kernel_device_us", "kernel_sync_us",
              "msg_dispatch_us",
              "mclock_qwait_us_client", "mclock_qwait_us_recovery",
              "mclock_qwait_us_scrub",
              "mclock_qwait_us_tenant_default",
              "store_commit_us", "store_queue_us",
              "kv_flush_us", "kv_compact_us", "kv_stall_us",
              "kv_wal_compact_us",
              "op_lat_us", "ec_batch_wait_us", "ec_batch_flush_us")
QUANTILES = (0.50, 0.99)

#: per-daemon tracer head-sampling counters (trace_sample_rate draws):
#: standing rate series make the sampled:dropped ratio — and any
#: sampler misconfiguration — visible on a dashboard without ad-hoc
#: PromQL.  The messenger copy counters ride the same rate-rule shape:
#: msg_tx_flatten_* books every Python-side assembly of an outgoing
#: frame's payload, msg_rx_copy_* every receive-side payload copy —
#: standing series keep the zero-copy wire path's "copies per hop"
#: claim a measured number (0 in plaintext mode) instead of a
#: code-reading exercise.  msg_syscalls_{tx,rx} count the transport's
#: actual kernel entries (sendmsg/recv or io_uring_enter) so
#: syscalls-per-frame — the uring stack's headline claim — is a
#: dashboard ratio; msg_uring_sqe_batch books each batched SQE-chain
#: submit and msg_uring_reg_buf_recycled each registered rx-buffer
#: reuse (recycle rate ~ large-frame rate means the pinned pool is
#: actually absorbing the big receives)
#: KV maintenance/cache counters ride the same rate-rule shape:
#: flush/compact rates say how hard the LSM is working, the cache
#: hit:miss ratio is the block cache's value on a dashboard
#: Read scale-out counters (osd/extent_cache.py's shared schema,
#: registered zeroed at OSD boot): balanced_read_serve/bounce say how
#: much read traffic the non-primary holders absorb (and how often a
#: holder had to decline back to the primary), read_lease_grant/revoke
#: track the client-cache lease churn (a revoke rate near the grant
#: rate means the working set is write-hot and leases are wasted), and
#: the ec_read_tier_* quartet is the HBM hot-read tier's admission
#: telemetry (hit:miss is the tier's value, admit:evict its churn)
#: Background-scrub counters (osd/scrub.py auto-scrub engine,
#: registered zeroed at OSD boot): verified_bytes over verify_launches
#: is the folded-verify batching win (bytes folded per device launch);
#: mismatches is the alertable corruption rate (host-confirmed, never
#: the raw folded candidates); digest_missing counts objects scrub had
#: to skip for lack of a stored digest (should trend to zero once
#: write-time digests cover the store); auto_chunks is the scheduler's
#: work cadence under the scrub mclock class.
SCRUB_COUNTERS = ("scrubs", "scrub_errors",
                  "scrub_verified_bytes", "scrub_verify_launches",
                  "scrub_mismatches", "scrub_digest_missing",
                  "scrub_auto_chunks")

#: Inline-compression counters (osd/compression.py COUNTERS schema):
#: the BlueStore-named pair bluestore_compressed_{original,allocated}
#: makes the at-rest ratio a dashboard division; compress_rejected
#: counts required_ratio fall-throughs (incompressible data staying
#: raw), compress_decompress the transparent read-side inflates.
COMPRESS_COUNTERS = ("compress_blobs", "compress_rejected",
                     "compress_decompress",
                     "bluestore_compressed_original",
                     "bluestore_compressed_allocated")

COUNTERS = ("trace_sampled", "trace_dropped",
            "msg_tx_flatten_bytes", "msg_tx_flatten_copies",
            "msg_rx_copy_bytes", "msg_rx_copy_copies",
            "msg_syscalls_tx", "msg_syscalls_rx",
            "msg_uring_sqe_batch", "msg_uring_reg_buf_recycled",
            "kv_flush", "kv_compact",
            "kv_cache_hit", "kv_cache_miss",
            "balanced_read_serve", "balanced_read_bounce",
            "read_lease_grant", "read_lease_ride", "read_lease_revoke",
            "ec_read_tier_hit", "ec_read_tier_miss",
            "ec_read_tier_admit", "ec_read_tier_evict") \
    + SCRUB_COUNTERS + COMPRESS_COUNTERS


def lint_counter_schema(registered) -> list[str]:
    """Counter-schema lint for the scrub_*/compress_* families: given
    the counter names a daemon actually registers (perf-counter keys),
    return a list of problems — a family member missing from the
    daemon, or a daemon counter in either namespace that the rules
    here don't know about (which would scrape without a standing rate
    rule).  Empty list = schema and rules agree."""
    have = set(registered)
    want = set(SCRUB_COUNTERS) | set(COMPRESS_COUNTERS)
    problems = []
    for c in sorted(want - have):
        problems.append(f"missing counter: {c} (in rules, "
                        f"not registered by daemon)")
    prefixes = ("scrub_", "compress_", "bluestore_compressed_")
    stray = {c for c in have
             if c.startswith(prefixes) or c == "scrubs"} - want
    for c in sorted(stray):
        problems.append(f"unruled counter: {c} (registered by "
                        f"daemon, no recording rule)")
    return problems

#: SLO_BURN-aligned bad-fraction recording rules: fraction of
#: observations ABOVE the bound over the rate window — the PromQL
#: twin of slo/objectives.py's bad_fraction (burn = ratio / (1 -
#: target) with the target applied at alerting time).  The le bound
#: must be an exporter bucket edge (a power of two): 16384 us is the
#: bucket floor of a ~20 ms client_op objective.
SLO_BAD_RATIOS = (("client_op", "op_lat_us", 16384),)

#: the metrics-history liveness gauge the exporter emits per daemon
#: (seconds since the mon merged that daemon's newest snapshot); the
#: max across daemons is the single alertable number
STALENESS_GAUGE = "metrics_history_staleness_s"


def recording_rules(histograms=HISTOGRAMS, quantiles=QUANTILES,
                    counters=COUNTERS, slo_ratios=SLO_BAD_RATIOS,
                    window: str = "5m") -> list[dict]:
    """One rule per (histogram, quantile) over the cumulative
    le-buckets, one rate rule per tracer counter, one SLO bad-fraction
    ratio per SLO_BAD_RATIOS entry, plus the metrics-history staleness
    max."""
    rules = []
    for h in histograms:
        metric = f"{PREFIX}_daemon_{h}_bucket"
        for q in quantiles:
            rules.append({
                "record": f"{PREFIX}:daemon_{h}:p{int(q * 100):02d}",
                "expr": (f"histogram_quantile({q}, "
                         f"sum by (daemon, le) "
                         f"(rate({metric}[{window}])))"),
            })
    for c in counters:
        rules.append({
            "record": f"{PREFIX}:daemon_{c}:rate{window}",
            "expr": (f"sum by (daemon) "
                     f"(rate({PREFIX}_daemon_{c}[{window}]))"),
        })
    for sig, h, le in slo_ratios:
        metric = f"{PREFIX}_daemon_{h}_bucket"
        rules.append({
            "record": f"{PREFIX}:slo_{sig}_bad:ratio_rate{window}",
            "expr": (f'1 - (sum(rate({metric}'
                     f'{{le="{le}"}}[{window}])) '
                     f'/ sum(rate({metric}'
                     f'{{le="+Inf"}}[{window}])))'),
        })
    rules.append({
        "record": f"{PREFIX}:{STALENESS_GAUGE}:max",
        "expr": f"max({PREFIX}_{STALENESS_GAUGE})",
    })
    return rules


def referenced_metrics(rules: list[dict]) -> set[str]:
    """Every exporter metric name a rule expression reads (record:
    names are products, not references)."""
    out: set[str] = set()
    for r in rules:
        out |= set(re.findall(rf"{PREFIX}_[a-z0-9_]+", r["expr"]))
    return out


def render(rules: list[dict], group: str = "ceph_tpu_latency") -> str:
    """Prometheus rule-file YAML (hand-rendered: the values are plain
    identifiers and exprs with no YAML-hostile characters)."""
    lines = ["groups:", f"- name: {group}", "  rules:"]
    for r in rules:
        lines.append(f"  - record: {r['record']}")
        lines.append(f"    expr: {r['expr']}")
    return "\n".join(lines) + "\n"


#: exporter-emitted perf-query aggregate series the dashboard's
#: attribution panel reads — labeled only by query id (the bounded
#: surface mon/exporter.py emits; named rows stay behind
#: `perf query report` / top_tool)
PERF_QUERY_METRICS = ("perf_query_ops_total", "perf_query_bytes_total",
                      "perf_query_keys", "perf_query_overflow_ops")


def dashboard(rules: list[dict] | None = None,
              window: str = "5m") -> dict:
    """Grafana dashboard JSON pinned to the emitted rule names: every
    recorded series a panel reads is checked against the actual
    recording_rules() output, so a rule rename breaks generation here
    (and the schema test) instead of stranding a live dashboard on a
    dead series."""
    rules = recording_rules(window=window) if rules is None else rules
    records = {r["record"] for r in rules}

    def rec(name: str) -> str:
        if name not in records:
            raise KeyError(
                f"dashboard references unemitted rule {name!r}")
        return name

    panels: list[dict] = []

    def panel(title: str, targets: list[tuple], unit: str = "µs",
              typ: str = "timeseries") -> None:
        i = len(panels)
        panels.append({
            "id": i + 1, "title": title, "type": typ,
            "datasource": {"type": "prometheus",
                           "uid": "${DS_PROMETHEUS}"},
            "gridPos": {"h": 8, "w": 12,
                        "x": 12 * (i % 2), "y": 8 * (i // 2)},
            "fieldConfig": {"defaults": {"unit": unit},
                            "overrides": []},
            "targets": [
                {"refId": chr(ord("A") + j), "expr": expr,
                 "legendFormat": legend,
                 **({"exemplar": True} if exemplar else {})}
                for j, (expr, legend, exemplar)
                in enumerate(targets)],
        })

    panel("Client op latency (p50/p99)", [
        (rec(f"{PREFIX}:daemon_op_lat_us:p50"), "p50 {{daemon}}",
         False),
        # the exemplar-linked panel: Grafana resolves the bucket
        # exemplars the OpenMetrics scrape carries into trace_id dots
        (rec(f"{PREFIX}:daemon_op_lat_us:p99"), "p99 {{daemon}}",
         True),
    ])
    panel("mClock queue wait p99 by class", [
        (rec(f"{PREFIX}:daemon_mclock_qwait_us_client:p99"),
         "client {{daemon}}", False),
        (rec(f"{PREFIX}:daemon_mclock_qwait_us_recovery:p99"),
         "recovery {{daemon}}", False),
        (rec(f"{PREFIX}:daemon_mclock_qwait_us_tenant_default:p99"),
         "tenant:default {{daemon}}", False),
    ])
    panel("SLO client_op bad fraction (burn feed)", [
        (rec(f"{PREFIX}:slo_client_op_bad:ratio_rate{window}"),
         "bad fraction", False),
    ], unit="percentunit")
    panel("Metrics-history staleness (max over daemons)", [
        (rec(f"{PREFIX}:{STALENESS_GAUGE}:max"), "staleness", False),
    ], unit="s")
    panel("Perf-query attribution (top standing queries)", [
        (f"topk(5, sum by (query) "
         f"(rate({PREFIX}_perf_query_ops_total[{window}])))",
         "query {{query}} ops/s", False),
        (f"sum by (query) "
         f"(rate({PREFIX}_perf_query_overflow_ops[{window}]))",
         "query {{query}} overflow ops/s", False),
    ], unit="ops")
    panel("Messenger dispatch p99", [
        (rec(f"{PREFIX}:daemon_msg_dispatch_us:p99"), "{{daemon}}",
         False),
    ])
    return {
        "title": "ceph_tpu overview",
        "uid": "ceph-tpu-overview",
        "schemaVersion": 39,
        "tags": ["ceph_tpu", "generated"],
        "time": {"from": "now-1h", "to": "now"},
        "refresh": "10s",
        "templating": {"list": [
            {"name": "DS_PROMETHEUS", "type": "datasource",
             "query": "prometheus"}]},
        "panels": panels,
    }


def tenant_histograms(tenants) -> tuple:
    """Histogram names for a deployment's NAMED tenants (the dynamic
    half of the per-tenant family: the default anchor is always in
    HISTOGRAMS; named tenants' series exist once those tenants have
    sent ops, so their rules are generated per deployment via
    ``--tenants``)."""
    from ..osd.scheduler import _tenant_metric
    return tuple(f"mclock_qwait_us_tenant_{_tenant_metric(t)}"
                 for t in tenants)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="emit Prometheus recording rules for the "
                    "exporter's pow-2 histograms")
    ap.add_argument("--tenants", default="",
                    help="comma-separated tenant names to stand "
                         "per-tenant mclock_qwait p50/p99 rules for "
                         "(the default-tenant anchor is always "
                         "included)")
    ap.add_argument("--dashboard", action="store_true",
                    help="emit the Grafana dashboard JSON (panels "
                         "pinned to the emitted rule names) instead "
                         "of the rule-file YAML")
    args = ap.parse_args(argv)
    hists = HISTOGRAMS
    if args.tenants:
        names = [t.strip() for t in args.tenants.split(",")
                 if t.strip()]
        hists = HISTOGRAMS + tenant_histograms(names)
    rules = recording_rules(histograms=hists)
    if args.dashboard:
        print(json.dumps(dashboard(rules), indent=2))
    else:
        print(render(rules), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
