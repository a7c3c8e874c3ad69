"""The port's operator tools, held against the JAX package on the CPU.

- tools/prom_rules: the cases of the JAX package's
  tests/test_prom_rules.py on the port (every metric a rule names is one
  the port's exporter emits), and the rule file and the dashboard the
  port renders equal the reference's text.
- tools/event_tool, perf_history, top_tool and cli: the cases of
  tests/test_observability.py and tests/test_perf_query.py that drive
  them, on the port; their pure formatters equal the reference's on
  seeded inputs; ``Cli``'s verbs answer as the reference's on the same
  cluster work.
- tools/smoke: ``--quick --device cpu`` and the full scorecard on the
  CPU exit 0 with the reference's check names (the kernel check
  renamed); ``--device cuda`` without a card exits 2.

``tools/cephadm``'s rolling restart is in test_torch_cephadm.py, and
``bench_sweep --multichip`` in test_torch_bench_sweep.py.
"""

import http.client
import io
import json
import os
import re
import subprocess
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import ceph_tpu.tools.cli as ref_cli
import ceph_tpu.tools.event_tool as ref_event_tool
import ceph_tpu.tools.perf_history as ref_perf_history
import ceph_tpu.tools.prom_rules as ref_prom_rules
import ceph_tpu.tools.smoke as ref_smoke
import ceph_tpu.tools.top_tool as ref_top_tool
import ceph_tpu.tools.vstart as ref_vstart
import ceph_tpu_torch.tools.cli as port_cli
import ceph_tpu_torch.tools.event_tool as port_event_tool
import ceph_tpu_torch.tools.perf_history as port_perf_history
import ceph_tpu_torch.tools.prom_rules as port_prom_rules
import ceph_tpu_torch.tools.top_tool as port_top_tool
from ceph_tpu_torch.mon.exporter import render_metrics
from ceph_tpu_torch.msg.messenger import LocalNetwork, Messenger
from ceph_tpu_torch.tools.prom_rules import (recording_rules,
                                             referenced_metrics, render)
from ceph_tpu_torch.tools.vstart import MiniCluster
from ceph_tpu_torch.utils.admin_socket import admin_request
from ceph_tpu_torch.utils.perf import kernel_profiler
from tests.test_cluster import make_cfg as ref_make_cfg
from tests.test_torch_cluster import make_cfg

# the EC pools of the copied cases: one intra-op thread
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- the cases of tests/test_prom_rules.py ------------------------------------
def _emitted_metric_names(body: str) -> set[str]:
    names = set()
    for line in body.splitlines():
        if not line or line.startswith("#"):
            continue
        names.add(line.rsplit(" ", 1)[0].split("{", 1)[0])
    return names


class _StubMon:
    """The minimal monitor surface render_metrics()'s mon branch
    touches — enough to materialize the mon-side staleness gauge
    without booting a cluster."""

    def __init__(self, store):
        import threading

        from ceph_tpu_torch.mon.maps import OSDMap
        self._lock = threading.Lock()
        self.osdmap = OSDMap()
        self.is_leader = True
        self._osd_stats = {}
        self.progress = None
        self.metrics_history = store


def test_rules_reference_only_emitted_metrics():
    # materialize the registries the rules read: the kernel profiler
    # (ec_kernels: kernel_*_us), one messenger (msg_dispatch_us), the
    # scheduler's per-class QoS counters (mclock_qwait_us_*), a tracer
    # (trace_sampled/trace_dropped) and a mon-side metrics-history
    # store with one merged sample (the staleness gauge) — the
    # exporter emits every histogram's +Inf bucket even at zero
    # samples, so the schema exists without traffic
    from ceph_tpu_torch.osd.scheduler import (ClassParams,
                                        register_qos_counters,
                                        register_tenant_counters)
    from ceph_tpu_torch.utils.metrics_history import MetricsHistoryStore
    from ceph_tpu_torch.utils.perf import global_perf
    from ceph_tpu_torch.utils.tracer import Tracer
    kernel_profiler()
    net = LocalNetwork()
    m = Messenger(net, "prom-rules-probe")
    qos_probe = global_perf().create("qos_probe")
    register_qos_counters(qos_probe, {
        "client": ClassParams(0, 1, 0),
        "recovery": ClassParams(0, 1, 0),
        "scrub": ClassParams(0, 1, 0)})
    # the per-tenant family's always-present anchor (the scheduler
    # registers it at construction — same zeroed-schema contract)
    register_tenant_counters(qos_probe, ("default",))
    # the store commit pipeline's schema (store_commit_us /
    # store_queue_us p50/p99 rules)
    from ceph_tpu_torch.osd.objectstore import register_store_counters
    register_store_counters(qos_probe)
    # the KV metadata tier's maintenance schema (kv_flush_us /
    # kv_compact_us / kv_stall_us / kv_wal_compact_us p50/p99 rules +
    # flush/compact/cache rate rules)
    from ceph_tpu_torch.osd.kvstore import register_kv_counters
    register_kv_counters(qos_probe)
    # the read scale-out schema (balanced_read_* / read_lease_* /
    # ec_read_tier_* rate rules — registered zeroed at OSD boot)
    from ceph_tpu_torch.osd.extent_cache import register_read_scaleout_counters
    register_read_scaleout_counters(qos_probe)
    # the exemplar-era op-path histograms (op_lat_us from the
    # OpTracker bind, ec_batch_{wait,flush}_us from the batcher) —
    # registered zeroed at daemon/batcher construction
    from ceph_tpu_torch.utils.perf import CounterType
    for h in ("op_lat_us", "ec_batch_wait_us", "ec_batch_flush_us"):
        qos_probe.add(h, CounterType.HISTOGRAM)
    # the background-scrub + inline-compression counter families
    # (registered zeroed at OSD boot; schema pinned by the lint below)
    from ceph_tpu_torch.tools.prom_rules import (COMPRESS_COUNTERS,
                                           SCRUB_COUNTERS)
    qos_probe.add_many(SCRUB_COUNTERS + COMPRESS_COUNTERS)
    Tracer("qos_probe", perf=qos_probe)  # trace_* counter schema
    import time as _time
    store = MetricsHistoryStore()
    # a FRESH sample: the store expires silent daemons out of the
    # staleness gauge, so an ancient ts would render nothing
    store.merge("osd.0", {"osd.0": [
        {"ts": _time.time(), "seq": 1, "counters": {"op_w": 0}}]})
    try:
        body = render_metrics(_StubMon(store))
    finally:
        m.shutdown()
        global_perf().remove("qos_probe")
    emitted = _emitted_metric_names(body)
    rules = recording_rules()
    refs = referenced_metrics(rules)
    assert refs, "rules reference no metrics at all"
    missing = refs - emitted
    assert not missing, \
        f"rules reference metrics the exporter never emits: {missing}"


def test_rules_shape_and_rendering():
    rules = recording_rules()
    # one rule per (histogram, quantile) + one rate rule per tracer /
    # messenger-copy / kv-maintenance / read-scale-out counter + the
    # SLO bad-fraction ratio + the staleness max, records namespaced
    assert len(rules) == 71
    assert all(r["record"].startswith("ceph_tpu:") for r in rules)
    hist = [r for r in rules if "histogram_quantile(" in r["expr"]]
    assert len(hist) == 34
    assert all("by (daemon, le)" in r["expr"] for r in hist)
    quantiles = {r["record"].rsplit(":", 1)[1] for r in hist}
    assert quantiles == {"p50", "p99"}
    # the KV tier's maintenance walls + write-stall time quantiles
    hist_recs = {r["record"] for r in hist}
    for kvh in ("kv_flush_us", "kv_compact_us", "kv_stall_us",
                "kv_wal_compact_us"):
        assert f"ceph_tpu:daemon_{kvh}:p99" in hist_recs
    rates = [r for r in rules if ":rate" in r["record"]]
    assert {r["record"] for r in rates} == {
        "ceph_tpu:daemon_trace_sampled:rate5m",
        "ceph_tpu:daemon_trace_dropped:rate5m",
        "ceph_tpu:daemon_msg_tx_flatten_bytes:rate5m",
        "ceph_tpu:daemon_msg_tx_flatten_copies:rate5m",
        "ceph_tpu:daemon_msg_rx_copy_bytes:rate5m",
        "ceph_tpu:daemon_msg_rx_copy_copies:rate5m",
        "ceph_tpu:daemon_msg_syscalls_tx:rate5m",
        "ceph_tpu:daemon_msg_syscalls_rx:rate5m",
        "ceph_tpu:daemon_msg_uring_sqe_batch:rate5m",
        "ceph_tpu:daemon_msg_uring_reg_buf_recycled:rate5m",
        "ceph_tpu:daemon_kv_flush:rate5m",
        "ceph_tpu:daemon_kv_compact:rate5m",
        "ceph_tpu:daemon_kv_cache_hit:rate5m",
        "ceph_tpu:daemon_kv_cache_miss:rate5m",
        "ceph_tpu:daemon_balanced_read_serve:rate5m",
        "ceph_tpu:daemon_balanced_read_bounce:rate5m",
        "ceph_tpu:daemon_read_lease_grant:rate5m",
        "ceph_tpu:daemon_read_lease_ride:rate5m",
        "ceph_tpu:daemon_read_lease_revoke:rate5m",
        "ceph_tpu:daemon_ec_read_tier_hit:rate5m",
        "ceph_tpu:daemon_ec_read_tier_miss:rate5m",
        "ceph_tpu:daemon_ec_read_tier_admit:rate5m",
        "ceph_tpu:daemon_ec_read_tier_evict:rate5m",
        "ceph_tpu:daemon_scrubs:rate5m",
        "ceph_tpu:daemon_scrub_errors:rate5m",
        "ceph_tpu:daemon_scrub_verified_bytes:rate5m",
        "ceph_tpu:daemon_scrub_verify_launches:rate5m",
        "ceph_tpu:daemon_scrub_mismatches:rate5m",
        "ceph_tpu:daemon_scrub_digest_missing:rate5m",
        "ceph_tpu:daemon_scrub_auto_chunks:rate5m",
        "ceph_tpu:daemon_compress_blobs:rate5m",
        "ceph_tpu:daemon_compress_rejected:rate5m",
        "ceph_tpu:daemon_compress_decompress:rate5m",
        "ceph_tpu:daemon_bluestore_compressed_original:rate5m",
        "ceph_tpu:daemon_bluestore_compressed_allocated:rate5m"}
    assert all("rate(" in r["expr"] and "by (daemon)" in r["expr"]
               for r in rates)
    stale = [r for r in rules
             if r["record"] == "ceph_tpu:metrics_history_staleness_s:max"]
    assert len(stale) == 1
    assert stale[0]["expr"] == "max(ceph_tpu_metrics_history_staleness_s)"
    # the SLO_BURN-aligned bad-fraction ratio: observations over the
    # bucket bound as a fraction of all (slo/objectives.py's
    # bad_fraction in PromQL; burn = ratio / (1 - target))
    slo = [r for r in rules if r["record"].startswith("ceph_tpu:slo_")]
    assert len(slo) == 1
    assert slo[0]["record"] == "ceph_tpu:slo_client_op_bad:ratio_rate5m"
    assert 'le="16384"' in slo[0]["expr"] \
        and 'le="+Inf"' in slo[0]["expr"] \
        and "ceph_tpu_daemon_op_lat_us_bucket" in slo[0]["expr"]
    text = render(rules)
    assert text.startswith("groups:\n- name: ceph_tpu_latency\n")
    assert text.count("  - record: ") == 71
    assert text.count("    expr: ") == 71
    # per-tenant family: the default anchor is standing, and named
    # tenants generate the same rule shape via tenant_histograms
    from ceph_tpu_torch.tools.prom_rules import tenant_histograms
    named = recording_rules(
        histograms=tenant_histograms(("gold", "Bul-k!")))
    recs = {r["record"] for r in named
            if "histogram_quantile(" in r["expr"]}
    assert ("ceph_tpu:daemon_mclock_qwait_us_tenant_gold:p99"
            in recs)
    # names sanitize exactly like the scheduler's counter stems
    assert ("ceph_tpu:daemon_mclock_qwait_us_tenant_bul_k_:p50"
            in recs)


def test_scrub_compress_counter_schema_lint():
    """The scrub_*/compress_* families stay in lockstep between the
    daemon's zeroed registration and the standing rate rules: a
    counter added to one side without the other fails the lint."""
    from ceph_tpu_torch.osd.compression import COUNTERS as COMPRESS_DAEMON
    from ceph_tpu_torch.tools.prom_rules import (COMPRESS_COUNTERS,
                                           SCRUB_COUNTERS,
                                           lint_counter_schema)
    # the exact names the OSD registers zeroed at boot (daemon.py
    # perf.add_many + compression.COUNTERS)
    daemon_registered = ("scrubs", "scrub_errors",
                         "scrub_verified_bytes",
                         "scrub_verify_launches",
                         "scrub_mismatches", "scrub_digest_missing",
                         "scrub_auto_chunks") + COMPRESS_DAEMON
    assert lint_counter_schema(daemon_registered) == []
    assert set(COMPRESS_COUNTERS) == set(COMPRESS_DAEMON)
    # drift in either direction is a loud, named failure
    missing = lint_counter_schema(daemon_registered[:-1])
    assert len(missing) == 1 and "missing counter" in missing[0]
    stray = lint_counter_schema(
        daemon_registered + ("scrub_new_thing",))
    assert len(stray) == 1 and "unruled counter" in stray[0]
    # every family member has a standing rate rule
    recs = {r["record"] for r in recording_rules()}
    for c in SCRUB_COUNTERS + COMPRESS_COUNTERS:
        assert f"ceph_tpu:daemon_{c}:rate5m" in recs
    # and the LIVE daemon registration passes the lint end-to-end
    from ceph_tpu_torch.tools.vstart import MiniCluster
    from tests.test_torch_cluster import make_cfg
    c = MiniCluster(n_osds=1, cfg=make_cfg()).start()
    try:
        osd = next(iter(c.osds.values()))
        names = list(osd.perf.dump())
        assert lint_counter_schema(names) == []
    finally:
        c.stop()


def test_dashboard_pinned_to_emitted_rule_names():
    """The generated Grafana dashboard may reference ONLY series that
    exist: recorded rule names from recording_rules() plus the
    exporter's bounded perf-query aggregates (PERF_QUERY_METRICS) — a
    rule rename must break generation here, not strand a live panel
    on a dead series."""
    import json

    import pytest

    from ceph_tpu_torch.tools.prom_rules import (PERF_QUERY_METRICS, dashboard,
                                           main)
    dash = json.loads(json.dumps(dashboard()))   # valid JSON document
    assert dash["uid"] == "ceph-tpu-overview"
    assert dash["panels"], "dashboard has no panels"
    records = {r["record"] for r in recording_rules()}
    raw_ok = {f"ceph_tpu_{m}" for m in PERF_QUERY_METRICS}
    seen_raw = set()
    ids = [p["id"] for p in dash["panels"]]
    assert len(ids) == len(set(ids))
    for p in dash["panels"]:
        assert p["datasource"]["uid"] == "${DS_PROMETHEUS}"
        refids = [t["refId"] for t in p["targets"]]
        assert len(refids) == len(set(refids))
        for t in p["targets"]:
            for token in re.findall(r"ceph_tpu[A-Za-z0-9_:]*",
                                    t["expr"]):
                assert token in records or token in raw_ok, \
                    f"panel {p['title']!r} references unknown " \
                    f"series {token!r}"
                if token in raw_ok:
                    seen_raw.add(token)
    # the attribution panel really reads the perf-query aggregates
    assert f"ceph_tpu_perf_query_ops_total" in seen_raw
    # the exemplar-linked target: client op p99 resolves trace dots
    p99 = [t for p in dash["panels"] for t in p["targets"]
           if t["expr"].endswith("op_lat_us:p99")]
    assert p99 and p99[0].get("exemplar") is True
    # a panel referencing a rule that was renamed away fails LOUDLY
    with pytest.raises(KeyError):
        dashboard(rules=[])
    # the CLI face emits the same parseable document
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--dashboard"])
    assert json.loads(buf.getvalue())["uid"] == "ceph-tpu-overview"


def test_exporter_histogram_buckets_are_cumulative_le():
    """The rule expressions only work over CUMULATIVE le-labeled
    buckets — pin the exporter's rendering contract."""
    from ceph_tpu_torch.utils.perf import global_perf
    pc = global_perf().create("bucket_probe")
    from ceph_tpu_torch.utils.perf import CounterType
    pc.add("lat_us", CounterType.HISTOGRAM)
    for v in (3, 3, 10, 300):
        pc.hinc("lat_us", v)
    try:
        body = render_metrics(None)
    finally:
        global_perf().remove("bucket_probe")
    rows = {}
    for line in body.splitlines():
        m = re.match(r'ceph_tpu_daemon_lat_us_bucket\{daemon="'
                     r'bucket_probe",le="([^"]+)"\} (\d+)', line)
        if m:
            rows[m.group(1)] = int(m.group(2))
    # 3 -> bucket 2 (le 4), 10 -> bucket 4 (le 16), 300 -> bucket 9
    # (le 512); counts accumulate and +Inf carries the total
    assert rows == {"4": 2, "16": 3, "512": 4, "+Inf": 4}
    assert 'ceph_tpu_daemon_lat_us_count{daemon="bucket_probe"} 4' \
        in body

# -- from tests/test_observability.py -----------------------------------------
@pytest.fixture
def obs_cluster(tmp_path):
    c = MiniCluster(n_osds=4, cfg=make_cfg(),
                    admin_dir=str(tmp_path / "asok"),
                    metrics_port=0).start()
    yield c, tmp_path
    c.stop()

def test_admin_socket_via_cli(obs_cluster):
    c, tmp_path = obs_cluster
    asok = str(tmp_path / "asok" / "osd.1.asok")
    out = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.cli", "daemon", asok,
         "perf", "dump"],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "op_w" in json.loads(out.stdout)

def test_cluster_events_progress_and_messenger_metrics(tmp_path):
    """The cluster-narrative acceptance path: an OSD kill + fresh-store
    revive drives a recovery storm, and the operator can watch it
    WITHOUT replaying traces — (a) ordered PG state-transition events
    in dump_cluster_log, (b) a progress item that goes 0 -> 100 and
    clears, (c) nonzero messenger dispatch-latency histograms in one
    exporter scrape that still passes the strict text-format parser."""
    from ceph_tpu_torch.mon.mgr import MgrDaemon
    from ceph_tpu_torch.tools.event_tool import fetch_events, tail

    cfg = make_cfg(osd_recovery_sleep=0.005,
                   osd_recovery_progress_interval=0.0,
                   mgr_progress_linger=2.0)
    c = MiniCluster(n_osds=4, cfg=cfg,
                    admin_dir=str(tmp_path / "asok"),
                    metrics_port=0).start()
    mgr = None
    try:
        client = c.client()
        client.create_pool("p", kind="ec", pg_num=4,
                           ec_profile={"plugin": "jerasure", "k": "2",
                                       "m": "1", "backend": "numpy"})
        for i in range(24):
            client.write_full("p", f"o{i}", b"evt" * 1024)
        mgr = MgrDaemon(c.mon, modules=("status", "progress")).start()
        # victim: a member of some PG's up set, so its fresh-store
        # revive forces shard rebuilds (a non-holder would recover
        # nothing and the storm never happens)
        pool_id = next(pid for pid, p in c.mon.osdmap.pools.items()
                       if p.name == "p")
        members = {o for seed in range(4)
                   for o in c.mon.osdmap.pg_to_up_osds(pool_id, seed)
                   if o is not None}
        victim = max(members)
        c.kill_osd(victim)             # marked down -> map change
        c.settle(0.3)
        c.revive_osd(victim)           # FRESH store: rebuild its shards
        mon_asok = str(tmp_path / "asok" / "mon.0.asok")

        def cluster_log(**kw):
            res, data = admin_request(mon_asok, "dump_cluster_log",
                                      **kw)
            assert res == 0, data
            return data["events"]

        # --- (b) progress 0 -> 100, sampled while the storm runs ----
        percents: dict[str, list] = {}
        deadline = time.time() + 30
        storm_done = False
        while time.time() < deadline:
            for it in c.mon.progress.items():
                percents.setdefault(it["id"], []).append(it["percent"])
            evs = cluster_log(channel="recovery")
            if any((e["fields"].get("event") == "recovery_done")
                   for e in evs) and not c.mon.progress.active():
                storm_done = True
                break
            time.sleep(0.02)
        assert storm_done, "recovery storm never completed in the log"
        assert percents, "no progress item ever appeared"
        assert all(all(a <= b for a, b in zip(ps, ps[1:]))
                   for ps in percents.values()), percents
        assert any(ps[-1] == 100.0 for ps in percents.values()), \
            percents
        # the mgr digest carries the items (the `ceph status` face)
        digest = mgr.command("status", "status")
        assert "progress" in digest
        ls = mgr.command("progress", "ls")
        assert any(i["percent"] == 100.0 for i in ls["completed"])

        # --- (a) ordered PG state transitions in the cluster log ----
        evs = cluster_log(channel="pg")
        by_pg: dict[tuple, dict] = {}
        for e in evs:
            key = (e["daemon"], e["fields"].get("pg"))
            slot = by_pg.setdefault(key, {})
            if "peering start" in e["message"]:
                slot.setdefault("start", e["seq"])
            elif "peering done" in e["message"]:
                slot["done"] = e["seq"]
        ordered = [k for k, s in by_pg.items()
                   if "start" in s and "done" in s
                   and s["start"] < s["done"]]
        assert ordered, f"no ordered peering start->done pair: {by_pg}"
        # the mon's own channels narrate the flap too
        assert any(f"osd.{victim} marked down" in e["message"]
                   for e in cluster_log(channel="cluster"))
        assert any(e["fields"].get("epoch")
                   for e in cluster_log(channel="osdmap"))
        assert any("recovery start" in e["message"]
                   for e in cluster_log(channel="recovery"))

        # event_tool: the `ceph -W` face over the same socket — the
        # one-shot dump prints the ring, follow mode resumes the cursor
        lines: list[str] = []
        tail(mon_asok, channel="pg", out=lines.append)
        assert lines and any("peering" in ln for ln in lines)
        _evs, cursor = fetch_events(mon_asok)
        # follow contract: a since-cursor fetch returns ONLY events
        # sequenced after it (the cluster is live — stragglers may
        # still land between the two fetches, but never replays)
        newer, cursor2 = fetch_events(mon_asok, since=cursor)
        assert all(e["seq"] > cursor for e in newer)
        assert cursor2 >= cursor

        # per-daemon verbs: local journal + messenger introspection
        osd_id = next(iter(c.osds))
        asok = str(tmp_path / "asok" / f"osd.{osd_id}.asok")
        local = admin_request(asok, "dump_events")
        assert isinstance(local, list)
        msgr = admin_request(asok, "dump_messenger")
        assert msgr["data"]["perf"]["msg_dispatched"] > 0
        assert len(msgr["data"]["queue_depths"]) == \
            msgr["data"]["workers"]

        # --- (c) one strict scrape: msg histograms are NONZERO -------
        conn = http.client.HTTPConnection("127.0.0.1", c.exporter.port,
                                          timeout=5)
        conn.request("GET", "/metrics")
        body = conn.getresponse().read().decode()
        conn.close()
        parsed = _parse_exposition_strict(body)
        counts = parsed["ceph_tpu_daemon_msg_dispatch_us_count"]
        assert sum(counts["samples"].values()) > 0
        buckets = parsed["ceph_tpu_daemon_msg_dispatch_us_bucket"]
        assert any(v > 0 for v in buckets["samples"].values())
        assert parsed["ceph_tpu_daemon_msg_queue_depth"]["type"] == \
            "gauge"
        # the progress gauge is visible while items linger; a late
        # recovery wave may have opened a FRESH sub-100 item by now
        # (storms close whenever the in-flight count drains), so the
        # contract asserted is "a completed storm's gauge shows 100",
        # not "every gauge is 100"
        assert "ceph_tpu_progress_percent" in parsed
        assert any(v == 100.0 for v in
                   parsed["ceph_tpu_progress_percent"]
                   ["samples"].values())
        # ...and CLEARS once the linger expires
        deadline = time.time() + 15
        cleared = False
        while time.time() < deadline:
            if not c.mon.progress.percent_gauges():
                cleared = True
                break
            time.sleep(0.05)
        assert cleared, "progress gauge never cleared"
        conn = http.client.HTTPConnection("127.0.0.1", c.exporter.port,
                                          timeout=5)
        conn.request("GET", "/metrics")
        body2 = conn.getresponse().read().decode()
        conn.close()
        assert "ceph_tpu_progress_percent" not in body2
    finally:
        if mgr is not None:
            mgr.stop()
        c.stop()

def _parse_exposition_strict(body: str):
    """Strict prometheus text-format parse: returns
    {metric: {"type": t, "samples": {labelstr: value}}} and asserts the
    format invariants — single HELP/TYPE per metric, TYPE before the
    samples, ALL samples of a metric contiguous in one group."""
    metrics: dict[str, dict] = {}
    current = None
    closed: set[str] = set()
    for line in body.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name = line.split(" ", 3)[2]
            assert name not in metrics, f"duplicate HELP for {name}"
            if current is not None:
                closed.add(current)
            assert name not in closed, f"{name} group reopened"
            metrics[name] = {"type": None, "samples": {}}
            current = name
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            name, typ = parts[2], parts[3]
            assert name == current, \
                f"TYPE {name} outside its HELP group"
            assert metrics[name]["type"] is None, \
                f"duplicate TYPE for {name}"
            assert typ in ("counter", "gauge", "histogram", "summary")
            metrics[name]["type"] = typ
            continue
        assert not line.startswith("#"), f"unknown comment: {line}"
        sample, value = line.rsplit(" ", 1)
        name = sample.split("{", 1)[0]
        assert name == current, \
            f"sample {name} outside its group (current {current})"
        assert sample not in metrics[name]["samples"], \
            f"duplicate sample {sample}"
        metrics[name]["samples"][sample] = float(value)
    for name, m in metrics.items():
        assert m["type"] is not None, f"{name} has no TYPE"
        assert m["samples"], f"{name} has no samples"
    return metrics

def test_slow_op_flight_recorder_and_metrics_history(tmp_path):
    """The acceptance case, end to end on a live cluster with
    trace_sample_rate=1.0: an injected dispatch stall produces a
    historic slow-op entry whose ATTACHED cross-daemon trace spans at
    least two services, journals a slow_op cluster event, and the
    metrics history answers rate queries over two disjoint snapshot
    windows that agree exactly with raw counter deltas."""
    cfg = make_cfg(trace_sample_rate=1.0, osd_op_complaint_time=0.08,
                   metrics_history_interval_s=0.1)
    c = MiniCluster(n_osds=4, cfg=cfg,
                    admin_dir=str(tmp_path / "asok")).start()
    try:
        client = c.client()
        client.create_pool("p", kind="ec", pg_num=1,
                           ec_profile={"plugin": "jerasure", "k": "2",
                                       "m": "1", "backend": "numpy"})
        client.write_full("p", "obj", b"a" * 4096)
        pool_id = next(pid for pid, p in c.mon.osdmap.pools.items()
                       if p.name == "p")
        seed = c.mon.osdmap.object_to_pg(pool_id, "obj")
        primary = next(o for o in
                       c.mon.osdmap.pg_to_up_osds(pool_id, seed)
                       if o is not None)
        posd = c.osds[primary]

        # --- flight recorder: stall the primary's EC write dispatch
        orig = posd._ec_write

        def stalled(*a, **kw):
            time.sleep(0.2)
            return orig(*a, **kw)

        posd._ec_write = stalled
        try:
            client.write_full("p", "obj", b"b" * 8192)
        finally:
            posd._ec_write = orig
        asok = str(tmp_path / "asok" / f"osd.{primary}.asok")
        hist = admin_request(asok, "dump_historic_slow_ops")
        entries = [d for d in hist if "obj" in d["description"]]
        assert entries, f"no historic slow op recorded: {hist}"
        entry = entries[-1]
        assert entry.get("trace_id"), "slow op lost its trace id"
        trace = entry.get("trace") or []
        services = {s["service"] for s in trace}
        assert len(services) >= 2, \
            f"slow-op trace does not cross daemons: {services}"
        # the op's own span names are in the merged evidence
        assert any(s["name"].startswith("osd-op") for s in trace)
        # ...and the complaint is journaled as a slow_op cluster event
        mon_asok = str(tmp_path / "asok" / "mon.0.asok")
        deadline = time.time() + 10
        evs = []
        while time.time() < deadline:
            res, data = admin_request(mon_asok, "dump_cluster_log",
                                      channel="slow_op")
            assert res == 0, data
            evs = data["events"]
            if evs:
                break
            time.sleep(0.05)
        assert evs, "slow_op event never reached the cluster log"
        assert any(e["fields"].get("trace_id") == entry["trace_id"]
                   for e in evs)

        # --- metrics history: two disjoint windows vs raw deltas ----
        # Boundaries are driven by MERGE COVERAGE, not fixed sleeps:
        # the loaded CI box can starve the heartbeat sampler / stats
        # shipping for long stretches, so each phase ends only once
        # the mon's newest merged snapshot reflects the raw counters
        # taken at that boundary (samples merge seq-ordered, so a
        # newer sample covering the counter implies every earlier one
        # is in too).
        reg = f"osd.{primary}"

        def newest(counter):
            res, data = admin_request(mon_asok, "dump_metrics_history",
                                      registry=reg, max=1)
            assert res == 0, data
            rows = data["registries"].get(reg) or []
            return rows[-1]["counters"].get(counter) if rows else None

        def wait_merged(counter, want, timeout=20):
            deadline = time.time() + timeout
            while time.time() < deadline:
                got = newest(counter)
                if isinstance(got, dict):
                    got = got.get("count")
                if got == want:
                    return
                time.sleep(0.05)
            raise AssertionError(
                f"mon history never caught up: {counter} stuck at "
                f"{newest(counter)!r}, want {want!r}")

        def newest_ts():
            res, data = admin_request(mon_asok, "dump_metrics_history",
                                      registry=reg, max=1)
            assert res == 0, data
            rows = data["registries"].get(reg) or []
            return float(rows[-1]["ts"]) if rows else 0.0

        w0 = posd.perf.get("op_w")
        q0 = posd.perf.dump()["mclock_qwait_us_client"]["count"]
        wait_merged("op_w", w0)
        t0 = time.time()
        # window 1 (quiet) closes only once a sample taken INSIDE it
        # has merged — the window query needs an in-window row
        deadline = time.time() + 20
        while newest_ts() <= t0 + 0.2:
            assert time.time() < deadline, "sampler stalled mid-quiet"
            time.sleep(0.05)
        t1 = time.time()
        w1 = posd.perf.get("op_w")
        q1 = posd.perf.dump()["mclock_qwait_us_client"]["count"]
        eb1 = posd.perf.get("ec_batch_coalesced_ops")
        for i in range(6):                    # window 2: traffic
            client.write_full("p", f"w{i}", b"c" * 2048)
        posd.perf.inc("ec_batch_coalesced_ops", 9)  # ec_batch_* probe
        w2 = posd.perf.get("op_w")
        q2 = posd.perf.dump()["mclock_qwait_us_client"]["count"]
        # wait until snapshots covering ALL the burst's counters merge
        wait_merged("op_w", w2)
        wait_merged("ec_batch_coalesced_ops", eb1 + 9)
        wait_merged("mclock_qwait_us_client", q2)
        t2 = time.time()
        now = time.time()

        def mon_query(counter, lo, hi):
            # ABSOLUTE window edges: relative since/until re-anchor to
            # the server clock at execution, and serial admin round
            # trips on a loaded box drift the edges across the burst
            # boundary (observed flake)
            res, data = admin_request(mon_asok, "metrics_query",
                                      registry=reg, counter=counter,
                                      start_ts=lo, end_ts=hi)
            assert res == 0, data
            return data

        quiet = mon_query("op_w", t0, t1)
        busy = mon_query("op_w", t1, t2)
        assert quiet["samples"] >= 2 and busy["samples"] >= 2
        assert quiet["delta"] == w1 - w0 == 0
        assert busy["delta"] == w2 - w1 == 6
        # span_s is rounded for the wire; the rate agrees to within
        # that rounding
        assert abs(busy["rate_per_s"]
                   - busy["delta"] / busy["span_s"]) < 1e-3
        # ec_batch_* rides the same surface
        eb = mon_query("ec_batch_coalesced_ops", t1, t2)
        assert eb["delta"] == 9
        # mclock_qwait histogram: count delta matches the raw registry
        # and the window quantiles are well-formed
        qq = mon_query("mclock_qwait_us_client", t1, t2)
        assert qq["count_delta"] == q2 - q1 > 0
        assert 0.0 <= qq["p50"] <= qq["p99"]
        qquiet = mon_query("mclock_qwait_us_client", t0, t1)
        assert qquiet["count_delta"] == q1 - q0 == 0
        # the local daemon verb serves the same ring
        local = admin_request(asok, "metrics_query", registry=reg,
                              counter="op_w", start_ts=t1, end_ts=t2)
        assert local["delta"] == 6
        # perf_history CLI helpers read the same surfaces
        from ceph_tpu_torch.tools.perf_history import ls, show
        regs = ls(mon_asok)
        assert reg in regs and "op_w" in regs[reg]
        text = show(mon_asok, reg, "op_w", since_s=now - t0)
        assert "rate" in text
    finally:
        c.stop()

# -- from tests/test_perf_query.py --------------------------------------------
def test_render_top_sorts_and_rejects_bad_sort():
    from ceph_tpu_torch.tools.top_tool import render_top
    report = {"qid": 1, "key_by": ["tenant"], "daemons": ["osd.0"],
              "rows": [
                  {"key": ["a"], "ops": 2, "bytes_in": 10, "bytes_out": 0,
                   "lat_count": 2, "avg_us": 5.0, "p50_us": 4.0,
                   "p99_us": 9.0},
                  {"key": ["b"], "ops": 1, "bytes_in": 9000,
                   "bytes_out": 0, "lat_count": 1, "avg_us": 50.0,
                   "p50_us": 40.0, "p99_us": 90.0}]}
    out = render_top(report, sort="bytes")
    lines = out.splitlines()
    assert lines[0].startswith("perf query 1")
    assert lines[3].startswith("b")  # bytes sort puts b first
    out = render_top(report, sort="ops", limit=1)
    assert "b" not in out.splitlines()[-1]
    with pytest.raises(ValueError):
        render_top(report, sort="nope")

def _make_cluster():
    from ceph_tpu_torch.tools.vstart import MiniCluster
    from ceph_tpu_torch.utils.config import default_config
    cfg = default_config()
    cfg.apply_dict({"osd_heartbeat_interval": 0.05,
                    "osd_heartbeat_grace": 0.5,
                    "ec_backend": "native",
                    "osd_op_num_shards": 2})
    return MiniCluster(n_osds=4, cfg=cfg).start()

def test_e2e_attribution_totals_and_kill_revive():
    """The tier-1 e2e: a tenant-grouped standing query registered at
    the mon reaches every OSD through the map, two tenants' ops are
    attributed at the reply edge (direct conn sends AND async EC
    drains), partials merge to totals matching the client op counts,
    the hot tenant tops the report, and an OSD kill/revive neither
    wedges the merge nor double-counts."""
    from ceph_tpu_torch.client.rados import RadosClient
    from ceph_tpu_torch.tools.top_tool import render_top

    c = _make_cluster()
    try:
        admin = c.client()
        admin.create_pool("pool0", kind="ec", pg_num=4,
                          ec_profile={"plugin": "jerasure", "k": "2",
                                      "m": "1", "backend": "numpy"})
        doc = admin.mon_command({"prefix": "perf query add",
                                 "key_by": "tenant", "top_n": 16})
        qid = doc["qid"]

        hot = RadosClient(c.network, "client.hot", mons=c.mon_names,
                          tenant="hot").connect()
        cold = RadosClient(c.network, "client.cold", mons=c.mon_names,
                           tenant="cold").connect()
        data = b"x" * 4096
        for i in range(12):
            hot.write_full("pool0", f"hot-{i}", data)
        for i in range(3):
            cold.write_full("pool0", f"cold-{i}", data)
        for i in range(6):
            assert hot.read("pool0", f"hot-{i}") == data

        # partials ship on the stats cadence; merge within a report
        # interval (the visibility bound)
        deadline = time.time() + 10
        rep = None
        while time.time() < deadline:
            rep = admin.mon_command({"prefix": "perf query report",
                                     "qid": qid})
            if rep["rows"] and sum(r["ops"] for r in rep["rows"]) >= 21:
                break
            time.sleep(0.2)
        rows = {tuple(r["key"]): r for r in rep["rows"]}
        assert rows[("hot",)]["ops"] == 18          # 12 writes + 6 reads
        assert rows[("cold",)]["ops"] == 3
        assert rows[("hot",)]["bytes_in"] == 12 * 4096
        assert rows[("hot",)]["bytes_out"] == 6 * 4096
        assert rows[("hot",)]["p99_us"] > 0
        top = max(rep["rows"], key=lambda r: r["ops"])
        assert top["key"] == ["hot"]                # hot tenant tops
        assert "hot" in render_top(rep, sort="ops")

        # kill/revive: spare fills the hole, degraded IO still
        # attributes, and the revived daemon's reset seq never
        # double-counts pre-crash rows
        epoch = c.mon.osdmap.epoch
        store = c.kill_osd(2)
        c.wait_for_epoch(epoch + 1)
        c.settle(0.5)
        from ceph_tpu_torch.client.rados import RadosError
        done = 0
        deadline = time.time() + 30
        while done < 4 and time.time() < deadline:
            try:
                hot.write_full("pool0", f"hk-{done}", data)
                done += 1
            except RadosError:
                time.sleep(0.25)
        assert done == 4
        c.revive_osd(2, store)
        c.wait_for_up(4)
        deadline = time.time() + 10
        while time.time() < deadline:
            rep2 = admin.mon_command({"prefix": "perf query report",
                                      "qid": qid})
            r2 = {tuple(r["key"]): r for r in rep2["rows"]}
            if r2.get(("hot",), {}).get("ops") == 22:
                break
            time.sleep(0.2)
        assert r2[("hot",)]["ops"] == 22            # 18 + 4, exactly once
        assert r2[("cold",)]["ops"] == 3

        # rm converges: every OSD drops back to the zero-alloc path
        ls = admin.mon_command({"prefix": "perf query ls"})
        assert str(qid) in ls["queries"]
        admin.mon_command({"prefix": "perf query rm", "qid": qid})
        deadline = time.time() + 5
        while time.time() < deadline and any(
                o.perf_queries.active for o in c.osds.values()):
            time.sleep(0.1)
        assert not any(o.perf_queries.active for o in c.osds.values())
    finally:
        c.stop()


# -- the port against the JAX package -----------------------------------------
@pytest.mark.parametrize("argv", [[], ["--tenants", "gold,bul-k, x y"],
                                  ["--dashboard"]])
def test_prom_rules_text_equals_the_references(argv):
    """The rule file and the dashboard JSON the port prints are the
    reference's text, and every metric they name is one the port's
    exporter emits (test_rules_reference_only_emitted_metrics)."""
    out = {}
    for name, mod in (("port", port_prom_rules), ("ref", ref_prom_rules)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert mod.main(list(argv)) == 0
        out[name] = buf.getvalue()
    assert out["port"] == out["ref"]
    assert len(out["port"]) > 1000


def test_tool_formatters_equal_the_references():
    """Seeded inputs through each tool's pure formatter: the same text
    from both packages."""
    rng = np.random.default_rng(96)
    for _ in range(20):
        vals = rng.random(int(rng.integers(0, 80))).tolist()
        width = int(rng.integers(4, 60))
        assert port_perf_history.sparkline(vals, width) == \
            ref_perf_history.sparkline(vals, width)
        samples = [{"ts": float(i), "counters": {"op_w": int(v)}}
                   for i, v in enumerate(np.cumsum(rng.integers(
                       0, 50, int(rng.integers(1, 10)))))]
        assert port_perf_history.interval_rates(samples, "op_w") == \
            ref_perf_history.interval_rates(samples, "op_w")
        ev = {"seq": int(rng.integers(1, 1000)), "ts": 1_760_000_000.5,
              "daemon": f"osd.{int(rng.integers(8))}",
              "channel": str(rng.choice(["pg", "recovery", "cluster"])),
              "level": str(rng.choice(["info", "warn"])),
              "message": "peering done", "fields": {"pg": "1.2"}}
        assert port_event_tool.format_event(ev) == \
            ref_event_tool.format_event(ev)
        rows = [{"key": [f"t{i}"], "ops": int(rng.integers(0, 99)),
                 "bytes_in": int(rng.integers(0, 1 << 20)),
                 "bytes_out": int(rng.integers(0, 1 << 20)),
                 "lat_count": 1, "avg_us": float(rng.random() * 100),
                 "p50_us": 1.0, "p99_us": 2.0} for i in range(4)]
        report = {"qid": 1, "key_by": ["tenant"], "daemons": ["osd.0"],
                  "rows": rows}
        for sort in ("ops", "bytes", "p99"):
            assert port_top_tool.render_top(report, sort=sort, limit=3) \
                == ref_top_tool.render_top(report, sort=sort, limit=3)


def _cli_answers(cli_mod, mc, cfg) -> dict:
    """Cli's verbs on a small cluster after the same writes; the parts
    of each answer that do not depend on timing."""
    c = mc(n_osds=3, cfg=cfg()).start()
    try:
        client = c.client()
        client.create_pool("p", size=2, pg_num=4)
        for i in range(6):
            client.write_full("p", f"o{i}", bytes([i]) * (1000 + i))
        cli = cli_mod.Cli(c)
        dump = cli.osd_dump()
        perf = cli.osd_perf()
        return {"health": cli.health()["checks"],
                "status": sorted(cli.status()),
                "osd_dump": sorted(dump),
                "osd_perf": {k: sorted(v) for k, v in perf.items()},
                "df": cli.df(),
                "scrub": [cli.pg_scrub("p", s) for s in range(4)],
                "config": sorted(cli.config_show())}
    finally:
        c.stop()


def test_cli_verbs_answer_as_the_references():
    """Every Cli verb on a port cluster and on a reference cluster after
    the same writes: the same health checks, keys, pool usage and scrub
    results; the port's OSDs count one counter more, ``op_timeouts``
    (the ops that waited out osd_op_timeout)."""
    port = _cli_answers(port_cli, MiniCluster, make_cfg)
    ref = _cli_answers(ref_cli, ref_vstart.MiniCluster, ref_make_cfg)
    port_perf, ref_perf = port.pop("osd_perf"), ref.pop("osd_perf")
    assert list(port_perf) == list(ref_perf) == ["osd.0", "osd.1", "osd.2"]
    for osd, names in ref_perf.items():
        assert sorted(port_perf[osd]) == sorted(names + ["op_timeouts"])
    assert port == ref
    assert port["df"]["pools"]["p"]["objects"] >= 6


def test_cli_refuses_unknown_commands():
    for mod in (port_cli, ref_cli):
        assert mod.main(["no", "such"]) == 2
        assert mod.main(["daemon", "x.asok"]) == 2


#: the scorecard's check names in the reference's source, in order
_CHECK = re.compile(r'@check\(f?"([^"]+)"\)')


def _scorecard(out: str) -> list[tuple[str, str]]:
    """(check, PASS or FAIL) from the scorecard's lines."""
    return re.findall(r"^  (.+?)\s+(PASS|FAIL)  ", out, re.M)


def _smoke(*argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.smoke", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_smoke_check_names_are_the_references():
    """The port's scorecard declares the reference's checks in the same
    order, the kernel check renamed (it runs the port's fused
    encode+CRC on --device, not a jax graph on a CPU mesh)."""
    with open(ref_smoke.__file__) as f:
        ref = _CHECK.findall(f.read())
    with open(os.path.join(REPO, "ceph_tpu_torch", "tools",
                           "smoke.py")) as f:
        port = _CHECK.findall(f.read())
    assert len(ref) == 15
    assert ref[-1] == "jax kernel parity (CPU mesh)"
    assert port[:-1] == ref[:-1]
    assert port[-1] == "kernel parity (fused encode+crc on {dev.type})"


@pytest.mark.parametrize("quick", [True, False])
def test_smoke_on_the_cpu_passes(quick):
    """``smoke [--quick] --device cpu`` exits 0 with every check PASS:
    the quick slice's five checks or all fifteen."""
    proc = _smoke(*(["--quick"] if quick else []), "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    card = _scorecard(proc.stdout)
    with open(ref_smoke.__file__) as f:
        ref = _CHECK.findall(f.read())
    want = (ref[:4] if quick else ref[:-1]) + [
        "kernel parity (fused encode+crc on cpu)"]
    assert [name for name, _ in card] == want
    assert {mark for _, mark in card} == {"PASS"}
    assert f"smoke: {len(want)}/{len(want)} subsystems ok" in proc.stdout


def test_smoke_without_a_card_exits_2():
    """``--device cuda``, the default, exits 2 where there is no card,
    before any cluster starts."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in ((), ("--device", "cuda")):
        proc = _smoke("--quick", *argv)
        assert proc.returncode == 2
        assert "torch.cuda.is_available() is False" in proc.stderr
        assert "subsystems ok" not in proc.stdout
