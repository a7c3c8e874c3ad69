"""Exemplar-linked histograms + SLO burn math, on the port (the JAX
package's tests/test_exemplars.py on ceph_tpu_torch).

The three layers' pure surfaces, no cluster: the pow-2 histogram's
per-bucket exemplar reservoir (zero state unsampled, recency ring
sampled), the exporter's OpenMetrics rendering (exemplar suffixes that
a strict parse accepts, while the classic 0.0.4 body stays
byte-identical to the pre-exemplar schema), the metrics-history
round-trip (exemplars survive the JSON wire and the mon's seq-deduped
merge), and the SLO objective grammar + error-budget burn math the mgr
module alerts on.  The live-cluster halves are in
tests/test_observability.py.
"""

import json
import re

import pytest

from ceph_tpu_torch.mon.exporter import render_metrics
from ceph_tpu_torch.utils.perf import (EXEMPLAR_KEEP, CounterType, PerfCounters,
                                 global_perf)

# ---------------------------------------------------------------- perf


def test_exemplar_reservoir_recency_and_schema():
    pc = PerfCounters("probe")
    pc.add("lat_us", CounterType.HISTOGRAM)
    # unsampled observations allocate NO exemplar state
    pc.hinc("lat_us", 3.0)
    assert pc._counters["lat_us"].exemplars is None
    d = pc.dump()["lat_us"]
    assert set(d) == {"buckets_pow2", "count", "sum"}  # schema parity
    # sampled observations join their bucket's recency ring
    for i in range(EXEMPLAR_KEEP + 2):
        pc.hinc("lat_us", 3.0, exemplar=100 + i)
    d = pc.dump()["lat_us"]
    ring = d["exemplars"][2]  # 3.0 -> bucket 2 ([2, 4))
    # newest EXEMPLAR_KEEP win, oldest evicted, order preserved
    assert [e["trace_id"] for e in ring] == \
        [100 + i for i in range(2, EXEMPLAR_KEEP + 2)]
    assert all(e["value"] == 3.0 and e["ts"] > 0 for e in ring)
    # other buckets untouched; a different bucket gets its own ring
    pc.hinc("lat_us", 300.0, exemplar=999)
    ex = pc.dump()["lat_us"]["exemplars"]
    assert sorted(ex) == [2, 9]
    assert [e["trace_id"] for e in ex[9]] == [999]


# ------------------------------------------------------------ exporter

_EXEMPLAR_RE = re.compile(
    r'^(?P<sample>\S+(?:\{[^}]*\})?) (?P<value>\S+)'
    r'(?: # \{trace_id="(?P<tid>\d+)"\} (?P<exval>\S+) (?P<exts>\S+))?$')


def _parse_openmetrics_strict(body: str):
    """Strict OpenMetrics 1.0 parse: the classic grouping invariants
    (single HELP/TYPE, contiguous groups) PLUS the # EOF terminator,
    and exemplar suffixes accepted only on histogram _bucket lines.
    Returns {metric: {"type", "samples": {labelstr: value},
    "exemplars": {labelstr: (trace_id, value, ts)}}}."""
    assert body.endswith("# EOF\n"), "missing OpenMetrics EOF terminator"
    lines = body.splitlines()
    assert lines[-1] == "# EOF"
    assert "# EOF" not in lines[:-1], "EOF before the end"
    metrics: dict[str, dict] = {}
    current = None
    closed: set[str] = set()
    for line in lines[:-1]:
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name = line.split(" ", 3)[2]
            assert name not in metrics, f"duplicate HELP for {name}"
            if current is not None:
                closed.add(current)
            assert name not in closed, f"{name} group reopened"
            metrics[name] = {"type": None, "samples": {},
                             "exemplars": {}}
            current = name
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            name, typ = parts[2], parts[3]
            assert name == current, f"TYPE {name} outside its group"
            assert metrics[name]["type"] is None
            metrics[name]["type"] = typ
            continue
        m = _EXEMPLAR_RE.match(line)
        assert m, f"unparsable sample line: {line!r}"
        sample = m.group("sample")
        name = sample.split("{", 1)[0]
        assert name == current, \
            f"sample {name} outside its group (current {current})"
        assert sample not in metrics[name]["samples"], \
            f"duplicate sample {sample}"
        metrics[name]["samples"][sample] = float(m.group("value"))
        if m.group("tid") is not None:
            # exemplars only make sense on bucket series
            assert name.endswith("_bucket"), \
                f"exemplar on a non-bucket line: {line!r}"
            metrics[name]["exemplars"][sample] = (
                int(m.group("tid")), float(m.group("exval")),
                float(m.group("exts")))
    for name, m in metrics.items():
        assert m["type"] is not None, f"{name} has no TYPE"
        assert m["samples"], f"{name} has no samples"
    return metrics


def test_openmetrics_exemplars_parse_and_classic_parity():
    """The exporter's two faces over ONE exemplar-laden registry: the
    OpenMetrics body carries the bucket's newest exemplar and passes a
    strict parse; the classic 0.0.4 body is byte-identical to the same
    registry rendered without any exemplars captured (the pre-exemplar
    schema — classic parsers never see exemplar syntax)."""
    values = (3.0, 10.0, 300.0)
    pc = global_perf().create("ex_probe")
    pc.add("lat_us", CounterType.HISTOGRAM)
    for i, v in enumerate(values):
        pc.hinc("lat_us", v, exemplar=0xA0 + i)
    pc.hinc("lat_us", 3.5, exemplar=0xAF)  # bucket 2 again: newest wins
    try:
        classic_with = render_metrics(None)
        om = render_metrics(None, openmetrics=True)
    finally:
        global_perf().remove("ex_probe")
    # classic: no exemplar syntax anywhere, no EOF
    assert "trace_id" not in classic_with
    assert "# EOF" not in classic_with
    parsed = _parse_openmetrics_strict(om)
    fam = parsed["ceph_tpu_daemon_lat_us_bucket"]
    exs = {s: e for s, e in fam["exemplars"].items()
           if 'daemon="ex_probe"' in s}
    by_le = {re.search(r'le="([^"]+)"', s).group(1): e
             for s, e in exs.items()}
    # bucket 2 (le=4) carries its NEWEST exemplar, not the first
    assert by_le["4"][0] == 0xAF and by_le["4"][1] == 3.5
    assert by_le["16"][0] == 0xA1 and by_le["16"][1] == 10.0
    assert by_le["512"][0] == 0xA2
    # +Inf never carries one (it is a synthetic total)
    assert "+Inf" not in by_le
    # parity: the same observations with NO exemplars render the
    # byte-identical classic body
    pc = global_perf().create("ex_probe")
    pc.add("lat_us", CounterType.HISTOGRAM)
    for v in values:
        pc.hinc("lat_us", v)
    pc.hinc("lat_us", 3.5)
    try:
        classic_without = render_metrics(None)
    finally:
        global_perf().remove("ex_probe")
    assert classic_with == classic_without


# ----------------------------------------------------- metrics history


def test_exemplars_survive_wire_roundtrip_and_merge_dedupe():
    """Exemplars ride the stats-report wire (JSON stringifies bucket
    keys) into the mon store's seq-deduped merge, and a window query
    returns them with int bucket keys, deduped by trace_id across
    re-shipped snapshots (reservoirs ship their CURRENT contents with
    every report)."""
    from ceph_tpu_torch.utils.metrics_history import (MetricsHistory,
                                                MetricsHistoryStore)
    pc = PerfCounters("osd.7")
    pc.add("op_lat_us", CounterType.HISTOGRAM)
    hist = MetricsHistory()
    hist.sample({"osd.7": pc})            # baseline edge
    pc.hinc("op_lat_us", 50_000.0, exemplar=0xABC)   # bucket 16
    pc.hinc("op_lat_us", 200_000.0, exemplar=0xDEF)  # bucket 18
    hist.sample({"osd.7": pc})
    hist.sample({"osd.7": pc})            # reservoir re-shipped
    payload = hist.pending(60.0)
    wire = json.loads(json.dumps(payload))  # the admin/report wire
    store = MetricsHistoryStore()
    assert store.merge("osd.7", wire) == 3
    assert store.merge("osd.7", wire) == 0  # seq dedupe on re-delivery
    q = store.query("osd.7", "op_lat_us", since_s=60.0)
    assert q["count_delta"] == 2
    exs = q["exemplars"]
    assert sorted(exs) == [16, 18]  # int keys restored from the wire
    # one entry per trace despite appearing in two merged snapshots
    assert [e["trace_id"] for e in exs[16]] == [0xABC]
    assert [e["trace_id"] for e in exs[18]] == [0xDEF]
    assert exs[18][0]["value"] == 200_000.0


# ------------------------------------------------------------ slo math


def test_parse_objectives_grammar():
    from ceph_tpu_torch.slo.objectives import parse_objective, parse_objectives
    o = parse_objective("client_op_p99<=20ms@99%")
    assert (o.registry_prefix, o.counter) == ("osd.", "op_lat_us")
    assert o.threshold_us == 20_000.0 and o.target == 0.99
    assert o.name == "client_op_p99<=20ms@99%"
    # the _pNN suffix is cosmetic; units scale; explicit pair spelling
    assert parse_objective("qwait_client<=5ms@99.9%").threshold_us \
        == 5_000.0
    o2 = parse_objective("msg.:msg_dispatch_us<=150us@95%")
    assert (o2.registry_prefix, o2.counter) == ("msg.", "msg_dispatch_us")
    assert o2.threshold_us == 150.0
    many = parse_objectives(
        "client_op<=20ms@99%, ec_batch_wait<=1ms@90%\n"
        "qwait_recovery<=1s@50%")
    assert [o.counter for o in many] == \
        ["op_lat_us", "ec_batch_wait_us", "mclock_qwait_us_recovery"]
    assert parse_objectives("") == []
    for bad in ("client_op<=20ms", "client_op<=20ms@0%",
                "client_op<=20ms@100%", "nope<=1ms@99%",
                "client_op<=1parsec@99%"):
        with pytest.raises(ValueError):
            parse_objective(bad)


def test_bad_fraction_interpolates_crossing_bucket():
    from ceph_tpu_torch.slo.objectives import bad_fraction, burn_rate
    # bucket 14 = [8192, 16384) all under 20ms; bucket 16 =
    # [32768, 65536) all over; empty window is all-good
    assert bad_fraction({14: 10, 16: 5}, 20_000.0) == (5 / 15, 15)
    assert bad_fraction({}, 20_000.0) == (0.0, 0)
    # the crossing bucket (15 = [16384, 32768)) contributes linearly:
    # (32768 - 20000) / 16384 of its population is over
    frac, total = bad_fraction({15: 100}, 20_000.0)
    assert total == 100
    assert frac == pytest.approx((32768 - 20000) / 16384)
    # wire-stringified keys normalize
    assert bad_fraction({"16": 5, "14": 5}, 20_000.0) == (0.5, 10)
    # burn: budget multiple, clamped finite
    assert burn_rate(0.02, 0.99) == pytest.approx(2.0)
    assert burn_rate(1.0, 0.999999999) == 1e6


def test_worst_bucket_exemplars_picks_offenders_newest_first():
    from ceph_tpu_torch.slo.objectives import worst_bucket_exemplars
    exs = {
        "14": [{"trace_id": 1, "value": 9_000.0, "ts": 10.0}],   # good
        "16": [{"trace_id": 2, "value": 40_000.0, "ts": 11.0},
               {"trace_id": 3, "value": 50_000.0, "ts": 12.0}],
        "18": [{"trace_id": 4, "value": 200_000.0, "ts": 13.0}],
    }
    out = worst_bucket_exemplars(exs, 20_000.0, keep=2)
    # highest offending bucket first; bucket 14 (under threshold) never
    assert [e["trace_id"] for e in out] == [4, 2]
    assert out[0]["bucket"] == 18
    assert worst_bucket_exemplars({}, 20_000.0) == []
    assert worst_bucket_exemplars({"10": exs["14"]}, 20_000.0) == []


def test_evaluate_objective_aggregates_registries():
    """Multiwindow evaluation over a mon-shaped store: bucket deltas
    aggregate across every prefix-matched registry, burns compute per
    window, and the fast window's worst-bucket exemplars ride along."""
    from ceph_tpu_torch.slo.objectives import evaluate_objective, parse_objective
    from ceph_tpu_torch.utils.metrics_history import (MetricsHistory,
                                                MetricsHistoryStore)
    store = MetricsHistoryStore()
    for osd, tid in (("osd.0", 0x111), ("osd.1", 0x222)):
        pc = PerfCounters(osd)
        pc.add("op_lat_us", CounterType.HISTOGRAM)
        h = MetricsHistory()
        h.sample({osd: pc})
        pc.hinc("op_lat_us", 5_000.0)                  # good
        pc.hinc("op_lat_us", 100_000.0, exemplar=tid)  # bad (bucket 17)
        h.sample({osd: pc})
        store.merge(osd, json.loads(json.dumps(h.pending(60.0))))
    obj = parse_objective("client_op<=20ms@99%")
    r = evaluate_objective(obj, store, fast_s=60.0, slow_s=120.0)
    assert sorted(r["registries"]) == ["osd.0", "osd.1"]
    for w in ("fast", "slow"):
        assert r[w]["observations"] == 4
        assert r[w]["bad_fraction"] == pytest.approx(0.5)
        assert r[w]["burn"] == pytest.approx(50.0)
    assert {e["trace_id"] for e in r["exemplars"]} == {0x111, 0x222}
    assert all(e["bucket"] == 17 for e in r["exemplars"])


def test_parse_wildcard_objective():
    from ceph_tpu_torch.slo.objectives import parse_objective
    o = parse_objective("mclock_qwait_us_tenant_*_p99<=50ms@99%")
    assert o.registry_prefix == "osd."
    assert o.counter == "mclock_qwait_us_tenant_*"  # _p99 is cosmetic
    assert o.threshold_us == 50_000.0 and o.target == 0.99
    # explicit prefix:counter spelling carries the wildcard too
    o2 = parse_objective("msg.:msg_dispatch_*<=1ms@95%")
    assert (o2.registry_prefix, o2.counter) == ("msg.", "msg_dispatch_*")
    # ...but never in the registry prefix (that would let one objective
    # fan out across unrelated daemon classes)
    with pytest.raises(ValueError):
        parse_objective("os*.:op_lat_us<=1ms@95%")


def test_expand_counters_matches_discovered_series_only():
    """Wildcard expansion answers from counter names the store has
    actually seen; ``*`` spans one [A-Za-z0-9_]+ run, so a hostile
    name cannot smuggle dots/colons into a synthesized objective."""
    from ceph_tpu_torch.slo.objectives import expand_counters
    from ceph_tpu_torch.utils.metrics_history import MetricsHistoryStore
    store = MetricsHistoryStore()
    store.merge("osd.0", {"osd.0": [{"ts": 1.0, "seq": 1, "counters": {
        "mclock_qwait_us_tenant_a": {}, "mclock_qwait_us_tenant_b": {},
        "mclock_qwait_us_tenant_evil.x": {}, "op_lat_us": {}}}]})
    store.merge("osd.1", {"osd.1": [{"ts": 1.0, "seq": 1, "counters": {
        "mclock_qwait_us_tenant_b": {}, "mclock_qwait_us_tenant_c": {}}}]})
    # a registry outside the prefix never contributes
    store.merge("mon", {"msg.mon": [{"ts": 1.0, "seq": 1, "counters": {
        "mclock_qwait_us_tenant_z": {}}}]})
    got = expand_counters("mclock_qwait_us_tenant_*", store, "osd.")
    assert got == ["mclock_qwait_us_tenant_a", "mclock_qwait_us_tenant_b",
                   "mclock_qwait_us_tenant_c"]
    assert expand_counters("nothing_*", store, "osd.") == []


def test_evaluate_wildcard_reports_worst_tenant_series():
    """A wildcard objective evaluates every discovered series and
    reports AS the worst one (highest fast burn): the mgr's burn
    thresholding is unchanged, and the detail names the tenant."""
    from ceph_tpu_torch.slo.objectives import evaluate_objective, parse_objective
    from ceph_tpu_torch.utils.metrics_history import (MetricsHistory,
                                                MetricsHistoryStore)
    store = MetricsHistoryStore()
    pc = PerfCounters("osd.0")
    pc.add("mclock_qwait_us_tenant_good", CounterType.HISTOGRAM)
    pc.add("mclock_qwait_us_tenant_noisy", CounterType.HISTOGRAM)
    h = MetricsHistory()
    h.sample({"osd.0": pc})
    for _ in range(4):
        pc.hinc("mclock_qwait_us_tenant_good", 5_000.0)    # under 50ms
        pc.hinc("mclock_qwait_us_tenant_noisy", 5_000.0)
        pc.hinc("mclock_qwait_us_tenant_noisy", 400_000.0)  # way over
    h.sample({"osd.0": pc})
    store.merge("osd.0", json.loads(json.dumps(h.pending(60.0))))
    obj = parse_objective("mclock_qwait_us_tenant_*<=50ms@99%")
    r = evaluate_objective(obj, store, fast_s=60.0, slow_s=120.0)
    assert r["objective"] == obj.name
    assert r["worst_series"] == "mclock_qwait_us_tenant_noisy"
    assert r["counter"] == "mclock_qwait_us_tenant_noisy"
    assert r["fast"]["bad_fraction"] == pytest.approx(0.5)
    assert r["fast"]["burn"] == pytest.approx(50.0)
    by_name = {s["counter"]: s for s in r["series"]}
    assert set(by_name) == {"mclock_qwait_us_tenant_good",
                            "mclock_qwait_us_tenant_noisy"}
    assert by_name["mclock_qwait_us_tenant_good"]["fast_burn"] == 0.0
    assert by_name["mclock_qwait_us_tenant_noisy"]["observations"] == 8
    # nothing discovered yet -> inert zero-burn result, not an error
    empty = evaluate_objective(obj, MetricsHistoryStore(),
                               fast_s=60.0, slow_s=120.0)
    assert empty["fast"]["burn"] == 0.0 and empty["slow"]["burn"] == 0.0
    assert empty["worst_series"] is None and empty["series"] == []
