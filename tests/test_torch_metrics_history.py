"""Metrics history (utils/metrics_history.py): fixed-budget snapshot
rings, window delta/rate queries verified against raw counter deltas,
pow-2 histogram quantiles, the at-least-once shipping window and the
mon-side seq-deduped merge + staleness surface.  The JAX package's
tests/test_metrics_history.py on ceph_tpu_torch."""

import json

from ceph_tpu_torch.utils.metrics_history import (MetricsHistory,
                                            MetricsHistoryStore,
                                            counter_delta, pow2_quantile,
                                            query_samples)
from ceph_tpu_torch.utils.perf import CounterType, PerfCounters


def _probe_registry():
    pc = PerfCounters("probe")
    pc.add("ops")
    pc.add("qwait_us", CounterType.HISTOGRAM)
    pc.add("lat", CounterType.TIME)
    return pc


def test_sample_window_query_matches_raw_deltas():
    """The acceptance contract: rates over two DISJOINT windows agree
    exactly with the raw counter deltas taken at the window edges."""
    pc = _probe_registry()
    h = MetricsHistory(keep=100)
    now = 1000.0
    h.sample({"probe": pc}, ts=now)
    pc.inc("ops", 7)            # window A traffic
    h.sample({"probe": pc}, ts=now + 10)
    pc.inc("ops", 5)            # window B traffic
    h.sample({"probe": pc}, ts=now + 20)
    qa = h.query("probe", "ops", since_s=20, until_s=10, now=now + 20)
    qb = h.query("probe", "ops", since_s=10, until_s=0, now=now + 20)
    assert qa["delta"] == 7 and qb["delta"] == 5
    assert qa["rate_per_s"] == 7 / 10 and qb["rate_per_s"] == 5 / 10
    # ABSOLUTE window edges answer identically (and win over the
    # relative pair — the drift-proof form operators should use when
    # reconstructing a recorded incident window)
    assert h.query("probe", "ops", since_s=999,
                   start_ts=now, end_ts=now + 10)["delta"] == 7
    assert h.query("probe", "ops",
                   start_ts=now + 10, end_ts=now + 20)["delta"] == 5
    # the full window sees the sum
    q = h.query("probe", "ops", since_s=20, now=now + 20)
    assert q["delta"] == 12 and q["samples"] == 3
    # a short window still answers via the start-edge baseline (the
    # newest sample at-or-before the window start): the movement since
    # that edge is attributed to the window
    q1 = h.query("probe", "ops", since_s=1, now=now + 20)
    assert q1["delta"] == 5 and q1["samples"] == 2
    # a ring with one sample (nothing to difference) errors cleanly
    h1 = MetricsHistory(keep=10)
    h1.sample({"probe": pc}, ts=now)
    qe = h1.query("probe", "ops", since_s=60, now=now + 1)
    assert "error" in qe and qe["samples"] == 1


def test_histogram_quantiles_over_window():
    pc = _probe_registry()
    h = MetricsHistory(keep=100)
    h.sample({"probe": pc}, ts=0.0)
    # window samples: 3us x4, 100us x4 -> p50 inside [2,4), p99 in
    # [64,128)
    for v in (3, 3, 3, 3, 100, 100, 100, 100):
        pc.hinc("qwait_us", v)
    h.sample({"probe": pc}, ts=10.0)
    q = h.query("probe", "qwait_us", since_s=20, now=10.0)
    assert q["count_delta"] == 8
    assert 2.0 <= q["p50"] <= 4.0
    assert 64.0 <= q["p99"] <= 128.0
    # TIME counters difference on their seconds sum
    pc.tinc("lat", 2.5)
    h.sample({"probe": pc}, ts=20.0)
    q = h.query("probe", "lat", since_s=11, now=20.0)
    assert abs(q["delta"] - 2.5) < 1e-9 and q["count_delta"] == 1


def test_pow2_quantile_interpolation_and_edges():
    assert pow2_quantile({}, 0.5) == 0.0
    # all mass in bucket 3 ([4, 8)): quantiles interpolate inside it
    assert 4.0 <= pow2_quantile({3: 10}, 0.5) <= 8.0
    assert pow2_quantile({3: 10}, 0.999) <= 8.0
    # string keys (JSON round-trip) behave identically
    assert pow2_quantile({"3": 10}, 0.5) == pow2_quantile({3: 10}, 0.5)
    # bucket 0 covers [0, 1)
    assert 0.0 <= pow2_quantile({0: 4}, 0.5) < 1.0


def test_counter_reset_clamps_to_zero():
    """A daemon restart zeroes its counters; a window straddling the
    reboot must report post-boot growth, never a negative rate."""
    assert counter_delta(100, 3)["delta"] == 0.0
    d = counter_delta({"sum": 50.0, "count": 9,
                       "buckets_pow2": {2: 9}},
                      {"sum": 1.0, "count": 1, "buckets_pow2": {1: 1}})
    assert d["delta"] == 0.0 and d["count_delta"] == 0
    assert d["buckets_delta"] == {1: 1}


def test_ring_budget_and_json_roundtrip():
    pc = _probe_registry()
    h = MetricsHistory(keep=5)
    for i in range(12):
        pc.inc("ops")
        h.sample({"probe": pc}, ts=float(i))
    dump = h.dump()
    assert len(dump["registries"]["probe"]) == 5  # fixed budget holds
    assert dump["registries"]["probe"][-1]["ts"] == 11.0
    # the query math survives a JSON round trip (admin-socket shape:
    # histogram bucket keys stringify)
    pc.hinc("qwait_us", 5)
    h.sample({"probe": pc}, ts=12.0)
    rows = json.loads(json.dumps(h.dump()))["registries"]["probe"]
    q = query_samples(rows, "qwait_us")
    assert q["count_delta"] == 1 and 4.0 <= q["p99"] <= 8.0


def test_pending_window_and_store_merge_dedupe():
    pc = _probe_registry()
    h = MetricsHistory(keep=50)
    import time as _time
    t0 = _time.time()
    for i in range(4):
        pc.inc("ops")
        h.sample({"probe": pc}, ts=t0 - 30 + i)
    h.sample({"probe": pc}, ts=t0)
    pend = h.pending(max_age=10.0, now=t0)
    assert len(pend["probe"]) == 1  # only the fresh sample re-ships
    store = MetricsHistoryStore(keep=50)
    full = h.pending(max_age=60.0, now=t0)
    assert store.merge("osd.0", full) == 5
    # the re-shipped window dedupes away on seq
    assert store.merge("osd.0", full) == 0
    q = store.query("probe", "ops", since_s=60, now=t0)
    assert q["delta"] == 3  # ops 1..4 minus the first snapshot's 1
    # staleness tracks the newest merged sample per daemon
    st = store.staleness(now=t0 + 7)
    assert abs(st["osd.0"] - 7.0) < 0.01
    # a rebooted daemon restarts seq at 1: reset_daemon drops the
    # floor so the fresh window merges
    h2 = MetricsHistory(keep=50)
    h2.sample({"probe": pc}, ts=t0 + 1)
    assert store.merge("osd.0", h2.pending(60.0, now=t0 + 1)) == 0
    store.reset_daemon("osd.0")
    assert store.merge("osd.0", h2.pending(60.0, now=t0 + 1)) == 1
    # malformed payloads never raise
    assert store.merge("osd.0", None) == 0
    assert store.merge("osd.0", {"probe": "junk"}) == 0
    assert store.merge("osd.0", {"probe": [{"seq": "x"}, 7]}) == 0


def test_store_forgets_silent_daemons():
    """A daemon silent past expire_after ages out of the staleness
    gauge (a decommissioned OSD must not pin the max() alert forever);
    its ring history stays queryable and a return merges fresh."""
    pc = _probe_registry()
    store = MetricsHistoryStore(keep=10, expire_after=600.0)
    store.merge("osd.9", {"probe": [
        {"ts": 1000.0, "seq": 1, "counters": {"ops": 1}}]})
    assert "osd.9" in store.staleness(now=1100.0)
    # past the horizon: gone from the gauge, history still there
    assert store.staleness(now=1000.0 + 601.0) == {}
    assert store.dump(registry="probe")["registries"]["probe"]
    # a returning daemon merges fresh (seq floor was dropped too)
    assert store.merge("osd.9", {"probe": [
        {"ts": 2000.0, "seq": 1, "counters": {"ops": 2}}]}) == 1
    assert "osd.9" in store.staleness(now=2001.0)


def test_downsample_coarse_tier_extends_window_at_same_budget():
    """With downsample_age set, samples aging past the threshold
    migrate into a coarse tier (every 8th kept) under the SAME total
    budget: len(fine) + len(coarse) never exceeds keep, the oldest
    retained sample reaches far beyond what a pure ring could hold,
    and window queries difference seamlessly across the tier seam
    (counters are cumulative, so the math stays exact)."""
    pc = _probe_registry()
    keep = 40
    h = MetricsHistory(keep=keep, downsample_age=20.0)
    for i in range(200):            # 1 Hz for 200 s, ops == ts + 1
        pc.inc("ops")
        h.sample({"probe": pc}, ts=float(i))
    dump = h.dump()
    assert dump["downsample_age"] == 20.0
    rows = dump["registries"]["probe"]
    assert len(rows) <= keep        # budget holds ACROSS both tiers
    ts = [s["ts"] for s in rows]
    assert ts == sorted(ts)         # coarse strictly precedes fine
    # fine tier: full rate inside the age threshold
    fine = [s["ts"] for s in h._rings["probe"]]
    assert len(fine) >= 20
    assert all(round(b - a) == 1 for a, b in zip(fine, fine[1:]))
    # coarse tier: stride-8 history far beyond the pure-ring horizon
    # (keep=40 at 1 Hz would cover only 40 s)
    coarse = [s["ts"] for s in h._coarse["probe"]]
    assert coarse and ts[0] < 199.0 - float(keep)
    assert all(round(b - a) == 8 for a, b in zip(coarse, coarse[1:]))
    # a long window spanning the seam still answers exactly: ops
    # advances 1/s, so delta == span for ANY achievable edge pair
    q = h.query("probe", "ops", since_s=150, now=199.0)
    assert q["samples"] >= 2
    assert q["delta"] == q["t1"] - q["t0"]
    # the mon-side store grows the same tier through merge()
    store = MetricsHistoryStore(keep=keep, downsample_age=20.0)
    for i in range(0, 200, 10):     # ship in 10-sample windows
        store.merge("osd.0", {"probe": rows_between(h, i, i + 10)})
    srows = store.dump()["registries"]["probe"]
    assert len(srows) <= keep
    sts = [s["ts"] for s in srows]
    assert sts == sorted(sts) and sts[0] < sts[-1] - float(keep)


def test_coarse_tier_boundary_windows_tile_exactly():
    """Adjacent DISJOINT windows laid across the fine/coarse migration
    seam tile: each window's baseline edge is the previous window's end
    edge, so the per-window deltas sum to the whole-span delta with no
    op counted twice or dropped — even though the coarse tier keeps
    only every 8th sample.  This is the contract dashboards differencing
    consecutive scrapes rely on."""
    pc = _probe_registry()
    h = MetricsHistory(keep=40, downsample_age=20.0)
    for i in range(200):            # 1 Hz, cumulative ops == ts + 1
        pc.inc("ops")
        h.sample({"probe": pc}, ts=float(i))
    # the seam sits downsample_age behind the newest stamp (199 - 20);
    # tile 30s windows across [139, 199] so window edges land on both
    # sides of it
    assert h._coarse["probe"] and h._rings["probe"]
    seam = float(h._rings["probe"][0]["ts"])
    assert 139.0 < seam <= 179.0
    qa = h.query("probe", "ops", start_ts=139.0, end_ts=169.0)
    qb = h.query("probe", "ops", start_ts=169.0, end_ts=199.0)
    qall = h.query("probe", "ops", start_ts=139.0, end_ts=199.0)
    # end edge of A IS the baseline of B: spans meet with no gap
    assert qa["t1"] == qb["t0"]
    assert qa["delta"] + qb["delta"] == qall["delta"]
    # cumulative counters make every achievable delta exact: 1 op/s
    assert qa["delta"] == qa["t1"] - qa["t0"]
    assert qb["delta"] == qb["t1"] - qb["t0"]
    # a window ENTIRELY inside the coarse tier still answers (stride-8
    # edges only, but the cumulative difference stays exact)
    qc = h.query("probe", "ops", start_ts=10.0, end_ts=80.0)
    assert qc["samples"] >= 2 and qc["delta"] == qc["t1"] - qc["t0"]
    # window() exposes the same tiling at the row level
    wa = h.window("probe", since_s=60.0, until_s=30.0, now=199.0)
    wb = h.window("probe", since_s=30.0, until_s=0.0, now=199.0)
    assert wa[-1]["ts"] == wb[0]["ts"]


def test_counters_discovery_tracks_newest_sample():
    """counters() lists the NEWEST sample's counter names — the
    discovery surface SLO wildcards expand against — so per-tenant
    series appear as soon as a sample carries them and the answer
    follows churn instead of accreting forever."""
    pc = PerfCounters("mclock")
    pc.add("qwait_us_tenant_a", CounterType.HISTOGRAM)
    h = MetricsHistory(keep=10)
    assert h.counters("mclock") == []       # empty ring -> empty list
    h.sample({"mclock": pc}, ts=1.0)
    assert h.counters("mclock") == ["qwait_us_tenant_a"]
    pc.add("qwait_us_tenant_b", CounterType.HISTOGRAM)
    h.sample({"mclock": pc}, ts=2.0)
    assert h.counters("mclock") == ["qwait_us_tenant_a",
                                    "qwait_us_tenant_b"]
    # the store-side face answers identically after a merge
    store = MetricsHistoryStore(keep=10)
    store.merge("osd.0", h.pending(max_age=60.0, now=2.0))
    assert store.counters("mclock") == ["qwait_us_tenant_a",
                                        "qwait_us_tenant_b"]


def rows_between(h, lo, hi):
    """Shipping-window helper: h's samples with lo <= ts < hi (the
    merge path wants seq-ordered lists, which sample() guarantees)."""
    return [{"ts": float(t), "seq": t + 1,
             "counters": {"ops": t + 1}} for t in range(lo, hi)]
