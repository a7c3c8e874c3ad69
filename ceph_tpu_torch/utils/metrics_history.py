"""In-cluster metrics history: fixed-budget time-series rings over
PerfCounters registries, with delta/rate and pow2-histogram-quantile
queries over arbitrary windows.

The reference's metrics path is scrape-only (mgr prometheus answers
"now"; history lives in an external TSDB).  Under saturation the
question that matters is retrospective — "what was mclock_qwait_us
doing five minutes ago when the tail blew up?" — so every daemon keeps
a bounded ring of periodic registry snapshots (sampled in its
heartbeat tick), ships the recent window inside its MStatsReport
increments (at-least-once, seq-deduped mon-side, exactly like the
event journal), and the monitor merges them into one queryable store
served by the ``dump_metrics_history`` / ``metrics_query`` verbs and
the ``tools/perf_history.py`` CLI.

A sample is a plain dict — it crosses the stats-report wire and the
admin socket unchanged::

    {"ts": float, "seq": int, "counters": PerfCounters.dump()}

Counter values inside a snapshot keep the dump() shapes: plain numbers
(COUNTER/U64), ``{"sum_seconds", "count"}`` (TIME), ``{"sum", "count",
"avg"}`` (LONGRUNAVG) and ``{"buckets_pow2", "count", "sum"}``
(HISTOGRAM).  Queries subtract the window-edge snapshots: plain
counters yield delta + rate, histograms yield a bucket-delta whose
pow-2 quantiles are interpolated within the crossing bucket — the same
[2^(b-1), 2^b) geometry ``histogram_quantile`` assumes over the
exporter's cumulative buckets, so the two surfaces agree by
construction.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["MetricsHistory", "MetricsHistoryStore", "counter_delta",
           "pow2_quantile", "query_samples", "window_exemplars"]


def pow2_quantile(bucket_delta: dict, q: float) -> float:
    """Quantile of a pow-2 bucket-count delta: bucket b covers
    [2^(b-1), 2^b) (b=0 covers [0, 1)); the value is interpolated
    linearly within the bucket the target rank lands in."""
    bd = {int(k): int(v) for k, v in bucket_delta.items()}
    total = sum(bd.values())
    if total <= 0:
        return 0.0
    target = max(1e-12, q * total)
    acc = 0
    for b in sorted(bd):
        n = bd[b]
        if n <= 0:
            continue
        if acc + n >= target:
            lo = 0.0 if b == 0 else float(2 ** (b - 1))
            hi = 1.0 if b == 0 else float(2 ** b)
            return lo + (target - acc) / n * (hi - lo)
        acc += n
    return 0.0


def _num(v) -> float:
    return float(v) if isinstance(v, (int, float)) else 0.0


def counter_delta(first, last) -> dict:
    """Difference of one counter between two snapshot values (the
    window-edge subtraction).  Returns {"delta"} for plain counters,
    {"delta", "count_delta"} for sum/count shapes, and adds
    {"buckets_delta"} for histograms.  A daemon restart (counter reset)
    clamps negatives to zero — a window straddling a reboot reports
    the post-boot growth, never a negative rate."""
    if isinstance(last, dict):
        first = first if isinstance(first, dict) else {}
        sum_key = "sum_seconds" if "sum_seconds" in last else "sum"
        out = {"delta": max(0.0, _num(last.get(sum_key))
                            - _num(first.get(sum_key))),
               "count_delta": max(0, int(_num(last.get("count"))
                                         - _num(first.get("count"))))}
        if "buckets_pow2" in last:
            # JSON round-trips (admin socket) stringify bucket keys;
            # normalize both edges to int before differencing
            fb = {int(k): int(v)
                  for k, v in (first.get("buckets_pow2") or {}).items()}
            out["buckets_delta"] = {
                b: n - fb.get(b, 0)
                for b, n in ((int(k), int(v)) for k, v in
                             last["buckets_pow2"].items())
                if n - fb.get(b, 0) > 0}
        return out
    return {"delta": max(0.0, _num(last) - _num(first))}


def window_exemplars(samples: list[dict], counter: str,
                     t0: float, t1: float) -> dict:
    """Per-bucket exemplars whose capture ts falls inside (t0, t1],
    collected across every snapshot in the window (snapshots carry the
    reservoir's CURRENT contents, so later snapshots supersede —
    newest capture wins, deduped by trace_id per bucket)."""
    out: dict[int, list] = {}
    for s in samples:
        c = (s.get("counters") or {}).get(counter)
        if not isinstance(c, dict):
            continue
        for b, exs in (c.get("exemplars") or {}).items():
            if not isinstance(exs, list):
                continue
            bucket = int(b)  # JSON round-trips stringify the key
            for e in exs:
                ts = float(e.get("ts", 0.0))
                if not (t0 < ts <= t1):
                    continue
                ring = out.setdefault(bucket, [])
                tid = e.get("trace_id")
                ring[:] = [x for x in ring
                           if x.get("trace_id") != tid]
                ring.append({"trace_id": tid,
                             "value": e.get("value"), "ts": ts})
    return {b: sorted(v, key=lambda e: -e["ts"])
            for b, v in sorted(out.items())}


def query_samples(samples: list[dict], counter: str) -> dict:
    """Delta/rate (+ histogram quantiles) of ``counter`` across a
    window of snapshots (oldest first).  Needs >= 2 samples to
    difference; fewer yields {"samples": n, "error": ...}."""
    rows = [s for s in samples if counter in (s.get("counters") or {})]
    if len(rows) < 2:
        return {"samples": len(rows),
                "error": "need >= 2 samples in the window"}
    first, last = rows[0], rows[-1]
    span_s = max(1e-9, float(last["ts"]) - float(first["ts"]))
    d = counter_delta(first["counters"][counter],
                      last["counters"][counter])
    out = {"samples": len(rows), "t0": float(first["ts"]),
           "t1": float(last["ts"]), "span_s": round(span_s, 6),
           "delta": d["delta"],
           "rate_per_s": d["delta"] / span_s}
    if "count_delta" in d:
        out["count_delta"] = d["count_delta"]
        out["count_rate_per_s"] = d["count_delta"] / span_s
    if "buckets_delta" in d:
        out["buckets_delta"] = dict(d["buckets_delta"])
        out["p50"] = pow2_quantile(d["buckets_delta"], 0.50)
        out["p99"] = pow2_quantile(d["buckets_delta"], 0.99)
        # bucket exemplars captured inside the window ride along, so a
        # quantile spike resolves directly to trace_ids — the key is
        # present only when something was captured (schema parity with
        # the exemplar-free dump)
        exs = window_exemplars(rows, counter, out["t0"], out["t1"])
        if exs:
            out["exemplars"] = exs
    return out


class _HistoryRings:
    """Shared ring machinery: bounded per-registry snapshot deques +
    the dump/window/query read surface.

    With ``downsample_age > 0`` each registry grows a COARSE
    long-horizon tier: samples aging past the threshold migrate out of
    the fine ring, every ``_STRIDE``-th surviving (the rest dropped),
    under the SAME total budget — ``len(fine) + len(coarse) <= keep``,
    enforced by evicting the coarse tier's oldest.  The retrospective
    window stretches toward ~``_STRIDE``x at unchanged memory; queries
    read both tiers seamlessly (a coarse edge sample still baselines a
    long window, just at stride-coarse time resolution).  Counters are
    cumulative, so differencing across coarse edges stays exact — only
    the achievable edge placement coarsens."""

    _STRIDE = 8

    def __init__(self, keep: int = 600, downsample_age: float = 0.0):
        self.keep = max(2, int(keep))
        self.downsample_age = max(0.0, float(downsample_age))
        self._lock = threading.Lock()
        self._rings: dict[str, deque] = {}
        self._coarse: dict[str, deque] = {}
        self._coarse_n: dict[str, int] = {}

    def _ring(self, registry: str) -> deque:
        ring = self._rings.get(registry)
        if ring is None:
            ring = self._rings[registry] = deque(maxlen=self.keep)
            self._coarse[registry] = deque(maxlen=self.keep)
        return ring

    def _migrate_locked(self, registry: str) -> None:
        """Age fine samples past ``downsample_age`` (relative to the
        ring's NEWEST stamp — deterministic under replayed clocks) into
        the coarse tier, keeping every ``_STRIDE``-th.  Caller holds
        _lock and must call this BEFORE appending so the fine deque's
        maxlen backstop never silently drops a migratable sample."""
        if self.downsample_age <= 0.0:
            return
        fine = self._rings.get(registry)
        if not fine:
            return
        coarse = self._coarse[registry]
        cutoff = float(fine[-1]["ts"]) - self.downsample_age
        while fine and float(fine[0]["ts"]) < cutoff:
            s = fine.popleft()
            n = self._coarse_n.get(registry, 0)
            self._coarse_n[registry] = n + 1
            if n % self._STRIDE == 0:
                coarse.append(s)
        # total budget, with one slot reserved for the append the
        # caller is about to do (migration always precedes it)
        while len(fine) + len(coarse) >= self.keep and coarse:
            coarse.popleft()

    def _rows_locked(self, registry: str) -> list[dict]:
        """Both tiers, oldest first (coarse strictly precedes fine:
        migration is in ts order)."""
        coarse = self._coarse.get(registry)
        fine = self._rings.get(registry)
        return list(coarse or ()) + list(fine or ())

    def registries(self) -> list[str]:
        with self._lock:
            return sorted(self._rings)

    def counters(self, registry: str) -> list[str]:
        """Counter names the registry's NEWEST sample carries — the
        discovery surface SLO metric wildcards expand against (e.g.
        mclock_qwait_us_tenant_* -> one objective per live tenant
        series)."""
        with self._lock:
            ring = self._rings.get(registry)
            newest = ring[-1] if ring else None
            if newest is None:
                coarse = self._coarse.get(registry)
                newest = coarse[-1] if coarse else None
            if newest is None:
                return []
            return sorted((newest.get("counters") or {}).keys())

    def window(self, registry: str, since_s: float,
               until_s: float = 0.0, now: float | None = None
               ) -> list[dict]:
        """Snapshots covering (now - since_s, now - until_s], oldest
        first, PLUS the newest sample at-or-before the window start as
        the baseline edge.  Differencing rows[0] vs rows[-1] then
        means "the counter's movement across this window" — traffic
        landing between the edge sample and the first inside sample is
        counted, and two adjacent disjoint windows tile exactly (the
        end edge of one IS the baseline of the next)."""
        now = time.time() if now is None else now
        lo, hi = now - float(since_s), now - float(until_s)
        with self._lock:
            rows = self._rows_locked(registry)
            if not rows:
                return []
            inside = [s for s in rows if lo < s["ts"] <= hi]
            before = [s for s in rows if s["ts"] <= lo]
        baseline = [max(before, key=lambda s: s["ts"])] if before else []
        return baseline + inside

    def last_ts(self, registry: str) -> float:
        with self._lock:
            ring = self._rings.get(registry)
            if ring:
                return float(ring[-1]["ts"])
            coarse = self._coarse.get(registry)
            return float(coarse[-1]["ts"]) if coarse else 0.0

    def query(self, registry: str, counter: str, since_s: float = 60.0,
              until_s: float = 0.0, now: float | None = None,
              start_ts: float | None = None,
              end_ts: float | None = None) -> dict:
        """The ``metrics_query`` document: delta/rate (+ pow-2
        quantiles for histograms) of one counter over the window.
        ``start_ts``/``end_ts`` pin ABSOLUTE window edges (epoch
        seconds) and win over the relative since/until pair — relative
        windows re-anchor to the server's clock at execution, so a
        caller reconstructing a past incident should pass the exact
        stamps it recorded."""
        if start_ts is not None or end_ts is not None:
            hi = float(end_ts) if end_ts is not None \
                else (time.time() if now is None else now)
            lo = float(start_ts) if start_ts is not None \
                else hi - float(since_s)
            now, since_s, until_s = hi, hi - lo, 0.0
        rows = self.window(registry, since_s, until_s, now=now)
        out = query_samples(rows, counter)
        out["registry"] = registry
        out["counter"] = counter
        return out

    def dump(self, registry: str | None = None,
             max_samples: int = 0) -> dict:
        """The ``dump_metrics_history`` document: ring contents per
        registry (newest last), optionally registry-filtered and
        tail-capped."""
        with self._lock:
            names = [registry] if registry else sorted(self._rings)
            out = {}
            for n in names:
                rows = self._rows_locked(n)
                if max_samples and len(rows) > int(max_samples):
                    rows = rows[-int(max_samples):]
                out[n] = rows
        return {"registries": out, "keep": self.keep,
                "downsample_age": self.downsample_age}


class MetricsHistory(_HistoryRings):
    """Daemon-side history: periodic ``sample()`` of the daemon's own
    registries from its tick, plus the at-least-once shipping window
    (``pending``) the stats report carries — entries re-ship with
    every report until they age past the resend window, and the mon
    dedupes by ``seq`` (reports drop silently on a lossy wire, so no
    delivery signal is trusted; the event journal pioneered this
    contract)."""

    def __init__(self, keep: int = 600, downsample_age: float = 0.0):
        super().__init__(keep, downsample_age)
        self._seq = 0

    def sample(self, registries: dict, ts: float | None = None) -> int:
        """Snapshot every given registry (name -> PerfCounters) at one
        shared timestamp.  Returns the sample seq."""
        ts = time.time() if ts is None else float(ts)
        dumps = {name: pc.dump() for name, pc in registries.items()}
        with self._lock:
            self._seq += 1
            for name, counters in dumps.items():
                self._migrate_locked(name)
                self._ring(name).append(
                    {"ts": ts, "seq": self._seq, "counters": counters})
        return self._seq

    def pending(self, max_age: float, now: float | None = None) -> dict:
        """The shipping window: per-registry samples younger than
        ``max_age`` seconds (capped at the ring, naturally bounded)."""
        now = time.time() if now is None else now
        cutoff = now - float(max_age)
        with self._lock:
            return {name: [s for s in ring if s["ts"] >= cutoff]
                    for name, ring in self._rings.items()
                    if ring and ring[-1]["ts"] >= cutoff}


class MetricsHistoryStore(_HistoryRings):
    """Mon-side merged history: per-(daemon, registry) seq-deduped
    ingest of the shipped windows + the staleness surface the exporter
    renders (how long since each daemon's newest merged sample — the
    gauge the prom recording rules watch).

    Daemons are FORGOTTEN after ``expire_after`` seconds of silence:
    a decommissioned OSD must not pin the ``max()`` staleness alert
    forever (the same dead-endpoint scrape-growth class the messenger
    registries guard against).  Its ring history stays queryable
    (bounded by ``keep`` regardless) and a returning daemon merges
    fresh — only the gauge entry and the seq floors age out."""

    def __init__(self, keep: int = 600, expire_after: float = 600.0,
                 downsample_age: float = 0.0):
        super().__init__(keep, downsample_age)
        self.expire_after = float(expire_after)
        # (daemon, registry) -> highest merged seq (reset on daemon
        # boot, mirroring the event journal's lseq contract)
        self._merged_seq: dict[tuple, int] = {}
        self._daemon_ts: dict[str, float] = {}

    def _expire_locked(self, now: float) -> None:
        """Drop gauge entries + seq floors of daemons silent past the
        horizon.  Caller holds _lock."""
        cutoff = now - self.expire_after
        for daemon in [d for d, ts in self._daemon_ts.items()
                       if ts < cutoff]:
            del self._daemon_ts[daemon]
            for key in [k for k in self._merged_seq
                        if k[0] == daemon]:
                del self._merged_seq[key]

    def reset_daemon(self, daemon: str) -> None:
        """A rebooted daemon restarts its sample seq at 1; drop the
        floor so its fresh window merges."""
        with self._lock:
            for key in [k for k in self._merged_seq if k[0] == daemon]:
                del self._merged_seq[key]

    def merge(self, daemon: str, payload: dict) -> int:
        """Ingest one report's shipped window ({registry: [samples]}).
        Returns the number of NEW samples merged (re-shipped ones
        dedupe away on seq)."""
        if not isinstance(payload, dict):
            return 0
        merged = 0
        with self._lock:
            for registry, rows in payload.items():
                if not isinstance(rows, list):
                    continue
                key = (daemon, str(registry))
                seen = self._merged_seq.get(key, 0)
                ring = self._ring(str(registry))
                for s in rows:
                    if not isinstance(s, dict):
                        continue
                    seq = s.get("seq")
                    if not isinstance(seq, int) or seq <= seen:
                        continue
                    seen = seq
                    ring.append(s)
                    merged += 1
                    ts = s.get("ts")
                    if isinstance(ts, (int, float)):
                        self._daemon_ts[daemon] = max(
                            self._daemon_ts.get(daemon, 0.0), float(ts))
                self._merged_seq[key] = seen
                # after the batch, not before it: a shipped window
                # appends many rows under one lock hold, and the
                # budget must hold at every merge() exit
                self._migrate_locked(str(registry))
        return merged

    def staleness(self, now: float | None = None) -> dict:
        """Seconds since each daemon's newest merged sample (the
        metrics_history_staleness_s gauge feed); daemons silent past
        ``expire_after`` age out of the gauge entirely."""
        now = time.time() if now is None else now
        with self._lock:
            self._expire_locked(now)
            return {d: round(max(0.0, now - ts), 3)
                    for d, ts in sorted(self._daemon_ts.items())}
