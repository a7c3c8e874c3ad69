"""Dynamic perf queries: live per-tenant/pool/PG IO attribution.

The capability of the reference's mgr dynamic perf counters
(src/osd/DynamicPerfStats.h + mgr OSDPerfMetricTypes: `osd perf query
add` installs a query descriptor in the OSDMap-adjacent mgr state,
every OSD buckets its client ops by the query's group-by key and ships
the partial counters back on the mgr report, `rbd perf image iotop`
renders the merged view).  Here the whole loop is explicit:

- :class:`PerfQuerySpec` — what to group by (tenant, pool, pgid, op
  class, object-name prefix) and which counters to keep (ops,
  bytes_in/out, pow-2 latency histogram), with a HARD top-N bound.
- :class:`PerfQuerySet` — the OSD-side accumulator bank living on the
  client-op dispatch path.  ``active`` is a plain attribute so the
  queries-off fast path is one attr check and ZERO allocations (the
  exemplar/tracer discipline).  Per query the rows are a top-N LRU:
  a new key past the bound evicts the least-recently-hit row into the
  ``_overflow`` fold bucket, so a hostile key churn (a client minting
  object names) can never grow the accumulator, the report, or the
  exporter scrape.
- :class:`PerfQueryStore` — the mon/mgr-side merge: per-daemon
  CUMULATIVE snapshots ride MStatsReport at-least-once (re-shipped
  every report, tagged with a per-daemon seq); the store keeps the
  newest seq per daemon, so re-delivery dedupes away and a rebooted
  daemon (seq restarts at 1) is reset explicitly on boot — revive can
  never double-count.  ``report()`` sums rows across daemons into the
  cluster view ``perf query report`` / tools/top_tool.py render.

Queries DISTRIBUTE like qos profiles: the mon commits them into an
OSDMap tail (mon/maps.py v5) and every OSD converges its
:class:`PerfQuerySet` on the next map push — no separate control
channel, and a daemon that missed epochs converges from the full map.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field

from ..utils.perf import pow2_bucket

#: the group-by vocabulary (OSDPerfMetricSubKeyType role): every key a
#: client-op dispatch can stamp without touching object data
GROUP_KEYS = ("tenant", "pool", "pgid", "op_class", "object_prefix")

#: counters a query may keep per row; "lat" is the pow-2 µs histogram
#: (p50/p99 derive from it at report time)
COUNTER_NAMES = ("ops", "bytes_in", "bytes_out", "lat")

#: cardinality ceiling per query per daemon — the hard bound the
#: counter-schema lint holds the exporter to
MAX_TOP_N = 256
DEFAULT_TOP_N = 32

#: the fold bucket's display key (never a legal group-key value: group
#: values are sanitized through _safe_key which strips leading "_")
OVERFLOW_KEY = "_overflow"


def op_class_of(op: str) -> str:
    """Collapse the MOSDOp op string into the attribution class
    (arXiv:1709.05365: online-EC bottlenecks shift with the read/write
    mix, so totals alone mislead)."""
    if op.startswith("write") or op == "remove":
        return "write"
    if op in ("read", "stat"):
        return "read"
    return op


def _safe_key(value: str) -> str:
    """One group-key value, bounded and exporter-safe: a hostile
    tenant/object name can't smuggle label syntax or grow a row key
    without limit."""
    out = "".join(ch if ch.isalnum() or ch in "._-" else "_"
                  for ch in str(value)[:64])
    return out.lstrip("_") or "default"


@dataclass
class PerfQuerySpec:
    """One query descriptor (the OSDPerfMetricQuery role): travels the
    OSDMap tail, so every field is scalar/strings-only."""

    qid: int
    key_by: tuple = ("tenant",)
    counters: tuple = COUNTER_NAMES
    top_n: int = DEFAULT_TOP_N
    prefix_len: int = 8  # object_prefix key: first N name chars

    def __post_init__(self):
        self.key_by = tuple(self.key_by)
        self.counters = tuple(self.counters)
        bad = [k for k in self.key_by if k not in GROUP_KEYS]
        if bad or not self.key_by:
            raise ValueError(f"key_by must be a non-empty subset of "
                             f"{GROUP_KEYS}, got {self.key_by}")
        badc = [c for c in self.counters if c not in COUNTER_NAMES]
        if badc or not self.counters:
            raise ValueError(f"counters must be a non-empty subset of "
                             f"{COUNTER_NAMES}, got {self.counters}")
        self.top_n = max(1, min(MAX_TOP_N, int(self.top_n)))
        self.prefix_len = max(1, min(64, int(self.prefix_len)))

    def to_dict(self) -> dict:
        return {"qid": self.qid, "key_by": list(self.key_by),
                "counters": list(self.counters), "top_n": self.top_n,
                "prefix_len": self.prefix_len}

    @classmethod
    def from_dict(cls, d: dict) -> "PerfQuerySpec":
        return cls(qid=int(d["qid"]),
                   key_by=tuple(d.get("key_by") or ("tenant",)),
                   counters=tuple(d.get("counters") or COUNTER_NAMES),
                   top_n=int(d.get("top_n", DEFAULT_TOP_N)),
                   prefix_len=int(d.get("prefix_len", 8)))


@dataclass
class _Row:
    """One group's cumulative counters.  lat is a sparse pow-2 bucket
    map (bucket -> count) — 64 dense slots per row would dominate the
    wire snapshot at top_n=256."""

    ops: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    lat: dict = field(default_factory=dict)
    lat_sum: float = 0.0

    def fold(self, other: "_Row") -> None:
        self.ops += other.ops
        self.bytes_in += other.bytes_in
        self.bytes_out += other.bytes_out
        self.lat_sum += other.lat_sum
        for b, n in other.lat.items():
            self.lat[b] = self.lat.get(b, 0) + n

    def to_dict(self) -> dict:
        return {"ops": self.ops, "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
                "lat": {str(b): n for b, n in self.lat.items()},
                "lat_sum": round(self.lat_sum, 1)}


class PerfQueryAccumulator:
    """One query's OSD-side rows: top-N LRU + overflow fold.  Caller
    holds the PerfQuerySet lock."""

    def __init__(self, spec: PerfQuerySpec):
        self.spec = spec
        self.rows: OrderedDict[tuple, _Row] = OrderedDict()
        self.overflow = _Row()
        # precomputed key extractors — the observe hot path indexes a
        # tuple instead of re-matching strings per op
        self._keyers = tuple(GROUP_KEYS.index(k) for k in spec.key_by)

    def observe(self, fields: tuple, bytes_in: int, bytes_out: int,
                lat_us: float) -> None:
        """``fields`` is the full (tenant, pool, pgid, op_class,
        object_prefix) tuple the dispatch path stamped once per op."""
        key = tuple(fields[i] for i in self._keyers)
        row = self.rows.get(key)
        if row is None:
            if len(self.rows) >= self.spec.top_n:
                # evict the least-recently-hit row into the fold
                # bucket; the NEW key takes its slot (recency bias:
                # the currently-hot keys are the ones worth naming)
                _, cold = self.rows.popitem(last=False)
                self.overflow.fold(cold)
            row = self.rows[key] = _Row()
        else:
            self.rows.move_to_end(key)
        counters = self.spec.counters
        if "ops" in counters:
            row.ops += 1
        if "bytes_in" in counters:
            row.bytes_in += bytes_in
        if "bytes_out" in counters:
            row.bytes_out += bytes_out
        if "lat" in counters and lat_us >= 0:
            b = pow2_bucket(lat_us)
            row.lat[b] = row.lat.get(b, 0) + 1
            row.lat_sum += lat_us

    def snapshot(self) -> dict:
        return {"spec": self.spec.to_dict(),
                "rows": [{"key": list(k), **r.to_dict()}
                         for k, r in self.rows.items()],
                "overflow": self.overflow.to_dict()}


class PerfQuerySet:
    """The OSD-side bank of active queries, hooked into the client-op
    dispatch path.  ``active`` is the zero-alloc gate: with no query
    installed the per-op cost is ONE attribute check."""

    def __init__(self):
        self.active = False
        self._lock = threading.Lock()
        self._accs: dict[int, PerfQueryAccumulator] = {}
        self._seq = 0

    def set_queries(self, specs: dict[int, dict | PerfQuerySpec]) -> None:
        """Converge on the map's query set: accumulators for unchanged
        specs SURVIVE (cumulative counters keep counting across
        unrelated map churn); new specs start zeroed; removed specs
        drop their rows."""
        parsed: dict[int, PerfQuerySpec] = {}
        for qid, spec in specs.items():
            if not isinstance(spec, PerfQuerySpec):
                spec = PerfQuerySpec.from_dict(spec)
            parsed[int(qid)] = spec
        with self._lock:
            accs: dict[int, PerfQueryAccumulator] = {}
            for qid, spec in parsed.items():
                old = self._accs.get(qid)
                if old is not None and old.spec == spec:
                    accs[qid] = old
                else:
                    accs[qid] = PerfQueryAccumulator(spec)
            self._accs = accs
            self.active = bool(accs)

    def observe(self, tenant: str, pool: int, pgid, op: str, oid: str,
                bytes_in: int, bytes_out: int, lat_us: float) -> None:
        """One completed client op.  Callers gate on ``active`` BEFORE
        building arguments — this method is never on the unqueried
        path."""
        with self._lock:
            if not self._accs:
                return
            # stamp the full field tuple once; every accumulator
            # projects its own key_by out of it
            prefix_len = max(a.spec.prefix_len
                             for a in self._accs.values())
            fields = (_safe_key(tenant or "default"), str(int(pool)),
                      str(pgid), op_class_of(op),
                      _safe_key(oid[:prefix_len]))
            for acc in self._accs.values():
                acc.observe(fields, bytes_in, bytes_out, lat_us)

    def snapshot(self) -> dict | None:
        """The stats-report payload: seq-tagged CUMULATIVE rows of
        every query (None when inactive, so the report carries no key).
        Re-shipped whole every report — the store dedupes on seq."""
        with self._lock:
            if not self._accs:
                return None
            self._seq += 1
            return {"seq": self._seq,
                    "queries": {str(qid): acc.snapshot()
                                for qid, acc in self._accs.items()}}

    def dump(self) -> dict:
        """Admin-socket face (``dump_perf_queries``)."""
        with self._lock:
            return {"active": self.active, "seq": self._seq,
                    "queries": {str(qid): acc.snapshot()
                                for qid, acc in self._accs.items()}}


def _merge_rows(into: dict, snap: dict) -> None:
    """Fold one daemon's query snapshot into a cluster-view dict
    {key_tuple: _Row} + overflow."""
    for r in snap.get("rows", ()):
        key = tuple(r["key"])
        row = into["rows"].get(key)
        if row is None:
            row = into["rows"][key] = _Row()
        row.ops += int(r.get("ops", 0))
        row.bytes_in += int(r.get("bytes_in", 0))
        row.bytes_out += int(r.get("bytes_out", 0))
        row.lat_sum += float(r.get("lat_sum", 0.0))
        for b, n in (r.get("lat") or {}).items():
            b = int(b)
            row.lat[b] = row.lat.get(b, 0) + int(n)
    ov = snap.get("overflow") or {}
    into["overflow"].ops += int(ov.get("ops", 0))
    into["overflow"].bytes_in += int(ov.get("bytes_in", 0))
    into["overflow"].bytes_out += int(ov.get("bytes_out", 0))
    into["overflow"].lat_sum += float(ov.get("lat_sum", 0.0))
    for b, n in (ov.get("lat") or {}).items():
        b = int(b)
        into["overflow"].lat[b] = \
            into["overflow"].lat.get(b, 0) + int(n)


class PerfQueryStore:
    """Mon/mgr-side merge of per-daemon snapshots into the cluster
    view.  Newest-seq-wins per daemon (snapshots are cumulative, so
    replacing is exact); ``reset_daemon`` forgets a rebooted daemon's
    stale state so its restarted seq merges and its pre-crash rows
    never double-count."""

    def __init__(self):
        self._lock = threading.Lock()
        # daemon -> {"seq": int, "queries": {qid_str: snapshot}}
        self._daemons: dict[str, dict] = {}

    def merge(self, daemon: str, payload: dict) -> bool:
        if not isinstance(payload, dict) or "queries" not in payload:
            return False
        seq = int(payload.get("seq", 0))
        with self._lock:
            have = self._daemons.get(daemon)
            if have is not None and seq <= have["seq"]:
                return False  # re-shipped or stale: dedupe away
            self._daemons[daemon] = {"seq": seq,
                                     "queries": payload["queries"]}
            return True

    def reset_daemon(self, daemon: str) -> None:
        with self._lock:
            self._daemons.pop(daemon, None)

    def daemons(self) -> list[str]:
        with self._lock:
            return sorted(self._daemons)

    def report(self, qid: int, sort: str = "ops",
               limit: int = 0) -> dict:
        """The cluster view of one query: rows summed across every
        daemon's newest snapshot, p50/p99 from the merged pow-2
        buckets, sorted by ``ops`` | ``bytes`` | ``p99``."""
        from ..utils.metrics_history import pow2_quantile
        qkey = str(int(qid))
        merged = {"rows": {}, "overflow": _Row()}
        key_by: list = []
        daemons = []
        with self._lock:
            for daemon, state in self._daemons.items():
                snap = state["queries"].get(qkey)
                if snap is None:
                    continue
                daemons.append(daemon)
                key_by = (snap.get("spec") or {}).get("key_by", key_by)
                _merge_rows(merged, snap)
        rows = []
        for key, r in merged["rows"].items():
            rows.append(self._render_row(list(key), r, pow2_quantile))
        if merged["overflow"].ops or merged["overflow"].bytes_in \
                or merged["overflow"].bytes_out:
            rows.append(self._render_row([OVERFLOW_KEY], merged["overflow"],
                                         pow2_quantile))
        keyer = {"ops": lambda r: r["ops"],
                 "bytes": lambda r: r["bytes_in"] + r["bytes_out"],
                 "p99": lambda r: r["p99_us"]}.get(sort)
        if keyer is None:
            raise ValueError(f"sort must be ops|bytes|p99, got {sort!r}")
        rows.sort(key=keyer, reverse=True)
        if limit > 0:
            rows = rows[:limit]
        return {"qid": int(qid), "key_by": list(key_by),
                "daemons": sorted(daemons), "rows": rows}

    @staticmethod
    def _render_row(key: list, r: _Row, pow2_quantile) -> dict:
        count = sum(r.lat.values())
        return {"key": key, "ops": r.ops, "bytes_in": r.bytes_in,
                "bytes_out": r.bytes_out,
                "lat_count": count,
                "avg_us": round(r.lat_sum / count, 1) if count else 0.0,
                "p50_us": round(pow2_quantile(r.lat, 0.50), 1),
                "p99_us": round(pow2_quantile(r.lat, 0.99), 1)}

    def aggregates(self) -> dict[int, dict]:
        """Per-query TOTALS for the exporter: qid -> {ops, bytes_in,
        bytes_out, keys, overflow_ops}.  Labeled only by query id so
        the scrape surface is bounded by the number of standing
        queries — key names (tenant strings etc.) never become metric
        series."""
        with self._lock:
            states = [dict(s) for s in self._daemons.values()]
        out: dict[int, dict] = {}
        keys: dict[int, set] = {}
        for state in states:
            for qkey, snap in (state.get("queries") or {}).items():
                qid = int(qkey)
                a = out.setdefault(qid, {"ops": 0, "bytes_in": 0,
                                         "bytes_out": 0, "keys": 0,
                                         "overflow_ops": 0})
                ks = keys.setdefault(qid, set())
                for row in snap.get("rows") or []:
                    a["ops"] += int(row.get("ops", 0))
                    a["bytes_in"] += int(row.get("bytes_in", 0))
                    a["bytes_out"] += int(row.get("bytes_out", 0))
                    ks.add(tuple(row.get("key") or ()))
                ov = snap.get("overflow") or {}
                a["ops"] += int(ov.get("ops", 0))
                a["bytes_in"] += int(ov.get("bytes_in", 0))
                a["bytes_out"] += int(ov.get("bytes_out", 0))
                a["overflow_ops"] += int(ov.get("ops", 0))
        for qid, a in out.items():
            a["keys"] = len(keys.get(qid) or ())
        return out

    def pg_load(self, qid: int) -> dict:
        """Per-PG load vector from a pgid-keyed standing query: the
        balancer-sensing feed persisted into the metrics-history store
        ({"pg_ops_<pgid>": n, "pg_bytes_<pgid>": n} flat counters)."""
        rep = self.report(qid, sort="ops")
        out: dict[str, int] = {}
        for row in rep["rows"]:
            key = "_".join(row["key"]).replace(".", "_")
            if key == OVERFLOW_KEY.lstrip("_") or key == OVERFLOW_KEY:
                continue
            out[f"pg_ops_{key}"] = row["ops"]
            out[f"pg_bytes_{key}"] = row["bytes_in"] + row["bytes_out"]
        return out
