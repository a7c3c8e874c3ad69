"""SLO objective grammar + burn-rate math over pow-2 histograms.

An objective is one line of the ``slo_objectives`` config option::

    client_op_p99<=20ms@99%
    qwait_client<=5ms@99.9%
    osd.:mclock_qwait_us_client<=2ms@95%

Grammar: ``<signal><=<threshold><unit>@<target>%`` — "<target>% of
observations must land at or under <threshold>".  A cosmetic ``_pNN``
suffix on the signal is accepted and ignored (the target percentage
after ``@`` is the objective; ``client_op_p99<=20ms@99%`` reads
naturally either way).  Signals resolve through ``SIGNALS`` to a
(registry-prefix, histogram-counter) pair, or spell the pair directly
as ``prefix:counter``.

Burn rate is the Google-SRE error-budget form: with target t, the
budget is the (1-t) fraction of observations allowed over threshold;
``burn = bad_fraction / (1 - t)`` — burn 1.0 consumes the budget
exactly as fast as allowed, burn N eats it N times faster.  The mgr
module alerts only when BOTH a fast and a slow window burn over the
configured threshold (multiwindow: the slow window proves it is not a
blip, the fast window proves it is still happening), and the alert
carries exemplar trace_ids from the worst offending bucket so the
operator lands directly in ``trace_tool --exemplar``.

``bad_fraction`` works on the ``buckets_delta`` a ``metrics_query``
returns: bucket b covers [2^(b-1), 2^b) microseconds (b=0 covers
[0,1)), and the bucket the threshold crosses contributes the
linearly-interpolated fraction of its population above the threshold
— the same geometry ``pow2_quantile`` and the exporter's cumulative
``le`` buckets assume, so the three surfaces agree by construction.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["SIGNALS", "Objective", "parse_objective",
           "parse_objectives", "bad_fraction", "burn_rate",
           "evaluate_objective", "expand_counters",
           "worst_bucket_exemplars"]

#: signal aliases -> (registry prefix, pow2 histogram counter).  The
#: registry prefix matches against the metrics-history store's
#: registry names ("osd.0", "msg.osd.1", "ec_kernels", ...).
SIGNALS: dict[str, tuple[str, str]] = {
    "client_op": ("osd.", "op_lat_us"),
    "qwait_client": ("osd.", "mclock_qwait_us_client"),
    "qwait_recovery": ("osd.", "mclock_qwait_us_recovery"),
    "msg_dispatch": ("msg.", "msg_dispatch_us"),
    "ec_batch_wait": ("ec_kernels", "ec_batch_wait_us"),
}

_UNIT_US = {"us": 1.0, "ms": 1e3, "s": 1e6}

_RE = re.compile(
    r"^(?P<signal>[A-Za-z0-9_.:*]+?)(?:_p\d+)?"
    r"<=(?P<num>\d+(?:\.\d+)?)(?P<unit>us|ms|s)"
    r"@(?P<target>\d+(?:\.\d+)?)%$")


@dataclass(frozen=True)
class Objective:
    name: str            # the raw objective string (the config spelling)
    registry_prefix: str  # metrics-history registries to aggregate over
    counter: str         # pow2 histogram counter inside each registry
    threshold_us: float  # observations above this are budget spend
    target: float        # fraction (0,1) that must land at/under


def parse_objective(text: str) -> Objective:
    """One objective line -> Objective; raises ValueError with the
    offending text on any grammar violation (config apply surfaces
    it)."""
    text = text.strip()
    m = _RE.match(text)
    if not m:
        raise ValueError(
            f"bad SLO objective {text!r} (want "
            f"'<signal><=<num><us|ms|s>@<pct>%', e.g. "
            f"'client_op_p99<=20ms@99%')")
    signal = m.group("signal")
    if ":" in signal:
        prefix, counter = signal.split(":", 1)
        if "*" in prefix:
            raise ValueError(
                f"SLO wildcard only allowed in the counter part: {text!r}")
    elif "*" in signal:
        # Metric wildcard: one objective per counter the store has
        # actually seen (e.g. 'mclock_qwait_us_tenant_*_p99<=50ms@99%'
        # stands one objective per discovered tenant series).  The
        # _pNN suffix the regex stripped is cosmetic, so the wildcard
        # pattern is the bare signal.  Expansion happens at evaluate
        # time against the live store; parse just records the pattern
        # over the default OSD registries.
        prefix, counter = "osd.", signal
    else:
        pair = SIGNALS.get(signal)
        if pair is None:
            raise ValueError(
                f"unknown SLO signal {signal!r} (aliases: "
                f"{sorted(SIGNALS)}; or spell 'prefix:counter')")
        prefix, counter = pair
    target = float(m.group("target")) / 100.0
    if not 0.0 < target < 1.0:
        raise ValueError(f"SLO target must be in (0, 100)%: {text!r}")
    return Objective(
        name=text, registry_prefix=prefix, counter=counter,
        threshold_us=float(m.group("num")) * _UNIT_US[m.group("unit")],
        target=target)


def parse_objectives(spec: str) -> list[Objective]:
    """The ``slo_objectives`` config value: comma/whitespace-separated
    objective lines (empty -> no objectives -> module inert)."""
    return [parse_objective(p) for p in re.split(r"[,\s]+", spec or "")
            if p.strip()]


def bad_fraction(buckets_delta: dict, threshold_us: float
                 ) -> tuple[float, int]:
    """(fraction of the window's observations above threshold, total
    observations).  The crossing bucket contributes linearly — pow-2
    buckets are coarse at the tail, and snapping to a bucket edge
    would make a 20 ms objective indistinguishable from a 32 ms
    one."""
    bd = {int(k): int(v) for k, v in (buckets_delta or {}).items()}
    total = sum(n for n in bd.values() if n > 0)
    if total <= 0:
        return 0.0, 0
    bad = 0.0
    for b, n in bd.items():
        if n <= 0:
            continue
        lo = 0.0 if b == 0 else float(2 ** (b - 1))
        hi = 1.0 if b == 0 else float(2 ** b)
        if lo >= threshold_us:
            bad += n
        elif hi > threshold_us:
            bad += n * (hi - threshold_us) / (hi - lo)
    return bad / total, total


def burn_rate(bad: float, target: float) -> float:
    """Error-budget burn multiple: 1.0 = spending the (1-target)
    budget exactly; clamped into a large-but-finite ceiling so a
    target of 99.999% over a tiny window cannot overflow the JSON
    surfaces."""
    return min(1e6, bad / max(1e-9, 1.0 - target))


def expand_counters(pattern: str, store, registry_prefix: str
                    ) -> list[str]:
    """Expand a ``*`` counter pattern against the counter names the
    store's matching registries actually carry.  ``*`` matches one
    metric-name segment run ([A-Za-z0-9_]+), so a hostile tenant name
    cannot smuggle dots or colons into a synthesized objective."""
    rx = re.compile(
        "^" + re.escape(pattern).replace(r"\*", "[A-Za-z0-9_]+") + "$")
    names: set[str] = set()
    counters_of = getattr(store, "counters", None)
    if counters_of is None:
        return []
    for reg in store.registries():
        if not reg.startswith(registry_prefix):
            continue
        for name in counters_of(reg):
            if rx.match(name):
                names.add(name)
    return sorted(names)


def worst_bucket_exemplars(exemplars: dict, threshold_us: float,
                           keep: int = 4) -> list[dict]:
    """Exemplars from the highest bucket whose RANGE exceeds the
    threshold (entirely or partially bad) — the trace_ids the alert
    detail carries.  Newest first, capped at ``keep``."""
    out: list[dict] = []
    for b in sorted((int(k) for k in (exemplars or {})), reverse=True):
        hi = 1.0 if b == 0 else float(2 ** b)
        if hi <= threshold_us:
            break
        for e in (exemplars or {}).get(b) or (exemplars or {}).get(
                str(b)) or []:
            out.append(dict(e, bucket=b))
            if len(out) >= keep:
                return out
    return out


def evaluate_objective(obj: Objective, store, fast_s: float,
                       slow_s: float) -> dict:
    """Evaluate one objective over a metrics-history store (anything
    with ``registries()`` and ``query()`` — MetricsHistoryStore or a
    daemon's local MetricsHistory): aggregate the bucket deltas of
    every matching registry per window, compute both burns, and carry
    the worst bucket's exemplars from the fast window.  Pure read —
    no health decisions here (the mgr module owns thresholds and
    hysteresis)."""
    if "*" in obj.counter:
        # Wildcard objective: expand per discovered counter, evaluate
        # each concrete sub-objective, and report AS the worst series
        # (highest fast burn) so the mgr's thresholding is unchanged —
        # the alert fires when the worst tenant burns, and the detail
        # names it.  Nothing discovered yet -> inert zero-burn result.
        series = []
        for name in expand_counters(obj.counter, store,
                                    obj.registry_prefix):
            sub = Objective(name=obj.name, registry_prefix=obj.registry_prefix,
                            counter=name, threshold_us=obj.threshold_us,
                            target=obj.target)
            series.append(evaluate_objective(sub, store, fast_s, slow_s))
        if not series:
            zero = {"window_s": 0.0, "observations": 0,
                    "bad_fraction": 0.0, "burn": 0.0}
            return {"objective": obj.name, "counter": obj.counter,
                    "threshold_us": obj.threshold_us, "target": obj.target,
                    "registries": [], "fast": dict(zero, window_s=fast_s),
                    "slow": dict(zero, window_s=slow_s), "exemplars": [],
                    "worst_series": None, "series": []}
        worst = max(series, key=lambda s: (s["fast"]["burn"],
                                           s["slow"]["burn"],
                                           s["counter"]))
        out = dict(worst, objective=obj.name)
        out["worst_series"] = worst["counter"]
        out["series"] = [
            {"counter": s["counter"],
             "fast_burn": s["fast"]["burn"],
             "slow_burn": s["slow"]["burn"],
             "observations": s["fast"]["observations"]}
            for s in series]
        return out
    windows = {"fast": float(fast_s), "slow": float(slow_s)}
    out = {"objective": obj.name, "counter": obj.counter,
           "threshold_us": obj.threshold_us, "target": obj.target,
           "registries": []}
    for label, since_s in windows.items():
        agg: dict[int, int] = {}
        exemplars: dict[int, list] = {}
        for reg in store.registries():
            if not reg.startswith(obj.registry_prefix):
                continue
            if reg not in out["registries"]:
                out["registries"].append(reg)
            q = store.query(reg, obj.counter, since_s=since_s)
            for b, n in (q.get("buckets_delta") or {}).items():
                agg[int(b)] = agg.get(int(b), 0) + int(n)
            if label == "fast":
                for b, ring in (q.get("exemplars") or {}).items():
                    exemplars.setdefault(int(b), []).extend(ring)
        bad, total = bad_fraction(agg, obj.threshold_us)
        out[label] = {"window_s": since_s, "observations": total,
                      "bad_fraction": round(bad, 6),
                      "burn": round(burn_rate(bad, obj.target), 3)}
        if label == "fast":
            out["exemplars"] = worst_bucket_exemplars(
                exemplars, obj.threshold_us)
    return out
