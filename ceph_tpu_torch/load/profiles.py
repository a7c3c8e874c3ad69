"""Workload model: named client profiles + mergeable latency histograms.

The shapes real object-store traffic studies parameterize (the COSBench
/ rados bench axes, and the hot-object skew the erasure-coding
characterization papers blame for tail blowups):

- **op-size distribution** — discrete (bytes, weight) pairs; real
  traffic is multi-modal (metadata-sized vs payload-sized), not one
  mean.
- **read/write mix** — ``read_fraction`` of ops are whole-object reads,
  the rest are write_fulls of a sampled size.
- **key popularity** — zipf(alpha) over the object set; alpha 0 is
  uniform, ~1 is web-like, >1.2 hammers a handful of hot objects
  (the duplicate-collapse / extent-cache stress case).
- **arrival process** — ``closed`` (N clients, each one op in flight:
  throughput self-limits as latency grows) vs ``open`` (ops arrive at
  an offered rate regardless of completions: the saturation probe —
  when achieved falls under offered, the cluster is past its knee).

Latencies land in ``Pow2Histogram`` — HDR-style power-of-two buckets in
microseconds, mergeable across workers/processes (the property the
multi-process generator needs: each worker ships its histogram as JSON
and the parent folds them without losing quantile fidelity beyond the
2x bucket width).
"""

from __future__ import annotations

import bisect
import math
import random
from dataclasses import dataclass, field

from ..utils.perf import pow2_bucket


class Pow2Histogram:
    """Power-of-two latency histogram (microseconds), mergeable.

    Buckets come from utils/perf.py's ``pow2_bucket`` — the SAME
    function the daemon-side HISTOGRAM counters and the exporter's
    cumulative ``le`` rendering use, so a worker-side histogram and a
    daemon-side one quantile identically by construction."""

    def __init__(self):
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0

    def record(self, value_us: float) -> None:
        b = pow2_bucket(value_us)
        self.buckets[b] = self.buckets.get(b, 0) + 1
        self.count += 1
        self.sum += value_us

    def merge(self, other: "Pow2Histogram | dict") -> "Pow2Histogram":
        if isinstance(other, dict):
            o = Pow2Histogram.from_dict(other)
        else:
            o = other
        for b, n in o.buckets.items():
            self.buckets[b] = self.buckets.get(b, 0) + n
        self.count += o.count
        self.sum += o.sum
        return self

    def quantile(self, q: float) -> float | None:
        """Upper bucket bound at quantile q (None when empty): the
        conservative estimate — the true value is within 2x below."""
        if not self.count:
            return None
        target = max(1, math.ceil(q * self.count))
        acc = 0
        for b in sorted(self.buckets):
            acc += self.buckets[b]
            if acc >= target:
                return float(2 ** b)
        return float(2 ** max(self.buckets))

    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def to_dict(self) -> dict:
        return {"buckets_pow2": {str(b): n
                                 for b, n in sorted(self.buckets.items())},
                "count": self.count, "sum": self.sum}

    @classmethod
    def from_dict(cls, d: dict) -> "Pow2Histogram":
        h = cls()
        h.buckets = {int(b): int(n)
                     for b, n in (d.get("buckets_pow2") or {}).items()}
        h.count = int(d.get("count", sum(h.buckets.values())))
        h.sum = float(d.get("sum", 0.0))
        return h


class ZipfSampler:
    """Rank-popularity sampler: P(rank k) ~ 1/k^alpha over n keys,
    alpha=0 degenerating to uniform.  Precomputes the CDF once; each
    draw is one bisect — cheap enough for the per-op hot path."""

    def __init__(self, n: int, alpha: float, rng: random.Random):
        self.n = max(1, int(n))
        self.alpha = float(alpha)
        self._rng = rng
        acc, cdf = 0.0, []
        for k in range(1, self.n + 1):
            acc += 1.0 / (k ** self.alpha) if self.alpha > 0 else 1.0
            cdf.append(acc)
        self._cdf = [c / acc for c in cdf]

    def sample(self) -> int:
        """A key index in [0, n) — index 0 is the hottest rank."""
        return bisect.bisect_left(self._cdf, self._rng.random())


@dataclass(frozen=True)
class Profile:
    """One named client population's traffic shape."""

    name: str
    read_fraction: float                      # 0..1: P(op is a read)
    sizes: tuple[tuple[int, float], ...]      # (bytes, weight) op sizes
    zipf_alpha: float = 0.0                   # key-popularity skew
    arrival: str = "closed"                   # "closed" | "open"
    description: str = ""

    def size_sampler(self, rng: random.Random):
        vals = [s for s, _w in self.sizes]
        weights = [w for _s, w in self.sizes]
        total = sum(weights)
        cdf, acc = [], 0.0
        for w in weights:
            acc += w / total
            cdf.append(acc)

        def sample() -> int:
            return vals[bisect.bisect_left(cdf, rng.random())]
        return sample

    def op_class(self, rng: random.Random) -> str:
        return "read" if rng.random() < self.read_fraction else "write"


PROFILES: dict[str, Profile] = {p.name: p for p in (
    Profile("small_mixed", read_fraction=0.5,
            sizes=((4 * 1024, 0.7), (16 * 1024, 0.3)),
            zipf_alpha=0.9,
            description="50/50 4-16KiB ops, web-like key skew — the "
                        "general-purpose leg"),
    Profile("read_heavy", read_fraction=0.9,
            sizes=((4 * 1024, 0.5), (64 * 1024, 0.5)),
            zipf_alpha=1.1,
            description="90% reads with a hot head — CDN-ish; "
                        "exercises the read pipeline + extent cache"),
    Profile("write_burst", read_fraction=0.0,
            sizes=((16 * 1024, 0.6), (64 * 1024, 0.4)),
            zipf_alpha=0.0,
            description="pure uniform writes — the EC encode/commit "
                        "path under pressure"),
    Profile("hot_object", read_fraction=0.8,
            sizes=((4 * 1024, 1.0),),
            zipf_alpha=1.4,
            description="a handful of scorching objects — duplicate-"
                        "read collapse and per-object ordering stress"),
)}


def get_profile(name: str) -> Profile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown load profile {name!r} "
                       f"(have: {sorted(PROFILES)})") from None


@dataclass
class LegSpec:
    """One scenario leg as the worker executes it: a profile driven by
    an arrival process for a bounded wall-clock window.  ``rate`` is
    this WORKER's offered ops/s (open loop); ``concurrency`` is this
    worker's simulated client count (closed loop, and the executor
    width that serves open-loop arrivals)."""

    name: str
    profile: str
    duration_s: float
    mode: str = "closed"         # "closed" | "open"
    rate: float = 0.0            # open-loop offered ops/s (per worker)
    concurrency: int = 8         # closed-loop clients / open-loop width

    def to_dict(self) -> dict:
        return {"name": self.name, "profile": self.profile,
                "duration_s": self.duration_s, "mode": self.mode,
                "rate": self.rate, "concurrency": self.concurrency}

    @classmethod
    def from_dict(cls, d: dict) -> "LegSpec":
        return cls(name=d["name"], profile=d["profile"],
                   duration_s=float(d["duration_s"]),
                   mode=d.get("mode", "closed"),
                   rate=float(d.get("rate", 0.0)),
                   concurrency=int(d.get("concurrency", 8)))


@dataclass
class LegResult:
    """Mergeable per-leg outcome: offered/achieved op counts, errors,
    and one histogram per op class."""

    offered: int = 0
    achieved: int = 0
    errors: int = 0
    wall_s: float = 0.0
    hists: dict = field(default_factory=dict)  # class -> Pow2Histogram

    def hist(self, klass: str) -> Pow2Histogram:
        h = self.hists.get(klass)
        if h is None:
            h = self.hists[klass] = Pow2Histogram()
        return h

    def merge(self, other: "LegResult | dict") -> "LegResult":
        o = LegResult.from_dict(other) if isinstance(other, dict) \
            else other
        self.offered += o.offered
        self.achieved += o.achieved
        self.errors += o.errors
        self.wall_s = max(self.wall_s, o.wall_s)
        for klass, h in o.hists.items():
            self.hist(klass).merge(h)
        return self

    def to_dict(self) -> dict:
        return {"offered": self.offered, "achieved": self.achieved,
                "errors": self.errors, "wall_s": round(self.wall_s, 3),
                "hists": {k: h.to_dict()
                          for k, h in sorted(self.hists.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "LegResult":
        r = cls(offered=int(d.get("offered", 0)),
                achieved=int(d.get("achieved", 0)),
                errors=int(d.get("errors", 0)),
                wall_s=float(d.get("wall_s", 0.0)))
        for klass, hd in (d.get("hists") or {}).items():
            r.hists[klass] = Pow2Histogram.from_dict(hd)
        return r
