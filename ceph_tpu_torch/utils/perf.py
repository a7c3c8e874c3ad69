"""Perf counters: typed metrics registries with structured dump.

The capability of the reference's PerfCounters machinery
(src/common/perf_counters.h types :44-52, labeled counters
perf_counters_key.h, collection + admin-socket `perf dump`,
perf_histogram.h — SURVEY.md §2.2): every component registers typed
counters; a process-wide collection dumps them all as one document
(what mgr/prometheus scrape in the reference).
"""

from __future__ import annotations

import enum
import math
import threading
import time
from collections import deque
from typing import Iterable


class CounterType(enum.Enum):
    U64 = "u64"            # gauge (settable)
    COUNTER = "counter"    # monotonic increments
    TIME = "time"          # accumulated seconds
    LONGRUNAVG = "longrunavg"  # sum + count -> average
    HISTOGRAM = "histogram"    # pow-2 bucket counts


def pow2_bucket(value: float) -> int:
    """THE pow-2 histogram bucket function: bucket b covers
    [2^(b-1), 2^b).  Shared by PerfCounters.hinc and the load
    harness's worker-side Pow2Histogram so daemon-side and
    client-side latency quantiles stay comparable by construction."""
    return min(63, max(0, int(math.log2(value)) + 1)
               if value >= 1 else 0)


#: exemplars retained per histogram bucket (newest win; the reservoir
#: is a recency ring, not a uniform sample — a p99 investigation wants
#: the most recent offending traces, not January's)
EXEMPLAR_KEEP = 4


class _Counter:
    __slots__ = ("name", "type", "desc", "value", "sum", "count", "buckets",
                 "exemplars")

    def __init__(self, name: str, ctype: CounterType, desc: str):
        self.name = name
        self.type = ctype
        self.desc = desc
        self.value = 0
        self.sum = 0.0
        self.count = 0
        self.buckets = [0] * 64 if ctype == CounterType.HISTOGRAM else None
        # bucket -> deque[(trace_id, value, ts)]; lazily allocated on
        # the first SAMPLED observation so unsampled histograms carry
        # zero exemplar state
        self.exemplars = None


class PerfCounters:
    """One component's counters (a PerfCounters instance)."""

    def __init__(self, name: str):
        self.name = name
        self._counters: dict[str, _Counter] = {}
        self._lock = threading.Lock()

    def add(self, name: str, ctype: CounterType = CounterType.COUNTER,
            desc: str = "") -> None:
        with self._lock:
            self._counters[name] = _Counter(name, ctype, desc)

    def has(self, name: str) -> bool:
        """Whether the counter is already registered — re-adding an
        existing counter RESETS it, so late registrants (the staging
        plane, arenas) must check before add."""
        with self._lock:
            return name in self._counters

    def add_many(self, names: Iterable[str],
                 ctype: CounterType = CounterType.COUNTER) -> None:
        for n in names:
            self.add(n, ctype)

    def _get(self, name: str) -> _Counter:
        c = self._counters.get(name)
        if c is None:
            raise KeyError(f"{self.name}: no counter {name!r}")
        return c

    def inc(self, name: str, by: int = 1) -> None:
        c = self._get(name)
        with self._lock:
            c.value += by

    def set(self, name: str, value) -> None:
        c = self._get(name)
        with self._lock:
            c.value = value

    def tinc(self, name: str, seconds: float) -> None:
        c = self._get(name)
        with self._lock:
            c.sum += seconds
            c.count += 1

    def time(self, name: str):
        """Context manager accumulating elapsed seconds."""
        pc = self

        class _Timer:
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                pc.tinc(name, time.perf_counter() - self._t0)
                return False

        return _Timer()

    def hinc(self, name: str, value: float, exemplar=None) -> None:
        """Record one histogram observation.  ``exemplar`` is an
        optional trace_id linking this observation to a SAMPLED
        distributed trace: when given, the (trace_id, value, ts)
        triple joins the bucket's small recency reservoir so a later
        p99 spike resolves to concrete waterfalls.  The ``exemplar is
        None`` path (unsampled ops, rate 0) allocates nothing and
        touches no exemplar state."""
        c = self._get(name)
        b = pow2_bucket(value)
        with self._lock:
            c.buckets[b] += 1
            c.count += 1
            c.sum += value
            if exemplar is not None:
                ex = c.exemplars
                if ex is None:
                    ex = c.exemplars = {}
                ring = ex.get(b)
                if ring is None:
                    ring = ex[b] = deque(maxlen=EXEMPLAR_KEEP)
                ring.append((int(exemplar), value, time.time()))

    def avg(self, name: str) -> float:
        c = self._get(name)
        return c.sum / c.count if c.count else 0.0

    def gauge_names(self) -> set[str]:
        """Names of settable (U64) counters — values that move both
        ways, which an exporter must type `gauge`, never `counter`
        (rate() over a two-way value is nonsense)."""
        with self._lock:
            return {n for n, c in self._counters.items()
                    if c.type == CounterType.U64}

    def get(self, name: str):
        return self._get(name).value

    def dump(self) -> dict:
        out = {}
        with self._lock:
            for n, c in sorted(self._counters.items()):
                if c.type in (CounterType.U64, CounterType.COUNTER):
                    out[n] = c.value
                elif c.type == CounterType.TIME:
                    out[n] = {"sum_seconds": c.sum, "count": c.count}
                elif c.type == CounterType.LONGRUNAVG:
                    out[n] = {"sum": c.sum, "count": c.count,
                              "avg": c.sum / c.count if c.count else 0.0}
                else:
                    # sum + count ride along so scrapes see a stable
                    # (zeroed) series per histogram even before any
                    # sample lands — and can derive a mean rate
                    nz = {i: v for i, v in enumerate(c.buckets) if v}
                    d = {"buckets_pow2": nz, "count": c.count,
                         "sum": c.sum}
                    # exemplars key appears ONLY when a reservoir holds
                    # something: the no-exemplar dump shape (and hence
                    # the exporter's classic exposition) stays
                    # byte-identical to the pre-exemplar schema
                    if c.exemplars:
                        d["exemplars"] = {
                            b: [{"trace_id": t, "value": v, "ts": ts}
                                for t, v, ts in ring]
                            for b, ring in sorted(c.exemplars.items())
                            if ring}
                    out[n] = d
        return out


class PerfCountersCollection:
    """Process-wide registry (perf_counters_collection + `perf dump`)."""

    def __init__(self):
        self._registries: dict[str, PerfCounters] = {}
        self._lock = threading.Lock()

    def create(self, name: str) -> PerfCounters:
        with self._lock:
            pc = self._registries.get(name)
            if pc is None:
                pc = PerfCounters(name)
                self._registries[name] = pc
            return pc

    def remove(self, name: str) -> None:
        with self._lock:
            self._registries.pop(name, None)

    def dump(self) -> dict:
        with self._lock:
            regs = dict(self._registries)
        return {n: r.dump() for n, r in sorted(regs.items())}

    def registries(self) -> dict[str, PerfCounters]:
        """Snapshot of the live registries (exporter rendering needs
        per-counter TYPE information the flat dump() strips)."""
        with self._lock:
            return dict(self._registries)


_GLOBAL = PerfCountersCollection()


def global_perf() -> PerfCountersCollection:
    return _GLOBAL


class KernelProfiler:
    """Per-signature accelerator-kernel timing: compile, device-execute
    and host-sync seconds (the slices the EC batcher's latency
    decomposition needs — an op's encode time is window wait + XLA
    compile + device compute + host sync, and only the first is visible
    to the tracer without this).

    Samples land twice: as TIME/HISTOGRAM counters on the process-wide
    ``ec_kernels`` perf registry (so `perf dump` and the prometheus
    exporter see them with zero extra wiring) and in per-signature
    aggregates plus a bounded ring of recent COMPILE events, dumpable
    via the OSD admin-socket verb ``dump_kernel_profile`` — compiles
    are the rare multi-second cliffs worth individual timestamps; the
    per-launch samples only matter in aggregate.

    Auto-tuner bookkeeping: the runtime kernel auto-selection
    (ec/matrix_code.py) records each per-(matrix, shape-bucket) kernel
    decision here via ``note_pick`` — winner, how it was decided
    (``auto`` race vs ``pinned``), and which candidates were skipped as
    unsupported — surfaced in ``dump()`` under ``picks`` (each entry's
    ``picked`` field is the winning kernel) and as the
    ``ec_kernel_pick_*`` counters."""

    RING = 64  # recent compile events retained

    #: kind -> (TIME counter, pow2 histogram in microseconds)
    KINDS = {
        "compile": ("kernel_compile_time", "kernel_compile_us"),
        "device": ("kernel_device_time", "kernel_device_us"),
        "sync": ("kernel_sync_time", "kernel_sync_us"),
    }

    #: auto-selection counters: picks decided by a timed race vs pinned
    #: deterministically (explicit profile key / CPU platform), viable-
    #: candidate skips (unsupported: mxu on wide matrices, pallas
    #: off-TPU), and the extra launches a race spent
    PICK_COUNTERS = ("ec_kernel_pick_auto", "ec_kernel_pick_pinned",
                     "ec_kernel_pick_skip",
                     "ec_kernel_pick_race_launches")

    def __init__(self, perf: PerfCounters | None = None):
        self._lock = threading.Lock()
        self._sigs: dict[str, dict] = {}
        self._picks: dict[str, dict] = {}
        self._compiles: deque[dict] = deque(maxlen=self.RING)
        self._perf = perf if perf is not None \
            else _GLOBAL.create("ec_kernels")
        for tname, hname in self.KINDS.values():
            self._perf.add(tname, CounterType.TIME)
            self._perf.add(hname, CounterType.HISTOGRAM)
        for cname in self.PICK_COUNTERS:
            self._perf.add(cname, CounterType.COUNTER)

    def note(self, kind: str, sig: str, seconds: float) -> None:
        tname, hname = self.KINDS[kind]
        self._perf.tinc(tname, seconds)
        self._perf.hinc(hname, seconds * 1e6)
        with self._lock:
            agg = self._sigs.setdefault(sig, {
                k: 0 for k in self.KINDS} | {
                    f"{k}_seconds": 0.0 for k in self.KINDS} | {
                    f"{k}_max_seconds": 0.0 for k in self.KINDS})
            agg[kind] += 1
            agg[f"{kind}_seconds"] += seconds
            agg[f"{kind}_max_seconds"] = max(
                agg[f"{kind}_max_seconds"], seconds)
            if kind == "compile":
                self._compiles.append({"sig": sig,
                                       "seconds": round(seconds, 6),
                                       "at": time.time()})

    def note_pick(self, sig: str, kernel: str, *, mode: str = "auto",
                  skipped=(), race_launches: int = 0) -> None:
        """Record one auto-selection decision: ``sig`` is the pick
        signature (per (matrix, shape-bucket)), ``kernel`` the winner,
        ``mode`` how it was decided (``auto`` = timed race, ``pinned``
        = explicit profile key or the deterministic CPU pick),
        ``skipped`` the candidates passed over as unsupported/failed,
        ``race_launches`` the extra launches the race spent."""
        self._perf.inc("ec_kernel_pick_auto" if mode == "auto"
                       else "ec_kernel_pick_pinned")
        if skipped:
            self._perf.inc("ec_kernel_pick_skip", len(skipped))
        if race_launches:
            self._perf.inc("ec_kernel_pick_race_launches",
                           race_launches)
        with self._lock:
            self._picks[sig] = {"picked": kernel, "mode": mode,
                                "skipped": list(skipped),
                                "at": time.time()}

    def picks(self) -> dict:
        """Snapshot of the recorded per-signature kernel picks."""
        with self._lock:
            return {s: dict(p) for s, p in sorted(self._picks.items())}

    def dump(self) -> dict:
        """The ``dump_kernel_profile`` document: per-signature
        aggregates (counts, total/max seconds per kind), the recorded
        kernel picks (``picked`` per signature), + the recent
        compile-event ring, newest last."""
        with self._lock:
            sigs = {s: {k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in agg.items()}
                    for s, agg in sorted(self._sigs.items())}
            return {"signatures": sigs,
                    "picks": {s: dict(p)
                              for s, p in sorted(self._picks.items())},
                    "recent_compiles": list(self._compiles)}


_KERNEL_PROFILER: KernelProfiler | None = None
_KPROF_LOCK = threading.Lock()


def kernel_profiler() -> KernelProfiler:
    """Process-wide kernel profiler (codecs are shared across the OSDs
    of an in-process cluster, so the profile is too — each daemon's
    ``dump_kernel_profile`` verb serves this one document, exactly like
    the reference's per-host compiled-kernel caches)."""
    global _KERNEL_PROFILER
    with _KPROF_LOCK:
        if _KERNEL_PROFILER is None:
            _KERNEL_PROFILER = KernelProfiler()
        return _KERNEL_PROFILER
