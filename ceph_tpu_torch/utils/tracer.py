"""Distributed tracing: span trees across the client -> primary ->
shard fan-out.

The capability of the reference's tracer (src/common/tracer.h:10-35 —
jaeger spans started per op, child spans per pipeline stage; ZTracer
child spans per EC sub-op, src/osd/ECCommon.cc:1046-1051), re-shaped
for this runtime: every entity (client, osd, mon) owns a Tracer that
records finished spans into a bounded ring; a trace CONTEXT — the
(trace_id, span_id) pair — rides message fields, so a child span on
the receiving daemon links to its remote parent without any shared
state.  Aggregation is collector-style: each daemon dumps its local
spans for a trace id (admin socket verb), and the operator (or
MiniCluster.collect_trace) merges the rings into one tree — the same
shape jaeger assembles from per-service reports.

Tracing is off unless the op carries a context (zero overhead on the
hot path: one falsy check per handler).

Head sampling (the always-on mode): a root op calls ``sample_root``
instead of ``start`` — with ``sample_rate`` <= 0 it returns None at
zero cost (no RNG draw, no allocation); otherwise the op is SAMPLED
with that probability.  A sampled root is a normal span whose context
propagates on the wire, so the one head decision covers the whole
client -> primary -> shard fan-out (the OpenTelemetry parent-based
sampler shape: a child traces iff the message carries a context).  An
UNSAMPLED root still gets a lightweight local-only span (``sampled``
False, context never propagated) held in a small bounded side ring —
the flight-recorder feed: when the op later crosses the slow-op
complaint threshold, ``promote()`` force-retains it retroactively into
the ordinary rings, so SLOW_OPS evidence survives even at low sample
rates.  ``trace_sampled`` / ``trace_dropped`` / ``trace_leaked``
counters land on the owning daemon's perf registry when one is given.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Span:
    trace_id: int
    span_id: int
    parent_id: int          # 0 = root
    name: str
    service: str            # entity that produced it (client.x / osd.N)
    start: float = field(default_factory=time.time)
    end: float = 0.0
    tags: dict = field(default_factory=dict)
    _tracer: "Tracer | None" = None
    # head-sampling verdict: False = local-only flight-recorder span
    # (context must NOT propagate; lives in the unsampled side ring
    # until promoted or aged out)
    sampled: bool = True

    @property
    def ctx(self) -> tuple[int, int]:
        """The propagation context a child on another daemon parents
        itself under (trace.h's trace context role)."""
        return (self.trace_id, self.span_id)

    def tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def finish(self) -> None:
        """Idempotent: async completions can race teardown.  The
        check-and-set must be ATOMIC with the ring append — two racing
        finishers both passing a bare `if self.end` check would each
        _record() the span and double-append it to the ring — so a
        tracer-owned span delegates the whole close to the tracer,
        under its lock."""
        if self._tracer is not None:
            self._tracer._finish(self)
        elif not self.end:
            self.end = time.time()

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


def _span_dict(s: Span, now: float) -> dict:
    """ONE dict shape for every dump path (spans_for and the no-id
    dump used to diverge — the id-less shape dropped start/end and
    broke build_tree's start-sort on merged dumps).  Unfinished spans
    keep end=0 and carry in_flight=True with the duration measured to
    `now`, so hung ops are visible in the same tree."""
    end = s.end
    d = {"trace_id": s.trace_id, "span_id": s.span_id,
         "parent_id": s.parent_id, "name": s.name,
         "service": s.service, "start": s.start, "end": end,
         "dur_ms": round(((end or now) - s.start) * 1000, 3),
         "tags": dict(s.tags)}
    if not end:
        d["in_flight"] = True
    return d


class Tracer:
    """Per-entity span factory + bounded finished-span ring."""

    KEEP = 2048  # finished spans retained (ring; ops tooling window)
    UNSAMPLED_KEEP = 128  # recent unsampled roots (flight-recorder feed)

    #: per-service sampling counters, registered on the daemon's perf
    #: registry when one is supplied (idempotent: has-before-add)
    PERF_COUNTERS = ("trace_sampled", "trace_dropped", "trace_leaked")

    def __init__(self, service: str, sample_rate: float = 0.0,
                 perf=None, rng: random.Random | None = None):
        self.service = service
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self._ids = itertools.count(1)
        self._seed = (hash(service) & 0xFFFF) << 32
        self._lock = threading.Lock()
        self._rng = rng if rng is not None else random.Random()
        self._done: deque[Span] = deque(maxlen=self.KEEP)
        # started-but-unfinished spans, so dumps can show hung ops;
        # bounded like the ring (a leaked span must not grow it forever)
        self._live: dict[int, Span] = {}
        # recent UNSAMPLED root spans: the retroactive-retention window
        # the slow-op flight recorder promotes from (bounded — aged-out
        # spans are simply gone, exactly like the dropped traces)
        self._unsampled: deque[Span] = deque(maxlen=self.UNSAMPLED_KEEP)
        self._perf = perf
        if perf is not None:
            for name in self.PERF_COUNTERS:
                if not perf.has(name):
                    perf.add(name)

    def set_sample_rate(self, rate) -> None:
        """Config-live knob (the trace_sample_rate observer target)."""
        self.sample_rate = max(0.0, min(1.0, float(rate)))

    def _next_id(self) -> int:
        return self._seed | next(self._ids)

    def start(self, name: str, parent: tuple | None = None,
              **tags) -> Span:
        """Start a span.  parent = a (trace_id, span_id) context from a
        message (remote parent) or a local Span.ctx; None starts a new
        root trace."""
        if parent:
            trace_id, parent_id = int(parent[0]), int(parent[1])
        else:
            trace_id, parent_id = self._next_id(), 0
        span = Span(trace_id, self._next_id(), parent_id, name,
                    self.service, tags=dict(tags), _tracer=self)
        with self._lock:
            self._live[span.span_id] = span
            while len(self._live) > self.KEEP:
                # overflow = leaked spans (owners that never finish):
                # close them into the done ring tagged leaked=True —
                # silently discarding them destroyed exactly the
                # hung-op evidence the live table exists to keep
                leaked = self._live.pop(next(iter(self._live)))
                leaked.end = time.time()
                leaked.tags["leaked"] = True
                self._done.append(leaked)
                if self._perf is not None:
                    self._perf.inc("trace_leaked")
        return span

    def sample_root(self, name: str, **tags) -> Span | None:
        """Head-sampling entry point for ROOT ops (client writes/reads,
        recovery storms, scrub).  Returns None at zero cost when
        sampling is off; a normal propagating span (``sampled`` True,
        counted trace_sampled) with probability ``sample_rate``; and
        otherwise a local-only unsampled span (counted trace_dropped)
        held in the bounded side ring for retroactive slow-op
        retention.  Callers propagate ``span.ctx`` on the wire ONLY
        when ``span.sampled`` — that is the one head decision covering
        the whole fan-out."""
        rate = self.sample_rate
        if rate <= 0.0:
            return None
        if rate >= 1.0 or self._rng.random() < rate:
            if self._perf is not None:
                self._perf.inc("trace_sampled")
            return self.start(name, **tags)
        if self._perf is not None:
            self._perf.inc("trace_dropped")
        span = Span(self._next_id(), self._next_id(), 0, name,
                    self.service, tags=dict(tags), _tracer=self,
                    sampled=False)
        with self._lock:
            self._unsampled.append(span)
        return span

    def promote(self, span: Span) -> None:
        """Force-retain an unsampled root span (the tail-based flight
        recorder: the op it roots crossed the slow-op threshold, so
        its evidence must survive the side ring's churn).  Idempotent;
        a span that already aged out of the side ring is re-adopted
        all the same."""
        with self._lock:
            if span.sampled:
                return
            span.sampled = True
            span.tags["retained"] = True
            try:
                self._unsampled.remove(span)
            except ValueError:
                pass  # aged out of the side ring; adopt anyway
            if span.end:
                self._done.append(span)
            else:
                self._live[span.span_id] = span

    def _finish(self, span: Span) -> None:
        """Atomic close: end-stamp check-and-set + ring append under
        ONE lock hold, so racing finishers record the span exactly
        once (Span.finish docstring has the failure mode).  An
        unsampled span just gets end-stamped — it already sits in the
        bounded side ring (or was promoted, flipping sampled)."""
        with self._lock:
            if span.end:
                return
            span.end = time.time()
            if not span.sampled:
                return
            self._live.pop(span.span_id, None)
            self._done.append(span)

    def spans_for(self, trace_id: int) -> list[dict]:
        now = time.time()
        with self._lock:
            spans = [s for s in self._done if s.trace_id == trace_id]
            spans += [s for s in self._live.values()
                      if s.trace_id == trace_id]
        return [_span_dict(s, now) for s in spans]

    def dump(self, trace_id: int | None = None) -> list[dict]:
        if trace_id is not None:
            return self.spans_for(trace_id)
        now = time.time()
        with self._lock:
            spans = list(self._done) + list(self._live.values())
        return [_span_dict(s, now) for s in spans]


def build_tree(spans: list[dict]) -> list[dict]:
    """Assemble collector-merged span dicts into parent->children trees
    (roots returned; orphans whose parent span is missing from the
    window become roots too, tagged so)."""
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots = []
    for s in by_id.values():
        parent = by_id.get(s["parent_id"])
        if parent is not None:
            parent["children"].append(s)
        else:
            if s["parent_id"]:
                s["orphan"] = True
            roots.append(s)
    for s in by_id.values():
        s["children"].sort(key=lambda c: c["start"])
    roots.sort(key=lambda c: c["start"])
    return roots
