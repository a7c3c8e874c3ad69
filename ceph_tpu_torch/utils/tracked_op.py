"""Op tracking: per-op event timelines, in-flight dump, slow-op detection.

The capability of the reference's TrackedOp/OpTracker
(src/common/TrackedOp.{h,cc} — SURVEY.md §2.2): every in-flight operation
records timestamped state marks; operators can dump in-flight and historic
ops; ops exceeding a threshold are counted as slow.

Flight-recorder extension (the tail-based sampling half of the tracing
story): an op may carry its ROOT SPAN.  When the op crosses the
complaint threshold — at finish, or mid-flight via ``note_inflight_slow``
from the daemon's tick — the tracker promotes an unsampled span out of
the tracer's side ring (retroactive retention) and fires ``on_slow``
exactly once per op, which the daemon uses to journal a ``slow_op``
cluster event.  Historic entries of slow traced ops carry ``trace_id``
so ``dump_historic_slow_ops`` can attach the full merged trace.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time


class TrackedOp:
    __slots__ = ("tracker", "op_id", "desc", "start", "events", "done",
                 "span", "slow_noted")

    def __init__(self, tracker: "OpTracker", op_id: int, desc: str,
                 span=None):
        self.tracker = tracker
        self.op_id = op_id
        self.desc = desc
        self.start = time.time()
        self.events: list[tuple[float, str]] = [(self.start, "initiated")]
        self.done = False
        # root span (utils/tracer.Span) when the op is traced — sampled
        # or unsampled; the flight recorder promotes the latter on slow
        self.span = span
        self.slow_noted = False  # on_slow fired (once per op)

    def mark(self, event: str) -> None:
        self.events.append((time.time(), event))

    def finish(self) -> None:
        if not self.done:
            self.mark("done")
            self.done = True
            self.tracker._finish(self)

    def age(self) -> float:
        return time.time() - self.start

    def dump(self) -> dict:
        d = {
            "id": self.op_id, "description": self.desc,
            "age_seconds": self.age(), "done": self.done,
            "events": [{"at": t, "event": e} for t, e in self.events],
        }
        if self.span is not None:
            d["trace_id"] = self.span.trace_id
            d["trace_sampled"] = bool(self.span.sampled)
        return d

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


class OpTracker:
    def __init__(self, history_size: int = 256, slow_op_seconds: float = 5.0,
                 on_slow=None, perf=None, lat_counter: str = "op_lat_us"):
        """``on_slow(op)`` fires at most once per op, OUTSIDE the
        tracker lock, the first time the op is seen past the complaint
        threshold (at finish, or mid-flight from note_inflight_slow) —
        the daemon's hook for journaling the ``slow_op`` event.

        ``perf``/``lat_counter`` name a pow2 histogram every finished
        op's end-to-end latency lands in (the SLO ``client_op``
        signal); sampled-trace ops attach their trace_id as the bucket
        exemplar so the p99 bucket resolves to waterfalls."""
        self._ids = itertools.count(1)
        self._inflight: dict[int, TrackedOp] = {}
        self._history: collections.deque[dict] = collections.deque(
            maxlen=history_size)
        self._slow_threshold = slow_op_seconds
        self._slow_count = 0
        self._on_slow = on_slow
        self._perf = perf
        self._lat_counter = lat_counter
        self._lock = threading.Lock()

    def bind_perf(self, perf, lat_counter: str | None = None) -> None:
        """Late-bind the latency registry (the daemon builds its
        tracker before its perf registry exists)."""
        self._perf = perf
        if lat_counter is not None:
            self._lat_counter = lat_counter

    def create(self, desc: str, span=None) -> TrackedOp:
        op = TrackedOp(self, next(self._ids), desc, span=span)
        with self._lock:
            self._inflight[op.op_id] = op
        return op

    def _retain_trace(self, op: TrackedOp) -> None:
        """Force-retain an unsampled root span the moment its op turns
        slow (the tail-based decision: evidence first, bookkeeping
        after).  Must run outside the tracker lock — the tracer has its
        own leaf lock."""
        span = op.span
        if span is not None and not span.sampled \
                and span._tracer is not None:
            span._tracer.promote(span)

    def _note_slow(self, op: TrackedOp) -> bool:
        """Check-and-set the once-per-op slow flag.  Caller holds
        _lock."""
        if op.slow_noted:
            return False
        op.slow_noted = True
        self._slow_count += 1
        return True

    def _finish(self, op: TrackedOp) -> None:
        newly_slow = False
        age = op.age()
        with self._lock:
            self._inflight.pop(op.op_id, None)
            if age >= self._slow_threshold:
                newly_slow = self._note_slow(op)
            self._history.append(op.dump())
        if self._perf is not None:
            span = op.span
            self._perf.hinc(
                self._lat_counter, age * 1e6,
                exemplar=span.trace_id
                if span is not None and span.sampled else None)
        if newly_slow:
            self._retain_trace(op)
            if self._on_slow is not None:
                try:
                    self._on_slow(op)
                except Exception:  # noqa: BLE001 - recorder must not kill IO
                    pass

    def note_inflight_slow(self) -> list[TrackedOp]:
        """Tick-driven flight-recorder sweep: ops that crossed the
        complaint threshold WHILE STILL IN FLIGHT (a wedged op may
        never finish — its evidence must not wait for a finish that
        never comes).  Promotes their traces, fires on_slow once each,
        and returns the newly-slow ops."""
        with self._lock:
            newly = [o for o in self._inflight.values()
                     if o.age() >= self._slow_threshold
                     and self._note_slow(o)]
        for op in newly:
            self._retain_trace(op)
            if self._on_slow is not None:
                try:
                    self._on_slow(op)
                except Exception:  # noqa: BLE001
                    pass
        return newly

    def dump_ops_in_flight(self) -> list[dict]:
        with self._lock:
            return [o.dump() for o in self._inflight.values()]

    def dump_historic_ops(self) -> list[dict]:
        with self._lock:
            return list(self._history)

    def slow_ops(self) -> list[dict]:
        """Currently in-flight ops past the slow threshold."""
        with self._lock:
            return [o.dump() for o in self._inflight.values()
                    if o.age() >= self._slow_threshold]

    def dump_historic_slow_ops(self) -> list[dict]:
        """Completed ops whose total duration crossed the complaint
        threshold (the reference's dump_historic_slow_ops verb — the
        history entry's age_seconds was fixed at finish time, so it IS
        the op's duration).  Traced entries carry trace_id; the daemon
        verb attaches the merged trace."""
        with self._lock:
            return [d for d in self._history
                    if d["age_seconds"] >= self._slow_threshold]

    def slow_op_count(self) -> int:
        """Cumulative count of ops seen past the threshold (finished
        or swept mid-flight; each op counts once)."""
        with self._lock:
            return self._slow_count

    def slow_summary(self, max_ops: int = 3) -> dict:
        """The health-mux feed: currently-blocked slow ops (these drive
        — and clear — HEALTH_WARN SLOW_OPS), the cumulative count, and
        the worst in-flight offenders by age."""
        with self._lock:
            slow = sorted((o for o in self._inflight.values()
                           if o.age() >= self._slow_threshold),
                          key=lambda o: o.start)
            return {
                "inflight": len(slow),
                "total": self._slow_count,
                "complaint_time": self._slow_threshold,
                "worst": [{"description": o.desc,
                           "age_seconds": round(o.age(), 3)}
                          for o in slow[:max_ops]],
            }
