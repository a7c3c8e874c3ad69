#!/usr/bin/env python3
"""How steady the timed bursts of tools/bench_root --ec-batch are: the
8-writer, 24-op burst of (8, 16 KiB) encodes through an ECBatcher
(window 2000 us) that the mode's tracing, exemplar and perf-query legs
time, with every leg alike (an A/A test of their 5 % gates).

For each interpreter switch interval of ``--switch`` (seconds; the
default 0.005 first) it runs ``--evals`` evaluations of the gates'
statistic, each three interleaved rounds of two identical bursts with
each side's best kept, ``min(B) / min(A) - 1``, and prints how many
evaluations fall outside 5 %.  Variants take turns, evaluation by
evaluation.  Each burst's flushes are timed too: the leader's wake after
its window ran out (``late``), the flush itself (``flush``), and the ops
each flush carried.

``--profile`` instead times the host work of one op's staging and of
one 8-op flush, step by step, first in one thread (staging 8 ops, then
flushing them) and then summed over whole bursts.  ``--staging-ab``
times bursts whose ops are staged by ``utils/staging.device_put_landed``
against bursts staged by its earlier form (a pinned buffer filled by
numpy and a pair of timing events around every queued copy), in turns.
``--costs`` times, in one thread, what the overhead legs add to each op:
a head-sampling draw at 1 % against 0 %, and a standing perf query's
``observe``.

    python3 experiments/burst_noise.py --device cuda
    python3 experiments/burst_noise.py --device cuda --profile
    python3 experiments/burst_noise.py --device cuda --staging-ab 20
    python3 experiments/burst_noise.py --device cpu --costs
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from ceph_tpu_torch import ec  # noqa: E402
from ceph_tpu_torch.ec.batcher import ECBatcher, bucket_len  # noqa: E402

K, M = 8, 3
CHUNK, WRITERS, OPS = 16 * 1024, 8, 24
GATE = 0.05


class TimedBatcher(ECBatcher):
    """An ECBatcher that keeps, per flush, how late its take came after
    the window's end, how long the flush took, and its op count."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.flushes: list[tuple[float, float, int]] = []
        self._taken_at = 0.0
        self._late = 0.0

    def _take_locked(self, sig):
        ops = super()._take_locked(sig)
        if ops:
            self._taken_at = ops[0].taken_at
            self._late = max(0.0, self._taken_at - ops[0].deadline)
        return ops

    def _complete(self, ops, src_bytes, reason, *shard):
        self.flushes.append((self._late, time.monotonic() - self._taken_at,
                             len(ops)))
        super()._complete(ops, src_bytes, reason, *shard)


def burst(codec, payloads) -> tuple[float, TimedBatcher]:
    b = TimedBatcher(window_us=2000, max_bytes=64 << 20)
    barrier = threading.Barrier(WRITERS + 1)

    def writer(w):
        barrier.wait()
        for data in payloads[w]:
            b.encode(codec, data)

    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(WRITERS)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, b


def evaluate(codec, payloads, log: list) -> float:
    """One A/A evaluation of the gates' statistic."""
    best = {"a": float("inf"), "b": float("inf")}
    for _ in range(3):
        for side in best:
            dt, b = burst(codec, payloads)
            best[side] = min(best[side], dt)
            log.append((dt, b.flushes))
    return best["b"] / best["a"] - 1


#: (owner, attribute) of each step --profile times
STEPS = (("staging", "device_put_landed"), ("staging", "record_ready"),
         ("staging", "fetch_recorded"), ("batcher", "_stage_encode_op"),
         ("batcher", "_submit"), ("batcher", "_flush_encode"),
         ("batcher", "_fold_device"), ("batcher", "_device_csums"),
         ("batcher", "_sync_flush"), ("batcher", "_complete"),
         ("batcher", "_launch_ctx"), ("codec", "_matmul_device"))


def profile(codec, payloads) -> None:
    """Wall time inside each step of STEPS: mean a call, single thread,
    then per burst under the 8 writers."""
    from ceph_tpu_torch.utils import staging
    owners = {"staging": staging, "batcher": ECBatcher, "codec": codec}
    clock: dict[str, list] = {}
    for who, name in STEPS:
        obj = owners[who]
        real = getattr(obj, name)
        tag = f"{who}.{name}"
        clock[tag] = [0, 0.0]

        def timed(*a, _real=real, _tag=tag, **kw):
            t0 = time.perf_counter()
            try:
                return _real(*a, **kw)
            finally:
                c = clock[_tag]
                c[0] += 1
                c[1] += time.perf_counter() - t0
        if isinstance(obj, type) and isinstance(
                obj.__dict__.get(name), staticmethod):
            timed = staticmethod(timed)
        setattr(obj, name, timed)

    def report(what, per):
        print(what + "; ".join(
            f"{t} {c[0] / per:g}x {c[1] / max(c[0], 1) * 1e6:.1f} us"
            for t, c in clock.items() if c[0]), flush=True)
        for c in clock.values():
            c[0], c[1] = 0, 0.0

    from ceph_tpu_torch.ec.batcher import FLUSH_WINDOW, _PendingOp
    b = ECBatcher(window_us=2000, max_bytes=64 << 20)
    sig = ("enc", codec.fold_sig(), codec.matrix.tobytes(), K, M, False,
           bucket_len(CHUNK))
    reps = 50
    for rep in range(reps + 5):
        if rep == 5:
            for c in clock.values():
                c[0], c[1] = 0, 0.0
        ops = []
        for w in range(WRITERS):
            op = _PendingOp(codec, streams=payloads[w][rep % OPS],
                            length=CHUNK)
            b._stage_encode_op(op, sig[-1])
            ops.append(op)
        b._flush_encode(sig, ops, FLUSH_WINDOW)
    report(f"one thread, {WRITERS} ops staged then flushed, a round: ", reps)
    n = 12
    dts = [burst(codec, payloads)[0] for _ in range(n)]
    report(f"{WRITERS} writers, a burst (median "
           f"{statistics.median(dts) * 1e3:.1f} ms): ", n)
    put_steps(codec, payloads)


def put_steps(codec, payloads) -> None:
    """The staging copy of one op split into its steps, under the 8
    writers: wall time inside each step a call."""
    from ceph_tpu_torch.utils import staging
    real = staging.device_put_landed
    steps: dict[str, list] = {}

    def tick(name, t0):
        t1 = time.perf_counter()
        c = steps.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += t1 - t0
        return t1

    def put(host, device, *, force=True, record=True, exemplar=None):
        device = torch.device(device)
        t = time.perf_counter()
        host = np.ascontiguousarray(host)
        pinned = torch.empty(host.shape, dtype=torch.uint8,
                             pin_memory=True)
        t = tick("pinned alloc", t)
        pinned.numpy()[...] = host
        t = tick("copy into pinned", t)
        start, end = staging._events(device)
        t = tick("events, start", t)
        dev = pinned.to(device, non_blocking=True)
        t = tick("to(non_blocking)", t)
        end.record(torch.cuda.current_stream(device))
        t = tick("end record", t)
        if record:
            staging.note_h2d(host.nbytes, None, exemplar=exemplar)
        tick("note_h2d", t)
        return dev

    staging.device_put_landed = put
    try:
        n = 12
        dts = [burst(codec, payloads)[0] for _ in range(n)]
    finally:
        staging.device_put_landed = real
    print(f"{WRITERS} writers, the staging copy's steps (bursts median "
          f"{statistics.median(dts) * 1e3:.1f} ms): " + "; ".join(
              f"{k} {c[1] / c[0] * 1e6:.1f} us" for k, c in steps.items()),
          flush=True)


def staging_ab(codec, payloads, rounds: int) -> None:
    """Bursts staged by the current device_put_landed (``new``) and by
    its earlier form (``old``), in turns."""
    from ceph_tpu_torch.utils import staging
    new = staging.device_put_landed

    def old(host, device, *, force=True, record=True, exemplar=None):
        device = torch.device(device)
        host = np.ascontiguousarray(host)
        pinned = torch.empty(host.shape, dtype=torch.from_numpy(
            host[:0]).dtype, pin_memory=True)
        pinned.numpy()[...] = host
        start, end = staging._events(device)
        dev = pinned.to(device, non_blocking=True)
        end.record(torch.cuda.current_stream(device))
        dt = None
        if force:
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        if record:
            staging.note_h2d(host.nbytes, dt, exemplar=exemplar)
        return dev

    runs = {"old": [], "new": []}
    flushes = {"old": [], "new": []}
    try:
        for _ in range(rounds):
            for name, put in (("old", old), ("new", new)):
                staging.device_put_landed = put
                dt, b = burst(codec, payloads)
                runs[name].append(dt)
                flushes[name].append(len(b.flushes))
    finally:
        staging.device_put_landed = new
    for name, dts in runs.items():
        print(f"staging {name}: bursts min {min(dts) * 1e3:.1f} median "
              f"{statistics.median(dts) * 1e3:.1f} max "
              f"{max(dts) * 1e3:.1f} ms; flushes a burst median "
              f"{statistics.median(flushes[name])}", flush=True)


def costs(n: int = 20000) -> None:
    """Microseconds an op of what the overhead legs add."""
    from ceph_tpu_torch.telemetry.perf_query import PerfQuerySet
    from ceph_tpu_torch.utils.tracer import Tracer
    pq = PerfQuerySet()
    pq.set_queries({1: {"qid": 1, "key_by": ["tenant"],
                        "counters": ["ops", "bytes_in", "bytes_out", "lat"],
                        "top_n": 32, "prefix_len": 8}})
    t0 = time.perf_counter()
    for i in range(n):
        pq.observe(f"tenant{i % WRITERS}", 1, "1.0", "write",
                   f"obj-{i % OPS:04d}", K * CHUNK, 0, 100.0)
    out = {"perf query observe": time.perf_counter() - t0}
    tr = Tracer("costs")
    for rate in (0.0, 0.01):
        tr.set_sample_rate(rate)
        t0 = time.perf_counter()
        for i in range(n):
            root = tr.sample_root("ec-op", writer=0, op=i)
            if root is not None:
                root.finish()
        out[f"sample_root at {rate:g}"] = time.perf_counter() - t0
    print("; ".join(f"{k} {v / n * 1e6:.2f} us an op" for k, v in out.items()),
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--evals", type=int, default=12)
    p.add_argument("--switch", default="0.005,0.0002")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--staging-ab", type=int, default=0, metavar="ROUNDS")
    p.add_argument("--costs", action="store_true")
    args = p.parse_args(argv)
    if args.costs:
        costs()
        return 0
    dev = torch.device(args.device)
    codec = ec.factory("tpu", {"k": K, "m": M, "backend": "torch",
                               "device": str(dev), "shard": "off"})
    rng = np.random.default_rng(5)
    payloads = [[rng.integers(0, 256, (K, CHUNK), dtype=np.uint8)
                 for _ in range(OPS)] for _ in range(WRITERS)]
    n2 = 1
    while n2 <= WRITERS:  # the race, off the clock
        codec.encode_chunks(np.zeros((K, n2 * bucket_len(CHUNK)),
                                     dtype=np.uint8))
        n2 <<= 1
    burst(codec, payloads)
    print(f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          f"; {os.cpu_count()} CPUs", flush=True)
    if args.profile:
        profile(codec, payloads)
        return 0
    if args.staging_ab:
        staging_ab(codec, payloads, args.staging_ab)
        return 0
    default = sys.getswitchinterval()
    switches = [float(s) for s in args.switch.split(",")]
    ratios = {s: [] for s in switches}
    logs = {s: [] for s in switches}
    for _ in range(args.evals):
        for s in switches:
            sys.setswitchinterval(s)
            try:
                ratios[s].append(evaluate(codec, payloads, logs[s]))
            finally:
                sys.setswitchinterval(default)
    for s in switches:
        r = ratios[s]
        dts = [dt for dt, _ in logs[s]]
        fl = [f for _, fs in logs[s] for f in fs]
        late = [f[0] * 1e3 for f in fl]
        flush = [f[1] * 1e3 for f in fl]
        per_burst = [len(fs) for _, fs in logs[s]]
        ops = [f[2] for f in fl]
        print(f"switch {s * 1e3:g} ms: A/A {[round(x * 100, 2) for x in r]} %"
              f"; outside {GATE * 100:g} %: "
              f"{sum(abs(x) > GATE for x in r)} of {len(r)}; bursts min "
              f"{min(dts) * 1e3:.1f} median {statistics.median(dts) * 1e3:.1f}"
              f" max {max(dts) * 1e3:.1f} ms; flushes a burst "
              f"{min(per_burst)}-{max(per_burst)}, ops a flush mean "
              f"{statistics.mean(ops):.2f}; late median "
              f"{statistics.median(late):.3f} p90 "
              f"{np.percentile(late, 90):.3f} max {max(late):.3f} ms; "
              f"flush median {statistics.median(flush):.3f} p90 "
              f"{np.percentile(flush, 90):.3f} max {max(flush):.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
