#!/usr/bin/env python3
"""Run chip_smoke.py's phase 17 (the port's 14-OSD cluster) a few times
with its peering messages and its lossy points traced.

    python3 experiments/osd_trace.py [--runs 4] [--op-timeout 20 5]
        [--defaults] [--quiet 25] [--out ceph_tpu_torch/build]

Run from the root of a checkout on a machine with a CUDA card (or with
``--device cpu --objects 16 --object-size 1048576`` on the CPU, at a
small size).  Each run is the phase as ``chip_smoke.phase_osd`` drives
it, at ``OSD_CONFIG`` (with ``--defaults``: at the default config) with
``osd_op_timeout`` set to the next value of ``--op-timeout`` in turn
(none given: the config's own).  Over each run it counts:

- messages each OSD's op queue dropped at its cap, by class and type,
  and messages its messenger dropped at its throttle;
- exceptions the op-queue workers caught;
- ops the ``osd_op_timeout`` sweep failed (each listed in
  ``osd_trace.log``: the op, the shards that had arrived), and the age
  of the oldest op a sweep found pending (the margin to the timeout);
- from the first OSD loss until the rebuild is done, each message type
  the op queues ran: how long it waited in the queue and how long its
  handler took (one ``[handlers]`` line a run, the five busiest types).

With ``--profile``, from the first OSD loss until the rebuild is done,
it samples the stacks of the threads not parked in a wait and reads
each thread's CPU time from /proc, and writes both, grouped, to
``osd_trace_profile_run<N>.txt`` (one ``[profile]`` line a run).

For every MPGQuery and MPGInfo it keeps when it was last sent, taken
into an OSD's dispatch and handled, a (sender, receiver, PG) apiece.
When no PG's peering has moved for ``--quiet`` seconds, it writes who
waits on whom with that trail, the queue depths and every thread's
stack to ``osd_trace_run<N>.txt`` and fails the run.  One line a run
goes to standard output; the exit code is 1 if a run failed, 2 without
a card.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import threading
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402
from ceph_tpu_torch.msg import messenger as msgr  # noqa: E402
from ceph_tpu_torch.msg.messages import MPGInfo, MPGQuery  # noqa: E402
from ceph_tpu_torch.osd import daemon, scheduler  # noqa: E402
from ceph_tpu_torch.tools import vstart  # noqa: E402
from ceph_tpu_torch.utils.config import default_config  # noqa: E402

PEERING = (MPGQuery, MPGInfo)


class Trace:
    """What the wrapped methods record during one run."""

    def __init__(self, log):
        self.log = log
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        self.trail: dict = {}
        self.drops = collections.Counter()
        self.errors = collections.Counter()
        self.expired = 0
        self.oldest = 0.0
        #: message type -> [(queue wait, handler seconds)], from the
        #: first loss until the rebuild is done
        self.handled: dict = collections.defaultdict(list)
        self.window = False

    def note(self, *key, **val):
        with self.lock:
            self.trail[key] = (time.monotonic(), val)


class Profile:
    """From a run's first OSD loss until recovery has rebuilt the lost
    shards: every ``every`` seconds a stack sample of each thread not
    parked in a wait, and at both ends each thread's CPU time (from
    /proc), grouped by the function the thread was started on."""

    WAITS = {"wait", "sleep", "_wait_for_tstate_lock", "select", "poll",
             "accept", "recv", "recv_into", "get"}

    def __init__(self, every: float = 0.01):
        self.every = every
        self.leaf = collections.Counter()
        self.incl = collections.Counter()
        self.samples = 0
        self.stop_ev = threading.Event()
        self.thread = None
        self.cpu0: dict = {}

    @staticmethod
    def cpu() -> dict:
        """native thread id -> (group, CPU seconds)."""
        tick = os.sysconf("SC_CLK_TCK")
        names = {}
        for t in threading.enumerate():
            target = getattr(t, "_target", None)
            names[t.native_id] = getattr(target, "__qualname__",
                                         None) or t.name
        out = {}
        for tid in os.listdir("/proc/self/task"):
            try:
                with open(f"/proc/self/task/{tid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            out[int(tid)] = (names.get(int(tid), "other"),
                             (int(fields[11]) + int(fields[12])) / tick)
        return out

    def start(self) -> None:
        self.cpu0 = self.cpu()
        self.t0 = time.monotonic()
        self.thread = threading.Thread(target=self.sample, daemon=True)
        self.thread.start()

    def sample(self) -> None:
        me = threading.get_ident()
        while not self.stop_ev.wait(self.every):
            for tid, frame in sys._current_frames().items():
                if tid == me or frame.f_code.co_name in self.WAITS:
                    continue
                self.samples += 1
                code = frame.f_code
                self.leaf[f"{os.path.basename(code.co_filename)}:"
                          f"{frame.f_lineno} {code.co_name}"] += 1
                seen = set()
                while frame is not None:
                    code = frame.f_code
                    key = (f"{os.path.basename(code.co_filename)} "
                           f"{code.co_qualname}")
                    if key not in seen:
                        seen.add(key)
                        self.incl[key] += 1
                    frame = frame.f_back

    def stop(self) -> str:
        """Stop sampling; the report."""
        self.stop_ev.set()
        self.thread.join()
        wall = time.monotonic() - self.t0
        groups = collections.Counter()
        for tid, (name, sec) in self.cpu().items():
            groups[name] += sec - self.cpu0.get(tid, (name, 0.0))[1]
        lines = [f"window {wall:.3f} s, {self.samples} samples, CPU "
                 f"{sum(groups.values()):.2f} s by thread function:"]
        lines += [f"  {sec:8.2f} s  {name}"
                  for name, sec in groups.most_common(20)]
        lines.append("innermost frames:")
        lines += [f"  {n:6d}  {k}" for k, n in self.leaf.most_common(30)]
        lines.append("frames on the stack:")
        lines += [f"  {n:6d}  {k}" for k, n in self.incl.most_common(60)]
        self.top = (f"CPU {sum(groups.values()):.2f} s in {wall:.3f} s: "
                    + ", ".join(f"{name} {sec:.2f}"
                                for name, sec in groups.most_common(6)))
        return "\n".join(lines)


def instrument(tr: Trace) -> None:
    """Wrap the messenger, the OSD's handlers and the op queue."""
    send = msgr.Connection.send

    def traced_send(self, msg):
        if isinstance(msg, PEERING):
            tr.note("sent", type(msg).__name__, self.messenger.name,
                    self.peer, str(msg.pgid),
                    epoch=getattr(msg, "epoch", None))
        return send(self, msg)

    msgr.Connection.send = traced_send
    dispatch = daemon.OSDDaemon.ms_dispatch

    def traced_dispatch(self, conn, msg):
        if isinstance(msg, PEERING):
            tr.note("taken", type(msg).__name__, conn.peer, self.name,
                    str(msg.pgid), epoch=getattr(msg, "epoch", None))
        try:
            msg._traced_at = time.monotonic()
        except AttributeError:  # a message with __slots__
            pass
        return dispatch(self, conn, msg)

    daemon.OSDDaemon.ms_dispatch = traced_dispatch
    run_scheduled = daemon.OSDDaemon._run_scheduled

    def timed_run(self, klass, item):
        msg, start = item[2], time.monotonic()
        try:
            return run_scheduled(self, klass, item)
        finally:
            if tr.window:
                tr.handled[type(msg).__name__].append(
                    (start - getattr(msg, "_traced_at", start),
                     time.monotonic() - start))

    daemon.OSDDaemon._run_scheduled = timed_run
    for name, kind in (("_handle_pg_query", "MPGQuery"),
                       ("_handle_pg_info", "MPGInfo")):
        def wrap(handler=getattr(daemon.OSDDaemon, name), kind=kind):
            def traced(self, conn, m):
                tr.note("handled", kind, conn.peer if conn else None,
                        self.name, str(m.pgid),
                        epoch=getattr(m, "epoch", None))
                return handler(self, conn, m)
            return traced
        setattr(daemon.OSDDaemon, name, wrap())
    enqueue = scheduler.MClockScheduler.enqueue

    def traced_enqueue(self, klass, item, **kw):
        before = self.dropped.get(klass, 0)
        enqueue(self, klass, item, **kw)
        if self.dropped.get(klass, 0) > before:
            tr.drops[(klass, type(item[2]).__name__)] += 1

    scheduler.MClockScheduler.enqueue = traced_enqueue
    init = scheduler.MClockScheduler.__init__

    def traced_init(self, handler, *a, **kw):
        def run(klass, item):
            try:
                handler(klass, item)
            except Exception:
                tr.errors[f"{type(item[2]).__name__}: "
                          f"{traceback.format_exc().splitlines()[-1]}"] += 1
                raise
        init(self, run, *a, **kw)

    scheduler.MClockScheduler.__init__ = traced_init
    sweep = daemon.OSDDaemon._sweep_pending

    def traced_sweep(self, now, max_age=None):
        age = self.cfg["osd_op_timeout"] if max_age is None else max_age
        with self._pending_lock:
            late = [("write", t) for t, pw in self._pending_writes.items()
                    if now - pw.stamp > age]
            late += [("read", t, pr.oid, sorted(pr.chunks))
                     for t, pr in self._pending_reads.items()
                     if now - pr.stamp > age]
            ages = [now - p.stamp for p in (*self._pending_writes.values(),
                                            *self._pending_reads.values())]
        tr.oldest = max([tr.oldest, *ages])
        if late:
            tr.expired += len(late)
            tr.log(f"timed out on {self.name}: {late}")
        return sweep(self, now, max_age)

    daemon.OSDDaemon._sweep_pending = traced_sweep


def stall_report(tr: Trace, cluster, pending: dict) -> str:
    """Who waits on whom, each waiting pair's message trail, the queue
    depths, then every thread's stack."""
    now = time.monotonic()
    lines = []
    for i, pgs in pending.items():
        o = cluster.osds[i]
        for pg, waiting in pgs.items():
            lines.append(f"primary osd.{i} pg {pg} waits on "
                         f"{sorted(waiting)}, map {o.osdmap.epoch}")
            for p in sorted(waiting):
                po = cluster.osds.get(p)
                if po is None:
                    lines.append(f"  osd.{p}: not running")
                    continue
                lines.append(f"  osd.{p}: map {po.osdmap.epoch}, queues "
                             f"{po.scheduler.queue_depths()}, messenger "
                             f"{po.messenger.queue_depths()}")
                a, b, s = f"osd.{i}", f"osd.{p}", str(pg)
                for step, kind, src, dst in (
                        ("sent", "MPGQuery", a, b),
                        ("taken", "MPGQuery", a, b),
                        ("handled", "MPGQuery", a, b),
                        ("sent", "MPGInfo", b, a),
                        ("taken", "MPGInfo", b, a),
                        ("handled", "MPGInfo", b, a)):
                    seen = tr.trail.get((step, kind, src, dst, s))
                    lines.append(f"    {step:7s} {kind}: " + (
                        "never" if seen is None else
                        f"{now - seen[0]:.2f} s ago {seen[1]}"))
            lines.append(f"  primary queues {o.scheduler.queue_depths()}"
                         f", messenger {o.messenger.queue_depths()}")
    frames = sys._current_frames()
    for t in threading.enumerate():
        if t.ident in frames:
            lines.append(f"--- thread {t.name}\n" + "".join(
                traceback.format_stack(frames[t.ident])[-8:]))
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--op-timeout", type=float, nargs="+", default=None)
    ap.add_argument("--defaults", action="store_true",
                    help="run at the default config, not OSD_CONFIG")
    ap.add_argument("--profile", action="store_true",
                    help="profile each run from the loss to the rebuild "
                         "into osd_trace_profile_run<N>.txt")
    ap.add_argument("--share-codecs", type=int, nargs="+", default=[0],
                    help="per run in turn: 1 = the OSDs share one codec "
                         "a pool (so its kernel picks), 0 = one each")
    ap.add_argument("--quiet", type=float, default=25.0)
    ap.add_argument("--out", default="ceph_tpu_torch/build")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--objects", type=int, default=None)
    ap.add_argument("--object-size", type=int, default=None)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("osd_trace: no CUDA card", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "osd_trace.log"), "w",
              buffering=1) as logf:
        return trace_runs(args, lambda text: logf.write(text + "\n"))


def trace_runs(args, log) -> int:
    tr = Trace(log)
    instrument(tr)
    run_no = [0]

    def peered(cluster, wait_s):
        def pending():
            return {i: {pg: set(w) for pg, w in list(o._peering.items())}
                    for i, o in list(cluster.osds.items()) if o._peering}

        deadline = time.monotonic() + wait_s
        last, since = None, time.monotonic()
        while (now := pending()):
            if now != last:
                last, since = now, time.monotonic()
            elif time.monotonic() - since > args.quiet:
                path = os.path.join(args.out,
                                    f"osd_trace_run{run_no[0]}.txt")
                with open(path, "w") as f:
                    f.write(stall_report(tr, cluster, now) + "\n")
                raise AssertionError(f"peering stalled {args.quiet} s, "
                                     f"see {path}: {now}")
            if time.monotonic() > deadline:
                raise AssertionError(f"peering not within {wait_s} s")
            time.sleep(0.05)

    chip_smoke.osd_peered = peered
    prof: list = []
    kill, wait_until = vstart.MiniCluster.kill_osd, chip_smoke._wait_until

    def profiled_kill(self, osd_id, *a, **kw):
        tr.window = True
        if args.profile and not prof:
            prof.append(Profile())
            prof[0].start()
        return kill(self, osd_id, *a, **kw)

    def profiled_wait(what, done, wait_s):
        wait_until(what, done, wait_s)
        if not what.startswith("recovery"):
            return
        tr.window = False
        print(f"[handlers] run {run_no[0]}: " + "; ".join(
            f"{name} {len(v)}, queued up to {max(w for w, _ in v):.3f} s, "
            f"handled in {sum(d for _, d in v) / len(v):.4f} s a message "
            f"(at most {max(d for _, d in v):.3f})"
            for name, v in sorted(tr.handled.items(),
                                  key=lambda kv: -sum(d for _, d in kv[1])
                                  )[:5]), flush=True)
        if prof:
            path = os.path.join(args.out,
                                f"osd_trace_profile_run{run_no[0]}.txt")
            with open(path, "w") as f:
                f.write(prof[0].stop() + "\n")
            print(f"[profile] run {run_no[0]}: {prof[0].top}", flush=True)

    stop = vstart.MiniCluster.stop

    def counted_stop(self, *a, **kw):
        # the kernel picks the OSDs' codecs pinned: one race each, and
        # how many distinct signatures they were (a race per signature
        # if the OSDs of one process shared their picks)
        picks = [p for o in list(self.osds.values())
                 for c in o._ec_codecs.values()
                 if hasattr(c, "kernel_picks")
                 for p in c.kernel_picks().items()]
        print(f"[picks] run {run_no[0]}: {len(picks)} pins by "
              f"{sum(len(o._ec_codecs) for o in self.osds.values())} "
              f"codecs, {len({k for k, _ in picks})} distinct signatures",
              flush=True)
        return stop(self, *a, **kw)

    pool_codec = daemon.OSDDaemon._pool_codec
    shared: dict = {}

    def shared_codec(self, pool_id, pool=None):
        if not share[0] or pool_id in self._ec_codecs:
            return pool_codec(self, pool_id, pool)
        pool = pool or self.osdmap.pools[pool_id]
        key = tuple(sorted(pool.ec_profile.items()))
        if key not in shared:
            shared[key] = pool_codec(self, pool_id, pool)
            return shared[key]
        codec = self._ec_codecs[pool_id] = shared[key]
        self._ec_device_plane(codec.device)
        return codec

    share = [0]
    daemon.OSDDaemon._pool_codec = shared_codec
    vstart.MiniCluster.kill_osd = profiled_kill
    vstart.MiniCluster.stop = counted_stop
    chip_smoke._wait_until = profiled_wait
    dev = torch.device(args.device)
    if dev.type == "cuda":
        chip_smoke.phase_device()
        chip_smoke.phase_build()
    over = {k: v for k, v in (("objects", args.objects),
                              ("object_size", args.object_size))
            if v is not None}
    base = {} if args.defaults else dict(chip_smoke.OSD_CONFIG)
    timeouts = args.op_timeout or [
        base.get("osd_op_timeout", default_config()["osd_op_timeout"])]
    failed = 0
    for r in range(args.runs):
        run_no[0] = r
        tr.reset()
        prof.clear()
        shared.clear()
        share[0] = args.share_codecs[r % len(args.share_codecs)]
        timeout = timeouts[r % len(timeouts)]
        chip_smoke.OSD_CONFIG = dict(base, osd_op_timeout=timeout)
        log(f"== run {r}, {'default config' if args.defaults else 'OSD_CONFIG'}"
            f", osd_op_timeout {timeout} s")
        try:
            _counts, res = chip_smoke.phase_osd(
                dev, np.random.default_rng(chip_smoke.SEED + r), **over)
            outcome = (f"passed, peered {res['peering_s']:.3f} s after "
                       f"the loss, faults {res['faults']}")
        except Exception as e:  # noqa: BLE001 - a run's outcome
            failed += 1
            outcome = f"FAILED {e!r:.300}"
        print(f"[trace] run {r}, {'default config, ' if args.defaults else ''}"
              f"{'shared codecs, ' if share[0] else ''}"
              f"osd_op_timeout {timeout} s: {outcome}; "
              f"queue-cap drops {dict(tr.drops)}, worker errors "
              f"{dict(tr.errors)}, {tr.expired} ops timed out, the oldest "
              f"pending op seen by a sweep {tr.oldest:.3f} s old",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
