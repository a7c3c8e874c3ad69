"""Manager daemon with a module ecosystem (mgr-lite).

The capability of the reference's ceph-mgr (src/mgr/ hosting
src/pybind/mgr/ modules: a MgrModule base with cluster-state accessors,
an enable/disable registry, per-module threads, and the module command
surface — `ceph mgr module ls/enable/disable`): a MgrDaemon attached to
the monitor hosts pluggable modules, each seeing the same state the
reference modules read (osdmap, per-osd stats, health) and able to act
through monitor commands.

Built-in modules (the reference's always-on + most-used set):
- status:     health/df digests as JSON (the `ceph status` feeder)
- prometheus: /metrics HTTP endpoint (wraps mon/exporter.py)
- dashboard:  HTTP overview — an HTML cluster page + /api/* JSON (the
              dashboard module's monitoring slice; no auth/SSL frame)
- balancer:   periodic upmap optimization when active (automatic mode)

Third-party modules register with @register_module and are enabled per
MgrDaemon — the loadable-module ecosystem seam.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_MODULES: dict[str, type] = {}


class ProgressTracker:
    """Derives operator-facing progress items from the recovery channel
    of the cluster event journal (the pybind/mgr/progress module role:
    `ceph progress` — "Recovery pg 1.3a: 40% (ETA 12s)").

    One item per recovery STORM — keyed (daemon, pg, start_ts), so a
    later wave on the same PG opens a fresh item and every item's
    percent is monotonic by construction.  recovery_start opens it,
    recovery_progress updates done/total (percent, an ops/s EWMA and
    the ETA derive from the deltas), recovery_done completes it at 100;
    completed items linger (visible in `progress ls` and the
    ``progress_percent`` gauge) for ``linger`` seconds, then drop — the
    "clears when the storm drains" contract.

    The monitor owns one instance and feeds it as stats reports land
    (under the mon lock); readers (mgr digest, exporter scrape threads)
    come from elsewhere, so state is guarded by its own lock."""

    RATE_ALPHA = 0.3  # EWMA weight of the newest ops/s sample
    KEEP_DONE = 64    # completed items retained (pre-linger-expiry cap)

    def __init__(self, linger: float = 5.0, stale_after: float = 60.0):
        self.linger = float(linger)
        # an active item whose daemon died mid-storm never sends
        # recovery_done: past this silence it is marked stale-complete
        # so it lingers and CLEARS instead of freezing sub-100 forever
        # (the reference progress module's staleness timeout)
        self.stale_after = float(stale_after)
        self._lock = threading.Lock()
        self._active: dict[tuple, dict] = {}
        self._done: list[dict] = []
        self._count = 0  # item-id sequence: one id per STORM, ever

    #: event kinds -> (verb, display label); scrub storms (the OSD's
    #: background deep-scrub cycles) ride the same machinery as
    #: recovery — one item per cycle, monotonic percent, linger+clear
    VERBS = {"recovery": "Recovery", "scrub": "Deep scrub"}

    @staticmethod
    def _key(ev: dict, verb: str) -> tuple:
        f = ev.get("fields") or {}
        return (verb, ev.get("daemon", "?"), f.get("pg", "?"),
                round(float(f.get("start_ts") or ev.get("ts") or 0), 6))

    def on_event(self, ev: dict) -> None:
        """Consume one recovery-channel journal event (other channels,
        unrecognized recovery events, and events with junk counters are
        ignored — a malformed report must never take the tracker down
        with it)."""
        try:
            self._on_event(ev)
        except (TypeError, ValueError, KeyError):
            pass

    def _on_event(self, ev: dict) -> None:
        f = ev.get("fields") or {}
        kind = str(f.get("event") or "")
        verb, _, phase = kind.partition("_")
        if verb not in self.VERBS or phase not in ("start", "progress",
                                                   "done"):
            return
        key = self._key(ev, verb)
        now = float(ev.get("ts") or time.time())
        with self._lock:
            it = self._active.get(key)
            if it is None:
                if phase == "done" or key in \
                        {i["key"] for i in self._done}:
                    # a straggling duplicate of a completed storm —
                    # never resurrect it as a 0% item
                    it = next((i for i in self._done
                               if i["key"] == key), None)
                    if it is None and phase != "done":
                        return
                if it is None:
                    self._count += 1
                    # the storm ordinal keeps ids UNIQUE across waves:
                    # a later storm on the same PG is a fresh item, and
                    # its gauge series must not splice into (and zigzag
                    # under) the finished one's
                    it = {"key": key,
                          "id": f"{verb}/{f.get('pg', '?')}/"
                                f"{ev.get('daemon', '?')}"
                                f"#{self._count}",
                          "message": f"{self.VERBS[verb]} "
                                     f"pg {f.get('pg', '?')} "
                                     f"({ev.get('daemon', '?')})",
                          "started": now, "updated": now,
                          "done": 0, "total": 0, "percent": 0.0,
                          "rate_eps": 0.0, "eta_seconds": None,
                          "completed": None}
                    self._active[key] = it
            done = int(f.get("done", it["done"]))
            total = int(f.get("total", it["total"]))
            # journal delivery is at-least-once orderly per daemon, but
            # belt-and-braces: progress never walks backwards
            it["total"] = max(it["total"], total)
            if done > it["done"]:
                dt = max(now - it["updated"], 1e-6)
                inst = (done - it["done"]) / dt
                a = self.RATE_ALPHA
                it["rate_eps"] = (a * inst + (1 - a) * it["rate_eps"]
                                  if it["rate_eps"] else inst)
                it["done"] = done
            it["updated"] = now
            if it["total"]:
                it["percent"] = max(
                    it["percent"],
                    round(100.0 * it["done"] / it["total"], 1))
            remaining = it["total"] - it["done"]
            it["eta_seconds"] = (round(remaining / it["rate_eps"], 1)
                                 if it["rate_eps"] > 0 and remaining > 0
                                 else (0.0 if not remaining else None))
            if phase == "done" and it["completed"] is None:
                it["percent"] = 100.0
                it["eta_seconds"] = 0.0
                it["completed"] = time.time()
                self._active.pop(key, None)
                self._done.append(it)
                del self._done[: max(0,
                                     len(self._done) - self.KEEP_DONE)]

    def _gc_locked(self, now: float) -> None:
        for key, it in list(self._active.items()):
            if now - it["updated"] > self.stale_after:
                it["completed"] = now
                it["stale"] = True
                it["eta_seconds"] = None
                self._active.pop(key, None)
                self._done.append(it)
        del self._done[: max(0, len(self._done) - self.KEEP_DONE)]
        self._done = [i for i in self._done
                      if now - i["completed"] <= self.linger]

    @staticmethod
    def _public(it: dict) -> dict:
        return {k: v for k, v in it.items() if k != "key"}

    def active(self) -> list[dict]:
        # GC here too: the mon `status` verb serves this directly, and
        # without the sweep a daemon that died mid-storm would show a
        # frozen sub-100 item in status forever (nothing else may be
        # polling items()/percent_gauges() to trigger it)
        now = time.time()
        with self._lock:
            self._gc_locked(now)
            return [self._public(i) for i in self._active.values()]

    def items(self) -> list[dict]:
        """Active items plus completed ones still inside the linger
        window (the `progress ls` document)."""
        now = time.time()
        with self._lock:
            self._gc_locked(now)
            return ([self._public(i) for i in self._active.values()]
                    + [self._public(i) for i in self._done])

    def ls(self) -> dict:
        """The active/completed split BOTH verb surfaces serve (the mon
        `progress` command and the mgr progress module)."""
        items = self.items()
        return {"active": [i for i in items if i["completed"] is None],
                "completed": [i for i in items
                              if i["completed"] is not None]}

    def percent_gauges(self) -> dict[str, float]:
        """item id -> percent for the exporter's ``progress_percent``
        gauge: active + lingering-completed items; an item past its
        linger stops being exported — the gauge CLEARS."""
        now = time.time()
        with self._lock:
            self._gc_locked(now)
            out = {}
            for i in list(self._active.values()) + self._done:
                out[i["id"]] = i["percent"]
            return out


def register_module(name: str):
    def deco(cls):
        cls.NAME = name
        _MODULES[name] = cls
        return cls
    return deco


def registered_modules() -> list[str]:
    return sorted(_MODULES)


class MgrModule:
    """Base class (src/mgr/MgrModule shape): cluster-state accessors +
    lifecycle hooks.  Modules run their own threads in serve() or do
    periodic work in tick()."""

    NAME = "base"
    TICK_EVERY = 5.0

    def __init__(self, mgr: "MgrDaemon"):
        self.mgr = mgr

    # -- state accessors (the MgrModule.get("...") surface) -----------
    def get_osdmap(self):
        return self.mgr.mon.osdmap

    def osd_states(self) -> list[tuple]:
        """[(id, up, in, host)] snapshotted under the mon lock — the
        dispatch thread inserts into osdmap.osds concurrently, and
        iterating it bare can blow up mid-scrape (same invariant the
        exporter documents)."""
        mon = self.mgr.mon
        with mon._lock:
            return [(i, o.up, o.in_cluster, getattr(o, "host", ""))
                    for i, o in sorted(mon.osdmap.osds.items())]

    def pool_states(self) -> list[tuple]:
        mon = self.mgr.mon
        with mon._lock:
            return [(pid, p.name, p.kind, p.pg_num, p.size)
                    for pid, p in sorted(mon.osdmap.pools.items())]

    def get_osd_stats(self) -> dict:
        with self.mgr.mon._lock:
            return {i: dict(s)
                    for i, s in self.mgr.mon._osd_stats.items()}

    def mon_command(self, cmd: dict):
        with self.mgr.mon._lock:
            result, data = self.mgr.mon._run_command(cmd)
        if result != 0:
            raise RuntimeError(f"mon command {cmd.get('prefix')!r} "
                               f"failed: {result} {data}")
        return data

    # -- lifecycle -----------------------------------------------------
    def serve(self) -> None:  # long-running setup (threads etc.)
        pass

    def shutdown(self) -> None:
        pass

    def tick(self) -> None:  # periodic work on the mgr tick thread
        pass

    def command(self, cmd: str, **kw):
        raise KeyError(f"module {self.NAME}: unknown command {cmd!r}")


@register_module("status")
class StatusModule(MgrModule):
    def command(self, cmd: str, **kw):
        if cmd == "status":
            return self.digest()
        raise KeyError(cmd)

    def digest(self) -> dict:
        osds = self.osd_states()
        stats = self.get_osd_stats()
        used = sum(int(s.get("bytes_used", 0)) for s in stats.values())
        with self.mgr.mon._lock:
            epoch = self.mgr.mon.osdmap.epoch
            pools = len(self.mgr.mon.osdmap.pools)
            # same health mux `ceph status` serves: OSD_DOWN + SLOW_OPS
            checks = self.mgr.mon._health_checks(
                self.mgr.mon.osdmap.up_osds())
        progress = getattr(self.mgr.mon, "progress", None)
        return {
            "epoch": epoch,
            "osds": {"total": len(osds),
                     "up": sum(1 for _i, up, _in, _h in osds if up),
                     "in": sum(1 for _i, _up, in_, _h in osds
                               if in_)},
            "pools": pools,
            "bytes_used": used,
            "health": "HEALTH_WARN" if checks else "HEALTH_OK",
            "checks": checks,
            # the progress module's face in `ceph status` (the
            # "progress:" block): derived recovery items, percent+ETA
            "progress": (progress.items() if progress is not None
                         else []),
        }


@register_module("prometheus")
class PrometheusModule(MgrModule):
    """Wraps the exporter: the mgr owns the /metrics endpoint like the
    reference's prometheus module does."""

    def __init__(self, mgr):
        super().__init__(mgr)
        self._exporter = None

    def serve(self) -> None:
        from .exporter import MetricsExporter
        self._exporter = MetricsExporter(mon=self.mgr.mon, port=0)
        self.port = self._exporter.port

    def shutdown(self) -> None:
        if self._exporter is not None:
            self._exporter.stop()


@register_module("progress")
class ProgressModule(MgrModule):
    """Surface the monitor's ProgressTracker (the pybind/mgr/progress
    command face): the derivation itself runs on the mon as recovery
    journal events land — this module is the operator verb surface."""

    def command(self, cmd: str, **kw):
        tracker = getattr(self.mgr.mon, "progress", None)
        if tracker is None:
            return {"active": [], "completed": []}
        if cmd in ("ls", "status"):
            return tracker.ls()
        raise KeyError(cmd)


@register_module("metrics")
class MetricsModule(MgrModule):
    """The metrics-history verb surface (the in-cluster TSDB face of
    the mgr): ``history`` dumps the monitor's merged snapshot rings,
    ``query`` answers delta/rate/quantile questions over arbitrary
    retrospective windows, ``staleness`` reports per-daemon sample
    age.  The store itself lives monitor-side (merged from the stats
    reports) — this module is the operator face, like progress."""

    def command(self, cmd: str, **kw):
        store = getattr(self.mgr.mon, "metrics_history", None)
        if store is None:
            return {"registries": {}, "keep": 0}
        if cmd == "history":
            return store.dump(registry=kw.get("registry"),
                              max_samples=int(kw.get("max", 0) or 0))
        if cmd == "query":
            return store.query(kw["registry"], kw["counter"],
                               since_s=float(kw.get("since_s", 60.0)),
                               until_s=float(kw.get("until_s", 0.0)))
        if cmd == "staleness":
            return store.staleness()
        raise KeyError(cmd)


@register_module("perf_query")
class PerfQueryModule(MgrModule):
    """Operator face of the dynamic perf-query subsystem: queries
    themselves are OSDMap state (mon ``perf query add/rm/ls``) and the
    per-daemon partials merge monitor-side into the PerfQueryStore as
    stats reports land — this module is the read surface ``top_tool``
    polls (``report``), like the metrics module is for the history
    store."""

    def command(self, cmd: str, **kw):
        mon = self.mgr.mon
        store = getattr(mon, "perf_queries", None)
        if store is None:
            return {"queries": {}, "reporting": []}
        if cmd == "ls":
            with mon._lock:
                queries = {str(q): dict(spec) for q, spec in sorted(
                    getattr(mon.osdmap, "perf_queries", {}).items())}
            return {"queries": queries, "reporting": store.daemons()}
        if cmd == "report":
            qid = int(kw["qid"])
            with mon._lock:
                if qid not in getattr(mon.osdmap, "perf_queries", {}):
                    raise KeyError(f"no perf query {qid}")
            return store.report(qid, sort=kw.get("sort", "ops"),
                                limit=int(kw.get("limit", 0) or 0))
        raise KeyError(cmd)


@register_module("qos")
class QosModule(MgrModule):
    """The adaptive recovery-reservation controller's host (the
    mclock-profiles role closed into a feedback loop): each tick it
    senses the cluster — worst client p99 ``mclock_qwait_us_client``
    across daemons over a ``metrics_query`` window, recovery backlog
    from the freshest ``mclock_depth_recovery`` snapshots, storm
    liveness from the progress tracker — feeds the pure AIMD
    controller (qos/controller.py), and applies any retune through a
    bound actuator (config set + ``reset_mclock`` on every OSD),
    journaling a ``qos`` cluster event per move.

    Config-gated on ``qos_controller=on``; inert until ``bind()``
    hands it an apply function (the harness/bench wires one over the
    cluster's admin sockets)."""

    TICK_EVERY = 1.0

    def __init__(self, mgr):
        super().__init__(mgr)
        self._ctl = None
        self._apply = None

    def bind(self, apply_fn, res0: float | None = None) -> "QosModule":
        """apply_fn(res, lim) pushes the setting at every OSD (the
        `config set osd_mclock_recovery_{res,lim}` + `reset_mclock`
        round).  res0 seeds the controller at the currently-configured
        reservation."""
        self._apply = apply_fn
        self._ctl = self._make_controller(res0)
        return self

    def _make_controller(self, res0):
        from ..qos.controller import (ControllerKnobs,
                                      ReservationController)
        cfg = self.mgr.mon.cfg
        knobs = ControllerKnobs(
            res_min=cfg["qos_recovery_res_min"],
            res_max=cfg["qos_recovery_res_max"],
            step=cfg["qos_controller_step"],
            backoff=cfg["qos_controller_backoff"],
            p99_low_us=cfg["qos_controller_p99_low_ms"] * 1e3,
            p99_high_us=cfg["qos_controller_p99_high_ms"] * 1e3,
            hold=cfg["qos_controller_hold_ticks"],
            cooldown=cfg["qos_controller_cooldown_ticks"],
            lim_factor=cfg["qos_recovery_lim_factor"],
            burn_high=cfg["qos_controller_burn_high"],
            burn_low=cfg["qos_controller_burn_low"])
        return ReservationController(knobs, res0=res0)

    # ------------------------------------------------------------ sensing
    def _client_p99_us(self) -> float | None:
        store = getattr(self.mgr.mon, "metrics_history", None)
        if store is None:
            return None
        window = self.mgr.mon.cfg["qos_controller_window_s"]
        worst = None
        for reg in store.registries():
            if not reg.startswith("osd."):
                continue
            q = store.query(reg, "mclock_qwait_us_client",
                            since_s=window)
            p99 = q.get("p99")
            if p99 is not None and (worst is None or p99 > worst):
                worst = float(p99)
        return worst

    def _recovery_state(self) -> tuple[int, bool]:
        """(queued recovery items cluster-wide, storm live?) from the
        freshest metrics snapshots + the progress tracker."""
        backlog = 0
        store = getattr(self.mgr.mon, "metrics_history", None)
        if store is not None:
            # staleness fence: a dead OSD's final snapshot can carry a
            # nonzero depth forever — a phantom backlog no reservation
            # can drain must not walk the knob to its ceiling
            max_age = max(5.0,
                          2 * self.mgr.mon.cfg[
                              "qos_controller_window_s"])
            now = time.time()
            for reg in store.registries():
                if not reg.startswith("osd."):
                    continue
                # window(max_age) copies only the fresh tail (not the
                # whole 600-snapshot ring per tick); the explicit ts
                # check below also rejects the window's BASELINE edge
                # sample, which may predate the window — a dead OSD's
                # final nonzero depth must age out, not pin a phantom
                # backlog that walks the knob to its ceiling
                rows = store.window(reg, since_s=max_age)
                if not rows or now - float(rows[-1].get("ts", 0)) \
                        > max_age:
                    continue
                counters = rows[-1].get("counters") or {}
                backlog += int(counters.get("mclock_depth_recovery",
                                            0) or 0)
        progress = getattr(self.mgr.mon, "progress", None)
        active = bool(progress.active()) if progress is not None \
            else False
        return backlog, active

    def _slo_burn_fast(self) -> float | None:
        """Worst fast-window SLO burn across configured objectives —
        the ``qos_controller_sense=slo`` signal.  Prefers the slo
        module's last evaluation (same tick cadence, already paid
        for); falls back to evaluating directly when that module is
        not enabled.  None until real observations exist, which
        ``observe_burn`` treats like quiet."""
        results = None
        slo = self.mgr._modules.get("slo")
        if slo is not None and getattr(slo, "last", None):
            results = slo.last
        else:
            store = getattr(self.mgr.mon, "metrics_history", None)
            cfg = self.mgr.mon.cfg
            if store is None:
                return None
            from ..slo.objectives import (evaluate_objective,
                                          parse_objectives)
            try:
                objs = parse_objectives(str(cfg["slo_objectives"]))
            except ValueError:
                return None
            results = [evaluate_objective(o, store,
                                          cfg["slo_fast_window_s"],
                                          cfg["slo_slow_window_s"])
                       for o in objs]
        worst = None
        for r in results or []:
            if r["fast"]["observations"] <= 0:
                continue
            b = float(r["fast"]["burn"])
            if worst is None or b > worst:
                worst = b
        return worst

    # ----------------------------------------------------------- the loop
    def tick(self) -> None:
        cfg = self.mgr.mon.cfg
        if cfg["qos_controller"] != "on" or self._apply is None:
            return
        if self._ctl is None:
            self._ctl = self._make_controller(None)
        p99 = self._client_p99_us()
        backlog, active = self._recovery_state()
        if cfg["qos_controller_sense"] == "slo":
            burn = self._slo_burn_fast()
            move = self._ctl.observe_burn(burn, backlog, active,
                                          p99_us=p99)
        else:
            move = self._ctl.observe(p99, backlog, active)
        if move is None:
            return
        res, lim = move
        self._apply(res, lim)
        last = self._ctl.history[-1]
        from ..utils.event_log import make_event
        mon = self.mgr.mon
        mon.cluster_log.append(make_event(
            mon.name, "qos",
            f"recovery reservation {last.reason} -> "
            f"{res:g}/{lim:g} ops/s",
            reason=last.reason, res=float(res), lim=float(lim),
            p99_us=float(p99) if p99 is not None else -1.0,
            backlog=int(backlog),
            **({"burn": float(last.burn)}
               if last.burn is not None else {})))

    def command(self, cmd: str, **kw):
        if cmd == "status":
            return {"enabled":
                    self.mgr.mon.cfg["qos_controller"] == "on",
                    "sense": self.mgr.mon.cfg["qos_controller_sense"],
                    "bound": self._apply is not None,
                    "controller": (self._ctl.status()
                                   if self._ctl is not None else None)}
        raise KeyError(cmd)


@register_module("slo")
class SloModule(MgrModule):
    """SLO burn-rate health (the slo/objectives.py host): each tick,
    evaluate every configured latency objective over a fast AND a slow
    ``metrics_query`` window (Google-SRE multiwindow: the slow window
    proves the burn is not a blip, the fast window proves it is still
    happening) and drive the ``SLO_BURN`` check through the monitor's
    health mux.  The check detail carries the worst offending bucket's
    exemplar trace_ids, so the alert itself is the entry point into
    ``trace_tool --exemplar``; raise/clear transitions journal to the
    cluster log's ``slo`` channel (the health mux additionally
    journals the HEALTH transition itself).

    Inert while ``slo_objectives`` is empty.  A malformed objective
    string journals ONCE per distinct value and disables evaluation
    until the config changes — a config typo must not take the mgr
    tick thread down or flap the log."""

    TICK_EVERY = 1.0

    def __init__(self, mgr):
        super().__init__(mgr)
        self._alerting: dict[str, dict] = {}  # objective -> last eval
        self._spec: str | None = None         # last parsed config value
        self._objs: list = []
        self.last: list | None = None

    def _objectives(self) -> list:
        spec = str(self.mgr.mon.cfg["slo_objectives"])
        if spec == self._spec:
            return self._objs
        from ..slo.objectives import parse_objectives
        self._spec = spec
        try:
            self._objs = parse_objectives(spec)
        except ValueError as e:
            self._objs = []
            self._journal(f"slo_objectives rejected: {e}",
                          severity="warn", error=str(e))
        return self._objs

    def _journal(self, message: str, severity: str = "info",
                 **fields) -> None:
        from ..utils.event_log import make_event
        mon = self.mgr.mon
        mon.cluster_log.append(make_event(
            mon.name, "slo", message, severity, **fields))

    def tick(self) -> None:
        mon = self.mgr.mon
        objs = self._objectives()
        store = getattr(mon, "metrics_history", None)
        if not objs or store is None:
            if self._alerting:
                for name in sorted(self._alerting):
                    self._journal(f"SLO_BURN cleared: {name} "
                                  "(objectives removed)", check=name)
                self._alerting = {}
            mon.set_health_check("SLO_BURN", None)
            return
        from ..slo.objectives import evaluate_objective
        cfg = mon.cfg
        fast_s = cfg["slo_fast_window_s"]
        slow_s = cfg["slo_slow_window_s"]
        thr = cfg["slo_burn_threshold"]
        results = [evaluate_objective(o, store, fast_s, slow_s)
                   for o in objs]
        self.last = results
        # both windows must burn over threshold, on real observations
        # (an empty window burns nothing — a quiet cluster is healthy)
        cur = {r["objective"]: r for r in results
               if r["fast"]["observations"] > 0
               and r["slow"]["observations"] > 0
               and r["fast"]["burn"] >= thr
               and r["slow"]["burn"] >= thr}
        for name in sorted(set(cur) - set(self._alerting)):
            r = cur[name]
            tids = [e["trace_id"] for e in r.get("exemplars") or []]
            self._journal(
                f"SLO_BURN raised: {name} burning "
                f"{r['fast']['burn']:g}x fast / "
                f"{r['slow']['burn']:g}x slow", severity="warn",
                check=name, burn_fast=float(r["fast"]["burn"]),
                burn_slow=float(r["slow"]["burn"]),
                exemplar_trace_ids=",".join(str(t) for t in tids),
                **({"worst_series": str(r["worst_series"])}
                   if r.get("worst_series") else {}))
        for name in sorted(set(self._alerting) - set(cur)):
            self._journal(f"SLO_BURN cleared: {name}", check=name)
        self._alerting = cur
        if not cur:
            mon.set_health_check("SLO_BURN", None)
            return
        detail = []
        for name, r in sorted(cur.items()):
            line = (f"{name}: burn {r['fast']['burn']:g}x over "
                    f"{fast_s:g}s / {r['slow']['burn']:g}x over "
                    f"{slow_s:g}s "
                    f"({r['fast']['observations']} obs)")
            if r.get("worst_series"):
                # wildcard objective: the alert names the tenant
                # series actually burning, not just the pattern
                line += f"; worst series: {r['worst_series']}"
            tids = [str(e["trace_id"])
                    for e in r.get("exemplars") or []]
            if tids:
                line += f"; exemplar traces: {', '.join(tids)}"
            detail.append(line)
        mon.set_health_check("SLO_BURN", {
            "severity": "HEALTH_WARN",
            "summary": (f"{len(cur)} SLO objective(s) burning error "
                        f"budget >= {thr:g}x in both windows"),
            "detail": detail})

    def command(self, cmd: str, **kw):
        if cmd == "status":
            return {"objectives": [o.name for o in self._objectives()],
                    "alerting": sorted(self._alerting),
                    "fast_window_s":
                        self.mgr.mon.cfg["slo_fast_window_s"],
                    "slow_window_s":
                        self.mgr.mon.cfg["slo_slow_window_s"],
                    "burn_threshold":
                        self.mgr.mon.cfg["slo_burn_threshold"],
                    "last": self.last}
        raise KeyError(cmd)


@register_module("balancer")
class BalancerModule(MgrModule):
    """Automatic upmap balancing (pybind/mgr/balancer role): when
    active, each tick runs one bounded optimize pass through the
    monitor's balancer verb."""

    TICK_EVERY = 10.0

    def __init__(self, mgr):
        super().__init__(mgr)
        self.active = False
        self.last: dict | None = None

    def command(self, cmd: str, **kw):
        if cmd == "on":
            self.active = True
            return {"active": True}
        if cmd == "off":
            self.active = False
            return {"active": False}
        if cmd == "status":
            return {"active": self.active, "last": self.last}
        if cmd == "optimize":
            return self._optimize(int(kw.get("max_moves", 10)))
        raise KeyError(cmd)

    def _optimize(self, max_moves: int = 10):
        with self.mgr.mon._lock:
            result, data = self.mgr.mon._run_command(
                {"prefix": "balancer optimize",
                 "max_moves": max_moves})
        self.last = data if result == 0 else {"error": data}
        return self.last

    def tick(self) -> None:
        if self.active:
            self._optimize()


@register_module("pg_autoscaler")
class PgAutoscalerModule(MgrModule):
    """pg_autoscaler role (src/pybind/mgr/pg_autoscaler/): watch
    per-pool object counts from the OSD stats reports and grow a
    pool's pg_num when it outgrows its placement granularity.  The
    proposal is the smallest power-of-two multiple of the current
    pg_num that brings logical objects-per-PG back under the target;
    `status` lists proposals, `on` applies them each tick through the
    `osd pool set-pg-num` split verb."""

    TICK_EVERY = 5.0

    def __init__(self, mgr):
        super().__init__(mgr)
        self.active = False
        cfg = mgr.mon.cfg
        self.target = int(cfg["mgr_autoscaler_objects_per_pg"])
        self.max_pg_num = int(cfg["mgr_autoscaler_max_pg_num"])
        self.last: list | None = None

    def _proposals(self) -> list[dict]:
        per_pool: dict[int, int] = {}
        for s in self.get_osd_stats().values():
            for pid, n in (s.get("pool_objects") or {}).items():
                pid = int(pid)
                per_pool[pid] = per_pool.get(pid, 0) + int(n)
        out = []
        for pool_id, pool in sorted(self.get_osdmap().pools.items()):
            # raw counts tally every replica/EC shard/clone: normalize
            # by pool width for a logical-object estimate
            logical = per_pool.get(pool_id, 0) / max(pool.size, 1)
            per_pg = logical / max(pool.pg_num, 1)
            if per_pg <= self.target:
                continue
            new = pool.pg_num
            # the cap is checked on the NEXT doubling, so a proposal
            # can never exceed max_pg_num
            while new * 2 <= self.max_pg_num \
                    and logical / new > self.target:
                new *= 2
            if new == pool.pg_num:
                continue  # already at (or doubling would pass) the cap
            out.append({"pool": pool.name, "pg_num": pool.pg_num,
                        "proposed": new,
                        "objects_per_pg": round(per_pg, 1),
                        "target": self.target})
        return out

    def command(self, cmd: str, **kw):
        if cmd == "on":
            self.active = True
            return {"active": True}
        if cmd == "off":
            self.active = False
            return {"active": False}
        if cmd == "status":
            return {"active": self.active,
                    "proposals": self._proposals(), "last": self.last}
        raise KeyError(cmd)

    def tick(self) -> None:
        if not self.active:
            return
        applied = []
        for p in self._proposals():
            reply = self.mon_command({"prefix": "osd pool set-pg-num",
                                      "pool": p["pool"],
                                      "pg_num": p["proposed"]})
            applied.append({**p, "result": reply})
        if applied:
            self.last = applied


@register_module("dashboard")
class DashboardModule(MgrModule):
    """HTTP overview (pybind/mgr/dashboard monitoring slice): an HTML
    cluster page plus /api/status, /api/osds, /api/pools JSON."""

    def serve(self) -> None:
        mgr = self.mgr  # noqa: F841 - closure for future handlers
        module = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                try:
                    if self.path == "/api/status":
                        self._json(StatusModule.digest(module))
                    elif self.path == "/api/osds":
                        stats = module.get_osd_stats()
                        self._json([
                            {"id": i, "up": up, "in": in_,
                             "host": host,
                             **{k: v for k, v in
                                stats.get(i, {}).items()}}
                            for i, up, in_, host
                            in module.osd_states()])
                    elif self.path == "/api/pools":
                        self._json([
                            {"id": pid, "name": name,
                             "kind": kind, "pg_num": pg_num,
                             "size": size}
                            for pid, name, kind, pg_num, size
                            in module.pool_states()])
                    elif self.path in ("/", "/index.html"):
                        d = StatusModule.digest(module)
                        rows = "".join(
                            f"<tr><td>osd.{i}</td>"
                            f"<td>{'up' if up else 'down'}</td>"
                            f"<td>{'in' if in_ else 'out'}"
                            f"</td></tr>"
                            for i, up, in_, _h in module.osd_states())
                        html = (
                            "<html><head><title>ceph_tpu dashboard"
                            "</title></head><body>"
                            f"<h1>{d['health']}</h1>"
                            f"<p>epoch {d['epoch']} — "
                            f"{d['osds']['up']}/{d['osds']['total']} "
                            f"osds up, {d['pools']} pools, "
                            f"{d['bytes_used']} bytes used</p>"
                            f"<table border=1><tr><th>osd</th>"
                            f"<th>state</th><th>membership</th></tr>"
                            f"{rows}</table>"
                            "<p><a href=/api/status>/api/status</a> "
                            "<a href=/api/osds>/api/osds</a> "
                            "<a href=/api/pools>/api/pools</a></p>"
                            "</body></html>").encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "text/html")
                        self.send_header("Content-Length",
                                         str(len(html)))
                        self.end_headers()
                        self.wfile.write(html)
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as e:  # noqa: BLE001
                    self._json({"error": repr(e)}, 500)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="mgr-dashboard", daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        if getattr(self, "_server", None) is not None:
            self._server.shutdown()
            self._server.server_close()


@register_module("nfs")
class NfsModule(MgrModule):
    """NFS export management (the pybind/mgr/nfs role): the reference's
    NFS support is ORCHESTRATION — it stores ganesha-format export
    configurations in RADOS for the ganesha daemons to consume and
    reload (src/pybind/mgr/nfs/export.py), it does not speak the NFS
    protocol itself.  Same here: exports live in the omap of a
    conf-<cluster> object in the named pool; create/delete/list mirror
    the `ceph nfs export ...` verbs; apply() renders the ganesha
    EXPORT block a gateway would ingest."""

    def __init__(self, mgr):
        super().__init__(mgr)
        self.client = None  # bound via bind(); needs a rados client
        self.pool = None
        self.cluster_id = "a"

    def bind(self, client, pool: str,
             cluster_id: str = "a") -> "NfsModule":
        self.client = client
        self.pool = pool
        self.cluster_id = cluster_id
        return self

    @property
    def _oid(self) -> str:
        return f"conf-nfs.{self.cluster_id}"

    def _exports(self) -> dict:
        from ..msg.wire import unpack_value
        try:
            omap = self.client.omap_get(self.pool, self._oid)
        except Exception:  # noqa: BLE001 - no exports yet
            return {}
        return {k: unpack_value(bytes(v)) for k, v in omap.items()}

    def command(self, cmd: str, **kw):
        if cmd == "export create":
            return self.export_create(**kw)
        if cmd == "export rm":
            return self.export_rm(kw["pseudo"])
        if cmd == "export ls":
            return sorted(self._exports())
        if cmd == "export get":
            return self._exports()[kw["pseudo"]]
        if cmd == "conf":
            return self.render_conf()
        raise KeyError(cmd)

    def export_create(self, pseudo: str, path: str = "/",
                      fs_pool: str | None = None,
                      access: str = "RW", squash: str = "none",
                      **_kw) -> dict:
        from ..msg.wire import pack_value
        if not pseudo.startswith("/"):
            raise ValueError("pseudo path must be absolute")
        exports = self._exports()
        export_id = 1 + max((e["export_id"]
                             for e in exports.values()), default=0)
        rec = {"export_id": export_id, "pseudo": pseudo,
               "path": path, "pool": fs_pool or self.pool,
               "access_type": access, "squash": squash,
               "protocols": [4], "transports": ["TCP"]}
        self.client.omap_set(self.pool, self._oid,
                             {pseudo: pack_value(rec)})
        return rec

    def export_rm(self, pseudo: str) -> None:
        if pseudo not in self._exports():
            raise KeyError(pseudo)
        self.client.omap_rm(self.pool, self._oid, [pseudo])

    def render_conf(self) -> str:
        """The ganesha config body a gateway ingests (EXPORT blocks —
        export.py's GaneshaConfParser format, the consumable
        artifact)."""
        blocks = []
        for pseudo, e in sorted(self._exports().items()):
            blocks.append(
                "EXPORT {\n"
                f"    Export_Id = {e['export_id']};\n"
                f"    Path = \"{e['path']}\";\n"
                f"    Pseudo = \"{pseudo}\";\n"
                f"    Access_Type = {e['access_type']};\n"
                f"    Squash = {e['squash']};\n"
                f"    Protocols = "
                f"{', '.join(map(str, e['protocols']))};\n"
                f"    Transports = {', '.join(e['transports'])};\n"
                "    FSAL { Name = CEPH; "
                f"Filesystem = \"{e['pool']}\"; }}\n"
                "}")
        return "\n".join(blocks)


class MgrDaemon:
    """Hosts enabled modules against a monitor (ceph-mgr role)."""

    def __init__(self, mon, modules=("status", "balancer"),
                 tick: float = 1.0):
        self.mon = mon
        self._modules: dict[str, MgrModule] = {}
        self._tick = tick
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_tick: dict[str, float] = {}
        for name in modules:
            self.enable(name)

    # -- module registry (mgr module ls/enable/disable) ---------------
    def module(self, name: str) -> MgrModule:
        return self._modules[name]

    def enabled(self) -> list[str]:
        return sorted(self._modules)

    def enable(self, name: str) -> MgrModule:
        if name in self._modules:
            return self._modules[name]
        cls = _MODULES.get(name)
        if cls is None:
            raise KeyError(f"no such mgr module {name!r} "
                           f"(have {registered_modules()})")
        mod = cls(self)
        mod.serve()
        self._modules[name] = mod
        return mod

    def disable(self, name: str) -> None:
        mod = self._modules.pop(name, None)
        if mod is not None:
            mod.shutdown()

    def command(self, module: str, cmd: str, **kw):
        """`ceph mgr <module> <cmd>` dispatch."""
        if module == "mgr" and cmd == "module ls":
            return {"enabled": self.enabled(),
                    "available": registered_modules()}
        return self.module(module).command(cmd, **kw)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "MgrDaemon":
        self._thread = threading.Thread(target=self._run,
                                        name="mgr-tick", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._tick):
            now = time.time()
            for name, mod in list(self._modules.items()):
                if now - self._last_tick.get(name, 0) >= mod.TICK_EVERY:
                    self._last_tick[name] = now
                    try:
                        mod.tick()
                    except Exception:  # noqa: BLE001 - module isolation
                        from ..utils.log import dout
                        dout("mgr", 0)("module %s tick failed", name)

    def stop(self) -> None:
        self._stop.set()
        for name in list(self._modules):
            self.disable(name)
