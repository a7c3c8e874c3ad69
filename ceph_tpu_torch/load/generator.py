"""Multi-process load generator: spawn, rendezvous, merge.

The parent half of the harness (load_worker.py is the child): spawns N
worker processes against a cluster's mon TCP address, rendezvouses them
onto one shared start instant, exposes the resulting ABSOLUTE leg
schedule (so a scenario can thrash the cluster at a known offset into a
leg), and merges every worker's per-leg histograms into one
``LegResult`` per leg.

Reuses the test_multiprocess_dcn.py plumbing decisions: children get
the repo on PYTHONPATH and no CUDA device (``CUDA_VISIBLE_DEVICES`` is
empty, so a worker, a TCP client, never opens the card the cluster's
process owns), one failed worker never orphans the rest, and results
ride the last stdout line as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import ceph_tpu_torch

from .profiles import LegResult, LegSpec

#: how long the reap of a worker killed at its deadline may take
REAP_DEADLINE_S = 10.0

REPO = os.path.dirname(os.path.dirname(os.path.abspath(
    ceph_tpu_torch.__file__)))


class LoadGenerator:
    """Drive ``legs`` from ``procs`` worker processes at once.

    Per-worker leg specs are the CLUSTER-level spec split evenly:
    open-loop rates divide by the worker count, closed-loop concurrency
    divides (rounded up) — so the caller reasons in cluster totals."""

    READY_TIMEOUT = 60.0

    def __init__(self, mon_addr: str, pool: str, objects: int,
                 legs: list[LegSpec], procs: int = 2, seed: int = 0,
                 client_timeout: float = 15.0,
                 tenant: str | None = None,
                 tenants: list | None = None,
                 frontend: str = "rados"):
        self.mon_addr = mon_addr
        self.pool = pool
        self.objects = int(objects)
        self.legs = list(legs)
        self.procs = max(1, int(procs))
        self.seed = int(seed)
        self.client_timeout = float(client_timeout)
        # QoS identity: every simulated client of this generator
        # stamps its ops with a tenant's dmclock tags — one name for
        # the whole stream, or a list assigned round-robin per client
        # (competing tenants inside ONE worker process)
        self.tenant = tenant
        self.tenants = list(tenants) if tenants else None
        # "rados" drives librados directly; "rgw" drives the
        # RgwGateway PUT/GET object path (the S3 front-end leg) —
        # same legs, histograms and invariants either way
        self.frontend = frontend
        self.start_at: float | None = None
        self.procs_alive: list[subprocess.Popen] = []

    def _worker_legs(self) -> list[dict]:
        out = []
        for leg in self.legs:
            out.append(LegSpec(
                name=leg.name, profile=leg.profile,
                duration_s=leg.duration_s, mode=leg.mode,
                rate=leg.rate / self.procs,
                concurrency=max(1, -(-leg.concurrency // self.procs)),
            ).to_dict())
        return out

    def leg_times(self) -> dict[str, tuple[float, float]]:
        """leg name -> (abs start, abs end); valid once launched."""
        assert self.start_at is not None, "launch() first"
        out, t = {}, self.start_at
        for leg in self.legs:
            out[leg.name] = (t, t + leg.duration_s)
            t += leg.duration_s
        return out

    # -------------------------------------------------------- lifecycle
    def launch(self) -> None:
        """Spawn workers, wait for every ready line, send the shared
        go timestamp.  Returns once the start instant is agreed."""
        self.spawn()
        self.go()

    def spawn(self) -> None:
        """Spawn workers and wait for every ready line — WITHOUT
        sending go.  Callers coordinating several generators (one per
        tenant stream) spawn them all first, then go() them onto one
        shared start instant so their leg clocks align."""
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH",
                                                        "")
        # no card in the workers, set before the child starts: any
        # torch import there, even one ahead of the worker's own code,
        # then sees no device
        env["CUDA_VISIBLE_DEVICES"] = ""
        spec = {"pool": self.pool, "objects": self.objects,
                "legs": self._worker_legs(), "seed": self.seed,
                "client_timeout": self.client_timeout,
                "tenant": self.tenant or "",
                "tenants": self.tenants or [],
                "frontend": self.frontend}
        self.procs_alive = [
            subprocess.Popen(
                [sys.executable, "-m", "ceph_tpu_torch.load.load_worker",
                 "--mon-addr", self.mon_addr,
                 "--worker-id", str(i), "--spec", json.dumps(spec)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
            for i in range(self.procs)
        ]
        self._stdout_lines: list[list[str]] = [
            [] for _ in self.procs_alive]
        # stderr is drained CONTINUOUSLY too: a chatty worker filling
        # the ~64KiB pipe buffer mid-run would block on the write and
        # be misreported as a deadlock-invariant trip
        self._stderr_tails: list[str] = ["" for _ in self.procs_alive]
        self._readers = []
        for i, proc in enumerate(self.procs_alive):
            t = threading.Thread(target=self._drain_stdout,
                                 args=(i, proc), daemon=True)
            t.start()
            e = threading.Thread(target=self._drain_stderr,
                                 args=(i, proc), daemon=True)
            e.start()
            self._readers.extend((t, e))
        deadline = time.time() + self.READY_TIMEOUT
        for i, proc in enumerate(self.procs_alive):
            while True:
                lines = self._stdout_lines[i]
                if lines:
                    first = json.loads(lines[0])
                    if not first.get("ready"):
                        self.abort()
                        raise RuntimeError(
                            f"worker {i} failed before ready: {first}")
                    break
                if proc.poll() is not None or time.time() > deadline:
                    err = self._stderr_tails[i]
                    self.abort()
                    raise RuntimeError(
                        f"worker {i} never became ready "
                        f"(rc={proc.returncode}): {err[-2000:]}")
                time.sleep(0.02)

    def go(self, start_at: float | None = None) -> None:
        """Send the shared go timestamp to every (ready) worker."""
        self.start_at = start_at if start_at is not None \
            else time.time() + 0.5
        go = json.dumps({"go": self.start_at}) + "\n"
        try:
            for proc in self.procs_alive:
                proc.stdin.write(go)
                proc.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            # a worker dying between ready and go must not leak the
            # rest blocked on stdin.readline()
            self.abort()
            raise RuntimeError(f"worker died before go: {e!r}") from e

    def _drain_stdout(self, i: int, proc: subprocess.Popen) -> None:
        for line in proc.stdout:
            line = line.strip()
            if line:
                self._stdout_lines[i].append(line)

    def _drain_stderr(self, i: int, proc: subprocess.Popen) -> None:
        for line in proc.stderr:
            # bounded tail: enough for a traceback, never unbounded
            self._stderr_tails[i] = (self._stderr_tails[i]
                                     + line)[-4000:]

    def collect(self, grace: float = 90.0) -> dict:
        """Wait for every worker to exit; merge results.  Returns
        {"legs": {name: LegResult}, "workers": N, "ok": bool,
        "worker_errors": [...]}."""
        assert self.start_at is not None, "launch() first"
        total = sum(l.duration_s for l in self.legs)
        deadline = self.start_at + total + grace
        ok, errors = True, []
        merged: dict[str, LegResult] = {
            l.name: LegResult() for l in self.legs}
        try:
            for i, proc in enumerate(self.procs_alive):
                timeout = max(1.0, deadline - time.time())
                try:
                    proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    ok = False
                    errors.append(f"worker {i}: no exit in {timeout:.0f}s"
                                  " (deadlock invariant trip)")
                    proc.kill()
                    try:
                        proc.wait(timeout=REAP_DEADLINE_S)
                    except subprocess.TimeoutExpired:
                        errors.append(f"worker {i}: not reaped "
                                      f"{REAP_DEADLINE_S} s after SIGKILL")
                    continue
                self._readers[2 * i].join(timeout=5.0)
                self._readers[2 * i + 1].join(timeout=5.0)
                lines = self._stdout_lines[i]
                if proc.returncode != 0 or not lines:
                    ok = False
                    err = self._stderr_tails[i]
                    errors.append(f"worker {i}: rc={proc.returncode} "
                                  f"{err[-500:]}")
                    continue
                try:
                    result = json.loads(lines[-1])
                except json.JSONDecodeError:
                    ok = False
                    errors.append(f"worker {i}: bad result line")
                    continue
                if not result.get("ok"):
                    ok = False
                    errors.append(f"worker {i}: {result.get('error')}")
                    continue
                for name, leg in (result.get("legs") or {}).items():
                    if name in merged:
                        merged[name].merge(leg)
        finally:
            self.abort()
        return {"legs": merged, "workers": self.procs, "ok": ok,
                "worker_errors": errors}

    def abort(self) -> None:
        """Kill any still-running worker (one failure must not orphan
        the rest — the dcn launcher's rule)."""
        for proc in self.procs_alive:
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs_alive:
            if proc.poll() is None:
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
            for pipe in (proc.stdin, proc.stdout, proc.stderr):
                try:
                    if pipe:
                        pipe.close()
                except OSError:
                    pass

    def run(self, grace: float = 90.0) -> dict:
        self.launch()
        return self.collect(grace=grace)
