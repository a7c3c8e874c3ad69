"""Spec-driven deployment + rolling upgrade orchestration (cephadm role).

The capability slice of the reference's deployment stack
(Ceph's src/cephadm/ deploying daemons from a service spec;
`ceph orch apply/ls/daemon restart`; qa/suites/upgrade/ rolling-restart
staircases): a declarative cluster spec boots a monitor plus OSDs as
REAL child processes over TCP with durable stores, an inventory verb
reports every daemon's state, and the upgrade verb performs a ROLLING
restart — one daemon at a time, waiting for the cluster to re-absorb
each before touching the next — which is the availability contract the
wire-format corpus (tools/dencoder.py) exists to protect.

Library use (tests, tooling):

    spec = {"osds": [{"id": 0, "store": "filestore"}, ...],
            "pools": [{"name": "p", "size": 2, "pg_num": 8}]}
    adm = CephAdm(spec, base_dir, device="cpu")  # children see no card
    adm.deploy()
    adm.rolling_restart()        # the `orch upgrade start` role
    adm.ls()                     # the `orch ps` inventory
    adm.teardown()

The OSD children are the port's (``ceph_tpu_torch.tools.osd_main``).
``device`` (``--device``, default ``cuda``) says where they may compute:
with ``cpu`` each child starts with ``CUDA_VISIBLE_DEVICES`` empty, as
the load workers do, so it never opens a card (its EC pools then need
``device=cpu`` in their profiles).

CLI:
    python -m ceph_tpu_torch.tools.cephadm --spec spec.json deploy
    python -m ceph_tpu_torch.tools.cephadm --spec spec.json --device cpu ls
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


class CephAdm:
    def __init__(self, spec: dict, base_dir: str,
                 cfg_overrides: dict | None = None, device: str = "cuda"):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        self.spec = dict(spec)
        self.base = base_dir
        self.device = device
        # ONE merged config for the monitor and every OSD child — a
        # split source here silently diverges heartbeat behavior
        self.cfg = {"osd_heartbeat_interval": 0.25,
                    "osd_heartbeat_grace": 2.0,
                    **(cfg_overrides or {})}
        self.cluster = None

    # ------------------------------------------------------------ deploy
    def deploy(self):
        """Boot the spec: one monitor (durable store under base/mon) +
        every OSD as a child process with a durable store directory."""
        from ..utils.config import default_config
        from .vstart import MiniCluster

        cfg = default_config()
        cfg.apply_dict(dict(self.cfg))
        os.makedirs(self.base, exist_ok=True)
        self.cluster = MiniCluster(
            n_osds=0, cfg=cfg, transport="tcp",
            mon_path=os.path.join(self.base, "mon"))
        self.cluster.start()
        for osd in self.spec.get("osds", []):
            self._spawn(osd)
        self.cluster.wait_for_up(len(self.spec.get("osds", [])),
                                 timeout=30.0)
        client = self.cluster.client()
        for pool in self.spec.get("pools", []):
            client.create_pool(pool["name"],
                               kind=pool.get("kind", "replicated"),
                               size=pool.get("size", 2),
                               pg_num=pool.get("pg_num", 8),
                               ec_profile=pool.get("ec_profile"))
        return self

    def _store_path(self, osd_id: int) -> str:
        return os.path.join(self.base, f"osd.{osd_id}")

    def _spawn(self, osd_spec: dict):
        osd_id = int(osd_spec["id"])
        store = osd_spec.get("store", "filestore")
        path = None
        if store != "memstore":
            path = self._store_path(osd_id)
            os.makedirs(path, exist_ok=True)
        return self.cluster.spawn_osd_process(
            osd_id, store=store, store_path=path,
            cfg_overrides=dict(self.cfg),
            env={"CUDA_VISIBLE_DEVICES": ""} if self.device == "cpu"
            else None)

    # --------------------------------------------------------- inventory
    def ls(self) -> list[dict]:
        """`ceph orch ps` role: every deployed daemon with its state."""
        out = [{"daemon": self.cluster.mon.name, "type": "mon",
                "state": "running", "pid": os.getpid()}]
        osdmap = self.cluster.mon.osdmap
        for osd_id, proc in sorted(self.cluster.procs.items()):
            info = osdmap.osds.get(osd_id)
            out.append({
                "daemon": f"osd.{osd_id}", "type": "osd",
                "pid": proc.pid,
                "state": ("running" if proc.poll() is None else
                          f"exited rc={proc.returncode}"),
                "up": bool(info and info.up),
                "store": self._store_path(osd_id)})
        return out

    # ----------------------------------------------------------- upgrade
    def restart_daemon(self, osd_id: int, wait: float = 30.0) -> None:
        """Restart one OSD into a fresh process on its durable store
        (the `orch daemon restart` / binary-swap step)."""
        spec = next(o for o in self.spec["osds"]
                    if int(o["id"]) == osd_id)
        # kill_osd terminates the child AND marks it down at the mon:
        # without the explicit down-mark the map keeps up=True through
        # the restart (heartbeat grace), the readiness wait below would
        # pass vacuously, and the staircase would overlap real outages
        # of consecutive OSDs
        self.cluster.kill_osd(osd_id, mark_down=True)
        self._wait_osd_state(osd_id, up=False, timeout=wait)
        self._spawn(spec)
        self._wait_osd_state(osd_id, up=True, timeout=wait)

    def _wait_osd_state(self, osd_id: int, up: bool,
                        timeout: float) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            info = self.cluster.mon.osdmap.osds.get(osd_id)
            if (info is not None and info.up) == up:
                return
            time.sleep(0.05)
        raise TimeoutError(f"osd.{osd_id} never reached up={up}")

    def wait_health_ok(self, timeout: float = 30.0) -> None:
        client = self.cluster.clients[0]
        deadline = time.time() + timeout
        while time.time() < deadline:
            if client.status()["health"] == "HEALTH_OK":
                return
            time.sleep(0.1)
        raise TimeoutError("cluster did not return to HEALTH_OK")

    def rolling_restart(self, settle: float = 0.3) -> list[int]:
        """The upgrade staircase (qa/suites/upgrade/ shape): restart
        every OSD ONE AT A TIME, requiring the cluster back at
        HEALTH_OK before touching the next daemon — client IO keeps
        flowing throughout (the no-downtime upgrade contract)."""
        order = [int(o["id"]) for o in self.spec.get("osds", [])]
        for osd_id in order:
            self.restart_daemon(osd_id)
            self.wait_health_ok()
            time.sleep(settle)
        return order

    def teardown(self) -> None:
        if self.cluster is not None:
            self.cluster.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="cephadm-role deployment")
    p.add_argument("--spec", required=True,
                   help="JSON service spec file")
    p.add_argument("--base", default="./cephadm-cluster")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the OSD children may compute (cpu: no "
                        "card in them)")
    p.add_argument("verb", choices=["deploy", "ls", "upgrade"])
    args = p.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    adm = CephAdm(spec, args.base, device=args.device)
    adm.deploy()
    try:
        if args.verb == "ls":
            print(json.dumps(adm.ls(), indent=2))
        elif args.verb == "upgrade":
            order = adm.rolling_restart()
            print(json.dumps({"restarted": order}))
        else:
            print(json.dumps({"deployed": len(adm.ls())}))
            print("cluster up; Ctrl-C to tear down", file=sys.stderr)
            try:
                while True:
                    time.sleep(1)
            except KeyboardInterrupt:
                pass
    finally:
        adm.teardown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
