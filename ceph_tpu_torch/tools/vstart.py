"""MiniCluster: the vstart.sh analogue — a full cluster in one process.

The reference boots mon+mgr+osd daemons from the build dir for development
and standalone tests (src/vstart.sh; qa/standalone/ceph-helpers.sh).  Here
a MiniCluster wires MonitorLite + N OSDDaemons + clients over a
LocalNetwork (in-proc messenger), with kill/revive and fault-injection
helpers shaped like the thrasher/ceph-helpers verbs.
"""

from __future__ import annotations

import os
import time

from ..client.rados import RadosClient
from ..mon.monitor import MonitorLite
from ..msg.messenger import LocalNetwork
from ..osd.daemon import OSDDaemon
from ..utils.admin_socket import asok_path
from ..utils.config import Config, default_config

__all__ = ["MiniCluster", "asok_path"]


class MiniCluster:
    def __init__(self, n_osds: int = 3, cfg: Config | None = None,
                 hosts_per_osd: bool = True, transport: str = "local",
                 n_mons: int = 1, mon_path: str | None = None,
                 admin_dir: str | None = None,
                 metrics_port: int | None = None,
                 tcp_auth_secret: bytes | None = None,
                 tcp_compress: str = "none",
                 tcp_secure: bool = False,
                 auth: bool = False,
                 auth_rotation: float = 0.0,
                 auth_ttl: float = 3600.0):
        self.cfg = cfg or default_config()
        # cephx (AuthMonitor + OSDCap roles): service base secrets +
        # the bootstrap admin entity, provisioned to every daemon at
        # construction (the keyring-file deployment role).  Each mon
        # gets its OWN KeyServer seeded identically; later `auth`
        # commands replicate through the paxos "authdb" key.
        self._auth_rotation = auth_rotation
        self._auth_ttl = auth_ttl
        self._svc_secrets = None
        self._seed_entities: dict = {}
        self.admin_key = None
        if auth:
            import secrets as _secrets
            self._svc_secrets = {s: _secrets.token_bytes(32)
                                 for s in ("mon", "osd", "mds")}
            self.admin_key = _secrets.token_bytes(32)
            self._seed_entities = {"client.admin": {
                "key": self.admin_key,
                "caps": {"mon": "allow *", "osd": "allow *",
                         "mds": "allow *"}}}
        if transport == "tcp":
            from ..msg.tcp import TcpNetwork
            self.network = TcpNetwork(auth_secret=tcp_auth_secret,
                                      compress=tcp_compress,
                                      secure=tcp_secure,
                                      stack=self.cfg["ms_stack"])
        elif transport == "local":
            self.network = LocalNetwork()
        else:
            raise ValueError(f"unknown transport {transport!r}")
        self._tcp_auth_secret = tcp_auth_secret
        self._tcp_compress = tcp_compress
        self._tcp_secure = tcp_secure
        self.mon_names = [f"mon.{i}" for i in range(n_mons)]
        self.mons: dict[int, MonitorLite] = {}
        self._mon_path = mon_path
        for i in range(n_mons):
            self.mons[i] = self._make_mon(i)
        self.mon = self.mons[0]  # compat alias (single-mon tests)
        self.osds: dict[int, OSDDaemon] = {}
        self.procs: dict[int, object] = {}  # subprocess OSDs (tcp mode)
        self.clients: list[RadosClient] = []
        self._n = n_osds
        self._hosts_per_osd = hosts_per_osd
        # observability (AdminSocket + mgr-prometheus roles)
        self._admin_dir = admin_dir
        self.admin_sockets: dict[str, object] = {}
        self.exporter = None
        if metrics_port is not None:
            from ..mon.exporter import MetricsExporter
            self.exporter = MetricsExporter(self.mon, port=metrics_port)
        if admin_dir:
            # resolve through self.mons at CALL time: a revived monitor
            # must serve, not the stopped object the closure was born with
            self._add_admin_socket(
                self.mon.name,
                lambda prefix, **kw: self.mons[0]._run_command(
                    dict(kw, prefix=prefix)))

    def asok(self, name: str) -> str:
        """Admin-socket path of one daemon (``mon.0``, ``osd.3``) —
        the shared resolver every tool should go through."""
        if not self._admin_dir:
            raise ValueError("cluster started without admin_dir")
        return asok_path(self._admin_dir, name)

    def admin(self, name: str, prefix: str, **kw):
        """One admin-socket round trip to a daemon by name (unwraps
        the mon's (errno, data) verb shape)."""
        from ..utils.admin_socket import admin_request
        result = admin_request(self.asok(name), prefix, **kw)
        if isinstance(result, list) and len(result) == 2 \
                and isinstance(result[0], int):
            if result[0] != 0:
                raise RuntimeError(f"{name} {prefix}: {result[1]}")
            result = result[1]
        return result

    def _add_admin_socket(self, name: str, handler) -> None:
        from ..utils.admin_socket import AdminSocketServer
        old = self.admin_sockets.pop(name, None)
        if old is not None:
            old.stop()  # revive: never leak the previous server
        self.admin_sockets[name] = AdminSocketServer(self.asok(name),
                                                     handler)

    def _drop_admin_socket(self, name: str) -> None:
        old = self.admin_sockets.pop(name, None)
        if old is not None:
            old.stop()

    def _make_key_server(self):
        if self._svc_secrets is None:
            return None
        from ..auth.cephx import KeyServer
        ks = KeyServer(dict(self._svc_secrets),
                       rotation=self._auth_rotation, ttl=self._auth_ttl)
        ks.entities = {name: {"key": ent["key"],
                              "caps": dict(ent["caps"])}
                       for name, ent in self._seed_entities.items()}
        return ks

    def _make_mon(self, rank: int) -> MonitorLite:
        import os
        path = None
        if self._mon_path:
            path = os.path.join(self._mon_path, f"mon{rank}")
        return MonitorLite(self.network, f"mon.{rank}", cfg=self.cfg,
                           peers=self.mon_names if len(self.mon_names) > 1
                           else (), path=path,
                           key_server=self._make_key_server())

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MiniCluster":
        for m in self.mons.values():
            m.start()
        if len(self.mons) > 1:
            self.wait_for_leader()
        for i in range(self._n):
            self.add_osd(i)
        self.wait_for_up(self._n)
        return self

    def leader_mon(self) -> MonitorLite | None:
        for m in self.mons.values():
            if m.is_leader:
                return m
        return None

    def wait_for_leader(self, timeout: float = 15.0) -> MonitorLite:
        deadline = time.time() + timeout
        while time.time() < deadline:
            m = self.leader_mon()
            if m is not None:
                return m
            time.sleep(0.02)
        raise TimeoutError("no mon leader elected")

    def kill_mon(self, rank: int) -> None:
        m = self.mons.pop(rank, None)
        if m:
            m.stop()

    def revive_mon(self, rank: int) -> MonitorLite:
        m = self._make_mon(rank)
        self.mons[rank] = m
        if rank == 0:
            self.mon = m  # keep the compat alias + exporter current
            if self.exporter is not None:
                self.exporter.mon = m
        m.start()
        return m

    def add_osd(self, osd_id: int, store=None) -> OSDDaemon:
        host = f"host{osd_id}" if self._hosts_per_osd else "host0"
        verifier = None
        if self._svc_secrets is not None:
            from ..auth.cephx import ServiceVerifier
            verifier = ServiceVerifier("osd", self._svc_secrets["osd"],
                                       rotation=self._auth_rotation)
        osd = OSDDaemon(osd_id, self.network, cfg=self.cfg, host=host,
                        mons=self.mon_names, store=store, auth=verifier)
        self.osds[osd_id] = osd
        osd.start()
        if self._admin_dir:
            # flight recorder: the daemon resolves peer sockets through
            # the shared asok convention to merge cross-daemon traces
            osd.asok_dir = self._admin_dir
            self._add_admin_socket(
                osd.name,
                lambda prefix, _o=osd, **kw: _o.admin_command(prefix,
                                                              **kw))
        return osd

    def spawn_osd_process(self, osd_id: int, store: str = "memstore",
                          store_path: str | None = None,
                          cfg_overrides: dict | None = None,
                          bind_ip: str | None = None,
                          env: dict | None = None):
        """Boot an OSD as a REAL child process over TCP (the multi-daemon
        vstart.sh mode).  Requires transport='tcp'.  ``env`` is set over
        this process's environment in the child's.  Returns the Popen;
        kill it with .terminate()/.kill() like a thrasher would."""
        import json as _json
        import os
        import subprocess
        import sys

        import ceph_tpu_torch
        mon_addr = self.network.addr_of(self.mon.name)
        if ":" not in mon_addr:
            raise RuntimeError("spawn_osd_process needs transport='tcp'")
        argv = [sys.executable, "-m", "ceph_tpu_torch.tools.osd_main",
                "--id", str(osd_id), "--mon-addr", mon_addr,
                "--store", store,
                "--host", f"host{osd_id}" if self._hosts_per_osd
                else "host0",
                "--cfg", _json.dumps(cfg_overrides or {})]
        if store_path:
            argv += ["--store-path", store_path]
        if bind_ip:
            argv += ["--bind-ip", bind_ip]
        if self._admin_dir:
            argv += ["--admin-socket", self.asok(f"osd.{osd_id}")]
        if self._tcp_auth_secret is not None:
            argv += ["--auth-secret-hex", self._tcp_auth_secret.hex()]
        if self._tcp_compress != "none":
            argv += ["--compress", self._tcp_compress]
        if self._tcp_secure:
            argv += ["--secure"]
        # the child must find the package regardless of caller cwd
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(ceph_tpu_torch.__file__)))
        child_env = {**os.environ, **(env or {})}
        child_env["PYTHONPATH"] = pkg_root + os.pathsep + child_env.get(
            "PYTHONPATH", "")
        proc = subprocess.Popen(argv, env=child_env)
        self.procs[osd_id] = proc
        return proc

    def mds_verifier(self):
        """ServiceVerifier for an in-process MDS on this cluster (None
        on an auth-free cluster)."""
        if self._svc_secrets is None:
            return None
        from ..auth.cephx import ServiceVerifier
        return ServiceVerifier("mds", self._svc_secrets["mds"],
                               rotation=self._auth_rotation)

    def client(self, idx: int | None = None,
               entity: str | None = None,
               key: bytes | None = None) -> RadosClient:
        """A connected client.  On an auth cluster the default identity
        is client.admin; pass entity+key for a restricted identity."""
        idx = len(self.clients) if idx is None else idx
        if key is None and self.admin_key is not None:
            entity, key = "client.admin", self.admin_key
        c = RadosClient(self.network, f"client.{idx}",
                        mons=self.mon_names, auth_entity=entity,
                        auth_key=key).connect()
        # always-on head sampling: clients inherit the cluster's
        # trace_sample_rate (the root-op draw that covers the whole
        # client -> primary -> shard fan-out)
        c.tracer.set_sample_rate(self.cfg["trace_sample_rate"])
        self.clients.append(c)
        return c

    def stop(self) -> None:
        for c in self.clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        for o in self.osds.values():
            o.stop()
        for p in self.procs.values():
            try:
                p.terminate()
                p.wait(timeout=5)
            except Exception:  # noqa: BLE001
                p.kill()
                p.wait()  # reap — no zombies across a test session
        for m in self.mons.values():
            m.stop()
        for a in self.admin_sockets.values():
            a.stop()
        if self.exporter is not None:
            self.exporter.stop()
        if hasattr(self.network, "stop"):
            self.network.stop()

    # ------------------------------------------------------------- helpers
    def _best_epoch_map(self):
        """The newest map any live monitor holds."""
        best = None
        for m in self.mons.values():
            if best is None or m.osdmap.epoch > best.epoch:
                best = m.osdmap
        return best

    def wait_for_up(self, n: int, timeout: float = 10.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self._best_epoch_map().up_osds()) >= n:
                return
            time.sleep(0.01)
        raise TimeoutError(
            f"only {len(self._best_epoch_map().up_osds())}/{n} up")

    def wait_for_epoch(self, epoch: int, timeout: float = 10.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self._best_epoch_map().epoch >= epoch:
                return
            time.sleep(0.01)
        raise TimeoutError(
            f"epoch {self._best_epoch_map().epoch} < {epoch}")

    def kill_osd(self, osd_id: int, mark_down: bool = True):
        """Hard-kill a daemon (kill_daemon in ceph-helpers).  With
        mark_down=False the cluster must notice via heartbeats.
        Returns the dead daemon's object store: pass it to revive_osd
        to model a crash-RESTART (durable state survives) instead of a
        device swap (fresh store, recovery rebuilds everything)."""
        osd = self.osds.pop(osd_id, None)
        store = None
        if osd:
            osd.stop()
            store = osd.store
            self._drop_admin_socket(osd.name)
        proc = self.procs.pop(osd_id, None)
        if proc is not None:
            proc.kill()
            proc.wait()
        if mark_down and self.clients:
            self.clients[0].mon_command({"prefix": "osd down",
                                         "id": osd_id})
        return store

    def revive_osd(self, osd_id: int, store=None) -> OSDDaemon:
        return self.add_osd(osd_id, store=store)

    def collect_trace(self, trace_id: int) -> list[dict]:
        """Collector role: merge every daemon's + client's local span
        ring for one trace id (what jaeger assembles from per-service
        reports)."""
        spans = []
        for osd in self.osds.values():
            spans += osd.tracer.spans_for(trace_id)
        for cl in self.clients:
            spans += cl.tracer.spans_for(trace_id)
        return spans

    def settle(self, seconds: float = 0.2) -> None:
        """Let in-flight dispatch/recovery drain (tests only)."""
        time.sleep(seconds)
