"""AdminSocket: per-daemon unix-socket command server.

The capability of the reference's AdminSocket
(src/common/admin_socket.cc: a unix socket per daemon answering
`ceph daemon <name> <command>` — perf dump, dump_ops_in_flight, config
show/set, status, injections).  Protocol: one JSON request object per
connection ({"prefix": "...", ...extra args}), one JSON reply, socket
closes — the same one-shot shape as the reference's `ceph --admin-daemon`.
"""

from __future__ import annotations

import json
import os
import socket
import threading

from .log import dout


def asok_path(admin_dir: str, name: str) -> str:
    """THE admin-socket path convention — one resolver shared by the
    cluster harness (which creates the sockets), the CLI tools
    (event_tool, trace_tool) and the load harness, instead of each
    re-deriving ``<dir>/<name>.asok`` by hand.  Lives here (not in
    vstart) so a lightweight CLI can resolve a path without importing
    the whole daemon stack."""
    return os.path.join(admin_dir, f"{name}.asok")


class AdminSocketServer:
    """Serve a daemon's admin_command(cmd, **kw) over a unix socket."""

    def __init__(self, path: str, handler):
        self.path = path
        self._handler = handler
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(16)
        self._stopping = False
        self._thread = threading.Thread(
            target=self._accept_loop, name=f"admin-{os.path.basename(path)}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopping = True
        try:
            self._sock.close()
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(5)
            buf = bytearray()
            while b"\n" not in buf and len(buf) < 1 << 20:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf.extend(chunk)
            try:
                req = json.loads(buf.decode("utf-8") or "{}")
                cmd = req.pop("prefix", "")
                result = self._handler(cmd, **req)
                reply = {"ok": True, "result": result}
            except Exception as e:  # noqa: BLE001 - report, don't die
                reply = {"ok": False, "error": repr(e)}
            conn.sendall(json.dumps(reply, default=str).encode("utf-8")
                         + b"\n")
        except OSError as e:
            dout("admin", 5)("admin socket client error: %r", e)
        finally:
            try:
                conn.close()
            except OSError:
                pass


def admin_request(path: str, prefix: str, timeout: float = 5.0, **kw):
    """Client side (the `ceph daemon` verb): one JSON round-trip."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(path)
        req = dict(kw, prefix=prefix)
        s.sendall(json.dumps(req).encode("utf-8") + b"\n")
        buf = bytearray()
        while b"\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf.extend(chunk)
        reply = json.loads(buf.decode("utf-8"))
        if not reply.get("ok"):
            raise RuntimeError(reply.get("error", "admin command failed"))
        return reply["result"]
    finally:
        s.close()
