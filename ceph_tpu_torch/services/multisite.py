"""Multisite async replication: zone-to-zone rgw sync.

The capability of the reference's RGW multisite machinery (src/rgw/
rgw_sync.cc metadata sync + rgw_data_sync.cc / RGWDataSyncCR: each zone
tails the peer zones' bucket-index logs over HTTP and applies changes
locally, with per-shard sync markers persisted so a restart resumes
where it left off; active-active loops are broken by skipping log
entries the applying zone itself originated).

ZoneSyncAgent runs INSIDE the destination zone: it polls the source
gateway's /admin/bilog endpoint, fetches changed objects with plain S3
GETs, and applies them through the destination gateway's store API
stamped with the ORIGIN zone (so the destination's own bilog entry for
the applied change is not replicated back — the no-ping-pong rule).
Conflicts resolve last-writer-wins by mtime, the reference's object-
mtime squash for non-versioned buckets.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse

from ..msg.wire import pack_value, unpack_value
from ..utils.log import dout
from .rgw import RgwGateway

_MARKERS_OID = "rgw_sync_markers.{src_zone}"


class ZoneSyncAgent:
    def __init__(self, src_host: str, src_port: int, dst: RgwGateway,
                 src_zone: str, interval: float = 0.2,
                 creds: tuple[str, str] | None = None):
        self.src_host = src_host
        self.src_port = src_port
        self.dst = dst
        self.src_zone = src_zone
        self.interval = interval
        self.creds = creds  # (access_key, secret_key) for SigV4 zones
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.cycles = 0
        self.applied = 0

    # ------------------------------------------------------------ control
    def start(self) -> "ZoneSyncAgent":
        self._thread = threading.Thread(
            target=self._run, name=f"rgw-sync-{self.src_zone}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    # ----------------------------------------------------- http plumbing
    def _request(self, method: str, path_qs: str,
                 body: bytes = b"") -> tuple[int, bytes]:
        headers = {}
        if self.creds is not None:
            from . import s3auth
            path, _, query = path_qs.partition("?")
            headers = s3auth.sign(
                method, f"{self.src_host}:{self.src_port}", path, query,
                body, self.creds[0], self.creds[1])
        conn = http.client.HTTPConnection(self.src_host, self.src_port,
                                          timeout=10)
        try:
            conn.request(method, path_qs, body=body or None,
                         headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    # ------------------------------------------------------- sync markers
    # Persisted in the DESTINATION zone (RGWDataSyncMarker role): a
    # restarted agent resumes from the durable position.
    def _markers_oid(self) -> str:
        return _MARKERS_OID.format(src_zone=self.src_zone)

    def _marker(self, bucket: str) -> int:
        try:
            raw = self.dst.client.omap_get(self.dst.pool,
                                           self._markers_oid())
        except Exception:  # noqa: BLE001 - no markers yet
            return 0
        return int(unpack_value(raw[bucket])) if bucket in raw else 0

    def _set_marker(self, bucket: str, seq: int) -> None:
        self.dst.client.omap_set(self.dst.pool, self._markers_oid(),
                                 {bucket: pack_value(int(seq))})

    # ------------------------------------------------------------ the loop
    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sync_once()
            except Exception as e:  # noqa: BLE001 - peer down: retry later
                dout("rgw", 5)("sync from %s: %r", self.src_zone, e)

    def _src_buckets(self) -> list[str]:
        st, body = self._request("GET", "/")
        if st != 200:
            return []
        out = []
        for part in body.decode().split("<Name>")[1:]:
            out.append(part.split("</Name>")[0])
        return out

    def sync_once(self) -> int:
        """One full pass over the source's buckets; returns entries
        applied."""
        self.cycles += 1
        applied = 0
        for bucket in self._src_buckets():
            try:
                self.dst.check_bucket(bucket)
            except KeyError:
                self.dst.create_bucket(bucket)  # metadata sync slice
            marker = self._marker(bucket)
            st, body = self._request(
                "GET", f"/admin/bilog?bucket={bucket}&marker={marker}")
            if st != 200:
                continue
            for entry in json.loads(body):
                if entry["zone"] == self.dst.zone:
                    # our own change echoed back: never re-apply
                    self._set_marker(bucket, entry["seq"])
                    continue
                verdict = self._apply(bucket, entry)
                if verdict == "retry":
                    # transient source failure: the marker must NOT
                    # advance past an unapplied entry (silent loss) —
                    # stop this bucket, the next cycle retries
                    break
                if verdict == "applied":
                    applied += 1
                self._set_marker(bucket, entry["seq"])
        self.applied += applied
        return applied

    def _apply(self, bucket: str, entry: dict) -> str:
        """-> "applied" | "skip" (superseded/duplicate) | "retry"."""
        key = entry["key"]
        vid = entry.get("version_id") or None
        op = entry["op"]
        # versioned ops replicate EXACT generations (the bilog carries
        # version ids — rgw data-sync versioned-epoch role); duplicates
        # are detected per-version, not by head mtime
        if (op in ("delete_marker", "delete_version")
                or (op == "put" and vid)) and \
                not self.dst.versioning_enabled(bucket):
            # versioned entries imply the source bucket is versioned:
            # mirror the flag before applying, or the unversioned paths
            # would DROP retained generations instead of keeping them
            self.dst.set_versioning(bucket, True)
        if op == "delete_marker":
            if any(m.get("delete_marker")
                   and m.get("version_id") == vid
                   for m in self.dst.versions_of(bucket, key)):
                return "skip"
            try:
                # the marker replicates with the ORIGIN's id, so the
                # generation graph stays identical across zones (a
                # later delete_version of the marker then applies)
                self.dst.delete_object(bucket, key,
                                       origin=entry["zone"],
                                       mtime=entry["mtime"],
                                       marker_version_id=vid)
            except KeyError:
                pass
            return "applied"
        if op == "delete_version":
            try:
                self.dst.delete_object(bucket, key, version_id=vid,
                                       origin=entry["zone"])
            except KeyError:
                pass  # that generation never made it here / gone
            return "applied"
        if op == "put" and vid:
            if any(m.get("version_id") == vid
                   for m in self.dst.versions_of(bucket, key)):
                return "skip"  # this exact generation already landed
            quoted = urllib.parse.quote(key)
            st, body = self._request(
                "GET", f"/{bucket}/{quoted}?versionId={vid}")
            if st == 404:
                return "skip"  # generation purged at source meanwhile
            if st != 200:
                return "retry"
            self.dst.put_object(bucket, key, body,
                                origin=entry["zone"],
                                mtime=entry["mtime"], version_id=vid)
            return "applied"
        # last-writer-wins by mtime: a newer local change outranks the
        # replicated one (non-versioned-bucket mtime squash)
        try:
            local = self.dst.head_object(bucket, key)
        except KeyError:
            local = None
        if local is not None and local["mtime"] > entry["mtime"]:
            return "skip"
        if op == "delete":
            try:
                self.dst.delete_object(bucket, key,
                                       origin=entry["zone"])
            except KeyError:
                pass  # already gone
            return "applied"
        if local is not None and local["etag"] == entry["etag"]:
            return "skip"  # content already present (e.g. via resync)
        quoted = urllib.parse.quote(key)
        st, body = self._request("GET", f"/{bucket}/{quoted}")
        if st == 404:
            return "skip"  # deleted again at source; its entry follows
        if st != 200:
            return "retry"  # transient source error: do not lose this
        self.dst.put_object(bucket, key, body, origin=entry["zone"],
                            mtime=entry["mtime"])
        return "applied"
