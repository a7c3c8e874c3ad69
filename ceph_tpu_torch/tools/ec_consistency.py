"""Independent online EC audit: client-side shard reads + in-tool
re-encode (the port's copy of ``ceph_tpu/tools/ec_consistency.py``; the
re-encode runs on the port's codec for the pool's profile, so a
``backend=torch`` pool re-encodes on the card).

The capability of the reference's consistency checker
(src/erasure-code/consistency/ceph_ec_consistency_checker.cc with
ECReader.h reading raw shards and ECEncoder.h:17 re-encoding them
IN-PROCESS): the tool fetches every shard's STORED bytes straight from
its holder, re-derives the parity with its OWN codec instance, and
compares.  Nothing is delegated to the OSDs' scrub machinery, so a
systematic OSD-side encode bug — or a corrupted parity shard whose
stored checksum was fixed up to match (self-consistent damage deep
scrub's per-shard digest check cannot see) — cannot hide from it.

Checks per object:
- parity_mismatch: stored parity differs from the in-tool re-encode
- csum_mismatch:   a shard's stored dcsum does not match its bytes
- stale_version:   shard version attrs disagree across holders
- missing_shard:   an up holder has no bytes for its shard
- shard_unreachable: a holder did not answer (reported, not fatal)

Usage (mirrors the reference tool's pool/object addressing):
    python -m ceph_tpu_torch.tools.ec_consistency --pool ecpool --mon-addr ...
    python -m ceph_tpu_torch.tools.ec_consistency --pool ecpool --oid obj1 ...
Exit code 0 = consistent, 1 = inconsistencies found, 2 = error.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import threading

import numpy as np

from ..msg.messages import MSubRead, MSubReadReply, PgId
from ..msg.messenger import Dispatcher, Messenger, Policy


class EcAuditor(Dispatcher):
    """Client-side shard reader + independent re-encoder."""

    def __init__(self, client, backend: str | None = None,
                 timeout: float = 10.0):
        self.client = client
        self.timeout = timeout
        self.backend = backend
        # a dedicated endpoint for raw shard reads (MSubRead is an
        # OSD<->OSD message; the replies come back here by tid)
        self.messenger = Messenger(client.messenger.network,
                                   f"{client.name}.ec-audit",
                                   Policy.lossless_peer())
        self.messenger.add_dispatcher(self)
        self.messenger.start()
        self._tids = itertools.count(1)
        self._waiters: dict[int, threading.Event] = {}
        self._replies: dict[int, MSubReadReply] = {}
        self._codecs: dict[int, object] = {}

    def close(self) -> None:
        self.messenger.shutdown()

    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MSubReadReply):
            ev = self._waiters.get(msg.tid)
            if ev is not None:
                self._replies[msg.tid] = msg
                ev.set()
            return True
        return False

    # -- raw shard fetch ---------------------------------------------------
    def _read_shard(self, osd: int, pgid: PgId, oid: str,
                    shard: int) -> MSubReadReply | None:
        tid = next(self._tids)
        ev = threading.Event()
        self._waiters[tid] = ev
        try:
            self.messenger.send_message(
                f"osd.{osd}", MSubRead(tid, pgid, oid, shard, None))
            if not ev.wait(self.timeout):
                return None
            return self._replies.pop(tid)
        finally:
            self._waiters.pop(tid, None)
            self._replies.pop(tid, None)

    # -- independent codec -------------------------------------------------
    def _codec(self, pool_spec):
        """The tool's OWN codec for the pool's profile — constructed
        here, never borrowed from a daemon, optionally on a different
        math backend (so an OSD-side backend bug cannot self-verify)."""
        c = self._codecs.get(pool_spec.pool_id)
        if c is None:
            from ..ec.registry import factory
            profile = dict(pool_spec.ec_profile)
            plugin = profile.pop("plugin", "jerasure")
            if self.backend:
                profile["backend"] = self.backend
            c = factory(plugin, profile)
            self._codecs[pool_spec.pool_id] = c
        return c

    # -- the audit ---------------------------------------------------------
    def audit_object(self, pool: str, oid: str) -> list[dict]:
        cl = self.client
        pool_id = cl._pool_id(pool)
        spec = cl.osdmap.pools[pool_id]
        if spec.kind != "ec":
            raise ValueError(f"pool {pool!r} is not erasure-coded")
        codec = self._codec(spec)
        k, m = codec.k, codec.m
        seed = cl.osdmap.object_to_pg(pool_id, oid)
        pgid = PgId(pool_id, seed)
        up = cl.osdmap.pg_to_up_osds(pool_id, seed)
        issues: list[dict] = []
        shards: dict[int, bytes] = {}
        versions: dict[int, int] = {}
        for s in range(k + m):
            holder = up[s] if s < len(up) else None
            if holder is None:
                issues.append({"object": oid, "shard": s,
                               "kind": "no_holder"})
                continue
            rep = self._read_shard(holder, pgid, oid, s)
            if rep is None:
                issues.append({"object": oid, "shard": s, "osd": holder,
                               "kind": "shard_unreachable"})
                continue
            if rep.result < 0 or "v" not in rep.attrs:
                issues.append({"object": oid, "shard": s, "osd": holder,
                               "kind": "missing_shard"})
                continue
            shards[s] = rep.data
            versions[s] = int(rep.attrs.get("v", 0))
            if "dcsum" in rep.attrs:
                from ..ops import native
                if native.crc32c(rep.data) != int(rep.attrs["dcsum"]):
                    issues.append({"object": oid, "shard": s,
                                   "osd": holder,
                                   "kind": "csum_mismatch"})
        if versions and len(set(versions.values())) > 1:
            auth_v = max(versions.values())
            for s, v in sorted(versions.items()):
                if v != auth_v:
                    issues.append({"object": oid, "shard": s,
                                   "kind": "stale_version",
                                   "have": v, "want": auth_v})
            # a torn snapshot (write in flight between our sequential
            # reads) must not escalate to the parity_mismatch alarm:
            # the version skew is already reported, and re-encoding
            # mixed-version shards compares apples to oranges
            return issues
        if any(s not in shards for s in range(k)):
            return issues  # cannot re-encode without every data shard
        L = max((len(b) for b in shards.values()), default=0)
        if L == 0:
            return issues
        data = np.zeros((k, L), dtype=np.uint8)
        for s in range(k):
            b = shards[s]
            data[s, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        expected = codec.encode_chunks(data)
        for j in range(m):
            s = k + j
            if s not in shards:
                continue
            stored = np.zeros(L, dtype=np.uint8)
            b = shards[s]
            stored[:len(b)] = np.frombuffer(b, dtype=np.uint8)
            if not np.array_equal(stored, expected[j]):
                issues.append({"object": oid, "shard": s,
                               "osd": up[s] if s < len(up) else None,
                               "kind": "parity_mismatch"})
        return issues

    def audit_pool(self, pool: str) -> list[dict]:
        issues: list[dict] = []
        for oid in self.client.list_objects(pool):
            issues.extend(self.audit_object(pool, oid))
        return issues


def run(client, pool: str, oid: str | None = None,
        backend: str | None = None) -> list[dict]:
    auditor = EcAuditor(client, backend=backend)
    try:
        if oid is not None:
            return auditor.audit_object(pool, oid)
        return auditor.audit_pool(pool)
    finally:
        auditor.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="independent online EC audit (client-side shard "
                    "reads + in-tool re-encode)")
    p.add_argument("--pool", required=True)
    p.add_argument("--oid", help="audit one object (default: the pool)")
    p.add_argument("--backend",
                   help="force the tool's codec math backend "
                        "(numpy/native/torch) — independent of the OSDs'")
    p.add_argument("--json", action="store_true")
    p.add_argument("--mon-addr", required=True,
                   help="a live cluster monitor, host:port "
                        "(the TCP transport)")
    p.add_argument("--secret", default="",
                   help="transport shared secret, hex (when the "
                        "cluster enforces wire auth)")
    p.add_argument("--entity", default="",
                   help="cephx entity name (auth clusters)")
    p.add_argument("--key", default="",
                   help="cephx entity key, hex (auth clusters)")
    p.add_argument("--timeout", type=float, default=30.0)
    args = p.parse_args(argv)

    from ..client.rados import RadosClient
    from ..msg.tcp import TcpNetwork

    net = TcpNetwork(
        auth_secret=bytes.fromhex(args.secret) if args.secret else None)
    client = RadosClient(
        net, name="client.ec-audit", timeout=args.timeout,
        auth_entity=args.entity or None,
        auth_key=bytes.fromhex(args.key) if args.key else None)
    net.set_addr("mon.0", args.mon_addr)
    try:
        client.connect()
        issues = run(client, args.pool, oid=args.oid,
                     backend=args.backend)
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        try:
            client.close()
        except Exception:  # noqa: BLE001
            pass
    if args.json:
        print(json.dumps({"pool": args.pool, "issues": issues},
                         default=str))
    else:
        for i in issues:
            print(f"INCONSISTENT {i}")
        print(f"{args.pool}: {len(issues)} inconsistencies")
    return 0 if not issues else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
