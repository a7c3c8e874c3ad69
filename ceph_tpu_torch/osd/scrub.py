"""Scrub: consistency auditing of PG replicas/shards, with repair.

The capability of the reference's scrubber (src/osd/scrubber/ — SURVEY.md
§2.5: shallow scrub compares object metadata across replicas, deep scrub
compares full-data digests via scrub_backend.cc; EC shards check local
checksums; `pg repair` rewrites bad copies from the authoritative one) and
of the EC consistency checker tool
(src/erasure-code/consistency/ceph_ec_consistency_checker.cc: re-encode
parity from data shards and compare).

Mixin for OSDDaemon: the primary fans MScrubShard to members, each returns
a scrub map (size/version per object; + crc32c digest when deep), and the
primary compares:
- replicated: every copy must match the authoritative (max-version) one;
- EC: each shard's stored digest attr must match its recomputed data (the
  per-shard local check), and with deep+repair the stripe is re-encoded
  from data shards and compared against stored parity (the consistency-
  checker pass), rebuilding any bad shard.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..ec.verify import verifier
from ..msg.messages import (MPGPull, MPGPush, MScrubMap, MScrubRequest,
                            MScrubResult, MScrubShard, PgId)
from ..ops import native
from ..ops.checksum import crc32c_extend_zeros, crc32c_ref
from ..utils.log import dout
from .objectstore import (CollectionId, NoSuchCollection, NoSuchObject,
                          ObjectId, Transaction)
from .snaps import to_oid, vname_of


def _host_crc32c(data: bytes) -> int:
    """Backend-independent host CRC for mismatch confirmation."""
    try:
        return native.crc32c(data)
    except Exception:  # noqa: BLE001 - ctypes lib unavailable
        return crc32c_ref(data)


@dataclass
class _PendingScrub:
    client: str
    client_tid: int
    pgid: PgId
    deep: bool
    repair: bool
    waiting_for: set = field(default_factory=set)
    maps: dict = field(default_factory=dict)  # osd -> scrub map
    span: object = None  # head-sampled root span (finished at compare)


class ScrubMixin:
    """Scrub handlers; mixed into OSDDaemon."""

    def _scrub_map_local(self, pgid: PgId, deep: bool) -> dict:
        cid = CollectionId(pgid.pool, pgid.seed)
        out = {}
        try:
            oids = self.store.list_objects(cid)
        except Exception:  # noqa: BLE001 - no collection yet
            return out
        for oid in oids:
            if oid.shard <= -2:
                continue  # PG metadata (pglog/snapmapper), not user data
            key = (vname_of(oid), oid.shard)  # clones scrub as vnames
            try:
                attrs = self.store.getattrs(cid, oid)
                entry = {"size": self.store.stat(cid, oid)["size"],
                         "version": int(attrs.get("v", 0))}
                if deep:
                    data = self.store.read(cid, oid).to_bytes()
                    entry["digest"] = native.crc32c(data)
                    entry["stored_digest"] = attrs.get("d")
                out[key] = entry
            except Exception as e:  # noqa: BLE001 - count unreadable objects
                out[key] = {"error": repr(e)}
        return out

    def _handle_scrub_request(self, conn, m: MScrubRequest) -> None:
        up = self.osdmap.pg_to_up_osds(m.pgid.pool, m.pgid.seed)
        if self._primary_of(up) != self.osd_id:
            conn.send(MScrubResult(m.tid, m.pgid, -116, []))
            return
        tid = next(self._tids)
        members = {u for u in up if u is not None}
        ps = _PendingScrub(m.client, m.tid, m.pgid, m.deep, m.repair,
                           waiting_for=set(members))
        # scrubs are ROOT ops for the head sampler (trace_sample_rate):
        # the span covers request -> shard maps -> compare/repair
        ps.span = self.tracer.sample_root(
            "scrub", pg=self._pgstr(m.pgid), deep=m.deep)
        self._pending_scrubs[tid] = ps
        for osd in members:
            if osd == self.osd_id:
                self._on_scrub_map(tid, self.osd_id,
                                   self._scrub_map_local(m.pgid, m.deep))
            else:
                self.messenger.send_message(
                    f"osd.{osd}", MScrubShard(tid, m.pgid, m.deep))

    def _handle_scrub_shard(self, conn, m: MScrubShard) -> None:
        conn.send(MScrubMap(m.tid, m.pgid, self.osd_id,
                            self._scrub_map_local(m.pgid, m.deep)))

    def _handle_scrub_map(self, conn, m: MScrubMap) -> None:
        self._on_scrub_map(m.tid, m.from_osd, m.objects)

    def _on_scrub_map(self, tid: int, from_osd: int, objects: dict) -> None:
        ps = self._pending_scrubs.get(tid)
        if ps is None:
            return
        ps.maps[from_osd] = objects
        ps.waiting_for.discard(from_osd)
        if ps.waiting_for:
            return
        del self._pending_scrubs[tid]
        self._finish_scrub(ps)

    # ------------------------------------------------------------- compare
    def _finish_scrub(self, ps: _PendingScrub) -> None:
        pool = self.osdmap.pools[ps.pgid.pool]
        issues: list[dict] = []
        for osd, omap_ in ps.maps.items():
            for key, entry in omap_.items():
                if "error" in entry:
                    issues.append({"osd": osd, "object": key[0],
                                   "shard": key[1], "kind": "read_error",
                                   "detail": entry["error"]})
                elif ps.deep and entry.get("stored_digest") is None:
                    # a non-empty object with no stored digest is NOT
                    # clean — it is unverifiable, which deep scrub must
                    # surface (every write path stamps "d"; an absent
                    # one means an interrupted transaction or attr rot)
                    if entry.get("size", 0) > 0:
                        issues.append({"osd": osd, "object": key[0],
                                       "shard": key[1],
                                       "kind": "digest_missing"})
                elif ps.deep and entry["digest"] != entry["stored_digest"]:
                    issues.append({"osd": osd, "object": key[0],
                                   "shard": key[1],
                                   "kind": "digest_mismatch"})
        if pool.kind == "ec":
            issues += self._scrub_compare_ec(ps)
        else:
            issues += self._scrub_compare_replicated(ps)
        repaired = 0
        if ps.repair and issues:
            repaired = self._scrub_repair(ps, issues)
        self.perf.inc("scrubs")
        if ps.span is not None:
            ps.span.tag("errors", len(issues)).tag("repaired", repaired)
            ps.span.finish()
        self.events.emit(
            "scrub",
            f"pg {self._pgstr(ps.pgid)} "
            f"{'deep-' if ps.deep else ''}scrub done"
            + (f": {len(issues)} inconsistencies" if issues else ""),
            severity="warn" if issues else "info",
            pg=self._pgstr(ps.pgid), deep=ps.deep,
            errors=len(issues), repaired=repaired)
        if issues:
            self.perf.inc("scrub_errors", len(issues))
            dout("osd", 1)("%s: scrub %s found %d inconsistencies",
                           self.name, ps.pgid, len(issues))
            if not ps.repair and any(
                    i["kind"] in ("missing_shard", "stale_version",
                                  "missing_copy")
                    for i in issues):
                # close the detect->repair->converge loop: a scrub that
                # SEES recoverable damage re-arms recovery even without
                # the explicit repair verb — a rebuild lost to a racing
                # map change or swept read must not leave a permanent
                # hole that only an operator command would fix (the
                # round-3 thrash fixed point: 4/5 shards healthy,
                # recovery idle, nothing ever retried)
                self._requery_pg(ps.pgid, force_full=True)
        self.messenger.send_message(
            ps.client, MScrubResult(ps.client_tid, ps.pgid, 0, issues,
                                    repaired))

    def _scrub_compare_replicated(self, ps: _PendingScrub) -> list[dict]:
        issues = []
        names: dict[str, dict[int, dict]] = {}
        for osd, omap_ in ps.maps.items():
            for (name, _shard), entry in omap_.items():
                if "error" not in entry:
                    names.setdefault(name, {})[osd] = entry
        for name, per_osd in names.items():
            # authority: max version; then majority digest
            auth_v = max(e["version"] for e in per_osd.values())
            auth_size = max((e["size"] for e in per_osd.values()
                             if e["version"] == auth_v), default=0)
            for osd, e in per_osd.items():
                if e["version"] != auth_v:
                    issues.append({"osd": osd, "object": name, "shard": -1,
                                   "kind": "stale_version"})
                elif e["size"] != auth_size:
                    # same version, truncated copy (lost tail)
                    issues.append({"osd": osd, "object": name, "shard": -1,
                                   "kind": "size_mismatch"})
            if ps.deep:
                digests = [e["digest"] for e in per_osd.values()
                           if e["version"] == auth_v]
                if len(set(digests)) > 1:
                    issues.append({"osd": None, "object": name, "shard": -1,
                                   "kind": "replica_digest_mismatch"})
            missing = set(ps.maps) - set(per_osd)
            for osd in missing:
                issues.append({"osd": osd, "object": name, "shard": -1,
                               "kind": "missing_copy"})
        return issues

    def _scrub_compare_ec(self, ps: _PendingScrub) -> list[dict]:
        """Cross-shard EC comparison: every up shard member must hold an
        entry for every object at the authoritative version (a missing or
        stale shard is a scrub finding, not just a recovery condition)."""
        issues = []
        up = self.osdmap.pg_to_up_osds(ps.pgid.pool, ps.pgid.seed)
        shard_owner = {shard: osd for shard, osd in enumerate(up)
                       if osd is not None and osd in ps.maps}
        names: dict[str, int] = {}
        for omap_ in ps.maps.values():
            for (name, _shard), entry in omap_.items():
                if "error" not in entry:
                    names[name] = max(names.get(name, 0), entry["version"])
        for name, auth_v in names.items():
            for shard, osd in shard_owner.items():
                entry = ps.maps[osd].get((name, shard))
                if entry is None or "error" in entry:
                    issues.append({"osd": osd, "object": name,
                                   "shard": shard, "kind": "missing_shard"})
                elif entry["version"] != auth_v:
                    issues.append({"osd": osd, "object": name,
                                   "shard": shard, "kind": "stale_version"})
        return issues

    # -------------------------------------------------------------- repair
    def _scrub_repair(self, ps: _PendingScrub, issues: list[dict]) -> int:
        """Repair by re-running recovery against the scrub findings:
        replicated bad/stale/missing copies get pushed from the
        authoritative copy; EC bad shards are rebuilt from survivors."""
        pool = self.osdmap.pools[ps.pgid.pool]
        repaired = 0
        if pool.kind == "ec":
            for issue in issues:
                if issue["kind"] in ("digest_mismatch", "digest_missing",
                                     "read_error", "missing_shard",
                                     "stale_version"):
                    # version: the object's authoritative version from the
                    # scrub maps, NOT the pg-wide counter
                    name = issue["object"]
                    v = max((e["version"] for om in ps.maps.values()
                             for (n, _s), e in om.items()
                             if n == name and "error" not in e), default=0)
                    self._rebuild_shard(ps.pgid, name, issue["shard"],
                                        issue["osd"], version=v, force=True)
                    repaired += 1
            return repaired
        cid = CollectionId(ps.pgid.pool, ps.pgid.seed)
        # which copies does scrub consider bad, per object?
        bad: dict[str, set[int]] = {}
        for issue in issues:
            if issue["osd"] is not None:
                bad.setdefault(issue["object"], set()).add(issue["osd"])
        for issue in issues:
            name = issue["object"]
            target = issue["osd"]
            if target is None:
                continue
            if self.osd_id in bad.get(name, ()):
                # my own copy is flagged: pull from a good peer instead of
                # propagating my (possibly corrupt) bytes
                if target == self.osd_id:
                    good = [o for o, om in ps.maps.items()
                            if o not in bad.get(name, ())
                            and (name, -1) in om]
                    if good:
                        self.messenger.send_message(
                            f"osd.{good[0]}",
                            MPGPull(ps.pgid, [name], force=True))
                        repaired += 1
                continue
            obj = to_oid(name)
            if target == self.osd_id or not self.store.exists(cid, obj):
                continue
            data, attrs = self._read_obj_raw(cid, obj)
            v = int(attrs.get("v", 0))
            omap = self.store.omap_get(cid, obj)
            self.messenger.send_message(
                f"osd.{target}",
                MPGPush(ps.pgid, -1,
                        {name: (v, data, None, omap,
                                self._push_attrs(attrs))},
                        force=True))
            repaired += 1
        return repaired


    # ------------------------------------------------ background deep scrub
    #
    # Continuous folded deep scrub (the reference's osd_scrub_min/max_
    # interval scheduler, src/osd/scrubber/osd_scrub_sched.cc, folded
    # through the PR's batching seam): each OSD audits ITS OWN shard
    # bytes per hosted PG — chunked object ranges, a name cursor
    # persisted in the PG's scrub meta object's omap (kill/revive
    # resumes where it stopped), chunks executing on the PG's shard
    # thread under the scrub mclock class (serialized with client ops
    # on the PG: no torn reads; paced by the scrub reservation).
    #
    # Verification is FOLDED: a chunk's objects are grouped into pow2
    # length buckets, each object's STORED bytes zero-padded to the
    # bucket and stacked into one (n, B) launch through
    # ECBatcher.verify — one fused device CRC sweep for many objects —
    # while the EXPECTED padded digest derives host-side from the
    # stored digest via the CRC32C zero-extension operator
    # (crc32c_extend_zeros), so no per-object device work remains.  A
    # folded mismatch is only a CANDIDATE: the object is re-checked
    # with a host CRC before anything is counted or repaired (zero
    # false mismatches by construction).

    SCRUB_META = "scrub_cursor"  # per-PG meta object (shard -2)

    def _scrub_meta_oid(self) -> ObjectId:
        return ObjectId(self.SCRUB_META, shard=-2)

    def _scrub_cursor_load(self, cid: CollectionId) -> tuple | None:
        try:
            raw = self.store.omap_get(
                cid, self._scrub_meta_oid()).get("cursor")
        except (NoSuchObject, NoSuchCollection):
            return None
        if not raw:
            return None
        name, _, shard = bytes(raw).decode().rpartition("\x00")
        return (name, int(shard))

    def _scrub_cursor_store(self, cid: CollectionId,
                            cursor: tuple | None) -> None:
        obj = self._scrub_meta_oid()
        tx = Transaction()
        if not self.store.exists(cid, obj):
            tx.touch(cid, obj)
        if cursor is None:
            tx.omap_rmkeys(cid, obj, ["cursor"])
        else:
            tx.omap_setkeys(cid, obj, {
                "cursor": f"{cursor[0]}\x00{cursor[1]}".encode()})
        self.store.queue_transaction(tx)

    def _scrub_tick(self, now: float) -> None:
        """Heartbeat hook: arm due PGs.  One cycle in flight per PG;
        chunks self-requeue through the scheduler until the cursor
        wraps."""
        if not self.cfg["osd_scrub_auto"] or self.osdmap is None:
            return
        mn = float(self.cfg["osd_scrub_min_interval"])
        mx = max(float(self.cfg["osd_scrub_max_interval"]), mn)
        for pool_id, seed, _up in self._pools_pgs_for_me():
            key = (pool_id, seed)
            st = self._scrub_auto.get(key)
            if st is None:
                # deterministic per-PG stagger spreads a cold fleet's
                # first cycles across [min, max); a PERSISTED cursor
                # means a cycle died mid-flight (OSD restart) — resume
                # promptly instead of waiting a whole interval
                frac = (zlib.crc32(f"{self.osd_id}/{pool_id}/{seed}"
                                   .encode()) & 0xFFFF) / 0x10000
                resume = self._scrub_cursor_load(
                    CollectionId(pool_id, seed)) is not None
                st = {"due": now if resume
                      else now + mn + frac * (mx - mn),
                      "running": False, "objects": 0, "bytes": 0,
                      "mismatches": 0, "started": 0.0, "total": 0}
                self._scrub_auto[key] = st
            if st["running"] or now < st["due"]:
                continue
            st.update(running=True, objects=0, bytes=0, mismatches=0,
                      started=now, total=0)
            pgid = PgId(pool_id, seed)
            self.events.emit(
                "scrub", f"pg {self._pgstr(pgid)} auto deep-scrub start",
                pg=self._pgstr(pgid), event="scrub_start",
                start_ts=st["started"], done=0, total=0)
            self._scrub_auto_enqueue(pgid)

    def _scrub_auto_enqueue(self, pgid: PgId) -> None:
        if self._use_mclock:
            self.scheduler.enqueue(
                "scrub",
                (lambda _c, _m: self._scrub_auto_chunk(pgid),
                 None, None),
                key=(pgid.pool, pgid.seed))
        else:
            # fifo queue: no scheduler threads to drain a scrub class —
            # the whole cycle runs inline on the caller (chunked loop
            # inside _scrub_auto_chunk, no recursion)
            self._scrub_auto_chunk(pgid)

    def _scrub_auto_chunk(self, pgid: PgId) -> None:
        key = (pgid.pool, pgid.seed)
        st = self._scrub_auto.get(key)
        if st is None:
            return
        done = False
        while not done:
            try:
                done = self._scrub_auto_run_chunk(pgid, st)
            except Exception as e:  # noqa: BLE001 - abort cycle, re-arm
                dout("osd", 1)("%s: auto-scrub chunk %s failed: %r",
                               self.name, pgid, e)
                done = True
            if not done and self._use_mclock:
                # yield the shard thread between chunks: client ops on
                # this PG interleave, mclock paces the scrub class
                self._scrub_auto_enqueue(pgid)
                return
        now = time.time()
        mn = float(self.cfg["osd_scrub_min_interval"])
        st.update(running=False, due=now + mn)
        self.perf.inc("scrubs")
        self.events.emit(
            "scrub",
            f"pg {self._pgstr(pgid)} auto deep-scrub done: "
            f"{st['objects']} objects, {st['bytes']} bytes"
            + (f", {st['mismatches']} mismatches"
               if st["mismatches"] else ""),
            severity="warn" if st["mismatches"] else "info",
            pg=self._pgstr(pgid), event="scrub_done",
            start_ts=st["started"], done=st["objects"],
            total=max(st["total"], st["objects"]),
            mismatches=st["mismatches"])

    def _scrub_auto_run_chunk(self, pgid: PgId, st: dict) -> bool:
        """Verify one cursor-bounded object range; True = cycle done."""
        cid = CollectionId(pgid.pool, pgid.seed)
        cursor = self._scrub_cursor_load(cid)
        try:
            # generation objects are rollback stashes (transient, no
            # digest contract) — skip them, like the -2 PG metadata
            oids = sorted(
                (o for o in self.store.list_objects(cid)
                 if o.shard > -2 and o.generation < 0),
                key=lambda o: (o.name, o.shard))
        except NoSuchCollection:
            return True
        st["total"] = max(st["total"], len(oids))
        if cursor is not None:
            oids = [o for o in oids if (o.name, o.shard) > cursor]
        chunk = oids[:int(self.cfg["osd_scrub_chunk_max"])]
        if not chunk:
            self._scrub_cursor_store(cid, None)
            return True
        self.perf.inc("scrub_auto_chunks")
        self._scrub_verify_folded(pgid, cid, chunk, st)
        last = chunk[-1]
        if len(chunk) == len(oids):
            # tail chunk: the cycle wrapped — clear the cursor so the
            # next cycle starts fresh (and a restart doesn't resume)
            self._scrub_cursor_store(cid, None)
            return True
        self._scrub_cursor_store(cid, (last.name, last.shard))
        self.events.emit(
            "scrub", f"pg {self._pgstr(pgid)} auto deep-scrub progress",
            pg=self._pgstr(pgid), event="scrub_progress",
            start_ts=st["started"], done=st["objects"],
            total=st["total"])
        return False

    def _scrub_verify_folded(self, pgid: PgId, cid: CollectionId,
                             chunk: list, st: dict) -> None:
        """Fold one chunk's objects through the batcher and confirm/
        repair any candidate mismatches."""
        ver = verifier(str(self.cfg["osd_scrub_fold"]))
        todo = []  # (oid, stored bytes, stored digest, attrs)
        for oid in chunk:
            try:
                attrs = dict(self.store.getattrs(cid, oid))
                data = self.store.read(cid, oid).to_bytes()
            except (NoSuchObject, NoSuchCollection):
                continue  # deleted under the cursor: not a finding
            d = attrs.get("d")
            if d is None:
                if data:
                    self.perf.inc("scrub_digest_missing")
                    dout("osd", 2)("%s: scrub %s %s/%d: no stored digest",
                                   self.name, pgid, oid.name, oid.shard)
                continue
            todo.append((oid, data, int(d), attrs))
        if not todo:
            return
        # pow2 length buckets: uniform row length per launch; the
        # stored digest extends over the zero pad host-side so the
        # folded compare is exact for every ragged length
        buckets: dict[int, list] = {}
        for item in todo:
            n = len(item[1])
            b = 4 if n <= 4 else 1 << (n - 1).bit_length()
            buckets.setdefault(b, []).append(item)
        for blen, items in sorted(buckets.items()):
            rows = np.zeros((len(items), blen), dtype=np.uint8)
            expected = np.empty(len(items), dtype=np.uint32)
            for i, (_oid, data, d, _attrs) in enumerate(items):
                rows[i, :len(data)] = np.frombuffer(data, dtype=np.uint8)
                expected[i] = crc32c_extend_zeros(d, blen - len(data))
            digs = self._ec_batcher.verify(ver, rows)
            self.perf.inc("scrub_verify_launches")
            st["objects"] += len(items)
            for i in np.nonzero(digs != expected)[0]:
                oid, data, d, attrs = items[int(i)]
                # candidate only: confirm with a host CRC over the
                # exact stored bytes before counting or repairing
                if _host_crc32c(data) == d:
                    dout("osd", 1)(
                        "%s: scrub %s %s/%d: folded false positive",
                        self.name, pgid, oid.name, oid.shard)
                    continue
                self._scrub_auto_mismatch(pgid, cid, oid, attrs, st)
        st["bytes"] += sum(len(it[1]) for it in todo)
        self.perf.inc("scrub_verified_bytes",
                      sum(len(it[1]) for it in todo))

    def _scrub_auto_mismatch(self, pgid: PgId, cid: CollectionId,
                             oid, attrs: dict, st: dict) -> None:
        """One confirmed bad local copy: count, report, repair via the
        existing per-object paths (EC rebuild / replicated pull)."""
        st["mismatches"] += 1
        self.perf.inc("scrub_mismatches")
        self.perf.inc("scrub_errors")
        name = vname_of(oid)
        self.events.emit(
            "scrub",
            f"pg {self._pgstr(pgid)} auto deep-scrub: digest mismatch "
            f"{name}/{oid.shard}",
            severity="warn", pg=self._pgstr(pgid), object=name,
            shard=oid.shard, kind="digest_mismatch")
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is not None and pool.kind == "ec" and oid.shard >= 0:
            self._rebuild_shard(pgid, name, oid.shard, self.osd_id,
                                version=int(attrs.get("v", 0)),
                                force=True)
            return
        up = self.osdmap.pg_to_up_osds(pgid.pool, pgid.seed)
        peers = [u for u in up if u is not None and u != self.osd_id]
        if peers:
            # my copy is the corrupt one: pull clean bytes from a peer
            self.messenger.send_message(
                f"osd.{peers[0]}", MPGPull(pgid, [name], force=True))


# ---------------------------------------------------------------------------
# Fault injection (the ECInject role, src/osd/ECInject.{h,cc}: arm
# read/write/parity errors checked from the IO paths; driven by tests)
# ---------------------------------------------------------------------------

class FaultInjection:
    def __init__(self):
        self.corrupt_data: set = set()   # (pgid, name, shard)
        self.drop_shard_writes: set = set()  # shard ids to drop

    def corrupt_object(self, store, pgid: PgId, name: str,
                       shard: int = -1, offset: int = 0) -> bool:
        """Flip a byte in a stored object (silent corruption for scrub
        tests) — bypasses the transaction path on purpose."""
        cid = CollectionId(pgid.pool, pgid.seed)
        oid = ObjectId(name, shard=shard)
        if hasattr(store, "_dev"):  # bluestore: rot a byte on the device
            try:
                onode = store._onode(cid, oid)
            except (NoSuchObject, NoSuchCollection):
                return False
            idx = offset // 4096
            if idx >= len(onode.pages) or onode.pages[idx][0] < 0:
                return False
            with store._lock:
                store._flush_deferred()  # the device must hold the page
                phys = onode.pages[idx][0]
                page = bytearray(store._dev_read(phys))
                page[offset % 4096] ^= 0xFF
                store._dev_write(phys, page)
                store._dev.flush()
            return True
        try:
            obj = store._mem._obj(cid, oid) if hasattr(store, "_mem") \
                else store._obj(cid, oid)
        except NoSuchObject:
            return False
        if not obj.data:
            return False
        obj.data[offset] ^= 0xFF
        return True
