"""Cluster maps: OSDMap with epochs, pools, device states, placement.

The capability of the reference's OSDMap (src/osd/OSDMap.{h,cc}: epochs +
incrementals, up/in states and weights, pool table, pg_to_up_acting_osds
:3143 combining CRUSH output with overrides) re-shaped for the TPU build:
the map embeds a PlacementMap (CRUSH-equivalent) and is an Encodable so it
travels the messenger and persists in the monitor store.
"""

from __future__ import annotations

import collections
import copy
import threading
from dataclasses import dataclass, field

from ..parallel.placement import PlacementMap, hash_combine, pg_of_object
from ..utils.codec import Decoder, Encodable, Encoder


@dataclass
class PoolSpec(Encodable):
    pool_id: int
    name: str
    kind: str = "replicated"  # replicated | ec
    size: int = 3             # replicas, or k+m for ec
    min_size: int = 2
    pg_num: int = 32
    ec_profile: dict = field(default_factory=dict)
    # self-managed snapshots (pg_pool_t snap_seq/removed_snaps role):
    # snap ids are minted monotonically here; removal publishes the id so
    # OSDs trim clones asynchronously
    snap_seq: int = 0
    removed_snaps: list = field(default_factory=list)

    VERSION, COMPAT = 2, 1

    def encode(self, enc: Encoder) -> None:
        def body(e: Encoder):
            e.u64(self.pool_id)
            e.string(self.name)
            e.string(self.kind)
            e.u32(self.size)
            e.u32(self.min_size)
            e.u32(self.pg_num)
            e.mapping(self.ec_profile, Encoder.string, Encoder.string)
            e.u64(self.snap_seq)           # v2 tail
            e.seq(self.removed_snaps, Encoder.u64)
        enc.versioned(self.VERSION, self.COMPAT, body)

    @classmethod
    def decode(cls, dec: Decoder) -> "PoolSpec":
        def body(d: Decoder, v: int):
            p = cls(d.u64(), d.string(), d.string(), d.u32(), d.u32(),
                    d.u32(), d.mapping(Decoder.string, Decoder.string))
            if v >= 2:
                p.snap_seq = d.u64()
                p.removed_snaps = d.seq(Decoder.u64)
            return p
        return dec.versioned(cls.VERSION, body)


@dataclass
class OsdInfo(Encodable):
    osd_id: int
    up: bool = False
    in_cluster: bool = True
    weight: float = 1.0
    host: str = ""
    addr: str = ""     # data-plane messenger address
    hb_addr: str = ""  # heartbeat messenger address (v2 field)
    primary_affinity: float = 1.0  # v3: likelihood of leading (0..1)

    VERSION, COMPAT = 3, 1

    def encode(self, enc: Encoder) -> None:
        def body(e: Encoder):
            e.u32(self.osd_id)
            e.boolean(self.up)
            e.boolean(self.in_cluster)
            e.f64(self.weight)
            e.string(self.host)
            e.string(self.addr)
            e.string(self.hb_addr)  # v2: old decoders skip the tail
            e.f64(self.primary_affinity)  # v3 tail
        enc.versioned(self.VERSION, self.COMPAT, body)

    @classmethod
    def decode(cls, dec: Decoder) -> "OsdInfo":
        def body(d: Decoder, v: int):
            info = cls(d.u32(), d.boolean(), d.boolean(), d.f64(),
                       d.string(), d.string())
            if v >= 2:
                info.hb_addr = d.string()
            if v >= 3:
                info.primary_affinity = d.f64()
            return info
        return dec.versioned(cls.VERSION, body)


def _enc_pq_spec(e: Encoder, qid: int, spec: dict) -> None:
    """One perf-query spec on the wire (shared by the full map's v5
    tail and the incremental's v3 tail): explicit scalar fields, no
    pickled dicts."""
    e.u64(int(qid))
    e.seq([str(k) for k in spec.get("key_by", ())], Encoder.string)
    e.seq([str(c) for c in spec.get("counters", ())], Encoder.string)
    e.u32(int(spec.get("top_n", 32)))
    e.u32(int(spec.get("prefix_len", 8)))


def _dec_pq_spec(d: Decoder) -> tuple[int, dict]:
    qid = d.u64()
    return qid, {"qid": qid,
                 "key_by": d.seq(Decoder.string),
                 "counters": d.seq(Decoder.string),
                 "top_n": d.u32(),
                 "prefix_len": d.u32()}


class OSDMapIncremental(Encodable):
    """One epoch's worth of map change (OSDMap::Incremental,
    src/osd/OSDMap.h): changed records only, applied in epoch order."""

    VERSION, COMPAT = 3, 1

    def __init__(self, base_epoch: int = 0, new_epoch: int = 0):
        self.base_epoch = base_epoch
        self.new_epoch = new_epoch
        self.osds: list[OsdInfo] = []
        self.pools: list[PoolSpec] = []
        self.removed_pools: list[int] = []
        self.upmap_set: dict[tuple[int, int], list[int]] = {}
        self.upmap_rm: list[tuple[int, int]] = []
        self.pg_temp_set: dict[tuple[int, int], list[int]] = {}
        self.pg_temp_rm: list[tuple[int, int]] = []
        self.primary_temp_set: dict[tuple[int, int], int] = {}
        self.primary_temp_rm: list[tuple[int, int]] = []
        self.next_pool_id = 1
        # v2 tail: tenant QoS profile changes (qos/profiles.py)
        self.qos_set: dict[str, dict] = {}   # name -> {res, wgt, lim}
        self.qos_rm: list[str] = []
        # v3 tail: dynamic perf-query changes (telemetry/perf_query):
        # qid -> spec dict (PerfQuerySpec.to_dict shape)
        self.pq_set: dict[int, dict] = {}
        self.pq_rm: list[int] = []

    def encode(self, enc: Encoder) -> None:
        def kv_list(e, items, val_enc):
            e.seq(sorted(items),
                  lambda ee, kv: (ee.u64(kv[0][0]), ee.u64(kv[0][1]),
                                  val_enc(ee, kv[1])))

        def key_list(e, keys):
            e.seq(sorted(keys),
                  lambda ee, k: (ee.u64(k[0]), ee.u64(k[1])))

        def body(e: Encoder):
            e.u64(self.base_epoch)
            e.u64(self.new_epoch)
            e.seq(self.osds, lambda ee, o: o.encode(ee))
            e.seq(self.pools, lambda ee, p: p.encode(ee))
            e.seq(self.removed_pools, Encoder.u64)
            kv_list(e, self.upmap_set.items(),
                    lambda ee, v: ee.seq(v, Encoder.i64))
            key_list(e, self.upmap_rm)
            kv_list(e, self.pg_temp_set.items(),
                    lambda ee, v: ee.seq(v, Encoder.i64))
            key_list(e, self.pg_temp_rm)
            kv_list(e, self.primary_temp_set.items(),
                    lambda ee, v: ee.i64(v))
            key_list(e, self.primary_temp_rm)
            e.u64(self.next_pool_id)
            # v2 tail: tenant QoS profile deltas
            e.seq(sorted(self.qos_set.items()),
                  lambda ee, kv: (ee.string(kv[0]),
                                  ee.f64(float(kv[1].get("res", 0.0))),
                                  ee.f64(float(kv[1].get("wgt", 1.0))),
                                  ee.f64(float(kv[1].get("lim",
                                                         0.0)))))
            e.seq(sorted(self.qos_rm), Encoder.string)
            # v3 tail: perf-query deltas
            e.seq(sorted(self.pq_set.items()),
                  lambda ee, kv: _enc_pq_spec(ee, kv[0], kv[1]))
            e.seq(sorted(self.pq_rm), Encoder.u64)
        enc.versioned(self.VERSION, self.COMPAT, body)

    @classmethod
    def decode(cls, dec: Decoder) -> "OSDMapIncremental":
        def body(d: Decoder, v: int):
            inc = cls(d.u64(), d.u64())
            inc.osds = d.seq(OsdInfo.decode)
            inc.pools = d.seq(PoolSpec.decode)
            inc.removed_pools = d.seq(Decoder.u64)

            def kv_item(val_dec):
                def item(dd: Decoder):
                    return (dd.u64(), dd.u64()), val_dec(dd)
                return item

            def key_item(dd: Decoder):
                return (dd.u64(), dd.u64())

            inc.upmap_set = dict(d.seq(kv_item(
                lambda dd: dd.seq(Decoder.i64))))
            inc.upmap_rm = d.seq(key_item)
            inc.pg_temp_set = dict(d.seq(kv_item(
                lambda dd: dd.seq(Decoder.i64))))
            inc.pg_temp_rm = d.seq(key_item)
            inc.primary_temp_set = dict(d.seq(kv_item(Decoder.i64)))
            inc.primary_temp_rm = d.seq(key_item)
            inc.next_pool_id = d.u64()
            if v >= 2:
                def qos_item(dd: Decoder):
                    return dd.string(), {"res": dd.f64(),
                                         "wgt": dd.f64(),
                                         "lim": dd.f64()}
                inc.qos_set = dict(d.seq(qos_item))
                inc.qos_rm = d.seq(Decoder.string)
            if v >= 3:
                inc.pq_set = dict(d.seq(_dec_pq_spec))
                inc.pq_rm = d.seq(Decoder.u64)
            return inc
        return dec.versioned(cls.VERSION, body)


def apply_map_push(current, msg):
    """Shared receiver state machine for MMapPush (OSDs and clients):
    returns (newmap | None, request | None) where request asks the
    caller to re-subscribe — "full" (no map yet) or "chain" (gap:
    subscribe with have_epoch).  A receiver never mutates the map it
    adopts, so the new map is frozen: its placements are shared."""
    if msg.map_bytes:
        return OSDMap.decode_bytes(msg.map_bytes).freeze(), None
    if current is None:
        return None, "full"
    if current.epoch == msg.base_epoch:
        inc = OSDMapIncremental.decode_bytes(msg.inc_bytes)
        m = current.deepcopy()
        m.apply_incremental(inc)
        return m.freeze(), None
    if msg.epoch > current.epoch:
        return None, "chain"
    return None, None  # stale push: nothing to do


#: placements of frozen maps, shared by every holder of an equal map
#: in the process (the OSDs and clients of a cluster each decode their
#: own copy of every epoch): placement-input signature -> {(pool, seed,
#: ignore_temp): up set}, the newest _PLACEMENT_SIGS signatures kept.
#: The signature holds every input of pg_to_up_osds, so an entry is the
#: value the computation gives, whichever map or test put it there.
_PLACEMENT_SIGS = 16
_placements: collections.OrderedDict = collections.OrderedDict()
_placements_lock = threading.Lock()


def _placement_table(sig: tuple) -> dict:
    with _placements_lock:
        table = _placements.get(sig)
        if table is None:
            table = _placements[sig] = {}
            while len(_placements) > _PLACEMENT_SIGS:
                _placements.popitem(last=False)
        else:
            _placements.move_to_end(sig)
        return table


class OSDMap(Encodable):
    """Epoch-versioned cluster map; placement is a pure function of it."""

    VERSION, COMPAT = 5, 1

    def __init__(self):
        #: the shared placement table of a frozen map (freeze), None
        #: while the map may still change
        self._placed: dict | None = None
        self.epoch = 0
        self.osds: dict[int, OsdInfo] = {}
        self.pools: dict[int, PoolSpec] = {}
        self.next_pool_id = 1
        # tenant QoS profiles (qos/profiles.py grammar): name ->
        # {"res", "wgt", "lim"} in ops/s, distributed cluster-wide
        # like pool options — the mon commits `osd qos set-profile`
        # here, every OSD converges its scheduler on the next push
        self.qos_profiles: dict[str, dict] = {}
        # dynamic perf queries (telemetry/perf_query): qid -> spec
        # dict, distributed exactly like qos_profiles — the mon
        # commits `perf query add/rm`, every OSD converges its
        # PerfQuerySet on the next push
        self.perf_queries: dict[int, dict] = {}
        # explicit placement overrides (the pg_upmap/read-balancer
        # machinery, ref OSDMap.cc upmap handling): (pool, seed) -> osds
        self.pg_upmap: dict[tuple[int, int], list[int]] = {}
        # temporary acting-set overrides during backfill (the pg_temp /
        # primary_temp machinery, ref OSDMap.h pg_temp): a freshly
        # promoted-but-behind primary asks the mon to keep the caught-up
        # members serving until recovery lands (replicated pools; EC
        # keeps position-stable shards)
        self.pg_temp: dict[tuple[int, int], list[int]] = {}
        self.primary_temp: dict[tuple[int, int], int] = {}

    # -- mutation (monitor-side; bumps epoch through Monitor) --------------
    def freeze(self) -> "OSDMap":
        """Promise that this map no longer changes (a receiver's adopted
        map): its up sets are then computed once and shared with every
        frozen map of the same placement inputs.  The mutators below
        thaw it; a direct field write after freeze() breaks the promise.
        Returns the map."""
        sig = (tuple(sorted((o.osd_id, o.up, o.in_cluster, o.weight,
                             o.host, o.primary_affinity)
                            for o in self.osds.values())),
               tuple(sorted((p.pool_id, p.kind, p.size)
                            for p in self.pools.values())),
               tuple(sorted((k, tuple(v))
                            for k, v in self.pg_upmap.items())),
               tuple(sorted((k, tuple(v))
                            for k, v in self.pg_temp.items())),
               tuple(sorted(self.primary_temp.items())))
        self._placed = _placement_table(sig)
        return self

    def add_osd(self, osd_id: int, host: str, addr: str = "",
                weight: float = 1.0, hb_addr: str = "") -> None:
        self._placed = None
        self.osds[osd_id] = OsdInfo(osd_id, up=False, in_cluster=True,
                                    weight=weight, host=host, addr=addr,
                                    hb_addr=hb_addr)

    def mark_up(self, osd_id: int, addr: str = "",
                hb_addr: str = "") -> None:
        self._placed = None
        info = self.osds[osd_id]
        info.up = True
        if addr:
            info.addr = addr
        if hb_addr:
            info.hb_addr = hb_addr

    def mark_down(self, osd_id: int) -> None:
        self._placed = None
        if osd_id in self.osds:
            self.osds[osd_id].up = False

    def mark_out(self, osd_id: int) -> None:
        self._placed = None
        if osd_id in self.osds:
            self.osds[osd_id].in_cluster = False

    def add_pool(self, spec: PoolSpec) -> None:
        self._placed = None
        self.pools[spec.pool_id] = spec
        self.next_pool_id = max(self.next_pool_id, spec.pool_id + 1)

    # -- placement (client AND server evaluate this identically) ----------
    def placement(self) -> PlacementMap:
        pm = PlacementMap()
        for o in self.osds.values():
            if o.in_cluster:
                pm.add_device(o.osd_id, o.weight, o.host)
        return pm

    def pg_to_osds(self, pool_id: int, pg_seed: int) -> list[int]:
        """Raw placement: ordered device ids for this PG (the
        _pg_to_raw_osds step)."""
        pool = self.pools[pool_id]
        key = hash_combine("pg", pool_id, pg_seed)
        return self.placement().select(key, pool.size)

    def pg_to_up_osds(self, pool_id: int, pg_seed: int,
                      ignore_temp: bool = False) -> list[int]:
        """Acting set: raw placement with down devices re-drawn,
        honoring pg_temp/primary_temp and pg_upmap overrides and primary
        affinity (the up/acting derivation of
        OSDMap::_pg_to_up_acting_osds :3143).  ignore_temp=True yields
        the UP set — what the map would choose with no temp overrides
        (needed to decide when a pg_temp can clear).  For EC pools,
        positions are shard ids, so a down device leaves a hole (None)
        rather than shifting shards."""
        placed = self._placed
        if placed is None:
            return self._pg_to_up_osds(pool_id, pg_seed, ignore_temp)
        at = (pool_id, pg_seed, ignore_temp)
        up = placed.get(at)
        if up is None:
            up = placed[at] = tuple(
                self._pg_to_up_osds(pool_id, pg_seed, ignore_temp))
        return list(up)

    def _pg_to_up_osds(self, pool_id: int, pg_seed: int,
                       ignore_temp: bool) -> list[int]:
        pool = self.pools[pool_id]
        key = hash_combine("pg", pool_id, pg_seed)
        pm = self.placement()

        def down(dev_id: int) -> bool:
            o = self.osds.get(dev_id)
            return o is None or not o.up

        # pg_temp wins over everything for replicated pools: the acting
        # set the (behind) primary requested stays in charge until the
        # mon clears it (OSDMap::_get_temp_osds role)
        if pool.kind != "ec" and not ignore_temp:
            temp = self.pg_temp.get((pool_id, pg_seed))
            if temp:
                alive = [d for d in temp if not down(d)]
                if alive:
                    return self._apply_primary_temp(pool_id, pg_seed,
                                                    alive)
        override = self.pg_upmap.get((pool_id, pg_seed))
        if override is not None:
            # dead mapped members re-draw from healthy placement (the
            # reference prunes invalid upmaps on map change; pinning a
            # PG degraded behind a stale override would be worse)
            healthy = pm.select(key, pool.size, reject=down)
            spares = [d for d in healthy if d not in override]
            if pool.kind == "ec":
                out: list[int | None] = []
                for d in override:
                    if not down(d):
                        out.append(d)
                    else:
                        out.append(spares.pop(0) if spares else None)
                return out
            filled = [d for d in override if not down(d)]
            while len(filled) < pool.size and spares:
                filled.append(spares.pop(0))
            filled = self._apply_affinity(filled)
            return filled if ignore_temp else \
                self._apply_primary_temp(pool_id, pg_seed, filled)
        raw = pm.select(key, pool.size)
        if pool.kind == "ec":
            # keep shard positions stable; holes where devices are down
            healthy = pm.select(key, pool.size, reject=down)
            out: list[int | None] = []
            spares = [d for d in healthy if d not in raw]
            for d in raw:
                if not down(d):
                    out.append(d)
                else:
                    out.append(spares.pop(0) if spares else None)
            return out
        chosen = self._apply_affinity(pm.select(key, pool.size,
                                                reject=down))
        return chosen if ignore_temp else \
            self._apply_primary_temp(pool_id, pg_seed, chosen)

    def _apply_primary_temp(self, pool_id: int, pg_seed: int,
                            up: list[int]) -> list[int]:
        """primary_temp: rotate the designated member to the front
        (replicated pools; callers for EC never route through here)."""
        want = self.primary_temp.get((pool_id, pg_seed))
        if want is not None and want in up and up and up[0] != want:
            up = [want] + [d for d in up if d != want]
        return up

    def _apply_affinity(self, up: list[int]) -> list[int]:
        """Primary affinity (OSDMap primary-affinity role): rotate the
        member with the HIGHEST affinity to the front; equal affinities
        keep the placement order (so the default 1.0 changes nothing)."""
        if not up:
            return up
        best = max(up, key=lambda d: self.osds[d].primary_affinity
                   if d in self.osds else 0.0)
        if self.osds.get(best) is not None and \
                self.osds[best].primary_affinity > \
                self.osds[up[0]].primary_affinity:
            up = [best] + [d for d in up if d != best]
        return up

    def object_to_pg(self, pool_id: int, name: str) -> int:
        return pg_of_object(name, self.pools[pool_id].pg_num)

    # -- incrementals ------------------------------------------------------
    def diff_from(self, old: "OSDMap") -> "OSDMapIncremental":
        """Build the incremental old -> self (OSDMap::Incremental role).
        Whole changed records travel (OsdInfo/PoolSpec are small); the
        win is not resending the unchanged bulk of a large map."""
        inc = OSDMapIncremental(old.epoch, self.epoch)
        for oid_, info in self.osds.items():
            if old.osds.get(oid_) != info:
                inc.osds.append(info)
        for pid, pool in self.pools.items():
            if old.pools.get(pid) != pool:
                inc.pools.append(pool)
        inc.removed_pools = [p for p in old.pools if p not in self.pools]
        for k, v in self.pg_upmap.items():
            if old.pg_upmap.get(k) != v:
                inc.upmap_set[k] = v
        inc.upmap_rm = [k for k in old.pg_upmap if k not in self.pg_upmap]
        for k, v in self.pg_temp.items():
            if old.pg_temp.get(k) != v:
                inc.pg_temp_set[k] = v
        inc.pg_temp_rm = [k for k in old.pg_temp if k not in self.pg_temp]
        for k, v in self.primary_temp.items():
            if old.primary_temp.get(k) != v:
                inc.primary_temp_set[k] = v
        inc.primary_temp_rm = [k for k in old.primary_temp
                               if k not in self.primary_temp]
        inc.next_pool_id = self.next_pool_id
        for name, prof in self.qos_profiles.items():
            if old.qos_profiles.get(name) != prof:
                inc.qos_set[name] = dict(prof)
        inc.qos_rm = [n for n in old.qos_profiles
                      if n not in self.qos_profiles]
        for qid, spec in self.perf_queries.items():
            if old.perf_queries.get(qid) != spec:
                inc.pq_set[qid] = dict(spec)
        inc.pq_rm = [q for q in old.perf_queries
                     if q not in self.perf_queries]
        return inc

    def apply_incremental(self, inc: "OSDMapIncremental") -> None:
        """Mutate this map by one incremental; caller must have checked
        inc.base_epoch == self.epoch."""
        if inc.base_epoch != self.epoch:
            raise ValueError(
                f"inc base {inc.base_epoch} != epoch {self.epoch}")
        self._placed = None
        for info in inc.osds:
            self.osds[info.osd_id] = info
        for pool in inc.pools:
            self.pools[pool.pool_id] = pool
        for pid in inc.removed_pools:
            self.pools.pop(pid, None)
        self.pg_upmap.update(inc.upmap_set)
        for k in inc.upmap_rm:
            self.pg_upmap.pop(k, None)
        self.pg_temp.update(inc.pg_temp_set)
        for k in inc.pg_temp_rm:
            self.pg_temp.pop(k, None)
        self.primary_temp.update(inc.primary_temp_set)
        for k in inc.primary_temp_rm:
            self.primary_temp.pop(k, None)
        self.next_pool_id = inc.next_pool_id
        for name, prof in getattr(inc, "qos_set", {}).items():
            self.qos_profiles[name] = dict(prof)
        for name in getattr(inc, "qos_rm", ()):
            self.qos_profiles.pop(name, None)
        for qid, spec in getattr(inc, "pq_set", {}).items():
            self.perf_queries[qid] = dict(spec)
        for qid in getattr(inc, "pq_rm", ()):
            self.perf_queries.pop(qid, None)
        self.epoch = inc.new_epoch

    def up_osds(self) -> list[int]:
        return sorted(o.osd_id for o in self.osds.values() if o.up)

    def deepcopy(self) -> "OSDMap":
        """A thawed copy (the shared placement table is not copied)."""
        placed, self._placed = self._placed, None
        try:
            return copy.deepcopy(self)
        finally:
            self._placed = placed

    # -- encoding ----------------------------------------------------------
    def encode(self, enc: Encoder) -> None:
        def body(e: Encoder):
            e.u64(self.epoch)
            e.seq(sorted(self.osds.values(), key=lambda o: o.osd_id),
                  lambda ee, o: o.encode(ee))
            e.seq(sorted(self.pools.values(), key=lambda p: p.pool_id),
                  lambda ee, p: p.encode(ee))
            e.u64(self.next_pool_id)
            # v2 tail: upmap overrides
            e.seq(sorted(self.pg_upmap.items()),
                  lambda ee, kv: (ee.u64(kv[0][0]), ee.u64(kv[0][1]),
                                  ee.seq(kv[1], Encoder.i64)))
            # v3 tail: temp acting overrides
            e.seq(sorted(self.pg_temp.items()),
                  lambda ee, kv: (ee.u64(kv[0][0]), ee.u64(kv[0][1]),
                                  ee.seq(kv[1], Encoder.i64)))
            e.seq(sorted(self.primary_temp.items()),
                  lambda ee, kv: (ee.u64(kv[0][0]), ee.u64(kv[0][1]),
                                  ee.i64(kv[1])))
            # v4 tail: tenant QoS profiles
            e.seq(sorted(self.qos_profiles.items()),
                  lambda ee, kv: (ee.string(kv[0]),
                                  ee.f64(float(kv[1].get("res", 0.0))),
                                  ee.f64(float(kv[1].get("wgt", 1.0))),
                                  ee.f64(float(kv[1].get("lim",
                                                         0.0)))))
            # v5 tail: dynamic perf queries
            e.seq(sorted(self.perf_queries.items()),
                  lambda ee, kv: _enc_pq_spec(ee, kv[0], kv[1]))
        enc.versioned(self.VERSION, self.COMPAT, body)

    @classmethod
    def decode(cls, dec: Decoder) -> "OSDMap":
        def body(d: Decoder, v: int):
            m = cls()
            m.epoch = d.u64()
            for o in d.seq(OsdInfo.decode):
                m.osds[o.osd_id] = o
            for p in d.seq(PoolSpec.decode):
                m.pools[p.pool_id] = p
            m.next_pool_id = d.u64()
            if v >= 2:
                def upmap_item(dd: Decoder):
                    pool, seed = dd.u64(), dd.u64()
                    return (pool, seed), dd.seq(Decoder.i64)
                for k, vlist in d.seq(upmap_item):
                    m.pg_upmap[k] = vlist
            if v >= 3:
                for k, vlist in d.seq(upmap_item):
                    m.pg_temp[k] = vlist

                def ptemp_item(dd: Decoder):
                    pool, seed = dd.u64(), dd.u64()
                    return (pool, seed), dd.i64()
                for k, who in d.seq(ptemp_item):
                    m.primary_temp[k] = who
            if v >= 4:
                def qos_item(dd: Decoder):
                    return dd.string(), {"res": dd.f64(),
                                         "wgt": dd.f64(),
                                         "lim": dd.f64()}
                for name, prof in d.seq(qos_item):
                    m.qos_profiles[name] = prof
            if v >= 5:
                for qid, spec in d.seq(_dec_pq_spec):
                    m.perf_queries[qid] = spec
            return m
        return dec.versioned(cls.VERSION, body)
