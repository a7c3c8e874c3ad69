"""Typed configuration from a single option schema.

The capability of the reference's config system (src/common/config.cc +
options/*.yaml.in codegen + md_config_obs_t observers — SURVEY.md §2.2 and
§5 Config/flags): one declarative schema source produces typed accessors,
validation, self-documentation, and runtime-change observers.  Here the
schema source is Python Option declarations (the yaml->codegen step
collapses away); layering is defaults < file < env < runtime overrides,
mirroring ceph.conf < env < cli < admin-socket.
"""

from __future__ import annotations

import enum
import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterable


class OptionLevel(enum.Enum):
    BASIC = "basic"
    ADVANCED = "advanced"
    DEV = "dev"


class ConfigError(Exception):
    pass


@dataclass(frozen=True)
class Option:
    """One typed option (the reference's Option yaml entry)."""

    name: str
    type: type  # int | float | bool | str
    default: Any
    level: OptionLevel = OptionLevel.ADVANCED
    desc: str = ""
    min: Any = None
    max: Any = None
    enum_values: tuple = ()
    see_also: tuple = ()
    startup: bool = False  # cannot change at runtime (flags: [startup])

    def validate(self, value: Any) -> Any:
        try:
            if self.type is bool and isinstance(value, str):
                if value.lower() in ("true", "1", "yes", "on"):
                    value = True
                elif value.lower() in ("false", "0", "no", "off"):
                    value = False
                else:
                    raise ValueError(value)
            else:
                value = self.type(value)
        except (TypeError, ValueError) as e:
            raise ConfigError(
                f"{self.name}: {value!r} is not {self.type.__name__}") from e
        if self.min is not None and value < self.min:
            raise ConfigError(f"{self.name}: {value} < min {self.min}")
        if self.max is not None and value > self.max:
            raise ConfigError(f"{self.name}: {value} > max {self.max}")
        if self.enum_values and value not in self.enum_values:
            raise ConfigError(
                f"{self.name}: {value!r} not in {self.enum_values}")
        return value


class Config:
    """Typed config instance over a schema (md_config_t + config_proxy)."""

    def __init__(self, schema: Iterable[Option]):
        self._schema: dict[str, Option] = {o.name: o for o in schema}
        self._values: dict[str, Any] = {}
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}
        self._lock = threading.RLock()
        self._started = False

    # -- access ------------------------------------------------------------
    def get(self, name: str) -> Any:
        opt = self._opt(name)
        with self._lock:
            return self._values.get(name, opt.default)

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def set(self, name: str, value: Any) -> None:
        opt = self._opt(name)
        value = opt.validate(value)
        with self._lock:
            if self._started and opt.startup:
                raise ConfigError(f"{name} can only be set at startup")
            self._values[name] = value
            observers = list(self._observers.get(name, ()))
        for cb in observers:
            cb(name, value)

    def mark_started(self) -> None:
        """After this, startup-flagged options are frozen."""
        self._started = True

    # -- bulk layers -------------------------------------------------------
    def apply_dict(self, values: dict[str, Any]) -> None:
        for k, v in values.items():
            self.set(k, v)

    def apply_env(self, prefix: str = "CEPH_TPU_") -> None:
        for k, v in os.environ.items():
            if k.startswith(prefix):
                name = k[len(prefix):].lower()
                if name in self._schema:
                    self.set(name, v)

    def apply_file(self, path: str) -> None:
        """JSON config file ({"option": value, ...})."""
        with open(path) as f:
            self.apply_dict(json.load(f))

    # -- observers (md_config_obs_t) ---------------------------------------
    def observe(self, name: str, cb: Callable[[str, Any], None]) -> None:
        self._opt(name)
        with self._lock:
            self._observers.setdefault(name, []).append(cb)

    # -- introspection (`config help`) -------------------------------------
    def help(self, name: str) -> dict:
        o = self._opt(name)
        return {
            "name": o.name, "type": o.type.__name__, "default": o.default,
            "level": o.level.value, "desc": o.desc, "min": o.min,
            "max": o.max, "enum_values": list(o.enum_values),
            "see_also": list(o.see_also), "startup": o.startup,
            "current": self.get(name),
        }

    def dump(self) -> dict[str, Any]:
        with self._lock:
            return {n: self._values.get(n, o.default)
                    for n, o in sorted(self._schema.items())}

    def schema(self) -> dict[str, Option]:
        return dict(self._schema)

    def _opt(self, name: str) -> Option:
        opt = self._schema.get(name)
        if opt is None:
            raise ConfigError(f"unknown option {name!r}")
        return opt


# ---------------------------------------------------------------------------
# The framework's option schema (the options/*.yaml.in equivalent).
# Components extend this list as they land.
# ---------------------------------------------------------------------------

OPTIONS: list[Option] = [
    Option("ec_plugin", str, "tpu", OptionLevel.BASIC,
           "default erasure-code plugin for new pools",
           enum_values=("tpu", "jerasure", "isa", "xor", "lrc", "shec",
                        "clay")),
    Option("ec_backend", str, "torch", OptionLevel.ADVANCED,
           "region math backend", enum_values=("auto", "native", "numpy",
                                               "torch")),
    Option("osd_pool_default_size", int, 3, OptionLevel.BASIC,
           "default replica count", min=1, max=32),
    Option("osd_pool_default_pg_num", int, 32, OptionLevel.BASIC,
           "default PG count per pool", min=1, max=65536),
    Option("osd_heartbeat_interval", float, 0.5, OptionLevel.ADVANCED,
           "seconds between peer heartbeats", min=0.01, max=60.0),
    Option("osd_heartbeat_grace", float, 3.0, OptionLevel.ADVANCED,
           "base grace before reporting a peer down", min=0.1, max=600.0),
    Option("mon_osd_min_down_reporters", int, 2, OptionLevel.ADVANCED,
           "distinct reporters required to mark an osd down", min=1),
    Option("mon_election_strategy", str, "connectivity",
           OptionLevel.ADVANCED,
           "elector strategy: classic (log/rank only) or connectivity "
           "(prefer candidates that can see the cluster — the "
           "ConnectionTracker scoring, src/mon/ElectionLogic)",
           enum_values=("classic", "connectivity")),
    Option("osd_op_num_shards", int, 4, OptionLevel.ADVANCED,
           "op scheduler shard queues per osd", min=1, max=64),
    Option("osd_client_message_cap", int, 256, OptionLevel.ADVANCED,
           "max in-flight client messages per osd (throttle)", min=1),
    Option("log_level", int, 1, OptionLevel.BASIC,
           "default log verbosity", min=-1, max=20),
    Option("log_recent_size", int, 10000, OptionLevel.DEV,
           "ring size of recent log entries kept for crash dump", min=100,
           startup=True),
    Option("ec_stripe_batch", int, 64, OptionLevel.ADVANCED,
           "stripes batched per device EC launch", min=1, max=4096),
    Option("ec_batch", str, "auto", OptionLevel.ADVANCED,
           "cross-op EC batching (ec/batcher.py): coalesce concurrent "
           "same-signature stripe encodes/decodes into one folded kernel "
           "launch; auto engages on the torch backend (the card) only "
           "(per-op pool "
           "override via ec profile key 'batch')",
           enum_values=("auto", "on", "off")),
    Option("ec_batch_window_us", float, 500.0, OptionLevel.ADVANCED,
           "max microseconds an EC op waits to coalesce with concurrent "
           "stripe work (0 = pass-through: per-op launches, bit-identical "
           "to the unbatched path)", min=0.0, max=1_000_000.0,
           see_also=("ec_batch", "ec_batch_max_bytes")),
    Option("ec_batch_max_bytes", int, 8 << 20, OptionLevel.ADVANCED,
           "pending source bytes per EC batch signature that force an "
           "immediate size-flush before the window expires", min=4096,
           see_also=("ec_batch", "ec_batch_window_us")),
    Option("ec_shard", str, "auto", OptionLevel.ADVANCED,
           "device fan-out for folded EC batch launches: a flushed "
           "batch's (k, sum L) tensor shards its length axis across "
           "a flat mesh of the codec's devices, each running the CUDA "
           "kernel on its column slice on a stream of its own "
           "(parallel/distributed.make_folded_matmul). 'auto' uses "
           "every card and one device on the CPU; 'off' pins "
           "single-device; an integer N caps the fan-out (clamped to "
           "the device count: the cards, or the logical devices "
           "parallel.mesh.force_devices sets on one). Per-pool "
           "override via ec profile key 'shard'",
           see_also=("ec_batch",)),
    Option("ec_kernel", str, "auto", OptionLevel.ADVANCED,
           "GF(2^8) region-kernel realization for torch-backend EC "
           "pools (ops/ec_kernels.KERNELS: xla the plain version, CPU "
           "only; pallas the bit-term CUDA kernel, mxu the GF(2) "
           "bit-matrix product on the tensor cores, bitxor "
           "XOR-scheduled GF(2) bitplanes).  'auto' lets the runtime "
           "tuner decide per (matrix, shape-bucket) signature: on "
           "the card the first launches race the viable "
           "candidates and pin the winner (dump_kernel_profile shows "
           "the pick); on CPU the pick pins deterministically (no "
           "wall-clock flapping in CI).  An explicit name pins that "
           "kernel everywhere, falling through with a booked "
           "ec_kernel_pick_skip when unsupported (mxu on k > 32, "
           "xla on the card) instead of raising.  Per-pool override "
           "via ec profile key 'kernel'",
           enum_values=("auto", "xla", "pallas", "mxu", "bitxor"),
           see_also=("ec_shard", "ec_batch")),
    Option("ec_batch_adaptive", str, "on", OptionLevel.ADVANCED,
           "resize the coalescing window from the observed "
           "ops-per-launch (EWMA toward ec_batch_target_ops, clamped "
           "to [ec_batch_window_min_us, ec_batch_window_max_us]): a "
           "trickle shrinks the window toward the floor instead of "
           "paying ec_batch_window_us as pure latency, a burst grows "
           "it to coalesce more.  ec_batch_window_us=0 still means "
           "pass-through", enum_values=("on", "off"),
           see_also=("ec_batch", "ec_batch_window_us")),
    Option("ec_batch_target_ops", float, 4.0, OptionLevel.ADVANCED,
           "ops-per-launch the adaptive window steers toward (floor 2: "
           "a 1-op target would make every flush 'enough' and pin the "
           "window at the ceiling)",
           min=2.0, max=4096.0, see_also=("ec_batch_adaptive",)),
    Option("ec_batch_window_min_us", float, 50.0, OptionLevel.ADVANCED,
           "adaptive-window floor (microseconds)", min=1.0,
           max=1_000_000.0, see_also=("ec_batch_adaptive",)),
    Option("ec_batch_window_max_us", float, 4000.0, OptionLevel.ADVANCED,
           "adaptive-window ceiling (microseconds)", min=1.0,
           max=1_000_000.0, see_also=("ec_batch_adaptive",)),
    Option("ec_read_cache_serve", str, "on", OptionLevel.ADVANCED,
           "serve whole client EC reads from the primary's extent "
           "cache when every data shard's rows are cached at a known "
           "version (the device-resident stripe plane's hot-read "
           "path): no store or wire fan-out, byte-identical to the "
           "store path under the cache invalidation contract.  'off' "
           "always fans reads out (the read-pipeline tests do this to "
           "exercise the sub-read aggregator)",
           enum_values=("on", "off"), see_also=("ec_arena_max_bytes",)),
    Option("ec_arena_max_bytes", int, 64 << 20, OptionLevel.ADVANCED,
           "HBM byte budget of the per-OSD device arena backing the "
           "device-resident stripe plane (ec/arena.py): extent-cache "
           "runs staged to the device stay resident under this budget "
           "and evict LRU beyond it.  Eviction drops only the device "
           "copy — the host extent cache re-stages on the next device "
           "read, so an undersized arena degrades to per-op staging "
           "instead of losing bytes", min=1 << 20,
           see_also=("ec_batch",)),
    Option("ec_read_coalesce", str, "auto", OptionLevel.ADVANCED,
           "coalesce the EC read fan-out: concurrent MSubReads headed "
           "to the same peer OSD merge into one MSubReadN wire message "
           "within a small window, duplicate in-flight shard fetches "
           "collapse onto one wire read, and overlapping extents of "
           "one hot shard object merge into a union range.  'auto' "
           "engages under the sharded mclock scheduler (fifo runs "
           "client ops inline on one dispatch thread, but reads fan "
           "out async so bursts still overlap — auto stays "
           "conservative); per-pool override via ec profile key "
           "'read_coalesce'", enum_values=("auto", "on", "off"),
           see_also=("ec_read_window_us", "ec_read_max_items")),
    Option("ec_read_window_us", float, 150.0, OptionLevel.ADVANCED,
           "microseconds the sub-read aggregator holds a peer's first "
           "queued fetch open for company before flushing the "
           "MSubReadN (0 = pass-through: one MSubRead per shard per "
           "op, bit-identical to the unbatched read path)",
           min=0.0, max=1_000_000.0, see_also=("ec_read_coalesce",)),
    Option("ec_read_max_items", int, 64, OptionLevel.ADVANCED,
           "wire fetches queued per peer that force an immediate "
           "MSubReadN flush before the window expires", min=1,
           max=65536, see_also=("ec_read_coalesce",)),
    Option("ec_read_tier", str, "on", OptionLevel.ADVANCED,
           "hot-read tier: admit whole-object client EC reads into the "
           "extent cache (and through it the device arena) on their "
           "SECOND read within the admission window — zipf-aware "
           "second-hit promotion, so a one-pass scan never admits — "
           "letting later reads assemble from cache/HBM via "
           "ec_read_cache_serve without a store or wire fan-out",
           enum_values=("on", "off"),
           see_also=("ec_read_cache_serve", "ec_read_tier_seen_cap")),
    Option("ec_read_tier_seen_cap", int, 4096, OptionLevel.ADVANCED,
           "objects remembered by the hot-read tier's first-hit LRU "
           "(the admission window: a re-read after eviction from this "
           "window counts as a first hit again)", min=16,
           max=1 << 20, see_also=("ec_read_tier",)),
    Option("osd_read_lease_ttl", float, 2.0, OptionLevel.ADVANCED,
           "seconds a client read lease stays valid (0 disables lease "
           "grants).  A client holding a lease serves repeat reads of "
           "the object from its local cache — zero RADOS ops — until "
           "a write-revoke notify or expiry; a client that misses the "
           "revoke serves at most this many seconds of staleness, "
           "never a torn read", min=0.0, max=300.0,
           see_also=("osd_read_lease_rate",)),
    Option("osd_read_lease_rate", float, 10.0, OptionLevel.ADVANCED,
           "per-object read rate (reads/s, EWMA) above which the "
           "serving OSD starts granting read leases — leases only pay "
           "off on objects hot enough to be re-read within the TTL",
           min=0.0, see_also=("osd_read_lease_ttl",)),
    Option("osd_ec_stripe_unit", int, 4096, OptionLevel.ADVANCED,
           "EC chunk size (bytes per shard per stripe row); must be a "
           "multiple of 4096 (the EC_ALIGN_SIZE page-alignment contract, "
           "ref ECUtil.h:33)", min=4096),
    # -- object-store commit pipeline (the BlueStore kv-sync/finisher
    # group commit: queue_transaction returns after the in-RAM apply,
    # a per-store kv-sync thread batches WAL appends behind ONE fsync,
    # and on_commit callbacks fire from a finisher in submission order)
    Option("store_sync_commit", str, "off", OptionLevel.ADVANCED,
           "'on' pins the pre-pipeline inline behavior: every "
           "queue_transaction stages, fsyncs and fires on_commit in "
           "the caller's thread (strict interleaving for scrub-heavy "
           "or crash-bisection runs); 'off' engages the async group-"
           "commit pipeline", enum_values=("on", "off"), startup=True,
           see_also=("store_throttle_bytes", "store_batch_window_us")),
    Option("store_throttle_bytes", int, 64 << 20, OptionLevel.ADVANCED,
           "admission throttle: bytes of transactions in flight in the "
           "commit pipeline before submitters block (BlueStore "
           "throttle_bytes role — backpressure instead of unbounded "
           "queue growth; also bounds how long by-reference wire "
           "payloads stay pinned)", min=1 << 20,
           see_also=("store_throttle_ops",)),
    Option("store_throttle_ops", int, 1024, OptionLevel.ADVANCED,
           "admission throttle: transactions in flight in the commit "
           "pipeline before submitters block", min=1,
           see_also=("store_throttle_bytes",)),
    Option("store_batch_window_us", float, 0.0, OptionLevel.ADVANCED,
           "initial extra coalescing delay before the kv-sync thread "
           "cuts a batch: 0 = pure self-clocking (txns arriving during "
           "the previous commit's fsync form the next batch — zero "
           "added latency); store_batch_adaptive steers it from there",
           min=0.0, see_also=("store_batch_adaptive",
                              "store_batch_window_max_us")),
    Option("store_batch_adaptive", str, "on", OptionLevel.ADVANCED,
           "EWMA window steering toward store_batch_target_txns per "
           "fsync: grows only while batches show real concurrency "
           "(and never past a few commit durations), decays to 0 for "
           "sequential writers so closed-loop latency never pays for "
           "coalescing that cannot happen",
           enum_values=("on", "off"),
           see_also=("store_batch_target_txns",)),
    Option("store_batch_target_txns", float, 8.0, OptionLevel.ADVANCED,
           "adaptive window target: transactions per group commit",
           min=1.0, see_also=("store_batch_adaptive",)),
    Option("store_batch_window_min_us", float, 50.0,
           OptionLevel.ADVANCED,
           "adaptive window growth seed (first nonzero window size)",
           min=1.0),
    Option("store_batch_window_max_us", float, 4000.0,
           OptionLevel.ADVANCED,
           "the max-latency clamp: the batch window never exceeds "
           "this, so an idle or trickle-load store still commits (and "
           "acks) promptly", min=10.0),
    # -- BlueStore metadata KV tier (osd/kvstore.py + osd/sstkv.py):
    # the RocksDBStore slot — backend choice + LSM maintenance knobs
    Option("kv_backend", str, "wal", OptionLevel.ADVANCED,
           "BlueStore metadata KeyValueDB backend: 'wal' (snapshot-"
           "compacting log) or 'sst' (leveled LSM: WAL-backed "
           "memtables seal and flush to L0 in the background, a "
           "compaction thread streams levels together, reads ride an "
           "atomically-swapped snapshot + shared block cache — the "
           "RocksDB-tier path)", enum_values=("wal", "sst"),
           startup=True,
           see_also=("kv_memtable_bytes", "kv_bg_maintenance")),
    Option("kv_memtable_bytes", int, 256 * 1024, OptionLevel.ADVANCED,
           "sst backend: memtable bytes before it seals into an "
           "immutable memtable and a fresh WAL segment opens "
           "(write_buffer_size role)", min=4096,
           see_also=("kv_backend",)),
    Option("kv_cache_bytes", int, 8 << 20, OptionLevel.ADVANCED,
           "sst backend: byte budget of the LRU block cache shared "
           "across every sorted table of one store (parsed data "
           "blocks; bloom filters + sparse indexes stay resident "
           "regardless).  0 disables caching", min=0,
           see_also=("kv_backend",)),
    Option("kv_bg_maintenance", str, "on", OptionLevel.ADVANCED,
           "'on' runs LSM flushes/compactions (and the wal backend's "
           "snapshot compaction) on background threads with counted "
           "write-stall backpressure (kv_stall_*); 'off' pins the "
           "inline path — every maintenance wall lands in the "
           "submitting thread (the kv-sync thread under the async "
           "commit pipeline), the cliff the kv_maint bench leg "
           "measures", enum_values=("on", "off"), startup=True,
           see_also=("kv_backend", "store_sync_commit")),
    Option("osd_op_timeout", float, 5.0, OptionLevel.ADVANCED,
           "seconds before an in-flight op whose sub-ops never completed "
           "is failed back to the client", min=0.1, max=3600.0,
           see_also=("osd_heartbeat_grace",)),
    Option("osd_op_complaint_time", float, 5.0, OptionLevel.ADVANCED,
           "seconds before an op counts as slow (OpTracker complaint "
           "threshold): in-flight ops past it surface in dump_slow_ops, "
           "the mon's HEALTH_WARN SLOW_OPS mux and the exporter's "
           "daemon_slow_ops", min=0.001, max=3600.0,
           see_also=("osd_op_timeout", "osd_op_history_size")),
    Option("osd_op_history_size", int, 256, OptionLevel.ADVANCED,
           "completed ops retained per OSD for dump_historic_ops / "
           "dump_historic_slow_ops", min=1, max=65536,
           see_also=("osd_op_complaint_time",)),
    Option("osd_op_queue", str, "mclock", OptionLevel.ADVANCED,
           "op scheduler: mclock (QoS classes) or fifo (inline dispatch)",
           enum_values=("mclock", "fifo"), startup=True),
    # mClock class parameters (reservation ops/s, weight, limit ops/s;
    # 0 = none/unlimited) — the mClockScheduler client vs background
    # recovery vs scrub QoS knobs
    Option("osd_mclock_client_res", float, 100.0, OptionLevel.ADVANCED,
           "client op reservation (ops/s)", min=0.0),
    Option("osd_mclock_client_wgt", float, 10.0, OptionLevel.ADVANCED,
           "client op weight", min=0.001),
    Option("osd_mclock_client_lim", float, 0.0, OptionLevel.ADVANCED,
           "client op limit (ops/s; 0 unlimited)", min=0.0),
    Option("osd_mclock_recovery_res", float, 20.0, OptionLevel.ADVANCED,
           "background recovery reservation (ops/s)", min=0.0),
    Option("osd_mclock_recovery_wgt", float, 2.0, OptionLevel.ADVANCED,
           "background recovery weight", min=0.001),
    Option("osd_mclock_recovery_lim", float, 0.0, OptionLevel.ADVANCED,
           "background recovery limit (ops/s; 0 unlimited)", min=0.0),
    Option("osd_mclock_scrub_res", float, 5.0, OptionLevel.ADVANCED,
           "scrub reservation (ops/s)", min=0.0),
    Option("osd_mclock_scrub_wgt", float, 1.0, OptionLevel.ADVANCED,
           "scrub weight", min=0.001),
    Option("osd_mclock_scrub_lim", float, 0.0, OptionLevel.ADVANCED,
           "scrub limit (ops/s; 0 unlimited)", min=0.0),
    # continuous folded deep scrub (osd/scrub.py auto-scrub scheduler)
    Option("osd_scrub_auto", bool, True, OptionLevel.BASIC,
           "background deep-scrub scheduler: each OSD continuously "
           "re-verifies its own stored shard bytes per PG in folded "
           "CRC launches (ec/verify.py through the batching seam), "
           "under the scrub mclock class",
           see_also=("osd_scrub_min_interval",
                     "osd_scrub_max_interval")),
    Option("osd_scrub_min_interval", float, 86400.0,
           OptionLevel.BASIC,
           "seconds between deep-scrub passes of one PG (a pass ends "
           "when the cursor wraps); the default keeps short-lived "
           "test clusters quiet — deployments tune it down",
           min=0.0, max=30 * 86400.0),
    Option("osd_scrub_max_interval", float, 7 * 86400.0,
           OptionLevel.ADVANCED,
           "hard deadline: a PG whose last pass finished longer ago "
           "than this scrubs next regardless of load ordering",
           min=0.0, max=365 * 86400.0),
    Option("osd_scrub_chunk_max", int, 25, OptionLevel.ADVANCED,
           "objects verified per scrub chunk (one scheduler grant / "
           "one cursor advance; ref osd_scrub_chunk_max)",
           min=1, max=4096),
    Option("osd_scrub_fold", str, "auto", OptionLevel.ADVANCED,
           "folded-verify backend: auto (the CRC32C kernel on the "
           "card, one native C sweep per launch on CPU hosts), device "
           "(force the torch path — its plain version on a CPU "
           "tensor), native (force the host sweep)",
           enum_values=("auto", "device", "native")),
    # inline store compression defaults (per-pool options override;
    # reference BlueStore bluestore_compression_* semantics)
    Option("osd_compression_mode", str, "none", OptionLevel.BASIC,
           "default pool compression mode: none, passive (compress "
           "only hinted/whole-object writes), aggressive (compress "
           "everything compressible)",
           enum_values=("none", "passive", "aggressive")),
    Option("osd_compression_algorithm", str, "czlib",
           OptionLevel.BASIC,
           "default pool compression algorithm (compress/registry.py "
           "plugin name)"),
    Option("osd_compression_required_ratio", float, 0.875,
           OptionLevel.ADVANCED,
           "store the compressed blob only when compressed/raw <= "
           "this ratio; otherwise the raw bytes land and reads pay "
           "nothing", min=0.0, max=1.0),
    Option("osd_compression_min_blob_size", int, 4096,
           OptionLevel.ADVANCED,
           "blobs smaller than this never compress (header-dominated "
           "wins are noise)", min=0, max=1 << 30),
    # multi-tenant QoS (qos/): per-tenant dmclock sub-queues under the
    # client class + the adaptive recovery-reservation controller
    Option("osd_qos_max_tenants", int, 64, OptionLevel.ADVANCED,
           "tenant sub-queues (and per-tenant counter series) one "
           "scheduler shard keeps: beyond it, idle tenants evict LRU "
           "and new tenants' counters fold into the default-profile "
           "series — bounded exporter cardinality under tenant churn",
           min=1, max=65536),
    Option("qos_controller", str, "off", OptionLevel.ADVANCED,
           "adaptive recovery-reservation controller (mgr qos "
           "module): reads windowed client p99 queue-wait vs recovery "
           "backlog from metrics_query and retunes "
           "osd_mclock_recovery_{res,lim} live via reset_mclock — "
           "AIMD with hysteresis, every retune journaled as a `qos` "
           "cluster event", enum_values=("on", "off"),
           see_also=("osd_mclock_recovery_res",)),
    Option("qos_controller_window_s", float, 3.0, OptionLevel.ADVANCED,
           "metrics_query window the controller senses client p99 "
           "queue-wait over", min=0.5, max=600.0,
           see_also=("qos_controller",)),
    Option("qos_controller_step", float, 8.0, OptionLevel.ADVANCED,
           "additive reservation increase per grow move (ops/s)",
           min=0.1, see_also=("qos_controller",)),
    Option("qos_controller_backoff", float, 0.5, OptionLevel.ADVANCED,
           "multiplicative reservation decrease factor per backoff "
           "move", min=0.05, max=0.95, see_also=("qos_controller",)),
    Option("qos_controller_p99_low_ms", float, 20.0,
           OptionLevel.ADVANCED,
           "client p99 queue-wait below which recovery may grow "
           "(milliseconds)", min=0.1, see_also=("qos_controller",)),
    Option("qos_controller_p99_high_ms", float, 100.0,
           OptionLevel.ADVANCED,
           "client p99 queue-wait above which recovery backs off "
           "(milliseconds; the hysteresis band's top)", min=0.1,
           see_also=("qos_controller_p99_low_ms",)),
    Option("qos_controller_hold_ticks", int, 2, OptionLevel.ADVANCED,
           "consecutive ticks a condition must hold before the "
           "controller acts (hysteresis)", min=1, max=100,
           see_also=("qos_controller",)),
    Option("qos_controller_cooldown_ticks", int, 2,
           OptionLevel.ADVANCED,
           "ticks of silence after every applied retune", min=0,
           max=100, see_also=("qos_controller",)),
    Option("qos_controller_sense", str, "p99", OptionLevel.ADVANCED,
           "what the controller senses: 'p99' = raw client p99 "
           "queue-wait vs the watermark band; 'slo' = the slo "
           "module's fast-window error-budget burn (needs "
           "slo_objectives set) — backoff above "
           "qos_controller_burn_high, grow below "
           "qos_controller_burn_low, retunes journaled with the burn "
           "value", enum_values=("p99", "slo"),
           see_also=("qos_controller", "slo_objectives")),
    Option("qos_controller_burn_high", float, 2.0, OptionLevel.ADVANCED,
           "slo-sense: fast-window burn multiple above which recovery "
           "backs off (burn 1.0 = spending the error budget exactly)",
           min=0.1, max=1e6, see_also=("qos_controller_sense",)),
    Option("qos_controller_burn_low", float, 0.5, OptionLevel.ADVANCED,
           "slo-sense: fast-window burn multiple below which recovery "
           "may grow (the hysteresis band's bottom)", min=0.0,
           max=1e6, see_also=("qos_controller_burn_high",)),
    Option("qos_recovery_res_min", float, 4.0, OptionLevel.ADVANCED,
           "controller clamp: recovery reservation floor (ops/s) — "
           "the hand-tuned sweep's low endpoint", min=0.1,
           see_also=("qos_controller",)),
    Option("qos_recovery_res_max", float, 128.0, OptionLevel.ADVANCED,
           "controller clamp: recovery reservation ceiling (ops/s) — "
           "the hand-tuned sweep's high endpoint", min=0.1,
           see_also=("qos_recovery_res_min",)),
    Option("qos_recovery_lim_factor", float, 2.0, OptionLevel.ADVANCED,
           "controller-applied recovery limit = reservation x this "
           "(0 = leave the limit unlimited)", min=0.0,
           see_also=("qos_controller",)),
    # recovery reservations + throttles (AsyncReserver / osd_max_backfills
    # / osd_recovery_max_active / osd_recovery_sleep roles)
    Option("osd_max_backfills", int, 2, OptionLevel.ADVANCED,
           "max PGs concurrently holding a local (and, per target, "
           "remote) recovery reservation on this OSD", min=1),
    Option("osd_ec_repair_narrow", str, "on", OptionLevel.ADVANCED,
           "repair-bandwidth-optimal shard rebuilds: single-failure "
           "rebuilds fetch only the codec's minimum_to_decode set "
           "(LRC: one locality group; SHEC: one shingle window) and, "
           "for sub-chunk codecs at d=k+m-1 (CLAY), only the alpha/q "
           "repair-plane byte ranges per helper instead of whole "
           "shards; an insufficient narrow read retries wide "
           "automatically.  off = always fetch every holder's whole "
           "shard (the pre-narrow behavior)",
           enum_values=("on", "off")),
    Option("osd_recovery_max_active", int, 4, OptionLevel.ADVANCED,
           "max recovery data-movement ops initiated concurrently",
           min=1),
    Option("osd_recovery_sleep", float, 0.0, OptionLevel.ADVANCED,
           "pause between successive recovery op initiations (seconds; "
           "0 = none)", min=0.0),
    Option("osd_recovery_reserve_timeout", float, 10.0,
           OptionLevel.ADVANCED,
           "seconds to wait for a remote reservation grant before "
           "failing open (target presumed dead)", min=0.5),
    Option("ms_dispatch_workers", int, 3, OptionLevel.ADVANCED,
           "sharded messenger dispatch workers per daemon endpoint "
           "(ms_async_op_threads role): peers pin to one worker so "
           "per-peer ordering holds while different peers dispatch "
           "concurrently", min=1),
    Option("ms_stack", str, "posix", OptionLevel.ADVANCED,
           "messenger transport stack (ms_async_transport_type role): "
           "'posix' = blocking sendmsg/recv_into syscalls per frame; "
           "'uring' = io_uring registered-buffer backend (batched SQE "
           "chains, <1 syscall/frame) where the native extension and "
           "kernel support it, logged fallback to posix where not; "
           "'auto' = uring when the probe passes, silently posix "
           "otherwise", enum_values=("posix", "uring", "auto"),
           startup=True),
    # cluster event journal + progress (LogClient/LogMonitor + mgr
    # progress module roles)
    Option("osd_event_log_size", int, 1024, OptionLevel.ADVANCED,
           "events retained in a daemon's local journal ring AND the "
           "cap on events pending shipment to the mon (oldest pending "
           "shed past it — an unreachable mon must never wedge the "
           "heartbeat thread)", min=16, max=1 << 20,
           see_also=("mon_cluster_log_size",)),
    Option("mon_cluster_log_size", int, 4096, OptionLevel.ADVANCED,
           "merged events the monitor's cluster log ring retains "
           "(dump_cluster_log / event_tool window)", min=16,
           max=1 << 20, see_also=("osd_event_log_size",)),
    Option("osd_event_resend_s", float, 10.0, OptionLevel.ADVANCED,
           "seconds a journal event stays pending (re-shipping with "
           "every stats report, mon dedupes by sequence): transient "
           "partitions/lossy wires inside this window lose nothing",
           min=0.0, max=3600.0, see_also=("osd_event_log_size",)),
    Option("osd_recovery_progress_interval", float, 0.2,
           OptionLevel.ADVANCED,
           "min seconds between recovery_progress journal events per "
           "PG (debounce: a storm emits progress at this cadence, not "
           "per op)", min=0.0, max=60.0),
    Option("mgr_progress_linger", float, 5.0, OptionLevel.ADVANCED,
           "seconds a completed progress item stays visible (in "
           "progress ls / the progress_percent gauge) before it is "
           "dropped", min=0.0, max=3600.0),
    # always-on telemetry: head-sampled tracing + metrics history
    Option("trace_sample_rate", float, 0.0, OptionLevel.ADVANCED,
           "probability a ROOT op (client write/read, recovery storm, "
           "scrub) starts a distributed trace; the head decision "
           "propagates in the (trace_id, span_id) wire context so one "
           "draw covers the whole client -> primary -> shard fan-out. "
           "0 = off (zero per-op tracer cost); config-live via the "
           "admin socket (`config set`).  Unsampled roots keep a "
           "lightweight local span in a small ring so a SLOW_OPS "
           "complaint can force-retain its evidence retroactively",
           min=0.0, max=1.0,
           see_also=("osd_op_complaint_time",)),
    Option("metrics_history_interval_s", float, 1.0,
           OptionLevel.ADVANCED,
           "seconds between metrics-history snapshots of a daemon's "
           "perf registries (sampled on the heartbeat tick; 0 "
           "disables sampling)", min=0.0, max=3600.0,
           see_also=("metrics_history_keep",)),
    Option("metrics_history_keep", int, 600, OptionLevel.ADVANCED,
           "snapshots retained per registry in a daemon's local "
           "metrics-history ring (the fixed budget: keep x interval "
           "= the retrospective window)", min=2, max=1 << 20,
           see_also=("metrics_history_interval_s",
                     "mon_metrics_history_keep")),
    Option("mon_metrics_history_keep", int, 1200, OptionLevel.ADVANCED,
           "snapshots retained per registry in the monitor's merged "
           "metrics-history store (dump_metrics_history / "
           "metrics_query window)", min=2, max=1 << 20,
           see_also=("metrics_history_keep",)),
    Option("metrics_history_downsample_age", float, 300.0,
           OptionLevel.ADVANCED,
           "snapshots older than this many seconds migrate to the "
           "coarse long-horizon tier (every 8th sample kept) so the "
           "same byte budget covers ~8x the window; 0 disables the "
           "coarse tier (pure fine ring)", min=0.0, max=86400.0,
           see_also=("metrics_history_keep",
                     "metrics_history_interval_s")),
    Option("mon_pg_load_persist_interval_s", float, 5.0,
           OptionLevel.ADVANCED,
           "min seconds between persisting a pgid-keyed standing perf "
           "query's merged per-PG load vector into the metrics-history "
           "store (daemon 'mon', registry 'pg_load' — the balancer's "
           "load-sensing feed); 0 disables persistence", min=0.0,
           max=3600.0, see_also=("mon_metrics_history_keep",)),
    # SLO burn-rate health (mgr slo module): latency objectives over
    # the metrics history, multiwindow burn alerting with exemplars
    Option("slo_objectives", str, "", OptionLevel.ADVANCED,
           "comma-separated latency objectives the mgr slo module "
           "evaluates, '<signal><=<num><us|ms|s>@<pct>%' each (e.g. "
           "'client_op_p99<=20ms@99%'; signals: client_op, "
           "qwait_client, qwait_recovery, msg_dispatch, ec_batch_wait, "
           "or an explicit 'registry_prefix:counter'; a '*' in the "
           "counter name expands per discovered series — e.g. "
           "'mclock_qwait_us_tenant_*_p99<=50ms@99%' stands one "
           "objective per tenant).  Empty = module inert",
           see_also=("slo_fast_window_s", "slo_burn_threshold")),
    Option("slo_fast_window_s", float, 60.0, OptionLevel.ADVANCED,
           "fast metrics_query window for SLO burn evaluation (the "
           "'still happening' half of the multiwindow rule)",
           min=1.0, max=86400.0,
           see_also=("slo_slow_window_s", "slo_burn_threshold")),
    Option("slo_slow_window_s", float, 600.0, OptionLevel.ADVANCED,
           "slow metrics_query window for SLO burn evaluation (the "
           "'not a blip' half of the multiwindow rule)",
           min=1.0, max=86400.0,
           see_also=("slo_fast_window_s", "slo_burn_threshold")),
    Option("slo_burn_threshold", float, 2.0, OptionLevel.ADVANCED,
           "error-budget burn multiple at which SLO_BURN raises: both "
           "windows must burn at least this many times faster than "
           "the objective's budget allows (burn 1.0 = spending the "
           "(1-target) budget exactly)", min=0.1, max=1e6,
           see_also=("slo_objectives",)),
    Option("mon_clog_persist_interval_s", float, 2.0,
           OptionLevel.ADVANCED,
           "min seconds between journaling the monitor's in-memory "
           "cluster log through the paxos store (LogMonitor parity: "
           "dump_cluster_log survives a mon restart); 0 persists on "
           "every stats merge", min=0.0, max=3600.0,
           see_also=("mon_cluster_log_size",)),
    # batcher-thrash health promotion (off by default until real-chip
    # numbers set the thresholds — the CPU CI box resizes legitimately)
    Option("mon_batch_thrash_warn_count", int, 0, OptionLevel.ADVANCED,
           "raise HEALTH_WARN BATCH_THRASH when one daemon journals "
           "at least this many `batch` channel events (adaptive-window "
           "resizes / fused-csum fall-throughs) within "
           "mon_batch_thrash_warn_window_s; 0 = off", min=0,
           see_also=("mon_batch_thrash_warn_window_s", "ec_batch_adaptive")),
    Option("mon_batch_thrash_warn_window_s", float, 60.0,
           OptionLevel.ADVANCED,
           "sliding window (seconds) the batch-thrash health check "
           "counts events over; the warning clears once the window "
           "drains below the threshold", min=0.1, max=3600.0,
           see_also=("mon_batch_thrash_warn_count",)),
    Option("mgr_autoscaler_objects_per_pg", int, 100, OptionLevel.BASIC,
           "pg_autoscaler: grow a pool's pg_num once its logical "
           "objects-per-PG estimate exceeds this target", min=1),
    Option("mgr_autoscaler_max_pg_num", int, 256, OptionLevel.ADVANCED,
           "pg_autoscaler: never propose pg_num beyond this cap",
           min=1),
]


def default_config() -> Config:
    return Config(OPTIONS)
