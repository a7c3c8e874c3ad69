"""ObjectStore: local object storage API + the async commit pipeline.

The capability of the reference's ObjectStore layer (src/os/ObjectStore.h —
collections of objects, atomic Transactions with ordered op-codes,
queue_transactions with commit callbacks :241, factory create
src/os/ObjectStore.cc:28) with MemStore (src/os/memstore/MemStore.cc) as
the first backend.  FileStore / BlueStore slot in behind the same factory.

Objects are keyed by (pool, shard, name) — the ghobject role: shard id
distinguishes EC shard copies, generation supports EC rollback (deferred).

Commit pipeline (the BlueStore queue_transactions + _kv_sync_thread group
commit, src/os/bluestore/BlueStore.cc):

    callers --queue_transaction--> [throttle] --_prepare--> queue
                                                              |
                      kv-sync thread:  drain -> _commit_batch (ONE fsync
                      per batch: all WAL records in one vectored write)
                                                              |
                      finisher thread: on_commit callbacks, in submission
                      order (global FIFO, so per-collection order holds)

Every backend splits ``queue_transaction`` into two primitives:

- ``_prepare(tx)``: synchronous staging + in-RAM apply in the CALLER's
  thread under the store lock.  After it returns, reads observe the
  transaction (read-your-writes holds before durability — the staged /
  shadow-onode state IS the read state) and per-collection ordering is
  fixed by queue position.  Raises exactly like the old inline path
  (validation failures never reach the WAL).
- ``_commit_batch(items)``: makes a whole batch durable with the minimum
  number of fsyncs (device sync + one vectored WAL/KV append + one KV
  fsync for BlueStore; one WAL write + fsync + one file mirror per dirty
  object for FileStore; nothing for MemStore) and returns the fsync
  count.  Runs on the kv-sync thread (or inline in sync mode).

Ordering & durability contract:

- ``on_commit`` fires only after the transaction's WAL record is fsync'd,
  in submission order (the finisher drains a FIFO).
- a crash loses only un-acked transactions: replay applies exactly the
  committed WAL prefix (records are individually crc-framed; a torn tail
  is discarded).  BlueStore additionally defers freed-page reuse and
  deferred-write device IO to AFTER the batch's KV fsync so a committed
  onode can never point at clobbered bytes.
- sync mode (``store_sync_commit=on`` / no ``enable_async``) runs
  prepare+commit inline per transaction — byte-identical on-disk
  behavior to the pre-pipeline stores, for scrub interleaving and tests.

Throttle knobs: ``store_throttle_bytes`` / ``store_throttle_ops`` bound
the queue (admission blocks BEFORE the store lock — BlueStore-style
backpressure instead of unbounded growth); the adaptive batch window
(``store_batch_window_us``, EWMA toward ``store_batch_target_txns``,
clamped to ``store_batch_window_max_us``) adds coalescing delay only
when concurrency exists, decaying to 0 for sequential writers so an
idle store commits promptly.

The KV tier below BlueStore composes with this chain: its background
flush/compaction threads keep ``_commit_batch`` off the merge path,
and when LSM maintenance falls behind, the counted KV write stall
lands on the kv-sync thread → the commit queue stays full → this
admission throttle blocks submitters.  Backpressure stays honest end
to end instead of an unbounded inline merge (osd/sstkv.py).
"""

from __future__ import annotations

import collections
import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..utils.buffer import BufferList
from ..utils.perf import CounterType, PerfCounters, global_perf


class StoreError(Exception):
    pass


class NoSuchObject(StoreError):
    pass


class NoSuchCollection(StoreError):
    pass


@dataclass(frozen=True, order=True)
class ObjectId:
    """ghobject-shaped key: name + shard (EC) + snapshot generation."""

    name: str
    shard: int = -1  # -1 = whole object / replicated (NO_SHARD)
    generation: int = -1

    def __str__(self) -> str:
        s = self.name
        if self.shard >= 0:
            s += f"(s{self.shard})"
        if self.generation >= 0:
            s += f"(g{self.generation})"
        return s


@dataclass(frozen=True, order=True)
class CollectionId:
    """One PG's object namespace (coll_t)."""

    pool: int
    pg_seed: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.pg_seed:x}"


class TxOp(enum.Enum):
    TOUCH = "touch"
    WRITE = "write"
    ZERO = "zero"
    TRUNCATE = "truncate"
    REMOVE = "remove"
    SETATTRS = "setattrs"
    RMATTR = "rmattr"
    OMAP_SETKEYS = "omap_setkeys"
    OMAP_RMKEYS = "omap_rmkeys"
    CLONE = "clone"
    CREATE_COLLECTION = "create_collection"
    REMOVE_COLLECTION = "remove_collection"


@dataclass
class Transaction:
    """Ordered list of mutations applied atomically (Transaction.h)."""

    ops: list[tuple] = field(default_factory=list)

    def touch(self, cid, oid):
        self.ops.append((TxOp.TOUCH, cid, oid))
        return self

    def write(self, cid, oid, offset: int, data):
        if not isinstance(data, BufferList):
            data = BufferList(data)
        self.ops.append((TxOp.WRITE, cid, oid, offset, data))
        return self

    def zero(self, cid, oid, offset: int, length: int):
        self.ops.append((TxOp.ZERO, cid, oid, offset, length))
        return self

    def truncate(self, cid, oid, size: int):
        self.ops.append((TxOp.TRUNCATE, cid, oid, size))
        return self

    def remove(self, cid, oid):
        self.ops.append((TxOp.REMOVE, cid, oid))
        return self

    def setattrs(self, cid, oid, attrs: dict[str, bytes]):
        self.ops.append((TxOp.SETATTRS, cid, oid, dict(attrs)))
        return self

    def rmattr(self, cid, oid, name: str):
        self.ops.append((TxOp.RMATTR, cid, oid, name))
        return self

    def omap_setkeys(self, cid, oid, kv: dict[str, bytes]):
        self.ops.append((TxOp.OMAP_SETKEYS, cid, oid, dict(kv)))
        return self

    def omap_rmkeys(self, cid, oid, keys):
        self.ops.append((TxOp.OMAP_RMKEYS, cid, oid, list(keys)))
        return self

    def clone(self, cid, src, dst):
        self.ops.append((TxOp.CLONE, cid, src, dst))
        return self

    def create_collection(self, cid):
        self.ops.append((TxOp.CREATE_COLLECTION, cid))
        return self

    def remove_collection(self, cid):
        self.ops.append((TxOp.REMOVE_COLLECTION, cid))
        return self

    def append(self, other: "Transaction"):
        self.ops.extend(other.ops)
        return self

    def empty(self) -> bool:
        return not self.ops


# --------------------------------------------------------------- pipeline

#: the per-store perf schema (registry ``store.<name>``): registered
#: zeroed at pipeline creation so the exporter/metrics-history see one
#: stable shape whether or not traffic has flowed yet.
STORE_COUNTERS = ("store_txns", "store_fsyncs", "store_batches",
                  "store_throttle_stalls",
                  "store_ingest_ref_bytes", "store_ingest_copy_bytes")
STORE_HISTOGRAMS = ("store_commit_us", "store_queue_us",
                    "store_txns_per_fsync", "store_throttle_wait_us")
STORE_GAUGES = ("store_queue_depth",)


def register_store_counters(perf: PerfCounters) -> None:
    """Idempotently register the commit-pipeline counter schema."""
    for n in STORE_COUNTERS:
        if not perf.has(n):
            perf.add(n)
    for n in STORE_HISTOGRAMS:
        if not perf.has(n):
            perf.add(n, CounterType.HISTOGRAM)
    for n in STORE_GAUGES:
        if not perf.has(n):
            perf.add(n, CounterType.U64)


class _QueuedTx:
    __slots__ = ("item", "on_commit", "nbytes", "t_enq", "admitted",
                 "on_error")

    def __init__(self, item, on_commit, nbytes, admitted,
                 on_error=False):
        self.item = item            # backend-opaque prepared txn; None
        #                             = pure completion barrier
        self.on_commit = on_commit
        self.nbytes = nbytes
        self.t_enq = time.monotonic()
        self.admitted = admitted    # counted against the throttle
        # fire even when the batch FAILS: flush events ride this (the
        # waiter re-checks _failed) — durability acks never do (a
        # failed commit must not ack)
        self.on_error = on_error


class CommitPipeline:
    """Per-store kv-sync + finisher threads (see module docstring for
    the full contract).  One instance per async-enabled store; owns the
    ``store.<name>`` perf registry unless handed an external one."""

    #: hard batch-size cut: past this many queued txns the kv thread
    #: commits immediately regardless of window (bounds commit latency
    #: and the single vectored write's size)
    MAX_BATCH = 256

    def __init__(self, store: "ObjectStore", *, name: str = "store",
                 throttle_bytes: int = 64 << 20,
                 throttle_ops: int = 1024,
                 window_us: float = 0.0,
                 window_min_us: float = 50.0,
                 window_max_us: float = 4000.0,
                 target_txns: float = 8.0,
                 adaptive: bool = True,
                 perf: PerfCounters | None = None):
        self._store = store
        self.throttle_bytes = int(throttle_bytes)
        self.throttle_ops = int(throttle_ops)
        self.window_us = float(window_us)
        self.window_min_us = float(window_min_us)
        self.window_max_us = float(window_max_us)
        self.target_txns = float(target_txns)
        self.adaptive = bool(adaptive)
        self._owns_perf = perf is None
        self._perf_name = f"store.{name}"
        self.perf = perf if perf is not None \
            else global_perf().create(self._perf_name)
        register_store_counters(self.perf)
        self._lock = threading.Lock()
        self._cv_work = threading.Condition(self._lock)   # kv thread
        self._cv_space = threading.Condition(self._lock)  # throttled
        self._queue: list[_QueuedTx] = []
        self._bytes = 0
        self._ops = 0
        self._kick = False
        self._stopping = False
        self._failed: BaseException | None = None
        # adaptive-window state (EWMA of observed batch size + commit
        # cost; see _steer_window)
        self._ewma_n = 1.0
        self._ewma_commit_s = 0.0
        self._fin_cv = threading.Condition(threading.Lock())
        self._fin_q: collections.deque = collections.deque()
        self._fin_open = True
        self._kv_thread = threading.Thread(
            target=self._kv_sync_loop, daemon=True,
            name=f"kv-sync-{name}")
        self._fin_thread = threading.Thread(
            target=self._finisher_loop, daemon=True,
            name=f"store-fin-{name}")
        self._kv_thread.start()
        self._fin_thread.start()

    # ------------------------------------------------------------- admit
    def admit(self, nbytes: int) -> None:
        """Admission throttle: block the SUBMITTING thread (never the
        store lock holder — callers admit before preparing) while the
        queue is over either bound."""
        t0 = None
        with self._cv_space:
            while not self._stopping and (
                    self._bytes >= self.throttle_bytes
                    or self._ops >= self.throttle_ops):
                if t0 is None:
                    t0 = time.monotonic()
                    self.perf.inc("store_throttle_stalls")
                self._cv_space.wait(0.5)
            self._bytes += nbytes
            self._ops += 1
            self.perf.set("store_queue_depth", self._ops)
        if t0 is not None:
            self.perf.hinc("store_throttle_wait_us",
                           (time.monotonic() - t0) * 1e6)

    def unadmit(self, nbytes: int) -> None:
        with self._cv_space:
            self._bytes -= nbytes
            self._ops -= 1
            self.perf.set("store_queue_depth", self._ops)
            self._cv_space.notify_all()

    # ------------------------------------------------------------ submit
    def submit(self, item, on_commit, nbytes: int,
               admitted: bool = True) -> None:
        # deliberately NO _failed check here: the caller already
        # applied the transaction in RAM (_prepare), so raising now
        # would error-return a write that stays visible to reads.
        # queue_transaction gates on _failed BEFORE preparing; a
        # failure landing in between means this item enqueues, its
        # batch is skipped, and its ack never fires (op-timeout
        # surfaces it) — the same fate as any tx whose commit fails.
        q = _QueuedTx(item, on_commit, nbytes, admitted)
        with self._cv_work:
            if self._stopping:
                # unreachable through queue_transaction (the order
                # mutex serializes against disable_async); a backstop
                # for direct misuse
                raise StoreError("commit pipeline stopped")
            self._queue.append(q)
            self._cv_work.notify_all()

    def barrier(self, cb: Callable[[], None], kick: bool = False,
                on_error: bool = False) -> None:
        """Queue a completion AFTER everything currently queued: the
        finisher fires ``cb`` once every prior transaction is durable
        (the on_flush role — reply continuations ride this).  Plain
        barriers do NOT cut the batch window — an ack continuation is
        exactly the latency the window is allowed to trade; ``kick``
        (flush) forces an immediate cut.  ``on_error`` barriers fire
        even when the batch fails (flush events; the waiter re-checks
        the failure) — ack barriers never do."""
        with self._cv_work:
            # _stopping (not thread aliveness) is the safe gate: the kv
            # thread decides to exit under this lock, so a cb appended
            # after _stopping could land in a queue nobody drains
            if not self._stopping and self._kv_thread.is_alive():
                self._queue.append(_QueuedTx(None, cb, 0, False,
                                             on_error=on_error))
                if kick:
                    self._kick = True
                self._cv_work.notify_all()
                return
        # pipeline stopping/dismantled (shutdown race): stop()'s flush
        # already drained everything queued before it, so the barrier's
        # contract is satisfied inline
        cb()

    def flush(self, timeout: float = 60.0) -> None:
        """Block until everything queued so far is committed AND its
        callbacks have fired.  Raises StoreError when the pipeline has
        failed or the drain never completes — umount must not close a
        device the kv thread might still be writing."""
        if self._failed is not None:
            raise StoreError(f"commit pipeline failed: {self._failed}")
        if not self._kv_thread.is_alive():
            return
        ev = threading.Event()
        self.barrier(ev.set, kick=True, on_error=True)
        if not ev.wait(timeout):
            raise StoreError(
                f"store flush did not drain in {timeout}s"
                f" ({self._failed or 'commit still in flight'})")
        if self._failed is not None:
            raise StoreError(f"commit pipeline failed: {self._failed}")

    def stop(self) -> None:
        try:
            self.flush()
        except StoreError:
            pass  # failure already surfaced; dismantle regardless
        with self._cv_work:
            self._stopping = True
            self._cv_work.notify_all()
            self._cv_space.notify_all()
        self._kv_thread.join(timeout=10)
        with self._fin_cv:
            self._fin_open = False
            self._fin_cv.notify_all()
        self._fin_thread.join(timeout=10)
        if self._owns_perf:
            global_perf().remove(self._perf_name)

    @property
    def depth(self) -> int:
        with self._lock:
            return self._ops

    # ------------------------------------------------------------ kv sync
    def _kv_sync_loop(self) -> None:
        while True:
            with self._cv_work:
                while not self._queue and not self._stopping:
                    self._cv_work.wait()
                if not self._queue:
                    return  # stopping and drained
                # adaptive coalescing window: give concurrent writers a
                # beat to pile on (deadline anchored at the FIRST
                # arrival so an idle store commits promptly); a flush
                # kick cuts the batch immediately, and a barrier-only
                # queue has nothing to coalesce — fire it now
                w = self.window_us
                if w > 0 and not self._kick and any(
                        q.item is not None for q in self._queue):
                    deadline = self._queue[0].t_enq + w * 1e-6
                    while (not self._kick and not self._stopping
                           and len(self._queue) < self.MAX_BATCH):
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cv_work.wait(left)
                if len(self._queue) > self.MAX_BATCH:
                    # bound the single vectored write (and FileStore's
                    # lock hold) even when the throttle admitted more:
                    # the remainder forms the next batch immediately
                    batch = self._queue[:self.MAX_BATCH]
                    self._queue = self._queue[self.MAX_BATCH:]
                else:
                    batch, self._queue = self._queue, []
                    self._kick = False
            self._run_batch(batch)

    def _run_batch(self, batch: list[_QueuedTx]) -> None:
        t0 = time.monotonic()
        items = [q.item for q in batch if q.item is not None]
        fsyncs = 0
        # once failed, stay failed: a later batch's records would land
        # BEHIND the torn frame — fsync'd but unreachable to replay,
        # so acking them would lose acked writes on the next crash
        err: BaseException | None = self._failed
        if items and err is None:
            try:
                fsyncs = int(self._store._commit_batch(items) or 0)
            except BaseException as e:  # noqa: BLE001 - device/WAL fail
                # a failed group commit must not ack: callbacks for this
                # batch never fire (callers' op timeouts surface it) and
                # the pipeline refuses new work — the reference asserts
                # out here; we fail the store loudly instead
                err = e
                self._failed = e
                from ..utils.log import dout
                dout("store", 0)(
                    "commit pipeline FAILED (store poisoned, "
                    "refusing new work): %r", e)
        commit_s = time.monotonic() - t0
        n = len(items)
        # book only batches that actually committed: a failed or
        # skipped-after-failure batch must not inflate store_txns (the
        # bench's fsyncs-per-txn gate reads these deltas) or steer the
        # window off phantom work
        if n and err is None:
            self.perf.inc("store_txns", n)
            self.perf.inc("store_batches")
            self.perf.inc("store_fsyncs", fsyncs)
            self.perf.hinc("store_commit_us", commit_s * 1e6)
            if fsyncs:
                self.perf.hinc("store_txns_per_fsync", n / fsyncs)
            for q in batch:
                if q.item is not None:
                    self.perf.hinc("store_queue_us",
                                   (t0 - q.t_enq) * 1e6)
            self._steer_window(n, commit_s)
        with self._cv_space:
            for q in batch:
                if q.admitted:
                    self._bytes -= q.nbytes
                    self._ops -= 1
            self.perf.set("store_queue_depth", max(self._ops, 0))
            self._cv_space.notify_all()
        cbs = [q.on_commit for q in batch
               if q.on_commit is not None
               and (err is None or q.on_error)]
        if cbs:
            with self._fin_cv:
                self._fin_q.extend(cbs)
                self._fin_cv.notify_all()

    def _steer_window(self, n: int, commit_s: float) -> None:
        """EWMA steering toward the target batch size, bounded by the
        max-latency clamp.  Growth only while batches show real
        concurrency (n > 1) — a sequential writer's window decays to 0
        so closed-loop latency never pays for coalescing that cannot
        happen; an over-target batch sheds window so a saturated store
        trades no more latency than the target needs."""
        self._ewma_n = 0.7 * self._ewma_n + 0.3 * n
        self._ewma_commit_s = 0.7 * self._ewma_commit_s + 0.3 * commit_s
        if not self.adaptive:
            return
        w = self.window_us
        if self._ewma_n >= self.target_txns:
            w *= 0.7  # coalescing enough without the extra latency
        elif n > 1:
            w = max(w * 1.3, self.window_min_us)
        else:
            w *= 0.5
        if w < 1.0:
            w = 0.0
        self.window_us = min(w, self.window_max_us)

    # ----------------------------------------------------------- finisher
    def _finisher_loop(self) -> None:
        while True:
            with self._fin_cv:
                while not self._fin_q and self._fin_open:
                    self._fin_cv.wait()
                if not self._fin_q:
                    return
                cb = self._fin_q.popleft()
            try:
                cb()
            except Exception as e:  # noqa: BLE001 - a callback must
                # not wedge the finisher behind it — but a vanished
                # reply continuation must leave a trace
                from ..utils.log import dout
                dout("store", 1)("on_commit callback raised: %r", e)


_ORDER_GUARD = threading.Lock()


def _tx_nbytes(tx: "Transaction") -> int:
    """Throttle-accounting estimate: payload bytes + a per-op floor."""
    n = 128 * len(tx.ops)
    for op in tx.ops:
        if op[0] == TxOp.WRITE:
            n += len(op[4])
    return n


class ObjectStore:
    """Abstract store; see MemStore below and the module docstring for
    the async commit pipeline every backend rides."""

    #: class-level default so existing backends need no __init__ change
    _pipeline: CommitPipeline | None = None

    @staticmethod
    def create(kind: str, **kw) -> "ObjectStore":
        """Factory (ObjectStore::create src/os/ObjectStore.cc:28):
        'memstore' (in-RAM, tests) or 'filestore' (durable, WAL-backed)."""
        if kind == "memstore":
            return MemStore(**kw)
        if kind == "filestore":
            from .filestore import FileStore
            return FileStore(**kw)
        if kind == "bluestore":
            from .bluestore import BlueStore
            return BlueStore(**kw)
        raise StoreError(f"unknown objectstore backend {kind!r}")

    # -- lifecycle ---------------------------------------------------------
    def mount(self) -> None: ...
    def umount(self) -> None: ...

    # -- KV metadata tier (BlueStore overrides) ----------------------------
    def configure_kv(self, cfg, name: str | None = None) -> None:
        """Fill unset KV-tier knobs from config before mount; no-op
        for backends without a KV metadata tier."""

    def kv_stats(self) -> dict | None:
        """KV-tier maintenance/occupancy stats (memtable seal depth,
        level shape, stall/cache tallies) or None when the backend has
        no KV tier — the ``dump_kv_stats`` admin surface."""
        return None

    # -- async commit pipeline --------------------------------------------
    def enable_async(self, *, name: str = "store",
                     perf: PerfCounters | None = None, **knobs) -> None:
        """Engage the group-commit pipeline (idempotent).  From here on
        ``queue_transaction`` returns after the in-RAM apply; durability
        and ``on_commit`` ride the kv-sync/finisher threads."""
        if self._pipeline is None:
            self._pipeline = CommitPipeline(self, name=name, perf=perf,
                                            **knobs)

    def disable_async(self) -> None:
        """Drain and dismantle the pipeline (back to inline commits).
        The order mutex serializes the transition: the pipeline is
        fully stopped (kv thread joined) before it is detached, so a
        racing submitter either lands in the queue pre-drain or takes
        the inline path post-detach — never two committers at once."""
        with self._order_mutex():
            p = self._pipeline
            if p is not None:
                p.stop()
                self._pipeline = None

    def flush(self) -> None:
        """Durability barrier: block until every transaction queued so
        far is committed and its callbacks have fired (the
        ObjectStore::flush / sync-mode escape hatch)."""
        p = self._pipeline
        if p is not None:
            p.flush()

    def commit_barrier(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` once everything queued SO FAR is durable — inline
        in sync mode (nothing is pending), via the finisher (in order)
        in async mode.  Reply continuations ride this."""
        p = self._pipeline
        if p is not None:
            p.barrier(cb)
        else:
            cb()

    def _order_mutex(self) -> threading.RLock:
        """Per-instance submission-order lock, created lazily (backends
        predate the pipeline and do not call a base __init__).  Held
        across prepare+enqueue so apply order == WAL/commit order —
        without it two racing writers could apply A,B but journal B,A,
        and a crash replay would resurrect the other serialization."""
        m = getattr(self, "_order_lock", None)
        if m is None:
            with _ORDER_GUARD:
                m = getattr(self, "_order_lock", None)
                if m is None:
                    self._order_lock = m = threading.RLock()
        return m

    @staticmethod
    def _failed_now(p: CommitPipeline) -> bool:
        return p._failed is not None

    def _tx_cost(self, tx: Transaction) -> int:
        """Bytes this transaction will pin in the commit queue — the
        throttle's unit.  Default: payload bytes + a per-op floor;
        backends that hold more per queued item (FileStore's per-tx
        object snapshots) override to account it."""
        return _tx_nbytes(tx)

    def _book(self, name: str, n: int = 1) -> None:
        """Book onto the pipeline's store registry (no-op in sync
        mode — there is no registry to keep a stable schema on)."""
        p = self._pipeline
        if p is not None:
            p.perf.inc(name, n)

    # -- mutation ----------------------------------------------------------
    def queue_transaction(self, tx: Transaction,
                          on_commit: Callable[[], None] | None = None) -> None:
        """Stage + apply in THIS thread (read-your-writes holds on
        return), then commit inline (sync mode) or hand durability to
        the kv-sync thread (async mode).  ``on_commit`` fires after the
        transaction is durable, in submission order."""
        p = self._pipeline
        if p is not None:
            if p._failed is not None:
                # refuse BEFORE the in-RAM apply: an error-returned
                # write must not stay visible to reads while it can
                # never become durable
                raise StoreError(
                    f"commit pipeline failed: {p._failed}")
            nbytes = self._tx_cost(tx)
            p.admit(nbytes)  # BEFORE any lock: backpressure must not
            #                  deadlock against the committing thread
            try:
                with self._order_mutex():
                    if self._failed_now(p):
                        # the kv thread failed while we waited in the
                        # throttle: still BEFORE the in-RAM apply
                        raise StoreError(
                            f"commit pipeline failed: {p._failed}")
                    if self._pipeline is p:  # not dismantled while
                        #                      we waited for the mutex
                        item = self._prepare(tx)
                        p.submit(item, on_commit, nbytes)
                        return
            except BaseException:
                p.unadmit(nbytes)
                raise
            p.unadmit(nbytes)  # fall through to the inline path
        with self._order_mutex():
            item = self._prepare(tx)
            self._commit_batch([item])
        if on_commit is not None:
            on_commit()

    # -- backend primitives (see module docstring) -------------------------
    def _prepare(self, tx: Transaction):
        raise NotImplementedError

    def _commit_batch(self, items: list) -> int:
        raise NotImplementedError

    # -- queries -----------------------------------------------------------
    def read(self, cid, oid, offset: int = 0,
             length: int | None = None) -> BufferList:
        raise NotImplementedError

    def stat(self, cid, oid) -> dict:
        raise NotImplementedError

    def exists(self, cid, oid) -> bool:
        raise NotImplementedError

    def getattrs(self, cid, oid) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, cid, oid) -> dict[str, bytes]:
        raise NotImplementedError

    def list_objects(self, cid) -> list[ObjectId]:
        raise NotImplementedError

    def list_collections(self) -> list[CollectionId]:
        raise NotImplementedError


class _Obj:
    __slots__ = ("data", "attrs", "omap")

    def __init__(self):
        self.data = bytearray()
        self.attrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}


class MemStore(ObjectStore):
    """In-RAM ObjectStore with atomic transactions (MemStore.cc role)."""

    def __init__(self):
        self._colls: dict[CollectionId, dict[ObjectId, _Obj]] = {}
        self._lock = threading.RLock()
        self._mounted = False

    def mount(self) -> None:
        self._mounted = True

    def umount(self) -> None:
        self._mounted = False

    #: prepared-transaction token: MemStore has no durable work, but a
    #: real (non-None) item keeps its txns flowing through
    #: _commit_batch so the pipeline's txn/batch counters and window
    #: steering see them (None is reserved for pure barriers)
    _APPLIED = object()

    # -- transaction application (atomic under the store lock) -------------
    def _prepare(self, tx: Transaction):
        """Validate + apply atomically (MemStore's whole commit is the
        in-RAM apply; the payload detaches here — bytearray splicing —
        so a carved rx frame buffer can be reused immediately)."""
        with self._lock:
            self.validate(tx)
            for op in tx.ops:
                self._apply(op)
        return self._APPLIED

    def _commit_batch(self, items: list) -> int:
        return 0  # nothing durable to sync

    def validate(self, tx: Transaction) -> None:
        """Raise if the transaction cannot apply; no effects.  Tracks
        objects/collections materialised earlier in the SAME tx so e.g.
        touch-then-truncate sequences validate (all-or-nothing)."""
        with self._lock:
            created: set[tuple] = set()
            for op in tx.ops:
                self._check(op, created)

    def _coll(self, cid) -> dict[ObjectId, _Obj]:
        c = self._colls.get(cid)
        if c is None:
            raise NoSuchCollection(str(cid))
        return c

    _CREATES = (TxOp.TOUCH, TxOp.WRITE, TxOp.ZERO, TxOp.SETATTRS,
                TxOp.OMAP_SETKEYS, TxOp.TRUNCATE)

    def _check(self, op, created: set) -> None:
        kind = op[0]
        if kind == TxOp.CREATE_COLLECTION:
            created.add(("coll", op[1]))
            return
        if kind == TxOp.REMOVE_COLLECTION:
            if ("coll", op[1]) not in created:
                self._coll(op[1])
            return
        cid = op[1]
        if ("coll", cid) in created:
            coll = self._colls.get(cid, {})
        else:
            coll = self._coll(cid)

        def have(oid) -> bool:
            return oid in coll or ("obj", cid, oid) in created

        if kind == TxOp.CLONE:
            if not have(op[2]):
                raise NoSuchObject(str(op[2]))
            created.add(("obj", cid, op[3]))
            return
        if kind in (TxOp.REMOVE, TxOp.RMATTR,
                    TxOp.OMAP_RMKEYS) and not have(op[2]):
            raise NoSuchObject(str(op[2]))
        if kind in self._CREATES:
            created.add(("obj", cid, op[2]))

    def _apply(self, op) -> None:
        kind = op[0]
        if kind == TxOp.CREATE_COLLECTION:
            self._colls.setdefault(op[1], {})
            return
        if kind == TxOp.REMOVE_COLLECTION:
            self._colls.pop(op[1], None)
            return
        cid, oid = op[1], op[2]
        coll = self._coll(cid)
        if kind == TxOp.TOUCH:
            coll.setdefault(oid, _Obj())
        elif kind == TxOp.WRITE:
            _, _, _, offset, data = op
            o = coll.setdefault(oid, _Obj())
            raw = data.to_bytes()
            end = offset + len(raw)
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[offset:end] = raw
        elif kind == TxOp.ZERO:
            _, _, _, offset, length = op
            o = coll.setdefault(oid, _Obj())
            end = offset + length
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[offset:end] = b"\0" * length
        elif kind == TxOp.TRUNCATE:
            o = coll.setdefault(oid, _Obj())
            size = op[3]
            if len(o.data) > size:
                del o.data[size:]
            else:
                o.data.extend(b"\0" * (size - len(o.data)))
        elif kind == TxOp.REMOVE:
            coll.pop(oid, None)
        elif kind == TxOp.SETATTRS:
            coll.setdefault(oid, _Obj()).attrs.update(op[3])
        elif kind == TxOp.RMATTR:
            coll[oid].attrs.pop(op[3], None)
        elif kind == TxOp.OMAP_SETKEYS:
            coll.setdefault(oid, _Obj()).omap.update(op[3])
        elif kind == TxOp.OMAP_RMKEYS:
            o = coll[oid]
            for k in op[3]:
                o.omap.pop(k, None)
        elif kind == TxOp.CLONE:
            src = coll[op[2]]
            dst = coll.setdefault(op[3], _Obj())
            dst.data = bytearray(src.data)
            dst.attrs = dict(src.attrs)
            dst.omap = dict(src.omap)
        else:  # pragma: no cover
            raise StoreError(f"unknown tx op {kind}")

    # -- reads -------------------------------------------------------------
    def _obj(self, cid, oid) -> _Obj:
        with self._lock:
            coll = self._coll(cid)
            o = coll.get(oid)
            if o is None:
                raise NoSuchObject(f"{cid}/{oid}")
            return o

    def read(self, cid, oid, offset: int = 0,
             length: int | None = None) -> BufferList:
        o = self._obj(cid, oid)
        with self._lock:
            data = bytes(o.data[offset:None if length is None
                                else offset + length])
        return BufferList(data)

    def stat(self, cid, oid) -> dict:
        o = self._obj(cid, oid)
        return {"size": len(o.data), "attrs": len(o.attrs),
                "omap": len(o.omap)}

    def exists(self, cid, oid) -> bool:
        with self._lock:
            try:
                return oid in self._coll(cid)
            except NoSuchCollection:
                return False

    def getattrs(self, cid, oid) -> dict[str, bytes]:
        return dict(self._obj(cid, oid).attrs)

    def omap_get(self, cid, oid) -> dict[str, bytes]:
        return dict(self._obj(cid, oid).omap)

    def list_objects(self, cid) -> list[ObjectId]:
        with self._lock:
            return sorted(self._coll(cid))

    def list_collections(self) -> list[CollectionId]:
        with self._lock:
            return sorted(self._colls)
