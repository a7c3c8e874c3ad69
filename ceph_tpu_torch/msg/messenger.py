"""Entity-addressed messengers over a pluggable transport.

Capability map to the reference (src/msg/ — SURVEY.md §2.3):
- Messenger::create / bind / connect -> Messenger over a Network
- Dispatcher::ms_dispatch / ms_handle_reset -> Dispatcher
- Policy (lossy/lossless, throttler) -> Policy (+ message-cap throttle)
- AsyncMessenger worker threads -> one dispatch thread per messenger
  (sharded workers are a scale knob, not a semantics change)
- msgr failure injection (ms inject socket failures) -> LocalNetwork
  drop_rate / partitions / latency knobs, used by thrasher tests

The LocalNetwork transport delivers Python message objects in-process.
Messages are Encodable; wire transports encode them with the versioned
codec (utils.codec) — the framing contract stands in for
ProtocolV2 (session resume at this layer is future work; LocalNetwork
queues are lossless by construction unless told to drop).
"""

from __future__ import annotations

import itertools
import queue
import random
import threading
import time
import zlib
from dataclasses import dataclass, field

from ..utils.log import dout
from ..utils.perf import CounterType, global_perf
from ..utils.throttle import Throttle

#: perf counters every messenger registers (schema is stable even for
#: idle endpoints, so scrapes see one shape across the cluster).  The
#: msg_tx_flatten_* / msg_rx_copy_* pairs are the zero-copy wire
#: path's measured "copies per hop": every Python-side assembly of an
#: outgoing frame's payload (compression join, secure-mode seal) and
#: every receive-side payload copy (decrypt, decompress) is counted —
#: plaintext data frames book ZERO on both, the kernel's iovec
#: gather/scatter being the only remaining copy.
#: The msg_syscalls_{tx,rx} pair is the transport-stack half of the
#: same story: kernel entries per direction (sendmsg/recv_into on the
#: posix stack, io_uring_enter on the uring stack — where batched SQE
#: submission drives tx syscalls-per-frame below 1), and the
#: msg_uring_* pair counts SQE batches submitted and registered
#: rx-pool slots recycled (a recycle == every carved view over the
#: slot died, i.e. the zero-copy rx landed and was consumed in place).
MSG_COUNTERS = ("msg_dispatched", "msg_drop_wire",
                "msg_drop_backpressure",
                "msg_tx_flatten_bytes", "msg_tx_flatten_copies",
                "msg_rx_copy_bytes", "msg_rx_copy_copies",
                "msg_syscalls_tx", "msg_syscalls_rx",
                "msg_uring_sqe_batch", "msg_uring_reg_buf_recycled")
MSG_HISTOGRAMS = ("msg_dispatch_us",)
MSG_TIMES = ("msg_throttle_wait_time",)
MSG_GAUGES = ("msg_queue_depth",)


@dataclass
class Policy:
    lossy: bool = False
    server: bool = False
    throttler_cap: int = 0  # 0 = unthrottled

    @staticmethod
    def lossless_peer() -> "Policy":
        return Policy(lossy=False)

    @staticmethod
    def stateless_server(cap: int = 0) -> "Policy":
        return Policy(lossy=True, server=True, throttler_cap=cap)


class Dispatcher:
    """Receive-side interface (ms_dispatch / ms_fast_dispatch role)."""

    def ms_dispatch(self, conn: "Connection", msg) -> bool:
        raise NotImplementedError

    def ms_handle_reset(self, conn: "Connection") -> None:
        pass


class Connection:
    """Send handle to one peer (Connection::send_message role)."""

    def __init__(self, messenger: "Messenger", peer: str):
        self.messenger = messenger
        self.peer = peer

    def send(self, msg) -> bool:
        return self.messenger.network.deliver(self.messenger.name,
                                              self.peer, msg)

    def __repr__(self):
        return f"Connection({self.messenger.name} -> {self.peer})"


class Network:
    """Transport base: entity registry + fault injection knobs shared by
    every transport (in-proc queues, TCP sockets).  Subclasses implement
    delivery."""

    def __init__(self, seed: int = 0):
        self._entities: dict[str, "Messenger"] = {}
        self._lock = threading.RLock()
        self.drop_rate = 0.0
        self.latency = 0.0
        self._partitions: set[frozenset[str]] = set()
        self._rng = random.Random(seed)
        # drop accounting, split by cause: a lossy-wire drop (fault
        # injection / partition) and a receive-side backpressure drop
        # (lossy server past its message cap) are different operator
        # stories — `dropped` stays as the conflated total for the
        # thrasher tests that only care that SOMETHING was dropped
        self.dropped = 0
        self.dropped_wire = 0
        self.dropped_backpressure = 0

    def note_wire_drop(self, dst: str) -> None:
        """Account one lossy-wire drop (transport-level _blocked hit),
        attributed to the destination endpoint's perf registry when it
        is local."""
        self.dropped += 1
        self.dropped_wire += 1
        target = self.lookup(dst)
        if target is not None:
            target.perf.inc("msg_drop_wire")

    def note_backpressure_drop(self) -> None:
        """Account one receive-side backpressure drop (the messenger
        increments its own perf counter itself)."""
        self.dropped += 1
        self.dropped_backpressure += 1

    # -- registry ----------------------------------------------------------
    def register(self, m: "Messenger") -> None:
        with self._lock:
            if m.name in self._entities:
                raise ValueError(f"entity {m.name!r} already bound")
            self._entities[m.name] = m

    def unregister(self, name: str) -> None:
        with self._lock:
            self._entities.pop(name, None)

    def lookup(self, name: str) -> "Messenger | None":
        with self._lock:
            return self._entities.get(name)

    def addr_of(self, name: str) -> str:
        """Publishable address of a local entity (the bound addr of a
        wire transport; the entity name itself in-proc)."""
        return name

    def set_addr(self, name: str, addr: str) -> None:
        """Teach the transport where a REMOTE entity lives (address book
        seeded from mon addr + map pushes).  No-op in-proc."""

    # -- fault injection (the msgr-failures knobs) -------------------------
    def partition(self, a: str, b: str) -> None:
        self._partitions.add(frozenset((a, b)))

    def heal(self, a: str | None = None, b: str | None = None) -> None:
        if a is None:
            self._partitions.clear()
        else:
            self._partitions.discard(frozenset((a, b)))

    @staticmethod
    def _entity_of(name: str) -> str:
        """Auxiliary endpoints (osd.3.hb) share their daemon's fate: a
        partition severs every plane of the entity, like pulling a host's
        cable severs both the data and heartbeat networks."""
        return name[:-3] if name.endswith(".hb") else name

    def _blocked(self, src: str, dst: str) -> bool:
        if frozenset((self._entity_of(src),
                      self._entity_of(dst))) in self._partitions:
            return True
        return self.drop_rate > 0 and self._rng.random() < self.drop_rate

    def deliver(self, src: str, dst: str, msg) -> bool:
        raise NotImplementedError


class LocalNetwork(Network):
    """In-proc transport: entity name -> messenger registry + faults."""

    # -- delivery ----------------------------------------------------------
    def deliver(self, src: str, dst: str, msg) -> bool:
        target = self.lookup(dst)
        if target is None or target._stopped:
            return False
        if self._blocked(src, dst):
            self.note_wire_drop(dst)
            dout("msg", 10)("dropped %s -> %s: %s", src, dst,
                            type(msg).__name__)
            return True  # silently dropped, like a lossy wire
        if self.latency:
            time.sleep(self.latency)
        return target._enqueue(src, msg)


class Messenger:
    """One entity's endpoint: N sharded dispatch workers.

    The sharded-worker model of AsyncMessenger (src/msg/async/Stack.h:259
    Worker event loops, ms_async_op_threads of them, connections pinned
    to one worker): incoming messages shard by SOURCE entity, so one
    peer's messages stay strictly ordered on one worker while different
    peers' dispatch runs concurrently.  workers=1 degenerates to the
    single dispatch thread every endpoint had before."""

    _ids = itertools.count(1)

    def __init__(self, network: Network, name: str,
                 policy: Policy | None = None, workers: int = 1):
        self.network = network
        self.name = name
        self.policy = policy or Policy()
        self.workers = max(1, int(workers))
        self._dispatchers: list[Dispatcher] = []
        self._queues = [queue.Queue() for _ in range(self.workers)]
        self._stopped = False
        self._throttle = (Throttle(f"{name}.msgs", self.policy.throttler_cap)
                          if self.policy.throttler_cap else None)
        self._threads: list[threading.Thread] = []
        # per-worker dispatch counters (perf evidence that connections
        # actually spread across the loops)
        self.worker_dispatched = [0] * self.workers
        # messenger perf registry (the AsyncMessenger perf counters
        # role, src/msg/async/AsyncMessenger.cc l_msgr_*): dispatch
        # count + pow2-µs latency histogram, throttle-wait seconds,
        # drops split by cause, live queue depth — per endpoint, under
        # the process-wide collection so `perf dump` and the exporter
        # see them with zero extra wiring
        self.perf = global_perf().create(f"msg.{name}")
        self.perf.add_many(MSG_COUNTERS)
        for h in MSG_HISTOGRAMS:
            self.perf.add(h, CounterType.HISTOGRAM)
        for t in MSG_TIMES:
            self.perf.add(t, CounterType.TIME)
        for g in MSG_GAUGES:
            self.perf.add(g, CounterType.U64)
        network.register(self)

    # -- lifecycle ---------------------------------------------------------
    def add_dispatcher(self, d: Dispatcher) -> None:
        self._dispatchers.append(d)

    def start(self) -> None:
        if not self._threads:
            for i in range(self.workers):
                t = threading.Thread(
                    target=self._dispatch_loop, args=(i,),
                    name=f"ms-{self.name}-w{i}", daemon=True)
                t.start()
                self._threads.append(t)

    def shutdown(self) -> None:
        self._stopped = True
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join(timeout=5)
        self.network.unregister(self.name)
        # drop the perf registry: a long-lived process churns client
        # endpoints, and dead registries would grow every `perf dump`
        # and exporter scrape forever (frozen queue-depth gauges incl.)
        global_perf().remove(f"msg.{self.name}")

    # -- introspection -----------------------------------------------------
    def queue_depths(self) -> list[int]:
        """Per-worker queued-message counts (the dump_messenger /
        stats-report face of the sharded loops)."""
        return [q.qsize() for q in self._queues]

    def dump_state(self) -> dict:
        """The ``dump_messenger`` admin-verb document for this
        endpoint: worker fan-out, per-worker dispatch/queue state,
        throttle occupancy and the perf registry."""
        out = {"name": self.name, "workers": self.workers,
               "dispatched": list(self.worker_dispatched),
               "queue_depths": self.queue_depths(),
               "perf": self.perf.dump()}
        if self._throttle is not None:
            out["throttle"] = {"current": self._throttle.current,
                               "max": self._throttle.max}
        return out

    # -- sending -----------------------------------------------------------
    def connect(self, peer: str) -> Connection:
        return Connection(self, peer)

    def send_message(self, peer: str, msg) -> bool:
        return self.connect(peer).send(msg)

    # -- receiving ---------------------------------------------------------
    def shard_of(self, src: str) -> int:
        """Worker a peer's messages are pinned to (stable across the
        process: per-peer FIFO must never depend on hash seeding).  The
        multiplicative mix decorrelates the near-identical entity names
        (client.N / osd.N) that raw crc32 mod small clusters badly."""
        return (zlib.crc32(src.encode()) * 2654435761 % (1 << 32)) \
            % self.workers

    def _enqueue(self, src: str, msg) -> bool:
        if self._stopped:
            return False
        throttled = False
        # the cap counts clients' messages alone (an OSD's
        # osd_client_message_cap): a peer's message has no retry, and
        # Ceph carries peers on a cluster messenger outside that cap
        if self._throttle and src.startswith("client."):
            if self._throttle.try_get():
                throttled = True
            elif self.policy.lossy:
                # backpressure: lossy servers drop, lossless block
                self.perf.inc("msg_drop_backpressure")
                self.network.note_backpressure_drop()
                return True
            else:
                t0 = time.perf_counter()
                # a timed-out get() took NO unit: the message still
                # enqueues (lossless peers never drop), but the worker
                # must not put() back a unit that was never acquired —
                # that would silently widen the cap under overload
                throttled = self._throttle.get(1, timeout=5)
                self.perf.tinc("msg_throttle_wait_time",
                               time.perf_counter() - t0)
        self.perf.inc("msg_queue_depth")
        self._queues[self.shard_of(src)].put((src, msg, throttled))
        return True

    def _dispatch_loop(self, worker: int) -> None:
        q = self._queues[worker]
        while True:
            item = q.get()
            if item is None:
                break
            src, msg, throttled = item
            conn = Connection(self, src)
            t0 = time.perf_counter()
            try:
                for d in self._dispatchers:
                    if d.ms_dispatch(conn, msg):
                        break
                else:
                    dout("msg", 0)("%s: unhandled %s from %s", self.name,
                                   type(msg).__name__, src)
            except Exception as e:  # noqa: BLE001 - daemon must survive
                dout("msg", 0)("%s: dispatch error on %s from %s: %r",
                               self.name, type(msg).__name__, src, e)
            finally:
                self.worker_dispatched[worker] += 1
                self.perf.inc("msg_dispatched")
                tr = getattr(msg, "trace", None)
                self.perf.hinc("msg_dispatch_us",
                               (time.perf_counter() - t0) * 1e6,
                               exemplar=tr[0] if tr else None)
                self.perf.inc("msg_queue_depth", -1)
                if self._throttle and throttled:
                    self._throttle.put()
