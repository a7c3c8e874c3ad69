"""The port's OSD at its device seams, each by name.

- §0, the default backend: the port's ``ec_backend`` defaults to
  ``torch``, so a pool without a ``backend`` in its profile gets its
  codec on the card (and, on a host without one, a refusal that names
  the card); an explicit ``auto`` resolves as in the JAX package, and a
  pool's profile wins over the option.
- (a) batching: ``_ec_batch_on`` engages ``auto`` on torch pools under
  the mclock queue, as the JAX package's does on jax pools.
- (b) the arena: built by ``_pool_codec`` on the device of a torch
  pool's codec, one a device, and attached to the extent cache; an OSD
  of native or numpy pools never builds one, and constructs and serves
  with no card; an OSD with pools on two devices stages each pool's
  reads on its own device.
- (c) the cached read: ``_ec_cached_ro`` assembles a torch pool's
  streams from the arena with torch and one metered copy back, equal to
  the host assembly; a failing device assembly raises; a stream that is
  not cached falls through to the host.
- (d) the scrub verifier: ``osd_scrub_fold=auto`` on a host without a
  card sweeps on the host (the native library), not the plain version
  of the CRC kernel; ``device`` forces the torch path, there on the CPU
  (``ec.verify.verifier`` picks the device).
- Peers' messages: an OSD drops a client's message past its messenger
  throttle or its op queue's cap (the client resends), and never a
  peer's, which has no retry (the JAX package drops both, which wedged
  peering and failed degraded reads on the card).
- (e) the library build: ``_pool_codec`` loads the CUDA library before
  it caches the codec of a pool on the card, and never for a pool on
  the CPU; a map that brings an EC pool has its codec built, and so the
  library loaded, before the map reaches the op handlers.
- A lost member: a write waiting on an OSD that a new map marks down is
  failed at once with EAGAIN, which the client retries on the new map
  (the JAX package waits out ``osd_op_timeout`` and answers EIO).
- A handed-over PG: an OSD that has answered a newer map's peering query
  for a PG refuses (EAGAIN) a client op it admitted under an older map,
  so a write its new primary never heard of is never acked (the JAX
  package acks it, and the new primary answers ENOENT for it); and a
  new primary refuses ops on a map whose peering rounds it has not yet
  armed (the JAX package reads its unpeered store: ENOENT).
"""

import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import ErasureCodeError
from ceph_tpu_torch.mon.maps import OSDMap, PoolSpec
from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.msg.messages import (MMonSubscribe, MOSDOp, MPGInfo,
                                         MPGQuery, PgId)
from ceph_tpu_torch.msg.messenger import LocalNetwork
from ceph_tpu_torch.ops import ec_kernels
from ceph_tpu_torch.osd import daemon
from ceph_tpu_torch.tools.vstart import MiniCluster
from ceph_tpu_torch.utils import staging
from ceph_tpu_torch.utils.config import default_config

RNG = np.random.default_rng(12)
TPU = {"plugin": "tpu", "k": "4", "m": "2"}


def make_cfg(**over):
    """The JAX package's ``tests/test_cluster.py`` ``make_cfg`` settings
    on the port, less its ``ec_backend``: each test says where its
    pools run."""
    cfg = default_config()
    cfg.apply_dict({"osd_heartbeat_interval": 0.05,
                    "osd_heartbeat_grace": 0.5,
                    "osd_op_num_shards": 2,
                    "ms_dispatch_workers": 2, **over})
    return cfg


@pytest.fixture
def bare_osd():
    """An OSD that is built but not started, with a map of the pools a
    test hands to ``pools``."""
    made = []

    def make(pools: dict, cfg=None):
        osd = daemon.OSDDaemon(0, LocalNetwork(), cfg=cfg or make_cfg())
        omap = OSDMap()
        for pid, profile in pools.items():
            omap.pools[pid] = PoolSpec(pid, f"p{pid}", "ec", 6, 5, 4,
                                       dict(profile))
        osd.osdmap = omap
        made.append(osd)
        return osd

    yield make
    for osd in made:
        osd.stop()


# ------------------------------------------------- §0: the default backend
def test_default_ec_backend_puts_a_tpu_pool_on_the_card(bare_osd,
                                                        monkeypatch):
    seen = []
    real = daemon.ec.factory

    def spy(plugin, profile):
        seen.append(dict(profile))
        return real(plugin, profile)

    monkeypatch.setattr(daemon.ec, "factory", spy)
    osd = bare_osd({1: TPU})
    assert osd.cfg["ec_backend"] == "torch"
    if torch.cuda.is_available():
        codec = osd._pool_codec(1)
        assert (codec._backend, codec.device.type) == ("torch", "cuda")
    else:
        with pytest.raises(ErasureCodeError, match="device cuda"):
            osd._pool_codec(1)
    assert seen[0]["backend"] == "torch" and "device" not in seen[0]


def test_explicit_auto_resolves_as_in_the_reference(bare_osd):
    osd = bare_osd({1: TPU}, cfg=make_cfg(ec_backend="auto"))
    codec = osd._pool_codec(1)
    assert codec._backend == "native" and codec.device is None
    assert not osd._ec_cache._arenas


@pytest.mark.parametrize("profile,option,want", [
    ({"backend": "torch", "device": "cpu"}, "native", ("torch", "cpu")),
    ({"device": "cpu"}, "torch", ("torch", "cpu")),
    ({"backend": "native"}, "torch", ("native", None)),
    ({"backend": "numpy"}, "torch", ("numpy", None)),
])
def test_pool_profile_wins_over_the_option(bare_osd, profile, option, want):
    osd = bare_osd({1: dict(TPU, **profile)},
                   cfg=make_cfg(ec_backend=option))
    codec = osd._pool_codec(1)
    dev = codec.device.type if codec.device is not None else None
    assert (codec._backend, dev) == want


# ------------------------------------------------------ (a) batching
@pytest.mark.parametrize("backend,queue,want", [
    ("torch", "mclock", True), ("native", "mclock", False),
    ("numpy", "mclock", False), ("torch", "fifo", False)])
def test_batching_engages_on_torch_pools_under_mclock(bare_osd, backend,
                                                      queue, want):
    osd = bare_osd({1: dict(TPU, backend=backend, device="cpu")},
                   cfg=make_cfg(osd_op_queue=queue))
    assert osd._ec_batch_on(osd._pool_codec(1)) is want


def test_pool_batch_key_still_wins(bare_osd):
    osd = bare_osd({1: dict(TPU, backend="native", batch="on"),
                    2: dict(TPU, device="cpu", batch="off")})
    assert osd._ec_batch_on(osd._pool_codec(1)) is True
    assert osd._ec_batch_on(osd._pool_codec(2)) is False


# --------------------------------------------------------- (b) the arena
@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_host_pools_build_no_arena(bare_osd, backend):
    osd = bare_osd({1: dict(TPU, backend=backend)})
    assert not osd._ec_cache._arenas
    osd._pool_codec(1)
    assert not osd._ec_cache._arenas


def test_torch_cpu_pool_arena_lives_on_the_cpu(bare_osd):
    osd = bare_osd({1: dict(TPU, device="cpu"),
                    2: dict(TPU, backend="native"),
                    3: dict(TPU, device="cpu", k="2")},
                   cfg=make_cfg(ec_arena_max_bytes=1 << 20))
    osd._pool_codec(2)
    assert not osd._ec_cache._arenas
    osd._pool_codec(1)
    arena = osd._ec_cache.arena("cpu")
    assert arena is not None and arena.device == torch.device("cpu")
    assert list(osd._ec_cache._arenas.values()) == [arena]
    assert arena._max == 1 << 20
    osd._pool_codec(3)  # a second pool on the CPU reuses its arena
    assert list(osd._ec_cache._arenas.values()) == [arena]


def test_native_cluster_serves_with_no_arena():
    """A native-pool cluster constructs and serves on a host without a
    card, and no OSD stages a byte."""
    c = MiniCluster(n_osds=6, cfg=make_cfg(ec_backend="native")).start()
    try:
        cl = c.client()
        cl.create_pool("ec", kind="ec", pg_num=2, ec_profile=dict(TPU))
        h2d = staging.stage_perf().get("ec_stage_h2d_bytes")
        data = RNG.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
        cl.write_full("ec", "obj", data)
        for _ in range(3):
            assert cl.read("ec", "obj") == data
        assert not any(o._ec_cache._arenas for o in c.osds.values())
        assert staging.stage_perf().get("ec_stage_h2d_bytes") == h2d
    finally:
        c.stop()


# ---------------------------------------------------- (c) the cached read
def cached_object(osd, pid: int, nbytes: int):
    """Write one object's data streams into ``osd``'s extent cache as
    the write path does; returns (codec, si, pgid, payload, slen)."""
    codec = osd._pool_codec(pid)
    si = osd._pool_stripe(pid)
    payload = RNG.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    streams = si.ro_scatter(payload)
    pgid = PgId(pid, 0)
    for shard in range(codec.k):
        osd._ec_cache.write(pgid, "obj", shard, 0, streams[shard].tobytes(),
                            version=1, length=nbytes)
    return codec, si, pgid, payload, si.object_chunk_size(nbytes)


def test_cached_read_assembles_from_the_arena(bare_osd):
    osd = bare_osd({1: dict(TPU, device="cpu")})
    codec, si, pgid, payload, slen = cached_object(osd, 1, 70_000)
    pc = staging.stage_perf()
    hits, d2h = pc.get("ec_arena_hits"), pc.get("ec_stage_d2h_copies")
    for n in range(2):
        ro = osd._ec_cached_ro(codec, si, pgid, "obj", 0, slen)
        assert ro[:len(payload)] == payload
    # the second assembly found every stream in the arena, and each
    # assembly left the device in one copy
    assert pc.get("ec_arena_hits") - hits == codec.k
    assert pc.get("ec_stage_d2h_copies") - d2h == 2
    # equal to the host assembly of the same streams
    parts = [np.frombuffer(osd._ec_cache.read(pgid, "obj", s, 0, slen),
                           dtype=np.uint8) for s in range(codec.k)]
    assert ro == si.ro_assemble(parts).tobytes()


def test_cached_read_raises_on_a_failing_device_stack(bare_osd,
                                                      monkeypatch):
    osd = bare_osd({1: dict(TPU, device="cpu")})
    codec, si, pgid, _payload, slen = cached_object(osd, 1, 40_000)

    def broken(*_a, **_k):
        raise RuntimeError("device assembly failed")

    monkeypatch.setattr(daemon.torch, "stack", broken)
    with pytest.raises(RuntimeError, match="device assembly failed"):
        osd._ec_cached_ro(codec, si, pgid, "obj", 0, slen)


def test_uncached_stream_falls_to_the_host(bare_osd):
    osd = bare_osd({1: dict(TPU, device="cpu")})
    codec, si, pgid, payload, slen = cached_object(osd, 1, 40_000)
    osd._ec_cache.drop_shards(pgid, "obj", [codec.k - 1])
    assert osd._ec_cached_ro(codec, si, pgid, "obj", 0, slen) is None
    # a native pool's cached read assembles on the host alone
    osd2 = bare_osd({1: dict(TPU, backend="native")})
    codec, si, pgid, payload, slen = cached_object(osd2, 1, 40_000)
    ro = osd2._ec_cached_ro(codec, si, pgid, "obj", 0, slen)
    assert ro[:len(payload)] == payload and not osd2._ec_cache._arenas


# ------------------------------------------------- (d) the scrub verifier
def test_cpu_folded_scrub_uses_the_native_sweep():
    """``osd_scrub_fold=auto`` (the default) without a card: a torch/cpu
    EC pool's shards fold through the native sweep, so the scrub runs no
    plain version of the CRC kernel."""
    from ceph_tpu_torch.ec.verify import verifier

    assert str(default_config()["osd_scrub_fold"]) == "auto"
    if torch.cuda.is_available():
        pytest.skip("on a card, auto is the CRC32C kernel")
    assert verifier("auto").fold_sig() == ("crc32c", "native")
    c = MiniCluster(n_osds=4, cfg=make_cfg(osd_op_queue="fifo",
                                           osd_scrub_chunk_max=8)).start()
    try:
        cl = c.client()
        cl.create_pool("ec", kind="ec", pg_num=1,
                       ec_profile={"plugin": "tpu", "k": "2", "m": "1",
                                   "device": "cpu"})
        payload = RNG.integers(0, 256, 9000, dtype=np.uint8).tobytes()
        cl.write_full("ec", "obj", payload)
        pool_id = cl._pool_id("ec")
        seed = c.mon.osdmap.object_to_pg(pool_id, "obj")
        up = c.mon.osdmap.pg_to_up_osds(pool_id, seed)
        plain = ec_kernels.launch_counts()["plain"]
        for osd_id in up:
            force_scrub(c.osds[osd_id])
            perf = c.osds[osd_id].perf
            assert perf.get("scrub_mismatches") == 0
            assert perf.get("scrub_verified_bytes") > 0
        assert ec_kernels.launch_counts()["plain"] == plain
    finally:
        c.stop()


@pytest.mark.parametrize("mode,backend", [("auto", "native"),
                                          ("native", "native"),
                                          ("device", "torch")])
def test_scrub_verifier_per_mode_without_a_card(mode, backend):
    """``device`` forces the torch path, on the CPU of a host without a
    card (the JAX package's runs its device graph on the CPU there); an
    OSD whose verifier asked for the card there aborted every cycle."""
    if torch.cuda.is_available():
        pytest.skip("on a card, auto and device are the CRC32C kernel")
    from ceph_tpu_torch.ec.verify import verifier

    ver = verifier(str(make_cfg(osd_scrub_fold=mode)["osd_scrub_fold"]))
    assert ver.fold_sig() == ("crc32c", backend)
    if backend == "torch":
        assert ver.device == torch.device("cpu")


def force_scrub(osd):
    """Arm and run one background deep-scrub cycle on every hosted PG
    (the JAX package's ``tests/test_scrub_fold.py`` helper)."""
    import time

    osd._scrub_tick(time.time())
    for st in osd._scrub_auto.values():
        st["due"] = 0.0
    osd._scrub_tick(time.time())


# ----------------------------------------------------- (e) the library
class _FakeCodec:
    """Stands in for a torch codec on the card, on a host without one."""

    k, m = 4, 2
    profile: dict = {}

    def __init__(self, device):
        self._backend = "torch"
        self.device = torch.device(device)


class _FakeArena:
    def __init__(self, max_bytes, device):
        self.max_bytes, self.device = max_bytes, device
        self.drops = 0

    def drop_where(self, _pred):
        self.drops += 1

    def clear(self):
        self.drops += 1


@pytest.mark.parametrize("device,loads", [("cuda", 1), ("cpu", 0)])
def test_pool_codec_loads_the_library_before_caching(bare_osd, monkeypatch,
                                                     device, loads):
    osd = bare_osd({1: dict(TPU), 2: dict(TPU)})
    calls = []
    monkeypatch.setattr(daemon.ec, "factory",
                        lambda plugin, profile: _FakeCodec(device))
    monkeypatch.setattr(daemon, "DeviceArena", _FakeArena)
    monkeypatch.setattr(daemon.cuda_lib, "lib",
                        lambda: calls.append(dict(osd._ec_codecs)))
    codec = osd._pool_codec(1)
    assert len(calls) == loads
    if loads:
        assert 1 not in calls[0]  # loaded before the codec was cached
    assert osd._ec_codecs[1] is codec
    assert osd._ec_cache.arena(device).device == torch.device(device)
    osd._pool_codec(1)  # cached: no second load
    assert len(calls) == loads


def test_map_builds_its_pools_codecs_before_publishing(bare_osd,
                                                      monkeypatch):
    """A map that brings an EC pool on the card loads the library and
    caches the pool's codec before the OSD's map, which every op
    handler reads, holds the pool: no client op of the pool can reach
    the OSD first."""
    from ceph_tpu_torch.msg.messages import MMapPush

    osd = bare_osd({})
    osd.osdmap = None
    omap = OSDMap()
    omap.epoch = 1
    omap.pools[1] = PoolSpec(1, "p1", "ec", 6, 5, 4, dict(TPU))
    omap.pools[2] = PoolSpec(2, "p2", "replicated", 3, 2, 4, {})
    calls = []
    monkeypatch.setattr(daemon.ec, "factory",
                        lambda plugin, profile: _FakeCodec("cuda"))
    monkeypatch.setattr(daemon, "DeviceArena", _FakeArena)
    monkeypatch.setattr(daemon.cuda_lib, "lib", lambda: calls.append(
        (osd.osdmap, dict(osd._ec_codecs))))
    osd._handle_map(None, MMapPush(1, map_bytes=omap.encode_bytes()))
    assert calls == [(None, {})]
    assert osd.osdmap.epoch == 1 and list(osd._ec_codecs) == [1]
    assert osd._ec_cache.arena("cuda") is not None


def test_map_logs_a_codec_that_cannot_be_built(bare_osd):
    """Without a card, a default pool's codec fails at the map as it
    would on the op path; the map is applied all the same."""
    from ceph_tpu_torch.msg.messages import MMapPush

    if torch.cuda.is_available():
        pytest.skip("on a card, the default pool's codec builds")
    osd = bare_osd({})
    osd.osdmap = None
    omap = OSDMap()
    omap.epoch = 1
    omap.pools[1] = PoolSpec(1, "p1", "ec", 6, 5, 4, dict(TPU))
    osd._handle_map(None, MMapPush(1, map_bytes=omap.encode_bytes()))
    assert osd.osdmap.epoch == 1 and not osd._ec_codecs
    with pytest.raises(ErasureCodeError, match="device cuda"):
        osd._pool_codec(1)


def test_pools_on_two_devices_keep_an_arena_each(bare_osd, monkeypatch):
    """A torch/cpu pool and a pool on the card in one OSD: each device
    gets its own arena, the CPU pool's cached reads stay in the CPU
    arena, and an invalidation reaches both."""
    osd = bare_osd({1: dict(TPU, device="cpu"), 2: dict(TPU)})
    codec, si, pgid, payload, slen = cached_object(osd, 1, 40_000)
    cpu_arena = osd._ec_cache.arena("cpu")
    monkeypatch.setattr(daemon.ec, "factory",
                        lambda plugin, profile: _FakeCodec("cuda"))
    monkeypatch.setattr(daemon, "DeviceArena", _FakeArena)
    monkeypatch.setattr(daemon.cuda_lib, "lib", lambda: None)
    osd._pool_codec(2)
    card_arena = osd._ec_cache.arena("cuda")
    assert isinstance(card_arena, _FakeArena)
    assert osd._ec_cache.arena("cpu") is cpu_arena
    pc = staging.stage_perf()
    hits = pc.get("ec_arena_hits") if pc.has("ec_arena_hits") else 0
    for _ in range(2):
        ro = osd._ec_cached_ro(codec, si, pgid, "obj", 0, slen)
        assert ro[:len(payload)] == payload
    assert pc.get("ec_arena_hits") - hits == codec.k
    assert osd._ec_cache.read_device(pgid, "obj", 0, 0, slen,
                                     "cpu").device.type == "cpu"
    drops = card_arena.drops
    osd._ec_cache.invalidate(pgid, "obj")
    assert card_arena.drops == drops + 1
    assert osd._ec_cache.read_device(pgid, "obj", 0, 0, slen, "cpu") is None


# ------------------------------------------- peers' messages never drop
def test_messenger_throttle_drops_clients_but_never_peers(bare_osd):
    """The OSD's messenger caps clients' messages in flight
    (``osd_client_message_cap``); a peer OSD's or the monitor's pass."""
    from ceph_tpu_torch.msg.messages import MPGQuery

    osd = bare_osd({}, cfg=make_cfg(osd_client_message_cap=2))
    msgr = osd.messenger  # not started: nothing leaves its queues
    msg = MPGQuery(PgId(1, 0), 1)
    for _ in range(5):
        msgr._enqueue("client.7", msg)
    assert msgr.perf.get("msg_drop_backpressure") == 3
    for src in ("osd.3", "mon.a"):
        for _ in range(5):
            msgr._enqueue(src, msg)
    assert msgr.perf.get("msg_drop_backpressure") == 3
    assert sum(msgr.queue_depths()) == 2 + 10


def test_op_queue_cap_drops_clients_but_never_peers(bare_osd, monkeypatch):
    """Past its QUEUE_CAP a shard's class queue drops a client's message
    and queues a peer's: a peering query, its answer and a sub-read's
    reply each have no retry."""
    from ceph_tpu_torch.msg.messages import MPGList, MPGQuery
    from ceph_tpu_torch.msg.messenger import Connection
    from ceph_tpu_torch.osd.scheduler import MClockScheduler

    monkeypatch.setattr(MClockScheduler, "QUEUE_CAP", 2)
    osd = bare_osd({})  # mclock, its workers not started
    pgid = PgId(1, 0)
    peer = Connection(osd.messenger, "osd.3")
    client = Connection(osd.messenger, "client.7")
    for _ in range(4):
        assert osd.ms_dispatch(peer, MPGQuery(pgid, 1))
    assert osd.scheduler.dropped["system"] == 0
    for tid in range(4):
        assert osd.ms_dispatch(client, MPGList(tid, pgid))
    assert osd.scheduler.dropped["system"] == 4
    assert osd.scheduler.queue_depths()["system"] == 4


@pytest.mark.parametrize("kind", ["replicated", "ec"])
def test_a_write_waiting_on_a_lost_member_is_retried_at_once(kind):
    """The primary's sub-write to one member is cut off, so the write
    waits for its ack; the member is then lost and marked down.  The map
    that says so fails the write at once (``ops_reset_on_down``, not
    ``op_timeouts``), and the client's retry lands on the new map long
    before the 60 s op timeout; the object reads back."""
    torch.set_num_threads(1)
    c = MiniCluster(n_osds=4, cfg=make_cfg(
        osd_op_timeout=60.0, osd_heartbeat_grace=30.0)).start()
    try:
        client = c.client()
        if kind == "ec":
            client.create_pool("p", kind="ec", pg_num=1, ec_profile={
                "plugin": "tpu", "k": "2", "m": "1", "device": "cpu"})
        else:
            client.create_pool("p", size=3, pg_num=1)
        client.write_full("p", "warm", b"w" * 4096)  # the PG has peered
        pid = client._pool_id("p")
        primary, member = client.osdmap.pg_to_up_osds(pid, 0)[:2]
        c.network.partition(f"osd.{primary}", f"osd.{member}")
        data = RNG.integers(0, 256, 8192, dtype=np.uint8).tobytes()
        done: dict = {}

        def write():
            try:
                client.write_full("p", "x", data)
            except Exception as e:  # noqa: BLE001 - asserted below
                done["error"] = e
            done["at"] = time.monotonic()

        t = threading.Thread(target=write, daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while not c.osds[primary]._pending_writes:
            assert time.monotonic() < deadline, "the write never waited"
            time.sleep(0.01)
        t0 = time.monotonic()
        c.kill_osd(member)
        t.join(30)
        assert not t.is_alive() and "error" not in done, done
        assert done["at"] - t0 < 15
        perf = c.osds[primary].perf
        assert c.osds[primary].ops_reset_on_down >= 1
        assert perf.get("op_timeouts") == 0
        assert client.read("p", "x") == data
    finally:
        c.network.heal()
        c.stop()


def test_a_read_waiting_on_a_lost_member_completes_on_the_map(bare_osd):
    """A recovery fetch and a client read each wait on a sub-read sent
    to OSD 5; the map that marks OSD 5 down answers those sub-reads as
    failed reads, so the fetch's callback runs and the read completes
    on the live members' chunks, at once, not at the op timeout."""
    osd = bare_osd({1: dict(TPU, device="cpu")})  # k = 4
    omap = OSDMap()
    for o in (0, 4, 5):
        omap.add_osd(o, f"host{o}")
        omap.mark_up(o)
    done = []
    fetch = daemon._PendingRead(None, 0, 1, "x", total_shards=1,
                                on_done=done.append, asked={2: 5})
    read = daemon._PendingRead(None, 0, 1, "y", total_shards=3,
                               on_done=done.append, asked={1: 4, 2: 5})
    read.replies, read.chunks = 1, {0: np.zeros(4, np.uint8)}
    osd._pending_reads.update({11: fetch, 12: read})
    osd._reset_ops_on_down(omap)  # every member up: nothing happens
    assert not done and len(osd._pending_reads) == 2
    omap.mark_down(5)
    osd._reset_ops_on_down(omap)
    assert done == [fetch]  # the read still waits on OSD 4
    assert fetch.replies == 1 and not fetch.chunks
    assert read.asked == {1: 4} and read.replies == 2
    osd._on_shard_read(12, 1, 0, b"\1" * 4, {})
    assert done == [fetch, read] and sorted(read.chunks) == [0, 1]
    assert not osd._pending_reads
    assert osd.ops_reset_on_down == 2
    assert osd.perf.get("op_timeouts") == 0


class _Noting:
    """A connection that sets ``sent`` once an MPGInfo leaves on it."""

    def __init__(self, conn, sent: threading.Event):
        self._conn, self._sent = conn, sent

    def send(self, msg):
        if isinstance(msg, MPGInfo):
            self._sent.set()
        return self._conn.send(msg)

    def __getattr__(self, name):
        return getattr(self._conn, name)


def test_an_acked_write_reads_back_after_its_pg_is_handed_over():
    """The rolling restart's unreadable acked write, staged.  Size 2 on
    3 OSDs: A is killed and marked down, so B is primary of the PG on
    map E1.  B's and the client's links to the monitor are cut, so both
    stay on E1 while A comes back and map E2 makes A primary again.  A
    queries B; B has not applied E2, defers, and answers with what it
    has (``_handle_pg_query``'s bounded deferral).  Only then does the
    client, still on E1, write an object through B.

    The JAX package behaves as the port did before the repair: B admits
    the write under E1 and acks it (``ceph_tpu/osd/daemon.py:1552``, the
    peering gate, is its only check), while A, whose peering closed on
    B's answer, never learns of the object and its ``_rep_read``
    (``:1805``) answers ENOENT; B's answer is ``_handle_pg_query``
    (``:5055``).  In the port B refuses the op (EAGAIN) once it has
    answered E2's query; the client's retry lands on A on E2, and the
    object reads back."""
    torch.set_num_threads(1)
    c = MiniCluster(n_osds=3, cfg=make_cfg(
        osd_op_timeout=60.0, osd_heartbeat_grace=30.0)).start()
    try:
        client = c.client()
        client.create_pool("p", size=2, pg_num=1)
        client.write_full("p", "warm", b"w" * 1024)
        pid = client._pool_id("p")
        a = client.osdmap.pg_to_up_osds(pid, 0)[0]
        store = c.kill_osd(a)
        deadline = time.monotonic() + 30
        while True:  # B has peered on E1 and serves (a listing answers)
            try:
                assert client.list_objects("p") == ["warm"]
                break
            except RadosError:
                assert time.monotonic() < deadline, "B never served"
                time.sleep(0.05)
        e1 = client.osdmap.epoch
        b = client.osdmap.pg_to_up_osds(pid, 0)[0]
        assert b != a
        answered = threading.Event()
        handle = c.osds[b]._handle_pg_query
        c.osds[b]._handlers[MPGQuery] = lambda conn, m: handle(
            _Noting(conn, answered) if m.epoch > e1 else conn, m)
        c.network.partition("mon.0", f"osd.{b}")
        c.network.partition("mon.0", client.name)
        c.revive_osd(a, store)
        assert answered.wait(30), "B never answered A's query"
        assert c.osds[b].osdmap.epoch == client.osdmap.epoch == e1
        data = RNG.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        done: dict = {}

        def write():
            for _attempt in range(20):  # an unacked write may be retried
                try:
                    client.write_full("p", "x", data)
                    done["acked"] = True
                    return
                except RadosError as e:
                    done["error"] = e
                    time.sleep(0.2)

        t = threading.Thread(target=write, daemon=True)
        t.start()
        deadline = time.monotonic() + 30
        while not done and not getattr(c.osds[b],
                                       "ops_refused_handed_over", 0):
            assert time.monotonic() < deadline, "the write never reached B"
            time.sleep(0.01)
        # the links come back; B and the client ask for the maps they
        # missed, and the object is read on E2, through A
        c.network.heal()
        for who in (c.osds[b], client):
            who.messenger.send_message(who.mon, MMonSubscribe(
                "osdmap", have_epoch=e1))
        t.join(60)
        assert not t.is_alive() and done.get("acked"), done
        reader = c.client()
        assert reader.osdmap.pg_to_up_osds(pid, 0)[0] == a
        assert reader.read("p", "x") == data
        assert c.osds[b].ops_refused_handed_over >= 1
    finally:
        c.network.heal()
        c.stop()


class _Replies:
    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)


def test_a_new_primary_serves_no_op_before_its_peering_is_armed():
    """``_handle_map`` publishes a map to the op handlers before it arms
    that map's peering rounds (``_start_recovery``).  An OSD that the
    published map makes primary, with no peering round armed yet, is
    asked for an object it does not hold: it answers EAGAIN (the client
    retries once the round gates the PG), not ENOENT from a store that
    has not peered.  Seen in the rolling restart: a write acked by the
    old primary read back ENOENT for 0.4 s from the new one.  The JAX
    package answers ENOENT: it sets ``_applied_epoch`` before
    ``_start_recovery`` (``ceph_tpu/osd/daemon.py:1395``) and gates ops
    only on ``_peering`` (``:1552``)."""
    osd = daemon.OSDDaemon(0, LocalNetwork(), cfg=make_cfg())
    try:
        omap = OSDMap()
        omap.add_osd(0, "host0")
        omap.mark_up(0)
        omap.pools[1] = PoolSpec(1, "p", "replicated", 2, 1, 1)
        omap.epoch = 7
        osd.osdmap = omap
        osd._ensure_collections()
        osd._applied_epoch = 6  # published, its peering not yet armed
        conn = _Replies()
        osd._handle_client_op(conn, MOSDOp(1, "client.0", 1, "x", "read",
                                           epoch=7))
        assert [r.result for r in conn.sent] == [daemon.EAGAIN]
        osd._applied_epoch = 7  # armed, and nothing to peer: served
        osd._handle_client_op(conn, MOSDOp(2, "client.0", 1, "x", "read",
                                           epoch=7))
        assert conn.sent[-1].result == daemon.ENOENT
    finally:
        osd.stop()
