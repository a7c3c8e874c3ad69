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
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import ErasureCodeError
from ceph_tpu_torch.mon.maps import OSDMap, PoolSpec
from ceph_tpu_torch.msg.messages import PgId
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
