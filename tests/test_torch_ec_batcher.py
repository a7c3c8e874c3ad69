"""ECBatcher of the port (ceph_tpu_torch/ec/batcher.py) on the CPU
device: the contracts of the JAX package's batcher tests
(tests/test_ec_batcher.py) — batched vs per-op byte-exactness against
the numpy oracle, every flush path (window / size / idle), mixed lengths
and signatures in flight, degraded-read decode coalescing, pass-through —
and bursts run through both batchers on the same seeded inputs, which
must give identical parity, csums, decoded bytes and launch statistics.
Every comparison is exact (tolerance 0)."""

import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu import ec as jax_ec
from ceph_tpu.ec.batcher import ECBatcher as JaxECBatcher
from ceph_tpu_torch import ec
from ceph_tpu_torch.ec import batcher as batcher_mod
from ceph_tpu_torch.ec.batcher import (ECBatcher, FLUSH_IDLE, FLUSH_SIZE,
                                       FLUSH_WINDOW, bucket_len)
from ceph_tpu_torch.ec.matrix_code import KERNEL_RACE_ORDER
from ceph_tpu_torch.ops import gf256, native
from ceph_tpu_torch.parallel import mesh as meshmod
from ceph_tpu_torch.utils import staging
from ceph_tpu_torch.utils.perf import kernel_profiler

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

RNG = np.random.default_rng(11)


def _codec(k=4, m=2, **profile):
    return ec.factory("tpu", {"k": str(k), "m": str(m), "device": "cpu",
                              **profile})


def _oracle_parity(codec, data):
    return gf256.encode_region(codec.matrix, data)


def _oracle_csums(data, parity):
    stack = np.concatenate([data, np.asarray(parity)], axis=0)
    return np.array([native.crc32c(row) for row in stack], dtype=np.uint32)


def _run(fns, stagger=0.0):
    """Run each fn in its own thread (the first leads by ``stagger``);
    returns the results in order, raising any thread's error."""
    results = [None] * len(fns)
    errors = []

    def run(i):
        try:
            results[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    # daemon threads: a thread stuck past the join below fails the test
    # and cannot keep the worker process from exiting
    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(fns))]
    threads[0].start()
    time.sleep(stagger)
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


def _burst(batcher, codec, payloads, *, with_csums=False, stagger=0.02):
    """Submit each payload from its own thread; first thread leads."""
    return _run([lambda d=d: batcher.encode(codec, d,
                                            with_csums=with_csums)
                 for d in payloads], stagger)


def test_bucket_len_bounded():
    assert [bucket_len(n) for n in (1, 512, 513, 768, 769, 4096, 4097,
                                    5000, 6145)] == \
        [512, 512, 768, 768, 1024, 4096, 6144, 6144, 8192]


def test_bucket_len_pad_waste_bounded():
    from ceph_tpu.ec.batcher import bucket_len as jax_bucket_len

    for L in range(512, 20_000, 7):
        b = bucket_len(L)
        assert b >= L and b % 4 == 0
        assert b - L <= L * 0.5, (L, b)
        assert b == jax_bucket_len(L)
    buckets = {bucket_len(L) for L in range(1, 1 << 20, 13)}
    assert buckets == {512, 768, 1024, 1536, 2048, 3072, 4096, 6144,
                       8192, 12_288, 16_384, 24_576, 32_768, 49_152,
                       65_536, 98_304, 131_072, 196_608, 262_144,
                       393_216, 524_288, 786_432, 1 << 20}


def test_passthrough_window0_bit_identical_no_leaks():
    codec = _codec()
    b = ECBatcher(window_us=0)
    fired = []
    for L in (512, 1000, 4096):
        data = RNG.integers(0, 256, (4, L), dtype=np.uint8)
        parity, csums = b.encode(codec, data, with_csums=True,
                                 callback=lambda p, c: fired.append(1))
        want_p, want_c = codec.encode_chunks_with_csums(data)
        assert np.array_equal(parity, want_p)
        assert np.array_equal(csums, want_c)
        assert np.array_equal(csums, _oracle_csums(data, want_p))
        p2, c2 = b.encode(codec, data, with_csums=False,
                          callback=lambda p, c: fired.append(1))
        assert np.array_equal(p2, codec.encode_chunks(data))
        assert c2 is None
    full = codec.encode(b"q" * 8192)
    avail = {i: c for i, c in full.items() if i != 2}
    out = b.decode(codec, [0, 1, 2, 3], dict(avail),
                   callback=lambda o: fired.append(1))
    ref = codec.decode([0, 1, 2, 3], dict(avail))
    for i in ref:
        assert np.array_equal(out[i], ref[i])
    assert len(fired) == 7  # 3 lengths x 2 encodes + 1 decode
    assert b.pending_ops() == 0
    assert b.stats["launches"] == 7
    assert b.stats[FLUSH_IDLE] == 7 and b.stats[FLUSH_WINDOW] == 0


def test_size_flush_coalesces_two_ops_one_launch():
    codec = _codec()
    L = 4096
    b = ECBatcher(window_us=10_000_000, max_bytes=2 * 4 * L)
    pays = [RNG.integers(0, 256, (4, L), dtype=np.uint8) for _ in range(2)]
    results = _burst(b, codec, pays, with_csums=True)
    for data, (parity, csums) in zip(pays, results):
        assert np.array_equal(parity, _oracle_parity(codec, data))
        assert np.array_equal(csums, _oracle_csums(data, parity))
    assert b.stats["launches"] == 1
    assert b.stats["ops"] == 2
    assert b.stats[FLUSH_SIZE] == 1
    assert b.pending_ops() == 0


def test_mixed_lengths_coalesce_byte_exact():
    """Ops of different lengths share a bucket, pad, and slice back
    byte-exact (csums from one CRC32C launch per length — still
    exact)."""
    codec = _codec()
    lens = [1000, 900, 1024]  # one shared 1024 bucket (769..1024)
    b = ECBatcher(window_us=10_000_000, max_bytes=4 * sum(lens))
    pays = [RNG.integers(0, 256, (4, L), dtype=np.uint8) for L in lens]
    results = _burst(b, codec, pays, with_csums=True)
    for data, (parity, csums) in zip(pays, results):
        assert np.array_equal(parity, _oracle_parity(codec, data))
        assert np.array_equal(csums, _oracle_csums(data, parity))
    assert b.stats["launches"] == 1 and b.stats["ops"] == 3


def test_window_flush_coalesces():
    codec = _codec()
    L = 2048
    b = ECBatcher(window_us=1_500_000)  # 1.5 s: a safe margin
    pays = [RNG.integers(0, 256, (4, L), dtype=np.uint8) for _ in range(2)]
    results = _burst(b, codec, pays, stagger=0.1)
    for data, (parity, _c) in zip(pays, results):
        assert np.array_equal(parity, _oracle_parity(codec, data))
    assert b.stats["launches"] == 1
    assert b.stats[FLUSH_WINDOW] == 1
    assert b.stats["ops"] == 2


def test_mixed_signatures_in_flight():
    """Two (k, m) signatures in flight at once form two independent
    groups — one launch each (size flushes), exact for both codecs."""
    c42, c83 = _codec(4, 2), _codec(8, 3)
    # 4 KiB a op in both groups: each group's second op size-flushes it
    b = ECBatcher(window_us=10_000_000, max_bytes=2 * 4096)
    p42 = [RNG.integers(0, 256, (4, 1024), dtype=np.uint8)
           for _ in range(2)]
    p83 = [RNG.integers(0, 256, (8, 512), dtype=np.uint8)
           for _ in range(2)]
    fns = [lambda d=d: b.encode(c42, d) for d in p42]
    fns += [lambda d=d: b.encode(c83, d) for d in p83]
    results = _run(fns)
    for i in range(2):
        assert np.array_equal(results[i][0], _oracle_parity(c42, p42[i]))
        assert np.array_equal(results[2 + i][0],
                              _oracle_parity(c83, p83[i]))
    assert b.stats["launches"] == 2
    assert b.stats["ops"] == 4
    assert b.pending_ops() == 0


def test_degraded_decode_coalesce():
    codec = _codec()
    L = 4096
    cases = []
    for _ in range(2):
        data = RNG.integers(0, 256, (4, L), dtype=np.uint8)
        parity = _oracle_parity(codec, data)
        chunks = {0: data[0], 2: data[2], 3: data[3],
                  4: parity[0], 5: parity[1]}  # shard 1 erased
        cases.append((data, chunks))
    b = ECBatcher(window_us=10_000_000, max_bytes=2 * 5 * L)
    out = _run([lambda c=c: b.decode(codec, [0, 1, 2, 3], dict(c[1]))
                for c in cases])
    for i, (data, chunks) in enumerate(cases):
        ref = codec.decode([0, 1, 2, 3], dict(chunks))
        for s in ref:
            assert np.array_equal(out[i][s], ref[s]), (i, s)
            assert np.array_equal(out[i][s], data[s]), (i, s)
    assert b.stats["launches"] == 1
    assert b.stats["ops"] == 2
    assert b.pending_ops() == 0


def test_decode_all_present_no_launch():
    codec = _codec()
    full = codec.encode(b"y" * 8192)
    b = ECBatcher(window_us=1000)
    out = b.decode(codec, [0, 1], {i: full[i] for i in range(4)})
    assert np.array_equal(out[0], full[0])
    assert b.stats["launches"] == 0


def test_batched_encode_matches_oracle_many_lengths():
    """Sequential (idle-flush) batched encodes across many lengths stay
    byte-exact — 12_288 is not a power of two but % 4 == 0, so the fused
    encode+CRC op must still engage."""
    codec = _codec()
    b = ECBatcher(window_us=50)
    for L in (512, 513, 1000, 2048, 4096, 10_000, 12_288):
        data = RNG.integers(0, 256, (4, L), dtype=np.uint8)
        parity, csums = b.encode(codec, data, with_csums=True)
        assert np.array_equal(parity, _oracle_parity(codec, data)), L
        assert np.array_equal(csums, _oracle_csums(data, parity)), L
    assert b.pending_ops() == 0
    assert "csum/2x4/L12288x12288" in kernel_profiler().dump()[
        "signatures"]


def test_fused_csum_path_on_first_flush(monkeypatch):
    """The port compiles nothing per shape, so the fused encode+CRC op
    serves the FIRST checksummed flush (the reference warms it in a
    background thread first): its csum/ launch is profiled, no host CRC
    sweep runs, and ``csum_warm`` changes nothing."""
    sweeps = []
    monkeypatch.setattr(batcher_mod, "_host_csums",
                        lambda rows: sweeps.append(rows) or None)
    for warm in ("off", "on"):
        codec = _codec(csum_warm=warm)
        L = 1536
        b = ECBatcher(window_us=50)
        data = RNG.integers(0, 256, (4, L), dtype=np.uint8)
        before = kernel_profiler().dump()["signatures"].get(
            f"csum/2x4/L{L}x{L}", {"device": 0, "compile": 0})
        parity, csums = b.encode(codec, data, with_csums=True)
        after = kernel_profiler().dump()["signatures"][f"csum/2x4/L{L}x{L}"]
        assert (after["device"] + after["compile"]
                == before["device"] + before["compile"] + 1)
        assert codec._csum_op_if_ready(L) is not None
        assert np.array_equal(parity, _oracle_parity(codec, data))
        assert np.array_equal(csums, _oracle_csums(data, parity))
    assert sweeps == []


@pytest.mark.parametrize("lens", [(1000, 900, 1024, 1000),
                                  (1001, 1022, 1023, 1001),
                                  (1001, 1001)])
def test_unfused_csums_stay_on_the_device(monkeypatch, lens):
    """A checksummed flush the fused op cannot take — lengths that
    differ, or one that is not a whole number of words — digests its
    data and parity rows with the CRC32C kernel (its plain version on
    this CPU device) on the codec's device, one launch per distinct
    length, and the digests ride the flush's one copy back: no host CRC
    sweep, in the batcher or in a pass-through encode."""
    from ceph_tpu_torch.ec import matrix_code
    from ceph_tpu_torch.ops import ec_kernels

    sweeps = []

    def sweep(rows):
        sweeps.append(len(rows))
        return None

    monkeypatch.setattr(batcher_mod, "_host_csums", sweep)
    monkeypatch.setattr(matrix_code, "_host_csums", sweep)
    codec = _codec()
    rng = np.random.default_rng(sum(lens))
    pays = [rng.integers(0, 256, (4, L), dtype=np.uint8) for L in lens]
    stage = staging.stage_perf()
    d2h = stage.get("ec_stage_d2h_copies")
    ec_kernels.reset_launches()
    b = ECBatcher(window_us=10_000_000, max_bytes=4 * sum(lens))
    results = _burst(b, codec, pays, with_csums=True)
    for data, (parity, csums) in zip(pays, results):
        assert np.array_equal(parity, _oracle_parity(codec, data))
        assert np.array_equal(csums, _oracle_csums(data, parity))
    assert b.stats["launches"] == 1 and b.stats["ops"] == len(lens)
    assert stage.get("ec_stage_d2h_copies") - d2h == 1
    # the plain versions: one region product, one CRC32C per length
    assert ec_kernels.launch_counts()["plain"] == 1 + len(set(lens))
    parity, csums = ECBatcher(window_us=0).encode(codec, pays[0],
                                                  with_csums=True)
    assert np.array_equal(csums, _oracle_csums(pays[0], parity))
    assert sweeps == []


def test_fused_flush_races_an_unpinned_signature():
    """Where races run (the card; forced here with kernel_race=on), the
    fused op's first flush races the encode matrix on the data rows of
    the flush's (k+m, N) stack, pins the winner and launches it: the
    bytes stay exact and one pick is booked for the signature."""
    codec = _codec(kernel_race="on")
    rng = np.random.default_rng(12)
    pays = [rng.integers(0, 256, (4, 2048), dtype=np.uint8)
            for _ in range(2)]
    b = ECBatcher(window_us=10_000_000, max_bytes=2 * 4 * 2048)
    results = _burst(b, codec, pays, with_csums=True)
    for data, (parity, csums) in zip(pays, results):
        assert np.array_equal(parity, _oracle_parity(codec, data))
        assert np.array_equal(csums, _oracle_csums(data, parity))
    picks = codec.kernel_picks()
    assert len(picks) == 1
    assert list(picks.values())[0] in KERNEL_RACE_ORDER


def test_one_device_copy_per_flush():
    """Every encode and decode flush leaves the device in exactly ONE
    metered copy (ec_stage_d2h_copies), fused or not."""
    codec = _codec()
    stage = staging.stage_perf()
    b = ECBatcher(window_us=50)
    before = stage.get("ec_stage_d2h_copies")
    data = RNG.integers(0, 256, (4, 4096), dtype=np.uint8)
    b.encode(codec, data, with_csums=True)
    b.encode(codec, data)
    full = codec.encode(data.tobytes())
    b.decode(codec, [1, 5], {i: full[i] for i in (0, 2, 3, 4)})
    assert b.stats["launches"] == 3
    assert stage.get("ec_stage_d2h_copies") - before == 3


def test_bad_shape_fails_alone_not_the_batch():
    codec = _codec(4, 2)
    b = ECBatcher(window_us=10_000)
    bad = RNG.integers(0, 256, (3, 1024), dtype=np.uint8)  # k-1 rows
    with pytest.raises(ec.ErasureCodeError):
        b.encode(codec, bad)
    good = RNG.integers(0, 256, (4, 1024), dtype=np.uint8)
    parity, _ = b.encode(codec, good)
    assert np.array_equal(parity, _oracle_parity(codec, good))
    assert b.pending_ops() == 0


def test_non_matrix_codec_passes_through():
    """A codec whose encode is not a region matmul (the bit-matrix
    liberation code here; CLAY in the reference) never folds."""
    lib = ec.factory("jerasure", {"technique": "liberation", "k": "4",
                                  "m": "2", "device": "cpu"})
    L = lib.get_chunk_size(4 * 4096)
    data = RNG.integers(0, 256, (4, L), dtype=np.uint8)
    b = ECBatcher(window_us=10_000)
    parity, _ = b.encode(lib, data)
    assert np.array_equal(parity, lib.encode_chunks(data))
    assert b.stats[FLUSH_IDLE] == 1


@pytest.fixture
def cpu8():
    """8 logical CPU devices (parallel.mesh.force_devices), the real one
    after."""
    meshmod.force_devices("cpu", 8)
    yield
    meshmod.force_devices("cpu", None)


def _ref_codec(k=4, m=2, **profile):
    return jax_ec.factory("tpu", {"k": k, "m": m, "backend": "jax",
                                  **profile})


def test_shard_devices_as_the_reference(cpu8, monkeypatch):
    """min(N, devices) for an integer, 1 for ``off``, every device of a
    card for ``auto`` and 1 on the CPU, 1 off the torch backend — the
    reference's answers on its 8 CPU devices; a value that is none of
    these raises (the reference reads it as 1)."""
    for mode, want in (("off", 1), ("8", 8), ("3", 3), ("100", 8),
                       ("auto", 1), ("on", 1)):
        assert _codec(shard=mode).shard_devices() == want, mode
        assert _ref_codec(shard=mode).shard_devices() == want, mode
    assert _codec(backend="numpy", shard="8").shard_devices() == 1
    with pytest.raises(ec.ErasureCodeError, match="bad shard"):
        _codec(shard="many")
    meshmod.force_devices("cpu", None)
    assert _codec(shard="8").shard_devices() == 1  # the one real CPU
    # auto on a card: every card (the device list stands in for them)
    codec = _codec(shard="off")
    codec.device = torch.device("cuda")
    monkeypatch.setattr(meshmod, "devices", lambda kind="cuda": [0, 1, 2])
    for mode, want in (("auto", 3), ("yes", 3), ("2", 2), ("off", 1)):
        codec.profile["shard"] = mode
        codec._shard_devices_cached = None
        assert codec.shard_devices() == want, mode


def test_a_mesh_that_cannot_be_built_raises(cpu8):
    """A deliberate difference: where the devices a codec resolved are
    gone when it builds its mesh, the sharded launch and the sharded
    fused op raise ErasureCodeError; the reference returns None and
    falls back to one device (or the host CRC sweep)."""
    codec = _codec(shard="8")
    assert codec.shard_devices() == 8
    meshmod.force_devices("cpu", 4)
    data = RNG.integers(0, 256, (4, 8 * 512), dtype=np.uint8)
    with pytest.raises(ec.ErasureCodeError, match="no 8-device mesh"):
        codec._matmul_device(codec.matrix, data, n_shard=8)
    with pytest.raises(ec.ErasureCodeError, match="no 8-device mesh"):
        codec._csum_op(512, n_shard=8)
    b = ECBatcher(window_us=10_000_000, max_bytes=8 * 4 * 512)
    # every writer of the flush gets the error (_run gathers them)
    with pytest.raises(AssertionError, match="no 8-device mesh"):
        _burst(b, codec, [data[:, :512]] * 8)


def test_sharded_matmul_byte_identical_and_fallback(cpu8):
    """The sharded folded multiply equals the oracle and the
    reference's; a column count that does not split into whole lanes
    per device takes the single-device launch, byte-identical."""
    codec, ref = _codec(shard="8"), _ref_codec(shard="8")
    for N in (8 * 512, 8 * 768, 4100, 513):
        data = RNG.integers(0, 256, (4, N), dtype=np.uint8)
        before = staging.stage_perf().dump()["ec_stage_h2d_copies"]
        out = codec.host_sync(codec._matmul_device(codec.matrix, data,
                                                   n_shard=8))
        copies = staging.stage_perf().dump()["ec_stage_h2d_copies"] - before
        assert np.array_equal(out, _oracle_parity(codec, data)), N
        assert np.array_equal(out, np.asarray(ref._matmul_device(
            ref.matrix, data, n_shard=8))), N
        # a host fold lands as one metered copy of a slice a device
        assert copies == (1 if N % 32 == 0 else 0), N
    sigs = kernel_profiler().dump()["signatures"]
    assert "matmul/2x4/L4096/s8/xla" in sigs


def test_sharded_encode_burst_identical_to_reference(cpu8):
    """8 writers through the sharded batcher of each package: one folded
    launch fanned over the 8 devices, identical parity and statistics."""
    rng = np.random.default_rng(44)
    L = 2048
    pays = [rng.integers(0, 256, (4, L), dtype=np.uint8) for _ in range(8)]
    port, ref = _codec(shard="8"), _ref_codec(shard="8")
    pb = ECBatcher(window_us=10_000_000, max_bytes=8 * 4 * L)
    rb = JaxECBatcher(window_us=10_000_000, max_bytes=8 * 4 * L)
    got, want = _burst_both(lambda i: pb.encode(port, pays[i]),
                            lambda i: rb.encode(ref, pays[i]), 8)
    for data, (p, _), (rp, _) in zip(pays, got, want):
        assert np.array_equal(p, np.asarray(rp))
        assert np.array_equal(p, _oracle_parity(port, data))
    assert pb.stats == rb.stats
    assert pb.stats["launches"] == 1 and pb.stats["sharded_launches"] == 1


def test_sharded_fused_csum_burst_identical_to_reference(cpu8):
    """A checksummed burst of one length on a sharded pool takes the
    mesh-sharded fused op in both packages: identical parity, csums
    (the native sweep's) and statistics; 3 ops pad to a fan-out of 4."""
    rng = np.random.default_rng(45)
    L = 4096
    pays = [rng.integers(0, 256, (4, L), dtype=np.uint8) for _ in range(3)]
    port, ref = _codec(shard="8"), _ref_codec(shard="8")
    pb = ECBatcher(window_us=10_000_000, max_bytes=3 * 4 * L)
    rb = JaxECBatcher(window_us=10_000_000, max_bytes=3 * 4 * L)
    got, want = _burst_both(
        lambda i: pb.encode(port, pays[i], with_csums=True),
        lambda i: rb.encode(ref, pays[i], with_csums=True), 3)
    for data, (p, c), (rp, rc) in zip(pays, got, want):
        assert np.array_equal(p, np.asarray(rp))
        assert np.array_equal(c, np.asarray(rc))
        assert np.array_equal(c, _oracle_csums(data, p))
    assert pb.stats == rb.stats
    assert pb.stats["sharded_launches"] == 1
    assert f"csum/2x4/L{L}x{4 * L}/s4" in kernel_profiler().dump()[
        "signatures"]


def test_sharded_decode_burst_identical_to_reference(cpu8):
    """Coalesced degraded reads fanned over the mesh: the same rebuilt
    bytes and statistics as the reference's sharded batcher."""
    rng = np.random.default_rng(46)
    port, ref = _codec(shard="8"), _ref_codec(shard="8")
    L = 4096
    stripes = []
    for _ in range(8):
        data = rng.integers(0, 256, (4, L), dtype=np.uint8)
        full = np.concatenate([data, _oracle_parity(port, data)])
        stripes.append({s: full[s] for s in (0, 2, 3, 4, 5)})
    pb = ECBatcher(window_us=10_000_000, max_bytes=8 * 5 * L)
    rb = JaxECBatcher(window_us=10_000_000, max_bytes=8 * 5 * L)
    got, want = _burst_both(
        lambda i: pb.decode(port, [0, 1, 2, 3], dict(stripes[i])),
        lambda i: rb.decode(ref, [0, 1, 2, 3], dict(stripes[i])), 8)
    for g, w, st in zip(got, want, stripes):
        for s in range(4):
            assert np.array_equal(g[s], np.asarray(w[s]))
    assert pb.stats == rb.stats
    assert pb.stats["sharded_launches"] == 1


def test_sharded_subchunk_and_repair_flushes(cpu8):
    """CLAY's sub-chunk encode and repair folds pass the fan-out to the
    codec's folded entry points, and match the reference's sharded
    batcher byte for byte."""
    prof = {"k": "4", "m": "2", "d": "5", "shard": "8"}
    port = ec.factory("clay", {**prof, "device": "cpu"})
    ref = jax_ec.factory("clay", {**prof, "backend": "jax"})
    L = port.get_chunk_size(4 * 4096)
    rng = np.random.default_rng(47)
    pays = [rng.integers(0, 256, (4, L), dtype=np.uint8) for _ in range(4)]
    pb = ECBatcher(window_us=10_000_000, max_bytes=4 * 4 * L)
    rb = JaxECBatcher(window_us=10_000_000, max_bytes=4 * 4 * L)
    got, want = _burst_both(lambda i: pb.encode(port, pays[i]),
                            lambda i: rb.encode(ref, pays[i]), 4)
    for (p, _), (rp, _), data in zip(got, want, pays):
        assert np.array_equal(p, np.asarray(rp))
        assert np.array_equal(p, port.encode_chunks(data))
    assert pb.stats == rb.stats and pb.stats["sharded_launches"] == 1
    lost = 1
    planes = port.repair_planes(lost)
    fulls = [np.concatenate([data, p]) for (p, _), data in zip(got, pays)]

    def subs(i):
        return {h: fulls[i][h].reshape(port.alpha, -1)[planes]
                for h in range(port.chunk_count) if h != lost}

    nbytes = 4 * sum(s.nbytes for s in subs(0).values())
    pb2 = ECBatcher(window_us=10_000_000, max_bytes=nbytes)
    rb2 = JaxECBatcher(window_us=10_000_000, max_bytes=nbytes)
    got2, want2 = _burst_both(lambda i: pb2.repair(port, lost, subs(i), L),
                              lambda i: rb2.repair(ref, lost, subs(i), L),
                              4)
    for i in range(4):
        assert np.array_equal(got2[i], np.asarray(want2[i]))
        assert np.array_equal(got2[i], fulls[i][lost])
    assert pb2.stats == rb2.stats and pb2.stats["sharded_launches"] == 1


def test_sharded_launch_counters(cpu8):
    """The ec_batch_sharded_* counters move with a sharded flush: the
    launch, its fan-out and each device's bytes."""
    from ceph_tpu_torch.utils.perf import global_perf

    name = "osd.test_sharded_counters"
    perf = global_perf().create(name)
    try:
        codec = _codec(shard="8")
        L = 2048
        pays = [RNG.integers(0, 256, (4, L), dtype=np.uint8)
                for _ in range(2)]
        b = ECBatcher(window_us=10_000_000, max_bytes=2 * 4 * L,
                      perf=perf)
        _burst(b, codec, pays)
        dump = perf.dump()
        assert dump["ec_batch_sharded_launches"] == 1
        # two ops: the fan-out caps at the stripe count
        assert dump["ec_batch_sharded_devices_per_launch"]["sum"] == 2
        assert dump["ec_batch_sharded_shard_bytes"]["sum"] == 4 * L
    finally:
        global_perf().remove(name)


def test_tensor_inputs_fold_on_the_device():
    """An encode of a tensor (an arena hit) and a decode whose survivors
    are half tensors from a DeviceArena fold like host bytes; the
    borrowed tensors are not written."""
    codec = _codec()
    arena = ec.DeviceArena(device="cpu")
    data = RNG.integers(0, 256, (4, 4096), dtype=np.uint8)
    dev = arena.put("stripe", data)
    b = ECBatcher(window_us=50)
    parity, csums = b.encode(codec, dev, with_csums=True)
    assert np.array_equal(parity, _oracle_parity(codec, data))
    assert np.array_equal(csums, _oracle_csums(data, parity))
    assert np.array_equal(arena.get("stripe").numpy(), data)
    full = np.concatenate([data, parity])
    chunks = {s: (arena.put(s, full[s]) if s < 2 else full[s])
              for s in (0, 1, 3, 5)}
    out = b.decode(codec, [2, 4], chunks)
    assert np.array_equal(out[2], full[2]) and np.array_equal(out[4], full[4])


# ---------------------------------------------------------------------------
# the same bursts through the reference batcher
# ---------------------------------------------------------------------------

#: each writer's length: 8 writers over 3 length buckets
BURST_LENGTHS = (4096, 8192, 12288)


def _burst_both(port_fn, ref_fn, n):
    """Run n ops through each batcher, all released together by a
    barrier (window flushes gather every op of a signature); returns
    (port results, reference results)."""
    out = []
    for fn in (port_fn, ref_fn):
        gate = threading.Barrier(n, timeout=60)

        def op(i, fn=fn, gate=gate):
            gate.wait()
            return fn(i)

        out.append(_run([lambda i=i: op(i) for i in range(n)]))
    return out


def test_writer_burst_identical_to_reference():
    """8 writers, k=4, m=2, lengths 4096 / 8192 / 12288, with csums:
    the port's batcher and the reference's give identical parity,
    csums and launch statistics."""
    rng = np.random.default_rng(42)
    pays = [rng.integers(0, 256, (4, BURST_LENGTHS[i % 3]), dtype=np.uint8)
            for i in range(8)]
    port, ref = _codec(), jax_ec.factory(
        "tpu", {"k": 4, "m": 2, "backend": "jax"})
    pb, rb = ECBatcher(window_us=400_000), JaxECBatcher(window_us=400_000)
    got, want = _burst_both(
        lambda i: pb.encode(port, pays[i], with_csums=True),
        lambda i: rb.encode(ref, pays[i], with_csums=True), 8)
    for (p, c), (rp, rc) in zip(got, want):
        assert np.array_equal(p, np.asarray(rp))
        assert np.array_equal(c, np.asarray(rc))
    for data, (p, c) in zip(pays, got):
        assert np.array_equal(c, _oracle_csums(data, p))
    assert pb.stats == rb.stats
    assert pb.stats["launches"] == 3 and pb.stats["ops"] == 8


def test_degraded_decode_burst_identical_to_reference():
    """8 readers of 8 stripes with shards 1 and 4 missing: one folded
    decode in each batcher, identical bytes and statistics."""
    rng = np.random.default_rng(43)
    port, ref = _codec(), jax_ec.factory(
        "tpu", {"k": 4, "m": 2, "backend": "jax"})
    L = 8192
    stripes = []
    for _ in range(8):
        data = rng.integers(0, 256, (4, L), dtype=np.uint8)
        full = np.concatenate([data, _oracle_parity(port, data)])
        stripes.append({s: full[s] for s in (0, 2, 3, 5)})
    pb, rb = ECBatcher(window_us=400_000), JaxECBatcher(window_us=400_000)
    got, want = _burst_both(
        lambda i: pb.decode(port, [1, 4], dict(stripes[i])),
        lambda i: rb.decode(ref, [1, 4], dict(stripes[i])), 8)
    for g, w in zip(got, want):
        for s in (1, 4):
            assert np.array_equal(g[s], np.asarray(w[s]))
    assert pb.stats == rb.stats
    assert pb.stats["launches"] == 1 and pb.stats["ops"] == 8
