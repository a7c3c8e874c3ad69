"""The port's distributed EC steps (ceph_tpu_torch/parallel) on 8 logical
CPU devices, each held byte for byte against the JAX package's step on
its own 8-device CPU mesh (conftest forces 8 host devices) on the same
seeded input: the twins of tests/test_parallel.py, plus the mesh
helpers' rules and the dry run's digests (MULTICHIP_r05.json).  Every
comparison is exact (tolerance 0)."""

import jax
import numpy as np
import pytest
import torch

from ceph_tpu.models.stripe_codec import StripeCodec as RefStripeCodec
from ceph_tpu.parallel import DistributedStripeEC as RefDistributedStripeEC
from ceph_tpu.parallel import make_host_mesh as ref_make_host_mesh
from ceph_tpu.parallel import make_mesh as ref_make_mesh
from ceph_tpu_torch.models.stripe_codec import StripeCodec
from ceph_tpu_torch.ops import ec_kernels, gf256
from ceph_tpu_torch.parallel import (DistributedStripeEC, dryrun,
                                     init_multihost, make_flat_mesh,
                                     make_host_mesh, make_mesh)
from ceph_tpu_torch.parallel import mesh as meshmod
from ceph_tpu_torch.parallel.distributed import make_folded_matmul

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

RNG = np.random.default_rng(9)


@pytest.fixture(scope="module")
def cpu8():
    """8 logical CPU devices for the module, the real list after."""
    meshmod.force_devices("cpu", 8)
    yield meshmod.devices("cpu")
    meshmod.force_devices("cpu", None)


@pytest.fixture(scope="module")
def dec(cpu8):
    return DistributedStripeEC(StripeCodec(8, 3), make_mesh(8, devices=cpu8))


@pytest.fixture(scope="module")
def ref_dec():
    return RefDistributedStripeEC(RefStripeCodec(8, 3), ref_make_mesh(8))


def _data(B, L, rng=RNG):
    return rng.integers(0, 256, (B, 8, L), dtype=np.uint8)


def test_mesh_axes(dec, ref_dec):
    assert dec.mesh.shape == ref_dec.mesh.shape == {"dp": 2, "shard": 4}
    assert [d.id for d in dec.mesh.devices.flat] == list(range(8))
    assert all(d.torch_device.type == "cpu" and d.stream() is None
               for d in dec.mesh.devices.flat)
    assert (dec.S, dec.spare_rows, dec.n_dp) == \
        (ref_dec.S, ref_dec.spare_rows, ref_dec.n_dp) == (12, 1, 2)


def test_write_step_systematic_and_parity(dec, ref_dec):
    B, L = 4, 1024
    data = _data(B, L)
    stack, digest = dec.write_step(data)
    ref_stack, ref_digest = ref_dec.write_step(data)
    st = np.asarray(stack)
    np.testing.assert_array_equal(st, np.asarray(ref_stack))
    assert st.shape == (B, 12, L)
    np.testing.assert_array_equal(st[:, :8], data)
    for b in range(B):
        np.testing.assert_array_equal(
            st[b, 8:11], gf256.encode_region(dec.codec.matrix, data[b]))
    assert not st[:, 11].any()
    assert int(np.asarray(digest)) == int(np.asarray(ref_digest)) == \
        int(st[:, 8:11].astype(np.uint64).sum())


def test_rebalance_roundtrip(dec, ref_dec):
    B, L = 2, 512
    data = _data(B, L)
    stack, _ = dec.write_step(data)
    ref_stack, _ = ref_dec.write_step(data)
    moved = dec.make_rebalance_step(1)(stack)
    ref_moved = jax.jit(ref_dec.make_rebalance_step(1))(ref_stack)
    np.testing.assert_array_equal(np.asarray(moved), np.asarray(ref_moved))
    back = np.asarray(dec.make_rebalance_step(-1)(moved))
    np.testing.assert_array_equal(back, np.asarray(stack))


@pytest.mark.parametrize("erased", [(1, 4, 9), (0, 1, 2), (8, 9, 10)])
def test_recovery_step(dec, ref_dec, erased):
    B, L = 2, 512
    data = _data(B, L)
    stack, _ = dec.write_step(data)
    available = [i for i in range(11) if i not in erased][:8]
    rec = np.asarray(dec.recovery_step(available)(stack))
    ref_rec = np.asarray(ref_dec.recovery_step(available)(
        ref_dec.write_step(data)[0]))
    np.testing.assert_array_equal(rec, ref_rec)
    np.testing.assert_array_equal(rec, data)
    assert dec.recovery_step(available) is dec.recovery_step(available)


def test_flagship_encode_single():
    """The twin of the reference's graft entry: the flagship k=8 m=3
    encode graph on the entry's seeded data (two 1 MiB stripes of its
    sixteen), against the reference's graph and the numpy oracle."""
    data = np.random.default_rng(0).integers(
        0, 256, (8, 2 * 1024 * 1024 // 8), dtype=np.uint8)
    out = StripeCodec(8, 3).encode_graph()(torch.from_numpy(data)).numpy()
    ref = np.asarray(jax.jit(RefStripeCodec(8, 3).encode_graph())(data))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out, gf256.encode_region(gf256.vandermonde_matrix(8, 3), data))


def test_dryrun_multichip(cpu8, capsys):
    """Every single-process leg of the dry run at 8 and 4 devices; the
    mesh legs' digests are the repo's record's (MULTICHIP_r05.json);
    the two-process leg is tests/test_torch_multiprocess_dcn.py."""
    out = dryrun.dryrun_multichip(8, "cpu", processes=False)
    assert out["main"]["digest"] == 1561950
    assert out["host"]["digest"] == 1568446
    assert out["host"]["mesh"] == {"host": 2, "dp": 1, "shard": 4}
    for leg in ("batcher", "batcher_csums"):
        assert out[leg]["sharded_launches"] == 1
        assert out[leg]["shard_devices"] == 8
    assert "dryrun_multichip ok" in capsys.readouterr().out
    out4 = dryrun.dryrun_multichip(4, "cpu", processes=False)
    assert out4["mesh"] == {"dp": 1, "shard": 4}
    assert out4["host"]["mesh"] == {"host": 2, "dp": 1, "shard": 2}


def test_delta_step_matches_full_reencode(dec, ref_dec):
    """Parity-delta partial write: stack ^ enc(delta) equals the full
    re-encode of (data ^ delta), and the reference's delta step."""
    B, L = 2, 512
    data, delta = _data(B, L), _data(B, L)
    stack, _ = dec.write_step(data)
    upd = np.asarray(dec.make_delta_step()(stack, delta))
    full, _ = dec.write_step(np.bitwise_xor(data, delta))
    np.testing.assert_array_equal(upd, np.asarray(full))
    ref_upd = jax.jit(ref_dec.make_delta_step())(
        ref_dec.write_step(data)[0], delta)
    np.testing.assert_array_equal(upd, np.asarray(ref_upd))


def test_stats_step_dp_reduction(dec, ref_dec):
    B, L = 4, 512
    data = _data(B, L)
    stack, _ = dec.write_step(data)
    stats = np.asarray(dec.make_stats_step()(stack))
    want = np.asarray(stack).astype(np.uint32).sum(axis=(0, 2),
                                                   dtype=np.uint32)
    np.testing.assert_array_equal(stats, want)
    ref_stats = jax.jit(ref_dec.make_stats_step())(ref_dec.write_step(
        data)[0])
    np.testing.assert_array_equal(stats, np.asarray(ref_stats))
    assert stats.dtype == np.uint32


def test_host_mesh_dcn_outer(cpu8):
    """("host", "dp", "shard") mesh: batch over (host, dp); write,
    recovery and delta equal the reference's on its host mesh."""
    hmesh = make_host_mesh(n_hosts=2, devices=cpu8)
    ref_hmesh = ref_make_host_mesh(n_hosts=2, devices=jax.devices()[:8])
    assert hmesh.shape == ref_hmesh.shape == {"host": 2, "dp": 1,
                                              "shard": 4}
    hdec = DistributedStripeEC(StripeCodec(8, 3), hmesh,
                               batch_axes=("host", "dp"))
    ref = RefDistributedStripeEC(RefStripeCodec(8, 3), ref_hmesh,
                                 batch_axes=("host", "dp"))
    B, L = 4, 512
    data, delta = _data(B, L), _data(B, L)
    stack, digest = hdec.write_step(data)
    ref_stack, ref_digest = ref.write_step(data)
    np.testing.assert_array_equal(np.asarray(stack), np.asarray(ref_stack))
    assert int(np.asarray(digest)) == int(np.asarray(ref_digest))
    rec = np.asarray(hdec.recovery_step([0, 2, 3, 5, 6, 7, 8, 10])(stack))
    np.testing.assert_array_equal(rec, data)
    upd = np.asarray(hdec.make_delta_step()(stack, delta))
    full, _ = hdec.write_step(np.bitwise_xor(data, delta))
    np.testing.assert_array_equal(upd, np.asarray(full))
    np.testing.assert_array_equal(upd, np.asarray(jax.jit(
        ref.make_delta_step())(ref_stack, delta)))


# ------------------------------------------------------------ mesh rules
def test_mesh_defaults_follow_the_reference(cpu8):
    """shard axis up to 4, a power of two; host devices contiguous."""
    for n in (1, 2, 4, 6, 8):
        assert make_mesh(n, devices=cpu8).shape == \
            ref_make_mesh(n).shape, n
    assert make_mesh(8, 2, devices=cpu8).shape == {"dp": 4, "shard": 2}
    with pytest.raises(ValueError):
        make_mesh(9, devices=cpu8)
    with pytest.raises(ValueError):
        make_mesh(6, 4, devices=cpu8)
    with pytest.raises(ValueError):
        make_host_mesh(n_hosts=3, devices=cpu8)
    assert make_flat_mesh(5, devices=cpu8).shape == {"shard": 5}
    h = make_host_mesh(n_hosts=2, devices=cpu8[::-1])
    assert [d.id for d in h.devices.flat] == list(range(8))


def test_forced_devices_and_the_real_ones(cpu8):
    """force_devices sets logical devices on the first real one; None
    gives the real ones back: one CPU, and no card here."""
    try:
        meshmod.force_devices("cpu", None)
        assert len(meshmod.devices("cpu")) == 1
        meshmod.force_devices("cpu", 3)
        devs = meshmod.devices("cpu")
        assert [d.id for d in devs] == [0, 1, 2]
        assert devs == meshmod.devices("cpu")  # the same objects
        assert all(d.addressable and d.process_index == 0 for d in devs)
    finally:
        meshmod.force_devices("cpu", len(cpu8))
    with pytest.raises(RuntimeError, match="is_available"):
        meshmod.devices("cuda")
    with pytest.raises(ValueError):
        meshmod.force_devices("tpu", 8)


def test_init_multihost_reads_torchs_environment(monkeypatch):
    """A deliberate difference: the environment fallbacks are torch's
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), not the reference's
    JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID; one process is
    a no-op."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR", "127.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    assert init_multihost() is False and not calls
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "4321")
    assert init_multihost() is False  # WORLD_SIZE unset: one process
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert init_multihost() is True
    (args, kw), = calls
    assert args == ("gloo",)
    assert kw == {"init_method": "tcp://127.0.0.1:4321", "world_size": 2,
                  "rank": 1}


def test_folded_matmul_books_each_logical_device(cpu8):
    """Each logical device runs the region op on its column slice and
    its launch is booked to it; the slices assemble to the oracle."""
    M = gf256.vandermonde_matrix(8, 3)
    fn = make_folded_matmul(M, make_flat_mesh(8, devices=cpu8))
    x = RNG.integers(0, 256, (8, 8 * 512), dtype=np.uint8)
    ec_kernels.reset_launches()
    out = fn(x)
    assert out.spec == (None, "shard") and out.shape == (3, 8 * 512)
    np.testing.assert_array_equal(np.asarray(out),
                                  gf256.encode_region(M, x))
    np.testing.assert_array_equal(
        out.assemble("cpu").numpy(), gf256.encode_region(M, x))
    assert ec_kernels.device_launch_counts() == {
        (i, "plain"): 1 for i in range(8)}
    with pytest.raises(ValueError, match="do not split"):
        fn(x[:, :100])
