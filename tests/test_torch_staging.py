"""Staging plane of the port (ceph_tpu_torch/utils/staging.py) against
the JAX package's: the same counter and histogram names, and the same
booking — one metered device->host event per fetch_recorded whatever it
carries, numpy passing through unmetered, one host->device copy per
device_put_landed — on the same seeded buffers, with the bytes returned
exact."""

import numpy as np
import torch

from ceph_tpu.utils import staging as jax_staging
from ceph_tpu_torch.utils import staging
from ceph_tpu_torch.utils.perf import kernel_profiler

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

NAMES = ("ec_stage_h2d_bytes", "ec_stage_h2d_copies",
         "ec_stage_d2h_bytes", "ec_stage_d2h_copies")


def _counts(pc):
    return {n: pc.get(n) for n in NAMES}


def _delta(pc, fn):
    before = _counts(pc)
    out = fn()
    after = _counts(pc)
    return out, {n: after[n] - before[n] for n in NAMES}


def test_counter_and_histogram_names_equal_reference():
    assert staging.COUNTERS == jax_staging.COUNTERS
    assert staging.HISTOGRAMS == jax_staging.HISTOGRAMS
    dumped = staging.stage_perf().dump()
    for n in staging.COUNTERS + staging.HISTOGRAMS:
        assert n in dumped


def test_fetch_recorded_books_one_event_like_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    parity = rng.integers(0, 256, (3, 4096), dtype=np.uint8)
    csums = rng.integers(0, 2**32, (11, 4), dtype=np.uint32)
    host = np.arange(10, dtype=np.uint8)
    ours, d_ours = _delta(staging.stage_perf(), lambda: staging.fetch_recorded(
        (torch.from_numpy(parity), torch.from_numpy(csums), host),
        sig="sync/test"))
    ref, d_ref = _delta(jax_staging.stage_perf(),
                        lambda: jax_staging.fetch_recorded(
                            (jnp.asarray(parity), jnp.asarray(csums), host)))
    assert d_ours == d_ref
    assert d_ours["ec_stage_d2h_copies"] == 1
    assert d_ours["ec_stage_d2h_bytes"] == parity.nbytes + csums.nbytes
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert "sync/test" in kernel_profiler().dump()["signatures"]


def test_numpy_only_fetch_is_unmetered():
    host = [np.zeros(8, np.uint8), np.ones(4, np.uint32)]
    out, d = _delta(staging.stage_perf(),
                    lambda: staging.fetch_recorded(host))
    assert out == host and all(v == 0 for v in d.values())


def test_device_put_landed_books_one_copy():
    rng = np.random.default_rng(10)
    buf = rng.integers(0, 256, (4, 1024), dtype=np.uint8)
    dev, d = _delta(staging.stage_perf(),
                    lambda: staging.device_put_landed(buf, "cpu"))
    assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(), buf)
    assert d["ec_stage_h2d_copies"] == 1
    assert d["ec_stage_h2d_bytes"] == buf.nbytes
    _, d = _delta(staging.stage_perf(), lambda: staging.device_put_landed(
        buf, "cpu", record=False))
    assert all(v == 0 for v in d.values())


def test_backend_is_cpu_follows_the_device():
    assert staging.backend_is_cpu("cpu")
    assert staging.backend_is_cpu(torch.device("cpu"))
    assert not staging.backend_is_cpu("cuda")
