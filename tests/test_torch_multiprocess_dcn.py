"""Two real processes on the host axis: the port's dcn_worker in a gloo
group over localhost, each with 4 logical CPU devices, against the JAX
package's host-mesh step on the same seeded payload (its worker's
computation, run here on its own 8 CPU devices as two hosts of four).
Exact comparisons; each child has a timeout."""

import jax
import numpy as np
import pytest
import torch

from ceph_tpu.models.stripe_codec import StripeCodec as RefStripeCodec
from ceph_tpu.parallel import DistributedStripeEC as RefDistributedStripeEC
from ceph_tpu.parallel import make_host_mesh as ref_make_host_mesh
from ceph_tpu_torch.parallel import dcn_worker

#: the digest of the reference worker's run in the repo's record
#: (MULTICHIP_r05.json, "2-process DCN leg")
DCN_DIGEST = 1571818


@pytest.fixture(scope="module")
def results():
    return dcn_worker.launch(num_processes=2, devices_per_host=4,
                             device="cpu", timeout=120)


def _ref_worker_digest() -> int:
    """The reference worker's step (seed 42, B = 2 * n_dp, L = 256 *
    n_shard on a 2 x 1 x 4 host mesh) in this process."""
    mesh = ref_make_host_mesh(n_hosts=2, devices=jax.devices()[:8])
    dec = RefDistributedStripeEC(RefStripeCodec(8, 3), mesh,
                                 batch_axes=("host", "dp"))
    data = np.random.default_rng(42).integers(
        0, 256, (2 * dec.n_dp, 8, 256 * dec.n_shard), dtype=np.uint8)
    return int(np.asarray(dec.write_step(data)[1]))


def test_two_process_host_mesh(results):
    assert len(results) == 2
    for r in results:
        assert r["process_count"] == 2
        assert r["devices_total"] == 8
        assert r["devices_local"] == 4
        assert r["mesh"] == {"host": 2, "dp": 1, "shard": 4}
        # the checks ran inside the distributed steps
        assert r["systematic_err"] == 0
        assert r["recovery_err"] == 0
    # both processes hold the same replicated reductions: the psum
    # digest and the stats crossed the process boundary and agreed
    assert results[0]["digest"] == results[1]["digest"] == DCN_DIGEST
    assert results[0]["stats_sum"] == results[1]["stats_sum"] > 0
    assert _ref_worker_digest() == DCN_DIGEST


def test_each_process_runs_its_own_devices(results):
    """Process i owns logical devices 4i..4i+3, each of which ran its
    share of the write and the recovery (the plain versions here), and
    neither process loaded jax or the JAX package."""
    for r in results:
        base = 4 * r["process_id"]
        assert r["device_launches"] == {
            f"{d}/plain": 2 for d in range(base, base + 4)}
        assert r["foreign_modules"] == []


def test_a_failing_worker_fails_the_launch(monkeypatch):
    """A worker that cannot join (a world of 3 with 2 started) is cut at
    the timeout and no child outlives the call."""
    real = dcn_worker.subprocess.Popen
    started = []

    def popen(argv, *a, **kw):
        argv = list(argv)
        argv[argv.index("--num-processes") + 1] = "3"
        p = real(argv, *a, **kw)
        started.append(p)
        return p

    monkeypatch.setattr(dcn_worker.subprocess, "Popen", popen)
    with pytest.raises(AssertionError, match="still running"):
        dcn_worker.launch(2, 2, "cpu", timeout=10)
    assert started and all(p.poll() is not None for p in started)


def test_launch_defaults_to_the_card():
    """``launch`` with no ``device`` asks its workers for the card: with
    none they fail, and the launch raises rather than running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("the default asks for the card, which is here")
    with pytest.raises(AssertionError, match="torch.cuda.is_available"):
        dcn_worker.launch(2, 2, timeout=30)
