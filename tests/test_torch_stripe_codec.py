"""The port's StripeCodec (functions on tensors, CPU) against the JAX
StripeCodec's graphs under jax.jit on the CPU.  Integer outputs:
tolerance 0 (byte-exact)."""

import jax
import numpy as np
import pytest
import torch

from ceph_tpu.models.stripe_codec import StripeCodec as RefCodec
from ceph_tpu.models.stripe_codec import coding_matrix as ref_coding_matrix
from ceph_tpu_torch.models import StripeCodec
from ceph_tpu_torch.models.stripe_codec import coding_matrix

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

RNG = np.random.default_rng(515)
N = 4 * 1024  # a batch of 4 stripes of 1 KiB chunks


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy_good",
                                       "cauchy"])
def test_coding_matrix_equal(technique):
    assert np.array_equal(coding_matrix(8, 3, technique),
                          ref_coding_matrix(8, 3, technique))


def test_unknown_technique_raises():
    with pytest.raises(ValueError):
        coding_matrix(8, 3, "nope")


@pytest.mark.parametrize("k,m", [(8, 3), (4, 2)])
@pytest.mark.parametrize("kernel", ["auto", "xla", "pallas", "bitxor",
                                    "mxu"])
def test_encode_graph_equal(k, m, kernel):
    port, ref = StripeCodec(k, m), RefCodec(k, m)
    assert np.array_equal(port.full, ref.full)
    data = RNG.integers(0, 256, (k, N), dtype=np.uint8)
    ref_kernel = "xla" if kernel in ("auto", "pallas") else kernel
    want = np.asarray(jax.jit(ref.encode_graph(ref_kernel))(data))
    got = port.encode_graph(kernel)(torch.from_numpy(data))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("available", [
    [0, 2, 3, 5, 6, 7, 8, 10],
    [3, 4, 5, 6, 7, 8, 9, 10],
    list(range(8)),
])
def test_decode_graph_equal(available):
    port, ref = StripeCodec(), RefCodec()
    data = RNG.integers(0, 256, (8, N), dtype=np.uint8)
    full = np.concatenate([data, np.asarray(
        jax.jit(ref.encode_graph())(data))])
    survivors = full[available]
    want = np.asarray(jax.jit(ref.decode_graph(available))(survivors))
    got = port.decode_graph(available)(torch.from_numpy(survivors))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), data)


@pytest.mark.parametrize("rows", [[0, 1], [8, 9, 10], [2, 9], [10]])
def test_stack_rows_graph_equal(rows):
    port, ref = StripeCodec(), RefCodec()
    data = RNG.integers(0, 256, (8, N), dtype=np.uint8)
    want = np.asarray(jax.jit(ref.stack_rows_graph(rows))(data))
    got = port.stack_rows_graph(rows)(torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)
