"""The port's GF(2^8) math and XOR schedules equal the JAX package's.

ceph_tpu_torch/ops/gf256.py and ops/xor_schedule.py are copies of the JAX
package's numpy modules; these tests hold them to the same outputs:
matrices, inverses, decode matrices, bit-matrices and schedules, field by
field.  Everything is integer, so the tolerance is 0 (exact equality).
"""

import numpy as np
import pytest

from ceph_tpu.ops import gf256 as ref_gf
from ceph_tpu.ops import xor_schedule as ref_xs
from ceph_tpu_torch.ec.convert import schedule_from_arrays
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.ops import xor_schedule as xs

RNG = np.random.default_rng(1201)

MAKERS = ["vandermonde_matrix", "cauchy_matrix", "cauchy_good_matrix"]


def test_tables_equal():
    """exp/log/mul/inv tables: exact."""
    assert np.array_equal(gf256.GF_EXP, ref_gf.GF_EXP)
    assert np.array_equal(gf256.GF_LOG, ref_gf.GF_LOG)
    assert np.array_equal(gf256.mul_table(), ref_gf.mul_table())
    assert np.array_equal(gf256.inv_table(), ref_gf.inv_table())


@pytest.mark.parametrize("maker", MAKERS)
@pytest.mark.parametrize("k", [2, 4, 8, 12])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_coding_matrices_equal(maker, k, m):
    """The three techniques' coding matrices, their bit-matrices and
    the decode matrix of a random erasure signature: exact."""
    M = getattr(gf256, maker)(k, m)
    R = getattr(ref_gf, maker)(k, m)
    assert M.dtype == R.dtype and np.array_equal(M, R)
    assert np.array_equal(gf256.bitmatrix(M), ref_gf.bitmatrix(R))
    avail = sorted(RNG.choice(k + m, size=k, replace=False).tolist())
    assert np.array_equal(gf256.decode_matrix(M, k, avail),
                          ref_gf.decode_matrix(R, k, avail))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 16])
def test_inverse_and_products_equal(n):
    """gf_mat_inv, gf_matmul and encode_region on random invertible
    matrices: exact."""
    while True:
        A = RNG.integers(0, 256, (n, n), dtype=np.uint8)
        try:
            want = ref_gf.gf_mat_inv(A)
            break
        except np.linalg.LinAlgError:
            continue
    got = gf256.gf_mat_inv(A)
    assert np.array_equal(got, want)
    assert np.array_equal(gf256.gf_matmul(A, got),
                          np.eye(n, dtype=np.uint8))
    data = RNG.integers(0, 256, (n, 97), dtype=np.uint8)
    assert np.array_equal(gf256.encode_region(A, data),
                          ref_gf.encode_region(A, data))


def test_singular_inverse_raises_like_reference():
    A = np.array([[1, 2], [1, 2]], dtype=np.uint8)
    for mod in (gf256, ref_gf):
        with pytest.raises(np.linalg.LinAlgError):
            mod.gf_mat_inv(A)


def test_bitplane_round_trip_equal():
    data = RNG.integers(0, 256, (3, 41), dtype=np.uint8)
    planes = gf256.bytes_to_bitplanes(data)
    assert np.array_equal(planes, ref_gf.bytes_to_bitplanes(data))
    assert np.array_equal(gf256.bitplanes_to_bytes(planes), data)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (8, 8), (16, 24),
                                   (24, 64), (40, 40)])
@pytest.mark.parametrize("cse", [True, False])
def test_build_schedule_equal_field_by_field(shape, cse):
    """build_schedule on random bit-matrices (one with an all-zero
    row): n_in, ops, outputs and used_inputs equal the reference's."""
    B = RNG.integers(0, 2, shape, dtype=np.uint8)
    if shape[0] > 1:
        B[0] = 0
    got = xs.build_schedule(B, cse=cse)
    want = ref_xs.build_schedule(B, cse=cse)
    assert got.n_in == want.n_in
    assert got.ops == want.ops
    assert got.outputs == want.outputs
    assert got.used_inputs == want.used_inputs
    assert got.xor_count() == want.xor_count()
    assert got.naive_xor_count() == want.naive_xor_count()


@pytest.mark.parametrize("maker,k,m", [("vandermonde_matrix", 8, 3),
                                       ("cauchy_good_matrix", 8, 4),
                                       ("cauchy_matrix", 12, 4)])
def test_coding_schedules_equal_and_evaluate_equal(maker, k, m):
    """The schedules of real coding bit-matrices equal the reference's,
    a schedule rebuilt from the reference's arrays is the same object,
    and both evaluators agree with the naive apply."""
    B = ref_gf.bitmatrix(getattr(ref_gf, maker)(k, m))
    want = ref_xs.build_schedule(B)
    got = xs.build_schedule(B)
    assert got.ops == want.ops and got.outputs == want.outputs
    rebuilt = schedule_from_arrays(want.n_in, want.ops, want.outputs,
                                   want.used_inputs)
    assert rebuilt == got
    planes = RNG.integers(0, 256, (B.shape[1], 64), dtype=np.uint8)
    out = xs.apply_schedule(rebuilt, planes)
    assert np.array_equal(out, ref_xs.apply_schedule(want, planes))
    assert np.array_equal(out, xs.naive_apply(B, planes))
    assert np.array_equal(xs.naive_apply(B, planes),
                          ref_xs.naive_apply(B, planes))
