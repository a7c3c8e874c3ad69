"""The port's region kernels on the CPU against the JAX package's.

On a CPU tensor the port's wrappers run their kernels' plain versions:
``pallas`` -> the bit-term chain (kernel gf_bitterm on the card),
``bitxor`` -> the scheduled-XOR program (kernel gf_bitxor on the card).
They are held against the JAX RegionMatmul with its Pallas bodies in
interpret mode, and against the numpy oracle gf256.encode_region.  The
host halves of the CUDA kernels — K1's coefficient table and K2's
lowered program with its liveness-allocated slots — are run here by
emulators that follow the kernels' loops.  All comparisons are integer:
tolerance 0 (byte-exact).
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ops import ec_kernels as ref_k
from ceph_tpu.ops import gf256 as ref_gf
from ceph_tpu_torch.ec.convert import schedule_from_arrays
from ceph_tpu_torch.ops import ec_kernels as K
from ceph_tpu_torch.ops import gf256

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

RNG = np.random.default_rng(4242)
CPU = torch.device("cpu")
LENGTHS = [4, 508, 512, 32 * 1024 + 4]


def _sparse(r, c, seed):
    """Random matrix with zero coefficients, ones and an all-zero row."""
    rng = np.random.default_rng(seed)
    M = rng.integers(0, 256, (r, c), dtype=np.uint8)
    M[rng.random((r, c)) < 0.3] = 0
    M[rng.random((r, c)) < 0.2] = 1
    if r > 1:
        M[r // 2] = 0
    return M


def _interp_matrices():
    C = ref_gf.vandermonde_matrix(8, 3)
    return {
        "1x1": np.array([[0x53]], dtype=np.uint8),
        "sparse3x5": _sparse(3, 5, 7),
        "rsv3x8": C,
        "decode8x8": ref_gf.decode_matrix(C, 8, [0, 2, 3, 5, 6, 7, 8, 10]),
        "rand4x32": RNG.integers(0, 256, (4, 32), dtype=np.uint8),
    }


INTERP = _interp_matrices()


@pytest.mark.parametrize("kernel", ["pallas", "bitxor"])
@pytest.mark.parametrize("name", list(INTERP))
def test_plain_forms_match_jax_interpret(kernel, name):
    """The port's plain K1/K2 forms == the JAX RegionMatmul's Pallas
    bodies in interpret mode == the numpy oracle, at every length
    (exact)."""
    M = INTERP[name]
    ref = ref_k.RegionMatmul(M, interpret=True,
                             kernel="auto" if kernel == "pallas"
                             else "bitxor")
    assert ref._use_pallas
    op = K.RegionMatmul(M, kernel=kernel, device=CPU)
    for L in LENGTHS:
        data = RNG.integers(0, 256, (M.shape[1], L), dtype=np.uint8)
        want = np.asarray(ref(data))
        got = op(data)
        assert got.device == CPU and got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), want), (name, L)
        assert np.array_equal(want, ref_gf.encode_region(M, data))


@pytest.mark.parametrize("c", [1, 2, 3, 5, 8, 12, 16, 24, 32])
@pytest.mark.parametrize("kernel", ["xla", "pallas", "bitxor"])
def test_realizations_match_oracle_c_1_to_32(c, kernel):
    """Random and sparse matrices, c from 1 to 32, numpy and tensor
    inputs: every CPU realization equals the oracle (exact)."""
    for M in (RNG.integers(0, 256, (3, c), dtype=np.uint8),
              _sparse(4, c, c)):
        op = K.RegionMatmul(M, kernel=kernel, device=CPU)
        for L in (4, 508, 4100):
            data = RNG.integers(0, 256, (c, L), dtype=np.uint8)
            want = gf256.encode_region(M, data)
            assert np.array_equal(op(data).numpy(), want), (c, L)
            t = torch.from_numpy(data)
            assert np.array_equal(op(t).numpy(), want), (c, L)


@pytest.mark.parametrize("name", ["sparse3x5", "rsv3x8", "decode8x8"])
def test_graphs_match_jax_graphs(name):
    """gf_matmul_graph / gf_bitxor_graph / gf_region_graph (plain
    versions on tensors) == the JAX graphs under jit (exact)."""
    import jax

    M = INTERP[name]
    data = RNG.integers(0, 256, (M.shape[1], 2048), dtype=np.uint8)
    t = torch.from_numpy(data)
    for port_fn, ref_fn in (
            (K.gf_matmul_graph(M), ref_k.gf_matmul_graph(M)),
            (K.gf_bitxor_graph(M), ref_k.gf_bitxor_graph(M)),
            (K.gf_region_graph(M, "bitxor"),
             ref_k.gf_region_graph(M, "bitxor")),
            (K.gf_region_graph(M, "xla"), ref_k.gf_region_graph(M, "xla"))):
        want = np.asarray(jax.jit(ref_fn)(data))
        assert np.array_equal(port_fn(t).numpy(), want)


def test_terms_equal_reference():
    for M in (ref_gf.cauchy_good_matrix(8, 4), _sparse(5, 9, 3),
              np.array([[0, 1, 3]], dtype=np.uint8)):
        assert K._terms(M) == ref_k._terms(M)


def test_quantum_padding_matches_reference():
    """_quantum: 512 B up to 32 KiB, then 32 KiB multiples — the same
    answer as the JAX kernel for every boundary length."""
    M = ref_gf.vandermonde_matrix(4, 2)
    op = K.RegionMatmul(M, device=CPU)
    ref = ref_k.RegionMatmul(M)
    assert op.BLOCK == ref.BLOCK == 8192
    for L in (1, 4, 511, 512, 513, 32768, 32769, 65536, 65537, 100_000):
        assert op._quantum(L) == ref._quantum(L), L
        assert (L + (-L) % op._quantum(L)) % 4 == 0


def test_encode_lanes_refuses_ragged():
    """encode_lanes refuses n4 that is not whole tiles, or beyond one
    block not whole blocks — like the JAX kernel."""
    M = ref_gf.vandermonde_matrix(4, 2)
    op = K.RegionMatmul(M, kernel="pallas", device=CPU)
    ref = ref_k.RegionMatmul(M, interpret=True)
    for n4 in (100, 8192 + 128):
        x = np.zeros((4, n4), dtype=np.uint32)
        with pytest.raises(ValueError):
            op.encode_lanes(torch.from_numpy(x.view(np.int32)))
        with pytest.raises(ValueError):
            ref.encode_lanes(x)
    x = RNG.integers(0, 2**32, (4, 16384), dtype=np.uint32)
    got = op.encode_lanes(torch.from_numpy(x.view(np.int32)))
    assert got.dtype == torch.int32
    want = np.asarray(ref.encode_lanes(x))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_zero_rows_and_empty_length():
    """An all-zero row yields zeros; L == 0 yields an empty result."""
    M = np.zeros((2, 3), dtype=np.uint8)
    M[1, 2] = 7
    for kernel in ("xla", "pallas", "bitxor"):
        op = K.RegionMatmul(M, kernel=kernel, device=CPU)
        data = RNG.integers(0, 256, (3, 64), dtype=np.uint8)
        out = op(data).numpy()
        assert not out[0].any()
        assert np.array_equal(out, gf256.encode_region(M, data))
        assert tuple(op(np.zeros((3, 0), np.uint8)).shape) == (2, 0)


def test_kernel_supports_answers():
    M = ref_gf.vandermonde_matrix(8, 3)
    for k in ("xla", "pallas", "bitxor"):
        assert K.kernel_supports(k, M, device=CPU)
        assert K.kernel_supports(k, M, (8, 100), device=CPU)
        assert not K.kernel_supports(k, M, (7, 100), device=CPU)
    assert not K.kernel_supports("mxu", M, device=CPU)
    assert not K.kernel_supports("mxu", M, device="cuda")
    assert not K.kernel_supports("xla", M, device="cuda")
    assert not K.kernel_supports("nope", M, device=CPU)
    assert not K.kernel_supports("xla", np.zeros((0, 3)), device=CPU)
    assert K.KERNELS == ref_k.KERNELS
    with pytest.raises(ValueError):
        K.RegionMatmul(M, kernel="mxu", device=CPU)
    with pytest.raises(ValueError):
        K.RegionMatmul(M, kernel="bogus", device=CPU)


def test_bitxor_threads_follow_slot_count():
    """The block size gf_bitxor gets: the largest that fits 48 KiB,
    else what a block may opt in to, else None (unsupported)."""
    optin = 232448  # H100: 227 KiB
    assert K.bitxor_threads(10, optin) == 256
    assert K.bitxor_threads(77, optin) == 128
    assert K.bitxor_threads(452, optin) == 128
    assert K.bitxor_threads(500, optin) == 64
    assert K.bitxor_threads(optin // 128, optin) == 32
    assert K.bitxor_threads(optin // 128 + 1, optin) is None


# -- host halves of the CUDA kernels, run by emulators -------------------

def _emulate_bitterm(M, x32):
    """gf_bitterm's per-lane loop over its (coef, tab) staging."""
    coef = np.asarray(M, dtype=np.uint8)
    tab = K.bitterm_table(M).astype(np.uint32)
    x = x32.astype(np.uint32)
    y = np.zeros((coef.shape[0], x.shape[1]), dtype=np.uint32)
    for i in range(coef.shape[0]):
        for j in range(coef.shape[1]):
            if coef[i, j] == 1:
                y[i] ^= x[j]
            elif coef[i, j]:
                for s in range(8):
                    y[i] ^= ((x[j] >> s) & 0x01010101) * tab[i, j, s]
    return y


def _emulate_bitxor(prog, x32):
    """gf_bitxor's interpreter over a lowered program, slots and all."""
    x = x32.astype(np.uint32)
    slots = np.zeros((prog.n_slots, x.shape[1]), dtype=np.uint32)
    y = np.full((prog.rows, x.shape[1]), 0xDEADBEEF, dtype=np.uint32)
    for op, a, b, c in prog.code.tolist():
        if op == K.OP_LOAD:
            slots[a] = (x[b] >> c) & 0x01010101
        elif op == K.OP_XOR:
            slots[a] = slots[b] ^ slots[c]
        elif op == K.OP_INIT:
            slots[a] = slots[b] << c
        elif op == K.OP_ACC:
            slots[a] ^= slots[b] << c
        elif op == K.OP_STORE:
            y[a] = slots[b]
        else:
            assert op == K.OP_ZERO
            y[a] = 0
    return y


@pytest.mark.parametrize("name", list(INTERP))
def test_kernel_host_halves_compute_the_product(name):
    """K1's table and K2's lowered program, run the way the kernels run
    them, equal the oracle (exact) — including slot reuse."""
    M = INTERP[name]
    data = RNG.integers(0, 256, (M.shape[1], 256), dtype=np.uint8)
    x32 = data.view(np.uint32)
    want = gf256.encode_region(M, data)
    assert np.array_equal(_emulate_bitterm(M, x32).view(np.uint8), want)
    prog = K.bitxor_program(M)
    assert prog.code.dtype == np.int32 and prog.code.shape[1] == 4
    assert np.array_equal(_emulate_bitxor(prog, x32).view(np.uint8), want)


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (3, 8), (6, 6),
                                   (4, 16)])
def test_lowered_program_on_random_and_zero_rows(shape):
    """Random matrices with zero rows: every output row is written once
    (STORE or ZERO), slots stay below the node count, and the program
    equals the oracle (exact)."""
    for trial in range(3):
        M = _sparse(*shape, seed=100 * trial + shape[1])
        prog = K.bitxor_program(M)
        stores = [a for op, a, _b, _c in prog.code.tolist()
                  if op in (K.OP_STORE, K.OP_ZERO)]
        assert sorted(stores) == list(range(shape[0]))
        sched = K.bitxor_schedule(M)
        assert prog.n_slots <= sched.n_in + len(sched.ops) + shape[0]
        data = RNG.integers(0, 256, (shape[1], 128), dtype=np.uint8)
        got = _emulate_bitxor(prog, data.view(np.uint32)).view(np.uint8)
        assert np.array_equal(got, gf256.encode_region(M, data))


def test_live_set_smaller_than_node_count():
    """For the main matrices the liveness allocation keeps fewer slots
    than the schedule has nodes."""
    C = ref_gf.vandermonde_matrix(8, 3)
    for M in (C, ref_gf.decode_matrix(C, 8, [0, 2, 3, 5, 6, 7, 8, 10])):
        sched = K.bitxor_schedule(M)
        assert K.bitxor_program(M).n_slots < len(sched.used_inputs) \
            + len(sched.ops)


def test_schedule_rebuilt_from_reference_arrays_runs_equal():
    """A JAX-package schedule handed over as plain arrays drives the
    port's plain K2 form to the JAX bitxor graph's bytes (exact)."""
    import jax

    M = ref_gf.cauchy_good_matrix(8, 4)
    ref = ref_k.bitxor_schedule(M)
    sched = schedule_from_arrays(ref.n_in, ref.ops, ref.outputs,
                                 ref.used_inputs)
    data = RNG.integers(0, 256, (8, 1024), dtype=np.uint8)
    x32 = torch.from_numpy(data.view(np.int32))
    got = K.gf_bitxor_lanes(x32, sched).numpy().view(np.uint8)
    want = np.asarray(jax.jit(ref_k.gf_bitxor_graph(M))(data))
    assert np.array_equal(got, want)


def test_wrappers_count_plain_runs_on_cpu():
    """On a CPU tensor the wrappers run the plain versions: the plain
    count moves, the kernel counts do not."""
    M = ref_gf.vandermonde_matrix(8, 3)
    x32 = torch.from_numpy(
        RNG.integers(0, 256, (8, 512), dtype=np.uint8).view(np.int32))
    before = K.launch_counts()
    K.gf_bitterm_lanes(x32, K._terms(M))
    K.gf_bitxor_lanes(x32, K.bitxor_schedule(M))
    after = K.launch_counts()
    assert after["plain"] - before["plain"] >= 2
    assert after["gf_bitterm"] == before["gf_bitterm"]
    assert after["gf_bitxor"] == before["gf_bitxor"]


def test_cuda_device_without_card_raises():
    """No card here: a CUDA RegionMatmul raises instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        K.RegionMatmul(ref_gf.vandermonde_matrix(8, 3), device="cuda")


@pytest.mark.parametrize("entry", ["call", "encode_lanes"])
def test_region_op_refuses_a_tensor_off_its_device(entry):
    """A CPU op takes host input only: a tensor on another device raises
    instead of being copied to the host and run through the plain
    version (the same rule keeps a card tensor from leaving the card)."""
    op = K.RegionMatmul(ref_gf.vandermonde_matrix(8, 3), device="cpu")
    before = K.launch_counts()["plain"]
    with pytest.raises(ValueError, match="meta"):
        if entry == "call":
            op(torch.empty((8, 512), dtype=torch.uint8, device="meta"))
        else:
            op.encode_lanes(torch.empty((8, 128), dtype=torch.int32,
                                        device="meta"))
    assert K.launch_counts()["plain"] == before
