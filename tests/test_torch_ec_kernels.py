"""The port's region kernels on the CPU against the JAX package's.

On a CPU tensor the port's wrappers run their kernels' plain versions:
``pallas`` -> the bit-term chain (kernel gf_bitterm on the card),
``bitxor`` -> the scheduled-XOR program (kernel gf_bitxor on the card).
They are held against the JAX RegionMatmul with its Pallas bodies in
interpret mode, and against the numpy oracle gf256.encode_region.  The
host halves of the CUDA kernels — K1's nibble table with the byte
permutes (PTX prmt) that read it, and K2's bit-plane CSR with the bit
order of its in-register transpose — are run here by emulators that
follow the kernels' loops on numpy uint32 words.
All comparisons are integer: tolerance 0 (byte-exact).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from ceph_tpu.ops import ec_kernels as ref_k
from ceph_tpu.ops import gf256 as ref_gf
from ceph_tpu_torch.ec.convert import schedule_from_arrays
from ceph_tpu_torch.ops import ec_kernels as K
from ceph_tpu_torch.ops import gf256

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

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


def test_kernel_supports_pallas_needs_its_table_in_shared_memory(
        monkeypatch):
    """On the card ``pallas`` needs 33 bytes a coefficient (nibble_table's
    32 and the flag byte) to fit what a block may opt in to."""
    from ceph_tpu_torch.ops import cuda_lib

    monkeypatch.setattr(cuda_lib, "smem_optin", lambda device: 33 * 64)
    for shape, ok in (((8, 8), True), ((1, 64), True), ((8, 9), False),
                      ((1, 65), False)):
        M = np.full(shape, 7, dtype=np.uint8)
        assert K.kernel_supports("pallas", M, device="cuda") is ok, shape
    monkeypatch.setattr(cuda_lib, "smem_optin", lambda device: 232448)
    assert K.kernel_supports("pallas", np.ones((32, 32), np.uint8),
                             device="cuda")
    assert K.kernel_supports("pallas", np.ones((1, 7043), np.uint8),
                             device="cuda")
    assert not K.kernel_supports("pallas", np.ones((1, 7044), np.uint8),
                                 device="cuda")


def test_kernel_supports_bitxor_needs_its_planes_in_shared_memory(
        monkeypatch):
    """On the card ``bitxor`` needs the (8c + 1) planes of a 32-thread
    block, 4 bytes each, to fit what a block may opt in to."""
    from ceph_tpu_torch.ops import cuda_lib

    monkeypatch.setattr(cuda_lib, "smem_optin", lambda device: 232448)
    assert K.BITXOR_MIN_THREADS == 32
    for c, ok in ((1, True), (32, True), (226, True), (227, False)):
        M = np.ones((2, c), dtype=np.uint8)
        assert K.kernel_supports("bitxor", M, device="cuda") is ok, c


# -- host halves of the CUDA kernels, run by emulators -------------------

def _prmt(a, b, s):
    """PTX prmt.b32 in its default mode, on uint32 arrays: byte n of the
    result is byte (s >> 4n) & 7 of the 8 bytes {b, a} (bytes 0-3 from
    a), or, where bit 4n + 3 of s is set, that byte's top bit copied into
    all 8 bits.  Only the low 16 bits of s are read."""
    a, b, s = (np.asarray(t, dtype=np.uint64) for t in (a, b, s))
    src = (b << np.uint64(32)) | a
    out = np.zeros(np.broadcast(a, b, s).shape, dtype=np.uint64)
    for n in range(4):
        sel = (s >> np.uint64(4 * n)) & np.uint64(15)
        byte = (src >> (np.uint64(8) * (sel & np.uint64(7)))) & np.uint64(255)
        sign = np.where(byte & np.uint64(128), np.uint64(255), np.uint64(0))
        byte = np.where(sel & np.uint64(8), sign, byte)
        out |= byte << np.uint64(8 * n)
    return out.astype(np.uint32)


def _nibbles(v):
    """gf_bitterm's per-word selectors and masks (``nibbles`` in
    csrc/gf_region.cu): (lo, hi, mlo, mhi)."""
    v = np.asarray(v, dtype=np.uint32)
    t = v & np.uint32(0x07070707)
    h = (v >> np.uint32(4)) & np.uint32(0x07070707)
    return (_prmt(t | (t >> np.uint32(4)), 0, 0x0020),
            _prmt(h | (h >> np.uint32(4)), 0, 0x0020),
            _prmt(v << np.uint32(4), 0, 0xBA98),
            _prmt(v, 0, 0xBA98))


def _emulate_bitterm(M, x32, combine="split"):
    """gf_bitterm's loop over its staged coefficient flags and
    nibble_table: each input word's Nibbles once, then per output row a
    coefficient 1 as one XOR, 0 skipped, and any other by the kernel's
    combine: ``split`` (the library's: 8-entry lookups of lo[0..7] and
    hi[0..7] and the bit-3 / bit-7 terms from lo[8] and hi[8]) or
    ``select16`` (whole 16-entry lookups, two prmts and a select per
    nibble)."""
    coef = np.asarray(M, dtype=np.uint8)
    tab = K.nibble_table(M).view("<u4")  # (r, c, 8): lo words, hi words
    x = np.asarray(x32).astype(np.uint32)
    r, c = coef.shape
    y = np.zeros((r, x.shape[1]), dtype=np.uint32)
    for j in range(c):
        lo_s, hi_s, mlo, mhi = _nibbles(x[j])
        for i in range(r):
            if coef[i, j] == 1:
                y[i] ^= x[j]
            elif coef[i, j]:
                lo, hi = tab[i, j, :4], tab[i, j, 4:]
                if combine == "select16":
                    l0 = _prmt(lo[0], lo[1], lo_s)
                    l1 = _prmt(lo[2], lo[3], lo_s)
                    h0 = _prmt(hi[0], hi[1], hi_s)
                    h1 = _prmt(hi[2], hi[3], hi_s)
                    y[i] ^= ((l0 & ~mlo) | (l1 & mlo)) ^ \
                        ((h0 & ~mhi) | (h1 & mhi))
                else:
                    b8, b128 = _prmt(lo[2], 0, 0), _prmt(hi[2], 0, 0)
                    y[i] ^= (_prmt(lo[0], lo[1], lo_s)
                             ^ _prmt(hi[0], hi[1], hi_s)
                             ^ (mlo & b8) ^ (mhi & b128))
    return y


def _bitterm_matrices():
    """chip_smoke's matrices, and two whose coefficients are mostly 0 and
    1 beside 0x80, 0xFF and 0x08."""
    mats = dict(chip_smoke.smoke_matrices(np.random.default_rng(5)))
    mats["0/1 3x3"] = np.array([[0, 1, 0x80], [1, 0, 0xFF], [0, 0, 0]],
                               dtype=np.uint8)
    mats["0/1 2x5"] = np.array([[1, 1, 0, 0x08, 1], [0, 0x80, 1, 1, 0]],
                               dtype=np.uint8)
    return mats


BITTERM_MATS = _bitterm_matrices()
#: input bytes: random, and constant bytes with bits 3 and 7 (the
#: sign-replicate masks) on and off
BITTERM_DATA = ("random", 0x80, 0xFF, 0x08, 0x77)


def _bitterm_data(M, kind, L=512):
    if kind == "random":
        return np.random.default_rng(M.size).integers(
            0, 256, (M.shape[1], L), dtype=np.uint8)
    return np.full((M.shape[1], L), kind, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_xla(name):
    """The JAX RegionMatmul(kernel="xla") of a BITTERM_MATS matrix, one
    per matrix so that every input kind reuses its compiled graph."""
    return ref_k.RegionMatmul(BITTERM_MATS[name], kernel="xla")


@pytest.mark.parametrize("combine", ["split", "select16"])
@pytest.mark.parametrize("kind", BITTERM_DATA)
@pytest.mark.parametrize("name", list(BITTERM_MATS))
def test_bitterm_emulator_matches_oracle_and_jax(name, kind, combine):
    """gf_bitterm's steps on numpy words (prmt with sign-replicate, the
    selector packing and masks, nibble_table, the combine) equal
    gf256.encode_region and the JAX RegionMatmul's xla form byte for
    byte, on every chip_smoke matrix (c up to 32) and on inputs whose
    bytes set bits 3 and 7 (exact)."""
    M = BITTERM_MATS[name]
    data = _bitterm_data(M, kind)
    got = _emulate_bitterm(M, data.view("<u4"), combine).view(np.uint8)
    want = gf256.encode_region(M, data)
    assert np.array_equal(got, want)
    assert np.array_equal(want, np.asarray(_jax_xla(name)(data)))


def test_prmt_follows_ptx_default_mode():
    """The emulator's prmt: index bytes of {b, a}, sign-replicate where
    the selector nibble's top bit is set, selector bits above 15
    ignored."""
    a, b = 0x83_02_81_00, 0x07_86_05_04
    assert _prmt(a, b, 0x3210) == a
    assert _prmt(a, b, 0x7654) == b
    assert _prmt(a, b, 0x0246) == 0x00_02_04_86
    assert _prmt(a, b, 0xBA98) == 0xFF_00_FF_00
    assert _prmt(a, b, 0xFFFF_1111) == 0x81_81_81_81
    assert _prmt(a, 0, 0x0000) == 0x00_00_00_00
    assert _prmt(0xAB, 0, 0x0000) == 0xAB_AB_AB_AB


def test_nibble_selectors_pack_each_byte():
    """Nibble k of the lo / hi selectors is bits 0-2 / 4-6 of byte k,
    and byte k of the masks is 0xFF where bit 3 / 7 of byte k is set."""
    v = np.random.default_rng(9).integers(0, 256, (1000, 4), dtype=np.uint8)
    lo, hi, mlo, mhi = _nibbles(v.view("<u4")[:, 0])
    for k in range(4):
        nib = lambda w: (w >> np.uint32(4 * k)) & np.uint32(15)
        byte = lambda w: (w >> np.uint32(8 * k)) & np.uint32(255)
        assert np.array_equal(nib(lo), v[:, k] & 7)
        assert np.array_equal(nib(hi), (v[:, k] >> 4) & 7)
        assert np.array_equal(byte(mlo), np.where(v[:, k] & 8, 255, 0))
        assert np.array_equal(byte(mhi), np.where(v[:, k] & 128, 255, 0))


def test_nibble_table_is_the_products():
    """nibble_table(M)[i, j] is lo[n] = M[i,j] * n then hi[n] =
    M[i,j] * (n << 4), n < 16, over GF(2^8)."""
    M = np.random.default_rng(11).integers(0, 256, (5, 7), dtype=np.uint8)
    M[0, 0], M[0, 1] = 0, 1
    tab = K.nibble_table(M)
    assert tab.shape == (5, 7, 32) and tab.dtype == np.uint8
    for i in range(5):
        for j in range(7):
            for n in range(16):
                assert tab[i, j, n] == gf256.gf_mul(int(M[i, j]), n)
                assert tab[i, j, 16 + n] == gf256.gf_mul(int(M[i, j]),
                                                          n << 4)


def _bitslice(words):
    """gf_bitxor's in-register transpose (bitslice in csrc/gf_region.cu)
    on (8, n) uint32 words: three delta-swap stages over word pairs."""
    w = np.array(words, dtype=np.uint32)
    for d, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F)):
        for k in range(8):
            if k & d:
                continue
            t = ((w[k] >> d) ^ w[k + d]) & np.uint32(m)
            w[k + d] ^= t
            w[k] ^= t << np.uint32(d)
    return w


def _emulate_bitxor(plan, x32):
    """gf_bitxor's loop over its plan: each thread's 32-byte column group
    (uint4 lanes g and g + n4 / 8 of a row) transposed into planes, plane
    8c kept zero, each output plane the XOR of its CSR quads, and the
    output planes transposed back into the same two lanes."""
    x = np.asarray(x32).astype(np.uint32)
    c, n4 = x.shape
    assert c == plan.cols and n4 % 8 == 0
    groups = n4 // 8
    x4 = x.reshape(c, 2, groups, 4)
    planes = np.zeros((8 * c + 1, groups), dtype=np.uint32)
    for j in range(c):
        planes[8 * j:8 * j + 8] = _bitslice(
            np.concatenate([x4[j, 0].T, x4[j, 1].T]))
    y4 = np.full((plan.rows, 2, groups, 4), 0xDEADBEEF, dtype=np.uint32)
    for i in range(plan.rows):
        acc = np.zeros((8, groups), dtype=np.uint32)
        for s in range(8):
            q = 8 * i + s
            for quad in plan.idx[plan.ptr[q]:plan.ptr[q + 1]]:
                for p in quad:
                    acc[s] ^= planes[p]
        out = _bitslice(acc)
        y4[i, 0], y4[i, 1] = out[:4].T, out[4:].T
    return y4.reshape(plan.rows, n4)


def _check_plan(M, plan):
    """The CSR lists each one of bitmatrix(M) once, in whole quads padded
    with the zero plane 8c only."""
    r, c = M.shape
    B = gf256.bitmatrix(M)
    assert plan.ptr.dtype == plan.idx.dtype == np.int32
    assert plan.ptr.shape == (8 * r + 1,) and plan.idx.shape[1] == 4
    assert (plan.rows, plan.cols) == (r, c)
    for q in range(8 * r):
        got = plan.idx[plan.ptr[q]:plan.ptr[q + 1]].ravel()
        assert list(got[got != 8 * c]) == list(np.nonzero(B[q])[0])
        assert (got == 8 * c).sum() < 4


def test_bitslice_bit_order_and_round_trip():
    """The transpose puts bit s of byte 4k + b at bit 8b + k of word s,
    and applied twice it is the identity, on random bytes."""
    data = RNG.integers(0, 256, (1000, 32), dtype=np.uint8)
    words = data.view("<u4").T  # (8, 1000): word k = bytes 4k..4k+3
    planes = _bitslice(words)
    bits = np.unpackbits(data[:, :, None], axis=2, bitorder="little")
    for s in range(8):
        for k in range(8):
            for b in range(4):
                got = (planes[s] >> np.uint32(8 * b + k)) & np.uint32(1)
                assert np.array_equal(got, bits[:, 4 * k + b, s])
    assert np.array_equal(_bitslice(planes), words)


@pytest.mark.parametrize("name", list(INTERP))
def test_kernel_host_halves_compute_the_product(name):
    """K1's nibble table and K2's plan, run the way the kernels run them, equal
    the oracle and the JAX RegionMatmul's bitxor body in interpret mode
    (exact)."""
    M = INTERP[name]
    data = RNG.integers(0, 256, (M.shape[1], 512), dtype=np.uint8)
    x32 = data.view(np.uint32)
    want = gf256.encode_region(M, data)
    assert np.array_equal(_emulate_bitterm(M, x32).view(np.uint8), want)
    plan = K.bitxor_plan(M)
    _check_plan(M, plan)
    assert np.array_equal(_emulate_bitxor(plan, x32).view(np.uint8), want)
    ref = ref_k.RegionMatmul(M, interpret=True, kernel="bitxor")
    assert ref._use_pallas
    assert np.array_equal(np.asarray(ref(data)), want)


@pytest.mark.parametrize("c", [1, 2, 3, 5, 8, 12, 16, 24, 32])
def test_bitxor_plan_c_1_to_32(c):
    """Random and sparse matrices, c from 1 to 32: the plan, run the way
    gf_bitxor runs it, equals the oracle (exact)."""
    for M in (RNG.integers(0, 256, (3, c), dtype=np.uint8),
              _sparse(4, c, c)):
        plan = K.bitxor_plan(M)
        _check_plan(M, plan)
        data = RNG.integers(0, 256, (c, 256), dtype=np.uint8)
        got = _emulate_bitxor(plan, data.view(np.uint32)).view(np.uint8)
        assert np.array_equal(got, gf256.encode_region(M, data)), c


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (3, 8), (6, 6),
                                   (4, 16)])
def test_bitxor_plan_on_random_and_zero_rows(shape):
    """Random sparse matrices with zero rows: a zero row of M has an
    empty CSR row for each of its 8 planes (the kernel stores zeros), and
    the plan equals the oracle (exact)."""
    for trial in range(3):
        M = _sparse(*shape, seed=100 * trial + shape[1])
        plan = K.bitxor_plan(M)
        _check_plan(M, plan)
        for i in np.nonzero(~M.any(axis=1))[0]:
            assert plan.ptr[8 * i] == plan.ptr[8 * i + 8]
        data = RNG.integers(0, 256, (shape[1], 128), dtype=np.uint8)
        got = _emulate_bitxor(plan, data.view(np.uint32)).view(np.uint8)
        assert np.array_equal(got, gf256.encode_region(M, data))


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
