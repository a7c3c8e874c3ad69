"""G4, the ``mxu`` realization, on the CPU against the JAX package's.

On a CPU tensor the port's ``mxu`` runs its plain version (a float32 dot
of 0/1 bit-planes, gf_matmul_mxu_graph); on the card the same wrapper
launches the binary tensor-core kernel gf_bitmm.  The plain version and
RegionMatmul(kernel="mxu") are held against the JAX package's
gf_matmul_mxu_graph (jitted on the CPU) and RegionMatmul(kernel="mxu"),
and the kernel's host half — bitmm_plan's fragment table — with the
kernel's loads, fragment byte permutes, AND-popcount products, sums
paired by shift-adds, low-byte gathers and Horner steps is replayed by
an emulator on numpy uint32 words, lane by lane.  All comparisons are
integer: tolerance 0 (byte-exact).
"""

import numpy as np
import pytest
import torch

from ceph_tpu import ec as ref_ec
from ceph_tpu.ec import matrix_code as ref_mc
from ceph_tpu.ops import ec_kernels as ref_k
from ceph_tpu_torch import ec
from ceph_tpu_torch.ec import matrix_code
from ceph_tpu_torch.models.stripe_codec import StripeCodec
from ceph_tpu_torch.ops import ec_kernels as K
from ceph_tpu_torch.ops import gf256, native
from ceph_tpu_torch.utils.perf import kernel_profiler

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
LENGTHS = (0, 4, 508, 4096, 100_000)
WIDTHS = (1, 2, 8, 11, 32)


def _matrix(family: str, c: int) -> np.ndarray:
    """A matrix with c columns: a k=c code's encode matrix (m = 3), the
    decode matrix of its first min(3, c) data chunks lost, or random."""
    m = 3
    if family == "vandermonde":
        return gf256.vandermonde_matrix(c, m)
    if family == "cauchy_good":
        return gf256.cauchy_good_matrix(c, m)
    if family == "decode":
        C = gf256.vandermonde_matrix(c, m)
        lost = min(m, c)
        return gf256.decode_matrix(C, c, list(range(lost, c + lost)))
    rng = np.random.default_rng(c)
    return rng.integers(0, 256, (5, c), dtype=np.uint8)


@pytest.mark.parametrize("family", ["vandermonde", "cauchy_good", "decode",
                                    "random"])
@pytest.mark.parametrize("c", WIDTHS)
def test_mxu_equals_jax_mxu(family, c):
    """The plain version and RegionMatmul(kernel="mxu") on the CPU give
    the JAX package's mxu bytes, and the oracle's, at every length."""
    import jax.numpy as jnp

    M = _matrix(family, c)
    assert M.shape[1] == c
    rng = np.random.default_rng(1000 + c)
    ref_graph = ref_k.gf_matmul_mxu_graph(M)
    ref_op = ref_k.RegionMatmul(M, kernel="mxu")
    graph = K.gf_matmul_mxu_graph(M)
    op = K.RegionMatmul(M, kernel="mxu", device=CPU)
    for L in LENGTHS:
        data = rng.integers(0, 256, (c, L), dtype=np.uint8)
        want = gf256.encode_region(M, data)
        ref_g = np.asarray(ref_graph(jnp.asarray(data)))
        ref_o = np.asarray(ref_op(data))
        got_g = graph(torch.from_numpy(data)).numpy()
        got_o = op(data).numpy()
        for name, arr in (("jax graph", ref_g), ("jax op", ref_o),
                          ("port graph", got_g), ("port op", got_o)):
            assert np.array_equal(arr, want), (name, L)


def test_region_graph_and_out_take_mxu():
    """gf_region_graph("mxu") is G4's plain version (the JAX package's
    rule), and RegionMatmul(kernel="mxu") writes into a caller's rows."""
    M = gf256.vandermonde_matrix(8, 3)
    data = np.random.default_rng(7).integers(0, 256, (8, 4096),
                                             dtype=np.uint8)
    want = gf256.encode_region(M, data)
    got = K.gf_region_graph(M, "mxu")(torch.from_numpy(data)).numpy()
    assert np.array_equal(got, want)
    stack = torch.zeros((11, 4096), dtype=torch.uint8)
    stack[:8] = torch.from_numpy(data)
    out = K.RegionMatmul(M, kernel="mxu", device=CPU)(stack[:8],
                                                      out=stack[8:])
    assert out.data_ptr() == stack[8:].data_ptr()
    assert np.array_equal(stack[8:].numpy(), want)


def test_fused_encode_csum_graph_takes_mxu():
    """The fused encode+CRC32C op runs with an ``mxu`` pick: parity
    against the oracle, every chunk's csum against native crc32c."""
    codec = StripeCodec(8, 3)
    chunk, batch = 1024, 3
    data = np.random.default_rng(8).integers(0, 256, (8, batch * chunk),
                                             dtype=np.uint8)
    parity, csums = codec.encode_csum_graph(chunk, kernel="mxu")(
        torch.from_numpy(data))
    want = gf256.encode_region(codec.matrix, data)
    assert np.array_equal(parity.numpy(), want)
    stack = np.concatenate([data, want])
    for r in range(11):
        for b in range(batch):
            assert int(csums[r, b]) == native.crc32c(
                stack[r, b * chunk:(b + 1) * chunk].tobytes())


# --------------------------------------------------------------------------
# the kernel's arithmetic, replayed on numpy words
# --------------------------------------------------------------------------

_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3
_U32 = np.uint64(0xFFFFFFFF)


def _byte_perm(a, b, s: int) -> np.ndarray:
    """CUDA __byte_perm on uint32 arrays (selectors 0-7 only): byte n of
    the result is byte ((s >> 4n) & 7) of the 8 bytes b:a."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    both = a | (b << np.uint64(32))
    out = np.zeros(np.broadcast(a, b).shape, dtype=np.uint64)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((both >> np.uint64(8 * sel)) & np.uint64(0xFF)) \
            << np.uint64(8 * n)
    return out


def _place_sel(u: int, p: int) -> int:
    """gf_bitmm.cu place_sel: byte p of a register to byte u, zeros
    elsewhere."""
    return (0x4444 & ~(0xF << (4 * u))) | (p << (4 * u))


def _bits(regs) -> np.ndarray:
    """(32,) uint32 -> (32, 32) 0/1, bit beta of each register."""
    return ((np.asarray(regs, dtype=np.uint64)[:, None]
             >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
            ).astype(np.int64)


def _mma_b1(acc: list, a: list, b0, b1) -> list:
    """mma.m16n8k256.b1 and.popc onto ``acc``, in the layout of
    gf2_mma.cuh: a[i] of lane (g, t) is A row g + 8 (i % 2) at k =
    128 (i // 2) + 32 t + beta; b_h of lane (n, t) is B column n at k =
    128 h + 32 t + beta.  Returns d[0..3] of each lane."""
    A = np.zeros((16, 256), dtype=np.int64)
    for i in range(4):
        rows = _G + 8 * (i & 1)
        cols = 128 * (i >> 1) + 32 * _T
        A[rows[:, None], cols[:, None] + np.arange(32)] = _bits(a[i])
    B = np.zeros((256, 8), dtype=np.int64)
    for h, regs in enumerate((b0, b1)):
        B[(128 * h + 32 * _T)[:, None] + np.arange(32), _G[:, None]] = \
            _bits(regs)
    D = A @ B
    return [acc[0] + D[_G, 2 * _T], acc[1] + D[_G, 2 * _T + 1],
            acc[2] + D[_G + 8, 2 * _T], acc[3] + D[_G + 8, 2 * _T + 1]]


def _transpose4(a0, a1, a2, a3) -> list:
    """gf_bitmm.cu transpose4: byte e of word u = byte u of a_e."""
    t0 = _byte_perm(a0, a1, 0x5140)
    t1 = _byte_perm(a0, a1, 0x7362)
    t2 = _byte_perm(a2, a3, 0x5140)
    t3 = _byte_perm(a2, a3, 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _place_pair(lo_out, hi_out, d: list):
    """gf_bitmm.cu place_pair: bits 2p + 1, then 2p, of four products'
    sums d[u] onto lo (d[u][0..1]) and hi (d[u][2..3]) by pairing, a
    low-byte gather, a mask and a Horner step."""
    out = [lo_out, hi_out]
    for v in (1, 0):
        for h in range(2):
            i = 2 * h + v
            lo = (d[0][i] + d[1][i] * np.uint64(1 << 16)) & _U32
            hi = (d[2][i] + d[3][i] * np.uint64(1 << 16)) & _U32
            bits = _byte_perm(lo, hi, 0x6420) & np.uint64(0x01010101)
            out[h] = (out[h] * np.uint64(2) + bits) & _U32
    return out


def _products(sums: list, a: list, b0, b1) -> list:
    """One mma from zero, its sums kept for the test: (32,) uint64 d[0..3]
    of each lane."""
    zero = np.zeros(32, dtype=np.int64)
    d = _mma_b1([zero] * 4, a, b0, b1)
    sums.append(max(int(x.max()) for x in d))
    return [x.astype(np.uint64) for x in d]


def _group_words(a: np.ndarray, fr: np.ndarray, sums: list) -> np.ndarray:
    """gf_bitmm.cu group_words: out[h, w] of every lane from the tile's A
    words a[i, w] and the group's packed B registers fr[h]."""
    out = np.zeros((2, 4, 32), dtype=np.uint64)
    for p in (3, 2, 1, 0):
        b = [[_byte_perm(fr[h], 0, _place_sel(u, p)) for u in range(4)]
             for h in range(2)]
        for w in range(4):
            av = [a[i, w] for i in range(4)]
            d = [_products(sums, av, b[0][u], b[1][u]) for u in range(4)]
            out[0, w], out[1, w] = _place_pair(out[0, w], out[1, w], d)
    return out


def _group_columns(cw: list, fr: np.ndarray, sums: list) -> np.ndarray:
    """gf_bitmm.cu group_columns: out[q] of every lane from the tile's
    column words cw[h][q][u] and the group's B registers fr[p, h]; with
    one half of K (c <= 16) the product is m16n8k128, the k256 one with
    the upper half zero."""
    zero = np.zeros(32, dtype=np.uint64)
    out = np.zeros((4, 32), dtype=np.uint64)
    for p in (3, 2, 1, 0):
        for q in range(2):
            d = []
            for u in range(4):
                upper = ([cw[1][q][u], cw[1][q + 2][u], fr[p, 1]]
                         if len(cw) == 2 else [zero, zero, zero])
                d.append(_products(sums, [cw[0][q][u], cw[0][q + 2][u]]
                                   + upper[:2], fr[p, 0], upper[2]))
            out[q], out[q + 2] = _place_pair(out[q], out[q + 2], d)
    return out


def _emulate_gf_bitmm(M: np.ndarray, x: np.ndarray,
                      sums: list | None = None) -> np.ndarray:
    """gf_bitmm's loops for one warp over every tile of (c, L) bytes x
    (L % 16 == 0), from bitmm_plan's table: for c <= 8 gf_bitmm_words
    (load_words, group_words, two uint4 stores a group on 256 columns),
    above gf_bitmm_columns (load_rows, transpose4, group_columns, one
    uint4 store a group on 128 columns)."""
    plan = K.bitmm_plan(M)
    r, c = M.shape
    L = x.shape[1]
    sums = [] if sums is None else sums
    words = x.view("<u4")  # (c, L / 4)
    y = np.zeros((r, L // 4), dtype=np.uint32)

    def load(j, at):
        v = np.zeros((4, 32), dtype=np.uint64)  # [word, lane]
        ok = (j < c) & (at < L)
        for q in range(4):
            v[q, ok] = words[j[ok], at[ok] // 4 + q]
        return v

    def store(row, at, out):  # out (4, 32): a uint4 a lane
        ok = (row < r) & (at < L)
        for q in range(4):
            y[row[ok], at[ok] // 4 + q] = out[q, ok]

    if c <= 8:
        for tile in range(-(-L // 256)):
            col = tile * 256 + 16 * _G
            a = np.stack([load(4 * (i >> 1) + _T, col + 128 * (i & 1))
                          for i in range(4)])  # [i, w, lane]
            for G in range(plan.frag.shape[0]):
                out = _group_words(a, plan.frag[G], sums)
                for h in range(2):
                    store(4 * G + _T, col + 128 * h, out[h])
    else:
        halves = 1 if c <= 16 else 2
        for tile in range(-(-L // 128)):
            col = tile * 128 + 16 * _G
            cw = []
            for h in range(halves):
                w = [load(16 * h + 4 * _T + e, col) for e in range(4)]
                cw.append([_transpose4(w[0][q], w[1][q], w[2][q], w[3][q])
                           for q in range(4)])
            for G in range(plan.frag.shape[0]):
                store(4 * G + _T, col,
                      _group_columns(cw, plan.frag[G], sums))
    return y.view(np.uint8)


@pytest.mark.parametrize("shape", [(3, 8), (8, 5), (3, 11), (16, 32),
                                   (1, 1)])
def test_fragment_table_is_the_bitmatrix(shape):
    """bitmm_plan, with rho, v = n // 2, n % 2 for lane (n, t): for
    c <= 8 bit s of byte p of register h is bitmatrix(M)[8 (4 G + rho) +
    2 p + v, 8 (4 h + t) + s]; above, bit 8 e + s of register (p, h) is
    bitmatrix(M)[8 (4 G + rho) + 2 p + v, 8 (16 h + 4 t + e) + s]; zero
    past r rows and c columns."""
    r, c = shape
    M = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    plan = K.bitmm_plan(M)
    groups = -(-r // 4)
    assert plan.frag.shape == ((groups, 2, 32) if c <= 8
                               else (groups, 4, 2, 32))
    assert plan.frag.dtype == np.uint32
    assert plan.frag.nbytes == K.bitmm_table_bytes(r, c)
    B = gf256.bitmatrix(M)

    def want(row8, bit, j, s):
        return int(B[8 * row8 + bit, 8 * j + s]) if row8 < r and j < c \
            else 0

    for G in range(groups):
        for lane in range(32):
            n, t = lane >> 2, lane & 3
            row8, v = 4 * G + (n >> 1), n & 1
            for h in range(2):
                for p in range(4):
                    for beta in range(32):
                        if c <= 8:
                            if beta >> 3 != p:
                                continue
                            reg = plan.frag[G, h, lane]
                            j, s = 4 * h + t, beta & 7
                        else:
                            reg = plan.frag[G, p, h, lane]
                            j, s = 16 * h + 4 * t + (beta >> 3), beta & 7
                        got = (int(reg) >> beta) & 1
                        assert got == want(row8, 2 * p + v, j, s), \
                            (G, lane, h, p, beta)
    with pytest.raises(ValueError):
        K.bitmm_plan(np.ones((2, 33), dtype=np.uint8))


def test_transpose4_gathers_one_column_of_four_rows():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2**32, (4, 32), dtype=np.uint64)
    b = _transpose4(*a)
    for u in range(4):
        for e in range(4):
            assert np.array_equal((b[u] >> np.uint64(8 * e)) & np.uint64(0xFF),
                                  (a[e] >> np.uint64(8 * u)) & np.uint64(0xFF))


def test_byte_permutes_place_and_gather():
    """place_sel moves byte p to byte u and zeroes the rest; selector
    0x6420 gathers the low bytes of four sums packed two to a word as
    lo + hi * 2^16, and a sum of 256 leaves an even low byte."""
    rng = np.random.default_rng(6)
    x = rng.integers(0, 2**32, 32, dtype=np.uint64)
    for u in range(4):
        for p in range(4):
            got = _byte_perm(x, 0, _place_sel(u, p))
            assert np.array_equal(got, ((x >> np.uint64(8 * p))
                                        & np.uint64(0xFF))
                                  << np.uint64(8 * u))
    s = rng.integers(0, 257, (4, 32), dtype=np.uint64)
    s[:, 0] = 256
    lo = s[0] + s[1] * np.uint64(1 << 16)
    hi = s[2] + s[3] * np.uint64(1 << 16)
    bits = _byte_perm(lo, hi, 0x6420) & np.uint64(0x01010101)
    for u in range(4):
        assert np.array_equal((bits >> np.uint64(8 * u)) & np.uint64(0xFF),
                              s[u] & np.uint64(1))
    assert bits[0] == 0


@pytest.mark.parametrize("r", [1, 3, 8, 16])
@pytest.mark.parametrize("c", [1, 2, 7, 8, 9, 16, 17, 32])
def test_kernel_emulation_equals_encode_region(c, r):
    """The replayed kernel gives gf256.encode_region's bytes and the JAX
    package's gf_matmul_mxu_graph's: the word kernel (c <= 8) and the
    column kernel on one half of K (c <= 16, m16n8k128) and on both, one
    to four groups of rows, over whole tiles and a ragged last one (16
    columns, so most lanes load and store nothing)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(100 * c + r)
    M = rng.integers(0, 256, (r, c), dtype=np.uint8)
    x = rng.integers(0, 256, (c, 256 + 16), dtype=np.uint8)
    got = _emulate_gf_bitmm(M, x)
    want = gf256.encode_region(M, x)
    assert np.array_equal(got, want)
    assert np.array_equal(
        np.asarray(ref_k.gf_matmul_mxu_graph(M)(jnp.asarray(x))), want)


def _full_row_element(k: int) -> int:
    """The GF(2^8) element a whose bitmatrix row k is all ones (bit k of
    a * x^s set for every s < 8): a row of them makes every bit-column
    count in row k's sums."""
    for a in range(1, 256):
        if gf256.bitmatrix(np.array([[a]], dtype=np.uint8))[k].all():
            return a
    raise AssertionError(f"no element for bit {k}")


def test_a_sum_of_256_keeps_its_parity():
    """All-0xFF data at c = 32 under a row whose bitmatrix rows are all
    ones: one product of the column kernel sums all 256 k-bits, whose low
    byte is 0, even, and the replay still gives encode_region's bytes."""
    M = np.array([[_full_row_element(0)] * 32, [_full_row_element(7)] * 32],
                 dtype=np.uint8)
    x = np.full((32, 272), 0xFF, dtype=np.uint8)
    sums: list = []
    got = _emulate_gf_bitmm(M, x, sums)
    assert max(sums) == 256
    assert np.array_equal(got, gf256.encode_region(M, x))


# --------------------------------------------------------------------------
# viability and the race
# --------------------------------------------------------------------------

def test_kernel_supports_mxu_up_to_32_columns():
    for c, ok in ((32, True), (33, False)):
        M = np.ones((3, c), dtype=np.uint8)
        assert ref_k.kernel_supports("mxu", M) is ok
        assert K.kernel_supports("mxu", M, device=CPU) is ok
        if not ok:
            # refused before the card is asked for its shared memory
            assert not K.kernel_supports("mxu", M, device="cuda")
            with pytest.raises(ValueError):
                K.RegionMatmul(M, kernel="mxu", device=CPU)
            with pytest.raises(ValueError):
                K.gf_matmul_mxu_graph(M)


def test_kernel_supports_mxu_needs_its_table_in_shared_memory(monkeypatch):
    """On the card ``mxu`` needs its fragment table to fit what a block
    may opt in to: BITMM_GROUP_BYTES a group of 4 output rows for c <= 8,
    BITMM_COLUMN_GROUP_BYTES above."""
    from ceph_tpu_torch.ops import cuda_lib

    monkeypatch.setattr(cuda_lib, "smem_optin",
                        lambda device: K.BITMM_COLUMN_GROUP_BYTES)
    for shape, ok in (((16, 8), True), ((17, 8), False), ((4, 32), True),
                      ((5, 9), False)):
        assert K.kernel_supports("mxu", np.ones(shape, np.uint8),
                                 device="cuda") is ok, shape


def test_race_order_is_the_references_less_xla():
    assert matrix_code.KERNEL_RACE_ORDER == tuple(
        k for k in ref_mc.KERNEL_RACE_ORDER if k != "xla")
    assert "mxu" in matrix_code.KERNEL_RACE_ORDER


def _skips() -> int:
    return kernel_profiler()._perf.get("ec_kernel_pick_skip")


def test_pinned_mxu_on_a_wide_matrix_books_a_skip():
    """A 2x40 matrix pinned to mxu falls through with the skip booked,
    as the JAX package's test_unsupported_pin_skips_not_raises pins."""
    before = _skips()
    codec = ec.factory("tpu", {"k": 40, "m": 2, "device": "cpu",
                               "kernel": "mxu"})
    data = np.random.default_rng(9).integers(0, 256, (40, 1024),
                                             dtype=np.uint8)
    got = codec.encode_chunks(data)
    assert np.array_equal(got, gf256.encode_region(codec.matrix, data))
    assert _skips() > before
    (sig, picked), = codec.kernel_picks().items()
    assert picked != "mxu"
    assert kernel_profiler().picks()[sig]["skipped"] == ["mxu"]
    ref = ref_ec.factory("tpu", {"k": 40, "m": 2, "backend": "jax",
                                 "kernel": "mxu"})
    assert np.array_equal(ref.encode_chunks(data), got)


def test_pinned_mxu_runs_on_a_narrow_matrix():
    codec = ec.factory("tpu", {"k": 8, "m": 3, "device": "cpu",
                               "kernel": "mxu"})
    data = np.random.default_rng(10).integers(0, 256, (8, 2048),
                                              dtype=np.uint8)
    before = K.launch_counts()["plain"]
    got = codec.encode_chunks(data)
    assert K.launch_counts()["plain"] > before
    assert np.array_equal(got, gf256.encode_region(codec.matrix, data))
    assert set(codec.kernel_picks().values()) == {"mxu"}
