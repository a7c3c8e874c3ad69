"""G4, the ``mxu`` realization, on the CPU against the JAX package's.

On a CPU tensor the port's ``mxu`` runs its plain version (a float32 dot
of 0/1 bit-planes, gf_matmul_mxu_graph); on the card the same wrapper
launches the binary tensor-core kernel gf_bitmm.  The plain version and
RegionMatmul(kernel="mxu") are held against the JAX package's
gf_matmul_mxu_graph (jitted on the CPU) and RegionMatmul(kernel="mxu"),
and the kernel's host half — bitmm_plan's fragment table — with the
kernel's loads, byte-permute transpose, AND-popcount products, packing
and quad reduce-scatter is replayed by an emulator on numpy uint32
words, lane by lane.  All comparisons are integer: tolerance 0
(byte-exact).
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
    return out.astype(np.uint32)


def _transpose4(a0, a1, a2, a3) -> list:
    """gf_bitmm.cu transpose4: byte e of word u = byte u of a_e."""
    t0 = _byte_perm(a0, a1, 0x5140)
    t1 = _byte_perm(a0, a1, 0x7362)
    t2 = _byte_perm(a2, a3, 0x5140)
    t3 = _byte_perm(a2, a3, 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _bits(regs) -> np.ndarray:
    """(32,) uint32 -> (32, 32) 0/1, bit beta of each register."""
    return ((np.asarray(regs, dtype=np.uint64)[:, None]
             >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
            ).astype(np.int64)


def _mma_b1(a: list, b0, b1) -> list:
    """mma.m16n8k256.b1 and.popc from zero, in the layout of
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
    return [D[_G, 2 * _T], D[_G, 2 * _T + 1], D[_G + 8, 2 * _T],
            D[_G + 8, 2 * _T + 1]]


def _shfl_xor(v, m: int) -> np.ndarray:
    return np.asarray(v)[_LANE ^ m]


def _reduce_scatter(w: list) -> np.ndarray:
    """gf_bitmm.cu quad_reduce_scatter: lane t gets word t of the OR of
    its quad's four w[0..3]."""
    hi = (_T & 2) != 0
    k0 = np.where(hi, w[2], w[0])
    k1 = np.where(hi, w[3], w[1])
    k0 = k0 | _shfl_xor(np.where(hi, w[0], w[2]), 2)
    k1 = k1 | _shfl_xor(np.where(hi, w[1], w[3]), 2)
    odd = (_T & 1) != 0
    return np.where(odd, k1, k0) | _shfl_xor(np.where(odd, k0, k1), 1)


def _emulate_gf_bitmm(M: np.ndarray, x: np.ndarray) -> np.ndarray:
    """gf_bitmm's loops for one warp over every tile of (c, L) bytes x
    (L % 16 == 0), from bitmm_plan's table."""
    plan = K.bitmm_plan(M)
    r, c = M.shape
    L = x.shape[1]
    words = x.view("<u4")  # (c, L / 4)
    y = np.zeros((r, L // 4), dtype=np.uint32)
    for tile in range(-(-L // 128)):
        col = tile * 128 + 16 * _G
        live = col < L
        cw = [[None] * 4 for _ in range(2)]
        for h in range(2):
            w = np.zeros((4, 4, 32), dtype=np.uint32)  # [e][q][lane]
            for e in range(4):
                j = 16 * h + 4 * _T + e
                ok = live & (j < c)
                for q in range(4):
                    w[e, q, ok] = words[j[ok], col[ok] // 4 + q]
            for q in range(4):
                cw[h][q] = _transpose4(w[0, q], w[1, q], w[2, q], w[3, q])
        for i in range(r):
            b0, b1 = plan.frag[i, 0], plan.frag[i, 1]
            out = [np.zeros(32, dtype=np.uint32) for _ in range(4)]
            for q in range(2):
                for u in range(4):
                    d = _mma_b1([cw[0][q][u], cw[0][q + 2][u], cw[1][q][u],
                                 cw[1][q + 2][u]], b0, b1)
                    sh = (8 * u + 2 * _T).astype(np.uint32)
                    out[q] |= (((d[0] & 1) | ((d[1] & 1) << 1))
                               .astype(np.uint32) << sh)
                    out[q + 2] |= (((d[2] & 1) | ((d[3] & 1) << 1))
                                   .astype(np.uint32) << sh)
            word = _reduce_scatter(out)
            y[i, (col[live] + 4 * _T[live]) // 4] = word[live]
    return y.view(np.uint8)


def test_fragment_table_is_the_bitmatrix():
    """bitmm_plan: bit 8e + s of register h of lane (n, t) for output row
    i is bitmatrix(M)[8i + n, 8(16h + 4t + e) + s], zero past 8c."""
    M = np.random.default_rng(5).integers(0, 256, (3, 11), dtype=np.uint8)
    plan = K.bitmm_plan(M)
    assert plan.frag.shape == (3, 2, 32) and plan.frag.dtype == np.uint32
    B = gf256.bitmatrix(M)
    for i in range(3):
        for h in range(2):
            for lane in range(32):
                n, t = lane >> 2, lane & 3
                for beta in range(32):
                    e, s = beta >> 3, beta & 7
                    j = 16 * h + 4 * t + e
                    want = int(B[8 * i + n, 8 * j + s]) if j < 11 else 0
                    assert (int(plan.frag[i, h, lane]) >> beta) & 1 == want
    with pytest.raises(ValueError):
        K.bitmm_plan(np.ones((2, 33), dtype=np.uint8))


def test_transpose4_gathers_one_column_of_four_rows():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2**32, (4, 32), dtype=np.uint64).astype(np.uint32)
    b = _transpose4(*a)
    for u in range(4):
        for e in range(4):
            assert np.array_equal((b[u] >> np.uint32(8 * e)) & 0xFF,
                                  (a[e] >> np.uint32(8 * u)) & 0xFF)


@pytest.mark.parametrize("shape,L", [((1, 8), 16), ((3, 8), 400),
                                     ((1, 1), 16), ((4, 32), 272),
                                     ((2, 11), 144), ((8, 17), 128)])
def test_kernel_emulation_equals_encode_region(shape, L):
    """The replayed kernel gives gf256.encode_region's bytes, for r = 1,
    c = 1 and c = 32 (a full k-step), and a ragged last tile."""
    rng = np.random.default_rng(sum(shape) + L)
    M = rng.integers(0, 256, shape, dtype=np.uint8)
    x = rng.integers(0, 256, (shape[1], L), dtype=np.uint8)
    assert np.array_equal(_emulate_gf_bitmm(M, x), gf256.encode_region(M, x))


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
    """On the card ``mxu`` needs BITMM_ROW_BYTES a row of M to fit what a
    block may opt in to."""
    from ceph_tpu_torch.ops import cuda_lib

    monkeypatch.setattr(cuda_lib, "smem_optin",
                        lambda device: 4 * K.BITMM_ROW_BYTES)
    assert K.kernel_supports("mxu", np.ones((4, 8), np.uint8),
                             device="cuda")
    assert not K.kernel_supports("mxu", np.ones((5, 8), np.uint8),
                                 device="cuda")


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
