"""CRC32C of the port (ceph_tpu_torch/ops/checksum.py) against the JAX
package on the same seeded inputs: the plain version of CrcPlan.device_fn
against the jitted JAX graph and the native library, the host operator
algebra, the fused encode+CRC graph, and a numpy replay of the CUDA
kernel (its split, tables, fragment layouts, integer products and
packing), at the library's setting and at the settings the variant race
runs.  Every
comparison is exact (tolerance 0): CRC32C is integer math."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from ceph_tpu.models.stripe_codec import StripeCodec as JaxStripeCodec
from ceph_tpu.ops import checksum as jax_checksum
from ceph_tpu.ops import native as jax_native
from ceph_tpu_torch.models import StripeCodec
from ceph_tpu_torch.ops import checksum, native

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

#: the lengths of tests/test_checksum.py, and 4100 (not a power of two
#: of words, and just past a 4 KiB chunk)
LENGTHS = (4, 8, 12, 100, 4096, 4100, 12288, 65536)


def _rows(seed: int, n: int, nbytes: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, nbytes),
                                                dtype=np.uint8)


@pytest.mark.parametrize("nbytes", LENGTHS)
def test_plain_device_fn_equals_jax_graph_and_native(nbytes):
    import jax

    data = _rows(nbytes, 4, nbytes)
    want = np.asarray(jax.jit(jax_checksum.CrcPlan(nbytes).device_fn())(
        data.view(np.uint32)))
    got = checksum.CrcPlan(nbytes).device_fn()(
        torch.from_numpy(data).view(torch.int32))
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, [jax_native.crc32c(bytes(r)) for r in data])
    assert [native.crc32c(r) for r in data] == list(want)


def test_device_fn_keeps_leading_dims():
    data = _rows(1, 6, 2 * 512)
    fn = checksum.crc_plan(512).device_fn()
    got = fn(torch.from_numpy(data).view(torch.int32).reshape(3, 2, 2, 128))
    assert got.shape == (3, 2, 2)
    want = [native.crc32c(r) for r in data.reshape(-1, 512)]
    assert got.reshape(-1).numpy().tolist() == want


@pytest.mark.parametrize("nbytes", [4, 12, 1000, 4096, 12288])
def test_plan_constants_equal_reference(nbytes):
    ours, ref = checksum.CrcPlan(nbytes), jax_checksum.CrcPlan(nbytes)
    assert ours.padded_words == ref.padded_words
    assert np.array_equal(ours.leaf_bits, ref.leaf_bits)
    assert ours.final_xor == ref.final_xor
    assert len(ours.level_ops) == len(ref.level_ops)
    for a, b in zip(ours.level_ops, ref.level_ops):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("nbytes", [1, 4, 7, 100, 4096, 1 << 20])
def test_zero_operator_equals_reference(nbytes):
    assert np.array_equal(checksum._zero_operator(nbytes),
                          jax_checksum._zero_operator(nbytes))


def test_extend_zeros_equals_reference_and_native():
    rng = np.random.default_rng(5)
    for n, pad in ((1, 0), (17, 3), (1000, 24), (4096, 2048),
                   (5000, 131_072 - 5000)):
        blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        crc = native.crc32c(blob)
        got = checksum.crc32c_extend_zeros(crc, pad)
        assert got == jax_checksum.crc32c_extend_zeros(crc, pad)
        assert got == native.crc32c(blob + bytes(pad))
    assert checksum.crc32c_ref(blob) == jax_checksum.crc32c_ref(blob)


def test_bad_lengths_rejected():
    for n in (0, 2, 6):
        with pytest.raises(ValueError):
            checksum.CrcPlan(n)
    with pytest.raises(ValueError):
        checksum.crc_plan(4).device_fn()(torch.zeros((2, 2),
                                                     dtype=torch.int32))
    with pytest.raises(TypeError):
        checksum.crc32c_chunks(torch.zeros((1, 1), dtype=torch.uint8),
                               checksum.crc_plan(4))


def test_fused_encode_csum_graph_equals_jax():
    """The port's two-launch encode_csum_graph (region op into out=,
    then the CRC over the stack) against the JAX fused graph: k=3, m=2,
    8 KiB chunks, batch 4."""
    import jax

    chunk, batch = 8192, 4
    data = _rows(9, 3, batch * chunk)
    want_p, want_c = map(np.asarray, jax.jit(
        JaxStripeCodec(k=3, m=2).encode_csum_graph(chunk))(data))
    parity, csums = StripeCodec(k=3, m=2).encode_csum_graph(chunk)(
        torch.from_numpy(data))
    assert np.array_equal(parity.numpy(), want_p)
    assert csums.shape == (5, batch)
    assert np.array_equal(csums.numpy(), want_c)


# ---------------------------------------------------------------------------
# the CUDA kernel's host half, replayed in numpy
# ---------------------------------------------------------------------------

_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3
#: the settings of experiments/crc_variants.py beside the library's
RACE_GEOMETRIES = (checksum.CrcGeometry(False, 4, 1, 8, 32),
                   checksum.CrcGeometry(False, 2, 1, 8, 32),
                   checksum.CrcGeometry(True, 4, 1, 8, 64),
                   checksum.CrcGeometry(True, 4, 2, 8, 32),
                   checksum.CrcGeometry(True, 4, 4, 4, 32))


def _elements(regs: np.ndarray, b1: bool) -> np.ndarray:
    """(..., n) uint32 registers -> (..., n, W) int64 elements: 32 bits
    (binary) or 4 signed bytes (int8), element x of a register first."""
    regs = np.ascontiguousarray(regs, dtype=np.uint32)
    if b1:
        return ((regs.astype(np.uint64)[..., None]
                 >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
                ).astype(np.int64)
    return regs.view(np.int8).reshape(regs.shape + (4,)).astype(np.int64)


def _frag_a(regs: np.ndarray, b1: bool) -> np.ndarray:
    """(..., 32 lanes, 4) A registers -> (..., 16, K): register i of lane
    (g, t) holds row g + 8 (i % 2) at columns K/2 (i // 2) + W t + x."""
    el = _elements(regs, b1)
    W = el.shape[-1]
    K = 8 * W
    A = np.zeros(regs.shape[:-2] + (16, K), dtype=np.int64)
    for i in range(4):
        for x in range(W):
            A[..., _G + 8 * (i & 1), K // 2 * (i >> 1) + W * _T + x] = \
                el[..., :, i, x]
    return A


def _frag_b(regs: np.ndarray, b1: bool) -> np.ndarray:
    """(2, 32 lanes) B registers -> (K, 8): register r of lane (g, t)
    holds column g at rows K/2 r + W t + x."""
    el = _elements(regs.T, b1)
    W = el.shape[-1]
    K = 8 * W
    B = np.zeros((K, 8), dtype=np.int64)
    for r in range(2):
        for x in range(W):
            B[K // 2 * r + W * _T + x, _G] = el[:, r, x]
    return B


def _mma(acc: np.ndarray, a_regs: np.ndarray, b_regs: np.ndarray,
         b1: bool) -> None:
    """acc (..., 4 n-tiles, 32 lanes, 4) += A B for each n-tile, in the
    C layout: c0, c1 row g columns 2t, 2t + 1; c2, c3 row g + 8."""
    A = _frag_a(a_regs, b1)
    for nt in range(4):
        D = A @ _frag_b(b_regs[nt], b1)
        acc[..., nt, :, :] += np.stack(
            [D[..., _G, 2 * _T], D[..., _G, 2 * _T + 1],
             D[..., _G + 8, 2 * _T], D[..., _G + 8, 2 * _T + 1]], -1)


def _low_bytes(a, b, c, d) -> np.ndarray:
    """byte_perm of the low bytes of four accumulators."""
    return ((a & 0xFF) | (b & 0xFF) << 8 | (c & 0xFF) << 16
            | (d & 0xFF) << 24).astype(np.uint32)


def _emulate_crc32c_chunks(rows: np.ndarray, nbytes: int,
                           geo=checksum.CRC_GEOMETRY) -> np.ndarray:
    """crc32c_chunks as csrc/crc32c.cu computes it at ``geo``, on the
    tables the wrapper uploads: the zero prefix and the split into
    segments of Horner steps, each lane's loads, the unpack (w >> j, no
    mask, as signed bytes) or the raw words (binary), the integer mma in
    the fragment layouts, the state k-step, the low-byte packing into the
    next A fragment, the final operators on each lane's state bits, the
    XOR over lanes and warps, the ladder shift of each segment and
    final_xor on segment 0."""
    n = nbytes // 4
    words = np.ascontiguousarray(rows).view("<u4").reshape(-1, n)
    q = words.shape[0]
    iters, segs, pad = checksum.kernel_split(n, geo)
    tb = checksum.kernel_tables(iters, geo)
    V, Lp, NW = geo.words, geo.loads, geo.warps
    x = np.concatenate([np.zeros((q, pad), np.uint32), words], axis=1)
    x = x.reshape(q, segs, iters, NW, Lp, 32, V)
    st = np.zeros((q, segs, NW, 32, 4), np.uint32)
    for it in range(iters):
        acc = np.zeros((q, segs, NW, 4, 32, 4), np.int64)
        if it:
            _mma(acc, st, tb.shift, geo.b1)
        for p in range(Lp):
            d = x[:, :, it, :, p]
            if geo.b1:
                _mma(acc, d, tb.ops[p], True)
                continue
            for v in range(V // 2):
                lo, hi = d[..., 2 * v], d[..., 2 * v + 1]
                for j in range(4):
                    a = np.stack([lo >> j, hi >> j, lo >> (j + 4),
                                  hi >> (j + 4)], -1)
                    _mma(acc, a, tb.ops[(p * (V // 2) + v) * 4 + j], False)
        c = acc
        st = np.stack([
            _low_bytes(c[..., 0, :, 0], c[..., 0, :, 1], c[..., 1, :, 0],
                       c[..., 1, :, 1]),
            _low_bytes(c[..., 0, :, 2], c[..., 0, :, 3], c[..., 1, :, 2],
                       c[..., 1, :, 3]),
            _low_bytes(c[..., 2, :, 0], c[..., 2, :, 1], c[..., 3, :, 0],
                       c[..., 3, :, 1]),
            _low_bytes(c[..., 2, :, 2], c[..., 2, :, 3], c[..., 3, :, 2],
                       c[..., 3, :, 3])], -1)
    fin = tb.fin.astype(np.uint64)
    v = np.zeros((q, segs, NW, 32), np.uint64)
    for i in range(4):
        for e in range(4):
            col = fin[np.arange(NW)[:, None], (_G + 8 * (i & 1))[None, :],
                      (16 * (i >> 1) + 4 * _T + e)[None, :]]
            bit = (st[..., i] >> (8 * e)) & 1
            v ^= np.where(bit == 1, col, np.uint64(0))
    raw = np.bitwise_xor.reduce(np.bitwise_xor.reduce(v, -1), -1)
    out = np.zeros(q, np.uint64)
    for seg in range(segs):
        r, d, j = raw[:, seg], segs - 1 - seg, 0
        while d:
            if d & 1:
                r = checksum._apply(tb.ladder[j], r)
            d >>= 1
            j += 1
        out ^= r
    final = np.uint64(int(checksum.crc_plan(nbytes).final_xor))
    return (out ^ final).astype(np.uint32)


def _split_lengths(geo=checksum.CRC_GEOMETRY) -> list[int]:
    """One word, and one word either side of a warp's load, a Horner
    step of the block and a whole segment."""
    out = [4]
    for w in (32 * geo.words, geo.step_words, geo.iters * geo.step_words):
        out += [4 * (w - 1), 4 * (w + 1)]
    return out


#: chip_smoke's crc lengths and the lengths about the kernel's split
EMU_LENGTHS = sorted(set(chip_smoke.CRC_LENGTHS) | set(_split_lengths()))


def _emu_rows(nbytes: int) -> np.ndarray:
    """Two chunks a row on two rows: random, then zeros and 0xFF."""
    rows = _rows(nbytes + 1, 2, 2 * nbytes)
    rows[1, :nbytes] = 0
    rows[1, nbytes:] = 255
    return rows


@pytest.mark.parametrize("nbytes", EMU_LENGTHS)
def test_kernel_emulation_equals_reference_crc(nbytes):
    import jax

    rows = _emu_rows(nbytes)
    got = _emulate_crc32c_chunks(rows, nbytes)
    chunks = rows.reshape(-1, nbytes)
    want = [jax_native.crc32c(bytes(c)) for c in chunks]
    assert got.tolist() == want
    graph = np.asarray(jax.jit(jax_checksum.CrcPlan(nbytes).device_fn())(
        chunks.view(np.uint32)))
    assert graph.tolist() == want


@pytest.mark.parametrize("geo", RACE_GEOMETRIES, ids=str)
@pytest.mark.parametrize("nbytes", [4, 4100, 32 * 1024 + 4])
def test_race_settings_emulate_the_reference_crc(geo, nbytes):
    """The settings crc_variants.py races compute the same CRC on their
    own tables and split."""
    rows = _emu_rows(nbytes)
    got = _emulate_crc32c_chunks(rows, nbytes, geo)
    assert got.tolist() == [native.crc32c(c)
                            for c in rows.reshape(-1, nbytes)]


@pytest.mark.parametrize("geo", (checksum.CRC_GEOMETRY,) + RACE_GEOMETRIES,
                         ids=str)
def test_kernel_split_covers_chunks_exactly(geo):
    """Whole segments of Horner steps, a prefix shorter than a segment,
    at most geo.iters steps a segment, one segment for a chunk that fits
    one, and the 128 KiB chunk of the main shape in whole segments of
    geo.iters steps."""
    for n_words in (1, 3, 127, 255, 256, 257, 1023, 1025, 4096, 4097,
                    8191, 8193, 32768, 262_145):
        iters, segs, pad = checksum.kernel_split(n_words, geo)
        seg = iters * geo.step_words
        assert 1 <= iters <= geo.iters
        assert segs * seg - pad == n_words and 0 <= pad < seg
        if n_words <= geo.iters * geo.step_words:
            assert segs == 1
        else:
            assert iters == geo.iters
    iters, segs, pad = checksum.kernel_split(32768, geo)
    assert (iters, pad) == (geo.iters, 0)
    assert segs * geo.iters * geo.step_words == 32768


@pytest.mark.parametrize("geo", (checksum.CRC_GEOMETRY,) + RACE_GEOMETRIES,
                         ids=str)
def test_kernel_tables_are_the_operators(geo):
    """Each table entry against the reference's _zero_operator: a data
    operator's element is entry (output bit, input bit) of M^(4 E) for
    the word it meets, the shift operator is M^(4 step_words) on the
    packed state bits, fin[w, r] is M^(4 (distance to the segment end))
    by the state bits' positions, and ladder rung j is M^(4 segment
    words 2^j)."""
    V, Lp, NW = geo.words, geo.loads, geo.warps
    t = checksum.kernel_tables(2, geo)

    def op(words):
        return jax_checksum._zero_operator(4 * words).astype(np.uint64)

    def entry(m, out_bit, in_bit):
        return int(m[in_bit]) >> out_bit & 1

    def state_bit(kappa):
        r, tt, e = kappa >> 4, (kappa >> 2) & 3, kappa & 3
        return 8 * (2 * r + (e >> 1)) + 2 * tt + (e & 1)

    for nt, r, lane in ((0, 0, 0), (1, 1, 5), (3, 0, 18), (2, 1, 31)):
        g, tt = lane >> 2, lane & 3
        o = 8 * nt + g
        for p in range(Lp):
            if geo.b1:
                m = op(32 * V * (Lp - 1 - p) + 4 * V - 1 - V * tt - 2 * r)
                want = sum(entry(m, o, b) << b for b in range(32))
                assert int(t.ops[p, nt, r, lane]) == want
                continue
            for v in range(V // 2):
                m = op(32 * V * (Lp - 1 - p) + 4 * V - 1 - V * tt - 2 * v)
                for j in (0, 3):
                    want = sum(entry(m, o, j + 4 * r + 8 * e) << 8 * e
                               for e in range(4))
                    s = (p * (V // 2) + v) * 4 + j
                    assert int(t.ops[s, nt, r, lane]) == want
        m = op(geo.step_words)
        want = sum(entry(m, o, state_bit(16 * r + 4 * tt + e)) << 8 * e
                   for e in range(4))
        assert int(t.shift[nt, r, lane]) == want
    for w, row in ((0, 0), (NW - 1, 15), (1, 9)):
        g, h = row & 7, row >> 3
        m = op(32 * V * Lp * (NW - 1 - w) + 28 * V + 1 - 4 * V * g - h)
        for kappa in (0, 7, 21, 31):
            assert int(t.fin[w, row, kappa]) == int(m[state_bit(kappa)])
    seg = 2 * geo.step_words
    assert np.array_equal(t.ladder[0], op(seg).astype(np.uint32))
    assert np.array_equal(t.ladder[2], op(4 * seg).astype(np.uint32))


def test_chunk_csums_digest_every_chunk():
    rows = _rows(3, 5, 3 * 4100)
    got = checksum.chunk_csums(torch.from_numpy(rows), 4100)
    assert got.shape == (5, 3)
    want = [[native.crc32c(r[i * 4100:(i + 1) * 4100]) for i in range(3)]
            for r in rows]
    assert got.numpy().tolist() == want


@pytest.mark.parametrize("nbytes", [0, 1, 2, 3, 5, 6, 7, 509, 4099, 4100])
def test_row_csums_take_any_length(nbytes):
    """row_csums gives the reference binding's CRC32C of rows of any
    length: a zero prefix words the rows, and the affine constant of
    the padded length is swapped for the row's own."""
    rows = _rows(nbytes + 5, 3, nbytes)
    got = checksum.row_csums(torch.from_numpy(rows))
    assert got.dtype == torch.uint32 and got.shape == (3,)
    assert got.numpy().tolist() == [jax_native.crc32c(r) for r in rows]


def test_native_binding_matches_reference_binding():
    data = _rows(4, 1, 10_000)[0]
    assert native.available()
    assert native.crc32c(data) == jax_native.crc32c(data)
    assert native.crc32c(data, 123) == jax_native.crc32c(data, 123)
    assert native.crc32c_blocks(data, 4096) == \
        jax_native.crc32c_blocks(data, 4096)


@pytest.mark.parametrize("kernel", ["xla", "pallas", "bitxor"])
def test_region_out_writes_the_callers_rows(kernel):
    """RegionMatmul(..., out=) fills rows k..k+m of the caller's
    (k + m, L) buffer, whose first k rows are the data, and returns it —
    whether L needs the lane padding (1000) or not — with the bytes of
    the JAX package's RegionMatmul."""
    from ceph_tpu.ops.ec_kernels import RegionMatmul as JaxRegionMatmul
    from ceph_tpu_torch.ops.ec_kernels import RegionMatmul

    M = StripeCodec(k=3, m=2).matrix
    for L in (512, 1000, 4096):
        data = _rows(L, 3, L)
        stack = torch.zeros((5, L), dtype=torch.uint8)
        stack[:3] = torch.from_numpy(data)
        got = RegionMatmul(M, kernel=kernel, device="cpu")(
            stack[:3], out=stack[3:])
        assert got.data_ptr() == stack[3:].data_ptr()
        want = np.asarray(JaxRegionMatmul(M, kernel="xla")(data))
        assert np.array_equal(stack[3:].numpy(), want)
        assert np.array_equal(stack[:3].numpy(), data)
    with pytest.raises(ValueError):
        RegionMatmul(M, kernel=kernel, device="cpu")(
            torch.zeros((3, 512), dtype=torch.uint8),
            out=torch.zeros((2, 256), dtype=torch.uint8))
