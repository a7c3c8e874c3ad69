"""CRC32C of the port (ceph_tpu_torch/ops/checksum.py) against the JAX
package on the same seeded inputs: the plain version of CrcPlan.device_fn
against the jitted JAX graph and the native library, the host operator
algebra, the fused encode+CRC graph, and a numpy replay of the CUDA
kernel's host half (its tables and its segment and thread split).  Every
comparison is exact (tolerance 0): CRC32C is integer math."""

import numpy as np
import pytest
import torch

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
#: the crc phase's chunk lengths up to 64 KiB + 4, and a two-segment one
EMU_LENGTHS = (4, 12, 508, 4096, 4100, 32 * 1024 + 4, 64 * 1024 + 4)


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

def _emulate_crc32c_chunks(rows: np.ndarray, nbytes: int) -> np.ndarray:
    """crc32c_chunks as csrc/crc32c.cu walks it, on the tables the
    wrapper uploads: the zero prefix, segments of T * K words, thread t
    on words t + T u with s <- M^(4T) s ^ w by byte lookups, the
    thread operators, the XOR over the block, the ladder shift of each
    segment and final_xor on segment 0."""
    n_words = nbytes // 4
    words = np.ascontiguousarray(rows).view("<u4").reshape(
        -1, n_words).astype(np.uint64)
    q = words.shape[0]
    T = checksum.CRC_THREADS
    k, segs, pad = checksum.kernel_split(n_words)
    tables = checksum.kernel_tables(k)
    padded = np.concatenate([np.zeros((q, pad), np.uint64), words], axis=1)
    w = padded.reshape(q, segs, k, T)
    tabs = tables.tabs.astype(np.uint64)
    s = np.zeros((q, segs, T), np.uint64)
    for u in range(k):
        a = np.zeros_like(s)
        for n in range(4):
            a ^= tabs[n][(s >> np.uint64(8 * n)) & np.uint64(255)]
        s = a ^ w[:, :, u, :]
    lane = tables.lane_ops.astype(np.uint64)
    v = np.zeros_like(s)
    for j in range(32):
        v ^= np.where((s >> np.uint64(j)) & np.uint64(1), lane[j],
                      np.uint64(0))
    raw = np.bitwise_xor.reduce(v, axis=2)
    out = np.zeros(q, np.uint64)
    for seg in range(segs):
        r, d, j = raw[:, seg], segs - 1 - seg, 0
        while d:
            if d & 1:
                r = checksum._apply(tables.ladder[j], r)
            d >>= 1
            j += 1
        out ^= r
    final = np.uint64(int(checksum.crc_plan(nbytes).final_xor))
    return (out ^ final).astype(np.uint32)


@pytest.mark.parametrize("nbytes", EMU_LENGTHS)
def test_kernel_emulation_equals_reference_crc(nbytes):
    rows = _rows(nbytes + 1, 3, 2 * nbytes)
    rows[1] = 0
    rows[2] = 255
    got = _emulate_crc32c_chunks(rows, nbytes)
    want = [jax_native.crc32c(bytes(r[i * nbytes:(i + 1) * nbytes]))
            for r in rows for i in range(2)]
    assert got.tolist() == want
    if nbytes <= 4100:  # the pure-Python reference is slow
        assert got[0] == jax_checksum.crc32c_ref(bytes(rows[0, :nbytes]))


def test_kernel_split_covers_chunks_exactly():
    """Whole segments, a prefix shorter than a segment, K a power of two
    up to CRC_MAX_RUN, and one segment for a chunk that fits one."""
    T = checksum.CRC_THREADS
    for n_words in (1, 3, 127, 255, 256, 257, 1025, 4096, 4097, 32768,
                    262_145):
        k, segs, pad = checksum.kernel_split(n_words)
        assert k & (k - 1) == 0 and 1 <= k <= checksum.CRC_MAX_RUN
        assert segs * T * k - pad == n_words and 0 <= pad < T * k
        if n_words <= T * checksum.CRC_MAX_RUN:
            assert segs == 1
    assert checksum.kernel_split(32768) == (32, 4, 0)  # a 128 KiB chunk


def test_kernel_tables_are_the_operators():
    """tabs is M^(4T) by bytes, lane_ops[:, t] is M^(4 (T - t)), the
    ladder rung j is M^(4 T K 2^j) — each checked against the
    reference's _zero_operator."""
    T = checksum.CRC_THREADS
    t = checksum.kernel_tables(16)
    full = jax_checksum._zero_operator(4 * T)
    for n in range(4):
        for x in (1, 5, 255):
            assert int(t.tabs[n, x]) == int(checksum._apply(full, x << 8 * n))
    for tt in (0, 1, 100, T - 1):
        assert np.array_equal(t.lane_ops[:, tt],
                              jax_checksum._zero_operator(4 * (T - tt))
                              .astype(np.uint32))
    assert np.array_equal(t.ladder[0],
                          jax_checksum._zero_operator(4 * T * 16)
                          .astype(np.uint32))
    assert np.array_equal(t.ladder[2],
                          jax_checksum._zero_operator(4 * T * 16 * 4)
                          .astype(np.uint32))


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
