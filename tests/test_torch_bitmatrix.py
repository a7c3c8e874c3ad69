"""The port's GF(2) bit-matrix layer on the CPU against the JAX package's.

- The constructions (gfw_mul, element_bitmatrix, blaum_roth, liberation,
  raid6 / liber8tion), _gf2_invert and _decode_combo equal the JAX
  package's.
- The port's ScheduledXor runs its kernel's plain version on a CPU tensor
  (kernel gf_sched_xor on the card).  It is held against the JAX
  ScheduledXor as its own tests run it (the plain graph, and the Pallas
  body in interpret mode) and against xor_schedule.naive_apply.
- The host half of the CUDA kernel, the plan of sched_xor_plan, is run
  here by an emulator that follows the kernel's loop and its addressing,
  in plane-row mode and in packet mode (the codec's (n, L) chunks, read
  and written where their packet rows lie).

Everything is integer: tolerance 0 (byte-exact).
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec import bitmatrix_code as ref_bm
from ceph_tpu.ops import ec_kernels as ref_k
from ceph_tpu.ops import xor_schedule as ref_xs
from ceph_tpu_torch.ec import bitmatrix_code as bm
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ops import ec_kernels as K
from ceph_tpu_torch.ops.xor_schedule import naive_apply

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

RNG = np.random.default_rng(2718)
CPU = torch.device("cpu")
LENGTHS = [4, 64, 508, 512, 32 * 1024 + 4]

#: every (technique, w) the jerasure plugin allows, with each k <= w;
#: liber8tion allows k up to 255, and its MDS assertion inverts C(k+2, 2)
#: matrices of side 8k, so it is checked for k <= 8 and at k = 32 (below)
ALLOWED = ([("liberation", w, k) for w in (5, 7) for k in range(1, w + 1)]
           + [("blaum_roth", w, k) for w in (4, 6)
              for k in range(1, w + 1)]
           + [("liber8tion", 8, k) for k in range(1, 9)])


def _build(mod, technique, k, w):
    if technique == "liberation":
        return mod.liberation_bitmatrix(k, w)
    if technique == "blaum_roth":
        return mod.blaum_roth_bitmatrix(k, w)
    return mod.raid6_bitmatrix(k, w)


@pytest.mark.parametrize("technique,w,k", ALLOWED)
def test_constructions_equal_reference(technique, w, k):
    B = _build(bm, technique, k, w)
    assert B.dtype == np.uint8 and B.shape == (2 * w, k * w)
    assert np.array_equal(B, _build(ref_bm, technique, k, w))


def test_widest_liber8tion_equals_reference():
    assert np.array_equal(bm.raid6_bitmatrix(32, 8), _widest())


def test_field_helpers_equal_reference():
    for w in (4, 5, 6, 7, 8):
        for e in range(1 << w):
            assert np.array_equal(bm.element_bitmatrix(e, w),
                                  ref_bm.element_bitmatrix(e, w))
            for b in (0, 1, 2, (1 << w) - 1):
                assert bm.gfw_mul(e, b, w) == ref_bm.gfw_mul(e, b, w)


def test_constructions_refuse_what_the_reference_refuses():
    for fn, k, w in ((bm.liberation_bitmatrix, 3, 6),
                     (bm.liberation_bitmatrix, 8, 7),
                     (bm.blaum_roth_bitmatrix, 3, 5),
                     (bm.blaum_roth_bitmatrix, 7, 6),
                     (bm.raid6_bitmatrix, 16, 4)):
        with pytest.raises(ErasureCodeError):
            fn(k, w)


def test_gf2_invert_equals_reference():
    n = 0
    while n < 20:
        size = int(RNG.integers(1, 40))
        M = RNG.integers(0, 2, (size, size), dtype=np.uint8)
        try:
            want = ref_bm._gf2_invert(M)
        except Exception:  # noqa: BLE001 - a singular draw
            with pytest.raises(ErasureCodeError):
                bm._gf2_invert(M)
            continue
        got = bm._gf2_invert(M)
        assert np.array_equal(got, want)
        assert np.array_equal((M.astype(int) @ got) % 2, np.eye(size))
        n += 1


@pytest.mark.parametrize("technique,k", [("liberation", 5),
                                         ("blaum_roth", 4),
                                         ("liber8tion", 6)])
def test_decode_combos_equal_reference(technique, k):
    """_decode_combo for every wanted set of 1 or 2 shards against
    every survivor set the decoder picks."""
    from ceph_tpu import ec as ref_ec
    from ceph_tpu_torch import ec

    prof = {"technique": technique, "k": str(k), "m": "2",
            "backend": "numpy"}
    ref = ref_ec.factory("jerasure", prof)
    port = ec.factory("jerasure", prof)
    n = k + 2
    for r in (1, 2):
        for want in itertools.combinations(range(n), r):
            avail = tuple(i for i in range(n) if i not in want)[:k]
            assert np.array_equal(port._decode_combo(want, avail),
                                  ref._decode_combo(want, avail))


def _zero_rows(R, C, seed):
    rng = np.random.default_rng(seed)
    B = rng.integers(0, 2, (R, C), dtype=np.uint8)
    B[rng.integers(0, R)] = 0
    return B


@functools.cache
def _widest():
    """The JAX package's liber8tion k=32 drive, (16, 256): built once,
    on first use, because its MDS check takes seconds."""
    return ref_bm.raid6_bitmatrix(32, 8)


@functools.cache
def _table_matrices():
    from ceph_tpu import ec as ref_ec

    def codec(t, k):
        return ref_ec.factory("jerasure", {"technique": t, "k": str(k),
                                           "m": "2", "backend": "numpy"})

    lib, br, l8 = codec("liberation", 5), codec("blaum_roth", 4), \
        codec("liber8tion", 6)
    return {
        "liberation 14x35": lib.bitmatrix,
        "liberation decode {0,1}": lib._decode_combo((0, 1),
                                                     (2, 3, 4, 5, 6)),
        "blaum_roth 12x24": br.bitmatrix,
        "liber8tion 16x48": l8.bitmatrix,
        "liber8tion decode {0,6}": l8._decode_combo((0, 6),
                                                    (1, 2, 3, 4, 5, 7)),
        "liber8tion k=32 16x256": _widest(),
        "random 24x64 zero row": _zero_rows(24, 64, 1),
        "random 5x9 zero row": _zero_rows(5, 9, 2),
        "1x1": np.ones((1, 1), dtype=np.uint8),
    }


NAMES = ["liberation 14x35", "liberation decode {0,1}", "blaum_roth 12x24",
         "liber8tion 16x48", "liber8tion decode {0,6}",
         "liber8tion k=32 16x256", "random 24x64 zero row",
         "random 5x9 zero row", "1x1"]


def _mat(name):
    return _table_matrices()[name]


def _same_schedule(a, b):
    return (a.n_in, a.ops, a.outputs, a.used_inputs) == \
        (b.n_in, b.ops, b.outputs, b.used_inputs)


@pytest.mark.parametrize("name", NAMES)
def test_plain_scheduled_xor_equals_jax_plain_and_oracle(name):
    """The port's ScheduledXor on the CPU == the JAX ScheduledXor's
    plain graph == naive_apply, at every length (exact)."""
    B = _mat(name)
    ref = ref_k.ScheduledXor(B)
    op = K.ScheduledXor(B, device=CPU)
    assert _same_schedule(op.sched, ref.sched)
    assert (op.R, op.C) == (ref.R, ref.C)
    for L in LENGTHS:
        rows = RNG.integers(0, 256, (B.shape[1], L), dtype=np.uint8)
        got = op(rows)
        assert got.device == CPU and got.dtype == torch.uint8
        want = np.asarray(ref(rows))
        assert np.array_equal(got.numpy(), want), (name, L)
        assert np.array_equal(want, naive_apply(B, rows)), (name, L)
        assert np.array_equal(op(torch.from_numpy(rows)).numpy(), want)


@pytest.mark.parametrize("name", ["liberation decode {0,1}",
                                  "liber8tion k=32 16x256",
                                  "random 24x64 zero row", "1x1"])
def test_plain_scheduled_xor_equals_jax_interpret(name):
    """... and == the JAX Pallas body in interpret mode (exact)."""
    B = _mat(name)
    ref = ref_k.ScheduledXor(B, interpret=True)
    assert ref._use_pallas
    op = K.ScheduledXor(B, device=CPU)
    for L in (4, 508, 32 * 1024 + 4):
        rows = RNG.integers(0, 256, (B.shape[1], L), dtype=np.uint8)
        assert np.array_equal(op(rows).numpy(), np.asarray(ref(rows))), L


def test_plain_graph_equals_jax_plain():
    """gf_sched_xor_graph, K3's plain version on any device (the one
    chip_smoke.py holds the kernel to), == the JAX ScheduledXor (exact)."""
    for name in ("liberation decode {0,1}", "random 24x64 zero row"):
        B = _mat(name)
        rows = RNG.integers(0, 256, (B.shape[1], 1024), dtype=np.uint8)
        got = K.gf_sched_xor_graph(B)(torch.from_numpy(rows))
        assert np.array_equal(got.numpy(),
                              np.asarray(ref_k.ScheduledXor(B)(rows)))
    with pytest.raises(ValueError):
        K.gf_sched_xor_graph(_mat("1x1"))(
            torch.zeros((2, 4), dtype=torch.uint8))


def test_quantum_padding_matches_reference():
    B = _mat("liberation 14x35")
    op = K.ScheduledXor(B, device=CPU)
    ref = ref_k.ScheduledXor(B)
    assert op.BLOCK == ref.BLOCK == 8192
    for L in (1, 4, 511, 512, 513, 32768, 32769, 65536, 65537,
              2_396_800):
        assert op._quantum(L) == ref._quantum(L), L
    assert tuple(op(np.zeros((35, 0), np.uint8)).shape) == (14, 0)


def test_scheduled_xor_masks_to_one_bit_and_checks_rows():
    B = _mat("random 5x9 zero row") * 3  # entries 0 and 3: & 1 keeps bit 0
    op = K.ScheduledXor(B, device=CPU)
    assert set(np.unique(op.B)) <= {0, 1}
    rows = RNG.integers(0, 256, (9, 64), dtype=np.uint8)
    assert np.array_equal(op(rows).numpy(), naive_apply(B & 1, rows))
    with pytest.raises(ValueError):
        op(np.zeros((8, 64), np.uint8))


def test_scheduled_xor_refuses_a_tensor_off_its_device():
    """A CPU op takes host input only: a tensor on another device raises
    instead of being copied to the host and run through the plain
    version."""
    op = K.ScheduledXor(_mat("liberation 14x35"), device="cpu")
    before = K.launch_counts()["plain"]
    with pytest.raises(ValueError, match="meta"):
        op(torch.empty((35, 512), dtype=torch.uint8, device="meta"))
    assert K.launch_counts()["plain"] == before


def test_cuda_scheduled_xor_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        K.ScheduledXor(_mat("1x1"), device="cuda")


def test_wrapper_counts_plain_runs_on_cpu():
    B = _mat("blaum_roth 12x24")
    x32 = torch.from_numpy(
        RNG.integers(0, 256, (24, 512), dtype=np.uint8).view(np.int32))
    before = K.launch_counts()
    y = K.gf_sched_xor_lanes(x32, K.ScheduledXor(B, device=CPU).sched)
    after = K.launch_counts()
    assert after["plain"] == before["plain"] + 1
    assert after["gf_sched_xor"] == before["gf_sched_xor"]
    assert np.array_equal(y.numpy().view(np.uint8),
                          naive_apply(B, x32.numpy().view(np.uint8)))


# -- the host half of the CUDA kernel, run by an emulator ----------------

def _emulate_sched_xor(plan, x32):
    """gf_sched_xor's loop and addressing on (C / w, n4) uint32 lanes: a
    row is n4 / 4 uint4 lanes and n4 / 4w column groups, and column group
    g starts at lane (g // 4) * 4w + g % 4.  Per block of SCHED_ROW_BLOCK
    output rows: zeroed accumulators, each (chunk, packet, mask) entry's
    input XORed into the rows of its mask, then output row R stored in
    chunk R // w at packet R % w."""
    w = plan.w
    x = np.asarray(x32).astype(np.uint32)
    x = x.reshape(x.shape[0], -1, 4)
    lanes = x.shape[1]
    g = np.arange(lanes // w)
    lane = (g // 4) * 4 * w + g % 4
    y = np.full((plan.rows // w, lanes, 4), 0xDEADBEEF, dtype=np.uint32)
    for b in range(len(plan.ptr) - 1):
        acc = np.zeros((K.SCHED_ROW_BLOCK, len(g), 4), dtype=np.uint32)
        for j, p, mask, _ in plan.entries[plan.ptr[b]:plan.ptr[b + 1]]:
            v = x[j, 4 * p + lane]
            for i in range(K.SCHED_ROW_BLOCK):
                if (int(mask) >> i) & 1:
                    acc[i] ^= v
        for i in range(K.SCHED_ROW_BLOCK):
            R = b * K.SCHED_ROW_BLOCK + i
            if R < plan.rows:
                y[R // w, 4 * (R % w) + lane] = acc[i]
    return y.reshape(plan.rows // w, -1)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_plan_computes_the_product(name):
    """The plan, run the way the kernel runs it, equals naive_apply
    (exact); its masks cover B's ones exactly once."""
    B = _mat(name)
    plan = K.sched_xor_plan(B)
    assert plan.ptr.dtype == plan.entries.dtype == np.int32
    assert len(plan.ptr) == -(-B.shape[0] // K.SCHED_ROW_BLOCK) + 1
    assert plan.w == 1 and not plan.entries[:, 1].any()
    assert sum(bin(int(m)).count("1") for m in plan.entries[:, 2]) \
        == int(B.sum())
    rows = RNG.integers(0, 256, (B.shape[1], 256), dtype=np.uint8)
    got = _emulate_sched_xor(plan, rows.view(np.uint32))
    assert np.array_equal(got.view(np.uint8), naive_apply(B, rows))


def test_plan_of_an_empty_matrix_and_of_many_blocks():
    """All-zero rows make no entries (the kernel stores zeros); 40 rows
    make three blocks."""
    plan = K.sched_xor_plan(np.zeros((3, 7), np.uint8))
    assert plan.entries.shape == (0, 4) and list(plan.ptr) == [0, 0]
    rows = RNG.integers(0, 256, (7, 64), dtype=np.uint8)
    assert not _emulate_sched_xor(plan, rows.view(np.uint32)).any()
    B = _zero_rows(40, 33, 9)
    plan = K.sched_xor_plan(B)
    assert len(plan.ptr) == 4
    rows = RNG.integers(0, 256, (33, 128), dtype=np.uint8)
    assert np.array_equal(
        _emulate_sched_xor(plan, rows.view(np.uint32)).view(np.uint8),
        naive_apply(B, rows))


#: one bit-matrix code for each packet count w, (technique, k)
PACKET_CODES = {6: ("blaum_roth", 4), 7: ("liberation", 5),
                8: ("liber8tion", 6)}


def _packet_matrices(w):
    """The encode drive and the densest {0,1} decode combo of the code
    with w packets a granule (JAX package's codec)."""
    from ceph_tpu import ec as ref_ec

    technique, k = PACKET_CODES[w]
    ref = ref_ec.factory("jerasure", {"technique": technique, "k": str(k),
                                      "m": "2", "backend": "numpy"})
    assert ref.w == w
    return ref, (ref.bitmatrix,
                 ref._decode_combo((0, 1), tuple(range(2, k + 2))))


def _to_planes(chunks, w):
    """(n, G * w * 64) chunks -> (n * w, G * 64) plane rows: the permute
    the codec ran on the card before the kernel took the layout over."""
    n, L = chunks.shape
    g = L // (w * 64)
    return chunks.reshape(n, g, w, 64).transpose(0, 2, 1, 3) \
        .reshape(n * w, g * 64)


@pytest.mark.parametrize("granules", [1, 3, 37])
@pytest.mark.parametrize("w", [6, 7, 8])
def test_packet_mode_addressing_equals_permuted_plane_rows(w, granules):
    """The packet-mode plan, run with the kernel's addressing on the
    chunks as they are, equals the plane-row product of the permuted
    chunks, permuted back (exact)."""
    _ref, mats = _packet_matrices(w)
    for B in mats:
        plan = K.sched_xor_plan(B, w)
        assert plan.w == w
        assert np.array_equal(plan.entries[:, 0] * w + plan.entries[:, 1],
                              K.sched_xor_plan(B).entries[:, 0])
        n = B.shape[1] // w
        chunks = RNG.integers(0, 256, (n, granules * w * 64), dtype=np.uint8)
        got = _emulate_sched_xor(plan, chunks.view(np.uint32))
        want = naive_apply(B, _to_planes(chunks, w))
        g = granules
        want = want.reshape(-1, w, g, 64).transpose(0, 2, 1, 3) \
            .reshape(B.shape[0] // w, -1)
        assert np.array_equal(got.view(np.uint8), want)


@pytest.mark.parametrize("w", [6, 7, 8])
def test_packet_mode_op_equals_the_codecs(w):
    """ScheduledXor in packet mode on the CPU (the plain version:
    permute, schedule, permute back), its plain graph, and the port's
    torch-backend codec equal the JAX package's numpy codec (exact)."""
    from ceph_tpu_torch import ec

    ref, mats = _packet_matrices(w)
    technique, k = PACKET_CODES[w]
    for B in mats:
        op = K.ScheduledXor(B, device=CPU, w=w)
        assert (op.r, op.c) == (B.shape[0] // w, B.shape[1] // w)
        for granules in (1, 37):
            chunks = RNG.integers(0, 256, (op.c, granules * w * 64),
                                  dtype=np.uint8)
            want = ref._unrows(ref._apply_bits(B, ref._rows(chunks)),
                               op.r)
            assert np.array_equal(op(chunks).numpy(), want)
            got = K.gf_sched_xor_graph(B, w)(torch.from_numpy(chunks))
            assert np.array_equal(got.numpy(), want)
    port = ec.factory("jerasure", {"technique": technique, "k": str(k),
                                   "m": "2", "backend": "torch",
                                   "device": "cpu"})
    port.DEVICE_APPLY_MIN_BYTES = 0
    data = RNG.integers(0, 256, (k, 5 * w * 64), dtype=np.uint8)
    assert np.array_equal(port.encode_chunks(data), ref.encode_chunks(data))
    assert port.host_applies == 0


def test_packet_mode_refuses_ragged_input():
    """Packet mode takes whole granules and matrices of whole chunks."""
    B = _packet_matrices(7)[1][0]
    op = K.ScheduledXor(B, device=CPU, w=7)
    with pytest.raises(ValueError, match="granules"):
        op(np.zeros((5, 7 * 64 + 64), np.uint8))
    with pytest.raises(ValueError):
        op(np.zeros((35, 7 * 64), np.uint8))
    assert tuple(op(np.zeros((5, 0), np.uint8)).shape) == (2, 0)
    with pytest.raises(ValueError, match="whole chunks"):
        K.ScheduledXor(B[:13], device=CPU, w=7)
    with pytest.raises(ValueError, match="whole chunks"):
        K.sched_xor_plan(B[:, :34], 7)


def test_schedule_equals_reference_schedule():
    """The CSE'd schedule the plain version runs is the JAX package's."""
    for B in _table_matrices().values():
        assert _same_schedule(K.ScheduledXor(B, device=CPU).sched,
                              ref_xs.build_schedule(B & 1))
