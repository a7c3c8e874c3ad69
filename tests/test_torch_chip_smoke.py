"""Rehearsal of chip_smoke.py's main path on the CPU at a small size:
the same phases (the tpu plugin's batched and interface encode/decode,
the ec_benchmark CLI, the corpus check) with device=cpu, where the
wrappers run the plain versions.  On the card the same code must launch
the kernels and never the plain versions; here the counts show the
opposite, which check_main_path must refuse.  Byte checks inside the
phases compare exactly (tolerance 0)."""

import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def test_main_path_rehearsal_on_cpu(capsys):
    counts = chip_smoke.main_path(
        torch.device("cpu"), np.random.default_rng(3), batch=4,
        chunk=2048, cli_size=256 * 1024, iterations=2)
    out = capsys.readouterr().out
    assert "decode_batch erasures {1, 4, 9}: byte-exact" in out
    assert "all configurations byte-exact vs archive" in out
    assert counts["plain"] > 0
    assert counts["gf_bitterm"] == counts["gf_bitxor"] == 0
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.check_main_path(counts)


def test_bounds_count_the_main_matrix():
    """The bound is the function's, one per (matrix, length) for both
    kernels: the 8+3 encode at 8 MiB per row moves 88 MiB, which takes
    longer at 3.35 TB/s than its bit-matrix operations at the int8
    rate; a dense 32x32 matrix is bound by operations.  gf_bitterm's own
    ALU mix for the encode, per 16-byte column group (4 words of each row)
    as the kernel's SASS issues it: the 8 input rows' selectors and masks,
    4 x 9 each, in one block of output rows; fourteen general coefficients
    at 25 (10 PRMT, 15 LOP3); ten coefficients 1 (row 2 and the first
    column) at 4 XORs; 2 flag compares for each of the 24 coefficients.
    The 8x8 decode holds its rows in two blocks of 4, so its selectors are
    computed twice."""
    rng = np.random.default_rng(0)
    mats = chip_smoke.smoke_matrices(rng)
    M = mats["reed_sol_van 3x8"]
    ms, by = chip_smoke.bound(M, 8 << 20)
    assert by == "bytes"
    assert ms == 11 * (8 << 20) / 3.35e12 * 1e3
    wide = rng.integers(1, 256, (32, 32), dtype=np.uint8)
    ms_w, by_w = chip_smoke.bound(wide, 8 << 20)
    assert by_w == "operations"
    assert ms_w > 64 * (8 << 20) / 3.35e12 * 1e3
    assert chip_smoke.bitterm_mix(M) == \
        4 * 9 * 8 + 25 * 14 + 4 * 10 + 2 * 24 == 726
    # 726 ALU instructions per column group over 64 per clock on 132 SMs
    # at 1.98 GHz: under the 0.0275 ms byte bound
    floor = chip_smoke.bitterm_floor_ms(M, 8 << 20, 132, 1.98e9)
    assert floor == (512 << 10) * 726 / (64 * 132 * 1.98e9) * 1e3
    assert 0.022 < floor < ms
    D = mats["decode 8x8 {1,4,9}"]
    general = int(((D != 0) & (D != 1)).sum())
    ones = int((D == 1).sum())
    assert chip_smoke.bitterm_mix(D) == \
        2 * 4 * 9 * 8 + 25 * general + 4 * ones + 2 * 64


def test_oracle_columns_sample_every_pass():
    """Short rows are checked whole; long ones in evenly spread windows
    that reach the row's end, so every grid-stride pass is sampled."""
    assert list(chip_smoke.oracle_columns(508)) == list(range(508))
    L = chip_smoke.CLI_L
    cols = chip_smoke.oracle_columns(L)
    assert cols.max() == L - 1 and cols.min() == 0
    assert np.all(cols < L) and len(np.unique(cols)) == len(cols)
    gaps = np.diff(np.unique(cols))
    assert gaps.max() <= L // 128


def test_race_picks_must_follow_phase_3(monkeypatch):
    """check_race_picks fails a run whose race pinned, at a phase-3
    shape, the kernel phase 3 timed more than 5 % slower; a pick within
    5 %, or a shape the path never raced, passes."""
    from ceph_tpu_torch.ec.matrix_code import MatrixErasureCode

    rng = np.random.default_rng(0)
    M = chip_smoke.smoke_matrices(rng)["reed_sol_van 3x8"]
    sig = MatrixErasureCode._pick_sig(M, chip_smoke.MAIN_L)
    picks = {sig: {"picked": "bitxor"}}
    monkeypatch.setattr(chip_smoke, "kernel_profiler",
                        lambda: types.SimpleNamespace(picks=lambda: picks))
    times = {"pallas": {"reed_sol_van 3x8": 0.043,
                        "decode 8x8 {1,4,9}": 0.067},
             "bitxor": {"reed_sol_van 3x8": 0.057,
                        "decode 8x8 {1,4,9}": 0.083}}
    with pytest.raises(AssertionError, match="pinned bitxor"):
        chip_smoke.check_race_picks(times, rng)
    picks[sig]["picked"] = "pallas"
    chip_smoke.check_race_picks(times, rng)
    times["bitxor"]["reed_sol_van 3x8"] = 0.044
    picks[sig]["picked"] = "bitxor"
    chip_smoke.check_race_picks(times, rng)


def test_crc_bound_counts_the_fused_batch():
    """G1's bound at its main shape, the fused CRC of a 64-stripe k=8,
    m=3 batch: 88 MiB read once and 704 digests written at 3.35 TB/s
    (0.0275 ms), above the CRC as a GF(2) matrix-vector product (32 x 8
    bits a byte, an AND and an XOR each) at the int8 rate."""
    rows, row_bytes, chunk = chip_smoke.CRC_MAIN
    t_bytes, t_ops = chip_smoke.crc_bound_parts(rows, row_bytes, chunk)
    assert t_bytes == (11 * (8 << 20) + 4 * 704) / 3.35e12 * 1e3
    assert t_ops == 2 * 32 * 8 * 11 * (8 << 20) / 1979e12 * 1e3
    assert 0.0275 < t_bytes < 0.0276 and t_ops < t_bytes


#: a small write path for the CPU: 4 writers x 3 encodes of 8 x 4 KiB
SMALL_WRITE = dict(writers=4, per_writer=3, k=8, m=3, chunk=4096,
                   erased=(1, 4, 9), scrub_rows=16,
                   batcher=dict(window_us=500.0, max_bytes=4 * 8 * 4096,
                                adaptive=True, target_ops=4.0,
                                window_min_us=50.0, window_max_us=4000.0))


def test_write_path_rehearsal_on_cpu(capsys):
    """The write phase at a small size with device=cpu: every parity,
    csum, decoded chunk and digest checks out, every encode flush takes
    the fused op and every flush one copy back — but the plain versions
    ran, which check_write_path must refuse."""
    counts, result = chip_smoke.write_path(
        torch.device("cpu"), np.random.default_rng(4), **SMALL_WRITE)
    out = capsys.readouterr().out
    assert "csums to native crc32c" in out and "singled out" in out
    assert result["sweeps"] == 0
    assert result["csum_launches"] >= result["encode"]["launches"] > 0
    assert result["d2h_encode"] == result["encode"]["launches"]
    assert result["d2h_decode"] == result["decode"]["launches"]
    mixed = result["mixed"]
    assert mixed["launches"] == chip_smoke.MIXED_ROUNDS
    assert mixed["lengths"] == 4 and mixed["csum_launches"] == 0
    assert mixed["d2h"] == mixed["launches"]
    assert counts["plain"] > 0 and counts["crc32c_chunks"] == 0
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.check_write_path(counts, result)


@pytest.mark.parametrize("chunk", [4096, 128 << 10])
def test_mixed_lengths_share_a_bucket(chunk):
    """The mixed writes' four lengths fall in the chunk's bucket, so
    each round is one flush, and two of them are not whole words, which
    the fused op cannot take."""
    from ceph_tpu_torch.ec.batcher import bucket_len

    lengths = chip_smoke.mixed_lengths(chunk, 8)
    assert len(set(lengths)) == 4 and lengths[0] == chunk
    assert {bucket_len(L) for L in lengths} == {bucket_len(chunk)}
    assert sorted(L % 4 for L in set(lengths)) == [0, 0, 1, 2]


def test_counted_sweeps_sees_a_host_sweep():
    """counted_sweeps, which the write phase wraps its writes in, sees
    the numpy backend's host CRC sweep, and puts the sweep back after."""
    from ceph_tpu_torch import ec
    from ceph_tpu_torch.ec import batcher as ec_batcher

    codec = ec.factory("tpu", {"k": "4", "m": "2", "backend": "numpy"})
    data = np.random.default_rng(5).integers(0, 256, (4, 1024),
                                             dtype=np.uint8)
    sweep = ec_batcher._host_csums
    sweeps = []
    with chip_smoke.counted_sweeps(sweeps):
        ec_batcher.ECBatcher(window_us=50).encode(codec, data,
                                                  with_csums=True)
    assert sweeps == [6] and ec_batcher._host_csums is sweep


def _passing_write():
    counts = {"gf_bitterm": 40, "gf_bitxor": 8, "gf_sched_xor": 0,
              "crc32c_chunks": 30, "plain": 0}
    result = {"encode": {"launches": 30}, "decode": {"launches": 25},
              "sweeps": 0, "d2h_encode": 30, "d2h_decode": 25,
              "csum_launches": 30,
              "mixed": {"launches": 2, "lengths": 4, "g1": 8,
                        "csum_launches": 0, "d2h": 2},
              "streams": {"threads": 8, "streams": 8, "shared": 0}}
    return counts, result


@pytest.mark.parametrize("fault", ["no region kernel", "plain ran",
                                   "host sweep", "unfused flush",
                                   "two copies", "decode copies",
                                   "mixed flush fused", "mixed G1 short",
                                   "mixed copies", "no mixed flush",
                                   "one stream", "threads share a stream"])
def test_write_path_check_refuses_each_fault(fault):
    counts, result = _passing_write()
    chip_smoke.check_write_path(counts, result)
    if fault == "no region kernel":
        counts["gf_bitterm"] = counts["gf_bitxor"] = 0
    elif fault == "plain ran":
        counts["plain"] = 1
    elif fault == "host sweep":
        result["sweeps"] = 2
    elif fault == "unfused flush":
        result["csum_launches"] = 29
    elif fault == "two copies":
        result["d2h_encode"] = 60
    elif fault == "decode copies":
        result["d2h_decode"] = 24
    elif fault == "mixed flush fused":
        result["mixed"]["csum_launches"] = 1
    elif fault == "mixed G1 short":
        result["mixed"]["g1"] = 2
    elif fault == "mixed copies":
        result["mixed"]["d2h"] = 3
    elif fault == "one stream":
        result["streams"].update(streams=1, shared=28)
    elif fault == "threads share a stream":
        result["streams"].update(streams=7, shared=1)
    else:
        result["mixed"].update(launches=0, g1=0, d2h=0)
    with pytest.raises(AssertionError):
        chip_smoke.check_write_path(counts, result)


#: a small wide path for the CPU: 4 threads x 2 stripes of 8 x 8 KiB, a
#: 64 KiB SHEC object, 8 CLAY objects
SMALL_WIDE = dict(threads=4, per_thread=2, chunk=8192,
                  shec=dict(k=8, m=4, c=3), shec_object=64 << 10,
                  shec_prefix=4096, clay=dict(k=8, m=4, d=11),
                  clay_objects=8, clay_erased=(0, 3, 8, 11),
                  batcher=chip_smoke.WRITE["batcher"])


def test_wide_path_rehearsal_on_cpu(capsys):
    """Phases 12-14 at a small size with device=cpu: every SHEC erasure
    set of 1-3 chunks decodes or is refused as the numpy codec does,
    every parity, csum, read and repair checks out, SHEC's one-lost
    folds read its window, the four wide corpus directories match; but
    the plain versions ran, which check_wide_path must refuse."""
    counts, result = chip_smoke.wide_path(
        torch.device("cpu"), np.random.default_rng(6), **SMALL_WIDE)
    out = capsys.readouterr().out
    assert "12/12, 64/66, 200/220 decode" in out
    assert "repair_chunk" in out and "(4 directories)" in out
    assert "[wide] walls:" in out
    shec = result["shec"]
    assert shec["narrow_rows"] and set(shec["narrow_rows"]) == {6}
    folds = result["folds"]
    assert shec["fused"] == folds["shec encode"][0] > 0
    assert folds["clay subchunk encode"][1] == 8
    assert folds["clay repair"][1] == 8 * 12
    assert folds["clay subchunk decode"][1] == 8
    assert counts["plain"] > 0
    assert counts["gf_bitterm"] == counts["gf_bitxor"] == 0
    with pytest.raises(AssertionError, match="no region kernel"):
        chip_smoke.check_wide_path(counts, result)


def test_corpus_grids_split_the_fifteen_directories():
    """Phase 7 checks the 11 matrix and bit-matrix directories, phase 14
    the four wide-code ones."""
    plain, wide = chip_smoke.corpus_grid(False), chip_smoke.corpus_grid(True)
    assert len(plain) == 11 and len(wide) == 4
    assert {p for p, _ in wide} == {"lrc", "shec", "clay"}


def _passing_wide():
    counts = {"gf_bitterm": 900, "gf_bitxor": 700, "gf_sched_xor": 0,
              "crc32c_chunks": 32, "plain": 0}
    result = {"shec": {"fused": 30, "k": 8, "narrow_rows": [6, 6, 6]},
              "folds": {"shec encode": [30, 64, 4],
                        "shec decode": [35, 128, 8],
                        "clay subchunk encode": [32, 64, 3],
                        "clay repair": [90, 192, 5],
                        "clay subchunk decode": [2, 16, 8]}}
    return counts, result


@pytest.mark.parametrize("fault", ["plain ran", "no region kernel",
                                   "skipped pick", "not narrow",
                                   "no narrow fold", "no G1",
                                   "unfused flush", "sub-chunk alone",
                                   "repair alone"])
def test_wide_path_check_refuses_each_fault(fault, monkeypatch):
    picks = {"pick/8x8/m00000000/L131072": {"picked": "pallas",
                                             "skipped": []}}
    monkeypatch.setattr(chip_smoke, "kernel_profiler",
                        lambda: types.SimpleNamespace(picks=lambda: picks))
    counts, result = _passing_wide()
    chip_smoke.check_wide_path(counts, result)
    counts["gf_bitxor"] = 0  # one region kernel alone passes too
    chip_smoke.check_wide_path(counts, result)
    if fault == "plain ran":
        counts["plain"] = 1
    elif fault == "no region kernel":
        counts["gf_bitterm"] = 0
    elif fault == "skipped pick":
        picks["pick/8x8/m00000000/L131072"]["skipped"] = ["bitxor"]
    elif fault == "not narrow":
        result["shec"]["narrow_rows"] = [6, 8]
    elif fault == "no narrow fold":
        result["shec"]["narrow_rows"] = []
    elif fault == "no G1":
        counts["crc32c_chunks"] = 0
    elif fault == "unfused flush":
        result["shec"]["fused"] = 29
    elif fault == "sub-chunk alone":
        result["folds"]["clay subchunk encode"][2] = 1
        result["folds"]["clay subchunk decode"][2] = 1
    else:
        result["folds"]["clay repair"][2] = 1
    with pytest.raises(AssertionError):
        chip_smoke.check_wide_path(counts, result)


def test_recorded_flushes_sees_each_fold_kind_and_lets_go():
    """recorded_flushes, which the wide phases wrap their batchers in,
    records every flush with its kind and ops, and puts the batcher's
    own flush methods back after."""
    from ceph_tpu_torch import ec
    from ceph_tpu_torch.ec.batcher import ECBatcher

    codec = ec.factory("clay", {"k": "4", "m": "2", "d": "5",
                                "device": "cpu"})
    b = ECBatcher(window_us=50)
    L = codec.alpha * 4
    data = np.random.default_rng(8).integers(0, 256, (4, L), dtype=np.uint8)
    flushes = []
    with chip_smoke.recorded_flushes(b, flushes):
        parity, _ = b.encode(codec, data)
        full = np.concatenate([data, parity])
        b.decode(codec, [0], {s: full[s] for s in range(1, 6)})
        planes = codec.repair_planes(1)
        b.repair(codec, 1, {h: full[h].reshape(codec.alpha, -1)[planes]
                            for h in (0, 2, 3, 4, 5)}, L)
    assert [(f[0], f[2]) for f in flushes] == [
        ("subchunk encode", 1), ("subchunk decode", 1), ("repair", 1)]
    assert chip_smoke.fold_summary(flushes)["repair"] == [1, 1, 1]
    assert "_flush_repair" not in vars(b)
