"""Rehearsal of chip_smoke.py's main path on the CPU at a small size:
the same phases (the tpu plugin's batched and interface encode/decode,
the ec_benchmark CLI, the corpus check) with device=cpu, where the
wrappers run the plain versions.  On the card the same code must launch
the kernels and never the plain versions; here the counts show the
opposite, which check_main_path must refuse.  Byte checks inside the
phases compare exactly (tolerance 0)."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from ceph_tpu_torch.ops import ec_kernels  # noqa: E402

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


def test_g4_row_has_its_source_and_the_functions_bound():
    """G4 (mxu, gf_bitmm) is a region kernel of phase 3 with its own
    source, and its bound is the function's: at the 3x8 encode on
    (8, 8 MiB) the same 88 MiB as K1's, 0.0275 ms at 3.35 TB/s."""
    name, ctr, plain_of, site = chip_smoke.KERNELS["mxu"]
    assert (name, ctr, site) == ("gf_bitmm", "gf_bitmm",
                                 "ceph_tpu/ops/ec_kernels.py:348")
    assert plain_of is ec_kernels.gf_matmul_mxu_graph
    assert chip_smoke.KERNEL_SOURCES["mxu"] == \
        "ceph_tpu_torch/csrc/gf_bitmm.cu"
    assert os.path.exists(os.path.join(chip_smoke.REPO,
                                       chip_smoke.KERNEL_SOURCES["mxu"]))
    M = chip_smoke.smoke_matrices(np.random.default_rng(0))[
        chip_smoke.TIMED_SHAPES[0]]
    ms, by = chip_smoke.bound(M, chip_smoke.MAIN_L)
    assert by == "bytes" and 0.0275 < ms < 0.02755
    # every smoke matrix has 32 columns or fewer: phase 3 runs G4 on all
    assert all(m.shape[1] <= 32 for m in
               chip_smoke.smoke_matrices(np.random.default_rng(0)).values())


def test_bitmm_floor_counts_the_kernels_sass_mix():
    """G4's own instruction floor: per 256-column tile, the group loop's
    ALU, FMA-pipe and total counts once per group of 4 output rows and
    the tile's own once; a tile takes the larger of the busier pipe's
    count at 2 warp-instructions a clock per SM (64 lane-instructions)
    and the total at the 4 schedulers' 4 a clock.  The 3x8 encode is one
    group, the 8x8 decode two; at both the dispatch limit binds, both
    floors sit under the byte bounds, and counts of one k-step do not
    stand for c > 8."""
    mats = chip_smoke.smoke_matrices(np.random.default_rng(0))
    M = mats["reed_sol_van 3x8"]
    assert chip_smoke.bitmm_mix(M) == (215, 215, 556)
    floor = chip_smoke.bitmm_floor_ms(M, 8 << 20, 132, 1.98e9)
    assert 556 / 4 > 215 / 2
    assert floor == 1e3 * 32768 * (556 / 4) / (132 * 1.98e9)
    assert 0.013 < floor < chip_smoke.bound(M, 8 << 20)[0]
    D = mats["decode 8x8 {1,4,9}"]
    assert chip_smoke.bitmm_mix(D) == (405, 397, 1028)
    floor_d = chip_smoke.bitmm_floor_ms(D, 8 << 20, 132, 1.98e9)
    assert floor_d == 1e3 * 32768 * (1028 / 4) / (132 * 1.98e9)
    assert floor_d < chip_smoke.bound(D, 8 << 20)[0]
    # the pipe limit binds where the total is small beside the busier pipe
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "BITMM_GROUP_OPS", 0)
        mp.setattr(chip_smoke, "BITMM_TILE_OPS", 0)
        assert chip_smoke.bitmm_floor_ms(M, 256, 1, 1.0) == \
            1e3 * 32 * 215 / 64
    # a ragged length counts its last tile whole
    assert chip_smoke.bitmm_floor_ms(M, 256 + 16, 1, 1.0) == \
        chip_smoke.bitmm_floor_ms(M, 512, 1, 1.0)
    with pytest.raises(ValueError):
        chip_smoke.bitmm_mix(np.ones((3, 9), np.uint8))


def test_bitmm_ptxas_lines_need_both_kernels(monkeypatch):
    """G4's ptxas lines come from the build this process ran; phase 3
    fails if they lack the word or the column kernel (a rename would
    otherwise print nothing), and prints none when no build ran."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN2g414gf_bitmm_wordsEPKhPhPKjiixx' for 'sm_90a'",
        "ptxas info    : Used 80 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN2g416gf_bitmm_columnsILi1EEvPKhPhPKjiixx' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function 'crc32c_mma_kernel'",
        "ptxas info    : Used 40 registers"])
    monkeypatch.setattr(chip_smoke.cuda_lib, "BUILD_LOG", {"ptxas": log})
    lines = chip_smoke.bitmm_ptxas_lines()
    assert len(lines) == 4 and not any("40 registers" in ln for ln in lines)
    renamed = log.replace("gf_bitmm_columns", "gf_bitmm_cols")
    monkeypatch.setattr(chip_smoke.cuda_lib, "BUILD_LOG", {"ptxas": renamed})
    with pytest.raises(AssertionError, match="gf_bitmm_columns"):
        chip_smoke.bitmm_ptxas_lines()
    monkeypatch.setattr(chip_smoke.cuda_lib, "BUILD_LOG", {})
    assert chip_smoke.bitmm_ptxas_lines() == []


def test_bitmm_cases_rehearsal_on_cpu(capsys):
    """Phase 3's own G4 cases: full rows reach a sum of 256 at c = 32 on
    all-0xFF data, r = 1 and r = 16 are there, every length is whole
    16-byte groups and most end in a ragged tile; the check runs them
    (shortened) through the wrapper's plain version on the CPU."""
    cases = chip_smoke.BITMM_CASES
    assert {c[1] for c in cases} >= {1, 16, "full"}
    # both sides of the column kernel's half-K boundary, each ragged
    assert any(8 < c[2] <= 16 and c[3] % 128 for c in cases)
    assert any(c[2] == 17 and c[3] % 128 for c in cases)
    assert all(c[3] % 16 == 0 for c in cases)
    assert sum(c[3] % 256 != 0 for c in cases) >= 4
    rng = np.random.default_rng(0)
    full = chip_smoke.bitmm_case_matrix("full", 32, rng)
    bits = ec_kernels.gf256.bitmatrix(full)
    assert bits[0].sum() == bits[15].sum() == 256
    short = tuple((label, rows, cols, min(L, 4096) + 16, fill)
                  for label, rows, cols, L, fill in cases)
    gen = torch.Generator()
    gen.manual_seed(0)
    n, err = chip_smoke.check_bitmm_cases(torch.device("cpu"), gen, rng,
                                          short)
    assert (n, err) == (len(cases), 0)
    assert "all-0xFF, full rows 2x32" in capsys.readouterr().out


def test_check_picks_allows_only_mxu_on_wide_matrices(capsys):
    """The one skip a pick may book is mxu on a matrix wider than 32
    columns, printed by signature; any other skip fails, and so does a
    path that raced a narrow matrix without launching G4."""
    counts = {"gf_bitmm": 3}
    ok = {"pick/3x8/m1/L512": {"mode": "auto", "skipped": []},
          "pick/2x40/m2/L512": {"mode": "auto", "skipped": ["mxu"]}}
    chip_smoke.check_picks(ok, counts, "test path")
    assert "pick/2x40/m2/L512" in capsys.readouterr().out
    assert chip_smoke.pick_cols("pick/2x40/m2/L512") == 40
    for bad in ({"pick/3x32/m3/L512": {"mode": "auto",
                                        "skipped": ["mxu"]}},
                {"pick/2x40/m2/L512": {"mode": "auto",
                                        "skipped": ["mxu", "bitxor"]}},
                {"pick/2x40/m2/L512": {"mode": "pinned",
                                        "skipped": ["nope"]}}):
        with pytest.raises(AssertionError, match="skipped"):
            chip_smoke.check_picks(bad, counts, "test path")
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.check_picks(ok, {"gf_bitmm": 0}, "test path")
    # a path with no race of a narrow matrix needs no G4 launch
    chip_smoke.check_picks({"pick/3x8/m1/L512": {"mode": "pinned",
                                                 "skipped": []}},
                           {"gf_bitmm": 0}, "test path")


def test_bench_runs_are_baselines_headline():
    runs = dict(chip_smoke.bench_runs())
    assert list(runs) == ["encode 4 KiB", "encode 64 KiB", "encode 1024 KiB",
                          "encode 4096 KiB", "decode 1024 KiB",
                          "encode+csum 1024 KiB"]
    for label, argv in runs.items():
        assert argv[:4] == ["--k", "8", "--m", "3"]
        stripe = int(argv[argv.index("--stripe-bytes") + 1])
        batch = int(argv[argv.index("--batch") + 1])
        assert batch == max(1, min(64, (64 << 20) // stripe))


def test_bench_phase_rehearsal_on_cpu(capsys):
    """Phase 15 at a small size on the CPU: every viable candidate (the
    plain versions, xla among them) measured with its digest verified."""
    small = ["--k", "8", "--m", "3", "--reps", "1", "--stripe-bytes",
             "4096", "--batch", "2"]
    lines = chip_smoke.phase_bench(torch.device("cpu"), [
        ("encode 4 KiB", small), ("encode+csum 4 KiB", small + ["--csum"])])
    out = capsys.readouterr().out
    assert out.count("[bench]") == 2 and "digests verified" in out
    for line in lines:
        assert set(line["candidates"]) == {"xla", "pallas", "bitxor", "mxu"}
    bad = dict(lines[0], candidates={"pallas": {"kernel_gbps": 1.0}})
    with pytest.raises(AssertionError, match="measured"):
        chip_smoke.check_bench(bad, torch.device("cpu"))


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
                        "decode 8x8 {1,4,9}": 0.083},
             "mxu": {"reed_sol_van 3x8": 0.064,
                     "decode 8x8 {1,4,9}": 0.121}}
    with pytest.raises(AssertionError, match="pinned bitxor"):
        chip_smoke.check_race_picks(times, rng)
    picks[sig]["picked"] = "mxu"
    with pytest.raises(AssertionError, match="pinned mxu"):
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
    counts = {"gf_bitterm": 40, "gf_bitxor": 8, "gf_bitmm": 8,
              "gf_sched_xor": 0, "crc32c_chunks": 30, "plain": 0}
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
        counts["gf_bitterm"] = counts["gf_bitxor"] = counts["gf_bitmm"] = 0
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
    counts = {"gf_bitterm": 900, "gf_bitxor": 700, "gf_bitmm": 400,
              "gf_sched_xor": 0, "crc32c_chunks": 32, "plain": 0}
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
                                   "repair alone", "no G4",
                                   "mxu skipped on a narrow matrix"])
def test_wide_path_check_refuses_each_fault(fault, monkeypatch):
    picks = {"pick/8x8/m00000000/L131072": {"picked": "pallas",
                                             "mode": "auto", "at": 0.0,
                                             "skipped": []},
             "pick/8x40/m00000001/L131072": {"picked": "pallas",
                                             "mode": "auto", "at": 0.0,
                                             "skipped": ["mxu"]}}
    monkeypatch.setattr(chip_smoke, "kernel_profiler",
                        lambda: types.SimpleNamespace(picks=lambda: picks))
    counts, result = _passing_wide()
    chip_smoke.check_wide_path(counts, result)
    counts["gf_bitxor"] = 0  # one region kernel alone passes too
    chip_smoke.check_wide_path(counts, result)
    if fault == "plain ran":
        counts["plain"] = 1
    elif fault == "no region kernel":
        counts["gf_bitterm"] = counts["gf_bitmm"] = 0
    elif fault == "no G4":
        counts["gf_bitmm"] = 0
    elif fault == "mxu skipped on a narrow matrix":
        picks["pick/8x8/m00000000/L131072"]["skipped"] = ["mxu"]
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


def test_cluster_phase_rehearsal_on_cpu(capsys):
    """Phase 16's host steps at full size with device=cpu: the wire
    corpus (all 55 checked), three monitors in a
    quorum, the tpu pool created from a backend=torch profile with no
    launch, 96 boots committed, the map pushed over TCP loopback in
    secure mode and its PG-mapping digest equal to CLUSTER_DIGEST; the
    codec from the pushed pool encodes byte-exact on the CPU, so the
    plain version ran, which check_cluster must refuse."""
    counts = chip_smoke.phase_cluster(torch.device("cpu"),
                                      np.random.default_rng(9),
                                      encode_L=64 << 10)
    out = capsys.readouterr().out
    assert "wire corpus: 55 files checked\n" in out
    assert "96 OSDs on 12 hosts, pool ecpool ec size 11 pg_num 1024" in out
    assert "PG-mapping digest matches" in out
    assert counts["plain"] > 0
    assert all(counts[c] == 0 for c in ("gf_bitterm", "gf_bitxor",
                                        "gf_bitmm"))
    with pytest.raises(AssertionError, match="no region kernel"):
        chip_smoke.check_cluster(counts)
    counts.update(plain=0, gf_bitmm=5)
    chip_smoke.check_cluster(counts)
    counts.update(plain=1)
    with pytest.raises(AssertionError, match="plain version ran"):
        chip_smoke.check_cluster(counts)


def test_cluster_digest_is_the_references():
    """CLUSTER_DIGEST is the JAX package's placement of the map the
    port's quorum commits: the committed bytes decode in the reference,
    re-encode unchanged, and the reference's acting sets hash to it."""
    from ceph_tpu.mon.maps import OSDMap as RefOSDMap
    from ceph_tpu_torch.msg.messenger import LocalNetwork

    cfg = dict(chip_smoke.CLUSTER)
    net = LocalNetwork()
    quorum = chip_smoke.cluster_quorum(net, **cfg)
    try:
        chip_smoke.cluster_pool(quorum, torch.device("cpu"), **cfg)
        raw, sent = chip_smoke.cluster_boot(net, quorum, **cfg)
        assert sent >= 96
    finally:
        for m in quorum:
            m.stop()
    ref = RefOSDMap.decode_bytes(raw)
    assert ref.encode_bytes() == raw
    assert len(ref.up_osds()) == 96 and ref.pools[1].pg_num == 1024
    assert ref.pools[1].ec_profile["backend"] == "torch"
    assert chip_smoke.pg_mapping_digest(ref) == chip_smoke.CLUSTER_DIGEST


def test_cluster_pool_refuses_a_create_that_launches(monkeypatch):
    """cluster_pool fails when the monitor's check reaches a kernel
    wrapper (here: a check codec built on the torch backend that counts
    a launch)."""
    from ceph_tpu_torch.mon import monitor
    from ceph_tpu_torch.msg.messenger import LocalNetwork

    real = monitor.ec.factory

    def launching(plugin, profile):
        ec_kernels._count("gf_bitmm")
        return real(plugin, profile)

    monkeypatch.setattr(monitor.ec, "factory", launching)
    mon = monitor.MonitorLite(LocalNetwork(), "mon.0")
    try:
        with pytest.raises(AssertionError, match="launched kernels"):
            chip_smoke.cluster_pool([mon], torch.device("cpu"), pg_num=8,
                                    wait_s=60.0, resend_s=2.0)
    finally:
        mon.stop()


def test_osd_phase_rehearsal_on_cpu(capsys):
    """Phase 17 at 8 objects of 64 KiB from 4 threads in 8 PGs with
    device=cpu: the 14-OSD cluster on the phase's config,
    writes, two reads (the second served from the arena), a folded
    scrub of one PG, two OSDs lost, degraded reads and the rebuild onto
    the spares, all byte-exact; the plain versions ran, which check_osd
    must refuse."""
    counts, res = chip_smoke.phase_osd(
        torch.device("cpu"), np.random.default_rng(5), objects=8,
        object_size=64 << 10, threads=4, sample=4, pg_num=8)
    out = capsys.readouterr().out
    assert "[osd] write" in out and "served from the arena" in out
    assert counts["plain"] > 0
    assert all(counts[c] == 0 for c in ("gf_bitterm", "gf_bitxor",
                                        "gf_bitmm", "crc32c_chunks"))
    assert res["write"]["fused"] > 0
    assert res["read2"]["cache_served"] > 0
    assert res["read2"]["ec_arena_hits"] > 0
    assert res["scrub"]["objects"] > 0 and res["scrub"]["mismatches"] == 0
    assert res["lost_shards"] > 0 and res["degraded_folds"]["decode"][0]
    assert res["codecs"] > 0
    assert res["faults"] == {"op_timeouts": 0, "dropped": 0}
    with pytest.raises(AssertionError, match="no region kernel"):
        chip_smoke.check_osd(counts, res)


def osd_result(**over) -> tuple[dict, dict]:
    """Counts and numbers of a phase 17 that check_osd accepts."""
    counts = {"gf_bitterm": 3, "gf_bitxor": 2, "gf_bitmm": 40,
              "gf_sched_xor": 0, "crc32c_chunks": 50, "plain": 0}
    res = {"write": {"fused": 30},
           "read2": {"ec_arena_hits": 64, "cache_served": 8},
           "scrub": {"objects": 11, "bytes": 1 << 20, "mismatches": 0,
                     "launches": 11},
           "scrub_counts": {"crc32c_chunks": 11},
           "degraded": {"gf_bitterm": 1, "gf_bitxor": 0, "gf_bitmm": 9},
           "degraded_folds": {"decode": [10, 12, 2]},
           "faults": {"op_timeouts": 0, "dropped": 0}}
    for key, value in over.items():
        where, _, name = key.partition("__")
        (counts if where == "counts" else res[where])[name] = value
    return counts, res


@pytest.mark.parametrize("fault,match", [
    ({"counts__gf_bitterm": 0, "counts__gf_bitxor": 0,
      "counts__gf_bitmm": 0}, "no region kernel"),
    ({"counts__crc32c_chunks": 0}, "G1 never launched"),
    ({"counts__plain": 1}, "a plain version ran"),
    ({"write__fused": 0}, "fused"),
    ({"read2__ec_arena_hits": 0}, "arena"),
    ({"scrub__mismatches": 1}, "scrub"),
    ({"scrub_counts__crc32c_chunks": 0}, "did not launch G1"),
    ({"degraded__gf_bitmm": 0, "degraded__gf_bitterm": 0}, "decoded"),
    ({"faults__op_timeouts": 1}, "1 ops timed out"),
    ({"faults__dropped": 2}, "2 messages dropped"),
])
def test_osd_check_refuses_each_fault(fault, match):
    chip_smoke.check_osd(*osd_result())
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_osd(*osd_result(**fault))


# ------------------------------------------------------------ phase 18
def bench_root_fixture(mode: str, **over) -> tuple[dict, dict, tuple]:
    """A row, counts and needed counters of a phase-18 kernel mode that
    check_bench_root accepts."""
    need = dict((m, n) for m, _argv, n in
                chip_smoke.BENCH_ROOT_KERNEL_MODES)[mode]
    counts = {"gf_bitterm": 30, "gf_bitxor": 28, "gf_bitmm": 40,
              "gf_sched_xor": 0, "crc32c_chunks": 16, "plain": 0}
    row = {"scrub": {"ok": True, "fold_backend": "torch"},
           "ec-batch": {"digest_verified": True,
                        "d2h_copies_per_flush": 1.0,
                        "ec_kernel_picks": {"pick/3x8/m/L16384": "mxu"}},
           "ec-recovery": {"digest_verified": True}}[mode]
    for key, value in over.items():
        where, _, name = key.partition("__")
        (counts if where == "counts" else row)[name] = value
    return row, counts, need


def test_bench_root_modes_are_the_issues():
    modes = {m: (argv, need) for m, argv, need in
             chip_smoke.BENCH_ROOT_KERNEL_MODES}
    assert modes["scrub"] == (["--scrub"], ("crc32c_chunks",))
    assert modes["ec-batch"] == (["--ec-batch", "--no-overhead"],
                                 ("gf_bitterm", "gf_bitxor", "gf_bitmm"))
    assert modes["ec-recovery"] == (["--ec-recovery", "--progress"],
                                    ("gf_bitterm", "gf_bitxor", "gf_bitmm"))
    assert [argv for _m, argv, _t in chip_smoke.BENCH_ROOT_CLUSTER_MODES] \
        == [["--ec-read"], ["--read-storm"], ["--saturate", "--smoke"],
            ["--saturate", "--smoke", "--frontend", "rgw"]]
    from ceph_tpu_torch.tools import bench_sweep
    assert chip_smoke.BENCH_ROOT_SWEEP_ROW in {
        c["id"] for c in bench_sweep.bench_root_configs()}


@pytest.mark.parametrize("mode,fault,match", [
    ("scrub", {"row__ok": False}, "not verified"),
    ("scrub", {"counts__crc32c_chunks": 0}, "crc32c_chunks never launched"),
    ("ec-batch", {"row__digest_verified": False}, "not verified"),
    ("ec-batch", {"counts__gf_bitmm": 0}, "gf_bitmm never launched"),
    ("ec-batch", {"counts__gf_bitxor": 0}, "gf_bitxor never launched"),
    ("ec-batch", {"counts__plain": 3}, "a plain version ran 3 times"),
    ("ec-batch", {"row__ec_kernel_picks": {"pick/3x8/m/L4096": "xla"}},
     "xla picks"),
    ("ec-batch", {"row__d2h_copies_per_flush": 2.0}, "copies back"),
    ("ec-recovery", {"counts__gf_bitterm": 0}, "gf_bitterm never launched"),
    ("ec-recovery", {"row__digest_verified": None}, "not verified"),
])
def test_bench_root_check_refuses_each_fault(mode, fault, match):
    chip_smoke.check_bench_root(mode, *bench_root_fixture(mode))
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_bench_root(mode, *bench_root_fixture(mode, **fault))


def test_bench_root_check_reads_the_picks_booked_during_the_mode():
    row, counts, need = bench_root_fixture("ec-recovery")
    chip_smoke.check_bench_root("ec-recovery", row, counts, need,
                                {"pick/8x8/m/L16384": "pallas"})
    with pytest.raises(AssertionError, match="xla picks"):
        chip_smoke.check_bench_root("ec-recovery", row, counts, need,
                                    {"pick/8x8/m/L16384": "xla"})


def test_bench_root_line_names_the_card():
    row = {"unit": "GB/s", "value": 0.13, "vs_baseline": 0.7,
           "e2e_gbps": 0.2, "ec_kernel_race_winner": "pallas"}
    line = chip_smoke.bench_root_line("ec-batch", row, 23.4,
                                      "NVIDIA H100 80GB HBM3, 700.00 W")
    assert line.startswith("ec-batch GB/s: {")
    assert '"value": 0.13' in line and '"ec_kernel_race_winner": "pallas"' \
        in line
    assert line.endswith("23.4 s; NVIDIA H100 80GB HBM3, 700.00 W")
    assert '"saturation_knee_per_s"' in chip_smoke.bench_root_line(
        "saturate-rgw", {"value": 1}, 1.0, "x")


def test_bench_root_phase_rehearsal_on_cpu(monkeypatch, capsys):
    """Phase 18's kernel-mode loop on the CPU at a small size: the scrub
    runs, and on the CPU (the native sweep, no kernel) check_bench_root
    refuses it, as it must."""
    monkeypatch.setenv("BENCH_SCRUB_OBJECTS", "16")
    monkeypatch.setattr(chip_smoke, "BENCH_ROOT_KERNEL_MODES",
                        chip_smoke.BENCH_ROOT_KERNEL_MODES[:1])
    monkeypatch.setattr(chip_smoke, "card", lambda dev: dev.type)
    with pytest.raises(AssertionError,
                       match="crc32c_chunks never launched"):
        chip_smoke.phase_bench_root(torch.device("cpu"))


@pytest.mark.parametrize("mode", ["scrub", "ec-batch", "ec-recovery",
                                  "ec-read", "read-storm", "saturate",
                                  "saturate-rgw"])
def test_bench_root_exit_is_taken_as_is(mode):
    """Any nonzero exit of a mode fails phase 18, whatever gate made it:
    the row rides the message."""
    chip_smoke.check_bench_root_exit(mode, 0, {"ok": True})
    row = {"digest_verified": True, "trace_overhead_ok": False}
    with pytest.raises(AssertionError,
                       match=f"bench_root {mode} exit 1: .*trace_overhead_ok"):
        chip_smoke.check_bench_root_exit(mode, 1, row)


def test_bench_root_phase_fails_on_a_mode_that_exits_nonzero(monkeypatch):
    """A kernel mode whose row verifies and whose kernels launched still
    fails the phase when it exits 1 (a timing gate of bench.py)."""
    row, counts, need = bench_root_fixture("scrub")

    def fake_main(argv):
        print(json.dumps({**row, "trace_overhead_ok": False}))
        return 1
    monkeypatch.setattr(chip_smoke.bench_root, "main", fake_main)
    monkeypatch.setattr(chip_smoke.ec_kernels, "launch_counts",
                        lambda: counts)
    monkeypatch.setattr(chip_smoke, "card", lambda dev: dev.type)
    with pytest.raises(AssertionError, match="bench_root scrub exit 1"):
        chip_smoke.phase_bench_root(torch.device("cpu"))


# ------------------------------------------------------------ phase 19
def test_mesh_phase_rehearsal_on_cpu(capsys):
    """Phase 19 on 8 logical CPU devices at a small size: the mesh steps
    against one device and the oracle, the host mesh, both sharded
    batcher bursts, ec_tool's round trip and the two-process leg, all
    exact; the plain versions ran, which check_mesh must refuse.  The
    forced devices are given back."""
    from ceph_tpu_torch.parallel import mesh as meshmod

    counts, res = chip_smoke.phase_mesh(
        torch.device("cpu"), np.random.default_rng(5), devices=8, B=4,
        chunk=8192, writers=8, batch_chunk=1024, proc_devices=2,
        tool_bytes=64 << 10)
    assert len(meshmod.devices("cpu")) == 1
    assert res["mesh"] == {"dp": 2, "shard": 4}
    assert set(res["times"]) == {"write", "rebalance", "recovery",
                                 "delta", "stats"}
    assert res["host"]["mesh"] == {"host": 2, "dp": 1, "shard": 4}
    assert res["batcher"]["sharded_launches"] == 1
    assert res["batcher_csums"]["sharded_launches"] == 1
    assert res["processes"][0]["digest"] == res["processes"][1]["digest"]
    assert counts["plain"] > 0
    assert {d for d, _ in res["device_launches"]} == set(range(8))
    line = chip_smoke.mesh_line(res, torch.device("cpu"))
    assert "write" in line and "GB/s" in line and "digest" in line
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.check_mesh(counts, res)


def mesh_result(**over) -> tuple[dict, dict]:
    """Counts and results of a phase 19 that check_mesh accepts."""
    counts = {"gf_bitterm": 138, "gf_bitxor": 72, "gf_bitmm": 80,
              "gf_sched_xor": 0, "crc32c_chunks": 8, "plain": 0}
    per = {(d, c): n for d in range(8)
           for c, n in (("gf_bitterm", 16), ("gf_bitxor", 8),
                        ("gf_bitmm", 9))}
    procs = [{"process_id": p, "devices_local": 4, "foreign_modules": [],
              "launches": {"gf_bitterm": 8, "plain": 0},
              "device_launches": {f"{4 * p + d}/gf_bitterm": 2
                                  for d in range(4)}} for p in (0, 1)]
    res = {"device_launches": per, "device_ids": list(range(8)),
           "processes": procs}
    for key, value in over.items():
        if key == "device":
            d, c, n = value
            per[(d, c)] = n
        elif key == "process_device":
            procs[1]["device_launches"].pop("7/gf_bitterm")
        elif key == "foreign":
            procs[0]["foreign_modules"] = ["jax"]
        else:
            counts[key] = value
    return counts, res


@pytest.mark.parametrize("fault,match", [
    ({"gf_bitxor": 0}, "gf_bitxor never launched"),
    ({"crc32c_chunks": 0}, "crc32c_chunks never launched"),
    ({"plain": 3}, "a plain version ran 3"),
    ({"device": (5, "plain", 1)}, "logical device 5"),
    ({"process_device": True}, "launched no region kernel"),
    ({"foreign": True}, "process 0"),
])
def test_mesh_check_refuses_each_fault(fault, match):
    chip_smoke.check_mesh(*mesh_result())
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_mesh(*mesh_result(**fault))


def test_mesh_check_refuses_a_device_with_no_region_kernel():
    counts, res = mesh_result()
    for c in ("gf_bitterm", "gf_bitxor", "gf_bitmm"):
        res["device_launches"][(3, c)] = 0
    with pytest.raises(AssertionError, match="logical device 3"):
        chip_smoke.check_mesh(counts, res)


# ------------------------------------------------------------ phase 20
#: phase 20 (b) at a small size: 8 objects of 256 KiB, 4 threads, the
#: gateways at 128 KiB a request, in 8 PGs on the CPU
SMALL_SERVICES = dict(image=2 << 20, object_size=256 << 10, threads=4,
                      gateway=512 << 10, request=128 << 10,
                      overwrites=64, snap_overwrites=16, pg_num=8)


def test_services_phase_rehearsal_on_cpu(capsys):
    """Phase 20 on the CPU: the port's whole scorecard passes its fifteen
    checks, and the image leg at a small size writes through the Image
    API, NBD and NVMe/TCP, overwrites 4 KiB pieces (the parity-delta
    route), snapshots, loses two OSDs and reads head, an NBD range and
    the snapshot back byte-exact while recovery rebuilds; the plain
    versions ran and no kernel did, which check_services must
    refuse."""
    counts, res = chip_smoke.phase_services(
        torch.device("cpu"), np.random.default_rng(5), **SMALL_SERVICES)
    out = capsys.readouterr().out
    assert "[services] scorecard: rc 0, 15 checks" in out
    assert "[services] image 2 MiB in 8 objects: Image writes" in out
    sc, rbd = res["scorecard"], res["rbd"]
    assert sc["rc"] == 0 and len(sc["checks"]) == 15
    assert {mark for _n, mark, _d in sc["checks"]} == {"PASS"}
    assert sc["checks"][-1][0] == "kernel parity (fused encode+crc on cpu)"
    routes = rbd["routes"]
    assert routes["full_stripe"] >= 8 + 2 * 4
    assert routes["parity_delta"] > 0
    assert rbd["snap_ok"] and rbd["lost_shards"] > 0
    assert rbd["degraded_folds"]["decode"][0] > 0
    assert rbd["faults"] == {"op_timeouts": 0, "dropped": 0}
    assert counts["plain"] == sc["counts"]["plain"] + \
        rbd["counts"]["plain"] > 0
    with pytest.raises(AssertionError, match="no region kernel launched "
                                             "on the scorecard"):
        chip_smoke.check_services(counts, res)


def services_result(**over) -> tuple[dict, dict]:
    """Counts and results of a phase 20 that check_services accepts."""
    region = {"gf_bitterm": 4, "gf_bitxor": 2, "gf_bitmm": 60,
              "gf_sched_xor": 0, "crc32c_chunks": 40, "plain": 0}
    sc_counts = dict(region)
    checks = [(f"check {i}", "PASS", "0.1s") for i in range(15)]
    res = {"scorecard": {"rc": 0, "checks": checks, "counts": sc_counts},
           "rbd": {"write": dict(region, fused=30),
                   "degraded": dict(region),
                   "faults": {"op_timeouts": 0, "dropped": 0}}}
    counts = {c: 2 * n for c, n in region.items()}
    for key, value in over.items():
        where, _, name = key.partition("__")
        if where == "counts":
            counts[name] = value
        elif where == "scorecard":
            if name == "check":
                checks[3] = ("check 3", "FAIL", "AssertionError()")
            else:
                sc_counts[name] = value
        else:
            res["rbd"][where][name] = value
    return counts, res


@pytest.mark.parametrize("fault,match", [
    ({"counts__plain": 2}, "a plain version ran 2"),
    ({"scorecard__plain": 1}, "a plain version ran 1 times on the "
                              "scorecard"),
    ({"scorecard__check": True}, "failed \\['check 3'\\]"),
    ({"scorecard__gf_bitterm": 0, "scorecard__gf_bitxor": 0,
      "scorecard__gf_bitmm": 0}, "no region kernel launched on the "
                                 "scorecard"),
    ({"scorecard__crc32c_chunks": 0}, "G1 never launched on the "
                                      "scorecard"),
    ({"write__gf_bitterm": 0, "write__gf_bitxor": 0,
      "write__gf_bitmm": 0}, "no region kernel launched in the image's "
                             "writes"),
    ({"write__crc32c_chunks": 0}, "no G1 launch in the image's fused"),
    ({"degraded__gf_bitterm": 0, "degraded__gf_bitxor": 0,
      "degraded__gf_bitmm": 0}, "no region kernel launched in the "
                                "degraded reads"),
    ({"faults__op_timeouts": 1}, "1 ops timed out"),
    ({"faults__dropped": 4}, "4 messages dropped"),
])
def test_services_check_refuses_each_fault(fault, match):
    chip_smoke.check_services(*services_result())
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_services(*services_result(**fault))


def test_services_phase_sizes():
    """Phase 20 (b)'s sizes: an image of 512 MiB in rbd's 4 MiB objects
    on phase 17's cluster and pool, 64 MiB through each gateway at 1 MiB
    a request, 256 and 128 overwrites of 4 KiB (the first cut from 2048,
    then from 512, for the whole run's time), two OSDs lost."""
    cfg = chip_smoke.SERVICES
    assert cfg["image"] // cfg["object_size"] == 128
    assert cfg["object_size"] == chip_smoke.OBJECT_SIZE == 4 << 20
    for key in ("osds", "pg_num", "k", "m", "lost"):
        assert cfg[key] == chip_smoke.OSD_PHASE[key]
    assert (cfg["gateway"], cfg["request"]) == (64 << 20, 1 << 20)
    assert (cfg["overwrites"], cfg["snap_overwrites"]) == (256, 128)


# ------------------------------------------------------------ phase 21
#: phase 21 at a small size: 4 OSD children, k=2 m=1, 4 objects of 256
#: KiB from 4 threads in 8 PGs, the writer's objects of 64 KiB; the
#: grace of tests/test_torch_cephadm.py (a loaded box can stall a child
#: interpreter past CephAdm's 2 s)
SMALL_CEPHADM = dict(osds=4, k=2, m=1, objects=4, object_size=256 << 10,
                     threads=4, pg_num=8, live_size=64 << 10,
                     live_payloads=4, wait_s=60.0,
                     cfg={"osd_heartbeat_grace": 5.0})
KERNEL_COUNTERS = ("gf_bitterm", "gf_bitxor", "gf_bitmm", "gf_sched_xor",
                   "crc32c_chunks")


def _as_on_the_card(counts: dict, res: dict) -> tuple[dict, dict]:
    """A CPU run's phase 21 made into one check_cephadm accepts: each
    child's plain launches booked to K1 and G1 instead, and no faults."""
    res = dict(res, faults={"op_timeouts": 0, "dropped": 0}, flaps=0,
               alive=[], incarnations=[
                   dict(st, launches=dict(
                       st["launches"], plain=0,
                       gf_bitterm=st["launches"]["plain"] + 1,
                       crc32c_chunks=1)) for st in res["incarnations"]])
    counts = dict(counts, plain=0, gf_bitterm=counts["plain"],
                  crc32c_chunks=len(res["incarnations"]))
    return counts, res


def test_cephadm_phase_rehearsal_on_cpu(capsys):
    """Phase 21 on the CPU: CephAdm deploys 4 osd_main children, the
    objects are written and read back, deep-scrubbed, one child is
    killed with SIGKILL and marked down on its peers' reports, every
    object read back degraded, the child restarted, then the rolling
    restart under a writer, everything read back and scrubbed, and no
    child outlives the teardown.  The children ran the plain versions
    (each read through its admin socket), which check_cephadm refuses;
    made into a run the check accepts, it refuses each fault in turn."""
    counts, res = chip_smoke.phase_cephadm(
        torch.device("cpu"), np.random.default_rng(5), **SMALL_CEPHADM)
    out = capsys.readouterr().out
    assert "[cephadm] 4 osd_main children: deploy" in out
    assert counts["plain"] > 0
    assert all(counts[c] == 0 for c in KERNEL_COUNTERS)
    assert res["parent"]["plain"] == 0
    assert res["order"] == [0, 1, 2, 3] and len(res["steps"]) == 4
    assert res["live_objects"] > 0
    # the writer read each acked write back at once, and every one came
    # back: the objects it kept are exactly the acked ones
    assert res["acked_unreadable"] == 0 and res["unreadable"] == []
    assert res["scrub1"] == res["scrub2"] == []
    # every child read once before it was killed, and at the end
    assert sorted(st["osd"] for st in res["incarnations"]) == \
        sorted([0, 1, 2, 3] * 2 + [res["victim"]])
    assert len({st["pid"] for st in res["incarnations"]}) == 9
    assert res["downs"][(res["victim"], "failure")] >= 1
    assert [d["daemon"] for d in res["ls"]] == \
        ["mon.0", "osd.0", "osd.1", "osd.2", "osd.3"]
    assert res["alive"] == []
    with pytest.raises(AssertionError, match="a plain version ran"):
        chip_smoke.check_cephadm(counts, res)
    good = _as_on_the_card(counts, res)
    chip_smoke.check_cephadm(*good)
    idle = dict(good[1], incarnations=[
        dict(st, launches=dict.fromkeys(st["launches"], 0))
        if st["osd"] == 2 else st for st in good[1]["incarnations"]])
    for bad, match in (
            (dict(good[1], faults={"op_timeouts": 1, "dropped": 0}),
             "1 ops timed out"),
            (dict(good[1], flaps=1), "1 flaps"),
            (dict(good[1], acked_unreadable=1,
                  unreadable=[(1.5, "live00007", "RadosError(-2)")]),
             "1 acked writes did not read back"),
            (idle, r"OSDs \[2\] launched no kernel"),
            (dict(good[1], alive=[4242]), r"children \[4242\] alive")):
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_cephadm(good[0], bad)


def cephadm_result(**over) -> tuple[dict, dict]:
    """Counts and numbers of a phase 21 that check_cephadm accepts."""
    launches = {"gf_bitterm": 2, "gf_bitxor": 1, "gf_bitmm": 9,
                "gf_sched_xor": 0, "crc32c_chunks": 4, "plain": 0}
    incs = [{"osd": i % 12, "pid": 100 + i, "launches": dict(launches),
             "cuda_lib": {"seconds": 0.1, "built": False}}
            for i in range(25)]
    counts = {c: 25 * n for c, n in launches.items()}
    ls = [{"daemon": "mon.0", "type": "mon", "state": "running"}] + [
        {"daemon": f"osd.{i}", "type": "osd", "state": "running",
         "up": True} for i in range(12)]
    res = {"osds": 12, "device": "cuda", "incarnations": incs,
           "contexts": dict.fromkeys(range(12), True),
           "apps": {1: 7344}, "apps_after": {1: 564}, "children_mib": 6780,
           "scrub1": [], "scrub2": [], "ls": ls,
           "faults": {"op_timeouts": 0, "dropped": 0}, "flaps": 0,
           "acked_unreadable": 0, "unreadable": [],
           "downs": {}, "alive": []}
    for key, value in over.items():
        if key == "counts":
            counts.update(value)
        elif key == "idle_osd":
            for st in incs:
                if st["osd"] == value:
                    st["launches"] = dict.fromkeys(launches, 0)
        elif key == "built":
            incs[3]["cuda_lib"] = {"seconds": 30.0, "built": True}
        elif key == "down":
            ls[5] = dict(ls[5], up=False)
        else:
            res[key] = value
    return counts, res


@pytest.mark.parametrize("fault,match", [
    ({"counts": {"plain": 3}}, "a plain version ran 3 times in the "
                               "cephadm children"),
    ({"counts": {"gf_bitterm": 0, "gf_bitxor": 0, "gf_bitmm": 0}},
     "no region kernel"),
    ({"counts": {"crc32c_chunks": 0}}, "G1 never launched"),
    ({"idle_osd": 7}, r"OSDs \[7\] launched no kernel"),
    ({"built": True}, r"OSDs \[3\] rebuilt the CUDA library"),
    ({"contexts": {i: i != 1 for i in range(12)}},
     r"the children of OSDs \[1\] hold no CUDA context"),
    ({"children_mib": 0}, "nvidia-smi shows no device memory"),
    ({"scrub2": [{"oid": "obj0003"}]}, "deep scrub found"),
    ({"down": True}, "inventory"),
    ({"faults": {"op_timeouts": 2, "dropped": 0}}, "2 ops timed out"),
    ({"faults": {"op_timeouts": 0, "dropped": 5}}, "5 messages dropped"),
    ({"flaps": 1}, "1 flaps"),
    ({"alive": [31337]}, r"children \[31337\] alive after the teardown"),
    ({"acked_unreadable": 1, "unreadable": [(2.25, "live00031", "RadosError("
                                             "-2, 'read cephadm/live00031')")]},
     r"1 acked writes did not read back: \[\(2.25, 'live00031'"),
])
def test_cephadm_check_refuses_each_fault(fault, match):
    chip_smoke.check_cephadm(*cephadm_result())
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_cephadm(*cephadm_result(**fault))


def test_cephadm_phase_sizes():
    """Phase 21's sizes: 12 OSD children, a tpu k=8 m=3 pool at pg_num
    32, 64 objects of 4 MiB from 8 threads (256 MiB, phase 17's size
    before its cut to 32), the writer's objects of 1 MiB, and CephAdm's
    own config over the defaults."""
    cfg = chip_smoke.CEPHADM
    assert cfg["osds"] == 12 and cfg["pg_num"] == 32
    assert (cfg["k"], cfg["m"]) == (8, 3)
    assert (cfg["objects"], cfg["threads"]) == (64, 8)
    assert cfg["object_size"] == chip_smoke.OBJECT_SIZE == 4 << 20
    assert cfg["live_size"] == 1 << 20 and cfg["cfg"] is None
