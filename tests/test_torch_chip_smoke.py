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
