"""Rehearsal of chip_smoke.py's main path on the CPU at a small size:
the same phases (the tpu plugin's batched and interface encode/decode,
the ec_benchmark CLI, the corpus check) with device=cpu, where the
wrappers run the plain versions.  On the card the same code must launch
the kernels and never the plain versions; here the counts show the
opposite, which check_main_path must refuse.  Byte checks inside the
phases compare exactly (tolerance 0)."""

import os
import sys

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
    mix for the encode: ten coefficients are 1 (row 2 and the first
    column, one XOR each), fourteen are general."""
    rng = np.random.default_rng(0)
    M = chip_smoke.smoke_matrices(rng)["reed_sol_van 3x8"]
    ms, by = chip_smoke.bound(M, 8 << 20)
    assert by == "bytes"
    assert ms == 11 * (8 << 20) / 3.35e12 * 1e3
    wide = rng.integers(1, 256, (32, 32), dtype=np.uint8)
    ms_w, by_w = chip_smoke.bound(wide, 8 << 20)
    assert by_w == "operations"
    assert ms_w > 64 * (8 << 20) / 3.35e12 * 1e3
    assert chip_smoke.bitterm_mix(M) == (10 + 23 * 14, 8 * 14)
    # 332 ALU operations per lane over 64 per clock on 132 SMs at 1.98 GHz
    floor = chip_smoke.bitterm_floor_ms(M, 8 << 20, 132, 1.98e9)
    assert floor == 332 * (2 << 20) / (64 * 132 * 1.98e9) * 1e3


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
