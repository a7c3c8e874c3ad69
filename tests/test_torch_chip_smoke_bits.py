"""Rehearsal of chip_smoke.py's bit-matrix path on the CPU at a small
size: the bit-matrix techniques' encode and every 1- or 2-erasure decode
through the plugin, the ec_benchmark CLI for them and for isa, and the
bit-matrix corpus directories with the device-apply size rule at 0, all
with device=cpu, where the wrappers run the plain versions.  On the card
the same code must launch gf_sched_xor and never a plain version; here
the counts show the opposite, which check_main_path must refuse.  Byte
checks inside the phases compare exactly (tolerance 0)."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from ceph_tpu_torch.ec.bitmatrix_code import BitMatrixErasureCode  # noqa: E402

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def test_bit_path_rehearsal_on_cpu(capsys):
    counts, host_applies = chip_smoke.bit_path(
        torch.device("cpu"), np.random.default_rng(5), size=256 << 10,
        cli_size=1 << 20, iterations=1)
    out = capsys.readouterr().out
    assert out.count("patterns of 1 or 2 erasures, byte-exact") == 3
    assert "all 28 patterns" in out and "all 36 patterns" in out
    assert "--plugin isa" in out
    assert "all configurations byte-exact vs archive (3 directories)" in out
    assert host_applies == 0
    assert BitMatrixErasureCode.DEVICE_APPLY_MIN_BYTES == 1 << 16
    assert counts["plain"] > 0 and counts["gf_sched_xor"] == 0
    with pytest.raises(AssertionError, match="gf_sched_xor never launched"):
        chip_smoke.check_main_path(counts, (chip_smoke.SCHED_KERNEL[1],))


def test_sched_bound_counts_bytes_and_ones():
    """K3's bound is the function's: (C + R) L bytes at 3.35 TB/s against
    an AND and an XOR per one of B per bit column at the int8 rate.  The
    liberation k=5 encode at an 80 MiB object's packet-row length is
    bound by bytes; a dense 16x256 matrix at the same length is too."""
    codec = chip_smoke.bit_codec("liberation", 5, backend="numpy")
    B = codec.bitmatrix
    L = chip_smoke.BIT_CLI_L
    assert codec.get_chunk_size(80 << 20) == 7 * L
    assert int(B.sum()) == 74
    t_bytes, t_ops = chip_smoke.sched_bound_parts(B, L)
    assert t_bytes == 49 * L / 3.35e12 * 1e3
    assert t_ops == 2 * 74 * 8 * L / 1979e12 * 1e3
    assert chip_smoke.bound(B, L, chip_smoke.sched_bound_parts) == \
        (t_bytes, "bytes")
    dense = np.ones((16, 256), np.uint8)
    ms, by = chip_smoke.bound(dense, L, chip_smoke.sched_bound_parts)
    assert by == "bytes" and ms == 272 * L / 3.35e12 * 1e3


def test_oracle_granules_cover_first_spread_and_last():
    assert list(chip_smoke.oracle_granules(37)) == list(range(37))
    g = chip_smoke.oracle_granules(37450)
    assert g[0] == 0 and g[-1] == 37449 and len(g) == 65
    assert np.all(np.diff(g) > 0) and np.diff(g).max() <= 37450 // 64 + 1


def test_packet_mode_check_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's packet-mode check, run with device=cpu on 1 MiB
    objects: every case passes on the plain version, and a kernel that
    flips one byte is caught (tolerance 0)."""
    from ceph_tpu_torch.ops import ec_kernels

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    gen = torch.Generator()
    gen.manual_seed(11)
    cpu = torch.device("cpu")
    cases, err = chip_smoke.check_packet_mode(cpu, gen, 1 << 20)
    assert (cases, err) == (4 * len(chip_smoke.PACKET_CASES), 0)
    call = ec_kernels.ScheduledXor.__call__

    def flipped(self, data, **kw):
        out = call(self, data, **kw).clone()
        out[0, -1] ^= 1
        return out

    monkeypatch.setattr(ec_kernels.ScheduledXor, "__call__", flipped)
    with pytest.raises(AssertionError, match="plain version"):
        chip_smoke.check_packet_mode(cpu, gen, 1 << 20)
