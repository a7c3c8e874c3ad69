"""The port's ec_non_regression tool on the CPU against the archives of
corpus/, which the JAX package's tool wrote.

``--check --device cpu`` verifies the 15 directories of the port's grid,
which is the JAX package's (jerasure, isa, lrc, shec, clay and tpu), on
the torch backend and on the native one; ``--create`` into a temporary
directory reproduces the same 15 directories byte for byte.  corpus/ itself is
only read.  Byte comparisons: tolerance 0.
"""

import os

import pytest
import torch

from ceph_tpu.tools import ec_non_regression as ref_nr
from ceph_tpu_torch.tools import ec_non_regression as nr

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "corpus")


def _dirs(base):
    return [nr.config_dir(base, plugin, prof)
            for plugin, prof in nr.DEFAULT_GRID]


def test_grid_is_the_reference_grid_of_the_ported_plugins():
    assert len(nr.DEFAULT_GRID) == 15
    assert nr.DEFAULT_GRID == ref_nr.DEFAULT_GRID
    assert nr.STRIPE_WIDTH == ref_nr.STRIPE_WIDTH
    assert nr.payload(4096) == ref_nr.payload(4096)
    assert all(os.path.isdir(d) for d in _dirs(CORPUS))


@pytest.mark.parametrize("backend", [[], ["--backend", "native"]])
def test_check_passes_on_the_corpus(capsys, backend):
    assert nr.main(["--check", "--base", CORPUS, "--device", "cpu"]
                   + backend) == 0
    out = capsys.readouterr().out
    assert "all configurations byte-exact vs archive (15 directories)" \
        in out


def test_create_reproduces_the_corpus(tmp_path, capsys):
    base = str(tmp_path / "corpus")
    assert nr.main(["--create", "--base", base, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("archived ") == 15
    assert sorted(os.listdir(base)) == sorted(
        os.path.basename(d) for d in _dirs(CORPUS))
    for d in _dirs(CORPUS):
        mine = os.path.join(base, os.path.basename(d))
        assert sorted(os.listdir(mine)) == sorted(os.listdir(d))
        for f in os.listdir(d):
            with open(os.path.join(d, f), "rb") as a, \
                    open(os.path.join(mine, f), "rb") as b:
                assert a.read() == b.read(), (d, f)
    # and the port's own check accepts what it wrote
    assert nr.check(base, None, "cpu") == 0


def test_check_reports_a_drifted_chunk(tmp_path, capsys):
    """A flipped byte in one archived chunk fails the check."""
    base = str(tmp_path / "corpus")
    nr.create(base, None, "cpu")
    grid = [g for g in nr.DEFAULT_GRID
            if g[1].get("technique") == "liberation"]
    path = os.path.join(nr.config_dir(base, *grid[0]), "chunk.5")
    with open(path, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 1]))
    assert nr.check(base, None, "cpu", grid) == 1
    assert "PARITY DRIFT" in capsys.readouterr().err


def test_decode_check_drops_one_data_chunk_of_the_locality_codes(
        tmp_path, capsys):
    """The decode check erases chunk 0 of an lrc or shec archive (not
    MDS against every pattern of m) and the first m chunks of the
    others; a drifted decode of the shec archive is reported."""
    from ceph_tpu_torch.ec.general_code import GeneralMatrixCode

    base = str(tmp_path / "corpus")
    grid = [g for g in nr.DEFAULT_GRID if g[0] in ("shec", "clay")]
    nr.create(base, None, "cpu")
    seen = []
    real = GeneralMatrixCode.decode_chunks

    def spy(self, want, chunks):
        seen.append(list(want))
        out = real(self, want, chunks)
        return {i: c ^ 1 for i, c in out.items()}

    GeneralMatrixCode.decode_chunks = spy
    try:
        assert nr.check(base, None, "cpu", grid) == 1
    finally:
        GeneralMatrixCode.decode_chunks = real
    assert seen == [[0]]
    assert "DECODE DRIFT" in capsys.readouterr().err
    assert nr.check(base, None, "cpu", grid) == 0
