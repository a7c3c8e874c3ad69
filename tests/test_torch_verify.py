"""Folded CRC32C verify of the port (ceph_tpu_torch/ec/verify.py)
against the JAX package's CrcVerifier on the same seeded rows, some with
bit flips: the torch backend on the CPU device (the CRC kernel's plain
version) and the native sweep give the reference's digests exactly, and
the batcher's verify op folds concurrent scrubs into one launch."""

import threading

import numpy as np
import pytest
import torch

from ceph_tpu.ec.verify import CrcVerifier as JaxCrcVerifier
from ceph_tpu.ops.checksum import crc32c_extend_zeros
from ceph_tpu_torch import ec
from ceph_tpu_torch.ec.batcher import ECBatcher
from ceph_tpu_torch.ec.verify import CrcVerifier, verifier
from ceph_tpu_torch.ops import native

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def _rows(seed, n, L, flips=3):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (n, L), dtype=np.uint8)
    clean = rows.copy()
    for r in rng.choice(n, size=flips, replace=False):
        rows[r, rng.integers(0, L)] ^= np.uint8(1 << int(rng.integers(0, 8)))
    return clean, rows


@pytest.mark.parametrize("L", [512, 1028])
def test_digests_equal_reference_and_flag_flips(L):
    clean, rows = _rows(L, 12, L)
    want = JaxCrcVerifier("device").digests(rows)
    assert np.array_equal(want, JaxCrcVerifier("native").digests(rows))
    for v in (CrcVerifier("device", device="cpu"), CrcVerifier("native")):
        got = v.digests(rows)
        assert got.dtype == np.uint32
        assert np.array_equal(got, want)
    stored = np.array(native.crc32c_blocks(clean, L), dtype=np.uint32)
    flipped = np.nonzero(np.any(rows != clean, axis=1))[0]
    assert np.nonzero(want != stored)[0].tolist() == flipped.tolist()


def test_padded_rows_check_against_extended_digests():
    """Objects of other lengths ride one bucket padded with zeros; the
    expected digest of a padded row comes from the write-time digest by
    the zero-extension identity."""
    rng = np.random.default_rng(3)
    L = 8192
    lengths = [100, 4096, 5000, 8192]
    rows = np.zeros((len(lengths), L), dtype=np.uint8)
    expect = []
    for i, n in enumerate(lengths):
        blob = rng.integers(0, 256, n, dtype=np.uint8)
        rows[i, :n] = blob
        expect.append(crc32c_extend_zeros(native.crc32c(blob), L - n))
    got = CrcVerifier("device", device="cpu").digests(rows)
    assert got.tolist() == expect


def test_batcher_folds_concurrent_scrubs():
    _clean, a = _rows(1, 5, 1024)
    _clean, b = _rows(2, 3, 1024, flips=1)
    v = CrcVerifier("device", device="cpu")
    bat = ECBatcher(window_us=10_000_000, max_bytes=a.nbytes + b.nbytes)
    out = [None, None]

    def run(i, rows):
        out[i] = bat.verify(v, rows)

    ts = [threading.Thread(target=run, args=(0, a), daemon=True),
          threading.Thread(target=run, args=(1, b), daemon=True)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert np.array_equal(out[0], JaxCrcVerifier("native").digests(a))
    assert np.array_equal(out[1], JaxCrcVerifier("native").digests(b))
    assert bat.stats["launches"] == 1 and bat.stats["ops"] == 2


def test_modes_and_fold_sig():
    assert CrcVerifier("native").fold_sig() == ("crc32c", "native")
    assert CrcVerifier("device", device="cpu").fold_sig() == \
        ("crc32c", "torch")
    assert verifier("native") is verifier("native")
    with pytest.raises(ValueError):
        CrcVerifier("jax")
    with pytest.raises(ValueError):
        CrcVerifier("native").digests(np.zeros((1, 6), np.uint8))
    if not torch.cuda.is_available():
        assert CrcVerifier("auto").fold_sig() == ("crc32c", "native")
        with pytest.raises(RuntimeError):
            CrcVerifier("device")
    assert ec.verifier is verifier
