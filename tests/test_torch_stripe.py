"""Stripe geometry + write-plan tests (the TestECUtil tier), on the port:
the JAX package's tests/test_stripe.py on ceph_tpu_torch."""

import numpy as np
import pytest

from ceph_tpu_torch.ec.interface import Flags
from ceph_tpu_torch.ec.stripe import StripeInfo, plan_write

SI = StripeInfo(k=4, m=2, chunk_size=4096)


def test_geometry_basics():
    assert SI.stripe_width == 16384
    assert SI.chunk_count == 6
    with pytest.raises(ValueError):
        StripeInfo(4, 2, 1000)  # not page aligned


def test_ro_shard_roundtrip():
    for ro in [0, 1, 4095, 4096, 16383, 16384, 100_000]:
        shard, soff = SI.ro_to_shard(ro)
        assert 0 <= shard < 4
        assert SI.shard_to_ro(shard, soff) == ro


def test_ro_to_shard_layout():
    # first stripe row: bytes [0,4096) -> shard0, [4096,8192) -> shard1 ...
    assert SI.ro_to_shard(0) == (0, 0)
    assert SI.ro_to_shard(4096) == (1, 0)
    assert SI.ro_to_shard(12288 + 5) == (3, 5)
    # second stripe row continues each shard at offset 4096
    assert SI.ro_to_shard(16384) == (0, 4096)


def test_chunk_mapping_permutation():
    si = StripeInfo(2, 1, 4096, chunk_mapping=(2, 0, 1))
    assert si.shard_of(0) == 2
    assert si.raw_of(2) == 0
    shard, off = si.ro_to_shard(0)
    assert shard == 2
    assert si.shard_to_ro(2, off) == 0
    with pytest.raises(ValueError):
        StripeInfo(2, 1, 4096, chunk_mapping=(0, 0, 1))


def test_range_to_shard_extents():
    ext = SI.ro_range_to_shard_extents(2048, 8192)  # spans shards 0,1,2
    assert set(ext) == {0, 1, 2}
    assert list(ext[0]) == [(2048, 4096)]
    assert list(ext[1]) == [(0, 4096)]
    assert list(ext[2]) == [(0, 2048)]
    # a range spanning stripe rows touches the same shard twice
    ext2 = SI.ro_range_to_shard_extents(0, SI.stripe_width + 4096)
    assert list(ext2[0]) == [(0, 8192)]


def test_aligned_ro_range():
    assert SI.aligned_ro_range(100, 10) == (0, 16384)
    assert SI.aligned_ro_range(16384, 16384) == (16384, 16384)
    assert SI.aligned_ro_range(16000, 1000) == (0, 32768)


def test_plan_full_stripe():
    p = plan_write(SI, 0, 0, SI.stripe_width, Flags.NONE)
    assert p.mode == "full_stripe" and not p.read_extents
    # append into rows holding NO live data is read-free
    p = plan_write(SI, 16384, 16384, 100, Flags.NONE)
    assert p.mode == "full_stripe" and not p.read_extents


def test_plan_append_into_live_row_reads():
    """An append landing mid-row where live data exists must NOT be
    read-free: the row's existing bytes feed the re-encode."""
    p = plan_write(SI, 1000, 4096, 100, Flags.NONE)
    assert p.mode == "rmw"
    # row 0 minus the written extent [0,100) on shard 1
    total_read = sum(iv.size() for iv in p.read_extents.values())
    assert total_read == SI.stripe_width - 100
    assert list(p.read_extents[1]) == [(100, 4096)]
    assert list(p.read_extents[0]) == [(0, 4096)]


def test_plan_parity_delta_vs_rmw():
    delta_flags = Flags.PARITY_DELTA_OPTIMIZATION
    p = plan_write(SI, 100_000, 4096, 100, delta_flags)
    assert p.mode == "parity_delta"
    assert set(p.read_extents) == {1}
    assert list(p.read_extents[1]) == [(0, 100)]
    p2 = plan_write(SI, 100_000, 4096, 100, Flags.NONE)
    assert p2.mode == "rmw"
    # rmw reads exactly the rest of the affected stripe row
    assert set(p2.read_extents) == {0, 1, 2, 3}
    assert list(p2.read_extents[1]) == [(100, 4096)]
    assert list(p2.read_extents[0]) == [(0, 4096)]
    total_read = sum(iv.size() for iv in p2.read_extents.values())
    assert total_read == SI.stripe_width - 100
