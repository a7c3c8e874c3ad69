"""DeviceArena of the port (ceph_tpu_torch/ec/arena.py) on the CPU
device against the JAX package's arena: the same sequence of puts, gets
and drops on the same seeded buffers leaves the same keys, the same byte
count and the same hit, miss and eviction counts, and returns the same
bytes (exact)."""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import arena as jax_arena
from ceph_tpu.utils.staging import stage_perf as jax_stage_perf
from ceph_tpu_torch.ec import arena
from ceph_tpu_torch.utils.staging import stage_perf

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

COUNTED = ("ec_arena_hits", "ec_arena_misses", "ec_arena_evictions",
           "ec_stage_h2d_copies", "ec_stage_h2d_bytes")


def _snapshot(pc):
    return {n: pc.get(n) for n in COUNTED}


def _play(a, pc, bufs):
    """A fixed script of puts, gets and drops; returns (log, counter
    deltas, keys left, bytes held)."""
    before = _snapshot(pc)
    log = []
    for i, b in enumerate(bufs):
        a.put(("obj", i), b)
    for key in (("obj", 0), ("obj", 5), ("obj", 2), ("nope", 0)):
        got = a.get(key)
        log.append(None if got is None else np.asarray(got).tobytes())
    a.put(("obj", 6), bufs[0].tobytes())  # bytes stage like arrays
    a.drop(("obj", 6))
    dropped = a.drop_where(lambda k: k[1] % 2 == 1)
    after = _snapshot(pc)
    keys = sorted(a._lru)
    return (log, dropped, {n: after[n] - before[n] for n in COUNTED},
            keys, a.nbytes)


def test_lru_budget_and_counters_equal_reference():
    rng = np.random.default_rng(7)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8)
            for n in (1000, 3000, 2000, 4000, 500, 2500)]
    budget = 8000
    ours = _play(arena.DeviceArena(budget, device="cpu"), stage_perf(),
                 bufs)
    ref = _play(jax_arena.DeviceArena(budget), jax_stage_perf(), bufs)
    assert ours == ref
    log, _dropped, deltas, keys, held = ours
    assert deltas["ec_arena_evictions"] > 0 and held <= budget
    assert log[3] is None and deltas["ec_arena_misses"] >= 1


def test_tensor_put_is_not_restaged_and_clear_empties():
    pc = stage_perf()
    a = arena.DeviceArena(1 << 20, device="cpu")
    t = torch.arange(64, dtype=torch.uint8)
    copies = pc.get("ec_stage_h2d_copies")
    assert a.put("t", t) is t
    assert pc.get("ec_stage_h2d_copies") == copies
    host = np.full(32, 7, np.uint8)
    dev = a.put("h", host)
    host[:] = 0  # the arena holds a copy, not a view of the caller's buffer
    assert dev.numpy().tolist() == [7] * 32
    assert a.nbytes == 96 and pc.get("ec_arena_bytes") == 96
    a.clear()
    assert a.nbytes == 0 and a.get("t") is None


def test_counter_names_equal_reference():
    assert arena.COUNTERS == jax_arena.COUNTERS
    assert arena.GAUGES == jax_arena.GAUGES


def test_cuda_arena_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        arena.DeviceArena()
