"""The port's jerasure (7 techniques), isa (2) and xor plugins, with
device=cpu, against the JAX package's plugins.

The JAX plugins run as their own tests run them on the CPU: backend
``jax`` (the XLA graphs; for the bit-matrix codes ScheduledXor's plain
graph with JAX_APPLY_MIN_BYTES = 0) and, for the exhaustive erasure
sweeps, the numpy backend.  The port's codecs are built around the JAX
codecs' matrices (ec.convert.codec_from_reference and
bitcode_from_reference) and run the kernels' plain versions, with the
bit-matrix codes' DEVICE_APPLY_MIN_BYTES at 0 so the small test chunks
take the device path.  Everything is integer: tolerance 0 (byte-exact).
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu import ec as ref_ec
from ceph_tpu_torch import ec
from ceph_tpu_torch.ec.bitmatrix_code import BitMatrixErasureCode
from ceph_tpu_torch.ec.convert import (bitcode_from_reference,
                                       codec_from_reference)
from ceph_tpu_torch.ops import ec_kernels

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

RNG = np.random.default_rng(1618)
CPU = torch.device("cpu")

MATRIX_CODES = [
    ("jerasure", {"technique": "reed_sol_van", "k": "5", "m": "3"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "5", "m": "2"}),
    ("jerasure", {"technique": "cauchy_orig", "k": "5", "m": "3"}),
    ("jerasure", {"technique": "cauchy_good", "k": "5", "m": "3"}),
    ("isa", {"technique": "reed_sol_van", "k": "5", "m": "3"}),
    ("isa", {"technique": "cauchy", "k": "5", "m": "3"}),
    ("xor", {"k": "4"}),
]
BIT_CODES = [
    {"technique": "liberation", "k": "5", "m": "2"},
    {"technique": "blaum_roth", "k": "4", "m": "2"},
    {"technique": "liber8tion", "k": "6", "m": "2"},
    {"technique": "liberation", "k": "3", "m": "2", "w": "5"},
    {"technique": "blaum_roth", "k": "3", "m": "2", "w": "4"},
]


def _ids(cases):
    return ["-".join([p[0], *p[1].values()] if isinstance(p, tuple)
                     else p.values()) for p in cases]


def _patterns(n, m):
    return [p for r in range(1, m + 1)
            for p in itertools.combinations(range(n), r)]


def _assert_maps_equal(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        assert np.array_equal(got[i], want[i]), i


@pytest.mark.parametrize("plugin,prof", MATRIX_CODES,
                         ids=_ids(MATRIX_CODES))
def test_matrix_plugins_equal_reference(plugin, prof):
    """encode against the JAX plugin's jax and numpy backends, then
    decode for every pattern of up to m erasures against the numpy
    backend and the original chunks (exact)."""
    ref = ref_ec.factory(plugin, dict(prof, backend="numpy"))
    ref_jax = ref_ec.factory(plugin, dict(prof, backend="jax"))
    port = codec_from_reference(plugin, prof, ref.matrix, device=CPU)
    assert port._backend == "torch" and port.device == CPU
    assert np.array_equal(port.matrix, ref_jax.matrix)
    assert port.get_flags() == ref.get_flags()
    assert (port.k, port.m) == (ref.k, ref.m)
    obj = RNG.integers(0, 256, port.k * 1000 + 13, dtype=np.uint8).tobytes()
    chunks = port.encode(obj)
    _assert_maps_equal(chunks, ref.encode(obj))
    _assert_maps_equal(chunks, ref_jax.encode(obj))
    for pat in _patterns(port.chunk_count, port.m):
        avail = {i: c for i, c in chunks.items() if i not in pat}
        got = port.decode(list(pat), avail)
        want = ref.decode(list(pat), avail)
        for i in pat:
            assert np.array_equal(got[i], want[i]), (pat, i)
            assert np.array_equal(got[i], chunks[i]), (pat, i)


def _bit_pair(prof):
    ref = ref_ec.factory("jerasure", dict(prof, backend="numpy"))
    port = bitcode_from_reference(prof, ref.bitmatrix, device=CPU)
    port.DEVICE_APPLY_MIN_BYTES = 0  # small test chunks take the device path
    return ref, port


@pytest.mark.parametrize("prof", BIT_CODES, ids=_ids(BIT_CODES))
def test_bit_codes_equal_reference(prof):
    """The bit-matrix codes: encode against the JAX plugin's jax backend
    (ScheduledXor) and numpy backend, then decode for every pattern of 1
    or 2 erasures against the numpy backend and the original chunks,
    and a few patterns against the jax backend (exact)."""
    ref, port = _bit_pair(prof)
    ref_jax = ref_ec.factory("jerasure", dict(prof, backend="jax"))
    ref_jax.JAX_APPLY_MIN_BYTES = 0
    assert np.array_equal(port.bitmatrix, ref_jax.bitmatrix)
    assert port.w == ref.w and port.get_flags() == ref.get_flags()
    assert port.get_minimum_granularity() == ref.get_minimum_granularity()
    for width in (1, 1000, 100_000):
        assert port.get_chunk_size(width) == ref.get_chunk_size(width)
    data = RNG.integers(0, 256, port.k * port.get_minimum_granularity() * 3
                        + 31, dtype=np.uint8).tobytes()
    before = ec_kernels.launch_counts()["plain"]
    chunks = port.encode(data)
    assert ec_kernels.launch_counts()["plain"] > before  # the device path
    _assert_maps_equal(chunks, ref.encode(data))
    _assert_maps_equal(chunks, ref_jax.encode(data))
    n = port.chunk_count
    for pat in _patterns(n, 2):
        avail = {i: c for i, c in chunks.items() if i not in pat}
        got = port.decode(list(pat), avail)
        want = ref.decode(list(pat), avail)
        for i in pat:
            assert np.array_equal(got[i], want[i]), (pat, i)
            assert np.array_equal(got[i], chunks[i]), (pat, i)
    for pat in [(0,), (1, port.k), (port.k, port.k + 1)]:
        avail = {i: c for i, c in chunks.items() if i not in pat}
        _assert_maps_equal(port.decode(list(pat), dict(avail)),
                           ref_jax.decode(list(pat), dict(avail)))
    assert port.host_applies == 0


def test_bit_code_device_path_equals_host_path():
    """The torch backend (the scheduled XOR in packet mode) and the
    numpy backend (host transposes) of the port give the same bytes, on
    chunks of many granules (exact)."""
    prof = {"technique": "liber8tion", "k": "6", "m": "2"}
    dev = ec.factory("jerasure", dict(prof, device="cpu"))
    host = ec.factory("jerasure", dict(prof, backend="numpy"))
    data = RNG.integers(0, 256, 300_000, dtype=np.uint8)
    chunks = dev.encode(data)
    _assert_maps_equal(chunks, host.encode(data))
    assert dev.host_applies == 0 and dev._xor_ops
    avail = {i: c for i, c in chunks.items() if i not in (2, 7)}
    _assert_maps_equal(dev.decode([2, 7], avail), host.decode([2, 7], avail))


def test_device_apply_error_propagates(monkeypatch):
    """An error in the device apply is not swallowed: encode raises, the
    next encode tries the device again and raises again, and nothing ran
    on the host."""
    _ref, port = _bit_pair(BIT_CODES[0])

    def boom(*_a, **_k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ec_kernels, "gf_sched_xor_lanes", boom)
    data = RNG.integers(0, 256, 5 * 448 * 2, dtype=np.uint8).tobytes()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            port.encode(data)
    assert port.host_applies == 0


def test_small_apply_stays_on_host_and_is_counted():
    """Below DEVICE_APPLY_MIN_BYTES an apply takes the host path: no
    scheduled-XOR op is built, no plain or kernel launch is made, and
    host_applies counts it."""
    assert BitMatrixErasureCode.DEVICE_APPLY_MIN_BYTES == 1 << 16
    ref = ref_ec.factory("jerasure", {"technique": "liber8tion", "k": "4",
                                      "m": "2", "backend": "numpy"})
    port = ec.factory("jerasure", {"technique": "liber8tion", "k": "4",
                                   "m": "2", "device": "cpu"})
    data = RNG.integers(0, 256, 4 * 512 * 4, dtype=np.uint8).tobytes()
    before = ec_kernels.launch_counts()
    chunks = port.encode(data)
    assert port.host_applies == 1
    have = {i: v for i, v in chunks.items() if i != 0}
    dec = port.decode([0], have)
    assert port.host_applies == 2
    assert not port._xor_ops
    assert ec_kernels.launch_counts() == before
    assert np.array_equal(dec[0], chunks[0])
    _assert_maps_equal(chunks, ref.encode(data))
    # the numpy backend is the host path by choice, not by the rule
    host = ec.factory("jerasure", {"technique": "liber8tion", "k": "4",
                                   "m": "2", "backend": "numpy"})
    host.encode(data)
    assert host.host_applies == 0 and host.device is None


@pytest.mark.parametrize("plugin,prof", [
    ("jerasure", {"technique": "reed_sol_van"}),
    ("jerasure", {"technique": "liberation", "k": "5", "m": "2"}),
    ("isa", {}), ("xor", {})])
def test_backend_default_and_native(plugin, prof):
    """Each plugin defaults to the torch backend on the card (no card
    here: construction raises); ``backend=native`` runs on the host with
    no device and gives the torch codec's bytes, and an explicit
    ``auto`` resolves to ``native``, as in the JAX package."""
    codec = ec.factory(plugin, dict(prof, device="cpu"))
    assert codec._backend == "torch" and codec.device == CPU
    host = ec.factory(plugin, dict(prof, backend="native", device="cpu"))
    assert host._backend == "native" and host.device is None
    assert ec.factory(plugin, dict(prof, backend="auto"))._backend == \
        "native"
    data = np.random.default_rng(9).integers(0, 256, 64 * 1024,
                                             dtype=np.uint8)
    want = codec.encode(data)
    got = host.encode(data)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[i], want[i]) for i in want)
    if not torch.cuda.is_available():
        with pytest.raises(ec.ErasureCodeError):
            ec.factory(plugin, dict(prof))


@pytest.mark.parametrize("prof", [
    {"technique": "reed_sol_van", "w": "16"},
    {"technique": "reed_sol_r6_op", "m": "3"},
    {"technique": "nope"},
    {"technique": "liberation", "m": "3"},
    {"technique": "liberation", "w": "6"},
    {"technique": "blaum_roth", "w": "5"},
    {"technique": "liber8tion", "w": "7"},
    {"technique": "liberation", "k": "8", "m": "2"},
])
def test_jerasure_refuses_what_the_reference_refuses(prof):
    with pytest.raises(Exception):
        ref_ec.factory("jerasure", dict(prof, backend="numpy"))
    with pytest.raises(ec.ErasureCodeError):
        ec.factory("jerasure", dict(prof, device="cpu"))


def test_isa_refuses_an_unknown_technique():
    with pytest.raises(ec.ErasureCodeError):
        ec.factory("isa", {"technique": "cauchy_good", "device": "cpu"})
    with pytest.raises(Exception):
        ref_ec.factory("isa", {"technique": "cauchy_good",
                               "backend": "numpy"})


def test_bitcode_from_reference_checks_its_input():
    ref = ref_ec.factory("jerasure", {"technique": "liberation", "k": "5",
                                      "m": "2", "backend": "numpy"})
    with pytest.raises(ec.ErasureCodeError):
        bitcode_from_reference({"technique": "reed_sol_van"},
                               ref.bitmatrix, device=CPU)
    with pytest.raises(ec.ErasureCodeError):
        bitcode_from_reference({"technique": "liberation", "k": "4",
                                "m": "2"}, ref.bitmatrix, device=CPU)


def test_registry_lists_the_new_plugins():
    for name in ("jerasure", "isa", "xor", "tpu"):
        ec.factory(name, {"device": "cpu"})
    assert {"jerasure", "isa", "xor", "tpu"} <= set(ec.registered())
