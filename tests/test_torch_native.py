"""The port's binding of the native library (ceph_tpu_torch/ops/native.py)
against the JAX package's (ceph_tpu/ops/native.py) on the same seeded
inputs, and the ``native`` codec backend of the matrix codes: an
explicit ``auto`` resolves to it, the matrix-code corpus directories
come out of it byte for byte, and its parity delta matches the JAX
package's.  Every comparison is byte-exact (tolerance 0).  The port
builds its copy of the library in its own build directory, under a
file lock."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ceph_tpu import ec as ref_ec
from ceph_tpu.ops import gf256 as ref_gf
from ceph_tpu.ops import native as ref_native
from ceph_tpu_torch import ec
from ceph_tpu_torch.ops import gf256, native
from ceph_tpu_torch.tools import ec_non_regression as nr

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "corpus")


def _rng(seed=7):
    return np.random.default_rng(seed)


def test_library_loads_and_scalars_match():
    assert native.available()
    L = native.lib()
    rng = _rng()
    for a, b in rng.integers(0, 256, (500, 2)):
        assert L.ct_gf_mul(int(a), int(b)) == int(gf256.gf_mul(a, b))
    assert [L.ct_gf_inv(a) for a in range(1, 256)] == \
        [int(gf256.gf_inv(a)) for a in range(1, 256)]


@pytest.mark.parametrize("k,m", [(2, 1), (8, 3), (8, 4), (10, 4)])
def test_matrices_match_the_reference_binding(k, m):
    for name in ("vandermonde_matrix", "cauchy_matrix",
                 "cauchy_good_matrix"):
        got = getattr(native, name)(k, m)
        assert got.dtype == np.uint8 and got.shape == (m, k)
        assert np.array_equal(got, getattr(ref_native, name)(k, m))
        assert np.array_equal(got, getattr(gf256, name)(k, m))


def test_bad_geometry_raises_as_the_reference():
    for fn in (native.vandermonde_matrix, ref_native.vandermonde_matrix,
               native.cauchy_matrix, ref_native.cauchy_matrix):
        with pytest.raises(ValueError):
            fn(200, 100)
    C = gf256.cauchy_matrix(4, 2)
    for mod in (native, ref_native):
        with pytest.raises(ValueError):
            mod.decode_matrix(C, 4, [0, 1, 2, 99])
        with pytest.raises(ValueError):
            mod.decode_matrix(C, 4, [0, 1])


def test_mat_inv_matches_the_reference():
    rng = _rng(3)
    for n in (2, 4, 8, 12):
        for _ in range(4):
            A = rng.integers(0, 256, (n, n)).astype(np.uint8)
            try:
                want = ref_native.mat_inv(A)
            except np.linalg.LinAlgError:
                with pytest.raises(np.linalg.LinAlgError):
                    native.mat_inv(A)
                continue
            assert np.array_equal(native.mat_inv(A), want)
            assert np.array_equal(want, ref_gf.gf_mat_inv(A))
    A = np.array([[1, 2], [1, 2]], dtype=np.uint8)
    with pytest.raises(np.linalg.LinAlgError):
        native.mat_inv(A)


@pytest.mark.parametrize("available", [[0, 2, 4, 5, 6, 7, 8, 10],
                                       [3, 4, 5, 6, 7, 8, 9, 10]])
def test_decode_matrix_matches_and_reconstructs(available):
    k, m, L = 8, 3, 4096
    C = gf256.cauchy_good_matrix(k, m)
    data = _rng(5).integers(0, 256, (k, L)).astype(np.uint8)
    stack = np.concatenate([data, native.encode_region(C, data)])
    D = native.decode_matrix(C, k, available)
    assert np.array_equal(D, ref_native.decode_matrix(C, k, available))
    assert np.array_equal(D, gf256.decode_matrix(C, k, available))
    assert np.array_equal(native.encode_region(D, stack[available]), data)


@pytest.mark.parametrize("L", [1, 63, 64, 4095, 4096, 100_001])
def test_encode_region_matches_at_odd_and_even_lengths(L):
    rng = _rng(L)
    for k, m in ((8, 3), (5, 2)):
        G = rng.integers(0, 256, (m, k)).astype(np.uint8)
        data = rng.integers(0, 256, (k, L)).astype(np.uint8)
        got = native.encode_region(G, data)
        assert np.array_equal(got, ref_native.encode_region(G, data))
        assert np.array_equal(got, gf256.encode_region(G, data))


def test_region_mac_matches_and_validates():
    rng = _rng(11)
    for L in (1, 33, 4096, 65537):
        src = rng.integers(0, 256, L).astype(np.uint8)
        base = rng.integers(0, 256, L).astype(np.uint8)
        for coef in (0, 1, 2, 0x8E, 255):
            a, b = base.copy(), base.copy()
            native.region_mac(a, src, coef)
            ref_native.region_mac(b, src, coef)
            assert np.array_equal(a, b)
            assert np.array_equal(a, base ^ gf256.gf_mul(np.uint8(coef),
                                                         src))
    dst = np.zeros(64, dtype=np.uint8)
    with pytest.raises(ValueError):
        native.region_mac(dst, np.zeros(16, dtype=np.uint8), 3)
    with pytest.raises(TypeError):
        native.region_mac(np.zeros(8), np.zeros(8), 2)
    with pytest.raises(ValueError):
        native.region_mac(dst[::2], np.zeros(64, dtype=np.uint8), 3)


def test_encode_region_ptrs_gathers_separate_rows():
    rng = _rng(13)
    k, m, L = 6, 2, 8192
    C = gf256.cauchy_matrix(k, m)
    rows = [np.ascontiguousarray(rng.integers(0, 256, L + 7)
                                 .astype(np.uint8)) for _ in range(k)]
    got = native.encode_region_ptrs(C, rows, L)
    assert np.array_equal(got, ref_native.encode_region_ptrs(C, rows, L))
    assert np.array_equal(got, gf256.encode_region(
        C, np.stack([r[:L] for r in rows])))
    with pytest.raises(ValueError):
        native.encode_region_ptrs(C, rows[:3], L)
    with pytest.raises(ValueError):
        native.encode_region_ptrs(C, rows, L + 8)


@pytest.mark.parametrize("with_b", [False, True])
def test_lincomb_rows_ptrs_matches_on_int64_addresses(with_b):
    """dst[i] = ca*a[i] ^ cb*b[i] over rows addressed as base + offset,
    the offsets computed in int64 numpy arithmetic as CLAY does, on
    buffers that outlive the call."""
    rng = _rng(17 + with_b)
    n, L = 40, 96
    A = rng.integers(0, 256, (n, L)).astype(np.uint8)
    B = rng.integers(0, 256, (n, L)).astype(np.uint8)
    order = rng.permutation(n).astype(np.int64)
    ca, cb = 0x1D, 0x53
    outs = []
    for mod in (native, ref_native):
        D = np.zeros((n, L), dtype=np.uint8)
        d = D.ctypes.data + np.arange(n, dtype=np.int64) * L
        a = A.ctypes.data + order * L
        b = B.ctypes.data + order[::-1] * L if with_b else None
        mod.lincomb_rows_ptrs(d, a, b, ca, cb, L)
        outs.append(D)
    assert np.array_equal(outs[0], outs[1])
    want = gf256.gf_mul(np.uint8(ca), A[order])
    if with_b:
        want = want ^ gf256.gf_mul(np.uint8(cb), B[order[::-1]])
    assert np.array_equal(outs[0], want)
    native.lincomb_rows_ptrs(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             None, 1, 0, L)  # no rows: nothing to do


@pytest.mark.parametrize("n", [0, 1, 31, 32, 1000, 65537])
def test_hashes_and_checksummer_match(n):
    data = _rng(n).integers(0, 256, n).astype(np.uint8).tobytes()
    for seed in (0, 0x9747B28C):
        assert native.xxhash32(data, seed) == \
            ref_native.xxhash32(data, seed)
        assert native.xxhash64(data, seed) == \
            ref_native.xxhash64(data, seed)
    for kind in ("crc32c", "xxhash32", "xxhash64"):
        assert native.checksummer(kind)(data) == \
            ref_native.checksummer(kind)(data)
    assert native.crc32c(data) == ref_native.crc32c(data)
    with pytest.raises(ValueError):
        native.checksummer("md5")


def test_xxhash_known_vectors():
    assert native.xxhash32(b"") == 0x02CC5D05
    assert native.xxhash64(b"") == 0xEF46DB3751D8E999


@pytest.mark.parametrize("n", [0, 1, 64, 1000])
def test_chacha20_xor_matches_and_round_trips(n):
    rng = _rng(n + 1)
    key = rng.integers(0, 256, 32).astype(np.uint8).tobytes()
    nonce = rng.integers(0, 256, 12).astype(np.uint8).tobytes()
    data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
    for counter in (0, 7):
        enc = native.chacha20_xor(key, nonce, data, counter)
        assert enc == ref_native.chacha20_xor(key, nonce, data, counter)
        assert native.chacha20_xor(key, nonce, enc, counter) == data
    with pytest.raises(ValueError):
        native.chacha20_xor(key[:16], nonce, data)


def test_chacha20_rfc8439_vector():
    """RFC 8439 section 2.4.2: the first bytes of the sunscreen text."""
    key = bytes(range(32))
    nonce = bytes.fromhex("000000000000004a00000000")
    text = (b"Ladies and Gentlemen of the class of '99: If I could offer "
            b"you only one tip for the future, sunscreen would be it.")
    assert native.chacha20_xor(key, nonce, text, 1)[:16].hex() == \
        "6e2e359a2568f98041ba0728dd0d6981"


#: the corpus grid's GF(2^8) matrix-code configurations of the jerasure
#: and isa plugins
MATRIX_GRID = [(p, prof) for p, prof in nr.DEFAULT_GRID
               if p in ("jerasure", "isa")
               and prof.get("technique") not in
               ("liberation", "blaum_roth", "liber8tion")]


def test_auto_resolves_to_native():
    from ceph_tpu_torch.ec.matrix_code import _pick_backend

    assert _pick_backend("auto") == "native"
    for plugin, prof in MATRIX_GRID:
        codec = ec.factory(plugin, dict(prof, backend="auto"))
        assert codec._backend == "native" and codec.device is None
        ref = ref_ec.factory(plugin, dict(prof, backend="auto"))
        assert ref._backend == codec._backend
    with pytest.raises(ec.ErasureCodeError):
        ec.factory("isa", {"backend": "jax"})


def test_matrix_grid_on_native_gives_the_archived_bytes():
    assert len(MATRIX_GRID) == 7
    assert nr.check(CORPUS, "native", "cpu", MATRIX_GRID) == 0


@pytest.mark.parametrize("plugin,prof", MATRIX_GRID)
def test_native_codec_equals_the_reference_native_codec(plugin, prof):
    """Encode, every decode of one and two erasures, and the parity
    delta of a data shard: the port's native codec against the JAX
    package's, byte for byte."""
    codec = ec.factory(plugin, dict(prof, backend="native"))
    ref = ref_ec.factory(plugin, dict(prof, backend="native"))
    rng = _rng(int(prof["k"]) * 10 + int(prof["m"]))
    L = 3000
    data = rng.integers(0, 256, (codec.k, L)).astype(np.uint8)
    parity = codec.encode_chunks(data)
    assert np.array_equal(parity, ref.encode_chunks(data))
    full = {i: data[i] for i in range(codec.k)}
    full.update({codec.k + j: parity[j] for j in range(codec.m)})
    n = codec.chunk_count
    pairs = [(0, n - 1), (1, 2)] if codec.m > 1 else []
    for erased in [(i,) for i in range(n)] + pairs:
        avail = {i: c for i, c in full.items() if i not in erased}
        got = codec.decode(list(erased), avail)
        want = ref.decode(list(erased), avail)
        for i in erased:
            assert np.array_equal(got[i], want[i])
            assert np.array_equal(got[i], full[i])
    new = rng.integers(0, 256, L).astype(np.uint8)
    delta = codec.encode_delta(data[1], new)
    mine = {codec.k + j: parity[j].copy() for j in range(codec.m)}
    theirs = {codec.k + j: parity[j].copy() for j in range(codec.m)}
    codec.apply_delta(delta, 1, mine)
    ref.apply_delta(delta, 1, theirs)
    data[1] = new
    fresh = codec.encode_chunks(data)
    for j in range(codec.m):
        assert np.array_equal(mine[codec.k + j], theirs[codec.k + j])
        assert np.array_equal(mine[codec.k + j], fresh[j])


def test_native_delta_goes_through_region_mac(monkeypatch):
    """On the native backend apply_delta is the library's region_mac,
    on the others the numpy product; both give the same bytes."""
    calls = []
    real = native.region_mac

    def counted(dst, src, coef):
        calls.append(coef)
        return real(dst, src, coef)

    monkeypatch.setattr(native, "region_mac", counted)
    rng = _rng(23)
    delta = rng.integers(0, 256, 512).astype(np.uint8)
    bufs = []
    for backend in ("native", "numpy"):
        codec = ec.factory("isa", {"k": "4", "m": "2", "backend": backend})
        parity = {4: np.zeros(512, np.uint8), 5: np.zeros(512, np.uint8)}
        codec.apply_delta(delta, 2, parity)
        bufs.append(parity)
    assert len(calls) == 2
    assert all(np.array_equal(bufs[0][i], bufs[1][i]) for i in (4, 5))


# ------------------------------------------------------------ the build
_LOAD_CHILD = r"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("port_native", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._BUILD_DIR = sys.argv[2]
try:
    print("ok", mod.lib()._name)
except Exception as e:
    print("FAIL", e)
"""


def test_the_port_builds_its_own_copy_of_the_library():
    """The port loads a library built into its own git-ignored build
    directory, never native/build/, which the JAX package's loader
    builds and reads without a file lock."""
    path = native.so_path()
    assert path == os.path.join(os.path.dirname(CORPUS), "ceph_tpu_torch",
                                "build", "native", "libcephtpu.so")
    assert native.lib()._name == path
    assert "native/build" not in path


def test_concurrent_first_loads_see_a_whole_library(tmp_path):
    """Six processes load the port's library at once from an empty build
    directory: one builds it under the file lock and every one loads
    the finished library ("file too short" was the failure of a process
    that read a library another was still linking)."""
    src = os.path.abspath(native.__file__)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOAD_CHILD, src, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert [o.split()[0] for o, _ in outs] == ["ok"] * 6, outs
    assert os.path.exists(tmp_path / "libcephtpu.so")
