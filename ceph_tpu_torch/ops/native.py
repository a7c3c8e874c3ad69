"""ctypes binding of the port to the repo's native library
(``native/build/libcephtpu.so``): the GF(2^8) matrices and region
products of the ``native`` codec backend (``vandermonde_matrix``,
``cauchy_matrix``, ``cauchy_good_matrix``, ``mat_inv``,
``decode_matrix``, ``encode_region``, ``region_mac``,
``encode_region_ptrs``, ``lincomb_rows_ptrs``), the host checksums
(``crc32c``, ``crc32c_blocks``, ``xxhash32``, ``xxhash64``,
``checksummer``) and the messenger's cipher (``chacha20_xor``).

The port's own copy of the loading logic of the JAX package's
``ceph_tpu/ops/native.py``: the shared object is built from
``native/``'s sources with ``make -s BUILD=<dir>`` into the port's own
git-ignored ``ceph_tpu_torch/build/native/`` when it is missing or
older than a source, under a thread lock and a file lock (two processes
of one checkout build once, and none loads a library another is still
linking).  The port never writes ``native/build/``: the JAX package's
loader there takes no file lock, and a process of either package that
loads ``native/build/libcephtpu.so`` while another's ``make`` is still
linking it fails ("file too short") and keeps that failure for its
life.  A failed build raises NativeUnavailable; nothing falls back to
the pure-Python ``checksum.crc32c_ref``.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "native"))
#: where the port builds its copy of the library
_BUILD_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "build", "native"))
_LOCK = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def so_path() -> str:
    return os.path.join(_BUILD_DIR, "libcephtpu.so")


def _stale() -> bool:
    if not os.path.exists(so_path()):
        return True
    so_m = os.path.getmtime(so_path())
    return any(os.path.getmtime(os.path.join(_NATIVE_DIR, f)) > so_m
               for f in os.listdir(_NATIVE_DIR)
               if f.endswith((".cc", ".h")))


_LIB_RESULT: ctypes.CDLL | Exception | None = None


def lib() -> ctypes.CDLL:
    """Load (building if needed) the native library; a failure is kept
    too, so a broken toolchain does not run ``make`` on every call."""
    global _LIB_RESULT
    with _LOCK:
        if _LIB_RESULT is None:
            try:
                _LIB_RESULT = _load()
            except (OSError, subprocess.SubprocessError,
                    NativeUnavailable) as e:
                _LIB_RESULT = (e if isinstance(e, NativeUnavailable)
                               else NativeUnavailable(str(e)))
        if isinstance(_LIB_RESULT, Exception):
            raise _LIB_RESULT
        return _LIB_RESULT


def _load() -> ctypes.CDLL:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if _stale():
            p = subprocess.run(["make", "-s", f"BUILD={_BUILD_DIR}"],
                               cwd=_NATIVE_DIR, capture_output=True,
                               text=True)
            if p.returncode:
                raise NativeUnavailable(
                    f"native build failed (make exit {p.returncode}): "
                    f"{p.stderr or p.stdout}")
        L = ctypes.CDLL(so_path())
    u8p = ctypes.POINTER(ctypes.c_uint8)
    L.ct_init.restype = ctypes.c_int
    L.ct_gf_mul.restype = ctypes.c_uint8
    L.ct_gf_mul.argtypes = [ctypes.c_uint8, ctypes.c_uint8]
    L.ct_gf_inv.restype = ctypes.c_uint8
    L.ct_gf_inv.argtypes = [ctypes.c_uint8]
    for name in ("ct_vandermonde_matrix", "ct_cauchy_matrix",
                 "ct_cauchy_good_matrix"):
        fn = getattr(L, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, u8p]
    L.ct_mat_inv.restype = ctypes.c_int
    L.ct_mat_inv.argtypes = [ctypes.c_int, u8p, u8p]
    L.ct_decode_matrix.restype = ctypes.c_int
    L.ct_decode_matrix.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), u8p]
    L.ct_region_mac.restype = None
    L.ct_region_mac.argtypes = [u8p, u8p, ctypes.c_size_t, ctypes.c_uint8]
    L.ct_encode.restype = None
    L.ct_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p, u8p,
                            ctypes.c_size_t]
    L.ct_encode_ptrs.restype = None
    L.ct_encode_ptrs.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(u8p),
        ctypes.POINTER(u8p), ctypes.c_size_t]
    L.ct_lincomb_rows.restype = None
    L.ct_lincomb_rows.argtypes = [
        ctypes.POINTER(u8p), ctypes.POINTER(u8p), ctypes.POINTER(u8p),
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_int, ctypes.c_size_t]
    L.ct_crc32c.restype = ctypes.c_uint32
    L.ct_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                            ctypes.c_size_t]
    L.ct_xxhash32.restype = ctypes.c_uint32
    L.ct_xxhash32.argtypes = [ctypes.c_uint32, u8p, ctypes.c_size_t]
    L.ct_xxhash64.restype = ctypes.c_uint64
    L.ct_xxhash64.argtypes = [ctypes.c_uint64, u8p, ctypes.c_size_t]
    L.chacha20_xor.restype = None
    L.chacha20_xor.argtypes = [u8p, u8p, ctypes.c_uint32, u8p,
                               ctypes.c_uint64]
    L.ct_init()
    return L


def available() -> bool:
    try:
        lib()
        return True
    except NativeUnavailable:
        return False


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def vandermonde_matrix(k: int, m: int) -> np.ndarray:
    out = np.empty((m, k), dtype=np.uint8)
    if lib().ct_vandermonde_matrix(k, m, _u8p(out)) != 0:
        raise ValueError(f"bad (k={k}, m={m})")
    return out


def cauchy_matrix(k: int, m: int) -> np.ndarray:
    out = np.empty((m, k), dtype=np.uint8)
    if lib().ct_cauchy_matrix(k, m, _u8p(out)) != 0:
        raise ValueError(f"bad (k={k}, m={m})")
    return out


def cauchy_good_matrix(k: int, m: int) -> np.ndarray:
    out = np.empty((m, k), dtype=np.uint8)
    if lib().ct_cauchy_good_matrix(k, m, _u8p(out)) != 0:
        raise ValueError(f"bad (k={k}, m={m})")
    return out


def mat_inv(A: np.ndarray) -> np.ndarray:
    A = np.ascontiguousarray(A, dtype=np.uint8)
    n = A.shape[0]
    out = np.empty((n, n), dtype=np.uint8)
    if lib().ct_mat_inv(n, _u8p(A), _u8p(out)) != 0:
        raise np.linalg.LinAlgError("singular")
    return out


def decode_matrix(C: np.ndarray, k: int,
                  available_ids: list[int]) -> np.ndarray:
    C = np.ascontiguousarray(C, dtype=np.uint8)
    m = C.shape[0]
    if not (0 < k <= 256 and k + m <= 256):
        raise ValueError(f"bad (k={k}, m={m})")
    if len(available_ids) < k:
        raise ValueError(f"need >= {k} available chunk ids")
    if any(not 0 <= i < k + m for i in available_ids[:k]):
        raise ValueError(f"chunk id out of range in {available_ids[:k]}")
    avail = (ctypes.c_int * k)(*available_ids[:k])
    out = np.empty((k, k), dtype=np.uint8)
    if lib().ct_decode_matrix(_u8p(C), k, m, avail, _u8p(out)) != 0:
        raise np.linalg.LinAlgError("singular decode set")
    return out


def encode_region(G: np.ndarray, data: np.ndarray) -> np.ndarray:
    """parity (m, L) = G (m, k) @ data (k, L) over GF(2^8), on the host
    (AVX2 where the CPU has it)."""
    G = np.ascontiguousarray(G, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, k = G.shape
    if data.ndim != 2 or data.shape[0] != k:
        raise ValueError(f"expected ({k}, L) data, got {data.shape}")
    L = data.shape[1]
    parity = np.empty((m, L), dtype=np.uint8)
    lib().ct_encode(_u8p(G), m, k, _u8p(data), _u8p(parity), L)
    return parity


def region_mac(dst: np.ndarray, src: np.ndarray, coef: int) -> None:
    """dst ^= coef * src over GF(2^8), in place.  Both must be uint8."""
    if dst.dtype != np.uint8 or src.dtype != np.uint8:
        raise TypeError("region_mac requires uint8 arrays")
    if not (dst.flags.c_contiguous and src.flags.c_contiguous):
        raise ValueError("region_mac requires contiguous arrays")
    if src.size < dst.size:
        raise ValueError(f"src ({src.size}) shorter than dst ({dst.size})")
    lib().ct_region_mac(_u8p(dst), _u8p(src), dst.size, coef)


def encode_region_ptrs(G: np.ndarray, rows: list[np.ndarray],
                       L: int) -> np.ndarray:
    """Like encode_region, but gathering the input rows by pointer (the
    decode path's shape, where survivor chunks live in separate
    buffers)."""
    G = np.ascontiguousarray(G, dtype=np.uint8)
    m, k = G.shape
    if len(rows) < k:
        raise ValueError(f"need {k} input rows")
    for r in rows[:k]:
        if r.dtype != np.uint8 or not r.flags.c_contiguous or r.size < L:
            raise ValueError("rows must be contiguous uint8 of >= L bytes")
    out = np.empty((m, L), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    in_ptrs = (u8p * k)(*[_u8p(r) for r in rows[:k]])
    out_ptrs = (u8p * m)(*[_u8p(out[i]) for i in range(m)])
    lib().ct_encode_ptrs(_u8p(G), m, k, in_ptrs, out_ptrs, L)
    return out


def lincomb_rows_ptrs(dst_ptrs: np.ndarray, a_ptrs: np.ndarray,
                      b_ptrs: np.ndarray | None,
                      ca: int, cb: int, L: int) -> None:
    """dst[i] = ca * a[i] ^ cb * b[i] over GF(2^8) for L-byte rows given
    as address arrays (base + offset computed with numpy on buffers
    that outlive the call): one ctypes cast a call instead of one a
    row.  ``b_ptrs`` None drops the second term."""
    n = len(dst_ptrs)
    if n == 0:
        return
    u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    d = np.ascontiguousarray(dst_ptrs, dtype=np.uint64)
    a = np.ascontiguousarray(a_ptrs, dtype=np.uint64)
    bp = None
    if b_ptrs is not None:
        b = np.ascontiguousarray(b_ptrs, dtype=np.uint64)
        bp = b.ctypes.data_as(u8pp)
    lib().ct_lincomb_rows(d.ctypes.data_as(u8pp), a.ctypes.data_as(u8pp),
                          bp, ca, cb, n, L)


def _bytes_of(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)


def crc32c(data, crc: int = 0) -> int:
    """Standard CRC-32C (init and final xor 0xFFFFFFFF folded in;
    chainable by passing a previous result as ``crc``)."""
    a = _bytes_of(data)
    return int(lib().ct_crc32c(ctypes.c_uint32(crc).value, a.ctypes.data,
                               a.size))


def crc32c_blocks(data, block: int, crc: int = 0) -> list[int]:
    """Per-block CRC-32C over one contiguous buffer, one pointer marshal
    for the whole buffer; the tail block may be short."""
    a = _bytes_of(data)
    fn = lib().ct_crc32c
    base = a.ctypes.data
    seed = ctypes.c_uint32(crc).value
    return [int(fn(seed, base + off, min(block, a.size - off)))
            for off in range(0, a.size, block)]


def xxhash32(data, seed: int = 0) -> int:
    """XXH32 (the public xxHash spec)."""
    a = _bytes_of(data)
    return int(lib().ct_xxhash32(ctypes.c_uint32(seed).value, _u8p(a),
                                 a.size))


def xxhash64(data, seed: int = 0) -> int:
    """XXH64 (the public xxHash spec)."""
    a = _bytes_of(data)
    return int(lib().ct_xxhash64(ctypes.c_uint64(seed).value, _u8p(a),
                                 a.size))


CSUM_FUNCS = {"crc32c": crc32c, "xxhash32": xxhash32, "xxhash64": xxhash64}


def checksummer(kind: str):
    """The checksum function of a family by name (crc32c, xxhash32,
    xxhash64)."""
    try:
        return CSUM_FUNCS[kind]
    except KeyError:
        raise ValueError(f"unknown checksum {kind!r}") from None


def chacha20_xor(key: bytes, nonce: bytes, data: bytes,
                 counter: int = 0) -> bytes:
    """ChaCha20 keystream XOR (RFC 8439): encrypt == decrypt."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("chacha20 wants a 32-byte key, 12-byte nonce")
    buf = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    k = np.frombuffer(key, dtype=np.uint8)
    n = np.frombuffer(nonce, dtype=np.uint8)
    if buf.size:
        lib().chacha20_xor(_u8p(k), _u8p(n), counter, _u8p(buf), buf.size)
    return buf.tobytes()
