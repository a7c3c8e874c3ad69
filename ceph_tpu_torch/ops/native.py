"""ctypes binding of the port to the repo's native library
(``native/build/libcephtpu.so``), limited to what the port needs: the
host CRC32C (``crc32c``, ``crc32c_blocks``).

The port's own copy of the loading logic of the JAX package's
``ceph_tpu/ops/native.py``: the shared object is built with ``make -s``
in ``native/`` when it is missing or older than a source, under a
thread lock and a file lock (two processes of one checkout build once).
A failed build raises NativeUnavailable; nothing falls back to the
pure-Python ``checksum.crc32c_ref``.
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
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libcephtpu.so")
_LOCK = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _stale() -> bool:
    if not os.path.exists(_SO_PATH):
        return True
    so_m = os.path.getmtime(_SO_PATH)
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
    os.makedirs(os.path.join(_NATIVE_DIR, "build"), exist_ok=True)
    with open(os.path.join(_NATIVE_DIR, "build", ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if _stale():
            p = subprocess.run(["make", "-s"], cwd=_NATIVE_DIR,
                               capture_output=True, text=True)
            if p.returncode:
                raise NativeUnavailable(
                    f"native build failed (make exit {p.returncode}): "
                    f"{p.stderr or p.stdout}")
    L = ctypes.CDLL(_SO_PATH)
    L.ct_init.restype = ctypes.c_int
    L.ct_crc32c.restype = ctypes.c_uint32
    L.ct_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                            ctypes.c_size_t]
    L.ct_init()
    return L


def available() -> bool:
    try:
        lib()
        return True
    except NativeUnavailable:
        return False


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
