"""ctypes bindings for the io_uring half of libcephtpu.so
(native/uring_stack.cc) — the native backend behind UringStack.

Mirrors how ops/native.py binds the gf256 kernels, with one twist: the
uring object is itself build-gated (the Makefile skips it where
<linux/io_uring.h> is missing), so every symbol lookup is getattr-
guarded — a libcephtpu.so built without the object must read as
"unavailable", not AttributeError.  `probe()` additionally asks the
KERNEL (ct_uring_probe does a real io_uring_setup) so a seccomp filter
or a pre-5.1 kernel also reads as unavailable.
"""

from __future__ import annotations

import ctypes
import threading

u64p = ctypes.POINTER(ctypes.c_ulonglong)
i64p = ctypes.POINTER(ctypes.c_longlong)


class UringUnavailable(RuntimeError):
    pass


_LOCK = threading.Lock()
_LIB_RESULT: ctypes.CDLL | Exception | None = None


def lib() -> ctypes.CDLL:
    """The shared libcephtpu.so handle with the ct_uring_* prototypes
    declared; raises UringUnavailable (cached) when the .so cannot be
    built or was built without the uring object."""
    global _LIB_RESULT
    if _LIB_RESULT is not None:
        if isinstance(_LIB_RESULT, Exception):
            raise _LIB_RESULT
        return _LIB_RESULT
    with _LOCK:
        if _LIB_RESULT is not None:
            if isinstance(_LIB_RESULT, Exception):
                raise _LIB_RESULT
            return _LIB_RESULT
        try:
            _LIB_RESULT = _declare()
        except Exception as e:  # noqa: BLE001 - cache any load failure
            _LIB_RESULT = UringUnavailable(str(e))
            raise _LIB_RESULT
    return _LIB_RESULT


def _declare() -> ctypes.CDLL:
    from ..ops.native import NativeUnavailable, lib as native_lib
    try:
        L = native_lib()
    except NativeUnavailable as e:
        raise UringUnavailable(f"native library unavailable: {e}")
    if getattr(L, "ct_uring_probe", None) is None:
        raise UringUnavailable(
            "libcephtpu.so built without uring_stack.o "
            "(linux/io_uring.h missing at build time)")
    L.ct_uring_probe.restype = ctypes.c_int
    L.ct_uring_create.restype = ctypes.c_void_p
    L.ct_uring_create.argtypes = [ctypes.c_uint]
    L.ct_uring_destroy.restype = None
    L.ct_uring_destroy.argtypes = [ctypes.c_void_p]
    L.ct_uring_register_buffers.restype = ctypes.c_int
    L.ct_uring_register_buffers.argtypes = [
        ctypes.c_void_p, u64p, u64p, ctypes.c_uint]
    L.ct_uring_prep_sendmsg.restype = ctypes.c_int
    L.ct_uring_prep_sendmsg.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u64p, u64p, ctypes.c_uint,
        ctypes.c_ulonglong]
    L.ct_uring_prep_recv.restype = ctypes.c_int
    L.ct_uring_prep_recv.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int,
        ctypes.c_ulonglong]
    L.ct_uring_prep_nop.restype = ctypes.c_int
    L.ct_uring_prep_nop.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
    L.ct_uring_submit.restype = ctypes.c_int
    L.ct_uring_submit.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    L.ct_uring_reap.restype = ctypes.c_int
    L.ct_uring_reap.argtypes = [ctypes.c_void_p, u64p, i64p, ctypes.c_uint]
    return L


def available() -> bool:
    """True iff the extension is built AND the kernel grants a ring."""
    try:
        return lib().ct_uring_probe() == 0
    except UringUnavailable:
        return False


def unavailable_reason() -> str | None:
    """Why `available()` is False (None when it is True) — the logged
    fallback event wants the reason, not just the fact."""
    try:
        L = lib()
    except UringUnavailable as e:
        return str(e)
    rc = L.ct_uring_probe()
    if rc == 0:
        return None
    return f"io_uring_setup failed (errno {-rc})"
