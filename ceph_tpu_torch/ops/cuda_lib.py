"""Build and load the port's hand-written CUDA kernels (``csrc/``: the
region kernels of gf_region.cu, the binary tensor-core region product of
gf_bitmm.cu and the CRC32C kernel of crc32c.cu).

Each source compiles with its own ``nvcc`` for Hopper (``sm_90a``), all
started together, and one more ``nvcc`` links the objects into
``build/libceph_tpu_torch.so``, a shared library with a plain C interface
that ctypes loads.  The build happens at first use, under a lock (a
thread lock and a file lock, so concurrent processes of one checkout
build once), and again whenever a source or header in ``csrc/`` is
newer than the library — the same staleness rule as the JAX package's
``ops/native.py`` applies to ``native/``.

Every C entry returns its ``cudaGetLastError()``; ``check`` raises
``CudaKernelError`` when that is not 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

#: the CUDA sources of the library, csrc/<name>.cu
SOURCES = ("gf_region", "gf_bitmm", "crc32c")
LIBRARY = "ceph_tpu_torch"

#: flags of every compile; NVCC_FLAGS builds a shared library in one step
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_FLAGS = COMPILE_FLAGS + ("-shared",)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_SMEM: dict[object, int] = {}
#: {"seconds": float, "ptxas": str} of the build this process ran, if any
BUILD_LOG: dict = {}
#: {"seconds": float, "built": bool} of this process's first load of the
#: library: the seconds of the staleness check, any build and the dlopen
LOAD_LOG: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "gf_bitterm": (_I, [_P, _P, _P, _P, _I, _I, _LL, _P]),
    "gf_bitxor": (_I, [_P, _P, _P, _P, _I, _I, _I, _LL, _P]),
    "gf_sched_xor": (_I, [_P, _P, _P, _P, _I, _I, _I, _LL, _P]),
    "gf_bitmm": (_I, [_P, _P, _P, _I, _I, _LL, _P]),
    "crc32c_chunks": (_I, [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I,
                           ctypes.c_uint32, _P]),
    "gf_smem_optin": (_I, [ctypes.POINTER(_I)]),
    "gf_error_string": (ctypes.c_char_p, [_I]),
}


class CudaBuildError(RuntimeError):
    pass


class CudaKernelError(RuntimeError):
    pass


def so_path() -> str:
    return os.path.join(BUILD, f"lib{LIBRARY}.so")


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise CudaBuildError("nvcc not found (PATH, CUDA_HOME)")
    return path


def _stale() -> bool:
    so = so_path()
    if not os.path.exists(so):
        return True
    so_m = os.path.getmtime(so)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > so_m
               for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def build() -> float | None:
    """Compile the sources if the library is stale; returns the seconds
    the build took, or None when the library was up to date.  Raises
    CudaBuildError."""
    with _LOCK:
        os.makedirs(BUILD, exist_ok=True)
        with open(os.path.join(BUILD, ".lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            if not _stale():
                return None
            t0 = time.perf_counter()
            tag = f".tmp{os.getpid()}"
            # nvcc takes a file's kind from its suffix: objects end in .o
            objs = [os.path.join(BUILD, f"{src}{tag}.o") for src in SOURCES]
            procs = [subprocess.Popen(
                [nvcc(), *COMPILE_FLAGS, "-c", "-o", obj,
                 os.path.join(CSRC, f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(SOURCES, objs)]
            logs = [p.communicate()[0] for p in procs]
            try:
                for src, p, log in zip(SOURCES, procs, logs):
                    if p.returncode:
                        raise CudaBuildError(
                            f"nvcc exit {p.returncode} on {src}.cu\n{log}")
                tmp = so_path() + tag
                p = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, *objs],
                                   capture_output=True, text=True)
                if p.returncode:
                    raise CudaBuildError(f"nvcc link exit {p.returncode}\n"
                                         f"{p.stdout}{p.stderr}")
                os.replace(tmp, so_path())
            finally:
                for obj in objs:
                    if os.path.exists(obj):
                        os.remove(obj)
            BUILD_LOG.update(seconds=time.perf_counter() - t0,
                             ptxas="\n".join(logs).strip())
            return BUILD_LOG["seconds"]


def lib() -> ctypes.CDLL:
    """The loaded library, building it first if stale."""
    global _LIB
    with _LOCK:
        hit = _LIB
    if hit is not None:
        return hit
    t0 = time.perf_counter()
    built = build()
    with _LOCK:
        if _LIB is None:
            hit = ctypes.CDLL(so_path())
            for fn, (res, args) in _SIGNATURES.items():
                f = getattr(hit, fn)
                f.restype = res
                f.argtypes = args
            _LIB = hit
            LOAD_LOG.update(seconds=time.perf_counter() - t0,
                            built=built is not None)
        return _LIB


def check(err: int, what: str) -> None:
    """Raise CudaKernelError when a C entry returned a CUDA error."""
    if err:
        msg = lib().gf_error_string(err).decode()
        raise CudaKernelError(f"{what}: CUDA error {err} ({msg})")


def smem_optin(device) -> int:
    """Largest dynamic shared memory (bytes) one block may use on
    ``device`` (a CUDA torch.device)."""
    import torch

    with _LOCK:
        hit = _SMEM.get(device)
    if hit is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            check(lib().gf_smem_optin(ctypes.byref(out)), "gf_smem_optin")
        hit = out.value
        with _LOCK:
            _SMEM[device] = hit
    return hit
