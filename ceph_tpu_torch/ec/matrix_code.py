"""Shared implementation of GF(2^8) matrix codes (RS/Cauchy families).

The counterpart of the JAX package's ``ceph_tpu/ec/matrix_code.py`` on a
``torch`` backend: hold an (m, k) coding matrix, multiply regions through
a backend — the numpy oracle, or PyTorch with the hand-written CUDA
kernels (ops/ec_kernels.py) on one device — and build cached inverted
decode matrices per erasure signature (the reference's
ErasureCodeIsaTableCache LRU, ErasureCodeIsa.cc:513-563).

The device is the profile key ``device`` (default ``cuda``).  A codec
asked for ``cuda`` on a process with no card raises at construction; it
never carries on on the CPU.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Sequence

import numpy as np
import torch

from ..ops import ec_kernels, gf256
from ..utils.perf import kernel_profiler
from .interface import ChunkMap, ErasureCode, ErasureCodeError, Flags


#: deterministic candidate order the auto-tuner races — hand-written
#: kernels only, so the plain version is never a candidate on the card
KERNEL_RACE_ORDER = ("bitxor", "pallas")


def _shape_bucket(L: int) -> int:
    """pow2 shape bucket (512-byte floor) of a launch's column count —
    kernel picks are pinned per (matrix, bucket)."""
    b = 512
    while b < L:
        b <<= 1
    return b


def _pick_backend(name: str) -> str:
    if name == "auto":
        return "numpy"
    if name not in ("numpy", "torch"):
        raise ErasureCodeError(f"unknown backend {name!r}")
    return name


def resolve_device(name) -> torch.device:
    """The torch.device of a profile's ``device`` value; ``cuda`` with
    no card raises instead of falling back to the CPU."""
    try:
        dev = torch.device(name)
    except (RuntimeError, TypeError) as e:
        raise ErasureCodeError(f"bad device {name!r}: {e}") from e
    if dev.type not in ("cpu", "cuda"):
        raise ErasureCodeError(f"unsupported device {name!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ErasureCodeError(
            "device cuda requested but torch.cuda.is_available() is "
            "False (pass device=cpu to run on the CPU)")
    return dev


class MatrixErasureCode(ErasureCode):
    """Systematic GF(2^8) matrix code over a pluggable region backend."""

    #: subclasses set this in _init_from_profile
    matrix: np.ndarray

    #: cache bounds (class attrs so tests can shrink them)
    OPS_CAP = 64
    DECODE_CACHE_CAP = 256

    def _init_matrix_backend(self) -> None:
        self._backend = _pick_backend(self.profile.get("backend", "auto"))
        self.device = (resolve_device(self.profile.get("device", "cuda"))
                       if self._backend == "torch" else None)
        # kernel realization for torch-backend region math: profile key
        # ``kernel`` pins one of ops/ec_kernels.KERNELS, ``auto``
        # (default) lets the per-signature tuner decide — racing the
        # viable hand-written kernels on the card, pinning the plain
        # version on the CPU (tier-1 must never wall-clock-flap).
        # ``kernel_race`` overrides WHERE races run (on/off/auto) — a
        # test/bench hook, auto = the card only.
        self._kernel_mode = str(self.profile.get("kernel",
                                                 "auto")).lower()
        #: (matrix bytes, matrix shape, shape bucket) -> winning kernel
        self._kernel_picks: dict[tuple, str] = {}
        self._decode_cache: dict[tuple[int, ...], np.ndarray] = {}
        # region-op cache keyed by kernel + matrix bytes (encode matrix
        # plus decode matrices), so repeated decodes reuse their
        # device-resident tables.  True LRU: hits re-insert at the
        # dict's end, eviction pops the front.
        self._ops: dict[bytes, object] = {}
        # concurrent callers hit these caches; the LRU touch is
        # pop+reinsert, which must not interleave
        self._cache_lock = threading.Lock()
        # (kernel sig, input shape) pairs already launched once: the
        # first launch of a pair builds the device tables (and, first in
        # the process, the CUDA library) and is profiled as a compile
        self._kern_shapes_seen: set[tuple] = set()

    def _op_cached(self, key: bytes, build):
        with self._cache_lock:
            op = self._ops.pop(key, None)
            if op is not None:
                self._ops[key] = op  # LRU touch: re-insert at end
                return op
        op = build()  # outside the lock
        with self._cache_lock:
            hit = self._ops.pop(key, None)
            if hit is not None:
                op = hit  # another thread built it first: keep one
            elif len(self._ops) > self.OPS_CAP:
                self._ops.pop(next(iter(self._ops)))
            self._ops[key] = op
        return op

    @staticmethod
    def _matmul_key(M: np.ndarray, kernel: str = "auto") -> bytes:
        """Op-LRU key of a region op: realization name + matrix bytes +
        shape (ONE definition)."""
        return kernel.encode() + b":" + M.tobytes() + bytes(M.shape)

    def _torch_matmul(self, M: np.ndarray, kernel: str = "auto"):
        def build():
            return ec_kernels.RegionMatmul(M, kernel=kernel,
                                           device=self.device)

        return self._op_cached(self._matmul_key(M, kernel), build)

    # -- per-signature kernel auto-selection -------------------------------
    def _race_enabled(self) -> bool:
        """Whether unpinned ``auto`` signatures RACE their candidates:
        profile key ``kernel_race`` on/off forces it (test/bench hook);
        ``auto`` races on the card only — on the CPU timing variance
        would flap picks run to run, so the CPU pins the plain version."""
        mode = str(self.profile.get("kernel_race", "auto")).lower()
        if mode in ("on", "true", "1", "yes"):
            return True
        if mode in ("off", "false", "0", "no"):
            return False
        return self.device.type == "cuda"

    def _kernel_fallback(self, M: np.ndarray) -> str:
        """Deterministic no-race kernel: the explicit pin when viable,
        else the platform default (the bit-term kernel on the card, the
        plain ``xla`` version on the CPU)."""
        mode = self._kernel_mode
        if mode in ec_kernels.KERNELS and \
                ec_kernels.kernel_supports(mode, M, device=self.device):
            return mode
        if self.device.type == "cpu":
            return "xla"
        for k in ("pallas", "bitxor"):
            if ec_kernels.kernel_supports(k, M, device=self.device):
                return k
        raise ErasureCodeError(
            f"no kernel can run a {M.shape[0]}x{M.shape[1]} matrix on "
            f"{self.device}")

    @staticmethod
    def _pick_sig(M: np.ndarray, bucket: int) -> str:
        """dump_kernel_profile signature of one pick: matrix dims +
        content crc (two decode matrices share dims) + shape bucket."""
        crc = zlib.crc32(M.tobytes() + bytes(M.shape)) & 0xFFFFFFFF
        return (f"pick/{M.shape[0]}x{M.shape[1]}/m{crc:08x}"
                f"/L{bucket}")

    def _pin_kernel(self, M: np.ndarray, bucket: int, kernel: str, *,
                    mode: str, skipped=(), race_launches: int = 0) -> str:
        """Pin ``kernel`` for (matrix, bucket) — first pin wins (two
        threads racing the same cold signature book ONE pick)."""
        key = (M.tobytes(), M.shape, bucket)
        with self._cache_lock:
            cur = self._kernel_picks.get(key)
            if cur is not None:
                return cur
            self._kernel_picks[key] = kernel
        kernel_profiler().note_pick(
            self._pick_sig(M, bucket), kernel, mode=mode,
            skipped=skipped, race_launches=race_launches)
        return kernel

    def _kernel_pick(self, M: np.ndarray, L: int) -> str | None:
        """Resolved kernel for a (matrix, bucket(L)) signature: the
        pinned winner, a deterministic pin made now (explicit profile
        key if viable — an unsupported pin books a skip and falls
        through instead of raising — or the platform default when
        races are disabled), or None = the caller should race."""
        bucket = _shape_bucket(L)
        key = (M.tobytes(), M.shape, bucket)
        with self._cache_lock:
            pick = self._kernel_picks.get(key)
        if pick is not None:
            return pick
        mode = self._kernel_mode
        skipped = []
        if mode != "auto":
            if mode in ec_kernels.KERNELS and \
                    ec_kernels.kernel_supports(mode, M, device=self.device):
                return self._pin_kernel(M, bucket, mode, mode="pinned")
            # unsupported OR unknown pin: booked as a skip (the dump's
            # skipped list is where a typo'd kernel name surfaces),
            # never a raise — selection falls through to auto
            skipped.append(mode)
        if self._race_enabled():
            return None
        return self._pin_kernel(M, bucket, self._kernel_fallback(M),
                                mode="pinned", skipped=skipped)

    @staticmethod
    def _matmul_sig(M: np.ndarray, L: int, kernel: str) -> str:
        return f"matmul/{M.shape[0]}x{M.shape[1]}/L{L}/{kernel}"

    def _race_matmul(self, M: np.ndarray, rows):
        """First launch of an unpinned auto signature: run every viable
        candidate on the real fold (a first launch + one timed launch
        each), pin the fastest, and return the winner's output.  Only
        ``kernel_supports`` decides a skip: a launch or CUDA error
        propagates."""
        L = int(rows.shape[-1])
        bucket = _shape_bucket(L)
        cands, skipped = [], []
        if self._kernel_mode != "auto" \
                and self._kernel_mode not in KERNEL_RACE_ORDER:
            skipped.append(self._kernel_mode)  # typo'd pin: stay visible
        for k in KERNEL_RACE_ORDER:
            (cands if ec_kernels.kernel_supports(k, M, device=self.device)
             else skipped).append(k)
        if not cands:
            raise ErasureCodeError(
                f"no kernel can run a {M.shape[0]}x{M.shape[1]} matrix on "
                f"{self.device} (skipped {skipped})")
        best = None  # (dt, kernel, out)
        for k in cands:
            sig = self._matmul_sig(M, L, k)
            op = self._torch_matmul(M, kernel=k)
            out = self._profiled_launch(op, rows, sig)  # + device tables
            t0 = time.perf_counter()
            out = self._profiled_launch(op, rows, sig)
            dt = time.perf_counter() - t0
            if best is None or dt < best[0]:
                best = (dt, k, out)
        self._pin_kernel(M, bucket, best[1], mode="auto",
                         skipped=skipped, race_launches=2 * len(cands))
        return best[2]

    def kernel_picks(self) -> dict:
        """Snapshot: pick signature -> winning kernel (test surface)."""
        with self._cache_lock:
            return {self._pick_sig(np.frombuffer(mb, dtype=np.uint8)
                                   .reshape(shape), bucket): k
                    for (mb, shape, bucket), k
                    in self._kernel_picks.items()}

    def get_flags(self) -> Flags:
        return (Flags.PARITY_DELTA_OPTIMIZATION | Flags.ZERO_PADDING |
                Flags.OPTIMIZED_SUPPORTED | Flags.PARTIAL_READ_OPTIMIZATION |
                Flags.PARTIAL_WRITE_OPTIMIZATION)

    # -- region multiply through the selected backend ----------------------
    def _matmul_device(self, M: np.ndarray, rows, *, donate: bool = False):
        """Backend-resident region multiply: on the torch backend the
        result STAYS a tensor on the codec's device (no host copy), so
        callers folding many stripes into one launch pay one host copy
        for the whole batch.  The numpy backend returns numpy.

        ``donate`` is accepted for the JAX package's signature and
        ignored: the port does not alias inputs yet."""
        if self._backend == "torch":
            if isinstance(rows, np.ndarray):
                # one host->device copy, outside the timed launches (a
                # race would otherwise time the copy once per candidate)
                rows = torch.from_numpy(np.ascontiguousarray(
                    rows, dtype=np.uint8)).to(self.device)
            L = int(rows.shape[-1])
            pick = self._kernel_pick(M, L)
            if pick is None:
                return self._race_matmul(M, rows)
            op = self._torch_matmul(M, kernel=pick)
            return self._profiled_launch(
                op, rows, self._matmul_sig(M, L, pick))
        if isinstance(rows, torch.Tensor):
            rows = rows.numpy()
        return gf256.encode_region(M, rows)

    def _profiled_launch(self, op, rows, sig: str):
        """One timed launch: elapsed measured around a device
        synchronize (enqueue + device execute, NOT the host copy —
        that's host_sync's slice).  A (kernel, shape) pair's first launch
        builds the op's device tables (and, first in the process, the
        CUDA library) and is recorded as a compile event."""
        t0 = time.perf_counter()
        out = op(rows)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        dt = time.perf_counter() - t0
        key = (sig, tuple(rows.shape))
        with self._cache_lock:
            first = key not in self._kern_shapes_seen
            if first:
                self._kern_shapes_seen.add(key)
        kernel_profiler().note("compile" if first else "device", sig, dt)
        return out

    def host_sync(self, dev, sig: str | None = None):
        """Materialize a device result on the host, timing the
        device->host copy as the profiler's host-sync slice (a numpy
        input passes through untimed).  Default signature carries the
        result shape."""
        if isinstance(dev, np.ndarray):
            return dev
        if sig is None:
            shape = "x".join(str(d) for d in dev.shape)
            sig = f"sync/{shape}"
        t0 = time.perf_counter()
        out = dev.cpu().numpy()
        kernel_profiler().note("sync", sig, time.perf_counter() - t0)
        return out

    def decode_folded_device(self, want: Sequence[int],
                             avail: Sequence[int], stacked):
        """Device-resident folded decode: ``stacked`` is a
        ``(len(avail), N)`` uint8 tensor on the codec's device whose rows
        are the survivor chunks in ``avail`` (sorted) order.  Returns a
        ``(len(want), N)`` tensor of the reconstructed rows in ``want``
        order, with NO host copy.

        Math is identical to decode_chunks (same decode-matrix cache,
        same single-row fast path, same parity-from-data product), so
        the bytes are identical to the per-op host path."""
        avail = [i for i in avail if i < self.chunk_count]
        if len(avail) < self.k:
            raise ErasureCodeError(
                f"cannot decode: only {len(avail)} of {self.k} chunks")
        want = list(want)
        use = avail[: self.k]
        stack = stacked[: self.k]
        want_data = [i for i in want if i < self.k]
        want_parity = [i for i in want if i >= self.k]
        rows: dict[int, object] = {}
        data_full = None
        missing_data = [i for i in range(self.k) if i not in avail]
        if not missing_data:
            # all k data rows present: the first k sorted survivors ARE
            # the data rows in order (decode_chunks' no-inversion path)
            data_full = stack
            for i in want_data:
                rows[i] = stack[i]
        else:
            D = self._get_decode_matrix(use)
            if want_parity or len(missing_data) > 1:
                data_full = self._matmul_device(D, stack)
                for i in want_data:
                    rows[i] = data_full[i]
            else:
                sub = self._matmul_device(D[want_data], stack)
                for r, i in enumerate(want_data):
                    rows[i] = sub[r]
        if want_parity:
            par = self._matmul_device(
                self.matrix[[i - self.k for i in want_parity]], data_full)
            for r, i in enumerate(want_parity):
                rows[i] = par[r]
        return torch.stack([torch.as_tensor(rows[i]) for i in want])

    def _matmul(self, M: np.ndarray, rows: np.ndarray) -> np.ndarray:
        return self.host_sync(self._matmul_device(M, rows))

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        data_chunks = np.ascontiguousarray(data_chunks, dtype=np.uint8)
        if data_chunks.shape[0] != self.k:
            raise ErasureCodeError(
                f"expected {self.k} data chunks, got {data_chunks.shape[0]}")
        return self._matmul(self.matrix, data_chunks)

    def _get_decode_matrix(self, available: Sequence[int]) -> np.ndarray:
        key = tuple(available[: self.k])
        with self._cache_lock:
            hit = self._decode_cache.pop(key, None)
            if hit is not None:
                # LRU touch: re-insert at the end so hot signatures
                # survive eviction churn from one-shot ones
                self._decode_cache[key] = hit
                return hit
        hit = gf256.decode_matrix(self.matrix, self.k, list(key))
        with self._cache_lock:
            # signature LRU, ref :513-563
            if len(self._decode_cache) > self.DECODE_CACHE_CAP:
                self._decode_cache.pop(next(iter(self._decode_cache)))
            self._decode_cache[key] = hit
        return hit

    def decode_chunks(self, want: Sequence[int],
                      chunks: ChunkMap) -> ChunkMap:
        avail = sorted(i for i in chunks if i < self.chunk_count)
        if len(avail) < self.k:
            raise ErasureCodeError(
                f"cannot decode: only {len(avail)} of {self.k} chunks")
        use = avail[: self.k]
        L = chunks[use[0]].shape[-1]
        stack = np.stack([np.ascontiguousarray(chunks[i], dtype=np.uint8)
                          for i in use])
        out: ChunkMap = {}
        want_data = [i for i in want if i < self.k]
        want_parity = [i for i in want if i >= self.k]
        data_full: np.ndarray | None = None
        if want_data or want_parity:
            missing_data = [i for i in range(self.k) if i not in chunks]
            if not missing_data:
                # all k data rows present: the first k sorted survivors
                # ARE the data rows in order — wanted parity is one
                # direct matmul against the coding matrix below, with no
                # decode-matrix build/inversion
                data_full = stack if want_parity else None
            else:
                D = self._get_decode_matrix(use)
                if want_parity or len(missing_data) > 1:
                    data_full = self._matmul(D, stack)
                else:
                    # single-row recovery: multiply only the needed rows
                    data_full = np.zeros((self.k, L), dtype=np.uint8)
                    sub = self._matmul(D[want_data], stack)
                    for r, i in enumerate(want_data):
                        data_full[i] = sub[r]
            for i in want_data:
                out[i] = chunks[i] if i in chunks else data_full[i]
        if want_parity:
            parity = self._matmul(
                self.matrix[[i - self.k for i in want_parity]], data_full)
            for r, i in enumerate(want_parity):
                out[i] = parity[r]
        return out

    # -- parity delta (RMW write path; ref ErasureCodeJerasure.h:115-122,
    # ECUtil.cc:519-566 encode_parity_delta) ------------------------------
    def apply_delta(self, delta: np.ndarray, data_shard: int,
                    parity_chunks: ChunkMap) -> None:
        if not 0 <= data_shard < self.k:
            raise ErasureCodeError(f"not a data shard: {data_shard}")
        delta = np.ascontiguousarray(delta, dtype=np.uint8)
        for pid, buf in parity_chunks.items():
            if not self.k <= pid < self.chunk_count:
                raise ErasureCodeError(f"not a parity shard: {pid}")
            coef = int(self.matrix[pid - self.k, data_shard])
            buf ^= gf256.gf_mul(np.uint8(coef), delta)
