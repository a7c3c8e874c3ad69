"""Shared implementation of GF(2^8) matrix codes (RS/Cauchy families).

The counterpart of the JAX package's ``ceph_tpu/ec/matrix_code.py`` on a
``torch`` backend: hold an (m, k) coding matrix, multiply regions through
a backend — the numpy oracle, the native host library (``native``,
ops/native.py), or PyTorch with the hand-written CUDA kernels
(ops/ec_kernels.py) on one device — and build cached inverted decode
matrices per erasure signature (the reference's ErasureCodeIsaTableCache
LRU, ErasureCodeIsa.cc:513-563).  ``backend=auto`` resolves to
``native`` when the library loads, else ``numpy``.

The device is the profile key ``device`` (default ``cuda``).  A codec
asked for ``cuda`` on a process with no card raises at construction; it
never carries on on the CPU.  The profile key ``shard`` (the reference's
device fan-out) resolves to one device; a fan-out above 1 raises until
the multi-GPU slice is ported.

Checksummed writes (``encode_chunks_with_csums`` and the batcher's fused
flush) run ``_csum_op``: the region kernel pinned for the encode matrix
writes the parity beside the data, then the CRC32C kernel digests every
chunk (models/stripe_codec.encode_csum_graph).  Nothing is compiled per
shape or matrix — the one ``nvcc`` build is the only compile — so the
op is ready at once on every device: the reference's background warm
(``csum_warm``, ``_csum_ready``) has no counterpart, and the profile key
``csum_warm`` is accepted and ignored.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Sequence

import numpy as np
import torch

from ..ops import checksum, ec_kernels, gf256, native
from ..utils import staging
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
        return "native" if native.available() else "numpy"
    if name not in ("native", "numpy", "torch"):
        raise ErasureCodeError(f"unknown backend {name!r}")
    return name


def _as_host(x) -> np.ndarray:
    """Host uint8 bytes of a numpy array or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.uint8)


def _host_csums(rows) -> np.ndarray:
    """Standard CRC32C of every row, on the host (native library)."""
    return np.array([native.crc32c(row) for row in rows], dtype=np.uint32)


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
        self.shard_devices()  # a fan-out above 1 raises here
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

    #: launches a race times for each candidate after its first one
    RACE_TIMED_LAUNCHES = 3

    def _race_matmul(self, M: np.ndarray, rows):
        """First launch of an unpinned auto signature: run every viable
        candidate on the real fold (a first launch, then
        RACE_TIMED_LAUNCHES timed ones each), pin the one whose lower
        median time is the least, and return its output.  Only
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
        n = self.RACE_TIMED_LAUNCHES
        best = None  # (time, kernel, out)
        for k in cands:
            sig = self._matmul_sig(M, L, k)
            op = self._torch_matmul(M, kernel=k)
            out = self._profiled_launch(op, rows, sig)  # + device tables
            times = []
            for _ in range(n):
                out, dt = self._timed_launch(op, rows, sig)
                times.append(dt)
            t = sorted(times)[(n - 1) // 2]
            if best is None or t < best[0]:
                best = (t, k, out)
        self._pin_kernel(M, bucket, best[1], mode="auto",
                         skipped=skipped, race_launches=(1 + n) * len(cands))
        return best[2]

    def kernel_picks(self) -> dict:
        """Snapshot: pick signature -> winning kernel (test surface)."""
        with self._cache_lock:
            return {self._pick_sig(np.frombuffer(mb, dtype=np.uint8)
                                   .reshape(shape), bucket): k
                    for (mb, shape, bucket), k
                    in self._kernel_picks.items()}

    def shard_devices(self) -> int:
        """Resolved device fan-out for folded launches: 1.  Profile key
        ``shard``: ``off`` (``false``, ``no``, ``0``) means one device;
        ``auto`` (or unset; ``on``, ``true``, ``yes``) means every card,
        as the reference engages every accelerator, and one device on
        the CPU or the numpy backend; an integer N means N devices.  A
        fan-out above 1 raises ErasureCodeError — the multi-GPU fan-out
        is not ported, and such a pool is never served by one device
        without saying so (``shard=off`` asks for one)."""
        mode = str(self.profile.get("shard", "auto")).lower()
        if mode in ("off", "false", "no", "0"):
            return 1
        if mode in ("auto", "on", "true", "yes"):
            device = getattr(self, "device", None)
            on_card = device is not None and device.type == "cuda"
            n = torch.cuda.device_count() if on_card else 1
        else:
            try:
                n = int(mode)
            except ValueError as e:
                raise ErasureCodeError(f"bad shard {mode!r}") from e
        if n > 1:
            raise ErasureCodeError(
                f"shard={mode} asks for {n} devices: the multi-GPU fan-out "
                "is not ported (shard=off serves the pool from one)")
        return 1

    # -- batcher fold protocol ---------------------------------------------
    # The ECBatcher folds concurrent same-signature ops into one
    # (k, sum L) launch.  These hooks tell it HOW this codec folds:
    #
    # - fold_sig(): the codec-identity component of every flush
    #   signature (two codecs sharing a matrix's bytes+shape need not
    #   share decode semantics).
    # - encode_fold_kind()/decode_fold_kind(): "plain" = the op is one
    #   region matmul against self.matrix / a decode-matrix product,
    #   "subchunk" = the op folds at plane granularity through the
    #   codec's *_chunks_folded entry points (CLAY's coupled planes),
    #   None = not foldable (pass-through).
    # - fold_rows(): which survivor rows a folded "plain" decode launch
    #   consumes, in stack order — the first k sorted survivors (every
    #   k-subset of an MDS code decodes).  None = this erasure cannot
    #   fold (pass-through surfaces the codec's own error per op).

    def fold_sig(self) -> tuple:
        return ("mat",)

    def encode_fold_kind(self) -> str | None:
        return ("plain" if type(self).encode_chunks
                is MatrixErasureCode.encode_chunks else None)

    def decode_fold_kind(self) -> str | None:
        return ("plain" if type(self).decode_chunks
                is MatrixErasureCode.decode_chunks else None)

    def fold_rows(self, want: Sequence[int],
                  avail: Sequence[int]) -> list[int] | None:
        rows = [i for i in avail if i < self.chunk_count][: self.k]
        return rows if len(rows) == self.k else None

    def get_flags(self) -> Flags:
        return (Flags.PARITY_DELTA_OPTIMIZATION | Flags.ZERO_PADDING |
                Flags.OPTIMIZED_SUPPORTED | Flags.PARTIAL_READ_OPTIMIZATION |
                Flags.PARTIAL_WRITE_OPTIMIZATION)

    # -- region multiply through the selected backend ----------------------
    def _matmul_device(self, M: np.ndarray, rows, *, donate: bool = False):
        """Backend-resident region multiply: on the torch backend the
        result STAYS a tensor on the codec's device (no host copy), so
        callers folding many stripes into one launch pay one host copy
        for the whole batch.  The native and numpy backends return numpy.

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
        if self._backend == "native":
            return native.encode_region(M, rows)
        return gf256.encode_region(M, rows)

    def _profiled_launch(self, op, rows, sig: str, events=None):
        """One timed launch: elapsed measured until the op's own outputs
        are done (staging.wait_for: an event on the stream it ran on,
        never the whole card) — enqueue + device execute, NOT the host
        copy, which is host_sync's slice.  A (kernel, shape) pair's first
        launch builds the op's device tables (and, first in the process,
        the CUDA library) and is recorded as a compile event.
        ``events``, a (start, end) pair of CUDA events, are recorded on
        the device's current stream just before and just after the op."""
        t0 = time.perf_counter()
        if events is not None:
            events[0].record(torch.cuda.current_stream(self.device))
        out = op(rows)
        if events is not None:
            events[1].record(torch.cuda.current_stream(self.device))
        # the fused encode+CRC op returns (parity, csums)
        staging.wait_for(out if isinstance(out, tuple) else (out,))
        dt = time.perf_counter() - t0
        key = (sig, tuple(rows.shape))
        with self._cache_lock:
            first = key not in self._kern_shapes_seen
            if first:
                self._kern_shapes_seen.add(key)
        kernel_profiler().note("compile" if first else "device", sig, dt)
        return out

    def _timed_launch(self, op, rows, sig: str):
        """(output, seconds) of one profiled launch, as the race times
        it: CUDA events around the op on the card, where the host clock
        cannot see a few microseconds; the host clock on the CPU."""
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            out = self._profiled_launch(op, rows, sig, events)
            return out, events[0].elapsed_time(events[1]) / 1e3
        t0 = time.perf_counter()
        out = self._profiled_launch(op, rows, sig)
        return out, time.perf_counter() - t0

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

    def host_sync_bulk(self, devs, sig: str | None = None) -> list:
        """Materialize SEVERAL device results as ONE metered
        device->host copy event (utils/staging.fetch_recorded): the
        flush-plane contract — a folded launch's outputs (parity, or
        parity + csums, or a decode's stacked rows) leave the device
        together, booked as one ``ec_stage_d2h`` copy.  Numpy inputs
        pass through untimed, same as host_sync."""
        return staging.fetch_recorded(devs, sig=sig)

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
        data_chunks = _as_host(data_chunks)
        if data_chunks.shape[0] != self.k:
            raise ErasureCodeError(
                f"expected {self.k} data chunks, got {data_chunks.shape[0]}")
        return self._matmul(self.matrix, data_chunks)

    def encode_chunks_with_csums(
            self, data_chunks: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(parity, per-chunk CRC32C over data+parity rows) — on the
        torch backend both come out of the fused op (_csum_op: the region
        kernel, then the CRC32C kernel over the stack), or, for a length
        that is not a whole number of words, of the same two kernels
        launched apart; the numpy backend, and subclasses that own their
        parity math, compute the same csums on the host so callers share
        one API."""
        data_chunks = _as_host(data_chunks)
        nbytes = int(data_chunks.shape[-1])
        plain = type(self).encode_chunks is MatrixErasureCode.encode_chunks
        if not plain:
            # a subclass owns the parity math: fuse nothing, delegate —
            # csums ride a host sweep over whatever it produced
            parity = self.encode_chunks(data_chunks)
            return parity, _host_csums(
                np.concatenate([data_chunks, parity], axis=0))
        if self._backend == "torch" and data_chunks.shape[0] != self.k:
            raise ErasureCodeError(f"expected {self.k} data chunks, "
                                   f"got {data_chunks.shape[0]}")
        if self._backend == "torch" and nbytes % 4 == 0 and nbytes >= 4:
            op = self._csum_op_if_ready(nbytes)
            parity, csums = self._profiled_launch(
                op, data_chunks,
                f"csum/{self.m}x{self.k}/L{nbytes}x{nbytes}")
            return self.host_sync(parity), self.host_sync(csums)[:, 0]
        if self._backend == "torch" and nbytes:
            # a length the fused op does not take: the region kernel,
            # then G1 over the (k+m, L) stack on the same device
            data = torch.from_numpy(data_chunks).to(self.device)
            parity = self._matmul_device(self.matrix, data)
            csums = checksum.row_csums(torch.cat([data, parity]))
            return self.host_sync(parity), self.host_sync(csums)
        parity = self._matmul(self.matrix, data_chunks)
        return parity, _host_csums(
            np.concatenate([data_chunks, parity], axis=0))

    def _csum_op(self, nbytes: int):
        """Fused encode+CRC32C op for chunk length ``nbytes``:
        fn((k, batch*nbytes) data, numpy or a tensor) -> (parity
        (m, batch*nbytes), csums (k+m, batch) uint32) as tensors on the
        codec's device — parity and every per-chunk digest leave the
        device together.  Cached per (matrix, nbytes) beside the region
        ops; the region kernel is resolved per launch width
        (_csum_graph_kernel) and its graph cached per kernel."""
        from ..models.stripe_codec import StripeCodec

        graphs: dict[str, object] = {}
        lock = threading.Lock()

        def op(data):
            if isinstance(data, np.ndarray):
                data = torch.from_numpy(np.ascontiguousarray(
                    data, dtype=np.uint8)).to(self.device)
            kern = self._csum_graph_kernel(data)
            with lock:
                fn = graphs.get(kern)
                if fn is None:
                    codec = StripeCodec.__new__(StripeCodec)
                    codec.k, codec.m = self.k, self.m
                    codec.matrix = self.matrix
                    fn = graphs[kern] = codec.encode_csum_graph(
                        nbytes, kernel=kern)
            return fn(data)

        return self._op_cached(self._csum_key(nbytes), lambda: op)

    def _csum_graph_kernel(self, data) -> str:
        """Region kernel the fused op runs for the encode matrix at
        ``data``'s width (``data``: the k data rows, or the (k+m, N)
        stack they head): the kernel pinned for (matrix, width bucket)
        — an explicit profile pin, an earlier race, or, for an unpinned
        signature on the card, a race run now on the data rows (its
        parity is dropped; the fused op launches the winner).  On the CPU
        the pin is the plain version."""
        M, L = self.matrix, int(data.shape[-1])
        pick = self._kernel_pick(M, L)
        if pick is None:
            self._race_matmul(M, data[: self.k])
            pick = self._kernel_pick(M, L)
        return pick

    def _csum_key(self, nbytes: int) -> bytes:
        """Op-LRU key of the fused encode+CRC op for this chunk length —
        ONE definition."""
        return b"csum:" + self.matrix.tobytes() + nbytes.to_bytes(8,
                                                                  "little")

    def _csum_op_if_ready(self, nbytes: int):
        """The fused op for chunk length ``nbytes``, at once on every
        device: the port compiles nothing per shape, so there is nothing
        to warm (the reference returns it at once only on a TPU and warms
        it in the background elsewhere)."""
        return self._csum_op(nbytes)

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
            if self._backend == "native":
                native.region_mac(buf, delta, coef)
            else:
                buf ^= gf256.gf_mul(np.uint8(coef), delta)
