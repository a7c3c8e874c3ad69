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
never carries on on the CPU.  The profile key ``shard`` is the device
fan-out of folded launches (shard_devices): a fan-out above 1 splits a
launch's length axis over a flat mesh of the devices of the codec's
kind (parallel/distributed.make_folded_matmul) — every card, or the
logical devices parallel.mesh.force_devices set on one — and a mesh
that cannot be built raises (the reference falls back to one device).

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


#: deterministic candidate order the auto-tuner races — the JAX
#: package's order less its plain ``xla`` graph: hand-written kernels
#: only, so the plain version is never a candidate on the card
KERNEL_RACE_ORDER = ("bitxor", "pallas", "mxu")


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
        self.shard_devices()  # a malformed ``shard`` raises here
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
    def _matmul_sig(M: np.ndarray, L: int, kernel: str,
                    n_shard: int = 1) -> str:
        return (f"matmul/{M.shape[0]}x{M.shape[1]}/L{L}"
                + (f"/s{n_shard}" if n_shard > 1 else "") + f"/{kernel}")

    #: launches a race times for each candidate after its first one
    RACE_TIMED_LAUNCHES = 3
    #: clock cycles the card sleeps ahead of each timed race launch
    #: (about 0.2 ms at 1.98 GHz, several times a wrapper's host work),
    #: so the host has queued the op before the card reaches its start
    #: event: the window then holds the kernels alone
    RACE_LEAD_CYCLES = 400_000

    def _race_matmul(self, M: np.ndarray, rows, n_shard: int = 1):
        """First launch of an unpinned auto signature: run every viable
        candidate on the real fold (a first launch, then
        RACE_TIMED_LAUNCHES timed ones each), pin the one whose lower
        median time is the least, and return its output.  Only
        ``kernel_supports`` decides a skip: a launch or CUDA error
        propagates.  ``n_shard > 1`` races each candidate's sharded op
        (every logical device runs the candidate on its slice; the
        timed window spans the whole fan-out, joined on this stream),
        with a host fold staged over the mesh once, before the race.
        The reference drops ``pallas`` from a sharded race (it lowers to
        the ``xla`` graph inside a shard_map body); here each candidate
        is its own kernel on every slice, so all of them race."""
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
        ops = {k: (self._matmul_sharded(M, n_shard, kernel=k)
                   if n_shard > 1 else (self._torch_matmul(M, kernel=k),
                                        None)) for k in cands}
        if n_shard > 1:
            from ..parallel.distributed import stage_folded
            rows = stage_folded(rows, ops[cands[0]][1])
        for k in cands:
            sig = self._matmul_sig(M, L, k, n_shard)
            op = ops[k][0]
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
        """Resolved device fan-out for folded launches (1 = one device),
        as the reference resolves it.  Profile key ``shard`` (seeded
        from the ``ec_shard`` option by the OSD): ``off`` (``false``,
        ``no``, ``0``) -> 1; an integer N -> min(N, devices of the
        codec's kind); ``auto`` (or unset; ``on``, ``true``, ``yes``) ->
        every device of a card and 1 on the CPU.  The devices are
        parallel.mesh.devices: the cards, or the logical devices
        force_devices set on the first.  Non-torch backends never fan
        out.  A value that is none of these raises ErasureCodeError (the
        reference resolves it to 1)."""
        if self._backend != "torch":
            return 1
        cached = getattr(self, "_shard_devices_cached", None)
        if cached is not None:
            return cached
        from ..parallel.mesh import devices
        mode = str(self.profile.get("shard", "auto")).lower()
        n = 1
        if mode not in ("off", "false", "no", "0"):
            ndev = len(devices(self.device.type))
            if mode in ("auto", "on", "true", "yes"):
                n = ndev if self.device.type == "cuda" else 1
            else:
                try:
                    n = min(int(mode), ndev)
                except ValueError as e:
                    raise ErasureCodeError(f"bad shard {mode!r}") from e
        n = max(1, n)
        self._shard_devices_cached = n
        return n

    def _matmul_sharded(self, M: np.ndarray, n_shard: int,
                        kernel: str = "auto"):
        """(op, mesh): the folded region multiply fanned over a flat
        mesh of ``n_shard`` devices of the codec's kind
        (parallel/distributed.make_folded_matmul), each device running
        ``kernel`` on its column slice, the result assembled on the
        codec's device.  Cached in the op LRU beside the single-device
        ops, keyed by (kernel, fan-out, matrix); the mesh rides along so
        the caller can stage a host fold straight into its sharding.  A
        mesh that cannot be built raises ErasureCodeError (the reference
        returns None and falls back to one device)."""
        def build():
            from ..parallel.distributed import make_folded_matmul
            from ..parallel.mesh import devices, make_flat_mesh
            try:
                mesh = make_flat_mesh(n_shard,
                                      devices=devices(self.device.type))
            except (ValueError, RuntimeError) as e:
                raise ErasureCodeError(
                    f"no {n_shard}-device mesh of {self.device.type}: "
                    f"{e}") from e
            fn = make_folded_matmul(M, mesh, kernel=kernel)
            return (lambda rows: fn(rows).assemble(self.device)), mesh

        key = (b"shard" + kernel.encode() + b":"
               + n_shard.to_bytes(4, "little") + M.tobytes()
               + bytes(M.shape))
        return self._op_cached(key, build)

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
    def _matmul_device(self, M: np.ndarray, rows, *, n_shard: int = 1,
                       donate: bool = False):
        """Backend-resident region multiply: on the torch backend the
        result STAYS a tensor on the codec's device (no host copy), so
        callers folding many stripes into one launch pay one host copy
        for the whole batch.  The native and numpy backends return numpy.

        ``n_shard > 1`` fans the launch over a flat mesh, length axis
        sharded (_matmul_sharded), when the column count splits into
        whole uint32 lanes per device; anything else takes the
        single-device launch, byte-identical.  The sharded launch rides
        the kernel pinned for (matrix, bucket), racing the candidates'
        sharded ops on an unpinned signature.

        ``donate`` is accepted for the JAX package's signature and
        ignored: the port does not alias inputs yet."""
        if self._backend == "torch":
            L = int(rows.shape[-1])
            if n_shard > 1 and L % (4 * n_shard) == 0:
                pick = self._kernel_pick(M, L)
                if pick is None:
                    return self._race_matmul(M, rows, n_shard=n_shard)
                op, mesh = self._matmul_sharded(M, n_shard, kernel=pick)
                from ..parallel.distributed import stage_folded
                return self._profiled_launch(
                    op, stage_folded(rows, mesh),
                    self._matmul_sig(M, L, pick, n_shard))
            if isinstance(rows, np.ndarray):
                # one host->device copy, outside the timed launches (a
                # race would otherwise time the copy once per candidate)
                rows = torch.from_numpy(np.ascontiguousarray(
                    rows, dtype=np.uint8)).to(self.device)
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
        cannot see a few microseconds, behind a sleep of
        RACE_LEAD_CYCLES on the same stream so the window holds no host
        work; the host clock on the CPU."""
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            with torch.cuda.device(self.device):
                torch.cuda._sleep(self.RACE_LEAD_CYCLES)
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
                             avail: Sequence[int], stacked, *,
                             n_shard: int = 1):
        """Device-resident folded decode: ``stacked`` is a
        ``(len(avail), N)`` uint8 tensor on the codec's device whose rows
        are the survivor chunks in ``avail`` (sorted) order.  Returns a
        ``(len(want), N)`` tensor of the reconstructed rows in ``want``
        order, with NO host copy.

        Math is identical to decode_chunks (same decode-matrix cache,
        same single-row fast path, same parity-from-data product), so
        the bytes are identical to the per-op host path.  ``n_shard``
        fans each product out as _matmul_device does."""
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
                data_full = self._matmul_device(D, stack, n_shard=n_shard)
                for i in want_data:
                    rows[i] = data_full[i]
            else:
                sub = self._matmul_device(D[want_data], stack,
                                          n_shard=n_shard)
                for r, i in enumerate(want_data):
                    rows[i] = sub[r]
        if want_parity:
            par = self._matmul_device(
                self.matrix[[i - self.k for i in want_parity]], data_full,
                n_shard=n_shard)
            for r, i in enumerate(want_parity):
                rows[i] = par[r]
        return torch.stack([torch.as_tensor(rows[i]) for i in want])

    def _matmul(self, M: np.ndarray, rows: np.ndarray, *,
                n_shard: int = 1) -> np.ndarray:
        return self.host_sync(self._matmul_device(M, rows,
                                                  n_shard=n_shard))

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

    def _csum_op(self, nbytes: int, n_shard: int = 1):
        """Fused encode+CRC32C op for chunk length ``nbytes``:
        fn((k, batch*nbytes) data, numpy or a tensor) -> (parity
        (m, batch*nbytes), csums (k+m, batch) uint32) as tensors on the
        codec's device — parity and every per-chunk digest leave the
        device together.  Cached per (matrix, nbytes, fan-out) beside
        the region ops; the region kernel is resolved per launch width
        (_csum_graph_kernel) and its graph cached per kernel.

        ``n_shard > 1`` builds the mesh-sharded op
        (parallel/distributed.make_folded_csum): the length axis, and
        with it the per-chunk CRC, fans over a flat mesh, each device
        owning whole chunks (the caller pads the stripe count to a
        multiple of the fan-out).  A mesh that cannot be built raises
        ErasureCodeError (the reference returns None and sweeps the
        CRCs on the host)."""
        from ..models.stripe_codec import StripeCodec

        graphs: dict[str, object] = {}
        lock = threading.Lock()
        mesh = None
        if n_shard > 1:
            from ..parallel.mesh import devices, make_flat_mesh
            try:
                mesh = make_flat_mesh(n_shard,
                                      devices=devices(self.device.type))
            except (ValueError, RuntimeError) as e:
                raise ErasureCodeError(
                    f"no {n_shard}-device mesh of {self.device.type}: "
                    f"{e}") from e

        def graph(kern):
            if mesh is not None:
                from ..parallel.distributed import make_folded_csum
                fn = make_folded_csum(self.k, self.m, self.matrix, nbytes,
                                      mesh, kernel=kern)

                def sharded(data):
                    par, cs = fn(data)
                    return (par.assemble(self.device),
                            cs.assemble(self.device))

                return sharded
            codec = StripeCodec.__new__(StripeCodec)
            codec.k, codec.m = self.k, self.m
            codec.matrix = self.matrix
            return codec.encode_csum_graph(nbytes, kernel=kern)

        def op(data):
            if isinstance(data, np.ndarray) and mesh is None:
                data = torch.from_numpy(np.ascontiguousarray(
                    data, dtype=np.uint8)).to(self.device)
            kern = self._csum_graph_kernel(data, n_shard)
            with lock:
                fn = graphs.get(kern)
                if fn is None:
                    fn = graphs[kern] = graph(kern)
            return fn(data)

        return self._op_cached(self._csum_key(nbytes, n_shard), lambda: op)

    def _csum_graph_kernel(self, data, n_shard: int = 1) -> str:
        """Region kernel the fused op runs for the encode matrix at
        ``data``'s width (``data``: the k data rows, or the (k+m, N)
        stack they head): the kernel pinned for (matrix, width bucket)
        — an explicit profile pin, an earlier race, or, for an unpinned
        signature on the card, a race run now on the data rows (its
        parity is dropped; the fused op launches the winner), of the
        sharded ops when ``n_shard > 1``.  On the CPU the pin is the
        plain version."""
        M, L = self.matrix, int(data.shape[-1])
        pick = self._kernel_pick(M, L)
        if pick is None:
            self._race_matmul(M, data[: self.k], n_shard=n_shard)
            pick = self._kernel_pick(M, L)
        return pick

    def _csum_key(self, nbytes: int, n_shard: int = 1) -> bytes:
        """Op-LRU key of the fused encode+CRC op for this chunk length
        and fan-out — ONE definition."""
        return (b"csum:" + self.matrix.tobytes()
                + nbytes.to_bytes(8, "little")
                + n_shard.to_bytes(4, "little"))

    def _csum_op_if_ready(self, nbytes: int, n_shard: int = 1):
        """The fused op for chunk length ``nbytes``, at once on every
        device: the port compiles nothing per shape, so there is nothing
        to warm (the reference returns it at once only on a TPU and warms
        it in the background elsewhere)."""
        return self._csum_op(nbytes, n_shard)

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

    def decode_chunks(self, want: Sequence[int], chunks: ChunkMap, *,
                      n_shard: int = 1) -> ChunkMap:
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
                    data_full = self._matmul(D, stack, n_shard=n_shard)
                else:
                    # single-row recovery: multiply only the needed rows
                    data_full = np.zeros((self.k, L), dtype=np.uint8)
                    sub = self._matmul(D[want_data], stack,
                                       n_shard=n_shard)
                    for r, i in enumerate(want_data):
                        data_full[i] = sub[r]
            for i in want_data:
                out[i] = chunks[i] if i in chunks else data_full[i]
        if want_parity:
            parity = self._matmul(
                self.matrix[[i - self.k for i in want_parity]], data_full,
                n_shard=n_shard)
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
