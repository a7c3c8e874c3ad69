"""Cross-op EC batching: coalesce stripe work into single folded launches.

The counterpart of the JAX package's ``ceph_tpu/ec/batcher.py`` on the
port's ``torch`` backend.  The OSD hot path issues one synchronous
encode (or degraded-read decode) per client op, paying a full
host->device->host round trip per call.  Columns of a GF(2^8) region
matmul are independent, so concurrent full-stripe encodes (and decodes)
that share a ``(matrix, k, m)`` signature fold into ONE ``(k, sum L)``
launch with results scattered back per op.  arXiv:1709.05365 measures
online-EC throughput dominated by exactly this per-request coding
overhead.

Mechanics (no background thread, so nothing can leak at shutdown):

- a submitting thread appends its op to the queue for its signature and
  BLOCKS until its results are ready;
- the first op queued per signature is the *leader*: it waits out the
  coalescing window (``window_us``) on a condition variable, then flushes
  everything queued behind it (flush reason ``window``, or ``idle`` when
  it expired alone);
- an arrival that pushes a signature's pending source bytes past
  ``max_bytes`` flushes immediately itself (reason ``size``), waking the
  leader;
- ``window_us == 0`` is pass-through: the op executes inline through the
  codec's own per-op entry points — bit-identical to the unbatched path.

Adaptive window: with ``adaptive=True`` the coalescing window resizes
itself per flush from the observed ops-per-launch (EWMA toward
``target_ops``, clamped to [window_min_us, window_max_us]).

Length-bucketed padding: each op's chunk length pads up to a
power-of-two-or-1.5x-half-step bucket and the stripe count per launch
pads to a power of two, so launches see a bounded set of shapes.  Zero
columns encode/decode to zero under a linear code, so the padding is
sliced away without affecting bytes.

Device-resident ingest: on a CUDA codec each op's source bytes are
staged to the card in the SUBMITTING thread (utils/staging, pinned and
non_blocking, then an event on that thread's stream), padded to the
bucket, and the flush folds them on the
card (``torch.cat``, or, for a checksummed flush, a copy into the data
rows of the (k+m, N) buffer the fused op writes its parity into); an
input that is already a tensor (an arena hit) is borrowed, never
written.  On a CPU codec host bytes fold once on
the host.  Every flush leaves the device in ONE metered copy
(``host_sync_bulk`` -> ``staging.fetch_recorded``).

Streams: on the card a flush runs on its thread's own CUDA stream
(``staging.FlushStreams``, a small pool per batcher), which first waits
on the events of its ops' staging copies; its kernels, its digests and
its copy back all queue there, and it waits for its own outputs only.
Flushes of different threads overlap on the card; on the CPU the flush
compute sections serialize behind one lock.

Checksums: a launch whose ops all want csums and share one exact chunk
length (a multiple of 4) rides the codec's fused encode+CRC32C op —
parity and every per-chunk digest from one flush; otherwise the folded
parity launch is followed by one CRC32C launch per distinct length over
the ops' data and parity rows on the same device, whose digests ride
the flush's one copy back.  Only the numpy backend sweeps on the host.

Deep scrub: the ``verify`` op kind folds concurrent digest requests of
one length bucket into one CRC32C pass (ec/verify.py).

Sub-chunk codecs (CLAY, fold kind ``subchunk``): ops of one exact chunk
length fold on the host at plane granularity, and the codec's folded
entry points (``encode_chunks_folded``, ``decode_chunks_folded``) run
their coupling once and their plane products as folded launches on the
codec's device; concurrent repairs of one lost chunk from one helper set
fold into one ``repair_chunk_folded`` pass (``repair``).  A sub-chunk
flush's csums are a host CRC32C sweep over its host parity, as in the
JAX package.

Mesh fan-out: when a codec resolves a device fan-out above 1
(``shard`` / the ``ec_shard`` option, MatrixErasureCode.shard_devices),
a flush's folded ``(k, sum L)`` launch shards its length axis over a
flat mesh of logical devices (parallel/distributed.py): the stripe count
caps the fan-out and pads to a multiple of it (``shard_pad``), so each
device owns whole stripes, and a checksummed flush of one length takes
the mesh-sharded fused op.  Sharded launches are counted in
``stats["sharded_launches"]`` and the ``ec_batch_sharded_*`` counters.
A codec without fold kinds passes through.

Tracing: an op submitted with ``trace=(tracer, parent_ctx)`` gets an
``ec-batch-wait`` span covering queued -> flushed, and each flush emits
ONE shared ``ec-flush`` span tagged with the batch signature, n_ops,
bucket length, pad-waste ratio and flush reason (duck-typed: any tracer
whose spans offer ``tag``/``finish``/``ctx``/``span_id``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import checksum
from ..utils import staging
from ..utils.perf import CounterType
from .interface import ChunkMap
from .matrix_code import MatrixErasureCode, _host_csums


def _is_device(x) -> bool:
    """A device-resident input: a tensor (on the codec's device)."""
    return isinstance(x, torch.Tensor)


FLUSH_WINDOW = "window"
FLUSH_SIZE = "size"
FLUSH_IDLE = "idle"

#: perf counters the batcher registers on the registry it is handed —
#: ALWAYS registered (zeroed) even when batching is off/pass-through, so
#: `perf dump` exposes one stable schema
COUNTERS = ("ec_batch_launches", "ec_batch_coalesced_ops",
            "ec_batch_bytes", "ec_batch_flush_window",
            "ec_batch_flush_size", "ec_batch_flush_idle",
            "ec_batch_sharded_launches")
HISTOGRAMS = ("ec_batch_ops_per_launch", "ec_batch_bytes_per_launch",
              "ec_batch_sharded_devices_per_launch",
              "ec_batch_sharded_shard_bytes",
              # latency decomposition (microseconds, exemplar-linked
              # when the op rides a sampled trace): queued -> taken by
              # a flusher, and taken -> launch complete
              "ec_batch_wait_us", "ec_batch_flush_us")
#: settable gauges (CounterType.U64): the live adaptive-window value
GAUGES = ("ec_batch_window_us_now",)


def bucket_len(length: int) -> int:
    """Pad target for one op's chunk length: powers of two PLUS the
    1.5x half-steps between them (512, 768, 1024, 1536, 2048, ...),
    with a 512-byte floor (the uint32-lane tiling quantum of
    RegionMatmul).  Two shapes per octave; a just-over-pow2 chunk pads
    <= 50%."""
    b = 512
    while b < length:
        half = b + (b >> 1)
        if length <= half:
            return half
        b <<= 1
    return b


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def shard_pad(n2: int, n_shard: int) -> tuple[int, int]:
    """(effective fan-out, padded stripe count) a flush uses for a
    pow2-padded stripe count ``n2`` on an ``n_shard``-device pool: the
    fan-out caps at the stripe count (a 2-op flush on an 8-device pool
    shards 2 ways instead of inflating the fold 4x with empty slots),
    then the count rounds up to a multiple of the fan-out so sum L
    splits into whole per-device slices.  ONE definition shared by the
    flush paths and the bench warm-up loops."""
    ns = max(1, min(n_shard, n2))
    return ns, -(-n2 // ns) * ns


class _PendingOp:
    """One submitted encode/decode/repair/verify riding a folded launch."""

    __slots__ = ("codec", "streams", "chunks", "want", "length",
                 "with_csums", "callback", "deadline", "submitted",
                 "taken", "taken_at", "done", "parity", "csums",
                 "decoded", "error", "tspan", "dev", "dev_owned", "ready")

    def __init__(self, codec, *, streams=None, chunks=None, want=None,
                 length=0, with_csums=False, callback=None):
        self.codec = codec
        self.streams = streams      # encode: (k, L) uint8
        self.chunks = chunks        # decode: shard -> (L,) uint8
        self.want = want            # decode: shard ids to produce
        self.length = length
        self.with_csums = with_csums
        self.callback = callback
        self.deadline = 0.0
        self.submitted = 0.0
        self.taken = False          # removed from the queue by a flusher
        self.taken_at = 0.0         # monotonic instant of the take
        self.done = False
        self.parity = None
        self.csums = None
        self.decoded = None
        self.error: BaseException | None = None
        self.tspan = None           # ec-batch-wait span (traced ops)
        # device-resident ingest: the op's source bytes staged ONCE in
        # the SUBMITTING thread, padded to the length bucket — the flush
        # folds tensors instead of host bytes.  dev_owned marks tensors
        # the batcher created itself; a tensor handed in (an arena or
        # cache hit) is borrowed and is never written (the arena
        # immutability contract, ec/arena.py)
        self.dev = None
        self.dev_owned = False
        # an event after the staging copies on the submitting thread's
        # stream (None on the CPU): the flush's stream waits on it
        self.ready = None


class ECBatcher:
    """Coalesces concurrent same-signature EC stripe work per launch.

    Thread-safe; blocking ``encode``/``decode``/``repair``/``verify`` are
    the only entry points, so every pending op has a live waiter and none
    can leak.
    """

    #: adaptive-window controller constants: EWMA weight of the newest
    #: launch, the multiplicative shrink step per solo flush, and the
    #: probe cadence — every PROBE_EVERY-th flush the next leader waits
    #: the MAX window, so a batcher parked at the floor can still see a
    #: burst arrive and grow back
    ADAPT_ALPHA = 0.25
    ADAPT_SHRINK = 0.7
    PROBE_EVERY = 16

    #: adaptive-window resizes quieter than this ratio (vs the last
    #: journaled value) stay out of the event journal
    EVENT_RESIZE_RATIO = 1.5

    def __init__(self, *, window_us: float = 500.0,
                 max_bytes: int = 8 << 20, perf=None,
                 adaptive: bool = False, target_ops: float = 4.0,
                 window_min_us: float = 50.0,
                 window_max_us: float = 4000.0, events=None):
        self.window_us = float(window_us)
        self.max_bytes = int(max_bytes)
        # window_us == 0 disables batching outright (pass-through) and
        # the adaptive controller never engages
        self.adaptive = bool(adaptive) and self.window_us > 0
        # a target below 2 degenerates the controller (every 1-op flush
        # satisfies n_ops >= target)
        self.target_ops = max(2.0, float(target_ops))
        self.window_min_us = max(1.0, float(window_min_us))
        self.window_max_us = max(self.window_min_us, float(window_max_us))
        self._ops_ewma = self.target_ops  # neutral start: no drift
        self._flushes_since_probe = 0
        self._probe_next = False
        self._cv = threading.Condition()
        # CPU launch serialization: concurrent folded launches on the
        # host thrash one shared compute threadpool, so flush COMPUTE
        # sections serialize behind this lock there — the card keeps
        # overlapping (see _launch_ctx)
        self._launch_lock = threading.Lock()
        # the card: one stream per flushing thread
        self._streams = staging.FlushStreams()
        self._groups: dict[tuple, list[_PendingOp]] = {}
        self._group_bytes: dict[tuple, int] = {}
        self.stats = {"launches": 0, "ops": 0, "bytes": 0,
                      "sharded_launches": 0,
                      FLUSH_WINDOW: 0, FLUSH_SIZE: 0, FLUSH_IDLE: 0}
        self._perf = perf
        # optional event journal (duck-typed ``emit(kind, msg, **kw)``):
        # adaptive window regime changes
        self._events = events
        self._event_window = self.window_us
        if perf is not None:
            perf.add_many(COUNTERS)
            for h in HISTOGRAMS:
                perf.add(h, CounterType.HISTOGRAM)
            for g in GAUGES:
                perf.add(g, CounterType.U64)
            perf.set("ec_batch_window_us_now", round(self.window_us, 1))

    # ------------------------------------------------------------- public
    def encode(self, codec, data_chunks, *, with_csums: bool = False,
               callback: Callable | None = None,
               trace: tuple | None = None):
        """Encode one op's (k, L) data chunks; returns (parity, csums)
        exactly as the per-op codec entry points would.  Blocks until the
        folded launch carrying this op completes; ``callback(parity,
        csums)`` (if given) fires before the call returns.

        A tensor input (e.g. served from the device arena) stays on the
        device: it is padded and folded there and never copied back
        through the host."""
        if not (_is_device(data_chunks)
                and data_chunks.dtype == torch.uint8):
            data_chunks = np.ascontiguousarray(data_chunks,
                                               dtype=np.uint8)
        L = int(data_chunks.shape[-1]) if data_chunks.ndim else 0
        kind = (codec.encode_fold_kind()
                if isinstance(codec, MatrixErasureCode) else None)
        if not (data_chunks.ndim == 2
                and data_chunks.shape[0] == codec.k  # bad shape:
                # per-op path raises the codec's own error without
                # poisoning coalesced neighbors
                and L > 0):
            kind = None
        if kind == "subchunk" and (L % codec.get_sub_chunk_count()
                                   or _is_device(data_chunks)):
            # sub-chunk codecs fold host bytes at plane granularity; a
            # misaligned length takes the codec's own error per op
            kind = None
        if self.window_us <= 0 or kind is None:
            return self._passthrough_encode(codec, data_chunks,
                                            with_csums, callback)
        # codec identity rides the signature: two codecs sharing a
        # matrix's bytes+shape must not coalesce into one fold.  A
        # sub-chunk fold is exact-L: its segments cannot pad inside an
        # op (the plane reshape would cross real-byte boundaries)
        sig = ("enc", codec.fold_sig(), codec.matrix.tobytes(),
               codec.k, codec.m, bool(with_csums),
               L if kind == "subchunk" else bucket_len(L))
        op = _PendingOp(codec, streams=data_chunks, length=L,
                        with_csums=with_csums, callback=callback)
        self._trace_submit(op, trace, sig)
        if kind == "plain":
            self._stage_encode_op(op, sig[-1])
            flush = self._flush_encode
        else:
            flush = self._flush_encode_subchunk
        self._submit(sig, op, _nbytes(data_chunks), flush)
        if op.error is not None:
            raise op.error
        return op.parity, op.csums

    def decode(self, codec, want: Sequence[int], chunks: ChunkMap, *,
               callback: Callable | None = None,
               trace: tuple | None = None) -> ChunkMap:
        """Batched counterpart of ``ErasureCode.decode``: present shards
        pass through, missing ones reconstruct via a coalesced decode
        launch shared with concurrent same-signature ops (same survivor
        set, same (matrix, k, m), same length bucket)."""
        want = list(want)
        need = sorted(i for i in want if i not in chunks)
        if not need:
            out = {i: chunks[i] for i in want}
            if callback is not None:
                callback(out)
            return out
        arrays = {i: (c if _is_device(c) and c.dtype == torch.uint8
                      else np.ascontiguousarray(c, dtype=np.uint8))
                  for i, c in chunks.items()}
        lengths = {int(c.shape[-1]) for c in arrays.values()}
        kind = (codec.decode_fold_kind()
                if isinstance(codec, MatrixErasureCode) else None)
        if not (len(lengths) == 1
                and all(c.ndim == 1 for c in arrays.values())
                and 0 not in lengths):
            kind = None
        if self.window_us <= 0:  # pass-through: skip the fold-rows
            # resolution an inline op would never use
            kind = None
        avail = tuple(sorted(arrays))
        if kind == "plain" and codec.fold_rows(need, avail) is None:
            # this erasure cannot fold (not enough survivors, or no
            # invertible subset): the per-op path surfaces the codec's
            # own error without poisoning coalesced neighbors
            kind = None
        if kind == "subchunk" and \
                next(iter(lengths)) % codec.get_sub_chunk_count():
            kind = None
        if kind is None:
            return self._passthrough_decode(codec, want, chunks, callback)
        L = lengths.pop()
        sig = ("dec", codec.fold_sig(), codec.matrix.tobytes(),
               codec.k, codec.m, avail, tuple(need),
               L if kind == "subchunk" else bucket_len(L))
        # the callback is fired below by THIS thread, after present
        # shards merge back in — not by the flusher
        op = _PendingOp(codec, chunks=arrays, want=need, length=L)
        self._trace_submit(op, trace, sig)
        if kind == "plain":
            self._stage_decode_op(op, sig)
            flush = self._flush_decode
        else:
            flush = self._flush_decode_subchunk
        nbytes = sum(_nbytes(c) for c in arrays.values())
        self._submit(sig, op, nbytes, flush)
        if op.error is not None:
            raise op.error
        out = dict(op.decoded)
        for i in want:
            if i in chunks:
                out[i] = chunks[i]
        out = {i: out[i] for i in want}
        if callback is not None:
            self._fire(op, callback, out)
            if op.error is not None:
                raise op.error
        return out

    def repair(self, codec, lost: int, helper_subchunks: ChunkMap,
               L: int, *, trace: tuple | None = None) -> np.ndarray:
        """Batched sub-chunk repair (CLAY MSR): concurrent repairs of the
        SAME lost chunk from the same helper set — the recovery-storm
        shape, one downed OSD's shard rebuilt across many objects — fold
        into one repair pass whose parity-check products run once over
        the whole launch (repair_chunk_folded).  Returns the repaired
        chunk exactly as ``codec.repair_chunk`` would."""
        helpers = {h: _host(c) for h, c in helper_subchunks.items()}
        nbytes = sum(c.nbytes for c in helpers.values())
        foldable = (self.window_us > 0
                    and hasattr(codec, "repair_chunk_folded")
                    and L > 0
                    and L % codec.get_sub_chunk_count() == 0)
        if not foldable:
            out = codec.repair_chunk(lost, helpers, L)
            self._account(1, nbytes, FLUSH_IDLE)
            return out
        sig = ("rep", codec.fold_sig(), lost, tuple(sorted(helpers)), L)
        op = _PendingOp(codec, chunks=helpers, want=[lost], length=L)
        self._trace_submit(op, trace, sig)
        self._submit(sig, op, nbytes, self._flush_repair)
        if op.error is not None:
            raise op.error
        return op.decoded

    def verify(self, verifier, rows: np.ndarray, *,
               trace: tuple | None = None) -> np.ndarray:
        """Batched digest verification (deep scrub, ec/verify.py):
        concurrent scrub chunks whose objects padded to the same length
        bucket fold into ONE CRC launch — (n, L) uint8 rows in, (n,)
        uint32 standard CRC32C out, rows scattered back per op.  The
        ``verifier`` rides the codec slot (it carries the same
        ``fold_sig`` protocol surface) but no coding matrix — replicated
        pools verify through the same seam."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        n, L = rows.shape
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        if self.window_us <= 0:
            out = verifier.digests(rows)
            self._account(1, rows.nbytes, FLUSH_IDLE)
            return out
        sig = ("ver", verifier.fold_sig(), L)
        op = _PendingOp(verifier, streams=rows, length=L)
        self._trace_submit(op, trace, sig)
        self._submit(sig, op, rows.nbytes, self._flush_verify)
        if op.error is not None:
            raise op.error
        return op.decoded

    def pending_ops(self) -> int:
        """Ops queued and not yet taken by a flusher (0 when quiescent)."""
        with self._cv:
            return sum(len(q) for q in self._groups.values())

    # ------------------------------------------- device-resident ingest
    def _stage_encode_op(self, op: _PendingOp, bucket: int) -> None:
        """Stage one encode op's (k, L) source bytes to the codec's
        device in the SUBMITTING thread, padded to the bucket: copied to
        the card ONCE on ingest — metered by ec_stage_h2d_* — so the
        flush folds tensors with one concat instead of a host memcpy
        and a whole-fold copy per launch, and staging parallelizes
        across submitters.  A tensor input (an arena hit) skips the copy
        and is only *borrowed*.  Host bytes on a CPU codec stay on the
        host (dev stays None): the flush folds them once."""
        codec = op.codec
        if getattr(codec, "_backend", None) != "torch":
            return
        data, L = op.streams, op.length
        if isinstance(data, np.ndarray):
            if staging.backend_is_cpu(codec.device):
                return
            if L < bucket:
                data = np.pad(data, ((0, 0), (0, bucket - L)))
            op.dev = staging.device_put_landed(
                data, codec.device, force=False,
                exemplar=self._op_exemplar(op))
            op.dev_owned = True
        else:
            dev = data.to(codec.device)
            if L < bucket:
                op.dev = F.pad(dev, (0, bucket - L))
                op.dev_owned = True  # the pad made a fresh tensor
            else:
                op.dev = dev
                op.dev_owned = dev.data_ptr() != data.data_ptr()
        op.ready = staging.record_ready(codec.device)

    def _stage_decode_op(self, op: _PendingOp, sig: tuple) -> None:
        """Decode counterpart: stack the op's fold rows (sorted shard
        order, the flush's row layout) into ONE (k, bucket) tensor on
        the codec's device in the submitting thread.  Mixed host/device
        chunk sets stack on the device; all-host sets stack and pad on
        the host and stage with one copy.  On a CPU codec all-host sets
        stay on the host (the flush folds them)."""
        codec = op.codec
        if getattr(codec, "_backend", None) != "torch":
            return
        bucket = sig[-1]
        # only the codec's fold rows feed the decode (the first k sorted
        # survivors) — staging any other survivor row would be waste
        rows = [op.chunks[s] for s in self._fold_rows_for(codec, sig)]
        if all(isinstance(r, np.ndarray) for r in rows):
            if staging.backend_is_cpu(codec.device):
                return
            arr = np.stack(rows)
            if op.length < bucket:
                arr = np.pad(arr, ((0, 0), (0, bucket - op.length)))
            op.dev = staging.device_put_landed(
                arr, codec.device, force=False,
                exemplar=self._op_exemplar(op))
        else:
            stacked = torch.stack([
                r.to(codec.device) if _is_device(r)
                else torch.from_numpy(r).to(codec.device) for r in rows])
            if op.length < bucket:
                stacked = F.pad(stacked, (0, bucket - op.length))
            op.dev = stacked
        op.dev_owned = True  # stack always makes a fresh tensor
        op.ready = staging.record_ready(codec.device)

    @staticmethod
    def _fold_rows_for(codec, sig: tuple) -> list[int]:
        """Survivor rows a folded decode launch consumes, resolved
        through the codec's fold protocol (decode() already verified
        they exist for this signature)."""
        rows = codec.fold_rows(list(sig[6]), sig[5])
        if rows is None:  # cannot happen after decode()'s gate, but a
            # flush must never crash the group on a protocol slip
            rows = [s for s in sig[5]
                    if s < codec.chunk_count][: codec.k]
        return rows

    # ----------------------------------------------------------- tracing
    @staticmethod
    def _sig_tag(sig: tuple) -> str:
        """Human-readable batch-signature tag (the raw sig embeds the
        whole coding matrix): kind/codec/k.m/length-bucket."""
        if sig[0] == "rep":
            return f"rep/{sig[1][0]}/lost{sig[2]}/L{sig[-1]}"
        if sig[0] == "ver":
            return f"ver/{sig[1][0]}/L{sig[-1]}"
        return f"{sig[0]}/{sig[1][0]}/k{sig[3]}m{sig[4]}/L{sig[-1]}"

    def _trace_submit(self, op: _PendingOp, trace: tuple | None,
                      sig: tuple) -> None:
        """Start the op's ec-batch-wait span (queued -> flushed)."""
        if trace is None:
            return
        tracer, ctx = trace
        op.tspan = tracer.start("ec-batch-wait", parent=ctx,
                                sig=self._sig_tag(sig))

    def _trace_flush(self, sig: tuple, ops: list[_PendingOp],
                     reason: str):
        """One shared ec-flush span per flush, parented under the first
        traced op's wait span; every traced op's wait span finishes now
        and tags the flush span's id."""
        tops = [o for o in ops if o.tspan is not None]
        if not tops:
            return None
        lead = tops[0].tspan
        fspan = lead._tracer.start("ec-flush", parent=lead.ctx,
                                   sig=self._sig_tag(sig),
                                   n_ops=len(ops), reason=reason)
        for o in tops:
            o.tspan.tag("flush_span", fspan.span_id)
            o.tspan.tag("flush_reason", reason)
            o.tspan.finish()
        return fspan

    @staticmethod
    def _trace_flush_done(fspan, *, bucket: int, src_cols: int,
                          padded_cols: int, n_shard: int) -> None:
        """Close the flush span with the launch-shape tags: bucket
        length, pad-waste ratio (padded columns that carried no op
        bytes), and the device fan-out."""
        if fspan is None:
            return
        waste = (1.0 - src_cols / padded_cols) if padded_cols else 0.0
        fspan.tag("bucket", bucket)
        fspan.tag("pad_waste", round(waste, 4))
        fspan.tag("n_shard", n_shard)
        fspan.finish()

    # ------------------------------------------------- submit/wait machinery
    def _submit(self, sig: tuple, op: _PendingOp, nbytes: int,
                flush) -> None:
        ops = reason = None
        with self._cv:
            q = self._groups.setdefault(sig, [])
            op.submitted = time.monotonic()
            if q:
                # the group's window is the LEADER's: a follower must
                # not cut a longer (probe) window short
                op.deadline = q[0].deadline
            else:
                w = self.window_us
                if self.adaptive and self._probe_next:
                    self._probe_next = False
                    w = self.window_max_us
                op.deadline = op.submitted + w * 1e-6
            q.append(op)
            total = self._group_bytes.get(sig, 0) + nbytes
            self._group_bytes[sig] = total
            if total >= self.max_bytes:
                ops, reason = self._take_locked(sig), FLUSH_SIZE
            else:
                while not op.done:
                    now = time.monotonic()
                    if not op.taken and now >= op.deadline:
                        ops = self._take_locked(sig)
                        reason = (FLUSH_WINDOW if len(ops) > 1
                                  else FLUSH_IDLE)
                        break
                    self._cv.wait(timeout=None if op.taken
                                  else max(0.0, op.deadline - now))
        if ops is not None:
            flush(sig, ops, reason)
        if not op.done:  # flushed by another thread after we broke out
            with self._cv:
                while not op.done:
                    self._cv.wait()

    def _take_locked(self, sig: tuple) -> list[_PendingOp]:
        ops = self._groups.pop(sig, [])
        self._group_bytes.pop(sig, None)
        now = time.monotonic()
        for o in ops:
            o.taken = True
            o.taken_at = now
        return ops

    @staticmethod
    def _op_exemplar(op: _PendingOp):
        """The op's sampled trace_id (exemplar), or None."""
        sp = op.tspan
        return sp.trace_id if sp is not None and sp.sampled else None

    def _complete(self, ops: list[_PendingOp], src_bytes: int,
                  reason: str, n_shard: int = 1,
                  shard_bytes: int = 0) -> None:
        p = self._perf
        if p is not None and ops:
            # wait (queued -> taken) per op, flush (taken -> done) once
            # per launch; sampled ops pin their trace_id on the bucket
            now = time.monotonic()
            lead_ex = None
            for o in ops:
                ex = self._op_exemplar(o)
                if lead_ex is None:
                    lead_ex = ex
                if o.taken_at:
                    p.hinc("ec_batch_wait_us",
                           max(0.0, o.taken_at - o.submitted) * 1e6,
                           exemplar=ex)
            t0 = min((o.taken_at for o in ops if o.taken_at),
                     default=0.0)
            if t0:
                p.hinc("ec_batch_flush_us", max(0.0, now - t0) * 1e6,
                       exemplar=lead_ex)
        self._account(len(ops), src_bytes, reason, n_shard, shard_bytes)
        self._adapt(ops)
        with self._cv:
            for o in ops:
                o.done = True
            self._cv.notify_all()

    def _shard_fanout(self, codec, n2: int) -> tuple[int, int]:
        """(fan-out, padded stripe count) for this flush — the codec's
        resolved shard count run through shard_pad (capped at the
        stripe count, count rounded up to the fan-out)."""
        sd = getattr(codec, "shard_devices", None)
        if sd is None:
            return 1, n2
        return shard_pad(n2, sd())

    def _adapt(self, ops: list[_PendingOp]) -> None:
        """One controller step per flush: EWMA the launch's op count,
        then steer the window.  Any flush that actually coalesced (>= 2
        ops) measures the ops' arrival span and the window moves halfway
        toward the span a target-sized group needs (x1.25 margin) —
        converging from both sides; launches flying alone shrink it
        toward the floor."""
        if not self.adaptive:
            return
        n_ops = len(ops)
        with self._cv:
            a = self.ADAPT_ALPHA
            self._ops_ewma = (1 - a) * self._ops_ewma + a * n_ops
            self._flushes_since_probe += 1
            if self._flushes_since_probe >= self.PROBE_EVERY:
                self._flushes_since_probe = 0
                self._probe_next = True
            w = self.window_us
            if n_ops >= 2:
                span = (max(o.submitted for o in ops)
                        - min(o.submitted for o in ops))
                est = (span / (n_ops - 1)
                       * (self.target_ops - 1) * 1.25 * 1e6)
                w = 0.5 * w + 0.5 * est
            elif self._ops_ewma < max(1.5, self.target_ops / 2):
                # launches flying alone: waiting buys nothing
                w = w * self.ADAPT_SHRINK
            w = min(self.window_max_us, max(self.window_min_us, w))
            self.window_us = w
            # regime-change journaling inside the cv: the decision must
            # be atomic with the _event_window check-and-set
            if self._events is not None and (
                    w >= self._event_window * self.EVENT_RESIZE_RATIO
                    or w <= self._event_window / self.EVENT_RESIZE_RATIO):
                self._events.emit(
                    "batch",
                    f"ec batch window resized to {w:.0f}us",
                    window_us=round(w, 1),
                    prev_us=round(self._event_window, 1),
                    ops_ewma=round(self._ops_ewma, 2))
                self._event_window = w
        if self._perf is not None:
            # the CLAMPED value the batcher actually uses
            self._perf.set("ec_batch_window_us_now", round(w, 1))

    def _fire(self, op: _PendingOp, callback: Callable, *args) -> None:
        try:
            callback(*args)
        except BaseException as e:  # surfaced to the op's own waiter
            op.error = e

    def _account(self, n_ops: int, src_bytes: int, reason: str,
                 n_shard: int = 1, shard_bytes: int = 0) -> None:
        with self._cv:
            self.stats["launches"] += 1
            self.stats["ops"] += n_ops
            self.stats["bytes"] += src_bytes
            self.stats[reason] += 1
            if n_shard > 1:
                self.stats["sharded_launches"] += 1
        p = self._perf
        if p is not None:
            p.inc("ec_batch_launches")
            p.inc("ec_batch_coalesced_ops", n_ops)
            p.inc("ec_batch_bytes", src_bytes)
            p.inc(f"ec_batch_flush_{reason}")
            p.hinc("ec_batch_ops_per_launch", n_ops)
            p.hinc("ec_batch_bytes_per_launch", src_bytes)
            if n_shard > 1:
                p.inc("ec_batch_sharded_launches")
                p.hinc("ec_batch_sharded_devices_per_launch", n_shard)
                p.hinc("ec_batch_sharded_shard_bytes", shard_bytes)

    # ------------------------------------------------------- pass-through
    def _passthrough_encode(self, codec, data_chunks, with_csums,
                            callback):
        enc_csum = getattr(codec, "encode_chunks_with_csums", None)
        if with_csums and enc_csum is not None:
            parity, csums = enc_csum(data_chunks)
        else:
            parity, csums = codec.encode_chunks(data_chunks), None
        self._account(1, _nbytes(data_chunks), FLUSH_IDLE)
        if callback is not None:
            callback(parity, csums)
        return parity, csums

    def _passthrough_decode(self, codec, want, chunks, callback):
        out = codec.decode(want, chunks)
        self._account(1, sum(_nbytes(c) for c in chunks.values()),
                      FLUSH_IDLE)
        if callback is not None:
            callback(out)
        return out

    # ------------------------------------------------------------ flushes
    def _launch_ctx(self, codec, ops=()):
        """Context the flush's compute section runs under: on a CPU
        device a per-batcher lock (overlapping launches thrash the one
        host threadpool); on the card the flushing thread's own stream,
        after the staging events of ``ops``, with their device tensors
        marked as used there (a host-only codec: nothing)."""
        device = getattr(codec, "device", None)
        if device is None:
            return contextlib.nullcontext()
        if staging.backend_is_cpu(device):
            return self._launch_lock
        return self._streams.flush(
            torch.device(device), waits=[o.ready for o in ops],
            uses=[t for o in ops for t in _op_tensors(o)])

    @staticmethod
    def _fold_host_rows(parts, lengths, width: int, n_rows: int,
                        n_str: int) -> np.ndarray:
        """Assemble the (n_rows, n_str * width) host fold with
        ``np.empty`` + pad-only zeroing: every op's columns are fully
        overwritten, so only the per-op pad tails and the empty trailing
        slots need zeros."""
        folded = np.empty((n_rows, n_str * width), dtype=np.uint8)
        col = 0
        for part, length in zip(parts, lengths):
            folded[:, col:col + length] = part
            if length < width:
                folded[:, col + length:col + width] = 0
            col += width
        if col < folded.shape[1]:
            folded[:, col:] = 0
        return folded

    @staticmethod
    def _fold_device(ops: list[_PendingOp], width: int, n_rows: int,
                     n_str: int, total_rows: int | None = None
                     ) -> tuple[torch.Tensor, bool]:
        """Concatenate the ops' ingest-staged tensors into the folded
        (n_rows, n_str * width) launch tensor — all on the device, no
        host memcpy.  Returns (folded, owned): ``owned`` means every byte
        of the fold is batcher-created scratch; a borrowed arena tensor
        riding the fold alone is not.

        ``total_rows`` > n_rows folds into the first n_rows of a new
        (total_rows, n_str * width) scratch buffer instead, whose other
        rows the launch fills (the fused encode+CRC op writes the parity
        there: the port's form of the reference's donation)."""
        if total_rows is not None:
            buf = torch.empty((total_rows, n_str * width), dtype=torch.uint8,
                              device=ops[0].dev.device)
            for i, o in enumerate(ops):
                buf[:n_rows, i * width:(i + 1) * width] = o.dev[:, :width]
            buf[:n_rows, len(ops) * width:] = 0
            return buf, True
        parts, owned = [], True
        for o in ops:
            d = o.dev
            part_owned = o.dev_owned
            if int(d.shape[-1]) != width:
                d = d[:, :width]  # exact-length slice of the bucket pad
            parts.append(d)
            owned = owned and part_owned
        pad = (n_str - len(ops)) * width
        if pad:
            parts.append(torch.zeros((n_rows, pad), dtype=torch.uint8,
                                     device=parts[0].device))
        if len(parts) == 1:
            return parts[0], owned
        return torch.cat(parts, dim=1), True

    @staticmethod
    def _device_csums(ops: list[_PendingOp], folded: torch.Tensor,
                      dev_parity: torch.Tensor, width: int
                      ) -> tuple[torch.Tensor | None, list[int]]:
        """CRC32C of the data and parity rows of every checksummed op of
        an unfused flush, on the fold's device: one G1 launch per
        distinct length over the ops' (k+m, L) stacks.  Returns the
        (n, k+m) digests and the index in ``ops`` of each of their rows
        (None and an empty order when no op wants csums)."""
        by_len: dict[int, list[int]] = {}
        for i, o in enumerate(ops):
            if o.with_csums:
                by_len.setdefault(o.length, []).append(i)
        parts, order = [], []
        for length, idx in by_len.items():
            rows = torch.cat([x[:, i * width: i * width + length]
                              for i in idx for x in (folded, dev_parity)])
            parts.append(checksum.row_csums(rows).reshape(len(idx), -1))
            order += idx
        if not parts:
            return None, order
        return (parts[0] if len(parts) == 1 else torch.cat(parts)), order

    def _sync_flush(self, codec, devs, fspan, sig: tuple):
        """The flush's SINGLE device->host copy (ec_stage_d2h_* meters
        it; copies/flush == 1): every output of the folded launch
        materializes in one host_sync_bulk event, shown as a ``staging``
        child span of the flush when traced."""
        sig_str = f"sync/flush/{self._sig_tag(sig)}"
        if fspan is not None:
            with fspan._tracer.start("staging", parent=fspan.ctx,
                                     dir="d2h") as sp:
                out = codec.host_sync_bulk(devs, sig=sig_str)
                sp.tag("bytes", sum(o.nbytes for o in out))
            return out
        return codec.host_sync_bulk(devs, sig=sig_str)

    def _flush_encode(self, sig: tuple, ops: list[_PendingOp],
                      reason: str) -> None:
        bucket = sig[-1]
        codec = ops[0].codec
        k = codec.k
        src_bytes = sum(_nbytes(o.streams) for o in ops)
        ns, shard_bytes = 1, 0
        padded_cols = 0
        fspan = self._trace_flush(sig, ops, reason)
        try:
            # stripe-count padding (bounded shapes), then rounded to the
            # fan-out so every device owns whole stripes
            ns, n2 = self._shard_fanout(codec, _pow2(len(ops)))
            # fused needs one EXACT chunk length across the launch (the
            # device CRC is per whole chunk — a padded chunk would
            # digest its padding); the shared length need not be a
            # power of two.  A sharded pool gets the mesh-sharded fused
            # op (each device owns whole chunks, so its digests are the
            # native sweep's)
            L0 = ops[0].length
            op_fn = None
            if (sig[5]  # every op in the group wants csums
                    and getattr(codec, "_backend", None) == "torch"
                    and all(o.length == L0 for o in ops)
                    and L0 % 4 == 0):
                op_fn = codec._csum_op_if_ready(L0, n_shard=ns)
            if op_fn is not None:
                # ONE flush: parity + per-chunk CRC32C for every stripe
                # in the launch (csums (k+m, n2), one column per stripe)
                padded_cols = n2 * L0
                with self._launch_ctx(codec, ops):
                    if all(o.dev is not None for o in ops):
                        # device-resident fold: exact-L0 slices of the
                        # bucket-padded tensors, copied on the card into
                        # the data rows of the (k+m, n2*L0) stack the
                        # fused op writes its parity into
                        folded, _owned = self._fold_device(
                            ops, L0, k, n2, total_rows=k + codec.m)
                    else:
                        folded = self._fold_host_rows(
                            [_host(o.streams) for o in ops],
                            [L0] * len(ops), L0, k, n2)
                    dev_parity, dev_csums = codec._profiled_launch(
                        op_fn, folded,
                        f"csum/{codec.m}x{k}/L{L0}x{n2 * L0}"
                        + (f"/s{ns}" if ns > 1 else ""))
                    # parity AND csums leave the device in the flush's
                    # one metered copy
                    parity, csums = self._sync_flush(
                        codec, (dev_parity, dev_csums), fspan, sig)
                shard_bytes = k * n2 * L0 // ns if ns > 1 else 0
                for i, o in enumerate(ops):
                    # copy out of the launch buffer: a retained per-op
                    # result must not pin the whole (m, n2*L) fold
                    o.parity = parity[:, i * L0: (i + 1) * L0].copy()
                    o.csums = csums[:, i].copy()
            else:
                padded_cols = n2 * bucket
                on_device = getattr(codec, "_backend", None) == "torch"
                with self._launch_ctx(codec, ops):
                    if all(o.dev is not None for o in ops):
                        # device-resident plane: fold on the card, ONE
                        # metered copy back per flush
                        folded, owned = self._fold_device(ops, bucket, k,
                                                          n2)
                    else:
                        # host fold (CPU device / numpy backend): one
                        # memcpy into the launch tensor, and the same ONE
                        # metered copy back per flush as the device fold
                        folded, owned = self._fold_host_rows(
                            [_host(o.streams) for o in ops],
                            [o.length for o in ops], bucket, k, n2), True
                        if on_device:
                            folded = torch.from_numpy(folded).to(
                                codec.device)
                    dev_parity = codec._matmul_device(
                        codec.matrix, folded, n_shard=ns,
                        donate=owned and ns == 1)
                    outs, order = (dev_parity,), []
                    if on_device:
                        # digests the fused op could not give (several
                        # lengths, or one not a whole number of words):
                        # G1 on the same device, in the same copy back
                        dev_csums, order = self._device_csums(
                            ops, folded, dev_parity, bucket)
                        if order:
                            outs += (dev_csums,)
                    synced = self._sync_flush(codec, outs, fspan, sig)
                    parity = synced[0]
                shard_bytes = k * n2 * bucket // ns if ns > 1 else 0
                for i, o in enumerate(ops):
                    o.parity = \
                        parity[:, i * bucket: i * bucket + o.length].copy()
                for j, i in enumerate(order):
                    ops[i].csums = synced[1][j].copy()
                for o in ops:
                    if o.with_csums and not on_device:
                        o.csums = _host_csums(np.concatenate(
                            [_host(o.streams), o.parity], axis=0))
            for o in ops:
                if o.callback is not None:
                    self._fire(o, o.callback, o.parity, o.csums)
        except BaseException as e:
            for o in ops:
                o.error = e
        finally:
            self._trace_flush_done(
                fspan, bucket=bucket,
                src_cols=sum(o.length for o in ops),
                padded_cols=padded_cols, n_shard=ns)
            self._complete(ops, src_bytes, reason, ns, shard_bytes)

    def _flush_decode(self, sig: tuple, ops: list[_PendingOp],
                      reason: str) -> None:
        bucket = sig[-1]
        codec = ops[0].codec
        avail, want = sig[5], list(sig[6])
        src_bytes = sum(sum(_nbytes(c) for c in o.chunks.values())
                        for o in ops)
        ns, shard_bytes = 1, 0
        padded_cols = 0
        fspan = self._trace_flush(sig, ops, reason)
        try:
            ns, n2 = self._shard_fanout(codec, _pow2(len(ops)))
            padded_cols = n2 * bucket
            if getattr(codec, "_backend", None) == "torch":
                # device-resident plane: the survivor stacks (staged at
                # ingest on the card, host-folded on a CPU device) feed
                # ONE folded decode that runs device-to-device
                # (decode_folded_device — decode matrix product + parity
                # product with no host copy in between), and every
                # waiter's rows carve out of ONE bulk copy per launch
                avail_ids = self._fold_rows_for(codec, sig)
                with self._launch_ctx(codec, ops):
                    if all(o.dev is not None for o in ops):
                        folded, _owned = self._fold_device(
                            ops, bucket, len(avail_ids), n2)
                    else:
                        host = np.empty((len(avail_ids), n2 * bucket),
                                        dtype=np.uint8)
                        for i, o in enumerate(ops):
                            c0 = i * bucket
                            for j, s in enumerate(avail_ids):
                                host[j, c0: c0 + o.length] = \
                                    _host(o.chunks[s])
                            if o.length < bucket:
                                host[:, c0 + o.length: c0 + bucket] = 0
                        if len(ops) < n2:
                            host[:, len(ops) * bucket:] = 0
                        folded = torch.from_numpy(host).to(codec.device)
                    out_dev = codec.decode_folded_device(
                        want, avail_ids, folded, n_shard=ns)
                    (out_np,) = self._sync_flush(codec, (out_dev,),
                                                 fspan, sig)
                shard_bytes = (len(avail_ids) * n2 * bucket // ns
                               if ns > 1 else 0)
                for i, o in enumerate(ops):
                    o.decoded = {
                        s: out_np[j, i * bucket: i * bucket + o.length
                                  ].copy()
                        for j, s in enumerate(want)}
            else:
                flat = {s: np.zeros(n2 * bucket, dtype=np.uint8)
                        for s in avail}
                for i, o in enumerate(ops):
                    for s, c in o.chunks.items():
                        flat[s][i * bucket: i * bucket + o.length] = \
                            _host(c)
                out = codec.decode_chunks(want, flat, n_shard=ns)
                shard_bytes = (sum(c.nbytes for c in flat.values())
                               // ns if ns > 1 else 0)
                for i, o in enumerate(ops):
                    # copy out of the launch buffer (see _flush_encode)
                    o.decoded = {
                        s: row[i * bucket: i * bucket + o.length].copy()
                        for s, row in out.items()}
        except BaseException as e:
            for o in ops:
                o.error = e
        finally:
            self._trace_flush_done(
                fspan, bucket=bucket,
                src_cols=sum(o.length for o in ops),
                padded_cols=padded_cols, n_shard=ns)
            self._complete(ops, src_bytes, reason, ns, shard_bytes)

    # CLAY (any codec of fold kind "subchunk") folds at plane
    # granularity: the ops' exact-L segments fold on the HOST (the plane
    # transpose is O(bytes) numpy), and the codec's folded entry point
    # runs its coupling once on the host and its plane products as
    # folded launches on its device, on this thread's stream.

    def _flush_encode_subchunk(self, sig: tuple, ops: list[_PendingOp],
                               reason: str) -> None:
        L = sig[-1]
        codec = ops[0].codec
        src_bytes = sum(_nbytes(o.streams) for o in ops)
        ns, shard_bytes = 1, 0
        padded_cols = 0
        fspan = self._trace_flush(sig, ops, reason)
        try:
            ns, n2 = self._shard_fanout(codec, _pow2(len(ops)))
            padded_cols = n2 * L
            with self._launch_ctx(codec, ops):
                folded = self._fold_host_rows(
                    [o.streams for o in ops], [L] * len(ops), L,
                    codec.k, n2)
                # zero stripe slots encode to zero parity (a linear
                # code: zero data, zero uncoupled planes, zero parity),
                # so the pow2 padding slices away clean
                parity = codec.encode_chunks_folded(folded, n2, L,
                                                    n_shard=ns)
            shard_bytes = folded.nbytes // ns if ns > 1 else 0
            for i, o in enumerate(ops):
                o.parity = parity[:, i * L: (i + 1) * L].copy()
                if o.with_csums:
                    o.csums = _host_csums(
                        np.concatenate([o.streams, o.parity], axis=0))
            for o in ops:
                if o.callback is not None:
                    self._fire(o, o.callback, o.parity, o.csums)
        except BaseException as e:
            for o in ops:
                o.error = e
        finally:
            self._trace_flush_done(
                fspan, bucket=L, src_cols=sum(o.length for o in ops),
                padded_cols=padded_cols, n_shard=ns)
            self._complete(ops, src_bytes, reason, ns, shard_bytes)

    def _flush_decode_subchunk(self, sig: tuple, ops: list[_PendingOp],
                               reason: str) -> None:
        L = sig[-1]
        codec = ops[0].codec
        avail = [s for s in sig[5] if s < codec.chunk_count]
        want = list(sig[6])
        src_bytes = sum(sum(_nbytes(c) for c in o.chunks.values())
                        for o in ops)
        ns, shard_bytes = 1, 0
        padded_cols = 0
        fspan = self._trace_flush(sig, ops, reason)
        try:
            ns, n2 = self._shard_fanout(codec, _pow2(len(ops)))
            padded_cols = n2 * L
            with self._launch_ctx(codec, ops):
                folded = np.empty((len(avail), n2 * L), dtype=np.uint8)
                for i, o in enumerate(ops):
                    c0 = i * L
                    for j, s in enumerate(avail):
                        folded[j, c0: c0 + L] = _host(o.chunks[s])
                if len(ops) < n2:
                    folded[:, len(ops) * L:] = 0
                out = codec.decode_chunks_folded(want, avail, folded,
                                                 n2, L, n_shard=ns)
            shard_bytes = folded.nbytes // ns if ns > 1 else 0
            for i, o in enumerate(ops):
                o.decoded = {
                    s: out[j, i * L: (i + 1) * L].copy()
                    for j, s in enumerate(want)}
        except BaseException as e:
            for o in ops:
                o.error = e
        finally:
            self._trace_flush_done(
                fspan, bucket=L, src_cols=sum(o.length for o in ops),
                padded_cols=padded_cols, n_shard=ns)
            self._complete(ops, src_bytes, reason, ns, shard_bytes)

    def _flush_repair(self, sig: tuple, ops: list[_PendingOp],
                      reason: str) -> None:
        """Folded MSR repair flush: same lost chunk, same helper set,
        same L — the whole group rides ONE repair_chunk_folded pass (no
        stripe-count padding: a zero segment would buy nothing)."""
        L = sig[-1]
        codec = ops[0].codec
        lost = sig[2]
        src_bytes = sum(sum(c.nbytes for c in o.chunks.values())
                        for o in ops)
        ns = 1
        fspan = self._trace_flush(sig, ops, reason)
        try:
            ns, _n2 = self._shard_fanout(codec, len(ops))
            with self._launch_ctx(codec, ops):
                outs = codec.repair_chunk_folded(
                    lost, [o.chunks for o in ops], L, n_shard=ns)
            for o, chunk in zip(ops, outs):
                o.decoded = chunk
        except BaseException as e:
            for o in ops:
                o.error = e
        finally:
            self._trace_flush_done(
                fspan, bucket=L, src_cols=len(ops) * L,
                padded_cols=len(ops) * L, n_shard=ns)
            self._complete(ops, src_bytes, reason, ns,
                           src_bytes // ns if ns > 1 else 0)

    def _flush_verify(self, sig: tuple, ops: list[_PendingOp],
                      reason: str) -> None:
        """Folded digest flush: every op's (n_i, L) rows concatenate
        into one (sum n_i, L) buffer — a single CRC pass (the CRC32C
        kernel or the native sweep, ec/verify.py) whose result rows
        scatter back per op.  No stripe-count padding: the kernel's
        shape depends only on L."""
        ver = ops[0].codec
        src_bytes = sum(o.streams.nbytes for o in ops)
        n_rows = sum(o.streams.shape[0] for o in ops)
        fspan = self._trace_flush(sig, ops, reason)
        try:
            folded = (ops[0].streams if len(ops) == 1
                      else np.concatenate([o.streams for o in ops]))
            with self._launch_ctx(ver, ops):
                digs = ver.digests(folded)
            row = 0
            for o in ops:
                n = o.streams.shape[0]
                o.decoded = digs[row:row + n]
                row += n
        except BaseException as e:
            for o in ops:
                o.error = e
        finally:
            self._trace_flush_done(fspan, bucket=sig[-1],
                                   src_cols=n_rows, padded_cols=n_rows,
                                   n_shard=1)
            self._complete(ops, src_bytes, reason)


def _op_tensors(op: _PendingOp):
    """The device tensors an op brings to its flush: its staged stack and
    any tensor it was handed (an arena hit)."""
    if op.dev is not None:
        yield op.dev
    if isinstance(op.streams, torch.Tensor):
        yield op.streams
    for c in (op.chunks or {}).values():
        if isinstance(c, torch.Tensor):
            yield c


def _nbytes(x) -> int:
    """Bytes of a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _host(x) -> np.ndarray:
    """Host bytes of a numpy array or a tensor (an arena-served input
    on the host-fold path)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
