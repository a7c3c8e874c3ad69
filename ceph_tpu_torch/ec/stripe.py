"""Stripe geometry and write planning.

The capability of the reference's ECUtil stripe layer
(the reference's src/osd/ECUtil.h: stripe_info_t :452-800 — stripe_width /
chunk_size bookkeeping, chunk_mapping permutation + reverse :477-517, the
ro-offset <-> shard-offset coordinate algebra :614-795, EC_ALIGN_SIZE=4096
:33) plus the write-plan decision of ECTransaction (ECTransaction.h:30-66
WritePlanObj: full-stripe encode vs partial write vs parity delta), shaped
for the TPU build: geometry is pure data (friendly to batching stripes
into device tensors), extents are IntervalSets.

"ro" (raw object) space is the client's contiguous byte stream; it maps
RAID-0-style onto k data shards in `chunk_size` units:
ro byte x lives at shard (x // chunk_size) % k, offset
(x // stripe_width) * chunk_size + x % chunk_size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.interval import IntervalSet
from .interface import EC_ALIGN_SIZE, Flags


@dataclass(frozen=True)
class StripeInfo:
    k: int
    m: int
    chunk_size: int
    chunk_mapping: tuple = ()  # raw shard index -> stored shard id

    def __post_init__(self):
        if self.chunk_size <= 0 or self.chunk_size % EC_ALIGN_SIZE:
            raise ValueError(
                f"chunk_size {self.chunk_size} must be a positive multiple "
                f"of {EC_ALIGN_SIZE}")
        if self.chunk_mapping:
            if sorted(self.chunk_mapping) != list(range(self.k + self.m)):
                raise ValueError("chunk_mapping must permute 0..k+m-1")

    # -- geometry ----------------------------------------------------------
    @property
    def stripe_width(self) -> int:
        return self.k * self.chunk_size

    @property
    def chunk_count(self) -> int:
        return self.k + self.m

    def shard_of(self, raw_index: int) -> int:
        """Apply the chunk_mapping permutation (identity if unset)."""
        return self.chunk_mapping[raw_index] if self.chunk_mapping \
            else raw_index

    def raw_of(self, shard: int) -> int:
        """Reverse permutation (ECUtil's reverse chunk_mapping)."""
        if not self.chunk_mapping:
            return shard
        return self.chunk_mapping.index(shard)

    # -- coordinate algebra (ro <-> shard) ---------------------------------
    def ro_to_shard(self, ro_off: int) -> tuple[int, int]:
        """ro byte -> (shard id, shard offset)."""
        stripe, within = divmod(ro_off, self.stripe_width)
        raw_shard, chunk_off = divmod(within, self.chunk_size)
        return (self.shard_of(raw_shard),
                stripe * self.chunk_size + chunk_off)

    def shard_to_ro(self, shard: int, shard_off: int) -> int:
        """(data shard id, shard offset) -> ro byte."""
        raw = self.raw_of(shard)
        if raw >= self.k:
            raise ValueError(f"shard {shard} is parity; no ro address")
        stripe, chunk_off = divmod(shard_off, self.chunk_size)
        return (stripe * self.stripe_width + raw * self.chunk_size
                + chunk_off)

    def ro_range_to_shard_extents(self, off: int,
                                  length: int) -> dict[int, IntervalSet]:
        """ro byte range -> per-data-shard IntervalSets of shard offsets
        (the shard_extent_set_t construction)."""
        out: dict[int, IntervalSet] = {}
        end = off + length
        while off < end:
            shard, soff = self.ro_to_shard(off)
            take = min(self.chunk_size - soff % self.chunk_size, end - off)
            out.setdefault(shard, IntervalSet()).insert(soff, take)
            off += take
        return out

    def aligned_ro_range(self, off: int, length: int) -> tuple[int, int]:
        """Expand an ro range to page-aligned full-stripe-row boundaries
        (the pad_and_rebuild_to_ec_align step, ECUtil.cc:749)."""
        start = (off // self.stripe_width) * self.stripe_width
        end = -(-(off + length) // self.stripe_width) * self.stripe_width
        return start, end - start

    def object_chunk_size(self, object_size: int) -> int:
        """Per-shard bytes for an object (full stripes, zero padded)."""
        stripes = -(-object_size // self.stripe_width)
        return stripes * self.chunk_size

    def rows_of_range(self, off: int, length: int) -> tuple[int, int]:
        """Stripe rows covering the ro range: (first_row, n_rows)."""
        row0 = off // self.stripe_width
        row_end = -(-(off + length) // self.stripe_width)
        return row0, row_end - row0

    def ro_range_segments(self, off: int,
                          length: int) -> list[tuple[int, int, int, int]]:
        """ro byte range -> ordered (shard, shard_off, seg_len, ro_off)
        segments (each contiguous within one chunk cell); the walk behind
        ro_range_to_shard_extents, keeping the ro provenance each segment
        came from so callers can slice the client buffer."""
        end = off + length
        segs = []
        while off < end:
            shard, soff = self.ro_to_shard(off)
            take = min(self.chunk_size - soff % self.chunk_size, end - off)
            segs.append((shard, soff, take, off))
            off += take
        return segs

    # -- tensor layout (the slice_iterator seam, re-shaped for devices) ----
    def ro_scatter(self, data) -> np.ndarray:
        """Pad an ro byte buffer to whole stripe rows and scatter it into
        the (k, rows*chunk_size) per-shard streams of the RAID-0 layout.
        One call covers ANY number of rows, so a whole object becomes one
        (k, L) matrix -> one encode_chunks kernel launch."""
        buf = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else np.asarray(
                data, dtype=np.uint8).reshape(-1)
        rows = -(-buf.size // self.stripe_width)
        padded = np.zeros(rows * self.stripe_width, dtype=np.uint8)
        padded[: buf.size] = buf
        return padded.reshape(rows, self.k, self.chunk_size) \
            .transpose(1, 0, 2).reshape(self.k, rows * self.chunk_size)

    def ro_assemble(self, streams) -> np.ndarray:
        """Inverse of ro_scatter: k equal-length shard streams -> the
        contiguous (zero-padded) ro byte buffer they interleave."""
        arr = np.stack([np.asarray(s, dtype=np.uint8) for s in streams])
        if arr.shape[0] != self.k:
            raise ValueError(f"need {self.k} data streams, got {arr.shape[0]}")
        length = arr.shape[1]
        if length % self.chunk_size:
            raise ValueError(f"stream length {length} not a multiple of "
                             f"chunk_size {self.chunk_size}")
        rows = length // self.chunk_size
        return arr.reshape(self.k, rows, self.chunk_size) \
            .transpose(1, 0, 2).reshape(-1)


# ---------------------------------------------------------------------------
# Write planning (the ECTransaction WritePlan decision table)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WritePlan:
    """How to execute an overwrite of [off, off+length) on an object."""

    mode: str                 # "full_stripe" | "parity_delta" | "rmw"
    read_extents: dict        # shard -> IntervalSet needed before writing
    touched_shards: tuple     # data shards being modified
    aligned_off: int
    aligned_len: int


def plan_write(si: StripeInfo, object_size: int, off: int, length: int,
               flags: Flags) -> WritePlan:
    """Decide full-stripe encode vs parity-delta vs read-modify-write,
    mirroring the decision inputs of ECTransaction.h:30-66 (plugin flags +
    geometry).  Rules:
    - writes covering whole stripe rows (or growing the object) need no
      reads: full_stripe;
    - sub-stripe overwrites with PARITY_DELTA support read only the old
      bytes being overwritten (delta = old ^ new folded into parity);
    - otherwise read the rest of each touched stripe row and re-encode.
    """
    aligned_off, aligned_len = si.aligned_ro_range(off, length)
    touched = si.ro_range_to_shard_extents(off, length)
    covers_rows = off % si.stripe_width == 0 and (
        length % si.stripe_width == 0 or off + length >= object_size)
    # appends are read-free only when the touched rows hold NO live data
    # (object ends at or before the aligned row start)
    if covers_rows or object_size <= aligned_off:
        return WritePlan("full_stripe", {}, tuple(sorted(touched)),
                         aligned_off, aligned_len)
    if flags & Flags.PARITY_DELTA_OPTIMIZATION:
        return WritePlan("parity_delta", touched, tuple(sorted(touched)),
                         aligned_off, aligned_len)
    # rmw: read the untouched remainder of each affected stripe row
    need: dict[int, IntervalSet] = {}
    row0 = aligned_off // si.stripe_width
    rows = aligned_len // si.stripe_width
    for shard in range(si.k):
        sid = si.shard_of(shard)
        iv = IntervalSet()
        iv.insert(row0 * si.chunk_size, rows * si.chunk_size)
        written = touched.get(sid)
        if written:
            for s, e in written:
                iv.erase(s, e - s)
        if not iv.empty():
            need[sid] = iv
    return WritePlan("rmw", need, tuple(sorted(touched)),
                     aligned_off, aligned_len)
