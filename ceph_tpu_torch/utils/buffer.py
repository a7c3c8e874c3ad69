"""Buffers: zero-copy scatter-gather byte containers.

The currency of the reference's IO paths is bufferlist/bufferptr/raw
(src/include/buffer.h, src/common/buffer.cc — SURVEY.md §2.2): refcounted
raw buffers, zero-copy views, aligned rebuilds, cached per-raw crc32c.
The TPU build's equivalent is numpy-backed: a Buffer is a uint8 view over
a raw ndarray (which can be host memory or a materialised device array),
and a BufferList is an ordered list of Buffers with the same alignment
and checksum amenities.  Device tensors stay device-side until to_bytes().
"""

from __future__ import annotations

import numpy as np

from ..ops import native

SIMD_ALIGN = 64
PAGE_ALIGN = 4096  # the OSD stripe path alignment (ref ECUtil.h:33)


class Buffer:
    """A view (offset, length) over a raw uint8 ndarray — bufferptr."""

    __slots__ = ("raw", "offset", "length", "_crc_cache")

    def __init__(self, raw: np.ndarray | bytes | bytearray | int,
                 offset: int = 0, length: int | None = None):
        if isinstance(raw, int):
            raw = np.zeros(raw, dtype=np.uint8)
        elif isinstance(raw, (bytes, bytearray, memoryview)):
            # zero-copy wrap; writability follows the source (bytes ->
            # read-only, bytearray -> writable)
            raw = np.frombuffer(raw, dtype=np.uint8)
        else:
            raw = np.ascontiguousarray(raw)
            if raw.dtype != np.uint8:
                raw = raw.view(np.uint8)
            if raw.ndim != 1:
                raw = raw.reshape(-1)  # byte semantics, never row slicing
        self.raw = raw
        self.offset = offset
        self.length = raw.size - offset if length is None else length
        if self.offset < 0 or self.offset + self.length > raw.size:
            raise ValueError("buffer view out of range")
        self._crc_cache: dict[tuple[int, int, int], int] = {}

    @staticmethod
    def create_aligned(length: int, align: int = SIMD_ALIGN) -> "Buffer":
        """Aligned allocation (buffer::create_aligned): numpy allocations
        are 64-byte aligned in practice; over-allocate and slide to be
        certain for larger alignments."""
        raw = np.zeros(length + align, dtype=np.uint8)
        off = (-raw.ctypes.data) % align
        return Buffer(raw, off, length)

    def view(self) -> np.ndarray:
        return self.raw[self.offset:self.offset + self.length]

    def is_aligned(self, align: int) -> bool:
        return (self.raw.ctypes.data + self.offset) % align == 0

    def is_zero(self) -> bool:
        return not self.view().any()

    def crc32c(self, seed: int = 0) -> int:
        """crc32c of the view, cached per (offset, length, seed) like the
        reference's per-raw cached crc (buffer.h cached_crc)."""
        key = (self.offset, self.length, seed)
        got = self._crc_cache.get(key)
        if got is None:
            got = native.crc32c(np.ascontiguousarray(self.view()), crc=seed)
            self._crc_cache[key] = got
        return got

    def invalidate_crc(self) -> None:
        self._crc_cache.clear()

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, sl) -> "Buffer":
        if isinstance(sl, slice):
            start, stop, step = sl.indices(self.length)
            if step != 1:
                raise ValueError("buffers are contiguous views")
            return Buffer(self.raw, self.offset + start, stop - start)
        raise TypeError("Buffer supports slice views only")

    def to_bytes(self) -> bytes:
        return self.view().tobytes()


class BufferList:
    """Ordered list of Buffers — bufferlist."""

    __slots__ = ("_bufs", "_length")

    def __init__(self, data=None):
        self._bufs: list[Buffer] = []
        self._length = 0
        if data is not None:
            self.append(data)

    # -- building ----------------------------------------------------------
    def append(self, data) -> "BufferList":
        if isinstance(data, BufferList):
            for b in data._bufs:
                self._bufs.append(b)
                self._length += b.length
        elif isinstance(data, Buffer):
            self._bufs.append(data)
            self._length += data.length
        else:
            b = Buffer(data)
            self._bufs.append(b)
            self._length += b.length
        return self

    def append_zero(self, length: int) -> "BufferList":
        """Zero padding; kept as one shared zero raw when possible (the
        zero-dedup idea of buffer.h append_zero2 / ECUtil slice zero-dedup)."""
        self.append(Buffer(_zero_raw(length), 0, length))
        return self

    # -- reading -----------------------------------------------------------
    def __len__(self) -> int:
        return self._length

    @property
    def buffers(self) -> list[Buffer]:
        return list(self._bufs)

    def to_bytes(self) -> bytes:
        return b"".join(b.to_bytes() for b in self._bufs)

    def contiguous(self):
        """Zero-copy bytes-like for the common single-buffer case: a
        memoryview over the raw array (read-only when the source was —
        e.g. an rx-carved wire payload), detached bytes otherwise.
        The store ingest path rides this into the WAL append instead
        of the eager ``to_bytes()`` detach; the caller owns keeping
        the source unmutated until consumed (the carve contract)."""
        if len(self._bufs) == 1:
            arr = self._bufs[0].view()
            if arr.flags["C_CONTIGUOUS"]:
                return memoryview(arr).cast("B")
        return self.to_bytes()

    def to_array(self) -> np.ndarray:
        """Contiguous uint8 array (single-buffer lists return the view)."""
        if len(self._bufs) == 1:
            return self._bufs[0].view()
        if not self._bufs:
            return np.empty(0, dtype=np.uint8)
        return np.concatenate([b.view() for b in self._bufs])

    def substr(self, off: int, length: int) -> "BufferList":
        if off < 0 or off + length > self._length:
            raise ValueError("substr out of range")
        out = BufferList()
        pos = 0
        for b in self._bufs:
            if length == 0:
                break
            end = pos + b.length
            if end <= off:
                pos = end
                continue
            start_in = max(off - pos, 0)
            take = min(b.length - start_in, length)
            out.append(b[start_in:start_in + take])
            off += take
            length -= take
            pos = end
        return out

    def crc32c(self, seed: int = 0) -> int:
        crc = seed
        for b in self._bufs:
            crc = b.crc32c(crc)
        return crc

    def is_contiguous(self) -> bool:
        return len(self._bufs) <= 1

    def is_aligned(self, align: int) -> bool:
        return all(b.is_aligned(align) and (b.length % align == 0 or
                                            b is self._bufs[-1])
                   for b in self._bufs)

    def rebuild(self) -> "BufferList":
        """Coalesce into one contiguous buffer in place."""
        if len(self._bufs) > 1:
            self._bufs = [Buffer(self.to_array())]  # concatenate = fresh
        return self

    def rebuild_aligned(self, align: int = SIMD_ALIGN) -> "BufferList":
        """Contiguous + aligned (rebuild_aligned_size_and_memory,
        buffer.h:1092-1095) — the precondition the EC encode path imposes
        (ErasureCode.cc SIMD_ALIGN input rebuild)."""
        if self.is_contiguous() and (not self._bufs or
                                     self._bufs[0].is_aligned(align)):
            return self
        out = Buffer.create_aligned(self._length, align)
        pos = 0
        for b in self._bufs:
            out.view()[pos:pos + b.length] = b.view()
            pos += b.length
        self._bufs = [out]
        return self


_ZERO_RAW = np.zeros(PAGE_ALIGN, dtype=np.uint8)
_ZERO_RAW.setflags(write=False)  # shared page must be immutable


def _zero_raw(length: int) -> np.ndarray:
    if length <= _ZERO_RAW.size:
        return _ZERO_RAW  # shared page; Buffer's (0, length) view clamps
    return np.zeros(length, dtype=np.uint8)
