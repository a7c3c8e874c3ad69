"""Versioned binary codec — the wire/disk encoding layer.

The capability of the reference's src/include/encoding.h + denc.h
(SURVEY.md layer 2): every struct encodes with a (version, compat,
length)-framed section so old decoders can skip unknown tails
(ENCODE_START/FINISH semantics) and new decoders can reject
incompatibility.  The format here is its own little-endian framing, not
the reference's — only the contract is mirrored:

    [u8 version][u8 compat][u32 payload_len][payload...]

Primitives are little-endian fixed width; varints deliberately avoided
(predictable layout; bulk data rides Buffers, not the codec).

Zero-copy contract (the bufferlist discipline of src/include/buffer.h,
carried into the codec itself):

- The Encoder is SEGMENTED: it holds an ordered list of bytes-like
  parts, never one growing stream.  ``blob()`` records a large payload
  by REFERENCE (bytes objects always; bytearray/memoryview at or above
  ``SEG_REF_MIN``) instead of copying it into the stream, so a stripe
  chunk appended to a message costs zero Python-side copies until (and
  unless) something genuinely needs contiguous bytes.  ``segments()``
  hands the parts to a vectored send (small metadata parts coalesced,
  referenced payloads standalone); ``tobytes()`` still assembles, and
  ``b"".join(segments()) == tobytes()`` always — the wire layout is
  byte-identical to the pre-segmented encoder.
- Referenced mutable buffers (bytearray/memoryview) MUST NOT be
  mutated by the caller until the frame is fully sent (including a
  possible session-resume replay) — the same rule as any zero-copy
  send path.  bytes references are safe by immutability.
- The Decoder wraps its input in a memoryview (no upfront copy) and,
  when constructed with ``carve_min > 0``, returns blobs at or above
  that size as read-only memoryview CARVES over the input buffer —
  skip-copy blob decode.  The carve pins the backing buffer by
  refcount; the transport guarantees it hands the Decoder a buffer it
  will never reuse (see msg/README.md for the ownership contract).
"""

from __future__ import annotations

import struct
from abc import ABC, abstractmethod
from typing import Any, Callable, TypeVar

T = TypeVar("T")

#: payload size at or above which the codec stops copying: the Encoder
#: records the blob as a referenced segment, the (carve-enabled)
#: Decoder returns a memoryview carve instead of detached bytes.
#: Smaller blobs still flatten — an iovec entry / pinned view per tiny
#: attr would cost more than the copy it saves.
SEG_REF_MIN = 4096


class CodecError(Exception):
    pass


class Encoder:
    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: list = []  # bytes | memoryview, in wire order

    # -- primitives --------------------------------------------------------
    def u8(self, v: int): self._parts.append(struct.pack("<B", v))
    def u16(self, v: int): self._parts.append(struct.pack("<H", v))
    def u32(self, v: int): self._parts.append(struct.pack("<I", v))
    def u64(self, v: int): self._parts.append(struct.pack("<Q", v))
    def i64(self, v: int): self._parts.append(struct.pack("<q", v))
    def f64(self, v: float): self._parts.append(struct.pack("<d", v))
    def boolean(self, v: bool): self.u8(1 if v else 0)

    def blob(self, v):
        """Length-prefixed bytes-like.  bytes append by reference
        (immutable — always safe); bytearray/memoryview append by
        reference at SEG_REF_MIN and above (zero-copy: the caller must
        not mutate until the frame is sent) and by copy below it."""
        if isinstance(v, memoryview) and \
                (v.itemsize != 1 or not v.contiguous):
            # normalize exotic views: byte-wise cast when contiguous,
            # detach otherwise (cast raises on strided views, and a
            # strided reference would blow up at join/sendmsg time —
            # the pre-segmented encoder's bytes(v) behavior)
            v = v.cast("B") if v.contiguous else bytes(v)
        n = len(v)
        self.u32(n)
        if isinstance(v, bytes):
            self._parts.append(v)
        elif n >= SEG_REF_MIN:
            self._parts.append(memoryview(v))
        else:
            self._parts.append(bytes(v))

    def string(self, v: str):
        self.blob(v.encode("utf-8"))

    def seq(self, items, item_fn: Callable[["Encoder", Any], None]):
        items = list(items)
        self.u32(len(items))
        for it in items:
            item_fn(self, it)

    def mapping(self, d: dict, key_fn, val_fn):
        self.u32(len(d))
        for k in sorted(d):
            key_fn(self, k)
            val_fn(self, d[k])

    def optional(self, v, fn):
        self.boolean(v is not None)
        if v is not None:
            fn(self, v)

    def obj(self, v: "Encodable"):
        v.encode(self)

    # -- versioned section (ENCODE_START/FINISH) ---------------------------
    def versioned(self, version: int, compat: int,
                  body: Callable[["Encoder"], None]):
        """Byte layout identical to ``u8 u8 blob(sub.tobytes())``, but
        the sub-encoder's parts SPLICE into this one — a versioned
        section wrapping a referenced payload stays zero-copy instead
        of flattening the whole body to measure it."""
        sub = Encoder()
        body(sub)
        self.u8(version)
        self.u8(compat)
        self.u32(sub.nbytes)
        self._parts.extend(sub._parts)

    @property
    def nbytes(self) -> int:
        """Total encoded length (sum over parts; no assembly)."""
        return sum(len(p) for p in self._parts)

    def segments(self, min_seg: int = SEG_REF_MIN) -> list:
        """The encoded stream as a short list of bytes-like segments
        for vectored IO: consecutive parts below ``min_seg`` coalesce
        into one joined chunk (cheap — they are metadata), parts at or
        above it (the referenced payloads) stay standalone.  Invariant:
        ``b"".join(segments()) == tobytes()``."""
        out: list = []
        run: list = []
        for p in self._parts:
            if len(p) >= min_seg:
                if run:
                    out.append(b"".join(run))
                    run = []
                out.append(p)
            else:
                run.append(p)
        if run:
            out.append(b"".join(run))
        return out

    def tobytes(self) -> bytes:
        return b"".join(self._parts)


class Decoder:
    __slots__ = ("_mv", "_pos", "_carve_min")

    def __init__(self, data, carve_min: int = 0):
        """``carve_min > 0`` enables skip-copy blob decode: blobs at or
        above it return as read-only memoryview carves over ``data``
        (which must stay unmutated for the carves' lifetime — they pin
        it by refcount).  The default (0) always detaches to bytes."""
        mv = data if isinstance(data, memoryview) else memoryview(data)
        if mv.itemsize != 1 or not mv.contiguous:
            # byte-wise view when possible, detached copy for strided
            # input (cast raises on non-contiguous views)
            mv = mv.cast("B") if mv.contiguous \
                else memoryview(bytes(mv))
        self._mv = mv.toreadonly()
        self._pos = 0
        self._carve_min = carve_min

    def _take(self, n: int):
        if self._pos + n > len(self._mv):
            raise CodecError(f"decode past end (+{n} at {self._pos}/"
                             f"{len(self._mv)})")
        b = self._mv[self._pos:self._pos + n]
        self._pos += n
        return b

    def u8(self) -> int: return self._take(1)[0]
    def u16(self) -> int: return struct.unpack("<H", self._take(2))[0]
    def u32(self) -> int: return struct.unpack("<I", self._take(4))[0]
    def u64(self) -> int: return struct.unpack("<Q", self._take(8))[0]
    def i64(self) -> int: return struct.unpack("<q", self._take(8))[0]
    def f64(self) -> float: return struct.unpack("<d", self._take(8))[0]
    def boolean(self) -> bool: return self.u8() != 0

    def blob(self):
        """Length-prefixed bytes-like: detached bytes, or (carve mode,
        large blobs) a read-only memoryview carve over the input."""
        n = self.u32()
        if self._carve_min and n >= self._carve_min:
            return self._take(n)
        return self._take(n).tobytes()

    def string(self) -> str:
        # strings always detach (str.decode needs bytes; a carved name
        # would also pin the frame for the life of a tiny key)
        return self._take(self.u32()).tobytes().decode("utf-8")

    def seq(self, item_fn: Callable[["Decoder"], T]) -> list[T]:
        return [item_fn(self) for _ in range(self.u32())]

    def mapping(self, key_fn, val_fn) -> dict:
        return {key_fn(self): val_fn(self) for _ in range(self.u32())}

    def optional(self, fn):
        return fn(self) if self.boolean() else None

    def remaining(self) -> int:
        return len(self._mv) - self._pos

    # -- versioned section (DECODE_START/FINISH) ---------------------------
    def versioned(self, my_version: int,
                  body: Callable[["Decoder", int], T]) -> T:
        """Decode a versioned section.  `body(dec, struct_version)` reads
        what it understands; any unknown tail is skipped (forward compat).
        Raises if the encoder demanded more than we support (compat >
        my_version).  The sub-decoder views the section in place (no
        detach) and inherits carve mode."""
        version = self.u8()
        compat = self.u8()
        payload = self._take(self.u32())
        if compat > my_version:
            raise CodecError(
                f"incompatible encoding: needs >= v{compat}, have v{my_version}")
        sub = Decoder(payload, carve_min=self._carve_min)
        return body(sub, version)


class Encodable(ABC):
    """Objects with versioned encode/decode (the struct encoding trait)."""

    @abstractmethod
    def encode(self, enc: Encoder) -> None: ...

    @classmethod
    @abstractmethod
    def decode(cls, dec: Decoder) -> "Encodable": ...

    def encode_bytes(self) -> bytes:
        e = Encoder()
        self.encode(e)
        return e.tobytes()

    @classmethod
    def decode_bytes(cls, data: bytes):
        return cls.decode(Decoder(data))
