"""Compressor plugin registry (src/compressor/Compressor.h shape)."""

from __future__ import annotations

import bz2
import lzma
import threading
import zlib
from abc import ABC, abstractmethod


class Compressor(ABC):
    """One algorithm: compress/decompress byte blobs.  `level` follows
    the per-plugin convention (ref compressor plugins read their own
    options)."""

    name: str = ""

    @abstractmethod
    def compress(self, data: bytes) -> bytes: ...

    @abstractmethod
    def decompress(self, data: bytes,
                   max_out: int | None = None) -> bytes:
        """Decompress; when max_out is given, implementations MUST bound
        the output allocation (decompression-bomb defence for wire
        consumers) and raise ValueError if the stream exceeds it."""


_FACTORIES: dict[str, type] = {}
_LOCK = threading.Lock()


def register(name: str):
    def deco(cls):
        cls.name = name
        with _LOCK:
            _FACTORIES[name] = cls
        return cls
    return deco


def factory(name: str, **kw) -> Compressor:
    with _LOCK:
        cls = _FACTORIES.get(name)
    if cls is None:
        raise ValueError(f"no compressor plugin {name!r} "
                         f"(have {sorted(_FACTORIES)})")
    return cls(**kw)


def registered() -> list[str]:
    with _LOCK:
        return sorted(_FACTORIES)


@register("none")
class NoneCompressor(Compressor):
    def compress(self, data: bytes) -> bytes:
        return bytes(data)

    def decompress(self, data: bytes,
                   max_out: int | None = None) -> bytes:
        if max_out is not None and len(data) > max_out:
            raise ValueError("output exceeds bound")
        return bytes(data)


@register("zlib")
class ZlibCompressor(Compressor):
    def __init__(self, level: int = 1):
        self.level = int(level)

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes,
                   max_out: int | None = None) -> bytes:
        if max_out is None:
            return zlib.decompress(data)
        d = zlib.decompressobj()
        out = d.decompress(data, max_out)
        if d.unconsumed_tail or not d.eof:
            raise ValueError("output exceeds bound")
        return out


@register("lzma")
class LzmaCompressor(Compressor):
    def __init__(self, preset: int = 0):
        self.preset = int(preset)

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data, preset=self.preset)

    def decompress(self, data: bytes,
                   max_out: int | None = None) -> bytes:
        if max_out is None:
            return lzma.decompress(data)
        d = lzma.LZMADecompressor()
        out = d.decompress(data, max_length=max_out)
        if not d.eof:
            raise ValueError("output exceeds bound")
        return out


_CZ_MAGIC = b"CZ01"
_CZ_POOL = None


def _cz_pool():
    global _CZ_POOL
    with _LOCK:
        if _CZ_POOL is None:
            import concurrent.futures
            import os
            _CZ_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="czlib")
        return _CZ_POOL


@register("czlib")
class ChunkedZlibCompressor(Compressor):
    """Chunk-parallel zlib: the store's inline-compression codec
    (BlueStore compresses per-blob; here fixed chunks compress
    concurrently on a shared thread pool — zlib releases the GIL — so
    a multi-MB ingest blob costs ~one chunk-time).  Frame:
    magic | u32 chunk_size | u32 n_chunks | n x u32 lengths |
    payloads.  Deterministic for a given (level, chunk_size): the
    same raw bytes always produce the same stored bytes, which the
    replicated push path relies on (replicas recompress the shipped
    raw bytes and must land byte-identical so scrub digest-compare
    stays meaningful)."""

    def __init__(self, level: int = 1, chunk_size: int = 256 << 10):
        self.level = int(level)
        self.chunk_size = int(chunk_size)

    def compress(self, data: bytes) -> bytes:
        import struct
        cs = self.chunk_size
        chunks = [bytes(data[o:o + cs]) for o in range(0, len(data), cs)]
        if len(chunks) <= 1:
            comp = [zlib.compress(chunks[0], self.level)] if chunks else []
        else:
            comp = list(_cz_pool().map(
                lambda c: zlib.compress(c, self.level), chunks))
        head = _CZ_MAGIC + struct.pack("<II", cs, len(comp))
        lens = struct.pack(f"<{len(comp)}I", *map(len, comp))
        return head + lens + b"".join(comp)

    def decompress(self, data: bytes,
                   max_out: int | None = None) -> bytes:
        import struct
        if data[:4] != _CZ_MAGIC or len(data) < 12:
            raise ValueError("not a czlib frame")
        cs, n = struct.unpack_from("<II", data, 4)
        if cs <= 0 or n > (1 << 24):
            raise ValueError("corrupt czlib header")
        lens = struct.unpack_from(f"<{n}I", data, 12)
        if max_out is not None and n * cs > max_out + cs:
            raise ValueError("output exceeds bound")
        payloads, off = [], 12 + 4 * n
        for ln in lens:
            payloads.append(data[off:off + ln])
            off += ln
        if off != len(data):
            raise ValueError("corrupt czlib frame")

        def one(p):
            d = zlib.decompressobj()
            out = d.decompress(p, cs)
            if d.unconsumed_tail or not d.eof:
                raise ValueError("chunk exceeds chunk_size")
            return out

        if n <= 1:
            outs = [one(p) for p in payloads]
        else:
            outs = list(_cz_pool().map(one, payloads))
        raw = b"".join(outs)
        if max_out is not None and len(raw) > max_out:
            raise ValueError("output exceeds bound")
        return raw


@register("bz2")
class Bz2Compressor(Compressor):
    def __init__(self, level: int = 1):
        self.level = int(level)

    def compress(self, data: bytes) -> bytes:
        return bz2.compress(data, self.level)

    def decompress(self, data: bytes,
                   max_out: int | None = None) -> bytes:
        if max_out is None:
            return bz2.decompress(data)
        d = bz2.BZ2Decompressor()
        out = d.decompress(data, max_length=max_out)
        if not d.eof:
            raise ValueError("output exceeds bound")
        return out
