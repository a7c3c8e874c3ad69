"""Compression plugins: the src/compressor/ registry tier.

The reference exposes zstd/lz4/snappy/zlib behind a Compressor plugin
registry (same dlopen pattern as erasure-code plugins) consumed by
BlueStore inline compression, msgr v2 on-wire compression, and RGW.
Here the registry carries the algorithms the Python runtime provides
natively — zlib, lzma, bz2, and the none pass-through — behind the
same factory shape; wire consumers negotiate by name.
"""

from .registry import Compressor, factory, register, registered

__all__ = ["Compressor", "factory", "register", "registered"]
