"""Erasure-code engine of the port: plugin interface, registry, and the
builtin ``tpu`` plugin (the counterpart of ``ceph_tpu.ec``; the batcher
comes with a later slice)."""

from .interface import (ChunkMap, ErasureCode, ErasureCodeError, Flags,
                        Profile, EC_ALIGN_SIZE, SIMD_ALIGN)
from .registry import factory, preload, register, registered

__all__ = [
    "ChunkMap", "ErasureCode", "ErasureCodeError", "Flags",
    "Profile", "EC_ALIGN_SIZE", "SIMD_ALIGN", "factory", "preload",
    "register", "registered",
]
