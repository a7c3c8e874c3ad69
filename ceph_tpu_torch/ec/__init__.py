"""Erasure-code engine of the port: plugin interface, registry, and the
builtin plugins ``tpu``, ``jerasure`` (matrix and bit-matrix techniques),
``isa`` and ``xor`` (the counterpart of ``ceph_tpu.ec``; the batcher and
the clay, lrc and shec plugins come with later slices).  The registry
imports ``ceph_tpu_torch.ec.plugin_<name>`` at first use."""

from .interface import (ChunkMap, ErasureCode, ErasureCodeError, Flags,
                        Profile, EC_ALIGN_SIZE, SIMD_ALIGN)
from .registry import factory, preload, register, registered

__all__ = [
    "ChunkMap", "ErasureCode", "ErasureCodeError", "Flags",
    "Profile", "EC_ALIGN_SIZE", "SIMD_ALIGN", "factory", "preload",
    "register", "registered",
]
