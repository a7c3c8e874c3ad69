"""Erasure-code engine of the port: plugin interface, registry, the
builtin plugins ``tpu``, ``jerasure`` (matrix and bit-matrix techniques),
``isa``, ``xor``, and the wide and local codes ``lrc``, ``shec`` and
``clay``, and the write path around them: the cross-op ECBatcher
(encode, degraded decode, CLAY's sub-chunk and repair folds, folded
verify), the DeviceArena and the CrcVerifier (the counterpart of
``ceph_tpu.ec``).  The registry imports
``ceph_tpu_torch.ec.plugin_<name>`` at first use."""

from .arena import DeviceArena
from .batcher import ECBatcher
from .interface import (ChunkMap, ErasureCode, ErasureCodeError, Flags,
                        Profile, EC_ALIGN_SIZE, SIMD_ALIGN)
from .registry import factory, preload, register, registered

from .verify import CrcVerifier, verifier

__all__ = [
    "ChunkMap", "CrcVerifier", "DeviceArena", "ECBatcher", "ErasureCode",
    "ErasureCodeError", "Flags",
    "Profile", "EC_ALIGN_SIZE", "SIMD_ALIGN", "factory", "preload",
    "register", "registered", "verifier",
]
