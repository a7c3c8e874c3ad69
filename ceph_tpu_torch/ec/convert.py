"""Bring the JAX package's erasure-code state into the port.

The JAX package's state is numpy already: a codec's coding matrix
(``.matrix``), a bit-matrix codec's ``.bitmatrix`` and an XOR schedule's
tuples.  These functions rebuild the
port's objects around that state, so the tests hand the JAX objects'
arrays over instead of recomputing them on the port's side.
"""

from __future__ import annotations

import numpy as np

from ..ops.xor_schedule import XorSchedule
from .interface import ErasureCodeError
from .registry import factory


def codec_from_reference(plugin: str, profile, matrix: np.ndarray, *,
                         device):
    """The port's ``plugin`` codec for ``profile`` (same k, m and
    technique as the reference codec) on ``device``, computing with the
    reference's coding ``matrix`` (m, k)."""
    prof = {k: v for k, v in dict(profile).items() if k != "backend"}
    prof["device"] = str(device)
    codec = factory(plugin, prof)
    M = np.ascontiguousarray(matrix, dtype=np.uint8)
    if M.shape != codec.matrix.shape:
        raise ErasureCodeError(
            f"matrix shape {M.shape} != the codec's {codec.matrix.shape}")
    codec.matrix = M
    return codec


def bitcode_from_reference(profile, bitmatrix: np.ndarray, *, device):
    """The port's ``jerasure`` bit-matrix codec (liberation, blaum_roth or
    liber8tion) for ``profile`` on ``device``, computing with the
    reference codec's ``bitmatrix`` (w*m, w*k) over GF(2)."""
    from .bitmatrix_code import BitMatrixErasureCode

    prof = {k: v for k, v in dict(profile).items() if k != "backend"}
    prof["device"] = str(device)
    codec = factory("jerasure", prof)
    if not isinstance(codec, BitMatrixErasureCode):
        raise ErasureCodeError(
            f"technique {prof.get('technique')!r} is not a bit-matrix code")
    B = np.ascontiguousarray(bitmatrix, dtype=np.uint8)
    if B.shape != codec.bitmatrix.shape:
        raise ErasureCodeError(
            f"bitmatrix shape {B.shape} != the codec's "
            f"{codec.bitmatrix.shape}")
    codec.bitmatrix = B
    return codec


def schedule_from_arrays(n_in: int, ops, outputs, used_inputs
                         ) -> XorSchedule:
    """An XorSchedule from plain sequences (the reference schedule's
    fields)."""
    return XorSchedule(
        n_in=int(n_in),
        ops=tuple((int(d), int(a), int(b)) for d, a, b in ops),
        outputs=tuple(tuple(int(t) for t in o) for o in outputs),
        used_inputs=tuple(int(u) for u in used_inputs))
