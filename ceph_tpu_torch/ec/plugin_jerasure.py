"""jerasure-compatible plugin of the PyTorch port: the matrix RS/Cauchy
techniques and the GF(2) bit-matrix techniques.

The counterpart of the JAX package's ``ceph_tpu/ec/plugin_jerasure.py``,
registered under the same name, ``jerasure``.  It mirrors the technique
surface of the reference's jerasure plugin (ErasureCodePluginJerasure.cc
technique switch; ErasureCodeJerasure.h per-technique classes; defaults
k=7, m=3, w=8).

Techniques:
- reed_sol_van   — systematic Vandermonde-derived RS (w=8)
- reed_sol_r6_op — RAID-6 specialisation (m=2): P = XOR, Q = sum 2^j d_j
- cauchy_orig    — Cauchy matrix, jerasure point convention
- cauchy_good    — Cauchy matrix, bit-matrix density optimised
- liberation / blaum_roth / liber8tion — RAID-6 (m=2) GF(2) bit-matrix
  codes over w sub-stripe packets (w=7 / w=6 / w=8 by default), see
  ec/bitmatrix_code.py.

The backend defaults to ``torch`` on the profile's ``device`` (default
``cuda``): the matrix techniques run the GF(2^8) region kernels, the
bit-matrix techniques the scheduled-XOR kernel.  ``backend=numpy`` is the
host oracle; ``backend=native`` runs the matrix techniques on the native
library's region product (ops/native.py) and the bit-matrix techniques
on the host XOR path; an explicit ``backend=auto`` resolves to ``native``
when the library loads, else ``numpy``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..ops import gf256
from .bitmatrix_code import (BitMatrixErasureCode, blaum_roth_bitmatrix,
                             liberation_bitmatrix, raid6_bitmatrix)
from .interface import ErasureCodeError, profile_int
from .matrix_code import MatrixErasureCode
from .registry import register

PLUGIN_API_VERSION = 1

DEFAULT_K = 7
DEFAULT_M = 3

TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good",
              "liberation", "blaum_roth", "liber8tion")
BIT_TECHNIQUES = {"liberation": 7, "blaum_roth": 6, "liber8tion": 8}


class JerasureCode(MatrixErasureCode):
    def _init_from_profile(self) -> None:
        self.k = profile_int(self.profile, "k", DEFAULT_K)
        self.m = profile_int(self.profile, "m", DEFAULT_M)
        w = profile_int(self.profile, "w", 8)
        if w != 8:
            raise ErasureCodeError(
                f"w={w} unsupported: the port implements GF(2^8) only "
                "(byte-oriented; other word sizes are CPU-schedule oriented)")
        self.technique = self.profile.get("technique", "reed_sol_van")
        if self.technique == "reed_sol_van":
            self.matrix = gf256.vandermonde_matrix(self.k, self.m)
        elif self.technique == "reed_sol_r6_op":
            if self.m != 2:
                raise ErasureCodeError("reed_sol_r6_op requires m=2")
            M = np.ones((2, self.k), dtype=np.uint8)
            for j in range(self.k):
                M[1, j] = gf256.gf_pow(2, j)
            self.matrix = M
        elif self.technique == "cauchy_orig":
            self.matrix = gf256.cauchy_matrix(self.k, self.m)
        else:  # cauchy_good
            self.matrix = gf256.cauchy_good_matrix(self.k, self.m)
        self.profile.setdefault("backend", "torch")
        self._init_matrix_backend()


class JerasureBitCode(BitMatrixErasureCode):
    """The liberation-family techniques: RAID-6 XOR schedules over w
    packets per chunk (ref ErasureCodeJerasure.h:238-336 envelope)."""

    def _init_from_profile(self) -> None:
        self.k = profile_int(self.profile, "k", DEFAULT_K)
        self.m = profile_int(self.profile, "m", 2)
        self.technique = self.profile["technique"]
        default_w = BIT_TECHNIQUES[self.technique]
        self.w = profile_int(self.profile, "w", default_w)
        if self.m != 2:
            raise ErasureCodeError(
                f"{self.technique} is a RAID-6 technique: m must be 2")
        if self.technique == "liberation" and self.w not in (5, 7):
            raise ErasureCodeError("liberation needs prime w (5 or 7)")
        if self.technique == "blaum_roth" and self.w not in (4, 6):
            raise ErasureCodeError("blaum_roth needs w with w+1 prime "
                                   "(4 or 6)")
        if self.technique == "liber8tion" and self.w != 8:
            raise ErasureCodeError("liber8tion is defined for w=8")
        if self.technique == "blaum_roth":
            self.bitmatrix = blaum_roth_bitmatrix(self.k, self.w)
        elif self.technique == "liberation":
            self.bitmatrix = liberation_bitmatrix(self.k, self.w)
        else:
            # liber8tion: the JAX package's MDS stand-in (bitmatrix_code)
            self.bitmatrix = raid6_bitmatrix(self.k, self.w)
        self.profile.setdefault("backend", "torch")
        self._init_bitmatrix()


@register("jerasure")
def _jerasure_factory(profile):
    technique = dict(profile).get("technique", "reed_sol_van")
    if technique not in TECHNIQUES:
        raise ErasureCodeError(f"unknown technique {technique!r}")
    if technique in BIT_TECHNIQUES:
        return JerasureBitCode(profile)
    return JerasureCode(profile)
