"""ISA-L-shaped plugin of the PyTorch port: Vandermonde or Cauchy RS (the
reference's default plugin for new pools since Tentacle).

The counterpart of the JAX package's ``ceph_tpu/ec/plugin_isa.py``,
registered under the same name, ``isa``.  It mirrors the reference's
ErasureCodeIsa.cc: matrix choice, decode-table caching per erasure
signature (MatrixErasureCode._get_decode_matrix) and the single-erasure
pure-XOR fast path (the kernels' coefficient-1 XOR).  The backend
defaults to ``torch`` on the profile's ``device`` (default ``cuda``);
``native`` and ``numpy`` run on the host, and an explicit ``auto``
resolves to ``native`` when the native library loads, else ``numpy``.
"""

from __future__ import annotations

from ..ops import gf256
from .interface import ErasureCodeError, profile_int
from .matrix_code import MatrixErasureCode
from .registry import register

PLUGIN_API_VERSION = 1

DEFAULT_K = 7
DEFAULT_M = 3


@register("isa")
class IsaCode(MatrixErasureCode):
    def _init_from_profile(self) -> None:
        self.k = profile_int(self.profile, "k", DEFAULT_K)
        self.m = profile_int(self.profile, "m", DEFAULT_M)
        self.technique = self.profile.get("technique", "reed_sol_van")
        if self.technique == "reed_sol_van":
            self.matrix = gf256.vandermonde_matrix(self.k, self.m)
        elif self.technique == "cauchy":
            self.matrix = gf256.cauchy_matrix(self.k, self.m)
        else:
            raise ErasureCodeError(f"unknown technique {self.technique!r}")
        self.profile.setdefault("backend", "torch")
        self._init_matrix_backend()
