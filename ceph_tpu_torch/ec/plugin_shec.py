"""SHEC plugin of the PyTorch port: shingled erasure code.

The counterpart of the JAX package's ``ceph_tpu/ec/plugin_shec.py``,
registered under the same name, ``shec``, with the same construction.
The backend defaults to ``torch`` on the profile's ``device`` (default
``cuda``): the region products (encode, folded decodes, the fused
encode+CRC op) run the CUDA kernels.  ``native`` and ``numpy`` run on
the host; an explicit ``auto`` resolves as in the JAX package.

The capability of the reference's shec plugin
(src/erasure-code/shec/ErasureCodeShec.{h,cc}: k data, m
parities, durability estimator c; each parity covers a shingled window of
the data so single/short failures repair with fewer reads than k).

Construction here: parity j covers a window of w = ceil(k*c/m) consecutive
data chunks; window starts spread evenly so consecutive parities overlap
("shingle").  Coefficients inside a window are Cauchy elements, giving
good (not guaranteed-MDS) independence: all single failures and most
<= c multi-failures decode; unrecoverable combinations raise, as the
reference's shec does.  technique=single/multiple is accepted and recorded
(the reference's variants differ in recovery optimisation, not layout).
"""

from __future__ import annotations

import numpy as np

from ..ops import gf256
from .general_code import GeneralMatrixCode
from .interface import ErasureCodeError, profile_int
from .registry import register

PLUGIN_API_VERSION = 1


@register("shec")
class ShecCode(GeneralMatrixCode):
    def _init_from_profile(self) -> None:
        self.k = profile_int(self.profile, "k", 4)
        self.m = profile_int(self.profile, "m", 3)
        self.c = profile_int(self.profile, "c", 2)
        self.technique = self.profile.get("technique", "multiple")
        if self.technique not in ("single", "multiple"):
            raise ErasureCodeError(f"unknown technique {self.technique!r}")
        if not 0 < self.c <= self.m:
            raise ErasureCodeError(f"need 0 < c={self.c} <= m={self.m}")
        k, m, c = self.k, self.m, self.c
        self.window = min(k, -(-k * c // m))  # ceil(k*c/m)
        P = np.zeros((m, k), dtype=np.uint8)
        for j in range(m):
            start = 0 if m == 1 else round(j * (k - self.window) / (m - 1))
            for idx in range(self.window):
                col = start + idx
                # Cauchy coefficients for within-window independence
                P[j, col] = gf256.inv_table()[(j ^ (m + col)) & 0xFF]
        self.full = np.concatenate([np.eye(k, dtype=np.uint8), P])
        self.profile.setdefault("backend", "torch")
        self._init_general()

    def _covering_parities(self, data_chunk: int) -> list[int]:
        return [self.k + j for j in range(self.m)
                if self.full[self.k + j, data_chunk]]

    def _decode_candidates(self, want, available):
        """Prefer the narrow repair set: for a failed data chunk, the
        chunks inside one covering parity's window (the shingle) first."""
        avail = set(available)
        order: list[int] = []

        def add(ids):
            for i in ids:
                if i in avail and i not in order:
                    order.append(i)

        for miss in want:
            if miss in avail:
                continue
            if miss < self.k:
                for p in self._covering_parities(miss):
                    if p in avail:
                        window = [c for c in range(self.k)
                                  if self.full[p, c]]
                        add(w for w in window if w != miss)
                        add([p])
                        break
        add(range(self.k))
        add(range(self.k, self.chunk_count))
        return order
