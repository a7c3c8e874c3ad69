"""Minimal XOR example plugin of the PyTorch port (k data + 1 parity).

The counterpart of the JAX package's ``ceph_tpu/ec/plugin_xor.py``: the
in-tree fake plugin the reference uses for registry and unit tests
(ErasureCodeExample.h), kept both as a registry test subject and as the
cheapest m=1 code.  The backend defaults to ``torch`` on the profile's
``device`` (default ``cuda``).
"""

from __future__ import annotations

import numpy as np

from .interface import profile_int
from .matrix_code import MatrixErasureCode
from .registry import register

PLUGIN_API_VERSION = 1


@register("xor")
class XorCode(MatrixErasureCode):
    def _init_from_profile(self) -> None:
        self.k = profile_int(self.profile, "k", 2)
        self.m = 1
        self.matrix = np.ones((1, self.k), dtype=np.uint8)
        self.profile.setdefault("backend", "torch")
        self._init_matrix_backend()
