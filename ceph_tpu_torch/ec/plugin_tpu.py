"""The `tpu` erasure-code plugin of the PyTorch port — the north star
(BASELINE.json: reed_sol_van k=8, m=3 on 1 MiB stripes, byte-exact).

It registers under the JAX package's name, ``tpu``, so profiles and the
corpus directory names carry over.  encode_chunks / decode_chunks run
the hand-written CUDA GF(2^8) kernels (ops/ec_kernels.py) on the
profile's ``device`` (default ``cuda``), and a batched API folds many
stripes into one (k, batch*L) launch.
"""

from __future__ import annotations

import numpy as np

from ..ops import gf256
from .interface import ChunkMap, ErasureCodeError, Flags, profile_int
from .matrix_code import MatrixErasureCode
from .registry import register

PLUGIN_API_VERSION = 1


@register("tpu")
class TpuCode(MatrixErasureCode):
    """Matrix RS/Cauchy with CUDA-kernel region math."""

    def _init_from_profile(self) -> None:
        self.k = profile_int(self.profile, "k", 8)
        self.m = profile_int(self.profile, "m", 3)
        self.technique = self.profile.get("technique", "reed_sol_van")
        if self.technique == "reed_sol_van":
            self.matrix = gf256.vandermonde_matrix(self.k, self.m)
        elif self.technique in ("cauchy", "cauchy_orig"):
            self.matrix = gf256.cauchy_matrix(self.k, self.m)
        elif self.technique == "cauchy_good":
            self.matrix = gf256.cauchy_good_matrix(self.k, self.m)
        else:
            raise ErasureCodeError(f"unknown technique {self.technique!r}")
        self.profile.setdefault("backend", "torch")
        self._init_matrix_backend()

    def get_flags(self) -> Flags:
        return super().get_flags() | Flags.ZERO_INPUT_ZERO_OUTPUT

    # -- batched stripe API (beyond the reference interface) ---------------
    def encode_batch(self, stripes: np.ndarray) -> np.ndarray:
        """(batch, k, L) data -> (batch, m, L) parity in one launch.

        Columns are independent, so a stripe batch folds into the length
        axis: (batch, k, L) -> (k, batch*L) without changing the math.
        When the profile resolves a device fan-out (``shard`` key /
        ``ec_shard`` option) the folded launch shards its length axis
        across the mesh; an indivisible batch*L takes the single-device
        launch, byte-identical.
        """
        stripes = np.ascontiguousarray(stripes, dtype=np.uint8)
        b, k, L = stripes.shape
        if k != self.k:
            raise ErasureCodeError(f"expected k={self.k}, got {k}")
        folded = stripes.transpose(1, 0, 2).reshape(k, b * L)
        # device-resident multiply: ONE host copy for the whole batch
        parity = self.host_sync(self._matmul_device(
            self.matrix, folded, n_shard=self.shard_devices()))
        return parity.reshape(self.m, b, L).transpose(1, 0, 2)

    def decode_batch(self, want: list[int], stripes: ChunkMap) -> ChunkMap:
        """Batched decode: stripes maps shard id -> (batch, L) arrays; the
        batch folds into the length axis exactly as in encode_batch,
        with the same mesh fan-out."""
        batch, L = next(iter(stripes.values())).shape
        flat = {i: np.ascontiguousarray(v, dtype=np.uint8).reshape(batch * L)
                for i, v in stripes.items()}
        out = self.decode_chunks(want, flat, n_shard=self.shard_devices())
        return {i: v.reshape(batch, L) for i, v in out.items()}
