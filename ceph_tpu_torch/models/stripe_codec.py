"""StripeCodec — the flagship EC compute pipeline of the port.

A batch of stripes lives as a (k, batch*chunk) uint8 tensor on the card
(batching stripes widens the column axis), and encode/decode are GF(2^8)
region products.  The counterpart of ``ceph_tpu/models/stripe_codec.py``:
its graphs are functions on tensors that launch the hand-written kernels
on a CUDA tensor and run their plain versions on a CPU tensor.
"""

from __future__ import annotations

import numpy as np

from ..ops import gf256
from ..ops.ec_kernels import region_fn


def coding_matrix(k: int, m: int, technique: str = "reed_sol_van") -> np.ndarray:
    if technique == "reed_sol_van":
        return gf256.vandermonde_matrix(k, m)
    if technique in ("cauchy", "cauchy_orig"):
        return gf256.cauchy_matrix(k, m)
    if technique == "cauchy_good":
        return gf256.cauchy_good_matrix(k, m)
    raise ValueError(f"unknown technique {technique!r}")


class StripeCodec:
    """k+m systematic stripe codec with encode/decode functions on
    tensors."""

    def __init__(self, k: int = 8, m: int = 3,
                 technique: str = "reed_sol_van"):
        self.k, self.m, self.technique = k, m, technique
        self.matrix = coding_matrix(k, m, technique)
        self.full = np.concatenate(
            [np.eye(k, dtype=np.uint8), self.matrix])

    def encode_graph(self, kernel: str = "auto"):
        """fn(data (k, N) uint8 tensor) -> parity (m, N) on data's
        device.  ``kernel`` picks the realization (ec_kernels.KERNELS):
        ``auto`` is the bit-term kernel on the card and the plain
        version on the CPU."""
        return region_fn(self.matrix, kernel)

    def stack_rows_graph(self, rows: list[int]):
        """fn(data (k, N)) -> the given rows of the full [I; C] stack —
        what a shard-parallel device computes for the chunks it owns."""
        return region_fn(self.full[rows])

    def decode_graph(self, available: list[int]):
        """fn(survivors (k, N)) -> data (k, N) for a static erasure
        signature (the decode matrix is inverted once, when the function
        is built, as the reference caches inverted tables per
        signature, ErasureCodeIsa.cc:513-563)."""
        D = gf256.decode_matrix(self.matrix, self.k, available)
        return region_fn(D)
