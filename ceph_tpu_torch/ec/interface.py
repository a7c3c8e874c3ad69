"""Erasure-code plugin interface — the shape of Ceph's ErasureCodeInterface.

Re-designs the contract of the reference's plugin ABI
(src/erasure-code/ErasureCodeInterface.h:183 — encode:402,
encode_chunks:448, encode_delta/apply_delta:470/498, decode:538,
decode_chunks:570, minimum_to_decode:310, get_chunk_size:291,
get_chunk_mapping:612, get_minimum_granularity:361, flags:645-693) for a
numpy/PyTorch world: chunks are uint8 arrays keyed by shard id instead of
bufferlists keyed by shard_id_t, and the default helpers of the reference's
ErasureCode base class (encode_prepare split+pad ErasureCode.cc:239-266,
SIMD_ALIGN=64 :43, greedy minimum_to_decode) live on the base class here.

All codes are systematic: shards [0, k) are data, [k, k+m) are parity, with
an optional chunk_mapping permutation (as the reference allows).
"""

from __future__ import annotations

import enum
from abc import ABC, abstractmethod
from typing import Mapping, Sequence

import numpy as np

# input alignment the base class pads chunks to (ref ErasureCode.cc:43)
SIMD_ALIGN = 64
# page alignment of the OSD stripe path (ref ECUtil.h:33 EC_ALIGN_SIZE)
EC_ALIGN_SIZE = 4096


class Flags(enum.IntFlag):
    """Plugin capability flags (ref ErasureCodeInterface.h:645-693)."""

    NONE = 0
    PARTIAL_READ_OPTIMIZATION = enum.auto()
    PARTIAL_WRITE_OPTIMIZATION = enum.auto()
    ZERO_INPUT_ZERO_OUTPUT = enum.auto()
    ZERO_PADDING = enum.auto()
    PARITY_DELTA_OPTIMIZATION = enum.auto()
    REQUIRE_SUB_CHUNKS = enum.auto()
    OPTIMIZED_SUPPORTED = enum.auto()
    CRC_ENCODE_DECODE = enum.auto()
    DIRECT_READS = enum.auto()


ChunkMap = dict[int, np.ndarray]
Profile = Mapping[str, str]


class ErasureCodeError(Exception):
    pass


def profile_int(profile: Profile, key: str, default: int) -> int:
    v = profile.get(key)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError as e:
        raise ErasureCodeError(f"profile {key}={v!r} is not an integer") from e


class ErasureCode(ABC):
    """Base class: chunk bookkeeping + default encode/decode plumbing."""

    def __init__(self, profile: Profile):
        self.profile = dict(profile)
        self.k: int = 0
        self.m: int = 0
        self._init_from_profile()
        if self.k <= 0 or self.m < 0:
            raise ErasureCodeError(f"bad k={self.k}/m={self.m}")

    # -- identity ----------------------------------------------------------
    @abstractmethod
    def _init_from_profile(self) -> None:
        """Parse self.profile, set self.k/self.m and prepare tables."""

    @property
    def chunk_count(self) -> int:
        return self.k + self.m

    @property
    def data_chunk_count(self) -> int:
        return self.k

    @property
    def coding_chunk_count(self) -> int:
        return self.m

    def get_flags(self) -> Flags:
        return Flags.NONE

    def get_chunk_mapping(self) -> list[int]:
        """raw index -> shard id permutation; identity unless remapped."""
        return list(range(self.chunk_count))

    def get_minimum_granularity(self) -> int:
        """Smallest IO granularity preserving decodability (ref :361)."""
        return 1

    def get_sub_chunk_count(self) -> int:
        return 1

    def get_chunk_size(self, stripe_width: int) -> int:
        """Chunk size for an object of stripe_width bytes (ref :291):
        ceil(width / k) rounded up so chunks stay SIMD_ALIGN-aligned."""
        per = -(-stripe_width // self.k)
        return -(-per // SIMD_ALIGN) * SIMD_ALIGN

    # -- encode ------------------------------------------------------------
    def encode_prepare(self, data: bytes | np.ndarray) -> np.ndarray:
        """Split+zero-pad input into a (k, chunk_size) matrix
        (ref ErasureCode.cc:239-266)."""
        buf = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else np.asarray(
                data, dtype=np.uint8).reshape(-1)
        cs = self.get_chunk_size(buf.size)
        out = np.zeros((self.k, cs), dtype=np.uint8)
        flat = out.reshape(-1)
        flat[: buf.size] = buf
        return out

    def encode(self, data: bytes | np.ndarray,
               want: Sequence[int] | None = None) -> ChunkMap:
        """Full-stripe encode: returns {shard_id: chunk} for `want`
        (default: all k+m shards) (ref ErasureCodeInterface.h:402)."""
        chunks = self.encode_prepare(data)
        parity = self.encode_chunks(chunks)
        allmap: ChunkMap = {i: chunks[i] for i in range(self.k)}
        allmap.update({self.k + i: parity[i] for i in range(self.m)})
        if want is None:
            return allmap
        return {i: allmap[i] for i in want}

    @abstractmethod
    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        """(k, L) data -> (m, L) parity (ref :448)."""

    # -- decode ------------------------------------------------------------
    def minimum_to_decode(self, want: Sequence[int],
                          available: Sequence[int]) -> list[int]:
        """Smallest shard set that can serve `want` (ref :310).  Greedy, as
        the reference base class: prefer wanted shards themselves, then
        remaining data shards, then parity."""
        want_s, avail_s = set(want), set(available)
        if want_s <= avail_s:
            return sorted(want_s)
        chosen = sorted(want_s & avail_s)
        for i in sorted(avail_s - want_s):
            if len(chosen) >= self.k:
                break
            chosen.append(i)
        chosen = sorted(chosen)[: self.k] if len(chosen) >= self.k else chosen
        if len(chosen) < self.k:
            raise ErasureCodeError(
                f"cannot decode {sorted(want_s)} from {sorted(avail_s)}")
        return chosen

    def minimum_to_decode_with_cost(
            self, want: Sequence[int],
            available_costs: Mapping[int, int]) -> list[int]:
        """Cost-aware variant (ref :345): pick cheapest feasible set."""
        order = sorted(available_costs, key=lambda i: (available_costs[i], i))
        picked: list[int] = []
        want_left = set(want)
        for i in order:
            if i in want_left:
                picked.append(i)
                want_left.discard(i)
        if not want_left:
            return sorted(picked)
        for i in order:
            if len(picked) >= self.k:
                break
            if i not in picked:
                picked.append(i)
        if len(picked) < self.k:
            raise ErasureCodeError("not enough shards")
        return sorted(picked[: self.k])

    def decode(self, want: Sequence[int], chunks: ChunkMap) -> ChunkMap:
        """Reconstruct `want` shards from available `chunks` (ref :538)."""
        have = {i for i in want if i in chunks}
        need = [i for i in want if i not in chunks]
        out = {i: chunks[i] for i in have}
        if need:
            out.update(self.decode_chunks(need, chunks))
        return {i: out[i] for i in want}

    @abstractmethod
    def decode_chunks(self, want: Sequence[int],
                      chunks: ChunkMap) -> ChunkMap:
        """Reconstruct the missing `want` chunks from survivors (ref :570)."""

    # -- parity delta (RMW path; ref :470-:498) ----------------------------
    def encode_delta(self, old_data: np.ndarray,
                     new_data: np.ndarray) -> np.ndarray:
        """Delta between old and new bytes of one data shard — XOR in
        GF(2^8) (ref :470: "delta = old XOR new" for linear codes)."""
        if not self.supports_parity_delta():
            raise ErasureCodeError("plugin does not support parity delta")
        return np.bitwise_xor(
            np.asarray(old_data, dtype=np.uint8),
            np.asarray(new_data, dtype=np.uint8))

    def apply_delta(self, delta: np.ndarray, data_shard: int,
                    parity_chunks: ChunkMap) -> None:
        """Fold a data-shard delta into parity chunks in place (ref :498)."""
        raise ErasureCodeError("plugin does not support parity delta")

    def supports_parity_delta(self) -> bool:
        return bool(self.get_flags() & Flags.PARITY_DELTA_OPTIMIZATION)
