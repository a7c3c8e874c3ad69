"""General (possibly non-MDS) systematic matrix codes of the PyTorch port.

The counterpart of the JAX package's ``ceph_tpu/ec/general_code.py``,
copied with its imports rewritten; the region products run through the
port's backends (MatrixErasureCode._matmul_device: the CUDA kernels on
the ``torch`` backend, the native library or numpy on the host), and a
folded decode stays a tensor on the codec's device on the torch
backend.

LRC and SHEC are systematic codes whose parity rows do NOT form an MDS
matrix — not every k-subset of surviving chunks can decode.  This base
class holds the full (n, k) generator stack [I; P] and decodes by finding
an invertible k-row subset among survivors (rank-greedy selection with the
caller's preferred order first) — the generalisation of the reference's
per-erasure-signature matrix inversion (jerasure matrix_decode / LRC layer
fallback, ref src/erasure-code/lrc/ErasureCodeLrc.cc minimum_to_decode
trying cheapest layers first).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..ops import gf256
from .interface import ChunkMap, ErasureCodeError, Flags
from .matrix_code import MatrixErasureCode


def independent_rows(full: np.ndarray, candidates: list[int],
                     k: int) -> list[int] | None:
    """Greedy rank-building selection of k independent rows (GF(2^8))."""
    chosen: list[int] = []
    for rid in candidates:
        if len(chosen) == k:
            break
        if _gf_rank(full[chosen + [rid]]) > len(chosen):
            chosen.append(rid)
    return chosen if len(chosen) == k else None


def _gf_rref(M: np.ndarray) -> np.ndarray:
    M = M.copy()
    rows, cols = M.shape
    mt = gf256.mul_table()
    r = 0
    for c in range(cols):
        piv = None
        for i in range(r, rows):
            if M[i, c]:
                piv = i
                break
        if piv is None:
            continue
        M[[r, piv]] = M[[piv, r]]
        M[r] = mt[gf256.inv_table()[M[r, c]], M[r]]
        for i in range(rows):
            if i != r and M[i, c]:
                M[i] ^= mt[M[i, c], M[r]]
        r += 1
        if r == rows:
            break
    # move zero rows to the bottom
    nz = [i for i in range(rows) if M[i].any()]
    z = [i for i in range(rows) if not M[i].any()]
    return M[nz + z]


def _gf_rank(M: np.ndarray) -> int:
    R = _gf_rref(M)
    return int(sum(1 for i in range(R.shape[0]) if R[i].any()))


class GeneralMatrixCode(MatrixErasureCode):
    """Systematic code over a full (n, k) generator stack [I; P]."""

    #: subclasses set full generator stack; parity block = rows [k:]
    full: np.ndarray

    def _init_general(self) -> None:
        self.matrix = np.ascontiguousarray(self.full[self.k:])
        #: (want, rows) -> combination matrix R with wanted = R @ rows
        #: (the folded-decode counterpart of _decode_cache, same LRU cap)
        self._fold_cache: dict[tuple, np.ndarray] = {}
        self._init_matrix_backend()

    # -- chunk-space repair equations (the locality machinery) -------------
    def repair_equations(self) -> list[dict[int, int]]:
        """GF-linear relations among CHUNKS: each dict {chunk_id: coef}
        satisfies XOR_i coef_i * chunk_i = 0.  The default is one equation
        per parity row (parity = combination of data chunks); locality
        codes override/extend with narrower relations (LRC's group XORs) —
        single failures then repair from one equation instead of a k-wide
        inversion."""
        eqs = []
        for j in range(self.m):
            eq = {self.k + j: 1}
            for c in range(self.k):
                if self.full[self.k + j, c]:
                    eq[c] = int(self.full[self.k + j, c])
            eqs.append(eq)
        return eqs

    def _cheap_repair_eq(self, missing: int,
                         avail: set[int]) -> dict[int, int] | None:
        """Smallest repair equation covering `missing` with all other
        participants available."""
        best = None
        for eq in self.repair_equations():
            if missing not in eq:
                continue
            others = [i for i in eq if i != missing]
            if all(i in avail for i in others):
                if best is None or len(eq) < len(best):
                    best = eq
        return best

    def _apply_repair_eq(self, eq: dict[int, int], missing: int,
                         chunks: ChunkMap) -> np.ndarray:
        acc = None
        for i, coef in eq.items():
            if i == missing:
                continue
            t = gf256.gf_mul(np.uint8(coef),
                             np.asarray(chunks[i], dtype=np.uint8))
            acc = t if acc is None else acc ^ t
        return gf256.gf_mul(gf256.inv_table()[eq[missing]], acc)

    # -- decode preference order (subclasses refine for locality) ----------
    def _decode_candidates(self, want: Sequence[int],
                           available: Sequence[int]) -> list[int]:
        """Order in which surviving rows should be tried."""
        avail = sorted(available)
        return ([i for i in avail if i < self.k]
                + [i for i in avail if i >= self.k])

    def repair_cost(self, chunk: int, available) -> int:
        """Chunks read to repair a single failure (locality metric)."""
        return len(self.minimum_to_decode([chunk],
                                          [i for i in available
                                           if i != chunk]))

    def get_flags(self):
        return super().get_flags() & ~Flags.PARITY_DELTA_OPTIMIZATION

    # -- batcher fold protocol (see MatrixErasureCode) ---------------------
    def fold_sig(self) -> tuple:
        # the FULL generator stack, not just the parity block: decode
        # selection (locality equations, rank-greedy subsets) reads
        # self.full, so two codes agreeing on [P] but not on the whole
        # stack must not share a fold
        return ("gen", type(self).__name__, self.full.shape,
                self.full.tobytes())

    def decode_fold_kind(self) -> str | None:
        return "plain"

    def fold_rows(self, want, avail) -> list[int] | None:
        """Survivor rows a folded decode consumes: a single failure
        takes its cheapest repair equation's participants (LRC's one
        locality group, SHEC's shingle window — a narrow (|group|,
        sum L) fold instead of a k-wide inversion); everything else
        takes a rank-greedy invertible k-subset in the locality-first
        candidate order.  None = this erasure cannot decode.  Cached:
        the batcher resolves rows per op and per flush, and the
        rank-greedy selection costs O(k^3) table work per miss."""
        key = ("rows", tuple(want), tuple(avail))
        with self._cache_lock:
            hit = self._fold_cache.get(key)
            if hit is not None:
                return hit[0]
        avail = [i for i in avail if i < self.chunk_count]
        missing = [i for i in want if i not in avail]
        rows = None
        if len(missing) == 1:
            eq = self._cheap_repair_eq(missing[0], set(avail))
            if eq is not None:
                rows = sorted(i for i in eq if i != missing[0])
        if rows is None:
            rows = independent_rows(
                self.full, self._decode_candidates(want, avail), self.k)
        with self._cache_lock:
            if len(self._fold_cache) > self.DECODE_CACHE_CAP:
                self._fold_cache.pop(next(iter(self._fold_cache)))
            self._fold_cache[key] = (rows,)  # (None,) caches the miss too
        return rows

    def _fold_matrix(self, want: tuple, rows: tuple) -> np.ndarray:
        """Combination matrix R (len(want), len(rows)) with
        wanted_chunks = R @ stack(rows): ONE region matmul reconstructs
        every wanted chunk of a folded launch.  Single failures use a
        repair equation over exactly `rows` (R is one narrow row);
        otherwise rows must be k independent survivors and
        R = full[want] @ inv(full[rows]).  Cached LRU like the decode
        matrices — erasure signatures repeat across a storm."""
        key = (want, rows)
        with self._cache_lock:
            hit = self._fold_cache.pop(key, None)
            if hit is not None:
                self._fold_cache[key] = hit  # LRU touch
                return hit
        R = None
        if len(want) == 1:
            eq = self._cheap_repair_eq(want[0], set(rows))
            if eq is not None and set(eq) - {want[0]} <= set(rows):
                inv = int(gf256.inv_table()[eq[want[0]]])
                R = np.zeros((1, len(rows)), dtype=np.uint8)
                for j, r in enumerate(rows):
                    if r in eq:
                        R[0, j] = int(gf256.gf_mul(inv, eq[r]))
        if R is None:
            if len(rows) != self.k:
                raise ErasureCodeError(
                    f"cannot fold-decode {list(want)} from {list(rows)}")
            D = gf256.gf_mat_inv(self.full[list(rows)])
            R = gf256.gf_matmul(self.full[list(want)], D)
        with self._cache_lock:
            if len(self._fold_cache) > self.DECODE_CACHE_CAP:
                self._fold_cache.pop(next(iter(self._fold_cache)))
            self._fold_cache[key] = R
        return R

    def decode_folded_device(self, want, avail, stacked, *,
                             n_shard: int = 1):
        """Folded decode over the fold_rows() survivor stack: ONE
        region matmul with the cached combination matrix — a tensor on
        the codec's device on the torch backend (the caller carves
        waiters out of one bulk copy back), numpy elsewhere."""
        rows = [i for i in avail if i < self.chunk_count]
        R = self._fold_matrix(tuple(want), tuple(rows))
        return self._matmul_device(R, stacked[: len(rows)],
                                   n_shard=n_shard)

    def minimum_to_decode(self, want, available):
        want_s, avail_s = set(want), set(available)
        if want_s <= avail_s:
            return sorted(want_s)
        missing = sorted(want_s - avail_s)
        if len(missing) == 1:
            eq = self._cheap_repair_eq(missing[0], avail_s)
            if eq is not None:
                return sorted((set(eq) - {missing[0]})
                              | (want_s & avail_s))
        rows = independent_rows(
            self.full, self._decode_candidates(want, available), self.k)
        if rows is None:
            raise ErasureCodeError(
                f"cannot decode {sorted(want_s)} from {sorted(avail_s)}")
        return sorted(set(rows) | (want_s & avail_s))

    def decode_chunks(self, want: Sequence[int], chunks: ChunkMap, *,
                      n_shard: int = 1) -> ChunkMap:
        avail = [i for i in chunks if i < self.chunk_count]
        missing = [i for i in want if i not in chunks]
        if len(missing) == 1:
            eq = self._cheap_repair_eq(missing[0], set(avail))
            if eq is not None:
                out = {i: chunks[i] for i in want if i in chunks}
                out[missing[0]] = self._apply_repair_eq(
                    eq, missing[0], chunks)
                return out
        rows = independent_rows(
            self.full, self._decode_candidates(want, avail), self.k)
        if rows is None:
            raise ErasureCodeError(
                f"cannot decode {sorted(want)} from {sorted(avail)}")
        sub = self.full[rows]
        D = gf256.gf_mat_inv(sub)
        stack = np.stack([np.ascontiguousarray(chunks[i], dtype=np.uint8)
                          for i in rows])
        data = self._matmul(D, stack, n_shard=n_shard)
        out: ChunkMap = {}
        for i in want:
            if i in chunks:
                out[i] = chunks[i]
            elif i < self.k:
                out[i] = data[i]
            else:
                out[i] = self._matmul(self.full[[i]], data,
                                      n_shard=n_shard)[0]
        return out
