"""CLAY plugin of the PyTorch port: coupled-layer MSR code with
sub-chunking.

The counterpart of the JAX package's ``ceph_tpu/ec/plugin_clay.py``,
registered under the same name, ``clay``, with the same construction.
The backend defaults to ``torch`` on the profile's ``device`` (default
``cuda``): the plane products (the scalar MDS code across each
intersection-score group of planes, and the repair's column solve) run
the CUDA region kernels.  The pairwise coupling stays on the host, as in
the JAX package: ``native.lincomb_rows_ptrs`` over numpy-computed row
addresses on the ``native`` backend, the mul-table loop elsewhere.

The capability of the reference's clay plugin
(src/erasure-code/clay/ErasureCodeClay.{h,cc}: k data, m
parity, d helpers; get_sub_chunk_count() :71, minimum_to_decode returning
sub-chunk ranges for bandwidth-optimal repair, REQUIRE_SUB_CHUNKS flag).

This is an original implementation of the published coupled-layer
construction (Clay codes, FAST'18): with q = d-k+1 and t = n/q, each chunk
is alpha = q^t sub-chunks; node (x, y) on a q x t grid stores coupled
symbols C related to an "uncoupled" virtual codeword U by pairwise
invertible transforms within each column, and every z-plane of U is a
codeword of a scalar (n, k) MDS code.  Single-node repair with d = n-1
helpers reads only alpha/q sub-chunks from each helper (the MSR bandwidth
point) instead of whole chunks.

Shortening (ref ErasureCodeClay.cc nu handling): when q = d-k+1 does
not divide n, the grid is built over n + nu nodes with nu VIRTUAL
all-zero data nodes (internal ids [k, k+nu)); the scalar plane code is
(k+nu+m, k+nu) MDS.  External chunk ids stay [0, n): data i maps to
internal i, parity j to internal k+nu+j.  The MSR sub-chunk repair
path applies when d = k+m-1 (m == q); other valid d fall back to full
MDS decode (correct, not bandwidth-optimal).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..ops import gf256, native
from .interface import (SIMD_ALIGN, ChunkMap, ErasureCodeError, Flags,
                        profile_int)
from .matrix_code import MatrixErasureCode, _as_host
from .registry import register

PLUGIN_API_VERSION = 1

GAMMA = 2  # coupling coefficient; needs gamma^2 != 1


@register("clay")
class ClayCode(MatrixErasureCode):
    def _init_from_profile(self) -> None:
        self.k = profile_int(self.profile, "k", 8)
        self.m = profile_int(self.profile, "m", 4)
        n = self.k + self.m
        self.d = profile_int(self.profile, "d", n - 1)
        if not self.k < n:
            raise ErasureCodeError("need m >= 1")
        if not self.k < self.d <= n - 1:
            raise ErasureCodeError(f"need k < d <= k+m-1, got d={self.d}")
        self.q = self.d - self.k + 1
        if self.q < 2:
            raise ErasureCodeError(f"d={self.d} gives q={self.q} < 2")
        # shortening: pad the grid with nu virtual zero data nodes so q
        # divides the internal node count
        self.nu = (self.q - n % self.q) % self.q
        self.k_int = self.k + self.nu
        self.n_int = n + self.nu
        self.t = self.n_int // self.q
        self.alpha = self.q ** self.t
        # scalar MDS code across each z-plane (over internal data)
        self.matrix = gf256.vandermonde_matrix(self.k_int, self.m)
        self.full = np.concatenate(
            [np.eye(self.k_int, dtype=np.uint8), self.matrix])
        # parity-check H = [P | I]: H @ u = 0 for plane codewords
        self.H = np.concatenate(
            [self.matrix, np.eye(self.m, dtype=np.uint8)], axis=1)
        g2 = int(gf256.gf_mul(GAMMA, GAMMA))
        self._inv_det = int(gf256.gf_inv(1 ^ g2))  # 1/(1 ^ gamma^2)
        # pair structure (independent of the erasure set): partner node
        # pn[node, z] (-1 = unpaired) and partner plane pz[node, z]
        n, q, t, alpha = self.n_int, self.q, self.t, self.alpha
        zs = np.arange(alpha)
        digits = np.stack([(zs // q ** y) % q for y in range(t)])  # (t, a)
        self._digits = digits
        pn = np.full((n, alpha), -1, dtype=np.int64)
        pz = np.zeros((n, alpha), dtype=np.int64)
        for node in range(n):
            x, y = self._xy(node)
            zy = digits[y]
            paired = zy != x
            pn[node, paired] = zy[paired] + y * q
            pz[node, paired] = zs[paired] + (x - zy[paired]) * q ** y
        self._pn, self._pz = pn, pz
        self.profile.setdefault("backend", "torch")
        self._init_matrix_backend()

    # -- identity ----------------------------------------------------------
    def get_sub_chunk_count(self) -> int:
        return self.alpha

    def get_flags(self) -> Flags:
        return (Flags.ZERO_PADDING | Flags.REQUIRE_SUB_CHUNKS)

    def get_minimum_granularity(self) -> int:
        return self.alpha

    def get_chunk_size(self, stripe_width: int) -> int:
        base = super().get_chunk_size(stripe_width)
        # chunks must split evenly into alpha aligned sub-chunks
        quantum = self.alpha * SIMD_ALIGN
        return -(-base // quantum) * quantum

    # -- coordinate helpers ------------------------------------------------
    def _ext2int(self, i: int) -> int:
        """External chunk id -> internal grid node (skip virtual pads)."""
        return i if i < self.k else i + self.nu

    def _virtual(self, node: int) -> bool:
        return self.k <= node < self.k_int

    def _xy(self, node: int) -> tuple[int, int]:
        return node % self.q, node // self.q

    def _node(self, x: int, y: int) -> int:
        return y * self.q + x

    def _digit(self, z: int, y: int) -> int:
        return (z // self.q ** y) % self.q

    # -- pairwise coupling -------------------------------------------------
    def _lin_rows(self, dst: list, a: list, b: list | None,
                  ca: int, cb: int, L: int) -> None:
        """Fallback (non-native backends): dst[i] = ca*a[i] ^ cb*b[i]
        over gathered row views via mul-table lookups.  The native path
        goes through lincomb_rows_ptrs with numpy-computed addresses
        instead — per-row view marshalling would dominate there."""
        if not dst:
            return
        mt = gf256.mul_table()
        ra = mt[ca] if ca != 1 else None
        rb = mt[cb] if b is not None and cb else None
        for i, d in enumerate(dst):
            v = a[i] if ra is None else ra[a[i]]
            if rb is not None:
                v = v ^ rb[b[i]]
            d[...] = v

    # -- core: recover erased C given alive C (also the encode) ------------
    def _decode_symbols(self, C: dict[int, np.ndarray],
                        erased: list[int], L: int
                        ) -> dict[int, np.ndarray]:
        """C: alive INTERNAL node -> (alpha, L) sub-chunk array (virtual
        pads included as zeros).  Returns C for erased nodes.

        IS-ordered recovery of the uncoupled codeword U, then
        re-coupling — vectorized by intersection-score GROUP: planes
        with equal IS only depend on strictly-lower groups (a partner
        plane of an erased-digit position has IS one lower), so each
        group runs as whole-array gathers/XORs and ONE region matmul
        through the backend instead of per-plane Python loops.  The
        per-symbol original ran ~250x slower than the plain RS plugins
        at k=8 d=11; this form keeps CLAY's repair-bandwidth win from
        costing two orders of magnitude at encode time."""
        n = self.n_int
        alpha = self.alpha
        E = sorted(set(erased))
        if len(E) > self.m:
            raise ErasureCodeError(f"{len(E)} erasures > m={self.m}")
        # intersection score per plane, vectorized over the digit grid
        erased_mask = np.zeros(n, dtype=bool)
        erased_mask[E] = True
        node_of = self._digits + np.arange(self.t)[:, None] * self.q
        IS = erased_mask[node_of].sum(axis=0)  # (alpha,)
        alive = [i for i in range(n) if not erased_mask[i]]
        use = alive[: self.k_int]
        # encode / data-intact decode: the survivors ARE the message
        # nodes, so the decode matrix is the identity — skip its full
        # k x k region pass (it is as expensive as a whole RS encode)
        ident = use == list(range(self.k_int))
        D = (None if ident
             else gf256.decode_matrix(self.matrix, self.k_int, use))
        F_er = self.full[E]
        U = np.zeros((n, alpha, L), dtype=np.uint8)
        invdet_g = int(gf256.gf_mul(self._inv_det, GAMMA))
        # row ADDRESSES computed with numpy (base + offset): thousands
        # of coupling rows per call would otherwise drown in per-row
        # ctypes marshalling
        fast = self._backend == "native" and native.available()
        # int64 on purpose: uint64 + int64 index math would silently
        # promote to float64 and corrupt the addresses
        U_base = U.ctypes.data
        C_base = np.zeros(n, dtype=np.int64)
        for i in alive:
            C_base[i] = C[i].ctypes.data
        uaddr = (lambda nd, zz: U_base + (nd * alpha + zz) * L)
        for score in range(int(IS.max()) + 1):
            Zs = np.nonzero(IS == score)[0]
            if not len(Zs):
                continue
            # 1) U of alive nodes across the whole group: three row
            # batches (copy / partner-alive / partner-erased), one
            # native call each, pointers straight into the buffers
            cp_d, cp_a = [], []
            pa_d, pa_a, pa_b = [], [], []
            pe_d, pe_a, pe_b = [], [], []
            for node in alive:
                pns = self._pn[node, Zs]
                pzs = self._pz[node, Zs]
                unp = pns < 0
                pe = ~unp & erased_mask[np.where(unp, 0, pns)]
                pa = ~unp & ~pe
                if fast:
                    if unp.any():
                        zz = Zs[unp]
                        cp_d.append(uaddr(node, zz))
                        cp_a.append(C_base[node] + zz * L)
                    if pa.any():
                        zz = Zs[pa]
                        pa_d.append(uaddr(node, zz))
                        pa_a.append(C_base[node] + zz * L)
                        pa_b.append(C_base[pns[pa]] + pzs[pa] * L)
                    if pe.any():
                        # partner erased: its U plane has IS one lower
                        # — already recovered in an earlier group
                        zz = Zs[pe]
                        pe_d.append(uaddr(node, zz))
                        pe_a.append(C_base[node] + zz * L)
                        pe_b.append(uaddr(pns[pe], pzs[pe]))
                else:
                    Un, Cn = U[node], C[node]
                    for i, z in enumerate(Zs):
                        if unp[i]:
                            cp_d.append(Un[z]); cp_a.append(Cn[z])
                        elif pe[i]:
                            pe_d.append(Un[z]); pe_a.append(Cn[z])
                            pe_b.append(U[pns[i]][pzs[i]])
                        else:
                            pa_d.append(Un[z]); pa_a.append(Cn[z])
                            pa_b.append(C[pns[i]][pzs[i]])
            if fast:
                cat = np.concatenate
                if cp_d:
                    native.lincomb_rows_ptrs(cat(cp_d), cat(cp_a),
                                             None, 1, 0, L)
                if pa_d:
                    native.lincomb_rows_ptrs(cat(pa_d), cat(pa_a),
                                             cat(pa_b), self._inv_det,
                                             invdet_g, L)
                if pe_d:
                    native.lincomb_rows_ptrs(cat(pe_d), cat(pe_a),
                                             cat(pe_b), 1, GAMMA, L)
            else:
                self._lin_rows(cp_d, cp_a, None, 1, 0, L)
                self._lin_rows(pa_d, pa_a, pa_b, self._inv_det,
                               invdet_g, L)
                self._lin_rows(pe_d, pe_a, pe_b, 1, GAMMA, L)
            # 2) MDS-recover U of erased nodes: one region matmul over
            # the group's planes (the card on the torch backend)
            if ident and len(Zs) == alpha:
                known = U[: self.k_int].reshape(self.k_int, alpha * L)
            else:
                known = np.empty((self.k_int, len(Zs) * L),
                                 dtype=np.uint8)
                for r, i in enumerate(use):
                    known[r] = U[i, Zs].reshape(-1)
            # D's product stays on the codec's device for F_er's
            if D is not None:
                known = self._matmul_device(D, known)
            rec = self.host_sync(self._matmul_device(F_er, known))
            rec = rec.reshape(len(E), len(Zs), L)
            for r, node in enumerate(E):
                U[node, Zs] = rec[r]
        # 3) re-couple: C of erased nodes (same row batching)
        out: dict[int, np.ndarray] = {}
        cp_d, cp_a = [], []
        pa_d, pa_a, pa_b = [], [], []
        for node in E:
            buf = np.empty((alpha, L), dtype=np.uint8)
            out[node] = buf
            pns, pzs = self._pn[node], self._pz[node]
            if fast:
                unp = pns < 0
                pa = ~unp
                zz = np.arange(alpha)
                bbase = buf.ctypes.data
                if unp.any():
                    cp_d.append(bbase + zz[unp] * L)
                    cp_a.append(uaddr(node, zz[unp]))
                if pa.any():
                    pa_d.append(bbase + zz[pa] * L)
                    pa_a.append(uaddr(node, zz[pa]))
                    pa_b.append(uaddr(pns[pa], pzs[pa]))
            else:
                Un = U[node]
                for z in range(alpha):
                    pn = pns[z]
                    if pn < 0:
                        cp_d.append(buf[z]); cp_a.append(Un[z])
                    else:
                        pa_d.append(buf[z]); pa_a.append(Un[z])
                        pa_b.append(U[pn][pzs[z]])
        if fast:
            cat = np.concatenate
            if cp_d:
                native.lincomb_rows_ptrs(cat(cp_d), cat(cp_a),
                                         None, 1, 0, L)
            if pa_d:
                native.lincomb_rows_ptrs(cat(pa_d), cat(pa_a),
                                         cat(pa_b), 1, GAMMA, L)
        else:
            self._lin_rows(cp_d, cp_a, None, 1, 0, L)
            self._lin_rows(pa_d, pa_a, pa_b, 1, GAMMA, L)
        return out

    # -- public API --------------------------------------------------------
    def _split(self, chunk: np.ndarray) -> np.ndarray:
        L = chunk.shape[-1]
        if L % self.alpha:
            raise ErasureCodeError(
                f"chunk length {L} not divisible by alpha={self.alpha}")
        return np.ascontiguousarray(chunk, dtype=np.uint8).reshape(
            self.alpha, L // self.alpha)

    def _zero_split(self, L: int) -> np.ndarray:
        return np.zeros((self.alpha, L // self.alpha), dtype=np.uint8)

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        data_chunks = _as_host(data_chunks)
        if data_chunks.shape[0] != self.k:
            raise ErasureCodeError(
                f"expected {self.k} data chunks, got {data_chunks.shape[0]}")
        L = data_chunks.shape[1]
        C = {i: self._split(data_chunks[i]) for i in range(self.k)}
        for v in range(self.k, self.k_int):  # shortened: virtual zeros
            C[v] = self._zero_split(L)
        parity = self._decode_symbols(
            C, list(range(self.k_int, self.n_int)), L // self.alpha)
        return np.stack([parity[self.k_int + j].reshape(L)
                         for j in range(self.m)])

    def decode_chunks(self, want: Sequence[int],
                      chunks: ChunkMap) -> ChunkMap:
        avail = {i: c for i, c in chunks.items() if i < self.chunk_count}
        missing = [i for i in want if i not in avail]
        if not missing:
            return {i: chunks[i] for i in want}
        L = next(iter(avail.values())).shape[-1]
        C = {self._ext2int(i): self._split(np.asarray(c))
             for i, c in avail.items()}
        for v in range(self.k, self.k_int):
            C[v] = self._zero_split(L)
        # all erased nodes must be recovered together (coupling crosses them)
        erased = [self._ext2int(i) for i in range(self.chunk_count)
                  if i not in avail]
        rec = self._decode_symbols(C, erased, L // self.alpha)
        out: ChunkMap = {}
        for i in want:
            out[i] = chunks[i] if i in avail \
                else rec[self._ext2int(i)].reshape(L)
        return out

    # -- batcher fold protocol (see MatrixErasureCode) ---------------------
    # CLAY ops fold at SUB-CHUNK granularity: an op's (rows, L) chunks
    # are alpha consecutive sub-chunks of L/alpha bytes each, so a raw
    # length-axis concat of two ops would interleave op bytes across
    # plane boundaries.  Instead each op's rows reshape to (alpha, Ls)
    # and the ops concatenate along Ls — the q x t coupled-layer planes
    # become length-axis SEGMENTS of one (alpha, sum Ls) plane array per
    # node, and every coupling gather and MDS plane matmul inside
    # _decode_symbols runs ONCE over the whole fold (the matmuls are
    # the same (k, sum L) folded launches the plain plugin's flushes
    # ride, through the same kernel race).

    def fold_sig(self) -> tuple:
        # (k, m, d) pins the whole construction: grid, alpha, coupling
        # pairs, and the plane-code matrix are all derived from it
        return ("clay", self.k, self.m, self.d)

    def encode_fold_kind(self) -> str | None:
        return "subchunk"

    def decode_fold_kind(self) -> str | None:
        return "subchunk"

    def _fold_planes(self, rows: np.ndarray, n_str: int,
                     L: int) -> np.ndarray:
        """(n_rows, n_str*L) op-major fold -> per-row (alpha, n_str*Ls)
        plane-major arrays: ops become length-axis segments of each
        plane."""
        Ls = L // self.alpha
        arr = np.ascontiguousarray(rows, dtype=np.uint8).reshape(
            rows.shape[0], n_str, self.alpha, Ls)
        return np.ascontiguousarray(arr.transpose(0, 2, 1, 3)).reshape(
            rows.shape[0], self.alpha, n_str * Ls)

    def _unfold_planes(self, planes: np.ndarray, n_str: int,
                       L: int) -> np.ndarray:
        """Inverse of _fold_planes for one node: (alpha, n_str*Ls) ->
        (n_str, L) per-op chunks."""
        Ls = L // self.alpha
        return planes.reshape(self.alpha, n_str, Ls).transpose(
            1, 0, 2).reshape(n_str, L)

    def encode_chunks_folded(self, folded: np.ndarray, n_str: int,
                             L: int) -> np.ndarray:
        """Folded encode: ``folded`` is (k, n_str*L) with each op an
        exact-L segment; returns (m, n_str*L) parity in the same
        layout.  One _decode_symbols pass covers the whole launch."""
        if L % self.alpha:
            raise ErasureCodeError(
                f"chunk length {L} not divisible by alpha={self.alpha}")
        planes = self._fold_planes(folded, n_str, L)
        C = {i: planes[i] for i in range(self.k)}
        width = n_str * (L // self.alpha)
        for v in range(self.k, self.k_int):  # shortened: virtual zeros
            C[v] = np.zeros((self.alpha, width), dtype=np.uint8)
        parity = self._decode_symbols(
            C, list(range(self.k_int, self.n_int)), width)
        out = np.empty((self.m, n_str * L), dtype=np.uint8)
        for j in range(self.m):
            out[j] = self._unfold_planes(
                parity[self.k_int + j], n_str, L).reshape(-1)
        return out

    def decode_chunks_folded(self, want: Sequence[int],
                             avail: Sequence[int], folded: np.ndarray,
                             n_str: int, L: int) -> np.ndarray:
        """Folded decode: ``folded`` is (len(avail), n_str*L) survivor
        rows in ``avail`` order; returns (len(want), n_str*L)
        reconstructed rows in ``want`` order."""
        if L % self.alpha:
            raise ErasureCodeError(
                f"chunk length {L} not divisible by alpha={self.alpha}")
        avail = [i for i in avail if i < self.chunk_count]
        planes = self._fold_planes(folded[: len(avail)], n_str, L)
        C = {self._ext2int(i): planes[r] for r, i in enumerate(avail)}
        width = n_str * (L // self.alpha)
        for v in range(self.k, self.k_int):
            C[v] = np.zeros((self.alpha, width), dtype=np.uint8)
        erased = [self._ext2int(i) for i in range(self.chunk_count)
                  if i not in avail]
        rec = self._decode_symbols(C, erased, width)
        out = np.empty((len(want), n_str * L), dtype=np.uint8)
        for r, i in enumerate(want):
            out[r] = self._unfold_planes(
                rec[self._ext2int(i)], n_str, L).reshape(-1)
        return out

    # -- MSR repair (d = n-1): the sub-chunk bandwidth win -----------------
    def repair_planes(self, lost: int) -> list[int]:
        """Planes (sub-chunk indices) each helper must send to repair
        EXTERNAL chunk `lost` — alpha/q of them (z_y0 == x0)."""
        x0, y0 = self._xy(self._ext2int(lost))
        return [z for z in range(self.alpha)
                if self._digit(z, y0) == x0]

    def minimum_to_decode(self, want, available):
        """Single-failure with all other nodes available: d=n-1 helpers x
        alpha/q sub-chunks (the CLAY minimum_to_decode sub-chunk contract,
        ref ErasureCodeClay.h minimum_to_decode with (offset,count))."""
        want_s, avail_s = set(want), set(available)
        if want_s <= avail_s:
            return sorted(want_s)
        missing = sorted(want_s - avail_s)
        if (len(missing) == 1
                and len(avail_s) >= self.d == self.chunk_count - 1):
            return sorted(avail_s)[: self.d]
        return super().minimum_to_decode(want, available)

    def minimum_sub_chunks(self, lost: int, available) -> dict[int, list[int]]:
        """helper -> plane indices (sub-chunks) needed for repair."""
        planes = self.repair_planes(lost)
        return {h: list(planes) for h in available if h != lost}

    def repair_chunk(self, lost: int,
                     helper_subchunks: dict[int, np.ndarray],
                     L: int) -> np.ndarray:
        """Repair one lost EXTERNAL chunk from helpers' alpha/q sub-chunk
        slices (each helper i supplies array (alpha/q, L/alpha) — its
        planes repair_planes(lost), in that order)."""
        if self.m != self.q:
            raise ErasureCodeError(
                "sub-chunk repair applies when d = k+m-1 (m == q); use "
                "decode_chunks otherwise")
        n_ext = self.chunk_count
        n, q, alpha = self.n_int, self.q, self.alpha
        lost_i = self._ext2int(lost)
        x0, y0 = self._xy(lost_i)
        planes = self.repair_planes(lost)
        if set(helper_subchunks) != {i for i in range(n_ext) if i != lost}:
            raise ErasureCodeError("repair needs all other real nodes")
        Ls = L // alpha
        P = len(planes)
        # position of plane z inside the repair set (alpha/q planes)
        zpos = np.full(alpha, -1, dtype=np.int64)
        zpos[planes] = np.arange(P)
        # helper C values on repair planes (virtual pads stay zero)
        Carr = np.zeros((n, P, Ls), dtype=np.uint8)
        for i, s in helper_subchunks.items():
            Carr[self._ext2int(i)] = np.ascontiguousarray(
                np.asarray(s, dtype=np.uint8).reshape(P, Ls))
        U = np.zeros((n, P, Ls), dtype=np.uint8)
        fast = self._backend == "native" and native.available()
        invdet_g = int(gf256.gf_mul(self._inv_det, GAMMA))
        mt = None if fast else gf256.mul_table()
        planes_a = np.asarray(planes)
        # 1) U of nodes outside column y0 (pairs stay inside P): the
        # same batched uncoupling as _decode_symbols
        C_base, U_base = Carr.ctypes.data, U.ctypes.data
        caddr = (lambda nd, pp: C_base + (nd * P + pp) * Ls)
        uaddr = (lambda nd, pp: U_base + (nd * P + pp) * Ls)
        cp_d, cp_a = [], []
        pa_d, pa_a, pa_b = [], [], []
        outside = [nd for nd in range(n)
                   if nd != lost_i and self._xy(nd)[1] != y0]
        for node in outside:
            pns = self._pn[node, planes_a]
            pzs = self._pz[node, planes_a]
            unp = pns < 0
            pp = np.arange(P)
            if fast:
                if unp.any():
                    cp_d.append(uaddr(node, pp[unp]))
                    cp_a.append(caddr(node, pp[unp]))
                if (~unp).any():
                    pa_d.append(uaddr(node, pp[~unp]))
                    pa_a.append(caddr(node, pp[~unp]))
                    pa_b.append(caddr(pns[~unp], zpos[pzs[~unp]]))
            else:
                U[node, unp] = Carr[node, unp]
                both = Carr[node, ~unp] ^ \
                    mt[GAMMA][Carr[pns[~unp], zpos[pzs[~unp]]]]
                U[node, ~unp] = mt[self._inv_det][both]
        if fast:
            cat = np.concatenate
            if cp_d:
                native.lincomb_rows_ptrs(cat(cp_d), cat(cp_a), None,
                                         1, 0, Ls)
            if pa_d:
                native.lincomb_rows_ptrs(cat(pa_d), cat(pa_a),
                                         cat(pa_b), self._inv_det,
                                         invdet_g, Ls)
        # 2) solve the q unknown U of column y0 via the parity checks —
        # ONE region matmul across every repair plane at once
        col_nodes = [self._node(x, y0) for x in range(q)]
        Hcol = self.H[:, col_nodes]  # (m, q); square since m == q
        Hinv = gf256.gf_mat_inv(Hcol)
        other_nodes = [i for i in range(n) if i not in col_nodes]
        Hoth = self.H[:, other_nodes]
        known = np.ascontiguousarray(
            U[other_nodes].reshape(len(other_nodes), P * Ls))
        sol = self.host_sync(self._matmul_device(
            Hinv, self._matmul_device(Hoth, known)))
        sol = sol.reshape(q, P, Ls)
        for r, node in enumerate(col_nodes):
            U[node] = sol[r]
        # 3) assemble the lost chunk: the P diagonal planes are U
        # verbatim; each off-diagonal plane z folds the helper's C and
        # U at the coupled plane zp with constant coefficients
        # (ginv*C ^ (ginv^g)*U — GF addition is XOR, so the two U
        # terms merge)
        out = np.empty((alpha, Ls), dtype=np.uint8)
        ginv = int(gf256.gf_inv(GAMMA))
        zz = np.arange(alpha)
        xs = self._digits[y0]              # digit(z, y0) for every z
        diag = xs == x0
        out[diag] = U[lost_i]
        nd = zz[~diag]
        helper_nodes = xs[~diag] + y0 * q
        zp = nd + (x0 - xs[~diag]) * q ** y0   # set_digit(z, y0, x0)
        pidx = zpos[zp]
        c2 = ginv ^ GAMMA
        if fast:
            out_base = out.ctypes.data
            native.lincomb_rows_ptrs(
                out_base + nd * Ls,
                caddr(helper_nodes, pidx),
                uaddr(helper_nodes, pidx), ginv, c2, Ls)
        else:
            out[nd] = mt[ginv][Carr[helper_nodes, pidx]] ^ \
                mt[c2][U[helper_nodes, pidx]]
        return out.reshape(alpha * Ls)

    def repair_chunk_folded(self, lost: int,
                            helpers_list: list[dict[int, np.ndarray]],
                            L: int) -> list[np.ndarray]:
        """Folded MSR repair: many concurrent repairs of the SAME lost
        chunk (a recovery storm rebuilding one downed OSD's shard
        across objects) fold into ONE repair pass — each op's (P, Ls)
        helper slices become length-axis segments of a (P, n*Ls) plane
        array, the column solve's parity-check matmul runs once over
        the whole fold, and the per-op chunks carve back out.  Byte-
        identical to per-op repair_chunk (the plane math never crosses
        the Ls axis)."""
        n = len(helpers_list)
        if n == 1:
            return [self.repair_chunk(lost, helpers_list[0], L)]
        P = len(self.repair_planes(lost))
        Ls = L // self.alpha
        folded: dict[int, np.ndarray] = {}
        for h in helpers_list[0]:
            folded[h] = np.ascontiguousarray(np.stack(
                [np.asarray(hl[h], dtype=np.uint8).reshape(P, Ls)
                 for hl in helpers_list], axis=1)).reshape(P, n * Ls)
        flat = self.repair_chunk(lost, folded, n * L)
        out = flat.reshape(self.alpha, n, Ls).transpose(
            1, 0, 2).reshape(n, L)
        return [out[i] for i in range(n)]
