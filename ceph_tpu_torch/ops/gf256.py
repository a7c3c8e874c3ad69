"""GF(2^8) arithmetic and erasure-code generator matrices (numpy reference).

This is the portable reference implementation of the Galois-field math that
the reference system obtains from the jerasure/gf-complete/ISA-L submodules
(absent from the reference tree — see SURVEY.md preamble).  It is the
byte-exactness oracle for both the native C++ kernels (native/gf256.cc) and
the CUDA region kernels (ceph_tpu_torch/csrc/gf_region.cu, wrapped by
ceph_tpu_torch/ops/ec_kernels.py).

Field: GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11d), the
polynomial used by gf-complete (w=8) and ISA-L — i.e. the field the reference
plugins compute in (ref: src/erasure-code/jerasure/ErasureCodeJerasure.cc,
src/erasure-code/isa/ErasureCodeIsa.cc call into those libs).

Matrix constructions:
- ``vandermonde_matrix``: systematic Reed-Solomon coding matrix derived from
  an extended Vandermonde matrix, the construction behind jerasure's
  ``reed_sol_van`` technique (ref: ErasureCodeJerasure.h:135-173 selects it;
  the math lived in the absent jerasure submodule's reed_sol.c).
- ``cauchy_matrix``: Cauchy coding matrix 1/(x_i + y_j), the construction
  behind jerasure's ``cauchy_orig``/``cauchy_good`` and ISA-L's cauchy (ref:
  ErasureCodeIsa.cc:598-658 chooses Vandermonde vs Cauchy).
- ``bitmatrix``: GF(2) bit-matrix expansion of a GF(2^8) matrix — the Cauchy
  Reed-Solomon trick jerasure uses for XOR-schedule encoding, and the exact
  formulation the region kernels use (a GF(2^8) matrix multiply becomes a
  GF(2) matmul that maps onto the MXU / VPU XOR pipeline).
"""

from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, primitive over GF(2)
GF_ORDER = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables for the multiplicative group generated by x (=2)."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    # replicate so exp[(loga + logb)] never needs a mod
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


@functools.lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """Full 256x256 multiplication table, uint8. mul_table()[a, b] = a*b."""
    a = np.arange(256, dtype=np.int32)
    la = GF_LOG[a][:, None]
    lb = GF_LOG[a][None, :]
    t = GF_EXP[la + lb].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


@functools.lru_cache(maxsize=1)
def inv_table() -> np.ndarray:
    """Multiplicative inverse table; inv_table()[0] = 0 (never used)."""
    inv = np.zeros(256, dtype=np.uint8)
    inv[1:] = GF_EXP[255 - GF_LOG[np.arange(1, 256)]]
    return inv


def gf_mul(a, b):
    """Elementwise GF(2^8) product of arrays/scalars (uint8)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return mul_table()[a, b]


def gf_inv(a):
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return inv_table()[a]


def gf_div(a, b):
    return gf_mul(a, gf_inv(b))


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


def gf_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product: (r,k) x (k,c) -> (r,c) with XOR accumulation."""
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    assert A.ndim == 2 and B.ndim == 2 and A.shape[1] == B.shape[0]
    # products[i,j,c] = A[i,j] * B[j,c]; XOR-reduce over j
    prods = mul_table()[A[:, :, None], B[None, :, :]]
    return np.bitwise_xor.reduce(prods, axis=1)


def gf_mat_inv(A: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8). Raises if singular."""
    A = np.array(A, dtype=np.uint8)
    n = A.shape[0]
    assert A.shape == (n, n)
    aug = np.concatenate([A, np.eye(n, dtype=np.uint8)], axis=1)
    mt = mul_table()
    for col in range(n):
        piv = col + int(np.argmax(aug[col:, col] != 0))
        if aug[piv, col] == 0:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        inv_p = inv_table()[aug[col, col]]
        aug[col] = mt[inv_p, aug[col]]
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] ^= mt[aug[row, col], aug[col]]
    return aug[:, n:].copy()


# ---------------------------------------------------------------------------
# Generator matrices
# ---------------------------------------------------------------------------

def extended_vandermonde_matrix(rows: int, cols: int) -> np.ndarray:
    """Extended Vandermonde matrix over GF(2^8); any `cols` rows invertible.

    Same shape as jerasure's reed_sol_extended_vandermonde_matrix: row 0 is
    e_0, the last row is e_{cols-1}, and interior row i is [i^0, i^1, ...].
    """
    if rows > GF_ORDER + 1 or cols > rows:
        raise ValueError(f"no extended Vandermonde matrix ({rows},{cols})")
    V = np.zeros((rows, cols), dtype=np.uint8)
    V[0, 0] = 1
    if rows == 1:
        return V
    V[rows - 1, cols - 1] = 1
    for i in range(1, rows - 1):
        acc = 1
        for j in range(cols):
            V[i, j] = acc
            acc = int(gf_mul(acc, i))
    return V


def vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """Systematic RS coding matrix (m,k): C = V_bottom @ inv(V_top).

    V is the (k+m, k) extended Vandermonde matrix; the distribution matrix
    V @ inv(V_top) has an identity top (systematic) and remains MDS because
    every k x k submatrix of V is invertible.  Each coding row is then
    normalised by its first element so the first data chunk enters parity
    unscaled (jerasure's reed_sol_van likewise derives a systematic matrix
    whose first coding row is all ones; row scaling preserves MDS).
    """
    V = extended_vandermonde_matrix(k + m, k)
    top_inv = gf_mat_inv(V[:k])
    C = gf_matmul(V[k:], top_inv)
    for i in range(m):
        if C[i, 0] not in (0, 1):
            C[i] = gf_mul(inv_table()[C[i, 0]], C[i])
    return C


def cauchy_matrix(k: int, m: int) -> np.ndarray:
    """Cauchy coding matrix (m,k): C[i][j] = 1/(i XOR (m+j)).

    The X = {0..m-1}, Y = {m..m+k-1} point sets of jerasure's
    cauchy_original_coding_matrix (absent submodule's cauchy.c; selected by
    technique=cauchy_orig, ref ErasureCodePluginJerasure.cc:40-66).
    Requires k + m <= 256 so the point sets are disjoint.
    """
    if k + m > GF_ORDER:
        raise ValueError("cauchy matrix needs k+m <= 256")
    i = np.arange(m, dtype=np.int32)[:, None]
    j = np.arange(k, dtype=np.int32)[None, :]
    return inv_table()[(i ^ (m + j)).astype(np.uint8)]


def cauchy_good_matrix(k: int, m: int) -> np.ndarray:
    """Cauchy matrix optimised to minimise bit-matrix density.

    Mirrors the intent of jerasure's cauchy_good technique
    (cauchy.c:improve_coding_matrix in the absent submodule): divide each
    column by its first-row element (making row 0 all ones), then rescale
    each later row by the candidate factor that minimises the total popcount
    of its GF(2) bit-matrix expansion — fewer ones = fewer XORs in the
    schedule.  Deterministic; preserves MDS (row/column scaling).
    """
    C = cauchy_matrix(k, m)
    # column scale: make row 0 all ones
    C = gf_mul(C, inv_table()[C[0]][None, :])
    for i in range(1, m):
        best_f, best_cost = 1, None
        for f in range(1, 256):
            row = gf_mul(np.uint8(f), C[i])
            cost = int(bitmatrix(row[None, :]).sum())  # ones == XOR count
            if best_cost is None or cost < best_cost:
                best_f, best_cost = f, cost
        C[i] = gf_mul(np.uint8(best_f), C[i])
    return C


# ---------------------------------------------------------------------------
# Bit-matrix (GF(2)) expansion — the kernels' formulation
# ---------------------------------------------------------------------------

def bitmatrix(M: np.ndarray) -> np.ndarray:
    """Expand a (r,c) GF(2^8) matrix into an (8r,8c) GF(2) bit-matrix.

    Multiplication by a constant g in GF(2^8) is GF(2)-linear on the 8 bits
    of the operand; its 8x8 bit-matrix has column s = bits of g * x^s.  With
    bytes viewed as LSB-first bit vectors, for any byte b:

        bits(g * b)[r] = XOR_s B[r, s] & bits(b)[s]

    so a GF(2^8) matrix multiply of chunk data becomes a GF(2) matmul of
    bit-planes — which is what the region kernels compute (an XOR schedule over
    bit-planes), exactly the Cauchy
    Reed-Solomon bit-matrix trick of jerasure's *_bitmatrix paths.
    """
    M = np.asarray(M, dtype=np.uint8)
    r, c = M.shape
    # cols[s] of the 8x8 block for entry g: bits of g * (1<<s)
    powers = np.uint8(1) << np.arange(8, dtype=np.uint8)          # x^s
    prod = mul_table()[M[:, :, None], powers[None, None, :]]      # (r,c,8)
    # bit r of each product byte -> (r, c, 8 cols, 8 rowbits)
    bits = (prod[:, :, :, None] >> np.arange(8, dtype=np.uint8)) & 1
    # arrange into (8r, 8c): block (i,j) at [8i:8i+8, 8j:8j+8], entry [rb, s]
    B = bits.transpose(0, 3, 1, 2).reshape(8 * r, 8 * c)
    return B.astype(np.uint8)


def bytes_to_bitplanes(data: np.ndarray) -> np.ndarray:
    """(k, L) uint8 -> (8k, L) bit-planes, row 8j+s = bit s of shard j."""
    data = np.asarray(data, dtype=np.uint8)
    k, L = data.shape
    planes = (data[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1
    return planes.reshape(8 * k, L)


def bitplanes_to_bytes(planes: np.ndarray) -> np.ndarray:
    """(8m, L) bit-planes -> (m, L) uint8 bytes (inverse of the above)."""
    planes = np.asarray(planes, dtype=np.uint8)
    m8, L = planes.shape
    assert m8 % 8 == 0
    p = planes.reshape(m8 // 8, 8, L)
    return (p << np.arange(8, dtype=np.uint8)[None, :, None]).sum(
        axis=1, dtype=np.uint32).astype(np.uint8)


# ---------------------------------------------------------------------------
# Region encode/decode (numpy reference used by plugins & tests)
# ---------------------------------------------------------------------------

def encode_region(C: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Parity chunks from data chunks: (m,k) x (k,L) -> (m,L) over GF(2^8).

    The reference hot loop this models: ECUtil.cc:488-514 slicing into
    ec_impl->encode_chunks -> jerasure/isa matrix multiply over each chunk.
    """
    return gf_matmul(C, data)


def decode_matrix(C: np.ndarray, k: int, available: list[int]) -> np.ndarray:
    """Matrix mapping k surviving chunks -> the k data chunks.

    ``available`` lists >=k surviving chunk ids (data ids < k, parity ids
    >= k) in the order their chunks will be stacked; only the first k are
    used.  Rows are taken from the systematic distribution matrix [I; C]
    and inverted — the construction ECBackend's decode performs via the
    plugin's decode_chunks (ref ErasureCodeJerasure.cc:193-240 erasures
    path; ErasureCodeIsa.cc decode-table cache).
    """
    full = np.concatenate([np.eye(k, dtype=np.uint8), np.asarray(C, dtype=np.uint8)])
    rows = full[available[:k]]
    return gf_mat_inv(rows)
