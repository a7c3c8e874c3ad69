"""CRC32C on the card: checksums of fixed-length chunks, computed right
after the parity they ride with (the Checksummer-on-the-batch north star;
ref src/common/Checksummer.h:13 crc32c, BlueStore per-blob csum
src/os/bluestore/BlueStore.cc:6080-6086).

The counterpart of the JAX package's ``ceph_tpu/ops/checksum.py``.  The
host half (the reference CRC, the GF(2) operator algebra, the zero
extension of a stored digest, CrcPlan's constants) is a copy of it.

CRC32C is GF(2)-linear in the message for the raw (init 0, no final xor)
variant: crc(A xor B) = crc(A) xor crc(B), and appending n zero bytes
multiplies the state by a fixed 32x32 GF(2) matrix M^n (zlib's
crc32_combine math).  Two device forms follow from that:

- the plain version (``CrcPlan.device_fn`` on a CPU tensor), the JAX
  package's graph op by op: a leaf map of 32 masked constants per word,
  then a balanced tree whose level l merges blocks of 4 * 2^l bytes with
  M^(4 * 2^l), on ``int32`` views (CPU torch has no shifts on uint32;
  an arithmetic shift then ``& 1`` gives the same bit);
- G1, the CUDA kernel ``crc32c_chunks`` (csrc/crc32c.cu, wrapper
  ``crc32c_chunks``): the words of a run as GF(2) products on the tensor
  cores (binary ``mma.sync`` at ``CRC_GEOMETRY``), Horner steps between
  runs as one more product, and the partials shifted into place by
  operators the host builds here (``kernel_split``, ``kernel_tables``)
  in the layout of the lanes' registers.

Both give the standard CRC32C; ``device_fn`` takes the kernel for a CUDA
tensor and the plain version for a CPU one, and never the other way.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

_POLY = 0x82F63B78  # Castagnoli, reflected


# ------------------------------------------------------------ host math
def _crc_table() -> np.ndarray:
    tab = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        tab[i] = c
    return tab


_TAB = _crc_table()


def crc32c_ref(data: bytes, crc: int = 0) -> int:
    """Reference CRC32C (matches ops.native.crc32c)."""
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ int(_TAB[(c ^ b) & 0xFF])
    return (c ^ 0xFFFFFFFF) & 0xFFFFFFFF


def _raw(data: bytes) -> int:
    """Init-0, no-final-xor crc — the LINEAR functional."""
    c = 0
    for b in data:
        c = (c >> 8) ^ int(_TAB[(c ^ b) & 0xFF])
    return c & 0xFFFFFFFF


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Product of 32x32 GF(2) matrices, each stored as 32 uint32
    column-masks (zlib gf2_matrix_square convention: row i of the
    operator is a[i], applying to vector v = xor of a[i] for set bits
    of v)."""
    out = np.zeros(32, dtype=np.uint64)
    for i in range(32):
        v = int(b[i])
        acc = 0
        for j in range(32):
            if v >> j & 1:
                acc ^= int(a[j])
        out[i] = acc
    return out


def _zero_operator(nbytes: int) -> np.ndarray:
    """M^{nbytes}: the matrix appending nbytes zero bytes applies to a
    raw crc state (zlib crc32_combine's op, built by squaring)."""
    # one-zero-BIT operator on the reflected crc state
    odd = np.zeros(32, dtype=np.uint64)
    odd[0] = _POLY
    for i in range(1, 32):
        odd[i] = 1 << (i - 1)
    even = _gf2_matmul(odd, odd)
    op4 = _gf2_matmul(even, even)      # 4 bits
    op8 = _gf2_matmul(op4, op4)        # one byte
    out = np.zeros(32, dtype=np.uint64)
    for i in range(32):
        out[i] = 1 << i                # identity
    cur = op8
    n = nbytes
    while n:
        if n & 1:
            out = _gf2_matmul(cur, out)
        cur = _gf2_matmul(cur, cur)
        n >>= 1
    return out


#: M^{2^j} ladder (j-th entry appends 2^j zero bytes), built once by
#: repeated squaring; 48 rungs cover pads past 256 TiB
_POW2_ZERO_OPS: list[np.ndarray] = []
_POW2_LOCK = threading.Lock()


def _pow2_zero_ops() -> list[np.ndarray]:
    with _POW2_LOCK:
        if not _POW2_ZERO_OPS:
            ops = [_zero_operator(1)]
            for _ in range(47):
                ops.append(_gf2_matmul(ops[-1], ops[-1]))
            _POW2_ZERO_OPS.extend(ops)
        return _POW2_ZERO_OPS


def crc32c_extend_zeros(crc: int, nzeros: int) -> int:
    """Standard CRC32C of `data || 0^nzeros` given crc32c(data).

    Appending zero bytes injects no message bits, so the raw state
    evolves purely linearly: raw' = M^nzeros · raw.  Converting the
    standard crc to raw (xor 0xFFFFFFFF twice around the operator)
    gives the folded-scrub identity — a stored whole-object digest can
    be re-expressed as the digest of the object padded to any bucket
    length without touching the bytes.  Per call: popcount(nzeros)
    matrix-vector products through the shared pow2 operator ladder."""
    v = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    if nzeros > 0:
        ops = _pow2_zero_ops()
        j = 0
        while nzeros:
            if nzeros & 1:
                op, acc = ops[j], 0
                for b in range(32):
                    if v >> b & 1:
                        acc ^= int(op[b])
                v = acc
            nzeros >>= 1
            j += 1
    return (v ^ 0xFFFFFFFF) & 0xFFFFFFFF


def _apply(op: np.ndarray, v) -> np.ndarray:
    """``op`` (32 columns) applied to every element of ``v`` — the
    vectorized matrix-vector product of _gf2_matmul, as uint64."""
    v = np.asarray(v, dtype=np.uint64)
    op = np.asarray(op, dtype=np.uint64)
    acc = np.zeros_like(v)
    for j in range(32):
        acc ^= np.where((v >> np.uint64(j)) & np.uint64(1), op[j],
                        np.uint64(0))
    return acc


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a · b by columns (the same product as _gf2_matmul(a, b))."""
    return _apply(a, b)


def _signed(v: int) -> int:
    """A uint32 constant as the int32 of the same bits."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


@functools.lru_cache(maxsize=64)
def _final_xor(nbytes: int) -> int:
    """The affine constant of the standard CRC32C of an ``nbytes``-byte
    message.  Raw crc is linear; the standard crc adds the init/final
    xor.  Processing data from init state I gives M^n·I ^ raw(data), so
    crc_std(data) = raw(data) ^ M^n·0xFFFFFFFF ^ 0xFFFFFFFF."""
    op_n = _zero_operator(nbytes)
    init_evolved = 0
    for j in range(32):
        init_evolved ^= int(op_n[j])  # apply to the all-ones state
    return (init_evolved ^ 0xFFFFFFFF) & 0xFFFFFFFF


class CrcPlan:
    """Precomputed constants for CRC32C over fixed-length chunks
    (nbytes = n_words * 4; the tree pads the word count up to a power of
    two with a zero prefix)."""

    def __init__(self, nbytes: int):
        if nbytes % 4 or nbytes < 4:
            raise ValueError("chunk length must be a multiple of 4")
        n_words = nbytes // 4
        self.nbytes = nbytes
        self.n_words = n_words
        # pad the word count up to a power of two WITH A ZERO PREFIX:
        # the raw (init-0) crc of leading zeros is zero and contributes
        # nothing through the combine, so raw(0^p || data) == raw(data)
        # — arbitrary chunk lengths ride the same balanced tree
        p = 1
        while p < n_words:
            p *= 2
        self.padded_words = p
        # leaf: raw crc of a single little-endian word, bit-decomposed
        self.leaf_bits = np.array(
            [_raw(int(1 << j).to_bytes(4, "little")) for j in range(32)],
            dtype=np.uint32)
        # per-level combine operator: level l merges blocks of 4*2^l
        # bytes, so the left half shifts by that many zero bytes; each
        # level's operator is the square of the one below
        self.level_ops = []
        blk, op = 4, None
        while blk < 4 * p:
            op = _zero_operator(blk) if op is None else _compose(op, op)
            self.level_ops.append(op.astype(np.uint32))
            blk *= 2
        # affine fix-up: one constant, every tree stage stays linear
        self.final_xor = np.uint32(_final_xor(nbytes))

    # ------------------------------------------------------ device form
    def device_fn(self):
        """fn: lanes (..., n_words) int32/uint32 tensor (little-endian
        words of each chunk) -> (...,) uint32 tensor, the standard
        CRC32C per chunk, on the lanes' device: the G1 kernel on a CUDA
        tensor, the plain version on a CPU one."""

        def fn(lanes: torch.Tensor) -> torch.Tensor:
            if lanes.shape[-1] != self.n_words:
                raise ValueError(f"want (..., {self.n_words}) words, got "
                                 f"{tuple(lanes.shape)}")
            lead = lanes.shape[:-1]
            flat = lanes.reshape(-1, self.n_words)
            return crc32c_chunks(flat, self).reshape(lead)

        return fn

    def plain(self, lanes: torch.Tensor) -> torch.Tensor:
        """The plain version: (Q, n_words) int32 -> (Q,) int32, the JAX
        package's leaf map and tree op by op."""
        from . import ec_kernels

        ec_kernels._count("plain")
        x = lanes.view(torch.int32)
        pad = self.padded_words - self.n_words
        if pad:
            x = torch.cat([torch.zeros(x.shape[:-1] + (pad,),
                                       dtype=torch.int32, device=x.device),
                           x], dim=-1)
        cur = _plain_apply([_signed(c) for c in self.leaf_bits], x)
        for op in self.level_ops:
            cur = (_plain_apply([_signed(c) for c in op], cur[..., 0::2])
                   ^ cur[..., 1::2])
        return cur[..., 0] ^ _signed(self.final_xor)

    # ------------------------------------------------------- CPU oracle
    def reference(self, chunk: bytes) -> int:
        return crc32c_ref(chunk)


def _plain_apply(cols: list[int], v: torch.Tensor) -> torch.Tensor:
    """XOR over bits j of v of cols[j] (int32 constants), elementwise."""
    acc = torch.zeros_like(v)
    for j, c in enumerate(cols):
        acc ^= ((v >> j) & 1) * c
    return acc


@functools.lru_cache(maxsize=64)
def crc_plan(nbytes: int) -> CrcPlan:
    """The CrcPlan of a chunk length, built once per length."""
    return CrcPlan(nbytes)


# ---------------------------------------------------------------------------
# G1: the host half of the CUDA kernel crc32c_chunks
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CrcGeometry:
    """What one build of crc32c_chunks computes with (the template
    arguments of csrc/crc32c.cu): binary (``b1``, m16n8k256 and.popc) or
    int8 (m16n8k32) tensor-core products, ``words`` words a lane loads at
    once (2 or 4), ``loads`` loads a lane makes a Horner step, ``warps``
    warps a block, and ``per_lane`` words a lane takes a segment."""

    b1: bool
    words: int
    loads: int
    warps: int
    per_lane: int

    @property
    def iters(self) -> int:
        """Horner steps a segment, at most."""
        return self.per_lane // (self.words * self.loads)

    @property
    def steps(self) -> int:
        """Data k-steps a Horner step."""
        return self.loads if self.b1 else self.loads * self.words * 2

    @property
    def step_words(self) -> int:
        """Words a block takes a Horner step."""
        return 32 * self.warps * self.words * self.loads

    @property
    def run(self) -> int:
        """Words of one mma row a Horner step (R)."""
        return 2 * self.words * self.loads


#: the setting the library launches (the template arguments of the C
#: entry crc32c_chunks in csrc/crc32c.cu)
CRC_GEOMETRY = CrcGeometry(b1=True, words=4, loads=1, warps=8, per_lane=32)


def kernel_split(n_words: int, geo: CrcGeometry = CRC_GEOMETRY
                 ) -> tuple[int, int, int]:
    """(iters, segs, pad) of crc32c_chunks for chunks of ``n_words``
    words: a segment is ``iters`` Horner steps of ``geo.step_words``
    words (``geo.iters``, fewer only when one segment holds the whole
    chunk), and ``pad`` zero words before the chunk make it ``segs``
    whole segments."""
    if n_words < 1:
        raise ValueError("a chunk has at least one word")
    iters = min(geo.iters, -(-n_words // geo.step_words))
    seg = iters * geo.step_words
    segs = -(-n_words // seg)
    return iters, segs, segs * seg - n_words


@dataclass(frozen=True)
class KernelTables:
    """What the crc32c_chunks wrapper uploads, as uint32 arrays, in the
    registers of the lanes that hold them (lane l = 4 g + t):

    ``ops`` (steps, 4, 2, 32): B fragment register r of n-tile nt of the
    data k-steps, the operator A of one mma row;
    ``shift`` (4, 2, 32): the B fragments of the state k-step,
    M^(4 step_words);
    ``fin`` (warps, 16, 32): column of the state bit at A-fragment
    position kappa of row r's final operator, warp by warp;
    ``ladder`` (32, 32): rung j is M^(4 segment words 2^j) by columns."""

    ops: np.ndarray
    shift: np.ndarray
    fin: np.ndarray
    ladder: np.ndarray


@functools.lru_cache(maxsize=4096)
def _shift_cols(nbytes: int) -> np.ndarray:
    """M^nbytes by columns as uint64, a product of the pow2 ladder."""
    ops = _pow2_zero_ops()
    out = np.array([1 << b for b in range(32)], dtype=np.uint64)
    j = 0
    while nbytes:
        if nbytes & 1:
            out = _apply(ops[j], out)
        nbytes >>= 1
        j += 1
    return out


def _bit(cols: np.ndarray, out_bit, in_bit) -> np.ndarray:
    """Entry (out_bit, in_bit) of operators given by columns: cols[...,
    in_bit] >> out_bit & 1, broadcast."""
    return (np.take_along_axis(cols, np.asarray(in_bit)[..., None], -1)[..., 0]
            >> np.asarray(out_bit, dtype=np.uint64)) & np.uint64(1)


_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3
#: output bit of column n of n-tile nt, and the state bit packed into
#: A-fragment position kappa (csrc/crc32c.cu low_bytes): kappa = 16 r + 4 t
#: + e holds C(n-tile 2 r + e // 2, column 2 t + e % 2)
_KAPPA = np.arange(32)
_KAPPA_BIT = (8 * (2 * (_KAPPA >> 4) + ((_KAPPA & 3) >> 1))
              + 2 * ((_KAPPA >> 2) & 3) + (_KAPPA & 1))


def _bytes_word(vals: np.ndarray) -> np.ndarray:
    """(..., 4) 0/1 values -> (...,) uint32, value e in byte e."""
    return (vals.astype(np.uint64)
            << (8 * np.arange(4, dtype=np.uint64))).sum(-1).astype(np.uint32)


def _data_exponent(geo: CrcGeometry, p, t, v):
    """Words from the word of load p, lane-in-quad t, pair v to one past
    its row's last word: the power (in words) of M^4 A applies to it."""
    V, Lp = geo.words, geo.loads
    return 32 * V * (Lp - 1 - p) + 4 * V - 1 - V * t - 2 * v


@functools.lru_cache(maxsize=64)
def kernel_tables(iters: int, geo: CrcGeometry = CRC_GEOMETRY
                  ) -> KernelTables:
    """The tables of crc32c_chunks at ``geo`` for segments of ``iters``
    Horner steps."""
    V, Lp, NW = geo.words, geo.loads, geo.warps
    nt = np.arange(4)[:, None, None]
    reg = np.arange(2)[None, :, None]
    out_bit = 8 * nt + _G[None, None, :]            # (4, 1, 32)
    e = np.arange(4)
    ops = np.zeros((geo.steps, 4, 2, 32), dtype=np.uint32)
    for p in range(Lp):
        if geo.b1:
            # register r of lane t' holds word (t', v = r) of the row;
            # bit beta of it pairs with bit beta of the data register
            expo = _data_exponent(geo, p, _T[None, None, :], reg)
            cols = np.stack([_shift_cols(4 * int(x)) for x in
                             expo.reshape(-1)]).reshape(1, 2, 32, 32)
            beta = np.arange(32, dtype=np.uint64)
            rows = (cols[..., None, :] >> out_bit[..., None, None]
                    .astype(np.uint64)) & np.uint64(1)  # (4,2,32,1,32)
            ops[p] = (rows[..., 0, :] << beta).sum(-1).astype(np.uint32)
            continue
        for v in range(V // 2):
            expo = _data_exponent(geo, p, _T, v)     # (32,)
            cols = np.stack([_shift_cols(4 * int(x)) for x in expo])
            for j in range(4):
                s = (p * (V // 2) + v) * 4 + j
                # byte e of register r: input bit j + 4 r + 8 e
                in_bit = j + 4 * reg[..., None] + 8 * e   # (1, 2, 1, 4)
                vals = _bit(np.broadcast_to(cols[None, None, :, None, :],
                                            (4, 2, 32, 4, 32)),
                            out_bit[..., None], np.broadcast_to(
                                in_bit, (4, 2, 32, 4)))
                ops[s] = _bytes_word(vals)
    # the state k-step: byte e of register r of lane (g', t') pairs with
    # kappa = 16 r + 4 t' + e
    cols = _shift_cols(4 * geo.step_words)
    kappa = 16 * reg[..., None] + 4 * _T[None, None, :, None] + e  # (1,2,32,4)
    vals = _bit(np.broadcast_to(cols, (4, 2, 32, 4, 32)), out_bit[..., None],
                np.broadcast_to(_KAPPA_BIT[kappa], (4, 2, 32, 4)))
    shift = _bytes_word(vals)
    # the final operators: row r = g + 8 h of warp w ends this far (in
    # words) before the segment's end, less one
    w = np.arange(NW)[:, None]
    r = np.arange(16)[None, :]
    expo = (32 * V * Lp * (NW - 1 - w) + 28 * V + 1 - 4 * V * (r & 7)
            - (r >> 3))
    fin = np.stack([_shift_cols(4 * int(x)) for x in expo.reshape(-1)]
                   )[:, _KAPPA_BIT].reshape(NW, 16, 32).astype(np.uint32)
    ladder = [_shift_cols(4 * iters * geo.step_words)]
    for _ in range(31):
        ladder.append(_compose(ladder[-1], ladder[-1]))
    return KernelTables(ops=ops, shift=shift, fin=fin,
                        ladder=np.stack(ladder).astype(np.uint32))


_DEV_TABLES: dict[tuple, tuple[torch.Tensor, ...]] = {}
_DEV_LOCK = threading.Lock()


def device_tables(device: torch.device, iters: int,
                  geo: CrcGeometry = CRC_GEOMETRY):
    """kernel_tables(iters, geo) as int32 tensors on ``device`` (ops,
    shift, fin, ladder), uploaded once per device, length and setting,
    landed before any stream reads them."""
    from ..utils import staging

    key = (device, iters, geo)
    with _DEV_LOCK:
        hit = _DEV_TABLES.get(key)
    if hit is None:
        t = kernel_tables(iters, geo)
        hit = staging.upload_tables(
            [np.ascontiguousarray(a).view(np.int32)
             for a in (t.ops, t.shift, t.fin, t.ladder)], device)
        with _DEV_LOCK:
            hit = _DEV_TABLES.setdefault(key, hit)
    return hit


def crc32c_chunks(words: torch.Tensor, plan: CrcPlan) -> torch.Tensor:
    """G1 wrapper: (Q, n_words) 32-bit words (each row one chunk of
    ``plan.nbytes`` bytes, little-endian words) -> (Q,) uint32 standard
    CRC32C.

    On a CPU tensor it runs the plain version.  On a CUDA tensor it
    launches ``crc32c_chunks`` on the current stream and needs
    contiguous, 4-byte aligned words; anything else raises."""
    if words.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"crc32c_chunks: want int32/uint32 words, got "
                        f"{words.dtype}")
    if words.ndim != 2 or words.shape[1] != plan.n_words:
        raise ValueError(f"crc32c_chunks: want (Q, {plan.n_words}) words, "
                         f"got {tuple(words.shape)}")
    if words.device.type == "cpu":
        return plan.plain(words).view(torch.uint32)
    if words.device.type != "cuda":
        raise ValueError(f"crc32c_chunks: unsupported device "
                         f"{words.device}")
    if not words.is_contiguous() or words.data_ptr() % 4:
        raise ValueError("crc32c_chunks: want contiguous, 4-byte aligned "
                         "words")
    from . import cuda_lib, ec_kernels

    iters, segs, pad = kernel_split(plan.n_words)
    ops, shift, fin, ladder = device_tables(words.device, iters)
    q = words.shape[0]
    y = torch.empty((q,), dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = cuda_lib.lib().crc32c_chunks(
            words.data_ptr(), y.data_ptr(), ops.data_ptr(), shift.data_ptr(),
            fin.data_ptr(), ladder.data_ptr(), q, plan.n_words, iters, segs,
            pad, int(plan.final_xor), stream)
    cuda_lib.check(err, "crc32c_chunks launch")
    ec_kernels._count("crc32c_chunks")
    return y.view(torch.uint32)


def chunk_csums(rows: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(n, batch * nbytes) uint8 tensor -> (n, batch) uint32: the
    standard CRC32C of every ``nbytes``-byte chunk of every row, in one
    G1 launch (or its plain version on the CPU)."""
    n, total = rows.shape
    if total % nbytes:
        raise ValueError(f"rows of {total} bytes are not whole chunks of "
                         f"{nbytes}")
    words = rows.contiguous().view(torch.int32).reshape(-1, nbytes // 4)
    return crc32c_chunks(words, crc_plan(nbytes)).reshape(
        n, total // nbytes)


def row_csums(rows: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 tensor -> (n,) uint32: the standard CRC32C of every
    row, for any length L, in one G1 launch (or its plain version on the
    CPU).  A length that is not a multiple of 4 is made one by a zero
    prefix of p bytes — raw(0^p || row) == raw(row) — and the affine
    constant of L + p is swapped for that of L."""
    n, L = rows.shape
    if L == 0:
        return torch.zeros((n,), dtype=torch.int32,
                           device=rows.device).view(torch.uint32)
    p = -L % 4
    if p:
        rows = F.pad(rows, (p, 0))
    y = chunk_csums(rows, L + p).reshape(n)
    if p:
        fix = _signed(_final_xor(L + p) ^ _final_xor(L))
        y = (y.view(torch.int32) ^ fix).view(torch.uint32)
    return y
