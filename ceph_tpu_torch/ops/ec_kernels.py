"""GF(2^8) region kernels for the PyTorch port — the erasure-code hot path.

The counterpart of the JAX package's ``ceph_tpu/ops/ec_kernels.py``.  The
math is the same; the kernels are written by hand in CUDA C++ for Hopper
(``csrc/gf_region.cu``) and bound through ctypes (``ops/cuda_lib.py``).

Formulation
-----------
A GF(2^8) multiply by a *constant* c is GF(2)-linear on the bits of the
operand:  c*b = XOR_s bit_s(b) * (c * x^s).  Working on 32-bit lanes that
each hold 4 independent bytes of a chunk:

    y32 ^= ((x32 >> s) & 0x01010101) * byte(c * x^s)      for s in 0..7

— the shifted mask extracts bit s of each byte into its low bit-position,
and the integer multiply broadcasts the constant byte into every byte slot
with no carries.  Coefficient 0 contributes nothing and coefficient 1 is a
single XOR.

Kernel realizations (the names of the ``kernel=`` profile key, KERNELS):

- ``xla``    — the plain PyTorch version of the bit-term chain
  (gf_matmul_graph).  Viable only for CPU tensors: on the card the port
  runs hand-written kernels only.
- ``pallas`` — the nibble-table CUDA kernel ``gf_bitterm`` (wrapper
  gf_bitterm_lanes): each product a * b as lo_a[b & 15] ^ hi_a[b >> 4],
  looked up four bytes at a time by byte permutes in a per-matrix table
  (nibble_table); its plain version, the bit-term chain above, on a CPU
  tensor.
- ``bitxor`` — the bit-sliced CUDA kernel ``gf_bitxor`` (wrapper
  gf_bitxor_lanes): the product over GF(2) bit-planes, transposed in
  registers, with the rows of gf256.bitmatrix(M) as a CSR (bitxor_plan);
  its plain version (gf_bitxor_graph) runs the CSE'd XOR schedule of
  ops/xor_schedule on a CPU tensor, as the JAX body does.
- ``mxu``    — the GF(2) bit-matrix product on the binary tensor cores,
  the CUDA kernel ``gf_bitmm`` of ``csrc/gf_bitmm.cu`` (wrapper
  gf_bitmm_lanes, fragment table bitmm_plan): bitmatrix(M) (8r, 8c)
  times the data's bit-planes mod 2, 8c <= 256 as in the JAX package;
  its plain version (gf_matmul_mxu_graph) is a float32 dot of 0/1 planes
  on a CPU tensor.

ScheduledXor is the third op: B @ rows over GF(2) for the bit-matrix
codes, whose packet rows are planes already.  It launches the CUDA kernel
``gf_sched_xor`` (wrapper gf_sched_xor_lanes) over B lowered by
sched_xor_plan; its plain version runs B's CSE'd XOR schedule, as the
JAX body does.  In packet mode it takes the codec's (n, L) chunks as they
are and the kernel finds the packet rows by address.

Plain versions work on ``int32`` views of the lanes: CPU torch has no
shifts on ``uint32``.  An arithmetic right shift by s <= 7 followed by the
0x01010101 mask gives the same bits as the logical one, and int32
multiplies and left shifts wrap exactly like uint32 ones.

A wrapper takes its plain version only because the tensor it was given
lies on the CPU; on a CUDA tensor it launches its kernel or raises.
Launches are counted in LAUNCHES (``gf_bitterm``, ``gf_bitxor``,
``gf_bitmm``, ``gf_sched_xor``, the CRC32C kernel ``crc32c_chunks`` of
ops/checksum.py, and ``plain`` for every run of a plain version).
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import gf256
from .xor_schedule import XorSchedule, build_schedule

_MASK = 0x01010101  # low bit of each byte lane in a 32-bit lane

#: kernel realizations, the vocabulary of the ``kernel=`` profile key
KERNELS = ("xla", "pallas", "mxu", "bitxor")

#: launch counters: each wrapper adds one where it launches its kernel,
#: and every run of a plain version adds one to ``plain``
LAUNCHES = {"gf_bitterm": 0, "gf_bitxor": 0, "gf_bitmm": 0,
            "gf_sched_xor": 0, "crc32c_chunks": 0, "plain": 0}
_COUNT_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    with _COUNT_LOCK:
        return dict(LAUNCHES)


def kernel_supports(kernel: str, M: np.ndarray, shape=None, *,
                    device="cuda") -> bool:
    """Whether candidate ``kernel`` can run matrix ``M`` (optionally at
    input ``shape``) on ``device`` — the auto-selection viability guard:
    a False here means SKIP the candidate, never try-and-raise.

    - ``mxu`` needs 8c <= 256 everywhere (the JAX package's rule: one
      k-step of the binary product on the card);
    - ``xla`` is the plain version, viable only on the CPU;
    - on the CPU ``pallas``, ``bitxor`` and ``mxu`` run their plain
      versions;
    - on the card ``pallas`` needs its nibble table and coefficient
      flags, 33 bytes a coefficient, to fit a block's shared memory,
      ``bitxor`` needs the (8c + 1) bit-planes of a
      BITXOR_MIN_THREADS-thread block to fit it, and ``mxu`` its
      fragment table, bitmm_table_bytes.
    """
    if kernel not in KERNELS:
        return False
    M = np.asarray(M)
    if M.ndim != 2 or 0 in M.shape:
        return False
    if shape is not None and tuple(shape)[0] != M.shape[1]:
        return False
    if kernel == "mxu" and 8 * M.shape[1] > 256:
        return False
    device = torch.device(device)
    if device.type == "cpu":
        return True
    if device.type != "cuda" or kernel == "xla":
        return False
    from . import cuda_lib
    smem = cuda_lib.smem_optin(device)
    if kernel == "pallas":
        return M.shape[0] * M.shape[1] * 33 <= smem
    if kernel == "mxu":
        return bitmm_table_bytes(*M.shape) <= smem
    return (8 * M.shape[1] + 1) * 4 * BITXOR_MIN_THREADS <= smem


def _terms(M: np.ndarray) -> tuple[tuple[tuple[int, int, int], ...], ...]:
    """Static per-output-row term lists: row i -> ((j, s, v), ...) with
    v = M[i,j] * x^s != 0; a (j, -1, 0) entry marks a plain XOR (coef 1)."""
    M = np.asarray(M, dtype=np.uint8)
    rows = []
    for i in range(M.shape[0]):
        row: list[tuple[int, int, int]] = []
        for j in range(M.shape[1]):
            c = int(M[i, j])
            if c == 0:
                continue
            if c == 1:
                row.append((j, -1, 0))
                continue
            for s in range(8):
                v = int(gf256.gf_mul(c, 1 << s))
                if v:
                    row.append((j, s, v))
        rows.append(tuple(row))
    return tuple(rows)


def _accumulate_row(x, terms):
    """XOR-accumulate one output row from int32 lane rows x (c, n)."""
    acc = None
    for j, s, v in terms:
        xj = x[j]
        t = xj if s < 0 else ((xj >> s) & _MASK) * v
        acc = t if acc is None else acc ^ t
    if acc is None:
        return torch.zeros_like(x[0])
    return acc


def _rows_op(x, terms_all):
    """Plain version of K1: (c, n) int32 lanes -> (r, n) int32."""
    _count("plain")
    return torch.stack([_accumulate_row(x, t) for t in terms_all])


def nibble_table(M: np.ndarray) -> np.ndarray:
    """K1's per-matrix table: (r, c, 32) bytes, lo[n] = M[i,j] * n for
    n < 16, then hi[n] = M[i,j] * (n << 4), so that M[i,j] * b =
    lo[b & 15] ^ hi[b >> 4]."""
    M = np.asarray(M, dtype=np.uint8)
    n = np.arange(16, dtype=np.uint8)
    mul = gf256.mul_table()[M]  # (r, c, 256)
    return np.ascontiguousarray(
        np.concatenate([mul[..., n], mul[..., n << 4]], axis=2))


def _lanes_view(data_u8: torch.Tensor) -> torch.Tensor:
    """(c, L) uint8 -> (c, L // 4) int32 view (little-endian lanes)."""
    return data_u8.contiguous().view(torch.int32)


def _bytes_view(y32: torch.Tensor) -> torch.Tensor:
    return y32.contiguous().view(torch.uint8)


def _check_lanes(x32: torch.Tensor, rows: int, what: str) -> None:
    if x32.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"{what}: want int32/uint32 lanes, got {x32.dtype}")
    if x32.ndim != 2 or x32.shape[0] != rows:
        raise ValueError(f"{what}: want ({rows}, n4) lanes, got "
                         f"{tuple(x32.shape)}")


def _out_lanes(out, r: int, x32: torch.Tensor, what: str) -> torch.Tensor:
    """The (r, n4) int32 output of a kernel launch on x32's device: a new
    tensor, or the caller's ``out``, which must be contiguous and 16-byte
    aligned there (a kernel writes it whole)."""
    n4 = x32.shape[1]
    if out is None:
        return torch.empty((r, n4), dtype=torch.int32, device=x32.device)
    if (out.dtype != torch.int32 or tuple(out.shape) != (r, n4)
            or out.device != x32.device or not out.is_contiguous()
            or out.data_ptr() % 16):
        raise ValueError(f"{what}: out must be a contiguous, 16-byte "
                         f"aligned ({r}, {n4}) int32 tensor on {x32.device}")
    return out


def _into(y32: torch.Tensor, out) -> torch.Tensor:
    """A plain version's lanes, copied into ``out`` when one is given."""
    if out is None:
        return y32
    out.copy_(y32)
    return out


def gf_bitterm_lanes(x32: torch.Tensor, terms_all, table=None, *,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """K1 wrapper: (c, n4) 32-bit lanes -> (r, n4) int32 lanes.

    On a CPU tensor it runs the plain version over ``terms_all``
    (_terms).  On a CUDA tensor it launches ``gf_bitterm`` with
    ``table`` = (coef (r, c) uint8, tab (r, c, 32) uint8, the
    nibble_table) resident on the same device, and needs n4 % 4 == 0 and
    16-byte alignment.  ``out`` (r, n4) int32, when given, receives the
    lanes (_out_lanes)."""
    r = len(terms_all)
    if x32.device.type == "cpu":
        return _into(_rows_op(x32.view(torch.int32), terms_all), out)
    if x32.device.type != "cuda":
        raise ValueError(f"gf_bitterm: unsupported device {x32.device}")
    if table is None:
        raise ValueError("gf_bitterm: a CUDA tensor needs the device table")
    coef, tab = table
    c = coef.shape[1]
    _check_lanes(x32, c, "gf_bitterm")
    n4 = x32.shape[1]
    if (not x32.is_contiguous() or n4 % 4 or x32.data_ptr() % 16
            or coef.device != x32.device or tab.device != x32.device):
        raise ValueError("gf_bitterm: want contiguous, 16-byte aligned "
                         "lanes with n4 % 4 == 0 and tables on the "
                         "same device")
    from . import cuda_lib
    y32 = _out_lanes(out, r, x32, "gf_bitterm")
    with torch.cuda.device(x32.device):
        stream = torch.cuda.current_stream(x32.device).cuda_stream
        err = cuda_lib.lib().gf_bitterm(
            x32.data_ptr(), y32.data_ptr(), coef.data_ptr(),
            tab.data_ptr(), r, c, n4, stream)
    cuda_lib.check(err, "gf_bitterm launch")
    _count("gf_bitterm")
    return y32


# ---------------------------------------------------------------------------
# bitxor: XOR-scheduled GF(2) bitplanes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=128)
def _cached_schedule(key: bytes, shape: tuple[int, int]) -> XorSchedule:
    B = np.frombuffer(key, dtype=np.uint8).reshape(shape)
    return build_schedule(B)


def bitxor_schedule(M: np.ndarray) -> XorSchedule:
    """The CSE'd XOR schedule of a GF(2^8) matrix's bit-matrix
    expansion (gf256.bitmatrix), cached per matrix — schedule
    construction is CPU work done once, the launches replay it."""
    B = gf256.bitmatrix(np.asarray(M, dtype=np.uint8))
    return _cached_schedule(B.tobytes(), B.shape)


def _eval_schedule_nodes(sched: XorSchedule, nodes: list) -> list:
    """Run the intermediate op chain in place (inputs pre-filled)."""
    for dst, a, b in sched.ops:
        nodes[dst] = nodes[a] ^ nodes[b]
    return nodes


def _combine_terms(nodes: list, terms: tuple[int, ...]):
    acc = None
    for t in terms:
        acc = nodes[t] if acc is None else acc ^ nodes[t]
    return acc


def _bitxor_rows(x32, sched: XorSchedule):
    """Plain version of K2: (c, n4) int32 lanes -> (r, n4) via the
    scheduled GF(2) planes.

    Input plane 8j+s is bit s of every byte of row j, kept in the low
    bit of its byte lane (one shift+mask per USED plane); output byte
    row i packs its 8 scheduled planes back with shifts."""
    c = x32.shape[0]
    if sched.n_in != 8 * c:
        raise ValueError(f"schedule wants {sched.n_in // 8} rows, got {c}")
    _count("plain")
    nodes: list = [None] * (sched.n_in + len(sched.ops))
    for p in sched.used_inputs:
        xj = x32[p >> 3]
        s = p & 7
        if s:
            xj = xj >> s
        nodes[p] = xj & _MASK
    _eval_schedule_nodes(sched, nodes)
    rows = []
    for i in range(len(sched.outputs) // 8):
        acc = None
        for t in range(8):
            q = _combine_terms(nodes, sched.outputs[8 * i + t])
            if q is None:
                continue
            if t:
                q = q << t
            acc = q if acc is None else acc ^ q
        rows.append(acc if acc is not None else torch.zeros_like(x32[0]))
    return torch.stack(rows)


#: gf_bitxor's smallest block (csrc/gf_region.cu falls back to it); its
#: (8c + 1) planes of 4 bytes a thread must fit a block's shared memory
BITXOR_MIN_THREADS = 32


@dataclass(frozen=True)
class BitxorPlan:
    """A GF(2^8) matrix M (r, c) lowered for the gf_bitxor kernel: the rows
    of B = gf256.bitmatrix(M) (8r x 8c) as a CSR over bit-planes.

    The bit order is the kernel's transpose (``bitslice`` in
    csrc/gf_region.cu).  A thread takes the 32-byte column group made of
    the 16 bytes at uint4 lane g of a row and the 16 at lane g + n4 / 8,
    as 8 words (word k = bytes 4k..4k+3).  After the transpose, word s
    holds bit s of byte 4k + b at bit 8b + k: plane 8j + s of input row j,
    the column of B it multiplies.  Output plane 8i + t is bit t of output
    row i in the same order, so the kernel transposes it back with the same
    function.

    Output plane q is the XOR of the planes ``idx[ptr[q]:ptr[q + 1]]``:
    ``ptr`` is (8r + 1,) int32 in quads, ``idx`` (n_quads, 4) int32 plane
    numbers, each row of B padded to whole quads with plane 8c, which the
    kernel keeps zero."""

    ptr: np.ndarray
    idx: np.ndarray
    rows: int
    cols: int


@functools.lru_cache(maxsize=128)
def _cached_plan(key: bytes, shape: tuple[int, int]) -> BitxorPlan:
    M = np.frombuffer(key, dtype=np.uint8).reshape(shape)
    B = gf256.bitmatrix(M)
    r, c = shape
    ptr = [0]
    quads: list[int] = []
    for q in range(8 * r):
        ones = np.nonzero(B[q])[0].tolist()
        quads += ones + [8 * c] * (-len(ones) % 4)
        ptr.append(len(quads) // 4)
    return BitxorPlan(ptr=np.array(ptr, dtype=np.int32),
                      idx=np.array(quads, dtype=np.int32).reshape(-1, 4),
                      rows=r, cols=c)


def bitxor_plan(M: np.ndarray) -> BitxorPlan:
    """The gf_bitxor plan of matrix ``M``, cached per matrix."""
    M = np.ascontiguousarray(M, dtype=np.uint8)
    return _cached_plan(M.tobytes(), M.shape)


def gf_bitxor_lanes(x32: torch.Tensor, sched: XorSchedule, plan=None, *,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """K2 wrapper: (c, n4) 32-bit lanes -> (r, n4) int32 lanes.

    On a CPU tensor it runs the plain version of ``sched``.  On a CUDA
    tensor it launches ``gf_bitxor`` with ``plan`` = (ptr tensor, idx
    tensor, BitxorPlan), the tensors on the same device, and needs
    n4 % 8 == 0 and 16-byte alignment.  ``out`` (r, n4) int32, when
    given, receives the lanes (_out_lanes)."""
    if x32.device.type == "cpu":
        return _into(_bitxor_rows(x32.view(torch.int32), sched), out)
    if x32.device.type != "cuda":
        raise ValueError(f"gf_bitxor: unsupported device {x32.device}")
    if plan is None:
        raise ValueError("gf_bitxor: a CUDA tensor needs the device plan")
    ptr, idx, p = plan
    _check_lanes(x32, p.cols, "gf_bitxor")
    n4 = x32.shape[1]
    if (not x32.is_contiguous() or n4 % 8 or x32.data_ptr() % 16
            or ptr.device != x32.device or idx.device != x32.device):
        raise ValueError("gf_bitxor: want contiguous, 16-byte aligned "
                         "lanes with n4 % 8 == 0 and the plan on the "
                         "same device")
    from . import cuda_lib
    y32 = _out_lanes(out, p.rows, x32, "gf_bitxor")
    with torch.cuda.device(x32.device):
        stream = torch.cuda.current_stream(x32.device).cuda_stream
        err = cuda_lib.lib().gf_bitxor(
            x32.data_ptr(), y32.data_ptr(), ptr.data_ptr(), idx.data_ptr(),
            p.rows, p.cols, int(idx.shape[0]), n4, stream)
    cuda_lib.check(err, "gf_bitxor launch")
    _count("gf_bitxor")
    return y32


def gf_bitxor_graph(M: np.ndarray):
    """fn(data (c, L) uint8 tensor) -> (r, L) uint8 computing M @ data
    over GF(2^8) as the XOR-scheduled bitplane program (L % 4 == 0);
    the plain version of K2, on any device."""
    sched = bitxor_schedule(M)
    r, c = np.asarray(M).shape

    def fn(data_u8):
        if data_u8.shape[0] != c:
            raise ValueError(f"expected {c} rows, got {data_u8.shape[0]}")
        y32 = _bitxor_rows(_lanes_view(data_u8), sched)
        return _bytes_view(y32).reshape(r, -1)

    return fn


def gf_matmul_graph(M: np.ndarray):
    """fn(data (c, L) uint8 tensor) -> (r, L) uint8 computing M @ data
    over GF(2^8) as the plain bit-term chain (L % 4 == 0); the plain
    version of K1, on any device."""
    terms_all = _terms(M)
    r, c = np.asarray(M).shape

    def fn(data_u8):
        if data_u8.shape[0] != c:
            raise ValueError(f"expected {c} rows, got {data_u8.shape[0]}")
        y32 = _rows_op(_lanes_view(data_u8), terms_all)
        return _bytes_view(y32).reshape(r, -1)

    return fn


def gf_region_graph(M: np.ndarray, kernel: str = "xla"):
    """Plain byte-domain fn(data (c, L) u8) -> (r, L) u8 for a named
    kernel realization: ``bitxor`` is K2's plain version, ``mxu`` G4's,
    everything else K1's (the JAX package's rule: pallas/auto lower to
    the xla graph)."""
    if kernel == "bitxor":
        return gf_bitxor_graph(M)
    if kernel == "mxu":
        return gf_matmul_mxu_graph(M)
    return gf_matmul_graph(M)


# ---------------------------------------------------------------------------
# mxu: the GF(2) bit-matrix product on the binary tensor cores (G4)
# ---------------------------------------------------------------------------

#: bytes of gf_bitmm's fragment table for each group of 4 output rows:
#: 2 registers of 32 lanes for c <= 8 (one byte a bit pair), 8 above
BITMM_GROUP_BYTES = 256
BITMM_COLUMN_GROUP_BYTES = 1024
#: columns the plain version of G4 unpacks at a time: its float32 planes
#: take 32 c bytes a column, so this bounds them to 2 GiB at c = 32
_MXU_PLAIN_COLS = 1 << 21


def bitmm_table_bytes(r: int, c: int) -> int:
    """Bytes of gf_bitmm's fragment table for an r x c matrix, which a
    block stages in shared memory: ceil(r / 4) groups of 4 output rows."""
    per = BITMM_GROUP_BYTES if c <= 8 else BITMM_COLUMN_GROUP_BYTES
    return per * -(-r // 4)


@dataclass(frozen=True)
class BitmmPlan:
    """A GF(2^8) matrix M (r, c) lowered for the gf_bitmm kernel: the B
    fragments of mma.m16n8k256.b1 (csrc/gf2_mma.cuh) for each group G of
    output rows 4 G .. 4 G + 3, where B column n = 2 rho + v of the
    product for bit pair p is bitmatrix row 8 (4 G + rho) + 2 p + v.

    - c <= 8 (gf_bitmm_words): ``frag[G, h, 4 n + t]`` holds in its byte
      p the bits s of bitmatrix(M)[8 (4 G + rho) + 2 p + v,
      8 (4 h + t) + s]; the kernel moves byte p to byte u for the product
      of byte column u (a block-diagonal B: its A words hold input row
      4 h + t at byte u).  (ceil(r / 4), 2, 32) uint32.
    - c > 8 (gf_bitmm_columns): ``frag[G, p, h, 4 n + t]``, bit 8 e + s
      of it bitmatrix(M)[8 (4 G + rho) + 2 p + v, 8 (16 h + 4 t + e) + s]
      (its A registers hold input row 16 h + 4 t + e at byte e of one
      column).  (ceil(r / 4), 4, 2, 32) uint32.

    Zero past r rows and c columns."""

    frag: np.ndarray
    rows: int
    cols: int


def _bitmm_rows(M: np.ndarray, width: int) -> np.ndarray:
    """bitmatrix(M) zero-padded to whole groups of 4 output rows (32 bit
    rows) and ``width`` bit columns, uint64."""
    r, c = M.shape
    B = np.zeros((32 * -(-r // 4), width), dtype=np.uint64)
    B[:8 * r, :8 * c] = gf256.bitmatrix(M)
    return B


def _bitmm_word_frag(M: np.ndarray) -> np.ndarray:
    """gf_bitmm_words' table of M (c <= 8): see BitmmPlan."""
    groups = -(-M.shape[0] // 4)
    B = _bitmm_rows(M, 64)
    # [G, rho, p, v, h, t, s] -> byte [G, rho, p, v, h, t]
    byte = (B.reshape(groups, 4, 4, 2, 2, 4, 8)
            << np.arange(8, dtype=np.uint64)).sum(-1)
    word = (byte << (8 * np.arange(4, dtype=np.uint64))[:, None, None, None]
            ).sum(2)  # [G, rho, v, h, t]
    return word.transpose(0, 3, 1, 2, 4).reshape(groups, 2, 32)


def _bitmm_column_frag(M: np.ndarray) -> np.ndarray:
    """gf_bitmm_columns' table of M (c <= 32): see BitmmPlan."""
    groups = -(-M.shape[0] // 4)
    B = _bitmm_rows(M, 256)
    # [G, rho, p, v, h, t, 8 e + s] -> word [G, rho, p, v, h, t]
    word = (B.reshape(groups, 4, 4, 2, 2, 4, 32)
            << np.arange(32, dtype=np.uint64)).sum(-1)
    return word.transpose(0, 2, 4, 1, 3, 5).reshape(groups, 4, 2, 32)


@functools.lru_cache(maxsize=128)
def _cached_bitmm_plan(key: bytes, shape: tuple[int, int]) -> BitmmPlan:
    M = np.frombuffer(key, dtype=np.uint8).reshape(shape)
    frag = _bitmm_word_frag(M) if shape[1] <= 8 else _bitmm_column_frag(M)
    return BitmmPlan(frag=np.ascontiguousarray(frag.astype(np.uint32)),
                     rows=shape[0], cols=shape[1])


def bitmm_plan(M: np.ndarray) -> BitmmPlan:
    """The gf_bitmm plan of matrix ``M`` (8c <= 256), cached per
    matrix."""
    M = np.ascontiguousarray(M, dtype=np.uint8)
    if 8 * M.shape[1] > 256:
        raise ValueError(f"gf_bitmm needs c <= 32, got c = {M.shape[1]}")
    return _cached_bitmm_plan(M.tobytes(), M.shape)


def _bitmm_bytes(u8: torch.Tensor, bits: np.ndarray) -> torch.Tensor:
    """Plain version of G4: (c, n) uint8 -> (r, n) uint8.  The bytes are
    unpacked into LSB-first 0/1 planes (8c, n), multiplied by ``bits`` =
    gf256.bitmatrix(M) (8r, 8c) in float32 — exact, since a sum is at
    most 8c <= 256 — and the low bit of each sum is packed back into
    bytes, as the JAX graph does with bf16 operands."""
    _count("plain")
    c, n = u8.shape
    r = bits.shape[0] // 8
    dev = u8.device
    B = torch.from_numpy(np.ascontiguousarray(bits, dtype=np.float32)).to(dev)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    out = torch.empty((r, n), dtype=torch.uint8, device=dev)
    for lo in range(0, n, _MXU_PLAIN_COLS):
        part = u8[:, lo:lo + _MXU_PLAIN_COLS]
        w = part.shape[1]
        planes = ((part[:, None, :] >> shifts[None, :, None]) & 1)
        acc = B @ planes.reshape(8 * c, w).to(torch.float32)
        low = acc.to(torch.int32).reshape(r, 8, w) & 1
        out[:, lo:lo + w] = (low << shifts.to(torch.int32)[None, :, None]
                             ).sum(1).to(torch.uint8)
    return out


def gf_bitmm_lanes(x32: torch.Tensor, bits: np.ndarray, plan=None, *,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """G4 wrapper: (c, n4) 32-bit lanes -> (r, n4) int32 lanes.

    On a CPU tensor it runs the plain version with ``bits`` =
    gf256.bitmatrix(M).  On a CUDA tensor it launches ``gf_bitmm`` with
    ``plan`` = (frag tensor, BitmmPlan), the tensor on the same device,
    and needs c <= 32, n4 % 4 == 0 and 16-byte alignment.  ``out``
    (r, n4) int32, when given, receives the lanes (_out_lanes)."""
    if x32.device.type == "cpu":
        y8 = _bitmm_bytes(x32.contiguous().view(torch.uint8), bits)
        return _into(y8.view(torch.int32), out)
    if x32.device.type != "cuda":
        raise ValueError(f"gf_bitmm: unsupported device {x32.device}")
    if plan is None:
        raise ValueError("gf_bitmm: a CUDA tensor needs the device plan")
    frag, p = plan
    _check_lanes(x32, p.cols, "gf_bitmm")
    n4 = x32.shape[1]
    if (not x32.is_contiguous() or n4 % 4 or x32.data_ptr() % 16
            or frag.device != x32.device):
        raise ValueError("gf_bitmm: want contiguous, 16-byte aligned "
                         "lanes with n4 % 4 == 0 and the plan on the "
                         "same device")
    from . import cuda_lib
    y32 = _out_lanes(out, p.rows, x32, "gf_bitmm")
    with torch.cuda.device(x32.device):
        stream = torch.cuda.current_stream(x32.device).cuda_stream
        err = cuda_lib.lib().gf_bitmm(
            x32.data_ptr(), y32.data_ptr(), frag.data_ptr(), p.rows, p.cols,
            4 * n4, stream)
    cuda_lib.check(err, "gf_bitmm launch")
    _count("gf_bitmm")
    return y32


def gf_matmul_mxu_graph(M: np.ndarray):
    """fn(data (c, L) uint8 tensor) -> (r, L) uint8 computing M @ data
    over GF(2^8) as the bit-matrix product mod 2; the plain version of
    G4, on any device.  Needs c <= 32, as the JAX graph does."""
    M = np.asarray(M, dtype=np.uint8)
    r, c = M.shape
    if 8 * c > 256:
        raise ValueError("the mxu realization needs c <= 32")
    bits = gf256.bitmatrix(M)

    def fn(data_u8):
        if data_u8.shape[0] != c:
            raise ValueError(f"expected {c} rows, got {data_u8.shape[0]}")
        return _bitmm_bytes(data_u8, bits)

    return fn


def region_fn(M: np.ndarray, kernel: str = "auto"):
    """fn(data (c, L) uint8 tensor, out=None) -> (r, L) uint8 tensor on
    data's device: the kernel on a CUDA tensor, its plain version on a
    CPU one (one RegionMatmul per device, built at first call); ``out``
    as in RegionMatmul.__call__."""
    ops: dict[torch.device, RegionMatmul] = {}
    lock = threading.Lock()

    def fn(data, out=None):
        with lock:
            op = ops.get(data.device)
            if op is None:
                op = ops[data.device] = RegionMatmul(
                    M, kernel=kernel, device=data.device)
        return op(data, out=out)

    return fn


# ---------------------------------------------------------------------------
# scheduled XOR of packet rows: the GF(2) bit-matrix codes (K3)
# ---------------------------------------------------------------------------

def _sched_plane_rows(x32, sched: XorSchedule):
    """Plain version of K3: (n_in, n4) int32 plane rows -> (n_out, n4):
    the schedule applied to rows that ARE the planes already (the
    bit-matrix code family's packet rows), so there is no bit extraction
    and no packing.  An output with no terms is a zero row."""
    if x32.shape[0] != sched.n_in:
        raise ValueError(f"schedule wants {sched.n_in} rows, got "
                         f"{x32.shape[0]}")
    _count("plain")
    nodes: list = [None] * (sched.n_in + len(sched.ops))
    for p in sched.used_inputs:
        nodes[p] = x32[p]
    _eval_schedule_nodes(sched, nodes)
    rows = []
    for terms in sched.outputs:
        acc = _combine_terms(nodes, terms)
        rows.append(acc if acc is not None else torch.zeros_like(x32[0]))
    return torch.stack(rows)


#: output rows one gf_sched_xor thread keeps in registers at a time;
#: must match kSchedRows in csrc/gf_region.cu
SCHED_ROW_BLOCK = 16

#: bytes of a packet of the bit-matrix codes (ec/interface.SIMD_ALIGN);
#: must match kPacketLanes * 16 in csrc/gf_region.cu
PACKET_BYTES = 64

def _sched_packet_rows(x32, sched: XorSchedule, w: int):
    """Plain version of K3 in packet mode: (n, n4) int32 chunk lanes ->
    (R / w, n4).  A chunk is granules of w packets of PACKET_BYTES; the
    chunks' packet rows are permuted into (n * w, G * PACKET_BYTES / 4)
    plane rows, the schedule runs on them, and the result is permuted
    back; the kernel reads and writes the same packet rows in place."""
    n, n4 = x32.shape
    q = PACKET_BYTES // 4
    if n4 % (w * q):
        raise ValueError(f"packet mode wants whole {w * PACKET_BYTES}-byte "
                         f"granules, got {4 * n4} bytes a row")
    g = n4 // (w * q)
    planes = x32.reshape(n, g, w, q).permute(0, 2, 1, 3).reshape(n * w, -1)
    out = _sched_plane_rows(planes, sched)
    return out.reshape(-1, w, g, q).permute(0, 2, 1, 3).reshape(-1, n4)


@dataclass(frozen=True)
class SchedXorPlan:
    """A GF(2) matrix B (rows, cols) lowered for the gf_sched_xor kernel,
    whose rows and columns are packet rows j * w + p: packet p of chunk j
    (w = 1: plane rows, chunk j is row j).

    Output rows go in blocks of SCHED_ROW_BLOCK.  Block b's entries are
    ``entries[ptr[b]:ptr[b + 1]]``, one (chunk, packet, mask, 0) quad for
    every input row that feeds a row of the block, in input-row order: bit
    i of the mask is B[b * SCHED_ROW_BLOCK + i, input row].  ``ptr`` is
    (n_blocks + 1,) int32 and ``entries`` (n, 4) int32."""

    ptr: np.ndarray
    entries: np.ndarray
    rows: int
    cols: int
    w: int


def sched_xor_plan(B: np.ndarray, w: int = 1) -> SchedXorPlan:
    """Lower GF(2) matrix ``B`` into a SchedXorPlan for ``w`` packets a
    granule; B's shape must be a multiple of w."""
    B = np.ascontiguousarray(B, dtype=np.uint8) & 1
    rows, cols = B.shape
    if rows % w or cols % w:
        raise ValueError(f"a {rows}x{cols} matrix is not whole chunks of "
                         f"{w} packets")
    ptr = [0]
    entries: list[tuple[int, int, int, int]] = []
    for r0 in range(0, rows, SCHED_ROW_BLOCK):
        blk = B[r0:r0 + SCHED_ROW_BLOCK].astype(np.int64)
        masks = (blk << np.arange(blk.shape[0])[:, None]).sum(axis=0)
        entries += [(int(c) // w, int(c) % w, int(masks[c]), 0)
                    for c in np.nonzero(masks)[0]]
        ptr.append(len(entries))
    return SchedXorPlan(ptr=np.array(ptr, dtype=np.int32),
                        entries=np.array(entries, dtype=np.int32)
                        .reshape(-1, 4), rows=rows, cols=cols, w=w)


def gf_sched_xor_lanes(x32: torch.Tensor, sched: XorSchedule, plan=None,
                       *, w: int = 1) -> torch.Tensor:
    """K3 wrapper: (C / w, n4) 32-bit lanes -> (R / w, n4) int32 lanes,
    where w = 1 takes plane rows and w > 1 chunks of granules of w
    packets (n4 % (w * PACKET_BYTES / 4) == 0).

    On a CPU tensor it runs the plain version of ``sched``.  On a CUDA
    tensor it launches ``gf_sched_xor`` with ``plan`` = (ptr tensor,
    entries tensor, SchedXorPlan for w), the tensors on the same device,
    and needs n4 % 4 == 0 and 16-byte alignment."""
    if x32.device.type == "cpu":
        x32 = x32.view(torch.int32)
        if w == 1:
            return _sched_plane_rows(x32, sched)
        return _sched_packet_rows(x32, sched, w)
    if x32.device.type != "cuda":
        raise ValueError(f"gf_sched_xor: unsupported device {x32.device}")
    if plan is None:
        raise ValueError("gf_sched_xor: a CUDA tensor needs the device plan")
    ptr, entries, p = plan
    if p.w != w:
        raise ValueError(f"gf_sched_xor: a plan for w={p.w}, not w={w}")
    _check_lanes(x32, p.cols // w, "gf_sched_xor")
    n4 = x32.shape[1]
    quantum = 4 if w == 1 else w * PACKET_BYTES // 4
    if (not x32.is_contiguous() or n4 % quantum or x32.data_ptr() % 16
            or ptr.device != x32.device or entries.device != x32.device):
        raise ValueError(f"gf_sched_xor: want contiguous, 16-byte aligned "
                         f"lanes with n4 % {quantum} == 0 and the plan on "
                         f"the same device")
    from . import cuda_lib
    y32 = torch.empty((p.rows // w, n4), dtype=torch.int32,
                      device=x32.device)
    with torch.cuda.device(x32.device):
        stream = torch.cuda.current_stream(x32.device).cuda_stream
        err = cuda_lib.lib().gf_sched_xor(
            x32.data_ptr(), y32.data_ptr(), ptr.data_ptr(),
            entries.data_ptr(), p.rows, int(entries.shape[0]), w, n4,
            stream)
    cuda_lib.check(err, "gf_sched_xor launch")
    _count("gf_sched_xor")
    return y32


def gf_sched_xor_graph(B: np.ndarray, w: int = 1):
    """fn(rows (C / w, L) uint8 tensor) -> (R / w, L) uint8 computing
    B @ rows over GF(2) by B's XOR schedule (L % 4 == 0; for w > 1 chunks
    of whole granules, as in ScheduledXor's packet mode); the plain version
    of K3, on any device."""
    B = np.ascontiguousarray(B, dtype=np.uint8) & 1
    sched = _cached_schedule(B.tobytes(), B.shape)
    R, C = B.shape

    def fn(rows_u8):
        if rows_u8.shape[0] * w != C:
            raise ValueError(f"expected {C // w} rows, got "
                             f"{rows_u8.shape[0]}")
        x32 = _lanes_view(rows_u8)
        y32 = (_sched_plane_rows(x32, sched) if w == 1
               else _sched_packet_rows(x32, sched, w))
        return _bytes_view(y32).reshape(R // w, -1)

    return fn


class _LaneOp:
    """What RegionMatmul and ScheduledXor share: one device, the JAX
    kernels' padding quantum, and the byte path (c, L) uint8 -> (r, L)
    uint8 around the op's lane computation ``_lanes_op``, (c, n4) ->
    (r, n4) 32-bit lanes.  Subclasses set ``r`` and ``c``."""

    # lane block of the JAX kernels: BLOCK 32-bit lanes per row (32 KiB);
    # it sets the padding quantum, which the port keeps exactly
    BLOCK = 8192

    r: int
    c: int

    def _set_device(self, device) -> None:
        """``device="cuda"`` with no card raises; ``cuda`` is pinned to
        the current card's index."""
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{type(self).__name__}: device cuda "
                                   "requested but "
                                   "torch.cuda.is_available() is False")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())

    def _lanes_op(self, x32: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _quantum(self, L: int) -> int:
        # 512 bytes up to one block, then whole blocks (the JAX kernel's
        # tiling; kept so both packages pad identically)
        return 512 if L <= 4 * self.BLOCK else 4 * self.BLOCK

    def _on_device(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on this op's device.  Host input is copied over; a
        tensor on any other device raises, so work never leaves the card
        unseen (a card tensor given to a CPU op does not quietly run the
        plain version)."""
        if x.device == self.device:
            return x
        if x.device.type != "cpu":
            raise ValueError(f"a {x.device} tensor given to a "
                             f"{type(self).__name__} on {self.device}")
        return x.to(self.device)

    def encode_lanes(self, x32: torch.Tensor, out32=None) -> torch.Tensor:
        """Raw lane-domain entry: x32 (c, n4) int32/uint32 tensor ->
        (r, n4) int32 tensor on this op's device (``out32``, an (r, n4)
        int32 tensor there, when given: RegionMatmul's lanes take one).
        n4 must already be a multiple of 128 (whole tiles) and, beyond
        one block, of BLOCK."""
        n4 = x32.shape[-1]
        if n4 % 128 or (n4 > self.BLOCK and n4 % self.BLOCK):
            raise ValueError(
                f"encode_lanes wants n4 % 128 == 0 and, beyond one block, "
                f"n4 % {self.BLOCK} == 0; got {n4}")
        x32 = self._on_device(x32)
        if out32 is None:
            return self._lanes_op(x32)
        return self._lanes_op(x32, out32)

    def _bytes_in(self, data) -> torch.Tensor:
        """``data`` as a (c, L) uint8 tensor (numpy is wrapped)."""
        if isinstance(data, np.ndarray):
            data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8))
        if data.dtype != torch.uint8:
            raise TypeError(f"expected uint8 data, got {data.dtype}")
        if data.ndim != 2 or data.shape[0] != self.c:
            raise ValueError(
                f"expected ({self.c}, L) data, got {tuple(data.shape)}")
        return data

    def __call__(self, data, *, donate: bool = False,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        """data (c, L) uint8 (numpy, or a tensor on the host or on this
        op's device) -> (r, L) uint8 tensor on this op's device.
        ``donate`` is accepted for the JAX package's signature and
        ignored (``out`` is the port's way to reuse a buffer).

        ``out``, an (r, L) uint8 tensor on this op's device, receives
        the result and is returned; the caller owns it (a flush's
        scratch, never an arena-held tensor).  Where it is contiguous,
        16-byte aligned and L needs no padding, the kernel writes into
        it; else the result is copied in."""
        data = self._bytes_in(data)
        L = data.shape[1]
        if out is not None and (out.shape != (self.r, L)
                                or out.dtype != torch.uint8
                                or out.device != self.device):
            raise ValueError(f"out: want a ({self.r}, {L}) uint8 tensor on "
                             f"{self.device}, got {tuple(out.shape)} "
                             f"{out.dtype} on {out.device}")
        if L == 0:
            return (out if out is not None else
                    torch.zeros((self.r, 0), dtype=torch.uint8,
                                device=self.device))
        pad = (-L) % self._quantum(L)
        x = self._on_device(data)
        if pad or not x.is_contiguous() or x.data_ptr() % 16:
            buf = torch.zeros((self.c, L + pad), dtype=torch.uint8,
                              device=self.device)
            buf[:, :L] = x
            x = buf
        out32 = (out.view(torch.int32) if out is not None and not pad
                 and out.is_contiguous() and out.data_ptr() % 16 == 0
                 else None)
        res = self.encode_lanes(x.view(torch.int32), out32).view(torch.uint8)
        res = res[:, :L] if pad else res
        if out is not None and res.data_ptr() != out.data_ptr():
            out.copy_(res)
            return out
        return res


class RegionMatmul(_LaneOp):
    """out(r, L) = M(r, c) @ data(c, L) over GF(2^8) on one device.

    ``data`` is uint8; stripes batch by widening L (columns are
    independent), which is how a stripe batch is fed in one launch: a
    (c, batch*chunk) tensor.  PyTorch runs eagerly, so the JAX package's
    per-shape jit LRU has no counterpart; what is cached is the
    matrix's device-resident coefficient table (K1), plan (K2) or
    fragment table (G4), built at first launch behind ``_cache_lock``.
    """

    def __init__(self, M: np.ndarray, *, kernel: str = "auto",
                 device="cuda"):
        """``kernel`` picks the realization (KERNELS): ``auto`` is the
        bit-term kernel on the card and the plain ``xla`` version on the
        CPU; an explicit name pins it and raises ValueError where
        kernel_supports says no (``xla`` on the card, ``mxu`` above 32
        columns).  ``device="cuda"`` with no card raises."""
        self.M = np.ascontiguousarray(M, dtype=np.uint8)
        self.r, self.c = self.M.shape
        if kernel not in ("auto",) + KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}")
        self._set_device(device)
        if kernel == "auto":
            kernel = "pallas" if self.device.type == "cuda" else "xla"
        if not kernel_supports(kernel, self.M, device=self.device):
            raise ValueError(f"kernel {kernel!r} cannot run this "
                             f"{self.r}x{self.c} matrix on {self.device}")
        self.kernel = kernel
        self._terms = (_terms(self.M) if kernel in ("xla", "pallas")
                       else None)
        self._sched = bitxor_schedule(self.M) if kernel == "bitxor" \
            else None
        self._bits = gf256.bitmatrix(self.M) if kernel == "mxu" else None
        self._dev_state = None
        # one matmul op serves many threads; the device state is built
        # once, under the lock
        self._cache_lock = threading.Lock()

    def _device_state(self):
        """K1's (coef, tab), K2's (ptr, idx, BitxorPlan) or G4's (frag,
        BitmmPlan) on the card, built at first use."""
        from ..utils import staging

        with self._cache_lock:
            if self._dev_state is None:
                dev = self.device
                if self.kernel == "pallas":
                    self._dev_state = staging.upload_tables(
                        (self.M, nibble_table(self.M)), dev)
                elif self.kernel == "mxu":
                    plan = bitmm_plan(self.M)
                    self._dev_state = staging.upload_tables(
                        (plan.frag,), dev) + (plan,)
                else:
                    plan = bitxor_plan(self.M)
                    self._dev_state = staging.upload_tables(
                        (plan.ptr, plan.idx), dev) + (plan,)
            return self._dev_state

    def _lanes_op(self, x32: torch.Tensor, out32=None) -> torch.Tensor:
        """The core (c, n4) -> (r, n4) lane computation of the selected
        realization."""
        if self.kernel == "xla":
            return _into(_rows_op(x32.view(torch.int32), self._terms), out32)
        state = None if x32.device.type == "cpu" else self._device_state()
        if self.kernel == "bitxor":
            return gf_bitxor_lanes(x32, self._sched, state, out=out32)
        if self.kernel == "mxu":
            return gf_bitmm_lanes(x32, self._bits, state, out=out32)
        return gf_bitterm_lanes(x32, self._terms, state, out=out32)


class ScheduledXor(_LaneOp):
    """out(R, L) = B(R, C) @ rows(C, L) over GF(2) on one device: the
    executor of the GF(2) bit-matrix code family (ec/bitmatrix_code.py
    sends its chunks here on the torch backend).  On the card it launches
    gf_sched_xor (K3) over the plan of ``B``; on the CPU it runs the plain
    version over ``self.sched``, the CSE'd XOR schedule of ``B``.

    ``w`` = 1 takes plane rows, with the same 512-byte lane quantum as
    RegionMatmul.  ``w`` > 1 is packet mode: the op takes (C / w, L)
    chunks made of granules of w packets of PACKET_BYTES, where B's row
    and column j * w + p is packet p of chunk j, and gives (R / w, L)
    chunks.  The kernel finds the packets by address, so nothing is
    permuted or padded: L must be whole granules."""

    def __init__(self, B: np.ndarray, *, device="cuda", w: int = 1):
        self.B = np.ascontiguousarray(B, dtype=np.uint8) & 1
        self.R, self.C = self.B.shape
        if w < 1 or self.R % w or self.C % w:
            raise ValueError(f"a {self.R}x{self.C} matrix is not whole "
                             f"chunks of {w} packets")
        self.w = w
        self.r, self.c = self.R // w, self.C // w
        self.sched = _cached_schedule(self.B.tobytes(), self.B.shape)
        self._set_device(device)
        self._dev_state = None
        self._cache_lock = threading.Lock()

    def _device_state(self):
        """(ptr, entries, SchedXorPlan) on the card, built at first use."""
        from ..utils import staging

        with self._cache_lock:
            if self._dev_state is None:
                plan = sched_xor_plan(self.B, self.w)
                self._dev_state = staging.upload_tables(
                    (plan.ptr, plan.entries), self.device) + (plan,)
            return self._dev_state

    def _lanes_op(self, x32: torch.Tensor) -> torch.Tensor:
        state = None if x32.device.type == "cpu" else self._device_state()
        return gf_sched_xor_lanes(x32, self.sched, state, w=self.w)

    def __call__(self, data, *, donate: bool = False) -> torch.Tensor:
        if self.w == 1:
            return super().__call__(data, donate=donate)
        data = self._bytes_in(data)
        L = data.shape[1]
        if L % (self.w * PACKET_BYTES):
            raise ValueError(f"packet mode wants whole "
                             f"{self.w * PACKET_BYTES}-byte granules, got "
                             f"L = {L}")
        if L == 0:
            return torch.zeros((self.r, 0), dtype=torch.uint8,
                               device=self.device)
        x = self._on_device(data)
        if not x.is_contiguous() or x.data_ptr() % 16:
            x = x.clone(memory_format=torch.contiguous_format)
        return self._lanes_op(x.view(torch.int32)).view(torch.uint8)
