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
- ``pallas`` — the bit-term CUDA kernel ``gf_bitterm`` (wrapper
  gf_bitterm_lanes); its plain version on a CPU tensor.
- ``bitxor`` — the scheduled-XOR CUDA kernel ``gf_bitxor`` (wrapper
  gf_bitxor_lanes): the CSE'd XOR program over GF(2) bit-planes built by
  ops/xor_schedule, lowered here into a flat instruction program that the
  kernel interprets; its plain version (gf_bitxor_graph) on a CPU tensor.
- ``mxu``    — the bit-matrix GEMM of the JAX package; not ported yet, so
  ``kernel_supports`` answers False for it.

Plain versions work on ``int32`` views of the lanes: CPU torch has no
shifts on ``uint32``.  An arithmetic right shift by s <= 7 followed by the
0x01010101 mask gives the same bits as the logical one, and int32
multiplies and left shifts wrap exactly like uint32 ones.

A wrapper takes its plain version only because the tensor it was given
lies on the CPU; on a CUDA tensor it launches its kernel or raises.
Launches are counted in LAUNCHES (``gf_bitterm``, ``gf_bitxor``, and
``plain`` for every run of a plain version).
"""

from __future__ import annotations

import functools
import heapq
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
LAUNCHES = {"gf_bitterm": 0, "gf_bitxor": 0, "plain": 0}
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

    - ``mxu`` is not ported yet;
    - ``xla`` is the plain version, viable only on the CPU;
    - on the CPU ``pallas`` and ``bitxor`` run their plain versions;
    - on the card ``pallas`` needs its (r, c, 9)-byte coefficient table
      to fit a block's shared memory, and ``bitxor`` needs the live set
      of its lowered schedule to fit even a 32-thread block.
    """
    if kernel not in KERNELS or kernel == "mxu":
        return False
    M = np.asarray(M)
    if M.ndim != 2 or 0 in M.shape:
        return False
    if shape is not None and tuple(shape)[0] != M.shape[1]:
        return False
    device = torch.device(device)
    if device.type == "cpu":
        return True
    if device.type != "cuda" or kernel == "xla":
        return False
    from . import cuda_lib
    smem = cuda_lib.smem_optin(device)
    if kernel == "pallas":
        return M.shape[0] * M.shape[1] * 9 <= smem
    return bitxor_threads(bitxor_program(M).n_slots, smem) is not None


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


def bitterm_table(M: np.ndarray) -> np.ndarray:
    """K1's per-matrix table: (r, c, 8) bytes gf(M[i,j] * x^s)."""
    M = np.asarray(M, dtype=np.uint8)
    powers = np.uint8(1) << np.arange(8, dtype=np.uint8)
    return gf256.mul_table()[M[:, :, None], powers[None, None, :]]


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


def gf_bitterm_lanes(x32: torch.Tensor, terms_all, table=None
                     ) -> torch.Tensor:
    """K1 wrapper: (c, n4) 32-bit lanes -> (r, n4) int32 lanes.

    On a CPU tensor it runs the plain version over ``terms_all``
    (_terms).  On a CUDA tensor it launches ``gf_bitterm`` with
    ``table`` = (coef (r, c) uint8, tab (r, c, 8) uint8) resident on
    the same device, and needs n4 % 4 == 0 and 16-byte alignment."""
    r = len(terms_all)
    if x32.device.type == "cpu":
        return _rows_op(x32.view(torch.int32), terms_all)
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
    y32 = torch.empty((r, n4), dtype=torch.int32, device=x32.device)
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


# program opcodes of the gf_bitxor kernel (csrc/gf_region.cu)
OP_LOAD, OP_XOR, OP_INIT, OP_ACC, OP_STORE, OP_ZERO = range(6)


@dataclass(frozen=True)
class BitxorProgram:
    """An XorSchedule lowered for the gf_bitxor kernel: ``code`` is an
    (n, 4) int32 array of (opcode, a, b, c) instructions over
    ``n_slots`` node slots; ``rows`` output byte rows.

    - LOAD  a, j, s: slot a = (x[j] >> s) & 0x01010101
    - XOR   a, b, c: slot a = slot b ^ slot c
    - INIT  a, b, t: slot a = slot b << t    (first term of a row)
    - ACC   a, b, t: slot a ^= slot b << t
    - STORE i, b:    output row i = slot b
    - ZERO  i:       output row i = 0
    """

    code: np.ndarray
    n_slots: int
    rows: int


def lower_schedule(sched: XorSchedule) -> BitxorProgram:
    """Lower ``sched`` into a BitxorProgram whose node slots are
    allocated by liveness: the working set is the most nodes live at
    once, not the node count.

    Order: the schedule's ops in order, each operand input plane loaded
    just before its first use; every node's output terms are folded into
    their row accumulators right after the node is made (shift
    distributes over XOR, so out_row ^= node << t term by term), and a
    row is stored right after its last term.  Planes read only by
    outputs load last, in plane order, so planes of one input row sit
    together (the kernel keeps the last row it read in a register)."""
    n_in = sched.n_in
    n_rows = len(sched.outputs) // 8
    node_terms: dict[int, list[tuple[int, int]]] = {}
    row_terms = [0] * n_rows
    for q, terms in enumerate(sched.outputs):
        for node in terms:
            node_terms.setdefault(node, []).append((q >> 3, q & 7))
            row_terms[q >> 3] += 1

    events: list[tuple] = []
    loaded: set[int] = set()

    def define(ev: tuple, node: int) -> None:
        events.append(ev)
        for row, t in node_terms.get(node, ()):
            events.append(("acc", row, node, t))

    for dst, a, b in sched.ops:
        for p in (a, b):
            if p < n_in and p not in loaded:
                loaded.add(p)
                define(("load", p), p)
        define(("xor", dst, a, b), dst)
    for p in sched.used_inputs:
        if p not in loaded:
            loaded.add(p)
            define(("load", p), p)

    last_use: dict[int, int] = {}
    for idx, ev in enumerate(events):
        if ev[0] == "xor":
            last_use[ev[2]] = idx
            last_use[ev[3]] = idx
        elif ev[0] == "acc":
            last_use[ev[2]] = idx

    free: list[int] = []
    n_slots = 0

    def alloc() -> int:
        nonlocal n_slots
        if free:
            return heapq.heappop(free)
        n_slots += 1
        return n_slots - 1

    slot: dict[int, int] = {}
    acc_slot: dict[int, int] = {}
    acc_left = list(row_terms)
    code: list[tuple[int, int, int, int]] = []

    def release(node: int, idx: int) -> None:
        if last_use.get(node, -1) <= idx and node in slot:
            heapq.heappush(free, slot.pop(node))

    for idx, ev in enumerate(events):
        kind = ev[0]
        if kind == "load":
            p = ev[1]
            slot[p] = alloc()
            code.append((OP_LOAD, slot[p], p >> 3, p & 7))
            release(p, idx)  # a plane nothing reads (never, in practice)
        elif kind == "xor":
            _, dst, a, b = ev
            sa, sb = slot[a], slot[b]
            release(a, idx)
            release(b, idx)
            slot[dst] = alloc()
            code.append((OP_XOR, slot[dst], sa, sb))
            release(dst, idx)
        else:
            _, row, node, t = ev
            src = slot[node]
            release(node, idx)
            if row not in acc_slot:
                acc_slot[row] = alloc()
                code.append((OP_INIT, acc_slot[row], src, t))
            else:
                code.append((OP_ACC, acc_slot[row], src, t))
            acc_left[row] -= 1
            if acc_left[row] == 0:
                code.append((OP_STORE, row, acc_slot[row], 0))
                heapq.heappush(free, acc_slot.pop(row))
    for row in range(n_rows):
        if row_terms[row] == 0:
            code.append((OP_ZERO, row, 0, 0))
    arr = np.array(code, dtype=np.int32).reshape(-1, 4)
    return BitxorProgram(code=arr, n_slots=n_slots, rows=n_rows)


@functools.lru_cache(maxsize=128)
def _cached_program(key: bytes, shape: tuple[int, int]) -> BitxorProgram:
    M = np.frombuffer(key, dtype=np.uint8).reshape(shape)
    return lower_schedule(bitxor_schedule(M))


def bitxor_program(M: np.ndarray) -> BitxorProgram:
    """The lowered bitxor program of matrix ``M``, cached per matrix."""
    M = np.ascontiguousarray(M, dtype=np.uint8)
    return _cached_program(M.tobytes(), M.shape)


#: gf_bitxor block sizes, largest first
_BITXOR_THREADS = (256, 128, 64, 32)


def bitxor_threads(n_slots: int, smem_optin: int) -> int | None:
    """Block size for a program of ``n_slots`` slots: the largest whose
    [slot][thread] array fits the default 48 KiB of shared memory, else
    the largest that fits what a block may opt in to, else None (the
    schedule's live set does not fit even a 32-thread block)."""
    for limit in (48 * 1024, smem_optin):
        for t in _BITXOR_THREADS:
            if max(n_slots, 1) * t * 4 <= limit:
                return t
    return None


def gf_bitxor_lanes(x32: torch.Tensor, sched: XorSchedule, program=None
                    ) -> torch.Tensor:
    """K2 wrapper: (c, n4) 32-bit lanes -> (r, n4) int32 lanes.

    On a CPU tensor it runs the plain version of ``sched``.  On a CUDA
    tensor it launches ``gf_bitxor`` with ``program`` = (code tensor
    (n, 4) int32 on the same device, BitxorProgram, threads)."""
    if x32.device.type == "cpu":
        return _bitxor_rows(x32.view(torch.int32), sched)
    if x32.device.type != "cuda":
        raise ValueError(f"gf_bitxor: unsupported device {x32.device}")
    if program is None:
        raise ValueError("gf_bitxor: a CUDA tensor needs the device program")
    code, prog, threads = program
    _check_lanes(x32, sched.n_in // 8, "gf_bitxor")
    n4 = x32.shape[1]
    if not x32.is_contiguous() or code.device != x32.device:
        raise ValueError("gf_bitxor: want contiguous lanes and the "
                         "program on the same device")
    from . import cuda_lib
    y32 = torch.empty((prog.rows, n4), dtype=torch.int32, device=x32.device)
    with torch.cuda.device(x32.device):
        stream = torch.cuda.current_stream(x32.device).cuda_stream
        err = cuda_lib.lib().gf_bitxor(
            x32.data_ptr(), y32.data_ptr(), code.data_ptr(),
            int(code.shape[0]), prog.n_slots, n4, threads, stream)
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
    kernel realization: ``bitxor`` is K2's plain version, everything else
    K1's (the JAX package's rule: pallas/auto lower to the xla graph)."""
    if kernel == "mxu":
        raise ValueError("the mxu realization is not ported yet")
    if kernel == "bitxor":
        return gf_bitxor_graph(M)
    return gf_matmul_graph(M)


def region_fn(M: np.ndarray, kernel: str = "auto"):
    """fn(data (c, L) uint8 tensor) -> (r, L) uint8 tensor on data's
    device: the kernel on a CUDA tensor, its plain version on a CPU one
    (one RegionMatmul per device, built at first call)."""
    ops: dict[torch.device, RegionMatmul] = {}
    lock = threading.Lock()

    def fn(data):
        with lock:
            op = ops.get(data.device)
            if op is None:
                op = ops[data.device] = RegionMatmul(
                    M, kernel=kernel, device=data.device)
        return op(data)

    return fn


class RegionMatmul:
    """out(r, L) = M(r, c) @ data(c, L) over GF(2^8) on one device.

    ``data`` is uint8; stripes batch by widening L (columns are
    independent), which is how a stripe batch is fed in one launch: a
    (c, batch*chunk) tensor.  PyTorch runs eagerly, so the JAX package's
    per-shape jit LRU has no counterpart; what is cached is the
    matrix's device-resident coefficient table (K1) or lowered program
    (K2), built at first launch behind ``_cache_lock``.
    """

    # lane block of the JAX kernel: BLOCK 32-bit lanes per row (32 KiB);
    # it sets the padding quantum, which the port keeps exactly
    BLOCK = 8192

    def __init__(self, M: np.ndarray, *, kernel: str = "auto",
                 device="cuda"):
        """``kernel`` picks the realization (KERNELS): ``auto`` is the
        bit-term kernel on the card and the plain ``xla`` version on the
        CPU; an explicit name pins it and raises ValueError where
        kernel_supports says no (``xla`` on the card, ``mxu``
        anywhere).  ``device="cuda"`` with no card raises."""
        self.M = np.ascontiguousarray(M, dtype=np.uint8)
        self.r, self.c = self.M.shape
        if kernel not in ("auto",) + KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("RegionMatmul: device cuda requested but "
                                   "torch.cuda.is_available() is False")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        if kernel == "auto":
            kernel = "pallas" if self.device.type == "cuda" else "xla"
        if not kernel_supports(kernel, self.M, device=self.device):
            raise ValueError(f"kernel {kernel!r} cannot run this "
                             f"{self.r}x{self.c} matrix on {self.device}")
        self.kernel = kernel
        self._terms = _terms(self.M) if kernel != "bitxor" else None
        self._sched = bitxor_schedule(self.M) if kernel == "bitxor" \
            else None
        self._dev_state = None
        # one matmul op serves many threads; the device state is built
        # once, under the lock
        self._cache_lock = threading.Lock()

    def _device_state(self):
        """K1's (coef, tab) or K2's (code, program, threads) on the
        card, built at first use."""
        with self._cache_lock:
            if self._dev_state is None:
                dev = self.device
                if self.kernel == "pallas":
                    self._dev_state = (
                        torch.from_numpy(self.M.copy()).to(dev),
                        torch.from_numpy(bitterm_table(self.M)).to(dev))
                else:
                    from . import cuda_lib
                    prog = bitxor_program(self.M)
                    threads = bitxor_threads(prog.n_slots,
                                             cuda_lib.smem_optin(dev))
                    self._dev_state = (torch.from_numpy(prog.code).to(dev),
                                       prog, threads)
            return self._dev_state

    def _lanes_op(self, x32: torch.Tensor) -> torch.Tensor:
        """The core (c, n4) -> (r, n4) lane computation of the selected
        realization."""
        if self.kernel == "xla":
            return _rows_op(x32.view(torch.int32), self._terms)
        state = None if x32.device.type == "cpu" else self._device_state()
        if self.kernel == "bitxor":
            return gf_bitxor_lanes(x32, self._sched, state)
        return gf_bitterm_lanes(x32, self._terms, state)

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
            raise ValueError(f"a {x.device} tensor given to a region op on "
                             f"{self.device}")
        return x.to(self.device)

    def encode_lanes(self, x32: torch.Tensor) -> torch.Tensor:
        """Raw lane-domain entry: x32 (c, n4) int32/uint32 tensor ->
        (r, n4) int32 tensor on this op's device.  n4 must already be a
        multiple of 128 (whole tiles) and, beyond one block, of BLOCK."""
        n4 = x32.shape[-1]
        if n4 % 128 or (n4 > self.BLOCK and n4 % self.BLOCK):
            raise ValueError(
                f"encode_lanes wants n4 % 128 == 0 and, beyond one block, "
                f"n4 % {self.BLOCK} == 0; got {n4}")
        return self._lanes_op(self._on_device(x32))

    def __call__(self, data, *, donate: bool = False) -> torch.Tensor:
        """data (c, L) uint8 (numpy, or a tensor on the host or on this
        op's device) -> (r, L) uint8 tensor on this op's device.
        ``donate`` is accepted for the JAX package's signature and
        ignored: the port does not alias inputs yet."""
        if isinstance(data, np.ndarray):
            data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8))
        if data.dtype != torch.uint8:
            raise TypeError(f"expected uint8 data, got {data.dtype}")
        if data.ndim != 2 or data.shape[0] != self.c:
            raise ValueError(
                f"expected ({self.c}, L) data, got {tuple(data.shape)}")
        L = data.shape[1]
        if L == 0:
            return torch.zeros((self.r, 0), dtype=torch.uint8,
                               device=self.device)
        pad = (-L) % self._quantum(L)
        x = self._on_device(data)
        if pad or not x.is_contiguous() or x.data_ptr() % 16:
            buf = torch.zeros((self.c, L + pad), dtype=torch.uint8,
                              device=self.device)
            buf[:, :L] = x
            x = buf
        y32 = self.encode_lanes(x.view(torch.int32))
        out = y32.view(torch.uint8)
        return out[:, :L] if pad else out
