#!/usr/bin/env python3
"""Race variants of the port's G1 kernel (crc32c_chunks) beside the
library's own, on one CUDA card.

    python3 experiments/crc_variants.py

Run from the root of a checkout on a machine with an H100.  It builds
experiments/crc_variants.cu (which includes the library's source and
instantiates its kernel at other settings) with nvcc into
ceph_tpu_torch/build/, prints the build's ptxas registers and spills,
and then, at (11, 8 MiB) in 128 KiB chunks (the fused CRC of a 64-stripe
k=8, m=3 batch), CUDA-event medians of 30 launches of:

- the library's kernel;
- the tensor-core kernel at each setting of MMA_VARIANTS: binary
  products (m16n8k256 and.popc) with runs of 8, 16 or 32 words a row,
  int8 products (m16n8k32) with runs of 4 or 8 words, 4 or 8 warps a
  block, 16, 32 or 64 words a lane a segment;
- its loads alone (no CRC);
- the first port's table chain (one 4 KiB byte table, 4 lookups a word)
  and the probe of it with every lane of a warp reading one table entry
  (no bank conflicts, no CRC);
- a device copy moving the same bytes.

Every variant that computes the CRC is held to the library's digests
(torch.equal) there and on (3, 4 x (1 MiB + 4)); a variant that differs
is reported and timed, and the script exits 1 after the race.  Exits 2
without a card.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ceph_tpu_torch.ops import checksum, cuda_lib  # noqa: E402
from ceph_tpu_torch.ops.checksum import CrcGeometry  # noqa: E402

SOURCE = os.path.join(REPO, "experiments", "crc_variants.cu")
N_TIME = 30
#: label -> the tensor-core kernel's setting (the instantiations of
#: crc_mma in crc_variants.cu)
MMA_VARIANTS = {
    "binary, run 8 (library setting)": CrcGeometry(True, 4, 1, 8, 32),
    "binary, run 16": CrcGeometry(True, 4, 2, 8, 32),
    "binary, run 32": CrcGeometry(True, 4, 4, 8, 32),
    "binary, run 8, 4 warps": CrcGeometry(True, 4, 1, 4, 32),
    "binary, run 8, 16 words a lane": CrcGeometry(True, 4, 1, 8, 16),
    "binary, run 8, 64 words a lane": CrcGeometry(True, 4, 1, 8, 64),
    "binary, run 8, 4 warps, 64 words a lane": CrcGeometry(True, 4, 1, 4,
                                                           64),
    "int8, run 8": CrcGeometry(False, 4, 1, 8, 32),
    "int8, run 4": CrcGeometry(False, 2, 1, 8, 32),
    "int8, run 8, 4 warps": CrcGeometry(False, 4, 1, 4, 32),
    "int8, run 8, 16 words a lane": CrcGeometry(False, 4, 1, 8, 16),
}
#: label -> (words, warps, per_lane) of the loads-alone kernel
LOAD_VARIANTS = {"loads alone, 4 words a load (no CRC)": (4, 8, 32),
                 "loads alone, 2 words a load (no CRC)": (2, 8, 32)}

# the first port's table chain: 256 threads a block, runs of up to 32
# words a thread on a byte table of M^(4 * 256)
CHAIN_THREADS = 256
CHAIN_RUN = 32


def chain_split(n_words: int) -> tuple[int, int, int]:
    """(k_words, segs, pad) of the table chain."""
    k = 1
    while k < CHAIN_RUN and k * CHAIN_THREADS < n_words:
        k *= 2
    seg = k * CHAIN_THREADS
    segs = -(-n_words // seg)
    return k, segs, segs * seg - n_words


@functools.lru_cache(maxsize=8)
def chain_tables(k_words: int) -> tuple[np.ndarray, ...]:
    """(tabs (4, 256), lane_ops (32, T), ladder (32, 32)) of the chain:
    M^(4T) of each byte value at each byte, column j of M^(4 (T - t)) at
    [j, t], and M^(4 T k_words 2^j) by columns."""
    T = CHAIN_THREADS
    op4 = checksum._shift_cols(4)
    cols = np.array([1 << b for b in range(32)], dtype=np.uint64)
    lane = np.zeros((32, T), dtype=np.uint64)
    for d in range(1, T + 1):  # cols = M^(4d)
        cols = checksum._apply(op4, cols)
        lane[:, T - d] = cols
    vals = (np.arange(256, dtype=np.uint64)[None, :]
            << (8 * np.arange(4, dtype=np.uint64))[:, None])
    tabs = checksum._apply(cols, vals)
    ladder = [checksum._shift_cols(4 * T * k_words)]
    for _ in range(31):
        ladder.append(checksum._compose(ladder[-1], ladder[-1]))
    return tuple(a.astype(np.uint32).view(np.int32)
                 for a in (tabs, lane, np.stack(ladder)))


def build() -> ctypes.CDLL:
    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    so = os.path.join(cuda_lib.BUILD, "libcrc_variants.so")
    p = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o", so,
                        SOURCE], capture_output=True, text=True)
    if p.returncode:
        raise cuda_lib.CudaBuildError(p.stdout + p.stderr)
    for ln in (p.stdout + p.stderr).splitlines():
        if any(w in ln for w in ("registers", "Compiling entry", "spill")):
            print(f"[build] {ln.strip()}")
    lib = ctypes.CDLL(so)
    P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_uint32
    lib.crc_mma.restype = I
    lib.crc_mma.argtypes = [I, I, I, I, I, P, P, P, P, P, P, LL, LL, I, I, I,
                            U, P]
    lib.crc_loads.restype = I
    lib.crc_loads.argtypes = [I, I, I, P, P, LL, LL, I, I, I, P]
    lib.crc_chain.restype = I
    lib.crc_chain.argtypes = [P, P, P, P, P, LL, LL, I, I, I, U, U, P]
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def mma_fn(lib, geo: CrcGeometry, words: torch.Tensor, nbytes: int):
    """fn() launching the tensor-core kernel at ``geo`` on (Q, n_words)
    words."""
    dev = words.device
    plan = checksum.crc_plan(nbytes)
    iters, segs, pad = checksum.kernel_split(plan.n_words, geo)
    ops, shift, fin, ladder = checksum.device_tables(dev, iters, geo)
    q = words.shape[0]
    y = torch.empty((q,), dtype=torch.int32, device=dev)

    def fn():
        err = lib.crc_mma(int(geo.b1), geo.words, geo.loads, geo.warps,
                          geo.per_lane, words.data_ptr(), y.data_ptr(),
                          ops.data_ptr(), shift.data_ptr(), fin.data_ptr(),
                          ladder.data_ptr(), q, plan.n_words, iters, segs,
                          pad, int(plan.final_xor), _stream(dev))
        cuda_lib.check(err, f"crc_mma {geo}")
        return y

    return fn


def loads_fn(lib, setting: tuple, words: torch.Tensor, nbytes: int):
    v, nw, per_lane = setting
    geo = CrcGeometry(False, v, 1, nw, per_lane)
    dev = words.device
    iters, segs, pad = checksum.kernel_split(nbytes // 4, geo)
    y = torch.empty((words.shape[0],), dtype=torch.int32, device=dev)

    def fn():
        err = lib.crc_loads(v, nw, per_lane, words.data_ptr(), y.data_ptr(),
                            words.shape[0], nbytes // 4, iters, segs, pad,
                            _stream(dev))
        cuda_lib.check(err, f"crc_loads {setting}")
        return y

    return fn


def chain_fn(lib, words: torch.Tensor, nbytes: int, mask: int = 255):
    dev = words.device
    plan = checksum.crc_plan(nbytes)
    k, segs, pad = chain_split(plan.n_words)
    tabs, lane, ladder = (torch.from_numpy(a).to(dev)
                          for a in chain_tables(k))
    y = torch.empty((words.shape[0],), dtype=torch.int32, device=dev)

    def fn():
        err = lib.crc_chain(words.data_ptr(), y.data_ptr(), tabs.data_ptr(),
                            lane.data_ptr(), ladder.data_ptr(),
                            words.shape[0], plan.n_words, k, segs, pad,
                            int(plan.final_xor), mask, _stream(dev))
        cuda_lib.check(err, "crc_chain")
        return y

    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("crc_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(f"[device] {cs.nvidia_smi('name,power.limit')}")
    cuda_lib.build()
    lib = build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 7)
    rows, row_bytes, chunk = cs.CRC_MAIN
    cases = {
        "main": (torch.randint(0, 256, (rows, row_bytes), dtype=torch.uint8,
                               device=dev, generator=gen), chunk),
        "1 MiB + 4": (torch.randint(0, 256, (3, 4 * ((1 << 20) + 4)),
                                    dtype=torch.uint8, device=dev,
                                    generator=gen), (1 << 20) + 4)}
    computing = {name: (lambda w, nb, g=g: mma_fn(lib, g, w, nb))
                 for name, g in MMA_VARIANTS.items()}
    computing["table chain (first port)"] = \
        lambda w, nb: chain_fn(lib, w, nb)
    wrong = []
    for label, (data, nbytes) in cases.items():
        words = data.view(torch.int32).reshape(-1, nbytes // 4)
        want = checksum.crc32c_chunks(words, checksum.crc_plan(nbytes))
        for name, make in computing.items():
            got = make(words, nbytes)()
            torch.cuda.synchronize(dev)
            if not torch.equal(got.view(torch.uint32), want):
                wrong.append(f"{name} at {label}")
    print(f"[crc] {len(computing) - len({w.split(' at ')[0] for w in wrong})}"
          f" of {len(computing)} variants that compute the CRC equal to the "
          f"library at {', '.join(cases)}"
          + (f"; DIFFERENT: {wrong}" if wrong else ""))
    data, nbytes = cases["main"]
    words = data.view(torch.int32).reshape(-1, nbytes // 4)
    plan = checksum.crc_plan(nbytes)
    lib_ms = cs.cuda_ms(lambda: checksum.crc32c_chunks(words, plan), N_TIME)
    half = data.reshape(-1)[: data.numel() // 2]
    copy_ms = cs.cuda_ms(lambda: torch.empty_like(half).copy_(half), N_TIME)
    bound_ms = max(cs.crc_bound_parts(rows, row_bytes, chunk))
    print(f"[crc] library kernel {checksum.CRC_GEOMETRY}: {lib_ms:.4f} ms "
          f"({bound_ms / lib_ms:.0%} of its {bound_ms:.4f} ms bound); a copy "
          f"moving the same bytes {copy_ms:.4f} ms")
    timed = dict(computing)
    for name, setting in LOAD_VARIANTS.items():
        timed[name] = lambda w, nb, s=setting: loads_fn(lib, s, w, nb)
    timed["table chain, every lane one entry (probe, no CRC)"] = \
        lambda w, nb: chain_fn(lib, w, nb, mask=0)
    for name, make in timed.items():
        ms = cs.cuda_ms(make(words, nbytes), N_TIME)
        print(f"[crc] {name}: {ms:.4f} ms ({bound_ms / ms:.0%} of the "
              f"bound)")
    print(f"[crc] after timing: "
          f"{cs.nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    if wrong:
        print(f"crc_variants: variants differ from the library: {wrong}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
