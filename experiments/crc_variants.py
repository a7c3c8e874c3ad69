#!/usr/bin/env python3
"""Time variants of the port's G1 kernel (crc32c_chunks) beside the
library's own, on one CUDA card.

    python3 experiments/crc_variants.py

Run from the root of a checkout on a machine with an H100.  It builds
experiments/crc_variants.cu (its own copy of the library's loop, with
switches) with nvcc into
ceph_tpu_torch/build/, prints the build's ptxas registers and spills,
and then, at (11, 8 MiB) in 128 KiB chunks (the fused CRC of a 64-stripe
k=8, m=3 batch), CUDA-event medians of 30 launches of: the library's
kernel; the same loop with runs of 16, 32 or 64 words a thread, 1, 2, 4
or 8 copies of the byte tables, a persistent grid of 3, 4 or 8 blocks an
SM walking the segments, with the next segment's loads in flight during
this one's chain (pipelined) or not; the loop
with parts left out (its loads alone, its chain without loads, no
per-thread operator); and a device copy moving the same bytes.  Every
variant that computes the CRC is held to the library's digests
(torch.equal) there and on (3, 4 x (1 MiB + 4)).  Exits 2 without a
card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ceph_tpu_torch.ops import checksum, cuda_lib  # noqa: E402

SOURCE = os.path.join(REPO, "experiments", "crc_variants.cu")
N_TIME = 30
#: label -> (run, copies, mode, pipe, block cap); mode 0 computes the CRC
VARIANTS = {
    "run 32, 8 copies": (32, 8, 0, 0, 0),
    "run 16": (16, 8, 0, 0, 0),
    "run 64": (64, 8, 0, 0, 0),
    "4 copies": (32, 4, 0, 0, 0),
    "2 copies": (32, 2, 0, 0, 0),
    "1 copy": (32, 1, 0, 0, 0),
    "persistent, 4 blocks an SM": (32, 8, 0, 0, 4 * 132),
    "persistent, 8 blocks an SM": (32, 8, 0, 0, 8 * 132),
    "2 copies, persistent, 4 blocks an SM": (32, 2, 0, 0, 4 * 132),
    "1 copy, persistent, 4 blocks an SM": (32, 1, 0, 0, 4 * 132),
    "pipelined, persistent, 4 blocks an SM": (32, 8, 0, 1, 4 * 132),
    "2 copies, pipelined, persistent, 4 blocks an SM": (32, 2, 0, 1,
                                                        4 * 132),
    "2 copies, pipelined, persistent, 3 blocks an SM": (32, 2, 0, 1,
                                                        3 * 132),
    "1 copy, pipelined, persistent, 4 blocks an SM": (32, 1, 0, 1, 4 * 132),
    "loads only (no CRC)": (32, 8, 1, 0, 0),
    "chain without loads (no CRC)": (32, 8, 2, 0, 0),
    "no thread operator (no CRC)": (32, 8, 3, 0, 0),
}


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
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.crc_variant.restype = I
    lib.crc_variant.argtypes = [I, I, I, I, LL, P, P, P, P, P, LL, LL, I, I,
                                I, ctypes.c_uint32, P]
    return lib


def variant_fn(lib, variant: tuple, words: torch.Tensor, nbytes: int):
    """fn() launching ``variant`` (VARIANTS) on (Q, n_words) words."""
    run, copies, mode, pipe, cap = variant
    dev = words.device
    plan = checksum.crc_plan(nbytes)
    k, segs, pad = checksum.kernel_split(plan.n_words, run)
    tabs, lane, ladder = checksum._device_tables(dev, k)
    q = words.shape[0]
    y = torch.empty((q,), dtype=torch.int32, device=dev)

    def fn():
        err = lib.crc_variant(run, copies, mode, pipe, cap,
                              words.data_ptr(),
                              y.data_ptr(), tabs.data_ptr(),
                              lane.data_ptr(), ladder.data_ptr(), q,
                              plan.n_words, k, segs, pad,
                              int(plan.final_xor),
                              torch.cuda.current_stream(dev).cuda_stream)
        cuda_lib.check(err, f"variant {variant}")
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
    crc = {label: v for label, v in VARIANTS.items() if v[2] == 0}
    for label, (data, nbytes) in cases.items():
        words = data.view(torch.int32).reshape(-1, nbytes // 4)
        want = checksum.crc32c_chunks(words, checksum.crc_plan(nbytes))
        for name, variant in crc.items():
            got = variant_fn(lib, variant, words, nbytes)()
            torch.cuda.synchronize(dev)
            if not torch.equal(got.view(torch.uint32), want):
                raise AssertionError(f"variant {name} differs from the "
                                     f"library at {label}")
    print(f"[crc] {len(crc)} variants that compute the CRC equal to the "
          f"library at {', '.join(cases)}")
    data, nbytes = cases["main"]
    words = data.view(torch.int32).reshape(-1, nbytes // 4)
    plan = checksum.crc_plan(nbytes)
    lib_ms = cs.cuda_ms(lambda: checksum.crc32c_chunks(words, plan), N_TIME)
    half = data.reshape(-1)[: data.numel() // 2]
    copy_ms = cs.cuda_ms(lambda: torch.empty_like(half).copy_(half), N_TIME)
    print(f"[crc] library kernel: {lib_ms:.4f} ms; a copy moving the same "
          f"bytes {copy_ms:.4f} ms")
    for name, variant in VARIANTS.items():
        ms = cs.cuda_ms(variant_fn(lib, variant, words, nbytes), N_TIME)
        print(f"[crc] {name}: {ms:.4f} ms")
    print(f"[crc] after timing: "
          f"{cs.nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
