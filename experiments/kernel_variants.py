#!/usr/bin/env python3
"""Time variants of the port's K1, K2 and K3 kernels beside the
library's own, on one CUDA card: what bounds each kernel, and why the
library's fixed settings are what they are.

    python3 experiments/kernel_variants.py

Run from the root of a checkout on a machine with an H100.  It builds
experiments/kernel_variants.cu (which includes the library's source and
launches its loops at other template arguments) with nvcc into
ceph_tpu_torch/build/, prints the build's ptxas registers and spills and
the SASS opcodes of the library's K1 loop (cuobjdump, where the toolkit
has it), then prints CUDA-event medians of 30 launches:

- K1 (gf_bitterm) at the 3x8 reed_sol_van encode and the 8x8 decode
  {1,4,9} on (c, 8 MiB): the library's kernel, the same loop with
  16-entry lookups, with no coefficient flags, at other counts of output
  rows in registers, input rows loaded at once and blocks per SM under
  __launch_bounds__, its loads and stores alone and its selectors alone,
  and a device copy of the same bytes;

- K2 (gf_bitxor) at the 3x8 reed_sol_van encode and an 8x8 decode on
  (c, 8 MiB): the library's kernel, K1 beside it, the same loop with 2,
  4 or 8 input rows in flight, and with its phases switched off one at a
  time (input phase only, output phase only, no transposes);
- K3 (gf_sched_xor) in packet mode at the liberation k=5 encode and the
  liber8tion {0,1} decode of an 80 MiB object: the library's kernel, the
  same loop at other knobs (8 loads in flight, 256-thread blocks,
  __launch_bounds__(128, 5), streaming stores, 1 to 64 blocks per SM), the
  rows of a mask XORed in by a switch per set bit, and the memory pattern
  alone (the same loads and stores, one XOR per input).

Variants that compute the product are held to the library's bytes
(torch.equal); the phase splits and the memory-only pass do not compute
it and say so.  Exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ceph_tpu_torch.ops import cuda_lib, ec_kernels  # noqa: E402

SOURCE = os.path.join(REPO, "experiments", "kernel_variants.cu")
N_TIME = 30


def build() -> ctypes.CDLL:
    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    so = os.path.join(cuda_lib.BUILD, "libkernel_variants.so")
    p = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o", so,
                        SOURCE], capture_output=True, text=True)
    if p.returncode:
        raise cuda_lib.CudaBuildError(p.stdout + p.stderr)
    for ln in (p.stdout + p.stderr).splitlines():
        if any(w in ln for w in ("registers", "Compiling entry", "spill")):
            print(f"[ptxas] {ln.strip()}")
    lib = ctypes.CDLL(so)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.variant_bitterm.argtypes = [P, P, P, P, I, I, LL, I]
    lib.variant_bitxor.argtypes = [P, P, P, P, I, I, I, LL, I, I]
    lib.variant_sched.argtypes = [P, P, P, P, I, I, I, LL, I, I]
    return lib


def timed(fn) -> float:
    rc = fn()
    torch.cuda.synchronize()
    if rc:
        raise cuda_lib.CudaKernelError(f"variant launch: CUDA error {rc}")
    return cs.cuda_ms(fn, N_TIME)


def sass_opcodes(so: str, kernel: str = "gf_bitterm_kernel") -> None:
    """Print the opcode counts of the first function in ``so`` whose
    mangled name holds ``kernel``: which pipes its loop issues to."""
    tool = os.path.join(os.path.dirname(cuda_lib.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print(f"[sass] no cuobjdump beside {cuda_lib.nvcc()}")
        return
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    counts: dict[str, int] = {}
    name = None
    for ln in out.splitlines():
        if "Function :" in ln:
            if name is not None:
                break
            if kernel in ln:
                name = ln.split("Function :")[1].strip()
            continue
        if name is None or "/*" not in ln:
            continue
        body = ln.split("*/", 1)[-1].strip().lstrip("{").strip()
        if not body or body.startswith("/*"):
            continue
        op = body.split()[0]
        if op.startswith("@"):
            op = body.split()[1]
        op = op.split(".")[0].rstrip(";")
        counts[op] = counts.get(op, 0) + 1
    print(f"[sass] {name}: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items(), key=lambda kv: -kv[1])),
        flush=True)


#: K1 variants: (mode of variant_bitterm, what, computes the product)
K1_VARIANTS = ((0, "the library's setting through the variant entry", True),
               (1, "16-entry lookups", True),
               (2, "loads and stores only", False),
               (3, "selectors only", False),
               (4, "no flags", True),
               *((m, f"{rows} rows, {batch} at once, "
                     f"__launch_bounds__({threads}, {blocks})"
                     f"{'' if flags else ', no flags'}", True)
                 for m, rows, batch, threads, blocks, flags in (
                     (5, 4, 8, 256, 3, True), (6, 4, 8, 256, 1, True),
                     (7, 4, 4, 128, 8, True), (8, 4, 4, 256, 4, False),
                     (9, 4, 3, 256, 4, True), (10, 4, 2, 256, 5, True),
                     (11, 4, 2, 256, 6, True), (12, 8, 2, 256, 4, True),
                     (13, 8, 4, 256, 3, True))))


def k1_variants(lib, dev, gen) -> None:
    mats = cs.smoke_matrices(np.random.default_rng(cs.SEED))
    L = cs.MAIN_L
    for name in ("reed_sol_van 3x8", "decode 8x8 {1,4,9}"):
        M = mats[name]
        r, c = M.shape
        op = ec_kernels.RegionMatmul(M, kernel="pallas", device=dev)
        x = torch.randint(0, 256, (c, L), dtype=torch.uint8, device=dev,
                          generator=gen)
        want = op(x)
        coef, tab = op._device_state()
        nbytes = (r + c) * L
        src = torch.randint(0, 256, (nbytes // 2,), dtype=torch.uint8,
                            device=dev, generator=gen)
        ms = cs.cuda_ms(lambda: op(x), N_TIME)
        copy_ms = cs.cuda_ms(lambda: torch.empty_like(src).copy_(src), N_TIME)
        out = [f"library {ms:.4f} ({nbytes / ms / 1e6:.1f} GB/s)",
               f"copy of the same bytes {copy_ms:.4f}"]
        for mode, what, product in K1_VARIANTS:
            y = torch.empty((r, L), dtype=torch.uint8, device=dev)
            ms = timed(lambda: lib.variant_bitterm(
                x.data_ptr(), y.data_ptr(), coef.data_ptr(), tab.data_ptr(),
                r, c, L // 4, mode))
            same = ("equal" if torch.equal(y, want) else "DIFFERS") \
                if product else "not the product"
            if same == "DIFFERS":
                raise AssertionError(f"K1 variant {what} on {name} differs")
            out.append(f"{what} {ms:.4f} ({same})")
        print(f"[K1] {name} at {L >> 20} MiB/row (ms): " + "; ".join(out),
              flush=True)
        del x, src, want


def k2_variants(lib, dev, gen) -> None:
    mats = cs.smoke_matrices(np.random.default_rng(cs.SEED))
    L = cs.MAIN_L
    for name in ("reed_sol_van 3x8", "decode 8x8 {1,4,9}"):
        M = mats[name]
        r, c = M.shape
        op = ec_kernels.RegionMatmul(M, kernel="bitxor", device=dev)
        k1 = ec_kernels.RegionMatmul(M, kernel="pallas", device=dev)
        x = torch.randint(0, 256, (c, L), dtype=torch.uint8, device=dev,
                          generator=gen)
        want = op(x)
        ptr, idx, _plan = op._device_state()
        out = [f"library {cs.cuda_ms(lambda: op(x), N_TIME):.4f}",
               f"K1 {cs.cuda_ms(lambda: k1(x), N_TIME):.4f}"]
        for mode, batch, what in ((0, 2, "2 rows in flight"),
                                  (0, 4, "4 rows in flight"),
                                  (0, 8, "8 rows in flight (the library's)"),
                                  (1, 8, "input phase only"),
                                  (2, 8, "output phase only"),
                                  (3, 8, "no transposes")):
            y = torch.empty((r, L), dtype=torch.uint8, device=dev)
            ms = timed(lambda: lib.variant_bitxor(
                x.data_ptr(), y.data_ptr(), ptr.data_ptr(), idx.data_ptr(),
                r, c, idx.shape[0], L // 4, mode, batch))
            same = ("equal" if torch.equal(y, want) else "DIFFERS") \
                if mode == 0 else "not the product"
            if same == "DIFFERS":
                raise AssertionError(f"K2 variant {what} on {name} differs")
            out.append(f"{what} {ms:.4f} ({same})")
        print(f"[K2] {name} at {L >> 20} MiB/row (ms): " + "; ".join(out),
              flush=True)


#: K3 variants: (mode of variant_sched, blocks per SM, what)
K3_VARIANTS = ((0, 8, "the library's knobs through the variant entry"),
               (1, 8, "8 loads in flight"), (2, 8, "256-thread blocks"),
               (3, 8, "__launch_bounds__(128, 5)"),
               (4, 8, "streaming stores"),
               *((0, n, f"{n} blocks/SM") for n in (1, 2, 4, 16, 64)),
               (5, 8, "sparse switch"), (6, 8, "memory pattern only"))


def k3_variants(lib, dev, gen, size: int = 80 << 20) -> None:
    for label, technique, k, erased in (cs.PACKET_CASES[0],
                                        cs.PACKET_CASES[4]):
        B, w, codec = cs.packet_matrix(technique, k, erased)
        op = ec_kernels.ScheduledXor(B, device=dev, w=w)
        Lc = codec.get_chunk_size(size)
        x = torch.randint(0, 256, (op.c, Lc), dtype=torch.uint8, device=dev,
                          generator=gen)
        want = op(x)
        ptr, ent, plan = op._device_state()
        nbytes = (op.c + op.r) * Lc
        ms = cs.cuda_ms(lambda: op(x), N_TIME)
        out = [f"library {ms:.4f} ({nbytes / ms / 1e6:.1f} GB/s)"]
        for mode, per_sm, what in K3_VARIANTS:
            y = torch.empty((op.r, Lc), dtype=torch.uint8, device=dev)
            ms = timed(lambda: lib.variant_sched(
                x.data_ptr(), y.data_ptr(), ptr.data_ptr(), ent.data_ptr(),
                plan.rows, ent.shape[0], w, Lc // 4, mode, per_sm))
            same = ("equal" if torch.equal(y, want) else "DIFFERS") \
                if mode != 6 else "not the product"
            if same == "DIFFERS":
                raise AssertionError(f"K3 variant {what} on {label} differs")
            out.append(f"{what} {ms:.4f} ({nbytes / ms / 1e6:.1f} GB/s, "
                       f"{same})")
        print(f"[K3] {label} ({int(B.sum())} ones), object of {size >> 20} "
              f"MiB (ms): " + "; ".join(out), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(f"[device] {cs.nvidia_smi('name,power.limit')}", flush=True)
    lib = build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 5)
    cuda_lib.build()
    sass_opcodes(cuda_lib.so_path())
    k1_variants(lib, dev, gen)
    k2_variants(lib, dev, gen)
    k3_variants(lib, dev, gen)
    print(f"[device] after timing: "
          f"{cs.nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
