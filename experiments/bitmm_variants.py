#!/usr/bin/env python3
"""Race variants of the port's G4 kernel (gf_bitmm, the ``mxu``
realization) beside the library's own, on one CUDA card.

    python3 experiments/bitmm_variants.py

Run from the root of a checkout on a machine with an H100.  It builds
experiments/bitmm_variants.cu (which includes the library's source) and
experiments/bitmm_wgmma.cu with nvcc, one process each, into
ceph_tpu_torch/build/, prints their ptxas registers and spills and the
SASS opcode mix, by pipe, of the library's kernels and of the first
design (per loop: one group of 4 output rows over one 256-column tile
for the word kernel, over one 128-column tile for the column kernel, one
output row over one 128-column tile for the first design; cuobjdump),
then CUDA-event medians of 30 launches on (c, 8 MiB), at the 3x8
reed_sol_van encode, the 8x8 decode {1,4,9} and random 4x16 and 4x32
matrices, of:

- the library (through its wrapper) and (a) the first design (the
  library's kernel before the redesign, as it was);
- (e) copies of the word kernel (c <= 8) at the library's setting and
  at others (blocks an SM, prefetch, the shift-adds forced onto the FMA
  pipe) and of the column kernel (the library's for c > 8) on one half
  of K (m16n8k128) or both, at other settings, at c <= 8 too;
- (d) the integer work alone: each kernel's loop with its products
  replaced by XORs of their operands;
- (c) the word kernel's loads alone, with and without the prefetch;
- a device copy of the input rows, for scale;

then (b) the binary mma.sync rate (m16n8k256 and m16n8k128 on register
operands) and (f) the wgmma m64n64k256 b1 rate, if ptxas takes it (else
its refusal).  Every variant that computes G4 is held to the plain
version (torch.equal) at every shape on 8 MiB and on a ragged
100,000-column input; a variant that differs is reported and timed, and
the script exits 1 after the race.  Exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ceph_tpu_torch.ops import cuda_lib, ec_kernels, gf256  # noqa: E402

SOURCES = {"variants": os.path.join(REPO, "experiments",
                                    "bitmm_variants.cu"),
           "wgmma": os.path.join(REPO, "experiments", "bitmm_wgmma.cu")}
N_TIME = 30
RAGGED_L = 100_000
#: input rows of the wider matrices (4 output rows) timed at more k-steps
WIDE_COLUMNS = (16, 32)
#: labels of the variant entry's word-kernel candidates (kCandidates in
#: bitmm_variants.cu, c <= 8), whether each computes G4
CANDIDATES = (
    ("word kernel copy at the library's setting (3 blocks/SM, prefetch, "
     "shift-adds left to the compiler)", True),
    ("word kernel, 2 blocks/SM", True),
    ("word kernel, 4 blocks/SM", True),
    ("word kernel, no prefetch", True),
    ("word kernel, 4 blocks/SM, no prefetch", True),
    ("word kernel, shift-adds forced onto the FMA pipe (opaque "
     "multipliers)", True),
    ("(d) word kernel's integer work alone: products replaced by XORs",
     False),
)
#: the same for the column kernel (kColumnCandidates): label, halves of
#: K it reads (one: m16n8k128, c <= 16), whether it computes G4
COLUMN_CANDIDATES = (
    ("column kernel, one half of K (m16n8k128), 2 blocks/SM (the "
     "library's setting for 8 < c <= 16)", 1, True),
    ("column kernel, both halves (m16n8k256), 2 blocks/SM (the library's "
     "for c > 16)", 2, True),
    ("column kernel, one half, 3 blocks/SM", 1, True),
    ("column kernel, both halves, 3 blocks/SM", 2, True),
    ("column kernel, one half, no prefetch", 1, True),
    ("(d) column kernel's integer work alone: products replaced by XORs",
     1, False),
)
#: the library's kernels in their mangled names
LIB_KERNELS = {
    "word kernel (one group of 4 rows x one 256-column tile)":
        "_ZN2g414gf_bitmm_wordsE",
    "column kernel, one half of K (one group x one 128-column tile)":
        "_ZN2g416gf_bitmm_columnsILi1EE",
    "column kernel, both halves of K (one group x one 128-column tile)":
        "_ZN2g416gf_bitmm_columnsILi2EE",
}

#: SASS opcodes by the pipe that issues them (sm_90)
PIPES = {
    "fma": ("IMAD", "FFMA", "FMUL", "FADD", "IDP"),
    "alu": ("LOP3", "LOP", "PRMT", "SHF", "IADD3", "LEA", "ISETP", "SEL",
            "MOV", "VIADD", "IABS", "PLOP3", "FLO", "POPC", "BREV",
            "IMNMX", "VIMNMX", "ISCADD"),
    "tensor": ("BMMA", "HMMA", "IMMA"),
}


@functools.lru_cache(maxsize=16)
def first_plan(key: bytes, shape: tuple[int, int]) -> np.ndarray:
    """The first design's fragment table: (r, 2, 32) words, bit 8 e + s
    of register h of lane (n, t) for output row i being
    bitmatrix(M)[8 i + n, 8 (16 h + 4 t + e) + s], zero past 8 c."""
    M = np.frombuffer(key, dtype=np.uint8).reshape(shape)
    r, c = shape
    B = np.zeros((8 * r, 256), dtype=np.uint64)
    B[:, :8 * c] = gf256.bitmatrix(M)
    words = (B.reshape(r, 8, 2, 4, 32) << np.arange(32, dtype=np.uint64)
             ).sum(-1)
    return np.ascontiguousarray(
        words.transpose(0, 2, 1, 3).reshape(r, 2, 32).astype(np.uint32))


def build() -> dict[str, ctypes.CDLL | str]:
    """Both sources, one nvcc each, started together.  Returns name ->
    the loaded library, or the compiler's message where it refused."""
    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        so = os.path.join(cuda_lib.BUILD, f"libbitmm_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out: dict[str, ctypes.CDLL | str] = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            out[name] = log.strip()
            continue
        for ln in log.splitlines():
            if any(w in ln for w in ("registers", "Compiling entry",
                                     "spill")):
                print(f"[build] {name}: {ln.strip()}")
        out[name] = ctypes.CDLL(so)
    if isinstance(out["variants"], str):
        raise cuda_lib.CudaBuildError(out["variants"])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = out["variants"]
    for fn, res, args in (
            ("cand_bitmm", I, [I, I, P, P, P, I, I, LL, P]),
            ("cand_count", I, [I]),
            ("first_bitmm", I, [I, P, P, P, I, I, LL, P]),
            ("products", I, [I, P, I, I, P]),
            ("loads_blocks", LL, [LL]),
            ("loads", I, [I, P, P, I, LL, P])):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    if not isinstance(out["wgmma"], str):
        out["wgmma"].wgmma_products.restype = I
        out["wgmma"].wgmma_products.argtypes = [P, I, I, P]
    if (lib.cand_count(0), lib.cand_count(1)) != (len(CANDIDATES),
                                                  len(COLUMN_CANDIDATES)):
        raise AssertionError("the candidate lists and kCandidates disagree")
    return out


def sass_functions(so: str) -> dict[str, list[tuple[str, str]]]:
    """Function name -> its SASS as (opcode, branch target or label)
    rows, from cuobjdump; a label row has opcode ':'."""
    tool = os.path.join(os.path.dirname(cuda_lib.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True).stdout
    funcs: dict[str, list] = {}
    rows = None
    for ln in text.splitlines():
        s = ln.strip()
        if "Function :" in s:
            rows = funcs.setdefault(s.split("Function :")[1].strip(), [])
            continue
        if rows is None:
            continue
        if s.startswith(".L") and s.endswith(":"):
            rows.append((":", s[:-1]))
            continue
        if not s.startswith("/*") or "*/" not in s:
            continue
        addr = s[2:s.index("*/")]
        body = s.split("*/", 1)[1].strip().lstrip("{").strip()
        if not body or body.startswith("/*"):
            continue
        rows.append((":", f"0x{int(addr, 16):x}"))
        words = body.replace(";", " ").split()
        op = words[1] if words[0].startswith("@") else words[0]
        target = ""
        if op.startswith("BRA"):
            hit = re.search(r"(\.L\w+|0x[0-9a-fA-F]+)",
                            body.split("BRA", 1)[1].split(";")[0])
            target = hit.group(1) if hit else ""
            if target.startswith("0x"):
                target = f"0x{int(target, 16):x}"
        rows.append((op.split(".")[0], target))
    return funcs


def loop_mix(rows: list[tuple[str, str]]) -> list[dict[str, int]]:
    """Opcode counts of the innermost loop that issues tensor products and
    of the loop around it less that one: [inner, outer]."""
    at: dict[str, int] = {}
    for i, (op, arg) in enumerate(rows):
        if op == ":":
            at.setdefault(arg, i)
    loops = sorted(((at[arg], i) for i, (op, arg) in enumerate(rows)
                    if op == "BRA" and arg in at and at[arg] < i),
                   key=lambda ab: ab[1] - ab[0])

    def counts(a, b, skip=None):
        out: dict[str, int] = {}
        for i in range(a, b + 1):
            op = rows[i][0]
            if op != ":" and not (skip and skip[0] <= i <= skip[1]):
                out[op] = out.get(op, 0) + 1
        return out

    inner = next((ab for ab in loops
                  if any(rows[i][0] in PIPES["tensor"]
                         for i in range(ab[0], ab[1] + 1))), None)
    if inner is None:
        return []
    outer = next((ab for ab in loops if ab[0] <= inner[0]
                  and ab[1] >= inner[1] and ab != inner), None)
    mixes = [counts(*inner)]
    if outer is not None:
        mixes.append(counts(*outer, skip=inner))
    return mixes


def pipes(mix: dict[str, int]) -> str:
    tally = {p: sum(n for op, n in mix.items() if op in ops)
             for p, ops in PIPES.items()}
    tally["other"] = sum(mix.values()) - sum(tally.values())
    return ", ".join(f"{p} {n}" for p, n in tally.items())


def print_sass(so: str) -> None:
    funcs = sass_functions(so)
    if not funcs:
        print("[sass] no cuobjdump beside nvcc")
        return
    picks = {label: (lambda n, k=key: k in n) for label, key in
             LIB_KERNELS.items()}
    picks["first design (one output row x one 128-column tile)"] = (
        lambda n: "5first" in n and "gf_bitmm_kernel" in n
        and "TensorMma" in n)
    for label, want in picks.items():
        name = next((n for n in funcs if want(n)), None)
        if name is None:
            print(f"[sass] {label}: not found")
            continue
        mixes = loop_mix(funcs[name])
        for what, mix in zip(("loop", "around it"), mixes):
            text = ", ".join(f"{k} {v}" for k, v in
                             sorted(mix.items(), key=lambda kv: -kv[1]))
            print(f"[sass] {label}, {what}: {sum(mix.values())} "
                  f"instructions ({pipes(mix)}): {text}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def race(lib, dev, gen, label: str, M: np.ndarray, wrong: list) -> None:
    """Every variant that runs M: the computing ones held to the plain
    version at (c, 8 MiB) and (c, RAGGED_L) (differences appended to
    ``wrong``), then all timed at (c, 8 MiB)."""
    r, c = M.shape
    stream = _stream(dev)

    def table(frag):
        return torch.from_numpy(np.ascontiguousarray(frag, dtype=np.uint32)
                                .view(np.int32)).to(dev)

    plan = ec_kernels.bitmm_plan(M)
    lib_frag = table(plan.frag)
    words = table(ec_kernels._bitmm_word_frag(M)) if c <= 8 else None
    columns = table(ec_kernels._bitmm_column_frag(M))
    old = table(first_plan(M.tobytes(), M.shape))
    outs: dict[tuple, torch.Tensor] = {}

    def out(key, L):
        if (key, L) not in outs:
            outs[key, L] = torch.empty((r, L), dtype=torch.uint8, device=dev)
        return outs[key, L]

    def entry(key, fn):
        """make(x, L) -> a launch writing out(key, L), returning it."""
        def make(x, L):
            y = out(key, L)

            def go():
                cuda_lib.check(fn(x.data_ptr(), y.data_ptr(), L), key)
                return y
            return go
        return make

    def library(x, L):
        y = out("library", L)

        def go():
            ec_kernels.gf_bitmm_lanes(x.view(torch.int32), None,
                                      (lib_frag, plan),
                                      out=y.view(torch.int32))
            return y
        return go

    computing = {"library": library,
                 "(a) first design": entry("first", lambda xp, yp, n:
                                           lib.first_bitmm(0, xp, yp,
                                                         old.data_ptr(), r,
                                                         c, n, stream))}
    timed_only = {"(d) first design's integer work alone: products "
                  "replaced by XORs": entry("firstx", lambda xp, yp, n:
                                            lib.first_bitmm(1, xp, yp,
                                                          old.data_ptr(), r,
                                                          c, n, stream))}
    lists = [(0, words, [(name, 1, ok) for name, ok in CANDIDATES])] \
        if words is not None else []
    lists.append((1, columns, list(COLUMN_CANDIDATES)))
    for column, frag, cands in lists:
        for i, (name, halves, computes) in enumerate(cands):
            if 16 * halves < c:
                continue
            make = entry(f"cand{column}.{i}", lambda xp, yp, n, column=column,
                         i=i, frag=frag: lib.cand_bitmm(
                             column, i, xp, yp, frag.data_ptr(), r, c, n,
                             stream))
            (computing if computes else timed_only)[f"(e) {name}" if computes
                                                    else name] = make
    data = torch.randint(0, 256, (c, cs.MAIN_L), dtype=torch.uint8,
                         device=dev, generator=gen)
    plain = ec_kernels.gf_matmul_mxu_graph(M)
    for L in (cs.MAIN_L, RAGGED_L):
        x = data[:, :L].contiguous()
        want = plain(x)
        for name, make in computing.items():
            got = make(x, L)()
            torch.cuda.synchronize(dev)
            if not torch.equal(got, want):
                wrong.append(f"{name} at {label} L={L}")
    timed = {**computing, **timed_only}
    if c <= 8:
        sink = torch.empty(lib.loads_blocks(cs.MAIN_L) * 256,
                           dtype=torch.int32, device=dev)
        for pf in (1, 0):
            timed[f"(c) the word kernel's loads alone"
                  f"{'' if pf else ', no prefetch'}"] = (
                lambda x, L, pf=pf: lambda: cuda_lib.check(lib.loads(
                    pf, x.data_ptr(), sink.data_ptr(), c, L, stream),
                    "loads"))
    timed["a device copy of the input rows"] = (
        lambda x, L: lambda: torch.empty_like(x).copy_(x))
    bound_ms, by = cs.bound(M, cs.MAIN_L)
    print(f"[bitmm] {label} on ({c}, {cs.MAIN_L >> 20} MiB): bound "
          f"{bound_ms:.4f} ms ({by})")
    for name, make in timed.items():
        ms = cs.cuda_ms(make(data, cs.MAIN_L), N_TIME)
        print(f"[bitmm] {label}: {name}: {ms:.4f} ms "
              f"({ms / bound_ms:.2f}x the bound)")
    print(f"[bitmm] after timing: "
          f"{cs.nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")


def main() -> int:
    if not torch.cuda.is_available():
        print("bitmm_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(f"[device] {cs.nvidia_smi('name,power.limit')}")
    clock_hz = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cuda_lib.build()
    libs = build()
    lib = libs["variants"]
    print_sass(os.path.join(cuda_lib.BUILD, "libbitmm_variants.so"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 9)
    mats = cs.smoke_matrices(np.random.default_rng(cs.SEED))
    shapes = [(label, mats[label]) for label in cs.TIMED_SHAPES]
    rng = np.random.default_rng(cs.SEED + 1)
    shapes += [(f"random 4x{c}", rng.integers(0, 256, (4, c), dtype=np.uint8))
               for c in WIDE_COLUMNS]
    wrong = []
    for label, M in shapes:
        race(lib, dev, gen, label, M, wrong)
    blocks, iters = sms * 8, 4096
    y = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    for k128 in (0, 1):
        ms = cs.cuda_ms(lambda: cuda_lib.check(lib.products(
            k128, y.data_ptr(), blocks, iters, _stream(dev)), "products"),
            10)
        n = blocks * 8 * iters * 8
        print(f"[products] (b) mma.sync m16n8k{128 if k128 else 256} b1, "
              f"register operands, 8 chains a warp, {blocks} blocks of 8 "
              f"warps: {n} products in {ms:.4f} ms = {n / ms / 1e9:.3f} "
              f"T/s, {sms * clock_hz * ms / 1e3 / n:.3f} SM clocks a "
              f"product at {clock_hz / 1e6:.0f} MHz")
    wg = libs["wgmma"]
    if isinstance(wg, str):
        lines = [ln for ln in wg.splitlines() if ln.strip()]
        print(f"[products] (f) wgmma m64n64k256 b1: ptxas refuses: "
              f"{' | '.join(lines[:6])}")
    else:
        wblocks, witers = sms * 4, 4096
        yw = torch.empty(wblocks * 128, dtype=torch.int32, device=dev)
        ms = cs.cuda_ms(lambda: cuda_lib.check(wg.wgmma_products(
            yw.data_ptr(), wblocks, witers, _stream(dev)), "wgmma"), 10)
        n = wblocks * witers * 32
        print(f"[products] (f) wgmma m64n64k256 b1 from shared memory, "
              f"{wblocks} warpgroups: {n} m16n8k256-sized products in "
              f"{ms:.4f} ms = {n / ms / 1e9:.3f} T/s, "
              f"{sms * clock_hz * ms / 1e3 / n:.3f} SM clocks each")
    print(f"[products] after timing: "
          f"{cs.nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    print("[bitmm] " + ("DIFFERENT: " + ", ".join(wrong) if wrong else
                        "every variant that computes G4 equals the plain "
                        "version"))
    if wrong:
        print(f"bitmm_variants: variants differ from the plain version: "
              f"{wrong}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
