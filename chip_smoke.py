#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold its
hand-written kernels against their plain versions.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA card (an
H100; the kernels are built for sm_90a).  Phases, one line each:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — nvcc builds every kernel from ceph_tpu_torch/csrc/.
3. kernels — each kernel against its plain version on the card
             (torch.equal) and against the numpy oracle, over the listed
             matrices and lengths; CUDA-event times at the main shape.
4. slice   — the ``tpu`` plugin (reed_sol_van k=8, m=3) on the card:
             encode_batch / decode_batch of 64 x 1 MiB stripes and
             encode / decode through the interface, byte-exact.
5. cli     — tools.ec_benchmark encode and decode at 80 MiB x 10.
6. corpus  — tools.ec_non_regression --check on corpus/.

Phases 4-6 are the main path: the launch counts are set to 0 before
phase 4 and read after phase 6; every kernel must have launched, the
plain versions never, and no kernel pick may have skipped a candidate.
Then one JSON line lists every kernel, and the last line is the
``{"ok": true, "device": ...}`` object.  Any failure exits nonzero, and
so does a process with no CUDA card.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ceph_tpu_torch import ec
from ceph_tpu_torch.ops import cuda_lib, ec_kernels, gf256
from ceph_tpu_torch.tools import ec_benchmark, ec_non_regression
from ceph_tpu_torch.utils.perf import kernel_profiler

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261017

#: H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12
#: 32-bit shift, logic and multiply-add results per clock per SM on
#: compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
#: instruction throughput), and warp instructions issued per clock per
#: SM (four sub-partitions, one warp instruction each)
INT32_PER_CLK_SM = 64
ISSUE_PER_CLK_SM = 4 * 32

KERNELS = {
    # realization -> (kernel name, launch counter, plain version, TPU site)
    "pallas": ("gf_bitterm", "gf_bitterm", ec_kernels.gf_matmul_graph,
               "ceph_tpu/ops/ec_kernels.py:473"),
    "bitxor": ("gf_bitxor", "gf_bitxor", ec_kernels.gf_bitxor_graph,
               "ceph_tpu/ops/ec_kernels.py:172"),
}
SOURCE = "ceph_tpu_torch/csrc/gf_region.cu"

MAIN_L = 8 << 20  # bytes per row at the main shape: 64 x 128 KiB chunks
CLI_L = 10 << 20  # bytes per row of ec_benchmark's 80 MiB object, k=8
LENGTHS = (4, 508, 512, 32 * 1024 + 4, 100_000, MAIN_L, CLI_L)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smoke_matrices(rng: np.random.Generator) -> dict[str, np.ndarray]:
    C = gf256.vandermonde_matrix(8, 3)
    D = gf256.decode_matrix(C, 8, [0, 2, 3, 5, 6, 7, 8, 10])
    return {
        "reed_sol_van 3x8": C,
        "decode 8x8 {1,4,9}": D,
        "decode rows 2x8 {1,4}": D[[1, 4]],
        "decode row 1x8 {4}": D[[4]],
        "cauchy_good 4x8": gf256.cauchy_good_matrix(8, 4),
        "random 4x32": rng.integers(0, 256, (4, 32), dtype=np.uint8),
        "1x1": np.array([[0x8E]], dtype=np.uint8),
    }


def oracle_columns(L: int, windows: int = 128, width: int = 1024
                   ) -> np.ndarray:
    """Columns of an (r, L) result held against the numpy oracle: all of
    them up to 32 KiB + 4, else ``windows`` runs of ``width`` bytes spread
    evenly over the row and the row's last ``width`` bytes, so every
    grid-stride pass of either kernel is sampled."""
    if L <= windows * width:
        return np.arange(L)
    starts = [k * L // windows // 16 * 16 for k in range(windows)]
    return np.concatenate([np.arange(s, s + width) for s in starts]
                          + [np.arange(L - width, L)])


def bound_parts(M: np.ndarray, L: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of the function M @ (c, L) over
    GF(2^8), whichever kernel computes it: each input byte read once and
    each output byte written once at the HBM rate; the product as a
    GF(2) bit-matrix product (an AND and an XOR per nonzero entry of
    gf256.bitmatrix(M), per byte column) at the int8 tensor-core rate,
    the card's fastest for operations of that width."""
    r, c = M.shape
    t_bytes = (r + c) * L / HBM_BYTES_PER_S
    t_ops = 2 * int(gf256.bitmatrix(M).sum()) * L / INT8_OPS_PER_S
    return t_bytes * 1e3, t_ops * 1e3


def bound(M: np.ndarray, L: int) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of bound_parts."""
    t_bytes, t_ops = bound_parts(M, L)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bitterm_mix(M: np.ndarray) -> tuple[int, int]:
    """gf_bitterm's instructions per 32-bit lane column as its source
    writes them: (shift/logic ops, multiply-adds).  A coefficient 1 is
    one XOR; any other nonzero one is 7 shifts, 8 ANDs and 8 XORs
    around 8 multiplies."""
    M = np.asarray(M)
    general = int(((M != 0) & (M != 1)).sum())
    return int((M == 1).sum()) + 23 * general, 8 * general


def bitterm_floor_ms(M: np.ndarray, L: int, sms: int, clock_hz: float
                     ) -> float:
    """The least time of gf_bitterm's own instruction mix: shifts and
    logic on the ALU pipe, multiply-adds on the FMA pipe, each at
    INT32_PER_CLK_SM, and all of them at the issue rate."""
    alu, imad = bitterm_mix(M)
    lanes = L // 4
    per_s = sms * clock_hz
    return 1e3 * lanes * max(alu / (INT32_PER_CLK_SM * per_s),
                             imad / (INT32_PER_CLK_SM * per_s),
                             (alu + imad) / (ISSUE_PER_CLK_SM * per_s))


def cuda_ms(fn, n: int, warm: int = 3) -> float:
    """Median CUDA-event time (ms) of ``n`` back-to-back launches.  The
    card first sleeps for about 50 ms while the host queues every
    launch, so no host gap between two launches lands inside a window."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(100_000_000)  # clock cycles
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> float:
    """Print the card's name and power limit; return its top SM clock
    (Hz), which the instruction floor of gf_bitterm needs."""
    say("device", f"nvidia-smi: {nvidia_smi('name,power.limit')}")
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"{torch.cuda.get_device_name(0)} "
                  f"x{torch.cuda.device_count()}, "
                  f"{torch.cuda.get_device_properties(0).multi_processor_count}"
                  f" SMs at up to {mhz:.0f} MHz")
    return mhz * 1e6


def phase_build() -> None:
    t0 = time.perf_counter()
    built = cuda_lib.build()
    say("build", f"{time.perf_counter() - t0:.2f} s "
                 f"({'nvcc ran' if built is not None else 'up to date'})")
    for ln in cuda_lib.BUILD_LOG.get("ptxas", "").splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            say("build", ln.strip())


def phase_kernels(dev: torch.device, rng: np.random.Generator,
                  clock_hz: float, lengths=LENGTHS, main_l: int = MAIN_L,
                  n_time: int = 30) -> dict[str, dict]:
    """Every kernel against its plain version (equal bytes, all columns)
    and the numpy oracle (oracle_columns); then CUDA-event times at the
    main shape."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = {}
    mats = smoke_matrices(rng)
    for realization, (name, _ctr, plain_of, site) in KERNELS.items():
        err = 0
        cases = 0
        for label, M in mats.items():
            op = ec_kernels.RegionMatmul(M, kernel=realization, device=dev)
            plain = plain_of(M)
            for L in lengths:
                data = torch.randint(0, 256, (M.shape[1], L),
                                     dtype=torch.uint8, device=dev,
                                     generator=gen)
                got = op(data)
                want = plain(data)
                torch.cuda.synchronize(dev)
                diff = int((got.int() - want.int()).abs().max())
                err = max(err, diff)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{name} {label} L={L}: differs from its plain "
                        f"version (max abs err {diff})")
                cols = torch.from_numpy(oracle_columns(L)).to(dev)
                oracle = gf256.encode_region(M, data[:, cols].cpu().numpy())
                if not np.array_equal(got[:, cols].cpu().numpy(), oracle):
                    raise AssertionError(
                        f"{name} {label} L={L}: differs from the oracle")
                cases += 1
        M = mats["reed_sol_van 3x8"]
        op = ec_kernels.RegionMatmul(M, kernel=realization, device=dev)
        data = torch.randint(0, 256, (M.shape[1], main_l),
                             dtype=torch.uint8, device=dev, generator=gen)
        x32 = data.view(torch.int32)
        ms = cuda_ms(lambda: op.encode_lanes(x32), n_time)
        plain = plain_of(M)
        plain_ms = cuda_ms(lambda: plain(data), max(5, n_time // 4), warm=1)
        clocks = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
        bound_ms, bound_by = bound(M, main_l)
        t_bytes, t_ops = bound_parts(M, main_l)
        nbytes = sum(M.shape) * main_l
        say("kernels", f"{name}: {cases} cases equal to the plain version "
                       f"and the oracle; 3x8 at {main_l >> 20} MiB/row: "
                       f"{ms:.4f} ms = {nbytes / ms / 1e6:.1f} GB/s, "
                       f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                       f"({bound_by}; bytes {t_bytes:.4f}, operations "
                       f"{t_ops:.4f}), {ms / bound_ms:.2f}x the bound; "
                       f"after timing: {clocks}")
        if realization == "pallas":
            alu, imad = bitterm_mix(M)
            floor = bitterm_floor_ms(
                M, main_l, torch.cuda.get_device_properties(
                    dev).multi_processor_count, clock_hz)
            say("kernels", f"{name}: its own instruction mix ({alu} "
                           f"shift/logic + {imad} multiply-add per lane) "
                           f"needs at least {floor:.4f} ms at the top "
                           f"clock, {ms / floor:.2f}x of it")
        results[realization] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": site, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}
    return results


def phase_slice(dev: torch.device, rng: np.random.Generator,
                batch: int = 64, chunk: int = 128 * 1024) -> None:
    """The tpu plugin's encode/decode through its entry points."""
    codec = ec.factory("tpu", {"k": "8", "m": "3", "device": str(dev)})
    C = codec.matrix
    stripes = rng.integers(0, 256, (batch, 8, chunk), dtype=np.uint8)
    t0 = time.perf_counter()
    parity = codec.encode_batch(stripes)
    dt = time.perf_counter() - t0
    folded = stripes.transpose(1, 0, 2).reshape(8, batch * chunk)
    oracle = gf256.encode_region(C, folded).reshape(3, batch, chunk)
    if not np.array_equal(parity, oracle.transpose(1, 0, 2)):
        raise AssertionError("encode_batch differs from the oracle")
    say("slice", f"encode_batch {batch} x {8 * chunk >> 20} MiB stripes: "
                 f"byte-exact ({dt:.3f} s with the kernel race)")
    full = np.concatenate([stripes, parity], axis=1)
    for erased in ((1, 4, 9), (0, 1, 2), (8, 9, 10), (7,)):
        avail = {i: full[:, i, :] for i in range(11) if i not in erased}
        out = codec.decode_batch(list(erased), avail)
        for i in erased:
            if not np.array_equal(out[i], full[:, i, :]):
                raise AssertionError(f"decode_batch {erased}: chunk {i}")
        say("slice", f"decode_batch erasures {set(erased)}: byte-exact")
    obj = rng.integers(0, 256, batch * 8 * chunk // 64,
                       dtype=np.uint8).tobytes()
    chunks = codec.encode(obj)
    flat = np.frombuffer(obj, dtype=np.uint8)
    data = codec.encode_prepare(flat)
    oracle = gf256.encode_region(C, data)
    for i in range(11):
        want = data[i] if i < 8 else oracle[i - 8]
        if not np.array_equal(chunks[i], want):
            raise AssertionError(f"encode: chunk {i} differs")
    out = codec.decode([1, 4, 9], {i: c for i, c in chunks.items()
                                   if i not in (1, 4, 9)})
    if not all(np.array_equal(out[i], chunks[i]) for i in (1, 4, 9)):
        raise AssertionError("decode through the interface differs")
    say("slice", f"encode/decode of a {len(obj) >> 10} KiB object "
                 "through the interface: byte-exact")
    say("slice", f"kernel picks: {json.dumps(codec.kernel_picks())}")


def phase_cli(dev: torch.device, size: int = 80 << 20,
              iterations: int = 10) -> None:
    """tools.ec_benchmark encode and decode (its data is constant, as
    the reference's is), then a byte check of the same codec path at the
    same size on random data."""
    common = ["--plugin", "tpu", "-P", "k=8", "-P", "m=3",
              "--size", str(size), "--iterations", str(iterations),
              "--device", str(dev)]
    for extra in (["--workload", "encode"],
                  ["--workload", "decode", "--erasures", "3"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ec_benchmark.main(common + extra)
        if rc != 0:
            raise AssertionError(f"ec_benchmark {extra} exit {rc}")
        say("cli", f"ec_benchmark {' '.join(extra)}: "
                   f"{buf.getvalue().strip()}")
    rng = np.random.default_rng(SEED)
    codec = ec.factory("tpu", {"k": "8", "m": "3", "device": str(dev)})
    data = rng.integers(0, 256, size, dtype=np.uint8)
    chunks = codec.encode(data)
    prepared = codec.encode_prepare(data)
    cols = oracle_columns(prepared.shape[1])
    oracle = gf256.encode_region(codec.matrix, prepared[:, cols])
    for i in range(8, 11):
        if not np.array_equal(chunks[i][cols], oracle[i - 8]):
            raise AssertionError(f"{size >> 20} MiB encode: parity {i} "
                                 "differs from the oracle")
    for erased in ((0, 5, 10), (3,)):
        out = codec.decode(list(erased), {i: c for i, c in chunks.items()
                                          if i not in erased})
        if not all(np.array_equal(out[i], chunks[i]) for i in erased):
            raise AssertionError(f"{size >> 20} MiB decode {erased} differs")
    say("cli", f"{size >> 20} MiB of random data: encode equal to the "
               f"oracle on {len(cols)} columns of every row, decodes of "
               "{0,5,10} and {3} byte-exact")


def phase_corpus(dev: torch.device) -> None:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ec_non_regression.main(
            ["--check", "--base", os.path.join(REPO, "corpus"),
             "--device", str(dev)])
    if rc != 0:
        raise AssertionError(f"ec_non_regression --check exit {rc}")
    say("corpus", buf.getvalue().strip())


def main_path(dev: torch.device, rng: np.random.Generator, *,
              batch: int = 64, chunk: int = 128 * 1024,
              cli_size: int = 80 << 20, iterations: int = 10
              ) -> dict[str, int]:
    """Phases 4-6 with the launch counts set to 0 before and read
    after; returns the counts."""
    ec_kernels.reset_launches()
    phase_slice(dev, rng, batch, chunk)
    phase_cli(dev, cli_size, iterations)
    phase_corpus(dev)
    return ec_kernels.launch_counts()


def check_main_path(counts: dict[str, int], realizations=KERNELS) -> None:
    say("launches", json.dumps(counts))
    for realization in realizations:
        ctr = KERNELS[realization][1]
        if counts[ctr] <= 0:
            raise AssertionError(f"{ctr} never launched on the main path")
    if counts["plain"]:
        raise AssertionError(
            f"a plain version ran {counts['plain']} times on the main path")
    picks = kernel_profiler().picks()
    skipped = {s: p["skipped"] for s, p in picks.items() if p["skipped"]}
    if skipped:
        raise AssertionError(f"kernel picks skipped candidates: {skipped}")
    say("launches", f"{len(picks)} kernel picks, none skipped: "
                    + json.dumps({s: p["picked"] for s, p in picks.items()}))


def profile_line(wall_s: float) -> None:
    """Where the main path's wall time went, from the codec's kernel
    profiler: first launches (device tables, library load), launches
    (kernel + synchronize) and device->host copies."""
    tot = {k: [0, 0.0] for k in ("compile", "device", "sync")}
    for agg in kernel_profiler().dump()["signatures"].values():
        for k, v in tot.items():
            v[0] += agg[k]
            v[1] += agg[f"{k}_seconds"]
    say("profile", f"main path {wall_s:.3f} s wall; " + ", ".join(
        f"{k} {n} x {sec:.4f} s" for k, (n, sec) in tot.items())
        + "; the rest is host work (copies to the card, numpy)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    clock_hz = phase_device()
    phase_build()
    kernels = phase_kernels(dev, rng, clock_hz)
    t_main = time.perf_counter()
    counts = main_path(dev, rng)
    profile_line(time.perf_counter() - t_main)
    check_main_path(counts)
    for realization, row in kernels.items():
        row["launches"] = counts[KERNELS[realization][1]]
    say("done", f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
