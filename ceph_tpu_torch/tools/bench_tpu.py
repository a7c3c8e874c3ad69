"""Device-side EC kernel bench of the PyTorch port: the batched encode
(or decode) of the headline configuration through each hand-written
region kernel, one JSON line.

The twin of the JAX package's ``ceph_tpu/tools/bench_tpu.py``, with the
same flags, defaults and JSON keys (``backend`` is ``cuda``, and the line
adds ``device`` and ``power_limit`` from nvidia-smi).  ``--device cuda``
(the default) raises with no card; ``--device cpu`` runs the kernels'
plain versions and the plain ``xla`` candidate.  Nothing is compiled per
shape, so the reference's ``--cache-dir`` has no counterpart.

Legs, GB/s counting source data bytes as 2^30 bytes a second (the
reference tool's convention, ceph_erasure_code_benchmark.cc:193):

- kernel_gbps: lanes resident on the card -> parity on the card.  The
  candidates are the realizations of ops/ec_kernels.KERNELS that
  ``kernel_supports`` lets run the matrix (``pallas`` K1, ``bitxor`` K2,
  ``mxu`` G4; and ``xla`` on the CPU).  Timed launch i reads staged buffer i of reps + 1
  distinct ones; CUDA events bracket the launch alone (the card first
  sleeps while the host queues every rep), and the launch's parity
  digest (the sum of its uint32 words, plus the csums with ``--csum``)
  is taken after the end event and checked against the native oracle's.
  On the CPU the host clock brackets the launch.
- staging_gbps: host -> device through utils/staging.device_put_landed
  (pinned buffer, landing forced), each copy timed on its own, median.
- e2e_gbps: host bytes in -> the whole parity (and csums) back on the
  host, byte-exact against the oracle, median of the warm shots.

Deliberate difference: the reference drops a candidate that raises or
gives a wrong digest and carries on; here that ends the run with a
nonzero exit (no fallback hides a kernel).  Only ``kernel_supports``
leaves a candidate out, as in the codecs' race.

    python -m ceph_tpu_torch.tools.bench_tpu            # k=8 m=3, 1 MiB
    python -m ceph_tpu_torch.tools.bench_tpu --device cpu --stripe-bytes \\
        4096 --batch 2 --reps 1 --csum
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import ec_kernels, gf256, native
from ..utils import staging

#: host buffers the e2e leg reserves (shot 0 warms)
E2E_SHOTS = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--m", type=int, default=3)
    p.add_argument("--stripe-bytes", type=int, default=1024 * 1024)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--technique", default="reed_sol_van")
    p.add_argument("--kernel", default="auto",
                   choices=["auto", "pallas", "xla", "mxu", "bitxor"],
                   help="pallas = K1 gf_bitterm; bitxor = K2 gf_bitxor; "
                        "mxu = G4 gf_bitmm; xla = the plain version (CPU "
                        "only); auto = time every viable one, keep the "
                        "fastest")
    p.add_argument("--skip-e2e", action="store_true",
                   help="skip the end-to-end leg")
    p.add_argument("--candidate-budget", type=float, default=150.0,
                   help="soft per-candidate budget (s) of the timed reps "
                        "on the CPU: they stop once it is spent (one "
                        "always runs); on the card every rep runs")
    p.add_argument("--workload", default="encode",
                   choices=["encode", "decode"],
                   help="decode = reconstruct m erased shards from k "
                        "survivors (the recovery hot path)")
    p.add_argument("--csum", action="store_true",
                   help="time the fused op (region kernel + CRC32C of "
                        "every chunk, data and parity) instead")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) needs a card; cpu runs the plain "
                        "versions")
    return p, p.parse_args(argv)


def working_matrix(k: int, m: int, technique: str,
                   workload: str) -> np.ndarray:
    """The encode matrix, or for ``decode`` the e x k block of the
    inverted survivor rows with e = min(m, k) data shards lost (the
    reference tool's rule)."""
    if technique == "reed_sol_van":
        M = gf256.vandermonde_matrix(k, m)
    elif technique == "cauchy_good":
        M = gf256.cauchy_good_matrix(k, m)
    else:
        M = gf256.cauchy_matrix(k, m)
    if workload != "decode":
        return M
    e = min(m, k)
    avail = list(range(e, k)) + list(range(k, k + e))
    return gf256.decode_matrix(M, k, avail)[:e]


def _smi(query: str) -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def _digest(y: torch.Tensor, cs=None) -> torch.Tensor:
    """Sum of the uint32 words of ``y`` (plus those of ``cs``) mod 2^32,
    as a one-element int64 tensor on their device."""
    words = y.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    total = words.sum()
    if cs is not None:
        total = total + (cs.contiguous().view(torch.int32).to(torch.int64)
                         & 0xFFFFFFFF).sum()
    return total & 0xFFFFFFFF


def _host_digest(par: np.ndarray, cs=None) -> int:
    s = int(np.sum(par.view(np.uint32), dtype=np.uint64))
    if cs is not None:
        s += int(np.sum(cs, dtype=np.uint64))
    return s & 0xFFFFFFFF


def _candidate(name: str, W: np.ndarray, chunk: int, csum: bool, dev):
    """fn(staged (k, cols) uint8) -> (parity (r, cols), csums or None)
    for one realization, and prep(staged) -> its input: the (k + r, cols)
    stack with the data rows first for ``--csum`` (the caller's scratch,
    so the timed window holds the two kernels alone)."""
    k, r = W.shape[1], W.shape[0]
    if not csum:
        op = ec_kernels.RegionMatmul(W, kernel=name, device=dev)

        def run(x):
            return op.encode_lanes(x.view(torch.int32)).view(torch.uint8), None

        return run, lambda staged: staged
    from ..models.stripe_codec import StripeCodec

    codec = StripeCodec.__new__(StripeCodec)
    codec.k, codec.m, codec.matrix = k, r, W
    fused = codec.encode_csum_graph(chunk, kernel=name)

    def prep(staged):
        stack = torch.empty((k + r, staged.shape[1]), dtype=torch.uint8,
                            device=staged.device)
        stack[:k] = staged
        return stack

    return fused, prep


def main(argv=None) -> int:
    p, args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_tpu: --device cuda but torch.cuda.is_available() is "
              "False (pass --device cpu to run the plain versions)",
              file=sys.stderr)
        return 2
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    W = working_matrix(args.k, args.m, args.technique, args.workload)
    k, r = args.k, int(W.shape[0])
    chunk = args.stripe_bytes // k
    cols = args.batch * chunk  # stripes fold into the column axis
    quantum = 512 if cols <= 4 * ec_kernels.RegionMatmul.BLOCK \
        else 4 * ec_kernels.RegionMatmul.BLOCK
    cols += (-cols) % quantum  # whole tiles (encode_lanes' contract)
    if args.csum and (cols % chunk or chunk % 4):
        p.error("--csum: the tile rounding broke the chunk boundary; "
                "pick a power-of-two stripe size")
    names = [n for n in ec_kernels.KERNELS if args.kernel in ("auto", n)
             and ec_kernels.kernel_supports(n, W, device=dev)]
    if not names:
        print(f"bench_tpu: no candidate of {args.kernel!r} can run a "
              f"{r}x{k} matrix on {dev}", file=sys.stderr)
        return 1
    on_card = dev.type == "cuda"

    def progress(msg: str) -> None:
        print(f"bench_tpu: {msg}", file=sys.stderr, flush=True)

    # ---- round trip: a one-element result back on the host -------------
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    rtts = []
    for i in range(6):
        t0 = time.perf_counter()
        int((one + i).item())
        rtts.append(time.perf_counter() - t0)
    rtt = statistics.median(rtts[1:])

    # ---- staging: distinct host buffers -> device, each timed ----------
    rng = np.random.default_rng(0)
    shots = 0 if args.skip_e2e else E2E_SHOTS
    hosts = [rng.integers(0, 256, (k, cols), dtype=np.uint8)
             for _ in range(args.reps + 1 + shots)]
    nbytes = hosts[0].nbytes
    progress(f"{dev}: staging {args.reps + 1} buffers of "
             f"{nbytes / 2**20:.1f} MiB")
    # bufs[i] holds hosts[i]: the first copy warms (untimed), then each
    # of the others is timed on its own
    bufs = [staging.device_put_landed(hosts[0], dev, record=False)]
    stage_dts = []
    for h in hosts[1:args.reps + 1]:
        t0 = time.perf_counter()
        bufs.append(staging.device_put_landed(h, dev))
        stage_dts.append(time.perf_counter() - t0)
    stage_med = statistics.median(stage_dts) if stage_dts else 0.0
    staging_gbps = (round(nbytes / stage_med / 2**30, 4) if stage_med > 0
                    else None)
    staging_spread = ([round(nbytes / dt / 2**30, 4)
                       for dt in sorted(stage_dts, reverse=True)]
                      if stage_dts and min(stage_dts) > 0 else None)

    # ---- the oracle's digests, one per staged buffer --------------------
    def oracle(h):
        par = (native.encode_region(W, h) if native.available()
               else gf256.encode_region(W, h))
        if not args.csum:
            return par, None
        stack = np.concatenate([h, par], axis=0)
        blocks = stack.reshape(stack.shape[0], -1, chunk)
        cs = np.array([[native.crc32c(blocks[i, b].tobytes())
                        for b in range(blocks.shape[1])]
                       for i in range(blocks.shape[0])], dtype=np.uint32)
        return par, cs

    progress("computing the oracle's digests")
    wants = [_host_digest(*oracle(h)) for h in hosts[:args.reps + 1]]

    # ---- per candidate: verify one launch, then time the reps ----------
    results = {}
    for name in names:
        fn, prep = _candidate(name, W, chunk, args.csum, dev)
        inputs = [prep(b) for b in bufs]
        progress(f"{name}: first launch + verify")
        t0 = time.perf_counter()
        got = int(_digest(*fn(inputs[-1])).item())
        first_s = time.perf_counter() - t0
        if got != wants[-1]:
            print(f"bench_tpu: {name} WRONG digest {got} != {wants[-1]}",
                  file=sys.stderr)
            return 1
        digests, times = [], []
        if on_card:
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(args.reps)]
            torch.cuda.synchronize(dev)
            torch.cuda._sleep(100_000_000)  # the host queues every rep
            for x, (start, end) in zip(inputs, events):
                start.record()
                out = fn(x)
                end.record()
                digests.append(_digest(*out))
            torch.cuda.synchronize(dev)
            times = [s.elapsed_time(e) / 1e3 for s, e in events]
        else:
            for x in inputs[:args.reps]:
                t0 = time.perf_counter()
                out = fn(x)
                times.append(time.perf_counter() - t0)
                digests.append(_digest(*out))
                if sum(times) > args.candidate_budget:
                    break
        for i, d in enumerate(digests):
            if int(d.item()) != wants[i]:
                print(f"bench_tpu: {name} rep {i} WRONG digest",
                      file=sys.stderr)
                return 1
        del inputs
        med = statistics.median(times)
        results[name] = {"kernel_gbps": nbytes / med / 2**30,
                         "compile_s": round(first_s, 6),
                         "rep_times_s": [round(t, 9) for t in times]}
        progress(f"{name}: {results[name]['kernel_gbps']:.1f} GB/s")
    best = max(results, key=lambda n: results[n]["kernel_gbps"])

    # ---- end to end: host bytes in -> the whole result on the host -----
    e2e_gbps = e2e_spread = None
    if shots:
        fn, prep = _candidate(best, W, chunk, args.csum, dev)
        e2e_dts = []
        for shot, h in enumerate(hosts[args.reps + 1:]):
            t0 = time.perf_counter()
            d = staging.device_put_landed(h, dev, force=False, record=False)
            par, cs = fn(prep(d))
            par = par.cpu().numpy()
            cs = cs.cpu().numpy() if cs is not None else None
            e2e_dts.append(time.perf_counter() - t0)
            want_par, want_cs = oracle(h)
            if not (np.array_equal(par, want_par) and
                    (cs is None or np.array_equal(cs, want_cs))):
                print(f"bench_tpu: e2e shot {shot} WRONG bytes",
                      file=sys.stderr)
                return 1
        warm = e2e_dts[1:] if len(e2e_dts) > 1 else e2e_dts
        e2e_gbps = nbytes / statistics.median(warm) / 2**30
        e2e_spread = [round(nbytes / dt / 2**30, 6)
                      for dt in sorted(e2e_dts, reverse=True)]

    print(json.dumps({
        "backend": dev.type,
        "kernel": best,
        "workload": args.workload + ("+csum" if args.csum else ""),
        "k": k, "m": r, "stripe_bytes": args.stripe_bytes,
        "batch": args.batch, "reps": args.reps,
        "bytes_per_rep": nbytes,
        "digest_verified": True,
        "rtt_s": round(rtt, 6),
        "staging_gbps": staging_gbps,
        "staging_spread_gbps": staging_spread,
        "kernel_gbps": round(results[best]["kernel_gbps"], 4),
        "e2e_gbps": None if e2e_gbps is None else round(e2e_gbps, 6),
        "e2e_spread_gbps": e2e_spread,
        "candidates": results,
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "power_limit": _smi("power.limit") if on_card else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
