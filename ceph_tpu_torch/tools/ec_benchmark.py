"""Erasure-code benchmark CLI of the PyTorch port — flag/output compatible
with the JAX package's tool and the reference's ceph_erasure_code_benchmark
(src/test/erasure-code/ceph_erasure_code_benchmark.cc: options :49-153,
encode loop :165-195, decode loop :260-326, output "seconds \\t KiB"
:193,:324).

The port adds ``--device`` (default ``cuda``): the profile's ``device``
key, unless a ``--parameter device=...`` sets it.  The port has only the
``tpu`` plugin so far, which is therefore the default.

Examples:
    python -m ceph_tpu_torch.tools.ec_benchmark \\
        --parameter k=8 --parameter m=3 --size $((80<<20)) --iterations 10
    python -m ceph_tpu_torch.tools.ec_benchmark --workload decode \\
        --erasures 2 --erasures-generation exhaustive --device cpu \\
        --parameter technique=cauchy_good
"""

from __future__ import annotations

import argparse
import itertools
import json
import random
import sys
import time

import numpy as np

from .. import ec


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--plugin", "-p", default="tpu",
                   help="erasure code plugin name (default tpu, the one "
                        "plugin the port has)")
    p.add_argument("--workload", "-w", default="encode",
                   choices=["encode", "decode"])
    p.add_argument("--size", "-s", type=int, default=80 * 1024 * 1024,
                   help="buffer size to encode per iteration (default 80 MiB)")
    p.add_argument("--iterations", "-i", type=int, default=1)
    p.add_argument("--erasures", "-e", type=int, default=1,
                   help="number of chunks to erase in decode workload")
    p.add_argument("--erasures-generation", "-E", default="random",
                   choices=["random", "exhaustive"])
    p.add_argument("--erased", type=int, action="append", default=None,
                   help="explicit chunk id to erase (repeatable)")
    p.add_argument("--parameter", "-P", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="erasure code profile parameter (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="device the plugin runs on (default cuda)")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--json", action="store_true",
                   help="emit a JSON summary instead of 'seconds\\tKiB'")
    return p.parse_args(argv)


def make_profile(args) -> dict[str, str]:
    profile: dict[str, str] = {}
    for kv in args.parameter:
        if "=" not in kv:
            raise SystemExit(f"--parameter {kv!r}: expected KEY=VALUE")
        key, val = kv.split("=", 1)
        profile[key] = val
    profile.setdefault("device", args.device)
    return profile


def run_encode(codec, size: int, iterations: int) -> float:
    data = np.full(size, ord("X"), dtype=np.uint8)  # 'X'*size as reference
    codec.encode(data)  # warm (kernel build, device tables, kernel pick)
    begin = time.perf_counter()
    for _ in range(iterations):
        codec.encode(data)
    return time.perf_counter() - begin


def run_decode(codec, size: int, iterations: int, erasures: int,
               generation: str, erased: list[int] | None,
               verbose: bool) -> float:
    data = np.full(size, ord("X"), dtype=np.uint8)
    chunks = codec.encode(data)
    n = codec.chunk_count
    if erased:
        patterns = [tuple(erased)]
    elif generation == "exhaustive":
        patterns = list(itertools.combinations(range(n), erasures))
    else:
        rng = random.Random(0)
        patterns = [tuple(rng.sample(range(n), erasures))
                    for _ in range(iterations)]
    # warm
    first = patterns[0]
    codec.decode(list(first), {i: c for i, c in chunks.items()
                               if i not in first})
    begin = time.perf_counter()
    verified = 0.0
    for it in range(iterations):
        if generation == "exhaustive" and not erased:
            # every combination per iteration, with byte verification — the
            # reference's exhaustive mode (:298-301, verify :234-244)
            todo = patterns
        else:
            todo = [patterns[it % len(patterns)]]
        for pat in todo:
            avail = {i: c for i, c in chunks.items() if i not in pat}
            out = codec.decode(list(pat), avail)
            if generation == "exhaustive":
                t0 = time.perf_counter()
                for i in pat:
                    if not np.array_equal(out[i], chunks[i]):
                        raise SystemExit(
                            f"decode mismatch: chunk {i} of {pat}")
                verified += time.perf_counter() - t0
    elapsed = time.perf_counter() - begin
    if verbose:
        print(f"verification time: {verified:.3f}s", file=sys.stderr)
    return elapsed


def main(argv=None) -> int:
    args = parse_args(argv)
    profile = make_profile(args)
    codec = ec.factory(args.plugin, profile)
    if args.workload == "encode":
        elapsed = run_encode(codec, args.size, args.iterations)
    else:
        elapsed = run_decode(codec, args.size, args.iterations, args.erasures,
                             args.erasures_generation, args.erased,
                             args.verbose)
    total_kib = args.size * args.iterations / 1024
    if args.json:
        gbs = args.size * args.iterations / max(elapsed, 1e-12) / 2**30
        print(json.dumps({
            "plugin": args.plugin, "workload": args.workload,
            "profile": profile, "seconds": elapsed, "KiB": total_kib,
            "GBps": gbs,
        }))
    else:
        # the reference's exact output shape: "seconds \t KiB"
        print(f"{elapsed:f}\t{total_kib:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
