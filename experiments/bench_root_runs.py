#!/usr/bin/env python3
"""Run one mode of the port's bench driver (tools/bench_root) several
times in a row, each in its own process, and keep every JSON row.

    python3 experiments/bench_root_runs.py --runs 5 -- --ec-batch
    python3 experiments/bench_root_runs.py --runs 3 --out chiprun_out \\
        -- --ec-recovery --progress

Each run prints one summary line (exit code, seconds, and the row's
timing-ratio gates and headline numbers); the rows go to
``<out>/bench_root_runs.jsonl`` with the card's name and power limit as
nvidia-smi gives them.  It exits 1 if any run exited nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the keys a summary line shows, where the row has them
SUMMARY = ("value", "vs_baseline", "digest_verified", "ok",
           "trace_overhead_pct_at_001", "trace_overhead_ok",
           "exemplar_overhead_pct_at_001", "exemplar_overhead_ok",
           "perf_query_overhead_pct", "perf_query_overhead_ok",
           "store_commit_ok", "kv_maint_ok", "wire_zero_copy_ok",
           "d2h_copies_per_flush", "e2e_device_share", "kernel_gbps",
           "ec_kernel_race_winner")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--out", default="chiprun_out")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("mode", nargs=argparse.REMAINDER,
                   help="bench_root's arguments, after --")
    args = p.parse_args(argv)
    mode = [a for a in args.mode if a != "--"]
    where = card()
    print(f"bench_root_runs: {' '.join(mode)} x {args.runs}; {where}",
          flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "bench_root_runs.jsonl")
    failed = 0
    with open(path, "a") as f:
        for run in range(args.runs):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "ceph_tpu_torch.tools.bench_root",
                 *mode], capture_output=True, text=True,
                timeout=args.timeout, cwd=REPO)
            wall = time.perf_counter() - t0
            try:
                row = json.loads(proc.stdout.strip().splitlines()[-1])
            except (json.JSONDecodeError, IndexError):
                row = {"stdout": proc.stdout[-2000:]}
            failed += proc.returncode != 0
            f.write(json.dumps({"mode": mode, "run": run,
                                "rc": proc.returncode, "wall_s": wall,
                                "card": where, "row": row,
                                "stderr": proc.stderr[-4000:]}) + "\n")
            print(f"run {run}: rc {proc.returncode}, {wall:.1f} s, "
                  + json.dumps({k: row[k] for k in SUMMARY if k in row}),
                  flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
