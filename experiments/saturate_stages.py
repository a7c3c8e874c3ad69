#!/usr/bin/env python3
"""Where ``bench_root --saturate --smoke`` (``chip_smoke.py`` phase 18's
longest child) spends its wall time: run the mode ``--runs`` times, each
in a fresh child process as phase 18 runs it, and print for each run
its wall seconds and the seconds of each stage inside the child: the
interpreter and imports, the cluster's build, the load workers' spawn
(until every worker is ready), the legs (go until every worker exits),
the recovery wait, and the cluster's stop.

    python3 experiments/saturate_stages.py --runs 3 --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def child(device: str) -> int:
    """One run of the mode in this process, each stage timed."""
    stages: list[tuple[str, float, float]] = []
    t_import = time.perf_counter()
    from ceph_tpu_torch.load import generator, scenarios
    from ceph_tpu_torch.tools import bench_root, vstart
    stages.append(("imports", t_import - T0, time.perf_counter() - T0))

    def timed(owner, name: str, label: str) -> None:
        real = getattr(owner, name)

        def wrapper(*args, **kw):
            t = time.perf_counter() - T0
            try:
                return real(*args, **kw)
            finally:
                stages.append((label, t, time.perf_counter() - T0))
        setattr(owner, name, wrapper)

    timed(scenarios, "_build_cluster", "cluster build")
    timed(generator.LoadGenerator, "spawn", "workers spawn")
    timed(generator.LoadGenerator, "collect", "legs until workers exit")
    timed(vstart.MiniCluster, "stop", "cluster stop")
    timed(scenarios, "_run_point_on", "point (spawn to recovery)")
    rc = bench_root.main(["--saturate", "--smoke", "--device", device])
    stages.append(("exit", time.perf_counter() - T0,
                   time.perf_counter() - T0))
    print(json.dumps({"stages": stages}), file=sys.stderr, flush=True)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.child:
        return child(a.device)
    bad = 0
    for i in range(a.runs):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--device", a.device], capture_output=True, text=True,
            timeout=300, cwd=REPO)
        wall = time.perf_counter() - t0
        stages = next((json.loads(line)["stages"] for line in
                       reversed(proc.stderr.splitlines())
                       if line.startswith('{"stages"')), [])
        row = proc.stdout.strip().splitlines()[-1] if proc.stdout else "{}"
        try:
            row = json.loads(row)
        except json.JSONDecodeError:
            row = {}
        bad += proc.returncode != 0
        print(f"run {i}: rc {proc.returncode}, {wall:.1f} s wall, "
              f"ops/s {row.get('value')}; stages (start-end s): "
              + ", ".join(f"{n} {s:.1f}-{e:.1f}" for n, s, e in stages),
              flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
