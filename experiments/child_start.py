#!/usr/bin/env python3
"""Where an OSD child's start goes, on the machine it runs on.

    python3 experiments/child_start.py [--runs 3]

For a fresh interpreter, the wall seconds of ``import torch``, of the
OSD child's imports (``ceph_tpu_torch.tools.osd_main`` and the daemon
it loads) and, on a card, of its first CUDA allocation (the context);
then ``python -X importtime`` of the child's imports, the modules that
took longest (cumulative).  On a card it also forks a process that has
imported the child's modules (and touched no CUDA) and opens the card
in the forked child: whether a process that forks OSD children after
those imports could work.  Prints one line a measurement.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORK_PROBE = r"""
import os, sys, time
import ceph_tpu_torch.tools.osd_main  # noqa: F401
import torch
print("after the imports, cuda initialized:", torch.cuda.is_initialized(),
      flush=True)
pid = os.fork()
if pid == 0:
    t = time.perf_counter()
    try:
        torch.zeros(1, device="cuda")
        print(f"forked child opened the card in "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        os._exit(0)
    except Exception as e:  # noqa: BLE001 - printed
        print(f"forked child failed: {e!r}", flush=True)
        os._exit(1)
_, status = os.waitpid(pid, 0)
sys.exit(os.waitstatus_to_exitcode(status))
"""


def timed(code: str, env: dict) -> tuple[float, str]:
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"{code!r} exit {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    return time.perf_counter() - t, out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=REPO)
    import torch
    card = torch.cuda.is_available()
    for i in range(args.runs):
        s, _ = timed("import torch", env)
        print(f"[child_start] run {i}: import torch {s:.3f} s", flush=True)
        s, _ = timed("import ceph_tpu_torch.tools.osd_main, "
                     "ceph_tpu_torch.osd.daemon", env)
        print(f"[child_start] run {i}: the child's imports {s:.3f} s",
              flush=True)
        if card:
            _, out = timed("import time, torch; t = time.perf_counter(); "
                           "torch.zeros(1, device='cuda'); "
                           "print(time.perf_counter() - t)", env)
            print(f"[child_start] run {i}: first CUDA allocation "
                  f"{float(out):.3f} s", flush=True)
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-c",
         "import ceph_tpu_torch.tools.osd_main, ceph_tpu_torch.osd.daemon"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    rows = []
    for ln in out.stderr.splitlines():
        parts = ln.split("|")
        if len(parts) == 3 and parts[1].strip().isdigit():
            rows.append((int(parts[1]), parts[2].rstrip()))
    rows.sort(reverse=True)
    for us, name in rows[:args.top]:
        print(f"[child_start] importtime cumulative {us / 1e6:.3f} s "
              f"{name}", flush=True)
    if card:
        out = subprocess.run([sys.executable, "-c", _FORK_PROBE], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=600)
        for ln in (out.stdout + out.stderr).strip().splitlines()[-4:]:
            print(f"[child_start] fork: {ln}", flush=True)
        print(f"[child_start] fork probe exit {out.returncode}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
