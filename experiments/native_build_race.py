#!/usr/bin/env python3
"""Race the first loads of the native library, as a parallel test run
from a fresh checkout does.

Each trial copies ``native/`` and the two packages' loaders
(``ceph_tpu/ops/native.py`` and ``ceph_tpu_torch/ops/native.py``) into a
temporary directory with no built library, starts ``--procs`` processes
at once, each of which loads the library through one loader, and counts
the loads that fail (e.g. "file too short": a process loaded a library
another process's ``make`` was still linking).

    python3 experiments/native_build_race.py --mix ref --trials 10
    python3 experiments/native_build_race.py --mix both --trials 10
    python3 experiments/native_build_race.py --mix both --port-in-native-build

``--mix ref``: every process uses the JAX package's loader; ``both``:
half use the port's.  ``--port-in-native-build`` points the port's
loader at ``native/build/`` (where it built before it had a directory
of its own).  Prints one JSON line of failures and loads per loader.
Nothing outside the temporary directory is written.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("n", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
if len(sys.argv) > 2:
    mod._BUILD_DIR = sys.argv[2]
try:
    mod.lib()
    print("ok")
except Exception as e:
    print("FAIL", str(e).replace("\n", " ")[:300])
"""


def _layout(tmp: str) -> dict[str, str]:
    shutil.copytree(os.path.join(REPO, "native"), os.path.join(tmp, "native"),
                    ignore=shutil.ignore_patterns("build"))
    paths = {}
    for pkg in ("ceph_tpu", "ceph_tpu_torch"):
        d = os.path.join(tmp, pkg, "ops")
        os.makedirs(d)
        shutil.copy(os.path.join(REPO, pkg, "ops", "native.py"), d)
        paths[pkg] = os.path.join(d, "native.py")
    return paths


def trial(procs: int, mix: str, port_in_native_build: bool) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        paths = _layout(tmp)
        kinds = ["ref" if mix == "ref" or i % 2 == 0 else "port"
                 for i in range(procs)]
        running = []
        for k in kinds:
            argv = [sys.executable, "-c", _CHILD,
                    paths["ceph_tpu" if k == "ref" else "ceph_tpu_torch"]]
            if k == "port" and port_in_native_build:
                argv.append(os.path.join(tmp, "native", "build"))
            running.append((k, subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        out = []
        for k, p in running:
            text = p.communicate(timeout=300)[0].strip()
            out.append((k, text if text else f"no output, exit "
                                                f"{p.returncode}"))
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mix", choices=("ref", "both"), default="ref")
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--port-in-native-build", action="store_true")
    args = ap.parse_args(argv)
    loads = {"ref": 0, "port": 0}
    fails = {"ref": 0, "port": 0}
    samples = []
    for _ in range(args.trials):
        for k, text in trial(args.procs, args.mix,
                             args.port_in_native_build):
            loads[k] += 1
            if not text.startswith("ok"):
                fails[k] += 1
                if len(samples) < 4:
                    samples.append(f"{k}: {text}")
    print(json.dumps({"mix": args.mix, "procs": args.procs,
                      "port_in_native_build": args.port_in_native_build,
                      "loads": loads, "failures": fails,
                      "samples": samples}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
