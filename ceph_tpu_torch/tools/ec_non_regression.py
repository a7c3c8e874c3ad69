"""EC encode/decode non-regression corpus check of the PyTorch port.

The capability of the reference's ceph_erasure_code_non_regression +
ceph-erasure-code-corpus (src/test/erasure-code/ceph_erasure_code_non_regression.cc,
qa/workunits/erasure-code/encode-decode-non-regression.sh): archive the
encoded chunks of a deterministic payload for every (plugin, technique,
k, m[, extra]) configuration, and verify later versions reproduce them
BYTE-EXACTLY — the guard against parity drift across releases and across
backends (the JAX package and this port must both match the archive).

The port has the ``--check`` side only: the archive is the JAX package's
(``python -m ceph_tpu.tools.ec_non_regression --create``), and the grid
holds the plugins the port has.  ``--device`` (default ``cuda``) is the
profile's device.

    python -m ceph_tpu_torch.tools.ec_non_regression --check --base corpus/
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import ec

#: the JAX package's grid, limited to the plugins the port has
DEFAULT_GRID = [
    ("tpu", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
]


def config_dir(base: str, plugin: str, profile: dict) -> str:
    tag = "_".join([plugin] + [f"{k}={profile[k]}"
                               for k in sorted(profile)])
    return os.path.join(base, tag)


#: profile keys that pick how a codec runs, not what it computes
RUN_KEYS = ("backend", "device")


def iter_grid(backend: str | None, device: str):
    for plugin, profile in DEFAULT_GRID:
        prof = dict(profile, device=device)
        if backend:
            prof["backend"] = backend
        yield plugin, prof


def check(base: str, backend: str | None, device: str = "cuda") -> int:
    failures = 0
    for plugin, prof in iter_grid(backend, device):
        d = config_dir(base, plugin, {k: v for k, v in prof.items()
                                      if k not in RUN_KEYS})
        if not os.path.isdir(d):
            print(f"MISSING archive {d}", file=sys.stderr)
            failures += 1
            continue
        with open(os.path.join(d, "content"), "rb") as f:
            data = f.read()
        codec = ec.factory(plugin, prof)
        chunks = codec.encode(data)
        archived = {int(f.split(".", 1)[1]) for f in os.listdir(d)
                    if f.startswith("chunk.")}
        if archived != set(chunks):
            # layout drift: chunk count/ids changed — exactly what this
            # gate exists to catch
            print(f"CHUNK SET DRIFT {d}: archive {sorted(archived)} vs "
                  f"encode {sorted(chunks)}", file=sys.stderr)
            failures += 1
            continue
        for cid, chunk in sorted(chunks.items()):
            with open(os.path.join(d, f"chunk.{cid}"), "rb") as f:
                want = f.read()
            if chunk.tobytes() != want:
                print(f"PARITY DRIFT {d} chunk {cid}", file=sys.stderr)
                failures += 1
        # decode check: the port's codes are MDS, so drop m chunks
        erased = list(range(codec.m))
        avail = {i: c for i, c in chunks.items() if i not in erased}
        out = codec.decode(erased, avail)
        for i in erased:
            if not np.array_equal(out[i], chunks[i]):
                print(f"DECODE DRIFT {d} chunk {i}", file=sys.stderr)
                failures += 1
    if failures:
        print(f"{failures} non-regression failures", file=sys.stderr)
        return 1
    print("all configurations byte-exact vs archive")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", default="corpus")
    p.add_argument("--check", action="store_true")
    p.add_argument("--backend", default=None,
                   help="force a math backend (numpy/torch) — the "
                       "cross-backend parity check")
    p.add_argument("--device", default="cuda",
                   help="device the plugins run on (default cuda)")
    args = p.parse_args(argv)
    if args.check:
        return check(args.base, args.backend, args.device)
    p.error("need --check")
    return 2


if __name__ == "__main__":
    sys.exit(main())
