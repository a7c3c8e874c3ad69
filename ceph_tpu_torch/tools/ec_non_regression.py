"""EC encode/decode non-regression corpus check of the PyTorch port.

The capability of the reference's ceph_erasure_code_non_regression +
ceph-erasure-code-corpus (src/test/erasure-code/ceph_erasure_code_non_regression.cc,
qa/workunits/erasure-code/encode-decode-non-regression.sh): archive the
encoded chunks of a deterministic payload for every (plugin, technique,
k, m[, extra]) configuration, and verify later versions reproduce them
BYTE-EXACTLY — the guard against parity drift across releases and across
backends (the JAX package and this port must both match the archive).

The grid is the JAX package's, all 15 configurations in its order;
``--create`` writes their archives into the ``--base`` the caller names
(the same payload, so they equal the JAX package's archives byte for
byte), ``--check`` verifies them.  ``--device`` (default ``cuda``) is the
profile's device.

    python -m ceph_tpu_torch.tools.ec_non_regression --check --base corpus/
    python -m ceph_tpu_torch.tools.ec_non_regression --create --base out/
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import ec

STRIPE_WIDTH = 4096  # matches the reference tool's default stripe-width

#: the JAX package's grid, in its order
DEFAULT_GRID = [
    ("jerasure", {"technique": "reed_sol_van", "k": "2", "m": "1"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "6", "m": "2"}),
    ("jerasure", {"technique": "cauchy_orig", "k": "8", "m": "4"}),
    ("jerasure", {"technique": "cauchy_good", "k": "8", "m": "4"}),
    ("isa", {"technique": "reed_sol_van", "k": "8", "m": "4"}),
    ("isa", {"technique": "cauchy", "k": "8", "m": "4"}),
    ("jerasure", {"technique": "liberation", "k": "5", "m": "2"}),
    ("jerasure", {"technique": "blaum_roth", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "liber8tion", "k": "6", "m": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("shec", {"k": "8", "m": "4", "c": "3"}),
    ("clay", {"k": "8", "m": "4", "d": "11"}),
    ("clay", {"k": "5", "m": "3", "d": "7"}),  # shortened (nu=1)
    ("tpu", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
]


def payload(width: int) -> bytes:
    """Deterministic content (seeded, not 'X'*n: catches coefficient
    ordering bugs constant payloads would mask)."""
    return np.random.default_rng(0xEC).integers(
        0, 256, width, dtype=np.uint8).tobytes()


def config_dir(base: str, plugin: str, profile: dict) -> str:
    tag = "_".join([plugin] + [f"{k}={profile[k]}"
                               for k in sorted(profile)])
    return os.path.join(base, tag)


#: profile keys that pick how a codec runs, not what it computes
RUN_KEYS = ("backend", "device")


def iter_grid(backend: str | None, device: str, grid=None):
    for plugin, profile in DEFAULT_GRID if grid is None else grid:
        prof = dict(profile, device=device)
        if backend:
            prof["backend"] = backend
        yield plugin, prof


def _archive_dir(base: str, plugin: str, prof: dict) -> str:
    return config_dir(base, plugin, {k: v for k, v in prof.items()
                                     if k not in RUN_KEYS})


def create(base: str, backend: str | None, device: str = "cuda") -> int:
    data = payload(STRIPE_WIDTH)
    for plugin, prof in iter_grid(backend, device):
        codec = ec.factory(plugin, prof)
        chunks = codec.encode(data)
        d = _archive_dir(base, plugin, prof)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "content"), "wb") as f:
            f.write(data)
        for cid, chunk in sorted(chunks.items()):
            with open(os.path.join(d, f"chunk.{cid}"), "wb") as f:
                f.write(chunk.tobytes())
        print(f"archived {d}: {len(chunks)} chunks")
    return 0


def check(base: str, backend: str | None, device: str = "cuda",
          grid=None) -> int:
    """Verify the archives of ``grid`` (default DEFAULT_GRID) under
    ``base``; 0 when every one is byte-exact."""
    failures = 0
    n = 0
    for plugin, prof in iter_grid(backend, device, grid):
        n += 1
        d = _archive_dir(base, plugin, prof)
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
        # decode check: MDS codes drop m chunks; locality codes (not MDS
        # against arbitrary patterns) drop one data chunk
        erased = [0] if plugin in ("lrc", "shec") else list(range(codec.m))
        avail = {i: c for i, c in chunks.items() if i not in erased}
        out = codec.decode(erased, avail)
        for i in erased:
            if not np.array_equal(out[i], chunks[i]):
                print(f"DECODE DRIFT {d} chunk {i}", file=sys.stderr)
                failures += 1
    if failures:
        print(f"{failures} non-regression failures", file=sys.stderr)
        return 1
    print(f"all configurations byte-exact vs archive ({n} directories)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", default="corpus")
    p.add_argument("--create", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--backend", default=None,
                   help="force a math backend (numpy/native/torch) — the "
                       "cross-backend parity check")
    p.add_argument("--device", default="cuda",
                   help="device the plugins run on (default cuda)")
    args = p.parse_args(argv)
    if args.create:
        return create(args.base, args.backend, args.device)
    if args.check:
        return check(args.base, args.backend, args.device)
    p.error("need --create or --check")
    return 2


if __name__ == "__main__":
    sys.exit(main())
