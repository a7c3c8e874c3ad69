"""ceph-erasure-code-tool: offline file encode/decode with any profile.

The port's copy of ``ceph_tpu/tools/ec_tool.py``, the capability of the
reference's tool (src/tools/erasure-code/ceph-erasure-code-tool.cc):
split a file into k+m chunk files with any plugin/profile, and
reassemble the original from any decodable subset — no cluster
involved.  The port's plugins default to ``backend=torch`` on
``device=cuda``, so the codec runs on the card unless the profile asks
for ``device=cpu`` or a host backend (``backend=native``).

    python -m ceph_tpu_torch.tools.ec_tool encode <profile> <file> <out-dir>
    python -m ceph_tpu_torch.tools.ec_tool decode <profile> <out-dir> <file> \
        [--erased 0,3]
    python -m ceph_tpu_torch.tools.ec_tool info <profile>

<profile> is comma-separated key=value pairs, e.g.
"plugin=jerasure,technique=reed_sol_van,k=4,m=2".
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import ec


def parse_profile(text: str) -> tuple[str, dict]:
    prof = {}
    for tok in text.split(","):
        if not tok:
            continue
        if "=" not in tok:
            raise SystemExit(f"bad profile token {tok!r} (want key=value)")
        k, v = tok.split("=", 1)
        prof[k] = v
    plugin = prof.pop("plugin", "jerasure")
    return plugin, prof


def cmd_info(plugin: str, prof: dict) -> int:
    codec = ec.factory(plugin, prof)
    print(f"plugin={plugin} k={codec.k} m={codec.m} "
          f"chunk_count={codec.chunk_count} "
          f"minimum_granularity={codec.get_minimum_granularity()} "
          f"sub_chunks={codec.get_sub_chunk_count()} "
          f"flags={codec.get_flags()!r}")
    return 0


def cmd_encode(plugin: str, prof: dict, path: str, outdir: str) -> int:
    codec = ec.factory(plugin, prof)
    with open(path, "rb") as f:
        data = f.read()
    chunks = codec.encode(data)
    os.makedirs(outdir, exist_ok=True)
    for cid, chunk in sorted(chunks.items()):
        with open(os.path.join(outdir, f"chunk.{cid}"), "wb") as f:
            f.write(chunk.tobytes())
    with open(os.path.join(outdir, "size"), "w") as f:
        f.write(str(len(data)))
    print(f"encoded {len(data)} bytes -> {len(chunks)} chunks in "
          f"{outdir}")
    return 0


def cmd_decode(plugin: str, prof: dict, indir: str, path: str,
               erased: list[int]) -> int:
    codec = ec.factory(plugin, prof)
    chunks = {}
    for cid in range(codec.chunk_count):
        if cid in erased:
            continue
        p = os.path.join(indir, f"chunk.{cid}")
        if not os.path.exists(p):
            continue
        with open(p, "rb") as f:
            chunks[cid] = np.frombuffer(f.read(), dtype=np.uint8)
    data_ids = list(range(codec.k))
    decoded = codec.decode(data_ids, chunks)
    out = np.concatenate([decoded[i] for i in data_ids]).tobytes()
    size_path = os.path.join(indir, "size")
    if os.path.exists(size_path):
        with open(size_path) as f:
            out = out[: int(f.read().strip())]
    with open(path, "wb") as f:
        f.write(out)
    print(f"decoded {len(out)} bytes from {len(chunks)} chunks -> {path}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("verb", choices=("encode", "decode", "info"))
    ap.add_argument("profile")
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--erased", default="",
                    help="comma-separated chunk ids to treat as lost")
    args = ap.parse_args(argv)
    plugin, prof = parse_profile(args.profile)
    if args.verb == "info":
        return cmd_info(plugin, prof)
    if args.verb == "encode":
        if len(args.paths) != 2:
            raise SystemExit("encode needs <file> <out-dir>")
        return cmd_encode(plugin, prof, *args.paths)
    if len(args.paths) != 2:
        raise SystemExit("decode needs <chunk-dir> <out-file>")
    erased = [int(x) for x in args.erased.split(",") if x]
    return cmd_decode(plugin, prof, args.paths[0], args.paths[1], erased)


if __name__ == "__main__":
    sys.exit(main())
