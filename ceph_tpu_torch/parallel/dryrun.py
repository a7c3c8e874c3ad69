"""The multi-device dry run of the port: every leg of the distributed EC
path once, checked byte for byte.

The counterpart of ``__graft_entry__.dryrun_multichip``: on an
n-device ("dp", "shard") mesh of ``parallel.mesh.devices(device)``
(one card's logical devices, or the CPU's, as force_devices set them),

- the write step (systematic rows, parity against the single-device
  encode and the numpy gf256 oracle, the psum digest), a rebalance by
  +1 and back by -1, the recovery from chunks [0,2,3,5,6,7,8,10], the
  parity-delta partial write against a full re-encode, the stats step;
- the host mesh (host x dp x shard, batch over host and dp);
- the sharded batcher: n writers coalesced into one folded launch fanned
  over a flat mesh, plain and checksummed;
- the two-process leg: two dcn_worker processes in a gloo group.

The host mesh draws its stripes before the batcher's, so its digest is
the one the repo's record holds (MULTICHIP_r05.json: 1568446); the
reference's dry run now draws the batcher's first.  Each leg is a
function of its shapes, so chip_smoke.py runs the same legs at full
width with its own clock.

    python -m ceph_tpu_torch.parallel.dryrun [--devices 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time

import numpy as np
import torch

from ..models.stripe_codec import StripeCodec
from ..ops import gf256
from . import mesh as meshmod
from .distributed import DistributedStripeEC

#: the recovery leg's survivors: chunks 1, 4 and 9 lost
AVAILABLE = [0, 2, 3, 5, 6, 7, 8, 10]

#: how long ``batcher_leg`` waits for its writers before it raises
JOIN_DEADLINE_S = 300.0


def _no_clock(name):
    return contextlib.nullcontext()


def _eq(what: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (np.argwhere(got != want)[:4].tolist()
               if got.shape == want.shape else "shape")
        raise AssertionError(f"{what}: {got.shape} differs from "
                             f"{want.shape} at {bad}")


def _oracle(M: np.ndarray, x: np.ndarray, cols) -> np.ndarray:
    """The numpy gf256 product of M and ``x``'s columns ``cols`` (all
    when None)."""
    return gf256.encode_region(M, x if cols is None
                               else np.ascontiguousarray(x[:, cols]))


def _single(fn, folded: np.ndarray, device) -> np.ndarray:
    """A StripeCodec graph on one device, as a plain tensor launch."""
    return fn(torch.from_numpy(folded).to(device)).cpu().numpy()


def mesh_leg(dec: DistributedStripeEC, data: np.ndarray,
             delta: np.ndarray, *, cols=None, clock=_no_clock) -> dict:
    """Write, rebalance +1 and -1, recovery from AVAILABLE, delta and
    stats on ``dec``'s mesh, each held byte for byte against the same
    work on one device (the mesh's first) and the numpy oracle on
    columns ``cols`` of every stripe.  ``clock(name)`` wraps each step;
    the inputs are staged on the mesh before it.  Returns the digest
    and the stack's shape."""
    codec, k, m = dec.codec, dec.codec.k, dec.codec.m
    B, _, L = data.shape
    dev0 = dec.mesh.devices.flat[0].torch_device
    staged, staged_delta = dec.stage(data), dec.stage(delta)
    with clock("write"):
        stack, digest = dec.write_step(staged)
    st = np.asarray(stack)
    if st.shape != (B, dec.S, L):
        raise AssertionError(f"write: stack {st.shape}")
    _eq("write: systematic rows", st[:, :k], data)
    folded = np.ascontiguousarray(data.transpose(1, 0, 2).reshape(k, -1))
    single = _single(codec.encode_graph(), folded, dev0)
    _eq("write: parity against one device",
        st[:, k:k + m].transpose(1, 0, 2).reshape(m, -1), single)
    for b in range(B):
        _eq(f"write: stripe {b} parity against the oracle",
            st[b, k:k + m] if cols is None else st[b, k:k + m][:, cols],
            _oracle(codec.matrix, data[b], cols))
    if dec.spare_rows and st[:, k + m:].any():
        raise AssertionError("write: a spare row is not zero")
    want_digest = int(single.astype(np.uint64).sum()) & 0xFFFFFFFF
    if int(np.asarray(digest)) != want_digest:
        raise AssertionError(f"write: digest {int(np.asarray(digest))} "
                             f"!= {want_digest}")
    rows = dec.S // dec.n_shard
    with clock("rebalance"):
        moved = dec.make_rebalance_step(1)(stack)
        back = dec.make_rebalance_step(-1)(moved)
    mv = np.asarray(moved)
    for j in range(dec.n_shard):
        d = (j + 1) % dec.n_shard
        _eq(f"rebalance +1: shard {j} -> {d}",
            mv[:, d * rows:(d + 1) * rows], st[:, j * rows:(j + 1) * rows])
    _eq("rebalance -1", np.asarray(back), st)
    with clock("recovery"):
        rec = dec.recovery_step(AVAILABLE)(stack)
    rc = np.asarray(rec)
    _eq("recovery: data", rc, data)
    surv = np.ascontiguousarray(st[:, AVAILABLE[:k]].transpose(
        1, 0, 2).reshape(k, -1))
    _eq("recovery: against one device's decode",
        rc.transpose(1, 0, 2).reshape(k, -1),
        _single(codec.decode_graph(AVAILABLE[:k]), surv, dev0))
    with clock("delta"):
        upd = dec.make_delta_step()(stack, staged_delta)
    full, _ = dec.write_step(np.bitwise_xor(data, delta))
    _eq("delta against a full re-encode", np.asarray(upd), np.asarray(full))
    with clock("stats"):
        stats = dec.make_stats_step()(stack)
    _eq("stats", np.asarray(stats),
        st.astype(np.uint32).sum(axis=(0, 2), dtype=np.uint32))
    return {"digest": int(np.asarray(digest)), "B": B, "L": L,
            "S": dec.S}


def host_mesh_leg(codec: StripeCodec, devs, n_hosts: int,
                  data: np.ndarray, delta: np.ndarray) -> dict:
    """The ("host", "dp", "shard") mesh in one process, batch over
    (host, dp): write, recovery, delta and stats."""
    hmesh = meshmod.make_host_mesh(n_hosts=n_hosts, devices=devs)
    hdec = DistributedStripeEC(codec, hmesh, batch_axes=("host", "dp"))
    hstack, hdig = hdec.write_step(data)
    hs = np.asarray(hstack)
    _eq("host mesh: systematic rows", hs[:, :codec.k], data)
    _eq("host mesh: recovery",
        np.asarray(hdec.recovery_step(AVAILABLE)(hstack)), data)
    upd = hdec.make_delta_step()(hstack, delta)
    full, _ = hdec.write_step(np.bitwise_xor(data, delta))
    _eq("host mesh: delta", np.asarray(upd), np.asarray(full))
    hstats = np.asarray(hdec.make_stats_step()(hstack))
    _eq("host mesh: stats", hstats,
        hs.astype(np.uint32).sum(axis=(0, 2), dtype=np.uint32))
    return {"mesh": hmesh.shape, "digest": int(np.asarray(hdig))}


def batcher_leg(n_devices: int, device: str, payloads: list, *,
                with_csums: bool = False) -> dict:
    """One writer a payload (each (8, L)) through an ECBatcher on a
    ``tpu`` k=8 m=3 codec of ``shard=n_devices``: the burst coalesces
    into one folded launch fanned over the mesh.  Each parity and each
    csum row is held against the native library; at least one launch
    must be sharded."""
    from .. import ec
    from ..ec.batcher import ECBatcher
    from ..ops import native

    codec = ec.factory("tpu", {"k": 8, "m": 3, "device": device,
                               "shard": str(n_devices)})
    bat = ECBatcher(window_us=10_000_000,
                    max_bytes=sum(p.nbytes for p in payloads))
    res, errors = [None] * len(payloads), []

    def enc(i):
        try:
            res[i] = bat.encode(codec, payloads[i], with_csums=with_csums)
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=enc, args=(i,), daemon=True)
               for i in range(len(payloads))]
    threads[0].start()
    time.sleep(0.05)  # the leader parks in its window first
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_DEADLINE_S)
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a batcher writer still runs after "
                           f"{JOIN_DEADLINE_S} s")
    if errors:
        raise errors[0]
    for i, (data, r) in enumerate(zip(payloads, res)):
        parity, csums = np.asarray(r[0]), r[1]
        _eq(f"batcher: writer {i} parity", parity,
            native.encode_region(codec.matrix, data))
        if with_csums:
            want = np.array([native.crc32c(row) for row in
                             np.concatenate([data, parity])],
                            dtype=np.uint32)
            _eq(f"batcher: writer {i} csums", np.asarray(csums), want)
    if n_devices > 1 and bat.stats["sharded_launches"] < 1:
        raise AssertionError(f"batcher: no sharded launch: {bat.stats}")
    return dict(bat.stats, shard_devices=codec.shard_devices())


def process_leg(device: str, devices_per_host: int,
                timeout: float = 120.0) -> list[dict]:
    """Two dcn_worker processes in a gloo group: their digests must be
    equal and their recovery exact."""
    from .dcn_worker import launch

    results = launch(2, devices_per_host, device, timeout=timeout)
    if results[0]["digest"] != results[1]["digest"]:
        raise AssertionError(f"process leg: digests differ: {results}")
    if any(r["recovery_err"] or r["systematic_err"] for r in results):
        raise AssertionError(f"process leg: {results}")
    return results


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     processes: bool = True) -> dict:
    """Every leg once at the reference's tiny shapes on ``n_devices`` of
    ``devices(device)``; ``processes=False`` leaves the two-process leg
    out (the tests run it as a test of its own).  Returns the legs'
    results and prints one summary line."""
    devs = meshmod.devices(device)[:n_devices]
    mesh = meshmod.make_mesh(n_devices, devices=devs)
    codec = StripeCodec(k=8, m=3)
    dec = DistributedStripeEC(codec, mesh)
    rng = np.random.default_rng(1)
    B, L = 2 * dec.n_dp, 256 * dec.n_shard
    data = rng.integers(0, 256, (B, 8, L), dtype=np.uint8)
    delta = rng.integers(0, 256, (B, 8, L), dtype=np.uint8)
    out = {"mesh": mesh.shape, "main": mesh_leg(dec, data, delta)}
    hd = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    hdec_shape = meshmod.make_host_mesh(n_hosts=hd, devices=devs)
    hB = 2 * hdec_shape.shape["host"] * hdec_shape.shape["dp"]
    hL = 256 * hdec_shape.shape["shard"]
    hdata = rng.integers(0, 256, (hB, 8, hL), dtype=np.uint8)
    hdelta = rng.integers(0, 256, (hB, 8, hL), dtype=np.uint8)
    out["host"] = host_mesh_leg(codec, devs, hd, hdata, hdelta)
    pays = [rng.integers(0, 256, (8, 512), dtype=np.uint8)
            for _ in range(n_devices)]
    out["batcher"] = batcher_leg(n_devices, device, pays)
    out["batcher_csums"] = batcher_leg(n_devices, device, pays,
                                       with_csums=True)
    if processes:
        out["processes"] = process_leg(device, max(2, n_devices // 2))
    mp = (f"2-process leg ok (digest {out['processes'][0]['digest']})"
          if processes else "2-process leg: run apart")
    print(f"dryrun_multichip ok: mesh dp={mesh.shape['dp']} x shard="
          f"{mesh.shape['shard']}, B={B}, L={L}, digest="
          f"{out['main']['digest']}; delta+stats ok; sharded batcher "
          f"{out['batcher']['ops']} ops/{out['batcher']['launches']} "
          f"launch ({out['batcher']['sharded_launches']} sharded) ok; "
          f"host mesh {out['host']['mesh']} hdigest="
          f"{out['host']['digest']}; {mp}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: --device cuda but torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 2
    meshmod.force_devices(args.device, args.devices)
    print(json.dumps(dryrun_multichip(args.devices, args.device),
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
