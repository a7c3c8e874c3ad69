#!/usr/bin/env python3
"""Does an acknowledged write read back in the port's rolling restart?

    python3 experiments/rolling_restart_enoent.py --runs 40 --parallel 4

Each run deploys the port's cluster as ``tests/test_torch_cephadm.py``'s
``adm`` fixture does (``CephAdm``: 4 filestore OSD children, a replicated
pool of size 2 at ``pg_num`` 8, heartbeat grace 5.0 s, ``device="cpu"``),
writes 12 objects, then runs one rolling restart (a staircase: each OSD
killed and restarted in turn) while a writer writes objects and reads
each acknowledged write back at once.  ``--parallel`` runs that many
clusters at once, each in its own interpreter, to load the box.

Every client RPC of the writer is traced.  For each acked write that did
not read back (ENOENT, another error, or other bytes) a run prints the
object's PG, its up set and the client's epoch at the write and at the
read, the OSD that acked the write and the one that answered the read,
and whether the object read back later.  One JSON line a run, then a
summary line; ``--out`` also writes them to a file.  Exit 1 if any acked
write did not read back.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _traced(client):
    """Wrap ``client._rpc``: each thread keeps the list of its op's
    attempts as (target, result, reply epoch, client epoch)."""
    local = threading.local()
    rpc = client._rpc

    def traced(target, msg, tid, timeout=None):
        reply = rpc(target, msg, tid, timeout)
        getattr(local, "attempts", []).append(
            (target, reply.result, reply.epoch, msg.epoch))
        return reply

    def begin():
        local.attempts = []
        return local.attempts

    client._rpc = traced
    return begin


def one_run(seed: int, base: str) -> dict:
    import numpy as np
    import torch

    from ceph_tpu_torch.tools.cephadm import CephAdm

    torch.set_num_threads(1)
    rng = np.random.default_rng(seed)
    spec = {"osds": [{"id": i, "store": "filestore"} for i in range(4)],
            "pools": [{"name": "up", "size": 2, "pg_num": 8}]}
    adm = CephAdm(spec, os.path.join(base, "cluster"),
                  cfg_overrides={"osd_heartbeat_grace": 5.0},
                  device="cpu", admin_dir=os.path.join(base, "asok"))
    out = {"seed": seed, "acked": 0, "unreadable": [], "write_failed": 0,
           "error": None}
    t0 = time.monotonic()
    try:
        adm.deploy()
        client = adm.cluster.client()
        for i in range(12):
            client.write_full("up", f"pre{i}", rng.integers(
                0, 256, 8_000, dtype=np.uint8).tobytes())
        stop = threading.Event()
        wclient = adm.cluster.client()
        begin = _traced(wclient)
        pid = wclient._pool_id("up")
        bad: list[dict] = []

        def placement(name):
            m = wclient.osdmap
            pg = m.object_to_pg(pid, name)
            return pg, list(m.pg_to_up_osds(pid, pg)), m.epoch

        def loader():
            i = 0
            while not stop.is_set():
                name, data = f"live{i}", bytes([i % 256]) * 2_000
                i += 1
                acked = None
                for _attempt in range(4):
                    tries = begin()
                    try:
                        wclient.write_full("up", name, data)
                        acked = tries
                        break
                    except Exception:  # noqa: BLE001 - retried
                        if stop.is_set():
                            return
                        time.sleep(0.5)
                if acked is None:
                    out["write_failed"] += 1
                    continue
                pg_w, up_w, ep_w = placement(name)
                out["acked"] += 1
                tries = begin()
                try:
                    got, err = wclient.read("up", name), None
                except Exception as e:  # noqa: BLE001 - recorded
                    got, err = None, repr(e)[:120]
                if got != data:
                    pg_r, up_r, ep_r = placement(name)
                    bad.append({
                        "oid": name, "error": err,
                        "other_bytes": got is not None,
                        "pg": pg_w, "up_at_write": up_w,
                        "epoch_at_write": ep_w, "up_at_read": up_r,
                        "epoch_at_read": ep_r, "pg_at_read": pg_r,
                        "acked_by": acked[-1][0],
                        "write_attempts": acked,
                        "answered_by": tries[-1][0] if tries else None,
                        "read_attempts": tries,
                        "data": data, "at_s": time.monotonic() - t0})
                time.sleep(0.05)

        t = threading.Thread(target=loader, daemon=True)
        t.start()
        try:
            adm.rolling_restart()
        finally:
            stop.set()
            t.join(timeout=60)
        # did each unreadable object come back later (recovery), or
        # is it lost?
        for b in bad:
            data = b.pop("data")
            deadline = time.monotonic() + 30
            b["reads_back_after_s"] = None
            while time.monotonic() < deadline:
                try:
                    if client.read("up", b["oid"]) == data:
                        b["reads_back_after_s"] = round(
                            time.monotonic() - t0 - b["at_s"], 3)
                        break
                except Exception:  # noqa: BLE001 - still recovering
                    pass
                time.sleep(0.3)
            b["at_s"] = round(b["at_s"], 3)
        out["unreadable"] = bad
    except Exception as e:  # noqa: BLE001 - the run's outcome
        out["error"] = repr(e)[:300]
    finally:
        adm.teardown()
    out["seconds"] = round(time.monotonic() - t0, 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3,
                    help="staircases in all")
    ap.add_argument("--parallel", type=int, default=3,
                    help="clusters at once, each in its own interpreter")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        with tempfile.TemporaryDirectory(prefix="rr_enoent_") as base:
            print(json.dumps(one_run(args.one, base)), flush=True)
        return 0

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    seeds = list(range(args.seed, args.seed + args.runs))
    lines, running = [], []
    sink = open(args.out, "w") if args.out else None

    def emit(line: str) -> None:
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    while seeds or running:
        while seeds and len(running) < args.parallel:
            s = seeds.pop(0)
            running.append((s, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--one", str(s)],
                stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)))
        s, p = running.pop(0)
        try:
            text, _ = p.communicate(timeout=600)
            row = json.loads(text.strip().splitlines()[-1])
        except (subprocess.TimeoutExpired, IndexError, ValueError) as e:
            p.kill()
            p.communicate(timeout=30)
            row = {"seed": s, "error": f"run failed: {e!r}"[:300],
                   "acked": 0, "unreadable": []}
        lines.append(row)
        emit(json.dumps(row))
    summary = {
        "staircases": len(lines), "parallel": args.parallel,
        "acked": sum(r["acked"] for r in lines),
        "acked_unreadable": sum(len(r["unreadable"]) for r in lines),
        "lost": sum(1 for r in lines for b in r["unreadable"]
                    if b.get("reads_back_after_s") is None),
        "runs_with_error": [r["seed"] for r in lines if r.get("error")]}
    emit(json.dumps(summary))
    if sink:
        sink.close()
    return 1 if summary["acked_unreadable"] else 0


if __name__ == "__main__":
    sys.exit(main())
