"""Multi-process worker: one process of a torch.distributed group.

The counterpart of ``ceph_tpu/parallel/dcn_worker.py``: N processes,
each with ``--devices-per-host`` logical devices (on one card, or on
the CPU), join one gloo group over a localhost address, build the host
mesh whose "host" axis is the process boundary, and run the distributed
EC write and recovery steps with every check computed inside the step
(replicated scalars out, nothing of another process gathered).

    python -m ceph_tpu_torch.parallel.dcn_worker \\
        --coordinator 127.0.0.1:PORT --num-processes 2 --process-id I \\
        [--devices-per-host 4] [--device cuda|cpu]

``launch`` starts such a group as children and returns each worker's
result line; parallel/dryrun.py and the tests call it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

#: how long the reap of a worker killed in ``launch``'s cleanup may take
REAP_DEADLINE_S = 10.0

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--devices-per-host", type=int, default=4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ceph_tpu_torch.models.stripe_codec import StripeCodec
    from ceph_tpu_torch.ops import ec_kernels
    from ceph_tpu_torch.parallel import (DistributedStripeEC,
                                         init_multihost, make_host_mesh)
    from ceph_tpu_torch.parallel import mesh as meshmod
    from ceph_tpu_torch.parallel.distributed import global_sum

    if args.device == "cpu":
        torch.set_num_threads(1)
    meshmod.force_devices(args.device, args.devices_per_host)
    joined = init_multihost(args.coordinator, args.num_processes,
                            args.process_id)
    if not joined:
        raise SystemExit("init_multihost declined a multi-process group")
    try:
        assert meshmod.process_count() == args.num_processes
        devs = meshmod.devices(args.device)
        mesh = make_host_mesh(devices=devs)  # host axis = the processes
        assert mesh.shape["host"] == args.num_processes
        codec = StripeCodec(k=8, m=3)
        dec = DistributedStripeEC(codec, mesh, batch_axes=("host", "dp"))

        B = 2 * dec.n_dp
        L = 256 * dec.n_shard
        # every process derives the same global payload and stages only
        # its own blocks of it
        data_np = np.random.default_rng(42).integers(
            0, 256, (B, 8, L), dtype=np.uint8)
        ec_kernels.reset_launches()
        stack, digest = dec.write_step(data_np)

        def sys_err(sl, t):
            # the data rows of this block against the payload
            rows = range(sl[1].start, sl[1].stop)
            keep = [i for i in rows if i < 8]
            if not keep:
                return 0
            want = torch.from_numpy(np.ascontiguousarray(
                data_np[sl[0], keep[0]:keep[-1] + 1, sl[2]])).to(t.device)
            return (t[:, :len(keep)] ^ want).to(torch.int64).sum()

        def rec_err(sl, t):
            want = torch.from_numpy(np.ascontiguousarray(
                data_np[sl])).to(t.device)
            return (t ^ want).to(torch.int64).sum()

        available = [0, 2, 3, 5, 6, 7, 8, 10]  # chunks 1, 4, 9 lost
        rec = dec.recovery_step(available)(stack)
        stats = dec.make_stats_step()(stack)
        result = {
            "process_id": args.process_id,
            "process_count": meshmod.process_count(),
            "devices_total": len(devs),
            "devices_local": len(meshmod.local_devices(args.device)),
            "mesh": mesh.shape,
            "digest": int(np.asarray(digest)),
            "systematic_err": global_sum(stack, sys_err),
            "recovery_err": global_sum(rec, rec_err),
            "stats_sum": int(np.asarray(stats).astype(np.uint64).sum()),
            "launches": ec_kernels.launch_counts(),
            "device_launches": {f"{d}/{k}": n for (d, k), n in sorted(
                ec_kernels.device_launch_counts().items())},
            "foreign_modules": sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "ceph_tpu")),
        }
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps(result))
    return 0 if result["systematic_err"] == 0 and \
        result["recovery_err"] == 0 else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(num_processes: int = 2, devices_per_host: int = 4,
           device: str = "cuda", timeout: float = 120.0) -> list[dict]:
    """Run the worker in ``num_processes`` children on a localhost
    address (each process with ``devices_per_host`` logical devices of
    ``device``); returns each worker's result line.  A worker that fails
    or outlives ``timeout`` raises AssertionError with its stderr, and
    no child outlives the call."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.parallel.dcn_worker",
         "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(num_processes), "--process-id", str(i),
         "--devices-per-host", str(devices_per_host), "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for i in range(num_processes)]
    results = []
    try:
        for i, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired as e:
                raise AssertionError(f"worker {i} still running after "
                                     f"{timeout} s") from e
            assert proc.returncode == 0, \
                f"worker {i} rc={proc.returncode}\n{err[-2000:]}"
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        # one failed worker must not orphan the others (they block in
        # init_process_group or a collective); a reap that outlives its
        # deadline raises rather than holding the caller for good
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=REAP_DEADLINE_S)
    return results


if __name__ == "__main__":
    sys.exit(main())
