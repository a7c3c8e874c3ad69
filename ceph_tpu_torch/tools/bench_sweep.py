"""The port's BASELINE sweep tool: each benchmark configuration as a
subprocess with a timeout and retries, results kept in a resumable state
file.

The twin of the JAX package's ``ceph_tpu/tools/bench_sweep.py``: the
BASELINE rows (configs 1-5) — the matrix codes ride tools/bench_tpu (the
kernels on the card, digest-verified), SHEC and CLAY ride
tools/ec_benchmark ``--json``, on the ``native`` backend and on
``torch`` (the reference's ``jax`` rows) — and the ``bench_root`` rows,
which drive tools/bench_root's modes (the twin of the reference's
repo-root bench.py) and keep the keys each row's ``extract`` names.
Rows that share a tool and arguments share one child run per sweep.
Every child gets ``--device``.  ``--multichip [PATH]`` writes the
reference's MULTICHIP-style blob instead of sweeping: the multi-device
dry run (``python -m ceph_tpu_torch.parallel.dryrun --device``, in
place of the reference's ``__graft_entry__.dryrun_multichip``) and the
``ec_batch_sharded`` row's bench (``--ec-batch --no-overhead``: the
sharded burst's numbers, without the tracing and exemplar overhead
legs, whose 5 % gates compare host times and are the
``trace_overhead`` row's).

The state file lies under the git-ignored ``ceph_tpu_torch/build/``
(``BENCH_SWEEP.json``, or ``BENCH_SWEEP_CPU.json`` for ``--device cpu``,
so a CPU number never fills a card row).  It is rewritten atomically
after every configuration; a re-run skips configurations that already
hold a result unless ``--fresh`` or ``--only`` is given.

    python -m ceph_tpu_torch.tools.bench_sweep               # resume/fill
    python -m ceph_tpu_torch.tools.bench_sweep --only headline_1M_b64
    python -m ceph_tpu_torch.tools.bench_sweep --device cpu --fresh
    python -m ceph_tpu_torch.tools.bench_sweep --multichip out.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD = os.path.join(REPO, "ceph_tpu_torch", "build")
#: state file of each device
STATE = {"cuda": os.path.join(BUILD, "BENCH_SWEEP.json"),
         "cpu": os.path.join(BUILD, "BENCH_SWEEP_CPU.json")}
#: the module each configuration's ``tool`` runs
TOOLS = {"bench_tpu": "ceph_tpu_torch.tools.bench_tpu",
         "ec_benchmark": "ceph_tpu_torch.tools.ec_benchmark",
         "bench_root": "ceph_tpu_torch.tools.bench_root"}

MiB = 1024 * 1024


def configs() -> list[dict]:
    """The BASELINE rows, ids and arguments as the reference's with its
    ``jax`` backend as ``torch``, then the ``bench_root`` rows as the
    reference's."""
    out = []

    def tpu(cid, k, m, stripe, batch, technique="reed_sol_van",
            workload="encode", reps=3):
        out.append({
            "id": cid, "tool": "bench_tpu",
            "argv": ["--k", str(k), "--m", str(m),
                     "--stripe-bytes", str(stripe),
                     "--batch", str(batch), "--reps", str(reps),
                     "--technique", technique,
                     "--workload", workload]})

    def plugin(cid, name, params, workload="encode", size=8 * MiB,
               iterations=5, erasures=1):
        argv = ["--plugin", name, "--workload", workload,
                "--size", str(size), "--iterations", str(iterations),
                "--json"]
        if workload == "decode":
            argv += ["--erasures", str(erasures)]
        for kv in params:
            argv += ["--parameter", kv]
        out.append({"id": cid, "tool": "ec_benchmark", "argv": argv})

    # 1. BASELINE config 1: reed_sol_van k=2 m=1, 1 MiB stripe
    tpu("rs_k2m1_1M_b64", 2, 1, MiB, 64)
    # 2. the headline k=8 m=3: 4K-4M stripes, ~64 MiB of data a launch
    for stripe in (4096, 64 * 1024, MiB, 4 * MiB):
        batch = max(1, min(64, (64 * MiB) // stripe))
        tag = (f"{stripe // 1024}K" if stripe < MiB
               else f"{stripe // MiB}M")
        tpu(f"headline_{tag}_b{batch}", 8, 3, stripe, batch)
    # batch scaling at the headline point
    for batch in (2, 8, 16, 64):
        tpu(f"headline_1M_batch{batch}", 8, 3, MiB, batch)
    # decode (the recovery hot path) at the headline point
    tpu("headline_1M_decode", 8, 3, MiB, 64, workload="decode")
    # 3. BASELINE config 3: cauchy k=8 m=4 encode and decode
    tpu("cauchy_k8m4_1M", 8, 4, MiB, 64, technique="cauchy_good")
    tpu("cauchy_k8m4_1M_decode", 8, 4, MiB, 64,
        technique="cauchy_good", workload="decode")
    # 4. BASELINE config 4: shec k=8 m=4 c=3 multi-failure decode
    for backend in ("native", "torch"):
        plugin(f"shec_k8m4c3_{backend}", "shec",
               [f"backend={backend}", "k=8", "m=4", "c=3"])
        plugin(f"shec_k8m4c3_{backend}_decode2", "shec",
               [f"backend={backend}", "k=8", "m=4", "c=3"],
               workload="decode", erasures=2)
    # 5. BASELINE config 5: clay k=8 m=4 d=11 sub-chunk repair
    for backend in ("native", "torch"):
        plugin(f"clay_k8m4d11_{backend}", "clay",
               [f"backend={backend}", "k=8", "m=4", "d=11"])
        plugin(f"clay_k8m4d11_{backend}_repair1", "clay",
               [f"backend={backend}", "k=8", "m=4", "d=11"],
               workload="decode", erasures=1)
    out.extend(bench_root_configs())
    return out


def bench_root_configs() -> list[dict]:
    """The reference's ``bench_root`` rows (6-11): the same ids, argv and
    ``extract`` keys, run by tools/bench_root."""
    def row(cid, argv, extract=None):
        cfg = {"id": cid, "tool": "bench_root", "argv": argv}
        if extract:
            cfg["extract"] = extract
        return cfg

    return [
        # 6. the cross-op batcher legs: the sharded 8-writer burst and
        # the recovery-storm decode burst
        row("ec_batch_sharded", ["--ec-batch"]),
        row("ec_recovery_storm", ["--ec-recovery"]),
        # 6b. the {rs, clay, lrc, shec} wide matrix's compact row
        row("ec_wide_repair", ["--ec-recovery"],
            ["wide_repair_bytes_per_lost_byte", "wide_degraded_p99_ms",
             "wide_locality_beats_rs", "wide_ok", "digest_verified"]),
        # 7. the coalesced read pipeline through a MiniCluster
        row("ec_read_burst", ["--ec-read"]),
        # 8. the device-resident stripe plane
        row("ec_e2e_ratio", ["--ec-batch"],
            ["kernel_gbps", "kernel_leg_gbps", "staging_h2d_gbps",
             "e2e_gbps", "e2e_chunk_kib", "e2e_device_share",
             "e2e_vs_kernel_quiet", "e2e_within_2x_kernel",
             "d2h_copies_per_flush", "single_d2h_per_flush",
             "digest_verified"]),
        # 8a2. the zero-copy wire path
        row("wire_path", ["--ec-batch"],
            ["wire_gbps", "wire_secure_gbps", "wire_msg_mib",
             "wire_tx_flatten_copies_per_op",
             "wire_rx_copy_copies_per_op", "wire_flatten_copies_per_mib",
             "wire_secure_tx_flatten_copies_per_op",
             "wire_secure_rx_copy_copies_per_op", "wire_zero_copy_ok",
             "digest_verified"]),
        # 8a2b. the transport-stack sweep
        row("wire_path_stack", ["--ec-batch"],
            ["wire_stack_posix_gbps",
             "wire_stack_posix_syscalls_tx_per_op",
             "wire_stack_posix_syscalls_rx_per_op",
             "wire_stack_uring_gbps",
             "wire_stack_uring_syscalls_tx_per_op",
             "wire_stack_uring_syscalls_rx_per_op",
             "wire_stack_uring_sqe_batches",
             "wire_stack_uring_reg_buf_recycled",
             "wire_stack_speedup_vs_posix", "wire_uring_active",
             "wire_stack_gate", "wire_stack_ok", "digest_verified"]),
        # 8a3. the async group-commit store pipeline
        row("store_commit", ["--ec-batch"],
            ["store_commit_async_gbps", "store_commit_sync_gbps",
             "store_commit_speedup", "store_fsyncs_per_txn",
             "store_fsyncs_per_txn_rounds", "store_ingest_ref_share",
             "store_commit_ok", "digest_verified"]),
        # 8a4. background LSM maintenance for the KV tier
        row("kv_maint", ["--ec-batch"],
            ["kv_maint_bg_p99_ms", "kv_maint_inline_p99_ms",
             "kv_maint_p99_ratio", "kv_maint_flushes",
             "kv_maint_compactions", "kv_maint_inline_maintenance",
             "kv_maint_stalls", "kv_maint_slowdowns",
             "kv_maint_cache_hits", "kv_maint_identical", "kv_maint_ok",
             "digest_verified"]),
        # 8b. kernel auto-selection: picks and each candidate's GB/s
        row("ec_kernel_pick", ["--ec-batch"],
            ["kernel_gbps", "ec_kernel_picks",
             "ec_kernel_candidates_gbps", "ec_kernel_race_winner",
             "digest_verified"]),
        # 8c. sampled-tracing and exemplar overheads
        row("trace_overhead", ["--ec-batch"],
            ["trace_overhead_gbps", "trace_overhead_pct_at_001",
             "trace_overhead_ok", "exemplar_overhead_pct_at_001",
             "exemplar_overhead_ok", "digest_verified"]),
        # 8d. the hot-object read storm
        row("read_storm", ["--read-storm"],
            ["value", "vs_baseline", "spread", "lease_hit_rate", "legs",
             "gates", "digest_verified"]),
        # 9. the many-client saturation harness
        row("saturate_qos", ["--saturate"],
            ["value", "vs_baseline", "saturation_knee_per_s",
             "client_read_p50_ms", "client_read_p99_ms",
             "client_write_p50_ms", "client_write_p99_ms",
             "recovery_eta_s", "recovery_wall_s", "msgs_per_op",
             "slow_ops_trips", "qos", "ok"]),
        # 10. the multi-tenant QoS control plane
        row("saturate_tenant", ["--saturate", "--tenants"],
            ["tenant_isolation_ratio", "gold_solo_qwait_p99_ms",
             "gold_flood_qwait_p99_ms", "gold_flood_achieved_per_s",
             "weight_split_ratio", "weight_served", "controller_retunes",
             "controller_final_res", "controller_convergence_error",
             "qos_events", "invariants", "ok"]),
        # 11. folded deep scrub and inline compression
        row("scrub_throughput", ["--scrub"],
            ["value", "vs_baseline", "fold_backend", "objects", "bytes",
             "loop_s", "folded_s", "false_mismatches",
             "corruption_detected_both", "ok"]),
        row("compress_ratio", ["--scrub"],
            ["compress_ratio", "compress_roundtrip_ok",
             "incompressible_falls_through", "ok"]),
    ]


def command(cfg: dict, device: str) -> list[str]:
    """The child process of one configuration."""
    return ([sys.executable, "-m", TOOLS[cfg["tool"]]] + cfg["argv"]
            + ["--device", device])


def run_config(cfg: dict, timeout: float, device: str,
               raw_cache: dict | None = None) -> dict:
    """{"result": the child's last JSON line (only the ``extract`` keys
    where the row names them) + wall_s} or {"error": ...}.  Within one
    sweep, rows of the same tool and argv share one child's line
    through ``raw_cache`` (marked ``reused_run``)."""
    t0 = time.time()
    key = (cfg["tool"], tuple(cfg["argv"]))
    raw = raw_cache.get(key) if raw_cache is not None else None
    reused = raw is not None
    if raw is None:
        try:
            proc = subprocess.run(command(cfg, device),
                                  capture_output=True, text=True,
                                  timeout=timeout, cwd=REPO)
        except subprocess.TimeoutExpired:
            return {"error": f"timeout after {timeout:.0f}s"}
        if proc.returncode != 0:
            return {"error": f"rc={proc.returncode}: "
                             f"{proc.stderr.strip()[-500:]}"}
        try:
            raw = json.loads(proc.stdout.strip().splitlines()[-1])
        except (json.JSONDecodeError, IndexError):
            return {"error": f"bad output: {proc.stdout[-300:]}"}
        if raw_cache is not None:
            raw_cache[key] = raw
    result = ({k: raw.get(k) for k in cfg["extract"]}
              if cfg.get("extract") else dict(raw))
    result["wall_s"] = round(time.time() - t0, 1)
    if reused:
        result["reused_run"] = True
    return {"result": result}


def write_state(path: str, state: dict) -> None:
    """The whole table, atomically: a kill mid-write never truncates the
    results already measured."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


#: the bench_root arguments of the multichip blob's sharded-batcher leg
MULTICHIP_BENCH = ["--ec-batch", "--no-overhead"]


def emit_multichip(path: str, device: str, n_devices: int = 8,
                   timeout: float = 600.0) -> int:
    """Write a MULTICHIP-style JSON blob to ``path`` (the reference's
    keys): the dry run on ``n_devices`` logical devices of ``device``
    (the tail of its output from its summary line on) and the sharded
    batcher's bench row.  Returns 0 iff both ran clean."""
    blob = {"n_devices": n_devices, "rc": 0, "ok": True,
            "skipped": False, "tail": ""}
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.parallel.dryrun",
             "--devices", str(n_devices), "--device", device],
            capture_output=True, text=True, timeout=timeout, cwd=REPO)
        blob["rc"] = proc.returncode
        blob["ok"] = proc.returncode == 0
        if proc.returncode == 0:
            out = proc.stdout.strip()
            i = out.rfind("dryrun_multichip")
            blob["tail"] = (out[i:] if i >= 0
                            else (out.splitlines() or [""])[-1]) + "\n"
        else:
            blob["tail"] = (proc.stdout + "\n" + proc.stderr)[-2000:]
    except subprocess.TimeoutExpired:
        blob.update(rc=-1, ok=False,
                    tail=f"dryrun timeout after {timeout:.0f}s")
    bench = run_config({"id": "ec_batch_sharded", "tool": "bench_root",
                        "argv": MULTICHIP_BENCH}, timeout, device)
    blob["ec_batch_sharded"] = bench.get("result", bench)
    if "error" in bench:
        blob["ok"] = False
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    print(json.dumps({"multichip": path, "ok": blob["ok"]}))
    return 0 if blob["ok"] else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fresh", action="store_true",
                   help="ignore (and overwrite) prior sweep state")
    p.add_argument("--only", help="run just this config id")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--timeout", type=float, default=600.0,
                   help="per-config subprocess timeout (s)")
    p.add_argument("--retries", type=int, default=2)
    p.add_argument("--multichip", nargs="?",
                   const="MULTICHIP_BATCH.json", default=None,
                   metavar="PATH",
                   help="emit a MULTICHIP-style JSON blob (the dry run "
                        "+ the sharded batcher's bench) instead of "
                        "sweeping; a relative PATH is under "
                        "ceph_tpu_torch/build/")
    args = p.parse_args(argv)

    if args.multichip:
        path = args.multichip if os.path.isabs(args.multichip) \
            else os.path.join(BUILD, args.multichip)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return emit_multichip(path, args.device, timeout=args.timeout)

    path = STATE[args.device]
    state: dict = {}
    if not args.fresh and os.path.exists(path):
        try:
            with open(path) as f:
                state = json.load(f)
        except (OSError, json.JSONDecodeError):
            state = {}
    todo = [c for c in configs()
            if args.only is None or c["id"] == args.only]
    if not todo:
        p.error(f"no configuration {args.only!r}")
    done = skipped = failed = 0
    raw_cache: dict = {}
    for cfg in todo:
        cid = cfg["id"]
        prior = state.get(cid, {})
        if "result" in prior and args.only is None:
            skipped += 1
            continue
        print(f"sweep: {cid} ...", file=sys.stderr, flush=True)
        for attempt in range(args.retries + 1):
            entry = run_config(cfg, args.timeout, args.device, raw_cache)
            if "result" in entry:
                break
            print(f"sweep: {cid} attempt {attempt + 1} failed: "
                  f"{entry['error'][:200]}", file=sys.stderr, flush=True)
        entry["attempts"] = prior.get("attempts", 0) + attempt + 1
        entry["utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        state[cid] = entry
        if "result" in entry:
            done += 1
        else:
            failed += 1
        write_state(path, state)
    measured = sum(1 for v in state.values() if "result" in v)
    print(json.dumps({"ran": done, "skipped": skipped, "failed": failed,
                      "measured_total": measured,
                      "configs_total": len(configs()),
                      "state_file": path}))
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
