#!/usr/bin/env python
"""The port's benchmark driver: the headline EC kernel GB/s by default,
or one focused mode.  Every mode prints ONE JSON row and exits nonzero
when its acceptance gate fails.

The twin of the JAX package's repo-root ``bench.py``, with its modes,
flags, JSON keys and exit gates:

- ``--ec-batch``: cross-op batched vs per-op encode through an
  ECBatcher (8 writers), the device-resident stripe plane, the kernel
  candidates on a staged fold, the adaptive window, the tracing,
  exemplar and perf-query overheads, and the wire, store-commit and KV
  maintenance legs;
- ``--ec-recovery`` (``--progress``, ``--no-wide``): the recovery-storm
  decode burst, the max_bytes sweep, the {rs, clay, lrc, shec} wide
  matrix and the mgr progress story through a MiniCluster;
- ``--ec-read``, ``--read-storm``: the coalesced read pipeline and the
  hot-object read storm through a MiniCluster;
- ``--saturate`` (``--smoke``, ``--tenants``, ``--frontend rgw``): the
  many-client load harness (ceph_tpu_torch.load), workers as separate
  processes over TCP;
- ``--scrub``: the folded deep scrub through ``ECBatcher.verify`` and
  the inline-compression gates;
- no mode: the headline, tools/bench_tpu in a child (the kernel on the
  card, digest-verified) beside the native library's single-thread
  GB/s.

Where it differs from ``bench.py`` (each pinned by a test):

- ``--device {cuda,cpu}`` (default ``cuda``) takes the place of the
  forced host devices; ``cuda`` with no card exits nonzero and never
  carries on on the CPU.  The kernel modes run on ``--device``; the
  cluster modes put nothing on the card, as in the reference (their
  clusters run ``ec_backend: native`` and ``numpy`` pools).
- The sharded legs fan out over every device of ``--device`` as
  ``parallel.mesh.devices`` lists them: the cards, or the logical
  devices ``force_devices`` set on one (``shard_devices: 1`` on one
  card or the CPU otherwise).
- Kernel legs (the quiet kernel reference and the candidate sweep) are
  timed with CUDA events around the launches alone on the card, on the
  host clock on the CPU.  Only ``kernel_supports`` skips a candidate;
  one that fails to build or launch fails the mode.
- The headline reads no recorded number and has no CPU fallback: its
  child failing fails the run.  Metric strings name the card.
- The fixed sizes of the kernel modes are module constants with the
  reference's values (EC_BATCH_*, PLANE_*, RECOVERY_*).
- ``--ec-batch --no-overhead`` (a flag bench.py lacks) skips the
  tracing, exemplar and perf-query overhead legs and their three 5 %
  gates; without it the mode runs and gates them as bench.py does.
  Each of those gates compares the best of three host-timed bursts of
  ~0.15-0.5 s, and on the card's host two sets of identical bursts
  differ by more than 5 % in most comparisons
  (experiments/burst_noise.py), so a run on the card that must pass
  only on the port's faults leaves them out.

    python -m ceph_tpu_torch.tools.bench_root --ec-batch
    python -m ceph_tpu_torch.tools.bench_root --scrub --device cpu
    python -m ceph_tpu_torch.tools.bench_root --saturate --smoke
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

K, M = 8, 3
STRIPE = 1024 * 1024
DEVICE_TIMEOUT_S = int(os.environ.get("BENCH_TPU_TIMEOUT", "900"))

#: --ec-batch: the burst's chunk bytes, writers and ops per writer
EC_BATCH_CHUNK = 16 * 1024
EC_BATCH_WRITERS, EC_BATCH_OPS = 8, 24
#: --ec-batch's device-resident plane leg: chunk bytes (1 MiB ops),
#: writers, ops per writer, ops per size-triggered flush
PLANE_CHUNK = 128 * 1024
PLANE_WRITERS, PLANE_OPS, PLANE_GROUP = 16, 8, 8
#: --ec-recovery: chunk bytes, readers, ops per reader
RECOVERY_CHUNK = 16 * 1024
RECOVERY_READERS, RECOVERY_OPS = 8, 12
#: clock cycles the card sleeps ahead of the timed kernel launches, so
#: the host has queued every one before the card reaches the first
#: start event (about 50 ms at 1.98 GHz)
KERNEL_LEAD_CYCLES = 100_000_000
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def bench_device(name: str = "cuda"):
    """The torch.device of ``--device``: ``cuda`` is the current card
    and raises RuntimeError where there is none (no CPU fallback)."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda but torch.cuda.is_available() is False "
                "(pass --device cpu to run the plain versions)")
        dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {name!r}")
    return dev


def device_count(dev) -> int:
    """The devices of ``dev``'s kind the sharded legs fan out over: the
    mesh's devices (parallel.mesh.devices)."""
    from ..parallel.mesh import devices

    return len(devices(dev.type))


def device_label(dev) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``."""
    import torch

    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")


def kernel_times(fn, reps: int, dev) -> list[float]:
    """Seconds of each of ``reps`` calls of ``fn()``, which launches
    work on ``dev`` and returns its output.  On the card, CUDA events
    bracket each launch alone: the card first sleeps while the host
    queues every rep.  On the CPU, the host clock brackets the call."""
    import torch

    from ..utils import staging

    if dev.type != "cuda":
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            staging.wait_for(res if isinstance(res, tuple) else (res,))
            out.append(time.perf_counter() - t0)
        return out
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(KERNEL_LEAD_CYCLES)
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize(dev)
    return [s.elapsed_time(e) / 1e3 for s, e in events]


def cpu_baseline_gbps() -> float:
    import numpy as np

    from ..ops import gf256, native

    Mx = gf256.vandermonde_matrix(K, M)
    chunk = STRIPE // K
    batch = 64
    data = np.random.default_rng(0).integers(
        0, 256, (K, batch * chunk), dtype=np.uint8)
    native.encode_region(Mx, data)  # warm
    reps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < 3.0:
        native.encode_region(Mx, data)
        reps += 1
    dt = time.perf_counter() - t0
    return reps * data.nbytes / dt / 2**30


def device_gbps(device: str = "cuda") -> dict:
    """tools/bench_tpu's JSON line at the headline configuration, run
    in a child with a timeout; raises RuntimeError when the child
    fails, times out or prints no JSON line."""
    cmd = [sys.executable, "-m", "ceph_tpu_torch.tools.bench_tpu",
           "--k", str(K), "--m", str(M), "--stripe-bytes", str(STRIPE),
           "--batch", "64", "--reps", "4", "--device", device]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=DEVICE_TIMEOUT_S, cwd=REPO)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"bench_tpu timed out after "
                           f"{DEVICE_TIMEOUT_S} s") from e
    if out.returncode != 0:
        raise RuntimeError(f"bench_tpu failed (rc={out.returncode}):\n"
                           f"{out.stderr[-2000:]}")
    try:
        return json.loads(out.stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError) as e:
        raise RuntimeError(f"bench_tpu printed no JSON line: "
                           f"{out.stdout[-500:]}") from e


def _wire_path_leg() -> dict:
    """The zero-copy wire path, measured: stripe-sized
    MSubWrite payloads over a real socket pair in plaintext and secure
    modes — e2e GB/s plus the copies-per-hop counters.  The structural
    gate is the counter contract, not the GB/s (2-core box variance):
    plaintext hops book ZERO Python-side payload copies (tx flattens
    and rx copies both 0 — the kernel's iovec gather/scatter is the
    only copy left), secure mode at most 2 tx (seal join + cipher
    output) and exactly 1 rx (decrypt)."""
    import threading

    from ..msg import messages as WM
    from ..msg.messenger import Dispatcher, Messenger, Policy
    from ..msg.tcp import TcpNetwork

    payload = bytes(bytearray(range(256)) * 4096)  # 1 MiB, bytes
    pg = WM.PgId(1, 1)

    def leg(n_msgs: int, **net_kw) -> dict:
        net = TcpNetwork(**net_kw)
        tx = Messenger(net, "wire.tx", Policy.lossless_peer())
        rx = Messenger(net, "wire.rx", Policy.lossless_peer())
        done = threading.Event()
        seen = [0]

        class Sink(Dispatcher):
            def ms_dispatch(self, conn, msg):
                if isinstance(msg, WM.MSubWrite):
                    seen[0] += 1
                    if seen[0] >= n_msgs:
                        done.set()
                return True

        rx.add_dispatcher(Sink())
        tx.start()
        rx.start()
        net.set_addr("wire.rx", net.addr_of("wire.rx"))
        try:
            # warm the connection (dial + handshake off the clock),
            # then snapshot the counters so the ping's own seal copies
            # stay out of the per-op math
            tx.send_message("wire.rx", WM.MOSDPing(0, 0, 0.0))
            deadline = time.time() + 10
            while time.time() < deadline and \
                    rx.perf.dump()["msg_dispatched"] < 1:
                time.sleep(0.005)
            tx0, rx0 = tx.perf.dump(), rx.perf.dump()
            t0 = time.perf_counter()
            for i in range(n_msgs):
                tx.send_message(
                    "wire.rx",
                    WM.MSubWrite(i, pg, f"o{i}", -1, 1, "write",
                                 payload))
            done.wait(60)
            dt = time.perf_counter() - t0
            txc, rxc = tx.perf.dump(), rx.perf.dump()
            flat_c = txc["msg_tx_flatten_copies"] \
                - tx0["msg_tx_flatten_copies"]
            copy_c = rxc["msg_rx_copy_copies"] \
                - rx0["msg_rx_copy_copies"]
            mib = n_msgs * len(payload) / 2**20
            return {
                "gbps": round(n_msgs * len(payload) / dt / 2**30, 3),
                "tx_flatten_copies_per_op": round(flat_c / n_msgs, 3),
                "tx_flatten_bytes": txc["msg_tx_flatten_bytes"]
                - tx0["msg_tx_flatten_bytes"],
                "rx_copy_copies_per_op": round(copy_c / n_msgs, 3),
                "rx_copy_bytes": rxc["msg_rx_copy_bytes"]
                - rx0["msg_rx_copy_bytes"],
                "flatten_copies_per_mib": round(flat_c / mib, 4),
                "syscalls_tx_per_op": round(
                    (txc["msg_syscalls_tx"]
                     - tx0["msg_syscalls_tx"]) / n_msgs, 3),
                "syscalls_rx_per_op": round(
                    (rxc["msg_syscalls_rx"]
                     - rx0["msg_syscalls_rx"]) / n_msgs, 3),
                "sqe_batches": txc["msg_uring_sqe_batch"]
                - tx0["msg_uring_sqe_batch"],
                "reg_buf_recycled": rxc["msg_uring_reg_buf_recycled"]
                - rx0["msg_uring_reg_buf_recycled"],
                "delivered": seen[0] >= n_msgs,
            }
        finally:
            tx.shutdown()
            rx.shutdown()
            net.stop()

    plain = leg(48)
    secure = leg(16, auth_secret=b"bench-wire", secure=True)
    ok = (plain["delivered"] and secure["delivered"]
          and plain["tx_flatten_copies_per_op"] == 0
          and plain["rx_copy_copies_per_op"] == 0
          and secure["tx_flatten_copies_per_op"] <= 2
          and secure["rx_copy_copies_per_op"] <= 1)
    out = {
        "wire_gbps": plain["gbps"],
        "wire_msg_mib": 1,
        "wire_tx_flatten_copies_per_op":
            plain["tx_flatten_copies_per_op"],
        "wire_rx_copy_copies_per_op": plain["rx_copy_copies_per_op"],
        "wire_flatten_copies_per_mib": plain["flatten_copies_per_mib"],
        "wire_secure_gbps": secure["gbps"],
        "wire_secure_tx_flatten_copies_per_op":
            secure["tx_flatten_copies_per_op"],
        "wire_secure_rx_copy_copies_per_op":
            secure["rx_copy_copies_per_op"],
        "wire_zero_copy_ok": ok,
    }
    # ---- per-stack sweep: the SAME plaintext leg on each
    # transport stack.  The structural gate is the syscall/copy
    # counter contract, not the GB/s (a loopback socket pair on a
    # small box is kernel-copy bound either way): the uring stack
    # must batch its SQE chains (tx kernel entries per frame < 1,
    # sqe_batches booked) and keep the Python-side rx copy count at
    # the posix stack's zero.  Where io_uring is unavailable the gate
    # records SKIPPED — never a failure — and posix numbers stand.
    from ..msg import uring as _uring
    out.update({
        "wire_stack_posix_gbps": plain["gbps"],
        "wire_stack_posix_syscalls_tx_per_op":
            plain["syscalls_tx_per_op"],
        "wire_stack_posix_syscalls_rx_per_op":
            plain["syscalls_rx_per_op"],
        "wire_uring_active": False,
        "wire_stack_gate": "skipped",
        "wire_stack_ok": True,
    })
    if _uring.available():
        u = leg(48, stack="uring")
        contracts = (u["delivered"]
                     and u["syscalls_tx_per_op"] < 1.0
                     and u["tx_flatten_copies_per_op"] == 0
                     and u["rx_copy_copies_per_op"] == 0
                     and u["sqe_batches"] >= 1)
        out.update({
            "wire_uring_active": True,
            "wire_stack_uring_gbps": u["gbps"],
            "wire_stack_uring_syscalls_tx_per_op":
                u["syscalls_tx_per_op"],
            "wire_stack_uring_syscalls_rx_per_op":
                u["syscalls_rx_per_op"],
            "wire_stack_uring_sqe_batches": u["sqe_batches"],
            "wire_stack_uring_reg_buf_recycled":
                u["reg_buf_recycled"],
            "wire_stack_speedup_vs_posix": round(
                u["gbps"] / max(plain["gbps"], 1e-9), 3),
            "wire_stack_gate": "passed" if contracts else "failed",
            "wire_stack_ok": bool(contracts),
        })
    else:
        out["wire_stack_skip_reason"] = _uring.unavailable_reason()
    return out


def _store_commit_leg() -> dict:
    """The async group-commit transaction pipeline, measured
   : an 8-writer burst of 1 MiB object writes on a real
    BlueStore, async (kv-sync/finisher pipeline) vs sync (inline
    fsync-per-txn baseline).  The structural gates: fsyncs per
    transaction < 0.5 on the async leg's best round (group commit is
    REAL — one device fsync + one KV fsync cover many transactions)
    and async throughput at or above the sync baseline (best-of-N;
    the pipeline must never cost throughput).  Payloads submit as
    memoryviews so the by-reference ingest path (whole pages sliced
    zero-copy into the buffered device write) is exercised and its
    ref/copy split reported."""
    import tempfile
    import threading

    import numpy as np

    from ..osd.bluestore import BlueStore
    from ..osd.objectstore import (CollectionId, ObjectId,
                                          Transaction)
    from ..utils.perf import global_perf

    writers, per = 8, 8
    payload = np.random.default_rng(3).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    nbytes_round = writers * per * len(payload)
    cid = CollectionId(9, 1)

    def burst(store, tag: str) -> float:
        barrier = threading.Barrier(writers + 1)

        def w(wi: int) -> None:
            barrier.wait()
            for i in range(per):
                store.queue_transaction(
                    Transaction().write(cid, ObjectId(f"{tag}-{wi}-{i}"),
                                        0, memoryview(payload)))

        ts = [threading.Thread(target=w, args=(wi,))
              for wi in range(writers)]
        for t in ts:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in ts:
            t.join()
        store.flush()  # durability barrier: every on_commit fired
        return time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as d:
        # both stores up front, rounds INTERLEAVED sync/async so box
        # noise hits both legs alike (the trace-overhead leg's
        # best-of-N treatment); compression off on both — this
        # measures the commit pipeline, not zlib.  kv_backend=sst:
        # the leveled LSM is the measured metadata path
        sync = BlueStore(os.path.join(d, "sync"), compression="none",
                         kv_backend="sst")
        sync.mount()
        sync.queue_transaction(Transaction().create_collection(cid))
        # async pipeline: throughput-tuned window knobs (the OSD's
        # defaults favor latency; a bench burst wants deep batches)
        st = BlueStore(os.path.join(d, "async"), compression="none",
                       kv_backend="sst")
        st.mount()
        st.enable_async(name="bench", window_us=20000.0,
                        window_min_us=2000.0, window_max_us=60000.0,
                        target_txns=12.0)
        st.queue_transaction(Transaction().create_collection(cid))
        st.flush()
        perf = global_perf().registries()["store.bench"]
        # drain any earlier bench legs' dirty pages, then one unmeasured
        # warmup round per store: cold allocation/writeback effects land
        # off the clock (both legs, same treatment)
        os.sync()
        burst(sync, "warm-s")
        burst(st, "warm-a")
        sync_walls, async_walls, ratios = [], [], []
        rounds = 4
        for r in range(rounds):
            sync_walls.append(burst(sync, f"s{r}"))
            p0 = perf.dump()
            async_walls.append(burst(st, f"a{r}"))
            p1 = perf.dump()
            dtx = p1["store_txns"] - p0["store_txns"]
            dfs = p1["store_fsyncs"] - p0["store_fsyncs"]
            ratios.append(round(dfs / dtx, 3) if dtx else None)
        totals = perf.dump()
        sync.umount()
        digest_ok = all(
            st.read(cid, ObjectId(f"a{rounds - 1}-{wi}-{per - 1}")
                    ).to_bytes() == payload
            for wi in range(writers))
        ref_b = totals["store_ingest_ref_bytes"]
        copy_b = totals["store_ingest_copy_bytes"]
        st.umount()
        st.disable_async()
    sync_gbps = nbytes_round / min(sync_walls) / 2**30
    async_gbps = nbytes_round / min(async_walls) / 2**30
    best_ratio = min(r for r in ratios if r is not None)
    ok = (digest_ok and best_ratio < 0.5 and async_gbps >= sync_gbps)
    return {
        "store_commit_async_gbps": round(async_gbps, 3),
        "store_commit_sync_gbps": round(sync_gbps, 3),
        "store_commit_speedup": (round(async_gbps / sync_gbps, 3)
                                 if sync_gbps > 0 else None),
        "store_fsyncs_per_txn": best_ratio,
        "store_fsyncs_per_txn_rounds": ratios,
        "store_txns": totals["store_txns"],
        "store_fsyncs": totals["store_fsyncs"],
        "store_batches": totals["store_batches"],
        "store_ingest_ref_share": (round(ref_b / (ref_b + copy_b), 3)
                                   if ref_b + copy_b else None),
        "store_commit_ok": ok,
    }


def _kv_maint_leg() -> dict:
    """Background LSM maintenance for the KV tier, measured
    + gated: a sustained omap-heavy write burst on BlueStore over
    ``kv_backend=sst`` with a small memtable, spanning many memtable
    flushes and at least one compaction.  The inline leg
    (``kv_bg_maintenance=off``) shows the cliff — the batch that tips
    the memtable pays the whole flush (and any cascading level merge)
    inside the kv-sync thread, so every commit behind it inherits the
    wall.  The background leg gates on: ZERO inline flush/compaction
    in the kv-sync thread (counted ``kv_*_inline``), commit p99
    STRICTLY below the inline leg, a nonzero block-cache hit count on
    the hot-read leg, and byte-identity vs the inline path over the
    full KV op grid (rm_prefix + tombstone-shadowing included) and the
    store's logical state."""
    import random
    import tempfile
    import threading

    from ..osd.bluestore import BlueStore
    from ..osd.kvstore import KVTransaction, MemKV
    from ..osd.objectstore import (CollectionId, ObjectId,
                                          Transaction)
    from ..osd.sstkv import SstKV
    from ..utils.perf import global_perf

    # ---- KV-grid byte identity: one deterministic op stream (puts,
    # overwrites, rms, rm_prefix, tombstone-shadowing across flush
    # boundaries) through bg-sst, inline-sst and the MemKV oracle
    def drive_kv_grid(kv) -> None:
        rng = random.Random(1510)
        keys = [f"k{i:03d}" for i in range(120)]
        for step in range(900):
            r = rng.random()
            prefix = rng.choice(("p1", "p2", "gone"))
            key = rng.choice(keys)
            if r < 0.62:
                kv.put(prefix, key, rng.randbytes(rng.randrange(64, 512)))
            elif r < 0.87:
                kv.rm(prefix, key)  # tombstones shadow flushed values
            elif r < 0.97:
                # multi-op tx: put-then-rm_prefix-then-put ordering
                kv.submit(KVTransaction()
                          .put("gone", f"e{step}", b"early")
                          .rm_prefix("gone")
                          .put("gone", f"l{step}", b"late"))
            else:
                kv.submit(KVTransaction().rm_prefix("p2"))

    def kv_dump(kv) -> dict:
        return {p: list(kv.iterate(p)) for p in ("p1", "p2", "gone")}

    grid_identical = True
    with tempfile.TemporaryDirectory() as d:
        oracle = MemKV()
        drive_kv_grid(oracle)
        for tag, bg in (("bg", True), ("inline", False)):
            kv = SstKV(os.path.join(d, tag), memtable_bytes=4096,
                       background=bg)
            drive_kv_grid(kv)
            if kv_dump(kv) != kv_dump(oracle):
                grid_identical = False
            kv.close()
            # remount: durable image replays to the same contents
            kv = SstKV(os.path.join(d, tag), memtable_bytes=4096,
                       background=bg)
            if kv_dump(kv) != kv_dump(oracle):
                grid_identical = False
            kv.close()

    # ---- the commit-latency burst: omap-heavy transactions so the
    # KV tier (not the page device) dominates each group commit.
    # Group commit merges each batch into ONE vectored KV submit, so
    # seals track BATCH count (a submit that tips the memtable seals
    # once however much it carried) — the memtable budget and the
    # L0 trigger are set low enough that the burst spans many seals
    # and at least one compaction
    writers, per = 4, 48
    nkeys, vbytes = 4, 2048  # ~8 KiB of KV mutations per txn
    cid = CollectionId(15, 1)
    payload = random.Random(15).randbytes(vbytes)

    def burst(store, tag: str) -> list[float]:
        lats: list[float] = []
        barrier = threading.Barrier(writers)

        def w(wi: int) -> None:
            barrier.wait()
            for i in range(per):
                kv = {f"{tag}-{wi}-{i}-{j}": payload
                      for j in range(nkeys)}
                t0 = time.perf_counter()
                store.queue_transaction(
                    Transaction().omap_setkeys(
                        cid, ObjectId(f"o-{wi}"), kv),
                    on_commit=lambda t0=t0: lats.append(
                        time.perf_counter() - t0))

        ts = [threading.Thread(target=w, args=(wi,))
              for wi in range(writers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        store.flush()
        return lats

    def p99(lats: list[float]) -> float:
        s = sorted(lats)
        return s[min(len(s) - 1, int(0.99 * len(s)))]

    with tempfile.TemporaryDirectory() as d:
        stores = {}
        for tag, bg in (("bg", True), ("inline", False)):
            st = BlueStore(os.path.join(d, tag), compression="none",
                           kv_backend="sst", kv_name=f"bench-{tag}",
                           kv_memtable_bytes=16 * 1024,
                           kv_background=bg)
            st.mount()
            # low L0 trigger (same on both legs): the burst must span
            # at least one level merge, the wall the inline leg pays
            st._kv.L0_COMPACT_FILES = 3
            st.enable_async(name=f"kvm-{tag}")
            st.queue_transaction(Transaction()
                                 .create_collection(cid)
                                 .touch(cid, ObjectId("seed")))
            st.flush()
            stores[tag] = st
        kv_perf = {t: global_perf().registries()[f"kv.bench-{t}"]
                   for t in stores}
        p0 = {t: kv_perf[t].dump() for t in stores}
        # rounds interleaved bg/inline so box noise hits both alike;
        # best (min) p99 per leg
        p99s = {"bg": [], "inline": []}
        rounds = 4
        for r in range(rounds):
            for tag in ("bg", "inline"):
                p99s[tag].append(p99(burst(stores[tag], f"r{r}")))
        # quiesce: in-flight background flush/compaction must finish
        # before the counter deltas are read (the p99s above were
        # already taken — waiting here costs the gate nothing)
        stores["bg"]._kv.wait_maintenance_idle()
        p1 = {t: kv_perf[t].dump() for t in stores}
        delta = {t: {k: p1[t][k] - p0[t][k]
                     for k in ("kv_flush", "kv_compact",
                               "kv_flush_inline", "kv_compact_inline",
                               "kv_stall_memtable", "kv_stall_l0",
                               "kv_slowdown")}
                 for t in stores}
        # ---- hot-read leg: repeated gets against the bg store's LSM
        # (onode-lookup shape: bloom + index + block via the shared
        # cache) — the hit counter must move
        kv = stores["bg"]._kv
        hot = [k for k, _v in itertools.islice(kv.iterate("M"), 16)]
        h0 = kv_perf["bg"].get("kv_cache_hit")
        for _ in range(40):
            for k in hot:
                kv.get("M", k)
        cache_hits = kv_perf["bg"].get("kv_cache_hit") - h0
        # ---- store-level identity: both stores ran the same txn
        # stream; their logical contents must match
        store_identical = True
        for wi in range(writers):
            oid = ObjectId(f"o-{wi}")
            if stores["bg"].omap_get(cid, oid) \
                    != stores["inline"].omap_get(cid, oid):
                store_identical = False
        for st in stores.values():
            st.umount()
            st.disable_async()
    bg_p99, inline_p99 = min(p99s["bg"]), min(p99s["inline"])
    inline_maint = (delta["bg"]["kv_flush_inline"]
                    + delta["bg"]["kv_compact_inline"])
    ok = (grid_identical and store_identical
          and delta["bg"]["kv_flush"] >= 4
          and delta["bg"]["kv_compact"] >= 1
          and inline_maint == 0
          and bg_p99 < inline_p99
          and cache_hits > 0)
    return {
        "kv_maint_bg_p99_ms": round(bg_p99 * 1e3, 3),
        "kv_maint_inline_p99_ms": round(inline_p99 * 1e3, 3),
        "kv_maint_p99_ratio": (round(inline_p99 / bg_p99, 2)
                               if bg_p99 > 0 else None),
        "kv_maint_p99_rounds_ms": {
            t: [round(v * 1e3, 3) for v in vs]
            for t, vs in p99s.items()},
        "kv_maint_flushes": delta["bg"]["kv_flush"],
        "kv_maint_compactions": delta["bg"]["kv_compact"],
        "kv_maint_inline_maintenance": inline_maint,
        "kv_maint_inline_leg_flushes_inline":
            delta["inline"]["kv_flush_inline"],
        "kv_maint_stalls": (delta["bg"]["kv_stall_memtable"]
                            + delta["bg"]["kv_stall_l0"]),
        "kv_maint_slowdowns": delta["bg"]["kv_slowdown"],
        "kv_maint_cache_hits": cache_hits,
        "kv_maint_identical": grid_identical and store_identical,
        "kv_maint_ok": ok,
    }


def ec_batch_bench(trace: bool = False, device: str = "cuda",
                   overhead: bool = True) -> int:
    """`--ec-batch` mode: cross-op batched vs per-op encode under a
    simulated multi-client write burst (8 writer threads submitting
    full-stripe encodes through an ECBatcher), same one-line JSON
    schema as the headline.  value = batched-path GB/s; vs_baseline =
    batched / per-op (pass-through, window=0) on the same buffers;
    extra keys carry ops/launch and flush-reason counts, the SHARDED
    batcher leg (a codec asking for every device of ``device``: one
    card, or the CPU), and the adaptive-window trajectory (after a
    single-writer trickle vs after the burst).  Parity is
    digest-verified against the numpy gf256 oracle for EVERY op.

    Device-resident stripe plane: the batched burst IS the end-to-end
    number (host payloads in -> host parity out through the staging
    path), reported as `e2e_gbps` next to a `kernel_gbps` reference
    (the same folded launch on an already-staged buffer on the device,
    timed with CUDA events on the card) and the `e2e_device_share` the
    acceptance gate tracks (share >= 0.5 == e2e within 2x of the
    burst's realized kernel).  The `ec_stage_*` counter deltas across
    the batched burst assert the single-copy contract:
    `d2h_copies_per_flush` must be exactly 1.0."""
    import threading

    import numpy as np

    from .. import ec
    from ..ec.batcher import ECBatcher
    from ..ops import gf256
    from ..utils import staging as stg

    dev = bench_device(device)
    n_dev = device_count(dev)
    chunk = EC_BATCH_CHUNK
    writers, ops_per = EC_BATCH_WRITERS, EC_BATCH_OPS
    codec = ec.factory("tpu", {"k": K, "m": M, "backend": "torch",
                               "device": str(dev), "shard": "off"})
    sharded_codec = ec.factory("tpu", {"k": K, "m": M,
                                       "backend": "torch",
                                       "device": str(dev),
                                       "shard": str(n_dev)})
    rng = np.random.default_rng(5)
    payloads = [[rng.integers(0, 256, (K, chunk), dtype=np.uint8)
                 for _ in range(ops_per)] for _ in range(writers)]

    def burst(batcher, cdc, plays=None):
        plays = payloads if plays is None else plays
        n_wr, n_ops = len(plays), len(plays[0])
        results = [[None] * n_ops for _ in range(n_wr)]
        barrier = threading.Barrier(n_wr + 1)

        def writer(w):
            barrier.wait()
            for i, data in enumerate(plays[w]):
                results[w][i] = np.asarray(
                    batcher.encode(cdc, data)[0])

        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(n_wr)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        return results, time.perf_counter() - t0

    # warm the kernel race off the clock: every pow2 stripe-count
    # fold shape a burst can produce (coalescing patterns vary run to
    # run; a race of three candidates leaking into the timed burst
    # would swamp the measurement), then one full warm burst per codec
    from ..ec.batcher import bucket_len, shard_pad
    bucket = bucket_len(chunk)
    n2 = 1
    while n2 <= writers:
        codec.encode_chunks(np.zeros((K, n2 * bucket), dtype=np.uint8))
        # sharded shapes use the flush path's shard_pad padding
        ns, n2s = shard_pad(n2, n_dev)
        sharded_codec._matmul_device(
            sharded_codec.matrix,
            np.zeros((K, n2s * bucket), dtype=np.uint8), n_shard=ns)
        n2 <<= 1
    burst(ECBatcher(window_us=2000, max_bytes=64 << 20), codec)
    burst(ECBatcher(window_us=2000, max_bytes=64 << 20), sharded_codec)

    batched = ECBatcher(window_us=2000, max_bytes=64 << 20)
    res_b, dt_b = burst(batched, codec)
    sharded = ECBatcher(window_us=2000, max_bytes=64 << 20)
    res_s, dt_s = burst(sharded, sharded_codec)
    perop = ECBatcher(window_us=0)
    res_p, dt_p = burst(perop, codec)

    # ---- device-resident stripe-plane leg ----
    # e2e: a steady-state SIZE-flushed burst — max_bytes sized to one
    # 8-op fold, a long window only as tail backstop — so the number
    # measures the marshalling + kernel pipeline (host payloads in ->
    # host parity out) rather than the coalescing-window policy the
    # legs above characterize.  Chunks are 128 KiB (1 MiB ops): the
    # plane is a DATA-MOVEMENT gate, so the workload is sized where
    # byte motion, not per-op Python dispatch, carries the time —
    # the 16 KiB legs above keep covering the small-op regime.  The
    # ec_stage_* counter deltas across this leg assert the plane's
    # contract: EXACTLY one metered device->host copy per launch.
    # 2x the flush group size in writers, so a second group is always
    # staging while the first one's folded launch runs — the burst
    # measures the PIPELINE, not serialized group round-trips (an OSD
    # under load always has the next stripe queued)
    plane_chunk = PLANE_CHUNK
    plane_writers, plane_ops = PLANE_WRITERS, PLANE_OPS
    plane_group = PLANE_GROUP  # ops per size-triggered flush
    plane_bucket = bucket_len(plane_chunk)
    plane_payloads = [
        [rng.integers(0, 256, (K, plane_chunk), dtype=np.uint8)
         for _ in range(plane_ops)] for _ in range(plane_writers)]
    spc = stg.stage_perf()

    def stage_snap() -> dict:
        d = spc.dump()
        return {"h2d_bytes": d["ec_stage_h2d_bytes"],
                "h2d_copies": d["ec_stage_h2d_copies"],
                "h2d_us": d["ec_stage_h2d_us"]["sum"],
                "d2h_bytes": d["ec_stage_d2h_bytes"],
                "d2h_copies": d["ec_stage_d2h_copies"],
                "d2h_us": d["ec_stage_d2h_us"]["sum"]}

    def plane_batcher():
        return ECBatcher(window_us=10_000,
                         max_bytes=plane_group * K * plane_chunk)

    # in-leg realized kernel time: the profiler's device-execute
    # seconds accumulated by the leg's own launches.  e2e wall divided
    # by this is THE marshalling ratio — when the burst spends at
    # least half its wall time inside the folded launches, staging +
    # orchestration no longer dominate, which is the gap this plane
    # exists to close.  (A quiet device-to-device reference is still
    # reported as kernel_gbps for context, but under load the in-leg
    # measure is the one that compares like with like.)
    from ..utils.perf import kernel_profiler

    def kern_seconds() -> float:
        sigs = kernel_profiler().dump()["signatures"]
        return sum(v["device_seconds"] + v["compile_seconds"]
                   for s, v in sigs.items()
                   if s.startswith(("matmul/", "csum/")))

    # warm the size-flush fold shapes off the clock, then take the
    # best of three timed bursts: this box's background load swings
    # any single rep several-fold, and the gate should compare
    # capability to capability (the kernel reference below gets the
    # same best-of treatment)
    burst(plane_batcher(), codec, plane_payloads)
    s0 = stage_snap()
    k0 = kern_seconds()
    plane = plane_batcher()
    res_e, dt_e = burst(plane, codec, plane_payloads)
    bursts = [(dt_e, kern_seconds() - k0)]
    s1 = stage_snap()
    for _ in range(2):
        k0 = kern_seconds()
        _res2, dt2 = burst(plane_batcher(), codec, plane_payloads)
        bursts.append((dt2, kern_seconds() - k0))
        dt_e = min(dt_e, dt2)
    # device-time share: ratio of a burst's wall clock spent inside
    # the launches (bounded above by 1.0 up to timer noise).  The
    # headline numbers all come from the FASTEST burst; the gate
    # passes when any burst's launches carry at least half its wall
    # (= e2e within 2x of that burst's realized kernel)
    fast_dt, fast_ks = min(bursts, key=lambda t: t[0])
    kern_share = fast_ks / fast_dt
    shares = [round(ks / dt, 3) for dt, ks in bursts if dt > 0]

    # kernel reference: the SAME folded launch shape a full 8-op flush
    # runs, on an already-staged buffer on the device — lanes on the
    # device -> parity on the device (no host copy), the codec's
    # pinned kernel timed with CUDA events on the card.
    # e2e_vs_kernel_quiet compares the plane leg's host-to-host number
    # against this quiet ceiling; the device-resident plane exists to
    # close that gap.
    fold_src = rng.integers(0, 256, (K, plane_group * plane_bucket),
                            dtype=np.uint8)
    dev_fold = stg.device_put_landed(fold_src, dev, record=False)
    stg.wait_for((codec._matmul_device(codec.matrix, dev_fold),))
    pinned = codec._torch_matmul(
        codec.matrix,
        kernel=codec._kernel_pick(codec.matrix, int(dev_fold.shape[1])))
    kern_dts = kernel_times(lambda: pinned(dev_fold), 9, dev)
    kernel_gbps = fold_src.nbytes / min(kern_dts) / 2**30

    # per-candidate kernel realizations on the same staged fold: the
    # ec_kernel_pick sweep row tracks every viable realization's GB/s
    # next to the winner a runtime race would pin (recorded, not gated;
    # the structural gates stay exactness + pick visibility).  Only
    # the kernel_supports predicate the runtime tuner consults skips a
    # candidate (``xla``, the plain version, runs on the CPU only); a
    # candidate that fails to build or launch fails the mode, and one
    # whose parity differs from the oracle's marks the run unverified.
    from ..ops import ec_kernels as _ek
    fold_want = gf256.encode_region(codec.matrix, fold_src)
    cand_gbps = {}
    cand_exact = True
    for kn in _ek.KERNELS:
        if not _ek.kernel_supports(kn, codec.matrix, device=dev):
            continue
        op = _ek.RegionMatmul(codec.matrix, kernel=kn, device=dev)
        got = op(dev_fold).cpu().numpy()  # device tables + warm
        cand_exact = cand_exact and np.array_equal(got, fold_want)
        dts = kernel_times(lambda op=op: op(dev_fold), 5, dev)
        cand_gbps[kn] = round(fold_src.nbytes / min(dts) / 2**30, 3)
    race_winner = max((kn for kn, v in cand_gbps.items() if v),
                      key=lambda kn: cand_gbps[kn], default=None)

    # adaptive window: a single-writer trickle must shrink it off the
    # 500us default, the 8-writer burst must grow it back.  The ceiling
    # is set above a host's per-launch latency (launches of the plain
    # versions on the CPU run milliseconds; deployments on the card
    # keep the 4000us default) so probe flushes can actually observe
    # the burst arriving.
    adaptive = ECBatcher(window_us=500, adaptive=True, target_ops=4.0,
                         window_min_us=50, window_max_us=20_000,
                         max_bytes=8 * K * chunk)
    for data in payloads[0]:  # sequential: every launch flies alone
        adaptive.encode(codec, data)
    window_after_trickle = adaptive.window_us
    burst(adaptive, codec)  # 4-op size flushes pull the EWMA to target
    window_after_burst = adaptive.window_us

    # the three overhead legs (``overhead=False`` skips them: their
    # keys read None and their gates leave the exit code)
    if overhead:
        # trace-overhead leg: the always-on-sampling cost,
        # measured.  The same 8-writer 16 KiB burst runs with head
        # sampling off / at the production-shaped 1% / fully on — each op
        # draws its root through Tracer.sample_root exactly like a client
        # op and propagates the span into the batcher only when sampled.
        # Gate: the 1% leg within 5% of the off leg's GB/s.  Rounds are
        # INTERLEAVED and each rate keeps its best-of-3: a host's
        # background load swings single reps far more than a 1% sampling
        # draw ever could, and capability-vs-capability is the honest
        # comparison (same treatment as the plane leg above).
        from ..utils.tracer import Tracer as _OTracer
        otr = _OTracer("bench-overhead")
        overhead_rates = (0.0, 0.01, 1.0)

        def sampled_burst(rate: float, perf=None) -> float:
            otr.set_sample_rate(rate)
            b = ECBatcher(window_us=2000, max_bytes=64 << 20, perf=perf)
            barrier = threading.Barrier(writers + 1)

            def writer(w):
                barrier.wait()
                for i, data in enumerate(payloads[w]):
                    root = otr.sample_root("ec-op", writer=w, op=i)
                    b.encode(codec, data,
                             trace=(otr, root.ctx)
                             if root is not None and root.sampled
                             else None)
                    if root is not None:
                        root.finish()

            threads = [threading.Thread(target=writer, args=(w,))
                       for w in range(writers)]
            for t in threads:
                t.start()
            barrier.wait()
            t0 = time.perf_counter()
            for t in threads:
                t.join()
            return time.perf_counter() - t0

        sampled_burst(0.0)  # warm the overhead-leg shapes off the clock
        overhead_dt = {r: float("inf") for r in overhead_rates}
        for _ in range(3):
            for r in overhead_rates:
                overhead_dt[r] = min(overhead_dt[r], sampled_burst(r))
        burst_bytes = writers * ops_per * K * chunk
        overhead_gbps = {str(r): round(burst_bytes / dt / 2**30, 3)
                         for r, dt in overhead_dt.items()}
        trace_overhead_pct = round(
            (overhead_dt[0.01] / overhead_dt[0.0] - 1) * 100, 2)
        trace_overhead_ok = overhead_dt[0.01] <= overhead_dt[0.0] * 1.05

        # exemplars-on point: the same burst with a perf
        # registry attached, so every sampled op's trace_id is captured
        # into the wait/flush histogram bucket reservoirs.  Gate: the 1%
        # exemplar leg within the SAME 5% budget of its own perf-attached
        # rate-0 baseline — capture cost must ride the sampled branch
        # only; the unsampled fast path books a plain hinc (exemplar=None,
        # zero allocation).
        from ..utils.perf import PerfCounters as _OPerf
        ex_perf = _OPerf("bench-overhead-ex")
        ex_dt = {0.0: float("inf"), 0.01: float("inf")}
        sampled_burst(0.0, perf=ex_perf)  # warm
        for _ in range(3):
            for r in ex_dt:
                ex_dt[r] = min(ex_dt[r], sampled_burst(r, perf=ex_perf))
        exemplar_overhead_pct = round(
            (ex_dt[0.01] / ex_dt[0.0] - 1) * 100, 2)
        exemplar_overhead_ok = ex_dt[0.01] <= ex_dt[0.0] * 1.05
        # the capture must actually work: one untimed fully-sampled pass
        # (1% of a small burst can legitimately sample zero ops) must
        # leave trace_id exemplars in the wait histogram's dump
        sampled_burst(1.0, perf=ex_perf)
        ex_dump = ex_perf.dump().get("ec_batch_wait_us", {})
        exemplar_overhead_ok = exemplar_overhead_ok and bool(
            ex_dump.get("exemplars"))

        # perf-query overhead leg: the dispatch-path
        # attribution cost on the same 8-writer burst.  Off = the one
        # gated attribute check every op pays when no query stands
        # (additionally gated ZERO-ALLOC on a pure check loop); on = one
        # standing tenant-grouped query booking every op's class/bytes/
        # latency into its bounded accumulator at the reply edge.
        # Best-of-3 interleaved rounds; the standing query is GATED within
        # 5% of queries-off.
        from ..telemetry.perf_query import PerfQuerySet
        pq_off = PerfQuerySet()
        pq_on = PerfQuerySet()
        pq_on.set_queries({1: {"qid": 1, "key_by": ["tenant"],
                               "counters": ["ops", "bytes_in",
                                            "bytes_out", "lat"],
                               "top_n": 32, "prefix_len": 8}})

        def pq_burst(pq) -> float:
            otr.set_sample_rate(0.0)
            b = ECBatcher(window_us=2000, max_bytes=64 << 20)
            barrier = threading.Barrier(writers + 1)

            def writer(w):
                barrier.wait()
                for i, data in enumerate(payloads[w]):
                    op_t0 = time.perf_counter()
                    b.encode(codec, data)
                    if pq.active:
                        pq.observe(f"tenant{w}", 1, "1.0", "write",
                                   f"obj-{i:04d}",
                                   getattr(data, "nbytes", 0), 0,
                                   (time.perf_counter() - op_t0) * 1e6)

            threads = [threading.Thread(target=writer, args=(w,))
                       for w in range(writers)]
            for t in threads:
                t.start()
            barrier.wait()
            t0 = time.perf_counter()
            for t in threads:
                t.join()
            return time.perf_counter() - t0

        import gc as _gc
        pq_checks = 100_000
        for _ in range(pq_checks):  # warm any lazy attribute state
            if pq_off.active:
                pass
        _gc.collect()
        _gc.disable()
        try:
            # best of 5 rounds: getallocatedblocks() is process-wide, so a
            # background thread (batcher flushers, profiler) can smear a
            # block into a round — the gated check itself must read clean
            # in at least one.  The baseline int bound between the two
            # reads is itself one live block, so a clean round deltas to
            # exactly 1.
            pq_alloc_delta = None
            for _ in range(5):
                pq_blocks0 = sys.getallocatedblocks()
                for _ in range(pq_checks):
                    if pq_off.active:
                        pass
                d = sys.getallocatedblocks() - pq_blocks0 - 1
                if pq_alloc_delta is None or d < pq_alloc_delta:
                    pq_alloc_delta = d
                if pq_alloc_delta <= 0:
                    break
        finally:
            _gc.enable()
        pq_zero_alloc = pq_alloc_delta <= 0
        pq_burst(pq_off)  # warm the leg's shapes off the clock
        pq_dt = {"off": float("inf"), "on": float("inf")}
        for _ in range(3):
            pq_dt["off"] = min(pq_dt["off"], pq_burst(pq_off))
            pq_dt["on"] = min(pq_dt["on"], pq_burst(pq_on))
        perf_query_gbps = {leg: round(burst_bytes / dt / 2**30, 3)
                           for leg, dt in pq_dt.items()}
        perf_query_overhead_pct = round(
            (pq_dt["on"] / pq_dt["off"] - 1) * 100, 2)
        # the standing query must also have SEEN the burst: every writer's
        # tenant row lands inside top_n=32, nothing folds to overflow
        pq_snap = pq_on.snapshot() or {"queries": {}}
        pq_rows = (pq_snap["queries"].get("1") or {}).get("rows") or []
        perf_query_overhead_ok = (pq_dt["on"] <= pq_dt["off"] * 1.05
                                  and pq_zero_alloc
                                  and len(pq_rows) == writers)

    else:
        overhead_gbps = perf_query_gbps = pq_alloc_delta = None
        trace_overhead_pct = exemplar_overhead_pct = None
        perf_query_overhead_pct = None
        trace_overhead_ok = exemplar_overhead_ok = None
        perf_query_overhead_ok = None
        pq_rows = []

    # --trace leg: sample traced ops through a batched burst and report
    # the per-stage latency decomposition (ec-op = the op's whole
    # encode, ec-batch-wait = queued->flushed, ec-flush = the folded
    # launch incl. host sync) — the stage table every later perf PR is
    # graded against
    trace_stages = None
    trace_blame = None
    if trace:
        from ..tools.trace_tool import (format_stage_table,
                                               stage_stats)
        from ..utils.tracer import Tracer
        tracer = Tracer("bench")
        traced = ECBatcher(window_us=2000, max_bytes=64 << 20)
        roots = [[None] * ops_per for _ in range(writers)]

        def traced_burst():
            import threading as _t
            barrier = _t.Barrier(writers + 1)

            def writer(w):
                barrier.wait()
                for i, data in enumerate(payloads[w]):
                    root = tracer.start("ec-op", writer=w, op=i)
                    traced.encode(codec, data,
                                  trace=(tracer, root.ctx))
                    root.finish()
                    roots[w][i] = root

            threads = [_t.Thread(target=writer, args=(w,))
                       for w in range(writers)]
            for t in threads:
                t.start()
            barrier.wait()
            for t in threads:
                t.join()

        traced_burst()
        traces = [tracer.spans_for(roots[w][i].trace_id)
                  for w in range(writers) for i in range(ops_per)]
        trace_stages = stage_stats(traces)
        print("bench: per-stage latency decomposition "
              f"({writers}x{ops_per} traced ops, batched burst):",
              file=sys.stderr)
        print(format_stage_table(trace_stages), file=sys.stderr)
        # blame column: which stage OWNS the blocked time
        # along each op's critical path, aggregated over the burst
        from ..utils.critical_path import (blame,
                                                  format_blame_table)
        trace_blame = blame(traces)
        print("bench: critical-path blame (blocking-chain self-time):",
              file=sys.stderr)
        print(format_blame_table(trace_blame), file=sys.stderr)

    # ---- wire-path leg: the segmented frame path over a
    # real socket pair — payload GB/s + the copies-per-hop counters
    # (plaintext must book ZERO Python-side payload copies; secure
    # mode's seal/encrypt assembly is bounded and counted)
    wire = _wire_path_leg()

    # ---- store group-commit leg: async kv-sync pipeline
    # vs inline fsync-per-txn on a real BlueStore (GATED: fsyncs/txn
    # < 0.5 and async >= sync throughput)
    store_leg = _store_commit_leg()

    # ---- KV background-maintenance leg: sustained multi-
    # memtable omap burst on kv_backend=sst — the bg leg gates on zero
    # inline flush/compaction in the kv-sync thread, commit p99
    # strictly below the inline-maintenance leg, nonzero block-cache
    # hits on the hot-read leg, and byte-identity vs the inline path
    kv_leg = _kv_maint_leg()

    verified = cand_exact
    for w in range(writers):
        for i in range(ops_per):
            want = gf256.encode_region(codec.matrix, payloads[w][i])
            if not (np.array_equal(res_b[w][i], want)
                    and np.array_equal(res_s[w][i], want)
                    and np.array_equal(res_p[w][i], want)):
                verified = False
    for w in range(plane_writers):
        for i in range(plane_ops):
            want = gf256.encode_region(codec.matrix,
                                       plane_payloads[w][i])
            if not np.array_equal(res_e[w][i], want):
                verified = False
    src_bytes = writers * ops_per * K * chunk
    gbps_b = src_bytes / dt_b / 2**30
    gbps_s = src_bytes / dt_s / 2**30
    gbps_p = src_bytes / dt_p / 2**30
    st = batched.stats
    total_ops = writers * ops_per
    backend = device_label(dev)
    # device-resident-plane contract: ONE metered d2h copy per folded
    # launch across the whole plane leg (off-CPU the h2d side also
    # stages once per op at ingest, so copies == ops there)
    plane_src = plane_writers * plane_ops * K * plane_chunk
    gbps_e = plane_src / dt_e / 2**30
    d2h_copies = s1["d2h_copies"] - s0["d2h_copies"]
    d2h_per_flush = (d2h_copies / plane.stats["launches"]
                     if plane.stats["launches"] else None)
    h2d_us = s1["h2d_us"] - s0["h2d_us"]
    h2d_bytes = s1["h2d_bytes"] - s0["h2d_bytes"]
    staging_gbps = (h2d_bytes / (h2d_us * 1e-6) / 2**30
                    if h2d_us > 0 else None)
    single_copy = d2h_per_flush == 1.0
    print(json.dumps({
        "metric": (f"EC encode GB/s batched-vs-per-op (k={K},m={M}, "
                   f"{chunk // 1024}KiB chunks, {writers}-writer burst, "
                   f"torch kernels on {backend}, digest-verified)"),
        "value": round(gbps_b, 3),
        "unit": "GB/s",
        "vs_baseline": round(gbps_b / gbps_p, 3) if gbps_p > 0 else None,
        "ops_per_launch": round(total_ops / st["launches"], 2),
        "launches_batched": st["launches"],
        "launches_per_op": perop.stats["launches"],
        "window_flush": st["window"],
        "size_flush": st["size"],
        "idle_flush": st["idle"],
        "per_op_gbps": round(gbps_p, 3),
        "sharded_gbps": round(gbps_s, 3),
        "sharded_vs_single": (round(gbps_s / gbps_b, 3)
                              if gbps_b > 0 else None),
        "shard_devices": n_dev,
        "sharded_launches": sharded.stats["sharded_launches"],
        "sharded_ops_per_launch": round(
            total_ops / sharded.stats["launches"], 2),
        "adaptive_window_start_us": 500.0,
        "adaptive_window_after_trickle_us": round(window_after_trickle, 1),
        "adaptive_window_after_burst_us": round(window_after_burst, 1),
        "adaptive_converged": (window_after_trickle < 500.0
                               < window_after_burst),
        "digest_verified": verified,
        # device-resident stripe plane: e2e (the size-flushed steady-
        # state burst, host payloads -> host parity) vs the device-
        # resident kernel ceiling, plus the staging-counter contract
        # the plane must hold
        "e2e_gbps": round(gbps_e, 3),
        "e2e_chunk_kib": plane_chunk // 1024,
        "e2e_ops_per_launch": round(
            plane_writers * plane_ops / plane.stats["launches"], 2),
        "kernel_gbps": round(kernel_gbps, 3),
        # realized kernel GB/s inside the fastest burst, and the share
        # of that burst's wall clock spent in the launches: e2e is
        # within 2x of the leg's REALIZED kernel exactly when the
        # share is >= 0.5 — that share is the gated quantity (the
        # quiet kernel_gbps ceiling is measured without the 16 writer
        # threads, so e2e/kernel_gbps — reported raw below as
        # e2e_vs_kernel_quiet — conflates the plane's staging overhead
        # with plain CPU contention on small hosts; the gate accepts
        # any burst passing, plane_burst_shares lists all)
        "kernel_leg_gbps": round(plane_src / fast_ks / 2**30, 3),
        "e2e_device_share": round(kern_share, 3),
        "e2e_vs_kernel_quiet": (round(gbps_e / kernel_gbps, 3)
                                if kernel_gbps > 0 else None),
        "plane_burst_shares": shares,
        "e2e_within_2x_kernel": any(s >= 0.5 for s in shares),
        # kernel auto-selection: every per-signature pick the run made
        # (the dump_kernel_profile `picked` surface — deterministic
        # "xla" pins on the CPU, raced winners on the card) and the
        # per-candidate kernel sweep on the staged fold
        "ec_kernel_picks": {s: p["picked"] for s, p in
                            kernel_profiler().dump()["picks"].items()},
        "ec_kernel_candidates_gbps": cand_gbps,
        "ec_kernel_race_winner": race_winner,
        # trace-overhead leg: sampled-tracing cost at head rates
        # 0 / 0.01 / 1.0 on the 8-writer burst (best-of-3 interleaved
        # rounds); the 1% leg is GATED within 5% of off
        "trace_overhead_gbps": overhead_gbps,
        "trace_overhead_pct_at_001": trace_overhead_pct,
        "trace_overhead_ok": trace_overhead_ok,
        # exemplars-on point: 1% sampling WITH bucket
        # exemplar capture vs its own perf-attached rate-0 baseline,
        # same 5% budget; also asserts a fully-sampled pass actually
        # left trace_id exemplars in ec_batch_wait_us
        "exemplar_overhead_pct_at_001": exemplar_overhead_pct,
        "exemplar_overhead_ok": exemplar_overhead_ok,
        # perf-query dispatch overhead: queries-off is one
        # gated attr check (zero-alloc, measured via allocated-blocks
        # delta) and one standing tenant query is GATED within 5% of
        # off on the same burst
        "perf_query_gbps": perf_query_gbps,
        "perf_query_overhead_pct": perf_query_overhead_pct,
        "perf_query_off_alloc_delta": pq_alloc_delta,
        "perf_query_rows": len(pq_rows),
        "perf_query_overhead_ok": perf_query_overhead_ok,
        "staging_h2d_gbps": (round(staging_gbps, 3)
                             if staging_gbps is not None else None),
        "stage_h2d_bytes": h2d_bytes,
        "stage_d2h_bytes": s1["d2h_bytes"] - s0["d2h_bytes"],
        "d2h_copies_per_flush": (round(d2h_per_flush, 3)
                                 if d2h_per_flush is not None
                                 else None),
        "single_d2h_per_flush": single_copy,
        # zero-copy wire path: scatter-gather framing +
        # vectored sends + carve-on-decode over a real socket, with
        # the measured copies-per-hop counters (GATED: plaintext 0,
        # secure <= 2 tx / 1 rx)
        **wire,
        # async group-commit store pipeline: 8-writer 1 MiB
        # burst on BlueStore — fsyncs/txn from counter deltas (GATED
        # < 0.5) and async-vs-sync GB/s (GATED async >= sync)
        **store_leg,
        # background LSM maintenance for the KV tier:
        # seal-and-flush + streaming compaction off the commit path
        # (GATED: zero inline maintenance in the kv-sync thread, bg
        # p99 < inline p99, cache hits > 0, byte-identity)
        **kv_leg,
        **({"trace_stages": trace_stages,
            "trace_blame": trace_blame}
           if trace_stages is not None else {}),
    }))
    overheads_ok = not overhead or (trace_overhead_ok
                                    and exemplar_overhead_ok
                                    and perf_query_overhead_ok)
    return 0 if verified and single_copy and overheads_ok \
        and wire["wire_zero_copy_ok"] \
        and wire["wire_stack_ok"] \
        and store_leg["store_commit_ok"] \
        and kv_leg["kv_maint_ok"] else 1


def _recovery_progress_leg() -> dict:
    """`--ec-recovery --progress`: drive a real MiniCluster through an
    OSD kill + fresh-store revive and assert the cluster-visible
    recovery story — the mgr progress item APPEARS, its percent
    advances MONOTONICALLY to 100, and it CLEARS once the storm drains
    (the acceptance face of the event-journal/progress layer; the
    storm benches above only measure the data plane)."""
    from ..tools.vstart import MiniCluster
    from ..utils.config import default_config

    cfg = default_config()
    cfg.apply_dict({"osd_heartbeat_interval": 0.05,
                    "osd_heartbeat_grace": 0.5,
                    "ec_backend": "native",
                    "ms_dispatch_workers": 2,
                    "osd_op_num_shards": 2,
                    # stretch the storm so the progress samples catch
                    # intermediate percents, and report every op
                    "osd_recovery_sleep": 0.005,
                    "osd_recovery_max_active": 2,
                    "osd_recovery_progress_interval": 0.0,
                    "mgr_progress_linger": 1.0})
    c = MiniCluster(n_osds=3, cfg=cfg).start()
    seen: dict[str, list] = {}
    cleared = False
    try:
        cl = c.client()
        cl.create_pool("p", kind="ec", pg_num=2,
                       ec_profile={"plugin": "jerasure", "k": "2",
                                   "m": "1", "backend": "numpy"})
        for i in range(24):
            cl.write_full("p", f"o{i}", b"r" * 4096)
        c.kill_osd(2)          # marked down -> map epoch, degradation
        c.settle(0.3)
        c.revive_osd(2)        # FRESH store: every shard rebuilds
        deadline = time.time() + 45
        while time.time() < deadline:
            for it in c.mon.progress.items():
                seen.setdefault(it["id"], []).append(it["percent"])
            if seen and not c.mon.progress.active() \
                    and not c.mon.progress.percent_gauges():
                cleared = True  # linger expired too: the gauge is GONE
                break
            time.sleep(0.02)
    finally:
        c.stop()
    appeared = bool(seen)
    monotonic = all(all(a <= b for a, b in zip(ps, ps[1:]))
                    for ps in seen.values())
    reached_100 = any(ps and ps[-1] == 100.0 for ps in seen.values())
    return {"ok": appeared and monotonic and reached_100 and cleared,
            "appeared": appeared, "monotonic": monotonic,
            "reached_100": reached_100, "cleared": cleared,
            "items": {k: {"samples": len(ps), "max_percent": max(ps)}
                      for k, ps in seen.items()}}


def wide_repair_matrix(full: bool = True, chunk: int = 8192,
                       seed: int = 13, device: str = "cuda") -> dict:
    """The {rs, clay, lrc, shec} x {healthy, degraded, storm} wide-code
    matrix: every cell runs THROUGH the ECBatcher (the seam the
    wide codes now ride) and byte-verifies against the unbatched numpy
    oracle.

    - healthy: 8-writer full-stripe encode burst (GB/s of source bytes)
    - degraded: single-shard-lost degraded read — survivors decode the
      lost data chunk (per-op p50/p99 ms + GB/s); for LRC/SHEC the
      batcher's fold takes the narrow repair-equation rows
    - storm: the recovery rebuild — each op fetches ONLY what the
      codec's minimum_to_decode / repair-plane contract requires (the
      OSD's osd_ec_repair_narrow fetch plan) and rebuilds the lost
      shard, reporting repair-bytes-per-lost-byte alongside throughput:
      RS reads k whole chunks (ratio k), LRC one locality group, SHEC
      one shingle window, CLAY (d=k+m-1) alpha/q sub-chunks from each
      of n-1 helpers (ratio (n-1)/q)

    All four plugins run at the same (k, data+parity) storage point:
    k=8 with 4 parity chunks, on the ``torch`` backend on ``device``.
    ``full=False`` is the tier-1-sized smoke leg (fewer readers/ops,
    same verification)."""
    import threading

    import numpy as np

    from .. import ec
    from ..ec.batcher import ECBatcher

    dev = bench_device(device)

    K_, M_ = 8, 4
    plugins = {
        "rs": ("tpu", {"k": str(K_), "m": str(M_)}),
        "clay": ("clay", {"k": str(K_), "m": str(M_),
                          "d": str(K_ + M_ - 1)}),
        # 2 global RS parities + (8+2)/5 = 2 local XORs = 4 parity
        # chunks total, the same 12-chunk footprint as the others
        "lrc": ("lrc", {"k": str(K_), "m": "2", "l": "5"}),
        "shec": ("shec", {"k": str(K_), "m": str(M_), "c": "3"}),
    }
    readers, ops_per = (8, 6) if full else (4, 2)
    rng = np.random.default_rng(seed)

    def burst(fn, n_threads, per):
        try:
            fn(0, 0)  # warm the cell's kernels/decode matrices
        except Exception:  # noqa: BLE001 - the timed run will surface it
            pass
        lat = []
        errs = []
        lock = threading.Lock()
        barrier = threading.Barrier(n_threads + 1)

        def worker(r):
            barrier.wait()
            mine = []
            try:
                for i in range(per):
                    t0 = time.perf_counter()
                    fn(r, i)
                    mine.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 - surfaced in cell
                with lock:
                    errs.append(repr(e))
            with lock:
                lat.extend(mine)

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(n_threads)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        lat.sort()
        return lat, wall, errs

    cells: dict = {}
    ratios: dict = {}
    degraded_p99: dict = {}
    all_ok = True
    for pname, (plugin, prof) in plugins.items():
        codec = ec.factory(plugin, dict(prof, backend="torch",
                                        device=str(dev)))
        oracle = ec.factory(plugin, dict(prof, backend="numpy"))
        n = codec.chunk_count
        lost = 1  # a data shard (the downed OSD's position)
        # pre-generate the cases + oracle truth off the clock
        cases = []
        for _ in range(readers * ops_per):
            data = rng.integers(0, 256, (K_, chunk), dtype=np.uint8)
            parity = oracle.encode_chunks(data)
            chunks = {j: data[j] for j in range(K_)}
            chunks.update({K_ + j: parity[j] for j in range(codec.m)})
            cases.append((data, parity, chunks))
        cell: dict = {}
        oks = []

        # -- healthy: full-stripe encode burst -------------------------
        bat = ECBatcher(window_us=2000)
        enc_out = [None] * len(cases)

        def do_enc(r, i, bat=bat, out=enc_out):
            idx = r * ops_per + i
            p, _ = bat.encode(codec, cases[idx][0])
            out[idx] = np.asarray(p)

        lat, wall, errs = burst(do_enc, readers, ops_per)
        ok = not errs and all(
            np.array_equal(enc_out[i], cases[i][1])
            for i in range(len(cases)))
        oks.append(ok)
        cell["healthy"] = {
            "gbps": round(len(cases) * K_ * chunk / wall / 2**30, 3),
            "p50_ms": round(lat[len(lat) // 2] * 1e3, 3) if lat else None,
            "ops_per_launch": round(len(cases)
                                    / max(1, bat.stats["launches"]), 2),
            "ok": ok, **({"errors": errs[:2]} if errs else {}),
        }

        # -- degraded: lost-shard read decode --------------------------
        bat = ECBatcher(window_us=2000)
        surv = [{s: c for s, c in ch.items() if s != lost}
                for _d, _p, ch in cases]

        def do_dec(r, i, bat=bat):
            idx = r * ops_per + i
            out = bat.decode(codec, [lost], dict(surv[idx]))
            if not np.array_equal(np.asarray(out[lost]),
                                  cases[idx][2][lost]):
                raise AssertionError(f"degraded bytes diverge op {idx}")

        lat, wall, errs = burst(do_dec, readers, ops_per)
        ok = not errs
        oks.append(ok)
        p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))] if lat else 0
        cell["degraded"] = {
            "gbps": round(len(cases) * chunk / wall / 2**30, 3),
            "p50_ms": round(lat[len(lat) // 2] * 1e3, 3) if lat else None,
            "p99_ms": round(p99 * 1e3, 3),
            "ops_per_launch": round(len(cases)
                                    / max(1, bat.stats["launches"]), 2),
            "ok": ok, **({"errors": errs[:2]} if errs else {}),
        }
        degraded_p99[pname] = cell["degraded"]["p99_ms"]

        # -- storm: minimum-fetch rebuild of the lost shard ------------
        # what the OSD's narrow recovery path moves over the wire:
        bat = ECBatcher(window_us=2000)
        avail = [s for s in range(n) if s != lost]
        sub_repair = (plugin == "clay"
                      and getattr(codec, "q", None) == codec.m)
        if sub_repair:
            planes = codec.repair_planes(lost)
            fetch_bytes = (n - 1) * len(planes) * (chunk // codec.alpha)
            helper_sets = []
            for _d, _p, ch in cases:
                helper_sets.append({
                    h: ch[h].reshape(codec.alpha,
                                     chunk // codec.alpha)[planes]
                    for h in avail})

            def do_rebuild(r, i, bat=bat):
                idx = r * ops_per + i
                got = bat.repair(codec, lost, helper_sets[idx], chunk)
                if not np.array_equal(np.asarray(got),
                                      cases[idx][2][lost]):
                    raise AssertionError(f"repair bytes diverge {idx}")
        else:
            need = codec.minimum_to_decode([lost], avail)
            need = [s for s in need if s != lost]
            fetch_bytes = len(need) * chunk

            def do_rebuild(r, i, bat=bat, need=need):
                idx = r * ops_per + i
                out = bat.decode(codec, [lost],
                                 {s: cases[idx][2][s] for s in need})
                if not np.array_equal(np.asarray(out[lost]),
                                      cases[idx][2][lost]):
                    raise AssertionError(f"rebuild bytes diverge {idx}")

        lat, wall, errs = burst(do_rebuild, readers, ops_per)
        ok = not errs
        oks.append(ok)
        ratio = round(fetch_bytes / chunk, 3)
        cell["storm"] = {
            "gbps": round(len(cases) * fetch_bytes / wall / 2**30, 3),
            "p50_ms": round(lat[len(lat) // 2] * 1e3, 3) if lat else None,
            "repair_bytes_per_lost_byte": ratio,
            "ops_per_launch": round(len(cases)
                                    / max(1, bat.stats["launches"]), 2),
            "subchunk": sub_repair,
            "ok": ok, **({"errors": errs[:2]} if errs else {}),
        }
        ratios[pname] = ratio
        cells[pname] = cell
        all_ok = all_ok and all(oks)

    # the acceptance claim: locality/sub-chunk repair moves strictly
    # fewer bytes per lost byte than plain RS at the same (k, m)
    locality_wins = (ratios["lrc"] < ratios["rs"]
                     and ratios["clay"] < ratios["rs"]
                     and ratios["shec"] < ratios["rs"])
    return {"cells": cells,
            "repair_bytes_per_lost_byte": ratios,
            "degraded_p99_ms": degraded_p99,
            "chunk_bytes": chunk,
            "k": K_, "parity_chunks": M_,
            "locality_beats_rs": locality_wins,
            "ok": all_ok and locality_wins}


def ec_recovery_bench(progress: bool = False,
                      wide: bool = True, device: str = "cuda") -> int:
    """`--ec-recovery` mode: the PG-recovery-storm scenario — one OSD's
    shards drop and a burst of stripes decode-rebuilds through the
    batcher (ROADMAP "recovery-burst batching").  8 reader threads each
    rebuild their stripes' missing shard from the k survivors; the
    shared erasure signature makes the whole storm one coalescing
    group.  Reports per-op latency and ops/launch for unbatched
    (window=0) vs batched vs mesh-sharded, sweeps ec_batch_max_bytes on
    the batched leg, and digest-verifies every rebuilt chunk against
    the original data.  value = best batched rebuild GB/s (source =
    survivor bytes read per op); vs_baseline = batched / unbatched.
    The sharded leg fans out over every device of ``device``
    (device_count)."""
    import threading

    import numpy as np

    from .. import ec
    from ..ec.batcher import ECBatcher, bucket_len
    from ..ops import gf256

    dev = bench_device(device)
    n_dev = device_count(dev)
    chunk = RECOVERY_CHUNK
    readers, ops_per = RECOVERY_READERS, RECOVERY_OPS
    lost = 1  # the downed OSD's shard, erased from every stripe
    single = ec.factory("tpu", {"k": K, "m": M, "backend": "torch",
                                "device": str(dev), "shard": "off"})
    sharded = ec.factory("tpu", {"k": K, "m": M, "backend": "torch",
                                 "device": str(dev),
                                 "shard": str(n_dev)})
    rng = np.random.default_rng(7)
    want = list(range(K))
    cases = [[None] * ops_per for _ in range(readers)]
    for r in range(readers):
        for i in range(ops_per):
            data = rng.integers(0, 256, (K, chunk), dtype=np.uint8)
            parity = gf256.encode_region(single.matrix, data)
            chunks = {j: data[j] for j in range(K) if j != lost}
            chunks.update({K + j: parity[j] for j in range(M)})
            cases[r][i] = (data, chunks)

    def storm(batcher, cdc):
        """Returns (per-op wall seconds, burst wall seconds, ok)."""
        lat = [[0.0] * ops_per for _ in range(readers)]
        ok = [True]
        barrier = threading.Barrier(readers + 1)

        def reader(r):
            barrier.wait()
            for i, (data, chunks) in enumerate(cases[r]):
                t0 = time.perf_counter()
                out = batcher.decode(cdc, want, dict(chunks))
                lat[r][i] = time.perf_counter() - t0
                if not np.array_equal(np.asarray(out[lost]), data[lost]):
                    ok[0] = False

        threads = [threading.Thread(target=reader, args=(r,))
                   for r in range(readers)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        flat = sorted(x for row in lat for x in row)
        return flat, time.perf_counter() - t0, ok[0]

    # warm the decode race off the clock (decode matrix + fold
    # shapes); sharded shapes follow the flush path's shard_pad padding
    from ..ec.batcher import shard_pad
    bucket = bucket_len(chunk)
    n2 = 1
    while n2 <= readers:
        flat = {s: np.zeros(n2 * bucket, dtype=np.uint8)
                for s in sorted(cases[0][0][1])}
        single.decode_chunks(want, flat)
        ns, n2s = shard_pad(n2, n_dev)
        flat_s = {s: np.zeros(n2s * bucket, dtype=np.uint8)
                  for s in sorted(cases[0][0][1])}
        sharded.decode_chunks(want, flat_s, n_shard=ns)
        n2 <<= 1

    src_per_op = K * chunk  # survivor bytes read to rebuild one stripe
    total_ops = readers * ops_per
    results = {}
    sweep = {}
    best = (None, 0.0)
    for mb in (1 << 20, 4 << 20, 16 << 20, 64 << 20):
        b = ECBatcher(window_us=2000, max_bytes=mb)
        lats, wall, ok = storm(b, single)
        gbps = total_ops * src_per_op / wall / 2**30
        sweep[f"{mb >> 20}MiB"] = {
            "gbps": round(gbps, 3),
            "per_op_ms_p50": round(lats[len(lats) // 2] * 1e3, 3),
            "ops_per_launch": round(total_ops / b.stats["launches"], 2),
            "ok": ok,
        }
        if ok and gbps > best[1]:
            best = (mb, gbps)
    best_mb = best[0] or (8 << 20)

    for name, batcher, cdc in (
            ("unbatched", ECBatcher(window_us=0), single),
            ("batched", ECBatcher(window_us=2000, max_bytes=best_mb),
             single),
            ("sharded", ECBatcher(window_us=2000, max_bytes=best_mb),
             sharded)):
        lats, wall, ok = storm(batcher, cdc)
        results[name] = {
            "gbps": round(total_ops * src_per_op / wall / 2**30, 3),
            "per_op_ms_p50": round(lats[len(lats) // 2] * 1e3, 3),
            "per_op_ms_p95": round(lats[int(len(lats) * 0.95)] * 1e3, 3),
            "ops_per_launch": round(
                total_ops / batcher.stats["launches"], 2),
            "sharded_launches": batcher.stats["sharded_launches"],
            "ok": ok,
        }
    verified = all(v["ok"] for v in results.values()) and \
        all(v["ok"] for v in sweep.values())
    progress = _recovery_progress_leg() if progress else None
    if progress is not None:
        verified = verified and progress["ok"]
    # the wide/local-code matrix: {rs, clay, lrc, shec} x {healthy,
    # degraded, storm}, every cell batched AND byte-verified against
    # the numpy oracle, with the repair-bytes-per-lost-byte column
    # (LRC/SHEC/CLAY strictly below plain RS gates the exit code)
    wide_m = wide_repair_matrix(full=True, device=device) if wide \
        else None
    if wide_m is not None:
        verified = verified and wide_m["ok"]
    backend = device_label(dev)
    gbps_b = results["batched"]["gbps"]
    gbps_u = results["unbatched"]["gbps"]
    print(json.dumps({
        "metric": (f"EC recovery-storm rebuild GB/s (k={K},m={M}, "
                   f"{chunk // 1024}KiB chunks, shard {lost} lost, "
                   f"{readers}-reader burst, torch kernels on {backend}, "
                   f"digest-verified)"),
        "value": gbps_b,
        "unit": "GB/s",
        "vs_baseline": round(gbps_b / gbps_u, 3) if gbps_u > 0 else None,
        "max_bytes_sweep": sweep,
        "max_bytes_sweet_spot": f"{best_mb >> 20}MiB",
        "shard_devices": n_dev,
        "scenarios": results,
        "digest_verified": verified,
        **({"progress": progress} if progress is not None else {}),
        **({"wide_matrix": wide_m["cells"],
            "wide_repair_bytes_per_lost_byte":
                wide_m["repair_bytes_per_lost_byte"],
            "wide_degraded_p99_ms": wide_m["degraded_p99_ms"],
            "wide_locality_beats_rs": wide_m["locality_beats_rs"],
            "wide_ok": wide_m["ok"]} if wide_m is not None else {}),
    }))
    return 0 if verified else 1


def ec_read_bench(trace: bool = False) -> int:
    """`--ec-read` mode: the client-facing EC read fan-out under an
    8-reader burst through a real MiniCluster — the coalesced read
    pipeline (per-peer MSubReadN aggregation + duplicate-fetch
    collapse + batched degraded decode) vs the per-op baseline (one
    MSubRead per shard per op, pass-through decode).

    Three legs on each cluster: HEALTHY whole-object reads, RANGED
    reads, and DEGRADED reads (one OSD killed on a spare-less k+m
    pool, so every read of its shard's PGs decodes).  A hot-object
    sub-leg has all 8 readers hammer ONE object to exercise the
    duplicate-read collapse.  Reports messenger sub-read messages per
    read, folded decode launches per degraded read, and p50/p99 read
    latency; EVERY payload is byte-verified against what was written.
    value = coalesced healthy reads/s; vs_baseline = coalesced /
    per-op.  `--trace` adds the read-stage decomposition table
    (ec-subread-fanout / ec-read-wait / ec-read-flush / ec-decode /
    ec-batch-wait / ec-flush)."""
    import threading

    import numpy as np

    from ..tools.vstart import MiniCluster
    from ..utils.config import default_config

    K_, M_ = 4, 2
    n_objects, readers, obj_bytes = 24, 8, 32 * 1024

    def build(coalesce: bool):
        cfg = default_config()
        cfg.apply_dict({
            "osd_heartbeat_interval": 0.05,
            "osd_heartbeat_grace": 0.5,
            "ec_backend": "native",
            "ms_dispatch_workers": 2,
            "osd_op_num_shards": 2,
            "ec_read_coalesce": "on" if coalesce else "off",
            "ec_read_window_us": 400.0,
            # decode coalescing rides the same comparison: batched
            # window vs strict pass-through (window 0 still counts one
            # launch per decode, so launches-per-op stays comparable)
            "ec_batch": "on",
            "ec_batch_adaptive": "off",
            "ec_batch_window_us": 1500.0 if coalesce else 0.0,
        })
        # k+m == n_osds: no spare devices, so the degraded leg STAYS
        # degraded (a spare would absorb the rebuilt shards and the
        # late reads would stop decoding)
        c = MiniCluster(n_osds=K_ + M_, cfg=cfg).start()
        cl = c.client()
        cl.create_pool("ecr", kind="ec", pg_num=8,
                       ec_profile={"plugin": "jerasure", "k": str(K_),
                                   "m": str(M_), "backend": "numpy"})
        return c, cl

    def counters(c):
        tot: dict[str, float] = {}
        for osd in c.osds.values():
            for k, v in osd.perf.dump().items():
                if isinstance(v, (int, float)):
                    tot[k] = tot.get(k, 0) + v
            st = osd._ec_batcher.stats
            tot["decode_launches"] = (tot.get("decode_launches", 0)
                                      + st["launches"])
        return tot

    def burst(c, clients, payloads, *, ranged=False, hot=None):
        """8 readers sweep the object set (or hammer `hot`); returns
        (sorted latencies, wall seconds, ok, msgs_per_op,
        launches_per_op)."""
        names = [hot] * n_objects if hot else sorted(payloads)
        lat: list[list[float]] = [[] for _ in range(readers)]
        ok = [True]
        before = counters(c)
        barrier = threading.Barrier(readers + 1)
        rng = np.random.default_rng(11)
        ranges = [(int(o), int(ln)) for o, ln in zip(
            rng.integers(0, obj_bytes - 4096, n_objects),
            rng.integers(1, 4096, n_objects))]

        def reader(r):
            cl_r = clients[r]
            barrier.wait()
            for i, name in enumerate(names):
                t0 = time.perf_counter()
                try:
                    if ranged:
                        off, ln = ranges[i]
                        got = cl_r.read("ecr", name, offset=off,
                                        length=ln)
                        want = payloads[name][off:off + ln]
                    else:
                        got = cl_r.read("ecr", name)
                        want = payloads[name]
                except Exception:  # noqa: BLE001 - counted as failure
                    ok[0] = False
                    continue
                lat[r].append(time.perf_counter() - t0)
                if got != want:
                    ok[0] = False

        threads = [threading.Thread(target=reader, args=(r,))
                   for r in range(readers)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        after = counters(c)
        n_reads = readers * len(names)
        # sub-read wire messages, honestly counted on BOTH paths: every
        # served sub-read bumps subop_r (once per plain MSubRead, once
        # per MSubReadN item), so plain messages = subop_r - fetches
        # (recovery paths still send direct MSubReads even when client
        # reads coalesce) and N-messages ride ec_read_msgs; on the
        # per-op path the coalescer terms are zero
        def delta(name):
            return after.get(name, 0) - before.get(name, 0)
        msgs = max(0, delta("ec_read_msgs")
                   + delta("subop_r") - delta("ec_read_fetches"))
        launches = (after["decode_launches"]
                    - before["decode_launches"])
        flat = sorted(x for row in lat for x in row)
        deltas = {k: after.get(k, 0) - before.get(k, 0)
                  for k in after}
        return (flat, wall, ok[0], msgs / max(1, n_reads),
                launches / max(1, n_reads), deltas)

    def pcts(flat):
        if not flat:
            return {"p50_ms": None, "p99_ms": None}
        return {"p50_ms": round(flat[len(flat) // 2] * 1e3, 3),
                "p99_ms": round(flat[min(len(flat) - 1,
                                         int(len(flat) * 0.99))] * 1e3,
                                3)}

    rng = np.random.default_rng(9)
    results: dict[str, dict] = {}
    verified = True
    trace_stages = None
    trace_blame = None
    for mode in ("coalesced", "perop"):
        c, cl = build(coalesce=mode == "coalesced")
        try:
            payloads = {}
            for i in range(n_objects):
                data = rng.integers(0, 256, obj_bytes,
                                    dtype=np.uint8).tobytes()
                payloads[f"o{i:02d}"] = data
                cl.write_full("ecr", f"o{i:02d}", data)
            # one client per reader, created HERE (client creation
            # binds entity names and is not thread-safe)
            clients = [c.client() for _ in range(readers)]
            legs = {}
            flat, wall, ok, mpo, _l, _d = burst(c, clients, payloads)
            verified &= ok
            legs["healthy"] = dict(pcts(flat), msgs_per_op=round(mpo, 2),
                                   reads_per_s=round(
                                       readers * n_objects / wall, 1))
            flat, _w, ok, mpo, _l, dd = burst(c, clients, payloads,
                                              hot="o00")
            verified &= ok
            # THIS leg's collapses only (deltas, not cumulative)
            legs["hot_object"] = dict(
                pcts(flat), msgs_per_op=round(mpo, 2),
                dup_hits=int(dd.get("ec_read_dup_hits", 0)),
                union_merges=int(dd.get("ec_read_union_merges", 0)))
            flat, _w, ok, mpo, _l, _d = burst(c, clients, payloads,
                                              ranged=True)
            verified &= ok
            legs["ranged"] = dict(pcts(flat), msgs_per_op=round(mpo, 2))
            # degraded: kill one OSD; with zero spares every PG it held
            # a data shard for decodes on read
            c.kill_osd(K_ + M_ - 1)
            c.settle(1.0)
            flat, wall, ok, mpo, lpo, _d = burst(c, clients, payloads)
            verified &= ok
            legs["degraded"] = dict(
                pcts(flat), msgs_per_op=round(mpo, 2),
                decode_launches_per_op=round(lpo, 3),
                reads_per_s=round(readers * n_objects / wall, 1))
            if mode == "coalesced" and trace:
                from ..tools.trace_tool import (
                    format_stage_table, stage_stats)
                tcl = c.client()
                tcl.tracing = True
                roots = []
                for i in range(min(8, n_objects)):
                    tcl.read("ecr", f"o{i:02d}")
                for s in tcl.tracer.dump():
                    if s["parent_id"] == 0:
                        roots.append(s["trace_id"])
                traces = [c.collect_trace(tid)
                          + tcl.tracer.spans_for(tid) for tid in roots]
                trace_stages = stage_stats(traces)
                print("bench: read-stage latency decomposition "
                      f"({len(roots)} traced degraded reads):",
                      file=sys.stderr)
                print(format_stage_table(trace_stages), file=sys.stderr)
                from ..utils.critical_path import (
                    blame, format_blame_table)
                trace_blame = blame(traces)
                print("bench: critical-path blame (degraded reads):",
                      file=sys.stderr)
                print(format_blame_table(trace_blame), file=sys.stderr)
            results[mode] = legs
        finally:
            c.stop()

    co, po = results["coalesced"], results["perop"]
    v = co["healthy"]["reads_per_s"]
    base = po["healthy"]["reads_per_s"]
    print(json.dumps({
        "metric": (f"EC coalesced read pipeline reads/s (k={K_},m={M_}, "
                   f"{obj_bytes // 1024}KiB objects, {readers}-reader "
                   f"burst, MSubReadN window 400us, byte-verified)"),
        "value": v,
        "unit": "reads/s",
        "vs_baseline": round(v / base, 3) if base else None,
        "coalesced": co,
        "perop": po,
        "msgs_per_op_healthy": {"coalesced": co["healthy"]["msgs_per_op"],
                                "perop": po["healthy"]["msgs_per_op"]},
        "msgs_per_op_degraded": {
            "coalesced": co["degraded"]["msgs_per_op"],
            "perop": po["degraded"]["msgs_per_op"]},
        "decode_launches_per_op": {
            "coalesced": co["degraded"]["decode_launches_per_op"],
            "perop": po["degraded"]["decode_launches_per_op"]},
        "digest_verified": verified,
        **({"trace_stages": trace_stages,
            "trace_blame": trace_blame}
           if trace_stages is not None else {}),
    }))
    return 0 if verified else 1


def read_storm_bench(args) -> int:
    """`--read-storm` mode: the hot-object read-path scale-out gate —
    a zipf(1.2) read storm against a spare-less k=2+m=1 MiniCluster,
    comparing pool read_policy=primary (every hot read lands on the
    hot object's PG primary) against read_policy=balance (clients
    hash (oid, nonce) across the acting set's shard holders), plus a
    lease leg where repeat readers are served from the CLIENT cache.

    Four legs, ONE JSON row, exit-gated on:
    - per-OSD served-read spread (max/mean of op_r deltas) <= 1.5x
      under balance (the primary baseline's spread is reported
      alongside, not gated — it is the problem being fixed);
    - balance p99 inside a generous envelope of the primary leg's
      (3x + scheduling noise floor: the CI box is a 2-core machine);
    - the repeat-reader lease leg serves >= 50% of its hot reads from
      the client lease cache with ZERO RADOS ops for those hits
      (client lease_hits counters vs cluster op_r deltas);
    - EVERY read in EVERY leg is byte-identical to what was written,
      including across the mid-leg write-under-lease revoke (readers
      must converge to the new bytes within the leg, and never
      observe a torn mix);
    - a reader-x10 leg (same storm, 10x the clients) stays
      byte-identical and completes.
    """
    import threading

    import numpy as np

    from ..tools.vstart import MiniCluster
    from ..utils.config import default_config

    n_objects = args.storm_objects
    n_reads = args.storm_reads
    readers = 6
    obj_bytes = 16 * 1024
    ZIPF_S = 1.2

    def build(policy: str, lease_ttl: float):
        cfg = default_config()
        cfg.apply_dict({
            "osd_heartbeat_interval": 0.05,
            "osd_heartbeat_grace": 0.5,
            "ec_backend": "native",
            "ms_dispatch_workers": 2,
            "osd_op_num_shards": 2,
            "osd_read_lease_ttl": lease_ttl,
            "osd_read_lease_rate": 5.0,
        })
        c = MiniCluster(n_osds=3, cfg=cfg).start()
        cl = c.client()
        cl.create_pool("storm", kind="ec", pg_num=4,
                       ec_profile={"plugin": "jerasure", "k": "2",
                                   "m": "1", "backend": "numpy",
                                   "read_policy": policy})
        rng = np.random.default_rng(7)
        payloads = {}
        for i in range(n_objects):
            data = rng.integers(0, 256, obj_bytes,
                                dtype=np.uint8).tobytes()
            payloads[f"h{i:02d}"] = data
            cl.write_full("storm", f"h{i:02d}", data)
        return c, cl, payloads

    # zipf(1.2) pmf over object ranks: rank 0 is the hot object
    ranks = np.arange(1, n_objects + 1, dtype=np.float64)
    pmf = ranks ** -ZIPF_S
    pmf /= pmf.sum()

    def op_r_by_osd(c):
        return {o: osd.perf.dump().get("op_r", 0)
                for o, osd in c.osds.items()}

    def counters(c, names):
        return {n: sum(osd.perf.dump().get(n, 0)
                       for osd in c.osds.values()) for n in names}

    def storm(c, payloads, *, n_clients=readers, reads=None,
              mutate=None):
        """n_clients readers each draw `reads` zipf-distributed
        objects and byte-verify every result; optional `mutate`
        callback fires mid-leg from a writer thread.  Returns
        (sorted latencies, wall seconds, ok, per-osd op_r deltas,
        clients)."""
        reads = n_reads if reads is None else reads
        clients = [c.client() for _ in range(n_clients)]
        names = sorted(payloads)
        # mutated objects verify against a (old, new) transition set
        allowed = {n: {payloads[n]} for n in names}
        allowed_lock = threading.Lock()
        lat: list[list[float]] = [[] for _ in range(n_clients)]
        ok = [True]
        errs: list[str] = []
        before = op_r_by_osd(c)
        barrier = threading.Barrier(n_clients + 1)

        def reader(r):
            rng_r = np.random.default_rng(100 + r)
            draws = rng_r.choice(n_objects, size=reads, p=pmf)
            barrier.wait()
            for i in draws:
                name = names[int(i)]
                t0 = time.perf_counter()
                try:
                    got = clients[r].read("storm", name)
                except Exception as e:  # noqa: BLE001 - counted below
                    ok[0] = False
                    errs.append(f"{name}: {e!r}")
                    continue
                lat[r].append(time.perf_counter() - t0)
                with allowed_lock:
                    good = got in allowed[name]
                if not good:
                    ok[0] = False
                    errs.append(f"{name}: torn/stale bytes")

        threads = [threading.Thread(target=reader, args=(r,))
                   for r in range(n_clients)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        if mutate is not None:
            mutate(allowed, allowed_lock)
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        after = op_r_by_osd(c)
        deltas = {o: after[o] - before.get(o, 0) for o in after}
        flat = sorted(x for row in lat for x in row)
        if errs:
            print(f"bench: read-storm errors: {errs[:5]}",
                  file=sys.stderr)
        return flat, wall, ok[0], deltas, clients

    def spread(deltas):
        served = [v for v in deltas.values()]
        mean = sum(served) / max(1, len(served))
        return (max(served) / mean) if mean > 0 else None

    def pcts(flat):
        if not flat:
            return {"p50_ms": None, "p99_ms": None}
        return {"p50_ms": round(flat[len(flat) // 2] * 1e3, 3),
                "p99_ms": round(flat[min(len(flat) - 1,
                                         int(len(flat) * 0.99))] * 1e3,
                                3)}

    results: dict[str, dict] = {}
    gates: dict[str, bool] = {}
    verified = True

    # ---- leg 1+2: spread under the storm, primary vs balance --------
    for policy in ("primary", "balance"):
        c, cl, payloads = build(policy, lease_ttl=0.0)
        try:
            flat, wall, ok, deltas, _cls = storm(c, payloads)
            verified &= ok
            sp = spread(deltas)
            results[policy] = dict(
                pcts(flat), spread=round(sp, 3) if sp else None,
                per_osd_reads=deltas,
                reads_per_s=round(readers * n_reads / wall, 1),
                **counters(c, ("balanced_read_serve",
                               "balanced_read_bounce",
                               "ec_read_tier_hit",
                               "ec_read_tier_admit",
                               "ec_read_tier_evict")))
        finally:
            c.stop()
    gates["spread_balance_le"] = (
        results["balance"]["spread"] is not None
        and results["balance"]["spread"] <= args.storm_spread)
    p99_pri = results["primary"]["p99_ms"] or 0.0
    p99_bal = results["balance"]["p99_ms"] or 0.0
    gates["p99_envelope"] = p99_bal <= max(3.0 * p99_pri, 50.0)

    # ---- leg 3: repeat readers under leases + mid-leg revoke --------
    c, cl, payloads = build("balance", lease_ttl=30.0)
    try:
        hot = sorted(payloads)[0]
        new_hot = bytes([0xAB]) * obj_bytes

        def mutate(allowed, allowed_lock):
            # mid-leg write-under-lease: readers may serve the old
            # bytes until the revoke lands, then must flip — both
            # whole generations are valid, a mix never is
            time.sleep(0.35)
            with allowed_lock:
                allowed[hot].add(new_hot)
            cl.write_full("storm", hot, new_hot)

        flat, wall, ok, deltas, lease_clients = storm(
            c, payloads, mutate=mutate)
        verified &= ok
        hits = sum(cl_.lease_hits for cl_ in lease_clients)
        misses = sum(cl_.lease_misses for cl_ in lease_clients)
        total = readers * n_reads
        rados_reads = sum(deltas.values())
        hit_rate = hits / max(1, total)
        # counter-enforced zero-RADOS-ops: every lease hit is a read
        # that never produced an op_r anywhere
        gates["lease_hits_ge_half"] = hit_rate >= 0.5
        gates["lease_hits_zero_rados"] = \
            rados_reads + hits <= total + misses
        # post-leg: every reader converges to the new bytes (the
        # revoke reached them; ttl=30s means expiry can't be why)
        fresh = True
        deadline = time.time() + 10.0
        for cl_ in lease_clients:
            got = cl_.read("storm", hot)
            while got != new_hot and time.time() < deadline:
                time.sleep(0.05)
                got = cl_.read("storm", hot)
            fresh &= got == new_hot
        gates["revoke_converges"] = fresh
        verified &= fresh
        results["lease_repeat"] = dict(
            pcts(flat), lease_hit_rate=round(hit_rate, 3),
            lease_hits=int(hits), rados_reads=int(rados_reads),
            reads_per_s=round(total / wall, 1),
            **counters(c, ("read_lease_grant", "read_lease_revoke",
                           "balanced_read_serve")))
    finally:
        c.stop()

    # ---- leg 4: reader x10 scaling, byte-identity under pressure ----
    c, cl, payloads = build("balance", lease_ttl=0.0)
    try:
        flat, wall, ok, deltas, _cls = storm(
            c, payloads, n_clients=readers * 10,
            reads=max(4, n_reads // 10))
        verified &= ok
        sp = spread(deltas)
        results["readers_x10"] = dict(
            pcts(flat), spread=round(sp, 3) if sp else None,
            reads_per_s=round(
                readers * 10 * max(4, n_reads // 10) / wall, 1))
    finally:
        c.stop()

    gates["byte_identity"] = verified
    all_ok = all(gates.values())
    v = results["balance"]["reads_per_s"]
    base = results["primary"]["reads_per_s"]
    print(json.dumps({
        "metric": (f"balanced-read storm reads/s (zipf-{ZIPF_S}, "
                   f"{n_objects} objects x {obj_bytes // 1024}KiB, "
                   f"{readers} readers x {n_reads} reads, k=2 m=1 "
                   "no-spare, spread+lease+byte-identity gated)"),
        "value": v,
        "unit": "reads/s",
        "vs_baseline": round(v / base, 3) if base else None,
        "spread": {"primary": results["primary"]["spread"],
                   "balance": results["balance"]["spread"],
                   "gate_max": args.storm_spread},
        "lease_hit_rate": results["lease_repeat"]["lease_hit_rate"],
        "legs": results,
        "gates": gates,
        "digest_verified": verified,
    }))
    return 0 if all_ok else 1


def saturate_bench(args) -> int:
    """`--saturate` mode: the many-client QoS regression gate — a
    multi-process load generator (ceph_tpu_torch.load) drives simulated
    clients through librados over TCP against a 4-OSD MiniCluster,
    through ramp-to-saturation, steady-saturation and thrash-while-
    loaded legs, across >= 3 mclock recovery reservation/limit
    settings.  ONE JSON row: client p50/p99 per op class, achieved vs
    offered rate, recovery ETA/rates, msgs/op, SLOW_OPS trips — gated
    on STRUCTURAL invariants (no deadlock, bounded queues, recovery
    completes, QoS ordering holds), never absolute throughput (the CI
    box is a 2-core high-variance machine).  Exit nonzero on any
    invariant failure.  --smoke runs one tier-1-safe point (tens of
    clients, seconds-bounded) with no cross-point QoS gate."""
    from ..load.scenarios import (ScenarioConfig,
                                         default_sweep_points,
                                         run_sweep)
    if args.tenants:
        if args.frontend != "rados":
            print("--saturate --tenants drives librados only; the "
                  "rgw front-end leg runs through the plain "
                  "--saturate sweep (--frontend rgw without "
                  "--tenants)", file=sys.stderr)
            return 2
        return saturate_tenants_bench(args)
    if args.smoke:
        base = ScenarioConfig(
            profile=args.profile, procs=args.procs,
            clients=min(args.clients, 12), objects=16,
            ramp_rates=(40.0,), ramp_leg_s=1.0, steady_s=2.0,
            thrash_s=4.0, kill_after_s=0.6, recovery_deadline_s=30.0)
        points = [{"id": "smoke", "osd_mclock_recovery_res": 16.0,
                   "osd_mclock_recovery_lim": 32.0}]
    else:
        base = ScenarioConfig(
            profile=args.profile, procs=args.procs,
            clients=args.clients, objects=args.objects,
            ramp_rates=(50.0, 150.0, 450.0), ramp_leg_s=1.5,
            steady_s=args.steady_s, thrash_s=args.thrash_s,
            kill_after_s=1.0, recovery_deadline_s=45.0)
        points = default_sweep_points()
    base.frontend = args.frontend
    row = run_sweep(points=points, base=base)
    mid = row["points"][len(row["points"]) // 2]
    steady = mid["steady"]
    value = steady.get("achieved_per_s", 0.0)
    offered = steady.get("offered_per_s", 0.0)
    print(json.dumps({
        "metric": (f"saturation client ops/s ({base.profile} profile, "
                   f"{base.procs}-proc x {base.clients}-client burst, "
                   f"ec k=2 m=1 over TCP via {base.frontend}, mclock "
                   f"sweep {[p['id'] for p in points]}, "
                   "structural-invariant gated)"),
        "frontend": base.frontend,
        "value": value,
        "unit": "ops/s",
        "vs_baseline": (round(value / offered, 3) if offered else None),
        "profile": base.profile,
        "procs": base.procs,
        "clients": base.clients,
        "saturation_knee_per_s": mid["ramp"]["saturation_knee_per_s"],
        "client_read_p50_ms": steady.get("read", {}).get("p50_ms"),
        "client_read_p99_ms": steady.get("read", {}).get("p99_ms"),
        "client_write_p50_ms": steady.get("write", {}).get("p50_ms"),
        "client_write_p99_ms": steady.get("write", {}).get("p99_ms"),
        "recovery_eta_s": mid["recovery"].get("eta_s"),
        "recovery_wall_s": mid["recovery"].get("wall_s"),
        "msgs_per_op": mid["msgs_per_op"],
        "slow_ops_trips": sum(p["slow_ops_trips"]
                              for p in row["points"]),
        "qos": row["qos"],
        "invariants": {p["id"]: p["invariants"]
                       for p in row["points"]},
        "points": row["points"],
        "ok": row["ok"],
    }))
    return 0 if row["ok"] else 1


def saturate_tenants_bench(args) -> int:
    """`--saturate --tenants` mode: the multi-tenant QoS gate — four
    aligned per-tenant load streams (gold reserved, silver/bronze
    weight-only, bulk best-effort) through the saturation harness against
    one cluster whose OSDMap carries the committed tenant profiles,
    with a kill/revive storm mid-run and the adaptive reservation
    controller live.  ONE JSON row, exit-gated on the three isolation
    invariants: a flooding bulk tenant cannot push the reserved
    tenant's p99 outside its envelope, weights split excess capacity
    proportionally within slack, and the controller converges the
    recovery reservation between the hand-tuned sweep points."""
    from ..load.scenarios import (TenantScenarioConfig,
                                         run_tenant_point)
    if args.smoke:
        cfg = TenantScenarioConfig(
            objects=20, solo_s=2.0, flood_s=3.0, settle_s=1.0,
            weights_s=2.5, thrash_s=4.0, kill_after_s=0.8,
            solo_rate=24.0, flood_rate=96.0, thrash_rate=32.0,
            recovery_deadline_s=30.0)
    else:
        cfg = TenantScenarioConfig()
    row = run_tenant_point(cfg)
    print(json.dumps({
        "metric": ("tenant isolation ratio (gold flood-p99 / solo-p99 "
                   "under a bulk flood; 4 tenant streams, ec k=2 m=1 "
                   "over TCP, adaptive controller live, isolation-"
                   "invariant gated)"),
        "value": row["tenant_isolation_ratio"],
        "unit": "x",
        "vs_baseline": None,
        **row,
    }))
    return 0 if row["ok"] else 1


def scrub_bench(args) -> int:
    """`--scrub` mode: full-store folded deep scrub vs the per-object
    python verify loop, plus the inline-compression gates.  ONE JSON
    row.

    The folded path is the OSD's background-scrub engine verbatim:
    objects grouped into pow2 length buckets, zero-padded rows stacked
    into one launch per bucket through ECBatcher.verify, EXPECTED
    padded digests derived host-side from the stored digests via the
    CRC32C zero-extension operator.  The baseline is the per-object
    pure-python reference loop (crc32c_ref) — the unfolded shape the
    paper's claim is against.

    Gates: zero false mismatches over a clean store; an injected
    bit-flip detected by BOTH modes on the SAME object; folded >= 10x
    the loop when a fused backend (device or native C sweep) is
    available, >= 1.0 (no-regression) on the pure-python fallback;
    compression: czlib ratio <= 0.6 on compressible data,
    incompressible falls through via required_ratio, byte-exact
    round-trip.

    The fold runs on ``args.device``: the CRC32C kernel (G1) on the
    card; on the CPU the native sweep, which the reference's ``auto``
    verifier picks on a host without an accelerator."""
    import numpy as np

    dev = bench_device(args.device)
    on_cpu = dev.type == "cpu"
    from ..ec.batcher import ECBatcher
    from ..ec.verify import CrcVerifier
    from ..ops import native
    from ..ops.checksum import crc32c_extend_zeros, crc32c_ref
    from ..osd.compression import CompressionPolicy, decompress

    n_objects = int(os.environ.get("BENCH_SCRUB_OBJECTS", "384"))
    rng = np.random.default_rng(11)
    sizes = rng.integers(1024, 48 * 1024, n_objects)
    objs = [rng.integers(0, 256, int(s), dtype=np.uint8).tobytes()
            for s in sizes]
    try:
        digests = [native.crc32c(o) for o in objs]
        host_crc, host = native.crc32c, "native"
    except Exception:  # noqa: BLE001 - ctypes lib unavailable
        digests = [crc32c_ref(o) for o in objs]
        host_crc, host = crc32c_ref, "ref"
    total_bytes = sum(len(o) for o in objs)

    def python_loop(data, digs):
        bad = [i for i, (o, d) in enumerate(zip(data, digs))
               if crc32c_ref(o) != d]
        return bad

    def folded(data, digs, ver, batcher):
        buckets: dict[int, list] = {}
        for i, o in enumerate(data):
            n = len(o)
            b = 4 if n <= 4 else 1 << (n - 1).bit_length()
            buckets.setdefault(b, []).append(i)
        candidates = []
        for blen, idxs in sorted(buckets.items()):
            rows = np.zeros((len(idxs), blen), dtype=np.uint8)
            expected = np.empty(len(idxs), dtype=np.uint32)
            for r, i in enumerate(idxs):
                o = data[i]
                rows[r, :len(o)] = np.frombuffer(o, dtype=np.uint8)
                expected[r] = crc32c_extend_zeros(digs[i],
                                                  blen - len(o))
            got = batcher.verify(ver, rows)
            candidates += [idxs[int(r)]
                           for r in np.nonzero(got != expected)[0]]
        # candidates confirm against a host CRC (zero-false-mismatch
        # contract): a surviving candidate is a real mismatch
        return [i for i in candidates if host_crc(data[i]) != digs[i]]

    ver = (CrcVerifier("native") if on_cpu
           else CrcVerifier("device", device=dev))
    batcher = ECBatcher(window_us=0.0)
    fused = ver._backend != "ref" or host == "native"
    folded(objs[:16], digests[:16], ver, batcher)  # warm/compile

    t0 = time.perf_counter()
    loop_bad = python_loop(objs, digests)
    t_loop = time.perf_counter() - t0
    t0 = time.perf_counter()
    fold_bad = folded(objs, digests, ver, batcher)
    t_fold = time.perf_counter() - t0
    false_mismatches = len(fold_bad) + len(loop_bad)

    # corruption leg: flip one byte, both modes must flag that object
    victim = n_objects // 3
    flipped = bytearray(objs[victim])
    flipped[len(flipped) // 2] ^= 0x40
    corrupted = list(objs)
    corrupted[victim] = bytes(flipped)
    loop_hit = python_loop(corrupted, digests)
    fold_hit = folded(corrupted, digests, ver, batcher)
    detect_ok = loop_hit == [victim] and fold_hit == [victim]

    # compression gates (czlib through the pool-policy seam)
    pol = CompressionPolicy("aggressive", "czlib", 0.875, 4096)
    compressible = (b"the quick brown fox jumps over the lazy dog " *
                    2000)
    comp = pol.maybe_compress(compressible)
    ratio = (len(comp[0]) / len(compressible)) if comp else 1.0
    rt_ok = comp is not None and decompress(
        comp[0], comp[1]["cz"], comp[1]["crl"]) == compressible
    incompressible = rng.integers(0, 256, 64 * 1024,
                                  dtype=np.uint8).tobytes()
    falls_through = pol.maybe_compress(incompressible) is None

    speedup = t_loop / max(t_fold, 1e-9)
    need = 10.0 if fused else 1.0
    ok = (false_mismatches == 0 and detect_ok and speedup >= need
          and rt_ok and ratio <= 0.6 and falls_through)
    print(json.dumps({
        "metric": (f"folded deep-scrub verify MB/s ({n_objects} ragged "
                   f"objects, {ver._backend} fold backend on "
                   f"{device_label(dev)}, {host} host "
                   "recheck, vs per-object crc32c_ref loop; "
                   "+ czlib inline-compression gates)"),
        "value": round(total_bytes / max(t_fold, 1e-9) / 1e6, 1),
        "unit": "MB/s",
        "vs_baseline": round(speedup, 1),
        "objects": n_objects,
        "bytes": int(total_bytes),
        "loop_s": round(t_loop, 4),
        "folded_s": round(t_fold, 4),
        "fold_backend": ver._backend,
        "on_cpu": on_cpu,
        "speedup_required": need,
        "false_mismatches": false_mismatches,
        "corruption_detected_both": detect_ok,
        "compress_ratio": round(ratio, 3),
        "compress_roundtrip_ok": rt_ok,
        "incompressible_falls_through": falls_through,
        "ok": ok,
    }))
    return 0 if ok else 1


def headline_bench(device: str = "cuda") -> int:
    """The headline: tools/bench_tpu's kernel GB/s at k=8 m=3 on 1 MiB
    stripes (batch 64, parity on the device, digest-verified), beside
    the native library's single-thread GB/s on the same shape.  The
    child failing fails the run: there is no recorded number and no
    CPU fallback."""
    bench_device(device)
    cpu = cpu_baseline_gbps()
    print(f"bench: cpu single-thread baseline {cpu:.2f} GB/s", file=sys.stderr)
    dev = device_gbps(device)
    print(f"bench: device detail {json.dumps(dev)}", file=sys.stderr)
    value = dev["kernel_gbps"]
    e2e = dev.get("e2e_gbps")
    e2e_s = f"{e2e:.3f}" if e2e is not None else "n/a"
    stg = dev.get("staging_gbps")
    stg_s = f"{stg:.3f}" if stg is not None else "n/a"
    where = dev.get("device", device)
    if dev.get("power_limit"):
        where = f"{where}, {dev['power_limit']}"
    metric = (f"EC encode GB/s (k={K},m={M}, 1MiB stripes, "
              f"{dev.get('kernel', '?')} kernel on {where}, parity on the "
              f"device, digest-verified; e2e {e2e_s}, staging {stg_s})")
    print(json.dumps({
        "metric": metric,
        "value": round(value, 3),
        "unit": "GB/s",
        "vs_baseline": round(value / cpu, 3) if cpu > 0 else None,
    }))
    return 0


def parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="ceph_tpu_torch.tools.bench_root",
        description="ceph_tpu_torch benchmark driver: headline EC "
                    "kernel GB/s by default, or one focused mode.  "
                    "Every mode prints ONE JSON row and exits nonzero "
                    "when its acceptance gate fails.")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--ec-batch", action="store_true",
                      help="cross-op batched vs per-op encode burst "
                           "(+ sharded, adaptive-window and device-"
                           "plane legs)")
    mode.add_argument("--ec-recovery", action="store_true",
                      help="PG-recovery-storm decode burst (batched "
                           "vs unbatched vs sharded, max_bytes sweep)")
    mode.add_argument("--ec-read", action="store_true",
                      help="coalesced EC read pipeline vs per-op "
                           "baseline through a MiniCluster")
    mode.add_argument("--saturate", action="store_true",
                      help="many-client saturation harness with the "
                           "mclock QoS reservation sweep (the SLO "
                           "regression gate)")
    mode.add_argument("--read-storm", action="store_true",
                      help="zipf-1.2 hot-object read storm: balanced "
                           "reads vs primary (per-OSD spread gate), "
                           "client lease-cache hit-rate gate, mid-leg "
                           "write-under-lease revoke, reader-x10 leg")
    mode.add_argument("--scrub", action="store_true",
                      help="folded deep-scrub verify vs per-object "
                           "python loop (zero-false-mismatch + "
                           "corruption-detection gates) + inline-"
                           "compression ratio/round-trip gates")
    ap.add_argument("--trace", action="store_true",
                    help="with --ec-batch/--ec-read: print the per-"
                         "stage latency decomposition table")
    ap.add_argument("--no-overhead", action="store_true",
                    help="with --ec-batch: skip the tracing, exemplar "
                         "and perf-query overhead legs and their three "
                         "5%% gates, which compare two host-timed "
                         "bursts (not in bench.py)")
    ap.add_argument("--progress", action="store_true",
                    help="with --ec-recovery: drive a MiniCluster "
                         "kill/revive and gate on the mgr progress "
                         "story")
    ap.add_argument("--no-wide", action="store_true",
                    help="with --ec-recovery: skip the {rs, clay, lrc, "
                         "shec} x {healthy, degraded, storm} wide-code "
                         "matrix leg")
    sat = ap.add_argument_group("saturate options")
    sat.add_argument("--smoke", action="store_true",
                     help="one tier-1-safe point: tens of clients, "
                          "seconds-bounded, no cross-point QoS gate")
    sat.add_argument("--tenants", action="store_true",
                     help="with --saturate: the multi-tenant QoS gate "
                          "(per-tenant dmclock streams, reserved-p99 "
                          "envelope under flood, proportional weight "
                          "split, adaptive-controller convergence)")
    sat.add_argument("--frontend", default="rados",
                     choices=("rados", "rgw"),
                     help="with --saturate: drive librados directly "
                          "or the RgwGateway PUT/GET object path "
                          "(same legs, histograms and invariants)")
    sat.add_argument("--procs", type=int, default=2,
                     help="load-generator worker processes")
    sat.add_argument("--clients", type=int, default=16,
                     help="cluster-wide simulated client concurrency")
    sat.add_argument("--objects", type=int, default=48,
                     help="preloaded object working set")
    sat.add_argument("--profile", default="small_mixed",
                     help="workload profile "
                          "(ceph_tpu_torch.load.profiles)")
    sat.add_argument("--steady-s", type=float, default=4.0,
                     help="steady-saturation leg seconds")
    sat.add_argument("--thrash-s", type=float, default=8.0,
                     help="thrash-while-loaded leg seconds")
    storm = ap.add_argument_group("read-storm options")
    storm.add_argument("--storm-objects", type=int, default=16,
                       help="with --read-storm: zipf working-set size")
    storm.add_argument("--storm-reads", type=int, default=80,
                       help="with --read-storm: reads per reader "
                            "per leg")
    storm.add_argument("--storm-spread", type=float, default=1.5,
                       help="with --read-storm: max allowed per-OSD "
                            "served-read spread (max/mean) under "
                            "read_policy=balance")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the kernel modes and the headline run: "
                         "cuda (default) needs a card; cpu runs the "
                         "kernels' plain versions")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        bench_device(args.device)
    except RuntimeError as e:
        print(f"bench_root: {e}", file=sys.stderr)
        return 2
    if args.ec_batch:
        return ec_batch_bench(trace=args.trace, device=args.device,
                              overhead=not args.no_overhead)
    if args.ec_recovery:
        return ec_recovery_bench(progress=args.progress,
                                 wide=not args.no_wide,
                                 device=args.device)
    if args.ec_read:
        return ec_read_bench(trace=args.trace)
    if args.saturate:
        return saturate_bench(args)
    if args.read_storm:
        return read_storm_bench(args)
    if args.scrub:
        return scrub_bench(args)
    return headline_bench(args.device)


if __name__ == "__main__":
    sys.exit(main())
