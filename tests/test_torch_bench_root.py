"""The port's bench driver (tools/bench_root), the twin of the repo's
bench.py, on the CPU: its kernel modes (``--ec-batch``,
``--ec-recovery`` and the wide matrix, ``--scrub``) at small sizes set
through its module constants, its device-free legs against the
reference's, each mode's JSON keys against bench.py's, and the
deliberate differences (``--device``, no fallback, no recorded number,
failing candidates, the sharded legs)."""

import ast
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import bench as ref_bench
from ceph_tpu_torch.ops import ec_kernels
from ceph_tpu_torch.tools import bench_root, bench_sweep

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(REPO, "bench.py")


def ref_row_keys(func: str) -> set[str]:
    """The literal keys of the JSON row bench.py's ``func`` prints (its
    first ``json.dumps`` of a dict)."""
    tree = ast.parse(open(BENCH_PY).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys
                    if isinstance(k, ast.Constant)}
    raise AssertionError(f"no JSON row in bench.py {func}")


def run_mode(fn, *args, **kw) -> tuple[int, dict]:
    """A mode's exit code and the JSON row it printed last."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = fn(*args, **kw)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def small(monkeypatch):
    """The kernel modes' sizes cut for the CPU; the store and KV legs,
    checked on their own below, stubbed."""
    monkeypatch.setattr(bench_root, "EC_BATCH_CHUNK", 4096)
    monkeypatch.setattr(bench_root, "EC_BATCH_WRITERS", 4)
    monkeypatch.setattr(bench_root, "EC_BATCH_OPS", 3)
    monkeypatch.setattr(bench_root, "PLANE_CHUNK", 8192)
    monkeypatch.setattr(bench_root, "PLANE_WRITERS", 4)
    monkeypatch.setattr(bench_root, "PLANE_OPS", 2)
    monkeypatch.setattr(bench_root, "PLANE_GROUP", 2)
    monkeypatch.setattr(bench_root, "RECOVERY_CHUNK", 4096)
    monkeypatch.setattr(bench_root, "RECOVERY_READERS", 4)
    monkeypatch.setattr(bench_root, "RECOVERY_OPS", 3)
    monkeypatch.setattr(bench_root, "_store_commit_leg",
                        lambda: {"store_commit_ok": True})
    monkeypatch.setattr(bench_root, "_kv_maint_leg",
                        lambda: {"kv_maint_ok": True})


# ------------------------------------------------------- the constants
def test_lifted_sizes_are_the_references():
    """The module constants hold the values bench.py keeps in locals."""
    src = open(BENCH_PY).read()
    batch = src[src.index("def ec_batch_bench"):
                src.index("def _recovery_progress_leg")]
    rec = src[src.index("def ec_recovery_bench"):
              src.index("def ec_read_bench")]
    assert "chunk = 16 * 1024\n    writers, ops_per = 8, 24" in batch
    assert (bench_root.EC_BATCH_CHUNK, bench_root.EC_BATCH_WRITERS,
            bench_root.EC_BATCH_OPS) == (16 * 1024, 8, 24)
    assert "plane_chunk = 128 * 1024\n    plane_writers, plane_ops = " \
           "16, 8\n    plane_group = 8" in batch
    assert (bench_root.PLANE_CHUNK, bench_root.PLANE_WRITERS,
            bench_root.PLANE_OPS, bench_root.PLANE_GROUP) == \
        (128 * 1024, 16, 8, 8)
    assert "chunk = 16 * 1024\n    readers, ops_per = 8, 12" in rec
    assert (bench_root.RECOVERY_CHUNK, bench_root.RECOVERY_READERS,
            bench_root.RECOVERY_OPS) == (16 * 1024, 8, 12)


# ----------------------------------------------------- the kernel modes
def test_ec_batch_on_the_cpu(small):
    """Every op digest-verified, one copy back a flush, every candidate
    timed (``xla`` among them: the CPU runs the plain versions), the
    CPU's picks the pinned plain version; the reference's keys."""
    rc, row = run_mode(bench_root.ec_batch_bench, device="cpu")
    assert row["digest_verified"] is True
    assert row["single_d2h_per_flush"] is True
    assert row["d2h_copies_per_flush"] == 1.0
    assert row["shard_devices"] == 1
    assert set(row["ec_kernel_candidates_gbps"]) == set(ec_kernels.KERNELS)
    assert all(v > 0 for v in row["ec_kernel_candidates_gbps"].values())
    assert row["ec_kernel_picks"] and \
        set(row["ec_kernel_picks"].values()) == {"xla"}
    assert "torch kernels on cpu" in row["metric"]
    assert row["wire_zero_copy_ok"] is True
    assert ref_row_keys("ec_batch_bench") - {"trace_stages"} <= set(row)
    # the timing gates are ratios of host times at these small sizes;
    # everything structural holds, so only they may fail the exit code
    if rc:
        assert not (row["trace_overhead_ok"] and row["exemplar_overhead_ok"]
                    and row["perf_query_overhead_ok"])


def test_ec_batch_without_the_overhead_legs(small):
    """``--no-overhead`` runs no overhead burst: the three legs' keys
    read None and the exit code is every other gate of the mode."""
    rc, row = run_mode(bench_root.main, ["--ec-batch", "--no-overhead",
                                         "--device", "cpu"])
    assert rc == 0 and row["digest_verified"] is True
    for key in ("trace_overhead_pct_at_001", "trace_overhead_ok",
                "exemplar_overhead_pct_at_001", "exemplar_overhead_ok",
                "perf_query_overhead_pct", "perf_query_overhead_ok",
                "trace_overhead_gbps", "perf_query_gbps"):
        assert row[key] is None, key
    assert ref_row_keys("ec_batch_bench") - {"trace_stages"} <= set(row)


def test_ec_batch_trace_prints_the_stage_tables(small, capsys):
    _rc, row = run_mode(bench_root.ec_batch_bench, trace=True,
                        device="cpu")
    assert {"ec-op", "ec-batch-wait", "ec-flush"} <= set(row["trace_stages"])
    assert row["trace_blame"]


def test_ec_recovery_on_the_cpu(small):
    rc, row = run_mode(bench_root.ec_recovery_bench, progress=False,
                       wide=False, device="cpu")
    assert rc == 0
    assert row["digest_verified"] is True
    assert row["shard_devices"] == 1
    assert set(row["max_bytes_sweep"]) == {"1MiB", "4MiB", "16MiB",
                                           "64MiB"}
    assert row["scenarios"]["batched"]["ops_per_launch"] >= 1
    assert ref_row_keys("ec_recovery_bench") <= set(row)


def test_wide_repair_matrix_as_the_reference():
    """Every cell byte-verified; the repair bytes per lost byte of each
    plugin and the locality verdict equal to the reference's."""
    port = bench_root.wide_repair_matrix(full=False, chunk=4096,
                                         device="cpu")
    ref = ref_bench.wide_repair_matrix(full=False, chunk=4096)
    assert port["ok"], port
    for pname, cell in port["cells"].items():
        for leg, v in cell.items():
            assert v["ok"], (pname, leg, v)
        assert set(cell) == set(ref["cells"][pname])
    assert port["repair_bytes_per_lost_byte"] == \
        ref["repair_bytes_per_lost_byte"]
    assert port["locality_beats_rs"] is ref["locality_beats_rs"] is True
    assert set(port) == set(ref)


def test_scrub_as_the_reference(monkeypatch):
    """The same seeded store: no false mismatch, the flipped byte found
    by both modes, and the compression gates' numbers equal."""
    monkeypatch.setenv("BENCH_SCRUB_OBJECTS", "40")
    rc, port = run_mode(bench_root.scrub_bench,
                        types.SimpleNamespace(device="cpu"))
    _, ref = run_mode(ref_bench.scrub_bench, types.SimpleNamespace())
    assert port["false_mismatches"] == ref["false_mismatches"] == 0
    assert port["corruption_detected_both"] is True
    assert ref["corruption_detected_both"] is True
    for key in ("objects", "bytes", "compress_ratio",
                "compress_roundtrip_ok", "incompressible_falls_through",
                "fold_backend", "speedup_required"):
        assert port[key] == ref[key], key
    assert set(ref) <= set(port)
    assert rc == (0 if port["ok"] else 1)


# --------------------------------------------------- device-free legs
def test_wire_leg_keeps_the_references_counter_contract():
    port, ref = bench_root._wire_path_leg(), ref_bench._wire_path_leg()
    assert set(port) == set(ref)
    for key in ("wire_tx_flatten_copies_per_op",
                "wire_rx_copy_copies_per_op", "wire_flatten_copies_per_mib",
                "wire_secure_tx_flatten_copies_per_op",
                "wire_secure_rx_copy_copies_per_op", "wire_zero_copy_ok",
                "wire_uring_active", "wire_stack_gate", "wire_stack_ok"):
        assert port[key] == ref[key], key
    assert port["wire_tx_flatten_copies_per_op"] == 0
    assert port["wire_zero_copy_ok"] is True


def test_store_leg_keeps_the_references_counter_contract():
    """Group commit on both: under 0.5 fsyncs a transaction, the same
    transactions, every payload read back (the throughput ratio is a
    timing and stays out)."""
    port, ref = bench_root._store_commit_leg(), ref_bench._store_commit_leg()
    assert set(port) == set(ref)
    assert port["store_fsyncs_per_txn"] < 0.5
    assert ref["store_fsyncs_per_txn"] < 0.5
    assert port["store_txns"] == ref["store_txns"]
    assert port["store_ingest_ref_share"] == ref["store_ingest_ref_share"]


def test_kv_leg_keeps_the_references_counter_contract():
    """Background maintenance on both: no inline flush or compaction in
    the kv-sync thread, flushes and a compaction, identical contents,
    cache hits (the p99 comparison is a timing and stays out)."""
    port, ref = bench_root._kv_maint_leg(), ref_bench._kv_maint_leg()
    assert set(port) == set(ref)
    for row in (port, ref):
        assert row["kv_maint_inline_maintenance"] == 0
        assert row["kv_maint_identical"] is True
        assert row["kv_maint_flushes"] >= 4
        assert row["kv_maint_compactions"] >= 1
        assert row["kv_maint_cache_hits"] > 0


# ------------------------------------------------- deliberate differences
@pytest.mark.parametrize("argv", [[], ["--ec-batch"], ["--ec-recovery"],
                                  ["--scrub"], ["--ec-read"],
                                  ["--saturate", "--smoke"]])
def test_device_cuda_without_a_card_exits_nonzero(argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert bench_root.main(argv) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "torch.cuda.is_available() is False" in captured.err


def test_module_without_a_card_prints_no_row():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "-m",
                          "ceph_tpu_torch.tools.bench_root", "--scrub"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def _recording_open(monkeypatch) -> list:
    import builtins
    opened = []
    real = builtins.open

    def spy(path, *a, **kw):
        opened.append(str(path))
        return real(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    return opened


def test_headline_fails_when_its_child_fails(monkeypatch):
    """No recorded number and no CPU fallback: a failed bench_tpu child
    fails the headline, and BENCH_TPU_RECORDED.json is never opened."""
    monkeypatch.setattr(bench_root, "cpu_baseline_gbps", lambda: 1.0)
    calls = []

    def fail(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "boom")

    monkeypatch.setattr(bench_root.subprocess, "run", fail)
    opened = _recording_open(monkeypatch)
    with pytest.raises(RuntimeError, match="bench_tpu failed"):
        bench_root.headline_bench("cpu")
    assert calls and calls[0][1:3] == ["-m", "ceph_tpu_torch.tools.bench_tpu"]
    assert calls[0][-2:] == ["--device", "cpu"]
    assert not any("RECORDED" in p for p in opened)
    assert not hasattr(bench_root, "_recorded_tpu")


def test_headline_reports_the_childs_kernel(monkeypatch, capsys):
    monkeypatch.setattr(bench_root, "cpu_baseline_gbps", lambda: 2.0)
    line = {"kernel": "mxu", "kernel_gbps": 1620.2, "e2e_gbps": 3.1,
            "staging_gbps": 4.3, "device": "NVIDIA H100 80GB HBM3",
            "power_limit": "700.00 W", "digest_verified": True}
    monkeypatch.setattr(
        bench_root.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(
            cmd, 0, "noise\n" + json.dumps(line) + "\n", ""))
    opened = _recording_open(monkeypatch)
    assert bench_root.headline_bench("cpu") == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) == ref_row_keys("headline_bench")
    assert row["value"] == 1620.2 and row["vs_baseline"] == 810.1
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in row["metric"]
    assert "tpu" not in row["metric"].lower().replace("bench_tpu", "")
    assert not any("RECORDED" in p for p in opened)


def test_failing_candidate_fails_the_mode(small, monkeypatch):
    """Only kernel_supports skips a candidate: one that raises at its
    launch ends the mode (bench.py:806 records None and carries on)."""
    real = ec_kernels.RegionMatmul

    class Broken(real):
        def __call__(self, *a, **kw):
            if self.kernel == "mxu":
                raise RuntimeError("mxu launch failed")
            return super().__call__(*a, **kw)

    monkeypatch.setattr(ec_kernels, "RegionMatmul", Broken)
    with pytest.raises(RuntimeError, match="mxu launch failed"):
        run_mode(bench_root.ec_batch_bench, device="cpu")


def test_unsupported_candidate_is_skipped(small, monkeypatch):
    real = ec_kernels.kernel_supports
    monkeypatch.setattr(ec_kernels, "kernel_supports",
                        lambda k, M, *a, **kw: k != "bitxor"
                        and real(k, M, *a, **kw))
    _rc, row = run_mode(bench_root.ec_batch_bench, device="cpu")
    assert set(row["ec_kernel_candidates_gbps"]) == {"xla", "pallas", "mxu"}
    assert row["digest_verified"] is True


@pytest.mark.parametrize("mode", ["ec_batch_bench", "ec_recovery_bench"])
def test_sharded_legs_fan_out_over_the_mesh(small, mode):
    """With 4 logical CPU devices (parallel.mesh.force_devices) the
    sharded legs fan out as bench.py's do over its forced devices:
    ``shard_devices`` 4, sharded launches, every op verified."""
    from ceph_tpu_torch.parallel import mesh as meshmod

    meshmod.force_devices("cpu", 4)
    try:
        kw = {} if mode == "ec_batch_bench" else {"progress": False,
                                                   "wide": False}
        _rc, row = run_mode(getattr(bench_root, mode), device="cpu", **kw)
    finally:
        meshmod.force_devices("cpu", None)
    assert row["shard_devices"] == 4
    assert row["digest_verified"] is True
    sharded = (row["sharded_launches"] if mode == "ec_batch_bench"
               else row["scenarios"]["sharded"]["sharded_launches"])
    assert sharded >= 1


def test_kernel_times_on_the_cpu_time_each_call():
    calls = []
    times = bench_root.kernel_times(
        lambda: calls.append(1) or torch.zeros(4), 3,
        torch.device("cpu"))
    assert len(times) == 3 and len(calls) == 3
    assert all(t >= 0 for t in times)


def test_flags_are_the_references():
    """Every option of bench.py, with its default, plus --device."""
    src = open(BENCH_PY).read()
    ref_flags = set(re.findall(r'add_argument\("(--[a-z-]+)"', src))
    port = bench_root.parse_args([])
    assert {f"--{k.replace('_', '-')}" for k in vars(port)} == \
        ref_flags | {"--device", "--no-overhead"}
    assert port.no_overhead is False
    assert port.device == "cuda"
    for flag, want in (("procs", 2), ("clients", 16), ("objects", 48),
                       ("profile", "small_mixed"), ("steady_s", 4.0),
                       ("thrash_s", 8.0), ("storm_objects", 16),
                       ("storm_reads", 80), ("storm_spread", 1.5),
                       ("frontend", "rados")):
        assert getattr(port, flag) == want, flag


# --------------------------------------------------------- the sweep row
def test_sweep_row_extracts_its_keys(tmp_path, monkeypatch):
    """``--only scrub_throughput --device cpu`` through the sweep's
    child: the row keeps exactly its extract keys."""
    monkeypatch.setattr(bench_sweep, "STATE",
                        {"cuda": str(tmp_path / "s.json"),
                         "cpu": str(tmp_path / "s_cpu.json")})
    monkeypatch.setenv("BENCH_SCRUB_OBJECTS", "24")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench_sweep.main(["--only", "scrub_throughput", "--device",
                               "cpu", "--retries", "0"])
    assert rc == 0, out.getvalue()
    entry = json.load(open(tmp_path / "s_cpu.json"))["scrub_throughput"]
    row = {c["id"]: c for c in bench_sweep.configs()}["scrub_throughput"]
    assert set(entry["result"]) == set(row["extract"]) | {"wall_s"}
    assert entry["result"]["objects"] == 24
    assert entry["result"]["false_mismatches"] == 0
    assert entry["result"]["fold_backend"] == "native"
    assert np.isfinite(entry["result"]["value"])
