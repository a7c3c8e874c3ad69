"""The port's bench driver's cluster modes on the CPU (tools/bench_root
``--ec-read``, ``--read-storm``, ``--saturate``, ``--ec-recovery``'s
progress leg): native clusters of the port, byte-verified, each row
with bench.py's keys; the workers of ``--saturate`` are separate
processes over TCP."""

import contextlib
import io
import json
import os
import types

import torch

from ceph_tpu_torch.tools import bench_root
from tests.test_torch_bench_root import ref_row_keys

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(REPO, "bench.py")


def run_main(argv) -> tuple[int, dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench_root.main(argv + ["--device", "cpu"])
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_ec_read_mode():
    rc, row = run_main(["--ec-read"])
    assert rc == 0 and row["digest_verified"] is True
    assert ref_row_keys("ec_read_bench") <= set(row)
    for mode in ("coalesced", "perop"):
        assert set(row[mode]) == {"healthy", "hot_object", "ranged",
                                  "degraded"}
    assert row["decode_launches_per_op"]["coalesced"] > 0


def test_read_storm_mode_at_a_small_size():
    """Every read in every leg byte-identical, lease hits never RADOS
    ops; the lease hit-rate gate needs the default reads per reader, so
    at this size only its counters are read."""
    rc, row = run_main(["--read-storm", "--storm-objects", "8",
                        "--storm-reads", "24"])
    assert ref_row_keys("read_storm_bench") <= set(row)
    assert row["gates"]["byte_identity"] is True
    assert row["gates"]["lease_hits_zero_rados"] is True
    assert set(row["legs"]) == {"primary", "balance", "lease_repeat",
                                "readers_x10"}
    assert row["spread"]["gate_max"] == 1.5
    assert rc == (0 if all(row["gates"].values()) else 1)


def test_saturate_smoke_mode():
    rc, row = run_main(["--saturate", "--smoke", "--clients", "8"])
    assert rc == 0 and row["ok"] is True
    assert ref_row_keys("saturate_bench") <= set(row)
    assert row["invariants"]["smoke"] == {"no_deadlock": True,
                                          "queues_bounded": True,
                                          "recovery_completes": True,
                                          "scrub_completes": True}
    assert row["frontend"] == "rados" and row["value"] > 0


def test_saturate_tenants_takes_librados_only(capsys):
    assert bench_root.main(["--saturate", "--tenants", "--frontend",
                            "rgw", "--device", "cpu"]) == 2
    assert "librados only" in capsys.readouterr().err


def test_recovery_progress_leg():
    """The mgr progress story through a native MiniCluster: the item
    appears, climbs monotonically to 100 and clears."""
    leg = bench_root._recovery_progress_leg()
    assert leg["ok"], leg
    assert set(leg) == {"ok", "appeared", "monotonic", "reached_100",
                        "cleared", "items"}


def test_tenant_config_is_the_references_smoke(monkeypatch):
    """--saturate --tenants --smoke builds bench.py's smoke config."""
    seen = {}

    def fake(cfg):
        seen["cfg"] = cfg
        return {"tenant_isolation_ratio": 1.0, "ok": True}

    monkeypatch.setattr("ceph_tpu_torch.load.scenarios.run_tenant_point",
                        fake)
    rc, row = run_main(["--saturate", "--tenants", "--smoke"])
    assert rc == 0 and row["value"] == 1.0
    assert ref_row_keys("saturate_tenants_bench") <= set(row)
    want = types.SimpleNamespace(
        objects=20, solo_s=2.0, flood_s=3.0, settle_s=1.0, weights_s=2.5,
        thrash_s=4.0, kill_after_s=0.8, solo_rate=24.0, flood_rate=96.0,
        thrash_rate=32.0, recovery_deadline_s=30.0)
    for k, v in vars(want).items():
        assert getattr(seen["cfg"], k) == v, k


def test_cluster_modes_put_nothing_on_the_card():
    """The cluster modes' configs are the reference's, byte for byte:
    native codecs and numpy pools (so nothing launches on a card), in
    bench_root as in bench.py and in the scenarios as in the
    reference's."""
    from ceph_tpu_torch.load import scenarios
    for port, ref in ((bench_root.__file__, BENCH_PY),
                      (scenarios.__file__, os.path.join(
                          REPO, "ceph_tpu", "load", "scenarios.py"))):
        src, want = open(port).read(), open(ref).read()
        for needle in ('"ec_backend": "native"', '"backend": "numpy"'):
            assert src.count(needle) == want.count(needle) >= 2, needle
