"""The port's saturation harness (ceph_tpu_torch.load) against the JAX
package's: the workload model gives the same histograms, draws,
profiles, leg specs and results on the same seeds, both ways across the
packages; the reference's unit tests of tests/test_load_harness.py on the
port; the worker spawn (the port's worker module, no CUDA device); and
the tier-1 smoke legs of tests/test_load_harness.py and tests/test_qos.py
on the port's cluster, workers as separate processes over TCP."""

import dataclasses
import json
import random
import sys

import numpy as np
import pytest

from ceph_tpu.load import profiles as ref_profiles
from ceph_tpu.load import scenarios as ref_scenarios
from ceph_tpu_torch.load import generator, load_worker, profiles, scenarios
from ceph_tpu_torch.load.profiles import (PROFILES, LegResult, LegSpec,
                                          Pow2Histogram, ZipfSampler,
                                          get_profile)

SEED = 1307


def _samples(seed: int, n: int = 600) -> list[float]:
    """Latencies in microseconds over six decades."""
    rng = np.random.default_rng(seed)
    return list(10 ** rng.uniform(0, 6, n))


# ------------------------------------------------ both packages, same seed
@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_histogram_record_merge_quantile_as_the_reference(seed):
    """Bit-for-bit: equal dicts, equal quantiles at every probe, after
    recording and after merging a dict written by the other package
    (0 and 1 included, and the empty histogram's None)."""
    a, b = _samples(seed), _samples(seed + 100, 50)
    port, ref = Pow2Histogram(), ref_profiles.Pow2Histogram()
    for v in a:
        port.record(v)
        ref.record(v)
    assert port.to_dict() == ref.to_dict()
    other_port, other_ref = Pow2Histogram(), ref_profiles.Pow2Histogram()
    for v in b:
        other_port.record(v)
        other_ref.record(v)
    port.merge(other_ref.to_dict())
    ref.merge(other_port.to_dict())
    assert port.to_dict() == ref.to_dict()
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert port.quantile(q) == ref.quantile(q)
    assert port.mean() == ref.mean()
    assert Pow2Histogram().quantile(0.5) is None \
        and ref_profiles.Pow2Histogram().quantile(0.5) is None


@pytest.mark.parametrize("n,alpha", [(1, 0.9), (100, 0.0), (100, 0.9),
                                     (48, 1.4)])
def test_zipf_draws_as_the_reference(n, alpha):
    port = ZipfSampler(n, alpha, random.Random(SEED))
    ref = ref_profiles.ZipfSampler(n, alpha, random.Random(SEED))
    assert [port.sample() for _ in range(2000)] == \
        [ref.sample() for _ in range(2000)]


def test_profiles_as_the_reference():
    """Every profile's fields equal, and each draws the same sizes and
    op classes from the same seed."""
    assert list(PROFILES) == list(ref_profiles.PROFILES)
    for name, prof in PROFILES.items():
        ref = ref_profiles.PROFILES[name]
        assert dataclasses.asdict(prof) == dataclasses.asdict(ref)
        rp, rr = random.Random(SEED), random.Random(SEED)
        sp, sr = prof.size_sampler(rp), ref.size_sampler(rr)
        assert [sp() for _ in range(300)] == [sr() for _ in range(300)]
        assert [prof.op_class(rp) for _ in range(300)] == \
            [ref.op_class(rr) for _ in range(300)]


def _leg_result(pkg, seed: int):
    rng = random.Random(seed)
    r = pkg.LegResult(offered=rng.randrange(1000),
                      achieved=rng.randrange(1000),
                      errors=rng.randrange(10),
                      wall_s=rng.uniform(0.5, 5.0))
    for klass in ("read", "write", "gold:read"):
        for _ in range(rng.randrange(1, 60)):
            r.hist(klass).record(rng.uniform(1, 1e6))
    return r


def test_leg_specs_and_results_cross_the_packages():
    """A dict written by one package, parsed by the other, equals it;
    merges of the two packages' results are equal."""
    spec = dict(name="ramp0", profile="read_heavy", duration_s=1.5,
                mode="open", rate=37.5, concurrency=6)
    p, r = LegSpec(**spec), ref_profiles.LegSpec(**spec)
    assert ref_profiles.LegSpec.from_dict(p.to_dict()) == r
    assert LegSpec.from_dict(r.to_dict()) == p
    assert p.to_dict() == r.to_dict()
    for seed in (SEED, SEED + 7):
        pr, rr = _leg_result(profiles, seed), _leg_result(ref_profiles,
                                                          seed)
        assert pr.to_dict() == rr.to_dict()
        assert ref_profiles.LegResult.from_dict(
            json.loads(json.dumps(pr.to_dict()))).to_dict() == rr.to_dict()
        assert LegResult.from_dict(rr.to_dict()).to_dict() == pr.to_dict()
        pr.merge(_leg_result(ref_profiles, seed + 1).to_dict())
        rr.merge(_leg_result(profiles, seed + 1).to_dict())
        assert pr.to_dict() == rr.to_dict()


@pytest.mark.parametrize("seed", range(6))
def test_envelopes_as_the_reference(seed):
    rng = random.Random(seed)
    seq = [rng.choice([None, rng.uniform(1, 500)])
           for _ in range(rng.randrange(0, 6))]
    for slack in (1.05, 1.5, 2.0, 8.0):
        assert scenarios.monotone_within(seq, slack) == \
            ref_scenarios.monotone_within(seq, slack)
        assert scenarios.bounded_spread(seq, slack) == \
            ref_scenarios.bounded_spread(seq, slack)


@pytest.mark.parametrize("over", [
    {}, {"thrash": False}, {"ramp_rates": (40.0,), "frontend": "rgw"},
    {"profile": "write_burst", "clients": 30, "steady_s": 2.5}])
def test_scenario_legs_as_the_reference(over):
    port = scenarios.ScenarioConfig(**over)
    ref = ref_scenarios.ScenarioConfig(**over)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [leg.to_dict() for leg in port.legs()] == \
        [leg.to_dict() for leg in ref.legs()]
    assert scenarios.default_sweep_points() == \
        ref_scenarios.default_sweep_points()
    assert dataclasses.asdict(scenarios.TenantScenarioConfig()) == \
        dataclasses.asdict(ref_scenarios.TenantScenarioConfig())


# ------------------------------ the reference's unit tests on the port
def test_pow2_histogram_record_merge_quantile():
    a = Pow2Histogram()
    for v in (3, 3, 10, 300, 3000):
        a.record(v)
    b = Pow2Histogram()
    for v in (70000, 70000):
        b.record(v)
    a.merge(b.to_dict())          # dict form: the cross-process path
    assert a.count == 7
    assert a.quantile(0.5) == 512.0
    assert a.quantile(0.99) == 131072.0
    c = Pow2Histogram.from_dict(json.loads(json.dumps(a.to_dict())))
    assert c.count == a.count and c.quantile(0.5) == a.quantile(0.5)
    assert Pow2Histogram().quantile(0.5) is None


def test_zipf_sampler_skew_and_uniform():
    rng = random.Random(7)
    hot = ZipfSampler(100, 1.4, rng)
    counts = [0] * 100
    for _ in range(4000):
        counts[hot.sample()] += 1
    assert counts[0] > counts[10] > 0
    assert counts[0] > 4000 * 0.15
    uni = ZipfSampler(100, 0.0, rng)
    counts = [0] * 100
    for _ in range(4000):
        counts[uni.sample()] += 1
    assert max(counts) < 4000 * 0.05


def test_profiles_registry_and_samplers():
    assert {"small_mixed", "read_heavy", "write_burst",
            "hot_object"} <= set(PROFILES)
    with pytest.raises(KeyError):
        get_profile("nope")
    rng = random.Random(3)
    prof = get_profile("small_mixed")
    sizes = {prof.size_sampler(rng)() for _ in range(200)}
    assert sizes == {4 * 1024, 16 * 1024}
    mix = [prof.op_class(rng) for _ in range(400)]
    assert 0.3 < mix.count("read") / len(mix) < 0.7
    wb = get_profile("write_burst")
    assert all(wb.op_class(rng) == "write" for _ in range(50))


def test_leg_result_merge_and_roundtrip():
    a = LegResult(offered=10, achieved=8, errors=1, wall_s=2.0)
    a.hist("read").record(100)
    b = LegResult(offered=5, achieved=5, errors=0, wall_s=2.5)
    b.hist("read").record(200)
    b.hist("write").record(50)
    a.merge(json.loads(json.dumps(b.to_dict())))
    assert (a.offered, a.achieved, a.errors) == (15, 13, 1)
    assert a.wall_s == 2.5
    assert a.hist("read").count == 2
    assert a.hist("write").count == 1
    spec = LegSpec.from_dict(LegSpec(
        name="x", profile="small_mixed", duration_s=1.5, mode="open",
        rate=40.0, concurrency=4).to_dict())
    assert spec.mode == "open" and spec.rate == 40.0


def test_monotone_within_envelope():
    from ceph_tpu_torch.load.scenarios import bounded_spread, monotone_within
    assert monotone_within([10, 20, 30], 1.1)
    assert monotone_within([10, 9, 30], 1.5)
    assert not monotone_within([30, 10, 31], 1.5)
    assert monotone_within([], 1.5)
    assert monotone_within([5, None, 7], 1.1)
    assert bounded_spread([100, 150, 300], 8.0)
    assert not bounded_spread([5, 50, 5000], 8.0)
    assert not bounded_spread([5000, 50, 5], 8.0)
    assert bounded_spread([None, 80, 100], 2.0)
    assert bounded_spread([], 8.0)


# ------------------------------------------------------- the worker spawn
class _FakePopen:
    """Records argv and env; prints a ready line and exits at once."""

    spawned: list = []

    def __init__(self, argv, **kw):
        import io
        _FakePopen.spawned.append((argv, kw))
        wid = argv[argv.index("--worker-id") + 1]
        self.stdin = io.StringIO()
        self.stdout = io.StringIO(json.dumps({"ready": True,
                                              "worker": int(wid)}) + "\n")
        self.stderr = io.StringIO("")
        self.returncode = None

    def poll(self):
        return self.returncode

    def kill(self):
        self.returncode = -9

    def wait(self, timeout=None):
        self.returncode = -9 if self.returncode is None else \
            self.returncode
        return self.returncode


def test_generator_spawns_the_ports_worker_with_no_card(monkeypatch):
    _FakePopen.spawned = []
    monkeypatch.setattr(generator.subprocess, "Popen", _FakePopen)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    gen = generator.LoadGenerator(
        "127.0.0.1:1", "pool", 8,
        [LegSpec("steady", "small_mixed", 0.1, concurrency=4)], procs=3)
    gen.spawn()
    gen.abort()
    assert len(_FakePopen.spawned) == 3
    for i, (argv, kw) in enumerate(_FakePopen.spawned):
        assert argv[:3] == [sys.executable, "-m",
                            "ceph_tpu_torch.load.load_worker"]
        assert argv[argv.index("--worker-id") + 1] == str(i)
        assert kw["env"]["CUDA_VISIBLE_DEVICES"] == ""
        assert kw["env"]["PYTHONPATH"].split(":")[0] == generator.REPO
        assert json.loads(argv[argv.index("--spec") + 1])["legs"][0][
            "concurrency"] == 2


def test_worker_refuses_ready_with_a_cuda_context(monkeypatch, capsys):
    """A worker that finds a CUDA context at ready time fails instead
    of reporting ready (it never reaches the go line)."""

    class _Cuda:
        @staticmethod
        def is_initialized():
            return True

    class _Torch:
        cuda = _Cuda

    class _Client:
        def __init__(self, *a, **kw):
            pass

        def connect(self):
            return self

        def close(self):
            pass

    monkeypatch.setitem(sys.modules, "torch", _Torch)
    monkeypatch.setattr("ceph_tpu_torch.client.rados.RadosClient", _Client)
    spec = {"pool": "p", "objects": 2,
            "legs": [LegSpec("steady", "small_mixed", 0.1,
                             concurrency=1).to_dict()]}
    rc = load_worker.main(["--mon-addr", "127.0.0.1:1", "--worker-id",
                           "0", "--spec", json.dumps(spec)])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 1
    assert out == [{"worker": 0, "ok": False,
                    "error": "a CUDA context was created in the load "
                             "worker"}]
    monkeypatch.setitem(sys.modules, "torch", None)
    assert load_worker._cuda_initialized() is False


# ------------------------------------------ tier-1 smoke legs on the port
def test_saturate_smoke_point():
    """tests/test_load_harness.py's smoke leg on the port: 2 worker
    processes, tens of simulated clients, seconds-bounded legs through
    librados over TCP against a 4-OSD cluster, one mclock point, thrash
    included — every structural invariant must hold."""
    base = scenarios.ScenarioConfig(
        procs=2, clients=10, objects=16,
        ramp_rates=(40.0,), ramp_leg_s=1.0, steady_s=2.0,
        thrash_s=4.0, kill_after_s=0.6, recovery_deadline_s=30.0)
    sweep = scenarios.run_sweep(points=[{"id": "smoke",
                                         "osd_mclock_recovery_res": 16.0,
                                         "osd_mclock_recovery_lim": 32.0}],
                                base=base)
    assert sweep["ok"], json.dumps(sweep["points"], indent=1)
    row = sweep["points"][0]
    assert row["invariants"] == {"no_deadlock": True,
                                 "queues_bounded": True,
                                 "recovery_completes": True,
                                 "scrub_completes": True}, row
    steady = row["steady"]
    assert steady["achieved_per_s"] > 0
    assert steady["read"]["ops"] > 0 and steady["write"]["ops"] > 0
    assert steady["read"]["p99_ms"] is not None
    assert row["ramp"]["saturation_knee_per_s"] in (None, 40.0)
    assert row["thrash"]["achieved_per_s"] > 0
    assert row["recovery"]["items"] > 0
    assert row["recovery"]["window_rate_per_s"] > 0
    assert row["msgs_per_op"] > 0


def test_rgw_frontend_saturation_smoke():
    """tests/test_qos.py's S3 front-end smoke on the port: the same
    harness drives the RgwGateway PUT/GET object path."""
    cfg = scenarios.ScenarioConfig(
        point_id="rgw_smoke", frontend="rgw", procs=2, clients=8,
        objects=12, obj_bytes=4096, ramp_rates=(30.0,),
        ramp_leg_s=1.0, steady_s=2.0, thrash=False)
    row = scenarios.run_point(cfg)
    assert row["invariants"]["no_deadlock"], json.dumps(row, indent=1)
    assert row["invariants"]["queues_bounded"]
    steady = row["steady"]
    assert steady["achieved_per_s"] > 0
    assert steady["read"]["ops"] > 0 and steady["write"]["ops"] > 0
    assert steady["read"]["p99_ms"] is not None
