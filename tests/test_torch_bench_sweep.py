"""The port's sweep tool (tools/bench_sweep.py): its BASELINE and
bench_root rows are the reference's, rows of one child share its run,
and its state file is written atomically, with a stub child in place of
a real bench; ``--multichip PATH --device cpu`` writes the reference's
blob from the port's dry run and sharded batcher bench."""

import io
import json
import os
import sys
from contextlib import redirect_stdout

from ceph_tpu.tools import bench_sweep as ref_sweep
from ceph_tpu_torch.tools import bench_sweep


def test_rows_are_the_references_baseline_rows():
    """Ids and arguments as the reference's configs(), its ``jax``
    backend as ``torch``; then its bench_root rows, ids, argv and
    ``extract`` keys as the reference's."""
    want = [{"id": c["id"].replace("_jax", "_torch"), "tool": c["tool"],
             "argv": [a.replace("backend=jax", "backend=torch")
                      for a in c["argv"]]}
            for c in ref_sweep.configs() if c["tool"] != "bench_root"]
    want += [c for c in ref_sweep.configs() if c["tool"] == "bench_root"]
    assert bench_sweep.configs() == want
    assert {c["tool"] for c in want} == set(bench_sweep.TOOLS)


def test_bench_root_rows_are_the_references_sixteen():
    rows = bench_sweep.bench_root_configs()
    assert len(rows) == 16
    assert rows == [c for c in ref_sweep.configs()
                    if c["tool"] == "bench_root"]
    assert bench_sweep.TOOLS["bench_root"] == \
        "ceph_tpu_torch.tools.bench_root"
    cmd = bench_sweep.command(rows[0], "cpu")
    assert cmd == [sys.executable, "-m", "ceph_tpu_torch.tools.bench_root",
                   "--ec-batch", "--device", "cpu"]


def test_rows_of_one_child_share_its_run(monkeypatch):
    """ec_e2e_ratio and ec_kernel_pick both read --ec-batch: one child,
    each row keeps its own extract keys."""
    calls = []

    def stub(cfg, device):
        calls.append(cfg["argv"])
        return [sys.executable, "-c",
                "import json; print(json.dumps({'kernel_gbps': 1.5, "
                "'e2e_gbps': 0.5, 'digest_verified': True, 'x': 1}))"]

    monkeypatch.setattr(bench_sweep, "command", stub)
    rows = {c["id"]: c for c in bench_sweep.bench_root_configs()}
    cache: dict = {}
    a = bench_sweep.run_config(rows["ec_e2e_ratio"], 60, "cpu", cache)
    b = bench_sweep.run_config(rows["ec_kernel_pick"], 60, "cpu", cache)
    assert calls == [["--ec-batch"]]
    assert set(a["result"]) == set(rows["ec_e2e_ratio"]["extract"]) | {
        "wall_s"}
    assert a["result"]["e2e_gbps"] == 0.5
    assert a["result"]["staging_h2d_gbps"] is None
    assert b["result"]["reused_run"] is True
    assert b["result"]["kernel_gbps"] == 1.5


def test_command_passes_the_device():
    cfg = bench_sweep.configs()[0]
    cmd = bench_sweep.command(cfg, "cuda")
    assert cmd[:3] == [sys.executable, "-m",
                       "ceph_tpu_torch.tools.bench_tpu"]
    assert cmd[3:-2] == cfg["argv"] and cmd[-2:] == ["--device", "cuda"]


def test_state_files_lie_in_the_build_directory():
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ceph_tpu_torch", "build")
    for path in bench_sweep.STATE.values():
        assert os.path.dirname(path) == build


def test_state_is_written_atomically_and_resumes(tmp_path, monkeypatch,
                                                 capsys):
    paths = {"cuda": str(tmp_path / "sweep.json"),
             "cpu": str(tmp_path / "sweep_cpu.json")}
    monkeypatch.setattr(bench_sweep, "STATE", paths)
    seen = []

    def stub(cfg, device):
        seen.append((cfg["id"], device))
        if cfg["id"] == "cauchy_k8m4_1M":
            return [sys.executable, "-c", "import sys; sys.exit(3)"]
        return [sys.executable, "-c",
                f"print('noise'); print('{{\"id\": \"{cfg['id']}\"}}')"]

    monkeypatch.setattr(bench_sweep, "command", stub)
    replaced = []
    real_replace = os.replace

    def spy(src, dst):
        assert src == dst + ".tmp"
        json.load(open(src))  # whole before it takes the name
        replaced.append(dst)
        real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    assert bench_sweep.main(["--device", "cpu", "--only",
                             "headline_1M_b64", "--retries", "0"]) == 0
    assert seen == [("headline_1M_b64", "cpu")]
    assert replaced == [paths["cpu"]]
    assert not os.path.exists(paths["cpu"] + ".tmp")
    state = json.load(open(paths["cpu"]))
    assert state["headline_1M_b64"]["result"]["id"] == "headline_1M_b64"
    assert state["headline_1M_b64"]["attempts"] == 1

    # a resumed run skips the measured row, retries a failing one and
    # keeps the rest
    seen.clear()
    assert bench_sweep.main(["--device", "cpu", "--retries", "1"]) == 1
    n = len(bench_sweep.configs())
    # every other child once (rows of one child share it), one retried
    children = {(c["tool"], tuple(c["argv"])) for c in bench_sweep.configs()
                if c["id"] != "headline_1M_b64"}
    assert len(seen) == len(children) + 1
    assert ("headline_1M_b64", "cpu") not in seen
    state = json.load(open(paths["cpu"]))
    assert len(state) == n
    assert state["cauchy_k8m4_1M"]["error"].startswith("rc=3")
    assert state["cauchy_k8m4_1M"]["attempts"] == 2
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["skipped"] == 1 and summary["failed"] == 1
    assert summary["measured_total"] == n - 1
    assert not os.path.exists(paths["cuda"])


def test_multichip_blob(tmp_path):
    """``bench_sweep --multichip PATH --device cpu``: the reference's
    blob keys, ok, the dry run's summary with its three digests (the
    repo's record: MULTICHIP_r05.json), and the sharded batcher's row."""
    path = tmp_path / "multichip.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench_sweep.main(["--multichip", str(path), "--device",
                               "cpu", "--timeout", "300"])
    blob = json.loads(path.read_text())
    assert rc == 0, blob
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == {
        "multichip": str(path), "ok": True}
    assert set(blob) == {"n_devices", "rc", "ok", "skipped", "tail",
                         "ec_batch_sharded"}
    assert (blob["n_devices"], blob["rc"], blob["ok"], blob["skipped"]) \
        == (8, 0, True, False)
    assert blob["tail"].startswith("dryrun_multichip ok")
    for digest in ("digest=1561950", "hdigest=1568446",
                   "digest 1571818"):
        assert digest in blob["tail"]
    row = blob["ec_batch_sharded"]
    assert row["digest_verified"] is True and row["wall_s"] > 0


def test_multichip_relative_path_lies_in_the_build_directory(monkeypatch):
    """A relative ``--multichip`` path (and the bare flag's default) is
    under ceph_tpu_torch/build/, never the repo root's record."""
    seen = []
    monkeypatch.setattr(bench_sweep, "emit_multichip",
                        lambda path, device, **kw: seen.append(
                            (path, device)) or 0)
    assert bench_sweep.main(["--multichip", "--device", "cpu"]) == 0
    assert bench_sweep.main(["--multichip", "x.json"]) == 0
    assert seen == [
        (os.path.join(bench_sweep.BUILD, "MULTICHIP_BATCH.json"), "cpu"),
        (os.path.join(bench_sweep.BUILD, "x.json"), "cuda")]
