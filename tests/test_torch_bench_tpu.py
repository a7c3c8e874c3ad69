"""The port's bench twin (tools/bench_tpu.py) on the CPU at a small
size: k=8, m=3, 4 KiB stripes, batch 2, one timed rep.  Every candidate
(the plain versions of K1, K2 and G4, and the plain ``xla``) must give
the oracle's digest, the JSON line must carry the reference tool's keys,
and a wrong digest or a missing card must end the run with a nonzero
exit.  Digests are compared exactly."""

import json

import pytest
import torch

from ceph_tpu_torch.tools import bench_tpu

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

#: the keys of the reference tool's JSON line (ceph_tpu/tools/bench_tpu.py)
REF_KEYS = {"backend", "kernel", "workload", "k", "m", "stripe_bytes",
            "batch", "reps", "bytes_per_rep", "digest_verified", "rtt_s",
            "staging_gbps", "staging_spread_gbps", "kernel_gbps",
            "e2e_gbps", "e2e_spread_gbps", "candidates"}
SMALL = ["--device", "cpu", "--stripe-bytes", "4096", "--batch", "2",
         "--reps", "1"]


def _run(capsys, *extra) -> dict:
    rc = bench_tpu.main(SMALL + list(extra))
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("extra,workload", [
    ((), "encode"),
    (("--skip-e2e",), "encode"),
    (("--workload", "decode"), "decode"),
    (("--csum",), "encode+csum"),
    (("--csum", "--workload", "decode", "--skip-e2e"), "decode+csum"),
])
def test_cpu_run_verifies_every_candidate(capsys, extra, workload):
    line = _run(capsys, *extra)
    assert REF_KEYS <= set(line)
    assert line["digest_verified"] is True
    assert line["workload"] == workload
    assert line["backend"] == "cpu" and line["device"] == "cpu"
    assert set(line["candidates"]) == {"pallas", "xla", "mxu", "bitxor"}
    assert line["kernel"] in line["candidates"]
    assert line["k"] == 8 and line["m"] == 3
    assert line["bytes_per_rep"] == 8 * 1024  # 2 x 512-byte chunks a row
    assert line["kernel_gbps"] > 0
    if "--skip-e2e" in extra:
        assert line["e2e_gbps"] is None
    else:
        assert line["e2e_gbps"] > 0
        assert len(line["e2e_spread_gbps"]) == bench_tpu.E2E_SHOTS


def test_pinned_kernel_runs_alone(capsys):
    line = _run(capsys, "--kernel", "mxu", "--skip-e2e")
    assert set(line["candidates"]) == {"mxu"} and line["kernel"] == "mxu"


def test_decode_matrix_is_the_references_block():
    """The e x k block of the inverted survivor rows, e = min(m, k)."""
    from ceph_tpu.ops import gf256 as ref_gf

    W = bench_tpu.working_matrix(8, 3, "reed_sol_van", "decode")
    M = ref_gf.vandermonde_matrix(8, 3)
    avail = [3, 4, 5, 6, 7, 8, 9, 10]
    assert (W == ref_gf.decode_matrix(M, 8, avail)[:3]).all()


def test_no_card_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run")
    assert bench_tpu.main(["--stripe-bytes", "4096", "--batch", "2"]) != 0
    assert "is_available() is False" in capsys.readouterr().err


def test_wrong_digest_fails_the_run(capsys, monkeypatch):
    """A candidate whose parity is off by one bit ends the run nonzero,
    with no JSON line: it is not dropped and the run carried on."""
    real = bench_tpu._candidate

    def candidate(name, *args):
        fn, prep = real(name, *args)
        if name != "mxu":
            return fn, prep

        def wrong(x):
            par, cs = fn(x)
            par = par.clone()
            par[0, 0] ^= 1
            return par, cs

        return wrong, prep

    monkeypatch.setattr(bench_tpu, "_candidate", candidate)
    assert bench_tpu.main(SMALL + ["--skip-e2e"]) == 1
    cap = capsys.readouterr()
    assert "mxu WRONG digest" in cap.err
    assert cap.out.strip() == ""


def test_csum_needs_whole_chunks(capsys):
    with pytest.raises(SystemExit):
        bench_tpu.main(["--device", "cpu", "--stripe-bytes", "24", "--batch",
                        "3", "--csum"])
