"""The port's ec_benchmark CLI with --device cpu at a small size: the
reference-compatible output formats and the exhaustive decode's byte
verification (tolerance 0)."""

import json
import re

import numpy as np
import pytest
import torch

from ceph_tpu.tools import ec_benchmark as ref_bench
from ceph_tpu_torch.ec.plugin_tpu import TpuCode
from ceph_tpu_torch.tools import ec_benchmark

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

SMALL = ["--size", str(64 * 1024), "--device", "cpu"]


def test_flags_are_the_reference_flags_plus_device():
    """Every flag of the JAX package's CLI parses the same way here."""
    argv = ["--workload", "decode", "--size", "4096", "--iterations", "3",
            "--erasures", "2", "--erasures-generation", "exhaustive",
            "--erased", "1", "--erased", "3", "-P", "k=4", "-P", "m=2",
            "--verbose", "--json"]
    a, b = ec_benchmark.parse_args(argv), ref_bench.parse_args(argv)
    for key, val in vars(b).items():
        if key != "plugin":
            assert getattr(a, key) == val, key
    assert a.device == "cuda" and a.plugin == "tpu"
    assert ec_benchmark.make_profile(a) == {"k": "4", "m": "2",
                                            "device": "cuda"}


@pytest.mark.parametrize("workload", [["--workload", "encode"],
                                      ["--workload", "decode",
                                       "--erasures", "3"]])
def test_seconds_tab_kib_output(workload, capsys):
    assert ec_benchmark.main(SMALL + ["--iterations", "2"] + workload) == 0
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r"\d+\.\d{6}\t128", line), line


def test_json_output(capsys):
    assert ec_benchmark.main(SMALL + ["--json", "-P", "k=4",
                                      "-P", "m=2"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["plugin"] == "tpu" and doc["workload"] == "encode"
    assert doc["profile"] == {"k": "4", "m": "2", "device": "cpu"}
    assert doc["KiB"] == 64 and doc["seconds"] > 0 and doc["GBps"] > 0


def test_exhaustive_decode_verifies_every_pattern(capsys):
    argv = SMALL + ["--workload", "decode", "--erasures", "2",
                    "--erasures-generation", "exhaustive", "-P", "k=4",
                    "-P", "m=2"]
    assert ec_benchmark.main(argv) == 0
    assert re.fullmatch(r"\d+\.\d{6}\t64", capsys.readouterr().out.strip())


def test_exhaustive_decode_catches_a_wrong_byte(monkeypatch):
    real = TpuCode.decode_chunks

    def corrupt(self, want, chunks):
        out = real(self, want, chunks)
        i = next(iter(out))
        out[i] = np.array(out[i], copy=True)
        out[i][0] ^= 1
        return out

    monkeypatch.setattr(TpuCode, "decode_chunks", corrupt)
    with pytest.raises(SystemExit, match="decode mismatch"):
        ec_benchmark.main(SMALL + ["--workload", "decode", "--erasures", "1",
                                   "--erasures-generation", "exhaustive"])
