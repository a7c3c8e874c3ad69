"""The port stands alone: importing ceph_tpu_torch (every submodule)
loads neither jax nor anything of ceph_tpu, its sources and chip_smoke.py
import neither, and asking for the card where there is none raises."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ceph_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import ceph_tpu_torch
names = ["ceph_tpu_torch"]
for mod in pkgutil.walk_packages(ceph_tpu_torch.__path__, "ceph_tpu_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ceph_tpu" or m.startswith("ceph_tpu."))
print(len(names), ",".join(bad))
"""

_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|ceph_tpu)(?:\.|\s|$)", re.M)


def test_import_loads_no_jax_and_no_reference_package():
    """In a fresh interpreter (this one already imported jax through
    conftest), every ceph_tpu_torch module imports without jax or any
    ceph_tpu module appearing in sys.modules."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1) if " " in \
        out.stdout.strip() else (out.stdout.strip(), "")
    assert int(count) >= 15
    assert bad == ""


#: the modules of the write path, imported one by one in a fresh
#: interpreter by test_write_path_modules_import_alone
WRITE_PATH_MODULES = ("ceph_tpu_torch.ops.native",
                      "ceph_tpu_torch.ops.checksum",
                      "ceph_tpu_torch.utils.staging",
                      "ceph_tpu_torch.ec.arena",
                      "ceph_tpu_torch.ec.verify",
                      "ceph_tpu_torch.ec.batcher")

_PROBE_EACH = r"""
import importlib, sys
for mod in sys.argv[1:]:
    importlib.import_module(mod)
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "ceph_tpu" or m.startswith("ceph_tpu."))
    if bad:
        print(mod, ",".join(bad))
        break
"""


def test_write_path_modules_import_alone():
    """Importing each module of the write path, one after another in a
    fresh interpreter, loads neither jax nor ceph_tpu: the probe names
    the first module after whose import either appears."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE_EACH,
                          *WRITE_PATH_MODULES], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


#: the modules of the wide and local codes, imported one by one in a
#: fresh interpreter by test_wide_code_modules_import_alone
WIDE_CODE_MODULES = ("ceph_tpu_torch.ec.general_code",
                     "ceph_tpu_torch.ec.plugin_lrc",
                     "ceph_tpu_torch.ec.plugin_shec",
                     "ceph_tpu_torch.ec.plugin_clay")


def test_wide_code_modules_import_alone():
    """Importing each module of the wide and local codes, one after
    another in a fresh interpreter, loads neither jax nor ceph_tpu, and
    the three plugins register."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    probe = _PROBE_EACH + (
        "\nfrom ceph_tpu_torch.ec import registered\n"
        "print(*sorted(set(registered()) & {'clay', 'lrc', 'shec'}))\n")
    out = subprocess.run([sys.executable, "-c", probe,
                          *WIDE_CODE_MODULES], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clay lrc shec"


def _sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_sources_import_no_jax_and_no_reference_package():
    found = []
    for path in _sources():
        with open(path) as f:
            text = f.read()
        found += [(path, m.group(0).strip()) for m in _IMPORT.finditer(text)]
        assert "import_module(\"ceph_tpu." not in text
    assert found == []


def test_chip_smoke_needs_a_card():
    """chip_smoke.py exits nonzero and prints no result without a
    card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_cuda_construction_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from ceph_tpu_torch import ec
    from ceph_tpu_torch.ec.matrix_code import resolve_device
    from ceph_tpu_torch.models import StripeCodec
    from ceph_tpu_torch.ops.ec_kernels import RegionMatmul

    with pytest.raises(ec.ErasureCodeError):
        resolve_device("cuda")
    with pytest.raises(ec.ErasureCodeError):
        ec.factory("tpu", {})
    with pytest.raises(RuntimeError):
        RegionMatmul(np.ones((1, 1), np.uint8))
    assert resolve_device("cpu") == torch.device("cpu")
    # a function on tensors follows its tensor's device: CPU here
    fn = StripeCodec(2, 1).encode_graph()
    out = fn(torch.ones((2, 8), dtype=torch.uint8))
    assert out.device.type == "cpu"
