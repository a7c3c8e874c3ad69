"""The port's offline EC tool and its independent online EC audit on the
CPU device: the twins of tests/test_runtime_utils.py's ec_tool round
trip, tests/test_scrub_striper.py's consistency-checker CLI and
tests/test_ec_audit.py, on port clusters whose pools run the torch
backend with ``device=cpu`` (the audit's re-encode runs on the port's
codec for the same profile).  The tool's chunk files are held byte for
byte against the JAX package's tool."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ceph_tpu.tools import ec_tool as ref_ec_tool
from ceph_tpu_torch.ops import native
from ceph_tpu_torch.osd.objectstore import CollectionId, ObjectId, Transaction
from ceph_tpu_torch.tools import ec_tool
from ceph_tpu_torch.tools.ec_consistency import run as audit
from ceph_tpu_torch.tools.vstart import MiniCluster
from ceph_tpu_torch.utils.config import default_config

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores and the OSDs' heartbeats keep their cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(99)

#: the audited pool: jerasure k=3 m=2 on the torch backend on the CPU
PROFILE = {"plugin": "jerasure", "k": "3", "m": "2", "backend": "torch",
           "device": "cpu"}


def make_cfg(**over):
    """tests/test_cluster.py's settings (heartbeat 0.05 s, grace 0.5 s,
    2 op shards, 2 dispatch workers)."""
    cfg = default_config()
    cfg.apply_dict({"osd_heartbeat_interval": 0.05,
                    "osd_heartbeat_grace": 0.5, "osd_op_num_shards": 2,
                    "ms_dispatch_workers": 2, **over})
    return cfg


# ------------------------------------------------------------ offline tool
def test_ec_tool_roundtrip(tmp_path):
    """Encode a file into k+m chunk files, lose two, reassemble it byte
    for byte; the chunk files are the JAX package's tool's."""
    data = RNG.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    src = tmp_path / "payload.bin"
    src.write_bytes(data)
    outdir, refdir = tmp_path / "chunks", tmp_path / "ref"
    prof = "plugin=jerasure,technique=reed_sol_van,k=4,m=2"
    run = [sys.executable, "-m", "ceph_tpu_torch.tools.ec_tool"]
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(run + ["encode", prof + ",device=cpu", str(src),
                              str(outdir)], capture_output=True, text=True,
                       timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert sorted(p.name for p in outdir.iterdir()) == \
        [f"chunk.{i}" for i in range(6)] + ["size"]
    assert ref_ec_tool.main(["encode", prof, str(src), str(refdir)]) == 0
    for p in refdir.iterdir():
        assert (outdir / p.name).read_bytes() == p.read_bytes(), p.name
    (outdir / "chunk.1").unlink()
    (outdir / "chunk.4").unlink()
    out = tmp_path / "restored.bin"
    r = subprocess.run(run + ["decode", prof + ",device=cpu", str(outdir),
                              str(out)], capture_output=True, text=True,
                       timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == data
    r = subprocess.run(run + ["info", prof + ",device=cpu"],
                       capture_output=True, text=True, timeout=120,
                       env=env, cwd=REPO)
    assert r.returncode == 0 and "k=4 m=2" in r.stdout


def test_ec_tool_codec_defaults_to_the_card(tmp_path, capsys):
    """Without ``device`` the tool's codec asks for the card (the
    plugins' default), so with no card it fails instead of running on
    the CPU."""
    src = tmp_path / "payload.bin"
    src.write_bytes(b"x" * 4096)
    with pytest.raises(Exception, match="is_available"):
        ec_tool.main(["encode", "plugin=tpu,k=4,m=2", str(src),
                      str(tmp_path / "c")])
    assert ec_tool.main(["info", "plugin=tpu,k=4,m=2,backend=native"]) \
        == 0
    assert "k=4 m=2" in capsys.readouterr().out


# ------------------------------------------------------------ online audit
@pytest.fixture
def ec_cluster():
    c = MiniCluster(n_osds=6, cfg=make_cfg()).start()
    client = c.client()
    client.create_pool("ecp", kind="ec", pg_num=4, ec_profile=PROFILE)
    yield c, client
    c.stop()


def _fill(client, n=8):
    objs = {}
    for i in range(n):
        data = RNG.integers(0, 256, 20_000 + i * 997,
                            dtype=np.uint8).tobytes()
        objs[f"obj{i}"] = data
        client.write_full("ecp", f"obj{i}", data)
    return objs


def _shard_holder(c, client, oid, shard):
    pool_id = client._pool_id("ecp")
    seed = client.osdmap.object_to_pg(pool_id, oid)
    up = client.osdmap.pg_to_up_osds(pool_id, seed)
    return c.osds[up[shard]], CollectionId(pool_id, seed)


def test_list_objects(ec_cluster):
    c, client = ec_cluster
    objs = _fill(client)
    assert client.list_objects("ecp") == sorted(objs)
    client.remove("ecp", "obj0")
    assert "obj0" not in client.list_objects("ecp")


def test_clean_pool_audits_clean(ec_cluster):
    c, client = ec_cluster
    _fill(client)
    assert audit(client, "ecp") == []


def test_catches_self_consistent_parity_corruption(ec_cluster):
    """A parity shard's bytes are wrong but its stored checksums were
    fixed up to match: deep scrub passes, and only the independent
    re-encode sees it."""
    c, client = ec_cluster
    _fill(client)
    oid, parity_shard = "obj3", 3  # k=3: shards 3, 4 are parity
    osd, cid = _shard_holder(c, client, oid, parity_shard)
    sid = ObjectId(oid, shard=parity_shard)
    raw = bytearray(osd.store.read(cid, sid).to_bytes())
    raw[7] ^= 0x5A
    tx = Transaction().write(cid, sid, 0, bytes(raw))
    crc = native.crc32c(bytes(raw))
    tx.setattrs(cid, sid, {"d": crc, "dcsum": crc})
    osd.store.queue_transaction(tx)
    assert client.scrub_pool("ecp", deep=True) == [], \
        "premise broken: deep scrub caught what it should miss"
    issues = audit(client, "ecp")
    assert any(i["kind"] == "parity_mismatch" and i["object"] == oid
               and i["shard"] == parity_shard for i in issues), issues


def test_catches_systematic_encode_bug(ec_cluster):
    """OSDs whose encoder is wrong write self-consistent garbage parity;
    the tool's own codec disagrees."""
    c, client = ec_cluster
    _fill(client, n=2)
    pool_id = client._pool_id("ecp")

    class _BuggyCodec:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            if name == "encode_chunks_with_csums":
                raise AttributeError(name)  # force the plain encode
            return getattr(self._inner, name)

        def encode_chunks(self, data_chunks):
            parity = np.array(self._inner.encode_chunks(data_chunks))
            parity[0, ::257] ^= 0x11
            return parity

    for osd in c.osds.values():
        osd._ec_codecs[pool_id] = _BuggyCodec(osd._pool_codec(pool_id))
    data = RNG.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
    client.write_full("ecp", "poisoned", data)
    issues = audit(client, "ecp", oid="poisoned")
    assert any(i["kind"] == "parity_mismatch" for i in issues), issues


def test_audit_detects_csum_mismatch(ec_cluster):
    c, client = ec_cluster
    _fill(client, n=3)
    oid = "obj1"
    osd, cid = _shard_holder(c, client, oid, 1)
    sid = ObjectId(oid, shard=1)
    raw = bytearray(osd.store.read(cid, sid).to_bytes())
    raw[0] ^= 0xFF  # bytes change, the stored dcsum does not
    osd.store.queue_transaction(
        Transaction().write(cid, sid, 0, bytes(raw)))
    issues = audit(client, "ecp", oid=oid)
    kinds = {i["kind"] for i in issues}
    assert "csum_mismatch" in kinds or "parity_mismatch" in kinds


def test_ec_consistency_checker_cli():
    """The standalone audit over TCP against a live cluster: clean,
    then a corrupted shard caught; exit-code semantics."""
    from ceph_tpu_torch.msg.messages import PgId

    c = MiniCluster(n_osds=5, cfg=make_cfg(), transport="tcp").start()
    try:
        client = c.client()
        client.create_pool("ec", kind="ec", pg_num=1, ec_profile=dict(
            PROFILE))
        client.write_full("ec", "obj", b"audit-me" * 5000)
        assert audit(client, "ec") == []
        mon_addr = c.network.addr_of(c.mon.name)
        env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
        out = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.ec_consistency",
             "--pool", "ec", "--mon-addr", mon_addr, "--json"],
            capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
        assert out.returncode == 0, out.stderr[-500:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["issues"] \
            == []
        pool_id = client._pool_id("ec")
        seed = c.mon.osdmap.object_to_pg(pool_id, "obj")
        up = c.mon.osdmap.pg_to_up_osds(pool_id, seed)
        victim = c.osds[up[1]]
        assert victim.inject.corrupt_object(
            victim.store, PgId(pool_id, seed), "obj", shard=1)
        assert audit(client, "ec"), "corruption went undetected"
        out = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.ec_consistency",
             "--pool", "ec", "--mon-addr", mon_addr],
            capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
        assert out.returncode == 1, out.stderr[-500:]
        assert "INCONSISTENT" in out.stdout
    finally:
        c.stop()
