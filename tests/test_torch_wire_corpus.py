"""Wire-format non-regression gate (ceph-dencoder + ceph-object-corpus
role, ref src/tools/ceph-dencoder/): archived encoded bytes of every
message/struct must keep decoding — the rolling-restart contract no
in-suite exchange can test, because both ends always run today's code.
The JAX package's tests/test_wire_corpus.py on the port, whose checker
also reports the archived files of structs it cannot decode yet.
"""

import os
import shutil

import ceph_tpu_torch
from ceph_tpu_torch.tools import dencoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(
    ceph_tpu_torch.__file__)))
CORPUS = os.path.join(REPO, "corpus_wire")


def test_corpus_covers_every_wire_type():
    from ceph_tpu_torch.msg.wire import MESSAGE_TYPES
    have = set(os.listdir(CORPUS))
    for cls in MESSAGE_TYPES:
        assert f"msg_{cls.__name__}.bin" in have, \
            f"{cls.__name__} added to the wire registry without " \
            f"archiving its bytes (run dencoder --create)"
    for name in dencoder.struct_samples():
        assert f"struct_{name}.bin" in have


def test_archived_bytes_still_decode():
    problems = dencoder.check(CORPUS).problems
    assert problems == []


def _copy_corpus(tmp_path) -> str:
    dst = str(tmp_path / "corpus_wire")
    shutil.copytree(CORPUS, dst)
    return dst


def test_gate_catches_incompatible_version_bump(tmp_path):
    """A blob whose encoder demanded a NEWER compat than we support
    (the downgrade/rolling-restart hazard) must be reported."""
    base = _copy_corpus(tmp_path)
    path = os.path.join(base, "struct_PoolSpec.bin")
    raw = bytearray(open(path, "rb").read())
    raw[1] = 99  # compat byte: "you need at least v99 to read this"
    open(path, "wb").write(bytes(raw))
    problems = dencoder.check(base).problems
    assert any("PoolSpec" in p and "no longer decode" in p
               for p in problems), problems


def test_gate_catches_field_drift(tmp_path):
    """Archived bytes that DECODE but no longer reproduce the canonical
    fields (a silently re-ordered/re-typed field) must be reported."""
    base = _copy_corpus(tmp_path)
    path = os.path.join(base, "msg_MOSDOp.bin")
    raw = open(path, "rb").read()
    assert b"obj" in raw
    open(path, "wb").write(raw.replace(b"obj", b"obX", 1))
    problems = dencoder.check(base).problems
    assert any("MOSDOp" in p and "differ" in p for p in problems), \
        problems


def test_gate_catches_missing_archive(tmp_path):
    base = _copy_corpus(tmp_path)
    os.remove(os.path.join(base, "msg_MAuth.bin"))
    problems = dencoder.check(base).problems
    assert any("MAuth" in p and "no archived blob" in p
               for p in problems), problems
