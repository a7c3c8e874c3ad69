"""The port's object stores, KV tiers and PG log against the JAX
package's.

Two halves:

- crossings: a store, a KV table or a PG log written and closed by one
  package is opened by the other at the same path and reads back the
  same collections, objects, bytes, attrs and omap; a ``LogEntry``
  encodes to the same bytes in both packages, and the archived
  ``corpus_wire/struct_LogEntry.bin`` decodes and re-encodes on the
  port;
- the JAX package's own unit cases of ``tests/test_pglog.py``,
  ``test_sstkv.py``, ``test_filestore.py`` and ``test_bluestore.py`` on
  the port (their ``MiniCluster`` cases stay with the JAX package: they
  cross no device seam), each named after its file.
"""

import os
import random
import struct

import numpy as np
import pytest

import ceph_tpu.osd.kvstore as ref_kvstore
import ceph_tpu.osd.objectstore as ref_os
import ceph_tpu.osd.pglog as ref_pglog
import ceph_tpu.osd.sstkv as ref_sstkv
import ceph_tpu_torch.osd.kvstore as port_kvstore
import ceph_tpu_torch.osd.objectstore as port_os
import ceph_tpu_torch.osd.pglog as port_pglog
import ceph_tpu_torch.osd.sstkv as port_sstkv
from ceph_tpu_torch.ops import native
from ceph_tpu_torch.osd.bluestore import HOLE, PAGE, BlueStore
from ceph_tpu_torch.osd.filestore import (FileStore, decode_transaction,
                                          encode_transaction)
from ceph_tpu_torch.osd.kvstore import KVTransaction, MemKV, create_kv
from ceph_tpu_torch.osd.objectstore import (CollectionId, MemStore,
                                            NoSuchObject, ObjectId,
                                            ObjectStore, StoreError,
                                            Transaction)
from ceph_tpu_torch.osd.pglog import PGLOG_OID, LogEntry, PGLog
from ceph_tpu_torch.osd.sstkv import SstKV

CORPUS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "corpus_wire")
PACKAGES = {"ref": (ref_os, ref_pglog, ref_sstkv, ref_kvstore),
            "port": (port_os, port_pglog, port_sstkv, port_kvstore)}
#: (writer, reader) package pairs: each direction once
DIRECTIONS = (("ref", "port"), ("port", "ref"))
#: store kind -> ObjectStore.create keyword arguments
STORE_KINDS = {"filestore": {}, "bluestore": {},
               "bluestore-sst": {"kv_backend": "sst"}}
CID = CollectionId(1, 0)
OID = ObjectId("obj", shard=2)


# ------------------------------------------------------------ crossings
def _make_store(mod, kind: str, path: str):
    kw = dict(STORE_KINDS[kind], path=path)
    return mod.ObjectStore.create(kind.split("-")[0], **kw)


def _seeded_workload(mod, seed: int):
    """Transactions of ``mod``'s types: data (whole, partial, zeroed,
    truncated, a page-aligned compressible run), xattrs of each value
    type, omap set and removed, a snapshot clone of a head that is then
    overwritten, a removed object and a second collection."""
    rng = np.random.default_rng(seed)
    C, O, Tx = mod.CollectionId, mod.ObjectId, mod.Transaction
    cid, cid2 = C(1, 0), C(2, 5)
    head, clone = O("rbd_data.1", shard=2), O("rbd_data.1", shard=2,
                                              generation=5)
    data = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
    txs = [
        Tx().create_collection(cid).create_collection(cid2),
        Tx().touch(cid, head).write(cid, head, 0, data)
        .setattrs(cid, head, {"v": 3, "len": len(data), "name": "x",
                              "raw": b"\x00\x01\xff"})
        .omap_setkeys(cid, head, {"k1": b"v1", "k2": rng.bytes(300),
                                  "k3": b""}),
        Tx().clone(cid, head, clone)
        .setattrs(cid, clone, {"_snap": 5}),
        Tx().write(cid, head, 1000, rng.bytes(5000))
        .zero(cid, head, 20_000, 3000).omap_rmkeys(cid, head, ["k1"])
        .rmattr(cid, head, "name"),
        Tx().touch(cid, O("short")).write(cid, O("short"), 0,
                                          rng.bytes(9000))
        .truncate(cid, O("short"), 4097),
        Tx().touch(cid2, O("zeros", shard=0))
        .write(cid2, O("zeros", shard=0), 0,
               bytes(64 << 10) + b"tail" * 4096)
        .omap_setkeys(cid2, O("zeros", shard=0), {"a": b"b"}),
        Tx().touch(cid, O("gone")).write(cid, O("gone"), 0, b"bye"),
        Tx().remove(cid, O("gone")),
    ]
    return txs


def _dump(store) -> dict:
    """Everything a reader sees, in types both packages share."""
    out = {}
    for cid in sorted(store.list_collections()):
        for oid in sorted(store.list_objects(cid)):
            key = (cid.pool, cid.pg_seed, oid.name, oid.shard,
                   oid.generation)
            out[key] = (store.read(cid, oid).to_bytes(),
                        dict(store.getattrs(cid, oid)),
                        dict(store.omap_get(cid, oid)))
    return out


@pytest.mark.parametrize("kind", sorted(STORE_KINDS))
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_store_opens_across_packages(tmp_path, kind, writer, reader):
    path = str(tmp_path / kind)
    w = _make_store(PACKAGES[writer][0], kind, path)
    w.mount()
    for tx in _seeded_workload(PACKAGES[writer][0], seed=17):
        w.queue_transaction(tx)
    want = _dump(w)
    w.umount()
    assert len(want) == 4 and all(k[2] != "gone" for k in want)
    r = _make_store(PACKAGES[reader][0], kind, path)
    r.mount()
    try:
        assert _dump(r) == want
        # the reader keeps writing on the writer's store
        mod = PACKAGES[reader][0]
        cid, oid = mod.CollectionId(1, 0), mod.ObjectId("after")
        r.queue_transaction(mod.Transaction().touch(cid, oid)
                            .write(cid, oid, 0, b"reader bytes"))
        assert r.read(cid, oid).to_bytes() == b"reader bytes"
    finally:
        r.umount()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_sstkv_tables_open_across_packages(tmp_path, writer, reader):
    """Flushed and compacted tables, the memtable's WAL, tombstones and
    a removed prefix, written by one package and read by the other."""
    path = str(tmp_path / "kv")
    rnd = random.Random(5)
    w = PACKAGES[writer][2].SstKV(path, memtable_bytes=2048)
    for i in range(600):
        w.put("p", f"k{rnd.randrange(300):04d}",
              rnd.randbytes(rnd.randrange(1, 60)))
        if i % 7 == 0:
            w.rm("p", f"k{rnd.randrange(300):04d}")
    for i in range(40):
        w.put("q", f"x{i:02d}", b"gone")
    w.submit(PACKAGES[writer][3].KVTransaction().rm_prefix("q"))
    w.put("r", "last", b"in the memtable")
    want = {p: list(w.iterate(p)) for p in ("p", "q", "r")}
    assert w.stats()["files"] > 0
    w.close()
    r = PACKAGES[reader][2].SstKV(path, memtable_bytes=2048)
    try:
        assert {p: list(r.iterate(p)) for p in ("p", "q", "r")} == want
        assert want["q"] == [] and want["r"] == [("last",
                                                  b"in the memtable")]
    finally:
        r.close()


def _log_entries(mod) -> list:
    E = mod.LogEntry
    return [E(1, "write", "obj", 0, 0),
            E(2, "rows", "obj", 2, prev_version=1,
              rollback=[(4096, b"old-bytes"), (0, b"x")], old_len=999),
            E(7, "write", "obj", 2, 6, rollback=[(0, b"old")],
              old_len=100, old_shard_len=25, epoch=4),
            E(9, "delete", "rbd_data.7", 1, 8, epoch=12)]


def test_log_entries_encode_to_the_same_bytes():
    ref, port = _log_entries(ref_pglog), _log_entries(port_pglog)
    for r, p in zip(ref, port):
        raw = r.encode_bytes()
        assert p.encode_bytes() == raw
        assert port_pglog.LogEntry.decode_bytes(raw) == p
        assert ref_pglog.LogEntry.decode_bytes(p.encode_bytes()) == r


def test_archived_log_entry_decodes_and_reencodes_on_the_port():
    raw = open(os.path.join(CORPUS, "struct_LogEntry.bin"), "rb").read()
    got = port_pglog.LogEntry.decode_bytes(raw)
    assert got.encode_bytes() == raw
    assert got == port_pglog.LogEntry(7, "write", "obj", 2, 6,
                                      rollback=[(0, b"old")], old_len=100,
                                      old_shard_len=25, epoch=4)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_pglog_persists_across_packages(tmp_path, writer, reader):
    """A PG log appended and trimmed in one package's FileStore is the
    same log, entry for entry, in the other's."""
    path = str(tmp_path / "fs")
    wos, wlog = PACKAGES[writer][:2]
    s = wos.ObjectStore.create("filestore", path=path)
    s.mount()
    cid = wos.CollectionId(1, 0)
    s.queue_transaction(wos.Transaction().create_collection(cid))
    pl = wlog.PGLog(s, cid)
    for v in range(1, 300):
        tx = wos.Transaction()
        pl.append_to(tx, wlog.LogEntry(v, "rows", f"o{v % 7}", v % 3,
                                       v - 1, rollback=[(v, b"pre")],
                                       old_len=v * 10))
        pl.trim_to(tx)
        s.queue_transaction(tx)
    want = [e.encode_bytes() for e in pl.entries()]
    floor, last = pl.floor(), pl.last_version()
    s.umount()
    ros, rlog = PACKAGES[reader][:2]
    s2 = ros.ObjectStore.create("filestore", path=path)
    s2.mount()
    try:
        pl2 = rlog.PGLog(s2, ros.CollectionId(1, 0))
        assert [e.encode_bytes() for e in pl2.entries()] == want
        assert (pl2.floor(), pl2.last_version()) == (floor, last)
        assert ros.ObjectId(PGLOG_OID.name, shard=PGLOG_OID.shard) in \
            s2.list_objects(ros.CollectionId(1, 0))
    finally:
        s2.umount()


# -------------------------------------------------- tests/test_pglog.py on the port
def test_log_entry_roundtrip():
    e = LogEntry(7, "rows", "obj", 2, prev_version=6,
                 rollback=[(4096, b"old-bytes"), (0, b"x")], old_len=999)
    got = LogEntry.decode_bytes(e.encode_bytes())
    assert got == e


def _mkstore():
    s = MemStore()
    s.mount()
    cid = CollectionId(1, 0)
    s.queue_transaction(Transaction().create_collection(cid))
    return s, cid


def test_pglog_append_trim_and_bounds():
    s, cid = _mkstore()
    pl = PGLog(s, cid)
    for v in range(1, 400):
        tx = Transaction()
        pl.append_to(tx, LogEntry(v, "rows", f"o{v % 7}", 0, v - 1))
        pl.trim_to(tx)
        s.queue_transaction(tx)
    assert pl.last_version() == 399
    assert pl.floor() > 1  # trimmed
    ents = pl.entries()
    assert len(ents) <= 2 * PGLog.KEEP
    assert [e.version for e in ents] == sorted(e.version for e in ents)
    assert pl.entries_after(397) == ents[-2:]


def test_pglog_rollback_applies_preimages():
    s, cid = _mkstore()
    obj = ObjectId("o", shard=1)
    tx = Transaction()
    tx.touch(cid, obj)
    tx.write(cid, obj, 0, b"AAAABBBBCCCC")
    tx.setattrs(cid, obj, {"v": 1, "len": 12})
    s.queue_transaction(tx)
    pl = PGLog(s, cid)
    # two partial writes with stashed pre-images
    for v, off, new, old in ((2, 4, b"XXXX", b"BBBB"),
                             (3, 0, b"YY", b"AA")):
        tx = Transaction()
        tx.write(cid, obj, off, new)
        pl.append_to(tx, LogEntry(v, "rows", "o", 1, v - 1,
                                  rollback=[(off, old)], old_len=12))
        s.queue_transaction(tx)
        s.queue_transaction(Transaction().setattrs(cid, obj, {"v": v}))
    assert s.read(cid, obj).to_bytes() == b"YYAAXXXXCCCC"
    assert pl.rollback_object("o", 1, to_version=1)
    assert s.read(cid, obj).to_bytes() == b"AAAABBBBCCCC"
    assert int(s.getattrs(cid, obj)["v"]) == 1


def test_pglog_rollback_refuses_without_preimage():
    s, cid = _mkstore()
    obj = ObjectId("o", shard=0)
    s.queue_transaction(Transaction().touch(cid, obj))
    pl = PGLog(s, cid)
    tx = Transaction()
    pl.append_to(tx, LogEntry(5, "write", "o", 0, 4))  # no stash
    s.queue_transaction(tx)
    assert pl.rollback_object("o", 0, to_version=4) is False


# -------------------------------------------------- tests/test_sstkv.py on the port
@pytest.fixture
def kv(tmp_path):
    db = SstKV(str(tmp_path / "kv"), memtable_bytes=2048)
    yield db
    db.close()


def test_sstkv_basic_put_get_rm(kv):
    kv.put("p", "a", b"1")
    kv.put("p", "b", b"2")
    kv.put("q", "a", b"other")
    assert kv.get("p", "a") == b"1"
    assert kv.get("p", "b") == b"2"
    assert kv.get("q", "a") == b"other"
    assert kv.get("p", "zz") is None
    kv.rm("p", "a")
    assert kv.get("p", "a") is None
    assert kv.get("q", "a") == b"other"


def test_sstkv_flush_compaction_and_reads_across_levels(kv):
    # small memtable (2 KiB) forces many flushes and L0 compactions
    for i in range(400):
        kv.put("p", f"k{i:04d}", f"v{i}".encode() * 7)
    assert kv.stats()["files"] > 0
    for i in range(0, 400, 17):
        assert kv.get("p", f"k{i:04d}") == f"v{i}".encode() * 7
    # overwrites win over older levels
    kv.put("p", "k0005", b"NEW")
    assert kv.get("p", "k0005") == b"NEW"
    # tombstones shadow flushed values
    kv.rm("p", "k0100")
    assert kv.get("p", "k0100") is None
    keys = [k for k, _ in kv.iterate("p")]
    assert "k0100" not in keys and "k0005" in keys
    assert keys == sorted(keys)


def test_sstkv_iterate_with_start_and_prefix_isolation(kv):
    for i in range(50):
        kv.put("a", f"x{i:02d}", b"v")
        kv.put("b", f"x{i:02d}", b"w")
    out = list(kv.iterate("a", start="x40"))
    assert [k for k, _ in out] == [f"x{i}" for i in range(40, 50)]
    assert all(v == b"v" for _k, v in out)


def test_sstkv_reopen_preserves_state(tmp_path):
    path = str(tmp_path / "kv")
    db = SstKV(path, memtable_bytes=1024)
    for i in range(100):
        db.put("p", f"k{i:03d}", f"v{i}".encode())
    db.rm("p", "k050")
    db.close()
    db2 = SstKV(path, memtable_bytes=1024)
    assert db2.get("p", "k007") == b"v7"
    assert db2.get("p", "k050") is None
    assert len(list(db2.iterate("p"))) == 99
    db2.close()


def test_sstkv_crash_replay_memtable_wal(tmp_path):
    """Keys in the memtable (not yet flushed) survive a crash via the
    WAL; a torn tail is discarded."""
    path = str(tmp_path / "kv")
    db = SstKV(path, memtable_bytes=1 << 20)  # nothing flushes
    db.put("p", "durable", b"yes")
    # crash: no close(); reopen replays the WAL
    db2 = SstKV(path, memtable_bytes=1 << 20)
    assert db2.get("p", "durable") == b"yes"
    db2.close()
    # torn tail: append garbage to the WAL
    with open(os.path.join(path, "memtable.wal"), "ab") as f:
        f.write(b"\x99" * 11)
    db3 = SstKV(path, memtable_bytes=1 << 20)
    assert db3.get("p", "durable") == b"yes"
    db3.close()


def test_sstkv_rm_prefix(kv):
    for i in range(30):
        kv.put("gone", f"k{i}", b"x")
        kv.put("keep", f"k{i}", b"y")
    kv.submit(KVTransaction().rm_prefix("gone"))
    assert list(kv.iterate("gone")) == []
    assert len(list(kv.iterate("keep"))) == 30


def test_sstkv_fuzz_against_model(tmp_path):
    """Random op stream: SstKV must match MemKV exactly, across a
    mid-stream reopen."""
    rng = random.Random(7)
    path = str(tmp_path / "kv")
    db = SstKV(path, memtable_bytes=512)
    model = MemKV()
    keys = [f"k{i:02d}" for i in range(40)]
    for step in range(1500):
        op = rng.random()
        prefix = rng.choice(["p1", "p2"])
        key = rng.choice(keys)
        if op < 0.55:
            val = os.urandom(rng.randrange(1, 40))
            db.put(prefix, key, val)
            model.put(prefix, key, val)
        elif op < 0.8:
            db.rm(prefix, key)
            model.rm(prefix, key)
        else:
            assert db.get(prefix, key) == model.get(prefix, key)
        if step == 900:
            db.close()
            db = SstKV(path, memtable_bytes=512)
    for prefix in ("p1", "p2"):
        assert list(db.iterate(prefix)) == list(model.iterate(prefix))
    db.close()


def test_sstkv_factory(tmp_path):
    db = create_kv("sst", str(tmp_path / "f"))
    db.put("p", "k", b"v")
    assert db.get("p", "k") == b"v"
    db.close()


def test_sstkv_bluestore_over_sst(tmp_path):
    """BlueStore-lite metadata on the LSM tier: write/read/omap survive
    a remount (the BlueStore-on-RocksDB pairing)."""
    from ceph_tpu_torch.osd.bluestore import BlueStore
    from ceph_tpu_torch.osd.objectstore import CollectionId, ObjectId, Transaction
    st = BlueStore(str(tmp_path / "bs"), kv_backend="sst")
    st.mount()
    cid = CollectionId(1, 0)
    st.queue_transaction(Transaction().create_collection(cid))
    obj = ObjectId("o")
    tx = Transaction().touch(cid, obj).write(cid, obj, 0, b"lsm-bytes")
    tx.omap_setkeys(cid, obj, {"k": b"v"})
    st.queue_transaction(tx)
    st.umount()
    st2 = BlueStore(str(tmp_path / "bs"), kv_backend="sst")
    st2.mount()
    assert st2.read(cid, obj).to_bytes() == b"lsm-bytes"
    assert st2.omap_get(cid, obj) == {"k": b"v"}
    errors = st2.fsck()
    assert not errors.get("errors"), errors
    st2.umount()


def test_sstkv_rm_prefix_in_tx_order(tmp_path):
    """Ops apply in order within a transaction: a put BEFORE rm_prefix
    dies with the prefix, a put AFTER survives (MemKV parity)."""
    db = SstKV(str(tmp_path / "kv"))
    tx = (KVTransaction().put("p", "early", b"1").rm_prefix("p")
          .put("p", "late", b"2"))
    db.submit(tx)
    assert db.get("p", "early") is None
    assert db.get("p", "late") == b"2"
    model = MemKV()
    model.submit(tx)
    assert list(db.iterate("p")) == list(model.iterate("p"))
    db.close()


# -------------------------------------------------- tests/test_filestore.py on the port
FILESTORE_RNG = np.random.default_rng(31)


def test_filestore_transaction_codec_roundtrip():
    tx = (Transaction().create_collection(CID).touch(CID, OID)
          .write(CID, OID, 64, b"payload").zero(CID, OID, 0, 16)
          .truncate(CID, OID, 100)
          .setattrs(CID, OID, {"v": 7, "name": "x", "raw": b"\x00\x01"})
          .omap_setkeys(CID, OID, {"k": b"v"})
          .omap_rmkeys(CID, OID, ["k"])
          .rmattr(CID, OID, "name")
          .clone(CID, OID, ObjectId("copy")))
    tx2 = decode_transaction(encode_transaction(tx))
    assert len(tx2.ops) == len(tx.ops)
    for a, b in zip(tx.ops, tx2.ops):
        assert a[0] == b[0] and a[1] == b[1]
    # WRITE payload survives
    assert tx2.ops[2][4].to_bytes() == b"payload"
    assert tx2.ops[5][3] == {"v": 7, "name": "x", "raw": b"\x00\x01"}


def test_filestore_basic_and_remount(tmp_path):
    path = str(tmp_path / "store")
    s = ObjectStore.create("filestore", path=path)
    s.mount()
    data = FILESTORE_RNG.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    s.queue_transaction(
        Transaction().create_collection(CID).touch(CID, OID)
        .write(CID, OID, 0, data).setattrs(CID, OID, {"v": 3, "len": 10_000}))
    assert s.read(CID, OID).to_bytes() == data
    s.umount()
    # fresh process simulation: new instance, same path
    s2 = FileStore(path)
    s2.mount()
    assert s2.read(CID, OID).to_bytes() == data
    assert s2.getattrs(CID, OID)["v"] == 3
    assert s2.list_objects(CID) == [OID]


def test_filestore_wal_replay_after_crash_before_apply(tmp_path):
    """Simulate a crash after the WAL commit point but before the files
    were written: remount must replay the record."""
    path = str(tmp_path / "store")
    s = FileStore(path)
    s.mount()
    s.queue_transaction(Transaction().create_collection(CID))
    # craft a committed-but-unapplied record by appending to the WAL only
    tx = Transaction().touch(CID, OID).write(CID, OID, 0, b"recovered")
    payload = encode_transaction(tx)
    with open(s._wal_path, "ab") as f:
        f.write(struct.pack("<II", len(payload), native.crc32c(payload))
                + payload)
    s.umount()
    s2 = FileStore(path)
    s2.mount()
    assert s2.read(CID, OID).to_bytes() == b"recovered"
    # and the replay was made durable in the files too
    s2.umount()
    s3 = FileStore(path)
    s3.mount()
    assert s3.read(CID, OID).to_bytes() == b"recovered"


def test_filestore_wal_torn_tail_discarded(tmp_path):
    path = str(tmp_path / "store")
    s = FileStore(path)
    s.mount()
    s.queue_transaction(Transaction().create_collection(CID)
                        .touch(CID, OID).write(CID, OID, 0, b"good"))
    # torn partial record at the tail
    with open(s._wal_path, "ab") as f:
        f.write(struct.pack("<II", 9999, 0) + b"partial")
    s.umount()
    s2 = FileStore(path)
    s2.mount()
    assert s2.read(CID, OID).to_bytes() == b"good"
    # tail was truncated; further writes work
    s2.queue_transaction(Transaction().write(CID, OID, 0, b"more"))
    assert s2.read(CID, OID).to_bytes() == b"more"


def test_filestore_checksum_detects_bitrot(tmp_path):
    path = str(tmp_path / "store")
    s = FileStore(path)
    s.mount()
    data = b"A" * 9000
    s.queue_transaction(Transaction().create_collection(CID)
                        .touch(CID, OID).write(CID, OID, 0, data))
    s.umount()
    # checkpoint: an intact WAL would legitimately repair the file on
    # replay, so clear it to model corruption after journal trim
    open(s._wal_path, "wb").close()
    # flip a bit in the object file (silent corruption)
    base = s._obj_base(CID, OID)
    with open(base + ".data", "r+b") as f:
        f.seek(5000)
        b = f.read(1)
        f.seek(5000)
        f.write(bytes([b[0] ^ 0x40]))
    s2 = FileStore(path)
    s2.mount()
    with pytest.raises(StoreError, match="checksum"):
        s2.read(CID, OID)


def test_filestore_clone_not_replayed_after_clean_remount(tmp_path):
    """Non-idempotent ops (clone) must not re-execute on remount: the
    applied checkpoint gates WAL replay."""
    path = str(tmp_path / "store")
    a, b = ObjectId("a"), ObjectId("b")
    s = FileStore(path)
    s.mount()
    s.queue_transaction(Transaction().create_collection(CID)
                        .touch(CID, a).write(CID, a, 0, b"XX"))
    s.queue_transaction(Transaction().clone(CID, a, b))
    s.queue_transaction(Transaction().write(CID, a, 2, b"YY"))
    s.umount()
    s2 = FileStore(path)
    s2.mount()
    assert s2.read(CID, a).to_bytes() == b"XXYY"
    assert s2.read(CID, b).to_bytes() == b"XX"  # clone must NOT re-run


def test_filestore_rejected_tx_never_journaled(tmp_path):
    """A transaction that fails validation must not reach the WAL (a
    durable invalid record would replay once state allows)."""
    path = str(tmp_path / "store")
    other = CollectionId(9, 9)
    s = FileStore(path)
    s.mount()
    with pytest.raises(Exception):
        s.queue_transaction(Transaction().touch(other, OID))
    s.queue_transaction(Transaction().create_collection(other))
    s.umount()
    s2 = FileStore(path)
    s2.mount()
    assert not s2.exists(other, OID)  # the rejected touch never happened


# -------------------------------------------------- tests/test_bluestore.py on the port
BLUESTORE_RNG = np.random.default_rng(77)


def fresh(tmp_path, name="bs", **kw) -> BlueStore:
    s = BlueStore(str(tmp_path / name), **kw)
    s.mount()
    return s


def test_bluestore_basic_write_read_remount(tmp_path):
    s = fresh(tmp_path)
    data = BLUESTORE_RNG.integers(0, 256, 3 * PAGE + 123, dtype=np.uint8).tobytes()
    s.queue_transaction(
        Transaction().create_collection(CID).touch(CID, OID)
        .write(CID, OID, 0, data).setattrs(CID, OID, {"v": 3})
        .omap_setkeys(CID, OID, {"k1": b"v1", "k2": b"v2"}))
    assert s.read(CID, OID).to_bytes() == data
    assert s.read(CID, OID, PAGE - 10, 20).to_bytes() == data[PAGE - 10:PAGE + 10]
    s.umount()
    s2 = BlueStore(s.path)
    s2.mount()
    assert s2.read(CID, OID).to_bytes() == data
    assert s2.getattrs(CID, OID)["v"] == 3
    assert s2.omap_get(CID, OID) == {"k1": b"v1", "k2": b"v2"}
    assert s2.list_objects(CID) == [OID]
    assert s2.stat(CID, OID)["size"] == len(data)
    s2.umount()


def test_bluestore_small_overwrite_is_deferred_and_replayed(tmp_path):
    """A committed deferred write whose device write never happened must
    replay from the KV 'D' records at mount."""
    s = fresh(tmp_path, defer_limit=PAGE)  # base write takes the large path
    base = b"A" * (2 * PAGE)
    s.queue_transaction(Transaction().create_collection(CID)
                        .write(CID, OID, 0, base))
    assert not s._deferred
    s.queue_transaction(Transaction().write(CID, OID, 100, b"deferred!"))
    assert s._deferred, "small overwrite should sit in the deferred set"
    # simulate the crash: clobber the device page the deferred write
    # targeted (as if the write never reached the platter), keep the KV
    [(phys, content)] = list(s._deferred.items())
    s._dev_write(phys, b"\0" * PAGE)
    s._dev.flush()
    os.fsync(s._dev.fileno())
    s._dev.close()  # bypass umount: umount would flush properly
    s._kv.close()
    s._mounted = False
    s2 = BlueStore(s.path)
    s2.mount()
    want = bytearray(base)
    want[100:109] = b"deferred!"
    assert s2.read(CID, OID).to_bytes() == bytes(want)
    s2.umount()


def test_bluestore_large_write_allocates_fresh_pages(tmp_path):
    """Large writes are COW: the page map must point at different pages
    after a full overwrite, and the old pages return to the allocator."""
    s = fresh(tmp_path, defer_limit=PAGE - 1)
    data1 = b"x" * (4 * PAGE)
    data2 = b"y" * (4 * PAGE)
    s.queue_transaction(Transaction().create_collection(CID)
                        .write(CID, OID, 0, data1))
    pages1 = [p for p, _ in s._colls[CID][OID].pages]
    s.queue_transaction(Transaction().write(CID, OID, 0, data2))
    pages2 = [p for p, _ in s._colls[CID][OID].pages]
    assert set(pages1).isdisjoint(set(pages2))
    assert s.read(CID, OID).to_bytes() == data2
    # old pages are reusable
    free = set(s._free)
    assert set(pages1) <= free
    s.umount()


def test_bluestore_clone_shares_pages_and_cows(tmp_path):
    s = fresh(tmp_path)
    a, b = ObjectId("a"), ObjectId("b")
    data = BLUESTORE_RNG.integers(0, 256, 2 * PAGE, dtype=np.uint8).tobytes()
    s.queue_transaction(Transaction().create_collection(CID)
                        .write(CID, a, 0, data)
                        .omap_setkeys(CID, a, {"k": b"v"}))
    s.queue_transaction(Transaction().clone(CID, a, b))
    pa = [p for p, _ in s._colls[CID][a].pages]
    pb = [p for p, _ in s._colls[CID][b].pages]
    assert pa == pb, "clone must share pages"
    assert all(s._refs[p] == 2 for p in pa)
    # write to the clone: COW, original untouched
    s.queue_transaction(Transaction().write(CID, b, 0, b"Z" * 10))
    assert s.read(CID, a).to_bytes() == data
    got = s.read(CID, b).to_bytes()
    assert got[:10] == b"Z" * 10 and got[10:] == data[10:]
    assert s.omap_get(CID, b) == {"k": b"v"}
    # remove the original: shared pages must survive for the clone
    s.queue_transaction(Transaction().remove(CID, a))
    assert s.read(CID, b).to_bytes() == got
    s.umount()
    s2 = BlueStore(s.path)
    s2.mount()
    assert s2.read(CID, b).to_bytes() == got
    with pytest.raises(NoSuchObject):
        s2.read(CID, a)
    s2.umount()


def test_bluestore_checksum_detects_bitrot(tmp_path):
    s = fresh(tmp_path)
    data = b"Q" * (3 * PAGE)
    s.queue_transaction(Transaction().create_collection(CID)
                        .write(CID, OID, 0, data))
    s.umount()
    s2 = BlueStore(s.path)
    s2.mount()
    phys = s2._colls[CID][OID].pages[1][0]
    with open(os.path.join(s2.path, "block.img"), "r+b") as f:
        f.seek(phys * PAGE + 17)
        f.write(b"\xff")
    assert not s2.deep_verify(CID, OID)
    with pytest.raises(StoreError, match="checksum"):
        s2.read(CID, OID)
    # unaffected pages still read fine
    assert s2.read(CID, OID, 0, PAGE).to_bytes() == data[:PAGE]
    s2.umount()


def test_bluestore_zero_truncate_semantics(tmp_path):
    s = fresh(tmp_path)
    s.queue_transaction(Transaction().create_collection(CID)
                        .write(CID, OID, 0, b"ab" * PAGE))
    # full-page zero punches a hole
    s.queue_transaction(Transaction().zero(CID, OID, 0, PAGE))
    assert s._colls[CID][OID].pages[0][0] == HOLE
    assert s.read(CID, OID, 0, PAGE).to_bytes() == b"\0" * PAGE
    # truncate down into a page, then grow: the tail must read zeros
    s.queue_transaction(Transaction().truncate(CID, OID, PAGE + 10))
    s.queue_transaction(Transaction().truncate(CID, OID, 2 * PAGE))
    got = s.read(CID, OID).to_bytes()
    assert len(got) == 2 * PAGE
    assert got[PAGE + 10:] == b"\0" * (PAGE - 10)
    assert got[PAGE:PAGE + 10] == b"ab" * 5
    s.umount()


def test_bluestore_rejected_tx_rolls_back_allocations(tmp_path):
    s = fresh(tmp_path)
    s.queue_transaction(Transaction().create_collection(CID))
    refs_before = dict(s._refs)
    # write stages allocations, then the clone of a missing src fails
    with pytest.raises(NoSuchObject):
        s.queue_transaction(
            Transaction().write(CID, OID, 0, b"W" * (2 * PAGE))
            .clone(CID, ObjectId("missing"), ObjectId("dst")))
    assert not s.exists(CID, OID)
    assert s._refs == refs_before
    # every device page is back on the freelist (the tx may have grown
    # the device; growth itself is not a leak)
    assert len(s._free) == s._npages
    s.umount()


def test_bluestore_fsck_clean_and_allocator_rebuild(tmp_path):
    s = fresh(tmp_path)
    for i in range(5):
        s.queue_transaction(
            Transaction().create_collection(CollectionId(1, i))
            .write(CollectionId(1, i), ObjectId(f"o{i}"), 0,
                   bytes([i]) * (PAGE + i)))
    s.queue_transaction(Transaction().remove(CollectionId(1, 2),
                                             ObjectId("o2")))
    rep = s.fsck()
    assert not rep["leaked"] and not rep["double_booked"] \
        and not rep["bad_refcounts"]
    used = dict(s._refs)
    s.umount()
    s2 = BlueStore(s.path)
    s2.mount()
    assert s2._refs == used, "mount must rebuild identical refcounts"
    rep2 = s2.fsck()
    assert not rep2["leaked"] and not rep2["bad_refcounts"]
    s2.umount()


def test_bluestore_crash_between_data_write_and_kv_commit_leaks_nothing(tmp_path):
    """Large-path ordering: data hits fresh pages before the KV commit.
    If the KV commit never happens, mount reclaims those pages."""
    s = fresh(tmp_path, defer_limit=0)
    s.queue_transaction(Transaction().create_collection(CID)
                        .write(CID, OID, 0, b"1" * PAGE))
    # simulate: write pages directly without any KV commit (the crash
    # window), by writing garbage to a freshly popped free page
    import heapq
    phys = heapq.heappop(s._free)
    s._dev_write(phys, b"g" * PAGE)
    s._dev.flush()
    s._dev.close()
    s._kv.close()
    s._mounted = False
    s2 = BlueStore(s.path)
    s2.mount()
    assert phys in set(s2._free), "leaked page must be reclaimed"
    assert s2.read(CID, OID).to_bytes() == b"1" * PAGE
    s2.umount()


def test_bluestore_remove_collection_frees_everything(tmp_path):
    s = fresh(tmp_path)
    s.queue_transaction(Transaction().create_collection(CID))
    for i in range(3):
        s.queue_transaction(Transaction().touch(CID, ObjectId(f"o{i}")))
    s.queue_transaction(
        Transaction().write(CID, ObjectId("big"), 0, b"B" * (8 * PAGE)))
    s.queue_transaction(Transaction().remove_collection(CID))
    assert s.list_collections() == []
    assert not s._refs
    s.umount()
    s2 = BlueStore(s.path)
    s2.mount()
    assert s2.list_collections() == []
    s2.umount()


def test_bluestore_remove_collection_atomic_with_same_tx_create(tmp_path):
    """An object created earlier in the SAME transaction must die with
    the collection: nothing may leak or resurrect on remount."""
    s = fresh(tmp_path)
    s.queue_transaction(
        Transaction().create_collection(CID).write(CID, OID, 0, b"x" * 5000)
        .omap_setkeys(CID, OID, {"k": b"v"}).remove_collection(CID))
    assert s.list_collections() == []
    rep = s.fsck()
    assert not rep["leaked"] and not s._refs
    s.umount()
    s2 = BlueStore(s.path)
    s2.mount()
    assert s2.list_collections() == []
    assert not s2.exists(CID, OID)
    s2.umount()


def test_bluestore_inline_compression_blob_roundtrip(tmp_path):
    """Compressible large writes store as blobs in fewer device pages
    (Compression.cc role); reads are byte-exact; overwrites
    materialise; clones share blob pages; fsck stays clean."""
    from ceph_tpu_torch.osd.bluestore import PAGE, BlueStore
    from ceph_tpu_torch.osd.objectstore import (CollectionId, ObjectId,
                                          Transaction)
    st = BlueStore(str(tmp_path / "bs"), compression="zlib")
    st.mount()
    cid, oid = CollectionId(1, 0), ObjectId("o")
    st.queue_transaction(Transaction().create_collection(cid))
    data = (b"compress-me!" * 6000)[: 16 * PAGE]  # highly compressible
    st.queue_transaction(Transaction().touch(cid, oid)
                         .write(cid, oid, 0, data))
    o = st._onode(cid, oid)
    assert o.blobs, "large compressible write did not form a blob"
    used = sum(len(b["pages"]) for b in o.blobs.values())
    assert used < 16, f"blob saved nothing ({used} pages)"
    assert st.read(cid, oid).to_bytes() == data
    assert st.fsck()["leaked"] == []
    # clone shares the blob
    clone = ObjectId("o", generation=3)
    st.queue_transaction(Transaction().clone(cid, oid, clone))
    assert st.read(cid, clone).to_bytes() == data
    # partial overwrite materialises the blob; clone keeps old bytes
    st.queue_transaction(Transaction().write(cid, oid, PAGE, b"X" * 10))
    got = st.read(cid, oid).to_bytes()
    assert got[PAGE:PAGE + 10] == b"X" * 10
    assert got[:PAGE] == data[:PAGE]
    assert not st._onode(cid, oid).blobs
    assert st.read(cid, clone).to_bytes() == data
    assert st.fsck()["leaked"] == [] and not st.fsck()["bad_refcounts"]
    # durability: remount decodes the blob map and still reads
    st.umount()
    st2 = BlueStore(str(tmp_path / "bs"), compression="zlib")
    st2.mount()
    assert st2.read(cid, clone).to_bytes() == data
    assert st2.fsck()["leaked"] == []
    # deep verify covers blob pages
    assert st2.deep_verify(cid, clone)
    st2.umount()


def test_bluestore_incompressible_data_stays_plain(tmp_path):
    import numpy as np

    from ceph_tpu_torch.osd.bluestore import PAGE, BlueStore
    from ceph_tpu_torch.osd.objectstore import (CollectionId, ObjectId,
                                          Transaction)
    st = BlueStore(str(tmp_path / "bs"), compression="zlib")
    st.mount()
    cid, oid = CollectionId(1, 0), ObjectId("r")
    st.queue_transaction(Transaction().create_collection(cid))
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 16 * PAGE, dtype=np.uint8).tobytes()
    st.queue_transaction(Transaction().touch(cid, oid)
                         .write(cid, oid, 0, data))
    assert not st._onode(cid, oid).blobs, \
        "random data must not be stored compressed"
    assert st.read(cid, oid).to_bytes() == data
    st.umount()
