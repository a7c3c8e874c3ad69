"""Wire-format non-regression corpus (the ceph-dencoder role).

The reference archives encoded bytes of every versioned type and
replays them across releases (src/tools/ceph-dencoder/ +
ceph-object-corpus): an encoding change that breaks decode of
yesterday's bytes would break rolling restarts, and nothing else in a
test suite catches it — both ends of every in-suite exchange always
run the same code.  This tool is that gate for the TPU build:

- one CANONICAL sample instance per wire message type (the registry
  tests/test_tcp.py also round-trips) and per versioned struct
  (maps, pglog entries, intervals, tickets, rbd headers);
- `--create` archives each sample's encoded bytes under corpus_wire/;
- `--check` replay-DECODES every archived blob with the current code
  and compares the decoded fields against the canonical sample (by
  re-encoding both with the current encoder — append-only version
  tails decode to their defaults and still match).

Rules for editors: appending a versioned tail field with a default is
compatible (the archived old bytes decode, the check passes);
reordering/retyping existing fields is not — the check fails, which is
the point.  After a deliberate, justified format break, regenerate
with --create and say so in the commit.

The port holds the archive the JAX package wrote and replays all of
it: every archived file has its sample here.

Usage:
    python -m ceph_tpu_torch.tools.dencoder --create [--base corpus_wire/]
    python -m ceph_tpu_torch.tools.dencoder --check  [--base corpus_wire/]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import NamedTuple

from ..msg import messages as M
from ..msg.wire import MESSAGE_TYPES, decode_frame, encode_frame


def message_samples() -> dict:
    """A representative instance of every wire message type,
    exercising the nested value shapes the generic codec must carry."""
    pg = M.PgId(3, 7)
    return {
        M.MOSDOp: M.MOSDOp(1, "client.0", 2, "obj", "write", 4096, 100,
                           b"\x00\xffdata", 9),
        M.MOSDOpReply: M.MOSDOpReply(1, -5, b"payload", 12, 9),
        M.MSubWrite: M.MSubWrite(2, pg, "o", 4, 7, "write", b"chunk",
                                 {"v": 7, "len": 100}, 512),
        M.MSubPartialWrite: M.MSubPartialWrite(
            3, pg, "o", 1, 8, [(0, b"ab"), (4096, b"cd")], 9000, True, 7),
        M.MSubDelta: M.MSubDelta(4, pg, "o", 5, 8,
                                 [(0, 128, b"\x01\x02")], 9000, 7),
        M.MSubWriteReply: M.MSubWriteReply(5, pg, 2, 3, -11),
        M.MSubRead: M.MSubRead(6, pg, "o", 0, [(4096, 8192)]),
        M.MSubReadReply: M.MSubReadReply(7, pg, "o", 0, 1, 0, b"bytes",
                                         {"v": 3, "len": 50}),
        M.MSubReadN: M.MSubReadN([(1, "o", 0, [(4096, 8192)]),
                                  (2, "p", 2, None)], pg),
        M.MSubReadReplyN: M.MSubReadReplyN(
            1, [(1, 0, 0, b"bytes", {"v": 3, "len": 50}),
                (2, 2, -2, b"", {})], pg),
        M.MOSDPing: M.MOSDPing(1, 5, 123.25),
        M.MOSDPingReply: M.MOSDPingReply(1, 123.25),
        M.MFailureReport: M.MFailureReport(2, 1, 5, 3.5),
        M.MMapPush: M.MMapPush(5, b"\x01\x02raw-map"),
        M.MMonSubscribe: M.MMonSubscribe("osdmap"),
        M.MOSDBoot: M.MOSDBoot(3, "host3", "127.0.0.1:1234",
                               "127.0.0.1:1235"),
        M.MMonCommand: M.MMonCommand(
            9, {"prefix": "pool create", "name": "p", "kind": "ec",
                "ec_profile": {"k": "4", "m": "2"}, "pg_num": 8}),
        M.MMonCommandReply: M.MMonCommandReply(9, 0, {"pool_id": 1}),
        M.MPGQuery: M.MPGQuery(pg, 5),
        M.MPGInfo: M.MPGInfo(pg, 2, -2, {("o", 0): 3, ("o", 1): 3},
                             {"dead": 2}),
        M.MPGPull: M.MPGPull(pg, ["a", "b"], True),
        M.MPGPush: M.MPGPush(pg, 1, {"o": (3, b"data", 100)},
                             {"gone": 4}, False),
        M.MStatsReport: M.MStatsReport(1, 5, {"pgs": 2, "bytes": 999}),
        M.MScrubRequest: M.MScrubRequest(1, "client.0", pg, True, False),
        M.MScrubShard: M.MScrubShard(1, pg, True),
        M.MScrubMap: M.MScrubMap(1, pg, 2,
                                 {("o", 0): {"size": 10, "version": 3,
                                             "digest": 77}}),
        M.MScrubResult: M.MScrubResult(1, pg, 0,
                                       [{"osd": 1, "kind": "x"}], 2),
        M.MMonPing: M.MMonPing("mon.1", 3, "leader", 9, 55.5),
        M.MMonElect: M.MMonElect(3, 9, 1, "mon.1"),
        M.MMonVote: M.MMonVote(3, 2, "mon.2", 8),
        M.MMonClaim: M.MMonClaim(3, 9, "mon.1"),
        M.MMonPropose: M.MMonPropose(3, 10, "osdmap", b"raw", "boot"),
        M.MMonPropAck: M.MMonPropAck(3, 10, "mon.2"),
        M.MMonSyncReq: M.MMonSyncReq(7, "mon.2"),
        M.MMonSyncEntries: M.MMonSyncEntries(
            3, [(8, "boot", "osdmap", b"v8"), (9, "down", "osdmap",
                                               b"v9")]),
        M.MMonForward: M.MMonForward("client.0", b"\x01\x02frame"),
        M.MMonFwdReply: M.MMonFwdReply("client.0", b"\x03frame"),
        M.MPGRollback: M.MPGRollback(pg, "obj", 3, 7),
        M.MWatchNotify: M.MWatchNotify(9, 2, "obj", "client.1",
                                       b"payload"),
        M.MNotifyAck: M.MNotifyAck(9, "client.2"),
        M.MOSDPGTemp: M.MOSDPGTemp(2, pg, [3, 0, 1]),
        M.MRecoveryReserve: M.MRecoveryReserve(pg, 4, "request", 255),
        M.MAuth: M.MAuth(3, "client.a", ["mon", "osd"], b"n" * 16,
                         1234567, b"p" * 32),
        M.MAuthReply: M.MAuthReply(
            3, 0, [("osd", b"ticket", b"sealed", b"n" * 16)], 600.0),
        M.MPGList: M.MPGList(4, pg, 9, b"t" * 8, b"p" * 16),
        M.MPGListReply: M.MPGListReply(4, pg, 0, ["a", "b"], 9),
        M.MLeaseRegister: M.MLeaseRegister(pg, "obj", "client.1",
                                           1234567.5),
    }


def struct_samples() -> dict:
    """name -> (instance, decode_bytes callable) for the versioned
    non-message structs that cross durability or wire boundaries (all
    of the JAX package's)."""
    from ..auth.cephx import Ticket
    from ..mon.maps import OSDMap, OsdInfo, PoolSpec
    from ..osd.intervals import Interval, PastIntervals
    from ..osd.pglog import LogEntry
    from ..services.rbd import ImageHeader, SnapRecord

    pool = PoolSpec(1, "data", "ec", 6, 5, 16,
                    {"plugin": "jerasure", "k": "4", "m": "2"},
                    snap_seq=3, removed_snaps=[1, 2])
    osd = OsdInfo(2, True, True, 1.0, "host2", "127.0.0.1:7000",
                  "127.0.0.1:7001", 0.5)
    omap = OSDMap()
    omap.epoch = 9
    omap.pools[1] = pool
    omap.osds[2] = osd
    omap.pg_temp[(1, 3)] = [2, 0]
    omap.primary_temp[(1, 3)] = 2
    omap.pg_upmap[(1, 4)] = [0, 2]
    pi = PastIntervals(
        intervals=[Interval(2, 5, [0, 1, None], 0),
                   Interval(6, 8, [1, 2, 0], 1)],
        cur_first=9, cur_up=[2, 1, 0], cur_primary=2)
    return {
        "PoolSpec": (pool, PoolSpec.decode_bytes),
        "OsdInfo": (osd, OsdInfo.decode_bytes),
        "OSDMap": (omap, OSDMap.decode_bytes),
        "PastIntervals": (pi, PastIntervals.decode_bytes),
        "LogEntry": (LogEntry(7, "write", "obj", 2, 6,
                              rollback=[(0, b"old")], old_len=100,
                              old_shard_len=25, epoch=4),
                     LogEntry.decode_bytes),
        "Ticket": (Ticket("client.a", "osd", "allow rw pool=p",
                          1234567890123, 5, b"n" * 16, b"s" * 32),
                   Ticket.decode_bytes),
        "SnapRecord": (SnapRecord(4, "snap1", 1 << 20, [1, 5]),
                       SnapRecord.decode_bytes),
        "ImageHeader": (ImageHeader(1 << 22, 1 << 20, 65536, 4,
                                    snap_seq=4,
                                    snaps=[SnapRecord(4, "s", 1 << 20)],
                                    features=1),
                        ImageHeader.decode_bytes),
    }


class Report(NamedTuple):
    """What ``check`` found: the archived files it replayed and the
    problems (empty = compatible)."""
    checked: list
    problems: list


def _msg_blob(msg) -> bytes:
    return encode_frame("dencoder.src", "dencoder.dst", msg)


def create(base: str) -> int:
    os.makedirs(base, exist_ok=True)
    n = 0
    samples = message_samples()
    missing = [c.__name__ for c in MESSAGE_TYPES if c not in samples]
    if missing:
        raise SystemExit(f"no canonical sample for {missing} — add them "
                         f"to message_samples() first")
    for cls in MESSAGE_TYPES:
        msg = samples[cls]
        with open(os.path.join(base, f"msg_{cls.__name__}.bin"),
                  "wb") as f:
            f.write(_msg_blob(msg))
        n += 1
    for name, (obj, _dec) in struct_samples().items():
        with open(os.path.join(base, f"struct_{name}.bin"), "wb") as f:
            f.write(obj.encode_bytes())
        n += 1
    print(f"archived {n} wire blobs under {base}")
    return 0


def check(base: str) -> Report:
    """Replay-decode every archived blob against its sample."""
    checked: list[str] = []
    problems: list[str] = []
    samples = message_samples()
    for cls in MESSAGE_TYPES:
        if cls not in samples:
            problems.append(f"{cls.__name__}: registered wire type has "
                            f"no canonical sample in message_samples()")
            continue
        path = os.path.join(base, f"msg_{cls.__name__}.bin")
        if not os.path.exists(path):
            problems.append(f"{cls.__name__}: no archived blob "
                            f"(run --create after adding a type)")
            continue
        raw = open(path, "rb").read()
        checked.append(os.path.basename(path))
        try:
            src, dst, got = decode_frame(raw[4:])
        except Exception as e:  # noqa: BLE001 - the failure IS the signal
            problems.append(f"{cls.__name__}: archived bytes no longer "
                            f"decode: {type(e).__name__}: {e}")
            continue
        if type(got) is not cls:
            problems.append(f"{cls.__name__}: decoded to "
                            f"{type(got).__name__}")
            continue
        # field compare via the CURRENT encoder: an appended default
        # tail matches; a changed/reordered field does not
        if _msg_blob(got) != _msg_blob(samples[cls]):
            problems.append(f"{cls.__name__}: decoded fields differ "
                            f"from the canonical sample")
    for name, (obj, dec) in struct_samples().items():
        path = os.path.join(base, f"struct_{name}.bin")
        if not os.path.exists(path):
            problems.append(f"{name}: no archived blob")
            continue
        raw = open(path, "rb").read()
        checked.append(os.path.basename(path))
        try:
            got = dec(raw)
        except Exception as e:  # noqa: BLE001
            problems.append(f"{name}: archived bytes no longer decode: "
                            f"{type(e).__name__}: {e}")
            continue
        if got.encode_bytes() != obj.encode_bytes():
            problems.append(f"{name}: decoded fields differ from the "
                            f"canonical sample")
    return Report(checked, problems)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--base", default="corpus_wire")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--create", action="store_true")
    g.add_argument("--check", action="store_true")
    args = p.parse_args()
    if args.create:
        return create(args.base)
    report = check(args.base)
    if report.problems:
        for what in report.problems:
            print(f"INCOMPATIBLE: {what}", file=sys.stderr)
        return 1
    print(f"wire corpus compatible ({len(report.checked)} blobs checked)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
