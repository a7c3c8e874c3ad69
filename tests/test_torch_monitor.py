"""The port's monitor against the JAX package's.

- The seam: ``osd pool create`` checks an EC profile by building its
  codec, and the port builds it on the host (backend ``auto``) whatever
  the profile's backend and device say, so the default ``tpu`` pool and
  every plugin's default profile are created on a box with no card, as
  the reference creates them.  Answers go through the monitor's command
  path (MMonCommand in, MMonCommandReply out) and equal the reference's;
  the committed PoolSpec encodes to the reference's bytes.
- The durable store: a monitor of either package opens the other's
  monstore.bin, serves the same epoch and OSDMap bytes, and commits on
  top of it.
- The MonStore, DurableMonStore and MonitorLite cases of the JAX
  package's tests/test_paxos.py and tests/test_quorum.py that need no
  MiniCluster, on the port.
"""

import threading

import pytest

import ceph_tpu.mon.maps as ref_maps
import ceph_tpu.mon.monitor as ref_monitor
import ceph_tpu.msg.messages as ref_messages
import ceph_tpu.msg.messenger as ref_messenger
import ceph_tpu.utils.config as ref_config
import ceph_tpu_torch.mon.maps as port_maps
import ceph_tpu_torch.mon.monitor as port_monitor
import ceph_tpu_torch.msg.messages as port_messages
import ceph_tpu_torch.msg.messenger as port_messenger
import ceph_tpu_torch.utils.config as port_config
from ceph_tpu_torch.mon.monitor import (DurableMonStore, MonitorLite,
                                        MonStore)
from ceph_tpu_torch.msg.messages import MMonElect
from ceph_tpu_torch.msg.messenger import LocalNetwork

PACKAGES = {
    "ref": (ref_monitor, ref_messages, ref_messenger, ref_config),
    "port": (port_monitor, port_messages, port_messenger, port_config),
}
#: the longest a command's reply may take (a bound, not a measurement)
REPLY_S = 60.0

#: each plugin's default profile, as ``osd pool create`` receives it
DEFAULT_PROFILES = [{}, {"plugin": "tpu"}, {"plugin": "jerasure"},
                    {"plugin": "isa"}, {"plugin": "lrc"},
                    {"plugin": "shec"}, {"plugin": "clay"},
                    {"plugin": "xor"}]
PLUGINS = ["tpu", "jerasure", "isa", "lrc", "shec", "clay", "xor"]


def make_cfg(config, **over):
    """tests/test_cluster.py's make_cfg on ``config``'s default_config."""
    cfg = config.default_config()
    cfg.apply_dict({"osd_heartbeat_interval": 0.05,
                    "osd_heartbeat_grace": 0.5,
                    "ec_backend": "native",
                    "osd_op_num_shards": 2,
                    "ms_dispatch_workers": 2, **over})
    return cfg


class Mon:
    """One started single MonitorLite of a package and a client entity
    that sends it commands and waits for the replies."""

    def __init__(self, pkg: str, path: str | None = None):
        monitor, messages, messenger, config = PACKAGES[pkg]
        self.messages = messages
        net = messenger.LocalNetwork()
        self.mon = monitor.MonitorLite(net, "mon.0", cfg=make_cfg(config),
                                       path=path)
        self.mon.start()
        self.client = messenger.Messenger(net, "client.0",
                                          messenger.Policy.lossless_peer())
        self._replies: dict[int, object] = {}
        self._got = threading.Condition()
        self._tid = 0
        outer = self

        class Replies(messenger.Dispatcher):
            def ms_dispatch(self, conn, msg):
                if not isinstance(msg, messages.MMonCommandReply):
                    return False
                with outer._got:
                    outer._replies[msg.tid] = msg
                    outer._got.notify_all()
                return True

        self.client.add_dispatcher(Replies())
        self.client.start()

    def command(self, **cmd) -> tuple[int, dict]:
        self._tid += 1
        tid = self._tid
        self.client.send_message("mon.0", self.messages.MMonCommand(tid, cmd))
        with self._got:
            if not self._got.wait_for(lambda: tid in self._replies,
                                      REPLY_S):
                raise AssertionError(f"no reply to {cmd} in {REPLY_S} s")
            reply = self._replies.pop(tid)
        return reply.result, reply.data

    def pool_bytes(self, pool_id: int) -> bytes:
        return self.mon.osdmap.pools[pool_id].encode_bytes()

    def stop(self) -> None:
        self.client.shutdown()
        self.mon.stop()


@pytest.fixture
def mons():
    pair = {"ref": Mon("ref"), "port": Mon("port")}
    yield pair
    for m in pair.values():
        m.stop()


def create(mon: Mon, profile: dict, name: str = "ecpool"):
    return mon.command(prefix="osd pool create", name=name, kind="ec",
                       ec_profile=profile)


# ----------------------------------------------------------------- the seam
@pytest.mark.parametrize("profile", DEFAULT_PROFILES,
                         ids=lambda p: p.get("plugin", "default"))
def test_default_profile_pool_as_in_the_reference(mons, profile):
    """Each plugin's default profile (and no profile: ec_plugin's tpu) is
    created on this CPU box, with the reference's answer and PoolSpec
    bytes."""
    want = create(mons["ref"], profile)
    assert want[0] == 0
    assert create(mons["port"], profile) == want
    pid = want[1]["pool_id"]
    assert mons["port"].pool_bytes(pid) == mons["ref"].pool_bytes(pid)


@pytest.mark.parametrize("plugin", PLUGINS)
def test_torch_profile_pool_gets_the_device_backends_answer(mons, plugin):
    """A profile that names the port's device backend (backend=torch,
    device=cuda) gets the answer the reference gives the same profile
    naming its device backend (jax), and the pool keeps the caller's
    profile: its PoolSpec is the reference's with that profile.  The
    reference itself refuses backend=torch, which it does not know."""
    profile = {"plugin": plugin, "backend": "torch", "device": "cuda"}
    got = create(mons["port"], profile)
    assert got == create(mons["ref"], dict(profile, backend="jax"))
    assert got[0] == 0
    pid = got[1]["pool_id"]
    spec = mons["ref"].mon.osdmap.pools[pid]
    ref_spec = ref_maps.PoolSpec(spec.pool_id, spec.name, spec.kind,
                                 spec.size, spec.min_size, spec.pg_num,
                                 profile)
    assert mons["port"].pool_bytes(pid) == ref_spec.encode_bytes()
    assert mons["port"].mon.osdmap.pools[pid].ec_profile == profile
    rc, data = create(mons["ref"], profile, name="refused")
    assert rc == -22 and "unknown backend 'torch'" in data["error"]


def test_check_builds_its_codec_on_the_host(monkeypatch):
    """The check's codec gets backend=auto and no device, whatever the
    profile says; the profile stored is the caller's."""
    built = []
    real = port_monitor.ec.factory

    def factory(plugin, profile):
        built.append((plugin, dict(profile)))
        return real(plugin, profile)

    monkeypatch.setattr(port_monitor.ec, "factory", factory)
    mon = Mon("port")
    try:
        profile = {"plugin": "tpu", "k": "8", "m": "3", "backend": "torch",
                   "device": "cuda:0", "stripe_unit": "8192"}
        assert create(mon, profile)[0] == 0
        assert built == [("tpu", {"k": "8", "m": "3",
                                  "stripe_unit": "8192",
                                  "backend": "auto"})]
        assert mon.mon.osdmap.pools[1].ec_profile == profile
    finally:
        mon.stop()
    assert port_monitor.host_check_profile({"plugin": "isa"}) == \
        {"backend": "auto"}


@pytest.mark.parametrize("profile", [
    {"stripe_unit": "1000"},
    {"plugin": "tpu", "stripe_unit": "x"},
    {"plugin": "jerasure", "technique": "liberation", "k": "5", "m": "2",
     "stripe_unit": "4096"},
    {"plugin": "tpu", "k": "0"},
    {"plugin": "tpu", "backend": "torch", "stripe_unit": "6144"},
], ids=["unit-1000", "unit-text", "granularity", "k0", "torch-unit"])
def test_refusals_match_the_reference(mons, profile):
    """A bad stripe_unit, a unit off the plugin's granularity and a bad
    k are refused with the reference's error (the torch-backend profile
    against the reference's jax one)."""
    want = create(mons["ref"], dict(
        profile, **({"backend": "jax"} if "backend" in profile else {})))
    assert want[0] == -22
    assert create(mons["port"], profile) == want


def test_replicated_pool_as_in_the_reference(mons):
    for name in ("rbd", "data"):
        cmd = dict(prefix="osd pool create", name=name, size="2",
                   pg_num="64", ec_profile={"read_policy": "balance"})
        assert mons["port"].command(**cmd) == mons["ref"].command(**cmd)
    assert mons["port"].mon.osdmap.encode_bytes() == \
        mons["ref"].mon.osdmap.encode_bytes()


# ---------------------------------------------------------- the store handoff
def populate(mon: Mon) -> None:
    """A tpu k=8 m=3 pool, a replicated pool, and a few more epochs."""
    assert create(mon, {"plugin": "tpu", "k": "8", "m": "3"},
                  name="ecpool")[0] == 0
    assert mon.command(prefix="osd pool create", name="rbd", size="3",
                       pg_num="128")[0] == 0
    assert mon.command(prefix="osd pool set-pg-num", pool="rbd",
                       pg_num="256")[0] == 0
    assert mon.command(prefix="osd qos set-profile", name="gold",
                       res="100", wgt="4", lim="0")[0] == 0


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_monitor_store_crosses_both_ways(tmp_path, first, second):
    """A monitor of one package commits several epochs to its durable
    store and stops; a monitor of the other opens the same directory,
    serves the same epoch and map bytes, and commits a new epoch."""
    a = Mon(first, path=str(tmp_path))
    try:
        populate(a)
    finally:
        a.stop()  # persists the cluster log: one more store version
    epoch = a.mon.osdmap.epoch
    raw = a.mon.store.kv["osdmap"]
    version = a.mon.store.version
    assert epoch >= 4 and len({p.name for p in
                               port_maps.OSDMap.decode_bytes(raw)
                               .pools.values()}) == 2
    b = Mon(second, path=str(tmp_path))
    try:
        assert b.mon.store.version == version
        assert b.mon.osdmap.epoch == epoch
        assert b.mon.store.kv["osdmap"] == raw
        assert b.mon.osdmap.encode_bytes() == raw
        rc, data = b.command(prefix="osd pool create", name="after",
                             size="2", pg_num="8")
        assert rc == 0
        # an epoch takes the store's next version (the cluster log's
        # commits take versions too)
        after = b.mon.osdmap.epoch
        assert after > epoch and b.mon.store.version > version
    finally:
        b.stop()
    c = Mon(first, path=str(tmp_path))
    try:
        assert c.mon.osdmap.epoch == after
        assert sorted(p.name for p in c.mon.osdmap.pools.values()) == \
            ["after", "ecpool", "rbd"]
    finally:
        c.stop()
    assert ref_maps.OSDMap.decode_bytes(raw).encode_bytes() == raw


# ------------------------------- the JAX package's MonStore/MonitorLite tests
def test_accept_commit_split():
    s = MonStore()
    s.accept_at(1, 5, "osdmap", b"e1", "first")
    s.accept_at(2, 5, "osdmap", b"e2", "second")
    assert s.version == 0 and s.accepted_version == 2
    out = s.commit_accepted_upto(1, pterm=5)
    assert [e[0] for e in out] == [1]
    assert s.version == 1 and s.kv["osdmap"] == b"e1"
    # stale-pointer guard: an old-term entry never commits by pointer
    s.restamp_accepted(6)
    assert s.commit_accepted_upto(2, pterm=5) == []
    assert s.commit_accepted_upto(2, pterm=6)[0][0] == 2


def test_accept_truncate_on_divergence():
    s = MonStore()
    s.accept_at(1, 3, "k", b"a", "d")
    s.accept_at(2, 3, "k", b"b", "d")
    assert s.truncate_accepted(2)
    assert s.accepted_version == 1
    s.accept_at(2, 4, "k", b"B", "d'")
    # a committed sync entry that contradicts the accepted head discards
    # the whole tail (it chains off a deposed leader's history)
    s2 = MonStore()
    s2.accept_at(1, 3, "k", b"junk", "d")
    s2.accept_at(2, 3, "k", b"junk2", "d")
    s2.commit_at(1, "k", b"real", "sync")
    assert s2.accepted == [] and s2.kv["k"] == b"real"


def test_durable_accept_records_survive_restart(tmp_path):
    s = DurableMonStore(str(tmp_path))
    s.commit("osdmap", b"base", "committed")
    s.accept_at(2, 7, "osdmap", b"staged", "accepted-not-committed")
    s.close()
    s2 = DurableMonStore(str(tmp_path))
    assert s2.version == 1 and s2.kv["osdmap"] == b"base"
    assert s2.accepted_version == 2
    assert s2.accepted[0][:2] == (2, 7)
    # the accepted entry commits after restart via the commit pointer
    s2.commit_accepted_upto(2, pterm=7)
    assert s2.version == 2 and s2.kv["osdmap"] == b"staged"
    s2.close()
    s3 = DurableMonStore(str(tmp_path))
    assert s3.version == 2 and s3.accepted == []
    s3.close()


def test_durable_truncate_and_compact_preserve_tail(tmp_path):
    s = DurableMonStore(str(tmp_path))
    for i in range(600):  # force at least one compaction
        s.commit("osdmap", b"m%d" % i, f"e{i}")
    s.accept_at(601, 9, "osdmap", b"tail1", "t1")
    s.accept_at(602, 9, "osdmap", b"tail2", "t2")
    s.truncate_accepted(602)
    s.close()
    s2 = DurableMonStore(str(tmp_path))
    assert s2.version == 600
    assert [e[0] for e in s2.accepted] == [601]
    s2.close()


def test_durable_term_and_vote_survive_restart(tmp_path):
    """A restarted mon must not vote twice in a term (two leaders): the
    term + votedFor persist with the log (Raft persistent state)."""
    s = DurableMonStore(str(tmp_path))
    s.set_term(5, "mon.2")
    s.close()
    s2 = DurableMonStore(str(tmp_path))
    assert (s2.cur_term, s2.voted_for) == (5, "mon.2")
    # snapshot compaction carries it too
    s2.note_term(4)
    for i in range(600):
        s2.commit("k", b"%d" % i, "e")
    s2.close()
    s3 = DurableMonStore(str(tmp_path))
    assert (s3.cur_term, s3.voted_for, s3.last_term) == (5, "mon.2", 4)
    s3.close()


def test_vote_comparator_prefers_newer_term_over_longer_tail():
    """A long divergent stale-term uncommitted tail must lose the
    election to newer-term history (Raft §5.4.1: term before length)."""
    net = LocalNetwork()
    m = MonitorLite(net, "mon.1", cfg=make_cfg(port_config),
                    peers=["mon.0", "mon.1", "mon.2"])
    # my log: one entry accepted under term 4
    m.store.accept_at(1, 4, "k", b"new", "d")
    m._term = 4
    granted = []
    m._post = lambda dst, msg: granted.append((dst, msg))
    # stale candidate: LONGER log (v3) but last entry from term 2
    m.ms_dispatch(type("C", (), {"peer": "mon.0"})(),
                  MMonElect(5, 3, 0, "mon.0", lterm=2))
    assert not any(d == "mon.0" and type(x).__name__ == "MMonVote"
                   for d, x in granted)
    # up-to-date candidate: same length + last term, better rank ->
    # granted (at a term we have not voted in yet)
    m.ms_dispatch(type("C", (), {"peer": "mon.0"})(),
                  MMonElect(max(m._term, 6) + 1, 1, 0, "mon.0", lterm=4))
    assert any(d == "mon.0" and type(x).__name__ == "MMonVote"
               for d, x in granted)
    m.messenger.shutdown()


def test_ack_from_divergent_tail_not_counted():
    """An equal-length tail accepted under a different term must not
    count toward the commit majority (prevLogTerm proof)."""
    net = LocalNetwork()
    m = MonitorLite(net, "mon.0", cfg=make_cfg(port_config),
                    peers=["mon.0", "mon.1", "mon.2"])
    m._term = 7
    m._role = "leader"
    m.store.accept_at(1, 7, "osdmap", b"mine", "d")
    m._pending_acks[1] = {"mon.0"}
    # divergent acker: claims v1 but accepted it under old term 3
    assert not m._ack_covers(1, 3)
    m._count_ack("mon.2", 1, 3)
    assert m._pending_acks[1] == {"mon.0"}
    # matching acker commits
    assert m._ack_covers(1, 7)
    m._count_ack("mon.1", 1, 7)
    assert m._pending_acks[1] == {"mon.0", "mon.1"}
    m.messenger.shutdown()


def test_durable_monstore_roundtrip(tmp_path):
    s = DurableMonStore(str(tmp_path))
    s.commit("osdmap", b"v1-bytes", "first")
    s.commit("osdmap", b"v2-bytes", "second")
    s.commit("other", b"x", "third")
    s.close()
    s2 = DurableMonStore(str(tmp_path))
    assert s2.version == 3
    assert s2.kv["osdmap"] == b"v2-bytes"
    assert s2.kv["other"] == b"x"
    assert [e[1] for e in s2.log] == ["first", "second", "third"]
    s2.close()


def test_durable_monstore_discards_torn_tail(tmp_path):
    s = DurableMonStore(str(tmp_path))
    s.commit("k", b"good", "ok")
    s.close()
    # simulate a crash mid-append: garbage half-record at the tail
    with open(str(tmp_path) + "/monstore.bin", "ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad\xbe\xefhalf")
    s2 = DurableMonStore(str(tmp_path))
    assert s2.version == 1 and s2.kv["k"] == b"good"
    s2.commit("k", b"after", "resumed")  # appends cleanly post-truncate
    s2.close()
    s3 = DurableMonStore(str(tmp_path))
    assert s3.version == 2 and s3.kv["k"] == b"after"
    s3.close()


def test_durable_monstore_compacts(tmp_path):
    """The log keeps a bounded tail and the file compacts to a snapshot:
    neither restart replay nor disk grows with cluster age."""
    import os
    s = DurableMonStore(str(tmp_path))
    for i in range(3000):
        s.commit("osdmap", b"map-%d" % i, f"epoch {i}")
    assert s.version == 3000
    assert len(s.log) <= 2 * s.LOG_KEEP
    size = os.path.getsize(str(tmp_path) + "/monstore.bin")
    assert size < 200_000, size  # snapshot+tail, not 3000 full records
    s.close()
    s2 = DurableMonStore(str(tmp_path))
    assert s2.version == 3000
    assert s2.kv["osdmap"] == b"map-2999"
    s2.close()


def test_connectivity_strategy_breaks_ties_against_flappers():
    """The connectivity election strategy (ConnectionTracker role):
    between equally log-complete candidates, voters defer to the one
    that can actually SEE the cluster — but link quality can NEVER
    outrank log completeness (commit safety)."""
    net = LocalNetwork()
    m = MonitorLite(net, "mon.1", cfg=make_cfg(port_config),
                    peers=["mon.0", "mon.1", "mon.2"])
    try:
        m._term = 4
        # my view of the cluster is healthy
        m._conn_scores = {"mon.0": 1.0, "mon.2": 1.0}
        granted = []
        m._post = lambda dst, msg: granted.append((dst, msg))
        # equally complete candidate with TERRIBLE connectivity
        # (bucket 2) and a better rank: the tie breaks AGAINST it
        m.ms_dispatch(type("C", (), {"peer": "mon.0"})(),
                      MMonElect(5, 0, 0, "mon.0", lterm=0,
                                connectivity=2))
        assert not any(type(x).__name__ == "MMonVote"
                       for _d, x in granted), \
            "a flapping candidate won an even tie"
        # same candidacy with healthy connectivity gets the vote
        granted.clear()
        m._voted = None
        m.ms_dispatch(type("C", (), {"peer": "mon.0"})(),
                      MMonElect(6, 0, 0, "mon.0", lterm=0,
                                connectivity=10))
        assert any(type(x).__name__ == "MMonVote"
                   for _d, x in granted)
        # a MORE COMPLETE log beats any connectivity deficit
        granted.clear()
        m._voted = None
        m.store.accept_at(1, 4, "k", b"v", "d")  # my log grows
        m.ms_dispatch(type("C", (), {"peer": "mon.0"})(),
                      MMonElect(7, 0, 0, "mon.0", lterm=0,
                                connectivity=10))
        assert not any(type(x).__name__ == "MMonVote"
                       for _d, x in granted), \
            "connectivity outranked log completeness"
    finally:
        m.stop()
