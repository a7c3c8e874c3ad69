"""Unit tests for the port's cluster-slice components: placement
determinism/balance, map encode/decode, messenger faults (the JAX
package's tests/test_slice_units.py on ceph_tpu_torch, less its
objectstore cases: the port has no osd.objectstore yet)."""

import collections
import threading

import pytest

from ceph_tpu_torch.mon.maps import OSDMap, PoolSpec
from ceph_tpu_torch.msg.messenger import (Dispatcher, LocalNetwork,
                                          Messenger, Policy)
from ceph_tpu_torch.parallel.placement import (PlacementMap,
                                               pg_of_object, stable_mod)


# --------------------------------------------------------------- placement
def test_stable_mod_matches_semantics():
    # b=6: bmask=7; values with (x&7) >= 6 fall back to x&3
    for x in range(64):
        got = stable_mod(x, 6, 7)
        want = (x & 7) if (x & 7) < 6 else (x & 3)
        assert got == want


def test_pg_of_object_range_and_determinism():
    for pg_num in (1, 3, 8, 15, 32):
        seen = set()
        for i in range(500):
            pg = pg_of_object(f"obj{i}", pg_num)
            assert 0 <= pg < pg_num
            seen.add(pg)
        assert len(seen) == pg_num  # all pgs hit
    assert pg_of_object("x", 8) == pg_of_object("x", 8)


def test_placement_distinct_hosts_and_determinism():
    pm = PlacementMap()
    for i in range(12):
        pm.add_device(i, 1.0, host=f"host{i % 6}")
    sel = pm.select(12345, 3)
    assert len(sel) == 3 == len(set(sel))
    hosts = {pm.devices[d].host for d in sel}
    assert len(hosts) == 3  # failure-domain separation
    assert sel == pm.select(12345, 3)  # pure function


def test_placement_balance_and_weights():
    pm = PlacementMap()
    for i in range(8):
        pm.add_device(i, 2.0 if i == 0 else 1.0, host=f"host{i}")
    counts = collections.Counter()
    for key in range(2000):
        for d in pm.select(key, 3):
            counts[d] += 1
    # the double-weight device gets roughly double a normal one's share
    normal = sum(counts[i] for i in range(1, 8)) / 7
    assert counts[0] / normal > 1.4
    # every device participates meaningfully
    assert min(counts.values()) > 0.3 * normal


def test_placement_stability_under_rejection():
    """Down devices are re-drawn; surviving members keep positions."""
    pm = PlacementMap()
    for i in range(10):
        pm.add_device(i, 1.0, host=f"host{i}")
    base = pm.select(999, 4)
    down = {base[1]}
    degraded = pm.select(999, 4, reject=lambda d: d in down)
    assert base[0] in degraded
    assert base[2] in degraded and base[3] in degraded
    assert down.isdisjoint(degraded)


# -------------------------------------------------------------------- maps
def test_osdmap_encode_decode_roundtrip():
    m = OSDMap()
    for i in range(4):
        m.add_osd(i, f"host{i}", f"osd.{i}")
        m.mark_up(i)
    m.mark_down(3)
    m.add_pool(PoolSpec(1, "rbd", "replicated", 3, 2, 8))
    m.add_pool(PoolSpec(2, "ec", "ec", 6, 4, 4,
                        {"plugin": "jerasure", "k": "4", "m": "2"}))
    m.epoch = 17
    m2 = OSDMap.decode_bytes(m.encode_bytes())
    assert m2.epoch == 17
    assert m2.osds[3].up is False and m2.osds[0].up is True
    assert m2.pools[2].ec_profile["k"] == "4"
    assert m2.pg_to_osds(1, 3) == m.pg_to_osds(1, 3)


def test_osdmap_ec_holes_keep_positions():
    m = OSDMap()
    for i in range(6):
        m.add_osd(i, f"host{i}")
        m.mark_up(i)
    m.add_pool(PoolSpec(1, "ec", "ec", 5, 4, 1))
    up = m.pg_to_up_osds(1, 0)
    assert len(up) == 5
    victim_pos = 2
    m.mark_down(up[victim_pos])
    up2 = m.pg_to_up_osds(1, 0)
    for pos in range(5):
        if pos != victim_pos:
            assert up2[pos] == up[pos]  # shard positions stable
    assert up2[victim_pos] != up[victim_pos]  # hole filled by spare or None


# --------------------------------------------------------------- messenger
class Echo(Dispatcher):
    def __init__(self):
        self.got = []
        self.event = threading.Event()

    def ms_dispatch(self, conn, msg):
        self.got.append(msg)
        if msg == "ping":
            conn.send("pong")
        self.event.set()
        return True


def test_messenger_roundtrip():
    net = LocalNetwork()
    a, b = Echo(), Echo()
    ma = Messenger(net, "a")
    mb = Messenger(net, "b")
    ma.add_dispatcher(a)
    mb.add_dispatcher(b)
    ma.start()
    mb.start()
    ma.send_message("b", "ping")
    assert b.event.wait(60) and a.event.wait(60)
    assert b.got == ["ping"] and a.got == ["pong"]
    ma.shutdown()
    mb.shutdown()
    assert net.lookup("a") is None


def test_messenger_partition_and_drops():
    net = LocalNetwork(seed=1)
    recv = Echo()
    m1 = Messenger(net, "one")
    m2 = Messenger(net, "two")
    m2.add_dispatcher(recv)
    m2.start()
    net.partition("one", "two")
    m1.send_message("two", "lost")
    net.heal()
    m1.send_message("two", "found")
    assert recv.event.wait(60)
    assert recv.got == ["found"]
    # probabilistic drops count
    net.drop_rate = 1.0
    m1.send_message("two", "gone")
    assert net.dropped >= 2
    m1.shutdown()
    m2.shutdown()


def test_messenger_duplicate_entity_rejected():
    net = LocalNetwork()
    m1 = Messenger(net, "dup")
    with pytest.raises(ValueError):
        Messenger(net, "dup")
    m1.shutdown()
