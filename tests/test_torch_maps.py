"""The port's cluster maps and placement against the JAX package's.

- An OSDMap with pools, OSD infos, pg_temp, primary_temp, pg_upmap, QoS
  profiles and perf queries, built by the same steps in both packages,
  encodes to the same bytes; each package decodes the other's bytes and
  re-encodes them unchanged, and the same holds for the incrementals
  between its epochs.
- Placement at the size of a cluster users run: 96 OSDs on 12 hosts (8
  each) with weights seeded between 0.5 and 2.0, an EC 8+3 pool with one
  chunk per host at pg_num 1024 (Ceph's mon_target_pg_per_osd default of
  100 gives 96 x 100 / 11 ~ 873 PGs, rounded up to a power of two) and a
  replicated size-3 pool, where pg_temp applies.  For every PG, and for
  20,000 seeded object names, both packages give the same PG, up set and
  acting set: for the map as built, after 3 OSDs are marked down, and
  after a pg_temp and a primary_temp entry.

Placement's straw2 draws (placement.PlacementMap._draw) are pure
functions of their arguments.  The placement test memoizes each
package's own _draw for its duration, so a draw that recurs (the up and
acting sets of one PG, an unchanged PG in the next state) is computed
once per package; the results are those of the unmemoized function.
The port's half runs in a child interpreter while this one computes the
reference's.  Sets and PGs compare exactly."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import ceph_tpu_torch.mon.maps as port_maps
import ceph_tpu_torch.parallel.placement as port_placement

OSDS, PER_HOST, PG_NUM, REP_PG_NUM, OBJECTS = 96, 8, 1024, 256, 20_000
SEED = 11
TESTS = os.path.dirname(os.path.abspath(__file__))


def reference():
    """The JAX package's maps and placement modules, imported here rather
    than at the top: the port's half of the placement test runs in a
    child interpreter that imports this file without jax."""
    import ceph_tpu.mon.maps as maps
    import ceph_tpu.parallel.placement as placement
    return maps, placement


def build(maps, seed: int = SEED):
    """The 96-OSD map, every OSD up, the EC 8+3 pool (pool 1) and the
    replicated pool (pool 2), at epoch 1."""
    rng = np.random.default_rng(seed)
    weights = rng.uniform(0.5, 2.0, OSDS)
    om = maps.OSDMap()
    for i in range(OSDS):
        om.add_osd(i, f"host{i // PER_HOST}", f"10.0.{i // PER_HOST}.1:"
                   f"{6800 + i}", float(weights[i]),
                   hb_addr=f"10.0.{i // PER_HOST}.1:{7800 + i}")
        om.mark_up(i)
    om.add_pool(maps.PoolSpec(1, "ecpool", "ec", 11, 9, PG_NUM,
                              {"plugin": "tpu", "technique": "reed_sol_van",
                               "k": "8", "m": "3"}))
    om.add_pool(maps.PoolSpec(2, "rbd", "replicated", 3, 2, REP_PG_NUM, {}))
    om.epoch = 1
    return om


def mark_down(om, rng_seed: int = SEED):
    """State 2: three seeded OSDs marked down (epoch 2)."""
    rng = np.random.default_rng(rng_seed + 1)
    down = sorted(int(d) for d in rng.choice(OSDS, 3, replace=False))
    for d in down:
        om.mark_down(d)
    om.epoch = 2
    return down


#: candidates for the replicated pool's pg_temp entry, one a host
PG_TEMP = (7, 15, 31, 39)


def add_temps(om):
    """State 3: a pg_temp and a primary_temp entry on the replicated
    pool, and a pg_temp entry on the EC pool, which EC ignores (epoch
    3)."""
    om.pg_temp[(2, 5)] = [d for d in PG_TEMP if om.osds[d].up][:3]
    om.primary_temp[(2, 9)] = om.pg_to_up_osds(2, 9)[-1]
    om.pg_temp[(1, 3)] = [0, 8, 16]
    om.epoch = 3


def rich(maps):
    """A map with every kind of field set: the three states' overrides
    plus pg_upmap, primary affinity, QoS profiles, perf queries and an
    out OSD, at epoch 4."""
    om = build(maps)
    mark_down(om)
    add_temps(om)
    om.pg_upmap[(1, 4)] = [0, 8, 16, 24, 32, 40, 48, 56, 64, 72, 80]
    om.pg_upmap[(2, 6)] = [1, 9, 17]
    om.osds[5].primary_affinity = 0.25
    om.mark_out(95)
    om.qos_profiles["gold"] = {"res": 100.0, "wgt": 4.0, "lim": 0.0}
    om.perf_queries[1] = {"key": "pool", "counters": ["ops", "bytes"]}
    om.epoch = 4
    return om


# -------------------------------------------------------------- encodings
def test_osdmap_crosses_both_ways():
    ref_maps = reference()[0]
    ref, port = rich(ref_maps), rich(port_maps)
    raw = ref.encode_bytes()
    assert port.encode_bytes() == raw
    got = port_maps.OSDMap.decode_bytes(raw)
    assert got.encode_bytes() == raw
    assert got.pg_temp == ref.pg_temp and got.pg_upmap == ref.pg_upmap
    assert got.primary_temp == ref.primary_temp
    back = ref_maps.OSDMap.decode_bytes(port.encode_bytes())
    assert back.encode_bytes() == raw
    assert sorted(back.osds) == list(range(OSDS))


@pytest.mark.parametrize("steps", [(build, mark_down), (mark_down, add_temps),
                                   (build, rich)],
                         ids=["down", "temps", "rich"])
def test_incrementals_cross_both_ways(steps):
    """The incremental between two epochs encodes to the same bytes in
    both packages; each applies the other's to reach the same map."""
    ref_maps = reference()[0]
    maps_of = {}
    for name, maps in (("ref", ref_maps), ("port", port_maps)):
        if steps[0] is build:
            old = build(maps)
            new = steps[1](maps) if steps[1] is rich else old.deepcopy()
            if steps[1] is not rich:
                steps[1](new)
        else:
            old = build(maps)
            steps[0](old)
            new = old.deepcopy()
            steps[1](new)
        maps_of[name] = (old, new, new.diff_from(old).encode_bytes())
    ref_old, ref_new, ref_inc = maps_of["ref"]
    port_old, port_new, port_inc = maps_of["port"]
    assert port_inc == ref_inc
    applied = port_old.deepcopy()
    applied.apply_incremental(
        port_maps.OSDMapIncremental.decode_bytes(ref_inc))
    assert applied.encode_bytes() == ref_new.encode_bytes()
    back = ref_old.deepcopy()
    back.apply_incremental(ref_maps.OSDMapIncremental.decode_bytes(port_inc))
    assert back.encode_bytes() == port_new.encode_bytes()


def test_map_push_crosses_both_ways():
    """maps.apply_map_push, the receivers' shared state machine, takes a
    full map and an incremental from the other package's bytes."""
    ref_maps = reference()[0]
    ref_old, port_old = build(ref_maps), build(port_maps)
    ref_new, port_new = rich(ref_maps), rich(port_maps)
    inc = ref_new.diff_from(ref_old).encode_bytes()
    msg = type("Push", (), dict(map_bytes=b"", inc_bytes=inc, base_epoch=1,
                                epoch=4))
    got, req = port_maps.apply_map_push(port_old, msg)
    assert req is None and got.encode_bytes() == ref_new.encode_bytes()
    msg.map_bytes, msg.inc_bytes = port_new.encode_bytes(), b""
    back, req = ref_maps.apply_map_push(None, msg)
    assert req is None and back.encode_bytes() == port_new.encode_bytes()


# -------------------------------------------------------------- placement
def memo(fn):
    """``fn`` with each distinct argument tuple computed once (its
    arguments are ints, strs and weights: equal arguments give equal
    draws)."""
    cache = {}

    def wrapped(*parts):
        try:
            return cache[parts]
        except KeyError:
            out = cache[parts] = fn(*parts)
            return out
    return wrapped


def mapping(om) -> list:
    """[pool, pg, up set, acting set] for every PG of every pool."""
    return [[pid, s, om.pg_to_up_osds(pid, s, ignore_temp=True),
             om.pg_to_up_osds(pid, s)]
            for pid, pool in sorted(om.pools.items())
            for s in range(pool.pg_num)]


def states(maps, placement) -> list:
    """The mapping of the map as built, after 3 OSDs down, and after the
    temp entries, with ``placement``'s draws memoized meanwhile."""
    draw = placement.PlacementMap.__dict__["_draw"]
    placement.PlacementMap._draw = staticmethod(memo(draw.__func__))
    try:
        om = build(maps)
        out = [mapping(om)]
        mark_down(om)
        out.append(mapping(om))
        add_temps(om)
        out.append(mapping(om))
    finally:
        placement.PlacementMap._draw = draw
    return out


def port_states_main() -> None:
    """The child interpreter's half: the port's states as JSON."""
    json.dump(states(port_maps, port_placement), sys.stdout)


def test_placement_parity_at_96_osds():
    env = dict(os.environ, PYTHONPATH=os.path.dirname(TESTS))
    child = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_maps as t; "
                               "t.port_states_main()"],
        cwd=TESTS, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ref_states = json.loads(json.dumps(states(*reference())))
    finally:
        out, err = child.communicate(timeout=300)
    assert child.returncode == 0, err
    port_states = json.loads(out)
    for i, (ref, port) in enumerate(zip(ref_states, port_states)):
        assert len(port) == len(ref) == PG_NUM + REP_PG_NUM
        diff = [r[:2] for r, p in zip(ref, port) if r != p]
        assert diff == [], f"state {i}: {len(diff)} PGs differ: {diff[:5]}"
    built, down, temps = ({(p, s): (up, acting) for p, s, up, acting in st}
                          for st in port_states)
    # the states do what they claim: an EC set spans 11 hosts, holes and
    # replacements follow the down OSDs, pg_temp moves the replicated
    # acting set and not its up set, and EC ignores pg_temp
    om = build(port_maps)
    for s in range(PG_NUM):
        up, acting = built[(1, s)]
        assert up == acting and len({om.osds[d].host for d in up}) == 11
    dead = set(mark_down(om))
    moved = [pg for pg in built if built[pg] != down[pg]]
    assert moved and all(dead & set(built[pg][1]) for pg in moved)
    assert all(not dead & set(d for d in down[pg][1] if d is not None)
               for pg in down)
    want = [d for d in PG_TEMP if d not in dead][:3]
    assert temps[(2, 5)][1] == want != temps[(2, 5)][0]
    assert temps[(2, 5)][0] == down[(2, 5)][0]
    assert temps[(1, 3)] == down[(1, 3)]
    assert temps[(2, 9)][1][0] == down[(2, 9)][1][-1]
    changed = [pg for pg in down if down[pg] != temps[pg]]
    assert sorted(changed) == [(2, 5), (2, 9)]



def push(maps, om):
    """``om`` as a receiver adopts it from a full-map push (frozen)."""
    msg = type("Push", (), dict(map_bytes=om.encode_bytes(), inc_bytes=b"",
                                base_epoch=0, epoch=om.epoch))
    return maps.apply_map_push(None, msg)[0]


def test_frozen_maps_place_as_the_reference():
    """A receiver's map (apply_map_push, full and incremental) is frozen
    and shares its up sets with every equal frozen map; every 8th PG of
    both pools, up and acting, is the reference's, on the first call
    and from the shared table, and a caller's edit of a returned set
    does not reach the table."""
    ref_maps = reference()[0]
    ref, port = rich(ref_maps), rich(port_maps)
    full = push(port_maps, port)
    old = build(port_maps)
    msg = type("Push", (), dict(map_bytes=b"", base_epoch=1, epoch=4,
                                inc_bytes=port.diff_from(old).encode_bytes()))
    inc = port_maps.apply_map_push(old, msg)[0]
    assert port._placed is None and old._placed is None
    assert full._placed is not None and inc._placed is full._placed
    for pid, pool in sorted(ref.pools.items()):
        for s in range(0, pool.pg_num, 8):
            for temp in (True, False):
                want = ref.pg_to_up_osds(pid, s, ignore_temp=temp)
                for om in (full, inc, full):
                    got = om.pg_to_up_osds(pid, s, ignore_temp=temp)
                    assert got == want, (pid, s, temp)
                    got.append(-5)
    assert len(full._placed) == 2 * (PG_NUM + REP_PG_NUM) // 8


def test_mutators_and_copies_thaw_a_frozen_map():
    """deepcopy, apply_incremental and every mutator leave a map that
    computes its placements afresh; a map whose placement inputs
    differ gets a table of its own."""
    om = push(port_maps, build(port_maps))
    table = om._placed
    before = om.pg_to_up_osds(1, 0)
    copy = om.deepcopy()
    assert copy._placed is None and om._placed is table
    down = before[0]
    copy.mark_down(down)
    assert copy.pg_to_up_osds(1, 0)[0] != down
    assert om.pg_to_up_osds(1, 0) == before
    other = push(port_maps, copy)
    assert other._placed is not table
    assert other.pg_to_up_osds(1, 0) == copy.pg_to_up_osds(1, 0)
    thawed = push(port_maps, build(port_maps))
    assert thawed._placed is table
    thawed.apply_incremental(copy.diff_from(thawed))
    assert thawed._placed is None
    assert thawed.pg_to_up_osds(1, 0) == copy.pg_to_up_osds(1, 0)
    for mutate in (lambda m: m.mark_up(down), lambda m: m.mark_down(down),
                   lambda m: m.mark_out(down),
                   lambda m: m.add_osd(OSDS, "hostx"),
                   lambda m: m.add_pool(port_maps.PoolSpec(
                       3, "p3", "replicated", 3, 2, 8, {}))):
        m = push(port_maps, build(port_maps))
        mutate(m)
        assert m._placed is None


def test_object_to_pg_parity_for_20000_names():
    rng = np.random.default_rng(SEED)
    names = [f"{rng.integers(1 << 32):08x}.{i:016x}"
             for i in range(OBJECTS)]
    ref, port = build(reference()[0]), build(port_maps)
    for pid in (1, 2):
        ref_pgs = [ref.object_to_pg(pid, n) for n in names]
        assert [port.object_to_pg(pid, n) for n in names] == ref_pgs
        assert [port_placement.pg_of_object(n, port.pools[pid].pg_num)
                for n in names] == ref_pgs
        assert len(set(ref_pgs)) == port.pools[pid].pg_num
