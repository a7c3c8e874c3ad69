"""The port's deployment tool (ceph_tpu_torch.tools.cephadm): the cases
of the JAX package's tests/test_rolling_restart.py on the port, its OSD
children the port's ``tools.osd_main`` processes, started with no card
(``device="cpu"``)."""

import threading
import time

import numpy as np
import pytest

from ceph_tpu_torch.tools.cephadm import CephAdm

# -- the cases of tests/test_rolling_restart.py -------------------------------
RNG = np.random.default_rng(31)


@pytest.fixture
def adm(tmp_path):
    spec = {"osds": [{"id": i, "store": "filestore"}
                     for i in range(4)],
            "pools": [{"name": "up", "size": 2, "pg_num": 8}]}
    # a loaded CI box can stall a child interpreter past a 2s grace,
    # and the resulting down/up flap cascades re-peer everything for
    # minutes — use a grace that tolerates scheduler starvation
    a = CephAdm(spec, str(tmp_path),
                cfg_overrides={"osd_heartbeat_grace": 5.0},
                device="cpu").deploy()
    yield a
    a.teardown()


def test_deploy_and_inventory(adm):
    inv = adm.ls()
    assert [d["daemon"] for d in inv] == \
        ["mon.0", "osd.0", "osd.1", "osd.2", "osd.3"]
    assert all(d["state"] == "running" for d in inv)
    assert all(d["up"] for d in inv if d["type"] == "osd")


def test_rolling_restart_under_load(adm):
    """THE upgrade acceptance test: write before, keep writing DURING
    the staircase, verify everything after — no lost object, no
    client-visible downtime beyond op retries."""
    client = adm.cluster.client()
    objs = {}
    for i in range(12):
        data = RNG.integers(0, 256, 8_000, dtype=np.uint8).tobytes()
        objs[f"pre{i}"] = data
        client.write_full("up", f"pre{i}", data)

    stop = threading.Event()
    errors: list[Exception] = []
    written_during: dict[str, bytes] = {}

    def loader():
        i = 0
        wclient = adm.cluster.client()
        while not stop.is_set():
            name = f"live{i}"
            data = bytes([i % 256]) * 2_000
            # the availability contract allows op RETRIES during the
            # degraded window (a size=2 PG blocks writes while its
            # restarting member is down); what may never happen is an
            # acked write failing to read back
            for attempt in range(4):
                try:
                    wclient.write_full("up", name, data)
                    break
                except Exception as e:  # noqa: BLE001
                    if stop.is_set():
                        # an UNACKED write failing while the test tears
                        # down is within contract — don't record it
                        return
                    if attempt == 3:
                        errors.append(e)
                        return
                    time.sleep(0.5)
            try:
                assert wclient.read("up", name) == data
                written_during[name] = data
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return
            i += 1
            time.sleep(0.05)

    t = threading.Thread(target=loader, daemon=True)
    t.start()
    try:
        order = adm.rolling_restart()
    finally:
        stop.set()
        t.join(timeout=30)
    assert order == [0, 1, 2, 3]
    assert not errors, f"client IO failed mid-upgrade: {errors[0]!r}"
    assert written_during, "loader never completed a write"
    # every object — pre-existing and written mid-staircase — survives.
    # Post-staircase recovery finishes on its own schedule: poll, and
    # only a PERMANENTLY unreadable object fails
    expect = {**objs, **written_during}
    deadline = time.time() + 30
    remaining = dict(expect)
    errs: dict = {}
    while remaining and time.time() < deadline:
        for name in list(remaining):
            try:
                if client.read("up", name) == remaining[name]:
                    del remaining[name]
            except Exception as e:  # noqa: BLE001 - still recovering
                errs[name] = repr(e)[:70]
        if remaining:
            time.sleep(0.3)
    if remaining:
        pid = client._pool_id("up")
        detail = {n: (client.osdmap.object_to_pg(pid, n),
                      client.osdmap.pg_to_up_osds(
                          pid, client.osdmap.object_to_pg(pid, n)),
                      errs.get(n)) for n in sorted(remaining)[:6]}
        raise AssertionError(f"stuck: {detail}")
    assert client.scrub_pool("up", deep=True) == []
    inv = adm.ls()
    assert all(d["state"] == "running" for d in inv)
