"""Deterministic data placement — the CRUSH-equivalent.

The capability of the reference's CRUSH layer (src/crush/mapper.c
crush_do_rule + straw2 buckets; OSDMap::_pg_to_raw_osds
src/osd/OSDMap.cc:2779): a pure function from (map, pg) to an ordered
device list that every client and server computes identically — no lookup
service.  This implementation is straw2-*style* (max of weight-scaled
log-uniform draws, which gives weight-proportional selection and minimal
movement on weight changes) over a two-level tree (root -> failure domains
-> devices), with retry-based collision avoidance.  The hash is splitmix64,
not rjenkins; layouts are NOT wire-compatible with Ceph, deliberately.

Object -> PG uses stable-mod semantics (ceph_stable_mod,
src/include/types.h) so pg_num changes split PGs predictably.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

_M = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M
    return z ^ (z >> 31)


def hash_combine(*parts) -> int:
    h = 0x243F6A8885A308D3
    for p in parts:
        if isinstance(p, str):
            p = int.from_bytes(p.encode("utf-8").ljust(8, b"\0")[:8],
                               "little") ^ (len(p) << 56)
        h = _splitmix64((h ^ p) & _M)
    return h


def stable_mod(x: int, b: int, bmask: int) -> int:
    """ceph_stable_mod semantics: nearest power-of-two split behaviour."""
    return (x & bmask) if (x & bmask) < b else (x & (bmask >> 1))


def pg_of_object(name: str, pg_num: int) -> int:
    """Object name -> pg seed (the ceph_str_hash + stable_mod step)."""
    bmask = (1 << max(pg_num - 1, 1).bit_length()) - 1
    return stable_mod(hash_combine("oid", name) & 0xFFFFFFFF, pg_num, bmask)


@dataclass
class Device:
    id: int
    weight: float = 1.0
    host: str = "host0"


@dataclass
class PlacementMap:
    """Two-level tree: failure domains (hosts) -> devices."""

    devices: dict[int, Device] = field(default_factory=dict)

    def add_device(self, dev_id: int, weight: float = 1.0,
                   host: str | None = None) -> None:
        self.devices[dev_id] = Device(dev_id, weight,
                                      host or f"host{dev_id}")

    def remove_device(self, dev_id: int) -> None:
        self.devices.pop(dev_id, None)

    def hosts(self) -> dict[str, list[Device]]:
        out: dict[str, list[Device]] = {}
        for d in self.devices.values():
            out.setdefault(d.host, []).append(d)
        return out

    # -- straw2-style draws ------------------------------------------------
    @staticmethod
    def _draw(key: int, item: int | str, trial: int, weight: float) -> float:
        if weight <= 0:
            return -math.inf
        u = (hash_combine("straw", key, item, trial) & 0xFFFFFFFF) / 2**32
        u = max(u, 1e-12)
        return math.log(u) / weight  # max over items ~ weighted choice

    def _choose_one(self, key: int, trial: int, items: list,
                    weights: list[float], exclude: set) -> int | str | None:
        best, best_draw = None, -math.inf
        for it, w in zip(items, weights):
            if it in exclude:
                continue
            d = self._draw(key, it, trial, w)
            if d > best_draw:
                best, best_draw = it, d
        return best

    def select(self, key: int, n: int, domain: str = "host",
               reject=None) -> list[int]:
        """Choose n devices for placement key, at most one per failure
        domain when domain='host' (fewer domains than n fall back to
        device-level spreading for the remainder).  `reject(dev_id)` marks
        devices unusable (out); collisions retry with fresh trials, so
        survivors keep their positions when others are rejected."""
        reject = reject or (lambda d: False)
        hosts = self.hosts()
        host_names = sorted(hosts)
        host_w = [sum(d.weight for d in hosts[h]) for h in host_names]
        out: list[int] = []
        used_hosts: set = set()
        used_devs: set = set()
        trial = 0
        max_trials = 50 * max(n, 1)
        while len(out) < n and trial < max_trials:
            if domain == "host" and len(used_hosts) < len(host_names):
                h = self._choose_one(key, trial, host_names, host_w,
                                     used_hosts)
                trial += 1
                if h is None:
                    break
                devs = hosts[h]
                d = self._choose_one(
                    hash_combine(key, h), trial, [x.id for x in devs],
                    [x.weight for x in devs], used_devs)
                if d is None or reject(d):
                    # host exhausted/unusable for this slot; try others
                    used_hosts.add(h)
                    continue
                used_hosts.add(h)
                used_devs.add(d)
                out.append(d)
            else:
                ids = sorted(self.devices)
                d = self._choose_one(key, trial, ids,
                                     [self.devices[i].weight for i in ids],
                                     used_devs)
                trial += 1
                if d is None:
                    break
                used_devs.add(d)
                if not reject(d):
                    out.append(d)
        return out
