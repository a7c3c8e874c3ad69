"""Named tenant QoS profiles, distributed via the OSDMap.

The mclock-profiles role at tenant granularity: a profile names a
tenant and gives it (reservation, weight, limit) IOPS — the same
triple the per-class scheduler knobs use, but owned by the operator
per tenant and shipped cluster-wide inside the OSDMap (the pg_pool_t
options pattern: commit once on the mon, every daemon converges on the
next map push, no per-OSD config fan-out).

Profile grammar (the `osd qos set-profile` verb and the map wire
form)::

    name:  [a-z0-9_-]{1,32}            # also the exporter label stem
    res:   float >= 0   ops/s guaranteed floor (0 = none)
    wgt:   float >  0   proportional share past the floor
    lim:   float >= 0   ops/s hard ceiling (0 = unlimited)

The string form ``res=50,wgt=4,lim=200`` round-trips through
``parse_profile`` / ``TenantProfile.spec``.  A tenant no profile
names falls into the DEFAULT profile — isolated in its own dynamic
sub-queue, but with the neutral (0, 1, 0) parameters.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

#: the tenant every untagged / unknown-tenant op accounts to
DEFAULT_TENANT = "default"

_NAME_RE = re.compile(r"^[a-z0-9_-]{1,32}$")


@dataclass(frozen=True)
class TenantProfile:
    """One tenant's (R, W, L) in ops/s."""

    name: str
    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0

    def __post_init__(self):
        validate_name(self.name)
        if self.reservation < 0 or self.limit < 0:
            raise ValueError(
                f"profile {self.name!r}: res/lim must be >= 0")
        if self.weight <= 0:
            raise ValueError(f"profile {self.name!r}: wgt must be > 0")

    def spec(self) -> str:
        return (f"res={self.reservation:g},wgt={self.weight:g},"
                f"lim={self.limit:g}")

    def to_dict(self) -> dict:
        """The OSDMap / mon-command wire form."""
        return {"res": float(self.reservation),
                "wgt": float(self.weight), "lim": float(self.limit)}

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "TenantProfile":
        return cls(name, reservation=float(d.get("res", 0.0)),
                   weight=float(d.get("wgt", 1.0)),
                   limit=float(d.get("lim", 0.0)))


def validate_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(
            f"bad tenant name {name!r} (want [a-z0-9_-]{{1,32}})")
    return name


DEFAULT_PROFILE = TenantProfile(DEFAULT_TENANT, 0.0, 1.0, 0.0)


def parse_profile(name: str, spec: str) -> TenantProfile:
    """``res=50,wgt=4,lim=200`` -> TenantProfile (missing keys keep
    their defaults; unknown keys are an error, not silence)."""
    kw = {"res": 0.0, "wgt": 1.0, "lim": 0.0}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in kw:
            raise ValueError(f"unknown profile key {k!r} "
                             f"(want res/wgt/lim)")
        try:
            kw[k] = float(v)
        except ValueError:
            raise ValueError(f"profile key {k}={v!r} is not a number") \
                from None
    return TenantProfile(name, reservation=kw["res"], weight=kw["wgt"],
                         limit=kw["lim"])


def profiles_from_map(qos_profiles: dict) -> dict[str, TenantProfile]:
    """OSDMap.qos_profiles ({name: {res, wgt, lim}}) -> profile
    objects; malformed entries degrade to the default parameters
    instead of raising (a bad map entry must not take a daemon down)."""
    out: dict[str, TenantProfile] = {}
    for name, d in (qos_profiles or {}).items():
        try:
            out[name] = TenantProfile.from_dict(name, dict(d))
        except (TypeError, ValueError):
            try:
                out[name] = TenantProfile(name)
            except ValueError:
                continue  # unusable name: skip entirely
    return out


def params_from_map(qos_profiles: dict) -> dict:
    """OSDMap.qos_profiles -> {tenant: ClassParams} for the scheduler
    (the import lives here so the scheduler module stays the only
    importer of ClassParams in this direction)."""
    from ..osd.scheduler import ClassParams
    return {name: ClassParams(p.reservation, p.weight, p.limit)
            for name, p in profiles_from_map(qos_profiles).items()}
