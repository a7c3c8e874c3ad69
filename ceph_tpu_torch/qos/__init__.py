"""Multi-tenant QoS control plane (the dmclock + mclock-profiles role).

Three coupled layers (see README.md in this package):

- ``dmclock.py``  — client-side tag state: a per-tenant ServiceTracker
  stamps outgoing ops with (delta, rho) dmclock tags learned from the
  phase field on op replies, so every OSD can compute correct
  multi-server mclock tags without a global clock;
- ``profiles.py`` — named tenant profiles (reservation/weight/limit
  IOPS) distributed cluster-wide via the OSDMap like pool options;
- ``controller.py`` — the adaptive reservation controller: AIMD with
  hysteresis over observed client p99 queue-wait vs recovery backlog,
  retuning ``osd_mclock_recovery_{res,lim}`` live via ``reset_mclock``.
"""

from .dmclock import (PHASE_NONE, PHASE_RESERVATION, PHASE_WEIGHT,
                      ServiceTracker)
from .profiles import (DEFAULT_TENANT, TenantProfile, params_from_map,
                       parse_profile, profiles_from_map)

__all__ = [
    "PHASE_NONE", "PHASE_RESERVATION", "PHASE_WEIGHT", "ServiceTracker",
    "DEFAULT_TENANT", "TenantProfile", "parse_profile",
    "params_from_map", "profiles_from_map",
]
