"""Authentication + authorization (the cephx role).

- caps.py: capability strings ("allow rw pool=x") parsed into matchers
  enforced at daemon op ingress (ref src/osd/OSDCap.h, src/mon/MonCap.h).
- cephx.py: per-entity keys held by the monitor (AuthMonitor /
  CephxKeyServer role), mon-issued time-limited tickets derived from
  rotating service keys, and per-op proofs bound to a ticket's session
  key (ref src/mon/AuthMonitor.h:35, src/auth/cephx/CephxKeyServer.h:165).
"""

from .caps import Caps, CapsError
from .cephx import (AuthContext, KeyServer, ServiceVerifier, Ticket,
                    op_proof)

__all__ = ["Caps", "CapsError", "KeyServer", "ServiceVerifier",
           "Ticket", "AuthContext", "op_proof"]
