"""SLO layer: latency objectives over the in-cluster metrics history.

``objectives.py`` is the pure half — the objective grammar
(``client_op_p99<=20ms@99%``), pow-2 bucket bad-fraction math, and
multiwindow burn-rate evaluation.  The mgr ``slo`` module
(mon/mgr.py) hosts it: each tick it evaluates every configured
objective over a fast and a slow ``metrics_query`` window and drives
the ``SLO_BURN`` health check through the monitor's health mux, with
the worst bucket's exemplar trace_ids riding in the detail.
"""

from .objectives import (Objective, bad_fraction, burn_rate,
                         evaluate_objective, parse_objective,
                         parse_objectives)

__all__ = ["Objective", "bad_fraction", "burn_rate",
           "evaluate_objective", "parse_objective", "parse_objectives"]
