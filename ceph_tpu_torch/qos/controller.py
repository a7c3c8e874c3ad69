r"""Adaptive recovery-reservation controller (AIMD with hysteresis).

Closes the loop between two facts: the recovery reservation/limit
knob moves recovery rate and client p99 in opposite directions, and
``metrics_query`` gives windowed ``mclock_qwait_us_client`` p99 — this
controller reads the observed tails and turns the knob itself,
retuning ``osd_mclock_recovery_{res,lim}`` live through the existing
``reset_mclock`` verb.

State machine (one ``observe()`` call per mgr tick)::

          p99 > high for `hold` ticks
    STEADY ------------------------------>  BACKOFF  (res *= backoff)
      ^  \                                      |
      |   \  backlog & p99 < low for `hold`     |  cooldown ticks
      |    ------------------------------> GROW |
      |          (res += step)                  |
      +-----------------------------------------+

- **Additive increase**: recovery has backlog and clients are
  comfortably under the low watermark -> raise the reservation one
  ``step`` (recovery drains faster while there is headroom).
- **Multiplicative decrease**: client p99 queue-wait crosses the high
  watermark -> cut the reservation by ``backoff`` (clients win ties).
- **Hysteresis**: a condition must hold ``hold`` consecutive ticks
  before acting, and every apply starts a ``cooldown`` during which no
  further move happens — one noisy window cannot saw the knob.
- **Clamps**: res stays inside [res_min, res_max] (the hand-tuned
  sweep's endpoints); the limit follows as ``res * lim_factor``.

The class is pure decision logic — no cluster access — so the AIMD
steps, hysteresis and clamps unit-test deterministically; the mgr
``qos`` module (mon/mgr.py) owns the sensing (metrics_query windows,
recovery backlog) and the actuation (config set + reset_mclock +
``qos`` cluster-log events).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ControllerKnobs:
    """Tuning surface (seeded from qos_controller_* config options)."""

    res_min: float = 4.0        # the hand-tuned sweep's low endpoint
    res_max: float = 128.0      # ... and its high endpoint
    step: float = 8.0           # additive increase (ops/s)
    backoff: float = 0.5        # multiplicative decrease factor
    p99_low_us: float = 20_000.0   # grow only below this client p99
    p99_high_us: float = 100_000.0  # back off above this client p99
    hold: int = 2               # consecutive ticks before acting
    cooldown: int = 2           # ticks of silence after an apply
    lim_factor: float = 2.0     # limit = res * lim_factor (0 = no lim)
    burn_high: float = 2.0      # slo sense: back off above this burn
    burn_low: float = 0.5       # slo sense: grow only below this burn


@dataclass
class Retune:
    """One applied move (the journal row of a ``qos`` cluster event)."""

    tick: int
    res: float
    lim: float
    reason: str                  # "grow" | "backoff"
    p99_us: float | None = None
    backlog: int = 0
    burn: float | None = None    # slo sense: fast-window burn at retune


class ReservationController:
    """AIMD recovery-reservation controller; call ``observe`` once per
    tick with the sensed cluster state, apply the returned (res, lim)
    when non-None."""

    def __init__(self, knobs: ControllerKnobs | None = None,
                 res0: float | None = None):
        self.knobs = knobs or ControllerKnobs()
        k = self.knobs
        self.res = min(k.res_max,
                       max(k.res_min, res0 if res0 is not None
                           else k.res_min))
        self._tick = 0
        self._hot = 0            # consecutive over-high ticks
        self._cold = 0           # consecutive grow-eligible ticks
        self._cooldown = 0
        self.history: list[Retune] = []

    # ------------------------------------------------------------ stepping
    def limit(self, res: float | None = None) -> float:
        k = self.knobs
        r = self.res if res is None else res
        return r * k.lim_factor if k.lim_factor > 0 else 0.0

    def observe(self, p99_us: float | None, backlog: int,
                recovery_active: bool) -> tuple[float, float] | None:
        """One tick.  ``p99_us``: worst client queue-wait p99 across
        daemons over the sensing window (None = no samples yet);
        ``backlog``: queued recovery items cluster-wide;
        ``recovery_active``: a storm is live (progress items open).
        Returns (res, lim) when a retune should be applied."""
        k = self.knobs
        hot = p99_us is not None and p99_us > k.p99_high_us
        cold = ((p99_us is None or p99_us < k.p99_low_us)
                and (recovery_active or backlog > 0))
        return self._step(hot, cold, p99_us, backlog, None)

    def observe_burn(self, burn_fast: float | None, backlog: int,
                     recovery_active: bool,
                     p99_us: float | None = None
                     ) -> tuple[float, float] | None:
        """One tick sensing on SLO burn instead of raw p99: back off
        when the fast-window error-budget burn exceeds ``burn_high``
        (the budget is being eaten faster than the objective allows),
        grow only when burn is comfortably under ``burn_low`` and
        recovery wants headroom.  ``burn_fast`` None = SLO module has
        no samples yet -> treated like quiet (grow-eligible when
        backlog exists), matching ``observe``'s no-samples stance."""
        k = self.knobs
        hot = burn_fast is not None and burn_fast > k.burn_high
        cold = ((burn_fast is None or burn_fast < k.burn_low)
                and (recovery_active or backlog > 0))
        return self._step(hot, cold, p99_us, backlog, burn_fast)

    def _step(self, hot: bool, cold: bool, p99_us, backlog,
              burn) -> tuple[float, float] | None:
        k = self.knobs
        self._tick += 1
        # hysteresis counters advance even through cooldown, so a
        # persistent condition acts the instant the cooldown lifts
        if hot:
            self._hot += 1
            self._cold = 0
        elif cold:
            self._cold += 1
            self._hot = 0
        else:
            self._hot = self._cold = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        if self._hot >= k.hold and self.res > k.res_min:
            self.res = max(k.res_min, self.res * k.backoff)
            return self._applied("backoff", p99_us, backlog, burn)
        if self._cold >= k.hold and self.res < k.res_max:
            self.res = min(k.res_max, self.res + k.step)
            return self._applied("grow", p99_us, backlog, burn)
        return None

    def _applied(self, reason: str, p99_us, backlog, burn=None
                 ) -> tuple[float, float]:
        lim = self.limit()
        self.history.append(Retune(self._tick, self.res, lim, reason,
                                   p99_us, int(backlog),
                                   None if burn is None else float(burn)))
        self._cooldown = self.knobs.cooldown
        self._hot = self._cold = 0
        return self.res, lim

    # -------------------------------------------------------- introspection
    def retunes(self) -> int:
        return len(self.history)

    def convergence_error(self) -> float:
        """Relative size of the last move — the bench row's
        "controller convergence error" (0.0 until two retunes exist)."""
        if len(self.history) < 2:
            return 0.0
        a, b = self.history[-2].res, self.history[-1].res
        return abs(b - a) / max(b, 1e-9)

    def converged_between(self, lo: float | None = None,
                          hi: float | None = None) -> bool:
        """The tenant-suite gate: the controller MOVED (>= 1 retune)
        and landed strictly above the low hand-tuned sweep point and
        at-or-under the high one."""
        k = self.knobs
        lo = k.res_min if lo is None else lo
        hi = k.res_max if hi is None else hi
        return bool(self.history) and lo < self.res <= hi

    def status(self) -> dict:
        return {
            "res": self.res, "lim": self.limit(),
            "tick": self._tick, "retunes": self.retunes(),
            "cooldown": self._cooldown,
            "convergence_error": round(self.convergence_error(), 4),
            "history": [
                {"tick": r.tick, "res": r.res, "lim": r.lim,
                 "reason": r.reason, "p99_us": r.p99_us,
                 "backlog": r.backlog,
                 **({"burn": r.burn} if r.burn is not None else {})}
                for r in self.history],
        }
