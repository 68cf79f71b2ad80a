"""Rolling cost-budget governor.

The port's own copy of ``repro.serving.budget`` (pure Python).

RouteLLM-style deployments route under a *spend* constraint, not a fixed
lambda: the operator states "at most $B per window" and the router's
willingness-to-pay must adapt to traffic. The governor tracks realized
spend over a rolling window and steers the effective lambda of the
exponential reward R2 = s * exp(-c / lam):

  * over budget  -> shrink lambda (cost penalty grows, traffic shifts to
    cheaper pool members);
  * under budget -> relax lambda back toward the operator's nominal value
    (never beyond it — the budget is a cap, not a quota to burn).

The controller is proportional in log-space: one update scales lambda by
``(high_water / utilization) ** gain`` (floored at ``min_step`` per update),
because lambda spans orders of magnitude (see the paper's lambda grids) and
a fixed decay would need dozens of updates to cross a decade. Relaxation is
a gentler fixed step — tighten fast, recover slowly. The governor is purely
a function of the recorded spend events + the supplied clock, so it is
deterministic and unit-testable without wall time.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Tuple


class BudgetGovernor:
    """Steers the effective lambda to hold spend at/below a $/window budget.

    Args:
      budget: $ allowed per rolling window.
      window_s: rolling window length in (virtual) seconds.
      lam0: operator's nominal willingness-to-pay (upper bound for lam).
      lam_min: floor — even fully over budget the router keeps routing
        (to the cheapest member) instead of dividing by zero.
      gain: log-space proportional gain; 1.0 means a 10x overspend shrinks
        lambda 10x in one update.
      min_step: floor on the per-update shrink factor (limits how violently
        a single window can move lambda).
      decay: relaxation step (0 < decay < 1): when under budget, lambda
        recovers by 1/decay per update, never above lam0.
      high_water / low_water: utilization thresholds (spend / budget) that
        trigger tightening / relaxing.
    """

    def __init__(self, budget: float, window_s: float = 10.0, *,
                 lam0: float = 1.0, lam_min: float = 1e-9,
                 gain: float = 1.0, min_step: float = 0.05,
                 decay: float = 0.7, high_water: float = 1.0,
                 low_water: float = 0.7):
        if budget <= 0:
            raise ValueError("budget must be positive")
        if not 0.0 < decay < 1.0:
            raise ValueError("decay must be in (0, 1)")
        self.budget = budget
        self.window_s = window_s
        self.lam0 = lam0
        self.lam_min = lam_min
        self.gain = gain
        self.min_step = min_step
        self.decay = decay
        self.high_water = high_water
        self.low_water = low_water

        self._events: Deque[Tuple[float, float]] = deque()  # (t, $)
        self._scale = 1.0
        self.total_spend = 0.0
        self.tightened = 0   # adjustment counters (telemetry)
        self.relaxed = 0
        # Last controller verdict (observability: the scheduler's trace
        # emits one "governor" instant per update).
        self.last_action = "hold"
        self.last_utilization = 0.0

    # -- spend accounting ---------------------------------------------------

    def record(self, cost: float, now: float) -> None:
        self._events.append((now, cost))
        self.total_spend += cost

    def _trim(self, now: float) -> None:
        lo = now - self.window_s
        while self._events and self._events[0][0] < lo:
            self._events.popleft()

    def window_spend(self, now: float) -> float:
        self._trim(now)
        return sum(c for _, c in self._events)

    def utilization(self, now: float) -> float:
        return self.window_spend(now) / self.budget

    def headroom(self, now: float) -> float:
        """Budget slack in [0, 1]: 1 = window untouched, 0 = at/over cap.

        The one definition every consumer shares — exploration annealing
        (`OnlineAdapter`) and cascade escalation gating
        (`CascadeCoordinator`) must read the same slack or their
        spend-shedding behaviours drift apart.
        """
        return float(min(max(1.0 - self.utilization(now), 0.0), 1.0))

    # -- control ------------------------------------------------------------

    @property
    def lam(self) -> float:
        return max(self.lam0 * self._scale, self.lam_min)

    def update(self, now: float) -> float:
        """One controller step; call once per scheduler dispatch."""
        u = self.utilization(now)
        self.last_utilization = u
        if u > self.high_water:
            step = (self.high_water / u) ** self.gain
            self._scale *= max(step, self.min_step)
            self.tightened += 1
            self.last_action = "tighten"
        elif u < self.low_water and self._scale < 1.0:
            self._scale = min(self._scale / self.decay, 1.0)
            self.relaxed += 1
            self.last_action = "relax"
        else:
            self.last_action = "hold"
        return self.lam

    def summary(self, now: float) -> Dict[str, float]:
        return {
            "lam": self.lam,
            "lam0": self.lam0,
            "budget_per_window": self.budget,
            "window_spend": self.window_spend(now),
            "utilization": self.utilization(now),
            "total_spend": self.total_spend,
            "tightened": self.tightened,
            "relaxed": self.relaxed,
        }
