"""Cascade coordinator: the scheduler-side hook driving multi-leg requests.

The micro-batching scheduler stays a single-leg machine; this object owns
everything cascade-specific around it:

  * at the **scoring step** it pins each request's predicted quality mean /
    ensemble std / cost rows onto the request (``note_scores``), so the
    escalation decision at leg completion replays against exactly what the
    router believed when the leg was dispatched — no re-scoring race with
    online router swaps;
  * at **leg completion** (``on_leg_complete``) it resolves the leg's
    quality — observed feedback when the deployment has it (RouterBench
    logs responses; the simulator's truth tables stand in), the router's
    estimate otherwise — maintains the request's best-answer-so-far under
    keep-best semantics, and asks the :class:`CascadePolicy` whether the
    expected marginal reward of the next ladder rung justifies another
    leg. Returns the rung to escalate to, or ``None`` to finalize.

The scheduler charges every leg's generate call to the budget governor as
it happens, so a cascade's *cumulative* cost hits the $/window ledger leg
by leg — a cascade can tighten lambda mid-flight, and the policy sees the
tightened lambda (and shrinking headroom) on its next decision.

The port of ``repro.cascade.coordinator``, a copy: pure host code over the
port's scheduler and :class:`CascadePolicy`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.cascade.policy import CascadeDecision, CascadePolicy


class CascadeCoordinator:
    """Per-run cascade state machine over :class:`CascadePolicy`.

    ``observed_quality(request) -> float | None`` supplies post-hoc quality
    feedback for a completed leg when the deployment has one (user rating,
    auto-eval, simulator truth); ``None`` falls back to the router's
    predicted mean for that member — the policy then discounts it by the
    ensemble disagreement.
    """

    def __init__(self, policy: CascadePolicy, *,
                 observed_quality: Optional[Callable] = None,
                 governor=None):
        self.policy = policy
        self.observed_quality = observed_quality
        self.governor = governor
        # Observability hook (the obs layer): one "cascade_decision" instant
        # per completed leg, carrying the policy's expected-marginal-reward
        # inputs. Installed by the scheduler.
        self.tracer = None
        self.stats: Dict[str, float] = {
            "legs": 0, "escalations": 0, "finalized": 0,
            "observed_legs": 0, "estimated_legs": 0,
            "headroom_blocked": 0, "cache_stops": 0,
        }
        # Escalation counts indexed by the leg that triggered them
        # (leg 1 -> leg 2 escalations live at index 0, etc.).
        self.escalations_by_leg: List[int] = []

    def headroom(self, now: float) -> float:
        if self.governor is None:
            return 1.0
        return self.governor.headroom(now)

    # -- scoring-step hook ---------------------------------------------------

    def note_scores(self, batch, s_hat: np.ndarray, s_std: np.ndarray,
                    c_hat: np.ndarray) -> None:
        """Pin this round's per-request prediction rows onto the requests."""
        for r, s, sd, c in zip(batch, s_hat, s_std, c_hat):
            r.s_pred = np.asarray(s)
            r.s_std_pred = np.asarray(sd)
            r.c_pred = np.asarray(c)

    # -- leg-completion hook -------------------------------------------------

    def on_leg_complete(self, r, lam: float, now: float) -> Optional[int]:
        """Decide the completed leg's fate; returns the next member or None.

        The scheduler has already appended the leg to ``r.tried`` /
        ``r.leg_costs`` and accumulated ``r.cum_cost`` before calling this.
        """
        self.stats["legs"] += 1
        member = int(r.member)
        s_obs = (self.observed_quality(r)
                 if self.observed_quality is not None else None)
        observed = s_obs is not None
        self.stats["observed_legs" if observed else "estimated_legs"] += 1
        s_cur = float(s_obs) if observed else float(r.s_pred[member])
        s_std_cur = 0.0 if observed else float(r.s_std_pred[member])
        r.leg_quality.append(s_cur)
        # Keep-best: the answer in hand is the best leg seen so far,
        # compared on disagreement-discounted value (an estimate's value
        # is its mean minus gamma * ensemble std; observed feedback has no
        # epistemic spread) — so a verified 0.7 beats a 0.75 the heads
        # can't agree on, and legs with mixed feedback compare fairly.
        gamma = self.policy.config.gamma
        cur_eff = s_cur - gamma * s_std_cur
        best_eff = r.best_q - gamma * r.best_q_std
        if not np.isfinite(r.best_q) or cur_eff >= best_eff:
            r.best_q = s_cur
            r.best_q_std = s_std_cur
            r.best_member = member
            r.best_observed = observed
            r.best_output = r.output

        hr = self.headroom(now)
        decision: CascadeDecision = self.policy.decide(
            s_cur=r.best_q, s_std_cur=r.best_q_std,
            s_hat=r.s_pred, s_std=r.s_std_pred, c_hat=r.c_pred,
            cum_cost=r.cum_cost, tried=r.tried, lam=lam,
            observed=r.best_observed, headroom=hr,
        )
        if (not decision.escalate and hr < self.policy.config.min_headroom
                and len(r.tried) < self.policy.config.max_legs):
            # Attribute the stop to the budget gate only when the policy
            # WOULD have escalated with full headroom — a leg that would
            # have stopped anyway (answer already good enough) is not a
            # budget-suppressed escalation.
            ungated = self.policy.decide(
                s_cur=r.best_q, s_std_cur=r.best_q_std,
                s_hat=r.s_pred, s_std=r.s_std_pred, c_hat=r.c_pred,
                cum_cost=r.cum_cost, tried=r.tried, lam=lam,
                observed=r.best_observed, headroom=1.0,
            )
            if ungated.escalate:
                self.stats["headroom_blocked"] += 1
        if self.tracer is not None:
            self.tracer.instant(
                "cascade_decision", "cascade", now, key=r.trace_key,
                args={"leg": len(r.tried),
                      "escalate": bool(decision.escalate),
                      "next_member": (int(decision.next_member)
                                      if decision.escalate else None),
                      "expected_gain": float(decision.expected_gain),
                      "best_q": float(r.best_q),
                      "best_q_std": float(r.best_q_std),
                      "observed": bool(r.best_observed),
                      "cum_cost": float(r.cum_cost),
                      "lam": float(lam), "headroom": float(hr)})
        if not decision.escalate:
            self.stats["finalized"] += 1
            return None
        leg_idx = len(r.tried) - 1
        while len(self.escalations_by_leg) <= leg_idx:
            self.escalations_by_leg.append(0)
        self.escalations_by_leg[leg_idx] += 1
        self.stats["escalations"] += 1
        return int(decision.next_member)

    def on_rescued(self, r) -> None:
        """A deadline hit mid-cascade finalized the request with its
        best-so-far answer (scheduler rescue path) — account for it so
        ``finalized`` tracks the telemetry completion count and the
        escalation rate stays honest."""
        self.stats["finalized"] += 1

    def on_cache_served(self, r) -> None:
        """Rung 0 stopped: a semantic-cache hit finalized the request
        without entering the real ladder. Counted as a finalization (the
        request is done) but not as a leg — no pool member ran."""
        self.stats["finalized"] += 1
        self.stats["cache_stops"] += 1

    # -- reporting -----------------------------------------------------------

    @property
    def escalation_rate(self) -> float:
        """Escalations per finalized request (0 when nothing finalized)."""
        done = self.stats["finalized"]
        return float(self.stats["escalations"] / done) if done else 0.0

    def report(self) -> str:
        s = self.stats
        by_leg = " ".join(f"L{i + 1}->L{i + 2}:{n}"
                          for i, n in enumerate(self.escalations_by_leg))
        return (
            f"cascade: legs {int(s['legs'])}  "
            f"escalations {int(s['escalations'])} ({by_leg or 'none'})  "
            f"finalized {int(s['finalized'])}  "
            f"rate {self.escalation_rate:.3f}  "
            f"quality signal observed/estimated "
            f"{int(s['observed_legs'])}/{int(s['estimated_legs'])}  "
            f"headroom-blocked {int(s['headroom_blocked'])}  "
            f"cache-stops {int(s['cache_stops'])}"
        )
