"""Uncertainty-aware escalation policy: stop vs. escalate, one leg at a time.

RouterBench (arXiv:2403.12031) shows *cascading* — try a cheap model,
escalate only when the response looks inadequate — dominates parts of the
cost-quality frontier no single-shot policy can reach, and RouteLLM
(arXiv:2406.18665) frames routing as exactly this strong/weak escalation
decision under a confidence threshold. The paper's router already predicts
per-model quality AND cost; with the deep-ensemble quality head
(``attn-ens``) it also reports *epistemic* uncertainty. That triple is what
a principled escalation rule needs:

  * **ladder** — a deterministic member ordering cheapest -> strongest,
    derived from the router's cost scaler (the per-member mean cost the
    offline cost trainer normalized against). Escalation only ever climbs
    the ladder, so a cascade terminates in at most K legs.
  * **stop value** — the reward of keeping the best answer so far at the
    cascade's *cumulative* cost. When the current leg's quality is only
    estimated (no observed feedback), ensemble disagreement discounts it:
    an answer the heads disagree about is a weaker reason to stop.
  * **escalation value** — for each untried rung above the current one,
    the reward of the optimistic (mean + beta * std) quality at cumulative
    cost + that rung's predicted cost. Optimism in the face of epistemic
    uncertainty makes the policy explore rungs the router is unsure about,
    exactly where a second opinion is worth buying.

Escalate when the best rung's expected *marginal* reward clears ``margin``
(and the budget governor still has headroom); otherwise stop. The rule is
reward-shape generic — both ``R1 = s - c/lam`` (linear) and
``R2 = s * exp(-c/lam)`` (exponential) plug in — and is a pure function of
its inputs, so decisions replay deterministically.

The port of ``repro.cascade.policy``: host numpy and Python floats, as in
the reference. Rewards are the port's ``REWARDS`` on Python floats, which
round as the reference's do on ``np.float64`` scalars: R1 in float64, R2's
``exp`` and product in float32 with subnormals flushed.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.rewards import REWARDS


def cost_ladder(router, c_hat: Optional[np.ndarray] = None) -> np.ndarray:
    """Member indices cheapest -> strongest (ascending expected cost).

    The ladder comes from the router's cost scaler: ``mu`` is each member's
    mean training cost, the stable, lambda-free ordering the offline cost
    trainer already established. Routers without a per-member scaler (e.g.
    hand-built test stubs) fall back to the mean of a predicted cost matrix
    ``c_hat`` (B, K) when supplied.
    """
    scaler = getattr(router, "cost_scaler", None)
    if scaler is not None and np.ndim(scaler["mu"]) == 1:
        mu = np.asarray(scaler["mu"], np.float64)
    elif c_hat is not None:
        mu = np.asarray(c_hat, np.float64).mean(axis=0)
    else:
        raise ValueError(
            "cost_ladder needs a per-member cost scaler on the router "
            "or a predicted cost matrix to derive the ladder from")
    return np.argsort(mu, kind="stable")


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    max_legs: int = 3          # hard cap on legs per request (>= 1)
    beta: float = 1.0          # optimism width on untried rungs (UCB)
    gamma: float = 1.0         # disagreement discount on the stop value
    margin: float = 0.0        # required expected marginal reward to escalate
    min_headroom: float = 0.0  # below this budget headroom, never escalate


class CascadeDecision(NamedTuple):
    escalate: bool
    next_member: int           # ladder rung to run next (-1 when stopping)
    expected_gain: float       # best rung's expected marginal reward


class CascadePolicy:
    """Expected-marginal-reward stop-vs-escalate rule over a cost ladder."""

    def __init__(self, ladder: Sequence[int],
                 config: Optional[CascadeConfig] = None,
                 reward: str = "R2"):
        self.ladder = [int(m) for m in ladder]
        self.config = config or CascadeConfig()
        if reward not in REWARDS:
            raise ValueError(f"unknown reward {reward!r}")
        self.reward = reward
        self._rank = {m: i for i, m in enumerate(self.ladder)}

    def refresh(self, router) -> bool:
        """Re-derive the ladder after a hot pool mutation.

        ``add_member`` / ``remove_member`` change the pool's member-index
        space while the policy's ladder still ranks the *old* members —
        a freshly added member could never be escalated to, and a removed
        member's stale rung could be selected. Called by the scheduler
        every dispatch round (next to the telemetry member re-sync); a
        no-op unless the router's member count disagrees with the ladder
        length, so unmutated pools pay one integer compare. Routers
        without a per-member cost scaler (hand-built stubs) are left
        alone. Returns True when the ladder was rebuilt.
        """
        scaler = getattr(router, "cost_scaler", None)
        if scaler is None or np.ndim(scaler.get("mu")) != 1:
            return False
        if len(scaler["mu"]) == len(self.ladder):
            return False
        try:
            ladder = cost_ladder(router)
        except ValueError:
            return False
        self.ladder = [int(m) for m in ladder]
        self._rank = {m: i for i, m in enumerate(self.ladder)}
        return True

    def _reward(self, s: float, c: float, lam: float) -> float:
        return float(REWARDS[self.reward](float(s), float(c), lam))

    def candidates(self, tried: Sequence[int]) -> list:
        """Untried rungs strictly above the highest rung already run."""
        if not tried:
            return list(self.ladder)
        top = max(self._rank.get(int(m), -1) for m in tried)
        return [m for m in self.ladder[top + 1:] if m not in set(tried)]

    def decide(self, *, s_cur: float, s_std_cur: float,
               s_hat: np.ndarray, s_std: np.ndarray, c_hat: np.ndarray,
               cum_cost: float, tried: Sequence[int], lam: float,
               observed: bool = False,
               headroom: float = 1.0) -> CascadeDecision:
        """One stop-vs-escalate decision after a completed leg.

        Args:
          s_cur: quality of the best answer so far — observed feedback when
            available (``observed=True``), else the router's mean estimate.
          s_std_cur: ensemble disagreement on ``s_cur`` (ignored when
            observed — ground truth has no epistemic spread).
          s_hat / s_std / c_hat: per-member (K,) mean quality, quality std,
            and predicted cost rows for this query.
          cum_cost: $ already spent on this request across all legs.
          tried: member indices already run (leg order irrelevant).
          lam: effective willingness-to-pay (post-governor).
          headroom: budget-governor slack in [0, 1]; under
            ``min_headroom`` the cascade never escalates (spend-shedding
            composes with the governor's lambda tightening).
        """
        cfg = self.config
        if len(tried) >= cfg.max_legs or headroom < cfg.min_headroom:
            return CascadeDecision(False, -1, 0.0)
        s_keep = float(s_cur)
        if not observed:
            s_keep -= cfg.gamma * float(s_std_cur)
        v_stop = self._reward(s_keep, cum_cost, lam)
        best_gain, best_m = -np.inf, -1
        for m in self.candidates(tried):
            s_up = min(float(s_hat[m]) + cfg.beta * float(s_std[m]), 1.0)
            # Keep-best semantics: escalating can only add cost, never
            # lose the answer already in hand.
            v_esc = self._reward(max(s_keep, s_up),
                                 cum_cost + max(float(c_hat[m]), 0.0), lam)
            gain = v_esc - v_stop
            if gain > best_gain:
                best_gain, best_m = gain, m
        if best_m < 0 or best_gain <= cfg.margin:
            return CascadeDecision(False, -1,
                                   best_gain if np.isfinite(best_gain)
                                   else 0.0)
        return CascadeDecision(True, best_m, best_gain)

    def decide_rung0(self, *, q_cache: float, sigma_cache: float,
                     s_hat: np.ndarray, s_std: np.ndarray,
                     c_hat: np.ndarray, lam: float,
                     headroom: float = 1.0) -> CascadeDecision:
        """Semantic-cache rung 0: keep the cached answer or enter the ladder.

        A cache hit is a zero-marginal-cost leg with nothing tried yet:
        the stop value is the reward of the cached answer's quality
        (discounted by the distance-derived confidence spread
        ``sigma_cache``, exactly like ensemble disagreement on an
        estimated leg) at ``cum_cost = 0``; escalation candidates are the
        whole ladder at their predicted costs. Escalating "falls through"
        the cache — the request is then scored and routed normally.
        """
        return self.decide(
            s_cur=q_cache, s_std_cur=sigma_cache, s_hat=s_hat,
            s_std=s_std, c_hat=c_hat, cum_cost=0.0, tried=(),
            lam=lam, observed=False, headroom=headroom)
