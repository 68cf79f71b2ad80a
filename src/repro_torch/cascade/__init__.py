"""Cascade routing: uncertainty-aware multi-leg escalation.

Turns the paper's one-shot routing decision into a sequential one: run a
cheap pool member first, then — if the answer in hand looks inadequate
relative to what a stronger member is predicted to deliver at the extra
cost — escalate up a deterministic cost ladder. Three pieces:

  :mod:`policy`       — stop-vs-escalate expected-marginal-reward rule over
                        quality mean + ensemble std + predicted cost;
  :mod:`coordinator`  — scheduler hook owning per-request cascade state and
                        telemetry-facing stats;
  serving integration — ``MicroBatchScheduler(cascade=...)`` re-admits
                        escalated legs at elevated priority, charges each
                        leg to the budget governor, and finalizes exactly
                        once (see :mod:`repro_torch.serving.scheduler`).

The port of ``repro.cascade``, with its exports.
"""
from repro_torch.cascade.coordinator import CascadeCoordinator
from repro_torch.cascade.policy import (
    CascadeConfig,
    CascadeDecision,
    CascadePolicy,
    cost_ladder,
)

__all__ = [
    "CascadeConfig", "CascadeCoordinator", "CascadeDecision",
    "CascadePolicy", "cost_ladder",
]
