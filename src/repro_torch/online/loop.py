"""OnlineAdapter: the feedback loop closing serve -> observe -> learn.

Sits between the micro-batching scheduler and the online machinery:

  * at the **scoring step** it replaces the plain reward argmax with the
    exploration policy (epsilon annealed by budget-governor headroom,
    optimistic bonus, probation masking);
  * on **served outcomes** it fills the replay buffer, advances hot-member
    probation, feeds the drift detector, and schedules bounded incremental
    updates — a drift alarm triggers a concentrated burst plus a detector
    re-anchor (recovery), steady state updates every ``update_every``
    outcomes;
  * every update **publishes** a new router version through the engine's
    atomic swap.

The quality feedback signal is a caller-supplied
``quality_feedback(request) -> float in [0, 1]`` — a user rating, an
auto-eval, or (in the simulator) the synthetic RouterBench truth. It may
return **None** for feedback that has not arrived yet: the outcome is then
*staged* (``repro_torch.online.staging``) instead of trained on a placeholder,
and committed when the real score lands via :meth:`deliver_feedback` and
the next :meth:`tick` — out-of-order tolerant, timeout-dropped.

Two roles: a **solo** adapter runs its own ``IncrementalUpdater`` (the
default); a **follower** (``defer_updates=True``, used by the multi-worker
plane, a later slice of the port) only collects outcomes into its local
replay — the leader's coordinator merges replays, runs the bounded update
steps, and broadcasts versioned routers back. A follower's drift alarm
raises ``pending_burst`` for the coordinator instead of bursting locally.

Determinism: policy and replay own seeded generators, staged outcomes flush
in staged order, and the scheduler drives everything from the virtual
clock, so a fixed seed replays the whole adapt cycle identically (tested in
tests/test_online.py).

The port of ``repro.online.loop``. Scoring goes through the engine (the
``router_xattn`` kernel on the card, again after every swap), the drift
detector's distances through ``pairwise_l2``, and the update steps
through the port's masked predictor step on the router's device; the
rest is the reference's host numpy. Rewards for the exploration policy
are :func:`repro_torch.core.rewards.reward_matrix`, the reference's
``REWARDS`` on numpy score rows rounded as it rounds them, so choices
agree near ties.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.rewards import reward_matrix
from repro_torch.online.drift import DriftDetector
from repro_torch.online.exploration import ExplorationConfig, ExplorationPolicy
from repro_torch.online.membership import MembershipTracker
from repro_torch.online.replay import ReplayBuffer
from repro_torch.online.staging import OutcomeStage
from repro_torch.online.updater import IncrementalUpdater, OnlineUpdateConfig


class OnlineAdapter:
    def __init__(self, engine, quality_feedback: Callable[[object], object],
                 *, governor=None,
                 config: Optional[OnlineUpdateConfig] = None,
                 exploration: Optional[ExplorationConfig] = None,
                 replay: Optional[ReplayBuffer] = None,
                 drift: Optional[DriftDetector] = None,
                 membership: Optional[MembershipTracker] = None,
                 updater: Optional[IncrementalUpdater] = None,
                 stage: Optional[OutcomeStage] = None,
                 feedback_source=None,
                 defer_updates: bool = False,
                 seed: int = 0):
        self.engine = engine
        self.quality_feedback = quality_feedback
        self.governor = governor
        self.config = config or OnlineUpdateConfig()
        # `is None` checks: ReplayBuffer/OutcomeStage define __len__, so a
        # freshly-constructed (empty) instance is falsy under `or`.
        self.replay = ReplayBuffer(seed=seed) if replay is None else replay
        self.drift = drift   # None disables drift detection
        self.membership = membership or MembershipTracker(engine)
        self.policy = ExplorationPolicy(
            len(engine.pool), exploration or ExplorationConfig(seed=seed))
        self.updater = updater or IncrementalUpdater(engine.router,
                                                     self.config)
        self.stage = OutcomeStage() if stage is None else stage
        # Optional pull-based feedback channel: ``due(now) -> [(rid, s)]``
        # drained on every tick (see repro_torch.online.staging.DelayedFeedback).
        self.feedback_source = feedback_source
        # Follower mode (multi-worker plane): never run local update steps;
        # drift alarms raise ``pending_burst`` for the coordinator instead.
        self.defer_updates = defer_updates
        self.pending_burst = False
        self._since_update = 0
        # Observability hook (the obs layer): observe/drift/update events.
        # Installed by the scheduler; None = no tracing overhead.
        self.tracer = None
        self.last_explored = np.zeros(0, bool)   # per-request, last batch
        self.stats: Dict[str, float] = {
            "outcomes": 0, "explored": 0, "updates": 0, "update_steps": 0,
            "bursts": 0, "drift_alarms": 0, "router_swaps": 0,
            "members_added": 0, "members_removed": 0,
            "staged": 0, "delayed_resolved": 0, "feedback_expired": 0,
            "last_quality_loss": float("nan"),
            "last_cost_loss": float("nan"),
        }

    # -- scoring-step hook ---------------------------------------------------

    def headroom(self, now: float) -> float:
        """Budget slack in [0, 1] annealing exploration (1 = no governor)."""
        if self.governor is None:
            return 1.0
        return self.governor.headroom(now)

    def choose(self, s_hat: np.ndarray, c_hat: np.ndarray, lam: float,
               now: float = 0.0) -> np.ndarray:
        """Exploration-aware routing for one score batch (scheduler hook)."""
        rewards = reward_matrix(self.engine.router.reward, s_hat, c_hat, lam)
        choices, explored = self.policy.choose(
            rewards, self.membership.exploit_mask(), self.headroom(now))
        self.last_explored = explored
        self.stats["explored"] += int(explored.sum())
        return choices

    # -- outcome hooks -------------------------------------------------------

    def observe(self, served: List, now: float = 0.0) -> None:
        """Fold one dispatch round's served requests into the loop.

        Requests whose feedback is immediate commit right away; the rest
        are staged until :meth:`deliver_feedback` resolves them.
        """
        ready: List[Tuple[object, float]] = []
        n_staged = 0
        for r in served:
            if getattr(r, "q_emb", None) is None or r.member < 0:
                continue
            s_obs = self.quality_feedback(r)
            if s_obs is None:
                self.stage.stage(r, now)
                self.stats["staged"] += 1
                n_staged += 1
            else:
                ready.append((r, float(s_obs)))
        if self.tracer is not None and served:
            self.tracer.instant(
                "adapter_observe", "online", now,
                args={"served": len(served), "immediate": len(ready),
                      "staged": n_staged})
        self._commit(ready, now)
        self.tick(now)

    def deliver_feedback(self, rid: int, s_obs: float,
                         now: float = 0.0) -> None:
        """Late quality feedback for a served request (any order)."""
        self.stage.deliver(rid, s_obs, now)

    def tick(self, now: float = 0.0) -> None:
        """Flush resolved staged outcomes (called every dispatch round)."""
        if self.feedback_source is not None:
            for rid, s in self.feedback_source.due(now):
                self.stage.deliver(rid, s, now)
        ready = self.stage.flush(now)
        if ready:
            self.stats["delayed_resolved"] += len(ready)
            self._commit(ready, now)
        self.stats["feedback_expired"] = self.stage.expired

    def _commit(self, outcomes: List[Tuple[object, float]],
                now: float) -> None:
        """Train-ready outcomes -> replay / membership / drift / updates."""
        embs, members = [], []
        for r, s_obs in outcomes:
            self.replay.add(r.q_emb, r.member, s_obs, r.cost, now)
            self.membership.record_outcome(r.member, r.q_emb, s_obs)
            members.append(r.member)
            embs.append(np.asarray(r.q_emb, np.float32))
            self.stats["outcomes"] += 1
            self._since_update += 1
        if members:
            self.policy.record(np.asarray(members))

        if self.drift is not None and embs:
            if self.drift.observe(np.stack(embs), now):
                self.stats["drift_alarms"] += 1
                if self.tracer is not None:
                    stats = self.drift.last_stats
                    self.tracer.instant(
                        "drift_alarm", "online", now,
                        args={"shift_z": stats.get("shift_z"),
                              "dispersion_z": stats.get("dispersion_z"),
                              "deferred": self.defer_updates})
                if self.defer_updates:
                    self.pending_burst = True
                else:
                    self.stats["bursts"] += 1
                    self._update(self.config.burst_steps, now)
                # Recovery: re-anchor the detector on the post-shift regime
                # so it arms for the *next* excursion instead of alarming
                # on every subsequent window.
                self.drift.refit()
        if (self._since_update >= self.config.update_every
                and not self.defer_updates):
            self._update(self.config.steps_per_update, now)

    # -- incremental updates -------------------------------------------------

    def _update(self, n_steps: int, now: float = 0.0) -> None:
        self._since_update = 0
        if len(self.replay) < self.config.min_buffer:
            return
        res = self.updater.run_steps(self.replay, self.membership.model_emb,
                                     n_steps)
        if res["steps"] == 0:
            return
        self.updater.publish(self.engine, self.membership.model_emb)
        self.membership.emb_dirty = False
        self.stats["updates"] += 1
        self.stats["update_steps"] += res["steps"]
        self.stats["router_swaps"] += 1
        self.stats["last_quality_loss"] = res["quality_loss"]
        self.stats["last_cost_loss"] = res["cost_loss"]
        if self.tracer is not None:
            # The engine's on_swap hook already emitted "router_swap"; this
            # carries the update's provenance alongside it.
            self.tracer.instant(
                "router_update", "online", now,
                args={"steps": int(res["steps"]),
                      "version": self.engine.router.version})

    # -- crash recovery (multi-worker plane) ---------------------------------

    def reset_outcome_state(self, seed: int) -> None:
        """Rejoin-after-crash support: in-memory outcome state (replay,
        staged feedback) did not survive the process; rebuild it empty."""
        frac = self.replay.cap_recent / self.replay.capacity
        self.replay = ReplayBuffer(self.replay.capacity,
                                   recent_frac=frac, seed=seed)
        self.stage = OutcomeStage(timeout_s=self.stage.timeout_s)
        self.pending_burst = False
        self._since_update = 0

    # -- hot pool membership -------------------------------------------------

    def add_member(self, pool_member,
                   emb_row: Optional[np.ndarray] = None) -> int:
        """Hot-add a pool member (probationary until min outcome count)."""
        idx = self.membership.add_member(pool_member, emb_row)
        self.policy.add_member()
        self.updater.warm_start(self.engine.router)
        self.stats["members_added"] += 1
        self.stats["router_swaps"] += 1
        return idx

    def remove_member(self, idx: int) -> None:
        """Hot-remove a pool member; dependent state is remapped."""
        self.membership.remove_member(idx, replay=self.replay,
                                      policy=self.policy)
        self.updater.warm_start(self.engine.router)
        self.stats["members_removed"] += 1
        self.stats["router_swaps"] += 1

    # -- reporting -----------------------------------------------------------

    def report(self) -> str:
        s = self.stats
        staged = ""
        if s["staged"]:
            staged = (f"  staged {int(s['staged'])} "
                      f"(resolved {int(s['delayed_resolved'])}, "
                      f"expired {int(s['feedback_expired'])})")
        return (
            f"online: outcomes {int(s['outcomes'])}  "
            f"explored {int(s['explored'])}  "
            f"updates {int(s['updates'])} ({int(s['update_steps'])} steps, "
            f"{int(s['bursts'])} bursts)  "
            f"drift alarms {int(s['drift_alarms'])}  "
            f"router v{self.engine.router.version} "
            f"({int(s['router_swaps'])} swaps)  "
            f"pool {len(self.engine.pool)} members "
            f"(+{int(s['members_added'])}/-{int(s['members_removed'])})"
            f"{staged}"
        )
