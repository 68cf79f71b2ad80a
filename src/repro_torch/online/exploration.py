"""Exploration over the pool at the scheduler's scoring step.

Pure exploitation starves the replay buffer of counterfactuals: once the
router believes member ``m`` is best for a region, only ``m``'s outcomes
are ever observed there and the other members' predictions can never be
corrected. Two mechanisms, composable:

  * **optimistic per-member bonus** ``bonus / sqrt(n_m + 1)`` added to the
    predicted reward — under-observed members (freshly added ones above
    all) win ties and decay back to honest scores as outcomes accumulate;
  * **epsilon-greedy** — a per-request coin flip routes uniformly over the
    explorable members.

Epsilon is annealed by the budget governor's *headroom*: exploration costs
money (it sometimes picks expensive members the reward argmax would not),
so a window running hot on budget explores less and a window with slack
explores at the configured rate.

The exploit argmax additionally honors a membership mask: probationary
members (below their minimum outcome count) are only reachable via the
exploration paths, never via exploitation — cold predictions should not
steer real traffic.

The port of ``repro.online.exploration``, a copy: host numpy and the
same seeded generator, so the same rewards, mask and headroom give the
reference's choices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ExplorationConfig:
    epsilon: float = 0.05       # exploration rate at full budget headroom
    bonus: float = 0.05         # optimistic bonus scale (reward units)
    seed: int = 0


class ExplorationPolicy:
    def __init__(self, n_members: int,
                 config: Optional[ExplorationConfig] = None):
        self.config = config or ExplorationConfig()
        self.counts = np.zeros(n_members, np.int64)
        self.rng = np.random.default_rng(self.config.seed)

    @property
    def n_members(self) -> int:
        return len(self.counts)

    def choose(self, rewards: np.ndarray,
               exploit_mask: Optional[np.ndarray] = None,
               headroom: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
        """(choices (B,), explored (B,) bool) for one score batch.

        ``rewards`` (B, K) are the predicted rewards at the effective
        lambda; ``exploit_mask`` (K,) False for probationary members;
        ``headroom`` in [0, 1] scales epsilon (1 = full exploration).
        """
        rewards = np.asarray(rewards, np.float64)
        b, k = rewards.shape
        if k != self.n_members:
            raise ValueError(f"rewards K={k} != tracked members "
                             f"{self.n_members}")
        biased = rewards + (self.config.bonus
                            / np.sqrt(self.counts + 1.0))[None, :]
        if exploit_mask is not None:
            biased = np.where(np.asarray(exploit_mask, bool)[None, :],
                              biased, -np.inf)
        choices = np.argmax(biased, axis=1)

        eps = self.config.epsilon * float(np.clip(headroom, 0.0, 1.0))
        explored = self.rng.random(b) < eps
        n_exp = int(explored.sum())
        if n_exp:
            choices = choices.copy()
            choices[explored] = self.rng.integers(k, size=n_exp)
        return choices.astype(np.int64), explored

    def record(self, members: np.ndarray) -> None:
        """Fold served members back into the observation counts."""
        np.add.at(self.counts, np.asarray(members, np.int64), 1)

    # -- hot pool membership -------------------------------------------------

    def add_member(self) -> None:
        self.counts = np.append(self.counts, 0)

    def remove_member(self, idx: int) -> None:
        self.counts = np.delete(self.counts, idx)
