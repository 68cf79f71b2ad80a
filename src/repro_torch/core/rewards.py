"""Reward functions combining predicted quality and cost (paper Eq. 3).

    R1(s, c; lam) = s - c / lam              (traditional linear trade-off)
    R2(s, c; lam) = s * exp(-c / lam)        (proposed exponential trade-off)

The functions take tensors or Python floats. R2 takes its ``exp`` in
float32 whatever the dtype of ``c``: the reference runs JAX with 64-bit
mode off, so its ``jnp.exp`` sees the float64 cost rounded to float32,
and near-ties
between members only pick the same member if the port rounds alike. For
the same reason R2 flushes subnormal results to zero, as XLA does on the
CPU and the TPU: at small lambda every member's ``exp`` can fall below
float32's smallest normal, where the reference sees a tie of zeros and
picks member 0.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

_TINY = torch.finfo(torch.float32).tiny


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < _TINY, torch.zeros((), dtype=x.dtype, device=x.device), x)


def reward_linear(s: torch.Tensor, c: torch.Tensor, lam: float) -> torch.Tensor:
    """R1 = s - c/lam."""
    return s - c / lam


def reward_exponential(s: torch.Tensor, c: torch.Tensor, lam: float) -> torch.Tensor:
    """R2 = s * exp(-c/lam), the exp in float32, subnormals flushed to zero."""
    e = torch.exp(torch.as_tensor(-c / lam, dtype=torch.float32))
    return _flush_subnormal(s * _flush_subnormal(e))


REWARDS: Dict[str, Callable] = {
    "R1": reward_linear,
    "R2": reward_exponential,
}


def reward_matrix(reward_name: str, s_hat, c_hat, lam: float) -> np.ndarray:
    """The reference's ``REWARDS[name](s_hat, c_hat, lam)`` on numpy score
    rows, rounded as it rounds them: its R1 is numpy arithmetic (float64
    for the engine's float64 costs); its R2 hands the numpy ``-c/lam`` to
    ``jnp.exp``, which narrows it to float32, and the product is float32.
    """
    s, c = np.asarray(s_hat), np.asarray(c_hat)
    if reward_name == "R1":
        return s - c / lam
    return REWARDS[reward_name](torch.from_numpy(s.astype(np.float32)),
                                torch.as_tensor(c), lam).numpy()


def route(reward_name: str, s_hat, c_hat, lam: float) -> torch.Tensor:
    """argmax_m Reward(s_hat[:, m], c_hat[:, m]; lam) -> (B,) model indices.

    Both inputs are narrowed to float32 first, as the reference's
    ``jnp.asarray`` narrows float64 with x64 off.
    """
    s = torch.as_tensor(s_hat).to(torch.float32)
    c = torch.as_tensor(c_hat).to(torch.float32)
    return torch.argmax(REWARDS[reward_name](s, c, lam), dim=-1)


# ---------------------------------------------------------------------------
# Cascade (multi-leg) reward accounting
# ---------------------------------------------------------------------------

def cascade_outcome(leg_quality, leg_cost, keep_best: bool = True):
    """(final_quality, cumulative_cost) of one escalation sequence.

    The cost of a cascade is the SUM of every leg it ran. Quality is the
    best answer in hand under keep-best semantics, or the last leg's
    answer when ``keep_best=False`` (strict replace-on-escalate).
    """
    if len(leg_quality) == 0 or len(leg_quality) != len(leg_cost):
        raise ValueError("leg_quality and leg_cost must be equal, nonzero "
                         f"length (got {len(leg_quality)}/{len(leg_cost)})")
    q = max(leg_quality) if keep_best else leg_quality[-1]
    return float(q), float(sum(leg_cost))


def cascade_reward(reward_name: str, leg_quality, leg_cost, lam,
                   keep_best: bool = True):
    """Realized reward of a full cascade: R(final quality, SUM leg costs).

    Python floats in, so R1 is float64 and R2 float32, as in the
    reference, whose ``jnp.exp`` rounds a Python float to float32.
    """
    q, c = cascade_outcome(leg_quality, leg_cost, keep_best=keep_best)
    return float(REWARDS[reward_name](q, c, lam))
