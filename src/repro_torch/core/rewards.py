"""Reward functions combining predicted quality and cost (paper Eq. 3).

    R1(s, c; lam) = s - c / lam              (traditional linear trade-off)
    R2(s, c; lam) = s * exp(-c / lam)        (proposed exponential trade-off)

The functions take tensors. R2 takes its ``exp`` in float32 whatever the
dtype of ``c``: the reference runs JAX with 64-bit mode off, so its
``jnp.exp`` sees the float64 cost rounded to float32, and near-ties
between members only pick the same member if the port rounds alike.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def reward_linear(s: torch.Tensor, c: torch.Tensor, lam: float) -> torch.Tensor:
    """R1 = s - c/lam."""
    return s - c / lam


def reward_exponential(s: torch.Tensor, c: torch.Tensor, lam: float) -> torch.Tensor:
    """R2 = s * exp(-c/lam), the exp in float32."""
    return s * torch.exp((-c / lam).to(torch.float32))


REWARDS: Dict[str, Callable] = {
    "R1": reward_linear,
    "R2": reward_exponential,
}


def route(reward_name: str, s_hat: torch.Tensor, c_hat: torch.Tensor,
          lam: float) -> torch.Tensor:
    """argmax_m Reward(s_hat[:, m], c_hat[:, m]; lam) -> (B,) model indices."""
    return torch.argmax(REWARDS[reward_name](s_hat, c_hat, lam), dim=-1)
