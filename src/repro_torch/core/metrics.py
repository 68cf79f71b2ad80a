"""Routing evaluation metrics: Pareto frontier, AIQ, lambda-sensitivity.

The port's own copy of ``repro.core.metrics`` (numpy only): the same
functions give the same numbers for the same routed choices.

AIQ (paper Eq. 1): sweep the user parameter lambda over a grid; each lambda
yields an (average cost, average quality) point on the test set. The
non-decreasing convex hull of those points is the router's cost-quality
Pareto frontier; AIQ is the area under that frontier divided by the cost
range [a, b].

lambda-sensitivity (paper Eq. 2): log-lambda-weighted average change of
performance (resp. cost) — lower means the router is stabler in the user
parameter.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

DEFAULT_LAMBDA_GRID = np.logspace(-4.5, 1.5, 25)


def routed_points(
    choices_per_lam: np.ndarray,      # (L, B) routed model index per lambda
    quality: np.ndarray,              # (B, K) true quality per (query, model)
    cost: np.ndarray,                 # (B, K) true cost
) -> Tuple[np.ndarray, np.ndarray]:
    """Average (cost, quality) per lambda. Returns (costs (L,), perfs (L,))."""
    b = np.arange(quality.shape[0])
    costs, perfs = [], []
    for ch in choices_per_lam:
        costs.append(float(cost[b, ch].mean()))
        perfs.append(float(quality[b, ch].mean()))
    return np.asarray(costs), np.asarray(perfs)


def pareto_frontier(costs: np.ndarray, perfs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Upper-left non-decreasing convex hull of the (cost, perf) points.

    Returns frontier (costs_sorted, hull_perfs) suitable for trapezoid
    integration. Duplicate costs keep the best perf.
    """
    order = np.argsort(costs, kind="stable")
    cs, ps = costs[order], perfs[order]
    # Dedup equal costs keeping max perf.
    uniq_c, uniq_p = [], []
    for c, p in zip(cs, ps):
        if uniq_c and np.isclose(c, uniq_c[-1]):
            uniq_p[-1] = max(uniq_p[-1], p)
        else:
            uniq_c.append(float(c))
            uniq_p.append(float(p))
    cs, ps = np.asarray(uniq_c), np.asarray(uniq_p)
    if len(cs) == 1:
        return cs, ps
    # Monotone non-decreasing envelope.
    ps = np.maximum.accumulate(ps)
    # Upper convex hull (Andrew's monotone chain, keeping concave-down turns).
    hull: list = []
    for x, y in zip(cs, ps):
        while len(hull) >= 2:
            (x1, y1), (x2, y2) = hull[-2], hull[-1]
            # Remove middle point if it lies below the chord (convexity).
            if (y2 - y1) * (x - x1) <= (y - y1) * (x2 - x1):
                hull.pop()
            else:
                break
        hull.append((float(x), float(y)))
    hx = np.asarray([h[0] for h in hull])
    hy = np.asarray([h[1] for h in hull])
    return hx, hy


def aiq(costs: np.ndarray, perfs: np.ndarray) -> float:
    """Average Improvement in Quality: hull area / cost range (Eq. 1)."""
    hx, hy = pareto_frontier(costs, perfs)
    if len(hx) < 2 or np.isclose(hx[-1], hx[0]):
        return float(hy.max())
    area = float(np.trapezoid(hy, hx))
    return area / float(hx[-1] - hx[0])


def frontier_value_at(costs: np.ndarray, perfs: np.ndarray,
                      at_cost: float) -> float:
    """Quality the frontier of (costs, perfs) delivers at budget ``at_cost``.

    Linear interpolation on the non-decreasing convex hull. Below the
    hull's cheapest point the frontier delivers nothing comparable
    (-inf — the policy cannot spend that little); above its priciest
    point the hull is flat (spending more cannot *lose* quality).
    """
    hx, hy = pareto_frontier(np.asarray(costs, np.float64),
                             np.asarray(perfs, np.float64))
    if at_cost < hx[0] and not np.isclose(at_cost, hx[0]):
        return float("-inf")
    return float(np.interp(at_cost, hx, hy))


def frontier_dominance(
    costs_a: np.ndarray, perfs_a: np.ndarray,
    costs_b: np.ndarray, perfs_b: np.ndarray,
    tol: float = 1e-9,
) -> np.ndarray:
    """Pointwise weak dominance of frontier A over B's operating points.

    For each point (c_i, p_i) traced by policy B, True when policy A's
    frontier delivers at least p_i quality at budget c_i (within ``tol``).
    The cascade acceptance gate counts these: a cascade dominates the
    single-shot router at a lambda point when, for the single-shot
    policy's realized spend there, the cascade frontier matches or beats
    its realized quality.
    """
    costs_b = np.asarray(costs_b, np.float64)
    perfs_b = np.asarray(perfs_b, np.float64)
    return np.asarray([
        frontier_value_at(costs_a, perfs_a, c) >= p - tol
        for c, p in zip(costs_b, perfs_b)
    ])


def lam_sensitivity(lams: Sequence[float], values: Sequence[float]) -> float:
    """Paper Eq. 2: sum_i log(l_{i+1}/l_i)*(v_{i+1}-v_i) / log(l_n/l_1)."""
    lams = np.asarray(lams, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if len(lams) < 2:
        return 0.0
    num = float(np.sum(np.log(lams[1:] / lams[:-1]) * np.abs(np.diff(values))))
    den = float(np.log(lams[-1] / lams[0]))
    return num / den


def max_calls_fraction(
    choices_per_lam: np.ndarray, expensive_idx: int
) -> float:
    """Max over lambda of the fraction of queries routed to the priciest model."""
    fracs = (choices_per_lam == expensive_idx).mean(axis=1)
    return float(fracs.max())


def evaluate_router(
    choices_per_lam: np.ndarray,
    quality: np.ndarray,
    cost: np.ndarray,
    lams: np.ndarray,
    expensive_idx: int,
) -> Dict[str, float]:
    """All paper metrics for one router on one test set."""
    costs, perfs = routed_points(choices_per_lam, quality, cost)
    return {
        "aiq": aiq(costs, perfs),
        "perf_max": float(perfs.max()),
        "lam_sens_perf": lam_sensitivity(lams, perfs),
        "lam_sens_cost": lam_sensitivity(lams, costs),
        "max_calls_expensive": max_calls_fraction(choices_per_lam, expensive_idx),
        "avg_costs": costs,
        "avg_perfs": perfs,
    }
