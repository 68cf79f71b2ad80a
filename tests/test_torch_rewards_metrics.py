"""The port's rewards, cascade accounting, metrics and sweeps against the
JAX reference.

``core/metrics.py`` is a numpy copy, so every metric must equal the
reference's exactly on the same points and choices. ``oracle_sweep`` must
give the reference's choices exactly on the synthetic corpus's pool1
(25 lambdas, float32 quality and cost): R2 rounds as XLA does, to float32
with subnormals flushed to zero, so even all-zero ties at the smallest
lambdas break alike. A single float32 R2 can still differ by an ulp,
since XLA's and torch's ``exp`` round differently; ``cascade_reward``'s
R2 is held within 2.5e-7 relative (two float32 ulps), its R1 exactly.
The reference's reward and metric properties are mirrored on the port.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import metrics as jax_metrics
from repro.core import rewards as jax_rewards
from repro.core.router import evaluate_sweep as jax_evaluate_sweep
from repro.core.router import oracle_sweep as jax_oracle_sweep
from repro.data import generate as jax_generate
from repro_torch.core import metrics
from repro_torch.core.rewards import (
    cascade_outcome, cascade_reward, reward_exponential, reward_linear, route,
)
from repro_torch.core.router import evaluate_sweep, oracle_sweep


@pytest.fixture(scope="module")
def pool1():
    return jax_generate(400, seed=0).pool("pool1")


def test_lambda_grid_is_the_reference_grid():
    np.testing.assert_array_equal(metrics.DEFAULT_LAMBDA_GRID, jax_metrics.DEFAULT_LAMBDA_GRID)
    assert len(metrics.DEFAULT_LAMBDA_GRID) == 25


@pytest.mark.parametrize("reward", ["R1", "R2"])
def test_oracle_sweep_equals_reference_exactly(pool1, reward):
    lams = metrics.DEFAULT_LAMBDA_GRID
    want = jax_oracle_sweep(pool1.quality, pool1.cost, lams, reward)
    got = oracle_sweep(pool1.quality, pool1.cost, lams, reward)
    assert got.shape == (25, 400)
    np.testing.assert_array_equal(got, want)


def test_evaluate_sweep_equals_reference_exactly(pool1):
    rng = np.random.default_rng(0)
    choices = rng.integers(0, 5, size=(25, 400))
    want = jax_evaluate_sweep(choices, pool1.quality, pool1.cost)
    got = evaluate_sweep(choices, pool1.quality, pool1.cost)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("reward", ["R1", "R2"])
def test_route_narrows_float64_like_the_reference(reward):
    rng = np.random.default_rng(1)
    s = rng.uniform(size=(300, 4))
    c = rng.uniform(0, 5e-3, size=(300, 4))          # float64, as denormalized costs are
    for lam in (3e-5, 1e-3, 0.3, 30.0):
        np.testing.assert_array_equal(route(reward, s, c, lam).numpy(),
                                      np.asarray(jax_rewards.route(reward, s, c, lam)))


@pytest.mark.parametrize("keep_best", [True, False])
@pytest.mark.parametrize("reward", ["R1", "R2"])
def test_cascade_reward_equals_reference(reward, keep_best):
    rng = np.random.default_rng(2)
    for _ in range(50):
        n = int(rng.integers(1, 4))
        q, c = list(rng.uniform(size=n)), list(rng.uniform(0, 0.05, size=n))
        lam = float(10 ** rng.uniform(-4, 1))
        assert cascade_outcome(q, c, keep_best) == jax_rewards.cascade_outcome(q, c, keep_best)
        got = cascade_reward(reward, q, c, lam, keep_best)
        want = jax_rewards.cascade_reward(reward, q, c, lam, keep_best)
        if reward == "R1":
            assert got == want                     # float64 on both sides
        else:                                      # float32 exp: XLA's and torch's
            np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)  # differ by an ulp


def test_cascade_outcome_rejects_ragged_legs():
    with pytest.raises(ValueError):
        cascade_outcome([], [])
    with pytest.raises(ValueError):
        cascade_outcome([0.5], [0.1, 0.2])


def test_cascade_cost_is_the_sum_of_legs_and_quality_keep_best():
    assert cascade_outcome([0.9, 0.4], [0.01, 0.02]) == (0.9, pytest.approx(0.03))
    assert cascade_outcome([0.9, 0.4], [0.01, 0.02], keep_best=False)[0] == 0.4


def _points(seed, n):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 0.05, size=n), rng.uniform(size=n)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 7), (3, 25), (4, 60)])
def test_metrics_equal_reference_exactly(seed, n):
    costs, perfs = _points(seed, n)
    costs[: n // 3] = costs[0]                     # duplicate costs: the dedup path
    for got, want in zip(metrics.pareto_frontier(costs, perfs),
                         jax_metrics.pareto_frontier(costs, perfs)):
        np.testing.assert_array_equal(got, want)
    assert metrics.aiq(costs, perfs) == jax_metrics.aiq(costs, perfs)
    lams = np.logspace(-3, 1, n)
    assert metrics.lam_sensitivity(lams, perfs) == jax_metrics.lam_sensitivity(lams, perfs)
    for at in (0.0, float(costs.min()), 0.025, 0.07):
        assert metrics.frontier_value_at(costs, perfs, at) == \
            jax_metrics.frontier_value_at(costs, perfs, at)
    cb, pb = _points(seed + 10, 5)
    np.testing.assert_array_equal(metrics.frontier_dominance(costs, perfs, cb, pb),
                                  jax_metrics.frontier_dominance(costs, perfs, cb, pb))


def test_routed_points_and_calls_fraction_equal_reference(pool1):
    ch = np.random.default_rng(3).integers(0, 5, size=(6, 400))
    for got, want in zip(metrics.routed_points(ch, pool1.quality, pool1.cost),
                         jax_metrics.routed_points(ch, pool1.quality, pool1.cost)):
        np.testing.assert_array_equal(got, want)
    assert metrics.max_calls_fraction(ch, 4) == jax_metrics.max_calls_fraction(ch, 4)


class TestRewards:
    def test_linear_matches_formula(self):
        assert np.isclose(float(reward_linear(0.8, 0.002, 0.1)), 0.8 - 0.02)

    def test_exponential_matches_formula(self):
        assert np.isclose(float(reward_exponential(0.8, 0.002, 0.1)), 0.8 * np.exp(-0.02))

    def test_route_prefers_quality_at_high_lambda(self):
        s, c = np.array([[0.5, 0.9]]), np.array([[0.001, 1.0]])
        assert int(route("R2", s, c, 1e6)[0]) == 1
        assert int(route("R1", s, c, 1e6)[0]) == 1

    def test_route_prefers_cheap_at_low_lambda(self):
        s, c = np.array([[0.5, 0.9]]), np.array([[0.001, 1.0]])
        assert int(route("R2", s, c, 1e-4)[0]) == 0
        assert int(route("R1", s, c, 1e-4)[0]) == 0

    @given(s=st.floats(0.0, 1.0), c=st.floats(0.0, 100.0), lam=st.floats(1e-4, 1e4))
    @settings(max_examples=50, deadline=None)
    def test_r2_bounded(self, s, c, lam):
        r = float(reward_exponential(s, c, lam))
        assert 0.0 <= r <= s * (1 + 1e-6) + 1e-7   # fp32 slack

    @given(s=st.floats(0.01, 1.0), c=st.floats(0.001, 100.0),
           lam1=st.floats(1e-4, 1e3), factor=st.floats(1.01, 100.0))
    @settings(max_examples=50, deadline=None)
    def test_rewards_monotone_in_lambda(self, s, c, lam1, factor):
        lam2 = lam1 * factor
        assert float(reward_linear(s, c, lam2)) >= float(reward_linear(s, c, lam1))
        assert float(reward_exponential(s, c, lam2)) >= float(reward_exponential(s, c, lam1))

    def test_r2_flushes_subnormals_to_zero(self):
        c = torch.tensor([[90.0, 95.0]])            # exp(-90), exp(-95): float32 subnormals
        assert torch.equal(reward_exponential(torch.ones(1, 2), c, 1.0), torch.zeros(1, 2))
        assert int(route("R2", np.ones((1, 2)), c.numpy(), 1.0)[0]) == 0


class TestPareto:
    def test_hull_of_two_points(self):
        hx, hy = metrics.pareto_frontier(np.array([1.0, 2.0]), np.array([0.5, 0.8]))
        assert list(hx) == [1.0, 2.0] and list(hy) == [0.5, 0.8]

    def test_aiq_constant_router(self):
        assert metrics.aiq(np.array([1.0, 1.0]), np.array([0.7, 0.7])) == 0.7

    def test_aiq_analytic_triangle(self):
        # (0, 0) -> (1, 1): the area under the chord over a range of 1 is 0.5.
        assert np.isclose(metrics.aiq(np.array([0.0, 1.0]), np.array([0.0, 1.0])), 0.5)

    def test_constant_series_has_zero_sensitivity(self):
        assert metrics.lam_sensitivity([0.1, 1.0, 10.0], [0.5, 0.5, 0.5]) == 0.0
