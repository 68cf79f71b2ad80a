"""The port's cascade layer against the JAX reference, on the CPU.

``cost_ladder``, ``CascadePolicy.decide`` and ``decide_rung0`` are held
against ``repro.cascade`` on seeded inputs for R1 and R2: the same
escalate / next-member verdicts, the expected gain within 1e-6 (R2's
``exp`` is float32 in both, by different libraries). The reference's own
policy, multi-leg lifecycle, telemetry and escalation-regression cases
(``tests/test_cascade.py``) are written out here against the port's
policy, coordinator, scheduler, request and telemetry, on a fake engine of
this file's own, so the seed-42 pin (47 escalations, ``finalized_by_leg ==
[1, 47]``, an identical replay) holds on the port's scheduler, and both
packages' schedulers make that run from the same helper. No module of
either package is patched. The ladder's
refresh after a hot pool change runs on the port's router. The cascade
smoke's escalate -> stop trace (``tools/cascade_smoke.py``) runs in both
packages from one ``attn-ens`` router carried across by the npz
checkpoint format, and the ``--cascade`` trace mode of the port's serve
entry point runs at smoke size.
"""
import contextlib
import io
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import cascade as jax_cascade
from repro import checkpoint as jax_ckpt
from repro.core.predictors import PREDICTORS as JAX_PREDICTORS
from repro.core.router import PredictiveRouter as JaxRouter
from repro.serving import MicroBatchScheduler as JaxScheduler
from repro.serving import Request as JaxRequest
from repro.serving import RoutedEngine as JaxEngine
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro.training import AdamConfig as JaxAdamConfig
from repro.training import adam_init as jax_adam_init
from repro.training import make_ensemble_predictor_step as jax_ensemble_step
from repro_torch import cascade
from repro_torch.checkpoint import load_router
from repro_torch.configs import get_smoke_config
from repro_torch.core import rewards as port_rewards
from repro_torch.core.router import PredictiveRouter
from repro_torch.launch import serve
from repro_torch.serving import queue as port_queue
from repro_torch.serving.budget import BudgetGovernor
from repro_torch.serving.engine import RoutedEngine
from repro_torch.serving.scheduler import MicroBatchScheduler, SchedulerConfig
from repro_torch.serving.telemetry import Telemetry


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, so that parallel test
    workers do not each start one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

# ---------------------------------------------------------------------------
# Policy parity on seeded inputs
# ---------------------------------------------------------------------------


def _states(seed, n=300, k=4):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        n_tried = int(rng.integers(0, 3))
        yield dict(
            s_cur=float(rng.uniform(0.0, 1.0)), s_std_cur=float(rng.uniform(0.0, 0.3)),
            s_hat=rng.uniform(0.0, 1.0, k), s_std=rng.uniform(0.0, 0.2, k),
            c_hat=rng.uniform(-0.1, 3.0, k), cum_cost=float(rng.uniform(0.0, 2.0)),
            tried=[int(m) for m in rng.permutation(k)[:n_tried]],
            lam=float(10.0 ** rng.uniform(-1.0, 2.0)), observed=bool(rng.random() < 0.4),
            headroom=float(rng.uniform(0.0, 1.0)))


def _same(got, want):
    assert (got.escalate, got.next_member) == (want.escalate, want.next_member)
    assert abs(got.expected_gain - want.expected_gain) <= 1e-6 * max(1.0, abs(want.expected_gain))


@pytest.mark.parametrize("reward", ["R1", "R2"])
def test_decide_equals_the_references(reward):
    ladder = [2, 0, 3, 1]
    kw = dict(max_legs=3, beta=0.7, gamma=1.2, margin=0.01, min_headroom=0.2)
    jp = jax_cascade.CascadePolicy(ladder, jax_cascade.CascadeConfig(**kw), reward=reward)
    tp = cascade.CascadePolicy(ladder, cascade.CascadeConfig(**kw), reward=reward)
    n_esc = 0
    for state in _states(1 if reward == "R1" else 2):
        want = jp.decide(**state)
        _same(tp.decide(**state), want)
        n_esc += want.escalate
        assert tp.candidates(state["tried"]) == jp.candidates(state["tried"])
    assert 0 < n_esc < 300


@pytest.mark.parametrize("reward", ["R1", "R2"])
def test_decide_rung0_equals_the_references(reward):
    jp = jax_cascade.CascadePolicy([0, 1, 2], reward=reward)
    tp = cascade.CascadePolicy([0, 1, 2], reward=reward)
    n_esc = 0
    for state in _states(3, k=3):
        args = dict(q_cache=state["s_cur"], sigma_cache=state["s_std_cur"],
                    s_hat=state["s_hat"], s_std=state["s_std"], c_hat=state["c_hat"],
                    lam=state["lam"], headroom=state["headroom"])
        want = jp.decide_rung0(**args)
        _same(tp.decide_rung0(**args), want)
        n_esc += want.escalate
    assert 0 < n_esc < 300


def _port_reg_router(mu, dq=4):
    k = len(mu)
    params = {"w": torch.zeros((dq, k)), "b": torch.zeros(k)}
    return PredictiveRouter("reg", "reg", params, dict(params), np.zeros((k, 2), np.float32),
                            cost_scaler={"mu": np.asarray(mu, np.float64), "sd": np.ones(k)})


def test_cost_ladder_equals_the_references():
    rng = np.random.default_rng(4)
    for _ in range(20):
        mu = rng.uniform(0.0, 5.0, 6)
        mu[rng.integers(6)] = mu[0]            # a tie keeps index order (stable sort)
        jr = JaxRouter("reg", "reg", {}, {}, np.zeros((6, 2), np.float32),
                       cost_scaler={"mu": mu, "sd": np.ones(6)})
        np.testing.assert_array_equal(cascade.cost_ladder(_port_reg_router(mu)),
                                      jax_cascade.cost_ladder(jr))
        c_hat = rng.uniform(size=(5, 6))
        bare = _port_reg_router(mu)
        bare.cost_scaler = None
        np.testing.assert_array_equal(cascade.cost_ladder(bare, c_hat),
                                      jax_cascade.cost_ladder(
                                          JaxRouter("reg", "reg", {}, {}, bare.model_emb), c_hat))
    bare.cost_scaler = None
    with pytest.raises(ValueError):
        cascade.cost_ladder(bare)


def test_ladder_refresh_follows_hot_pool_changes_on_the_port_router():
    router = _port_reg_router([0.1, 1.0])
    policy = cascade.CascadePolicy(cascade.cost_ladder(router))
    assert policy.refresh(router) is False and policy.ladder == [0, 1]
    grown = router.add_member()                   # mu of the new member: the mean, 0.55
    assert 2 not in policy.candidates([0])
    assert policy.refresh(grown) is True and policy.ladder == [0, 2, 1]
    d = policy.decide(s_cur=0.1, s_std_cur=0.0, s_hat=np.asarray([0.3, 0.5, 0.95]),
                      s_std=np.asarray([0.05, 0.05, 0.05]),
                      c_hat=np.asarray([0.1, 1.0, 0.55]), cum_cost=0.1, tried=[0],
                      lam=100.0, observed=True)
    assert d.escalate and d.next_member == 2
    shrunk = grown.remove_member(0)
    assert policy.refresh(shrunk) is True and policy.ladder == [1, 0]
    stub = cascade.CascadePolicy([0, 1, 2])
    assert stub.refresh(PredictiveRouter("reg", "reg", {}, {}, np.zeros((2, 2)))) is False


# ---------------------------------------------------------------------------
# The reference's cascade suites on the port
# ---------------------------------------------------------------------------
# tests/test_cascade.py's policy, multi-leg lifecycle, telemetry, seed-42
# and reward-accounting cases, written out against the port's classes with
# a fake engine of this file's own. Nothing here patches a module: the
# helpers take the package whose classes they build (``PORT`` or ``REF``),
# so the seed-42 run is made by both schedulers from the same code.

PORT = SimpleNamespace(
    CascadeConfig=cascade.CascadeConfig, CascadeCoordinator=cascade.CascadeCoordinator,
    CascadePolicy=cascade.CascadePolicy, Request=port_queue.Request,
    MicroBatchScheduler=MicroBatchScheduler, SchedulerConfig=SchedulerConfig)
REF = SimpleNamespace(
    CascadeConfig=jax_cascade.CascadeConfig,
    CascadeCoordinator=jax_cascade.CascadeCoordinator,
    CascadePolicy=jax_cascade.CascadePolicy, Request=JaxRequest,
    MicroBatchScheduler=JaxScheduler, SchedulerConfig=JaxSchedulerConfig)

# Three-member ladder: cheap / mid / strong.
LADDER_COSTS = (0.1, 1.0, 5.0)
LADDER_QUAL = (0.4, 0.7, 0.95)
LADDER_STD = (0.05, 0.05, 0.05)


def make_policy(reward="R2", pkg=PORT, **cfg):
    return pkg.CascadePolicy([0, 1, 2], pkg.CascadeConfig(**cfg), reward=reward)


def decide(policy, *, s_cur, s_std_cur=0.0, tried=(0,), cum=0.1, lam=5.0,
           s_hat=LADDER_QUAL, s_std=LADDER_STD, c_hat=LADDER_COSTS, observed=False,
           headroom=1.0):
    return policy.decide(
        s_cur=s_cur, s_std_cur=s_std_cur, s_hat=np.asarray(s_hat), s_std=np.asarray(s_std),
        c_hat=np.asarray(c_hat), cum_cost=cum, tried=list(tried), lam=lam,
        observed=observed, headroom=headroom)


class FakeMember:
    def __init__(self, name, cost_rate):
        self.name, self.cost_rate = name, cost_rate


class FakeCascadeEngine:
    """Per-text quality tables and the cascade's scoring surface, host
    numpy only. ``pred_of`` is what the router believes (s_hat rows); it
    defaults to ``quality_of`` (perfect estimates)."""

    def __init__(self, quality_of=None, pred_of=None, lam=10.0, std=LADDER_STD):
        self.pool = [FakeMember(f"m{i}", c) for i, c in enumerate(LADDER_COSTS)]
        self.lam = lam
        self.std = np.asarray(std, np.float64)
        self.quality_of = quality_of or {}
        self.pred_of = pred_of if pred_of is not None else self.quality_of
        self.generate_log = []

    def _rows(self, texts):
        return np.stack([np.asarray(self.pred_of.get(t, LADDER_QUAL), np.float64)
                         for t in texts])

    def embed(self, texts):
        self._last_texts = list(texts)
        return np.zeros((len(texts), 4), np.float32)

    def score_emb_uncertainty(self, q_emb):
        b = len(q_emb)
        return (self._rows(self._last_texts), np.tile(self.std, (b, 1)),
                np.tile(LADDER_COSTS, (b, 1)))

    def score_emb(self, q_emb):
        s, _, c = self.score_emb_uncertainty(q_emb)
        return s, c

    def score_texts(self, texts):
        self.embed(texts)
        return self.score_emb(np.zeros((len(texts), 4), np.float32))

    def choose(self, s_hat, c_hat, lam=None):
        lam = self.lam if lam is None else lam
        return np.argmax(s_hat * np.exp(-c_hat / lam), axis=-1)

    def generate_member(self, mi, prompts, max_new=8):
        self.generate_log.append((mi, len(prompts)))
        outs = [np.full(max_new, mi, np.int32) for _ in prompts]
        return outs, self.pool[mi].cost_rate * len(prompts)


def req(text="q", arrival=0.0, deadline=None, forced=-1, pkg=PORT):
    r = pkg.Request(text=text, prompt=np.zeros(4, np.int32), max_new=2,
                    arrival_s=arrival, deadline_s=deadline)
    r.forced_member = forced
    if forced >= 0:
        r.forced_member_name = f"m{forced}"   # members resolve by name
    return r


def make_sched(eng, coordinator, pkg=PORT, **cfg):
    return pkg.MicroBatchScheduler(
        eng, pkg.SchedulerConfig(score_batch=16, max_batch=16, **cfg),
        cascade=coordinator, service_time=lambda kind, n, wall: 1e-3)


def pinned_run(pkg=PORT, n=48):
    """The seed-42 escalation trace of ``tests/test_cascade.py``, on
    ``pkg``'s policy, coordinator, request and scheduler."""
    rng = np.random.default_rng(42)
    texts = [f"t{i}" for i in range(n)]
    quality_of = {
        t: (float(rng.uniform(0.1, 0.9)),
            float(np.clip(rng.uniform(0.1, 0.9) + 0.2, 0, 1)),
            float(rng.uniform(0.85, 1.0)))
        for t in texts}
    eng = FakeCascadeEngine(quality_of=quality_of, lam=30.0)
    coord = pkg.CascadeCoordinator(
        make_policy("R2", pkg, max_legs=3),
        observed_quality=lambda r: quality_of[r.text][r.member])
    sched = make_sched(eng, coord, pkg)
    trace = [req(text=t, arrival=i * 1e-3, forced=0, pkg=pkg) for i, t in enumerate(texts)]
    return sched.run_trace(trace), coord


class TestPortPolicyDecisions:
    """The reference's stop-vs-escalate pins on the port's policy."""

    @pytest.mark.parametrize("reward", ["R1", "R2"])
    def test_good_observed_answer_stops(self, reward):
        d = decide(make_policy(reward), s_cur=0.95, observed=True, lam=5.0)
        assert not d.escalate and d.next_member == -1

    @pytest.mark.parametrize("reward", ["R1", "R2"])
    def test_poor_observed_answer_escalates(self, reward):
        d = decide(make_policy(reward), s_cur=0.1, observed=True, lam=50.0)
        assert d.escalate and d.next_member in (1, 2)
        assert d.expected_gain > 0

    @pytest.mark.parametrize("reward", ["R1", "R2"])
    def test_escalation_monotone_in_lambda(self, reward):
        policy = make_policy(reward)
        rng = np.random.default_rng(0)
        states = [(float(rng.uniform(0.05, 0.95)), float(rng.uniform(0.0, 0.3)))
                  for _ in range(40)]
        counts = [sum(decide(policy, s_cur=s, s_std_cur=sd, lam=lam).escalate
                      for s, sd in states)
                  for lam in (0.5, 2.0, 8.0, 32.0, 128.0)]
        assert counts == sorted(counts)
        assert counts[-1] > counts[0]

    def test_disagreement_discount_flips_stop_to_escalate(self):
        policy = make_policy("R2", gamma=1.0)
        assert not decide(policy, s_cur=0.8, s_std_cur=0.0, lam=10.0).escalate
        assert decide(policy, s_cur=0.8, s_std_cur=0.35, lam=10.0).escalate

    def test_observed_quality_ignores_std(self):
        policy = make_policy("R2", gamma=1.0)
        assert not decide(policy, s_cur=0.8, s_std_cur=0.35, observed=True,
                          lam=10.0).escalate

    def test_max_legs_hard_stop(self):
        policy = make_policy("R2", max_legs=2)
        assert not decide(policy, s_cur=0.1, tried=(0, 1), cum=1.1, lam=100.0).escalate

    def test_headroom_gate_blocks_escalation(self):
        policy = make_policy("R2", min_headroom=0.25)
        base = dict(s_cur=0.1, observed=True, lam=100.0)
        assert decide(policy, headroom=1.0, **base).escalate
        assert not decide(policy, headroom=0.1, **base).escalate

    def test_margin_blocks_marginal_gains(self):
        base = dict(s_cur=0.1, observed=True, lam=100.0)
        assert decide(make_policy("R2", margin=0.0), **base).escalate
        assert not decide(make_policy("R2", margin=10.0), **base).escalate

    def test_candidates_climb_only(self):
        policy = make_policy("R2")
        assert policy.candidates([]) == [0, 1, 2]
        assert policy.candidates([0]) == [1, 2]
        assert policy.candidates([1]) == [2]      # below-top rungs skipped
        assert policy.candidates([0, 2]) == []

    def test_unknown_reward_rejected(self):
        with pytest.raises(ValueError):
            cascade.CascadePolicy([0, 1], reward="R9")


class TestPortMultiLegLifecycle:
    """Re-admission at the queue head, escalation by member name, keep-best,
    rescue at a deadline, the headroom gate and one adapter outcome per
    leg, on the port's scheduler."""

    def test_escalation_readmits_at_queue_head_and_accumulates_cost(self):
        coord = cascade.CascadeCoordinator(make_policy("R2"))
        sched = make_sched(FakeCascadeEngine(lam=10.0), coord)
        for i in range(3):
            sched.queue.offer(req(text=str(i), forced=0), 0.0)
        served1 = sched.dispatch()
        assert served1 == []
        assert sched.queue.depth == 3 and sched.queue.readmitted == 3
        assert all(r.forced_member >= 1 for r in sched.queue.peek_all())
        served2 = sched.dispatch()
        escalated_twice = sched.queue.depth
        while sched.queue.depth:
            served2 += sched.dispatch()
        done = served1 + served2
        assert len(done) == 3
        for r in done:
            assert r.status == port_queue.DONE and r.finalized
            assert len(r.tried) >= 2 and r.tried[0] == 0
            assert r.leg == len(r.tried) == len(r.leg_costs)
            assert r.cum_cost == pytest.approx(sum(LADDER_COSTS[m] for m in r.tried))
            assert r.cum_cost > r.cost
        assert coord.stats["escalations"] >= 3 + escalated_twice

    def test_no_double_finalize_and_telemetry_split_by_leg(self):
        coord = cascade.CascadeCoordinator(make_policy("R2"))
        sched = make_sched(FakeCascadeEngine(lam=10.0), coord)
        trace = [req(text=str(i), arrival=i * 1e-3, forced=0) for i in range(4)]
        summary = sched.run_trace(trace)
        assert summary["completed"] == 4
        assert summary["double_finalize_blocked"] == 0
        assert sum(summary["finalized_by_leg"]) == 4
        assert summary["escalations"] == coord.stats["escalations"] > 0
        assert sum(summary["legs_served"]) == sum(r.leg for r in trace)
        assert summary["legs_served"][0] == 4
        assert all(r.finalized for r in trace)

    def test_keep_best_answer_is_delivered(self):
        quality_of = {"x": (0.2, 0.9, 0.5)}
        pred_of = {"x": (0.2, 0.9, 0.95)}
        eng = FakeCascadeEngine(quality_of=quality_of, pred_of=pred_of, lam=50.0)
        coord = cascade.CascadeCoordinator(
            make_policy("R2"), observed_quality=lambda r: quality_of["x"][r.member])
        sched = make_sched(eng, coord)
        sched.queue.offer(req(text="x", forced=0), 0.0)
        done = []
        for _ in range(4):
            done += sched.dispatch()
            if done:
                break
        (r,) = done
        assert r.tried == [0, 1, 2]
        assert r.best_member == 1 and r.member == 1
        assert (r.output == 1).all()
        assert r.best_q == pytest.approx(0.9)
        assert r.cum_cost == pytest.approx(sum(LADDER_COSTS))

    def test_mixed_feedback_keeps_verified_answer_over_shaky_estimate(self):
        truth = {1: 0.7}
        eng = FakeCascadeEngine(pred_of={"x": (0.75, 0.70, 0.50)}, lam=50.0,
                                std=(0.30, 0.01, 0.05))
        coord = cascade.CascadeCoordinator(make_policy("R2", gamma=1.0),
                                           observed_quality=lambda r: truth.get(r.member))
        sched = make_sched(eng, coord)
        r = req(text="x", forced=0)
        sched.queue.offer(r, 0.0)
        while sched.queue.depth:
            sched.dispatch()
        assert r.tried == [0, 1]
        assert coord.stats["estimated_legs"] == 1
        assert coord.stats["observed_legs"] == 1
        assert r.best_member == 1 and r.best_observed
        assert r.best_q == pytest.approx(0.7)
        assert r.member == 1

    def test_estimated_best_survives_weak_observation_unobserved(self):
        coord = cascade.CascadeCoordinator(make_policy("R2", gamma=1.0))
        r = req(text="x")
        r.s_pred = np.asarray([0.75, 0.3, 0.9])
        r.s_std_pred = np.asarray([0.10, 0.01, 0.05])
        r.c_pred = np.asarray(LADDER_COSTS)
        r.member, r.output = 0, np.zeros(2, np.int32)
        r.tried, r.leg_costs, r.cum_cost = [0], [0.1], 0.1
        coord.on_leg_complete(r, lam=50.0, now=0.0)
        assert not r.best_observed
        assert r.best_q == pytest.approx(0.75)
        assert r.best_q_std == pytest.approx(0.10)

    def test_deadline_mid_cascade_delivers_best_so_far(self):
        coord = cascade.CascadeCoordinator(make_policy("R2"))
        sched = make_sched(FakeCascadeEngine(lam=10.0), coord)
        r = req(text="q", deadline=0.0005, forced=0)
        sched.queue.offer(r, 0.0)
        sched.dispatch()
        assert sched.queue.depth == 1
        sched.clock.advance(1.0)
        assert sched.dispatch() == [r]
        assert r.status == port_queue.DONE and r.finalized
        assert r.output is not None and (r.output == 0).all()
        assert sched.queue.expired == 0
        assert sched.telemetry.completed == 1
        assert coord.stats["finalized"] == 1

    def test_forced_member_beyond_pool_falls_back_to_free_routing(self):
        sched = make_sched(FakeCascadeEngine(lam=10.0),
                           cascade.CascadeCoordinator(make_policy("R2")))
        r = req(text="q", forced=len(LADDER_COSTS) + 3)
        sched.queue.offer(r, 0.0)
        done = []
        while sched.queue.depth:
            done += sched.dispatch()
        assert r in done and r.finalized
        assert all(0 <= m < len(LADDER_COSTS) for m in r.tried)

    def test_forced_member_resolved_by_name_across_index_shift(self):
        eng = FakeCascadeEngine(lam=10.0)
        sched = make_sched(eng, cascade.CascadeCoordinator(make_policy("R2", max_legs=1)))
        del eng.pool[0]
        r = req(text="q", forced=2)
        r.forced_member_name = "m2"
        sched.queue.offer(r, 0.0)
        (done,) = sched.dispatch()
        assert done is r and r.tried == [1]
        assert eng.generate_log == [(1, 1)]
        sched2 = make_sched(FakeCascadeEngine(lam=10.0),
                            cascade.CascadeCoordinator(make_policy("R2", max_legs=1)))
        r2 = req(text="q", forced=0)
        r2.forced_member_name = "gone"
        sched2.queue.offer(r2, 0.0)
        (done2,) = sched2.dispatch()
        assert done2 is r2 and r2.finalized

    def test_headroom_blocked_counts_only_suppressed_escalations(self):
        quality_of = {"poor": (0.1, 0.7, 0.95), "good": (0.95, 0.6, 0.7)}
        gov = BudgetGovernor(1e-6, 1e9, lam0=30.0)   # hopelessly over budget
        gov.record(1.0, 0.0)
        coord = cascade.CascadeCoordinator(
            make_policy("R2", min_headroom=0.5),
            observed_quality=lambda r: quality_of[r.text][r.member], governor=gov)
        sched = make_sched(FakeCascadeEngine(quality_of=quality_of, lam=30.0), coord)
        sched.queue.offer(req(text="poor", forced=0), 0.0)
        sched.queue.offer(req(text="good", forced=0), 0.0)
        while sched.queue.depth:
            sched.dispatch()
        assert coord.stats["escalations"] == 0
        assert coord.stats["headroom_blocked"] == 1

    def test_adapter_observes_every_leg_with_unique_rids(self):
        observed = []

        class SpyAdapter:
            last_explored = np.zeros(0, bool)

            def choose(self, s_hat, c_hat, lam, now):
                self.last_explored = np.zeros(len(s_hat), bool)
                return np.argmax(s_hat, axis=1)

            def observe(self, outcomes, now):
                observed.extend(outcomes)

            def tick(self, now):
                pass

        coord = cascade.CascadeCoordinator(make_policy("R2"))
        sched = MicroBatchScheduler(
            FakeCascadeEngine(lam=10.0), SchedulerConfig(score_batch=8, max_batch=8),
            cascade=coord, adapter=SpyAdapter(), service_time=lambda kind, n, wall: 1e-3)
        r = req(text="a", forced=0)
        sched.queue.offer(r, 0.0)
        while sched.queue.depth:
            sched.dispatch()
        assert len(observed) == coord.stats["legs"] >= 2
        rids = [o.rid for o in observed]
        assert len(set(rids)) == len(rids) and r.rid not in rids
        assert [o.member for o in observed] == r.tried
        assert [o.cost for o in observed] == pytest.approx(
            [LADDER_COSTS[m] for m in r.tried])
        assert [len(o.tried) for o in observed] == list(range(1, len(observed) + 1))

    def test_without_cascade_behavior_unchanged(self):
        sched = MicroBatchScheduler(
            FakeCascadeEngine(lam=10.0), SchedulerConfig(score_batch=8, max_batch=8),
            service_time=lambda kind, n, wall: 1e-3)
        for i in range(3):
            sched.queue.offer(req(text=str(i)), 0.0)
        assert len(sched.dispatch()) == 3
        assert "escalations" not in sched.telemetry.summary()


class TestPortTelemetryFinalizeIdempotent:
    """Idempotent finalize and merged cascade counters on the port's telemetry."""

    def test_double_finalize_counts_once(self):
        t = Telemetry(["a", "b"])
        r = req()
        r.leg = 1
        r.service_start_s, r.finish_s = 0.1, 0.2
        assert t.finalize_request(r) is True
        assert t.finalize_request(r) is False
        assert t.completed == 1
        assert t.e2e_latency.count == 1
        assert t.double_finalize_blocked == 1

    def test_merge_folds_cascade_counters(self):
        a, b = Telemetry(["m"]), Telemetry(["m"])
        for t in (a, b):
            t.record_leg(1, 0.5, 0.8, 0.01)
            t.record_escalation()
        b.record_leg(2, 1.0, 0.9, 0.02)
        a.merge(b)
        assert a.escalations == 2
        assert a.leg_served == [2, 1]
        assert a.leg_spend == pytest.approx([1.0, 1.0])


class TestPortEscalationRegression:
    """The seed-42 pin on the port's scheduler: 47 escalations,
    ``finalized_by_leg == [1, 47]``, an identical replay."""

    def test_pinned_escalation_counts(self):
        summary, coord = pinned_run()
        assert summary["completed"] == 48
        assert summary["escalations"] == 47
        assert summary["finalized_by_leg"] == [1, 47]
        assert coord.escalations_by_leg == [47]
        assert summary["escalation_rate"] == pytest.approx(47 / 48)

    def test_replays_identically(self):
        s1, c1 = pinned_run()
        s2, c2 = pinned_run()
        assert s1["escalations"] == s2["escalations"]
        assert s1["finalized_by_leg"] == s2["finalized_by_leg"]
        assert c1.stats == c2.stats


class TestPortCascadeRewardAccounting:
    """Cumulative cost and keep-best on the port's reward accounting."""

    def test_cumulative_cost_not_last_leg(self):
        q, c = port_rewards.cascade_outcome([0.4, 0.9], [0.1, 5.0])
        assert q == 0.9 and c == pytest.approx(5.1)

    def test_keep_best_vs_replace(self):
        q_best, _ = port_rewards.cascade_outcome([0.8, 0.3], [0.1, 5.0], keep_best=True)
        q_last, _ = port_rewards.cascade_outcome([0.8, 0.3], [0.1, 5.0], keep_best=False)
        assert q_best == 0.8 and q_last == 0.3

    def test_reward_uses_cum_cost(self):
        r_casc = port_rewards.cascade_reward("R1", [0.4, 0.9], [1.0, 2.0], lam=1.0)
        assert r_casc == pytest.approx(0.9 - 3.0)

    def test_empty_or_ragged_legs_rejected(self):
        with pytest.raises(ValueError):
            port_rewards.cascade_outcome([], [])
        with pytest.raises(ValueError):
            port_rewards.cascade_outcome([0.5], [0.1, 0.2])


def test_port_helpers_build_the_ports_classes():
    """The suites above run the port: its policy, coordinator, scheduler
    and request, and the reference's where they are asked for."""
    coord = cascade.CascadeCoordinator(make_policy())
    assert isinstance(coord.policy, cascade.CascadePolicy)
    assert isinstance(make_sched(FakeCascadeEngine(), coord), MicroBatchScheduler)
    assert isinstance(req(), port_queue.Request)
    assert isinstance(req(pkg=REF), JaxRequest)
    assert isinstance(make_policy(pkg=REF), jax_cascade.CascadePolicy)


def test_seed_42_pin_equals_the_references_run():
    """The pinned trace run by both packages' schedulers: the same summary
    counters and coordinator stats."""
    want = pinned_run(REF)
    got = pinned_run(PORT)
    assert isinstance(got[1], cascade.CascadeCoordinator)
    assert isinstance(want[1], jax_cascade.CascadeCoordinator)
    for key in ("completed", "escalations", "finalized_by_leg", "legs_served"):
        assert got[0][key] == want[0][key], key
    assert got[0]["escalations"] == 47 and got[0]["finalized_by_leg"] == [1, 47]
    assert got[1].stats == want[1].stats
    assert got[1].report() == want[1].report()

# ---------------------------------------------------------------------------
# tools/cascade_smoke.py's escalate -> stop trace in both packages
# ---------------------------------------------------------------------------

DQ, LAM = 32, 8.0
COST = np.array([0.2, 1.0, 3.0])
QUAL_EASY = np.array([0.90, 0.92, 0.95])
QUAL_HARD = np.array([0.15, 0.55, 0.92])
N_REQ = 48
STUB_CFG = get_smoke_config("qwen3-0.6b")


class JaxStub:
    def __init__(self, name, cost_rate):
        self.name, self.cost_rate = name, cost_rate

    def generate(self, prompts, max_new=8, attn_mask=None):
        return np.zeros((len(prompts), max_new), np.int32)


class PortStub(JaxStub):
    """The port's engine pads by the member's config and reads a tensor back."""

    cfg = STUB_CFG

    def generate(self, prompts, max_new=8, attn_mask=None):
        return torch.zeros((prompts.shape[0], max_new), dtype=torch.int32)


def _region(rng, n, sign):
    mu = np.zeros(DQ, np.float32)
    mu[: DQ // 2] = 0.8 * sign
    e = rng.normal(0, 0.3, size=(n, DQ)).astype(np.float32) + mu
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _world(rng):
    emb = np.concatenate([_region(rng, 128, +1.0), _region(rng, 128, -1.0)])
    labels = np.concatenate([np.tile(QUAL_EASY, (128, 1)),
                             np.tile(QUAL_HARD, (128, 1))]).astype(np.float32)
    labels += rng.normal(0, 0.03, labels.shape).astype(np.float32)
    memb = rng.random((3, 4)).astype(np.float32)
    boot = rng.poisson(1.0, size=(256, 4)).astype(np.float32)
    return emb, labels, memb, boot


def _jax_router(emb, labels, memb, boot):
    opt = JaxAdamConfig(lr=5e-3)
    step = jax_ensemble_step("attn-ens", opt)
    qp = JAX_PREDICTORS["attn-ens"].init(jax.random.key(0), DQ, 3, memb.shape[1])
    assert qp["bo"].shape[0] == boot.shape[1]
    state = jax_adam_init(opt, qp)
    for _ in range(200):
        _, qp, state = step(qp, state, emb, memb, labels, boot)
    cp = {"w": np.zeros((DQ, 3), np.float32), "b": np.zeros(3, np.float32)}
    return JaxRouter("attn-ens", "reg", qp, cp, memb, reward="R2",
                     cost_scaler={"mu": np.asarray(COST, np.float64),
                                  "sd": np.ones(3, np.float64)})


def _smoke_trace(mod, make_engine, request_cls, sched_cls, sched_cfg):
    rng = np.random.default_rng(0)
    _world(rng)
    engine = make_engine()
    easy, hard = _region(rng, N_REQ // 2, +1.0), _region(rng, N_REQ // 2, -1.0)
    truth, reqs, embs = {}, [], []
    ladder = mod.cost_ladder(engine.router)
    for i in range(N_REQ):
        is_hard = i % 2 == 1
        text = f"{'hard' if is_hard else 'easy'}-{i}"
        truth[text] = QUAL_HARD if is_hard else QUAL_EASY
        r = request_cls(text=text, prompt=np.zeros(2, np.int32), max_new=2, arrival_s=i * 1e-3)
        r.forced_member = int(ladder[0])
        r.forced_member_name = engine.pool[int(ladder[0])].name
        reqs.append(r)
        embs.append(hard[i // 2] if is_hard else easy[i // 2])
    emb_of = {r.text: e for r, e in zip(reqs, embs)}
    engine.embed = lambda texts: np.stack([emb_of[t] for t in texts])
    coord = mod.CascadeCoordinator(
        mod.CascadePolicy(ladder, mod.CascadeConfig(max_legs=3, beta=1.0)),
        observed_quality=lambda r: float(truth[r.text][r.member]))
    sched = sched_cls(engine, sched_cfg(score_batch=16, max_batch=16), cascade=coord,
                      service_time=lambda kind, n, wall: 1e-3)
    return sched.run_trace(reqs), coord, reqs


@pytest.fixture(scope="module")
def smoke_traces(tmp_path_factory):
    """(reference run, port run, port rerun) of the cascade smoke's trace."""
    world = _world(np.random.default_rng(0))
    jr = _jax_router(*world)
    path = str(tmp_path_factory.mktemp("cascade") / "ens.npz")
    jax_ckpt.save_router(path, jr)
    names = ("cheap", "mid", "strong")
    ref = _smoke_trace(jax_cascade, lambda: JaxEngine(
        router=jr, pool=[JaxStub(n, c) for n, c in zip(names, COST)], lam=LAM),
        JaxRequest, JaxScheduler, JaxSchedulerConfig)
    port = [_smoke_trace(cascade, lambda: RoutedEngine(
        router=load_router(path, device="cpu"),
        pool=[PortStub(n, c) for n, c in zip(names, COST)], lam=LAM, device="cpu"),
        port_queue.Request, MicroBatchScheduler, SchedulerConfig) for _ in range(2)]
    return ref, port[0], port[1]


def test_cascade_smoke_trace_equals_the_references(smoke_traces):
    (s_ref, c_ref, r_ref), (s, c, reqs), _ = smoke_traces
    for key in ("completed", "escalations", "finalized_by_leg", "legs_served",
                "double_finalize_blocked"):
        assert s[key] == s_ref[key], key
    assert c.stats == c_ref.stats and c.escalations_by_leg == c_ref.escalations_by_leg
    assert [r.tried for r in reqs] == [r.tried for r in r_ref]
    np.testing.assert_allclose([r.cum_cost for r in reqs], [r.cum_cost for r in r_ref],
                               rtol=0, atol=1e-12)
    easy = [r for r in reqs if r.text.startswith("easy")]
    hard = [r for r in reqs if r.text.startswith("hard")]
    assert s["completed"] == N_REQ and s["double_finalize_blocked"] == 0
    assert np.mean([r.leg == 1 for r in easy]) >= 0.9
    assert np.mean([r.leg > 1 for r in hard]) >= 0.9
    assert np.mean([r.best_q for r in hard]) > 0.8
    assert all(abs(r.cum_cost - sum(r.leg_costs)) < 1e-12 for r in reqs)
    assert s["escalations"] == c.stats["escalations"] > 0


def test_cascade_smoke_trace_replays_identically(smoke_traces):
    _, (s1, c1, r1), (s2, c2, r2) = smoke_traces
    assert s1["escalations"] == s2["escalations"]
    assert s1["finalized_by_leg"] == s2["finalized_by_leg"]
    assert c1.stats == c2.stats and [r.tried for r in r1] == [r.tried for r in r2]


def test_score_emb_uncertainty_is_the_routers_plain_predictor(smoke_traces, tmp_path):
    world = _world(np.random.default_rng(0))
    path = str(tmp_path / "ens.npz")
    jr = _jax_router(*world)
    jax_ckpt.save_router(path, jr)
    eng = RoutedEngine(router=load_router(path, device="cpu"), pool=[], device="cpu")
    q = _region(np.random.default_rng(5), 8, -1.0)
    got = eng.score_emb_uncertainty(q)
    want = jr.predict_with_uncertainty(q)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
    assert (got[1] > 0).all()


# ---------------------------------------------------------------------------
# The serve entry point
# ---------------------------------------------------------------------------

def test_serve_cascade_trace_mode_escalates():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--smoke", "--device", "cpu", "--epochs", "2", "--trace", "neardup",
                    "--cascade", "--semcache", "--requests", "32", "--max-new", "2",
                    "--lam", "0.001"])
    lines = out.getvalue().splitlines()
    assert any(x.startswith("cascade legs: ") for x in lines), lines
    esc = next(x for x in lines if x.startswith("escalations "))
    assert "finalized by leg" in esc
    casc = next(x for x in lines if x.startswith("cascade: legs "))
    assert int(casc.split("escalations ")[1].split()[0]) > 0, casc
    assert any(x.startswith("semcache: ") for x in lines)
