"""The port's online layer against the JAX reference, on the CPU.

Every piece of ``repro_torch.online`` is held against its counterpart in
``repro.online`` on the same numpy inputs, made from a seed. The host
numpy modules (replay, staging, exploration) agree exactly; the ones that
step or score a router (membership, updater, the adapter) take the
reference's router across by the npz checkpoint format, so both start
from the same parameters. Tolerances: model embeddings within 1e-7,
updater params and losses within 1e-5; the adapter's counters equal, and
its choices equal wherever the top two biased rewards of the reference
lie more than 1e-5 apart. The reference's replay-buffer properties
(``tests/test_replay_properties.py``) are written out here against the
port's buffer, and the reference's online checks (swap atomicity,
staging, hot membership) against the port's adapter; no module of either
package is patched. The ``--online`` trace mode of the port's serve entry
point runs at smoke size.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro import checkpoint as jax_ckpt
from repro import online as jax_online
from repro.core.predictors import PREDICTORS as JAX_PREDICTORS
from repro.core.router import PredictiveRouter as JaxRouter
from repro.serving import DONE as JAX_DONE
from repro.serving import Request as JaxRequest
from repro.serving import RoutedEngine as JaxEngine
from repro.training import AdamConfig as JaxAdamConfig
from repro.training import adam_init as jax_adam_init
from repro.training import make_predictor_step as jax_predictor_step
from repro_torch import online
from repro_torch.checkpoint import load_router
from repro_torch.common.tree import flatten_with_paths
from repro_torch.launch import serve
from repro_torch.serving.engine import RoutedEngine
from repro_torch.serving.queue import DONE, Request


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, so that parallel test
    workers do not each start one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

DQ, K, DM = 16, 2, 4
COSTS = (0.2, 1.0)


def _emb(rng, n, sign=1.0):
    e = rng.normal(0, 0.4, size=(n, DQ)).astype(np.float32)
    e[:, : DQ // 2] += 0.8 * sign
    return e / np.linalg.norm(e, axis=1, keepdims=True)


class StubMember:
    def __init__(self, name, cost_rate):
        self.name, self.cost_rate = name, cost_rate


def _jax_router(seed=0, quality_kind="attn"):
    """The reference tests' stub router: seeded ``quality_kind`` head, an
    exact ``reg`` cost head with the member rates as bias, centroids."""
    rng = np.random.default_rng(seed)
    memb = rng.random((K, DM)).astype(np.float32)
    qp = JAX_PREDICTORS[quality_kind].init(jax.random.key(seed), DQ, K, DM)
    cp = {"w": np.zeros((DQ, K), np.float32), "b": np.asarray(COSTS, np.float32)}
    return JaxRouter(quality_kind, "reg", qp, cp, memb, reward="R2",
                     cost_scaler=None, centroids=_emb(rng, 4))


def _port_router(jax_router, tmp_path, name="router.npz"):
    path = str(tmp_path / name)
    jax_ckpt.save_router(path, jax_router)
    return load_router(path, device="cpu")


def _engines(tmp_path, seed=0):
    """(reference engine, port engine) over the same router and stub pool."""
    jr = _jax_router(seed)
    pool = lambda: [StubMember(f"m{i}", c) for i, c in enumerate(COSTS)]  # noqa: E731
    return (JaxEngine(router=jr, pool=pool(), lam=2.0),
            RoutedEngine(router=_port_router(jr, tmp_path), pool=pool(), lam=2.0,
                         device="cpu"))


def _snapshot(params):
    return {k: v.detach().clone() for k, v in flatten_with_paths(params).items()}


def _unchanged(params, snap):
    flat = flatten_with_paths(params)
    return flat.keys() == snap.keys() and all(torch.equal(flat[k], v) for k, v in snap.items())


# ---------------------------------------------------------------------------
# Replay buffer
# ---------------------------------------------------------------------------

def test_replay_samples_equal_the_references():
    rng = np.random.default_rng(0)
    embs = rng.random((300, DQ)).astype(np.float32)
    bufs = [mod.ReplayBuffer(capacity=64, recent_frac=0.25, seed=7)
            for mod in (jax_online, online)]
    for buf in bufs:
        for i in range(300):
            buf.add(embs[i], i % 3, i / 300.0, 0.1 * (i % 5), float(i))
            if i == 150:
                buf.drop_member(1)
    for n, frac in ((32, 0.5), (7, 0.25), (64, 0.9)):
        want, got = (buf.sample(n, recent_frac=frac) for buf in bufs)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(bufs[1].member_counts(3), bufs[0].member_counts(3))
    assert online.ReplayBuffer(capacity=8).sample(4) is None


# The reference's replay-buffer properties (tests/test_replay_properties.py)
# on the port's buffer. Written out here, with the stream helper of that
# file, rather than by subclassing: the same @given method run from two
# classes fails hypothesis's differing_executors health check.

def _fill(buf, n, dq=8):
    for i in range(n):
        buf.add(np.full(dq, i % 17, np.float32), i % 3, i / max(n, 1), 0.1, float(i))
    return buf


@given(st.integers(2, 128), st.integers(0, 400))
@settings(max_examples=40, deadline=None)
def test_replay_sizes_and_boundary(capacity, n_items):
    buf = _fill(online.ReplayBuffer(capacity=capacity, recent_frac=0.25, seed=3),
                          n_items)
    assert len(buf) <= capacity and buf.added == n_items
    ring_ts = [item[4] for item in buf._recent]
    n_ring = min(n_items, buf.cap_recent)
    assert ring_ts == [float(t) for t in range(n_items - n_ring, n_items)]
    n_evicted = max(0, n_items - buf.cap_recent)
    assert buf._evicted == n_evicted
    assert len(buf._reservoir) == min(n_evicted, buf.cap_reservoir)
    res_ts = [item[4] for item in buf._reservoir]
    if res_ts and ring_ts:
        assert max(res_ts) < min(ring_ts)
    assert all(t < n_evicted for t in res_ts)


@given(st.integers(2, 64), st.floats(0.1, 0.9))
@settings(max_examples=30, deadline=None)
def test_replay_region_caps_partition_capacity(capacity, recent_frac):
    buf = online.ReplayBuffer(capacity=capacity, recent_frac=recent_frac, seed=0)
    assert buf.cap_recent >= 1 and buf.cap_recent + buf.cap_reservoir == capacity
    _fill(buf, 3 * capacity)
    assert len(buf._recent) == buf.cap_recent
    assert len(buf._reservoir) <= buf.cap_reservoir


def test_replay_inclusion_rate_uniform_over_evicted_stream():
    n, capacity, trials = 200, 40, 400
    counts = np.zeros(n)
    for seed in range(trials):
        buf = _fill(online.ReplayBuffer(capacity=capacity, recent_frac=0.25,
                                                  seed=seed), n)
        for item in buf._reservoir:
            counts[int(item[4])] += 1
    n_evicted = n - buf.cap_recent
    expect = buf.cap_reservoir / n_evicted
    inc = counts[:n_evicted] / trials
    assert np.isclose(inc[: n_evicted // 2].mean(), expect, rtol=0.1)
    assert np.isclose(inc[n_evicted // 2:].mean(), expect, rtol=0.1)
    assert (counts[n_evicted:] == 0).all()
    res_ts = [item[4] for item in _fill(
        online.ReplayBuffer(capacity=40, recent_frac=0.25, seed=0), 500)._reservoir]
    assert min(res_ts) < 150 and max(res_ts) > 300


@given(st.integers(4, 96), st.floats(0.1, 0.8))
@settings(max_examples=20, deadline=None)
def test_replay_fixed_seed_replays_identically(capacity, recent_frac):
    b1, b2 = (_fill(online.ReplayBuffer(capacity=capacity, recent_frac=recent_frac,
                                                  seed=11), 150) for _ in range(2))
    for _ in range(3):
        s1, s2 = b1.sample(24, recent_frac=0.5), b2.sample(24, recent_frac=0.5)
        for key in ("q_emb", "member", "s", "c", "t"):
            np.testing.assert_array_equal(s1[key], s2[key])


@given(st.integers(8, 64))
@settings(max_examples=20, deadline=None)
def test_replay_sample_strata_come_from_their_regions(n):
    buf = _fill(online.ReplayBuffer(capacity=64, recent_frac=0.25, seed=2), 256)
    ring_lo = min(item[4] for item in buf._recent)
    s = buf.sample(n, recent_frac=0.5)
    assert abs(int((s["t"] >= ring_lo).sum()) - round(n * 0.5)) <= 1


# ---------------------------------------------------------------------------
# Rewards and exploration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reward", ["R1", "R2"])
@pytest.mark.parametrize("lam", [1e-5, 0.01, 2.0])
def test_reward_matrix_rounds_as_the_references_rewards(reward, lam):
    """The engine's float32 scores and float64 costs through the
    reference's ``REWARDS`` (numpy in, as ``OnlineAdapter.choose`` calls
    it) and the port's ``reward_matrix``: the same dtype, values within one
    float32 ulp-scale step (1e-6 relative; R2's exp is another library's),
    equal zeros where float32 underflows."""
    from repro.core.rewards import REWARDS as JAX_REWARDS
    from repro_torch.core.rewards import reward_matrix

    rng = np.random.default_rng(7)
    s = rng.uniform(size=(32, 4)).astype(np.float32)
    c = rng.uniform(0.0, 2e-3, size=(32, 4))
    want = np.asarray(JAX_REWARDS[reward](s, c, lam))
    got = reward_matrix(reward, s, c, lam)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got == 0, want == 0)


def test_exploration_choices_equal_the_references():
    rng = np.random.default_rng(3)
    cfgs = [mod.ExplorationConfig(epsilon=0.3, bonus=0.05, seed=4)
            for mod in (jax_online, online)]
    pols = [mod.ExplorationPolicy(3, cfg) for mod, cfg in zip((jax_online, online), cfgs)]
    for step in range(12):
        rewards = rng.uniform(size=(16, 3))
        mask = None if step % 3 == 0 else np.array([True, step % 2 == 0, True])
        headroom = (1.0, 0.5, 0.0, 1.7)[step % 4]
        (cw, ew), (cg, eg) = (p.choose(rewards, mask, headroom) for p in pols)
        np.testing.assert_array_equal(cg, cw)
        np.testing.assert_array_equal(eg, ew)
        assert cg.dtype == cw.dtype and eg.dtype == ew.dtype
        for p in pols:
            p.record(cw)
        if step == 5:
            for p in pols:
                p.add_member()
            rng_rewards = rng.uniform(size=(4, 4))
            (cw, _), (cg, _) = (p.choose(rng_rewards) for p in pols)
            np.testing.assert_array_equal(cg, cw)
            for p in pols:
                p.remove_member(3)
    np.testing.assert_array_equal(pols[1].counts, pols[0].counts)
    with pytest.raises(ValueError):
        pols[1].choose(np.zeros((2, 5)))


# ---------------------------------------------------------------------------
# Staged feedback
# ---------------------------------------------------------------------------

class _Req:
    def __init__(self, rid, finish_s=0.0, member=0):
        self.rid, self.finish_s, self.member = rid, finish_s, member


def _stage_script(mod):
    """Out-of-order delivery, early deliveries past the FIFO cap, and
    timeouts; returns everything the stage reports."""
    stage = mod.OutcomeStage(timeout_s=1.0, early_capacity=3)
    log = []
    reqs = [_Req(i) for i in range(8)]
    for r in reqs[:5]:
        stage.stage(r, now=0.0)
    stage.deliver(3, 0.3, now=0.1)
    stage.deliver(1, 0.1, now=0.2)
    stage.deliver(1, 0.15, now=0.25)           # a second score replaces the first
    for rid in (100, 101, 102, 103, 7):        # early: for never-staged rids
        stage.deliver(rid, rid / 1000.0, now=0.3)
    log.append([(r.rid, s) for r, s in stage.flush(now=0.4)])
    stage.stage(reqs[7], now=0.5)              # its feedback raced completion
    stage.deliver(0, 0.0, now=0.6)
    log.append([(r.rid, s) for r, s in stage.flush(now=0.7)])
    log.append([(r.rid, s) for r, s in stage.flush(now=2.0)])   # 2 and 4 expire
    stage.deliver(2, 0.2, now=2.1)             # late: held, never committed
    log.append([(r.rid, s) for r, s in stage.flush(now=5.0)])
    return log, (stage.staged, stage.resolved, stage.expired, stage.early_deliveries,
                 len(stage), sorted(stage._early))


def _feedback_script(mod):
    fb = mod.DelayedFeedback(lambda r: 0.25 + 0.5 * r.member, 0.1, jitter_s=0.05, seed=6)
    for i in range(12):
        assert fb(_Req(i, finish_s=0.01 * i, member=i % 2)) is None
    return [fb.due(t) for t in (0.05, 0.12, 0.16, 1.0)], fb.in_flight


def test_staging_equals_the_references():
    want, got = _stage_script(jax_online), _stage_script(online)
    assert got == want
    assert want[0][0] == [(1, 0.15), (3, 0.3)]          # staged order, not delivery order
    assert want[1][2] == 2                              # rids 2 and 4 expired
    want_fb, got_fb = _feedback_script(jax_online), _feedback_script(online)
    assert got_fb == want_fb and got_fb[1] == 0


# ---------------------------------------------------------------------------
# Membership
# ---------------------------------------------------------------------------

def _membership_script(eng, mod, rng_seed=0):
    out = []
    tracker = mod.MembershipTracker(eng, min_outcomes=5)
    idx = tracker.add_member(StubMember("new", 0.05))
    out.append((idx, tracker.exploit_mask().tolist(), tracker.model_emb.copy()))
    rng = np.random.default_rng(rng_seed)
    for i in range(6):
        tracker.record_outcome(idx, _emb(rng, 1)[0], 0.5 + 0.08 * i)
        tracker.record_outcome(i % 2, _emb(rng, 1)[0], 0.9)
        out.append((tracker.counts.tolist(), tracker.exploit_mask().tolist(),
                    tracker.model_emb.copy(), tracker.emb_dirty))
    tracker.remove_member(0)
    out.append((tracker.counts.tolist(), tracker.model_emb.copy(), len(eng.pool)))
    refresh = mod.MembershipTracker(eng, refresh_established=True, refresh_rate=0.2)
    for i in range(20):
        refresh.record_outcome(i % 2, _emb(rng, 1, -1.0)[0], 0.1 * (i % 7))
    out.append((refresh.counts.tolist(), refresh.model_emb.copy(), refresh.emb_dirty))
    return out


def test_membership_equals_the_references(tmp_path):
    jeng, teng = _engines(tmp_path)
    want, got = _membership_script(jeng, jax_online), _membership_script(teng, online)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
            else:
                assert a == b
    assert teng.router.n_members == jeng.router.n_members == 2
    assert teng.router.version == jeng.router.version == 2


# ---------------------------------------------------------------------------
# Incremental updater
# ---------------------------------------------------------------------------

def _filled_replay(mod, seed=0, n=48):
    rng = np.random.default_rng(seed)
    buf = mod.ReplayBuffer(capacity=64, seed=seed)
    for i in range(n):
        buf.add(_emb(rng, 1)[0], i % K, float(rng.uniform()), COSTS[i % K] + 0.01 * i, i)
    return buf


@pytest.mark.parametrize("quality_kind", ["attn", "attn-ens"])
def test_updater_steps_equal_the_references(tmp_path, quality_kind):
    """8 masked Adam steps on the same replay, with a per-member cost
    scaler, from one router carried across: params and losses within
    1e-5, and the live router's tensors unchanged by steps and publish."""
    jr = _jax_router(1, quality_kind)
    jr.cost_scaler = {"mu": np.asarray(COSTS, np.float64), "sd": np.asarray([0.5, 2.0])}
    tr = _port_router(jr, tmp_path)
    cfg = dict(batch_size=16, lr_quality=3e-3, lr_cost=1e-3)
    jup = jax_online.IncrementalUpdater(jr, jax_online.OnlineUpdateConfig(**cfg))
    tup = online.IncrementalUpdater(tr, online.OnlineUpdateConfig(**cfg))
    snap_q, snap_c = _snapshot(tr.quality_params), _snapshot(tr.cost_params)
    jres = jup.run_steps(_filled_replay(jax_online), jr.model_emb, 8)
    tres = tup.run_steps(_filled_replay(online), tr.model_emb, 8)
    assert tres["steps"] == jres["steps"] == 8
    for key in ("quality_loss", "cost_loss"):
        assert abs(tres[key] - jres[key]) <= 1e-5 * max(1.0, abs(jres[key]))
    for got, want in ((tup.q_params, jup.q_params), (tup.c_params, jup.c_params)):
        want = flatten_with_paths(jax.tree.map(np.asarray, want))
        got = flatten_with_paths(got)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-5)
    assert _unchanged(tr.quality_params, snap_q) and _unchanged(tr.cost_params, snap_c)
    eng = RoutedEngine(router=tr, pool=[StubMember("a", 0.2), StubMember("b", 1.0)],
                       device="cpu")
    staging = np.array(tr.model_emb, copy=True)
    published = tup.publish(eng, staging)
    assert eng.router is published and published.version == tr.version + 1
    assert published.model_emb is not staging
    staging[0, 0] += 1.0
    assert published.model_emb[0, 0] != staging[0, 0]
    assert _unchanged(tr.quality_params, snap_q) and _unchanged(tr.cost_params, snap_c)
    assert not _unchanged(published.quality_params, snap_q)


def test_updater_on_an_empty_replay_takes_no_step(tmp_path):
    tr = _port_router(_jax_router(2), tmp_path)
    res = online.IncrementalUpdater(tr).run_steps(online.ReplayBuffer(capacity=8),
                                                  tr.model_emb, 4)
    assert res["steps"] == 0 and np.isnan(res["quality_loss"])


# ---------------------------------------------------------------------------
# The adapter: tools/online_smoke.py's drift -> adapt -> recover cycle
# ---------------------------------------------------------------------------

SMOKE_DQ, SMOKE_LAM = 32, 2.0
SMOKE_COST = np.array([0.2, 1.0])
QUAL_A, QUAL_B = np.array([0.45, 0.85]), np.array([0.80, 0.35])
BATCH, N_A, N_B, N_RECOVER = 16, 6, 18, 6


def _region(rng, n, sign):
    mu = np.zeros(SMOKE_DQ, np.float32)
    mu[: SMOKE_DQ // 2] = 0.8 * sign
    e = rng.normal(0, 0.4, size=(n, SMOKE_DQ)).astype(np.float32) + mu
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _smoke_world(rng):
    """The smoke's draws: the offline corpus over both regions and its
    noisy pre-drift labels (the port discards the labels: its router
    arrives trained)."""
    emb = np.concatenate([_region(rng, 192, +1.0), _region(rng, 64, -1.0)])
    quality = (np.tile(QUAL_A, (256, 1)) + rng.normal(0, 0.05, (256, 2))).astype(np.float32)
    return emb, quality


def _smoke_jax_router(emb, quality):
    memb = np.stack([np.full(4, q) for q in QUAL_A]).astype(np.float32)
    opt = JaxAdamConfig(lr=3e-3)
    step = jax_predictor_step("attn", opt)
    qp = JAX_PREDICTORS["attn"].init(jax.random.key(0), SMOKE_DQ, 2, memb.shape[1])
    state = jax_adam_init(opt, qp)
    for _ in range(30):
        _, qp, state = step(qp, state, emb, memb, quality)
    cp = {"w": np.zeros((SMOKE_DQ, 2), np.float32), "b": np.asarray(SMOKE_COST, np.float32)}
    return JaxRouter("attn", "reg", qp, cp, memb, reward="R2", cost_scaler=None,
                     centroids=emb[:4].copy())


def _run_cycle(mod, make_engine, request_cls, done, drift_kw):
    rng = np.random.default_rng(0)
    emb, _ = _smoke_world(rng)
    engine = make_engine()
    truth, seen = {}, []
    adapter = mod.OnlineAdapter(
        engine, lambda req: float(truth[req.rid][req.member]),
        config=mod.OnlineUpdateConfig(update_every=32, steps_per_update=8, burst_steps=32,
                                      batch_size=32, min_buffer=16),
        exploration=mod.ExplorationConfig(epsilon=0.1, seed=0),
        drift=mod.DriftDetector(window=32, threshold=3.0, seed=0, **drift_kw).fit(
            emb[:192], engine.router.centroids),
        seed=0)
    choose = adapter.policy.choose

    def spy(rewards, exploit_mask=None, headroom=1.0):
        biased = np.asarray(rewards, np.float64) + (
            adapter.policy.config.bonus / np.sqrt(adapter.policy.counts + 1.0))[None]
        seen.append(np.sort(biased, axis=1))
        return choose(rewards, exploit_mask, headroom)

    adapter.policy.choose = spy
    phases = ["A"] * N_A + ["B"] * (N_B + N_RECOVER)
    choices_log, alarms_at, now = [], [], 0.0
    for bi, phase in enumerate(phases):
        q = _region(rng, BATCH, +1.0 if phase == "A" else -1.0)
        s_hat, c_hat = engine.score_emb(q)
        choices = adapter.choose(s_hat, c_hat, engine.lam, now)
        reqs = []
        for e, m in zip(q, choices):
            r = request_cls(text="", prompt=np.zeros(1, np.int32))
            r.q_emb, r.member, r.status = e, int(m), done
            r.cost = float(SMOKE_COST[int(m)])
            truth[r.rid] = QUAL_A if phase == "A" else QUAL_B
            reqs.append(r)
        before = adapter.stats["drift_alarms"]
        adapter.observe(reqs, now)
        if adapter.stats["drift_alarms"] > before:
            alarms_at.append(bi)
        choices_log.append(np.asarray(choices))
        now += 0.1
    return adapter, choices_log, alarms_at, seen


@pytest.fixture(scope="module")
def smoke_cycles(tmp_path_factory):
    """(reference run, port run, port rerun) of the online smoke's cycle."""
    emb, quality = _smoke_world(np.random.default_rng(0))
    jr = _smoke_jax_router(emb, quality)
    path = tmp_path_factory.mktemp("online") / "smoke.npz"
    jax_ckpt.save_router(str(path), jr)
    pool = lambda: [StubMember("cheap", SMOKE_COST[0]), StubMember("pricey", SMOKE_COST[1])]  # noqa: E731
    ref = _run_cycle(jax_online, lambda: JaxEngine(router=_smoke_jax_router(emb, quality),
                                                   pool=pool(), lam=SMOKE_LAM),
                     JaxRequest, JAX_DONE, {})
    port = [_run_cycle(online, lambda: RoutedEngine(router=load_router(str(path), device="cpu"),
                                                    pool=pool(), lam=SMOKE_LAM, device="cpu"),
                       Request, DONE, {"device": "cpu"}) for _ in range(2)]
    return ref, port[0], port[1]


def test_online_cycle_counters_equal_the_references(smoke_cycles):
    (ja, jc, jal, jseen), (ta, tc, tal, _), _ = smoke_cycles
    for key in ("drift_alarms", "bursts", "updates", "update_steps", "router_swaps",
                "outcomes", "explored"):
        assert ta.stats[key] == ja.stats[key], key
    assert ta.engine.router.version == ja.engine.router.version >= 2
    assert tal == jal and ja.stats["drift_alarms"] >= 1 and ja.stats["bursts"] >= 1
    compared = 0
    for got, want, sorted_biased in zip(tc, jc, jseen):
        clear = (sorted_biased[:, -1] - sorted_biased[:, -2]) > 1e-5
        np.testing.assert_array_equal(got[clear], want[clear])
        compared += int(clear.sum())
    assert compared >= 0.9 * (N_A + N_B + N_RECOVER) * BATCH
    post_b = np.mean([np.mean(c == 0) for c in tc[-N_RECOVER:]])
    pre_b = np.mean([np.mean(c == 0) for c in tc[N_A:N_A + 2]])
    assert post_b > 0.8 >= 0.5 > pre_b            # the port's routing flipped to cheap on B
    assert abs(ta.stats["last_quality_loss"] - ja.stats["last_quality_loss"]) < 1e-4


def test_online_cycle_replays_bit_identically(smoke_cycles):
    _, (a1, c1, al1, _), (a2, c2, al2, _) = smoke_cycles
    assert a1.stats == a2.stats and al1 == al2
    assert all(np.array_equal(x, y) for x, y in zip(c1, c2))
    p1 = flatten_with_paths(a1.engine.router.quality_params)
    p2 = flatten_with_paths(a2.engine.router.quality_params)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert a1.report() == a2.report() and a1.report().startswith("online: outcomes ")


# ---------------------------------------------------------------------------
# The reference's adapter checks on the port
# ---------------------------------------------------------------------------

def _port_engine(tmp_path, seed=0):
    return _engines(tmp_path, seed)[1]


def _adapter(eng, **cfg):
    return online.OnlineAdapter(
        eng, lambda r: 0.5,
        config=online.OnlineUpdateConfig(**{"update_every": 10 ** 9, "min_buffer": 1,
                                            "batch_size": 8, **cfg}),
        seed=0)


def test_live_router_never_mutated_and_model_emb_copied(tmp_path):
    eng = _port_engine(tmp_path)
    adapter = _adapter(eng, steps_per_update=2)
    idx = adapter.add_member(StubMember("new", 0.05))
    assert idx == 2 and eng.router.n_members == 3 and len(eng.pool) == 3
    rng = np.random.default_rng(0)
    for i in range(16):
        adapter.replay.add(_emb(rng, 1)[0], i % K, 0.5, 0.2)
    live = eng.router
    snap = _snapshot(live.quality_params)
    adapter._update(2)
    assert eng.router is not live and _unchanged(live.quality_params, snap)
    live = eng.router
    assert live.model_emb is not adapter.membership.model_emb
    frozen = np.array(live.model_emb[idx], copy=True)
    adapter.membership.record_outcome(idx, _emb(rng, 1)[0], 0.99)
    np.testing.assert_array_equal(live.model_emb[idx], frozen)


def test_hot_added_member_scores_and_stays_out_of_exploitation(tmp_path):
    eng = _port_engine(tmp_path)
    adapter = online.OnlineAdapter(eng, lambda r: 0.5,
                                   exploration=online.ExplorationConfig(epsilon=0.5, seed=1),
                                   seed=0)
    adapter.add_member(StubMember("new", 0.05))
    q = _emb(np.random.default_rng(1), 64)
    s_hat, c_hat = eng.score_emb(q)
    assert s_hat.shape == c_hat.shape == (64, 3)
    s_plain, _ = eng.router.predict(q)
    np.testing.assert_allclose(s_hat, s_plain, rtol=0, atol=1e-5)
    choices = adapter.choose(s_hat, c_hat, 2.0)
    explored = adapter.last_explored
    assert explored.any() and (choices[~explored] != 2).all()


def test_remove_member_remaps_replay_policy_and_pool(tmp_path):
    eng = _port_engine(tmp_path)
    adapter = online.OnlineAdapter(eng, lambda r: 0.5, seed=0)
    rng = np.random.default_rng(2)
    for i in range(12):
        adapter.replay.add(_emb(rng, 1)[0], i % 2, 0.5, 0.1)
    adapter.remove_member(0)
    assert len(eng.pool) == 1 and eng.router.n_members == 1
    assert adapter.policy.n_members == 1
    assert adapter.replay.member_counts(1)[0] == 6
    assert eng.score_emb(_emb(rng, 4))[0].shape == (4, 1)
    assert adapter.stats["members_removed"] == 1 and adapter.stats["router_swaps"] == 1


def test_staged_adapter_commits_in_staged_order_and_drops_timeouts(tmp_path):
    eng = _port_engine(tmp_path, seed=5)
    pending = {}
    adapter = online.OnlineAdapter(
        eng, lambda r: pending.get(r.rid),
        config=online.OnlineUpdateConfig(update_every=10 ** 9, min_buffer=4, batch_size=8),
        stage=online.OutcomeStage(timeout_s=1.0), seed=5)
    rng = np.random.default_rng(1)
    reqs = []
    for _ in range(4):
        r = Request(text="t", prompt=np.zeros(1, np.int32))
        r.q_emb, r.member, r.cost, r.status = rng.normal(0, 1, DQ).astype(np.float32), 0, 0.2, DONE
        reqs.append(r)
    adapter.observe(reqs, now=0.0)
    assert len(adapter.replay) == 0 and adapter.stats["staged"] == 4
    for r, s in ((reqs[2], 0.9), (reqs[0], 0.1), (reqs[1], 0.5)):
        adapter.deliver_feedback(r.rid, s, now=0.1)
    adapter.tick(now=0.4)
    assert [s for (_, _, s, _, _) in adapter.replay._recent] == [0.1, 0.5, 0.9]
    adapter.tick(now=5.0)
    assert adapter.stats["outcomes"] == 3 and adapter.stats["feedback_expired"] == 1
    assert "staged 4 (resolved 3, expired 1)" in adapter.report()


# ---------------------------------------------------------------------------
# The serve entry point
# ---------------------------------------------------------------------------

def _serve(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(argv)
    return out.getvalue()


def test_serve_online_trace_mode_updates_the_router():
    text = _serve(["--smoke", "--device", "cpu", "--epochs", "2", "--trace", "drift",
                   "--online", "--requests", "40", "--max-new", "2",
                   "--budget", "0.05", "--feedback-delay", "0.001"])
    line = next(x for x in text.splitlines() if x.startswith("online: "))
    updates = int(line.split("updates ")[1].split()[0])
    assert updates > 0, line
    assert "staged 40 (resolved" in line and "expired 0" in line
    assert "budget $0.0500/0.5s window" in text
