"""The port's routed serving slice against the JAX reference, end to end.

The reference builds its smoke pool and an untrained ``attn`` router with
a float64 cost scaler and saves the router; the port loads that file with
its own ``load_router`` and carries the pool's weights through
``repro_torch.bridge``. Both then serve the same texts and prompts (the
reference through its Pallas kernel in interpret mode) and must agree on
choices, tokens, per-member counts, and total $ to 1e-12 relative. The
pool is the reference's default three members, the mixture-of-experts
granite-moe-1b-a400m among them, so the kernel scores K = 3. A second
pool, qwen3-0.6b, xlstm-1.3b and the jamba hybrid, generates the
reference's tokens on its recurrent members, a 300-token prompt among
them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import load_router as jax_load_router
from repro.checkpoint import save_router as jax_save_router
from repro.configs import get_config as jax_get_config
from repro.core.predictors import PREDICTORS as JAX_PREDICTORS
from repro.core.router import PredictiveRouter as JaxRouter
from repro.data.featurizer import embed_texts as jax_embed_texts
from repro.launch.serve import build_pool as jax_build_pool
from repro.launch.serve import make_parser as jax_make_parser
from repro.launch.serve import pool_quality_columns as jax_pool_quality_columns
from repro.models import lm as jax_lm
from repro.serving.engine import RoutedEngine as JaxEngine
from repro.serving.engine import arch_cost_per_token as jax_arch_cost_per_token
from repro.serving.engine import arch_cost_rate as jax_arch_cost_rate
from repro_torch import bridge
from repro_torch.checkpoint import load_router, save_router
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.featurizer import embed_texts
from repro_torch.data.routerbench import generate
from repro_torch.launch.serve import (
    DEFAULT_POOL, build_engine, init_router, pool_quality_columns, synthetic_requests,
)
from repro_torch.serving.engine import (
    PoolMember, RoutedEngine, arch_cost_per_token, arch_cost_rate, pad_prompts,
    prompt_pad_mask,
)

NAMES = ["qwen3-0.6b", "granite-moe-1b-a400m", "granite-3-8b"]
RECURRENT_POOL = ["qwen3-0.6b", "xlstm-1.3b", "jamba-1.5-large-398b"]
K = len(NAMES)
SCALER = {"mu": np.array([0.02, 0.1, 0.3], np.float64),
          "sd": np.array([0.05, 0.1, 0.2], np.float64)}


def _balancing_shift(s, c):
    """Quality-bias shifts (0, d1, d2) under which the R2 argmax at lambda 1
    picks every member for part of the batch, with the widest gap between
    each text's best and second-best reward among such shifts."""
    e = np.exp(-c.astype(np.float32)).astype(np.float64)
    grids = []
    for m in (1, 2):
        flip = (s[:, 0] * e[:, 0] - s[:, m] * e[:, m]) / e[:, m]
        grids.append(np.linspace(flip.min() - 0.1, flip.max() + 0.1, 161))
    best, best_key = None, None
    for d1 in grids[0]:
        for d2 in grids[1]:
            r = np.sort((s + np.array([0.0, d1, d2])) * e, axis=1)
            choice = np.argmax((s + np.array([0.0, d1, d2])) * e, axis=1)
            counts = np.bincount(choice, minlength=K)
            key = (counts.min(), (r[:, -1] - r[:, -2]).min())
            if counts.min() > 0 and (best_key is None or key > best_key):
                best, best_key = np.array([0.0, d1, d2]), key
    assert best is not None, "no bias shift splits the batch over every member"
    return best


def _jax_router(balance_texts=None):
    qp = JAX_PREDICTORS["attn"].init(jax.random.key(1), 768, K, 20)
    cp = JAX_PREDICTORS["attn"].init(jax.random.key(2), 768, K, 20)
    memb = np.random.default_rng(11).uniform(size=(K, 20)).astype(np.float32)
    router = JaxRouter("attn", "attn", qp, cp, memb, reward="R2",
                       cost_scaler=SCALER, version=3,
                       centroids=np.random.default_rng(12).standard_normal(
                           (20, 768)).astype(np.float32))
    if balance_texts is None:
        return router
    # Lift every quality bias by one amount, so member 0's predicted
    # quality is at least 0.1 and each chosen member's clears a semantic
    # cache's admission floor; then shift members 1 and 2's so the R2
    # choice splits the batch: every member generates, and both packages'
    # generation is compared on each.
    s, c = router.predict(jax_embed_texts(balance_texts))
    s = np.asarray(s, np.float64)
    lift = 0.1 - s[:, 0].min()
    bo = np.asarray(qp["bo"]) + lift + _balancing_shift(s + lift, c)
    return router.with_updates(quality_params={
        **qp, "bo": jax.numpy.asarray(bo.astype(np.float32))})


def _port_pool(jax_pool):
    return [PoolMember(name=m.name, cfg=get_smoke_config(m.name),
                       params=bridge.lm_params_from_jax(
                           get_smoke_config(m.name),
                           jax.tree.map(np.asarray, m.params), "cpu"),
                       cost_rate=arch_cost_rate(get_config(m.name)))
            for m in jax_pool]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    texts, prompts = synthetic_requests(8, 512, seed=5, min_len=3, max_len=14)
    jax_engine = JaxEngine(router=_jax_router(texts),
                           pool=jax_build_pool(NAMES, seed=0), lam=1.0,
                           use_pallas=True)
    path = str(tmp_path_factory.mktemp("ckpt") / "router.npz")
    jax_save_router(path, jax_engine.router, pool_names=NAMES)
    port_engine = RoutedEngine(
        router=load_router(path, expect_pool_names=NAMES, device="cpu"),
        pool=_port_pool(jax_engine.pool), lam=1.0, device="cpu")
    return jax_engine, port_engine, texts, prompts


def test_featurizer_is_bit_identical():
    texts, _ = synthetic_requests(16, 512, seed=3)
    texts += ["", "a", "Ünïcödé prompt"]
    got, want = embed_texts(texts), jax_embed_texts(texts)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_scores_match_reference(engines):
    jax_engine, port_engine, texts, _ = engines
    js, jc = jax_engine.score_texts(texts)
    ps, pc = port_engine.score_texts(texts)
    np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-5)
    assert pc.dtype == jc.dtype == np.float64
    np.testing.assert_allclose(pc, jc, rtol=1e-5, atol=1e-6)
    q_emb = jax_embed_texts(texts)
    np.testing.assert_array_equal(port_engine.router.route(q_emb, 0.5),
                                  jax_engine.router.route(q_emb, 0.5))
    # The plain path (use_kernel off) agrees with the kernel path too.
    port_engine.use_kernel = False
    try:
        np.testing.assert_allclose(port_engine.score_texts(texts)[0], ps,
                                   rtol=1e-5, atol=1e-5)
    finally:
        port_engine.use_kernel = True


def test_serve_matches_reference(engines):
    jax_engine, port_engine, texts, prompts = engines
    ragged = np.empty(len(prompts), dtype=object)
    for i, p in enumerate(prompts):
        ragged[i] = p
    ref = jax_engine.serve(texts, ragged, max_new=4)
    out = port_engine.serve(texts, prompts, max_new=4)
    assert set(ref["choices"].tolist()) == set(range(K)), "every member must generate"
    np.testing.assert_array_equal(out["choices"], ref["choices"])
    np.testing.assert_array_equal(out["per_member_counts"], ref["per_member_counts"])
    for got, want in zip(out["outputs"], ref["outputs"]):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert out["total_cost"] == pytest.approx(ref["total_cost"], rel=1e-12)


def test_generate_member_prices_delivered_tokens(engines):
    jax_engine, port_engine, _, prompts = engines
    caps = [1, 4, 2]
    _, ref_cost = jax_engine.generate_member(1, prompts[:3], max_new=4,
                                             max_new_per_req=caps)
    outs, cost = port_engine.generate_member(1, prompts[:3], max_new=4,
                                             max_new_per_req=caps)
    assert [len(o) for o in outs] == [4, 4, 4]
    np.testing.assert_allclose(cost, ref_cost, rtol=1e-12, atol=0)


def test_choose_rounds_r2_like_reference(engines):
    """R2 on float64 costs is taken in float32, as JAX with x64 off does."""
    jax_engine, port_engine, _, _ = engines
    rng = np.random.default_rng(0)
    s = rng.uniform(size=(2000, 2)).astype(np.float32)
    c = rng.uniform(0, 0.5, size=(2000, 2))
    np.testing.assert_array_equal(port_engine.choose(s, c, 0.7),
                                  jax_engine.choose(s, c, 0.7))


def test_swap_router_rejects_stale_versions(engines):
    _, port_engine, _, _ = engines
    live = port_engine.router
    with pytest.raises(ValueError, match="new router object"):
        port_engine.swap_router(live)
    with pytest.raises(ValueError, match="stale"):
        port_engine.swap_router(dataclasses.replace(live))
    port_engine.pool_projections()
    try:
        port_engine.swap_router(live.with_updates())
        assert port_engine.router.version == live.version + 1
        assert port_engine._pool_proj is None
    finally:
        port_engine.router = live
        port_engine.refresh_pool()


def test_jax_checkpoint_loads_bitwise_in_port(tmp_path):
    router = _jax_router()
    path = str(tmp_path / "r.npz")
    jax_save_router(path, router, pool_names=NAMES)
    got = load_router(path, expect_pool_names=NAMES, device="cpu")
    for mine, theirs in [(got.quality_params, router.quality_params),
                         (got.cost_params, router.cost_params)]:
        assert mine.keys() == theirs.keys()
        for k in theirs:
            want = np.asarray(theirs[k])
            assert mine[k].numpy().dtype == want.dtype
            np.testing.assert_array_equal(mine[k].numpy(), want)
    for k in ("mu", "sd"):
        assert got.cost_scaler[k].dtype == np.float64
        assert got.cost_scaler[k].tobytes() == SCALER[k].tobytes()
    np.testing.assert_array_equal(got.model_emb, router.model_emb)
    np.testing.assert_array_equal(got.centroids, router.centroids)
    assert (got.version, got.reward, got.quality_kind) == (3, "R2", "attn")
    with pytest.raises(ValueError, match="misroute"):
        load_router(path, expect_pool_names=NAMES[::-1], device="cpu")


def test_port_checkpoint_loads_bitwise_in_jax(tmp_path):
    router = init_router(K, seed=4, device="cpu")
    router.cost_scaler = SCALER
    path = str(tmp_path / "r.npz")
    save_router(path, router, pool_names=NAMES)
    got = jax_load_router(path, expect_pool_names=NAMES)
    for mine, theirs in [(router.quality_params, got.quality_params),
                         (router.cost_params, got.cost_params)]:
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_array_equal(np.asarray(theirs[k]), mine[k].numpy())
            assert np.asarray(theirs[k]).dtype == np.float32
    for k in ("mu", "sd"):
        assert got.cost_scaler[k].tobytes() == SCALER[k].tobytes()
    np.testing.assert_array_equal(got.model_emb, router.model_emb)
    assert got.centroids is None and got.version == router.version
    # Same file keys in the same order as the reference writes them.
    ref_path = str(tmp_path / "ref.npz")
    jax_save_router(ref_path, got, pool_names=NAMES)
    with np.load(path) as a, np.load(ref_path) as b:
        assert a.files == b.files
        assert bytes(a["__repro_meta__"]) == bytes(b["__repro_meta__"])


@pytest.mark.parametrize("name", NAMES + RECURRENT_POOL[1:])
def test_cost_rates_match_reference(name):
    assert arch_cost_rate(get_config(name)) == jax_arch_cost_rate(jax_get_config(name))


def test_moe_member_is_priced_by_its_active_parameters():
    """granite-moe's rate counts its top-8 of 32 experts: the pool's
    cheapest member per token, below the dense qwen3-0.6b."""
    cfg = get_config("granite-moe-1b-a400m")
    assert (cfg.param_count(), cfg.active_param_count()) == (1_385_480_192, 479_510_528)
    per_token = arch_cost_per_token(cfg)
    assert per_token == jax_arch_cost_per_token(jax_get_config("granite-moe-1b-a400m"))
    assert per_token == pytest.approx(2.1098463232e-07, rel=1e-10)
    assert per_token < arch_cost_per_token(get_config("qwen3-0.6b"))


def test_requests_are_seeded_and_in_vocab():
    a = synthetic_requests(6, 100, seed=1)
    b = synthetic_requests(6, 100, seed=1)
    assert a[0] == b[0]
    for p, q in zip(a[1], b[1]):
        np.testing.assert_array_equal(p, q)
        assert 16 <= len(p) <= 128 and p.min() >= 0 and p.max() < 100


def test_default_pool_is_the_references_and_trains_for_three_members():
    """The reference's default pool, in its order; the router trains for
    K = 3, and cost order maps granite-moe (the cheapest per token) to the
    cheapest API model's quality column, as the reference maps it."""
    names = DEFAULT_POOL.split(",")
    assert DEFAULT_POOL == jax_make_parser().get_default("pool")
    engine = build_engine(names, smoke=True, device="cpu", epochs=2, n_traffic=200)
    assert engine.router.n_members == 3
    assert [m.name for m in engine.pool] == names
    data = generate(200, seed=0)
    cols = pool_quality_columns(engine.pool, data)
    assert cols == jax_pool_quality_columns(jax_build_pool(names, seed=0), data)
    assert cols[names.index("granite-moe-1b-a400m")] == int(np.argmin(data.cost.mean(0)))
    s, c = engine.score_texts(["prove the integral converges", "write a short poem"])
    assert s.shape == c.shape == (2, 3) and np.isfinite(s).all()


@pytest.mark.parametrize("member", RECURRENT_POOL[1:])
def test_recurrent_members_generate_the_references_tokens(member):
    """The reference's smoke pool with xlstm-1.3b and jamba, carried across:
    ``generate_member`` on prompts of 300, 7 and 40 tokens gives the
    reference's greedy tokens on the batch the port pads (512 wide for
    xlstm's mLSTM chunk, 300 for jamba), and the delivered-token charge."""
    jax_pool = jax_build_pool(RECURRENT_POOL, seed=0)
    engine = RoutedEngine(router=init_router(3, device="cpu"),
                          pool=_port_pool(jax_pool), device="cpu")
    mi = RECURRENT_POOL.index(member)
    cfg, jmember = engine.pool[mi].cfg, jax_pool[mi]
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32) for n in (300, 7, 40)]
    tok, mask = pad_prompts(prompts, cfg), prompt_pad_mask(prompts, cfg)
    assert tok.shape[1] == (512 if member == "xlstm-1.3b" else 300)
    want = np.asarray(jax_lm.greedy_generate(jmember.cfg, jmember.params,
                                             jnp.asarray(tok.numpy()), 3,
                                             attn_mask=jnp.asarray(mask.numpy())))
    outs, costs = engine.generate_member(mi, prompts, max_new=3)
    np.testing.assert_array_equal(np.stack(outs), want)
    per_tok = jmember.cost_rate / 256
    np.testing.assert_allclose(costs, [per_tok * (len(p) + 3) for p in prompts], rtol=1e-12)


def test_recurrent_pool_trains_and_serves():
    """``build_engine`` on the recurrent pool: the router trains for K = 3
    and serves through every member's prefill and decode."""
    engine = build_engine(RECURRENT_POOL, smoke=True, device="cpu", epochs=2, n_traffic=200)
    assert engine.router.n_members == 3
    texts, prompts = synthetic_requests(6, 512, seed=2, min_len=3, max_len=20)
    res = engine.serve(texts, prompts, max_new=3)
    assert all(len(o) == 3 and 0 <= o.min() and o.max() < 512 for o in res["outputs"])
    for mi in range(3):
        outs, _ = engine.generate_member(mi, prompts[:2], max_new=2)
        assert all(len(o) == 2 for o in outs)
