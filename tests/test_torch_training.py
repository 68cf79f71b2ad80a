"""The port's optimizer and predictor trainer against the JAX reference,
and the training slice end to end.

Every run here starts from the reference's own initial params (drawn from
``jax.random``, which torch cannot reproduce) carried over by
``repro_torch.bridge``; batch order and bootstrap weights are numpy on
both sides. Tolerances:

  * ``cosine_lr`` at t = 1, t_max/2, t_max, t_max + 5 and two AdamW
    updates with weight decay: rtol 1e-6;
  * ``train_predictor``, each kind, 5 epochs over the 300 training rows of
    ``generate(400, seed=0)``'s pool1 (real featurizer embeddings), batch
    64, ``eval_every`` 2: loss histories rtol 1e-4, best params atol 1e-4;
  * ten masked and ten ensemble steps from the same params, batches,
    members and bootstrap weights: losses rtol 1e-5;
  * the slice: pool1 model embeddings from the reference's k-means start,
    ``train_dual_predictors("attn", "attn", epochs=10)``, the lambda sweep
    and ``evaluate_sweep`` as the reference's benchmark does them: equal
    choices wherever the reference's top two R2 rewards differ by more
    than 1e-5, AIQ and ``perf_max`` within 1e-4.

With real-valued targets a ReLU unit's gate can part between the two
packages' float32 sums when its input lies within rounding of 0; on pool1
none does in these runs (their params agree to 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_router as jax_load_router
from repro.checkpoint import save_router as jax_save_router
from repro.core.clustering import _kmeanspp_init
from repro.core.model_repr import build_model_embeddings as jax_build_model_embeddings
from repro.core.predictors import PREDICTORS as JAX_PREDICTORS
from repro.core.router import PredictiveRouter as JaxRouter
from repro.core.router import evaluate_sweep as jax_evaluate_sweep
from repro.data import POOLS
from repro.data import generate as jax_generate
from repro.training import optim as jax_optim
from repro.training import predictor_trainer as jax_trainer
from repro_torch import bridge
from repro_torch.checkpoint import load_router, save_router
from repro_torch.common.tree import flatten_with_paths
from repro_torch.core.metrics import DEFAULT_LAMBDA_GRID
from repro_torch.core.model_repr import build_model_embeddings
from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.router import PredictiveRouter, evaluate_sweep
from repro_torch.training import optim
from repro_torch.training import predictor_trainer as trainer

KINDS = list(PREDICTORS)
DQ, DM = 768, 20
POOL1 = POOLS["pool1"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return bridge.router_params_from_jax(_np(tree), "cpu")


def _flat(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_with_paths(tree).items()}


def _assert_trees_close(got, want, **tol):
    got, want = _flat(got), _flat(_np(want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.fixture(scope="module")
def pool1():
    """pool1 of ``generate(400, seed=0)``: split, and the reference's model
    embeddings of the training rows."""
    data = jax_generate(400, seed=0).pool("pool1")
    tr, va, te = data.split(seed=0)
    memb, centers = jax_build_model_embeddings(data.emb[tr], data.quality[tr], seed=0)
    return data, tr, va, te, memb, centers


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eta_min", [0.0, 1e-5])
def test_cosine_lr_matches_reference(eta_min):
    kw = dict(lr=1e-3, t_max=40, eta_min=eta_min)
    for t in (1, 20, 40, 45):
        want = float(jax_optim.cosine_lr(jax_optim.AdamConfig(**kw), jnp.asarray(t, jnp.int32)))
        got = optim.cosine_lr(optim.AdamConfig(**kw), torch.tensor(t, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert float(optim.cosine_lr(optim.AdamConfig(lr=3e-4), torch.tensor(7))) == \
        pytest.approx(3e-4, rel=1e-7)


def test_schedule_starts_at_t1_and_clamps_at_t_max():
    cfg = optim.AdamConfig(lr=1e-3, t_max=10)
    assert float(optim.cosine_lr(cfg, torch.tensor(10))) == 0.0
    assert float(optim.cosine_lr(cfg, torch.tensor(15))) == 0.0      # no second cycle
    params = {"w": torch.ones(3)}
    state = optim.adam_init(cfg, params)
    _, state = optim.adam_update(cfg, {"w": torch.ones(3)}, state, params)
    assert int(state.step) == 1                                      # lr(t = 1) was used


@pytest.mark.parametrize("kind", ["attn", "2fcn", "attn-ens"])
def test_adam_updates_with_weight_decay_match_reference(kind):
    cfg_kw = dict(lr=1e-2, weight_decay=1e-3, t_max=7)
    params = JAX_PREDICTORS[kind].init(jax.random.key(0), DQ, 5, DM)
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                          params) for _ in range(2)]
    jcfg, pcfg = jax_optim.AdamConfig(**cfg_kw), optim.AdamConfig(**cfg_kw)
    jp, js = params, jax_optim.adam_init(jcfg, params)
    pp, ps = _port(params), optim.adam_init(pcfg, _port(params))
    for g in grads:
        jp, js = jax_optim.adam_update(jcfg, g, js, jp)
        pp, ps = optim.adam_update(pcfg, _port(g), ps, pp)
    assert int(ps.step) == int(js.step) == 2 and ps.step.dtype == torch.int32
    _assert_trees_close(pp, jp, rtol=1e-6, atol=1e-9)
    _assert_trees_close(ps.m, js.m, rtol=1e-6, atol=1e-12)
    _assert_trees_close(ps.v, js.v, rtol=1e-6, atol=1e-12)


def test_make_train_step_matches_reference():
    cfg_kw = dict(lr=5e-3, weight_decay=1e-4, t_max=3)
    params = {"w": jnp.asarray(np.random.default_rng(2).standard_normal((6, 2)), jnp.float32)}
    x = np.random.default_rng(3).standard_normal((9, 6)).astype(np.float32)
    jstep = jax_optim.make_train_step(jax_optim.AdamConfig(**cfg_kw),
                                      lambda p, x: jnp.mean((x @ p["w"]) ** 2))
    pstep = optim.make_train_step(optim.AdamConfig(**cfg_kw),
                                  lambda p, x: torch.mean((x @ p["w"]) ** 2))
    jp, js = params, jax_optim.adam_init(jax_optim.AdamConfig(**cfg_kw), params)
    pp, ps = _port(params), optim.adam_init(optim.AdamConfig(**cfg_kw), _port(params))
    for _ in range(3):
        jl, jp, js = jstep(jp, js, jnp.asarray(x))
        pl, pp, ps = pstep(pp, ps, torch.from_numpy(x))
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    _assert_trees_close(pp, jp, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# predictor_trainer
# ---------------------------------------------------------------------------

CFG = dict(lr=1e-3, weight_decay=1e-5, batch_size=64, epochs=5, seed=0, eval_every=2)


@pytest.mark.parametrize("kind", KINDS)
def test_train_predictor_matches_reference(pool1, kind):
    data, tr, va, _, memb, _ = pool1
    args = (kind, data.emb[tr], data.quality[tr], memb)
    val = (data.emb[va], data.quality[va])
    want, want_hist = jax_trainer.train_predictor(*args, jax_trainer.TrainConfig(**CFG), val)
    init = JAX_PREDICTORS[kind].init(jax.random.key(CFG["seed"]), DQ, 5, DM)
    got, got_hist = trainer.train_predictor(*args, trainer.TrainConfig(**CFG), val,
                                            init_params=_port(init), device="cpu")
    assert len(got_hist["train_loss"]) == 5 and len(got_hist["val_loss"]) == 3
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got_hist[key], want_hist[key], rtol=1e-4, err_msg=key)
    _assert_trees_close(got, want, atol=1e-4, rtol=0)


def _batches(pool1, n_steps, b=32, seed=5):
    data, tr, _, _, memb, _ = pool1
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        idx = rng.choice(tr, size=b, replace=False)
        yield (data.emb[idx].astype(np.float32), data.quality[idx].astype(np.float32),
               rng.integers(0, 5, size=b), rng.poisson(1.0, size=(b, 4)).astype(np.float32))


@pytest.mark.parametrize("kind", ["attn", "reg", "2fcn", "attn-ens"])
def test_masked_steps_match_reference(pool1, kind):
    memb = pool1[4]
    cfg_kw = dict(lr=1e-3, weight_decay=1e-5, t_max=10)
    jstep = jax_trainer.make_masked_predictor_step(kind, jax_optim.AdamConfig(**cfg_kw))
    pstep = trainer.make_masked_predictor_step(kind, optim.AdamConfig(**cfg_kw))
    params = JAX_PREDICTORS[kind].init(jax.random.key(4), DQ, 5, DM)
    jp, js = params, jax_optim.adam_init(jax_optim.AdamConfig(**cfg_kw), params)
    pp, ps = _port(params), optim.adam_init(optim.AdamConfig(**cfg_kw), _port(params))
    m = torch.from_numpy(memb)
    for q, t, member, _ in _batches(pool1, 10):
        target = t[np.arange(len(t)), member]
        jl, jp, js = jstep(jp, js, jnp.asarray(q), jnp.asarray(memb),
                           jnp.asarray(member, jnp.int32), jnp.asarray(target))
        pl, pp, ps = pstep(pp, ps, torch.from_numpy(q), m, torch.from_numpy(member),
                           torch.from_numpy(target))
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)


def test_ensemble_steps_match_reference(pool1):
    memb = pool1[4]
    cfg_kw = dict(lr=1e-3, weight_decay=1e-5, t_max=10)
    jstep = jax_trainer.make_ensemble_predictor_step("attn-ens", jax_optim.AdamConfig(**cfg_kw))
    pstep = trainer.make_ensemble_predictor_step("attn-ens", optim.AdamConfig(**cfg_kw))
    params = JAX_PREDICTORS["attn-ens"].init(jax.random.key(6), DQ, 5, DM)
    jp, js = params, jax_optim.adam_init(jax_optim.AdamConfig(**cfg_kw), params)
    pp, ps = _port(params), optim.adam_init(optim.AdamConfig(**cfg_kw), _port(params))
    m = torch.from_numpy(memb)
    for q, t, _, w in _batches(pool1, 10, seed=7):
        jl, jp, js = jstep(jp, js, jnp.asarray(q), jnp.asarray(memb), jnp.asarray(t),
                           jnp.asarray(w))
        pl, pp, ps = pstep(pp, ps, torch.from_numpy(q), m, torch.from_numpy(t),
                           torch.from_numpy(w))
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)


def test_best_params_are_the_best_validation_epoch_not_the_last(pool1):
    """A high learning rate makes the validation loss rise again; the
    returned params must still score the lowest validation loss seen."""
    data, tr, va, _, memb, _ = pool1
    cfg = trainer.TrainConfig(lr=0.05, weight_decay=0.0, batch_size=32, epochs=12,
                              seed=0, eval_every=1)
    val = (data.emb[va], data.quality[va])
    params, hist = trainer.train_predictor("2fcn", data.emb[tr], data.quality[tr], memb,
                                           cfg, val, device="cpu")
    best = int(np.argmin(hist["val_loss"]))
    assert best < len(hist["val_loss"]) - 1, "the run must end past its best epoch"
    with torch.no_grad():
        vl = float(torch.mean((PREDICTORS["2fcn"].apply(
            params, torch.from_numpy(val[0].astype(np.float32)), torch.from_numpy(memb))
            - torch.from_numpy(val[1].astype(np.float32))) ** 2))
    assert vl == pytest.approx(hist["val_loss"][best], rel=1e-6)


def test_steps_per_epoch_drops_the_tail_and_seed_draws_the_init(pool1):
    data, tr, _, _, memb, _ = pool1
    cfg = trainer.TrainConfig(batch_size=128, epochs=2, seed=3)
    _, hist = trainer.train_predictor("reg", data.emb[tr], data.quality[tr], memb, cfg,
                                      device="cpu")
    assert len(hist["train_loss"]) == 2 and hist["val_loss"] == []
    a, _ = trainer.train_predictor("reg", data.emb[tr[:50]], data.quality[tr[:50]], memb,
                                   dataclasses.replace(cfg, epochs=1), device="cpu")
    b, _ = trainer.train_predictor("reg", data.emb[tr[:50]], data.quality[tr[:50]], memb,
                                   dataclasses.replace(cfg, epochs=1), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)                   # one step from seed 3


def test_dual_cost_scaler_matches_reference_and_constant_columns_normalize_to_zero(pool1):
    data, tr, va, _, memb, _ = pool1
    cost = np.stack([np.full(len(tr), 0.01), np.full(len(tr), 0.3)], axis=1)
    *_, scaler, hist = trainer.train_dual_predictors(
        "reg", "reg", data.emb[tr], data.quality[tr][:, :2], cost, memb[:2], epochs=1,
        device="cpu")
    *_, want, _ = jax_trainer.train_dual_predictors(
        "reg", "reg", data.emb[tr], data.quality[tr][:, :2], cost, memb[:2], epochs=1)
    for key in ("mu", "sd"):
        assert scaler[key].dtype == np.float64
        np.testing.assert_array_equal(scaler[key], want[key])
    np.testing.assert_allclose(scaler["sd"], 1e-9, rtol=0, atol=1e-14)   # std ~ 0 + 1e-9
    assert set(hist) == {"quality", "cost"}


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(pool1):
    """The attn/attn router trained for 10 epochs by both packages from the
    reference's initial params, the port's model embeddings from the
    reference's k-means start."""
    data, tr, va, _, memb_ref, _ = pool1
    start = np.array(_kmeanspp_init(jax.random.key(0), jnp.asarray(data.emb[tr], jnp.float32),
                                    20))
    memb, centers = build_model_embeddings(data.emb[tr], data.quality[tr], seed=0,
                                           device="cpu", init_centers=start)
    np.testing.assert_array_equal(memb, memb_ref)
    split = dict(q_emb_val=data.emb[va], quality_val=data.quality[va],
                 cost_val=data.cost[va], epochs=10, seed=0)
    args = ("attn", "attn", data.emb[tr], data.quality[tr], data.cost[tr])
    jqp, jcp, jscaler, _ = jax_trainer.train_dual_predictors(*args, memb_ref, **split)
    qp, cp, scaler, _ = trainer.train_dual_predictors(
        *args, memb, **split, device="cpu",
        quality_init=_port(JAX_PREDICTORS["attn"].init(jax.random.key(0), DQ, 5, DM)),
        cost_init=_port(JAX_PREDICTORS["attn"].init(jax.random.key(1), DQ, 5, DM)))
    ref = JaxRouter("attn", "attn", jqp, jcp, memb_ref, reward="R2", cost_scaler=jscaler)
    port = PredictiveRouter("attn", "attn", qp, cp, memb, reward="R2", cost_scaler=scaler,
                            centroids=centers)
    return ref, port


def test_trained_router_sweep_matches_reference(pool1, trained):
    data, _, _, te, _, _ = pool1
    ref, port = trained
    lams = DEFAULT_LAMBDA_GRID
    want, got = ref.sweep(data.emb[te], lams), port.sweep(data.emb[te], lams)
    s, c = ref.predict(data.emb[te])
    r2 = np.stack([np.asarray(s * jnp.exp(-jnp.asarray(c) / lam)) for lam in lams])
    top2 = np.sort(r2, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])

    m_want = jax_evaluate_sweep(want, data.quality[te], data.cost[te], lams)
    m_got = evaluate_sweep(got, data.quality[te], data.cost[te], lams)
    for key in ("aiq", "perf_max"):
        assert abs(m_got[key] - m_want[key]) <= 1e-4, key


def test_trained_routers_cross_as_checkpoints(pool1, trained, tmp_path):
    data, _, _, te, _, _ = pool1
    ref, port = trained
    q = data.emb[te]
    path = str(tmp_path / "port.npz")
    save_router(path, port, pool_names=POOL1)
    loaded = jax_load_router(path, expect_pool_names=POOL1)
    for got, want in zip(loaded.predict(q), port.predict(q)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(loaded.centroids, port.centroids)
    path = str(tmp_path / "ref.npz")
    jax_save_router(path, ref, pool_names=POOL1)
    loaded = load_router(path, expect_pool_names=POOL1, device="cpu")
    for got, want in zip(loaded.predict(q), ref.predict(q)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
