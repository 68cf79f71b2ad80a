"""The port's ``PredictiveRouter`` against the JAX reference: pool growth
and shrinkage, the ensemble's uncertainty, router checkpoints of every
kind, and the engine's router-swap hook.

Params come from the reference's ``init`` (carried over by
``repro_torch.bridge``). ``add_member`` / ``remove_member`` must give the
reference's params, model embeddings and cost scaler, and equal
predictions, within atol 1e-6, for each kind with a pool axis (``attn``,
``reg``, ``attn-ens``, ``2fcn``, ``3fcn``); a pool-free kind passes
through unchanged. ``predict_with_uncertainty`` is a population std over
heads (ddof 0). Checkpoints cross both ways for all nine kinds, 0-d leaves
and the (H, d, K) ensemble head included, and predict the same.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_router as jax_load_router
from repro.checkpoint import save_router as jax_save_router
from repro.core.predictors import PREDICTORS as JAX_PREDICTORS
from repro.core.router import PredictiveRouter as JaxRouter
from repro.obs.trace import TraceRecorder
from repro_torch import bridge
from repro_torch.checkpoint import load_router, save_router
from repro_torch.common.tree import flatten_with_paths
from repro_torch.core.predictors import ENSEMBLE_KINDS, PREDICTORS
from repro_torch.core.router import PredictiveRouter
from repro_torch.launch.serve import build_pool, init_router
from repro_torch.serving.engine import RoutedEngine
from repro_torch.serving.scheduler import MicroBatchScheduler, SchedulerConfig

K, DQ, DM = 5, 768, 20
POOL_AXIS_KINDS = ["attn", "reg", "attn-ens", "2fcn", "3fcn"]
SCALER = {"mu": np.array([0.01, 0.02, 0.05, 0.1, 0.3]),
          "sd": np.array([0.002, 0.01, 0.02, 0.05, 0.2])}


def _routers(quality_kind, cost_kind="attn"):
    """The same router in both packages."""
    qp = JAX_PREDICTORS[quality_kind].init(jax.random.key(1), DQ, K, DM)
    cp = JAX_PREDICTORS[cost_kind].init(jax.random.key(2), DQ, K, DM)
    memb = np.random.default_rng(3).uniform(size=(K, DM)).astype(np.float32)
    ref = JaxRouter(quality_kind, cost_kind, qp, cp, memb, cost_scaler=SCALER, version=2)
    port = PredictiveRouter(
        quality_kind, cost_kind, bridge.router_params_from_jax(jax.tree.map(np.asarray, qp), "cpu"),
        bridge.router_params_from_jax(jax.tree.map(np.asarray, cp), "cpu"), memb,
        cost_scaler=SCALER, version=2)
    return ref, port


def _queries(n=23, seed=4):
    q = np.random.default_rng(seed).standard_normal((n, DQ))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _assert_same_router(port, ref, atol=1e-6):
    for got, want in ((port.quality_params, ref.quality_params),
                      (port.cost_params, ref.cost_params)):
        got, want = flatten_with_paths(got), flatten_with_paths(jax.tree.map(np.asarray, want))
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=atol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(port.model_emb, ref.model_emb)
    for key in ("mu", "sd"):
        np.testing.assert_allclose(port.cost_scaler[key], ref.cost_scaler[key], rtol=1e-15)
    assert port.version == ref.version and port.n_members == ref.n_members
    q = _queries()
    for g, w in zip(port.predict(q), ref.predict(q)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("kind", POOL_AXIS_KINDS)
def test_add_member_matches_reference(kind):
    ref, port = _routers(kind)
    row = np.random.default_rng(5).uniform(size=DM)
    _assert_same_router(port.add_member(row), ref.add_member(row))
    _assert_same_router(port.add_member(), ref.add_member())


@pytest.mark.parametrize("kind", POOL_AXIS_KINDS)
@pytest.mark.parametrize("idx", [0, 2, 4])
def test_remove_member_matches_reference(kind, idx):
    ref, port = _routers(kind, cost_kind=kind)
    _assert_same_router(port.remove_member(idx), ref.remove_member(idx))


@pytest.mark.parametrize("kind", ["reg-emb", "2fcn-emb", "3fcn-emb", "attn-dot"])
def test_pool_free_kinds_pass_through_unchanged(kind):
    ref, port = _routers(kind, cost_kind=kind)
    grown = port.add_member()
    assert grown.quality_params is port.quality_params
    assert grown.cost_params is port.cost_params
    assert port.remove_member(1).quality_params is port.quality_params
    _assert_same_router(grown, ref.add_member(), atol=1e-5)


def test_add_member_leaves_the_old_router_unchanged():
    _, port = _routers("attn")
    before = {k: v.clone() for k, v in port.quality_params.items()}
    grown = port.add_member()
    assert all(torch.equal(port.quality_params[k], before[k]) for k in before)
    assert grown.quality_params["wo"].shape == (20, K + 1) and port.n_members == K


def test_remove_member_bounds():
    _, port = _routers("attn")
    with pytest.raises(IndexError):
        port.remove_member(K)
    lone = dataclasses.replace(port, model_emb=port.model_emb[:1])
    with pytest.raises(ValueError, match="last pool member"):
        lone.remove_member(0)


@pytest.mark.parametrize("kind", ["attn-ens", "attn", "2fcn"])
def test_predict_with_uncertainty_matches_reference(kind):
    ref, port = _routers(kind)
    q = _queries(31, seed=6)
    for g, w in zip(port.predict_with_uncertainty(q), ref.predict_with_uncertainty(q)):
        assert g.shape == (31, K)
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


def test_ensemble_std_is_the_population_std():
    _, port = _routers("attn-ens")
    q = _queries(9, seed=7)
    _, std, _ = port.predict_with_uncertainty(q)
    heads = ENSEMBLE_KINDS["attn-ens"](port.quality_params, torch.from_numpy(q).float(),
                                       port.model_emb_tensor()).numpy()
    np.testing.assert_allclose(std, heads.std(axis=0, ddof=0), atol=1e-7, rtol=0)
    assert (std > 0).all()


@pytest.mark.parametrize("kind", ["attn", "2fcn", "reg-emb"])
def test_sweep_matches_reference(kind):
    ref, port = _routers(kind, cost_kind=kind)
    q = _queries(40, seed=8)
    lams = np.logspace(-4.5, 1.5, 25)
    np.testing.assert_array_equal(port.sweep(q, lams), ref.sweep(q, lams))
    np.testing.assert_array_equal(port.route(q, 0.01), ref.route(q, 0.01))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(PREDICTORS))
def test_checkpoint_round_trips_both_ways(kind, tmp_path):
    ref, port = _routers(kind, cost_kind=kind)
    port = dataclasses.replace(port, centroids=np.ones((20, DQ), np.float32))
    q = _queries(11, seed=9)
    path = str(tmp_path / "port.npz")
    save_router(path, port, pool_names=list("abcde"))
    back = load_router(path, expect_pool_names=list("abcde"), device="cpu")
    for key, t in flatten_with_paths(port.quality_params).items():
        got = flatten_with_paths(back.quality_params)[key]
        assert got.shape == t.shape and got.dtype == t.dtype and torch.equal(got, t), key
    for g, w in zip(back.predict(q), port.predict(q)):
        np.testing.assert_array_equal(g, w)
    assert back.centroids.shape == (20, DQ) and back.version == 2
    from_ref = jax_load_router(path, expect_pool_names=list("abcde"))
    for g, w in zip(from_ref.predict(q), port.predict(q)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)

    path = str(tmp_path / "ref.npz")
    jax_save_router(path, ref)
    into_port = load_router(path, device="cpu")
    for g, w in zip(into_port.predict(q), ref.predict(q)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    for key in ("mu", "sd"):
        assert into_port.cost_scaler[key].dtype == np.float64


# ---------------------------------------------------------------------------
# the engine's swap hook
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    return RoutedEngine(router=init_router(2, device="cpu"),
                        pool=build_pool(["qwen3-0.6b", "granite-3-8b"], smoke=True,
                                        device="cpu"), device="cpu")


def test_swap_under_a_traced_scheduler_emits_router_swap(engine):
    tracer = TraceRecorder()
    MicroBatchScheduler(engine, SchedulerConfig(), tracer=tracer)
    assert engine.on_swap is not None
    new = engine.router.with_updates()
    engine.swap_router(new)
    swaps = [e for e in tracer.events if e[0] == "router_swap"]
    assert len(swaps) == 1 and swaps[0][7] == {"version": new.version}
    assert engine.router is new


def test_stale_publish_calls_nothing():
    calls = []
    eng = RoutedEngine(router=init_router(2, device="cpu").with_updates(), pool=[],
                       device="cpu", on_swap=calls.append)
    with pytest.raises(ValueError, match="stale router publish"):
        eng.swap_router(init_router(2, device="cpu"))
    with pytest.raises(ValueError, match="new router object"):
        eng.swap_router(eng.router)
    assert calls == []
    eng.swap_router(eng.router.with_updates())
    assert calls == [2]
