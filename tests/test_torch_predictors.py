"""The port's nine predictor kinds against the JAX reference.

Params come from the reference's own ``init`` and cross into the port
through ``repro_torch.bridge.router_params_from_jax``; queries (B, 768)
and model embeddings (K, 20) come from a numpy seed. Each kind's
``apply``, the ensemble's per-head (H, B, K) scores and the MSE gradient
must agree within atol 1e-5, rtol 1e-5. The port's own ``init`` must give
the reference's tree (paths, shapes, dtypes) on the generator's device.
The reference's shape, gradient and pool-freedom tests are mirrored.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.predictors import ENSEMBLE_KINDS as JAX_ENSEMBLE_KINDS
from repro.core.predictors import PREDICTORS as JAX_PREDICTORS
from repro_torch import bridge
from repro_torch.common.tree import flatten_with_paths, nest_flat
from repro_torch.core import predictors as P
from repro_torch.core.predictors import (
    ATTN_LATENT, ENSEMBLE_HEADS, ENSEMBLE_KINDS, MLP_HIDDEN, PREDICTORS, attention_scores,
)

KINDS = list(PREDICTORS)
DQ, K, DM, B = 768, 5, 20, 37


def _inputs(seed=0, b=B, k=K):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, DQ))
    q /= np.linalg.norm(q, axis=1, keepdims=True)        # as the featurizer gives
    m = rng.uniform(size=(k, DM))
    return q.astype(np.float32), m.astype(np.float32)


def _jax_params(kind, seed=0, k=K):
    return jax.tree.map(np.asarray, JAX_PREDICTORS[kind].init(jax.random.key(seed), DQ, k, DM))


def _port(tree):
    return bridge.router_params_from_jax(tree, "cpu")


def test_port_has_the_reference_kinds_and_constants():
    assert list(PREDICTORS) == list(JAX_PREDICTORS)
    assert {k: p.pool_free for k, p in PREDICTORS.items()} == \
        {k: p.pool_free for k, p in JAX_PREDICTORS.items()}
    assert list(ENSEMBLE_KINDS) == list(JAX_ENSEMBLE_KINDS)
    assert (ATTN_LATENT, MLP_HIDDEN, ENSEMBLE_HEADS) == (20, 256, 4)


@pytest.mark.parametrize("kind", KINDS)
def test_apply_matches_reference(kind):
    params = _jax_params(kind)
    q, m = _inputs()
    want = np.asarray(JAX_PREDICTORS[kind].apply(params, jnp.asarray(q), jnp.asarray(m)))
    got = PREDICTORS[kind].apply(_port(params), torch.from_numpy(q), torch.from_numpy(m))
    assert got.shape == (B, K) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_ensemble_heads_match_reference():
    params = _jax_params("attn-ens")
    q, m = _inputs(1)
    want = np.asarray(JAX_ENSEMBLE_KINDS["attn-ens"](params, jnp.asarray(q), jnp.asarray(m)))
    got = ENSEMBLE_KINDS["attn-ens"](_port(params), torch.from_numpy(q), torch.from_numpy(m))
    assert got.shape == (ENSEMBLE_HEADS, B, K)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        PREDICTORS["attn-ens"].apply(_port(params), torch.from_numpy(q),
                                     torch.from_numpy(m)).numpy(),
        want.mean(axis=0), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_mse_gradients_match_reference(kind):
    params = _jax_params(kind, seed=3)
    q, m = _inputs(2)
    t = np.random.default_rng(4).uniform(size=(B, K)).astype(np.float32)

    def jax_loss(p):
        return jnp.mean((JAX_PREDICTORS[kind].apply(p, jnp.asarray(q), jnp.asarray(m))
                         - jnp.asarray(t)) ** 2)

    want = flatten_with_paths(jax.tree.map(np.asarray, jax.grad(jax_loss)(params)))
    leaves = {k: v.requires_grad_(True) for k, v in flatten_with_paths(_port(params)).items()}
    loss = torch.mean((PREDICTORS[kind].apply(nest_flat(leaves), torch.from_numpy(q),
                                              torch.from_numpy(m)) - torch.from_numpy(t)) ** 2)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(grads) == set(want)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], atol=1e-5, rtol=1e-5, err_msg=path)


@pytest.mark.parametrize("kind", KINDS)
def test_init_makes_the_reference_tree_on_the_generators_device(kind):
    want = {k: (v.shape, v.dtype) for k, v in flatten_with_paths(_jax_params(kind)).items()}
    got = flatten_with_paths(PREDICTORS[kind].init(torch.Generator().manual_seed(0), DQ, K, DM))
    assert {k: (tuple(v.shape), v.numpy().dtype) for k, v in got.items()} == want
    assert all(v.device.type == "cpu" for v in got.values())


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_flow_and_outputs_finite(kind):
    params = PREDICTORS[kind].init(torch.Generator().manual_seed(0), DQ, K, DM)
    q, m = (torch.from_numpy(a) for a in _inputs(5))
    leaves = list(flatten_with_paths(params).values())
    for leaf in leaves:
        leaf.requires_grad_(True)
    out = PREDICTORS[kind].apply(params, q, m)
    assert out.shape == (B, K) and bool(torch.isfinite(out).all())
    grads = torch.autograd.grad(torch.mean((out - 0.5) ** 2), leaves)
    norms = [float(g.abs().sum()) for g in grads]
    assert all(np.isfinite(norms)) and sum(norms) > 0.0


def test_attention_weights_are_simplex():
    params = PREDICTORS["attn"].init(torch.Generator().manual_seed(1), DQ, K, DM)
    q, m = (torch.from_numpy(a) for a in _inputs(6))
    _, alpha = attention_scores(params, q, m)
    assert alpha.shape == (B, K)
    torch.testing.assert_close(alpha.sum(-1), torch.ones(B), atol=1e-5, rtol=0)
    assert float(alpha.min()) >= 0.0


def test_pool_free_predictors_accept_new_models():
    """emb/dot kinds score a grown pool without retraining; emb kinds keep
    the original columns exactly."""
    q, m5 = (torch.from_numpy(a) for a in _inputs(7))
    m7 = torch.cat([m5, torch.from_numpy(_inputs(8, k=2)[1])])
    for kind, pred in PREDICTORS.items():
        if not pred.pool_free:
            continue
        params = pred.init(torch.Generator().manual_seed(0), DQ, 5, DM)
        out5, out7 = pred.apply(params, q, m5), pred.apply(params, q, m7)
        assert out7.shape == (B, 7)
        if kind.endswith("-emb"):
            torch.testing.assert_close(out5, out7[:, :5], atol=1e-5, rtol=0)


def test_zero_dim_leaves_and_stacked_heads():
    gen = torch.Generator().manual_seed(0)
    assert P._init_reg_emb(gen, DQ, K, DM)["b"].shape == ()
    dot = P._init_attn_dot(gen, DQ, K, DM)
    assert dot["scale"].shape == () and float(dot["scale"]) == 1.0 and dot["bias"].shape == ()
    ens = P._init_attn_ens(gen, DQ, K, DM)
    assert ens["wo"].shape == (ENSEMBLE_HEADS, ATTN_LATENT, K)
    assert ens["bo"].shape == (ENSEMBLE_HEADS, K)
