"""The port's k-means against the reference's.

``jax.random`` draws cannot be reproduced in torch, so the port's Lloyd
loop starts from the reference's own kmeans++ centers
(``repro.core.clustering._kmeanspp_init``) and must land where the
reference's ``kmeans`` lands: centers within 1e-5 (the two frameworks sum
the cluster means in different orders) and equal assignments. The port's
own kmeans++ init is checked for the properties the reference's tests
state (determinism, separated clusters, nearest-centroid assignment).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering import _kmeanspp_init
from repro.core.clustering import assign_clusters as jax_assign_clusters
from repro.core.clustering import kmeans as jax_kmeans
from repro.data.featurizer import embed_texts as jax_embed_texts
from repro_torch.core.clustering import assign_clusters, kmeans, lloyd, pairwise_sq_dists
from repro_torch.data.routerbench import generate


def _separated(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.standard_normal((50, 4)) * 0.1 + 5.0,
                           rng.standard_normal((50, 4)) * 0.1 - 5.0]).astype(np.float32)


DATASETS = {
    "separated": lambda: (_separated(), 2, 0),
    "gaussian": lambda: (np.random.default_rng(1).standard_normal((80, 6))
                         .astype(np.float32), 5, 1),
    "corpus-768": lambda: (generate(300, seed=4).emb.astype(np.float32), 20, 0),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_lloyd_matches_reference_from_its_initial_centers(name):
    x, k, seed = DATASETS[name]()
    init = np.array(_kmeanspp_init(jax.random.key(seed), jnp.asarray(x), k))
    want_c, want_a = jax_kmeans(x, k, seed=seed)
    got_c, got_a = lloyd(torch.from_numpy(x), torch.from_numpy(init))
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_a.numpy(), want_a)


def test_assign_clusters_matches_reference():
    texts = generate(120, seed=9).texts
    x = jax_embed_texts(texts)
    centers = x[:7].astype(np.float32)
    np.testing.assert_array_equal(assign_clusters(x, centers, device="cpu"),
                                  jax_assign_clusters(x, centers))


def test_kmeans_recovers_separated_clusters():
    centers, assign = kmeans(_separated(), 2, seed=0, device="cpu")
    assert len(set(assign[:50])) == 1 and len(set(assign[50:])) == 1
    assert assign[0] != assign[-1]
    assert centers.dtype == np.float32 and centers.shape == (2, 4)


def test_kmeans_assignment_is_nearest_centroid():
    x = np.random.default_rng(1).standard_normal((80, 6)).astype(np.float32)
    centers, assign = kmeans(x, 5, seed=1, device="cpu")
    d = pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(centers)).numpy()
    np.testing.assert_array_equal(assign, d.argmin(axis=1))


@pytest.mark.parametrize("k,n", [(2, 20), (4, 41), (6, 60)])
def test_kmeans_deterministic(k, n):
    x = np.random.default_rng(42).standard_normal((n, 5)).astype(np.float32)
    c1, a1 = kmeans(x, k, seed=3, device="cpu")
    c2, a2 = kmeans(x, k, seed=3, device="cpu")
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)


def test_lloyd_keeps_an_empty_clusters_center():
    x = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]])
    init = torch.tensor([[0.0, 0.0], [5.0, 5.0], [100.0, 100.0]])
    centers, assign = lloyd(x, init)
    assert assign.tolist() == [0, 0, 1]
    torch.testing.assert_close(centers[2], init[2], rtol=0, atol=0)
