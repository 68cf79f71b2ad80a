"""The port's training-free model embeddings against the JAX reference.

The reference's kmeans++ start draws from ``jax.random``, which torch
cannot reproduce, so the port's ``build_model_embeddings`` starts Lloyd's
loop from the reference's own start (``init_centers``). From there the
assignments are equal (``tests/test_torch_clustering.py``), and so the
numpy sampling of representatives: the model embeddings must equal the
reference's exactly (float32), the centroids within 1e-5 (the frameworks
sum the cluster means in different orders). ``embed_new_model`` from the
same centroids must be exact too. The reference's own properties of the
embeddings are mirrored.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.clustering import _kmeanspp_init
from repro.core.model_repr import build_model_embeddings as jax_build_model_embeddings
from repro.core.model_repr import embed_new_model as jax_embed_new_model
from repro.data import generate as jax_generate
from repro_torch.core.model_repr import (
    N_CLUSTERS, SAMPLE_FRACTION, build_model_embeddings, embed_new_model,
)


def _start(x, k, seed):
    return np.array(_kmeanspp_init(jax.random.key(seed), jnp.asarray(x, jnp.float32), k))


CASES = {
    "pool1-300": lambda: (lambda d: (d.emb[:300], d.quality[:300], 20, 0))(
        jax_generate(400, seed=0).pool("pool1")),
    "serving-900": lambda: (lambda d: (d.emb[:900], d.quality[:900, [0, 4]], 20, 0))(
        jax_generate(1200, seed=0)),
    "gaussian": lambda: (np.random.default_rng(0).standard_normal((200, 16)).astype(np.float32),
                         np.random.default_rng(1).random((200, 4)).astype(np.float32), 8, 3),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    return CASES[name]()


@pytest.mark.parametrize("case", list(CASES))
def test_build_model_embeddings_equals_reference_from_its_start(case):
    x, quality, k, seed = _case(case)
    want_emb, want_c = jax_build_model_embeddings(x, quality, n_clusters=k, seed=seed)
    got_emb, got_c = build_model_embeddings(x, quality, n_clusters=k, seed=seed,
                                            device="cpu", init_centers=_start(x, k, seed))
    assert got_emb.dtype == np.float32 and got_c.dtype == np.float32
    np.testing.assert_array_equal(got_emb, want_emb)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_embed_new_model_equals_reference(case):
    x, quality, k, seed = _case(case)
    _, centers = jax_build_model_embeddings(x, quality, n_clusters=k, seed=seed)
    np.testing.assert_array_equal(embed_new_model(centers, x, quality[:, 0], device="cpu"),
                                  jax_embed_new_model(centers, x, quality[:, 0]))


def test_paper_constants():
    assert (N_CLUSTERS, SAMPLE_FRACTION) == (20, 0.20)


def test_embedding_shape_and_range():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((200, 16)).astype(np.float32)
    quality = rng.random((200, 4)).astype(np.float32)
    memb, centers = build_model_embeddings(emb, quality, n_clusters=8, seed=0, device="cpu")
    assert memb.shape == (4, 8) and centers.shape == (8, 16)
    assert memb.min() >= 0.0 and memb.max() <= 1.0


def test_perfect_model_embeds_to_ones():
    emb = np.random.default_rng(1).standard_normal((100, 8)).astype(np.float32)
    memb, _ = build_model_embeddings(emb, np.ones((100, 2), np.float32), n_clusters=4,
                                     seed=0, device="cpu")
    np.testing.assert_array_equal(memb, 1.0)


def test_dynamic_model_addition():
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((150, 8)).astype(np.float32)
    quality = rng.random((150, 3)).astype(np.float32)
    _, centers = build_model_embeddings(emb, quality, n_clusters=5, seed=0, device="cpu")
    new = embed_new_model(centers, emb, quality[:, 0], device="cpu")
    assert new.shape == (5,) and 0.0 <= new.min() and new.max() <= 1.0


def test_fewer_prompts_than_clusters_caps_the_clusters():
    emb = np.random.default_rng(3).standard_normal((6, 4)).astype(np.float32)
    memb, centers = build_model_embeddings(emb, np.full((6, 2), 0.5), device="cpu")
    assert memb.shape == (2, 6) and centers.shape == (6, 4)
