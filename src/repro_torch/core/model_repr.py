"""Training-free LLM representations (paper §5, inspired by Universal Routing).

The port of ``repro.core.model_repr``. Training prompts are clustered with
k-means (C = 20 from an elbow test in the paper); 20% of the prompts of
each cluster are sampled uniformly at random as representatives. A
model's embedding is its mean observed quality on the representatives of
each cluster: I_m in R^C.

K-means runs on ``device`` (the CUDA card unless the caller names
another); the sampling is numpy, seeded as in the reference. The
reference's kmeans++ start draws from ``jax.random``, which torch cannot
reproduce, so ``init_centers`` lets a caller start Lloyd's loop where the
reference started it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.common.device import DeviceLike
from repro_torch.core.clustering import assign_clusters, kmeans

N_CLUSTERS = 20
SAMPLE_FRACTION = 0.20


def build_model_embeddings(
    query_emb: np.ndarray,        # (N, d) training prompt embeddings
    quality: np.ndarray,          # (N, K) observed quality per (prompt, model)
    *,
    n_clusters: int = N_CLUSTERS,
    sample_fraction: float = SAMPLE_FRACTION,
    seed: int = 0,
    device: Optional[DeviceLike] = None,
    init_centers: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (model_embeddings (K, C) float32, centroids (C, d) float32)."""
    n, k = quality.shape
    n_clusters = min(n_clusters, n)
    centers, assign = kmeans(query_emb, n_clusters, seed=seed, device=device,
                             init=init_centers)
    rng = np.random.default_rng(seed)

    emb = np.zeros((k, n_clusters), dtype=np.float32)
    overall = quality.mean(axis=0)
    for c in range(n_clusters):
        members = np.flatnonzero(assign == c)
        if len(members) == 0:
            emb[:, c] = overall
            continue
        n_rep = max(1, int(round(sample_fraction * len(members))))
        reps = rng.choice(members, size=n_rep, replace=False)
        emb[:, c] = quality[reps].mean(axis=0)
    return emb, centers


def embed_new_model(
    centroids: np.ndarray,
    query_emb: np.ndarray,
    quality_one: np.ndarray,      # (N,) observed quality of the new model
    device: Optional[DeviceLike] = None,
) -> np.ndarray:
    """Embed a model added to the pool after training (dynamic pools):
    mean quality per existing cluster, no predictor retraining needed."""
    assign = assign_clusters(query_emb, centroids, device=device)
    c = centroids.shape[0]
    emb = np.zeros((c,), dtype=np.float32)
    overall = float(quality_one.mean())
    for ci in range(c):
        members = np.flatnonzero(assign == ci)
        emb[ci] = quality_one[members].mean() if len(members) else overall
    return emb
