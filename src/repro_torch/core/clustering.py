"""K-means from scratch: kmeans++ init + Lloyd, in plain torch.

The port of ``repro.core.clustering``. The serving path uses it for the
router's centroids, which the drift detector measures distance to.
``pairwise_sq_dists`` stays plain torch, as the reference's is jnp: the
``pairwise_l2`` kernel serves the semantic cache and the drift detector
only. JAX's ``jax.random`` draws cannot be reproduced, so the kmeans++
picks come from a numpy generator seeded here; :func:`lloyd` takes the
initial centers explicitly, and the tests hold it to the reference's
``kmeans`` from the reference's own initial centers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, d) x (K, d) -> (N, K) squared euclidean distances."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)
    return torch.clamp(x2 - 2.0 * (x @ c.T) + c2[None, :], min=0.0)


def kmeanspp_init(x: torch.Tensor, k: int, rng: np.random.Generator) -> torch.Tensor:
    """k seeds: the first uniform, each next one with probability
    proportional to its squared distance from the seeds so far."""
    n = x.shape[0]
    idx = [int(rng.integers(n))]
    d2 = pairwise_sq_dists(x, x[idx]).squeeze(1)
    for _ in range(1, k):
        w = d2.double().cpu().numpy()
        idx.append(int(rng.choice(n, p=w / max(w.sum(), 1e-12))))
        d2 = torch.minimum(d2, pairwise_sq_dists(x, x[idx[-1:]]).squeeze(1))
    return x[idx].clone()


def lloyd(x: torch.Tensor, centers: torch.Tensor,
          n_iters: int = 50) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd steps from ``centers`` until they move by at most
    ``allclose(atol=1e-6)`` or ``n_iters`` steps ran. An empty cluster
    keeps its center. Returns (centers (K, d), assignments (N,))."""
    k = centers.shape[0]
    assign = None
    for _ in range(n_iters):
        assign = torch.argmin(pairwise_sq_dists(x, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)   # (N, K)
        counts = onehot.sum(dim=0)[:, None]                           # (K, 1)
        sums = onehot.T @ x                                           # (K, d)
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centers)
        done = torch.allclose(new, centers, atol=1e-6)
        centers = new
        if done:
            break
    return centers, assign


def kmeans(x: np.ndarray, k: int, *, seed: int = 0, n_iters: int = 50,
           device: Optional[DeviceLike] = None,
           init: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's algorithm on ``device`` (the CUDA card unless the caller
    names another), from ``init`` (K, d) when given, else from a kmeans++
    start seeded with ``seed``. Returns (centroids (K, d) fp32,
    assignments (N,))."""
    device = resolve_device(device)
    xt = torch.tensor(np.asarray(x, np.float32), device=device)
    if init is None:
        start = kmeanspp_init(xt, k, np.random.default_rng(seed))
    else:
        start = torch.tensor(np.asarray(init, np.float32), device=device)
    centers, assign = lloyd(xt, start, n_iters)
    return centers.cpu().numpy(), assign.cpu().numpy()


def assign_clusters(x: np.ndarray, centers: np.ndarray,
                    device: Optional[DeviceLike] = None) -> np.ndarray:
    """Index of each row's nearest center."""
    device = resolve_device(device)
    d = pairwise_sq_dists(torch.tensor(np.asarray(x, np.float32), device=device),
                          torch.tensor(np.asarray(centers, np.float32), device=device))
    return torch.argmin(d, dim=1).cpu().numpy()
