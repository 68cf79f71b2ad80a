"""Baseline routers from RouterBench (KNN, MLP, SVM) and LLM-Blender.

The port of ``repro.core.baselines``:

  * KNN (k = 20): predicted quality and cost of model m are the means over
    the k nearest training prompts (euclidean in embedding space), on the
    router's device.
  * SVM (margin 0): one linear SVM per model, trained by full-batch
    gradient descent on the hinge loss of binarized correctness, on the
    device; the squashed decision value is the quality estimate.
  * MLP: the ``2fcn`` predictor trained as a baseline (no code here).
  * LLM-Blender: queries every pool member and answers with the winner of
    pairwise comparisons by a judge simulated as the true qualities under
    flip noise (numpy, seeded as in the reference). Its cost is the sum of
    all members' costs.

``KNNRouter`` and the SVM trainer run on the CUDA card unless the caller
names another device. The reference takes the neighbours with
``jax.lax.top_k``, the port with ``torch.topk``; the two can order ties at
the k-th distance apart, so their neighbour sets agree where the
distances are distinct.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.clustering import pairwise_sq_dists


# ---------------------------------------------------------------------------
# KNN router
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KNNRouter:
    train_emb: np.ndarray        # (N, d)
    train_quality: np.ndarray    # (N, K)
    train_cost: np.ndarray       # (N, K)
    k: int = 20
    device: Optional[DeviceLike] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @torch.inference_mode()
    def predict(self, q_emb: np.ndarray, batch: int = 1024):
        """Mean quality and cost of the k nearest training prompts, each
        (B, K) float32 numpy."""
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)  # noqa: E731
        xt, sq, sc = f32(self.train_emb), f32(self.train_quality), f32(self.train_cost)
        k = min(self.k, self.train_emb.shape[0])
        outs_s, outs_c = [], []
        for i in range(0, len(q_emb), batch):
            d = pairwise_sq_dists(f32(q_emb[i: i + batch]), xt)      # (B, N)
            idx = torch.topk(-d, k, dim=1).indices                   # (B, k)
            outs_s.append(_neighbour_mean(sq, idx).cpu().numpy())
            outs_c.append(_neighbour_mean(sc, idx).cpu().numpy())
        return np.concatenate(outs_s), np.concatenate(outs_c)


def _neighbour_mean(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Mean of ``values``' rows at ``idx`` (B, k): a running float32 sum
    in neighbour order times 1/k, the order and the scaling in which XLA
    reduces the reference's ``mean``, so the two agree bit for bit."""
    acc = values[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        acc = acc + values[idx[:, j]]
    return acc * (1.0 / idx.shape[1])


# ---------------------------------------------------------------------------
# Linear SVM router (hinge loss)
# ---------------------------------------------------------------------------

def _train_linear_svm(
    x: np.ndarray, y: np.ndarray, *, c_reg: float = 1.0, epochs: int = 200,
    lr: float = 0.05, seed: int = 0, device: Optional[DeviceLike] = None,
) -> Tuple[np.ndarray, float]:
    """Binary linear SVM via hinge-loss full-batch GD. y in {-1, +1}.

    The hinge is ``torch.maximum`` against 0, whose gradient splits at a
    tie as ``jnp.maximum``'s does.
    """
    device = resolve_device(device)
    xj = torch.as_tensor(np.asarray(x, np.float32), device=device)
    yj = torch.as_tensor(np.asarray(y, np.float32), device=device)
    zero = torch.zeros((), device=device)
    w = torch.zeros((x.shape[1],), device=device, requires_grad=True)
    b = torch.zeros((), device=device, requires_grad=True)
    for _ in range(epochs):
        margins = yj * (xj @ w + b)
        hinge = torch.mean(torch.maximum(zero, 1.0 - margins))
        loss = 0.5 / c_reg * torch.sum(w * w) / len(x) + hinge
        gw, gb = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            w = (w - lr * gw).requires_grad_(True)
            b = (b - lr * gb).requires_grad_(True)
    return w.detach().cpu().numpy(), float(b.detach())


@dataclasses.dataclass
class SVMRouter:
    weights: np.ndarray          # (K, d)
    biases: np.ndarray           # (K,)
    mean_cost: np.ndarray        # (K,)
    margin: float = 0.0

    @classmethod
    def fit(cls, train_emb, train_quality, train_cost, margin: float = 0.0,
            device: Optional[DeviceLike] = None):
        ws, bs = [], []
        for m in range(train_quality.shape[1]):
            y = np.where(train_quality[:, m] > 0.5, 1.0, -1.0)
            w, b = _train_linear_svm(train_emb, y, device=device)
            ws.append(w)
            bs.append(b)
        return cls(
            weights=np.stack(ws),
            biases=np.asarray(bs),
            mean_cost=train_cost.mean(axis=0),
            margin=margin,
        )

    def predict(self, q_emb: np.ndarray):
        dec = q_emb @ self.weights.T + self.biases       # (B, K)
        # Squash decision values to a [0,1] quality proxy; margin shifts the
        # decision boundary (margin=0 in the paper's configuration).
        s_hat = 1.0 / (1.0 + np.exp(-(dec - self.margin)))
        c_hat = np.broadcast_to(self.mean_cost, s_hat.shape)
        return s_hat, c_hat


# ---------------------------------------------------------------------------
# LLM-Blender (post-generation, simulated PairRM)
# ---------------------------------------------------------------------------

def llm_blender_choices(
    quality: np.ndarray, *, judge_noise: float = 0.1, seed: int = 0
) -> np.ndarray:
    """Per-prompt argmax-wins over all pairwise comparisons. (B,) indices."""
    rng = np.random.default_rng(seed)
    b, k = quality.shape
    wins = np.zeros((b, k), dtype=np.int32)
    for i in range(k):
        for j in range(i + 1, k):
            better = quality[:, i] >= quality[:, j]
            flip = rng.random(b) < judge_noise
            i_wins = better ^ flip
            wins[:, i] += i_wins
            wins[:, j] += ~i_wins
    return wins.argmax(axis=1)


def llm_blender_eval(quality: np.ndarray, cost: np.ndarray, **kw):
    """(perf, total_cost): quality of the winner, cost of querying everyone."""
    ch = llm_blender_choices(quality, **kw)
    b = np.arange(len(ch))
    perf = float(quality[b, ch].mean())
    total_cost = float(cost.sum(axis=1).mean())
    return perf, total_cost
