"""Quickstart on the PyTorch port: train the paper's cross-attention router
and evaluate it.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port of ``examples/quickstart.py``. Steps (all offline,
deterministic), on the CUDA card unless ``--device`` names another
device (with no card and no ``--device`` it raises):
  1. generate synthetic RouterBench traffic (11 models x 8 benchmarks),
  2. build training-free model embeddings (k-means cluster performance),
  3. train the dual attention predictors (quality + cost, MSE/Adam/cosine),
  4. sweep the user's willingness-to-pay and report AIQ vs KNN + oracle.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import (
    DEFAULT_LAMBDA_GRID, build_model_embeddings, evaluate_sweep, rewards,
)
from repro_torch.core.baselines import KNNRouter
from repro_torch.core.router import PredictiveRouter
from repro_torch.data.routerbench import generate
from repro_torch.training import train_dual_predictors


def route_sweep(s_hat, c_hat, device, reward="R2") -> np.ndarray:
    """R2 choices (L, B) over the lambda grid for score rows (B, K), taken
    on ``device``."""
    s = torch.as_tensor(np.asarray(s_hat), device=device)
    c = torch.as_tensor(np.asarray(c_hat), device=device)
    return np.stack([rewards.route(reward, s, c, lam).cpu().numpy()
                     for lam in DEFAULT_LAMBDA_GRID])


def main(argv=None, *, n_queries: int = 2000, epochs: int = 200) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device: {device}")

    print("== 1. data ==")
    data = generate(n_queries, seed=0)
    pool = data.pool("pool1")
    tr, va, te = pool.split()
    print(f"pool1 = {pool.model_names}; {len(tr)} train / {len(te)} test")

    print("== 2. model embeddings (training-free, k-means) ==")
    memb, _ = build_model_embeddings(pool.emb[tr], pool.quality[tr], seed=0,
                                     device=device)
    print(f"model embedding matrix: {memb.shape}")

    print("== 3. train dual attention predictors ==")
    qp, cp, scaler, hist = train_dual_predictors(
        "attn", "attn", pool.emb[tr], pool.quality[tr], pool.cost[tr], memb,
        q_emb_val=pool.emb[va], quality_val=pool.quality[va],
        cost_val=pool.cost[va], epochs=epochs, seed=0, device=device,
    )
    print(f"quality MSE {hist['quality']['train_loss'][0]:.4f} -> "
          f"{hist['quality']['train_loss'][-1]:.4f}")

    print("== 4. evaluate ==")
    router = PredictiveRouter("attn", "attn", qp, cp, memb, reward="R2",
                              cost_scaler=scaler)
    ch = router.sweep(pool.emb[te], DEFAULT_LAMBDA_GRID)
    m = evaluate_sweep(ch, pool.quality[te], pool.cost[te])

    knn = KNNRouter(pool.emb[tr], pool.quality[tr], pool.cost[tr], k=20,
                    device=device)
    mk = evaluate_sweep(route_sweep(*knn.predict(pool.emb[te]), device),
                        pool.quality[te], pool.cost[te])
    mo = evaluate_sweep(route_sweep(pool.quality[te], pool.cost[te], device),
                        pool.quality[te], pool.cost[te])

    print(f"{'router':<22}{'AIQ':>8}{'Perf_max':>10}")
    print(f"{'attention (paper)':<22}{m['aiq']:>8.4f}{m['perf_max']:>10.4f}")
    print(f"{'KNN (k=20)':<22}{mk['aiq']:>8.4f}{mk['perf_max']:>10.4f}")
    print(f"{'oracle R2':<22}{mo['aiq']:>8.4f}{mo['perf_max']:>10.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
