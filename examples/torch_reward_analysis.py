"""Reward-function study on the PyTorch port (paper §6 + Appendix A): R1
vs R2 oracle routers.

    PYTHONPATH=src python examples/torch_reward_analysis.py [--device cpu]

The port of ``examples/reward_analysis.py``: comparable AIQ, drastically
lower lambda-sensitivity, bounded reward values, and the query
distribution concentrated on cheap models. The oracle's rewards are taken
on the CUDA card unless ``--device`` names another device (with no card
and no ``--device`` it raises).
"""
import argparse
import sys

import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import (
    DEFAULT_LAMBDA_GRID, evaluate_sweep, oracle_sweep, reward_exponential, reward_linear,
)
from repro_torch.data.routerbench import generate


def main(argv=None, *, n_queries: int = 2000) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device: {device}")

    data = generate(n_queries, seed=0)
    print(f"{'pool':<8}{'reward':<8}{'AIQ':>9}{'sens_perf':>11}"
          f"{'sens_cost':>12}{'maxGPT4':>9}")
    for pool_name in ("pool1", "pool2", "pool3", "pool4"):
        pool = data.pool(pool_name)
        _, _, te = pool.split()
        q, c = pool.quality[te], pool.cost[te]
        for reward in ("R1", "R2"):
            m = evaluate_sweep(oracle_sweep(q, c, DEFAULT_LAMBDA_GRID, reward, device), q, c)
            print(f"{pool_name:<8}{reward:<8}{m['aiq']:>9.4f}"
                  f"{m['lam_sens_perf']:>11.4f}{m['lam_sens_cost']:>12.2e}"
                  f"{m['max_calls_expensive']:>9.3f}")

    print("\nboundedness (s=0.9): R1 vs R2 as cost grows at lambda=0.01")
    for cost in (0.0, 0.01, 0.1, 1.0):
        s, ct = (torch.tensor(v, device=device) for v in (0.9, cost))
        r1 = float(reward_linear(s, ct, 0.01))
        r2 = float(reward_exponential(s, ct, 0.01))
        print(f"  c={cost:<6} R1={r1:>10.3f}   R2={r2:>8.5f}")

    print("\nquery distribution at mid-lambda (pool1, R2 oracle):")
    pool = data.pool("pool1")
    _, _, te = pool.split()
    ch = oracle_sweep(pool.quality[te], pool.cost[te], DEFAULT_LAMBDA_GRID, "R2", device)
    mid = ch[len(DEFAULT_LAMBDA_GRID) // 2]
    for i, name in enumerate(pool.model_names):
        bar = "#" * int(40 * (mid == i).mean())
        print(f"  {name:<26}{(mid == i).mean():>6.1%} {bar}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
