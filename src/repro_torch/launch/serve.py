"""Routed serving on the port: build the pool and router, serve a batch.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --pool qwen3-0.6b,granite-3-8b --requests 8

builds the pool members at their published widths and depths on the CUDA
card (``--smoke`` builds the reduced configs instead, ``--device cpu``
runs on the CPU), a router (``--router`` loads an npz checkpoint saved by
either package; otherwise a seeded, untrained attention router), and
serves seeded requests through :meth:`RoutedEngine.serve`, generating
``MAX_NEW`` tokens each at willingness-to-pay lambda = 1.

Every random path derives from ``--seed``: pool init from torch
generators on the serving device, the router's init likewise, the model
embeddings and the requests from numpy.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import load_router
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.router import PredictiveRouter
from repro_torch.data.featurizer import EMB_DIM
from repro_torch.models import lm as lm_mod
from repro_torch.serving.engine import PoolMember, RoutedEngine, arch_cost_rate

DEFAULT_POOL = "qwen3-0.6b,granite-3-8b"
MAX_NEW = 8

# Width of a model embedding: one column per k-means cluster of training
# prompts (N_CLUSTERS in repro.core.model_repr).
N_CLUSTERS = 20

_WORDS = ("prove", "integral", "python", "function", "poem", "summarize",
          "history", "translate", "riddle", "matrix", "physics", "recipe",
          "debug", "essay", "chemistry", "logic", "story", "sql", "limit",
          "proof", "biology", "economics", "sort", "graph")


def build_pool(names: Sequence[str], seed: int = 0,
               device: Optional[DeviceLike] = None,
               smoke: bool = False) -> List[PoolMember]:
    """Pool members with seeded params made directly on ``device``.

    ``smoke=False`` builds the published configs. Cost rates always come
    from the published configs: the economics the router weighs are those
    of the real architectures.
    """
    device = resolve_device(device)
    members = []
    for i, name in enumerate(names):
        cfg = get_smoke_config(name) if smoke else get_config(name)
        gen = torch.Generator(device=device).manual_seed(seed + i)
        members.append(PoolMember(
            name=name, cfg=cfg, params=lm_mod.init_lm(gen, cfg),
            cost_rate=arch_cost_rate(get_config(name)),
        ))
    return members


def init_router(n_members: int, seed: int = 0,
                device: Optional[DeviceLike] = None) -> PredictiveRouter:
    """Seeded untrained router: ``attn`` quality and cost heads, R2 reward."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pred = PREDICTORS["attn"]
    qp = pred.init(gen, EMB_DIM, n_members, N_CLUSTERS)
    cp = pred.init(gen, EMB_DIM, n_members, N_CLUSTERS)
    model_emb = np.random.default_rng(seed).uniform(
        size=(n_members, N_CLUSTERS)).astype(np.float32)
    return PredictiveRouter("attn", "attn", qp, cp, model_emb, reward="R2")


def build_engine(names: Sequence[str], router_path: Optional[str] = None,
                 seed: int = 0, device: Optional[DeviceLike] = None,
                 smoke: bool = False) -> RoutedEngine:
    """Pool + router + engine on one device (the CUDA card by default)."""
    device = resolve_device(device)
    pool = build_pool(names, seed=seed, device=device, smoke=smoke)
    if router_path is not None:
        router = load_router(router_path, expect_pool_names=list(names),
                             device=device)
        if router.n_members != len(pool):
            raise ValueError(f"checkpoint pool size {router.n_members} != "
                             f"serving pool size {len(pool)}")
    else:
        router = init_router(len(pool), seed=seed, device=device)
    return RoutedEngine(router=router, pool=pool, device=device)


def synthetic_requests(n: int, vocab: int, seed: int = 0, min_len: int = 16,
                       max_len: int = 128) -> Tuple[List[str], List[np.ndarray]]:
    """``n`` seeded (text, prompt tokens) requests of mixed prompt lengths."""
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(_WORDS, size=int(rng.integers(4, 12))))
             for _ in range(n)]
    prompts = [rng.integers(0, vocab, size=int(rng.integers(min_len, max_len + 1)),
                            dtype=np.int32) for _ in range(n)]
    return texts, prompts


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pool", default=DEFAULT_POOL)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--router", default=None, help="npz router checkpoint")
    ap.add_argument("--smoke", action="store_true", help="reduced configs")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    names = args.pool.split(",")
    t0 = time.perf_counter()
    engine = build_engine(names, router_path=args.router, seed=args.seed,
                          device=args.device, smoke=args.smoke)
    t_build = time.perf_counter() - t0
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    texts, prompts = synthetic_requests(args.requests, vocab, seed=args.seed)
    res = engine.serve(texts, prompts, max_new=MAX_NEW)
    n_tok = sum(len(o) for o in res["outputs"])
    print(f"device: {engine.device}  build: {t_build:.3f}s")
    print("per-member counts: " + ", ".join(
        f"{m.name}={int(c)}" for m, c in zip(engine.pool, res["per_member_counts"])))
    print(f"total $: {res['total_cost']:.6g}  serve: {res['latency_s']:.3f}s  "
          f"tokens/s: {n_tok / res['latency_s']:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
