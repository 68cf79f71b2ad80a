"""Routed serving on the port: one batch, or an open-loop trace.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --pool qwen3-0.6b,granite-3-8b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --trace neardup --semcache --requests 200

builds the pool members at their published widths and depths on the CUDA
card (``--smoke`` builds the reduced configs instead, ``--device cpu``
runs on the CPU) and a router (``--router`` loads an npz checkpoint saved
by either package; otherwise a seeded, untrained attention router).

Without ``--trace`` it serves one batch of seeded requests through
:meth:`RoutedEngine.serve`, ``MAX_NEW`` tokens each, at willingness-to-pay
lambda = 1. With ``--trace`` it replays an open-loop trace over the
held-out split of the synthetic RouterBench corpus through the admission
queue and the micro-batching scheduler, on the deterministic service-time
model, and prints the telemetry report. ``--semcache`` puts the semantic
answer cache in front as rung 0, with a radius calibrated on the training
split (unless ``--cache-radius``) and a cache-owned drift detector fitted
on the training split against the router's k-means centroids. A seeded
router gets those centroids from k-means (C = 20) of the training split;
a checkpoint brings its own.

Every random path derives from ``--seed``: pool init from torch
generators on the serving device, the router's init likewise, the model
embeddings, the corpus, the k-means seeds, the trace and the requests
from numpy.
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
from repro_torch.core.clustering import kmeans
from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.router import PredictiveRouter
from repro_torch.data.featurizer import EMB_DIM
from repro_torch.data.routerbench import generate
from repro_torch.models import lm as lm_mod
from repro_torch.online.drift import DriftDetector
from repro_torch.serving.engine import PoolMember, RoutedEngine, arch_cost_rate
from repro_torch.serving.scheduler import (
    MicroBatchScheduler, SchedulerConfig, default_service_model,
)
from repro_torch.serving.semcache import SemanticCache, calibrate_radius
from repro_torch.serving.traffic import TRACE_KINDS, TraceConfig, make_trace

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


def pool_quality_columns(pool, data) -> list:
    """RouterBench quality columns for the pool members, matched by cost
    order (cheapest member <- cheapest API model, etc.)."""
    api_cost_order = np.argsort(data.cost.mean(0))          # cheap -> pricey
    member_rank = np.argsort(np.argsort([m.cost_rate for m in pool]))
    k_api, p = len(api_cost_order), len(pool)
    return [
        int(api_cost_order[int(round(member_rank[i] * (k_api - 1) / max(p - 1, 1)))])
        for i in range(p)
    ]


def synthetic_pool_traffic(pool, n: int = 1200, seed: int = 0):
    """Map synthetic RouterBench quality columns onto the pool members:
    (data, quality (n, K), cost (n, K))."""
    data = generate(n, seed=seed)
    quality = data.quality[:, pool_quality_columns(pool, data)]  # pool order
    cost = np.stack([np.full(n, m.cost_rate) for m in pool], axis=1)
    return data, quality, cost


def fit_router_centroids(router: PredictiveRouter, train_emb: np.ndarray,
                         seed: int = 0, device: Optional[DeviceLike] = None) -> None:
    """Give a router without centroids the k-means centroids (C = 20) of
    the training embeddings, as the reference's trained router carries
    them. Its model embeddings stay as they are."""
    if router.centroids is None:
        router.centroids = kmeans(train_emb, min(N_CLUSTERS, len(train_emb)),
                                  seed=seed, device=device)[0]


def build_drift_proto(train_emb: np.ndarray, centroids: Optional[np.ndarray], *,
                      window: int = 48, seed: int = 0,
                      device: Optional[DeviceLike] = None) -> DriftDetector:
    """A drift detector fitted on the training embeddings against the
    router's centroids (the reference's ``build_drift_proto`` with one
    worker)."""
    return DriftDetector(window=window, seed=seed, device=device).fit(
        train_emb, centroids)


def make_semcache(train_emb: np.ndarray, *, radius: Optional[float] = None,
                  cap: int = 256, drift: Optional[DriftDetector] = None,
                  device: Optional[DeviceLike] = None) -> SemanticCache:
    """The rung-0 semantic cache. ``radius=None`` calibrates it on the
    training embeddings (nearest-neighbour distance quantile)."""
    if radius is None:
        radius = calibrate_radius(train_emb, device=device)
    return SemanticCache(radius, cap=cap, drift=drift, device=device)


def build_scheduler(engine: RoutedEngine, *, score_batch: int = 64,
                    max_batch: int = 8, max_wait_s: float = 0.05,
                    queue_capacity: int = 512,
                    semcache: Optional[SemanticCache] = None,
                    device: Optional[DeviceLike] = None) -> MicroBatchScheduler:
    """The streaming scheduler over ``engine`` on the deterministic
    service-time model. The engine, the cache and its drift detector must
    all run on ``device`` (the CUDA card unless the caller names another)."""
    device = resolve_device(device)
    parts = [("engine", engine.device)]
    if semcache is not None:
        parts.append(("semantic cache", semcache.device))
        if semcache.drift is not None:
            parts.append(("drift detector", semcache.drift.device))
    for name, d in parts:
        if (d.type, d.index or 0) != (device.type, device.index or 0):
            raise ValueError(f"the {name} runs on {d}, the scheduler on {device}")
    return MicroBatchScheduler(
        engine, SchedulerConfig(score_batch=score_batch, max_batch=max_batch,
                                max_wait_s=max_wait_s, queue_capacity=queue_capacity),
        semcache=semcache, service_time=default_service_model())


def run_trace_mode(engine: RoutedEngine, args) -> dict:
    """Replay ``args.trace`` over the held-out split through the scheduler
    (and the semantic cache with ``args.semcache``); print the report."""
    data, _, _ = synthetic_pool_traffic(engine.pool, seed=args.seed)
    tr, _, te = data.split(seed=args.seed)
    fit_router_centroids(engine.router, data.emb[tr], seed=args.seed,
                         device=engine.device)
    cache = None
    if args.semcache:
        drift = build_drift_proto(data.emb[tr], engine.router.centroids,
                                  seed=args.seed, device=engine.device)
        cache = make_semcache(data.emb[tr], radius=args.cache_radius,
                              cap=args.cache_cap, drift=drift, device=engine.device)
        print(f"semcache radius {cache.radius:.4f}"
              + (" (training-split NN-distance quantile)"
                 if args.cache_radius is None else ""))
    trace = make_trace(
        TraceConfig(kind=args.trace, n_requests=args.requests, rate=args.rate,
                    seed=args.seed, max_new=args.max_new or 4, prompt_len_max=48,
                    vocab=min(m.cfg.vocab_size for m in engine.pool)),
        texts=[data.texts[i] for i in te],
        benchmarks=[data.benchmark[i] for i in te])
    sched = build_scheduler(engine, score_batch=args.score_batch,
                            max_batch=args.max_batch, semcache=cache,
                            device=engine.device)
    summary = sched.run_trace(trace)
    print(f"trace={args.trace} requests={args.requests} seed={args.seed}")
    print(sched.telemetry.report(summary.get("duration_s")))
    if cache is not None:
        rep = cache.report()
        print(f"semcache: {rep['served']} served / {rep['lookups']} lookups "
              f"(hit rate {rep['hit_rate']:.2f})  "
              f"{rep['fallthroughs']} fallthroughs  "
              f"{rep['stale_hits']} stale  {rep['evicted']} evicted  "
              f"{rep['invalidations']} invalidated  "
              f"{rep['entries']} entries")
        print(f"drift: {cache.drift.windows_seen} windows, "
              f"{cache.drift.alarms} alarms")
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pool", default=DEFAULT_POOL)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--router", default=None, help="npz router checkpoint")
    ap.add_argument("--smoke", action="store_true", help="reduced configs")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--trace", default=None, choices=TRACE_KINDS,
                    help="replay an open-loop trace through the scheduler")
    ap.add_argument("--rate", type=float, default=400.0,
                    help="mean arrivals per virtual second")
    ap.add_argument("--max-new", type=int, default=None,
                    help=f"new tokens per request (default 4 with --trace, "
                         f"{MAX_NEW} for the one batch)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--score-batch", type=int, default=64)
    ap.add_argument("--semcache", action="store_true",
                    help="semantic answer cache as rung 0 (with --trace)")
    ap.add_argument("--cache-radius", type=float, default=None,
                    help="semcache: L2 match radius (default: calibrated "
                         "from the training split)")
    ap.add_argument("--cache-cap", type=int, default=256,
                    help="semcache: max entries (LRU eviction past it)")
    args = ap.parse_args(argv)
    if args.semcache and args.trace is None:
        ap.error("--semcache needs --trace")

    names = args.pool.split(",")
    t0 = time.perf_counter()
    engine = build_engine(names, router_path=args.router, seed=args.seed,
                          device=args.device, smoke=args.smoke)
    t_build = time.perf_counter() - t0
    print(f"device: {engine.device}  build: {t_build:.3f}s")
    if args.trace is not None:
        run_trace_mode(engine, args)
        return 0
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    texts, prompts = synthetic_requests(args.requests, vocab, seed=args.seed)
    res = engine.serve(texts, prompts, max_new=args.max_new or MAX_NEW)
    n_tok = sum(len(o) for o in res["outputs"])
    print("per-member counts: " + ", ".join(
        f"{m.name}={int(c)}" for m, c in zip(engine.pool, res["per_member_counts"])))
    print(f"total $: {res['total_cost']:.6g}  serve: {res['latency_s']:.3f}s  "
          f"tokens/s: {n_tok / res['latency_s']:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
