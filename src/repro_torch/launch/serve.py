"""Routed serving on the port: one batch, or an open-loop trace.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --pool qwen3-0.6b,granite-moe-1b-a400m,granite-3-8b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --pool qwen3-0.6b,qwen1.5-4b,gemma3-27b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --pool qwen3-0.6b,xlstm-1.3b,jamba-1.5-large-398b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --pool qwen3-0.6b,musicgen-large,llama-3.2-vision-90b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --trace neardup --semcache --requests 200
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --trace drift --online --requests 200 --budget 0.02 --feedback-delay 0.01
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --trace neardup --cascade --semcache --max-legs 3 --requests 200
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --trace neardup --semcache --trace-out t.json --metrics-out m.json \
        --trace-profile --scrape-every 0.05 --trace-sample 0.25
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --trace drift --online --workers 3 --crash-at 0.08 --rejoin-at 0.2 \
        --budget 0.01
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --trace drift --online --workers 3 --transport socket

builds the pool members at their published widths and depths on the CUDA
card (``--smoke`` builds the reduced configs instead, ``--device cpu``
runs on the CPU) and a router. As the reference's ``build_routed_engine``
does, the router is trained on the same device: synthetic RouterBench
traffic mapped onto the pool, k-means model embeddings of the training
split, then the quality (``--quality-kind``, default ``attn``) and ``attn``
cost predictors for ``--epochs`` epochs, keeping the best-validation
params. ``--router`` (or the reference's name, ``--restore-router``) loads
an npz checkpoint saved by either package instead and skips training;
``--save-router`` writes the trained one.

Without ``--trace`` it serves one batch of seeded requests through
:meth:`RoutedEngine.serve`, ``MAX_NEW`` tokens each, at willingness-to-pay
lambda = 1. With ``--trace`` it replays an open-loop trace over the
held-out split of the synthetic RouterBench corpus through the admission
queue and the micro-batching scheduler (``--max-batch``, ``--max-wait``,
``--score-batch``, ``--queue-capacity``), on the deterministic service-time
model (``--wall-time``: on measured wall time instead), with a deadline of
``--deadline`` virtual seconds after arrival when given, and prints the
telemetry report. ``--semcache`` puts the semantic
answer cache in front as rung 0, with a radius calibrated on the training
split (unless ``--cache-radius``) and a cache-owned drift detector fitted
on the training split against the router's k-means centroids. A trained
router carries those centroids; a checkpoint without them gets them from
k-means (C = 20) of the training split.

In trace mode, as the reference's single-scheduler run: ``--online`` puts
an :class:`~repro_torch.online.OnlineAdapter` on the scheduler (replay,
exploration at ``--epsilon``, a drift detector of window 48 fitted on the
training split, an update every ``--online-update-every`` outcomes,
``--refresh-established``; ``--feedback-delay`` stages the feedback and
delivers it that many virtual seconds late). ``--cascade`` trains an
``attn-ens`` quality head and runs the stop-vs-escalate ladder
(``--max-legs``, ``--cascade-beta``, ``--cascade-margin``,
``--cascade-min-headroom``); with ``--semcache`` the cache's rung 0 takes
the cascade's policy. Both take their observed quality from the
synthetic RouterBench truth, keyed by text over the pool's quality
columns. ``--budget`` (with ``--budget-window`` and ``--lam``) adds the
budget governor, whose headroom anneals exploration and gates escalation.
With ``--online`` the adapter's drift detector drives the cache's
invalidation, as in the reference; otherwise the cache owns one.

Observability, as the reference's flags: ``--trace-out`` writes the
run's per-request spans as Chrome-trace JSON (byte-identical across
replays of a seed), ``--metrics-out`` a metrics snapshot (``.prom`` /
``.txt`` Prometheus text, else canonical JSON), ``--metrics-port`` serves
the live registry on localhost, ``--trace-profile`` installs the
kernel-dispatch profiler (each ``router_xattn_pool`` / ``pairwise_l2``
dispatch timed under a device sync; removed again when the run ends), and
``--scrape-every`` / ``--obs-dir`` / ``--trace-sample`` / ``--trace-head`` /
``--trace-cap`` stream sampled segments. ``--slo-*`` add burn-rate SLOs,
and ``--slo-class K`` sheds the lowest class while one fires.

``--workers N`` (N > 1) serves the trace on the in-process serving plane:
N workers over :class:`~repro_torch.distributed.LocalTransport`, each with
a :class:`RoutedEngine` of its own over the ONE pool and router (shared
by reference: members' params are not copied), its own queue, clock,
cache and cascade, one shared budget ledger with ``--budget``, and with
``--online`` follower adapters whose replay the coordinator merges onto
the leader every ``--sync-every`` virtual seconds before it broadcasts
the updated router. ``--crash-at`` / ``--rejoin-at`` / ``--crash-worker``
inject a crash and rejoin.

``--transport socket`` runs workers 1..N-1 as OS processes
(``python -m repro_torch.distributed.host``) that speak length-prefixed TCP
to this process, the controller, which is worker 0 and the leader. Each
process re-parses this argv, builds only the pool members it owns
(round-robin, :func:`~repro_torch.distributed.shard.owner_of`) and trains
its own router from ``--seed`` (bitwise the controller's: the ``ready``
lines print each router's digest); a generate leg for a member another
process owns hops there as a ``GENERATE`` message, and budget ops reach the
controller's ledger as ``LEDGER_OP``. At the end the controller absorbs
the followers' traces (``TRACE_REQ``) and metrics (``METRICS_REQ``; with
``--metrics-out`` a ``.fleet.prom`` beside it) and shuts them down. The
reference's ``--pallas`` has no counterpart: every CUDA tensor launches the
kernel.

Every random path derives from ``--seed``: pool init from torch
generators on the serving device, the predictors' init likewise, the
model embeddings, the corpus, the k-means seeds, the batch order, the
trace and the requests from numpy.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from typing import Callable, Collection, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cascade import CascadeConfig, CascadeCoordinator, CascadePolicy, cost_ladder
from repro_torch.checkpoint import load_router, save_router
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import XATTN
from repro_torch.core.clustering import kmeans
from repro_torch.core.model_repr import N_CLUSTERS, build_model_embeddings
from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.router import PredictiveRouter
from repro_torch.data.featurizer import EMB_DIM
from repro_torch.data.routerbench import generate
from repro_torch.distributed import (
    Coordinator, PlaneEvent, ServingPlane, SharedBudgetLedger, SyncConfig, WorkerNode,
)
from repro_torch.distributed.shard import owned_members
from repro_torch.kernels import ops as kops
from repro_torch.models import lm as lm_mod
from repro_torch.online import (
    DelayedFeedback, DriftDetector, ExplorationConfig, MembershipTracker, OnlineAdapter,
    OnlineUpdateConfig, OutcomeStage,
)
from repro_torch.serving.budget import BudgetGovernor
from repro_torch.serving.engine import PoolMember, RoutedEngine, arch_cost_rate
from repro_torch.obs import (
    KernelProfiler, MetricsRegistry, MetricsServer, ObsFlusher, TraceRecorder, TraceSampler,
    build_slo_tracker, concat_dir, register_governor_metrics, register_plane_metrics,
    register_scheduler_metrics, register_slo_metrics, register_stream_metrics,
)
from repro_torch.serving.scheduler import (
    MicroBatchScheduler, SchedulerConfig, SimClock, default_service_model,
)
from repro_torch.serving.semcache import SemanticCache, calibrate_radius
from repro_torch.serving.traffic import TRACE_KINDS, TraceConfig, make_trace
from repro_torch.training.predictor_trainer import train_dual_predictors

# The reference's default serve pool, in its order: two dense members and
# the mixture-of-experts granite-moe, the cheapest per token.
DEFAULT_POOL = "qwen3-0.6b,granite-moe-1b-a400m,granite-3-8b"
MAX_NEW = 8

_WORDS = ("prove", "integral", "python", "function", "poem", "summarize",
          "history", "translate", "riddle", "matrix", "physics", "recipe",
          "debug", "essay", "chemistry", "logic", "story", "sql", "limit",
          "proof", "biology", "economics", "sort", "graph")


def stub_media(cfg, gen: torch.Generator) -> Optional[torch.Tensor]:
    """The carve-out encoder's stand-in for a config with cross-attention
    layers: (1, n_frontend_tokens, frontend_dim) standard normal, drawn from
    ``gen`` on its device, as the reference's ``launch/train.py`` draws one
    stub per run. None for a config without cross attention."""
    if not cfg.has_mixer(XATTN):
        return None
    return torch.randn((1, cfg.n_frontend_tokens, cfg.frontend_dim),
                       generator=gen, device=gen.device)


def build_pool(names: Sequence[str], seed: int = 0,
               device: Optional[DeviceLike] = None,
               smoke: bool = False,
               owned: Optional[Collection[int]] = None) -> List[PoolMember]:
    """Pool members with seeded params made directly on ``device``.

    ``smoke=False`` builds the published configs. Cost rates always come
    from the published configs: the economics the router weighs are those
    of the real architectures. A member with cross-attention layers (a vlm)
    also gets its :func:`stub_media`, drawn after its params from the same
    seed, which every request it serves reads: the reference's serving
    path passes no media and cannot serve such a member (ROADMAP.md
    Queue 3).

    ``owned`` (member indices) builds only those members' params and
    media, as a socket-mode worker does for its shard: each member has a
    generator of its own (``seed + i``), so an owned member gets the bits
    of the full build. The others keep their config and cost rate (all
    that router training and scoring read) with ``params=None``.
    """
    device = resolve_device(device)
    members = []
    for i, name in enumerate(names):
        cfg = get_smoke_config(name) if smoke else get_config(name)
        params = media = None
        if owned is None or i in owned:
            gen = torch.Generator(device=device).manual_seed(seed + i)
            params = lm_mod.init_lm(gen, cfg)
            media = stub_media(cfg, gen)
        members.append(PoolMember(
            name=name, cfg=cfg, params=params,
            cost_rate=arch_cost_rate(get_config(name)), media=media,
        ))
    return members


def init_router(n_members: int, seed: int = 0,
                device: Optional[DeviceLike] = None) -> PredictiveRouter:
    """Seeded untrained router: ``attn`` quality and cost heads, R2 reward
    (for tests that need a router without training one)."""
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
                 smoke: bool = False, epochs: int = 120, n_traffic: int = 1200,
                 quality_kind: str = "attn",
                 owned: Optional[Collection[int]] = None) -> RoutedEngine:
    """Pool + trained router + engine on one device (the CUDA card by
    default), as the reference's ``build_routed_engine``:
    :func:`build_pool` (only the ``owned`` members' params, when given),
    then :func:`train_engine` on it."""
    device = resolve_device(device)
    pool = build_pool(names, seed=seed, device=device, smoke=smoke, owned=owned)
    return train_engine(pool, router_path=router_path, seed=seed, device=device,
                        epochs=epochs, n_traffic=n_traffic, quality_kind=quality_kind)


def train_engine(pool: Sequence[PoolMember], router_path: Optional[str] = None,
                 seed: int = 0, device: Optional[DeviceLike] = None,
                 epochs: int = 120, n_traffic: int = 1200,
                 quality_kind: str = "attn") -> RoutedEngine:
    """A trained router and the engine over an already built ``pool``.

    The router trains on ``n_traffic`` synthetic RouterBench queries mapped
    onto the pool (75/5/20 split): model embeddings and centroids by
    k-means of the training split, then ``train_dual_predictors`` of
    ``quality_kind`` and ``attn`` for ``epochs`` epochs with validation.
    ``router_path`` loads a checkpoint instead and skips training.
    """
    device = resolve_device(device)
    pool = list(pool)
    if router_path is not None:
        router = load_router(router_path, expect_pool_names=[m.name for m in pool],
                             device=device)
        if router.n_members != len(pool):
            raise ValueError(f"checkpoint pool size {router.n_members} != "
                             f"serving pool size {len(pool)}")
    else:
        data, quality, cost = synthetic_pool_traffic(pool, n=n_traffic, seed=seed)
        tr, va, _ = data.split(seed=seed)
        memb, centers = build_model_embeddings(data.emb[tr], quality[tr],
                                               seed=seed, device=device)
        qp, cp, scaler, _ = train_dual_predictors(
            quality_kind, "attn", data.emb[tr], quality[tr], cost[tr], memb,
            q_emb_val=data.emb[va], quality_val=quality[va], cost_val=cost[va],
            epochs=epochs, seed=seed, device=device)
        router = PredictiveRouter(quality_kind, "attn", qp, cp, memb, reward="R2",
                                  cost_scaler=scaler, centroids=centers)
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
    """Give a router without centroids (a checkpoint saved without them)
    the k-means centroids (C = 20) of the training embeddings, as a
    trained router carries them. Its model embeddings stay as they are."""
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


def quality_truth(pool: Sequence[PoolMember], data) -> Callable:
    """``truth(request) -> float``: the synthetic RouterBench quality of the
    request's text for the member that served it, over ``pool``'s quality
    columns (:func:`pool_quality_columns`). It stands in for the
    deployment's feedback: the adapter's ratings, the cascade's observed
    leg quality."""
    quality = data.quality[:, pool_quality_columns(pool, data)]
    qual_of_text = {data.texts[i]: quality[i] for i in range(len(data.texts))}

    def truth(req) -> float:
        return float(qual_of_text[req.text][req.member])

    return truth


def make_cascade(engine: RoutedEngine, truth: Optional[Callable], *,
                 governor: Optional[BudgetGovernor] = None, max_legs: int = 3,
                 beta: float = 1.0, margin: float = 0.0,
                 min_headroom: float = 0.0) -> CascadeCoordinator:
    """A cascade coordinator over the router's cost ladder, with ``truth``
    as each leg's observed quality (None: the router's estimate)."""
    policy = CascadePolicy(
        cost_ladder(engine.router),
        CascadeConfig(max_legs=max_legs, beta=beta, margin=margin,
                      min_headroom=min_headroom),
        reward=engine.router.reward)
    return CascadeCoordinator(policy, observed_quality=truth, governor=governor)


def make_feedback(truth: Callable, delay_s: float = 0.0, seed: int = 0):
    """(quality_feedback, feedback_source, stage) for one adapter: the
    truth at completion, or with ``delay_s`` > 0 staged and delivered
    ``delay_s`` (plus up to half that of seeded jitter) later, unresolved
    outcomes dropped after 20 delays."""
    if delay_s > 0:
        fb = DelayedFeedback(truth, delay_s, jitter_s=delay_s * 0.5, seed=seed)
        return fb, fb, OutcomeStage(timeout_s=20.0 * delay_s)
    return truth, None, None


def make_adapter(engine: RoutedEngine, truth: Callable, train_emb: np.ndarray, *,
                 governor: Optional[BudgetGovernor] = None, update_every: int = 32,
                 epsilon: float = 0.05, feedback_delay: float = 0.0,
                 refresh_established: bool = False, window: int = 48,
                 seed: int = 0) -> OnlineAdapter:
    """The reference's solo online adapter over ``engine``: a drift
    detector of ``window`` fitted on ``train_emb`` against the router's
    centroids (on the engine's device), exploration at ``epsilon`` seeded
    with ``seed``, an update every ``update_every`` outcomes, feedback from
    :func:`make_feedback`."""
    quality_feedback, feedback_source, stage = make_feedback(truth, feedback_delay, seed)
    drift = build_drift_proto(train_emb, engine.router.centroids, window=window,
                              device=engine.device)
    membership = (MembershipTracker(engine, refresh_established=True)
                  if refresh_established else None)
    return OnlineAdapter(
        engine, quality_feedback, governor=governor,
        config=OnlineUpdateConfig(update_every=update_every),
        exploration=ExplorationConfig(epsilon=epsilon, seed=seed),
        drift=drift, feedback_source=feedback_source, stage=stage,
        membership=membership, seed=seed)


def build_scheduler(engine: RoutedEngine, *, score_batch: int = 64,
                    max_batch: int = 8, max_wait_s: float = 0.05,
                    queue_capacity: int = 512, wall_time: bool = False,
                    semcache: Optional[SemanticCache] = None,
                    governor: Optional[BudgetGovernor] = None,
                    adapter: Optional[OnlineAdapter] = None,
                    cascade: Optional[CascadeCoordinator] = None,
                    tracer=None, slo=None, flusher=None,
                    clock: Optional[SimClock] = None,
                    device: Optional[DeviceLike] = None) -> MicroBatchScheduler:
    """The streaming scheduler over ``engine`` on the deterministic
    service-time model (``wall_time``: on measured wall time instead, as
    the reference's ``--wall-time``), with the obs hooks (``tracer``: a
    recorder's worker-scoped view, ``slo``: an SLO tracker, ``flusher``: an
    :class:`ObsFlusher`) when given. The engine, the cache and the drift
    detectors must all run on ``device`` (the CUDA card unless the caller
    names another)."""
    device = resolve_device(device)
    parts = [("engine", engine.device)]
    if semcache is not None:
        parts.append(("semantic cache", semcache.device))
        if semcache.drift is not None:
            parts.append(("drift detector", semcache.drift.device))
    if adapter is not None and adapter.drift is not None:
        parts.append(("adapter's drift detector", adapter.drift.device))
    for name, d in parts:
        if (d.type, d.index or 0) != (device.type, device.index or 0):
            raise ValueError(f"the {name} runs on {d}, the scheduler on {device}")
    return MicroBatchScheduler(
        engine, SchedulerConfig(score_batch=score_batch, max_batch=max_batch,
                                max_wait_s=max_wait_s, queue_capacity=queue_capacity),
        governor=governor, clock=clock,
        service_time=None if wall_time else default_service_model(),
        adapter=adapter, cascade=cascade, semcache=semcache,
        tracer=tracer, slo=slo, flusher=flusher)


def _streaming_requested(args) -> bool:
    return (args.scrape_every is not None or args.trace_sample is not None
            or args.trace_cap is not None or args.obs_dir is not None)


def setup_obs(args):
    """(recorder, registry, profiler, flusher) from the obs flags, as the
    reference's ``_setup_obs``.

    All default to None, and the runtime's tracer branches then cost
    nothing. Streaming mode (any of ``--scrape-every/--trace-sample/
    --trace-cap/--obs-dir``) builds the recorder with the sampler and cap
    and an :class:`ObsFlusher` over the segment directory; with no
    ``--scrape-every`` the flusher still samples, in one final flush.
    ``--trace-profile`` installs the kernel-dispatch profiler globally
    (:func:`save_obs` and :func:`run_trace_mode` remove it again).
    ``--metrics-port`` forces the registry on so the endpoint has
    something to serve.
    """
    recorder = registry = profiler = flusher = None
    streaming = _streaming_requested(args)
    label = f"serve-{args.trace}-seed{args.seed}"
    if args.trace_out or args.trace_profile or streaming:
        sampler = None
        if args.trace_sample is not None:
            sampler = TraceSampler(args.trace_sample, seed=args.seed,
                                   head=args.trace_head)
        recorder = TraceRecorder(label=label, sampler=sampler,
                                 max_buffered_per_worker=args.trace_cap)
    if args.metrics_out or args.metrics_port is not None or streaming:
        registry = MetricsRegistry()
    if streaming:
        args.obs_dir = args.obs_dir or f"obs_{args.trace}_seed{args.seed}"
        flusher = ObsFlusher(
            args.obs_dir, recorder=recorder, registry=registry,
            scrape_every_s=args.scrape_every, label=label,
            include_wall=args.trace_profile,
            deterministic_metrics=not args.trace_profile)
    if args.trace_profile:
        profiler = KernelProfiler(tracer=recorder)
        kops.set_kernel_profiler(profiler)
    return recorder, registry, profiler, flusher


def save_obs(args, recorder, registry, profiler, flusher=None,
             now: float = 0.0) -> None:
    """Write the obs artifacts and uninstall the profiler, as the
    reference's ``_save_obs``. ``now`` is the run's final virtual time; in
    streaming mode ``--trace-out`` is the concatenation of the segments."""
    if profiler is not None:
        kops.set_kernel_profiler(None)
        print(profiler.report())
        if registry is not None:
            profiler.register_metrics(registry)
    if flusher is not None:
        flusher.finalize(now)
        stats = recorder.drop_stats
        print(f"obs segments written to {args.obs_dir} "
              f"({flusher.seq} flushes, peak {recorder.peak_buffered} "
              f"buffered events, {stats['requests_sampled_out']} trees "
              f"sampled out, {stats['requests_shed']} shed)")
        if args.trace_out:
            with open(args.trace_out, "w") as fh:
                fh.write(json.dumps(concat_dir(args.obs_dir), sort_keys=True,
                                    separators=(",", ":")))
            print(f"concatenated trace written to {args.trace_out}")
    elif recorder is not None and args.trace_out:
        recorder.save(args.trace_out, include_wall=args.trace_profile)
        print(f"trace written to {args.trace_out} "
              f"({recorder.n_events} events)")
    if registry is not None and args.metrics_out:
        if args.metrics_out.endswith((".prom", ".txt")):
            registry.save_prometheus(args.metrics_out)
        else:
            # Deterministic unless wall-clock data was asked for.
            registry.save(args.metrics_out, deterministic=not args.trace_profile)
        print(f"metrics snapshot written to {args.metrics_out} "
              f"({len(registry)} series)")


def make_slo(args, tracer=None):
    """SLO tracker from the ``--slo-*`` flags (None when none is set)."""
    return build_slo_tracker(
        tracer=tracer, p95_target_s=args.slo_p95,
        miss_rate_budget=args.slo_miss_rate,
        quality_floor=args.slo_quality_floor,
        spend_per_window=args.slo_spend, window_s=args.slo_window)


def print_slo(slo, now: float) -> None:
    if slo is None:
        return
    firing = slo.firing()
    burns = {name: f"{b['long']:.2f}x" for name, b in slo.burn_rates(now).items()}
    print(f"slo: {slo.alerts_total} alert transitions  "
          f"firing {firing if firing else 'none'}  long-window burn "
          + "  ".join(f"{k}={v}" for k, v in burns.items()))


def _print_cache(cache: SemanticCache, prefix: str = "") -> None:
    rep = cache.report()
    print(f"{prefix}semcache: {rep['served']} served / {rep['lookups']} lookups "
          f"(hit rate {rep['hit_rate']:.2f})  "
          f"{rep['fallthroughs']} fallthroughs  "
          f"{rep['stale_hits']} stale  {rep['evicted']} evicted  "
          f"{rep['invalidations']} invalidated  "
          f"{rep['entries']} entries")
    if cache.drift is not None:
        print(f"{prefix}drift: {cache.drift.windows_seen} windows, "
              f"{cache.drift.alarms} alarms")


def _print_budget(governor, args, now: float, prefix: str = "budget",
                  extra: str = "") -> None:
    g = governor.summary(now)
    print(f"{prefix} ${g['budget_per_window']:.4f}/{args.budget_window}s "
          f"window  spend ${g['total_spend']:.6f}  "
          f"final lambda {g['lam']:.3g} (nominal {g['lam0']:.3g})  "
          f"tightened x{int(g['tightened'])} relaxed x{int(g['relaxed'])}{extra}")


def trace_corpus(engine: RoutedEngine, args):
    """(data, train indices, held-out indices, truth) of a trace run: the
    synthetic RouterBench corpus mapped onto the pool and split from
    ``--seed``; the router given k-means centroids of the training split
    if it has none; the truth lookup with ``--online`` or ``--cascade``
    (else None). Every process of a socket run derives the same."""
    data, _, _ = synthetic_pool_traffic(engine.pool, seed=args.seed)
    tr, _, te = data.split(seed=args.seed)
    fit_router_centroids(engine.router, data.emb[tr], seed=args.seed,
                         device=engine.device)
    truth = quality_truth(engine.pool, data) if (args.online or args.cascade) else None
    return data, tr, te, truth


def cache_radius(args, train_emb: np.ndarray, device) -> Optional[float]:
    """``--cache-radius``, or with ``--semcache`` and none given, the radius
    calibrated on the training split; printed when the cache is on."""
    radius = args.cache_radius
    if args.semcache:
        if radius is None:
            radius = calibrate_radius(train_emb, device=device)
        print(f"semcache radius {radius:.4f}"
              + (" (training-split NN-distance quantile)"
                 if args.cache_radius is None else ""))
    return radius


def make_serve_trace(args, data, te: np.ndarray, vocab: int) -> list:
    """The run's trace, as the reference's ``main`` makes it: ``--trace``
    kind, ``--requests`` at ``--rate`` from ``--seed``, prompts of up to 48
    tokens below ``vocab``, ``--max-new`` tokens (4 unless given) and a
    deadline ``--deadline`` virtual seconds after arrival (none unless
    given), its texts from the held-out split ``te`` of ``data``; with
    ``--slo-class K`` the requests get classes 0..K-1 round-robin in
    arrival order (followers get them with the requests)."""
    trace = make_trace(
        TraceConfig(kind=args.trace, n_requests=args.requests, rate=args.rate,
                    seed=args.seed, max_new=args.max_new or 4,
                    deadline_s=args.deadline, prompt_len_max=48, vocab=vocab),
        texts=[data.texts[i] for i in te],
        benchmarks=[data.benchmark[i] for i in te])
    if args.slo_class > 0:
        for i, r in enumerate(trace):
            r.slo_class = i % args.slo_class
    return trace


def run_trace_mode(engine: RoutedEngine, args, fleet: Optional["FollowerFleet"] = None
                   ) -> dict:
    """Replay ``args.trace`` over the held-out split through the scheduler
    (with the semantic cache, the online adapter, the cascade, the budget
    governor and the obs stack as ``args`` asks), on one scheduler or, with
    ``--workers N``, on the serving plane (in process, or over ``fleet``'s
    follower processes with ``--transport socket``); print the report and
    return the run's summary."""
    data, tr, te, truth = trace_corpus(engine, args)
    obs = setup_obs(args)
    mserver = None
    try:
        radius = cache_radius(args, data.emb[tr], engine.device)
        trace = make_serve_trace(args, data, te,
                                 vocab=min(m.cfg.vocab_size for m in engine.pool))
        if args.metrics_port is not None:
            mserver = MetricsServer(obs[1], port=args.metrics_port)
            print(f"metrics endpoint: http://127.0.0.1:{mserver.start()}/metrics")
        if fleet is not None:
            return _run_plane_socket(engine, args, data.emb[tr], truth, radius, trace,
                                     obs, fleet, mserver=mserver)
        run = _run_plane if args.workers > 1 else _run_solo
        return run(engine, args, data.emb[tr], truth, radius, trace, obs)
    finally:
        if mserver is not None:
            mserver.stop()
        if obs[2] is not None:
            kops.set_kernel_profiler(None)


def _run_solo(engine, args, train_emb, truth, radius, trace, obs) -> dict:
    """One scheduler (``--workers 1``)."""
    recorder, registry, profiler, flusher = obs
    governor = (BudgetGovernor(args.budget, args.budget_window, lam0=args.lam)
                if args.budget > 0 else None)
    adapter = None
    if args.online:
        adapter = make_adapter(
            engine, truth, train_emb, governor=governor,
            update_every=args.online_update_every, epsilon=args.epsilon,
            feedback_delay=args.feedback_delay,
            refresh_established=args.refresh_established, seed=args.seed)
    cascade = None
    if args.cascade:
        cascade = make_cascade(engine, truth, governor=governor, max_legs=args.max_legs,
                               beta=args.cascade_beta, margin=args.cascade_margin,
                               min_headroom=args.cascade_min_headroom)
    cache = None
    if args.semcache:
        drift = None if adapter is not None else build_drift_proto(
            train_emb, engine.router.centroids, seed=args.seed, device=engine.device)
        cache = make_semcache(train_emb, radius=radius, cap=args.cache_cap,
                              drift=drift, device=engine.device)
    slo = make_slo(args, tracer=recorder)
    sched = build_scheduler(engine, score_batch=args.score_batch,
                            max_batch=args.max_batch, max_wait_s=args.max_wait,
                            queue_capacity=args.queue_capacity,
                            wall_time=args.wall_time, semcache=cache,
                            governor=governor, adapter=adapter, cascade=cascade,
                            tracer=recorder.scoped(0) if recorder is not None else None,
                            slo=slo, flusher=flusher, device=engine.device)
    sched.slo_enforce = args.slo_class > 0
    if registry is not None:
        register_scheduler_metrics(registry, sched)
        if governor is not None:
            register_governor_metrics(registry, governor, lambda: sched.clock.now)
        if slo is not None:
            register_slo_metrics(registry, slo, lambda: sched.clock.now)
        if flusher is not None:
            register_stream_metrics(registry, flusher)
    summary = sched.run_trace(trace)
    print(f"trace={args.trace} requests={args.requests} seed={args.seed}")
    print(sched.telemetry.report(summary.get("duration_s")))
    if cascade is not None:
        print(cascade.report())
    if cache is not None:
        _print_cache(cache)
    if adapter is not None:
        print(adapter.report())
        print(f"drift: {adapter.drift.windows_seen} windows, "
              f"{adapter.drift.alarms} alarms")
    if governor is not None:
        _print_budget(governor, args, sched.clock.now)
    print_slo(slo, sched.clock.now)
    save_obs(args, recorder, registry, profiler, flusher, now=sched.clock.now)
    return summary


def build_plane_worker(engine: RoutedEngine, args, wid: int, *, governor, drift_proto,
                       truth, train_emb, radius, recorder, slo) -> WorkerNode:
    """One plane worker, as the reference's ``build_plane_worker``,
    identical whichever process builds it.

    Its :class:`RoutedEngine` shares ``engine``'s router and pool by
    reference (its own cached pool projections, no copy of any member's
    params); in a socket run ``governor`` is a follower's
    :class:`~repro_torch.distributed.ledger.LedgerClient` and ``recorder``
    the follower's own. Its adapter is a follower (``defer_updates=True``)
    seeded ``seed + 101 * wid + 1`` with a deep copy of the fitted
    ``drift_proto``;
    it has its own cascade and semantic cache, and the shared ``governor``
    (the ledger), ``recorder`` (through its worker-scoped view) and ``slo``.
    """
    weng = RoutedEngine(router=engine.router, pool=engine.pool, lam=args.lam,
                        device=engine.device)
    adapter = None
    if args.online:
        wseed = args.seed + 101 * wid + 1
        quality_feedback, feedback_source, stage = make_feedback(
            truth, args.feedback_delay, wseed)
        membership = (MembershipTracker(weng, refresh_established=True)
                      if args.refresh_established else None)
        adapter = OnlineAdapter(
            weng, quality_feedback, governor=governor,
            config=OnlineUpdateConfig(update_every=args.online_update_every),
            exploration=ExplorationConfig(epsilon=args.epsilon, seed=wseed),
            drift=copy.deepcopy(drift_proto), feedback_source=feedback_source,
            stage=stage, membership=membership, defer_updates=True, seed=wseed)
    cascade = None
    if args.cascade:
        cascade = make_cascade(weng, truth, governor=governor, max_legs=args.max_legs,
                               beta=args.cascade_beta, margin=args.cascade_margin,
                               min_headroom=args.cascade_min_headroom)
    cache = None
    if args.semcache:
        drift = None if adapter is not None else build_drift_proto(
            train_emb, weng.router.centroids, seed=args.seed, device=weng.device)
        cache = make_semcache(train_emb, radius=radius, cap=args.cache_cap,
                              drift=drift, device=weng.device)
    sched = build_scheduler(weng, score_batch=args.score_batch,
                            max_batch=args.max_batch, max_wait_s=args.max_wait,
                            queue_capacity=args.queue_capacity,
                            wall_time=args.wall_time, semcache=cache,
                            governor=governor, adapter=adapter, cascade=cascade,
                            tracer=recorder.scoped(wid) if recorder is not None else None,
                            slo=slo, clock=SimClock(), device=weng.device)
    sched.slo_enforce = args.slo_class > 0
    return WorkerNode(wid, weng, sched, adapter)


def plane_drift_proto(engine: RoutedEngine, args, train_emb: np.ndarray):
    """With ``--online``, the plane workers' drift-detector prototype: fitted
    on ``train_emb`` against the router's centroids with a window of
    ``max(16, 48 // N)``, as each worker watches its 1/N share of the
    traffic (None without ``--online``). Each worker takes a deep copy."""
    if not args.online:
        return None
    return build_drift_proto(train_emb, engine.router.centroids,
                             window=max(16, 48 // args.workers), device=engine.device)


def plane_events(args) -> List[PlaneEvent]:
    """The crash and rejoin of ``--crash-worker`` the flags ask for."""
    events = []
    if args.crash_at is not None:
        events.append(PlaneEvent(args.crash_at, "crash", args.crash_worker))
        if args.rejoin_at is not None:
            events.append(PlaneEvent(args.rejoin_at, "rejoin", args.crash_worker))
    return events


def build_plane(engine: RoutedEngine, args, train_emb: np.ndarray, truth, radius, *,
                recorder=None, slo=None, flusher=None):
    """(plane, ledger) for ``args.workers`` in-process workers over
    LocalTransport, each from :func:`build_plane_worker`; the ledger is the
    shared :class:`SharedBudgetLedger` (None without ``--budget``). With
    ``--online`` the workers' drift detectors are deep copies of
    :func:`plane_drift_proto`."""
    governor = (SharedBudgetLedger(args.budget, args.budget_window, lam0=args.lam)
                if args.budget > 0 else None)
    drift_proto = plane_drift_proto(engine, args, train_emb)
    workers = [build_plane_worker(engine, args, wid, governor=governor,
                                  drift_proto=drift_proto, truth=truth,
                                  train_emb=train_emb, radius=radius,
                                  recorder=recorder, slo=slo)
               for wid in range(args.workers)]
    coord = Coordinator(workers, SyncConfig(
        sync_every_s=args.sync_every, seed=args.seed,
        update=OnlineUpdateConfig(update_every=args.online_update_every)))
    plane = ServingPlane(workers, coord, events=plane_events(args), tracer=recorder,
                         flusher=flusher)
    return plane, governor


def _register_plane_metrics(registry, plane, slo, flusher) -> None:
    """The plane's, the fleet SLO's and the flusher's series on ``registry``
    (a run without one registers nothing)."""
    if registry is None:
        return
    register_plane_metrics(registry, plane)
    if slo is not None:
        register_slo_metrics(registry, slo,
                             lambda: max(w.clock.now for w in plane.workers.values()))
    if flusher is not None:
        register_stream_metrics(registry, flusher)


def _run_plane(engine, args, train_emb, truth, radius, trace, obs) -> dict:
    """N in-process workers over LocalTransport (``--workers N``)."""
    recorder, registry, profiler, flusher = obs
    # One fleet-level SLO tracker: every worker's finalized requests feed it.
    slo = make_slo(args, tracer=recorder)
    plane, governor = build_plane(engine, args, train_emb, truth, radius,
                                  recorder=recorder, slo=slo, flusher=flusher)
    workers = list(plane.workers.values())
    _register_plane_metrics(registry, plane, slo, flusher)
    summary = plane.run_trace(trace)
    print(f"trace={args.trace} requests={args.requests} seed={args.seed} "
          f"workers={args.workers}")
    print(plane.report(summary.get("duration_s")))
    for w in sorted(workers, key=lambda w: w.wid):
        if args.cascade:
            print(f"w{w.wid} {w.scheduler.cascade.report()}")
        if args.semcache:
            _print_cache(w.scheduler.semcache, prefix=f"w{w.wid} ")
        if args.online:
            print(f"w{w.wid} {w.adapter.report()}")
    t_end = max(w.clock.now for w in workers)
    if governor is not None:
        _print_budget(governor, args, t_end, prefix="shared budget",
                      extra=f" throttled x{governor.throttled}")
    print_slo(slo, t_end)
    save_obs(args, recorder, registry, profiler, flusher, now=t_end)
    return summary


def peak_memory_note(device) -> str:
    """``, peak device memory X GiB (reserved Y GiB)``: the caching
    allocator's peaks on a CUDA ``device`` (allocated, and held from the
    card), for a socket run's reports; "" on the CPU."""
    if torch.device(device).type != "cuda":
        return ""
    return (f", peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB "
            f"(reserved {torch.cuda.max_memory_reserved(device) / 2**30:.3f} GiB)")


def follower_env() -> dict:
    """The environment a follower process starts with: this one's, with
    ``PYTHONPATH`` led by the directory this package was imported from
    (the controller may have been started by path, with no PYTHONPATH).
    ``__path__``, not ``__file__``: a src-layout package may be imported
    as a namespace package, whose ``__file__`` is None."""
    import repro_torch

    env = dict(os.environ)
    src_root = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
    env["PYTHONPATH"] = (src_root + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else src_root)
    return env


class FollowerFleet:
    """Workers 1..N-1 of a socket run as OS processes, connected.

    Opens the controller's listening socket (a :class:`SocketTransport`
    for worker 0 on ``device``), starts ``python -m
    repro_torch.distributed.host`` for each follower with ``raw_argv`` (by
    exec: no follower inherits this process's CUDA context) and accepts
    their HELLOs on a thread of its own, so this process builds its shard
    while the followers start, dial back and build theirs. :meth:`hellos`
    waits for the accepts (120 s at most). :meth:`close` shuts the
    transport and waits for every follower, killing one that has not
    exited within 60 s.
    """

    def __init__(self, args, raw_argv: Sequence[str], device):
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.distributed.transport import SocketTransport

        # Long connection timeout: frames wait in TCP buffers while the
        # followers build and train.
        self.transport = SocketTransport(0, timeout=600.0, device=device)
        self.port = self.transport.listen()
        env = follower_env()
        self.procs = [
            subprocess.Popen([sys.executable, "-m", "repro_torch.distributed.host",
                              "--wid", str(wid), "--port", str(self.port),
                              "--serve-argv", json.dumps(list(raw_argv))], env=env)
            for wid in range(1, args.workers)]
        self._accepting = ThreadPoolExecutor(max_workers=1)
        self._hellos = self._accepting.submit(self.transport.accept, args.workers - 1,
                                              timeout=120.0)

    def hellos(self) -> dict:
        """wid -> HELLO payload of every follower, once all have dialled
        back; raises the accept's ``TransportError`` if one did not."""
        return self._hellos.result()

    def close(self) -> None:
        self._accepting.shutdown(wait=True)
        self.transport.close()
        for proc in self.procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _run_plane_socket(engine, args, train_emb, truth, radius, trace, obs,
                      fleet: FollowerFleet, mserver=None) -> dict:
    """Workers 1..N-1 as OS processes over :class:`SocketTransport`, as the
    reference's ``_run_plane_socket``.

    This process is worker 0, the controller and (by lowest-id election)
    the leader: the coordinator's updater reads the leader's engine
    directly, so co-locating leader and controller runs leader updates
    without shipping optimizer state over the wire. Workers 1..N-1 are
    ``fleet``'s processes: each re-parses this argv, builds the pool
    members it owns, trains its router from ``--seed`` and services
    protocol messages. ``engine`` holds only worker 0's members. Generate
    legs for a member the executing worker does not own hop to the owner
    as ``GENERATE``; follower budget ops reach this process's shared
    ledger as ``LEDGER_OP``.
    """
    from repro_torch.distributed import messages as M
    from repro_torch.distributed.host import RemoteWorkerProxy, say
    from repro_torch.distributed.messages import Message, router_digest
    from repro_torch.distributed.shard import (
        PoolDispatcher, owner_of, pool_param_bytes, shard_pool,
    )
    from repro_torch.distributed.transport import TransportError
    from repro_torch.obs import merge_prom_texts

    recorder, registry, profiler, flusher = obs
    slo = make_slo(args, tracer=recorder)
    governor = (SharedBudgetLedger(args.budget, args.budget_window, lam0=args.lam)
                if args.budget > 0 else None)
    transport, port, hellos = fleet.transport, fleet.port, fleet.hellos()
    w0 = build_plane_worker(engine, args, 0, governor=governor,
                            drift_proto=plane_drift_proto(engine, args, train_emb),
                            truth=truth, train_emb=train_emb, radius=radius,
                            recorder=recorder, slo=slo)
    w0.ledger = governor        # follower LEDGER_OP messages land here
    shard_pool(w0.engine.pool, 0, args.workers, device=engine.device)
    w0.scheduler.dispatcher = PoolDispatcher(0, args.workers, w0.engine, transport)
    w0.bind(transport)
    names = [m.name for m in engine.pool]
    proxies = [RemoteWorkerProxy(wid, transport, member_names=names,
                                 pid=int(hellos[wid].get("pid", -1)))
               for wid in range(1, args.workers)]
    workers = [w0] + proxies
    pids = {0: os.getpid()}
    pids.update({p.wid: p.pid for p in proxies})
    say(f"socket plane: controller pid {pids[0]} port {port}  router "
        f"v{engine.router.version} digest {router_digest(engine.router)} "
        f"({pool_param_bytes(engine.pool) / 2**30:.4f} GiB of params)  "
        + "  ".join(f"w{p.wid}:pid{p.pid}" for p in proxies))
    say("pool ownership: " + "  ".join(
        f"{names[mi]}->w{owner_of(mi, args.workers)}" for mi in range(len(names))))
    coord = Coordinator(workers, SyncConfig(
        sync_every_s=args.sync_every, seed=args.seed,
        update=OnlineUpdateConfig(update_every=args.online_update_every)),
        transport=transport)
    # Fleet-wide obs drain, called by the plane at sync boundaries and
    # once more after the run: follower trace batches are absorbed
    # verbatim (their keys start at wid * 1_000_000), and follower
    # registries are scraped over METRICS_REQ for the live endpoint.
    # The RPCs run here, on the plane's loop, never on the HTTP thread.
    fleet_prom = {}

    def fleet_drain(now, force=False):
        for p in proxies:
            try:
                if recorder is not None:
                    rep = transport.request(Message(
                        kind=M.TRACE_REQ, dst=p.wid, payload={"force": bool(force)}))
                    recorder.absorb([tuple(e) for e in rep.payload["events"]])
                if registry is not None:
                    rep = transport.request(Message(kind=M.METRICS_REQ, dst=p.wid))
                    text = rep.payload.get("prom", "")
                    if text:
                        fleet_prom[p.wid] = text
                        if mserver is not None:
                            mserver.update_fleet(p.wid, text)
            except TransportError:
                continue

    plane = ServingPlane(workers, coord, events=plane_events(args), tracer=recorder,
                         flusher=flusher,
                         fleet_drain=(fleet_drain if recorder is not None
                                      or registry is not None else None))
    _register_plane_metrics(registry, plane, slo, flusher)
    summary = plane.run_trace(trace)
    summary["transport"] = "socket"
    summary["pids"] = pids
    summary["pool_owner"] = {names[mi]: owner_of(mi, args.workers)
                             for mi in range(len(names))}
    # Whatever the sync-boundary drains have not collected (open trees,
    # spans after FINALIZE, the last metrics) comes in now.
    if recorder is not None or registry is not None:
        fleet_drain(None, force=True)
    print(f"trace={args.trace} requests={args.requests} seed={args.seed} "
          f"workers={args.workers} transport=socket")
    print(plane.report(summary.get("duration_s")))
    # Only w0's serving components live here; each follower prints its
    # own cascade, cache and adapter lines when it shuts down.
    if args.cascade:
        print(f"w0 {w0.scheduler.cascade.report()}")
    if args.semcache:
        _print_cache(w0.scheduler.semcache, prefix="w0 ")
    if args.online:
        print(f"w0 {w0.adapter.report()}")
    t_end = max(w.clock.now for w in workers)
    if governor is not None:
        _print_budget(governor, args, t_end, prefix="shared budget",
                      extra=f" throttled x{governor.throttled}")
    print_slo(slo, t_end)
    disp = w0.scheduler.dispatcher
    say(f"socket plane: w0 router v{w0.router_version} digest "
        f"{router_digest(w0.engine.router)}, generate local/remote "
        f"{disp.stats['local']}/{disp.stats['remote']}{peak_memory_note(engine.device)}")
    save_obs(args, recorder, registry, profiler, flusher, now=t_end)
    if args.metrics_out and registry is not None and fleet_prom:
        fleet_path = args.metrics_out + ".fleet.prom"
        own = registry.prometheus(deterministic=not args.trace_profile)
        with open(fleet_path, "w") as fh:
            fh.write(merge_prom_texts([own] + [fleet_prom[w] for w in sorted(fleet_prom)]))
        print(f"fleet metrics exposition written to {fleet_path} "
              f"({1 + len(fleet_prom)} registries)")
    for p in proxies:
        try:
            transport.send(Message(kind=M.SHUTDOWN, dst=p.wid))
        except TransportError:
            pass
    return summary


def make_parser() -> argparse.ArgumentParser:
    """The serve argv schema."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pool", default=DEFAULT_POOL)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--router", "--restore-router", dest="router", default=None,
                    metavar="PATH",
                    help="npz router checkpoint to load instead of training "
                         "(--restore-router is the reference's name)")
    ap.add_argument("--epochs", type=int, default=80,
                    help="router training epochs")
    ap.add_argument("--quality-kind", default="attn", choices=sorted(PREDICTORS),
                    help="quality predictor kind (the cost predictor is attn)")
    ap.add_argument("--save-router", default=None, metavar="PATH",
                    help="write the router as an npz checkpoint")
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
    ap.add_argument("--max-wait", type=float, default=0.05,
                    help="virtual seconds a partial micro-batch waits")
    ap.add_argument("--score-batch", type=int, default=64)
    ap.add_argument("--queue-capacity", type=int, default=512,
                    help="admission queue capacity (arrivals past it are "
                         "rejected)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline, virtual seconds after arrival")
    ap.add_argument("--wall-time", action="store_true",
                    help="advance the virtual clock by measured wall time "
                         "instead of the deterministic service model")
    ap.add_argument("--semcache", action="store_true",
                    help="semantic answer cache as rung 0 (with --trace)")
    ap.add_argument("--cache-radius", type=float, default=None,
                    help="semcache: L2 match radius (default: calibrated "
                         "from the training split)")
    ap.add_argument("--cache-cap", type=int, default=256,
                    help="semcache: max entries (LRU eviction past it)")
    ap.add_argument("--lam", type=float, default=1.0,
                    help="willingness to pay (the governor's nominal lambda)")
    ap.add_argument("--budget", type=float, default=0.0,
                    help="$ budget per rolling window (0 disables the governor)")
    ap.add_argument("--budget-window", type=float, default=0.5,
                    help="governor window, virtual seconds")
    ap.add_argument("--online", action="store_true",
                    help="online adaptation: replay-buffered outcome feedback, "
                         "drift detection, exploration and incremental router "
                         "updates (with --trace)")
    ap.add_argument("--refresh-established", action="store_true",
                    help="online: EMA outcome-driven embedding refresh for "
                         "graduated members")
    ap.add_argument("--online-update-every", type=int, default=32,
                    help="online: outcomes between scheduled updates")
    ap.add_argument("--epsilon", type=float, default=0.05,
                    help="online: exploration rate at full budget headroom")
    ap.add_argument("--feedback-delay", type=float, default=0.0,
                    help="online: virtual seconds until quality feedback "
                         "arrives (staged path; 0 = at completion)")
    ap.add_argument("--cascade", action="store_true",
                    help="cascade routing: train the attn-ens quality head and "
                         "escalate up the cost ladder (with --trace)")
    ap.add_argument("--max-legs", type=int, default=3,
                    help="cascade: max legs per request")
    ap.add_argument("--cascade-beta", type=float, default=1.0,
                    help="cascade: optimism width on untried rungs")
    ap.add_argument("--cascade-margin", type=float, default=0.0,
                    help="cascade: required expected marginal reward to escalate")
    ap.add_argument("--cascade-min-headroom", type=float, default=0.0,
                    help="cascade: budget headroom below which no leg escalates")
    ap.add_argument("--workers", type=int, default=1,
                    help="N > 1 serves the trace on the serving plane: N "
                         "workers, leader/follower sync")
    ap.add_argument("--transport", default="local", choices=["local", "socket"],
                    help="plane message transport: local = in-process, the "
                         "workers sharing one pool (byte-identical seeded "
                         "replays); socket = workers 1..N-1 as OS processes "
                         "over length-prefixed TCP, each holding only the pool "
                         "members it owns")
    ap.add_argument("--sync-every", type=float, default=0.05,
                    help="virtual seconds between replay-merge/broadcast rounds")
    ap.add_argument("--crash-at", type=float, default=None,
                    help="crash --crash-worker at this virtual time")
    ap.add_argument("--rejoin-at", type=float, default=None,
                    help="rejoin the crashed worker at this virtual time")
    ap.add_argument("--crash-worker", type=int, default=1,
                    help="worker id for the crash/rejoin scenario")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's per-request spans as Chrome-trace "
                         "JSON (byte-identical across replays of a seed)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="metrics snapshot at the end (.prom/.txt: Prometheus "
                         "text, else canonical JSON)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve the live registry on localhost HTTP for the "
                         "run (/metrics, /metrics.json; 0 picks a port)")
    ap.add_argument("--trace-profile", action="store_true",
                    help="time every kernel dispatch under a device sync and "
                         "put the wall-clock spans/metrics in the artifacts "
                         "(which are then not replay-stable)")
    ap.add_argument("--scrape-every", type=float, default=None, metavar="VIRT_S",
                    help="streaming obs: flush trace spans and a metrics scrape "
                         "to segments every this many virtual seconds")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="segment directory for streaming obs (default "
                         "obs_<trace>_seed<seed>)")
    ap.add_argument("--trace-sample", type=float, default=None, metavar="RATE",
                    help="deterministic per-request trace sampling rate in "
                         "[0, 1]; anomalous requests are always kept")
    ap.add_argument("--trace-head", type=int, default=8,
                    help="always keep the first N request trees")
    ap.add_argument("--trace-cap", type=int, default=None, metavar="N",
                    help="per-worker buffered-event cap: new request trees "
                         "are shed past it")
    ap.add_argument("--slo-p95", type=float, default=None, metavar="VIRT_S",
                    help="SLO: p95 e2e latency target (error budget 5%%)")
    ap.add_argument("--slo-miss-rate", type=float, default=None, metavar="FRAC",
                    help="SLO: allowed deadline-miss fraction")
    ap.add_argument("--slo-quality-floor", type=float, default=None,
                    help="SLO: per-request quality floor (error budget 10%%)")
    ap.add_argument("--slo-spend", type=float, default=None, metavar="USD",
                    help="SLO: $ spend allowed per --slo-window")
    ap.add_argument("--slo-window", type=float, default=0.25, metavar="VIRT_S",
                    help="SLO compliance window, virtual seconds")
    ap.add_argument("--slo-class", type=int, default=0, metavar="K",
                    help="assign trace requests classes in [0, K) round-robin "
                         "and shed the lowest while an SLO alert fires")
    return ap


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The serve flags, checked: what needs ``--trace``, the crash/rejoin
    order, and the reference's two socket-transport errors (``--workers``
    below 2, a crash of the controller)."""
    ap = make_parser()
    args = ap.parse_args(argv)
    trace_only = ["semcache", "online", "cascade", "trace_out", "metrics_out",
                  "metrics_port", "trace_profile", "scrape_every", "obs_dir",
                  "trace_sample", "trace_cap", "crash_at"]
    for flag in trace_only:
        if getattr(args, flag) not in (None, False) and args.trace is None:
            ap.error(f"--{flag.replace('_', '-')} needs --trace")
    if args.workers > 1 and args.trace is None:
        ap.error("--workers needs --trace")
    if (args.crash_at is not None and args.rejoin_at is not None
            and args.rejoin_at <= args.crash_at):
        ap.error(f"--rejoin-at ({args.rejoin_at}) must be after "
                 f"--crash-at ({args.crash_at})")
    if args.transport == "socket":
        if args.workers < 2:
            ap.error("--transport socket needs --workers >= 2")
        if args.crash_at is not None and args.crash_worker == 0:
            ap.error("--transport socket pins the controller (and leader) "
                     "to worker 0; crash a follower instead")
    return args


def run_cli(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    """What ``main`` does; returns the trace run's summary (None for the
    one batch). With ``--transport socket`` this process is the controller:
    it starts the followers first (:class:`FollowerFleet`), so that they
    build while it builds, and builds only worker 0's pool members."""
    # Socket mode forwards the raw argv to the followers, which re-parse it.
    raw_argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(raw_argv)

    names = args.pool.split(",")
    fleet = owned = None
    if args.transport == "socket":       # parse_args holds it to --workers >= 2
        fleet = FollowerFleet(args, raw_argv, resolve_device(args.device))
        owned = owned_members(0, len(names), args.workers)
    try:
        t0 = time.perf_counter()
        engine = build_engine(names, router_path=args.router, seed=args.seed,
                              device=args.device, smoke=args.smoke, epochs=args.epochs,
                              quality_kind="attn-ens" if args.cascade else args.quality_kind,
                              owned=owned)
        engine.lam = args.lam
        t_build = time.perf_counter() - t0
        print(f"device: {engine.device}  build: {t_build:.3f}s")
        if args.save_router is not None:
            save_router(args.save_router, engine.router, pool_names=names)
            print(f"router saved to {args.save_router}")
        if args.trace is not None:
            return run_trace_mode(engine, args, fleet)
    finally:
        if fleet is not None:
            fleet.close()
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    texts, prompts = synthetic_requests(args.requests, vocab, seed=args.seed)
    res = engine.serve(texts, prompts, max_new=args.max_new or MAX_NEW)
    n_tok = sum(len(o) for o in res["outputs"])
    print("per-member counts: " + ", ".join(
        f"{m.name}={int(c)}" for m, c in zip(engine.pool, res["per_member_counts"])))
    print(f"total $: {res['total_cost']:.6g}  serve: {res['latency_s']:.3f}s  "
          f"tokens/s: {n_tok / res['latency_s']:.1f}")
    return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The serve CLI; exits 0 (:func:`run_cli` returns the summary)."""
    run_cli(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
