"""The port's cached streaming slice against the JAX reference, end to end.

Both packages replay the same seeded ``neardup`` trace (32 requests,
prompts of at most 16 tokens, 2 new tokens each) through their
``MicroBatchScheduler`` (score batch 16, micro-batches of 8, the
deterministic service-time model) with a semantic cache in front: one
calibrated radius, and a cache-owned ``DriftDetector(window=8,
patience=1)`` fitted on the training split against the router's k-means
centroids. The pool is the reference's default three members, as in
``test_torch_serving.py``. The reference scores through its Pallas kernel
in interpret mode; the port's pool crosses through ``repro_torch.bridge``
and its router through an npz checkpoint that carries the centroids.

Both must agree on every request's status, member and tokens, on its $
within 1e-12 relative, on the cache's stats, on the drift detector's
windows and alarms, and on the telemetry counts.
"""
import dataclasses

import numpy as np
import pytest

from repro.checkpoint import save_router as jax_save_router
from repro.core.clustering import kmeans as jax_kmeans
from repro.launch.serve import build_pool as jax_build_pool
from repro.online.drift import DriftDetector as JaxDetector
from repro.serving.engine import RoutedEngine as JaxEngine
from repro.serving.scheduler import MicroBatchScheduler as JaxScheduler
from repro.serving.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro.serving.scheduler import default_service_model as jax_service_model
from repro.serving.semcache import SemanticCache as JaxCache
from repro.serving.traffic import TraceConfig as JaxTraceConfig
from repro.serving.traffic import make_trace as jax_make_trace
from repro_torch.checkpoint import load_router
from repro_torch.data.routerbench import generate
from repro_torch.launch.serve import build_scheduler
from repro_torch.online.drift import DriftDetector
from repro_torch.serving.engine import RoutedEngine
from repro_torch.serving.semcache import SemanticCache, calibrate_radius
from repro_torch.serving.traffic import TraceConfig, make_trace
from test_torch_serving import NAMES, _jax_router, _port_pool

TRACE = dict(kind="neardup", n_requests=32, rate=400.0, seed=0, max_new=2,
             prompt_len_min=4, prompt_len_max=16, hot_set=8, dup_frac=0.7)
DRIFT = dict(window=8, patience=1, seed=0)
# Entries take the router's predicted quality of their member; the untrained
# router's (biases lifted, see test_torch_serving._jax_router) lie below the
# default admission floor of 0.25.
FLOOR = 0.05


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = generate(240, seed=0)
    tr, _, te = data.split(seed=0)
    train, held = data.emb[tr], [data.texts[i] for i in te]
    centroids, _ = jax_kmeans(train, 20, seed=0)
    radius = calibrate_radius(train, device="cpu")

    router = dataclasses.replace(_jax_router(held[:16]), centroids=centroids)
    jax_engine = JaxEngine(router=router, pool=jax_build_pool(NAMES, seed=0),
                           lam=1.0, use_pallas=True)
    path = str(tmp_path_factory.mktemp("ckpt") / "router.npz")
    jax_save_router(path, router, pool_names=NAMES)
    port_router = load_router(path, expect_pool_names=NAMES, device="cpu")
    port_engine = RoutedEngine(router=port_router, pool=_port_pool(jax_engine.pool),
                               lam=1.0, device="cpu")
    vocab = min(m.cfg.vocab_size for m in jax_engine.pool)

    ref_cache = JaxCache(radius, quality_floor=FLOOR,
                         drift=JaxDetector(**DRIFT).fit(train, centroids))
    ref_sched = JaxScheduler(jax_engine, JaxSchedulerConfig(score_batch=16, max_batch=8),
                             semcache=ref_cache, service_time=jax_service_model())
    ref_trace = jax_make_trace(JaxTraceConfig(vocab=vocab, **TRACE), held)
    ref_summary = ref_sched.run_trace(ref_trace)

    cache = SemanticCache(radius, quality_floor=FLOOR, device="cpu", drift=DriftDetector(
        device="cpu", **DRIFT).fit(train, port_router.centroids))
    sched = build_scheduler(port_engine, score_batch=16, max_batch=8,
                            max_wait_s=0.02, queue_capacity=256, semcache=cache,
                            device="cpu")
    trace = make_trace(TraceConfig(vocab=vocab, **TRACE), held)
    summary = sched.run_trace(trace)
    return {"ref": (ref_sched, ref_trace, ref_summary, ref_cache, train),
            "port": (sched, trace, summary, cache, train)}


def test_radius_is_calibrated_like_the_reference(runs):
    from repro.serving.semcache import calibrate_radius as jax_calibrate_radius

    train = runs["port"][4]
    assert runs["port"][3].radius == pytest.approx(jax_calibrate_radius(train), rel=1e-4)


def test_requests_agree(runs):
    _, ref_trace, _, _, _ = runs["ref"]
    _, trace, _, _, _ = runs["port"]
    members = set()
    for got, want in zip(trace, ref_trace):
        assert (got.status, got.member, got.leg) == (want.status, want.member, want.leg)
        np.testing.assert_array_equal(got.output, np.asarray(want.output))
        assert got.cost == pytest.approx(want.cost, rel=1e-12, abs=0)
        assert (got.arrival_s, got.finish_s) == (want.arrival_s, want.finish_s)
        members.add(got.member)
    assert members == set(range(len(NAMES))), "every member must generate"


def test_cache_and_drift_agree(runs):
    _, _, _, ref_cache, _ = runs["ref"]
    _, _, _, cache, _ = runs["port"]
    assert cache.report() == ref_cache.report()
    assert cache.stats["served"] > 0, "the trace must be served from the cache"
    assert cache.drift.windows_seen == ref_cache.drift.windows_seen >= 3
    assert cache.drift.alarms == ref_cache.drift.alarms
    for key, want in ref_cache.drift.last_stats.items():
        assert cache.drift.last_stats[key] == pytest.approx(want, rel=1e-5, abs=1e-5)


def test_telemetry_agrees(runs):
    _, _, ref_summary, _, _ = runs["ref"]
    _, _, summary, _, _ = runs["port"]
    assert summary["completed"] + summary["rejected"] + summary["expired"] == 32
    for key in ("completed", "rejected", "expired", "per_member_counts",
                "generate_calls", "score_batches", "cache_hits", "cache_misses",
                "cache_stale", "max_queue_depth", "queue_wait_p50_ms", "e2e_p99_ms"):
        assert summary[key] == ref_summary[key], key
    assert summary["total_spend"] == pytest.approx(ref_summary["total_spend"], rel=1e-12)
