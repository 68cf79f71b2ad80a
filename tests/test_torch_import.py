"""The port's import closure and its device rule.

``repro_torch`` must import neither ``jax`` nor anything of ``repro``; the
check runs in a fresh interpreter, because other test files in the same
worker import both, and walks every module of the package (the training
and evaluation modules included). Entry points run on CUDA unless told otherwise: with
no device given and no card present they raise, never quietly use the CPU.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_router, save_router
from repro_torch.core.baselines import KNNRouter, SVMRouter
from repro_torch.core.model_repr import build_model_embeddings, embed_new_model
from repro_torch.core.clustering import assign_clusters, kmeans
from repro_torch.launch.serve import (
    build_drift_proto, build_engine, build_pool, build_scheduler, init_router,
    make_semcache,
)
from repro_torch.online.drift import DriftDetector
from repro_torch.serving.engine import RoutedEngine
from repro_torch.serving.semcache import SemanticCache, calibrate_radius
from repro_torch.training import train_dual_predictors

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

_PROBE = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == "repro" or k.startswith("repro."))
leaked += sorted(k for k, m in sys.modules.items()
                 if (k == "jax" or k.startswith("jax.")) and m is not None)
print(json.dumps({"modules": names, "leaked": leaked}))
"""

# Modules the walk must reach (the online, cascade, obs and fleet layers among them).
REQUIRED = {
    "repro_torch.obs", "repro_torch.obs.trace", "repro_torch.obs.metrics",
    "repro_torch.obs.sampling", "repro_torch.obs.slo", "repro_torch.obs.stream",
    "repro_torch.obs.scrape", "repro_torch.obs.profiling", "repro_torch.obs.wiring",
    "repro_torch.distributed", "repro_torch.distributed.messages",
    "repro_torch.distributed.transport", "repro_torch.distributed.ledger",
    "repro_torch.distributed.worker", "repro_torch.distributed.coordinator",
    "repro_torch.distributed.plane", "repro_torch.distributed.shard",
    "repro_torch.distributed.host",
    "repro_torch.online.drift", "repro_torch.online.replay", "repro_torch.online.staging",
    "repro_torch.online.exploration", "repro_torch.online.membership",
    "repro_torch.online.updater", "repro_torch.online.loop", "repro_torch.cascade",
    "repro_torch.cascade.policy", "repro_torch.cascade.coordinator",
    "repro_torch.launch.serve", "repro_torch.serving.scheduler",
    "repro_torch.launch.train", "repro_torch.launch.steps", "repro_torch.data.lm_data",
    "repro_torch.common.dtypes",
    "repro_torch.launch.mesh", "repro_torch.launch.sharding", "repro_torch.launch.dryrun",
    "repro_torch.launch.hlo_analysis", "repro_torch.models.sharding_ctx",
    "repro_torch.models.runtime_flags", "repro_torch.configs.shapes",
}


def test_port_imports_no_jax_and_no_reference_module():
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert len(report["modules"]) >= 20
    assert REQUIRED <= set(report["modules"])
    assert report["leaked"] == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_build_pool_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pool(["qwen3-0.6b"], smoke=True)


def test_engine_without_device_raises_without_cuda(no_cuda):
    router = init_router(2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RoutedEngine(router=router, pool=[])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(["qwen3-0.6b"], smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_router(2)


def test_load_router_without_device_raises_without_cuda(no_cuda, tmp_path):
    path = str(tmp_path / "r.npz")
    save_router(path, init_router(2, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_router(path)
    got = load_router(path, device="cpu")
    assert got.device.type == "cpu" and got.n_members == 2
    assert isinstance(got.model_emb, np.ndarray)


def test_cpu_entry_points_run_on_the_cpu():
    engine = build_engine(["qwen3-0.6b", "granite-3-8b"], smoke=True, device="cpu")
    assert engine.device.type == "cpu"
    assert all(m.device.type == "cpu" for m in engine.pool)
    assert engine.router.device.type == "cpu"


def test_cache_drift_and_clustering_without_device_raise_without_cuda(no_cuda):
    emb = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    for call in (lambda: SemanticCache(0.5), lambda: calibrate_radius(emb),
                 lambda: DriftDetector(), lambda: kmeans(emb, 2),
                 lambda: assign_clusters(emb, emb[:2]),
                 lambda: make_semcache(emb, radius=0.5),
                 lambda: build_drift_proto(emb, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_training_and_evaluation_without_device_raise_without_cuda(no_cuda):
    rng = np.random.default_rng(0)
    emb, quality = rng.standard_normal((16, 8)), rng.uniform(size=(16, 2))
    memb = np.ones((2, 4), np.float32)
    for call in (lambda: build_model_embeddings(emb, quality, n_clusters=4),
                 lambda: embed_new_model(emb[:4], emb, quality[:, 0]),
                 lambda: train_dual_predictors("attn", "attn", emb, quality, quality,
                                               memb, epochs=1),
                 lambda: KNNRouter(emb, quality, quality),
                 lambda: SVMRouter.fit(emb, quality, quality)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_build_scheduler_without_device_raises_without_cuda(no_cuda):
    engine = build_engine(["qwen3-0.6b"], smoke=True, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_scheduler(engine)
    cache = SemanticCache(0.5, device="cpu")
    assert build_scheduler(engine, semcache=cache, device="cpu").semcache is cache
    with pytest.raises(ValueError, match="runs on cpu"):
        build_scheduler(engine, device="meta")


def test_serve_without_device_raises_without_cuda(no_cuda):
    """The serve entry point, one scheduler or the in-process plane, with
    the obs flags: no device and no card raise before anything is built."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import main

    for extra in ([], ["--workers", "3", "--online"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--smoke", "--trace", "drift", "--requests", "4", "--trace-profile",
                  *extra])
        assert ops.get_kernel_profiler() is None


def test_train_without_device_raises_without_cuda(no_cuda):
    """The LM training entry points: no device and no card raise before
    anything is built."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import main, train_loop

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(get_smoke_config("qwen3-0.6b"), steps=1, batch=2, seq=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1"])
