"""The port's import closure and its device rule.

``repro_torch`` must import neither ``jax`` nor anything of ``repro``; the
check runs in a fresh interpreter, because other test files in the same
worker import both. Entry points run on CUDA unless told otherwise: with
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
from repro_torch.launch.serve import build_engine, build_pool, init_router
from repro_torch.serving.engine import RoutedEngine

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
print(json.dumps({"n_modules": len(names), "leaked": leaked}))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["n_modules"] >= 20
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
