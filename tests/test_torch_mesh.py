"""The port's steps on a device mesh, against the unsharded port and the
JAX reference; the dry-run's counts against a real step.

Smoke configs on the CPU:

  * the train step on a 1x1 gloo mesh in this process (params, moments
    and batch as DTensors) against the unsharded step and the
    reference's jitted ``make_train_step`` on carried params, for qwen3,
    granite-moe and xlstm: every gradient leaf within 1e-5 of its largest
    magnitude of the unsharded port's (on a mesh the cross entropy is
    vocab-parallel and granite-moe dispatches by the reference's one-hot
    einsums, so sums run in another order); the loss within 1e-5
    relative of both; the params after the step within lr of either
    (Adam moves an entry whose gradient is at the rounding level by up
    to lr, ``tests/test_torch_launch.py``);
  * four gloo processes on a 2x2 mesh (``tests/_torch_mesh_worker.py``;
    qwen3, granite-moe, xlstm and jamba): the loss within 1e-5 of the
    unsharded port's, every gradient leaf
    within 1e-4 of its largest magnitude, the prefill and two decode
    steps' logits within 1e-4; each config's pool member laid out by
    ``shard_pool(..., mesh=...)`` serves ragged prompts the unsharded
    port's tokens and $ costs exactly (the unsharded port's are held to
    the reference's ``greedy_generate`` in
    ``tests/test_torch_mesh_serve.py``);
  * the dry-run as a child process: its 1x1 FLOPs equal to
    ``FlopCounterMode`` on the same real step (the fake 16x16 mesh's
    records are held in ``tests/test_torch_sharding.py``);
  * ``train_loop`` on the 1x1 mesh: the unsharded losses, a checkpoint.

The file holds torch at two threads and destroys every process group it
starts.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_smoke_config as jax_get_smoke
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro.training.optim import adam_init as jax_adam_init
from repro_torch import bridge
from repro_torch.common.tree import flatten_with_paths
from repro_torch.configs import get_smoke_config
from repro_torch.data.lm_data import MarkovCorpus
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding, steps, train
from repro_torch.models import lm
from repro_torch.training.optim import adam_init

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_mesh_worker as worker  # noqa: E402

QWEN, MOE_NAME, XLSTM = "qwen3-0.6b", "granite-moe-1b-a400m", "xlstm-1.3b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ENV = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, so that parallel test
    workers do not each start one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mesh11():
    """A 1x1 gloo mesh in this process; its process group is destroyed
    after the module's tests."""
    assert not dist.is_initialized()
    mesh = mesh_mod.make_debug_mesh(1, 1, device="cpu")
    yield mesh
    dist.destroy_process_group()


def _batch(cfg):
    tok, lab = next(MarkovCorpus(cfg.vocab_size, seed=0).batches(4, 16, seed=1))
    return {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}


@pytest.mark.parametrize("name", [QWEN, MOE_NAME, XLSTM])
def test_train_step_on_a_1x1_mesh_matches_the_unsharded_port_and_the_reference(mesh11, name):
    jcfg, cfg = jax_get_smoke(name), get_smoke_config(name)
    jp = jax_lm.init_lm(jax.random.key(0), jcfg)
    carried = lambda: bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")  # noqa: E731
    batch = _batch(cfg)

    plain = carried()
    _, grads_p = steps.make_grad_step(cfg)(plain, batch)
    loss_p, plain, _ = steps.make_train_step(cfg)(plain, adam_init(steps.TRAIN_ADAM, plain), batch)

    dp = sharding.distribute_params(cfg, mesh11, carried())
    _, grads_m = steps.make_grad_step(cfg, mesh11)(dp, sharding.distribute_batch(mesh11, batch))
    for key, g in flatten_with_paths(grads_p).items():
        err = float((flatten_with_paths(grads_m)[key].full_tensor() - g).abs().max())
        assert err <= 1e-5 * float(g.abs().max()), (key, err)
    loss_m, dp, state = steps.make_train_step(cfg, mesh11)(
        dp, adam_init(steps.TRAIN_ADAM, dp), sharding.distribute_batch(mesh11, batch))
    assert type(loss_m) is torch.Tensor                   # whole on every rank
    assert all(type(m).__name__ == "DTensor" for m in flatten_with_paths(state.m).values())

    jloss, jnew, _ = jax.jit(jax_steps.make_train_step(jcfg))(
        jp, jax_adam_init(jax_steps.TRAIN_ADAM, jp),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})

    assert abs(float(loss_m) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    assert abs(float(loss_m) - float(jloss)) <= 1e-5 * abs(float(jloss))
    got = {k: v.full_tensor() for k, v in flatten_with_paths(dp).items()}
    want = flatten_with_paths(plain)
    ref = flatten_with_paths(bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jnew), "cpu"))
    for other in (want, ref):
        diff = torch.cat([(got[k] - other[k]).abs().flatten() for k in other])
        assert float(diff.max()) <= steps.TRAIN_ADAM.lr


def test_two_by_two_gloo_mesh_matches_the_unsharded_port(tmp_path):
    """Four processes; each gradient leaf within 1e-4 of its scale, the
    loss within 1e-5, prefill and decode logits within 1e-4; the served
    tokens and $ costs equal."""
    names = [QWEN, MOE_NAME, XLSTM, "jamba-1.5-large-398b"]
    out = tmp_path / "mesh.npz"
    script = os.path.join(ROOT, "tests", "_torch_mesh_worker.py")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(tmp_path / "store"),
                               str(out), ",".join(names)], env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        results = [p.communicate(timeout=150) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 4, results[0][1][-3000:]
    got = np.load(out)
    want = {**worker.run(names), **worker.run_serve(names)}
    for key, w in want.items():
        g = got[key]
        if "/serve" in key:
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif "/grad/" in key:
            assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30), key
        elif key.endswith("/loss"):
            assert abs(float(g) - float(w)) <= 1e-5, key
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=key)


def _dryrun(tmp_path, *args):
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
                           "--out-dir", str(tmp_path), *args], env=ENV, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    return proc


def test_dryrun_flops_on_1x1_equal_the_real_step(mesh11, tmp_path):
    cfg = get_smoke_config(QWEN)
    proc = _dryrun(tmp_path, "--mesh", "1x1", "--arch", QWEN, "--shape", "train_4k",
                   "--batch", "4", "--seq", "16")
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((tmp_path / f"{QWEN}__train_4k__1x1.json").read_text())
    assert rec["status"] == "ok" and rec["collective_bytes_per_device"] == 0.0
    params = sharding.distribute_params(cfg, mesh11, lm.init_lm(torch.Generator().manual_seed(0), cfg))
    batch = sharding.distribute_batch(mesh11, _batch(cfg))
    with FlopCounterMode(display=False) as counter:
        steps.make_train_step(cfg, mesh11)(params, adam_init(steps.TRAIN_ADAM, params), batch)
    assert rec["flops"] == counter.get_total_flops() > 0
    # Params + two moments of fp32 at least are live at the start.
    n_params = sum(t.numel() for t in flatten_with_paths(params).values())
    assert rec["argument_bytes_per_device"] >= 12 * n_params
    assert rec["peak_bytes_per_device"] > rec["argument_bytes_per_device"]


def test_train_loop_on_a_1x1_mesh_replays_the_unsharded_losses(mesh11, tmp_path):
    cfg = get_smoke_config(QWEN)
    kw = dict(steps=3, batch=4, seq=16, seed=0, log_every=10, device="cpu")
    _, plain = train.train_loop(cfg, **kw)
    params, meshed = train.train_loop(cfg, mesh=mesh11,
                                      checkpoint_path=str(tmp_path / "lm.npz"), **kw)
    np.testing.assert_allclose(meshed, plain, rtol=1e-6)
    assert (tmp_path / "lm.npz").exists()
    assert all(type(t).__name__ == "DTensor" for t in flatten_with_paths(params).values())
