"""One rank of the 2x2 gloo mesh that ``tests/test_torch_mesh.py`` starts.

    python tests/_torch_mesh_worker.py RANK STORE OUT NAMES

Four processes join a gloo group over a ``FileStore`` at STORE, build
``make_debug_mesh(2, 2, device="cpu")`` and, for each smoke config in
NAMES (comma-separated), take the loss and every gradient of
``make_grad_step`` on the mesh, the prefill logits and two decode steps'
logits, from the params ``init_lm`` makes under seed 0 and a batch drawn
from numpy seed 1; then each config's smoke pool member, built by
``serve.build_pool`` and laid out by ``shard_pool(..., mesh=...)``,
serves ragged left-padded prompts through ``generate_member`` (tokens
and $ costs). Rank 0 writes them, gathered, to the npz OUT. The module
imports no JAX.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.tree import flatten_with_paths
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.shard import shard_pool
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve, sharding, steps
from repro_torch.models import lm
from repro_torch.serving.engine import RoutedEngine

B, S = 4, 16
PROMPT_LENS, MAX_NEW = (5, 16, 9, 12), 4


def batch_tokens(cfg) -> torch.Tensor:
    """(B, S + 1) int32 tokens: the inputs and, shifted, the labels."""
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32))


def run(names, mesh=None):
    """{key: array} for ``names`` on ``mesh`` (None: the unsharded port)."""
    res = {}
    place = (lambda b: b) if mesh is None else (lambda b: sharding.distribute_batch(mesh, b))
    for name in names:
        cfg = get_smoke_config(name)
        params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
        caches = lm.init_caches(cfg, B, S + 4, "cpu")
        if mesh is not None:
            params = sharding.distribute_params(cfg, mesh, params)
            caches = sharding.distribute_caches(cfg, mesh, caches)
        tok = batch_tokens(cfg)
        loss, grads = steps.make_grad_step(cfg, mesh)(
            params, place({"tokens": tok[:, :S], "labels": tok[:, 1:]}))
        res[f"{name}/loss"] = loss.numpy()
        for key, g in flatten_with_paths(grads).items():
            res[f"{name}/grad/{key}"] = _whole(g)
        batch = {**place({"tokens": tok[:, :S]}), "caches": caches}
        logits, caches = steps.make_prefill_step(cfg, mesh)(params, batch)
        res[f"{name}/prefill"] = _whole(logits)
        token = place({"token": tok[:, S:]})["token"]
        for i in range(2):
            logits, caches = steps.make_decode_step(cfg, mesh)(
                params, {"token": token, "caches": caches, "pos": S + i})
            res[f"{name}/decode{i}"] = _whole(logits)
    return res


def serve_prompts(vocab: int):
    """Ragged prompts (numpy seed 2) for ``generate_member``: four rows,
    left-padded by the engine into one batch of B."""
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


def run_serve(names, mesh=None):
    """{key: array}: each config's tokens and $ costs from
    ``generate_member`` on its smoke pool member (seed 0), laid out on
    ``mesh`` by ``shard_pool`` (None: whole on the CPU). Every rank makes
    the same calls in the same order."""
    res = {}
    pool = serve.build_pool(names, seed=0, device="cpu", smoke=True)
    if mesh is not None:
        shard_pool(pool, 0, 1, mesh=mesh)
    engine = RoutedEngine(router=serve.init_router(len(pool), device="cpu"), pool=pool,
                          device="cpu")
    for mi, name in enumerate(names):
        outs, costs = engine.generate_member(mi, serve_prompts(pool[mi].cfg.vocab_size),
                                             max_new=MAX_NEW)
        res[f"{name}/serve"] = np.stack(outs)
        res[f"{name}/serve_cost"] = costs
    return res


def _whole(t: torch.Tensor) -> np.ndarray:
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()


def main(argv):
    rank, store, out, names = int(argv[0]), argv[1], argv[2], argv[3].split(",")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
    try:
        mesh = mesh_mod.make_debug_mesh(2, 2, device="cpu")
        res = {**run(names, mesh), **run_serve(names, mesh)}
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
