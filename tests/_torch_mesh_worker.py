"""One rank of the 2x2 gloo mesh that ``tests/test_torch_mesh.py`` starts.

    python tests/_torch_mesh_worker.py RANK STORE OUT NAMES

Four processes join a gloo group over a ``FileStore`` at STORE, build
``make_debug_mesh(2, 2, device="cpu")`` and, for each smoke config in
NAMES (comma-separated), take the loss and every gradient of
``make_grad_step`` on the mesh, the prefill logits and two decode steps'
logits, from the params ``init_lm`` makes under seed 0 and a batch drawn
from numpy seed 1. Rank 0 writes them, gathered, to the npz OUT. The
module imports no JAX.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.tree import flatten_with_paths
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding, steps
from repro_torch.models import lm

B, S = 4, 16


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


def _whole(t: torch.Tensor) -> np.ndarray:
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()


def main(argv):
    rank, store, out, names = int(argv[0]), argv[1], argv[2], argv[3].split(",")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
    try:
        res = run(names, mesh_mod.make_debug_mesh(2, 2, device="cpu"))
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
