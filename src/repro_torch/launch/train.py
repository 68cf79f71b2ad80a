"""LM training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --smoke --steps 50 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 5 --batch 8 --seq 1024

The port of ``repro.launch.train``. ``--smoke`` uses the reduced per-arch
config; without it the published config is built, in fp32, on the CUDA
card (``--device cpu`` runs on the CPU). Each step is
:func:`~repro_torch.launch.steps.make_train_step`'s, which updates the
params and optimizer state in place. ``--checkpoint PATH`` writes the
trained params in the reference's stacked layout, which either package
loads.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.bridge import lm_params_to_jax
from repro_torch.checkpoint import save_checkpoint
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.lm_data import MarkovCorpus
from repro_torch.common.tree import tree_map
from repro_torch.launch.sharding import distribute_batch, distribute_params
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as lm_mod
from repro_torch.training.optim import AdamConfig, adam_init


def train_loop(
    cfg,
    *,
    steps: int,
    batch: int,
    seq: int,
    mesh=None,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 10,
    checkpoint_path: Optional[str] = None,
    media_fn: Optional[Callable[[int], torch.Tensor]] = None,
    var_len: bool = False,
    device: Optional[DeviceLike] = None,
):
    """Returns (params, list of losses).

    Params come from ``init_lm`` on a generator seeded ``seed`` on
    ``device`` (the CUDA card unless named); batches from
    :class:`MarkovCorpus` (seeded ``seed``) with stream seed ``seed + 1``,
    the reference's. ``var_len`` trains on variable-length left-padded
    batches (``padded_batches``): the pad mask goes to
    ``lm_loss(attn_mask=)``, so the cross entropy and the MoE capacity
    and aux see only real tokens. ``media_fn(i)`` gives step ``i``'s media
    for a config with cross-attention layers. One ``float(loss)`` per step
    syncs with the device, as in the reference.

    With a ``mesh`` (``launch/mesh.py``) the params are distributed under
    ``launch/sharding.py``'s rules (the moments mirror them) and so is
    each batch; the returned params are DTensors, and a checkpoint is
    written from their gathered values.
    """
    device = resolve_device(device)
    adam_cfg = AdamConfig(lr=lr, b1=0.9, b2=0.95, weight_decay=0.1, t_max=steps)
    step_fn = make_train_step(cfg, mesh, adam_cfg)
    params = lm_mod.init_lm(torch.Generator(device).manual_seed(seed), cfg)
    if mesh is not None:
        params = distribute_params(cfg, mesh, params)
    opt_state = adam_init(adam_cfg, params)       # moments placed as the params

    corpus = MarkovCorpus(cfg.vocab_size, seed=seed)
    if var_len:
        batches = corpus.padded_batches(batch, seq, seed=seed + 1)
    else:
        batches = corpus.batches(batch, seq, seed=seed + 1)
    losses: List[float] = []
    t0 = time.time()
    for i in range(steps):
        if var_len:
            tokens, labels, mask = next(batches)
        else:
            tokens, labels = next(batches)
            mask = None
        b = {"tokens": torch.from_numpy(tokens).to(device),
             "labels": torch.from_numpy(labels).to(device)}
        if mask is not None:
            b["attn_mask"] = torch.from_numpy(mask).to(device)
        if media_fn is not None:
            b["media"] = media_fn(i)
        if mesh is not None:
            b = distribute_batch(mesh, b)
        loss, params, opt_state = step_fn(params, opt_state, b)
        losses.append(float(loss))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if checkpoint_path:
        whole = params if mesh is None else tree_map(lambda t: t.full_tensor(), params)
        save_checkpoint(checkpoint_path, lm_params_to_jax(cfg, whole),
                        {"arch": cfg.name, "steps": steps})
        print(f"saved checkpoint to {checkpoint_path}")
    return params, losses


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--var-len", action="store_true",
                    help="variable-length left-padded batches with pad "
                         "masks (exercises masked CE + MoE accounting)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    media_fn = None
    if cfg.arch_type == "vlm" and cfg.n_frontend_tokens:
        # A torch generator seeded 7 where the reference takes jax.random.key(7):
        # the same distribution, other numbers.
        media = torch.randn((args.batch, cfg.n_frontend_tokens, cfg.frontend_dim),
                            generator=torch.Generator(device).manual_seed(7),
                            device=device)
        media_fn = lambda i: media  # noqa: E731
    _, losses = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, checkpoint_path=args.checkpoint, media_fn=media_fn,
        var_len=args.var_len, device=device,
    )
    print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
