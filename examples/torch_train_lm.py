"""End-to-end example on the PyTorch port: train a ~100M-parameter dense LM
for a few hundred steps on the synthetic Markov corpus, then greedy-decode
from it.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

The port of ``examples/train_lm.py``: the qwen3 family at ~100M scale
(12L, d_model=512), Adam + cosine schedule, remat, and the checkpoint
layer, on the CUDA card unless ``--device`` names another device (with no
card and no ``--device`` it raises). Loss must drop well below uniform
(ln 4096 ~ 8.3) into the corpus' structural entropy.
"""
import argparse
import dataclasses
import math
import sys

import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN, MLP, LayerSpec
from repro_torch.launch.train import train_loop
from repro_torch.models import lm as lm_mod


def lm_100m(n_layers: int = 12):
    base = get_config("qwen3-0.6b")
    return dataclasses.replace(
        base,
        name="qwen3-100m-example",
        n_layers=n_layers,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        head_dim=64,
        d_ff=1536,
        vocab_size=4096,
        pattern=(LayerSpec(mixer=ATTN, ffn=MLP),),
        n_repeats=n_layers,
    )


def main(argv=None, *, n_layers: int = 12) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # Defaults as the reference's, sized for a 1-core CPU container
    # (~2-4 s/step there); raise them freely on the card.
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint", default="reports/lm100m.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = lm_100m(n_layers)
    n_params = cfg.param_count()
    print(f"training {cfg.name} on {device}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens")
    params, losses = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=6e-4, checkpoint_path=args.checkpoint, log_every=25, device=device,
    )
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(uniform would be {math.log(cfg.vocab_size):.3f})")

    prompt = torch.zeros((1, 8), dtype=torch.int32, device=device)
    out = lm_mod.greedy_generate(cfg, params, prompt, max_new=16)
    print("greedy sample:", out[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
