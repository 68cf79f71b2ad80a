"""Assigned input shapes and meta-tensor input specs for the dry-run.

The port of ``repro.configs.shapes``. Shapes (assigned):
    train_4k     seq_len=4096    global_batch=256   (training)
    prefill_32k  seq_len=32768   global_batch=32    (inference prefill)
    decode_32k   seq_len=32768   global_batch=128   (inference decode: ONE new
                                                     token + seq_len KV cache)
    long_500k    seq_len=524288  global_batch=1     (long-context decode;
                                                     sub-quadratic archs only)

``input_specs(cfg, shape)`` returns meta tensors for every model input,
allocating nothing; decode shapes include the abstract cache list.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm as lm_mod


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}

SHAPE_IDS = list(SHAPES)


def shape_applicable(cfg: ArchConfig, shape: ShapeCfg) -> bool:
    """long_500k only runs on sub-quadratic archs."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


def input_specs(cfg: ArchConfig, shape: ShapeCfg, cache_dtype: torch.dtype = torch.float32,
                batch_override: Optional[int] = None) -> Dict:
    """Meta inputs for (architecture x shape). Keys match the step fns;
    a decode ``pos`` is the int ``seq_len - 1``, the last slot of the
    cache (the port's decode takes one position for the batch). Media
    and caches are float32, as the port's models compute (the
    reference's are bf16)."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    meta = dict(device="meta")
    media = None
    if cfg.arch_type == "vlm" and cfg.n_frontend_tokens:
        media = torch.empty((b, cfg.n_frontend_tokens, cfg.frontend_dim),
                            dtype=torch.float32, **meta)
    if shape.kind == "train":
        specs = {"tokens": torch.empty((b, s), dtype=torch.int32, **meta),
                 "labels": torch.empty((b, s), dtype=torch.int32, **meta)}
    elif shape.kind == "prefill":
        specs = {"tokens": torch.empty((b, s), dtype=torch.int32, **meta),
                 "caches": lm_mod.abstract_caches(cfg, b, s, cache_dtype)}
    else:  # decode: ONE new token against a seq_len cache.
        return {"token": torch.empty((b, 1), dtype=torch.int32, **meta),
                "caches": lm_mod.abstract_caches(cfg, b, s, cache_dtype),
                "pos": s - 1}
    if media is not None:
        specs["media"] = media
    return specs
