"""gemma3-27b [dense]: 5:1 local:global attention, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3-1b-pt family]. Locals use a 1024-token sliding window
(ring KV cache), globals use full attention.
62 = 10 x (5 local + 1 global) + 2 local remainder.

The port's copy of the reference's config, field for field. As in the
reference, every layer takes ``rope_theta`` 1e6, the locals too (the
published model gives its locals a base of 1e4).
"""
import dataclasses

from repro_torch.configs.base import ATTN, MLP, ArchConfig, LayerSpec

LOCAL_WINDOW = 1024

_LOCAL = LayerSpec(mixer=ATTN, ffn=MLP, window=LOCAL_WINDOW)
_GLOBAL = LayerSpec(mixer=ATTN, ffn=MLP, window=0)

CONFIG = ArchConfig(
    name="gemma3-27b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    qk_norm=True,                     # gemma3 applies qk-norm
    rope_theta=1_000_000.0,           # global-layer rope base
    pattern=(_LOCAL,) * 5 + (_GLOBAL,),
    n_repeats=10,
    remainder=(_LOCAL, _LOCAL),
    supports_long_context=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=3,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        pattern=(
            dataclasses.replace(_LOCAL, window=8),
            dataclasses.replace(_LOCAL, window=8),
            _GLOBAL,
        ),
        n_repeats=1,
        remainder=(),
    )
