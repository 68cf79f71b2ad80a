"""granite-3-8b [dense]: GQA.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base family].
"""
import dataclasses

from repro_torch.configs.base import ATTN, MLP, ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-3-8b",
    arch_type="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    pattern=(LayerSpec(mixer=ATTN, ffn=MLP),),
    n_repeats=40,
    supports_long_context=False,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        n_repeats=2,
    )
