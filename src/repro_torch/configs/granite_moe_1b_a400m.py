"""granite-moe-1b-a400m [moe]: 32 experts, top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]. d_ff=512 is the per-expert FF.
"""
import dataclasses

from repro_torch.configs.base import ATTN, MOE, ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    top_k=8,
    d_ff_expert=512,
    pattern=(LayerSpec(mixer=ATTN, ffn=MOE),),
    n_repeats=24,
    supports_long_context=False,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        d_ff_expert=128,
        vocab_size=512,
        n_experts=4,
        top_k=2,
        n_repeats=2,
    )
