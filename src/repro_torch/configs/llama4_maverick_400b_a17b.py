"""llama4-maverick-400b-a17b [moe]: 128 experts top-1 + shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E family]. MoE on every other layer
(interleave-moe-layer-step=2), each MoE layer adds a shared expert.
"early fusion" multimodality: the image tokenizer is the carve-out stub —
the backbone consumes fused text/image token ids directly.

The port's copy of the reference's config, field for field.
"""
import dataclasses

from repro_torch.configs.base import ATTN, MLP, MOE, ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    d_ff_expert=8192,
    n_shared_experts=1,
    rope_theta=500_000.0,
    pattern=(LayerSpec(mixer=ATTN, ffn=MLP), LayerSpec(mixer=ATTN, ffn=MOE)),
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
        head_dim=64,
        d_ff=512,
        d_ff_expert=512,
        vocab_size=512,
        n_experts=4,
        top_k=1,
        n_repeats=1,
    )
