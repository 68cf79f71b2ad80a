"""qwen3-0.6b [dense]: qk_norm, GQA.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936 [hf:Qwen/Qwen3-8B family].
"""
import dataclasses

from repro_torch.configs.base import ATTN, MLP, ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    pattern=(LayerSpec(mixer=ATTN, ffn=MLP),),
    n_repeats=28,
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
        vocab_size=512,
        n_repeats=2,
    )
