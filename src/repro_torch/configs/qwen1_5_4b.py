"""qwen1.5-4b [dense]: QKV bias.

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936 [hf:Qwen/Qwen1.5-0.5B].
"""
import dataclasses

from repro_torch.configs.base import ATTN, MLP, ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
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
        n_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        n_repeats=2,
    )
