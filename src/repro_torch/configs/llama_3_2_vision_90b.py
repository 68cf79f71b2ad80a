"""llama-3.2-vision-90b [vlm]: cross-attention image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision family]: 80 self-attention decoder
layers + 20 interleaved cross-attention layers (1 per 4 self layers).

The ViT vision encoder is the carve-out stub: media arrive as precomputed
patch embeddings (n_frontend_tokens x frontend_dim; a served member gets a
seeded stub from ``launch/serve.py::build_pool``); the learned projector +
cross-attention layers that consume them are real.

The port's copy of the reference's config, field for field.
"""
import dataclasses

from repro_torch.configs.base import ATTN, MLP, XATTN, ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    n_frontend_tokens=1601,        # 1 tile x (40x40 patches + 1 cls)
    frontend_dim=1280,             # ViT-H width
    pattern=(LayerSpec(mixer=ATTN, ffn=MLP),) * 4
    + (LayerSpec(mixer=XATTN, ffn=MLP),),
    n_repeats=20,
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
        n_frontend_tokens=16,
        frontend_dim=64,
        pattern=(LayerSpec(mixer=ATTN), LayerSpec(mixer=XATTN)),
        n_repeats=1,
    )
