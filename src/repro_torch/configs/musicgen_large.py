"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048 [arXiv:2306.05284].
The EnCodec audio codec (mel/conv frontend) is the carve-out stub: the
language backbone consumes codec *token ids* directly: int32 codebook
tokens of the published vocab.

The port's copy of the reference's config, field for field.
"""
import dataclasses

from repro_torch.configs.base import ATTN, MLP, ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="musicgen-large",
    arch_type="audio",
    source="arXiv:2306.05284",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pattern=(LayerSpec(mixer=ATTN, ffn=MLP),),
    n_repeats=48,
    supports_long_context=False,   # pure full attention
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
