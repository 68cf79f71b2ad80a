"""jamba-1.5-large-398b [hybrid]: Mamba + attention 1:7, MoE every other layer.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
[arXiv:2403.19887]. Jamba block = 8 layers with attention at index 3 and MoE
on every odd layer; 72 = 9 x 8. Mamba layers decode from a recurrent state.

The port's copy of the reference's config, field for field.
"""
import dataclasses

from repro_torch.configs.base import ATTN, MAMBA, MLP, MOE, ArchConfig, LayerSpec


def _jamba_pattern(n_per_block: int = 8, attn_idx: int = 3):
    specs = []
    for i in range(n_per_block):
        mixer = ATTN if i == attn_idx else MAMBA
        ffn = MOE if i % 2 == 1 else MLP
        specs.append(LayerSpec(mixer=mixer, ffn=ffn))
    return tuple(specs)


CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    d_ff_expert=24576,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    pattern=_jamba_pattern(),
    n_repeats=9,
    supports_long_context=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=4,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        d_ff_expert=512,
        vocab_size=512,
        n_experts=4,
        top_k=2,
        pattern=_jamba_pattern(n_per_block=4, attn_idx=1),
        n_repeats=1,
    )
