"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks, 1:7 interleave (xLSTM[7:1]).

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517].
d_ff=0: blocks own their projections (mLSTM: up-projection x2; sLSTM: a
gated post-FFN). The decode cache is a recurrent state, not a KV cache.

The port's copy of the reference's config, field for field.
"""
import dataclasses

from repro_torch.configs.base import MLSTM, NONE, SLSTM, ArchConfig, LayerSpec

_PATTERN = (LayerSpec(mixer=SLSTM, ffn=NONE),) + tuple(
    LayerSpec(mixer=MLSTM, ffn=NONE) for _ in range(7)
)

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    source="arXiv:2405.04517",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm_expand=2,
    pattern=_PATTERN,
    n_repeats=6,
    supports_long_context=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        vocab_size=512,
        pattern=(LayerSpec(mixer=SLSTM, ffn=NONE), LayerSpec(mixer=MLSTM, ffn=NONE)),
        n_repeats=1,
    )
