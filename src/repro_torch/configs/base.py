"""Architecture configuration system (the port's copy of ``repro.configs.base``).

An :class:`ArchConfig` holds the exact published dimensions plus a
*periodic layer plan*: a base ``pattern`` of :class:`LayerSpec` blocks
repeated ``n_repeats`` times, followed by an optional ``remainder``. The
port runs the plan as a plain loop over layers.

:meth:`ArchConfig.param_count` counts as the reference does: the serving
engine's $ cost rates derive from it, so both packages must price every
member the same. Only the fields the dense attention members use are
here; the MoE, SSM, xLSTM and modality fields come with their mixers.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Mixer kinds.
ATTN = "attn"          # causal self attention (full or sliding window)
XATTN = "xattn"        # cross attention to (stubbed) modality embeddings
MAMBA = "mamba"        # selective SSM (Mamba-1)
MLSTM = "mlstm"        # xLSTM matrix-memory LSTM (linear attention family)
SLSTM = "slstm"        # xLSTM scalar-memory LSTM (strictly recurrent)

# FFN kinds.
MLP = "mlp"
MOE = "moe"
NONE = "none"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One block of the plan: a sequence mixer followed by an optional FFN."""

    mixer: str = ATTN
    ffn: str = MLP
    window: int = 0          # >0: sliding-window self attention (ring KV cache)

    def __post_init__(self):
        if self.mixer not in (ATTN, XATTN, MAMBA, MLSTM, SLSTM):
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in (MLP, MOE, NONE):
            raise ValueError(f"unknown ffn {self.ffn!r}")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    source: str                        # citation from the assignment table

    # Core transformer dims (published values — do not change).
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                  # 0 -> d_model // n_heads

    # Attention options.
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0

    # Layer plan.
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    n_repeats: int = 1
    remainder: Tuple[LayerSpec, ...] = ()

    # Norm epsilon.
    norm_eps: float = 1e-6

    def __post_init__(self):
        planned = len(self.pattern) * self.n_repeats + len(self.remainder)
        if self.n_layers and planned != self.n_layers:
            raise ValueError(
                f"{self.name}: layer plan covers {planned} layers, "
                f"config says {self.n_layers}"
            )

    # ---- derived quantities -------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's layout)."""
        return round_up(self.vocab_size, 256)

    def layer_plan(self) -> Tuple[LayerSpec, ...]:
        """The full, flat sequence of layer specs (pattern*n + remainder)."""
        return tuple(self.pattern) * self.n_repeats + tuple(self.remainder)

    # ---- parameter count (for the cost model) -------------------------------

    def param_count(self) -> int:
        """Analytic parameter count of the full model (attention + MLP plans;
        the reference's other mixer and FFN families are not ported yet)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.padded_vocab * d          # embedding table
        total += self.padded_vocab * d         # separate lm head
        for spec in self.layer_plan():
            if spec.mixer != ATTN or spec.ffn != MLP:
                raise NotImplementedError(
                    f"{self.name}: {spec.mixer}+{spec.ffn} blocks are not ported "
                    "yet (ROADMAP.md Queue 1, item 6)")
            total += 2 * d                     # pre-mixer + pre-ffn norms
            total += d * self.n_heads * hd     # q
            total += 2 * d * self.n_kv_heads * hd  # k, v
            total += self.n_heads * hd * d     # o
            if self.qkv_bias:
                total += (self.n_heads + 2 * self.n_kv_heads) * hd
            total += 3 * d * self.d_ff         # gate, up, down (SwiGLU)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token: all of them for a dense model."""
        return self.param_count()
