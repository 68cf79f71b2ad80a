"""Architecture configuration system (the port's copy of ``repro.configs.base``).

An :class:`ArchConfig` holds the exact published dimensions plus a
*periodic layer plan*: a base ``pattern`` of :class:`LayerSpec` blocks
repeated ``n_repeats`` times, followed by an optional ``remainder``. The
port runs the plan as a plain loop over layers.

:meth:`ArchConfig.param_count` counts as the reference does: the serving
engine's $ cost rates derive from it, so both packages must price every
member the same: the port copies the count term for term, also where it
differs from the reference's own init (ROADMAP.md Queue 3). Every
field of the reference is here, with its default.
"""
from __future__ import annotations

import dataclasses
import math
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

    # MoE options.
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0               # 0 -> d_ff
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # Mamba options.
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0               # 0 -> ceil(d_model / 16)

    # xLSTM options.
    xlstm_expand: int = 2              # mLSTM up-projection factor
    xlstm_ff_factor: float = 2.6667    # sLSTM post-FFN factor (~4/3 * 2)

    # Modality frontend stubs (cross attention's media).
    n_frontend_tokens: int = 0         # image patches / audio frames per item
    frontend_dim: int = 0              # raw embedding dim from the stub encoder

    # Eligibility: sub-quadratic decode for long_500k (configs/shapes.py).
    supports_long_context: bool = False

    # Layer plan.
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    n_repeats: int = 1
    remainder: Tuple[LayerSpec, ...] = ()

    # Max positions: a sanity bound only; caches size themselves from the
    # request.
    max_seq_len: int = 1 << 20

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

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, math.ceil(self.d_model / 16))

    @property
    def xlstm_d_inner(self) -> int:
        return self.xlstm_expand * self.d_model

    @property
    def xlstm_n_heads(self) -> int:
        # xLSTM-1.3B uses 4 heads; reduced smoke variants keep >=1.
        return max(1, min(self.n_kv_heads or 4, self.xlstm_expand * 2))

    def layer_plan(self) -> Tuple[LayerSpec, ...]:
        """The full, flat sequence of layer specs (pattern*n + remainder)."""
        return tuple(self.pattern) * self.n_repeats + tuple(self.remainder)

    def has_mixer(self, kind: str) -> bool:
        return any(s.mixer == kind for s in self.layer_plan())

    def has_ffn(self, kind: str) -> bool:
        return any(s.ffn == kind for s in self.layer_plan())

    @property
    def resolved_d_ff_expert(self) -> int:
        return self.d_ff_expert or self.d_ff

    # ---- parameter count (for the cost model) -------------------------------

    def param_count(self) -> int:
        """Analytic parameter count of the full model, the reference's term
        for term. Where it and the init differ, the count wins (the $ rates
        derive from it): the sLSTM FFN counts ``int(2·d·d·ff_factor)``, not
        the init's width rounded up to 256; the mLSTM term leaves out the
        conv, skip and gate biases; an FFN-less block still counts ``2·d``
        of norms; a cross-attention block counts its projector
        ``frontend_dim·d`` but not the projector's norm."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.padded_vocab * d          # embedding table
        total += self.padded_vocab * d         # separate lm head
        for spec in self.layer_plan():
            total += 2 * d                     # pre-mixer + pre-ffn norms
            if spec.mixer in (ATTN, XATTN):
                total += d * self.n_heads * hd     # q
                total += 2 * d * self.n_kv_heads * hd  # k, v
                total += self.n_heads * hd * d     # o
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
                if spec.mixer == XATTN and self.frontend_dim:
                    total += self.frontend_dim * d  # modality projector
            elif spec.mixer == MAMBA:
                di, ds, dtr = self.ssm_d_inner, self.ssm_d_state, self.resolved_dt_rank
                total += d * 2 * di            # in_proj (x, z)
                total += di * self.ssm_d_conv  # depthwise conv
                total += di * (dtr + 2 * ds)   # x_proj
                total += dtr * di + di         # dt_proj, dt_bias
                total += di * ds + di          # A_log, D
                total += di * d                # out_proj
            elif spec.mixer == MLSTM:
                di, nh = self.xlstm_d_inner, self.xlstm_n_heads
                total += d * 2 * di            # up projection (x, z)
                total += 3 * di * (di // nh)   # block-diagonal q, k, v
                total += 2 * di * nh           # i, f gate projections
                total += di * d                # down projection
            elif spec.mixer == SLSTM:
                nh = self.xlstm_n_heads
                hd_s = d // nh
                total += 4 * d * d             # W_{z,i,f,o}
                total += 4 * nh * hd_s * hd_s  # block-diagonal recurrent R
                total += 4 * d                 # biases
                total += int(2 * d * d * self.xlstm_ff_factor)  # gated FFN
            if spec.ffn == MLP and self.d_ff:
                total += 3 * d * self.d_ff     # gate, up, down (SwiGLU)
            elif spec.ffn == MOE:
                e, fe = self.n_experts, self.resolved_d_ff_expert
                total += d * e                 # router
                total += e * 3 * d * fe        # experts
                total += self.n_shared_experts * 3 * d * fe
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token: an MoE layer touches its top-k
        experts, not all E."""
        total = self.param_count()
        n_moe = sum(1 for s in self.layer_plan() if s.ffn == MOE)
        total -= n_moe * (self.n_experts - self.top_k) * 3 * self.d_model \
            * self.resolved_d_ff_expert
        return int(total)
