"""Mixed-precision policy, with torch dtypes.

The port of ``repro.common.dtypes``. A bf16 policy keeps parameters and
activations in bf16 with fp32 softmax/normalizer accumulations and fp32
optimizer moments. The default policy runs everything in fp32, as the
port's models and its parity tests do.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    # Accumulations (softmax denominators, scan carries, losses) always fp32.
    accum_dtype: torch.dtype = torch.float32

    def cast_param(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.param_dtype)

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


# Full fp32.
DEFAULT_POLICY = DTypePolicy()

# bf16 params + compute, fp32 accumulations.
BF16_POLICY = DTypePolicy(
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, accum_dtype=torch.float32
)
