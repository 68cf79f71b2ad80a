"""Where the port runs: CUDA unless the caller names another device."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card; with no card present that raises rather
    than quietly running on the CPU. Pass ``device="cpu"`` to ask for the
    CPU (the parity tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
