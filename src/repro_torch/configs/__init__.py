"""Architecture registry of the port.

``get_config(name)`` returns the full published config; ``get_smoke_config``
the reduced same-family variant the CPU tests use. Ported so far: the
reference's default serve pool (qwen3-0.6b, granite-3-8b and the
mixture-of-experts granite-moe-1b-a400m), qwen1.5-4b (QKV bias),
gemma3-27b (sliding-window locals), xlstm-1.3b (sLSTM and mLSTM) and
the jamba hybrid (Mamba, attention and MoE). The reference's other three
architectures wait in ROADMAP.md's Queue 1 (item 6) and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

ARCH_IDS: List[str] = ["qwen3-0.6b", "granite-moe-1b-a400m", "granite-3-8b",
                       "qwen1.5-4b", "gemma3-27b", "xlstm-1.3b",
                       "jamba-1.5-large-398b"]

_MODULES: Dict[str, str] = {
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "granite-3-8b": "granite_3_8b",
    "qwen1.5-4b": "qwen1_5_4b",
    "gemma3-27b": "gemma3_27b",
    "xlstm-1.3b": "xlstm_1_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def _module(name: str):
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP.md Queue 1, item 6); "
            f"ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke_config()
