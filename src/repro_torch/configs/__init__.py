"""Architecture registry of the port.

``get_config(name)`` returns the full published config; ``get_smoke_config``
the reduced same-family variant the CPU tests use. All ten of the
reference's architectures: its default serve pool (qwen3-0.6b,
granite-3-8b and the mixture-of-experts granite-moe-1b-a400m), qwen1.5-4b
(QKV bias), gemma3-27b (sliding-window locals), xlstm-1.3b (sLSTM and
mLSTM), the jamba hybrid (Mamba, attention and MoE), musicgen-large,
llama4-maverick (128 experts top-1 with a shared expert) and
llama-3.2-vision (cross attention to stub media). An unknown name raises
``KeyError``, as in the reference.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

ARCH_IDS: List[str] = ["qwen3-0.6b", "granite-moe-1b-a400m", "granite-3-8b",
                       "qwen1.5-4b", "gemma3-27b", "xlstm-1.3b",
                       "jamba-1.5-large-398b", "musicgen-large",
                       "llama4-maverick-400b-a17b", "llama-3.2-vision-90b"]

_MODULES: Dict[str, str] = {
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "granite-3-8b": "granite_3_8b",
    "qwen1.5-4b": "qwen1_5_4b",
    "gemma3-27b": "gemma3_27b",
    "xlstm-1.3b": "xlstm_1_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "musicgen-large": "musicgen_large",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke_config()
