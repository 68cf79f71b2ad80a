"""Architecture registry of the port.

``get_config(name)`` returns the full published config; ``get_smoke_config``
the reduced same-family variant the CPU tests use. Only the dense
attention members are ported so far; the reference's other eight
architectures wait in ROADMAP.md's Queue 1 (item 6) and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

ARCH_IDS: List[str] = ["qwen3-0.6b", "granite-3-8b"]

_MODULES: Dict[str, str] = {
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-3-8b": "granite_3_8b",
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
