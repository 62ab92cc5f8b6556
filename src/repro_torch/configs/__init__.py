"""Assigned architecture configs (+ the paper's own DeepSeek-V3).

``get(name)`` returns the full published config; ``get_smoke(name)`` a
reduced same-family config for CPU tests. ``ALL_ARCHS`` lists the ten
assigned ids (dry-run set); ``deepseek-v3-671b`` is additionally available
as the paper's own model.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ArchConfig, ShapeSpec, SHAPES, shape_applicable

ALL_ARCHS: List[str] = [
    "smollm-360m",
    "gemma3-4b",
    "starcoder2-7b",
    "codeqwen1.5-7b",
    "jamba-1.5-large-398b",
    "xlstm-350m",
    "hubert-xlarge",
    "granite-moe-3b-a800m",
    "qwen3-moe-235b-a22b",
    "pixtral-12b",
]

EXTRA_ARCHS: List[str] = ["deepseek-v3-671b"]

_MODULES: Dict[str, str] = {
    "smollm-360m": "smollm_360m",
    "gemma3-4b": "gemma3_4b",
    "starcoder2-7b": "starcoder2_7b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "xlstm-350m": "xlstm_350m",
    "hubert-xlarge": "hubert_xlarge",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "pixtral-12b": "pixtral_12b",
    "deepseek-v3-671b": "deepseek_v3",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "shape_applicable",
           "ALL_ARCHS", "EXTRA_ARCHS", "get", "get_smoke"]
