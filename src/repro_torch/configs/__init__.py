"""Architecture registry: ``get_config("<arch-id>")`` and the input shapes.

The port's own copy of ``repro.configs`` (which it may not import): the
same dataclasses and the same ten architectures, field for field
(``tests/test_torch_transformer.py`` holds every one against JAX's).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (INPUT_SHAPES, SHAPES, InputShape,
                                      ModelConfig)

_ARCH_MODULES = {
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "granite-8b": "repro_torch.configs.granite_8b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)

_cache: Dict[str, ModelConfig] = {}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _cache:
        if arch_id not in _ARCH_MODULES:
            raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
        _cache[arch_id] = importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG
    return _cache[arch_id]


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def applicable_shapes(cfg: ModelConfig) -> List[InputShape]:
    """The input shapes this arch runs (long_500k only when sub-quadratic)."""
    out = []
    for s in INPUT_SHAPES:
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue  # skip noted in DESIGN.md §Arch-applicability
        out.append(s)
    return out


__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "SHAPES", "InputShape", "ModelConfig",
    "get_config", "get_shape", "applicable_shapes",
]
