"""repro.configs — one module per assigned architecture + the shape set.

``get_config(arch_id)`` resolves by the assignment's arch id (dashes/dots);
``get_reduced(arch_id)`` returns the smoke-test configuration of the same
family.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_supported
from repro_torch.models.common import ArchConfig

__all__ = ["ARCHS", "get_config", "get_reduced", "SHAPES", "ShapeSpec",
           "cell_supported"]

# arch id -> module name
ARCHS = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-780m": "mamba2_780m",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-1.2b": "zamba2_1_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "gemma3-1b": "gemma3_1b",
    "minitron-4b": "minitron_4b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; options: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ArchConfig:
    return _module(arch).reduced()
