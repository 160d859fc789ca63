"""Architecture registry: ``--arch <id>`` resolution for every launcher."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig, SHAPES, ShapeConfig, \
    shape_applicable  # noqa: F401

_MODULES = {
    "hymba-1.5b": "hymba_1_5b",
    "gemma3-1b": "gemma3_1b",
    "mistral-large-123b": "mistral_large_123b",
    "minicpm-2b": "minicpm_2b",
    "gemma-2b": "gemma_2b",
    "whisper-tiny": "whisper_tiny",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-780m": "mamba2_780m",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {aid: get_config(aid) for aid in ARCH_IDS}
