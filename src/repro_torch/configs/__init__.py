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
# the port's own configurations, which the JAX package does not have:
# ``get_config`` resolves them, ``ARCH_IDS`` stays the set both share
PORT_ONLY = {"granite-4.0-h-small": "granite_4_0_h_small"}


def get_config(arch_id: str) -> ArchConfig:
    name = _MODULES.get(arch_id, PORT_ONLY.get(arch_id))
    if name is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES) + sorted(PORT_ONLY)}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {aid: get_config(aid) for aid in ARCH_IDS}
