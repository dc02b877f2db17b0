"""Architecture registry: the 10 assigned configs (+ reduced variants).

``get(name)`` returns the full published config; ``get_smoke(name)``
returns a reduced same-family config for CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHITECTURES = (
    "jamba_1_5_large_398b",
    "qwen2_moe_a2_7b",
    "granite_moe_3b_a800m",
    "rwkv6_1_6b",
    "llama3_8b",
    "gemma2_9b",
    "granite_3_2b",
    "starcoder2_3b",
    "pixtral_12b",
    "hubert_xlarge",
)

# CLI aliases (--arch accepts either form)
ALIASES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "llama3-8b": "llama3_8b",
    "gemma2-9b": "gemma2_9b",
    "granite-3-2b": "granite_3_2b",
    "starcoder2-3b": "starcoder2_3b",
    "pixtral-12b": "pixtral_12b",
    "hubert-xlarge": "hubert_xlarge",
}


def canonical(name: str) -> str:
    name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHITECTURES}")
    return name


def get(name: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    cfg = mod.CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke(name: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    cfg = mod.SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def all_configs():
    return {n: get(n) for n in ARCHITECTURES}
