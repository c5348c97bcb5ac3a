"""Architecture config registry of the port.

``get_config(name)`` / ``get_reduced(name)`` return ModelConfigs, as in
the JAX package's ``repro.configs``.  The port carries the dense
``qwen3-1.7b``, the MoE ``granite-moe-3b-a800m`` and the SSM
``mamba2-780m``; the other seven architectures wait for the port of
their model families (ROADMAP, port items A6 and A8).
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mamba2-780m": "mamba2_780m",
}

ARCH_NAMES = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port carries "
                       f"{ARCH_NAMES} so far")
    return import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _mod(name).reduced()
