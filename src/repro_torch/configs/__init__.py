"""Architecture config registry of the port.

``get_config(name)`` / ``get_reduced(name)`` return ModelConfigs, as in
the JAX package's ``repro.configs``.  Slice 1 carries only the dense
``qwen3-1.7b`` entry; the other nine architectures wait for the port of
their model families (ROADMAP, port item A8).
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
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
