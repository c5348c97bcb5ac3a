"""Architecture config registry of the port.

``get_config(name)`` / ``get_reduced(name)`` return ModelConfigs, as in
the JAX package's ``repro.configs``, for all ten of its architectures:
the dense ``qwen3-1.7b``, ``codeqwen1.5-7b`` (qkv bias), ``stablelm-3b``
(layernorm, partial rotary) and ``gemma-7b`` (GeGLU, head_dim 256,
scaled embedding), the VLM ``chameleon-34b``, the MoE
``granite-moe-3b-a800m`` and ``deepseek-v2-lite-16b`` (MLA), the SSM
``mamba2-780m``, the hybrid ``recurrentgemma-2b`` (RG-LRU and
sliding-window attention) and the encoder-decoder
``seamless-m4t-large-v2``.  ``arch_input_specs(name, shape)`` builds
the dry-run's ShapeDtype inputs from the shape cells of
:mod:`repro_torch.configs.shapes`, and ``all_cells()`` lists every
(arch, shape) pair with whether the dry-run runs it.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import ModelConfig

from .shapes import SHAPES, LONG_CONTEXT_ARCHS, ShapeCell, \
    input_specs as _input_specs, supports_cell

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mamba2-780m": "mamba2_780m",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "stablelm-3b": "stablelm_3b",
    "gemma-7b": "gemma_7b",
    "chameleon-34b": "chameleon_34b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_NAMES = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _mod(name).reduced()


def arch_input_specs(name: str, shape: str, *, reduced: bool = False):
    from repro_torch.models import build
    cfg = get_reduced(name) if reduced else get_config(name)
    return _input_specs(build(cfg), SHAPES[shape], frontend=cfg.frontend)


def all_cells():
    """Every (arch, shape) pair — 40 cells — with whether it runs (the
    long_500k rows only for the O(1)-state archs)."""
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            yield arch, shape, supports_cell(arch, shape)
