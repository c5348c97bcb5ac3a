"""Model facade: ``build(cfg)`` returns the family's LM object — the port
of the JAX package's ``models/model.py``.  Slice 1 builds the dense
family only."""
from __future__ import annotations

from .config import ModelConfig
from .transformer import TransformerLM

_PENDING = {
    "moe": "A6 (MoE router and grouped FFN)",
    "vlm": "A6",
    "hybrid": "A8 (hybrid, recurrent, encoder-decoder and SSM families)",
    "ssm": "A8",
    "encdec": "A8",
    "audio": "A8",
}


def build(cfg: ModelConfig) -> TransformerLM:
    if cfg.family == "dense":
        return TransformerLM(cfg)
    if cfg.family in _PENDING:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet: ROADMAP, port "
            f"item {_PENDING[cfg.family]}")
    raise ValueError(f"unknown model family {cfg.family!r}")
