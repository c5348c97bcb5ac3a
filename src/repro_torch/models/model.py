"""Model facade: ``build(cfg)`` returns the family's LM object — the port
of the JAX package's ``models/model.py``.  The dense and MoE families
are built (both as :class:`TransformerLM`, GQA attention only)."""
from __future__ import annotations

from .config import ModelConfig
from .transformer import TransformerLM

_PENDING = {
    "vlm": "A6",
    "hybrid": "A8 (hybrid, recurrent, encoder-decoder and SSM families)",
    "ssm": "A8",
    "encdec": "A8",
    "audio": "A8",
}


def build(cfg: ModelConfig) -> TransformerLM:
    if cfg.family in ("dense", "moe"):
        return TransformerLM(cfg)
    if cfg.family in _PENDING:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet: ROADMAP, port "
            f"item {_PENDING[cfg.family]}")
    raise ValueError(f"unknown model family {cfg.family!r}")
