"""Cost-model facade for the harness — the "napkin math first" profile.

The H100 model constants and shared helpers live in
:mod:`repro_torch.core.costs`; the per-family estimators live with their
families in :mod:`repro_torch.core.families` (the registry's ``cost``
hook).  This module is the harness-facing entry point
``estimate(family, cfg, prob)``.
"""
from __future__ import annotations

from ..costs import CostEstimate
from ..families import get_family

__all__ = ["estimate", "CostEstimate"]


def estimate(family: str, cfg, prob) -> CostEstimate:
    """Registry dispatch: the family's own cost hook."""
    return get_family(family).cost(cfg, prob)
