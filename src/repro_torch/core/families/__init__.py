"""Kernel-family registry of the port: one module per family,
self-registering.

``from repro_torch.core.families import get_family`` is the single
dispatch point of the validator, planner, lowering agent and cost model.
The port registers the families whose kernels it has ported (``gemm``);
``get_family`` of any other raises, naming the ROADMAP item.
"""
from .base import (GENERIC_SKILLS, MATCH_EXACT, MATCH_NONE, MATCH_STAGE,
                   NOT_PORTED, BugSignature, KernelFamily, Skill,
                   all_families, assertion_key, family_for_config,
                   family_names, generic_skill, get_family, register)

# importing a family module registers it (order fixes registry iteration
# order)
from . import gemm              # noqa: E402,F401

__all__ = [
    "KernelFamily", "Skill", "GENERIC_SKILLS", "generic_skill",
    "register", "get_family", "family_names", "all_families",
    "family_for_config", "BugSignature", "assertion_key",
    "MATCH_EXACT", "MATCH_STAGE", "MATCH_NONE", "NOT_PORTED",
]
