"""Kernel-family registry of the port: one module per family,
self-registering.

``from repro_torch.core.families import get_family`` is the single
dispatch point of the validator, planner, lowering agent and cost model.
The port registers the families whose kernels it has ported (``gemm``,
``flash_attention``, ``flash_decode``, ``moe``, ``ssd``, ``quant_gemm``,
``paged_attention``, ``ragged_prefill``: all eight), in the JAX
package's order; ``get_family`` of any other raises.
"""
from .base import (GENERIC_SKILLS, MATCH_EXACT, MATCH_NONE, MATCH_STAGE,
                   BugSignature, KernelFamily, Skill,
                   all_families, assertion_key, family_for_config,
                   family_names, generic_skill, get_family, register)

# importing a family module registers it (order fixes registry iteration
# order)
from . import gemm              # noqa: E402,F401
from . import flash_attention   # noqa: E402,F401
from . import flash_decode      # noqa: E402,F401
from . import moe               # noqa: E402,F401
from . import ssd               # noqa: E402,F401
from . import quant_gemm        # noqa: E402,F401
from . import paged_attention   # noqa: E402,F401
from . import ragged_prefill    # noqa: E402,F401

__all__ = [
    "KernelFamily", "Skill", "GENERIC_SKILLS", "generic_skill",
    "register", "get_family", "family_names", "all_families",
    "family_for_config", "BugSignature", "assertion_key",
    "MATCH_EXACT", "MATCH_STAGE", "MATCH_NONE",
]
