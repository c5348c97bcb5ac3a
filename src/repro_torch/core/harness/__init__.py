"""The agentic optimization loop (paper §6, Algorithm 1) over the port's
family registry: knowledge base, planner, selector, lowering agent,
validator (which runs the family's CUDA kernel on the card when asked)
and the ICRL loop."""
from .costmodel import CostEstimate, estimate
from .icrl import (OptimizeCheckpoint, OptimizeResult, StepRecord,
                   export_lessons, icrl_train, import_lessons,
                   optimize_kernel)
from .knowledge import KNOWLEDGE_BASE, Skill, skills_for
from .lowering import LoweredState, LoweringAgent, RepairAttempt
from .planner import KernelState, Planner, PlannerParams
from .selector import Selector
from .validator import Validator

__all__ = ["estimate", "CostEstimate", "KNOWLEDGE_BASE", "Skill",
           "skills_for", "Planner", "PlannerParams", "KernelState",
           "Selector", "LoweringAgent", "LoweredState", "RepairAttempt",
           "Validator", "optimize_kernel", "icrl_train", "OptimizeResult",
           "OptimizeCheckpoint", "StepRecord", "export_lessons",
           "import_lessons"]
