"""Learnable planner (paper §6): binds KB skills to the current kernel.

The planner is a *policy* over (skill, context) proposals.  Its scoring is
the paper's "napkin math first" discipline: for every enumerable context it
predicts the cost-model delta, then adds a learned per-skill bias θ (the
ICRL-updated "prompt parameters").  Offline this policy is deterministic
arithmetic; an ``LLMPolicy`` adapter can replace `score_extra` online —
the ICRL loop (icrl.py) is agnostic (DESIGN.md §2d).

Proposals are the paper's triple (optimization, context, score); each also
carries the invariant templates that must hold after the rewrite (the
family verify_* call re-instantiates them concretely).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..families import get_family
from . import costmodel
from .knowledge import Skill


@dataclass
class Proposal:
    skill: Skill
    context: str
    new_cfg: object
    score: float
    predicted_s: float
    note: str = ""


@dataclass
class KernelState:
    family: str
    cfg: object
    prob: object
    est: costmodel.CostEstimate = None   # filled by the validator

    def refresh(self):
        self.est = costmodel.estimate(self.family, self.cfg, self.prob)
        return self


# score penalty scale for skills that repeatedly trip the same assertion
STRIKE_PENALTY = 0.15


@dataclass
class PlannerParams:
    """θ — the mutable policy parameters the ICRL loop updates."""

    skill_bias: Dict[str, float] = field(default_factory=dict)
    lessons: List[str] = field(default_factory=list)   # textual trace
    # skill -> stable assertion key -> violation count, recorded by
    # icrl.parameter_update from the verdicts' stage-attributed feedback
    assertion_strikes: Dict[str, Dict[str, int]] = field(
        default_factory=dict)

    def bias(self, skill: str) -> float:
        return self.skill_bias.get(skill, 0.0)

    def strike(self, skill: str, assertion: str) -> None:
        per = self.assertion_strikes.setdefault(skill, {})
        per[assertion] = per.get(assertion, 0) + 1

    def strike_penalty(self, skill: str) -> float:
        """Down-weight proposals from skills whose rewrites keep tripping
        the *same* invariant: scattered one-off violations are noise, a
        repeat offender on one assertion is a systematic mis-lowering."""
        per = self.assertion_strikes.get(skill)
        if not per:
            return 0.0
        return STRIKE_PENALTY * math.log1p(max(per.values()) - 1)


class Planner:
    def __init__(self, params: Optional[PlannerParams] = None):
        self.params = params or PlannerParams()

    def propose(self, state: KernelState, top: int = 12) -> List[Proposal]:
        if state.est is None:
            state.refresh()
        base = state.est.time_s
        out: List[Proposal] = []
        for skill in get_family(state.family).skills:
            for label, new_cfg in skill.contexts(state.cfg, state.prob):
                try:
                    est = costmodel.estimate(state.family, new_cfg,
                                             state.prob)
                except Exception:
                    continue
                speedup = base / est.time_s if est.time_s > 0 else 0.0
                score = math.log(max(speedup, 1e-6)) \
                    + self.params.bias(skill.name) \
                    - self.params.strike_penalty(skill.name)
                out.append(Proposal(skill, label, new_cfg, score,
                                    est.time_s,
                                    note=f"bound={est.bound}"))
        out.sort(key=lambda p: -p.score)
        return out[:top]
