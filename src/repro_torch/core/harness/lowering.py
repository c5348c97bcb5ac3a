"""Lowering agent (paper §6): applies the selected transformation.

In this offline reproduction the rewrite itself is exact (config-space), but
intrusive rewrites in the paper are *fallible* — the LLM mis-lowers some
fraction of global restructurings, which is precisely what data-flow
invariants exist to catch.  The agent therefore carries a calibrated fault
model: each applied skill may inject a latent bug from the family's
injectable-bug list (declared by the family's registry entry, matching its
``build_program`` inject_bug menu), with a rate per Table-1 tier.

Repair is *feedback-driven* (paper §9.4): the agent matches the validator's
structured :class:`repro_torch.core.verify_engine.Feedback` — (stage, assertion
id, counterexample) — against the family's declared
:class:`repro_torch.core.families.BugSignature` ground truth to decide *which*
latent fault to fix.  An exact assertion hit narrows the candidate set to
the bugs whose own invariant fired and the fix lands with high probability;
a stage-only match narrows less; a bare unit-test failure leaves blind
trial-and-error over the whole menu.  The fault model is ON to measure
the targeted-repair gap, and OFF for production tuning (``chip_smoke.py``
runs the loop on the card with it off).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..families import (MATCH_EXACT, MATCH_NONE, MATCH_STAGE,
                        assertion_key, get_family)
from .planner import KernelState, Proposal

# fault rates by Table-1 tier: intrusive rewrites break more often
TIER_BUG_RATE = {"global": 0.35, "local": 0.10, "isa": 0.20}

# probability a fix attempt on the *right* bug lands, by evidence quality
# (paper §9.4): an exact counterexample names the faulty assertion; a
# stage-level match only narrows the search; a bare unit-test failure says
# nothing about where the fault lives.
P_FIX = {MATCH_EXACT: 0.9, MATCH_STAGE: 0.65, MATCH_NONE: 0.4}

# a failed blind fix pokes at random code and may mutate the latent fault
BLIND_MUTATE_P = 0.25


@dataclass
class LoweredState:
    state: KernelState
    latent_bug: Optional[str] = None    # unknown to the agent until caught
    applied: str = ""


@dataclass
class RepairAttempt:
    """One repair round, stage-attributed for the ICRL lessons and the
    fig_repair benchmark.  ``specificity`` is the best
    :class:`repro_torch.core.families.BugSignature` match level the feedback
    supported; ``candidates`` the bugs at that level; ``picked`` the one
    the agent chose to fix; ``fixed`` whether the latent bug is gone."""

    stage: str = ""            # stage of the evidence used ("" = blind)
    assertion: str = ""        # stable assertion key of the matched finding
    specificity: int = MATCH_NONE
    candidates: List[str] = field(default_factory=list)
    picked: Optional[str] = None
    fixed: bool = False

    @property
    def targeted(self) -> bool:
        return self.specificity > MATCH_NONE


class LoweringAgent:
    def __init__(self, *, fault_model: bool = False, seed: int = 0):
        self.fault_model = fault_model
        self.rng = random.Random(seed)

    def apply(self, state: KernelState, prop: Proposal) -> LoweredState:
        new_state = KernelState(state.family, prop.new_cfg, state.prob)
        new_state.refresh()
        bug = None
        if self.fault_model:
            rate = TIER_BUG_RATE.get(prop.skill.tier, 0.1)
            menu = self._compatible_bugs(new_state)
            if menu and self.rng.random() < rate:
                bug = self.rng.choice(menu)
        return LoweredState(new_state, bug,
                            applied=f"{prop.skill.name}[{prop.context}]")

    def repair(self, lowered: LoweredState, feedback: Sequence = ()
               ) -> Tuple[LoweredState, RepairAttempt]:
        """Fix attempt after a failure report.

        ``feedback`` is the validator's violation list (empty when only a
        unit test failed).  The agent scores every compatible bug's
        signature against the findings, fixes the best-matching candidate,
        and the fix lands with :data:`P_FIX` probability *for that evidence
        level* — provided the candidate actually is the latent bug.
        Mis-attributed or unlucky fixes leave the fault in place; failed
        blind pokes may even mutate it into a different bug."""
        menu = self._compatible_bugs(lowered.state)
        att = RepairAttempt()
        violations = [f for f in feedback if not f.ok]
        if violations and menu:
            sigs = {s.bug: s
                    for s in get_family(lowered.state.family).bug_signatures}
            scored = []                      # (specificity, evidence, bug)
            for bug in menu:
                sig = sigs.get(bug)
                if sig is None:
                    continue
                spec, ev = max(
                    ((sig.specificity(f.stage, f.assertion_id), f)
                     for f in violations),
                    key=lambda t: t[0])
                scored.append((spec, ev, bug))
            best = max((s for s, _, _ in scored), default=MATCH_NONE)
            if best > MATCH_NONE:
                cands = [(ev, bug) for s, ev, bug in scored if s == best]
                ev, picked = cands[self.rng.randrange(len(cands))]
                att.specificity = best
                att.stage = ev.stage
                att.assertion = assertion_key(ev.assertion_id)
                att.candidates = [b for _, b in cands]
                att.picked = picked
        if att.picked is None and menu:
            att.picked = self.rng.choice(menu)      # blind trial-and-error
        hit = att.picked is not None and att.picked == lowered.latent_bug
        if hit and self.rng.random() < P_FIX[att.specificity]:
            att.fixed = True
            return LoweredState(lowered.state, None, lowered.applied), att
        bug = lowered.latent_bug
        if not att.targeted and menu and self.rng.random() < BLIND_MUTATE_P:
            bug = self.rng.choice(menu)
        return LoweredState(lowered.state, bug, lowered.applied), att

    def _compatible_bugs(self, state: KernelState) -> List[str]:
        return get_family(state.family).bugs_for(state.cfg, state.prob)
