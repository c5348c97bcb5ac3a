"""Validator agent (paper §6): compile-time invariant validation, unit
tests of the family's kernel against its plain version, and the
cost-model profile — fused into the reward signal for the ICRL loop.

Verification goes through the staged, caching
:class:`repro_torch.core.verify_engine.VerificationEngine`: structural checks,
tag propagation, then memoized solver discharge.  The engine instance
lives for the whole optimization loop, so re-validating a repaired or
revisited config is a result-cache hit and validating a mutated config
only re-proves the assertions whose tag expressions changed.  Violations
come back as structured :class:`repro_torch.core.verify_engine.Feedback`
(stage, assertion id, counterexample, repair hint), which the lowering
agent uses for targeted repair.

Cost accounting mirrors the paper's token-budget measurements (§9.4): a
static invariant check is cheap (counterexamples arrive pre-compile); a
unit-test round is expensive (build + execute + diff).

With ``run_kernels=True`` the unit test is real: the family's
``reference_check`` runs its CUDA kernel on the validator's device (the
plain PyTorch version when that device is the CPU).  Only the config's
own precondition errors count as a failed test (``ValueError``, and the
gate's ``InvariantViolation``); an error building or launching the
kernel propagates, so a broken kernel cannot pass for a run of rejected
candidates.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from ..families import get_family
from ..verify_engine import Feedback, InvariantViolation, VerificationEngine
from .lowering import LoweredState
from .planner import KernelState

COST_STATIC = 1.0      # invariant validation (compile-time, no execution)
COST_UNIT_TEST = 8.0   # lower + run + compare round
UNIT_TEST_CATCH_P = 0.95


@dataclass
class Verdict:
    ok: bool
    caught_static: bool = False
    caught_unit: bool = False
    cost_units: float = 0.0
    reward: float = 0.0
    violation_report: str = ""
    est_time_s: float = 0.0
    feedback: List[Feedback] = field(default_factory=list)
    # which pipeline stage decided a failing verdict: "build" | "analysis"
    # | "solver" | "structural" | "unit" | "" (passing) — the key the
    # ICRL lessons and fig_repair aggregate on
    caught_stage: str = ""


# stage-attributed static-catch rewards: the earlier (cheaper) the stage
# that caught the fault, the milder the penalty — lattice-level analysis
# verdicts arrive before any counterexample search even starts
STATIC_CATCH_REWARD = {"build": -1.0, "analysis": -0.45, "solver": -0.55,
                       "structural": -0.5}


def _catch_stage(feedback: List[Feedback]) -> str:
    """The most decisive failing stage: build > analysis > solver (a ⊤
    poisoning the lattice also fails downstream solver assertions — the
    analysis finding is the root cause)."""
    stages = {f.stage for f in feedback if not f.ok}
    for stage in ("build", "analysis", "solver", "structural"):
        if stage in stages:
            return stage
    return ""


class Validator:
    """``device`` (default ``"cuda"``) is where ``run_kernels`` runs the
    family's kernel; it is resolved only when kernels are run, and then
    raises without a CUDA card unless it is ``"cpu"``.
    ``reference_runs`` counts the unit tests that ran to a verdict,
    ``reference_refusals`` those a precondition error refused."""

    def __init__(self, *, use_invariants: bool = True,
                 run_kernels: bool = False, rng=None,
                 engine: Optional[VerificationEngine] = None,
                 device="cuda"):
        self.use_invariants = use_invariants
        self.run_kernels = run_kernels
        self.engine = engine or VerificationEngine()
        self.device = None
        if run_kernels:
            from repro_torch.device import resolve_device
            self.device = resolve_device(device)
        self.reference_runs = 0
        self.reference_refusals = 0
        import random
        self.rng = rng or random.Random(1)

    def evaluate(self, lowered: LoweredState, incumbent_s: float) -> Verdict:
        state = lowered.state
        cost = 0.0

        if self.use_invariants:
            cost += COST_STATIC
            res = self.engine.verify(state.family, state.cfg, state.prob,
                                     inject_bug=lowered.latent_bug)
            if res.build_error is not None:
                # invalid config is itself a verdict
                return Verdict(False, caught_static=True, cost_units=cost,
                               reward=-1.0,
                               violation_report=res.build_error,
                               feedback=res.violations,
                               caught_stage="build")
            if not res.hard_ok:
                stage = _catch_stage(res.violations)
                return Verdict(False, caught_static=True, cost_units=cost,
                               reward=STATIC_CATCH_REWARD.get(stage, -0.5),
                               violation_report=res.render(),
                               feedback=res.violations,
                               caught_stage=stage)
            # structural warnings degrade the profile but do not reject
        else:
            # config-validity errors still surface when lowering runs
            res = self.engine.verify(state.family, state.cfg, state.prob)
            if res.build_error is not None:
                return Verdict(False, caught_unit=True,
                               cost_units=COST_UNIT_TEST, reward=-1.0,
                               violation_report=res.build_error,
                               feedback=res.violations,
                               caught_stage="build")

        # unit-test round (real or modeled)
        cost += COST_UNIT_TEST
        if lowered.latent_bug is not None:
            if self.rng.random() < UNIT_TEST_CATCH_P:
                return Verdict(False, caught_unit=True, cost_units=cost,
                               reward=-0.8,
                               violation_report="unit test mismatch "
                               f"(latent {lowered.latent_bug})",
                               caught_stage="unit")
            # bug slips through tests: silent wrong kernel — heavy penalty
            return Verdict(False, caught_unit=False, cost_units=cost,
                           reward=-2.0,
                           violation_report="SILENT corruption")
        if self.run_kernels:
            ok = self._run_real(state)
            if not ok:
                return Verdict(False, caught_unit=True, cost_units=cost,
                               reward=-0.8, violation_report="allclose fail",
                               caught_stage="unit")

        est = state.est.time_s
        reward = math.log(max(incumbent_s, 1e-12) / max(est, 1e-12))
        return Verdict(True, cost_units=cost, reward=reward,
                       est_time_s=est)

    # -- real execution path (chip_smoke.py + tests) -------------------------
    def _run_real(self, state: KernelState) -> bool:
        fam = get_family(state.family)
        if fam.reference_check is None:
            return True
        try:
            ok = bool(fam.reference_check(state.cfg, state.prob,
                                          self.device))
        except (ValueError, InvariantViolation):
            self.reference_refusals += 1
            return False
        self.reference_runs += 1
        return ok
