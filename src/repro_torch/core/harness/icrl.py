"""In-context RL loop — Algorithm 1 of the paper.

The planner prompt θ is the mutable policy; trajectories of
(state, action, reward) feed PolicyEval → Analyze → ParameterUpdate.
Offline, θ is the per-skill bias vector plus a textual lesson log (the
"text gradient" analogue: every update appends a human-readable lesson and
nudges the biases toward skills with positive advantage) — DESIGN.md §2d.

``optimize_kernel`` is the inner hillclimb (one s₀, T steps, keep the best
valid candidate); ``icrl_train`` is the outer cross-task loop.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import obs as _obs

from ..families import assertion_key
from ..verify_engine import VerificationEngine
from .lowering import LoweredState, LoweringAgent, RepairAttempt
from .planner import KernelState, Planner, PlannerParams, Proposal
from .selector import Selector
from .validator import Validator, Verdict


@dataclass
class StepRecord:
    skill: str
    context: str
    verdict: Verdict
    accepted: bool
    time_s: float
    # stage-attributed repair rounds taken inside this step (paper §9.4)
    repairs: List[RepairAttempt] = field(default_factory=list)


@dataclass
class OptimizeCheckpoint:
    """Resumable hillclimb state — what a budgeted run hands to its
    continuation.  The fleet tuner (:mod:`repro_torch.core.tuning`) runs
    successive-halving rungs as budgeted :func:`optimize_kernel` slices:
    each rung resumes from the previous rung's checkpoint, so doubling a
    survivor's budget continues its trajectory instead of restarting it.
    Configs are stored as config instances; ``baseline_time_s`` is the
    *original* rung-0 baseline so speedups stay cumulative."""

    cur_cfg: object
    best_cfg: object
    baseline_time_s: float
    iterations_done: int = 0


@dataclass
class OptimizeResult:
    best_state: KernelState
    best_time_s: float
    baseline_time_s: float
    history: List[StepRecord] = field(default_factory=list)
    cost_units: float = 0.0
    solved: bool = True
    # VerificationEngine accounting for THIS run (deltas, so a shared
    # engine reports per-run numbers) — fig2_ablation prints them
    verify_stats: Dict[str, int] = field(default_factory=dict)
    # where the walk ended (≠ best_state after a sideways move) and the
    # cumulative iteration count — what checkpoint() snapshots
    final_state: Optional[KernelState] = None
    iterations_done: int = 0

    @property
    def speedup(self) -> float:
        return self.baseline_time_s / self.best_time_s

    def checkpoint(self) -> OptimizeCheckpoint:
        """Snapshot this run so a later budgeted run can continue it."""
        cur = self.final_state or self.best_state
        return OptimizeCheckpoint(cur.cfg, self.best_state.cfg,
                                  self.baseline_time_s,
                                  self.iterations_done)

    def repair_summary(self) -> Dict[str, Dict[str, int]]:
        """Per-stage repair outcomes across the run: for each evidence
        stage ("" = blind), how many attempts were made, how many were
        signature-targeted, and how many landed."""
        out: Dict[str, Dict[str, int]] = {}
        for rec in self.history:
            for att in rec.repairs:
                row = out.setdefault(att.stage or "blind",
                                     {"attempts": 0, "targeted": 0,
                                      "fixed": 0})
                row["attempts"] += 1
                row["targeted"] += int(att.targeted)
                row["fixed"] += int(att.fixed)
        return out


def optimize_kernel(state0: KernelState, *, planner: Planner,
                    selector: Optional[Selector] = None,
                    lowering: Optional[LoweringAgent] = None,
                    validator: Optional[Validator] = None,
                    iterations: int = 10,
                    max_repairs: int = 2,
                    checkpoint: Optional[OptimizeCheckpoint] = None
                    ) -> OptimizeResult:
    """Inner hillclimb (one s₀, ``iterations`` steps, keep the best valid
    candidate).  With ``checkpoint``, the walk resumes where a previous
    budgeted slice left off: current/best configs come from the
    checkpoint (their estimates are re-derived from the cost model, so a
    serialized checkpoint cannot smuggle in a stale score) and the
    baseline stays the original run's."""
    selector = selector or Selector()
    lowering = lowering or LoweringAgent()
    validator = validator or Validator()
    stats0 = validator.engine.stats()

    state0.refresh()
    if checkpoint is not None:
        best = KernelState(state0.family, checkpoint.best_cfg,
                           state0.prob).refresh()
        cur = KernelState(state0.family, checkpoint.cur_cfg,
                          state0.prob).refresh()
        best_t = best.est.time_s
        res = OptimizeResult(best, best_t, checkpoint.baseline_time_s)
    else:
        best = cur = state0
        best_t = state0.est.time_s
        res = OptimizeResult(best, best_t, best_t)
    for step_i in range(iterations):
        with _obs.span("icrl.step") as sp:
            props = planner.propose(cur)
            prop = selector.select(props)
            if prop is None:
                break
            lowered = lowering.apply(cur, prop)
            verdict = validator.evaluate(lowered, best_t)
            res.cost_units += verdict.cost_units
            attempts: List[RepairAttempt] = []
            while not verdict.ok and len(attempts) < max_repairs and (
                    verdict.caught_static or verdict.caught_unit):
                # a static catch hands the structured counterexamples to
                # the repair agent; a unit-test catch hands it nothing
                # (blind)
                lowered, att = lowering.repair(
                    lowered,
                    feedback=verdict.feedback if verdict.caught_static
                    else ())
                attempts.append(att)
                verdict = validator.evaluate(lowered, best_t)
                res.cost_units += verdict.cost_units
            accepted = verdict.ok and verdict.est_time_s < best_t
            if accepted:
                best = lowered.state
                best_t = verdict.est_time_s
                cur = lowered.state
            elif verdict.ok:
                cur = lowered.state      # sideways move keeps exploring
            res.history.append(StepRecord(prop.skill.name, prop.context,
                                          verdict, accepted,
                                          verdict.est_time_s,
                                          repairs=attempts))
            if _obs.enabled():
                sp.set(step=step_i, skill=prop.skill.name,
                       accepted=accepted, repairs=len(attempts))
    res.best_state, res.best_time_s = best, best_t
    res.final_state = cur
    res.iterations_done = len(res.history) + (
        checkpoint.iterations_done if checkpoint is not None else 0)
    res.solved = any(r.verdict.ok for r in res.history) or not res.history
    stats1 = validator.engine.stats()
    res.verify_stats = {k: stats1[k] - stats0.get(k, 0) for k in stats1}
    return res


# --------------------------------------------------------------------------
# Fleet lesson exchange — what the shared lesson store transports
# --------------------------------------------------------------------------

# bias learning rate for imported fleet lessons (deliberately below the
# local lr=0.5: a peer's lesson is evidence, not this trajectory's own)
LESSON_LR = 0.25


def export_lessons(result: OptimizeResult, *, family: str,
                   source: str) -> List[Dict]:
    """Distill one optimize run into structured, publishable lesson
    entries — the wire format of the fleet's shared lesson store
    (:mod:`repro_torch.core.tuning.lessons`).  One entry per skill the
    episode produced an advantage signal for, stage-attributed with the
    (stage, assertion) the skill's rewrites tripped most.  ``source``
    (the work-item id) makes re-publication after a crash/re-dispatch
    idempotent: the store keys entries on a content hash that includes
    it."""
    grads = analyze(policy_eval(result.history))
    trips = assertion_trips(result.history)
    entries: List[Dict] = []
    for skill in sorted(grads):
        g = grads[skill]
        stage, akey, strikes = "", "", 0
        per = trips.get(skill)
        if per:
            # deterministic worst offender: count, then label, tie-break
            (stage, akey), strikes = max(
                per.items(), key=lambda kv: (kv[1], kv[0]))
        entries.append({
            "skill": skill, "family": family, "source": source,
            "direction": "prefer" if g > 0 else "avoid",
            "advantage": round(g, 6),
            "stage": stage, "assertion": akey, "strikes": strikes,
        })
    return entries


def import_lessons(params: PlannerParams, entries: Sequence[Dict], *,
                   family: Optional[str] = None,
                   skills: Optional[set] = None) -> Dict[str, int]:
    """Warm-start θ from published fleet lessons.

    Entries are grouped by (skill, direction, stage, assertion); each
    group contributes ``LESSON_LR · mean(advantage) · log1p(#sources)``
    to the skill bias — repeated observations saturate logarithmically
    (the store's *decay*: one loud lesson cannot dominate θ however many
    workers republish it) — and its assertion strikes are folded into
    :attr:`PlannerParams.assertion_strikes` (by max, so re-imports are
    idempotent).  Application iterates groups in sorted order, so the
    resulting θ depends only on the entry *set*, never on merge or
    arrival order.

    ``skills`` restricts application to the consuming family's skill
    names (generic skills — retile, software_pipelining, … — are what
    carries lessons *across* families); ``family`` is the consumer,
    used only to count cross-family reuse.  Returns counters:
    ``imported`` (entries applied), ``reused`` (of those, published by a
    different family), ``strikes`` (assertion strikes folded in)."""
    groups: Dict[Tuple[str, str, str, str], List[Dict]] = {}
    counts = {"imported": 0, "reused": 0, "strikes": 0}
    for e in entries:
        skill = e.get("skill")
        if not skill or (skills is not None and skill not in skills):
            continue
        key = (skill, e.get("direction", ""), e.get("stage", ""),
               e.get("assertion", ""))
        groups.setdefault(key, []).append(e)
        counts["imported"] += 1
        if family is not None and e.get("family") != family:
            counts["reused"] += 1
    for (skill, _direction, _stage, akey) in sorted(groups):
        group = sorted(groups[(skill, _direction, _stage, akey)],
                       key=lambda e: str(e.get("source")))
        adv = sum(float(e.get("advantage", 0.0)) for e in group) \
            / len(group)
        params.skill_bias[skill] = params.skill_bias.get(skill, 0.0) \
            + LESSON_LR * adv * math.log1p(len(group))
        strikes = sum(int(e.get("strikes", 0)) for e in group)
        if akey and strikes:
            per = params.assertion_strikes.setdefault(skill, {})
            if strikes > per.get(akey, 0):
                counts["strikes"] += strikes - per.get(akey, 0)
                per[akey] = strikes
        lesson = (f"[fleet] {_direction} {skill} "
                  f"(advantage {adv:+.3f}, {len(group)} source(s))")
        if akey:
            lesson += f" — trips {akey} at the {_stage} stage"
        params.lessons.append(lesson)
    return counts


# --------------------------------------------------------------------------
# Algorithm 1 — outer loop
# --------------------------------------------------------------------------

def policy_eval(buffer: List[StepRecord]) -> Dict[str, float]:
    """E_k: mean reward per skill over the episode buffer."""
    sums: Dict[str, List[float]] = {}
    for rec in buffer:
        sums.setdefault(rec.skill, []).append(rec.verdict.reward)
    return {k: sum(v) / len(v) for k, v in sums.items()}


def analyze(evals: Dict[str, float]) -> Dict[str, float]:
    """g_k: advantage of each skill vs the episode mean (the numeric
    'text gradient')."""
    if not evals:
        return {}
    mean = sum(evals.values()) / len(evals)
    return {k: v - mean for k, v in evals.items()}


def assertion_trips(buffer: Optional[Sequence[StepRecord]]
                    ) -> Dict[str, Dict[Tuple[str, str], int]]:
    """Per skill, how often each (stage, stable assertion key) fired
    across the episode buffer — the raw material for stage-attributed
    lessons (both the local textual ones and the fleet's shared store)."""
    trips: Dict[str, Dict[Tuple[str, str], int]] = {}
    for rec in buffer or ():
        if rec.verdict.ok:
            continue
        for f in rec.verdict.feedback:
            if f.ok:
                continue
            akey = assertion_key(f.assertion_id)
            per = trips.setdefault(rec.skill, {})
            per[(f.stage, akey)] = per.get((f.stage, akey), 0) + 1
    return trips


def parameter_update(params: PlannerParams, grads: Dict[str, float],
                     buffer: Optional[Sequence[StepRecord]] = None,
                     lr: float = 0.5) -> PlannerParams:
    """θ update.  With the episode ``buffer``, lessons become
    *stage-attributed*: a skill with negative advantage is annotated with
    the assertion (and pipeline stage) its rewrites kept tripping, and
    every violation is recorded as an assertion strike — which is what
    :meth:`PlannerParams.strike_penalty` down-weights in later proposals."""
    trips = assertion_trips(buffer)
    for skill, per in trips.items():
        for (_stage, akey), n in per.items():
            for _ in range(n):
                params.strike(skill, akey)
    for k, g in grads.items():
        params.skill_bias[k] = params.skill_bias.get(k, 0.0) + lr * g
        direction = "prefer" if g > 0 else "avoid"
        lesson = f"{direction} {k} (advantage {g:+.3f}) on this task family"
        if g < 0 and k in trips:
            (stage, akey), n = max(trips[k].items(), key=lambda kv: kv[1])
            lesson += f" — trips {akey} at the {stage} stage ×{n}"
        params.lessons.append(lesson)
    return params


def icrl_train(tasks: Sequence[KernelState], *, episodes: int = 8,
               iterations: int = 8, seed: int = 0,
               fault_model: bool = True,
               use_invariants: bool = True) -> Tuple[PlannerParams,
                                                     List[OptimizeResult]]:
    """Outer ICRL loop: sample s₀ ~ E, run the inner trajectory, update θ.

    One :class:`VerificationEngine` is shared across every episode:
    cross-episode revisits are result-cache hits and config mutations
    only re-discharge the constraints they actually changed."""
    rng = random.Random(seed)
    params = PlannerParams()
    results: List[OptimizeResult] = []
    engine = VerificationEngine()
    for k in range(episodes):
        s0 = tasks[rng.randrange(len(tasks))]
        state = KernelState(s0.family, s0.cfg, s0.prob).refresh()
        planner = Planner(params)
        res = optimize_kernel(
            state, planner=planner,
            selector=Selector(seed=seed * 1000 + k),
            lowering=LoweringAgent(fault_model=fault_model,
                                   seed=seed * 77 + k),
            validator=Validator(use_invariants=use_invariants,
                                engine=engine),
            iterations=iterations)
        results.append(res)
        evals = policy_eval(res.history)
        grads = analyze(evals)
        params = parameter_update(params, grads, buffer=res.history)
    return params, results
