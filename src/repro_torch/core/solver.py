"""Constraint solving for data-flow invariants.

The paper delegates tag-assertion constraints to an SMT solver (Z3).  Z3 is
unavailable offline, so this module implements an exact decision layer for
the fragment ARGUS' layout algebra actually emits — quasi-affine expressions
over *bounded* integer variables (grid indices, tile-local coordinates):

1. **Symbolic phase** — normalize the difference of the two tag expressions
   (:mod:`repro_torch.core.tags` carries the rewrite rules).  A zero normal form
   proves conformity outright.
2. **Refutation phase** — structured + pseudo-random probing finds a concrete
   violating assignment for almost every genuinely wrong kernel (wrong index
   maps differ on most points); the result is a *counterexample* naming the
   grid step, the logical element and both tag values (paper §5).
3. **Exhaustive phase** — for residual cases, enumerate the full domain when
   it is small enough, otherwise a reduced fundamental box (extents capped by
   the periods of the mod/floordiv atoms).  If the reduced box cannot certify
   equality the result is ``UNKNOWN`` and callers treat it as a failure —
   the analysis stays sound (never claims PROVEN incorrectly).
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from enum import Enum
from math import gcd, prod
from typing import Dict, List, Optional, Sequence, Tuple

from .tags import BOT, TOP, AppAtom, Expr, OpAtom, TagValue, Var


class Status(Enum):
    PROVEN = "proven"
    VIOLATED = "violated"
    UNKNOWN = "unknown"


@dataclass
class Counterexample:
    """Concrete witness of an invariant violation (paper §5): the executing
    grid step + logical element, the program point, and both tag values."""

    env: Dict[Var, int]
    lhs: object
    rhs: object
    detail: str = ""
    program_point: str = ""

    def render(self) -> str:
        assign = ", ".join(f"{v.name}={x}" for v, x in sorted(
            self.env.items(), key=lambda kv: kv[0].name))
        loc = f" at {self.program_point}" if self.program_point else ""
        return (f"invariant violated{loc}: [{assign}] "
                f"lhs={self.lhs!r} rhs={self.rhs!r}"
                + (f" ({self.detail})" if self.detail else ""))


@dataclass
class ProofResult:
    status: Status
    counterexample: Optional[Counterexample] = None
    points_checked: int = 0
    note: str = ""
    # verification stage that *decided* this obligation, set by the site
    # that knows ("analysis" for lattice/interval verdicts); empty means
    # a quantified solver proof.  verify_engine._stage_of reads this.
    stage: str = ""

    @property
    def ok(self) -> bool:
        return self.status is Status.PROVEN


# Tunables -------------------------------------------------------------------
_EXHAUSTIVE_CAP = 200_000      # full-domain enumeration budget (points)
_RANDOM_PROBES = 512           # refutation probes
_REDUCED_DIM_CAP = 48          # per-var cap in the reduced fundamental box
_SEED = 0xA26C5                # deterministic probing


def _domain_vars(exprs: Sequence[Expr]) -> Tuple[Var, ...]:
    seen: list = []
    s = set()
    for e in exprs:
        for v in e.vars():
            if v not in s:
                s.add(v)
                seen.append(v)
    return tuple(seen)


def _probe_points(vars_: Sequence[Var], n_random: int) -> List[Dict[Var, int]]:
    """Structured corners + unit points + deterministic random probes."""
    pts: List[Dict[Var, int]] = []
    if not vars_:
        return [dict()]
    zeros = {v: 0 for v in vars_}
    pts.append(dict(zeros))
    pts.append({v: v.extent - 1 for v in vars_})
    for v in vars_:
        for val in {1 % v.extent, v.extent // 2, v.extent - 1}:
            p = dict(zeros)
            p[v] = val
            pts.append(p)
    rng = random.Random(_SEED)
    for _ in range(n_random):
        pts.append({v: rng.randrange(v.extent) for v in vars_})
    return pts


def _atom_periods(e: Expr, v: Var) -> int:
    """An enumeration bound for ``v`` that covers the periodic structure of
    every mod/floordiv atom mentioning it (plus slack for linear parts)."""
    period = 1
    stack = [e]
    while stack:
        cur = stack.pop()
        for a, _ in cur.terms:
            if isinstance(a, OpAtom):
                if v in a.inner.vars():
                    period = period * a.k // gcd(period, a.k)
                stack.append(a.inner)
    return min(v.extent, max(2 * period, 4))


def _enumerate(vars_: Sequence[Var], extents: Sequence[int]):
    return itertools.product(*[range(n) for n in extents])


def prove_zero(diffs: Sequence[Expr], *, program_point: str = "",
               detail_lhs=None, detail_rhs=None) -> ProofResult:
    """Decide whether every expression in ``diffs`` is identically zero over
    the (bounded) domain of its variables."""
    pending = [d for d in diffs if not (d.is_const and d.const == 0)]
    if not pending:
        return ProofResult(Status.PROVEN, note="symbolic")
    # quick interval check: a difference whose range excludes 0 is violated
    for d in pending:
        lo, hi = d.range()
        if lo > 0 or hi < 0:
            env = {v: 0 for v in d.vars()}
            return ProofResult(Status.VIOLATED, Counterexample(
                env, d.evaluate(env), 0, detail="range excludes zero",
                program_point=program_point))
    vars_ = _domain_vars(pending)
    checked = 0
    # refutation probing
    for env in _probe_points(vars_, _RANDOM_PROBES):
        checked += 1
        for d in pending:
            if d.evaluate(env) != 0:
                full = _pad_env(env, detail_lhs, detail_rhs)
                lhs = (tuple(e.evaluate(full) for e in detail_lhs)
                       if detail_lhs else d.evaluate(env))
                rhs = (tuple(e.evaluate(full) for e in detail_rhs)
                       if detail_rhs else 0)
                return ProofResult(
                    Status.VIOLATED,
                    Counterexample(dict(env), lhs, rhs,
                                   program_point=program_point),
                    points_checked=checked)
    # exhaustive / reduced enumeration
    full = prod(v.extent for v in vars_) if vars_ else 1
    if full <= _EXHAUSTIVE_CAP:
        extents = [v.extent for v in vars_]
        for point in _enumerate(vars_, extents):
            env = dict(zip(vars_, point))
            checked += 1
            for d in pending:
                if d.evaluate(env) != 0:
                    return ProofResult(
                        Status.VIOLATED,
                        Counterexample(env, d.evaluate(env), 0,
                                       program_point=program_point),
                        points_checked=checked)
        return ProofResult(Status.PROVEN, points_checked=checked,
                           note="exhaustive")
    # reduced fundamental box: periods of mod atoms + linear slack
    extents = []
    for v in vars_:
        bound = max(_atom_periods(d, v) for d in pending)
        extents.append(min(v.extent, max(bound, 2), _REDUCED_DIM_CAP))
    if prod(extents) <= _EXHAUSTIVE_CAP:
        linear_certified = _linear_parts_zero(pending)
        for point in _enumerate(vars_, extents):
            env = dict(zip(vars_, point))
            checked += 1
            for d in pending:
                if d.evaluate(env) != 0:
                    return ProofResult(
                        Status.VIOLATED,
                        Counterexample(env, d.evaluate(env), 0,
                                       program_point=program_point),
                        points_checked=checked)
        if linear_certified:
            # zero on a full fundamental box of the periodic parts + no
            # residual linear growth ⇒ identically zero.
            return ProofResult(Status.PROVEN, points_checked=checked,
                               note="fundamental-box")
        return ProofResult(Status.UNKNOWN, points_checked=checked,
                           note="zero on reduced box but not certified")
    return ProofResult(Status.UNKNOWN, points_checked=checked,
                       note="domain too large to certify")


def _pad_env(env: Dict[Var, int], *expr_groups) -> Dict[Var, int]:
    """Extend ``env`` with 0 for vars appearing only in detail tags (they
    cancelled in the difference, so any value is representative)."""
    full = dict(env)
    for group in expr_groups:
        if not group:
            continue
        for e in group:
            if isinstance(e, Expr):
                for v in e.vars():
                    full.setdefault(v, 0)
    return full


def _linear_parts_zero(diffs: Sequence[Expr]) -> bool:
    """True when no difference has a direct (non-atom-wrapped) Var term and
    no uninterpreted application — i.e. the expression is purely periodic,
    so zero on a fundamental box certifies zero everywhere."""
    from .tags import AppAtom
    for d in diffs:
        for a, _ in d.terms:
            if isinstance(a, (Var, AppAtom)):
                return False
    return True


def prove_tags_equal(lhs: TagValue, rhs: TagValue, *,
                     program_point: str = "") -> ProofResult:
    """Conformity assertion: tags at a use site must match (paper §4)."""
    if lhs is TOP or rhs is TOP:
        return ProofResult(Status.VIOLATED, Counterexample(
            {}, lhs, rhs, detail="⊤ reached a use site (conflicting writes)",
            program_point=program_point), stage="analysis")
    if lhs is BOT or rhs is BOT:
        # constants conform with anything (merge identity)
        return ProofResult(Status.PROVEN, note="⊥ operand",
                           stage="analysis")
    if len(lhs) != len(rhs):
        return ProofResult(Status.VIOLATED, Counterexample(
            {}, lhs, rhs, detail="tag arity mismatch",
            program_point=program_point), stage="analysis")
    diffs = [l - r for l, r in zip(lhs, rhs)]
    return prove_zero(diffs, program_point=program_point,
                      detail_lhs=lhs, detail_rhs=rhs)


def prove_tags_distinct(lhs: TagValue, rhs: TagValue, *,
                        program_point: str = "") -> ProofResult:
    """Non-conformity assertion: tags must differ for every assignment
    (separation constraint — concurrent producers must not collide)."""
    if lhs is TOP or rhs is TOP:
        return ProofResult(Status.VIOLATED, Counterexample(
            {}, lhs, rhs, detail="⊤ reached a separation site",
            program_point=program_point), stage="analysis")
    if lhs is BOT or rhs is BOT:
        return ProofResult(Status.VIOLATED, Counterexample(
            {}, lhs, rhs, detail="⊥ cannot be proven distinct",
            program_point=program_point), stage="analysis")
    diffs = [l - r for l, r in zip(lhs, rhs)]
    # distinct iff for all env, some component differs
    vars_ = _domain_vars(diffs)
    # symbolic shortcut: a component whose range excludes zero separates all
    for d in diffs:
        lo, hi = d.range()
        if lo > 0 or hi < 0:
            return ProofResult(Status.PROVEN, note="range-separated")
    full = prod(v.extent for v in vars_) if vars_ else 1
    checked = 0
    if full <= _EXHAUSTIVE_CAP:
        extents = [v.extent for v in vars_]
        for point in _enumerate(vars_, extents):
            env = dict(zip(vars_, point))
            checked += 1
            if all(d.evaluate(env) == 0 for d in diffs):
                return ProofResult(
                    Status.VIOLATED,
                    Counterexample(env,
                                   tuple(e.evaluate(env) for e in lhs),
                                   tuple(e.evaluate(env) for e in rhs),
                                   detail="tags coincide",
                                   program_point=program_point),
                    points_checked=checked)
        return ProofResult(Status.PROVEN, points_checked=checked,
                           note="exhaustive")
    return ProofResult(Status.UNKNOWN, points_checked=checked,
                       note="separation domain too large")


def prove_injective(offset: Expr, over: Sequence[Var], *,
                    program_point: str = "") -> ProofResult:
    """No-clobber invariant: an affine write-offset must be injective in the
    distinguishing variables (two distinct parallel executors never write the
    same location).  Uses the sorted-stride reach argument (exact for the
    affine case), with enumeration fallback for atom-bearing offsets."""
    coeffs: List[Tuple[int, int]] = []  # (|coeff|, extent)
    residual_atoms = False
    over_set = set(over)
    for a, c in offset.terms:
        if isinstance(a, Var) and a in over_set:
            coeffs.append((abs(c), a.extent))
        elif isinstance(a, (OpAtom, AppAtom)) and (
                set(a.inner.vars()) & over_set):
            residual_atoms = True
    if not residual_atoms:
        coeffs.sort(key=lambda p: p[0])
        reach = 0
        for c, n in coeffs:
            if n <= 1:
                continue
            if c == 0 or c <= reach:
                break
            reach += (n - 1) * c
        else:
            return ProofResult(Status.PROVEN, note="stride-reach")
    # fallback: enumeration over the distinguishing vars
    full = prod(v.extent for v in over) if over else 1
    if full <= _EXHAUSTIVE_CAP:
        seen: Dict[Tuple[int, int], Tuple[int, ...]] = {}
        others = [v for v in offset.vars() if v not in over_set]
        base_env = {v: 0 for v in others}
        for point in _enumerate(over, [v.extent for v in over]):
            env = dict(base_env)
            env.update(zip(over, point))
            val = offset.evaluate(env)
            if val in seen:
                return ProofResult(Status.VIOLATED, Counterexample(
                    env, val, dict(zip([v.name for v in over], seen[val])),
                    detail="two executors write the same offset",
                    program_point=program_point))
            seen[val] = point
        return ProofResult(Status.PROVEN, note="exhaustive")
    return ProofResult(Status.UNKNOWN, note="injectivity domain too large")
