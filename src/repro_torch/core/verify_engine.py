"""Staged, caching verification engine — the dense-feedback fast path.

The paper's claim (§5–6) is that *cheap, dense* compile-time feedback from
data-flow invariants is what lets an agent coordinate tightly coupled
optimizations.  The legacy ``verify_<family>`` entry points re-prove every
assertion from scratch on every call; inside the ICRL hillclimb that means
re-discharging identical quasi-affine constraints dozens of times per
episode.  This engine makes the feedback loop incremental:

**Stage 1 — structural** (:mod:`repro_torch.core.kernelspec`): the Hopper
structural model — shared memory per CTA, accumulator registers,
tensor-core grain, 16-byte alignment, CTA split, masking obligations.
Pure arithmetic on the config; no program build.

**Stage 2 — tag propagation** (:mod:`repro_torch.core.analysis`): build the
tile program and run the abstract interpreter.  Config-validity errors surface
here as ``build`` feedback; lattice-level violations (⊤ reaching a use
site, tag arity mismatches) are decided without the solver.

**Stage 3 — solver discharge** (:mod:`repro_torch.core.solver`), memoized:
every quantified obligation is keyed by the **canonical normal form of its
difference expressions** (the :class:`repro_torch.core.tags.Expr` normal form,
with analyzer-deterministic variable naming).  After a config mutation only
the assertions whose tag expressions actually changed miss the cache —
e.g. flipping ``stagger_k`` re-proves the K-index bijection but reuses the
coverage, alignment-conformity and accumulator proofs verbatim.

Results are returned as structured :class:`Feedback` objects (stage,
assertion id, counterexample, repair hint) rather than strings, so the
harness can route counterexamples into targeted repair prompts.

Three more layers make the loop incremental end to end:

* **Whole-result memo** (keyed on the frozen (family, config, problem,
  bug) tuple): exact re-verification — repairs, sideways moves, revisited
  configs — is free.
* **Program-skeleton memo**: traced ``TileProgram``\\ s are memoized on the
  same key, and their *structural signatures* (op sequence, grid
  semantics — everything except the config-bound Exprs) are interned per
  (family, problem, bug).  The first config of a structural class is a
  full build; every later congruent trace is counted (and reported) as a
  skeleton re-bind, with the constraint cache re-proving only the
  assertions whose expressions actually changed.
* **Alpha-renaming canonicalizer** (:func:`canonical_key`): constraint
  keys are normalized to De Bruijn-style variable indices before lookup,
  so congruent proofs are shared across configs that number their trace
  locals differently, across assertion reorderings, and across families —
  including through the persisted ``constraint_cache.json``.

``stats()`` reports verify calls, result/program hits, full builds vs
skeleton re-binds, constraint/canonical hits and solver discharges;
``benchmarks/fig2_ablation.py`` prints them next to the wall-clock win.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import json
from pathlib import Path

from repro_torch import obs as _obs

from .analysis import Analyzer, CheckReport, Discharger
from .families import get_family
from .fslock import locked, merge_save
from .kernelspec import VerifyResult
from .solver import (Counterexample, ProofResult, Status, prove_injective,
                     prove_tags_distinct, prove_tags_equal, prove_zero)
from .tags import (AppAtom, BOT, OpAtom, TOP, Expr, TagValue, Var)


# ---------------------------------------------------------------------------
# Structured feedback
# ---------------------------------------------------------------------------

@dataclass
class Feedback:
    """One verification finding, routed back to the agent.

    ``stage``: "structural" | "build" | "analysis" | "solver".
    ``assertion_id``: the program point / assertion label.
    ``counterexample``: concrete witness when the solver found one.
    ``repair_hint``: what kind of fix the violation calls for.
    """

    stage: str
    assertion_id: str
    ok: bool
    counterexample: Optional[Counterexample] = None
    repair_hint: str = ""
    detail: str = ""

    def render(self) -> str:
        mark = "PASS" if self.ok else "FAIL"
        s = f"[{self.stage}] {mark} {self.assertion_id}"
        if self.detail:
            s += f" — {self.detail}"
        if self.counterexample is not None:
            s += f"\n    {self.counterexample.render()}"
        if self.repair_hint:
            s += f"\n    hint: {self.repair_hint}"
        return s


_HINTS = (
    ("assert_in_range", "the index expression can escape its declared "
                        "bound — clamp the indirection table's result "
                        "range (or fix the base/extent arithmetic) so "
                        "every access stays inside the physical buffer"),
    ("assert_injective", "the reduction index expression replays or skips "
                         "blocks — restore the bijection over the "
                         "reduction range"),
    ("assert_stable", "the carried value's tag depends on the sequential "
                      "axis — retag with output coordinates only, or "
                      "reset the buffer each step"),
    ("assert_disjoint", "two parallel grid steps write the same block — "
                        "make the store origin injective in the parallel "
                        "axes"),
    ("assert_coverage", "the grid under-covers the output — check cdiv()/"
                        "grid extents and store origins"),
    ("assert_nonconform", "concurrent producers must stay separated — "
                          "their tags coincide on some element"),
    ("scatter", "the combine must scatter through the same permutation "
                "table the dispatch gathered with"),
    ("assert_conform", "re-derive the operand index map at this use site — "
                       "the paired elements carry different coordinates"),
    ("conform", "re-derive the operand index map at this use site — "
                "the paired elements carry different coordinates"),
)


def repair_hint_for(assertion_id: str, res: ProofResult) -> str:
    if res.ok:
        return ""
    ce = res.counterexample
    if ce is not None and "⊤" in (ce.detail or ""):
        return ("a value reached this point with conflicting provenance "
                "(⊤) — add a retag declaring its semantics, or reset the "
                "scratch buffer per step")
    for needle, hint in _HINTS:
        if needle in assertion_id:
            return hint
    return "re-check the index maps feeding this assertion"


def _stage_of(res: ProofResult) -> str:
    """Classify a discharged assertion: lattice-level verdicts (⊤/⊥,
    arity, or interval bounds — all decided during propagation without a
    counterexample search) vs quantified solver proofs.  The deciding
    site stamps ``ProofResult.stage``; the message sniffing below only
    covers results reconstructed without one (e.g. verdicts loaded from
    a persisted cache written by an older version)."""
    if res.stage:
        return res.stage
    ce = res.counterexample
    if ce is not None and ("⊤" in (ce.detail or "")
                           or "arity" in (ce.detail or "")):
        return "analysis"
    if res.ok and ("⊥" in (res.note or "")
                   or (res.note or "").startswith("interval")):
        return "analysis"
    return "solver"


# ---------------------------------------------------------------------------
# Stable (cross-process) constraint-key serialization
# ---------------------------------------------------------------------------

def _stable_atom(a) -> str:
    if isinstance(a, Var):
        # extents are load-bearing: a verdict holds for exactly this
        # domain, so the serialized key must pin them (plain repr() of a
        # Var prints only the name)
        return f"{a.name}#{a.extent}"
    if isinstance(a, OpAtom):
        return f"({a.kind} {stable_expr(a.inner)} {a.k})"
    if isinstance(a, AppAtom):
        return f"{a.name}#{a.extent}({stable_expr(a.inner)})"
    return repr(a)


def stable_expr(e: Expr) -> str:
    """Deterministic, extent-qualified rendering of an Expr normal form —
    identical across processes (the analyzer's per-run variable naming is
    deterministic, and Expr.terms is sorted)."""
    parts = [f"{c}*{_stable_atom(a)}" for a, c in e.terms]
    parts.append(str(e.const))
    return "+".join(parts)


def stable_constraint_key(key: tuple) -> str:
    """Serialize a ConstraintCache key (a nested tuple of str/int/Expr/
    Var) into its canonical string form for on-disk persistence."""
    out = []
    for item in key:
        if isinstance(item, Expr):
            out.append(stable_expr(item))
        elif isinstance(item, Var):
            out.append(_stable_atom(item))
        elif isinstance(item, tuple):
            out.append(stable_constraint_key(item))
        else:
            out.append(repr(item))
    return "(" + " ".join(out) + ")"


# ---------------------------------------------------------------------------
# Alpha-renaming canonicalizer (De Bruijn-style variable indices)
# ---------------------------------------------------------------------------

class _Canon:
    """One canonicalization pass: renames every :class:`Var` to ``x<i>``
    (preserving its extent — the extents are what verdicts quantify over)
    in order of first appearance, rebuilding ``Expr``/atom structure
    untouched.  Uninterpreted-table names (:class:`AppAtom`) are *kept*:
    two different tables are genuinely different functions, and the
    solver's finite-model interpretation keys on the name.

    Index assignment must not depend on the *original* names (the whole
    point is erasing them), so within each expression terms are visited
    in a name-free structural order — (coefficient, atom shape) — not in
    ``Expr.terms``' name-sorted storage order.  Same-shaped variables at
    the same coefficient are further ranked by their *global occurrence
    signature* (:func:`_occurrence_signatures`): the sorted tuple of
    name-free paths at which the variable appears anywhere in the key.
    Congruent keys assign corresponding variables identical signatures,
    so a tie that is broken at all is broken the same way on both sides;
    variables whose signatures also tie are genuinely interchangeable
    (swapping them is an automorphism of the key), so the residual
    name-order fallback cannot canonicalize congruent keys apart."""

    def __init__(self, sigs: Optional[Dict["Var", tuple]] = None):
        self._map: Dict[Var, Var] = {}
        self._sigs: Dict[Var, tuple] = sigs or {}

    def var(self, v: Var) -> Var:
        c = self._map.get(v)
        if c is None:
            c = Var(f"x{len(self._map)}", v.extent)
            self._map[v] = c
        return c

    @staticmethod
    def _shape(a) -> tuple:
        """Name-free structural rank of an atom (extents, op kinds and
        nesting only; table names are semantic, so AppAtom keeps its)."""
        if isinstance(a, Var):
            return (0, a.extent)
        if isinstance(a, OpAtom):
            return (1, 0 if a.kind == "floordiv" else 1, a.k,
                    _Canon._shape_expr(a.inner))
        if isinstance(a, AppAtom):
            return (2, a.extent, a.name, _Canon._shape_expr(a.inner))
        return (3, repr(a))

    @staticmethod
    def _shape_expr(e: Expr) -> tuple:
        return (e.const,
                tuple(sorted((c, _Canon._shape(a)) for a, c in e.terms)))

    def atom(self, a):
        if isinstance(a, Var):
            return self.var(a)
        if isinstance(a, OpAtom):
            return OpAtom(a.kind, self.expr(a.inner), a.k)
        if isinstance(a, AppAtom):
            return AppAtom(a.name, self.expr(a.inner), a.extent)
        return a

    def _sig(self, a) -> tuple:
        """Tie-break rank of an atom: the sorted signatures of every
        variable inside it (name-free — congruent keys rank congruent
        atoms identically)."""
        if isinstance(a, Var):
            return (self._sigs.get(a, ()),)
        if isinstance(a, (OpAtom, AppAtom)):
            return tuple(sorted(s for at, _ in a.inner.terms
                                for s in self._sig(at)))
        return ()

    def expr(self, e: Expr) -> Expr:
        terms: Dict[object, int] = {}
        for a, c in sorted(e.terms,
                           key=lambda ac: (ac[1], self._shape(ac[0]),
                                           self._sig(ac[0]))):
            ca = self.atom(a)
            terms[ca] = terms.get(ca, 0) + c
        return Expr(terms, e.const)

    def walk(self, item):
        if isinstance(item, Expr):
            return self.expr(item)
        if isinstance(item, Var):
            return self.var(item)
        if isinstance(item, tuple):
            return tuple(self.walk(x) for x in item)
        return item


def _occurrence_signatures(key: tuple) -> Dict[Var, tuple]:
    """Name-free global signature per variable: the sorted tuple of
    paths at which it occurs anywhere in ``key``.  Every path element is
    a ``(tag, ...)`` tuple (tuple index, term coefficient + expression
    constant, op kind, table name) so signatures compare without ever
    mixing types — and never mention a variable name, so congruent keys
    assign corresponding variables equal signatures."""
    sigs: Dict[Var, List[tuple]] = {}

    def visit_expr(e: Expr, path: tuple) -> None:
        for a, c in e.terms:
            visit_atom(a, path + (("term", c, e.const),))

    def visit_atom(a, path: tuple) -> None:
        if isinstance(a, Var):
            sigs.setdefault(a, []).append(path + (("var", a.extent),))
        elif isinstance(a, OpAtom):
            visit_expr(a.inner, path + (("op", a.kind, a.k),))
        elif isinstance(a, AppAtom):
            visit_expr(a.inner, path + (("app", a.name, a.extent),))

    def visit(item, path: tuple) -> None:
        if isinstance(item, Expr):
            visit_expr(item, path)
        elif isinstance(item, (Var, OpAtom, AppAtom)):
            visit_atom(item, path)
        elif isinstance(item, tuple):
            for i, x in enumerate(item):
                visit(x, path + (("idx", i),))

    visit(key, ())
    return {v: tuple(sorted(occ)) for v, occ in sigs.items()}


def canonical_key(key: tuple) -> tuple:
    """Alpha-rename a constraint key into its canonical form.

    Renaming is a bijection that preserves every extent, and verdicts
    depend only on expression structure and variable domains — never on
    names — so two keys with equal canonical forms are obligations of the
    same theorem.  This is what shares proofs across configs whose traces
    number their locals differently, across assertion reorderings, and
    across families.  Within-expression term order is name-free —
    (coefficient, atom shape), with ties resolved by each variable's
    global occurrence signature — so congruent keys that merely permute
    same-shaped variables (e.g. two grid axes of the same extent with
    swapped roles elsewhere in the key) canonicalize together rather
    than apart."""
    return _Canon(_occurrence_signatures(key)).walk(key)


# ---------------------------------------------------------------------------
# Normalized-constraint memo cache
# ---------------------------------------------------------------------------

class ConstraintCache:
    """Memo of discharged proof obligations, keyed by the canonical normal
    form of the obligation's expressions.

    :class:`repro_torch.core.tags.Expr` is already a normal form (sorted linear
    combination over atoms with reduced ``//``/``%`` structure), and the
    analyzer names variables deterministically per run, so two builds of
    the same — or a partially mutated — program produce *syntactically
    identical* expressions for every unchanged assertion.  Every key is
    additionally passed through :func:`canonical_key` before lookup:
    variables are alpha-renamed to De Bruijn-style indices (extents
    preserved), so congruent obligations hit even when the traces that
    produced them numbered their locals differently — across configs,
    assertion reorderings and families.  Verdicts depend only on the
    expressions and their variables' extents (both captured by the
    canonical key), never on which config produced them or what its
    variables were called, so the sharing is sound.  ``canonical_hits``
    counts the hits that only the renaming made possible (the raw key had
    never been seen).
    """

    # bound on retained verdicts: FIFO-evict beyond this (an optimization
    # loop's working set is a few hundred constraints; the bound only
    # matters for long-lived serving processes)
    MAX_ENTRIES = 8192
    # on-disk bound (ROADMAP "solver-cache persistence"): FIFO-evict the
    # oldest serialized verdicts beyond this when saving
    MAX_PERSISTED = 4096

    def __init__(self):
        # memo keyed on CANONICAL keys (see canonical_key)
        self._memo: Dict[tuple, ProofResult] = {}
        # raw key -> its canonical key: makes repeat lookups (the dominant
        # hillclimb case) a single dict get instead of a tree rebuild, and
        # marks which raw keys were seen — a memo hit whose raw key is
        # unseen was enabled purely by the canonicalization.  FIFO-bounded;
        # canonical_hits is therefore approximate on runs exceeding
        # MAX_ENTRIES distinct raw keys, and persisted-store hits are
        # accounted under persisted_hits only (the saving process' raw
        # naming is unknowable here).
        self._raw_seen: Dict[tuple, tuple] = {}
        # warm-start store loaded from disk: stable key -> (note, stage).
        # Only PROVEN verdicts are persisted — they are the ones repeat
        # tuning runs re-discharge, and they need no counterexample
        # round-trip (a violation's witness is program-point-specific).
        # Insertion order is recency (refreshed on hit), so save()'s
        # FIFO eviction drops the least-recently-used entries.
        self._persisted: Dict[str, Tuple[str, str]] = {}
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.persisted_hits = 0
        self.canonical_hits = 0
        # wall-clock spent inside solver thunks (cache misses only), µs
        self.solver_wall_us = 0

    def __len__(self) -> int:
        return len(self._memo)

    def discharge(self, key: tuple, thunk, *,
                  program_point: str = "") -> ProofResult:
        self.lookups += 1
        ckey = self._raw_seen.get(key)
        raw_seen = ckey is not None
        if not raw_seen:
            ckey = canonical_key(key)
            if len(self._raw_seen) >= self.MAX_ENTRIES:
                self._raw_seen.pop(next(iter(self._raw_seen)))
            self._raw_seen[key] = ckey
        hit = self._memo.get(ckey)
        if hit is not None:
            self.hits += 1
            if not raw_seen:
                self.canonical_hits += 1
            return self._restamp(hit, program_point)
        if self._persisted:
            sk = stable_constraint_key(ckey)
            entry = self._persisted.get(sk)
            if entry is not None:
                self.hits += 1
                self.persisted_hits += 1
                # refresh recency so save()'s eviction keeps live entries
                self._persisted[sk] = self._persisted.pop(sk)
                note, stage = entry
                res = ProofResult(Status.PROVEN, note=note, stage=stage)
                if len(self._memo) >= self.MAX_ENTRIES:
                    self._memo.pop(next(iter(self._memo)))
                self._memo[ckey] = res
                return res
        self.misses += 1
        t0 = time.perf_counter()
        with _obs.span("verify.solver"):
            res = thunk()
        self.solver_wall_us += int((time.perf_counter() - t0) * 1e6)
        if len(self._memo) >= self.MAX_ENTRIES:
            self._memo.pop(next(iter(self._memo)))
        self._memo[ckey] = res
        return res

    # -- persistence (warm-start across processes) ---------------------------
    # Format version 2: keys are serialized from *canonical* (alpha-
    # renamed) constraint keys, so a persisted proof warms congruent
    # obligations from any config or family.  Version-1 files (raw
    # analyzer naming) load as empty — a cold start, never a wrong answer.
    PERSIST_VERSION = 2

    def save(self, path) -> int:
        """Serialize the proven verdicts (stable canonical keys, insertion
        order) to ``path``, merging over what is on disk and FIFO-evicting
        beyond :data:`MAX_PERSISTED`.  Returns the number of entries
        written.  The read-merge-write goes through
        :func:`repro_torch.core.fslock.merge_save`: the merge base is re-read
        inside one exclusive advisory lock, so two workers saving
        concurrently union their verdicts instead of the later one
        clobbering the earlier's."""
        ours = dict(self._persisted)
        for key, res in self._memo.items():
            if res.ok:
                sk = stable_constraint_key(key)   # key is already canonical
                ours.pop(sk, None)    # refresh recency for this run
                ours[sk] = [res.note or res.status.value, res.stage]

        def merge(disk):
            merged: Dict[str, list] = {}
            try:
                if disk and disk.get("version") == self.PERSIST_VERSION:
                    merged = dict(disk["constraints"])
            except (KeyError, TypeError, ValueError):
                merged = {}
            for sk, entry in ours.items():    # this run's entries win
                merged.pop(sk, None)          # recency
                merged[sk] = list(entry)
            items = list(merged.items())
            if len(items) > self.MAX_PERSISTED:
                items = items[-self.MAX_PERSISTED:]
            return {"version": self.PERSIST_VERSION, "constraints": items}

        return len(merge_save(path, merge, indent=0)["constraints"])

    def load(self, path) -> int:
        """Load previously persisted verdicts; silently starts cold on a
        missing, unreadable or old-format file.  Returns the number of
        entries newly added to the store.  Reads under an advisory shared
        lock so a concurrent writer cannot hand us a torn file."""
        before = len(self._persisted)
        try:
            with locked(path, exclusive=False):
                data = json.loads(Path(path).read_text())
            if data.get("version") != self.PERSIST_VERSION:
                return 0
            self._persisted.update(
                {k: (str(note), str(stage))
                 for k, (note, stage) in dict(data["constraints"]).items()})
        except (OSError, ValueError, KeyError, TypeError):
            return 0
        return len(self._persisted) - before

    @staticmethod
    def _restamp(res: ProofResult, program_point: str) -> ProofResult:
        """A cached verdict may have been proven at a *different* program
        point (two assertions normalizing to the same constraint); re-stamp
        the counterexample so repair feedback names the caller's site."""
        ce = res.counterexample
        if not program_point or ce is None \
                or ce.program_point == program_point:
            return res
        from dataclasses import replace
        return replace(res, counterexample=replace(
            ce, program_point=program_point))


class CachingDischarger(Discharger):
    """Routes the analyzer's proof obligations through a
    :class:`ConstraintCache`.  Lattice-level early-outs (⊤/⊥ operands, tag
    arity mismatches) are decided inline — they are cheaper than a cache
    probe and their verdict is part of propagation, not solving."""

    def __init__(self, cache: ConstraintCache):
        self.cache = cache

    @staticmethod
    def _norm(diffs: Sequence[Expr]) -> Tuple[Expr, ...]:
        # drop identically-zero components: they never affect the verdict,
        # and removing them lets e.g. a retile that only renames a matched
        # coordinate still hit the memo
        return tuple(d for d in diffs if not (d.is_const and d.const == 0))

    def tags_equal(self, lhs: TagValue, rhs: TagValue, *,
                   program_point: str = "") -> ProofResult:
        if lhs is TOP or rhs is TOP or lhs is BOT or rhs is BOT \
                or len(lhs) != len(rhs):
            return prove_tags_equal(lhs, rhs, program_point=program_point)
        diffs = self._norm([l - r for l, r in zip(lhs, rhs)])
        return self.cache.discharge(
            ("eq", diffs),
            lambda: prove_tags_equal(lhs, rhs,
                                     program_point=program_point),
            program_point=program_point)

    def tags_distinct(self, lhs: TagValue, rhs: TagValue, *,
                      program_point: str = "") -> ProofResult:
        if lhs is TOP or rhs is TOP or lhs is BOT or rhs is BOT:
            return prove_tags_distinct(lhs, rhs,
                                       program_point=program_point)
        diffs = tuple(l - r for l, r in zip(lhs, rhs))
        return self.cache.discharge(
            ("neq", diffs, len(lhs)),
            lambda: prove_tags_distinct(lhs, rhs,
                                        program_point=program_point),
            program_point=program_point)

    def zero(self, diffs: Sequence[Expr], *,
             program_point: str = "") -> ProofResult:
        norm = self._norm(diffs)
        return self.cache.discharge(
            ("zero", norm),
            lambda: prove_zero(list(diffs), program_point=program_point),
            program_point=program_point)

    def injective(self, expr: Expr, over: Sequence[Var], *,
                  program_point: str = "") -> ProofResult:
        return self.cache.discharge(
            ("inj", expr, tuple(over)),
            lambda: prove_injective(expr, over,
                                    program_point=program_point),
            program_point=program_point)

    def check_block(self, kind: str, key: tuple, thunk) -> ProofResult:
        return self.cache.discharge(key, thunk)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class InvariantViolation(RuntimeError):
    """Raised by a validated kernel entry point (``repro_torch.kernels.*.
    ops``) for a config the gate rejects, before any launch; the message
    is the rendered report."""


@dataclass
class EngineResult(VerifyResult):
    """A :class:`repro_torch.core.kernelspec.VerifyResult` extended with the
    engine's structured feedback and provenance."""

    feedback: List[Feedback] = field(default_factory=list)
    build_error: Optional[str] = None
    family: str = ""
    cached: bool = False

    @property
    def ok(self) -> bool:
        return self.build_error is None and super().ok

    @property
    def hard_ok(self) -> bool:
        return self.build_error is None and super().hard_ok

    @property
    def violations(self) -> List[Feedback]:
        return [f for f in self.feedback if not f.ok]

    def render(self) -> str:
        if self.build_error is not None:
            return (f"  BUILD-ERROR {self.family}: {self.build_error}\n"
                    f"  VERDICT: REJECTED")
        lines = [super().render()]
        hints = [f for f in self.violations if f.repair_hint]
        for f in hints:
            lines.append(f"  HINT[{f.stage}] {f.assertion_id}: "
                         f"{f.repair_hint}")
        return "\n".join(lines)


class VerificationEngine:
    """Staged verification with a normalized-constraint memo cache and a
    whole-result memo.  One engine instance should live as long as the
    optimization loop it feeds — sharing it across hillclimb steps (and
    across episodes) is what turns re-verification into cache hits."""

    # FIFO bound on retained EngineResults (matches the old per-kernel
    # lru_cache(512) gates this engine replaced; keeps long-lived serving
    # processes from growing the memo without limit)
    MAX_RESULTS = 512
    # FIFO bound on retained traced programs — wider than MAX_RESULTS so
    # a program outlives its result and a revisit after result eviction
    # still skips the re-trace
    MAX_PROGRAMS = 2048

    def __init__(self, *, use_cache: bool = True,
                 constraints: Optional[ConstraintCache] = None):
        self.use_cache = use_cache
        # identity check, not truthiness: a freshly warm-loaded cache has
        # __len__() == 0 (memo empty, persisted store full) and must not
        # be silently replaced
        self.constraints = (constraints if constraints is not None
                            else ConstraintCache())
        self._results: Dict[tuple, EngineResult] = {}
        # traced-program memo: (family, cfg, prob, bug) -> TileProgram
        self._programs: Dict[tuple, object] = {}
        # interned program skeletons: (family, prob, bug, structure_sig).
        # The first config of a structural class is a *full build*; every
        # later congruent trace only re-binds config-dependent Exprs into
        # a known skeleton (the constraint cache then re-proves only the
        # assertions whose expressions actually changed).
        self._skeletons: set = set()
        # exact (family, cfg, prob, bug) keys whose program was ever
        # requested — a program-memo hit for an *unseen* exact key is a
        # trace skip enabled purely by the family's trace_fields
        # projection (dict as FIFO-bounded ordered set)
        self._trace_seen: Dict[tuple, None] = {}
        self.verify_calls = 0
        self.result_hits = 0
        self.program_hits = 0
        self.full_builds = 0
        self.skeleton_rebinds = 0
        self.trace_skips = 0
        # per-stage wall-clock (µs): where verification time actually
        # goes.  "analysis" excludes the solver time accrued inside
        # Analyzer.run (tracked separately on the constraint cache), so
        # the four numbers partition a verify call's wall time.
        self.wall_us: Dict[str, int] = {"structural": 0, "build": 0,
                                        "analysis": 0}

    def _program(self, fam, family: str, cfg, prob, inject_bug):
        """Incremental program build: exact-trace memo first (keyed on
        the family's ``trace_fields`` projection of the config when it
        declares one — configs differing only in trace-irrelevant knobs
        share one traced program), then trace and intern the structural
        skeleton for the accounting above."""
        tf = fam.trace_fields
        cfg_key = (tuple(getattr(cfg, f) for f in tf)
                   if tf is not None else cfg)
        key = (family, cfg_key, prob, inject_bug)
        exact = (family, cfg, prob, inject_bug)
        if self.use_cache:
            prog = self._programs.get(key)
            if prog is not None:
                self.program_hits += 1
                if tf is not None and exact not in self._trace_seen:
                    self.trace_skips += 1
                    self._mark_seen(exact)
                return prog
        prog = fam.build_program(cfg, prob, inject_bug=inject_bug)
        self._mark_seen(exact)
        sig = (family, prob, inject_bug, prog.structure_sig())
        if sig in self._skeletons:
            self.skeleton_rebinds += 1
        else:
            self.full_builds += 1
            self._skeletons.add(sig)
        if self.use_cache:
            if len(self._programs) >= self.MAX_PROGRAMS:
                self._programs.pop(next(iter(self._programs)))
            self._programs[key] = prog
        return prog

    def _mark_seen(self, exact: tuple) -> None:
        if len(self._trace_seen) >= self.MAX_PROGRAMS:
            self._trace_seen.pop(next(iter(self._trace_seen)))
        self._trace_seen[exact] = None

    # -- the single entry point ---------------------------------------------
    def verify(self, family: str, cfg, prob, *,
               inject_bug: Optional[str] = None) -> EngineResult:
        self.verify_calls += 1
        key = (family, cfg, prob, inject_bug)
        if self.use_cache:
            hit = self._results.get(key)
            if hit is not None:
                self.result_hits += 1
                return dataclasses.replace(hit, cached=True)
        fam = get_family(family)
        clk = time.perf_counter

        # stage 1 — structural obligations (no program build needed)
        t0 = clk()
        with _obs.span("verify.structural"):
            structural = list(fam.structural(cfg, prob))
        self.wall_us["structural"] += int((clk() - t0) * 1e6)
        feedback = [
            Feedback("structural", f"{s.kind}", False, detail=s.message,
                     repair_hint=_STRUCT_HINTS.get(s.kind, ""))
            for s in structural]

        # stage 2 — build + tag propagation; stage 3 — cached discharge
        report: Optional[CheckReport] = None
        build_error: Optional[str] = None
        t0 = clk()
        try:
            with _obs.span("verify.build"):
                prog = self._program(fam, family, cfg, prob, inject_bug)
        except Exception as e:
            self.wall_us["build"] += int((clk() - t0) * 1e6)
            build_error = str(e)
            feedback.append(Feedback(
                "build", f"{family}.build_program", False, detail=str(e),
                repair_hint="the config is invalid for this problem — "
                            "pick knob values satisfying the family's "
                            "divisibility/shape preconditions"))
        else:
            self.wall_us["build"] += int((clk() - t0) * 1e6)
            discharger = (CachingDischarger(self.constraints)
                          if self.use_cache else Discharger())
            sol0 = self.constraints.solver_wall_us
            t0 = clk()
            with _obs.span("verify.analysis"):
                report = Analyzer(prog, discharger=discharger).run()
            # propagation time only: solver thunks inside the run are
            # accounted under wall_solver_us (cached engines; the
            # uncached Discharger's solver time stays in "analysis")
            self.wall_us["analysis"] += max(0, int(
                (clk() - t0) * 1e6)
                - (self.constraints.solver_wall_us - sol0))
            for label, res in report.results:
                feedback.append(Feedback(
                    _stage_of(res), label, res.ok,
                    counterexample=res.counterexample,
                    repair_hint=repair_hint_for(label, res),
                    detail=res.note))

        out = EngineResult(report, structural, feedback=feedback,
                           build_error=build_error, family=family)
        if self.use_cache:
            if len(self._results) >= self.MAX_RESULTS:
                self._results.pop(next(iter(self._results)))
            self._results[key] = out
        return out

    # -- accounting ----------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        c = self.constraints
        return {
            "verify_calls": self.verify_calls,
            "result_hits": self.result_hits,
            "program_hits": self.program_hits,
            "full_builds": self.full_builds,
            "skeleton_rebinds": self.skeleton_rebinds,
            "trace_skips": self.trace_skips,
            "constraint_lookups": c.lookups,
            "constraint_hits": c.hits,
            "canonical_hits": c.canonical_hits,
            "persisted_hits": c.persisted_hits,
            "solver_discharges": c.misses,
            "cached_constraints": len(c),
            "wall_structural_us": self.wall_us["structural"],
            "wall_build_us": self.wall_us["build"],
            "wall_analysis_us": self.wall_us["analysis"],
            "wall_solver_us": c.solver_wall_us,
        }

    def reset_stats(self) -> None:
        self.verify_calls = 0
        self.result_hits = 0
        self.program_hits = 0
        self.full_builds = 0
        self.skeleton_rebinds = 0
        self.trace_skips = 0
        self.wall_us = {"structural": 0, "build": 0, "analysis": 0}
        c = self.constraints
        c.lookups = c.hits = c.misses = 0
        c.persisted_hits = c.canonical_hits = 0
        c.solver_wall_us = 0

    def drop_results(self) -> None:
        """Forget memoized EngineResults (but keep traced programs and
        the constraint memo) — what a fresh process attached to warm
        caches looks like; tests and benchmarks use it to exercise the
        incremental re-verification path."""
        self._results.clear()


def merge_stats(stats_seq) -> Dict[str, int]:
    """Aggregate ``stats()`` dicts across engines — e.g. across the fleet
    tuner's worker processes (each journal record carries its item's
    per-run stat deltas).  Counters sum; the ``cached_constraints`` gauge
    takes the max (it measures one engine's live memo, not work done)."""
    out: Dict[str, int] = {}
    for s in stats_seq:
        for k, v in s.items():
            if k == "cached_constraints":
                out[k] = max(out.get(k, 0), v)
            else:
                out[k] = out.get(k, 0) + v
    return out


_STRUCT_HINTS = {
    "smem": "shrink the CTA tile until its staged chunks fit the 227 KB "
            "of shared memory a block may use",
    "registers": "shrink the CTA tile until its f32 accumulator fits the "
                 "255 registers of a thread",
    "grain": "pick tile rows, columns and K block that are multiples of "
             "the CTA tile and of the 32-deep K chunk",
    "alignment": "keep operand rows and block starts 16-byte aligned (k, "
                 "n, bk, bn multiples of 16 bytes) for cp.async copies",
    "cta_split": "a tile beyond one CTA runs on several; grow it only for "
                 "the L2 reuse of its operand panels",
    "masking": "declare the non-divisible dim masked or pick a divisible "
               "block size",
    "unsupported": "the CUDA kernel is not compiled for this geometry "
                   "(head_dim, group or page size): its wrapper raises "
                   "before any launch",
}


# Module-level engine shared by the validated kernel entry points
# (repro_torch.kernels.*.ops) — their configs repeat across calls, so the
# result memo makes a repeat verdict free.
_DEFAULT: Optional[VerificationEngine] = None


def default_engine() -> VerificationEngine:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = VerificationEngine()
    return _DEFAULT
