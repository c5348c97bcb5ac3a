"""Flow-sensitive, path-insensitive tag propagation over tile programs.

This is the paper's §5 compiler analysis, adapted to the tile IR of
:mod:`repro_torch.core.dsl`:

* tags propagate through loads by *composing the tensor's tag function with
  the affine access* (origin + local coordinate);
* elementwise ops merge operand tags on the ⊥ < t < ⊤ lattice;
* scratch buffers carried across sequential ("arbitrary") grid axes merge
  their stores across iterations — a carried tag that depends on the carried
  axis collapses to ⊤ unless the buffer is reset each step (paper §5's
  shared-memory segment reuse);
* assertions are discharged through a pluggable :class:`Discharger` (by
  default straight into :mod:`repro_torch.core.solver`), yielding concrete
  counterexamples on violation.  The staged engine in
  :mod:`repro_torch.core.verify_engine` substitutes a caching discharger that
  memoizes verdicts on the canonical normal form of each assertion's
  difference expressions — re-verifying a mutated config then only
  re-proves the assertions whose tag expressions actually changed.

Variable naming is deterministic *per analyzer run* (an instance counter,
not a process-global one): analyzing the same program twice produces
syntactically identical constraint expressions, which is what makes the
normal-form memoization sound and effective.

Zero runtime overhead: everything here happens before any compilation of the
actual kernel; tags never materialize at runtime.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from math import prod
from typing import Dict, List, Optional, Sequence, Tuple

from . import dsl
from .solver import (Counterexample, ProofResult, Status, prove_injective,
                     prove_tags_distinct, prove_tags_equal, prove_zero)
from .tags import BOT, TOP, Expr, TagValue, Var, tag_subs, tag_vars


@dataclass
class TileState:
    """Abstract state of one tile value: its tag as a function of fresh
    per-dimension local coordinate variables (plus grid variables)."""

    local_vars: Tuple[Var, ...]
    tag: TagValue


@dataclass
class WriteDesc:
    origin: Tuple[Expr, ...]
    shape: Tuple[int, ...]
    tag: TagValue
    label: str


@dataclass
class CheckReport:
    program: str
    results: List[Tuple[str, ProofResult]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(r.ok for _, r in self.results)

    @property
    def violations(self) -> List[Tuple[str, ProofResult]]:
        return [(l, r) for l, r in self.results if not r.ok]

    def render(self) -> str:
        lines = [f"ARGUS invariant report for {self.program}: "
                 f"{len(self.results)} assertions, "
                 f"{len(self.violations)} violations"]
        for label, r in self.results:
            if r.ok:
                lines.append(f"  PASS {label} [{r.note or r.status.value}]")
            elif r.counterexample is not None:
                lines.append(f"  FAIL {label}")
                lines.append(f"       {r.counterexample.render()}")
            else:
                lines.append(f"  FAIL {label} [{r.status.value}: {r.note}]")
        return "\n".join(lines)


class Discharger:
    """Proof-obligation sink.  The default implementation forwards every
    obligation straight to the solver; :mod:`repro_torch.core.verify_engine`
    substitutes a caching one."""

    def tags_equal(self, lhs: TagValue, rhs: TagValue, *,
                   program_point: str = "") -> ProofResult:
        return prove_tags_equal(lhs, rhs, program_point=program_point)

    def tags_distinct(self, lhs: TagValue, rhs: TagValue, *,
                      program_point: str = "") -> ProofResult:
        return prove_tags_distinct(lhs, rhs, program_point=program_point)

    def zero(self, diffs: Sequence[Expr], *,
             program_point: str = "") -> ProofResult:
        return prove_zero(diffs, program_point=program_point)

    def injective(self, expr: Expr, over: Sequence[Var], *,
                  program_point: str = "") -> ProofResult:
        return prove_injective(expr, over, program_point=program_point)

    def check_block(self, kind: str, key: tuple, thunk) -> ProofResult:
        """Write-set obligations (disjointness / coverage).  ``key`` is a
        hashable canonical description of everything the verdict depends
        on; the default discharger ignores it and just runs the check."""
        return thunk()


class Analyzer:
    """One-pass abstract interpreter over a :class:`dsl.TileProgram`."""

    def __init__(self, prog: dsl.TileProgram,
                 discharger: Optional[Discharger] = None):
        self.prog = prog
        self.solve = discharger or Discharger()
        self.state: Dict[str, TileState] = {}
        self.scratch: Dict[str, bool] = {}       # tile name -> reset-per-step?
        self.writes: Dict[str, List[WriteDesc]] = {}
        self.report = CheckReport(prog.name)
        self._arb_axes = {prog.grid_var(a.name) for a in prog.grid
                          if a.semantics == "arbitrary"}
        self._axis_var = {a.name: prog.grid_var(a.name) for a in prog.grid}
        # deterministic per-run naming: same program -> same constraint
        # expressions (the cache-key property; see module docstring)
        self._ctr = itertools.count()

    # -- helpers -------------------------------------------------------------
    def _fresh_locals(self, shape: Sequence[int],
                      tag_name: str) -> Tuple[Var, ...]:
        n = next(self._ctr)
        return tuple(Var(f"l{n}_{tag_name}_{d}", int(s))
                     for d, s in enumerate(shape))

    def _default_tag(self, decl: dsl.TensorDecl,
                     coords: Sequence[Expr]) -> TagValue:
        if decl.tag_fn is not None:
            return decl.tag_fn(*coords)
        # default: identity tag — the element's global logical coordinates
        return tuple(coords)

    def _carry_filter(self, tile: dsl.TileVal, tag: TagValue) -> TagValue:
        """Cross-iteration fixpoint for grid-carried scratch: a stored tag
        depending on a sequential axis merges to ⊤ across iterations unless
        the buffer is reset per step."""
        if tile.name not in self.scratch or tag is BOT or tag is TOP:
            return tag
        if self.scratch[tile.name]:  # reset-per-step: per-iteration identity
            return tag
        if set(tag_vars(tag)) & self._arb_axes:
            return TOP
        return tag

    def _tile_state(self, tile: dsl.TileVal) -> TileState:
        st = self.state.get(tile.name)
        if st is None:
            raise KeyError(f"tile {tile.name} has no abstract state "
                           f"(use before def?)")
        return st

    def _retag_state(self, tile: dsl.TileVal, retag, fallback: TagValue
                     ) -> TileState:
        lv = self._fresh_locals(tile.shape, tile.name)
        if retag is not None:
            return TileState(lv, retag(*lv))
        return TileState(lv, fallback)

    def _grid_sig(self) -> tuple:
        """Cache-key view of the grid: the axis *Vars* (name + extent)
        plus semantics.  Keying on Vars rather than bare names lets the
        engine's alpha-renaming canonicalizer share write-set verdicts
        across families whose grids are congruent up to naming."""
        return tuple((self.prog.grid_var(a.name), a.semantics)
                     for a in self.prog.grid)

    # -- interpretation ----------------------------------------------------------
    def run(self) -> CheckReport:
        for op in self.prog.ops:
            handler = getattr(self, f"_op_{type(op).__name__}", None)
            if handler is None:
                raise NotImplementedError(f"no handler for {type(op)}")
            handler(op)
        return self.report

    def _op_Load(self, op: dsl.Load) -> None:
        decl = self.prog.tensors[op.src]
        lv = self._fresh_locals(op.dst.shape, op.dst.name)
        # unit-extent block dims contribute a constant 0 local coordinate —
        # keeps proofs symbolic instead of enumerating extent-1 vars.
        coords = tuple(
            op.origin[d] + (lv[d] if op.dst.shape[d] > 1 else 0)
            for d in range(len(lv)))
        self.state[op.dst.name] = TileState(lv, self._default_tag(decl,
                                                                  coords))

    def _op_Squeeze(self, op: dsl.Squeeze) -> None:
        src_st = self._tile_state(op.src)
        lv = self._fresh_locals(op.dst.shape, op.dst.name)
        sub: Dict[Var, object] = {}
        it = iter(lv)
        for d, s in enumerate(op.src.shape):
            if s == 1 and d not in op.keep:
                sub[src_st.local_vars[d]] = Expr.of(0)
            else:
                sub[src_st.local_vars[d]] = next(it)
        self.state[op.dst.name] = TileState(lv, tag_subs(src_st.tag, sub))

    def _op_Store(self, op: dsl.Store) -> None:
        st = self._tile_state(op.src)
        decl = self.prog.tensors[op.dst]
        # a lower-rank tile stored into a higher-rank tensor occupies unit
        # extents on the leading dims (e.g. a (bq, d) tile into (B,H,S,d))
        pad = len(decl.shape) - len(op.src.shape)
        shape = (1,) * pad + tuple(op.src.shape)
        self.writes.setdefault(op.dst, []).append(
            WriteDesc(op.origin, shape, st.tag, op.label))

    def _op_AllocScratch(self, op: dsl.AllocScratch) -> None:
        lv = self._fresh_locals(op.dst.shape, op.dst.name)
        self.state[op.dst.name] = TileState(
            lv, BOT if op.zero_init else TOP)
        self.scratch[op.dst.name] = False

    def _op_ResetTags(self, op: dsl.ResetTags) -> None:
        st = self._tile_state(op.buf)
        self.state[op.buf.name] = TileState(st.local_vars, BOT)
        self.scratch[op.buf.name] = True  # per-step identity from here on

    def _op_Elementwise(self, op: dsl.Elementwise) -> None:
        from .tags import merge
        lv = self._fresh_locals(op.dst.shape, op.dst.name)
        is_scratch_update = op.dst.name in self.scratch
        if op.retag is not None:
            tag: TagValue = op.retag(*lv)
        else:
            tag = BOT
            for s in op.srcs:
                st = self._tile_state(s)
                if tuple(s.shape) != tuple(op.dst.shape):
                    raise ValueError("elementwise shape mismatch")
                tag = merge(tag, tag_subs(st.tag,
                                          dict(zip(st.local_vars, lv))))
        if is_scratch_update:
            old = self.state[op.dst.name]
            tag = merge(tag_subs(old.tag,
                                 dict(zip(old.local_vars, lv))), tag)
            tag = self._carry_filter(op.dst, tag)
        self.state[op.dst.name] = TileState(lv, tag)

    def _op_Matmul(self, op: dsl.Matmul) -> None:
        # contraction-pairing correctness is asserted explicitly via
        # AssertConform; here we only produce the result tag.
        st = self._retag_state(op.dst, op.retag, TOP)
        tag = st.tag
        if op.accumulate and op.dst.name in self.state:
            # merging into a carried accumulator
            old = self.state[op.dst.name]
            from .tags import merge
            tag = merge(tag_subs(old.tag,
                                 dict(zip(old.local_vars, st.local_vars))),
                        tag)
        tag = self._carry_filter(op.dst, tag)
        self.state[op.dst.name] = TileState(st.local_vars, tag)

    def _op_Reduce(self, op: dsl.Reduce) -> None:
        src_st = self._tile_state(op.src)
        lv = self._fresh_locals(op.dst.shape, op.dst.name)
        if op.retag is not None:
            self.state[op.dst.name] = TileState(lv, op.retag(*lv))
            return
        keep = [v for i, v in enumerate(src_st.local_vars) if i != op.axis]
        red_var = src_st.local_vars[op.axis]
        tag = src_st.tag
        if tag is BOT or tag is TOP:
            self.state[op.dst.name] = TileState(lv, tag)
            return
        if any(red_var in e.vars() for e in tag):
            # tag varies along the reduced axis -> merged to ⊤ (paper lattice)
            self.state[op.dst.name] = TileState(lv, TOP)
            return
        sub = dict(zip(keep, lv))
        self.state[op.dst.name] = TileState(lv, tag_subs(tag, sub))

    def _op_Transpose(self, op: dsl.Transpose) -> None:
        src_st = self._tile_state(op.src)
        lv = self._fresh_locals(op.dst.shape, op.dst.name)
        # dst[l] = src[l permuted back]: dst local d corresponds to src dim
        # perm[d], so substitute src var perm[d] -> lv[d].
        sub = {src_st.local_vars[p]: lv[d] for d, p in enumerate(op.perm)}
        self.state[op.dst.name] = TileState(lv, tag_subs(src_st.tag, sub))

    def _op_GatherRows(self, op: dsl.GatherRows) -> None:
        decl = self.prog.tensors[op.src]
        lv = self._fresh_locals(op.dst.shape, op.dst.name)
        if op.retag is not None:
            self.state[op.dst.name] = TileState(lv, op.retag(*lv))
            return
        row = op.row_expr(lv[0])
        col = op.col_origin + (lv[1] if op.dst.shape[1] > 1 else 0)
        coords = (row, col)
        self.state[op.dst.name] = TileState(lv, self._default_tag(decl,
                                                                  coords))

    def _op_ScatterRows(self, op: dsl.ScatterRows) -> None:
        st = self._tile_state(op.src)
        if op.conform_component is not None:
            # dispatch/combine identity: the element's routed-row tag must
            # equal the row it is scattered back to.
            if st.tag is TOP:
                res = ProofResult(
                    Status.VIOLATED,
                    Counterexample({}, TOP, None,
                                   detail="⊤ reached combine scatter",
                                   program_point=op.label),
                    stage="analysis")
            elif st.tag is BOT:
                res = self.solve.tags_equal(st.tag, st.tag,
                                            program_point=op.label)
            else:
                lhs = (st.tag[op.conform_component],)
                rhs = (op.row_expr(st.local_vars[0]),)
                res = self.solve.tags_equal(lhs, rhs,
                                            program_point=op.label)
            self.report.results.append((op.label, res))
        # record the write (non-affine rows: coverage/disjointness of the
        # scatter is a runtime precondition of the routing tables, validated
        # by the kernel's unit tests — DESIGN.md §4)
        self.writes.setdefault(op.dst, []).append(
            WriteDesc((op.row_expr(st.local_vars[0]), op.col_origin),
                      op.src.shape, st.tag, op.label))

    # -- assertions -----------------------------------------------------------
    def _op_AssertConform(self, op: dsl.AssertConform) -> None:
        res = self._conformity(op.a, op.b, op.bind, op.components)
        self.report.results.append((op.label, res))

    def _op_AssertNonConform(self, op: dsl.AssertNonConform) -> None:
        ta, tb = self._paired_tags(op.a, op.b, op.bind)
        res = self.solve.tags_distinct(ta, tb, program_point=op.label)
        self.report.results.append((op.label, res))

    def _paired_tags(self, a: dsl.TileVal, b: dsl.TileVal,
                     bind: Tuple[Tuple[int, int], ...]):
        sa, sb = self._tile_state(a), self._tile_state(b)
        env_a: Dict[Var, Var] = {}
        env_b: Dict[Var, Var] = {}
        for da, db in bind:
            ea, eb = a.shape[da], b.shape[db]
            if ea != eb:
                raise ValueError(
                    f"bound dims disagree: {a.name}[{da}]={ea} vs "
                    f"{b.name}[{db}]={eb}")
            shared = Var(f"k{next(self._ctr)}", ea)
            env_a[sa.local_vars[da]] = shared
            env_b[sb.local_vars[db]] = shared
        ta = tag_subs(sa.tag, env_a)
        tb = tag_subs(sb.tag, env_b)
        return ta, tb

    def _conformity(self, a, b, bind, components) -> ProofResult:
        ta, tb = self._paired_tags(a, b, bind)
        if components is not None and ta not in (BOT, TOP) \
                and tb not in (BOT, TOP):
            ca, cb = components
            ta = tuple(ta[i] for i in ca)
            tb = tuple(tb[i] for i in cb)
        return self.solve.tags_equal(ta, tb, program_point="conform")

    def _op_AssertStable(self, op: dsl.AssertStable) -> None:
        st = self._tile_state(op.tile)
        g = self._axis_var[op.axis]
        label = op.label
        if st.tag is TOP:
            self.report.results.append((label, ProofResult(
                Status.VIOLATED,
                Counterexample({}, TOP, None,
                               detail="⊤ accumulator (conflicting carries)",
                               program_point=label),
                stage="analysis")))
            return
        if st.tag is BOT or g not in set(tag_vars(st.tag)):
            self.report.results.append(
                (label, ProofResult(Status.PROVEN, note="axis-free",
                                    stage="analysis")))
            return
        g2 = Var(f"{g.name}__alt", g.extent)
        diffs = [e - e.subs({g: g2}) for e in st.tag]
        self.report.results.append(
            (label, self.solve.zero(diffs, program_point=label)))

    def _op_AssertDisjointWrites(self, op: dsl.AssertDisjointWrites) -> None:
        """Origin-lattice disjointness: enumerate the requested (parallel)
        axes, require (a) block origins distinct across steps and write
        sites, (b) origins lattice-aligned to the block shape, (c) origins
        constant along all *other* grid axes (the output-revisiting rule:
        a store that moves along a reduction axis clobbers partial data)."""
        label = op.label
        writes = self.writes.get(op.tensor, [])
        decl = self.prog.tensors[op.tensor]
        axes = op.axes or tuple(a.name for a in self.prog.grid
                                if a.semantics == "parallel")
        key = ("disjoint", tuple(decl.shape),
               tuple(self._axis_var[a] for a in axes), self._grid_sig(),
               tuple((w.origin, tuple(w.shape)) for w in writes))
        res = self.solve.check_block(
            "disjoint", key,
            lambda: self._disjoint_verdict(writes, decl, axes, label))
        self.report.results.append((label, res))

    def _disjoint_verdict(self, writes, decl, axes, label) -> ProofResult:
        if not writes:
            return ProofResult(
                Status.VIOLATED,
                Counterexample({}, None, None, detail="no writes recorded",
                               program_point=label))
        used: set = set()
        for w in writes:
            for o in w.origin:
                used.update(o.vars())
        # a parallel axis the origin ignores means every step of that axis
        # writes the same block — an immediate clobber
        for a in axes:
            v = self._axis_var[a]
            if v.extent > 1 and v not in used:
                return ProofResult(
                    Status.VIOLATED,
                    Counterexample({v: 0}, None, None,
                                   detail=f"parallel axis {a} does not "
                                          f"distinguish the write origin",
                                   program_point=label))
        over = [self._axis_var[a] for a in axes
                if self._axis_var[a] in used]
        others = [self._axis_var[a.name] for a in self.prog.grid
                  if a.name not in axes]
        # symbolic fast path (partition ⇒ disjoint) when the distinguishing
        # axes cover every var the origins mention
        if (len(writes) == 1 and used <= set(over)
                and _symbolic_partition(writes[0], decl.shape)):
            return ProofResult(Status.PROVEN, note="mixed-radix lattice")
        total = prod(v.extent for v in over) if over else 1
        if total > 200_000:
            return ProofResult(
                Status.UNKNOWN, note=f"axis domain too large ({total})")
        # (c) constancy along non-enumerated axes
        for w in writes:
            for g in others:
                if g.extent < 2:
                    continue
                env0 = {v: 0 for v in over + others}
                env1 = dict(env0)
                env1[g] = 1
                try:
                    o0 = tuple(o.evaluate(env0) for o in w.origin)
                    o1 = tuple(o.evaluate(env1) for o in w.origin)
                except KeyError:
                    o0, o1 = None, ()
                if o0 != o1:
                    return ProofResult(
                        Status.VIOLATED,
                        Counterexample(env1, o1, o0,
                                       detail=f"store origin varies along "
                                              f"sequential axis {g.name}",
                                       program_point=w.label))
        seen: Dict[tuple, tuple] = {}
        base_others = {v: 0 for v in others}
        for point in itertools.product(*[range(v.extent) for v in over]):
            env = dict(base_others)
            env.update(zip(over, point))
            for wi, w in enumerate(writes):
                org = tuple(o.evaluate(env) for o in w.origin)
                for o, b in zip(org, w.shape):
                    if o % b != 0:
                        return ProofResult(
                            Status.VIOLATED,
                            Counterexample(env, org, None,
                                           detail="origin not aligned to "
                                                  "block lattice",
                                           program_point=w.label))
                key = org
                if key in seen and seen[key] != (wi,) + point:
                    return ProofResult(
                        Status.VIOLATED,
                        Counterexample(env, key, seen[key],
                                       detail="two parallel steps write the "
                                              "same block",
                                       program_point=w.label))
                seen[key] = (wi,) + point
        return ProofResult(
            Status.PROVEN, note=f"{len(seen)} distinct block origins")

    def _op_AssertInRange(self, op: dsl.AssertInRange) -> None:
        """Interval obligation: decided by the Expr normal form's range
        bound alone — no probing, no enumeration.  This is deliberately a
        *lattice-level* verdict (stage "analysis" in the engine): an
        out-of-range indirection (e.g. a block table whose declared result
        range exceeds the physical pool) is rejected before any solver
        search could even start."""
        lo, hi = op.expr.range()
        if 0 <= lo and hi < op.extent:
            self.report.results.append((op.label, ProofResult(
                Status.PROVEN, stage="analysis",
                note=f"interval [{lo},{hi}] ⊆ [0,{op.extent})")))
            return
        # try to exhibit an honest point witness at the domain corners;
        # when none escapes (e.g. an uninterpreted table whose *declared*
        # range is the problem), report the interval itself — never an
        # assignment/value pair that does not actually evaluate to it
        env, bad = None, None
        vars_ = op.expr.vars()
        corners = [{v: 0 for v in vars_}, {v: v.extent - 1 for v in vars_}]
        for v in vars_:
            c = {w: 0 for w in vars_}
            c[v] = v.extent - 1
            corners.append(c)
        for cand in corners:
            try:
                val = op.expr.evaluate(cand)
            except KeyError:
                break
            if val < 0 or val >= op.extent:
                env, bad = cand, val
                break
        self.report.results.append((op.label, ProofResult(
            Status.VIOLATED,
            Counterexample(env or {}, bad if bad is not None
                           else f"range [{lo},{hi}]", f"[0,{op.extent})",
                           detail=f"interval [{lo},{hi}] escapes "
                                  f"[0,{op.extent}) — {op.what or 'index'} "
                                  f"out of range",
                           program_point=op.label),
            stage="analysis")))

    def _op_AssertInjective(self, op: dsl.AssertInjective) -> None:
        over = [self._axis_var[a] for a in op.axes]
        self.report.results.append(
            (op.label, self.solve.injective(op.expr, over,
                                            program_point=op.label)))

    def _op_AssertCoverage(self, op: dsl.AssertCoverage) -> None:
        label = op.label
        decl = self.prog.tensors[op.tensor]
        writes = self.writes.get(op.tensor, [])
        key = ("coverage", tuple(decl.shape), self._grid_sig(),
               tuple((w.origin, tuple(w.shape)) for w in writes))
        res = self.solve.check_block(
            "coverage", key,
            lambda: self._coverage_verdict(writes, decl, label))
        self.report.results.append((label, res))

    def _coverage_verdict(self, writes, decl, label) -> ProofResult:
        if not writes:
            return ProofResult(
                Status.VIOLATED,
                Counterexample({}, None, None, detail="no writes recorded",
                               program_point=label))
        # symbolic fast path: a single affine write site whose origins form
        # a contiguous mixed-radix lattice is a proven partition at any
        # grid size (tiny tiles × huge grids exceed any enumeration cap)
        if len(writes) == 1 and _symbolic_partition(writes[0],
                                                    decl.shape):
            return ProofResult(Status.PROVEN, note="mixed-radix lattice")
        # enumerate only grid vars the origins actually mention — reduction
        # axes with origin-constant stores would otherwise explode the box
        used: set = set()
        for w in writes:
            for o in w.origin:
                used.update(o.vars())
        gvars = [self._axis_var[a.name] for a in self.prog.grid
                 if self._axis_var[a.name] in used]
        total = prod(v.extent for v in gvars) if gvars else 1
        if total > 200_000:
            return ProofResult(
                Status.UNKNOWN, note=f"grid too large to enumerate ({total})")
        seen = set()
        shape0 = writes[0].shape
        for w in writes:
            if tuple(w.shape) != tuple(shape0):
                return ProofResult(Status.UNKNOWN, note="mixed block shapes")
        for point in itertools.product(*[range(v.extent) for v in gvars]):
            env = dict(zip(gvars, point))
            for w in writes:
                seen.add(tuple(o.evaluate(env) for o in w.origin))
        expected = set(itertools.product(*[
            tuple(range(0, dim, blk))
            for dim, blk in zip(decl.shape, shape0)]))
        missing = expected - seen
        if missing:
            miss = sorted(missing)[0]
            return ProofResult(
                Status.VIOLATED,
                Counterexample({}, sorted(seen)[:4], miss,
                               detail=f"{len(missing)} uncovered block(s), "
                                      f"first at origin {miss}",
                               program_point=label))
        extra = seen - expected
        if extra:
            return ProofResult(
                Status.VIOLATED,
                Counterexample({}, sorted(extra)[0], None,
                               detail="write outside block lattice",
                               program_point=label))
        return ProofResult(Status.PROVEN,
                           note=f"{len(expected)} blocks covered")


def _symbolic_partition(write: "WriteDesc", decl_shape: Sequence[int]
                        ) -> Optional[bool]:
    """Mixed-radix proof that one write site's block origins tile the
    output exactly once, for purely-linear origins (no atoms, no consts):
    per dim, sort coefficients ascending and require a contiguous radix
    (c₁ = block, c_{i+1} = c_i·extent_i, final reach = dim).  Exact for
    any grid size — no enumeration.  Returns True (proven partition),
    or None (inconclusive; fall back to enumeration)."""
    seen_vars: set = set()
    for d, (o, blk, dim) in enumerate(zip(write.origin, write.shape,
                                          decl_shape)):
        if o.const != 0:
            return None
        terms = []
        for a, c in o.terms:
            if not isinstance(a, Var) or c <= 0:
                return None
            if a in seen_vars:
                return None          # var reused across dims
            terms.append((c, a))
        for _, a in terms:
            seen_vars.add(a)
        terms.sort(key=lambda t: t[0])
        if not terms:
            if dim != blk:
                return None          # constant-0 origin must cover the dim
            continue
        if terms[0][0] != blk:
            return None
        reach = blk
        for i, (c, a) in enumerate(terms):
            if c != reach:
                return None
            reach = c * a.extent
        if reach != dim:
            return None
    return True


def _row_major_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    out: List[int] = []
    acc = 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def check(prog: dsl.TileProgram,
          discharger: Optional[Discharger] = None) -> CheckReport:
    """Validate every assertion in ``prog``; the entry point used by kernel
    specs, tests and the agentic validator.  ``discharger`` intercepts the
    proof obligations (see :class:`Discharger`)."""
    return Analyzer(prog, discharger=discharger).run()
