"""The ARGUS tile DSL — tile programs as a small, analyzable IR.

A :class:`TileProgram` models one kernel at the level ARGUS reasons about
(paper §4): a bounded grid of steps, tensors in device memory with *tag
functions*, tiles staged into shared memory via affine loads, compute ops,
stores, and explicit *tag assertions*.  Each kernel family in
:mod:`repro_torch.core.families` describes what one CUDA thread block
(CTA) of its kernel does in this IR, so that the kernel's tiling and grid
are validated by the same machinery as hand-written DSL programs.

Granularity note: the paper's tag domain ranges over threads; the
programs here are tile-granular, so tags range over ``(grid step,
tile-local logical coordinate)``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from .tags import BOT, TOP, Expr, TagValue, Var, make_tag

TagFn = Callable[..., TagValue]  # coord Exprs -> TagValue


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------

@dataclass
class GridAxis:
    """One grid dimension.  "parallel" axes may be freely reordered /
    distributed (on the card: independent CTAs); "arbitrary" axes are
    sequential (reduction / carry: a loop inside one CTA)."""

    name: str
    extent: int
    semantics: str = "parallel"  # "parallel" | "arbitrary"

    def __post_init__(self):
        if self.semantics not in ("parallel", "arbitrary"):
            raise ValueError(f"bad semantics {self.semantics!r}")


@dataclass
class TensorDecl:
    """A device-memory-resident operand/result with an optional tag function."""

    name: str
    shape: Tuple[int, ...]
    dtype: str = "bf16"
    tag_fn: Optional[TagFn] = None
    kind: str = "input"  # "input" | "output"


@dataclass
class TileVal:
    """A shared-memory/register tile value (SSA name + static shape)."""

    name: str
    shape: Tuple[int, ...]
    dtype: str = "bf16"


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

@dataclass
class Op:
    label: str = field(default="", init=False)


@dataclass
class Load(Op):
    """dst[l...] = src[origin + l]  (affine block load, BlockSpec-style)."""

    dst: TileVal
    src: str                      # tensor name
    origin: Tuple[Expr, ...]      # per-dim origin, Exprs over grid vars


@dataclass
class Store(Op):
    """dst[origin + l] = src[l...]  (block store)."""

    dst: str
    src: TileVal
    origin: Tuple[Expr, ...]


@dataclass
class AllocScratch(Op):
    """Shared-memory/register scratch carried across grid steps (accumulators, staging)."""

    dst: TileVal
    zero_init: bool = True


@dataclass
class ResetTags(Op):
    """Reset a scratch buffer's tags to ⊥ (paper §5: safe segment reuse)."""

    buf: TileVal


@dataclass
class Elementwise(Op):
    """dst = fn(srcs...) pointwise; tags merge (constants are ⊥)."""

    dst: TileVal
    srcs: Tuple[TileVal, ...]
    fn: str = "map"
    retag: Optional[TagFn] = None


@dataclass
class Matmul(Op):
    """dst[i,j] (+)= sum_k a[i,k] * b[k,j]   — the tensor-core contraction.

    ``retag`` names the semantics of the product (paper: T_rS for S=QKᵀ);
    without it the result is ⊤ (must be re-tagged before downstream
    conformity assertions — deliberate, keeps the analysis sound).
    """

    dst: TileVal
    a: TileVal
    b: TileVal
    accumulate: bool = False
    retag: Optional[TagFn] = None


@dataclass
class Reduce(Op):
    """dst = reduce(src, axis). Tag keeps components independent of the
    reduced axis; otherwise degrades to ⊤."""

    dst: TileVal
    src: TileVal
    axis: int
    kind: str = "sum"
    retag: Optional[TagFn] = None


@dataclass
class Transpose(Op):
    """dst = permute(src, perm); tags follow the permutation."""

    dst: TileVal
    src: TileVal
    perm: Tuple[int, ...]


@dataclass
class Squeeze(Op):
    """dst = src with unit dims removed (rank-N block -> compute tile).
    ``keep`` lists dims preserved even when unit (e.g. the m=1 row of a
    decode matmul)."""

    dst: TileVal
    src: TileVal
    keep: Tuple[int, ...] = ()


@dataclass
class GatherRows(Op):
    """dst[r, c] = src[row_map(r), c] — data-dependent row gather through an
    uninterpreted index table (MoE dispatch: rows of the sorted/padded token
    buffer).  ``row_expr`` is the absolute routed-row expression over grid
    vars + the tile-local row var passed to it.  ``retag`` declares the
    gathered tile's semantics (e.g. adds the block's expert-group tag)."""

    dst: TileVal
    src: str
    row_expr: "object"            # Callable[[Expr], Expr]
    col_origin: Expr
    retag: Optional[TagFn] = None


@dataclass
class ScatterRows(Op):
    """dst[row_map(r), c] = src[r, c] — data-dependent row scatter (MoE
    combine).  ``conform_component`` asserts that the named tag component of
    ``src`` equals the scatter row expression — the dispatch/combine identity
    invariant (gathered element returns to *its own* routed slot)."""

    dst: str
    src: TileVal
    row_expr: "object"
    col_origin: Expr
    conform_component: Optional[int] = None


@dataclass
class AssertConform(Op):
    """Conformity: paired elements of two tiles must carry matching tags.

    ``bind`` identifies tile dims: e.g. for C=A·B, bind=((1, 0),) pairs
    A's contraction dim with B's.  Unbound dims iterate independently.
    ``components`` optionally restricts which tag tuple components are
    compared ((lhs_idx...), (rhs_idx...)).
    """

    a: TileVal
    b: TileVal
    bind: Tuple[Tuple[int, int], ...]
    components: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None


@dataclass
class AssertNonConform(Op):
    """Non-conformity: paired elements must carry *different* tags
    (separation constraint, e.g. concurrent producers)."""

    a: TileVal
    b: TileVal
    bind: Tuple[Tuple[int, int], ...] = ()


@dataclass
class AssertStable(Op):
    """Accumulator-consistency: a tile's tag must not depend on the given
    grid axis (reading it back across that axis is then well-defined)."""

    tile: TileVal
    axis: str  # grid axis name


@dataclass
class AssertDisjointWrites(Op):
    """No-clobber: across the given (parallel) grid axes, block stores to
    ``tensor`` must hit disjoint regions."""

    tensor: str
    axes: Tuple[str, ...] = ()


@dataclass
class AssertCoverage(Op):
    """Completeness: the union of block stores to ``tensor`` covers every
    element (catches cdiv/grid-extent bugs)."""

    tensor: str


@dataclass
class AssertInjective(Op):
    """Reduction completeness / no-replay: an index expression must take
    distinct values across the named grid axes (e.g. stagger-K must consume
    each K block exactly once)."""

    expr: Expr
    axes: Tuple[str, ...]


@dataclass
class AssertInRange(Op):
    """Bounds obligation: an index expression must stay inside [0, extent)
    for every assignment — e.g. a physical page produced by a block table
    must land inside the KV pool.  Decided by pure interval arithmetic on
    the expression's normal form (:meth:`repro_torch.core.tags.Expr.range`), so a
    violation is caught at the analysis stage, before any solver search."""

    expr: Expr
    extent: int
    what: str = ""


# ---------------------------------------------------------------------------
# Program builder
# ---------------------------------------------------------------------------

class TileProgram:
    """A traced tile program.  Build with the fluent helpers below, then run
    :func:`repro_torch.core.analysis.check` to validate all assertions."""

    def __init__(self, name: str):
        self.name = name
        self.grid: List[GridAxis] = []
        self.tensors: Dict[str, TensorDecl] = {}
        self.ops: List[Op] = []
        self._grid_vars: Dict[str, Var] = {}
        self._tile_ctr = itertools.count()

    # -- declarations --------------------------------------------------------
    def add_grid(self, name: str, extent: int,
                 semantics: str = "parallel") -> Var:
        if name in self._grid_vars:
            raise ValueError(f"duplicate grid axis {name}")
        ax = GridAxis(name, int(extent), semantics)
        self.grid.append(ax)
        v = Var(f"g_{name}", int(extent))
        self._grid_vars[name] = v
        return v

    def grid_var(self, name: str) -> Var:
        return self._grid_vars[name]

    def tensor(self, name: str, shape: Sequence[int], dtype: str = "bf16",
               tag_fn: Optional[TagFn] = None,
               kind: str = "input") -> TensorDecl:
        d = TensorDecl(name, tuple(int(s) for s in shape), dtype, tag_fn, kind)
        self.tensors[name] = d
        return d

    def _fresh_tile(self, prefix: str, shape: Sequence[int],
                    dtype: str) -> TileVal:
        return TileVal(f"{prefix}{next(self._tile_ctr)}",
                       tuple(int(s) for s in shape), dtype)

    def _push(self, op: Op, label: str) -> Op:
        op.label = f"{self.name}[{len(self.ops)}]:{label}"
        self.ops.append(op)
        return op

    # -- op helpers ------------------------------------------------------------
    def load(self, src: str, origin: Sequence[Union[Expr, Var, int]],
             shape: Sequence[int], dtype: Optional[str] = None) -> TileVal:
        decl = self.tensors[src]
        if len(origin) != len(decl.shape) or len(shape) != len(decl.shape):
            raise ValueError(f"load rank mismatch for {src}")
        t = self._fresh_tile(f"t_{src}_", shape, dtype or decl.dtype)
        self._push(Load(t, src, tuple(Expr.of(o) for o in origin)),
                   f"load {src}")
        return t

    def store(self, dst: str, src: TileVal,
              origin: Sequence[Union[Expr, Var, int]]) -> None:
        decl = self.tensors[dst]
        if len(origin) != len(decl.shape):
            raise ValueError(f"store rank mismatch for {dst}")
        self._push(Store(dst, src, tuple(Expr.of(o) for o in origin)),
                   f"store {dst}")

    def alloc(self, shape: Sequence[int], dtype: str = "f32",
              zero_init: bool = True) -> TileVal:
        t = self._fresh_tile("s_", shape, dtype)
        self._push(AllocScratch(t, zero_init), f"alloc {t.name}")
        return t

    def reset_tags(self, buf: TileVal) -> None:
        self._push(ResetTags(buf), f"reset {buf.name}")

    def elementwise(self, fn: str, *srcs: TileVal,
                    retag: Optional[TagFn] = None) -> TileVal:
        t = self._fresh_tile("e_", srcs[0].shape, srcs[0].dtype)
        self._push(Elementwise(t, tuple(srcs), fn, retag), f"ew.{fn}")
        return t

    def update(self, buf: TileVal, *srcs: TileVal, fn: str = "update",
               retag: Optional[TagFn] = None) -> TileVal:
        """In-place update of a grid-carried scratch buffer, e.g. the online
        softmax running max/sum:  buf = fn(buf, srcs...)."""
        self._push(Elementwise(buf, tuple(srcs), fn, retag),
                   f"update.{fn} {buf.name}")
        return buf

    def matmul(self, a: TileVal, b: TileVal, *, accumulate: bool = False,
               acc: Optional[TileVal] = None,
               retag: Optional[TagFn] = None) -> TileVal:
        if a.shape[-1] != b.shape[0]:
            raise ValueError(
                f"matmul contraction mismatch {a.shape} @ {b.shape}")
        out_shape = (a.shape[0], b.shape[1])
        t = acc if acc is not None else self._fresh_tile("mm_", out_shape,
                                                         "f32")
        if acc is not None and tuple(acc.shape) != out_shape:
            raise ValueError("accumulator shape mismatch")
        self._push(Matmul(t, a, b, accumulate, retag), "matmul")
        return t

    def transpose(self, src: TileVal, perm: Sequence[int] = (1, 0)) -> TileVal:
        shape = tuple(src.shape[p] for p in perm)
        t = self._fresh_tile("tr_", shape, src.dtype)
        self._push(Transpose(t, src, tuple(perm)), "transpose")
        return t

    def squeeze(self, src: TileVal, keep: Sequence[int] = ()) -> TileVal:
        shape = tuple(s for d, s in enumerate(src.shape)
                      if s != 1 or d in keep) or (1,)
        t = self._fresh_tile("sq_", shape, src.dtype)
        self._push(Squeeze(t, src, tuple(keep)), "squeeze")
        return t

    def gather_rows(self, src: str, row_expr, col_origin, n_rows: int,
                    n_cols: int, dtype: Optional[str] = None,
                    retag: Optional[TagFn] = None) -> TileVal:
        decl = self.tensors[src]
        t = self._fresh_tile(f"g_{src}_", (n_rows, n_cols),
                             dtype or decl.dtype)
        self._push(GatherRows(t, src, row_expr, Expr.of(col_origin), retag),
                   f"gather {src}")
        return t

    def scatter_rows(self, dst: str, src: TileVal, row_expr, col_origin,
                     conform_component: Optional[int] = None) -> None:
        self._push(ScatterRows(dst, src, row_expr, Expr.of(col_origin),
                               conform_component), f"scatter {dst}")

    def reduce(self, src: TileVal, axis: int, kind: str = "sum",
               retag: Optional[TagFn] = None) -> TileVal:
        shape = tuple(s for i, s in enumerate(src.shape) if i != axis)
        t = self._fresh_tile("r_", shape or (1,), src.dtype)
        self._push(Reduce(t, src, axis, kind, retag), f"reduce.{kind}")
        return t

    # -- assertions -------------------------------------------------------------
    def assert_conform(self, a: TileVal, b: TileVal,
                       bind: Sequence[Tuple[int, int]],
                       components=None) -> None:
        self._push(AssertConform(a, b, tuple(bind), components),
                   f"assert_conform({a.name},{b.name})")

    def assert_contraction(self, a: TileVal, b: TileVal,
                           components=None) -> None:
        """Conformity for C=A·B: pair A's dim -1 with B's dim 0."""
        self.assert_conform(a, b, [(len(a.shape) - 1, 0)],
                            components=components)

    def assert_nonconform(self, a: TileVal, b: TileVal,
                          bind: Sequence[Tuple[int, int]] = ()) -> None:
        self._push(AssertNonConform(a, b, tuple(bind)),
                   f"assert_nonconform({a.name},{b.name})")

    def assert_stable(self, tile: TileVal, axis: str) -> None:
        self._push(AssertStable(tile, axis), f"assert_stable({tile.name})")

    def assert_disjoint_writes(self, tensor: str,
                               axes: Sequence[str] = ()) -> None:
        self._push(AssertDisjointWrites(tensor, tuple(axes)),
                   f"assert_disjoint({tensor})")

    def assert_coverage(self, tensor: str) -> None:
        self._push(AssertCoverage(tensor), f"assert_coverage({tensor})")

    def assert_injective(self, expr, axes: Sequence[str]) -> None:
        self._push(AssertInjective(Expr.of(expr), tuple(axes)),
                   f"assert_injective({','.join(axes)})")

    def assert_in_range(self, expr, extent: int, what: str = "") -> None:
        self._push(AssertInRange(Expr.of(expr), int(extent), what),
                   f"assert_in_range({what or 'index'})")

    # -- info ---------------------------------------------------------------------
    def structure_sig(self) -> tuple:
        """Config-independent structural signature of the trace: grid axis
        names/semantics, tensor names/kinds/ranks, and the op sequence
        (op types + stable label suffixes — tile naming is deterministic
        per trace, so congruent traces agree on it).  Extents, tile
        shapes and the Exprs bound into origins/assertions are *excluded*:
        two traces sharing a signature differ only in re-bound
        config-dependent values, which is what lets
        :class:`repro_torch.core.verify_engine.VerificationEngine` count the
        second trace as a skeleton re-bind rather than a full rebuild."""
        grid = tuple((a.name, a.semantics) for a in self.grid)
        tensors = tuple((n, d.kind, len(d.shape))
                        for n, d in self.tensors.items())
        # label format is "<name>[<op idx>]:<suffix>"; the suffix is the
        # config-independent part (the program name embeds the config)
        ops = tuple((type(op).__name__, op.label.partition("]:")[2])
                    for op in self.ops)
        return (grid, tensors, ops)

    def grid_extent(self) -> int:
        out = 1
        for ax in self.grid:
            out *= ax.extent
        return out

    def __repr__(self) -> str:
        lines = [f"TileProgram({self.name}) grid="
                 + "×".join(f"{a.name}:{a.extent}({a.semantics[0]})"
                            for a in self.grid)]
        for op in self.ops:
            lines.append(f"  {op.label}")
        return "\n".join(lines)
