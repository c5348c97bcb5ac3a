"""Symbolic tags and the quasi-affine expression engine behind them.

ARGUS attaches *tags* — tuples of symbolic expressions over logical
coordinates — to tensor elements and propagates them through data movement
(paper §4).  This module provides:

* ``Expr``    — a normalized quasi-affine expression: a linear combination of
  *atoms* (variables, or opaque ``floordiv``/``mod``-by-constant nodes over
  inner expressions) plus an integer constant.  This is exactly the fragment
  the layout algebra emits: affine maps composed with mixed-radix wrapping.
* ``Var``     — a bounded symbolic variable (domain ``[0, extent)``), e.g. a
  grid index or a tile-local coordinate.
* ``Tag``     — ⊥ (constants), ⊤ (conflict), or a tuple of ``Expr``/int, with
  the paper's merge lattice  ⊥ < t < ⊤.

Normalization carries the weight of the "SMT" layer: correct kernels produce
tag expressions that normalize to syntactically identical forms, so equality
is decided symbolically.  The residual cases are discharged by the bounded
enumeration in :mod:`repro_torch.core.solver`.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# Atoms
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Var:
    """Bounded integer variable with domain [0, extent)."""

    name: str
    extent: int

    def __repr__(self) -> str:
        return self.name

    # convenience arithmetic – promote to Expr
    def __add__(self, o):
        return Expr.of(self) + o

    __radd__ = __add__

    def __mul__(self, o):
        return Expr.of(self) * o

    __rmul__ = __mul__

    def __sub__(self, o):
        return Expr.of(self) - o

    def __rsub__(self, o):
        return Expr.of(o) - self

    def __floordiv__(self, k):
        return Expr.of(self) // k

    def __mod__(self, k):
        return Expr.of(self) % k


@dataclass(frozen=True)
class OpAtom:
    """Opaque ``floordiv`` / ``mod`` node over a normalized inner Expr."""

    kind: str  # "floordiv" | "mod"
    inner: "Expr"
    k: int

    def __repr__(self) -> str:
        sym = "//" if self.kind == "floordiv" else "%"
        return f"({self.inner!r} {sym} {self.k})"


@dataclass(frozen=True)
class AppAtom:
    """Uninterpreted-function application ``name(inner)`` with a declared
    result range [0, extent).

    Models data-dependent indirection the compiler cannot evaluate — e.g.
    MoE's sorted token permutation or expert group map (paper §9.1: "expert
    assignments use sorted maps with indirection through token IDs").  Two
    applications are equal iff they apply the *same* table to provably equal
    arguments; for counterexample search the solver interprets tables with a
    deterministic pseudo-random injection (finite-model refutation).
    """

    name: str
    inner: "Expr"
    extent: int

    def __repr__(self) -> str:
        return f"{self.name}({self.inner!r})"


Atom = Union[Var, OpAtom, AppAtom]


def app(name: str, arg, extent: int) -> "Expr":
    """Apply an uninterpreted table to an argument expression."""
    return Expr({AppAtom(name, Expr.of(arg), int(extent)): 1}, 0)


# ---------------------------------------------------------------------------
# Expr — normalized linear combination over atoms
# ---------------------------------------------------------------------------


class Expr:
    """Normalized quasi-affine expression: ``const + Σ coeff_i · atom_i``."""

    __slots__ = ("terms", "const", "_hash")

    def __init__(self, terms: Mapping[Atom, int], const: int):
        clean = {a: c for a, c in terms.items() if c != 0}
        object.__setattr__(self, "terms", tuple(sorted(
            clean.items(), key=lambda kv: repr(kv[0]))))
        object.__setattr__(self, "const", int(const))
        object.__setattr__(self, "_hash", hash((self.terms, self.const)))

    # -- construction -------------------------------------------------------
    @staticmethod
    def of(x: Union[int, Var, "Expr"]) -> "Expr":
        if isinstance(x, Expr):
            return x
        if isinstance(x, Var):
            return Expr({x: 1}, 0)
        if isinstance(x, int):
            return Expr({}, x)
        raise TypeError(f"cannot build Expr from {type(x)}")

    @property
    def is_const(self) -> bool:
        return not self.terms

    def term_dict(self) -> Dict[Atom, int]:
        return dict(self.terms)

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, o) -> "Expr":
        o = Expr.of(o)
        t = self.term_dict()
        for a, c in o.terms:
            t[a] = t.get(a, 0) + c
        return Expr(t, self.const + o.const)

    __radd__ = __add__

    def __neg__(self) -> "Expr":
        return Expr({a: -c for a, c in self.terms}, -self.const)

    def __sub__(self, o) -> "Expr":
        return self + (-Expr.of(o))

    def __rsub__(self, o) -> "Expr":
        return Expr.of(o) - self

    def __mul__(self, k) -> "Expr":
        if isinstance(k, Expr):
            if k.is_const:
                k = k.const
            else:
                raise TypeError("Expr multiplication requires a constant")
        return Expr({a: c * k for a, c in self.terms}, self.const * k)

    __rmul__ = __mul__

    def __floordiv__(self, k: int) -> "Expr":
        return floordiv(self, k)

    def __mod__(self, k: int) -> "Expr":
        return mod(self, k)

    # -- comparison / hashing --------------------------------------------------
    def __eq__(self, o) -> bool:
        if isinstance(o, int):
            return self.is_const and self.const == o
        if not isinstance(o, Expr):
            return NotImplemented
        return self.terms == o.terms and self.const == o.const

    def __hash__(self) -> int:
        return self._hash

    # -- analysis ----------------------------------------------------------
    def range(self) -> Tuple[int, int]:
        """Inclusive interval bound of the expression's value."""
        lo = hi = self.const
        for a, c in self.terms:
            alo, ahi = _atom_range(a)
            if c >= 0:
                lo += c * alo
                hi += c * ahi
            else:
                lo += c * ahi
                hi += c * alo
        return lo, hi

    def vars(self) -> Tuple[Var, ...]:
        out: list = []
        seen = set()
        for a, _ in self.terms:
            for v in _atom_vars(a):
                if v not in seen:
                    seen.add(v)
                    out.append(v)
        return tuple(out)

    def evaluate(self, env: Mapping[Var, int]) -> int:
        total = self.const
        for a, c in self.terms:
            total += c * _atom_eval(a, env)
        return total

    def subs(self, env: Mapping[Var, Union[int, "Expr", Var]]) -> "Expr":
        """Substitute variables with expressions; re-normalizes."""
        total = Expr.of(self.const)
        for a, c in self.terms:
            total = total + _atom_subs(a, env) * c
        return total

    def __repr__(self) -> str:
        if not self.terms:
            return str(self.const)
        parts = []
        for a, c in self.terms:
            if c == 1:
                parts.append(f"{a!r}")
            else:
                parts.append(f"{c}*{a!r}")
        s = " + ".join(parts)
        if self.const:
            s += f" + {self.const}"
        return s


def _atom_range(a: Atom) -> Tuple[int, int]:
    if isinstance(a, Var):
        return 0, a.extent - 1
    if isinstance(a, AppAtom):
        return 0, a.extent - 1
    if a.kind == "mod":
        lo, hi = a.inner.range()
        if lo >= 0:
            return 0, min(hi, a.k - 1)
        return 0, a.k - 1
    # floordiv
    lo, hi = a.inner.range()
    return lo // a.k, hi // a.k


def _atom_vars(a: Atom) -> Tuple[Var, ...]:
    if isinstance(a, Var):
        return (a,)
    return a.inner.vars()


def _atom_eval(a: Atom, env: Mapping[Var, int]) -> int:
    if isinstance(a, Var):
        if a not in env:
            raise KeyError(f"unbound variable {a!r}")
        return env[a]
    if isinstance(a, AppAtom):
        # finite-model interpretation: a deterministic pseudo-random map —
        # distinguishes different tables and different arguments w.h.p.
        import zlib
        v = a.inner.evaluate(env)
        return zlib.crc32(f"{a.name}:{v}".encode()) % a.extent
    v = a.inner.evaluate(env)
    return v // a.k if a.kind == "floordiv" else v % a.k


def _atom_subs(a: Atom, env) -> Expr:
    if isinstance(a, Var):
        if a in env:
            return Expr.of(env[a])
        return Expr.of(a)
    if isinstance(a, AppAtom):
        return Expr({AppAtom(a.name, a.inner.subs(env), a.extent): 1}, 0)
    inner = a.inner.subs(env)
    return floordiv(inner, a.k) if a.kind == "floordiv" else mod(inner, a.k)


# ---------------------------------------------------------------------------
# Simplifying constructors for // and %
# ---------------------------------------------------------------------------


def _split_by_divisor(e: Expr, k: int) -> Tuple[Expr, Expr]:
    """Split e = k*q + r where q collects terms with coefficients divisible
    by k (including the matching part of the constant)."""
    q_terms: Dict[Atom, int] = {}
    r_terms: Dict[Atom, int] = {}
    for a, c in e.terms:
        if c % k == 0:
            q_terms[a] = c // k
        else:
            r_terms[a] = c
    q_const, r_const = divmod(e.const, k)
    return Expr(q_terms, q_const), Expr(r_terms, r_const)


def floordiv(e: Union[Expr, Var, int], k: int) -> Expr:
    e = Expr.of(e)
    if k <= 0:
        raise ValueError("floordiv by non-positive constant")
    if k == 1:
        return e
    if e.is_const:
        return Expr.of(e.const // k)
    q, r = _split_by_divisor(e, k)
    rlo, rhi = r.range()
    if 0 <= rlo and rhi < k:
        return q  # remainder can never carry
    if q.is_const and q.const == 0:
        # irreducible — opaque atom over the *original* expr
        return Expr({OpAtom("floordiv", e, k): 1}, 0)
    return q + Expr({OpAtom("floordiv", r, k): 1}, 0)


def mod(e: Union[Expr, Var, int], k: int) -> Expr:
    e = Expr.of(e)
    if k <= 0:
        raise ValueError("mod by non-positive constant")
    if k == 1:
        return Expr.of(0)
    if e.is_const:
        return Expr.of(e.const % k)
    _, r = _split_by_divisor(e, k)
    rlo, rhi = r.range()
    if 0 <= rlo and rhi < k:
        return r  # already reduced
    # mod of a single variable whose extent divides k is itself
    if len(r.terms) == 1 and r.const == 0:
        (a, c), = r.terms
        if c == 1 and isinstance(a, Var) and a.extent <= k:
            return r
        if c == 1 and isinstance(a, OpAtom) and a.kind == "mod" and a.k <= k:
            return r
    return Expr({OpAtom("mod", r, k): 1}, 0)


# ---------------------------------------------------------------------------
# Tags (paper §4/§5)
# ---------------------------------------------------------------------------


class _Bot:
    """⊥ — the tag of constants; merges to the other operand."""

    def __repr__(self):
        return "⊥"


class _Top:
    """⊤ — conflicting writes; merges absorb everything."""

    def __repr__(self):
        return "⊤"


BOT = _Bot()
TOP = _Top()

TagValue = Union[_Bot, _Top, Tuple[Expr, ...]]


def make_tag(*components: Union[int, Var, Expr]) -> Tuple[Expr, ...]:
    return tuple(Expr.of(c) for c in components)


def merge(t1: TagValue, t2: TagValue) -> TagValue:
    """Paper §5 merge:  merge(t1,t2) = t1 if t2<=t1; t2 if t1<t2; ⊤ otherwise."""
    if t1 is TOP or t2 is TOP:
        return TOP
    if t1 is BOT:
        return t2
    if t2 is BOT:
        return t1
    if tags_equal_syntactic(t1, t2):
        return t1
    return TOP


def tags_equal_syntactic(t1: TagValue, t2: TagValue) -> bool:
    if t1 is BOT or t1 is TOP or t2 is BOT or t2 is TOP:
        return t1 is t2
    return len(t1) == len(t2) and all(a == b for a, b in zip(t1, t2))


def tag_subs(t: TagValue, env) -> TagValue:
    if t is BOT or t is TOP:
        return t
    return tuple(e.subs(env) for e in t)


def tag_vars(t: TagValue) -> Tuple[Var, ...]:
    if t is BOT or t is TOP:
        return ()
    seen: list = []
    s = set()
    for e in t:
        for v in e.vars():
            if v not in s:
                s.add(v)
                seen.append(v)
    return tuple(seen)
