"""Layout algebra for the ARGUS tile DSL.

A *layout* is a function from multi-dimensional logical coordinates to
one-dimensional physical offsets, parameterized by ``shape`` and ``stride``
tuples (CuTe-style, see paper §4).  Elements of ``shape``/``stride`` may be
ints or nested tuples of ints ("IntTuple"); nested modes model
hardware-swizzled layouts by wrapping coordinates around sub-extents.

The algebra implemented here is the fragment ARGUS' analysis needs:

* evaluation        — ``layout(coord)`` maps a coordinate (or a flat index in
                      colexicographic order) to a physical offset;
* ``coalesce``      — canonicalize adjacent contiguous modes;
* ``composition``   — ``A.compose(B)`` = A ∘ B (B indexes into A);
* ``right_inverse`` — invert an injective layout (offset → flat index);
* ``logical_divide``— tile a layout by a tiler (block decomposition);
* ``complement``    — the "rest" layout w.r.t. a tiler, used by divide.

All layouts here are *bounded*: every extent is a concrete int.  That bound
is what makes the downstream invariant solving decidable (DESIGN.md §2c).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple, Union

IntTuple = Union[int, Tuple["IntTuple", ...]]


# ---------------------------------------------------------------------------
# IntTuple utilities
# ---------------------------------------------------------------------------

def is_int(x: IntTuple) -> bool:
    return isinstance(x, int)


def flatten(x: IntTuple) -> Tuple[int, ...]:
    """Flatten a nested IntTuple to a flat tuple of ints."""
    if is_int(x):
        return (x,)
    out: list = []
    for e in x:
        out.extend(flatten(e))
    return tuple(out)


def tuple_size(shape: IntTuple) -> int:
    """Total number of coordinates described by ``shape``."""
    return math.prod(flatten(shape)) if not is_int(shape) else shape


def congruent(a: IntTuple, b: IntTuple) -> bool:
    """True when two IntTuples have identical nesting structure."""
    if is_int(a) and is_int(b):
        return True
    if is_int(a) or is_int(b):
        return False
    return len(a) == len(b) and all(congruent(x, y) for x, y in zip(a, b))


def _idx2crd(idx: int, shape: IntTuple) -> IntTuple:
    """Flat (colexicographic) index -> coordinate congruent with ``shape``."""
    if is_int(shape):
        return idx
    coords = []
    for s in shape:
        sz = tuple_size(s)
        coords.append(_idx2crd(idx % sz, s))
        idx //= sz
    return tuple(coords)


def _crd2idx(crd: IntTuple, shape: IntTuple) -> int:
    """Coordinate -> flat colexicographic index."""
    if is_int(shape):
        if not is_int(crd):
            raise ValueError(f"coordinate {crd!r} not congruent with shape {shape!r}")
        return crd
    if is_int(crd):  # allow a flat index for a nested mode
        return crd
    idx, mult = 0, 1
    for c, s in zip(crd, shape):
        idx += _crd2idx(c, s) * mult
        mult *= tuple_size(s)
    return idx


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Layout:
    """A layout function L_(shape, stride).

    ``L(c) = sum_i c_i * t_i`` over the flattened modes, with nested modes
    wrapping their flat sub-index around sub-extents (paper §4).
    """

    shape: IntTuple
    stride: IntTuple

    def __post_init__(self):
        if not congruent(self.shape, self.stride):
            raise ValueError(
                f"shape {self.shape!r} and stride {self.stride!r} are not congruent")

    # -- basic queries -----------------------------------------------------
    @property
    def rank(self) -> int:
        return 1 if is_int(self.shape) else len(self.shape)

    @property
    def size(self) -> int:
        """Number of logical coordinates (domain size)."""
        return tuple_size(self.shape)

    @property
    def cosize(self) -> int:
        """One past the largest offset produced (codomain extent)."""
        if self.size == 0:
            return 0
        return self(self.size - 1) + 1 if self._is_monotone_upper() else (
            max(self(i) for i in range(self.size)) + 1)

    def _is_monotone_upper(self) -> bool:
        # Offset of max coordinate bounds all offsets when strides >= 0.
        return all(t >= 0 for t in flatten(self.stride))

    # -- evaluation --------------------------------------------------------
    def __call__(self, coord: IntTuple) -> int:
        """Map a coordinate (or flat index) to a physical offset."""
        if is_int(coord):
            coord = _idx2crd(coord, self.shape)
        return self._apply(coord, self.shape, self.stride)

    @staticmethod
    def _apply(crd: IntTuple, shape: IntTuple, stride: IntTuple) -> int:
        if is_int(shape):
            if not is_int(crd):
                raise ValueError("coordinate rank mismatch")
            return crd * stride  # type: ignore[operator]
        if is_int(crd):
            # flat index into a nested mode — wrap around sub-extents
            crd = _idx2crd(crd, shape)
        total = 0
        for c, s, t in zip(crd, shape, stride):  # type: ignore[arg-type]
            total += Layout._apply(c, s, t)
        return total

    # -- iteration ---------------------------------------------------------
    def coords(self) -> Iterator[IntTuple]:
        for i in range(self.size):
            yield _idx2crd(i, self.shape)

    def offsets(self) -> Iterator[int]:
        for i in range(self.size):
            yield self(i)

    # -- canonicalization --------------------------------------------------
    def flat(self) -> "Layout":
        """Flatten nesting (keeps the same index->offset function)."""
        return Layout(flatten(self.shape), flatten(self.stride))

    def coalesce(self) -> "Layout":
        """Merge adjacent modes where s_i*t_i == t_{i+1}; drop size-1 modes."""
        shp, std = list(flatten(self.shape)), list(flatten(self.stride))
        out_s: list = []
        out_t: list = []
        for s, t in zip(shp, std):
            if s == 1:
                continue
            if out_s and out_s[-1] * out_t[-1] == t:
                out_s[-1] *= s
            else:
                out_s.append(s)
                out_t.append(t)
        if not out_s:
            return Layout(1, 0)
        if len(out_s) == 1:
            return Layout(out_s[0], out_t[0])
        return Layout(tuple(out_s), tuple(out_t))

    # -- algebra -----------------------------------------------------------
    def compose(self, other: "Layout") -> "Layout":
        """Functional composition self ∘ other (other indexes into self).

        Exact for the divisibility-compatible cases used by tiling/view; the
        result satisfies ``(A∘B)(i) == A(B(i))`` for all i < B.size, which is
        also verified by the property tests against brute force.
        """
        a = self.coalesce()
        modes_s: list = []
        modes_t: list = []
        b_shape = flatten(other.shape)
        b_stride = flatten(other.stride)
        for bs, bt in zip(b_shape, b_stride):
            s, t = _compose_mode(a, bs, bt)
            modes_s.append(s)
            modes_t.append(t)
        # keep one result mode per mode of ``other`` (mode correspondence
        # matters for view(); callers coalesce explicitly if wanted)
        if len(modes_s) == 1:
            return Layout(modes_s[0], modes_t[0])
        return Layout(tuple(modes_s), tuple(modes_t))

    def right_inverse(self) -> "Layout":
        """For an injective layout, a layout R with self(R(off)) == off for
        every offset ``off`` in the image, and R defined on [0, cosize)."""
        if not self.is_injective():
            raise ValueError("right_inverse requires an injective layout")
        # sort flat modes by stride; walk up building the inverse
        flat = self.coalesce().flat()
        pairs = sorted(
            [(t, s, i) for i, (s, t) in enumerate(zip(flatten(flat.shape),
                                                      flatten(flat.stride)))
             if s > 1],
            key=lambda p: p[0])
        shp: list = []
        std: list = []
        mult_dom = [1]
        fs = flatten(flat.shape)
        for i in range(len(fs)):
            mult_dom.append(mult_dom[-1] * fs[i])
        for t, s, i in pairs:
            shp.append(s)
            std.append(mult_dom[i])
        if not shp:
            return Layout(1, 0)
        if len(shp) == 1:
            return Layout(shp[0], std[0])
        return Layout(tuple(shp), tuple(std))

    def is_injective(self) -> bool:
        """Exact injectivity check (bounded domains make this decidable)."""
        flat = self.coalesce().flat()
        modes = [(s, abs(t)) for s, t in zip(flatten(flat.shape),
                                             flatten(flat.stride)) if s > 1]
        if any(t == 0 for _, t in modes):
            return False
        modes.sort(key=lambda p: p[1])
        reach = 0  # max offset achievable so far
        for s, t in modes:
            if t <= reach:
                return False  # overlap possible -> verify by brute force
            reach += (s - 1) * t
        return True

    def image(self) -> set:
        return set(self.offsets())

    def __repr__(self) -> str:  # CuTe-ish printing
        return f"{self.shape!r}:{self.stride!r}"


def _compose_mode(a: Layout, bs: int, bt: int) -> Tuple[IntTuple, IntTuple]:
    """Compose one flat mode (bs:bt) through layout ``a`` (coalesced/flat)."""
    if bs == 1:
        return 1, 0
    shp = list(flatten(a.shape))
    std = list(flatten(a.stride))
    # skip past bt elements of a's domain
    rest = bt
    out_s: list = []
    out_t: list = []
    remaining = bs
    for i, (s, t) in enumerate(zip(shp, std)):
        if rest >= s:
            if rest % s != 0:
                return _compose_fallback(a, bs, bt)
            rest //= s
            continue
        if rest > 0 and s % rest != 0:
            return _compose_fallback(a, bs, bt)
        avail = s // rest if rest > 0 else s
        take = min(avail, remaining)
        if remaining > avail and avail != take:
            return _compose_fallback(a, bs, bt)
        out_s.append(take)
        out_t.append(t * rest if rest > 0 else t)
        if remaining % take != 0 and i + 1 < len(shp):
            return _compose_fallback(a, bs, bt)
        remaining //= take
        rest = 0
        if remaining == 1:
            break
    if remaining > 1:
        # ran off the end: extend with the last stride (mode overflow)
        return _compose_fallback(a, bs, bt)
    if not out_s:
        return 1, 0
    if len(out_s) == 1:
        return out_s[0], out_t[0]
    return tuple(out_s), tuple(out_t)


def _compose_fallback(a: Layout, bs: int, bt: int) -> Tuple[IntTuple, IntTuple]:
    """Exact fallback: tabulate offsets and re-derive (shape, stride) modes.

    Only valid when the tabulated function is a layout (piecewise-affine with
    mixed-radix structure); raises otherwise.  Bounded domains keep this
    cheap — tiles are small by construction.
    """
    offs = [a(i * bt) for i in range(bs)]
    # derive mixed-radix structure
    shp: list = []
    std: list = []
    i = 1
    base = offs[0]
    if base != 0:
        raise ValueError("composition result is not a layout (nonzero base)")
    n = len(offs)
    cur = 1
    while cur < n:
        stride = offs[cur]
        run = 1
        while (run + 1) * cur < n + cur and (run + 1) * cur <= n:
            nxt = run + 1
            ok = True
            for j in range(cur):
                idx = nxt * cur - cur + j
                if idx >= n or offs[idx] != offs[j] + run * stride:
                    ok = False
                    break
            if not ok:
                break
            run = nxt
        # verify periodic structure for this mode
        shp.append(run)
        std.append(stride)
        # check consistency
        for k in range(run):
            for j in range(cur):
                if offs[k * cur + j] != offs[j] + k * stride:
                    raise ValueError("composition result is not a layout")
        cur *= run
        if cur >= n:
            break
        if n % cur != 0:
            raise ValueError("composition result is not a layout")
    if not shp:
        return 1, 0
    if len(shp) == 1:
        return shp[0], std[0]
    return tuple(shp), tuple(std)


# ---------------------------------------------------------------------------
# Tiling operations
# ---------------------------------------------------------------------------

def make_contiguous(shape: Sequence[int], *, row_major: bool = True) -> Layout:
    """Contiguous tensor layout.  ``row_major`` matches numpy/C order: the
    *last* dimension has stride 1."""
    shape = tuple(int(s) for s in shape)
    strides: list = []
    acc = 1
    for s in reversed(shape) if row_major else shape:
        strides.append(acc)
        acc *= s
    if row_major:
        strides = list(reversed(strides))
    if len(shape) == 1:
        return Layout(shape[0], strides[0])
    return Layout(tuple(shape), tuple(strides))


def logical_divide(layout: Layout, tile: Sequence[int]) -> Layout:
    """Tile ``layout`` by per-dimension tile extents.

    Returns a layout of rank 2*n shaped ((tile_0..tile_n-1),(rest_0..rest_n-1))
    where the first group indexes *within* a tile and the second *across*
    tiles.  Requires every dim divisible by its tile extent.
    """
    shp = flatten(layout.shape)
    std = flatten(layout.stride)
    if len(tile) != len(shp):
        raise ValueError("tile rank mismatch")
    inner_s: list = []
    inner_t: list = []
    outer_s: list = []
    outer_t: list = []
    for (s, t, b) in zip(shp, std, tile):
        if s % b != 0:
            raise ValueError(f"dimension {s} not divisible by tile {b}")
        inner_s.append(b)
        inner_t.append(t)
        outer_s.append(s // b)
        outer_t.append(t * b)
    return Layout((tuple(inner_s), tuple(outer_s)),
                  (tuple(inner_t), tuple(outer_t)))


def view(layout: Layout, new_shape: Sequence[int], *,
         row_major: bool = True) -> Layout:
    """Reinterpret a tile under a new logical shape (paper: ``view()``).

    Memory safety: source and destination must cover identical sizes.
    """
    new = make_contiguous(new_shape, row_major=row_major)
    if new.size != layout.size:
        raise ValueError(
            f"view() size mismatch: {layout.size} -> {new.size}")
    return layout.compose(new)


def brute_force_equal(a: Layout, b: Layout) -> bool:
    """Test oracle: do two layouts implement the same index->offset map?"""
    if a.size != b.size:
        return False
    return all(a(i) == b(i) for i in range(a.size))
