"""Parameter descriptor system of the port.

Models declare parameters as :class:`ParamSpec` trees (shape, dtype,
logical axes, initializer), as in the JAX package's ``models/params.py``.
From one spec tree we derive:

* concrete initialization (:func:`init_params`) from explicit
  ``torch.Generator``s — the same fan-in rule as the JAX package, but
  not the same numbers (the two generators differ);
* abstract parameters (:func:`abstract_params`): :class:`ShapeDtype`
  stand-ins for the multi-pod dry-run (no allocation);
* the tree of logical axes (:func:`axes_tree`), which the rules in
  :mod:`repro_torch.parallel.sharding` bind to mesh axes;
* the parameter count and bytes;
* :func:`from_jax_numpy`, which carries a parameter tree that the JAX
  package initialised (converted leaf by leaf to numpy) across, so the
  port and the reference run the same weights.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class ShapeDtype(NamedTuple):
    """Shape and dtype of one leaf (``jax.ShapeDtypeStruct``'s
    counterpart): cache shapes, abstract parameters, dry-run inputs."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    axes: Tuple[Optional[str], ...] = ()
    init: str = "normal"          # normal | zeros | ones | embed_normal
    scale: Optional[float] = None  # override fan-in scaling

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank != shape {self.shape} rank")


def leaf_paths(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], prefix + (k,))
        return
    yield prefix, tree


def _set_path(out: Dict, path, value) -> None:
    node = out
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _fold_seed(seed: int, path: Tuple[str, ...]) -> int:
    """Per-leaf seed: FNV-1a of the leaf path mixed into ``seed``, so a
    layout change does not reshuffle the other leaves' streams."""
    h = 2166136261
    for p in path:
        for ch in str(p).encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return (int(seed) * 1000003 + h) & 0x7FFFFFFFFFFFFFFF


def _init_leaf(gen: torch.Generator, spec: ParamSpec,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "embed_normal":
        std = spec.scale if spec.scale is not None else 1.0
    else:
        # fan-in scaled normal (truncation-free, as in the JAX package)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = (spec.scale if spec.scale is not None
               else 1.0 / math.sqrt(fan_in))
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(spec.dtype)


def init_params(specs, seed: int, device: DeviceLike = "cuda") -> Dict:
    """Materialize a spec tree on ``device``; each leaf draws from its
    own ``torch.Generator`` seeded from ``seed`` and the leaf path."""
    dev = resolve_device(device)
    out: Dict = {}
    for path, spec in leaf_paths(specs):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_fold_seed(seed, path))
        _set_path(out, path, _init_leaf(gen, spec, dev))
    return out


def abstract_params(specs) -> Dict:
    """ShapeDtype tree for the dry-run (no allocation)."""
    out: Dict = {}
    for path, spec in leaf_paths(specs):
        _set_path(out, path, ShapeDtype(tuple(spec.shape), spec.dtype))
    return out


def axes_tree(specs) -> Dict:
    """Tree of logical-axis tuples congruent with the param tree; a leaf
    declared without axes gets ``(None,) * rank``."""
    out: Dict = {}
    for path, spec in leaf_paths(specs):
        _set_path(out, path, spec.axes or (None,) * len(spec.shape))
    return out


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for _, s in leaf_paths(specs))


def param_bytes(specs) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for _, s in leaf_paths(specs))


def to_torch(arr, device: torch.device) -> torch.Tensor:
    """One numpy leaf -> tensor on ``device``.  bfloat16 arrays (numpy
    sees them as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    rejects) go through float32, which holds every bfloat16 exactly."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax_numpy(tree, device: DeviceLike = "cuda") -> Dict:
    """A nested dict of numpy-convertible leaves (for example
    ``jax.tree.map(np.asarray, params)``) -> the same tree of tensors
    on ``device``, dtypes kept."""
    dev = resolve_device(device)
    out: Dict = {}
    for path, leaf in leaf_paths(tree):
        _set_path(out, path, to_torch(leaf, dev))
    return out
