"""The benchmark's weights: drawn on the device from ``--seed``.

One ``torch.Generator`` on the run's device draws every leaf of the
port's parameter tree (``model.specs``, taken in sorted path order),
each layer-stacked leaf in one call, in the type the leaf is served in.
The program and the reference are handed the same tensors.

Scales: a weight matrix ~ N(0, 1 / fan_in) with fan_in the size it is
contracted over (the second axis from the end where the leaf's name is
not listed below); the token table ~ N(0, 1); norm scales
1 + N(0, 0.1²) and biases N(0, 0.1²), so that a
scale or bias read from the wrong place shows.  A configuration file
may set a leaf's standard deviation by name (``init_std``).

The configuration's family turns these, the port's weights, into the
ones its reference reads (``published``: for granite, the muP
multipliers divided back out; :mod:`bench.families.decoder`).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

_BIASES = ("bias", "bq", "bk", "bv", "router_bias")
# the axes (from the end, so a layer-stacked leaf reads the same) each
# weight is contracted over
_FAN_IN_AXES: Dict[str, Tuple[int, ...]] = {
    "wq": (-3,), "wk": (-3,), "wv": (-3,), "wo": (-3, -2),
    "wg": (-2,), "wu": (-2,), "wd": (-2,), "router": (-2,),
    "unembed": (-2,),
}


def _leaves(specs, prefix=()):
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _leaves(specs[k], prefix + (k,))
        return
    yield prefix, specs


def _std(name: str, shape) -> float:
    if name == "tok":
        return 1.0
    if name in _BIASES:
        return 0.1
    axes = _FAN_IN_AXES.get(name, (-2,))
    return 1.0 / math.sqrt(math.prod(shape[a] for a in axes))


def make(specs, seed: int, device, init_std: Dict = None) -> Dict:
    """The parameter tree of ``specs`` (a tree of objects with ``shape``
    and ``dtype``) on ``device``, drawn from ``seed``; ``init_std`` sets
    the standard deviation of the leaves it names."""
    init_std = init_std or {}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    out: Dict = {}
    for path, spec in _leaves(specs):
        shape = tuple(spec.shape)
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        name = path[-1]
        if name in init_std:
            x.mul_(float(init_std[name]))
        elif name == "scale":
            x.mul_(0.1).add_(1.0)
        else:
            x.mul_(_std(name, shape))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x.to(spec.dtype)
        del x
    return out

