"""AdamW with float32 moments over (possibly bf16) params — the port of
the JAX package's ``optim/adamw.py``.

Parameter trees are nested dicts of tensors.  The state is the same
``NamedTuple(step, mu, nu)`` as in the JAX package, so its checkpoint
keys (``opt/0``, ``opt/1/...``, ``opt/2/...``) match.  Updates build
new tensors (the caller drops the old ones by reassignment, as the JAX
launcher donates them).  The bias corrections ``b ** step`` and every
other scalar are float32 tensors, as in JAX.  The JAX package's moments
take their parameter's placements on DTensor parameters as they take its
sharding in JAX: with "embed" over "data" (``parallel.default_rules``,
fsdp) the optimizer state is sharded over the data axis — ZeRO-1.  The
global norm of :func:`clip_by_global_norm` then sums over every rank."""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, device_of, resolve_device

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts, in sorted key order (that
    of :func:`tree_leaves`); ``rest``: trees of the same structure, their
    leaves passed alongside."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """Leaves of nested dicts in sorted key order (``jax.tree.leaves``'
    order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def adamw_init(params) -> AdamWState:
    dev = device_of(params)
    # zeros_like keeps a DTensor parameter's placements
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                      tree_map(torch.clone, zeros))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    gsq = None
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.to(F32)))
        gsq = s if gsq is None else gsq + s
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Any, AdamWState]:
    """-> (new params, new state).  New parameter leaves require grad
    where the old ones did."""
    step = state.step + 1
    sf = step.to(F32)
    b1c = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=sf.device), sf)
    b2c = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=sf.device), sf)

    def upd(p, g, m, v):
        gf = g.to(F32)
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(F32)
        p_new = (p.to(F32) - lr * delta).to(p.dtype)
        return p_new.requires_grad_(p.requires_grad), m_new, v_new

    out = tree_map(upd, params, grads, state.mu, state.nu)
    return _pick(out, 0), AdamWState(step, _pick(out, 1), _pick(out, 2))


def _pick(tree, i: int):
    """Element ``i`` of every (param, mu, nu) leaf triple."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def adamw_from_jax_numpy(state, device: DeviceLike = "cuda") -> AdamWState:
    """The JAX package's ``AdamWState`` with numpy leaves (for example
    ``jax.tree.map(np.asarray, opt)``) -> the port's, on ``device``:
    ``from_jax_numpy``'s counterpart for the optimizer state."""
    dev = resolve_device(device)
    step, mu, nu = state
    conv = lambda a: torch.from_numpy(np.array(a)).to(dev)
    return AdamWState(conv(step), tree_map(conv, mu), tree_map(conv, nu))
