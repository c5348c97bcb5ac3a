"""Activation-sharding context, and the models' DTensor plumbing — the
port of the JAX package's ``parallel/api.py``.

A distributed launch installs the (batch, seq, embed) spec here; the
models' layer loops call :func:`constrain_activations` on the activation
entering each layer (where the JAX models pin their scan carries with
``with_sharding_constraint``) and on the residual stream after each
sublayer (DTensor would otherwise carry a row-parallel matmul's pending
sum into the next norm, where XLA's propagation reshards), which
redistributes a DTensor activation, and its gradient, to the installed
placements.  Without a spec, or on a plain tensor, it is a no-op.

The rest is how the models trace under DTensor, each helper the plain
op on plain tensors (so the numerics of a single device are unchanged).
A plain tensor a model builds from shapes or positions (rope tables,
masks, position ranges) meets the DTensor activations as a replicated
one: the callers that make DTensors (the launcher's distributed branch,
the dry-run) run the model under :func:`implicit_replication`.  The
helpers below are for the ops that DTensor's own rules do not carry:

* :func:`reshape` — a view DTensor cannot carry (a merged dim split
  over more ranks than its outer part) replicates that mesh dim first;
* :func:`per_shard`, :func:`per_shard_attention` — computations
  independent per batch row and head run on each rank's local blocks;
* :func:`gather_last`, :func:`embed_rows` — vocab-parallel lookups;
* :func:`on_replicated` — an op without a DTensor sharding rule;
* :func:`shard_state` — the cache a model builds for itself, placed by
  the installed rules (:func:`set_state_rules`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from .sharding import (ShardingRules, Spec, _contiguous_stride,
                       distribute, placements, tree_shardings)

_ACT_SPEC: Optional[Spec] = None
_STATE_RULES: Optional[ShardingRules] = None


def set_activation_spec(spec: Optional[Spec]) -> None:
    """Install the (batch, seq, embed) spec of the activations entering
    each layer; None disables the constraint (single-process runs)."""
    global _ACT_SPEC
    _ACT_SPEC = spec


def activation_spec() -> Optional[Spec]:
    return _ACT_SPEC


def constrain_activations(x: torch.Tensor) -> torch.Tensor:
    """Redistribute a (B, S, D) DTensor activation to the installed spec,
    and its gradient in the backward pass to the same placements, as
    ``with_sharding_constraint`` pins a value and its cotangent (a no-op
    outside a distributed launch)."""
    if _ACT_SPEC is None or not isinstance(x, DTensor) or x.ndim != 3:
        return x
    return _Pin.apply(x, placements(_ACT_SPEC, x.device_mesh))


def constrain_rows(t: torch.Tensor) -> torch.Tensor:
    """Pin a DTensor whose leading dim is the batch (MoE's groups) to the
    installed spec's batch placement, replicated on the other dims, in
    the forward and the backward pass (a no-op outside a distributed
    launch)."""
    if _ACT_SPEC is None or not isinstance(t, DTensor):
        return t
    return _Pin.apply(t, placements(_ACT_SPEC[:1], t.device_mesh))


class _Pin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return _redistribute(x, want)

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, ctx.want), None


def _redistribute(t, want):
    if tuple(t.placements) == tuple(want):
        return t
    return t.redistribute(t.device_mesh, want)


def set_state_rules(rules: Optional[ShardingRules]) -> None:
    """Install the rules by which the state a model builds for itself
    (the cache ``prefill`` returns) is placed when its inputs are
    DTensors; None: no distributed launch."""
    global _STATE_RULES
    _STATE_RULES = rules


def shard_state(shapes, axes, like):
    """The zeros of a ``ShapeDtype`` tree with logical ``axes``, placed by
    the installed rules on ``like``'s mesh when ``like`` is a DTensor
    (``meta`` DTensors when ``like`` is on ``meta``); None when ``like``
    is a plain tensor, for the caller to build its own."""
    if not isinstance(like, DTensor):
        return None
    if _STATE_RULES is None:
        raise RuntimeError("a DTensor input needs set_state_rules(rules) "
                           "to place the state a model builds")
    mesh = like.device_mesh
    specs = tree_shardings(axes, shapes, _STATE_RULES, mesh)
    if like.to_local().is_meta:
        return distribute(shapes, specs, mesh)
    return distribute(_zeros(shapes, like.device), specs, mesh)


def _zeros(shapes, device):
    if isinstance(shapes, dict):
        return {k: _zeros(v, device) for k, v in shapes.items()}
    return torch.zeros(shapes.shape, dtype=shapes.dtype, device=device)


def _replicated(t, like):
    """``t`` as a replicated DTensor on ``like``'s mesh when ``t`` is a
    plain tensor (to be redistributed or unwrapped here); ``t``
    otherwise."""
    if isinstance(like, DTensor) and isinstance(t, torch.Tensor) \
            and not isinstance(t, DTensor):
        mesh = like.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t



def _groups(src, dst):
    """Pair the dims of two shapes of one size into groups of equal
    product: [(src dims, dst dims)], size-1 dims in groups of their
    own."""
    out, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        if i < len(src) and src[i] == 1:
            out.append(([i], [])); i += 1; continue
        if j < len(dst) and dst[j] == 1:
            out.append(([], [j])); j += 1; continue
        gi, gj = [i], [j]
        a, b = src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a *= src[i]; gi.append(i); i += 1
            else:
                b *= dst[j]; gj.append(j); j += 1
        out.append((gi, gj))
    return out


def _reshapeable(t, shape):
    """``t``'s placements with Replicate on every mesh dim whose sharding
    DTensor cannot carry through ``t.reshape(shape)``: a sharded dim
    must lead its group of merged or split dims, and the group's first
    output dim must divide by the ranks that share it."""
    mesh, pl = t.device_mesh, list(t.placements)
    ways = {}
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(i)
    ok = set()
    for gi, gj in _groups(tuple(t.shape), tuple(shape)):
        for d in gi:
            if d in ways and d == gi[0] and gj and \
                    shape[gj[0]] % ways[d] == 0:
                ok.add(d)
    return tuple(Replicate() if isinstance(p, Shard) and p.dim not in ok
                 else p for p in pl)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape = tuple(t.shape)
        return _fit(t, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _fit(g, ctx.shape).reshape(ctx.shape), None


def _fit(t, shape):
    want = _reshapeable(t, shape)
    return t if want == tuple(t.placements) else \
        t.redistribute(t.device_mesh, want)


def reshape(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(shape)``.  On a DTensor, a mesh dim whose sharding the
    view cannot keep (XLA would reshard there; DTensor refuses an
    uneven split of a merged dim) is replicated first, in the forward
    pass and, for the gradient, in the backward pass."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    if not isinstance(t, DTensor):
        return t.reshape(shape)
    n = 1
    for s in shape:
        n *= s
    if -1 in shape:
        known = -n
        shape = tuple(t.numel() // known if s == -1 else s for s in shape)
    return _Reshape.apply(t, tuple(shape))


def on_replicated(fn, t: torch.Tensor) -> torch.Tensor:
    """``fn(t)`` for an op DTensor has no sharding rule for: on a DTensor,
    ``fn`` runs on the local tensor of ``t`` replicated, and the result
    is replicated on ``t``'s mesh (both steps differentiable)."""
    if not isinstance(t, DTensor):
        return fn(t)
    mesh = t.device_mesh
    rep = [Replicate()] * mesh.ndim
    if tuple(t.placements) != tuple(rep):
        t = t.redistribute(mesh, rep)
    return DTensor.from_local(fn(t.to_local()), mesh, rep, run_check=False)


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor with a pending (partial) sum on some mesh dims, reduced
    there (replicated); ``t`` unchanged otherwise."""
    if not isinstance(t, DTensor):
        return t
    want = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    if want == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def per_shard_attention(fn, q, k, v, *, q_positions=None,
                        kv_positions=None, **kw):
    """``fn(q, k, v, q_positions=, kv_positions=, **kw)``, an attention
    over (B, H, S, D) tensors.  On DTensors it runs on each rank's local
    block: attention is independent per batch row and head, so q, k and
    v are placed alike on the batch and head dims (the KV heads repeated
    to one per query head where they do not split as the query heads
    do) and replicated on the others (a KV cache sharded on its sequence
    is gathered), the (B, S) positions sharded as the batch, and the
    output takes q's batch and head placements.  DTensor's own rules
    would merge the sharded batch and head dims in ``einsum``'s batched
    product and replicate the heads."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, q_positions=q_positions,
                  kv_positions=kv_positions, **kw)
    mesh = q.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1)
               else Replicate() for p in q.placements)
    head_ways = 1
    for i, p in enumerate(pl):
        if p == Shard(1):
            head_ways *= mesh.size(i)
    rep = [Replicate()] * mesh.ndim
    if k.shape[1] % head_ways:
        g = q.shape[1] // k.shape[1]
        # DTensor has no rule for repeat_interleave: repeat the KV heads
        # on each rank's local tensor, its batch rows kept
        rows = tuple(p if p == Shard(0) else Replicate() for p in pl)
        k, v = (DTensor.from_local(
            _redistribute(_replicated(t, q), rows).to_local()
            .repeat_interleave(g, 1), mesh, rows, run_check=False)
            for t in (k, v))

    def local(t, want):
        if t is None:
            return None
        t = _replicated(t, q)
        if tuple(t.placements) != tuple(want):
            t = t.redistribute(mesh, want)
        return t.to_local()

    def pos_pl(t):
        if t is None or t.ndim < 2:
            return rep
        return tuple(p if p == Shard(0) else Replicate() for p in pl)
    out = fn(local(q, pl), local(k, pl), local(v, pl),
             q_positions=local(q_positions, pos_pl(q_positions)),
             kv_positions=local(kv_positions, pos_pl(kv_positions)), **kw)
    shape = tuple(q.shape[:3]) + (v.shape[-1],)
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))




def gather_last(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather(t, -1, index)``.  On a DTensor sharded on its last
    dim (vocab-sharded logits) each rank gathers from its own block the
    indices that fall in it (zeros elsewhere) and the ranks' values are
    summed, as Megatron's vocab-parallel cross entropy does: DTensor's
    own gather would build the gradient from a zero tensor of the full
    global shape on every rank."""
    if not isinstance(t, DTensor):
        return torch.gather(t, -1, index)
    mesh, last = t.device_mesh, t.ndim - 1
    vocab = [i for i, p in enumerate(t.placements) if p == Shard(last)]
    if not vocab:
        return reduce_partial(torch.gather(t, -1, _replicated(index, t)))
    rows = tuple(Replicate() if i in vocab else p
                 for i, p in enumerate(t.placements))
    idx = _redistribute(_replicated(index, t), rows).to_local()
    local = t.to_local()
    n = local.shape[-1]
    block = 0
    for i in vocab:                              # major to minor
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    rel = idx - block * n
    inside = (rel >= 0) & (rel < n)
    got = torch.gather(local, -1, rel.clamp(0, n - 1)) * inside
    out = DTensor.from_local(
        got, mesh, tuple(Partial() if i in vocab else p
                         for i, p in enumerate(t.placements)),
        run_check=False, shape=index.shape,
        stride=_contiguous_stride(tuple(index.shape)))
    return reduce_partial(out)


def per_shard(fn, args, dims, out_dims):
    """``fn(*args)`` for a computation independent per batch row and per
    head.  On DTensors it runs on each rank's local blocks: ``dims[i]`` =
    (batch dim, head dim) of ``args[i]`` (None args pass through),
    ``out_dims`` the same for each output.  The mesh dims that shard the
    first argument's batch or head dim shard every argument's and
    output's; the others are replicated first.  (DTensor would run such
    a computation op by op: a Python loop over the SSD chunks costs its
    sharding propagation on every op.)"""
    ref = args[0]
    if not isinstance(ref, DTensor):
        return fn(*args)
    mesh = ref.device_mesh
    b0, h0 = dims[0]
    roles = ["b" if p == Shard(b0) else "h" if p == Shard(h0) else None
             for p in ref.placements]

    def pl(bd, hd):
        return tuple(Shard(bd) if r == "b" else Shard(hd) if r == "h"
                     else Replicate() for r in roles)
    local = [None if a is None else
             _redistribute(_replicated(a, ref), pl(*d)).to_local()
             for a, d in zip(args, dims)]
    outs = fn(*local)
    one = not isinstance(outs, tuple)
    outs = (outs,) if one else outs
    res = tuple(DTensor.from_local(o, mesh, pl(*d), run_check=False)
                for o, d in zip(outs, out_dims))
    return res[0] if one else res


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  On a DTensor table sharded on its rows (the vocab)
    each rank looks up the ids in its own block (zero rows elsewhere) and
    the ranks' rows are summed, as Megatron's vocab-parallel embedding
    does: exactly one rank holds each row, so the sum is exact.  (The
    backward of DTensor's own indexing fails on some releases.)"""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    table = _redistribute(table, tuple(
        Shard(0) if i in vocab else Replicate()
        for i in range(mesh.ndim)))
    ids = _replicated(ids, table)
    ipl = tuple(Replicate() if i in vocab or not p.is_shard() else p
                for i, p in enumerate(ids.placements))
    lid, local = _redistribute(ids, ipl).to_local(), table.to_local()
    n = local.shape[0]
    block = 0
    for i in vocab:                              # major to minor
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    rel = lid - block * n
    inside = ((rel >= 0) & (rel < n))[..., None]
    rows = local[rel.clamp(0, n - 1)] * inside.to(local.dtype)
    shape = tuple(ids.shape) + tuple(local.shape[1:])
    out = DTensor.from_local(
        rows, mesh, tuple(Partial() if i in vocab else p
                          for i, p in enumerate(ipl)),
        run_check=False, shape=torch.Size(shape),
        stride=_contiguous_stride(shape))
    return reduce_partial(out)
