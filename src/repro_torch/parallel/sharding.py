"""Logical-axis -> mesh-axis sharding rules on DTensor — the port of the
JAX package's ``parallel/sharding.py``.

Parameters, caches and activations carry *logical* axis names
(``models/params.py``); the rules bind them to the axes of a
``DeviceMesh`` with the JAX package's divisibility fallback (an axis that
does not divide its mesh extent is replicated — MQA's single KV head
never shards over a 16-way model axis) and never use a mesh axis twice
in one array.

Default layout on the production meshes:
  (16, 16)    ("data", "model")          — single pod
  (2, 16, 16) ("pod", "data", "model")   — two pods; batch shards over
                                           ("pod", "data")

* tensor-parallel ("model"): heads / kv_heads / mlp / expert / vocab
* FSDP ("data"): the "embed" axis of weight matrices (ZeRO-3-style
  weight sharding: DTensor gathers a layer's weights where it uses them)
* optimizer state: the parameter's placements (``optim/adamw.py``), so
  with "embed" over "data" the moments are sharded over the data axis —
  ZeRO-1.

``spec_for`` returns the JAX ``PartitionSpec``'s entries as a tuple — a
mesh-axis name, a tuple of names or ``None`` per dimension, trailing
``None``s dropped — and :func:`placements` turns such a spec into one
DTensor placement per mesh dimension.  The functions that take a mesh
read only its axis names and sizes, so they take a ``DeviceMesh`` or a
:class:`MeshShape` (no process group).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

from repro_torch.optim.adamw import tree_map

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes without devices or a process group
    (``jax.sharding.AbstractMesh``'s counterpart)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]


def mesh_shape(mesh) -> MeshShape:
    """The names and sizes of a ``DeviceMesh`` (or a MeshShape)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def _size(mesh, name: str) -> int:
    m = mesh_shape(mesh)
    return m.sizes[m.axis_names.index(name)] if name in m.axis_names else 1


@dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Tuple[str, MeshAxes], ...]
    batch_axes: Tuple[str, ...] = ("data",)

    def lookup(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        return None


def default_rules(mesh, *, fsdp: bool = True) -> ShardingRules:
    names = mesh_shape(mesh).axis_names
    batch = tuple(a for a in ("pod", "data") if a in names)
    rules = [
        ("vocab", "model"),
        ("embed", "data" if fsdp else None),
        ("mlp", "model"),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("head_dim", None),
        ("expert", "model"),
        ("kv_lora", None),
        ("layers", None),
        ("state", None),
        ("conv", None),
        ("batch", batch),            # activation/cache batch dim
        ("seq", None),               # sequence stays local by default
        # KV-cache seq dim: claims the model axis only when kv_heads could
        # not (spec_for walks dims in order and never reuses an axis):
        # sequence-parallel KV for MQA / few-KV-head archs
        ("kv_seq", "model"),
    ]
    return ShardingRules(tuple(rules), batch)


def _mesh_size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(_size(mesh, a) for a in axes)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: ShardingRules, mesh) -> Spec:
    """The PartitionSpec entries of one array, with divisibility
    fallback."""
    entries = []
    used: set = set()
    for dim, logical in zip(shape, axes):
        mesh_axes = rules.lookup(logical)
        if mesh_axes is None:
            entries.append(None)
            continue
        names = (mesh_axes,) if isinstance(mesh_axes, str) else mesh_axes
        names = tuple(a for a in names if a not in used)
        if not names or dim % _mesh_size(mesh, names) != 0:
            entries.append(None)
            continue
        used.update(names)
        entries.append(names[0] if len(names) == 1 else names)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def batch_spec(rules: ShardingRules) -> Spec:
    b = rules.batch_axes
    return (b if len(b) > 1 else b[0],)


def placements(spec: Spec, mesh) -> Tuple:
    """One DTensor placement per mesh dimension for ``spec``: ``Shard(d)``
    on every mesh axis that dimension ``d``'s entry names, ``Replicate()``
    elsewhere.  A tuple entry such as ``("pod", "data")`` shards ``d`` on
    both mesh dimensions; DTensor splits over them in mesh order, so its
    names must come in that order (then each rank's block is the block
    JAX gives that device)."""
    names = mesh_shape(mesh).axis_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_block(shape: Sequence[int], spec: Spec, mesh,
                coord: Sequence[int]) -> Tuple[slice, ...]:
    """The block of a ``shape`` array that the rank at mesh coordinate
    ``coord`` holds under ``spec`` (every sharded dimension divides its
    mesh extent, as ``spec_for`` guarantees)."""
    m = mesh_shape(mesh)
    block = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        group = (() if entry is None else
                 (entry,) if isinstance(entry, str) else tuple(entry))
        index, ways = 0, 1
        for a in group:                       # major to minor
            i = m.axis_names.index(a)
            index = index * m.sizes[i] + coord[i]
            ways *= m.sizes[i]
        if n % ways:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"{ways} ways")
        step = n // ways
        block.append(slice(index * step, (index + 1) * step))
    return tuple(block)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of every rank's block of ``shape`` under ``spec``."""
    return tuple(s.stop - s.start for s in local_block(
        shape, spec, mesh, (0,) * len(mesh_shape(mesh).axis_names)))


def param_shardings(axes_tree, specs_tree, rules: ShardingRules, mesh):
    """Tree of PartitionSpec entries congruent with the param tree.
    ``axes_tree`` is the logical-axes tree, ``specs_tree`` the abstract
    or concrete params (leaves expose ``.shape``).  :func:`distribute`
    places a tree by it."""
    return tree_map(lambda axes, leaf: spec_for(
        tuple(leaf.shape), tuple(axes), rules, mesh), axes_tree, specs_tree)


# caches and other activation state whose logical axes the model declares
tree_shardings = param_shardings


def data_shardings(tree, rules: ShardingRules, mesh):
    """Spec tree for inputs: every leaf's leading (batch) dim over the
    batch axes where it divides; scalars replicate.  KV caches also
    shard their heads over "model" when the leaf looks like (B, H, S, D)
    and H divides the model axis."""
    bspec = batch_spec(rules)
    model_n = _size(mesh, "model")
    batch_n = _mesh_size(mesh, rules.batch_axes)

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return ()
        lead = bspec[0] if shape[0] % batch_n == 0 else None
        rest = [None] * (len(shape) - 1)
        if len(shape) == 4 and shape[1] % model_n == 0 and shape[1] > 1:
            rest[0] = "model"   # (B, H, S, D) caches: heads over model
        spec = [lead] + rest
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    return tree_map(one, tree)


def distribute(tree, spec_tree, mesh):
    """Place a tree by a spec tree on ``mesh``: a tensor is split by
    ``distribute_tensor`` (each rank keeps its own block of the full
    tensor it holds, no communication); a ``ShapeDtype`` (shape and
    dtype, no data) or a ``meta`` tensor becomes a ``meta`` DTensor of
    the same global shape (the dry-run: no memory); a Python scalar
    passes through."""
    def one(leaf, spec):
        pl = placements(spec, mesh)
        abstract = not isinstance(leaf, torch.Tensor) and hasattr(
            leaf, "shape") and hasattr(leaf, "dtype")
        if abstract or (isinstance(leaf, torch.Tensor) and leaf.is_meta):
            shape = tuple(leaf.shape)
            local = torch.empty(local_shape(shape, spec, mesh),
                                dtype=leaf.dtype, device="meta")
            return DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=_contiguous_stride(shape))
        if isinstance(leaf, torch.Tensor):
            out = distribute_tensor(leaf.detach(), mesh, pl,
                                    src_data_rank=None)
            return out.requires_grad_(leaf.requires_grad)
        return leaf
    return tree_map(one, tree, spec_tree)


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def full_tensor(tree):
    """Every DTensor leaf of ``tree`` gathered into a full tensor (for a
    checkpoint in the JAX package's format); other leaves unchanged."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)
