"""Mesh builders — the port of the JAX package's ``launch/mesh.py``.

Both are functions (never module-level constants), so importing this
module touches no process group.

``make_production_mesh`` builds the dry-run's meshes over PyTorch's
*fake* process-group backend: 256 or 512 ranks that exist only as a
rank number and a world size, whose collectives move no data.  It is
the one place in the port that imports the private
``torch.testing._internal.distributed.fake_pg``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _mesh(device_type: str, shape, names) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks ("data", "model").  Multi-pod:
    2x16x16 = 512 ranks ("pod", "data", "model").  Replaces the default
    process group by a fake one of that world size, rank 0."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, names)


def make_fake_mesh(shape, names, rank: int = 0) -> DeviceMesh:
    """A mesh of ``shape`` over a fake process group (rank ``rank``),
    which replaces any default process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    world = 1
    for s in shape:
        world *= s
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    return _mesh("cpu", shape, names)


def make_host_mesh(*, model: int = 1) -> DeviceMesh:
    """A (world // model, model) ("data", "model") mesh over the ranks of
    the running process group (``torch.distributed.run``): on the cards
    under NCCL, on the CPU under gloo."""
    world = dist.get_world_size()
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return _mesh(dev, (world // model, model), ("data", "model"))
