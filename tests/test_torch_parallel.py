"""The port's sharding rules (``repro_torch.parallel``) against the JAX
package's (``repro.parallel``), with no compile: ``spec_for`` on drawn
shapes and axes, the rules' own properties, the local shard shape of
every parameter leaf of all ten architectures at full size, and of the
decode caches and inputs of every cell, on both production meshes with
fsdp on and off (JAX's ``NamedSharding(...).shard_shape`` over an
``AbstractMesh``), DTensor's own local shapes on fake process groups of
256 and 512 ranks, and each rank's block on a 2 x 2 x 2 mesh against
``devices_indices_map`` over 8 JAX CPU devices (in a subprocess)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings, strategies as st

from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.parallel import data_shardings as jdata_shardings
from repro.parallel import default_rules as jdefault_rules
from repro.parallel import param_shardings as jparam_shardings
from repro.parallel import spec_for as jspec_for
from repro.parallel.sharding import tree_shardings as jtree_shardings

from repro_torch import configs
from repro_torch.models import build
from repro_torch.models.params import leaf_paths
from repro_torch.parallel import (MeshShape, data_shardings, default_rules,
                                  local_shape, param_shardings, placements,
                                  spec_for, tree_shardings)

REPO = Path(__file__).resolve().parent.parent
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
LOGICAL = ("vocab", "embed", "mlp", "heads", "kv_heads", "head_dim",
           "expert", "kv_lora", "layers", "state", "conv", "batch", "seq",
           "kv_seq", None)


def _abstract_mesh(shape, names):
    try:
        return AbstractMesh(shape, names)
    except TypeError:        # jax 0.4.x spelling
        return AbstractMesh(tuple(zip(names, shape)))


JMESH = {k: _abstract_mesh(*v) for k, v in MESHES.items()}
TMESH = {k: MeshShape(v[1], v[0]) for k, v in MESHES.items()}


def _shard_shapes(jtree, mesh):
    """{path: shard shape} of a tree of JAX NamedShardings and its
    shapes (``jtree``: (shardings, shapes))."""
    shard, shapes = jtree
    out = {}
    for (p, s), (_, x) in zip(leaf_paths(shard), leaf_paths(shapes)):
        out[p] = tuple(s.shard_shape(tuple(x.shape)))
    return out


def _local_shapes(specs, shapes, mesh):
    return {p: local_shape(tuple(x.shape), s, mesh)
            for (p, s), (_, x) in zip(leaf_paths(specs), leaf_paths(shapes))}


@settings(max_examples=150, deadline=None)
@given(data=st.data(), mesh=st.sampled_from(sorted(MESHES)),
       fsdp=st.booleans())
def test_spec_for_matches_jax(data, mesh, fsdp):
    rank = data.draw(st.integers(0, 5))
    shape = tuple(data.draw(st.sampled_from([1, 2, 3, 8, 16, 24, 32, 40,
                                             48, 64, 256, 512, 4096]))
                  for _ in range(rank))
    axes = tuple(data.draw(st.sampled_from(LOGICAL)) for _ in range(rank))
    jm, tm = JMESH[mesh], TMESH[mesh]
    want = tuple(jspec_for(shape, axes, jdefault_rules(jm, fsdp=fsdp), jm))
    got = spec_for(shape, axes, default_rules(tm, fsdp=fsdp), tm)
    assert got == want
    pl = placements(got, tm)                 # one placement a mesh dim
    assert len(pl) == len(tm.axis_names)


class TestShardingRules:
    """Twins of ``tests/test_substrate.py::TestShardingRules``."""

    def test_divisibility_fallback(self):
        mesh = TMESH["single"]
        rules = default_rules(mesh)
        spec = spec_for((64, 1, 128, 64),
                        ("batch", "kv_heads", "seq", "head_dim"), rules, mesh)
        assert len(spec) < 2 or spec[1] is None
        spec = spec_for((64, 16, 128, 64),
                        ("batch", "kv_heads", "seq", "head_dim"), rules, mesh)
        assert spec[1] == "model"

    def test_no_double_axis_use(self):
        mesh = TMESH["single"]
        rules = default_rules(mesh, fsdp=True)
        spec = spec_for((32, 64), ("batch", "embed"), rules, mesh)
        names = []
        for s in spec:
            if s is not None:
                names.extend(s if isinstance(s, tuple) else (s,))
        assert len(names) == len(set(names))

    def test_a_tuple_entry_out_of_mesh_order_is_refused(self):
        with pytest.raises(ValueError):
            placements((("data", "pod"),), TMESH["multi"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [True, False])
def test_every_parameter_leaf_shards_as_in_jax(mesh, fsdp):
    jm, tm = JMESH[mesh], TMESH[mesh]
    for arch in configs.ARCH_NAMES:
        jmodel = jbuild(jconfigs.get_config(arch))
        tmodel = build(configs.get_config(arch))
        jabs, tabs = jmodel.abstract(), tmodel.abstract()
        assert jmodel.axes() == tmodel.axes(), arch
        want = _shard_shapes((jparam_shardings(
            jmodel.axes(), jabs, jdefault_rules(jm, fsdp=fsdp), jm), jabs),
            jm)
        specs = param_shardings(tmodel.axes(), tabs,
                                default_rules(tm, fsdp=fsdp), tm)
        got = _local_shapes(specs, tabs, tm)
        assert got == want, arch


def _cell_inputs(arch, shape, jm, tm):
    """(JAX shard shapes, port local shapes) of a cell's inputs, the
    cache by the model's cache axes, as the dry-runs place them."""
    jrules, trules = jdefault_rules(jm), default_rules(tm)
    jin = jconfigs.arch_input_specs(arch, shape)
    tin = configs.arch_input_specs(arch, shape)
    jsh = jdata_shardings(jin, jrules, jm)
    tsp = data_shardings(tin, trules, tm)
    if "cache" in jin:
        jsh["cache"] = jtree_shardings(
            jbuild(jconfigs.get_config(arch)).cache_axes(), jin["cache"],
            jrules, jm)
        tsp["cache"] = tree_shardings(
            build(configs.get_config(arch)).cache_axes(), tin["cache"],
            trules, tm)
    return _shard_shapes((jsh, jin), jm), _local_shapes(tsp, tin, tm)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cell_inputs_and_caches_shard_as_in_jax(mesh):
    jm, tm = JMESH[mesh], TMESH[mesh]
    for arch, shape, runs in configs.all_cells():
        if runs:
            want, got = _cell_inputs(arch, shape, jm, tm)
            assert got == want, (arch, shape)


@pytest.fixture
def fake_group():
    """Builds fake meshes (``launch.mesh.make_fake_mesh``) and tears the
    default process group down afterwards."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_fake_mesh
    yield make_fake_mesh
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dtensor_local_shapes_are_the_rules_shapes(fake_group, mesh):
    """On the production meshes over the fake backend, DTensor's own
    local shard of every ``meta`` parameter (``parallel.distribute``)
    has the shape ``local_shape`` gives (rank 0)."""
    from repro_torch.parallel import distribute
    shape, names = MESHES[mesh]
    dmesh = fake_group(shape, names)
    tm = TMESH[mesh]
    for arch in configs.ARCH_NAMES:
        model = build(configs.get_config(arch))
        abstract = model.abstract()
        specs = param_shardings(model.axes(), abstract, default_rules(tm),
                                tm)
        placed = distribute(abstract, specs, dmesh)
        want = _local_shapes(specs, abstract, tm)
        for p, t in leaf_paths(placed):
            assert tuple(t.to_local().shape) == want[p], (arch, p)
            assert tuple(t.shape) == tuple(
                dict(leaf_paths(abstract))[p].shape)


_OFFSETS = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np, jax, torch, torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.distributed.tensor import distribute_tensor
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.parallel import MeshShape, local_block, placements
names = ("pod", "data", "model")
jm = jax.make_mesh((2, 2, 2), names)
coords = {d.id: c for c, d in np.ndenumerate(jm.devices)}
cases = [((8, 4), (("pod", "data"), "model")), ((4, 6, 8), (None, "data")),
         ((16,), (("pod", "data", "model"),)), ((2, 4, 2), ("pod", None,
         "model")), ((4, 4), ("model", "data")), ((3, 5), ())]
tm = MeshShape(names, (2, 2, 2))
bad = []
for shape, spec in cases:
    idx = NamedSharding(jm, P(*spec)).devices_indices_map(shape)
    for dev, sl in idx.items():
        c = coords[dev.id]
        want = tuple((s.start or 0, s.stop if s.stop is not None else n)
                     for s, n in zip(sl, shape))
        got = tuple((s.start, s.stop) for s in local_block(shape, spec, tm,
                                                           c))
        if got != want:
            bad.append(("local_block", shape, spec, c, got, want))
    # DTensor's own block on each rank: a fake group per rank
    for rank in range(8):
        mesh = make_fake_mesh((2, 2, 2), names, rank=rank)
        c = tuple(mesh.get_coordinate())
        full = torch.arange(int(np.prod(shape))).reshape(shape)
        loc = distribute_tensor(full, mesh, placements(spec, mesh),
                                src_data_rank=None).to_local()
        sl = local_block(shape, spec, tm, c)
        if not torch.equal(loc, full[sl]):
            bad.append(("dtensor", shape, spec, c))
dist.destroy_process_group()
print(json.dumps(bad))
"""


def test_each_rank_holds_the_block_jax_gives_its_device():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _OFFSETS], cwd=REPO,
                         capture_output=True, text=True, timeout=240,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
