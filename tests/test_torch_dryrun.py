"""The port's dry-run (``repro_torch.launch.dryrun``, ``trace_analysis``,
``configs.shapes``) against the JAX package's: the shape cells and input
specs, the abstract parameters and optimizer state, the roofline terms
on an H100's rates, collective counting on a hand-built DTensor program,
and ``run_cell`` on reduced configs over fake (4, 8) and (2, 2, 8)
meshes, as the JAX machinery test traces them.  Every fake process
group is torn down by the ``fake_group`` fixture."""
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch.dryrun import model_flops_for as jmodel_flops_for
from repro.models import build as jbuild
from repro.models.params import param_bytes as jparam_bytes
from repro.parallel import data_shardings as jdata_shardings
from repro.parallel import default_rules as jdefault_rules
from repro.parallel import param_shardings as jparam_shardings
from repro.train import abstract_opt_state as jabstract_opt_state

import torch

from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.launch import dryrun
from repro_torch.launch.trace_analysis import (HBM_BW, NVLINK_BW,
                                               PEAK_BF16, Roofline,
                                               TraceCounter)
from repro_torch.models import build
from repro_torch.models.params import leaf_paths, param_bytes
from repro_torch.train import abstract_opt_state, make_train_step

REPO = Path(__file__).resolve().parent.parent


def _sd(tree):
    """{path: (shape, dtype name)} of a ShapeDtype / ShapeDtypeStruct
    tree."""
    return {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in leaf_paths(tree)}


def test_shape_cells_and_supported_cells_match_jax():
    assert {k: (c.name, c.seq_len, c.global_batch, c.mode)
            for k, c in shapes.SHAPES.items()} == \
        {k: (c.name, c.seq_len, c.global_batch, c.mode)
         for k, c in jshapes.SHAPES.items()}
    assert shapes.LONG_CONTEXT_ARCHS == jshapes.LONG_CONTEXT_ARCHS
    assert sorted(configs.all_cells()) == sorted(jconfigs.all_cells())


@pytest.mark.parametrize("reduced", [False, True])
def test_input_specs_match_jax(reduced):
    for arch, shape, runs in configs.all_cells():
        want = _sd(jconfigs.arch_input_specs(arch, shape, reduced=reduced))
        got = _sd(configs.arch_input_specs(arch, shape, reduced=reduced))
        assert got == want, (arch, shape)


def test_abstract_params_opt_state_trips_bytes_and_flops_match_jax():
    for arch in configs.ARCH_NAMES:
        jm, tm = jbuild(jconfigs.get_config(arch)), build(
            configs.get_config(arch))
        assert _sd(tm.abstract()) == _sd(jm.abstract()), arch
        assert tm.scan_trips() == jm.scan_trips(), arch
        assert param_bytes(tm.specs) == jparam_bytes(jm.specs), arch
        jo, to = jabstract_opt_state(jm.abstract()), abstract_opt_state(
            tm.abstract())
        assert _sd(to.mu) == _sd(jo.mu) and _sd(to.nu) == _sd(jo.nu)
        assert (tuple(to.step.shape), str(to.step.dtype)) == (
            tuple(jo.step.shape), "torch." + str(jo.step.dtype))
        for shape in shapes.SHAPES:
            assert dryrun.model_flops_for(
                tm.cfg, tm, shapes.SHAPES[shape]) == jmodel_flops_for(
                jm.cfg, jm, jshapes.SHAPES[shape]), (arch, shape)


def test_roofline_terms():
    """Twin of ``TestHloAnalysis::test_roofline_terms`` on an H100's
    rates: one second of each term."""
    r = Roofline(flops=PEAK_BF16, hbm_bytes=HBM_BW, coll_bytes=NVLINK_BW,
                 n_chips=1, model_flops=0.51 * PEAK_BF16)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 1.0) < 1e-9
    assert abs(r.collective_s - 1.0) < 1e-9
    assert 0.5 < r.useful_flops_frac < 0.52
    assert (PEAK_BF16, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert set(r.as_dict()) == {
        "flops", "hbm_bytes", "coll_bytes", "n_chips", "trips", "compute_s",
        "memory_s", "collective_s", "bound", "model_flops",
        "useful_flops_frac"}


@pytest.fixture
def fake_group():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_fake_mesh
    yield make_fake_mesh
    if dist.is_initialized():
        dist.destroy_process_group()


def test_collective_counting(fake_group):
    """Twin of ``TestHloAnalysis::test_collective_parsing``: a DTensor
    program with one all-gather, reduce-scatter, all-reduce and
    all-to-all on a fake 2 x 4 mesh; each counted once, at the result's
    bytes times the ring factor (2 for the all-reduce).  The all-to-all
    is counted as one though the CPU mesh emulates it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = fake_group((2, 4), ("data", "model"))

    def dt(local, pl):
        return DTensor.from_local(torch.empty(local, dtype=torch.bfloat16,
                                              device="meta"), mesh, pl,
                                  run_check=False)
    c = TraceCounter()
    with c:
        dt((4, 64), [Replicate(), Shard(0)]).redistribute(
            mesh, [Replicate(), Replicate()])             # all-gather
        dt((16, 64), [Replicate(), Partial()]).redistribute(
            mesh, [Replicate(), Shard(0)])                # reduce-scatter
        dt((8, 8), [Partial(), Replicate()]).redistribute(
            mesh, [Replicate(), Replicate()])             # all-reduce
        dt((4, 64), [Replicate(), Shard(0)]).redistribute(
            mesh, [Replicate(), Shard(1)])                # all-to-all
    assert c.coll.count_by_kind == {"all-gather": 1, "reduce-scatter": 1,
                                    "all-reduce": 1, "all-to-all": 1}
    assert c.coll.bytes_by_kind == {
        "all-gather": 16 * 64 * 2, "reduce-scatter": 4 * 64 * 2,
        "all-reduce": 2 * 8 * 8 * 2, "all-to-all": 4 * 64 * 2}


def _jax_arg_bytes(arch, shape, mesh_shape, names):
    """Per-device argument bytes of the JAX dry-run's train cell, summed
    from ``shard_shape``: params, AdamW moments by the params' specs, the
    step counter and the inputs by ``data_shardings``."""
    try:
        mesh = AbstractMesh(mesh_shape, names)
    except TypeError:
        mesh = AbstractMesh(tuple(zip(names, mesh_shape)))
    m = jbuild(jconfigs.get_reduced(arch))
    rules = jdefault_rules(mesh)
    ab = m.abstract()
    ps = jparam_shardings(m.axes(), ab, rules, mesh)

    def nbytes(shard_tree, tree, dtype=None):
        out = 0
        for (_, s), (_, x) in zip(leaf_paths(shard_tree), leaf_paths(tree)):
            dt = jnp.dtype(dtype or x.dtype)
            out += math.prod(s.shard_shape(tuple(x.shape))) * dt.itemsize
        return out
    inputs = jconfigs.arch_input_specs(arch, shape, reduced=True)
    return (nbytes(ps, ab) + 2 * nbytes(ps, ab, jnp.float32) + 4
            + nbytes(jdata_shardings(inputs, rules, mesh), inputs))


@pytest.mark.parametrize("mesh", [((4, 8), ("data", "model")),
                                  ((2, 2, 8), ("pod", "data", "model"))])
def test_run_cell_on_a_reduced_config(fake_group, mesh):
    rec = dryrun.run_cell("qwen3-1.7b", "train_4k", False, None,
                          reduced=True, mesh_axes=mesh)
    assert rec["n_chips"] == 32
    assert rec["roofline"]["flops"] > 0
    assert rec["roofline"]["trips"] == 2
    assert rec["memory"]["argument_bytes"] == _jax_arg_bytes(
        "qwen3-1.7b", "train_4k", *mesh)
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["roofline"]["coll_bytes"] > 0


def test_one_rank_trace_counts_the_real_step(fake_group):
    """The dry-run on a (1, 1) mesh counts the FLOPs of the same step run
    for real on the CPU (plain tensors, the same counter)."""
    cell = shapes.ShapeCell("tiny", 32, 2, "train")
    rec = dryrun.run_cell("qwen3-1.7b", cell, False, None, reduced=True,
                          mesh_axes=((1, 1), ("data", "model")))
    model = build(configs.get_reduced("qwen3-1.7b"))
    params = model.init(0, device="cpu")
    from repro_torch.optim import adamw_init
    opt = adamw_init(params)
    step = make_train_step(model, lr_fn=lambda s: 1e-3)
    batch = {"tokens": torch.randint(2, 200, (2, 32))}
    c = TraceCounter()
    with c:
        step(params, opt, batch)
    assert rec["roofline"]["flops"] == c.flops > 0


_JAX_CELL = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=32"
sys.path.insert(0, "src")
import jax
from jax.sharding import AxisType
import repro.launch.dryrun as dr
import repro.configs as C
dr.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (4, 8), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
dr.configs.get_config = C.get_reduced
rec = dr.run_cell("qwen3-1.7b", "train_4k", False, __import__("pathlib")
                  .Path(sys.argv[1]))
print(json.dumps([rec["roofline"]["flops"], rec["memory"]["argument_bytes"]]))
"""


def test_jax_cost_analysis_flops_are_logged_beside_the_trace(fake_group,
                                                             tmp_path):
    """XLA's per-device ``cost_analysis`` FLOPs of the same reduced cell
    (its scan body scaled by the trips, elementwise work counted) beside
    the port's traced count: logged, no tolerance.  JAX's compiled
    argument bytes equal the port's."""
    rec = dryrun.run_cell("qwen3-1.7b", "train_4k", False, None,
                          reduced=True,
                          mesh_axes=((4, 8), ("data", "model")))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", _JAX_CELL, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=240, env=dict(env, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    jflops, jargs = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"reduced qwen3-1.7b train_4k on 4 x 8: port traced "
          f"{rec['roofline']['flops']:.4e} FLOPs a device, XLA "
          f"cost_analysis {jflops:.4e}")
    assert jargs == rec["memory"]["argument_bytes"]


@pytest.mark.parametrize("arch", [
    "granite-moe-3b-a800m", "mamba2-780m", "recurrentgemma-2b",
    "seamless-m4t-large-v2", "chameleon-34b", "deepseek-v2-lite-16b"])
def test_each_family_traces_train_and_decode(fake_group, arch):
    """MoE, SSM, hybrid, encoder-decoder, VLM and MLA: a reduced cell at
    train_4k and at decode_32k on a fake (4, 8) mesh."""
    for shape in ("train_4k", "decode_32k"):
        rec = dryrun.run_cell(arch, shape, False, None, reduced=True,
                              mesh_axes=((4, 8), ("data", "model")))
        r = rec["roofline"]
        assert r["flops"] > 0 and r["hbm_bytes"] > 0, (arch, shape)
        assert rec["memory"]["peak_bytes"] >= \
            rec["memory"]["argument_bytes"] > 0


def test_decode_gathers_a_sequence_sharded_cache(fake_group):
    """Reduced qwen3-1.7b's 2 KV heads do not divide an 8-way model axis,
    so the rules shard the decode cache's sequence over "model" (as in
    JAX); the port's attention gathers each layer's K and V before it
    attends (ROADMAP B.7), XLA would not: the all-gathers carry at least
    the whole cache of the rank's rows."""
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", False, None,
                          reduced=True,
                          mesh_axes=((4, 8), ("data", "model")))
    cfg = configs.get_reduced("qwen3-1.7b")
    rows = shapes.SHAPES["decode_32k"].global_batch // 4
    cache = (2 * cfg.n_layers * rows * cfg.n_kv_heads * 32768
             * cfg.resolved_head_dim * 2)           # k and v, bf16
    assert rec["collectives"]["bytes_by_kind"]["all-gather"] >= cache
