"""The port's train step on DTensors across two gloo ranks ((2, 1) mesh,
fsdp off, as the launcher places them) against the JAX package's jitted
step on the full batch; checkpoints crossing between ranks and one
process.  The setup and the tolerances are ``tests/dist_cases.py``'s."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.params import leaf_paths
from repro_torch.optim import adamw_init

from dist_cases import PARAM_TOL, STEPS, match_jax, run_ranks, setup


@pytest.mark.parametrize("compress", ["none", "bf16"])
def test_two_ranks_match_the_jitted_jax_step(tmp_path, compress):
    pl = match_jax(tmp_path, "qwen3-1.7b", 2, 1, False, compress, 2)
    # data parallel: the size-1 model axis is named as in JAX
    assert pl["blocks/attn/wq"] == ["R", "S2"]


# The jitted JAX step on a CPU mesh of N devices, placed as the JAX
# launcher places it (rules without fsdp, the batch over "data", the
# activation spec installed): its parameters and first moments, and the
# element types of the all-reduces in its compiled program.
JAX_MESH_STEP = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro import configs
from repro.models import build
from repro.optim import adamw_init, cosine_schedule
from repro.parallel.api import set_activation_spec
from repro.parallel.sharding import (data_shardings, default_rules,
                                     param_shardings)
from repro.train import make_train_step
d, accum, compress, steps = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    int(sys.argv[4])
model = build(dataclasses.replace(configs.get_reduced("qwen3-1.7b"),
                                  dtype="float32"))
params = {}
for k, v in np.load(d + "/weights.npz").items():
    node = params
    *head, last = k.split("/")
    for h in head:
        node = node.setdefault(h, {})
    node[last] = jnp.asarray(v)
mesh = jax.make_mesh((len(jax.devices()), 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
rules = default_rules(mesh, fsdp=False)
set_activation_spec(P("data", None, None))
ps = param_shardings(model.axes(), params, rules, mesh)
params = jax.device_put(params, ps)
opt = adamw_init(params)
step = jax.jit(make_train_step(
    model, lr_fn=lambda s: cosine_schedule(s, peak_lr=1e-3, warmup=2,
                                           total=10),
    grad_accum=accum, compress_grads=compress))
bs = np.load(d + "/batches.npz")
with jax.set_mesh(mesh):
    for i in range(steps):
        batch = {"tokens": jnp.asarray(bs[f"b{i}"])}
        batch = jax.device_put(batch, data_shardings(batch, rules, mesh))
        hlo = step.lower(params, opt, batch).compile().as_text()
        params, opt, _ = step(params, opt, batch)
out = {}
for pre, tree in (("params/", params), ("mu/", opt.mu)):
    for path, v in jax.tree_util.tree_leaves_with_path(tree):
        out[pre + "/".join(k.key for k in path)] = np.asarray(v, np.float32)
np.savez(d + "/mesh.npz", **out)
print(json.dumps(hlo))
"""


def test_jax_mesh_step_reduces_each_microbatch(tmp_path):
    """Pins the difference from JAX behind ``dist_cases.UPDATE_TOL``: with
    bf16 accumulation the jitted JAX step on a CPU mesh of two devices
    reduces each microbatch's gradient in its own dtype (float32: no
    bf16 all-reduce in the compiled program) and so gives the
    single-device step's result within ``PARAM_TOL``, where the port's
    ranks accumulate in bf16 and reduce once."""
    want, _ = setup(tmp_path, "qwen3-1.7b", 2, "bf16")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    run = subprocess.run(
        [sys.executable, "-c", JAX_MESH_STEP, str(tmp_path), "2", "bf16",
         str(STEPS)], capture_output=True, text=True, env=env, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    hlo = json.loads(run.stdout.strip().splitlines()[-1])
    types = [re.findall(r"([a-z]+[0-9]*)\[", line.split(" all-reduce(")[0])
             for line in hlo.splitlines() if " all-reduce(" in line]
    assert types and {t for ts in types for t in ts} == {"f32"}, types
    got = dict(np.load(tmp_path / "mesh.npz"))
    assert set(got) == set(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= PARAM_TOL * max(1.0, float(np.abs(w).max())), (k, err)


def test_checkpoints_cross_between_ranks_and_one_process(tmp_path):
    """A checkpoint one process wrote restores on 2 ranks, each holding
    its bit-identical block (the launcher's restore-then-distribute); the
    state those ranks train on is written back with full tensors and
    restores bit-identically in one process."""
    setup(tmp_path, "qwen3-1.7b", 1, "none")
    from repro_torch import configs
    from repro_torch.models import from_jax_numpy
    import dataclasses
    cfg = dataclasses.replace(configs.get_reduced("qwen3-1.7b"),
                              dtype="float32")
    flat = dict(np.load(tmp_path / "weights.npz"))
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    params = from_jax_numpy(tree, device="cpu")
    opt = adamw_init(params)
    mgr = CheckpointManager(tmp_path / "ck1")
    mgr.save(0, {"params": params, "opt": opt, "meta": {"step": 0}})
    mgr.wait()
    got, _ = run_ranks(tmp_path, 2, 1, arch="qwen3-1.7b", fsdp=False,
                       compress=None, grad_accum=1,
                       ckpt_in=str(tmp_path / "ck1"),
                       ckpt_out=str(tmp_path / "ck2"))
    for r in range(2):
        local = dict(np.load(tmp_path / f"out_local{r}.npz"))
        for p, t in leaf_paths(params):      # (2, 1) mesh, fsdp off:
            assert np.array_equal(local["/".join(p)],   # replicated
                                  t.numpy()), p
    back = CheckpointManager(tmp_path / "ck2").restore(
        {"params": params, "opt": opt}, device="cpu")
    assert int(back["meta"]["step"]) == STEPS
    for p, t in leaf_paths(back["params"]):
        assert np.array_equal(t.numpy(), got["params/" + "/".join(p)]), p
