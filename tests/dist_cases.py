"""Shared setup of ``tests/test_torch_train_dist*.py``: the port's train
step on DTensors across gloo ranks on the CPU, against the JAX package's
jitted step on the full batch.  Not a test file.

Each multi-rank case starts its ranks as processes of
``tests/dist_worker.py`` on a ``file://`` store in ``tmp_path`` (no
port); the schedule is ``test_torch_train.py``'s (cosine, peak 1e-3,
warmup 2, total 10); the weights are the port's seeded float32 init of
the reduced architecture, carried to JAX (``train_cases.pair``).  Tolerances are
``tests/test_torch_train.py``'s: parameters and first moments within
``PARAM_TOL`` (1e-5) of max(1, the leaf's largest |value|) after the
last step, the loss within 1e-5 of its value and the gradient norm within
1e-4 at every step (measured: 1.2e-7 in the parameters: the ranks' sum
and the sharded matmuls add in other orders than XLA's single-device
program).  Four steps, so that the last loss read follows two updates at
a non-zero rate.  Where microbatch gradients accumulate in bf16 the
ranks reduce other sums than JAX does (``UPDATE_TOL`` below)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from repro.optim import adamw_init as jax_adamw_init
from repro.optim import cosine_schedule as jax_cosine
from repro.train import make_train_step as jax_train_step

from repro_torch.data import make_dataset
from repro_torch.models.params import leaf_paths

from train_cases import pair

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "dist_worker.py"
PARAM_TOL = 1e-5
# With bf16 accumulation the port's ranks round their own partial
# gradients to bf16, accumulate them and sum the ranks in bf16 once (the
# halved all-reduce).  XLA cannot carry a pending sum across the scan:
# the jitted JAX step on a CPU mesh of the same shape all-reduces each
# microbatch's gradient in its own dtype (float32 here) inside the loop,
# and gives the single-device step's result to 4e-6
# (``test_jax_mesh_step_reduces_each_microbatch``).  An element whose
# partials cancel can then take the other sign in the port, and AdamW's
# normalised step moves it by up to the rate either way, so the
# parameters and first moments are held by norm, leaf by leaf: the
# update ``p_last - p_0`` (and ``mu``) within ``UPDATE_TOL`` of JAX's,
# relative to the norm of JAX's.  An update that did nothing or went
# the wrong way is off by 1 or 2.  Measured: 4.7e-3 (embed/tok) on 2
# ranks and on 4, 6.7e-3 (ln_ffn/scale) on granite's 4.  The gradient
# norm moves by at most a bf16 step (2^-8 of it); the loss at 1e-5 as
# above, but for the last step's, which follows the updates that differ:
# ``LAST_LOSS_TOL`` (measured: 9.3e-6 on 2 ranks, 8.0e-6 and 7.1e-6 on 4).
UPDATE_TOL = 2e-2
LAST_LOSS_TOL = 5e-5
STEPS, B, S = 4, 4, 16
# test_torch_train.py's schedule (the workers use the port's)
LR = dict(peak_lr=1e-3, warmup=2, total=10)


def _np_tree(tree, prefix=""):
    return {prefix + "/".join(p): np.asarray(v.astype(jnp.float32))
            for p, v in leaf_paths(jax.tree.map(lambda a: a, tree))}


def setup(tmp_path, arch, grad_accum, compress):
    """Weights and batches for the ranks, and the JAX step's results."""
    jm, jp, tm, tp = pair(arch, "float32")
    np.savez(tmp_path / "weights.npz", **{
        "/".join(p): t.detach().numpy() for p, t in leaf_paths(tp)})
    ds = make_dataset(tm.cfg, seq_len=S, global_batch=B, seed=1)
    batches = {f"b{i}": next(ds)["tokens"] for i in range(STEPS)}
    np.savez(tmp_path / "batches.npz", **batches)
    jstep = jax.jit(jax_train_step(jm, lr_fn=lambda s: jax_cosine(s, **LR),
                                   grad_accum=grad_accum,
                                   compress_grads=compress))
    jo = jax_adamw_init(jp)
    mets = []
    for i in range(STEPS):
        jp, jo, met = jstep(jp, jo, {"tokens": jnp.asarray(
            batches[f"b{i}"])})
        mets.append({k: float(v) for k, v in met.items()})
    want = _np_tree(jp, "params/")
    want.update(_np_tree(jo.mu, "mu/"))
    return want, mets


def run_ranks(tmp_path, world, model, **case):
    """Start ``world`` worker ranks on one case; returns rank 0's npz and
    json outputs."""
    case = dict(world=world, model=model, steps=STEPS,
                store=f"file://{tmp_path}/store",
                weights=str(tmp_path / "weights.npz"),
                batches=str(tmp_path / "batches.npz"),
                out=str(tmp_path / "out.npz"), **case)
    path = tmp_path / "case.json"
    path.write_text(json.dumps(case))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(path),
                               str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return (dict(np.load(case["out"])),
            json.loads(Path(case["out"] + ".json").read_text()))


def check(got, meta, want, mets, gnorm_rel=1e-4, start=None):
    """The metrics at every step, then every parameter and first moment
    elementwise within ``PARAM_TOL``, or, given the starting weights
    ``start`` (bf16 accumulation), by norm within ``UPDATE_TOL`` (the
    update of a parameter) and the last loss within ``LAST_LOSS_TOL``."""
    for i, (g, w) in enumerate(zip(meta["metrics"], mets)):
        loss_rel = 1e-5 if start is None or i < len(mets) - 1 \
            else LAST_LOSS_TOL
        for k, rel in (("loss", loss_rel), ("ce", loss_rel),
                       ("gnorm", gnorm_rel)):
            assert abs(g[k] - w[k]) <= rel * abs(w[k]), (i, k, g[k], w[k])
    assert set(got) == set(want)
    for k, w in want.items():
        if start is None:
            scale = max(1.0, float(np.abs(w).max()))
            err = float(np.abs(got[k] - w).max())
            assert err <= PARAM_TOL * scale, (k, err)
            continue
        g = got[k]
        if k.startswith("params/"):
            g, w = g - start[k[len("params/"):]], w - start[k[len("params/"):]]
        err = float(np.linalg.norm(g - w))
        assert err <= UPDATE_TOL * float(np.linalg.norm(w)), (
            k, err, float(np.linalg.norm(w)))


def match_jax(tmp_path, arch, world, model, fsdp, compress, accum):
    """Run one case on ``world`` ranks and hold it to the JAX step;
    returns the parameters' placements (as "S<dim>" / "R" per mesh
    dim)."""
    want, mets = setup(tmp_path, arch, accum, compress)
    got, meta = run_ranks(tmp_path, world, model, arch=arch, fsdp=fsdp,
                          compress=None if compress == "none" else compress,
                          grad_accum=accum)
    if accum > 1 and compress == "bf16":
        check(got, meta, want, mets, gnorm_rel=2 ** -8,
              start=dict(np.load(tmp_path / "weights.npz")))
    else:
        check(got, meta, want, mets)
    return meta["placements"]
