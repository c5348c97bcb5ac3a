"""The port's launchers on the training path, on the CPU:
``python -m repro_torch.launch.train`` (the loss drops; ``--resume``
continues exactly where an uninterrupted run would be, as the JAX
package's ``test_system.py::TestTrainLoop`` checks for its trainer) and
``launch.serve --ckpt-dir`` (a checkpoint the port's trainer wrote and
one the JAX package's wrote are served with the same tokens as the same
params passed to the engine directly; the default directory
``checkpoints/<config name>`` is read when present)."""
import numpy as np

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JaxManager
from repro.data import make_dataset as jax_dataset
from repro.models import build as jax_build
from repro.optim import adamw_init as jax_adamw_init
from repro.train import make_train_step as jax_train_step

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import build, from_jax_numpy
from repro_torch.serve import Request, ServingEngine

ARCH = "qwen3-1.7b"
TRAIN = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4",
         "--seq", "64", "--log-every", "10"]
SERVE = ["--arch", ARCH, "--reduced", "--device", "cpu", "--engine",
         "dense", "--requests", "3", "--max-new-tokens", "6",
         "--max-len", "64", "--slots", "2"]


def test_train_loss_drops_and_resume_continues_the_same_run(tmp_path):
    args = TRAIN + ["--steps", "30", "--ckpt-dir", str(tmp_path / "a"),
                    "--ckpt-every", "15"]
    losses = train_mod.main(args)
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert CheckpointManager(tmp_path / "a").latest_step() == 30
    # resume from step 30's checkpoint: params, optimizer and data state
    resumed = train_mod.main(args + ["--resume", "--steps", "35"])
    assert len(resumed) == 5
    # the same five steps of one uninterrupted run, bit for bit
    whole = train_mod.main(TRAIN + ["--steps", "35", "--ckpt-dir",
                                    str(tmp_path / "b"), "--ckpt-every",
                                    "100"])
    assert resumed == whole[30:]


def _serve_directly(params):
    """The launcher's dense engine and requests (``SERVE``), with
    ``params`` handed to the engine."""
    cfg = tconfigs.get_reduced(ARCH)
    eng = ServingEngine(build(cfg), params, n_slots=2, max_len=64,
                        eos_id=-1, device="cpu")
    rng = np.random.default_rng(0)
    for rid in range(3):
        plen = int(rng.integers(4, 64 // 4))
        eng.submit(Request(rid, rng.integers(2, cfg.vocab, size=plen)
                           .tolist(), max_new_tokens=6))
    return _outputs(eng.run())


def _outputs(done):
    return {r.rid: list(r.output) for r in done}


def test_serve_restores_a_checkpoint_the_port_trained(tmp_path, capsys):
    ck = tmp_path / "ck"
    train_mod.main(TRAIN + ["--steps", "6", "--lr", "3e-2", "--ckpt-dir",
                            str(ck), "--ckpt-every", "3"])
    fresh = _outputs(serve_mod.main(SERVE + ["--ckpt-dir",
                                             str(tmp_path / "none")]))
    assert not (tmp_path / "none").exists()
    capsys.readouterr()
    got = _outputs(serve_mod.main(SERVE + ["--ckpt-dir", str(ck)]))
    assert f"restored step 6 from {ck}" in capsys.readouterr().out
    model = build(tconfigs.get_reduced(ARCH))
    params = CheckpointManager(ck).restore(
        {"params": model.init(0, device="cpu")}, device="cpu")["params"]
    assert got == _serve_directly(params)
    assert got != fresh


def test_serve_restores_a_checkpoint_the_jax_package_trained(
        tmp_path, capsys, monkeypatch):
    """One jitted JAX train step from the JAX init, saved by the JAX
    manager into the default directory ``checkpoints/<config name>``
    (under a scratch working directory): the port's launcher serves it
    with no ``--ckpt-dir``."""
    jcfg = jconfigs.get_reduced(ARCH)
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(1))
    opt = jax_adamw_init(params)
    ds = jax_dataset(jcfg, seq_len=32, global_batch=2)
    step = jax.jit(jax_train_step(jm, lr_fn=lambda s: 1e-3))
    params, opt, _ = step(params, opt, jax.tree.map(jnp.asarray, next(ds)))
    monkeypatch.chdir(tmp_path)
    mgr = JaxManager(f"checkpoints/{jcfg.name}", async_save=False)
    mgr.save(1, {"params": params, "opt": opt, "data": ds.state(),
                 "meta": {"step": 1}})
    capsys.readouterr()
    got = _outputs(serve_mod.main(SERVE))
    assert "restored step 1 from checkpoints/qwen3-1.7b-smoke" in \
        capsys.readouterr().out
    want = _serve_directly(from_jax_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))
    assert got == want
