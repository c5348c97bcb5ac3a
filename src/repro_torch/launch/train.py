"""Training launcher, on a CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --steps 200 --batch 8 --seq 128 [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --reduced --steps 50 --resume

The port of the JAX package's ``launch/train.py``, with its flags and
``--device`` (``cpu`` runs on the CPU).  It builds the model, initialises
its weights from ``--seed`` with ``torch.Generator``s, draws batches from
the deterministic data pipeline and runs the train step eagerly on one
device: the step takes the params and optimizer state and returns new
ones, and the loop drops the old ones by reassignment (the JAX launcher
donates them to its jitted step).  Checkpoints (``--ckpt-dir``, default
``checkpoints/<config name>``, every ``--ckpt-every`` steps and on
preemption) hold params, optimizer state and the data iterator's state;
``--resume`` restores all three from the latest one.  The preemption
handler and the straggler monitor run as in JAX.  ``--dispatch-table``
installs a fleet tuner's table through ``repro_torch.core.tuning``, as
the JAX launcher does; the train step reaches no kernel, so nothing
reads it there.

The JAX launcher's host mesh and its parameter and data shardings are
left out: the port has no sharding yet (ROADMAP item A10).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import make_dataset
from repro_torch.device import resolve_device
from repro_torch.ft import PreemptionHandler, StepTimer, StragglerMonitor
from repro_torch.models import build
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.train import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", default="bf16",
                    choices=["bf16", "none"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dispatch-table", default=None,
                    help="fleet tuner dispatch_table.json with tuned "
                         "kernel configs (python -m "
                         "repro_torch.launch.tune)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.dispatch_table:
        # tuned kernel configs for any validated kernel the step reaches
        from repro_torch.core.tuning import install, load_dispatch_table
        table = install(load_dispatch_table(args.dispatch_table))
        print(f"dispatch table: {table.summary()}")

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    model = build(cfg)
    print(f"arch={cfg.name} params={model.n_params:,} "
          f"active={model.n_active_params:,}")

    ds = make_dataset(cfg, seq_len=args.seq, global_batch=args.batch,
                      seed=args.seed)
    params = model.init(args.seed, device=device)
    opt = adamw_init(params)
    start_step = 0

    ckpt_dir = args.ckpt_dir or f"checkpoints/{cfg.name}"
    mgr = CheckpointManager(ckpt_dir, keep=3)
    if args.resume and mgr.latest_step() is not None:
        state = mgr.restore({"params": params, "opt": opt,
                             "data": ds.state()}, device=device)
        params, opt = state["params"], state["opt"]
        ds.restore({k: int(v) for k, v in state["data"].items()})
        start_step = int(state["meta"]["step"])
        print(f"resumed from step {start_step}")

    lr_fn = lambda s: cosine_schedule(s, peak_lr=args.lr, warmup=20,
                                      total=max(args.steps, 100))
    step_fn = make_train_step(
        model, lr_fn=lr_fn, grad_accum=args.grad_accum,
        compress_grads=None if args.compress_grads == "none" else "bf16")

    pre = PreemptionHandler()
    mon = StragglerMonitor()
    host = "host0"
    losses = []
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(ds).items()}
            with StepTimer() as t:
                params, opt, metrics = step_fn(params, opt, batch)
                loss = float(metrics["loss"])
            mon.record(host, t.last)
            mon.check()
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['gnorm']):7.3f} "
                      f"{t.last*1e3:7.1f} ms", flush=True)
            want_ckpt = (step + 1) % args.ckpt_every == 0 or pre.preempted
            if want_ckpt:
                mgr.save(step + 1, {"params": params, "opt": opt,
                                    "data": ds.state(),
                                    "meta": {"step": step + 1}})
            if pre.preempted:
                print("preemption requested: checkpointed, exiting")
                break
        mgr.wait()
    finally:
        pre.restore()
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
