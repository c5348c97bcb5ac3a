"""Training launcher, on a CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --steps 200 --batch 8 --seq 128 [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --reduced --steps 50 --resume
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch qwen3-1.7b --reduced --device cpu

The port of the JAX package's ``launch/train.py``, with its flags and
``--device`` (``cpu`` runs on the CPU).  It builds the model, initialises
its weights from ``--seed`` with ``torch.Generator``s, draws batches from
the deterministic data pipeline and runs the train step eagerly: the
step takes the params and optimizer state and returns new ones, and the
loop drops the old ones by reassignment (the JAX launcher donates them
to its jitted step).  Checkpoints (``--ckpt-dir``, default
``checkpoints/<config name>``, every ``--ckpt-every`` steps and on
preemption) hold params, optimizer state and the data iterator's state;
``--resume`` restores all three from the latest one.  The preemption
handler and the straggler monitor run as in JAX.  ``--dispatch-table``
installs a fleet tuner's table through ``repro_torch.core.tuning``, as
the JAX launcher does; the train step reaches no kernel, so nothing
reads it there.

Under ``torch.distributed.run`` (``WORLD_SIZE`` set) every process is a
rank: the launcher creates the process group (``nccl`` for a CUDA
device, each rank on its local card; ``gloo`` for ``--device cpu``),
builds the host mesh (``launch/mesh.py``: (world, 1) over "data",
"model"), takes the JAX launcher's rules (``default_rules(mesh,
fsdp=False)``), distributes the parameters and the optimizer state as
DTensors by ``param_shardings`` and gives each data rank its rows of the
deterministic global batch.  Rank 0 logs and writes the checkpoints, in
the JAX package's format with full tensors, so a checkpoint written by N
ranks restores in one process and the other way round.  One process
without ``torch.distributed.run`` runs as a single device.
"""
from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field
from typing import Any, List

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import make_dataset
from repro_torch.device import resolve_device
from repro_torch.ft import PreemptionHandler, StepTimer, StragglerMonitor
from repro_torch.models import build
from repro_torch.optim import AdamWState, adamw_init, cosine_schedule
from repro_torch.parallel import (data_shardings, default_rules, distribute,
                                  full_tensor, implicit_replication,
                                  param_shardings, set_activation_spec)
from repro_torch.train import make_train_step


def parse_args(argv=None):
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
    return ap.parse_args(argv)


@dataclass
class TrainRun:
    """What a run leaves: the losses, each step's time on the host clock
    (ms), the final params and optimizer state (DTensors on a mesh), the
    step function, the dataset, the mesh (None in one process) and, on a
    card, the peak memory of the steps (bytes)."""
    losses: List[float]
    step_ms: List[float]
    params: Any
    opt: Any
    step_fn: Any
    ds: Any
    mesh: Any
    device: torch.device
    peak_bytes: int = 0
    put_batch: Any = field(default=None, repr=False)


def _host(x) -> float:
    """A metric as a Python float (a DTensor's full value)."""
    return float(x.full_tensor() if hasattr(x, "full_tensor") else x)


def _init_distributed(device: torch.device):
    """The process group of a ``torch.distributed.run`` launch, and the
    rank's device."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend)
    return device


def _replicating(step_fn):
    """``step_fn`` run under ``implicit_replication()``: the plain tensors
    the model builds from shapes and positions (rope tables, masks,
    position ranges) meet the DTensor activations as replicated ones."""
    def step(*args):
        with implicit_replication():
            return step_fn(*args)
    return step


def run(args) -> TrainRun:
    """The training loop of :func:`main` (which also tears down the
    process group a distributed launch created)."""
    device = resolve_device(args.device)
    distributed = "WORLD_SIZE" in os.environ
    rank = 0
    if distributed:
        from repro_torch.launch.mesh import make_host_mesh
        device = _init_distributed(device)
        rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)

    if args.dispatch_table:
        # tuned kernel configs for any validated kernel the step reaches
        from repro_torch.core.tuning import install, load_dispatch_table
        table = install(load_dispatch_table(args.dispatch_table))
        say(f"dispatch table: {table.summary()}")

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    model = build(cfg)
    say(f"arch={cfg.name} params={model.n_params:,} "
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
        say(f"resumed from step {start_step}")

    mesh = None
    put_batch = lambda b: b
    if distributed:
        mesh = make_host_mesh()
        rules = default_rules(mesh, fsdp=False)
        b = rules.batch_axes
        set_activation_spec((b if len(b) > 1 else b[0], None, None))
        p_spec = param_shardings(model.axes(), params, rules, mesh)
        params = distribute(params, p_spec, mesh)
        opt = AdamWState(distribute(opt.step, (), mesh),
                         distribute(opt.mu, p_spec, mesh),
                         distribute(opt.nu, p_spec, mesh))
        put_batch = lambda b: distribute(b, data_shardings(b, rules, mesh),
                                         mesh)
        say(f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} over "
            f"{dist.get_world_size()} ranks ({dist.get_backend()})")

    def snapshot():
        if mesh is None:
            return params, opt
        return full_tensor(params), AdamWState(*(full_tensor(t) for t in opt))

    lr_fn = lambda s: cosine_schedule(s, peak_lr=args.lr, warmup=20,
                                      total=max(args.steps, 100))
    step_fn = make_train_step(
        model, lr_fn=lr_fn, grad_accum=args.grad_accum,
        compress_grads=None if args.compress_grads == "none" else "bf16")
    if mesh is not None:
        step_fn = _replicating(step_fn)

    pre = PreemptionHandler()
    mon = StragglerMonitor()
    host = f"host{rank}"
    losses, step_ms = [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        for step in range(start_step, args.steps):
            batch = put_batch({k: torch.from_numpy(v).to(device)
                               for k, v in next(ds).items()})
            with StepTimer() as t:
                params, opt, metrics = step_fn(params, opt, batch)
                loss = _host(metrics["loss"])
            mon.record(host, t.last)
            mon.check()
            losses.append(loss)
            step_ms.append(t.last * 1e3)
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"step {step:5d} loss {loss:8.4f} "
                    f"lr {_host(metrics['lr']):.2e} "
                    f"gnorm {_host(metrics['gnorm']):7.3f} "
                    f"{t.last*1e3:7.1f} ms", flush=True)
            want_ckpt = (step + 1) % args.ckpt_every == 0 or pre.preempted
            if want_ckpt:
                p_full, o_full = snapshot()    # every rank gathers
                if rank == 0:
                    mgr.save(step + 1, {"params": p_full, "opt": o_full,
                                        "data": ds.state(),
                                        "meta": {"step": step + 1}})
                del p_full, o_full
            if pre.preempted:
                say("preemption requested: checkpointed, exiting")
                break
        mgr.wait()
        if distributed:
            dist.barrier()        # rank 0's checkpoint is on disk
    finally:
        pre.restore()
    say(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return TrainRun(losses, step_ms, params, opt, step_fn, ds, mesh, device,
                    peak, put_batch)


def main(argv=None):
    args = parse_args(argv)
    try:
        return run(args).losses
    finally:
        if "WORLD_SIZE" in os.environ and dist.is_initialized():
            set_activation_spec(None)
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
