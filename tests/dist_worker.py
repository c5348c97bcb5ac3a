"""One gloo rank of ``tests/test_torch_train_dist.py`` (not a test file).

    python tests/dist_worker.py CASE.json RANK

``CASE.json`` names the world size, the mesh shape, the rules' fsdp
switch, the train-step knobs, the process group's ``file://`` store and
the npz files to read (float32 weights, batches) and write.  The rank
builds the port's reduced model, distributes the weights as DTensors by
the port's sharding rules, runs the train step on its rows of each
global batch and, on rank 0, writes the full parameters, moments and
metrics.  With ``"ckpt_in"`` it first restores a checkpoint written by
one process, as the launcher does, and writes each rank's local blocks;
with ``"ckpt_out"`` rank 0 writes the trained state as a checkpoint.
Imports torch and the port only."""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import build, from_jax_numpy  # noqa: E402
from repro_torch.models.params import leaf_paths  # noqa: E402
from repro_torch.optim import (AdamWState, adamw_init,  # noqa: E402
                               cosine_schedule)
from repro_torch.parallel import (data_shardings, default_rules,  # noqa
                                  distribute, full_tensor,
                                  implicit_replication, param_shardings,
                                  set_activation_spec)
from repro_torch.train import make_train_step  # noqa: E402


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _flat(tree, prefix="", out=None):
    out = {} if out is None else out
    for path, leaf in leaf_paths(tree):
        out[prefix + "/".join(path)] = leaf.detach().float().numpy()
    return out


def main(case_path: str, rank: int) -> None:
    case = json.loads(Path(case_path).read_text())
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=case["store"], rank=rank,
                            world_size=case["world"])
    try:
        mesh = make_host_mesh(model=case["model"])
        rules = default_rules(mesh, fsdp=case["fsdp"])
        b = rules.batch_axes
        set_activation_spec((b if len(b) > 1 else b[0], None, None))
        import dataclasses
        cfg = dataclasses.replace(configs.get_reduced(case["arch"]),
                                  dtype="float32")
        model = build(cfg)
        params = from_jax_numpy(_unflat(dict(np.load(case["weights"]))),
                                device="cpu")
        opt = adamw_init(params)
        if case.get("ckpt_in"):
            st = CheckpointManager(case["ckpt_in"]).restore(
                {"params": params, "opt": opt}, device="cpu")
            params, opt = st["params"], st["opt"]
        spec = param_shardings(model.axes(), params, rules, mesh)
        params = distribute(params, spec, mesh)
        opt = AdamWState(distribute(opt.step, (), mesh),
                         distribute(opt.mu, spec, mesh),
                         distribute(opt.nu, spec, mesh))
        if case.get("ckpt_in"):
            local = {"/".join(p): t.to_local().numpy()
                     for p, t in leaf_paths(params)}
            np.savez(case["out"].replace(".npz", f"_local{rank}.npz"),
                     **local)
        step = make_train_step(
            model, lr_fn=lambda s: cosine_schedule(
                s, peak_lr=1e-3, warmup=2, total=10),
            grad_accum=case["grad_accum"],
            compress_grads=case["compress"])
        batches = np.load(case["batches"])
        mets = []
        for i in range(case["steps"]):
            batch = {"tokens": torch.from_numpy(batches[f"b{i}"])}
            batch = distribute(batch, data_shardings(batch, rules, mesh),
                               mesh)
            with implicit_replication():     # as the launcher's step
                params, opt, met = step(params, opt, batch)
            mets.append({k: float(v.full_tensor() if hasattr(
                v, "full_tensor") else v) for k, v in met.items()})
        p_full = full_tensor(params)
        o_full = AdamWState(*(full_tensor(t) for t in opt))
        if rank == 0:
            out = _flat(p_full, "params/")
            _flat(o_full.mu, "mu/", out)
            np.savez(case["out"], **out)
            Path(case["out"] + ".json").write_text(json.dumps(
                {"metrics": mets, "placements": {
                    "/".join(p): [f"S{x.dim}" if x.is_shard() else "R"
                                  for x in t.placements]
                    for p, t in leaf_paths(params)}}))
            if case.get("ckpt_out"):
                mgr = CheckpointManager(case["ckpt_out"])
                mgr.save(int(o_full.step), {
                    "params": p_full, "opt": o_full,
                    "meta": {"step": int(o_full.step)}})
                mgr.wait()
        dist.barrier()
    finally:
        set_activation_spec(None)
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
