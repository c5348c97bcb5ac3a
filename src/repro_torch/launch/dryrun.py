"""Multi-pod dry-run driver — the port of the JAX package's
``launch/dryrun.py``.

For every (architecture x input shape x mesh) cell it builds the
production mesh over PyTorch's fake process-group backend (256 or 512
ranks, this process rank 0), places ``meta`` parameters, optimizer state
and inputs as DTensors by the sharding rules, and runs the train,
prefill or decode step eagerly on them: no memory and no data, but
every op DTensor runs on rank 0's local shards, and every collective it
asks for.  :class:`~repro_torch.launch.trace_analysis.TraceCounter`
counts them per device, in place of XLA's ``memory_analysis``,
``cost_analysis`` and the partitioned HLO:

    memory    — argument bytes (the local shards of params, optimizer
                state and inputs) and the peak of the live local bytes;
    roofline  — FLOPs, HBM bytes and collective bytes per device, over
                an H100's rates (``trace_analysis``).

``trace_s`` takes the place of the JAX record's ``lower_s`` and
``compile_s``.  A decode cell's ``pos`` is a Python int (the cache's
last position): the port's cache write reads its offset on the host.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
Outputs one JSON per cell under experiments/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence, Union

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeCell, supports_cell
from repro_torch.launch import trace_analysis
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh
from repro_torch.models import build
from repro_torch.optim import cosine_schedule
from repro_torch.parallel import (data_shardings, default_rules, distribute,
                                  implicit_replication, param_shardings,
                                  set_activation_spec, tree_shardings)
from repro_torch.parallel.api import set_state_rules
from repro_torch.train import (abstract_opt_state, make_prefill_step,
                               make_serve_step, make_train_step)


def model_flops_for(cfg, model, cell) -> float:
    n = model.n_active_params
    if cell.mode == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.mode == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch  # decode: one token per sequence


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def run_cell(arch: str, shape: Union[str, ShapeCell], multi_pod: bool,
             outdir: Optional[Path], grad_accum: int = 1, *,
             reduced: bool = False,
             mesh_axes: Optional[Sequence] = None) -> dict:
    """Trace one cell and return (and, with ``outdir``, write) its record.
    ``shape``: a ``SHAPES`` name or a ShapeCell; ``reduced``: the arch's
    reduced config; ``mesh_axes`` = (shape, names): a fake mesh of that
    shape in place of the production mesh."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    model = build(cfg)
    mesh = (make_fake_mesh(*mesh_axes) if mesh_axes is not None
            else make_production_mesh(multi_pod=multi_pod))
    rules = default_rules(mesh)
    n_chips = mesh.size()
    t0 = time.time()

    b_axes = rules.batch_axes
    set_activation_spec((b_axes if len(b_axes) > 1 else b_axes[0],
                         None, None))
    set_state_rules(rules)
    counter = trace_analysis.TraceCounter()
    try:
        abstract = model.abstract()
        p_spec = param_shardings(model.axes(), abstract, rules, mesh)
        params = distribute(abstract, p_spec, mesh)
        inputs = configs.shapes.input_specs(model, cell,
                                            frontend=cfg.frontend)
        in_spec = data_shardings(inputs, rules, mesh)
        if "cache" in inputs:
            in_spec["cache"] = tree_shardings(model.cache_axes(),
                                              inputs["cache"], rules, mesh)
        if "pos" in inputs:
            inputs["pos"] = cell.seq_len - 1
        batch = distribute(inputs, in_spec, mesh)
        args = [params, batch]
        if cell.mode == "train":
            opt = abstract_opt_state(abstract)
            opt = type(opt)(
                distribute(opt.step, (), mesh),
                distribute(opt.mu, p_spec, mesh),
                distribute(opt.nu, p_spec, mesh))
            args.append(opt)
        arg_bytes = counter.track(args)
        with counter, implicit_replication():
            if cell.mode == "train":
                step = make_train_step(
                    model, lr_fn=lambda s: cosine_schedule(
                        s, peak_lr=3e-4, warmup=100, total=10000),
                    grad_accum=grad_accum)
                out = step(params, opt, batch)
            elif cell.mode == "prefill":
                if cfg.frontend == "audio_frames":
                    out = model.prefill(params, batch["enc_embeds"],
                                        cell.seq_len)
                else:
                    out = make_prefill_step(model, cell.seq_len)(
                        params, batch["tokens"])
            else:
                out = make_serve_step(model)(params, batch["cache"],
                                             batch["tokens"], batch["pos"])
            out_bytes = sum(
                t.to_local().nbytes if hasattr(t, "to_local") else t.nbytes
                for t in trace_analysis.tensors_of(out))
            del out
        trace_s = time.time() - t0
    finally:
        set_activation_spec(None)
        set_state_rules(None)

    roof = trace_analysis.analyze(
        counter, n_chips=n_chips, trips=model.scan_trips(),
        model_flops=model_flops_for(cfg, model, cell))
    rec = {
        "arch": arch, "shape": cell.name,
        "mesh": _mesh_name(mesh),
        "n_chips": n_chips,
        "mode": cell.mode,
        "params": model.n_params,
        "active_params": model.n_active_params,
        "trace_s": round(trace_s, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "peak_bytes": counter.peak_bytes,
        },
        "collectives": {"bytes_by_kind": counter.coll.bytes_by_kind,
                        "count_by_kind": counter.coll.count_by_kind},
        "roofline": roof.as_dict(),
    }
    if outdir is not None:
        outdir.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}_{cell.name}_{rec['mesh']}"
        (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    outdir = Path(args.outdir)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    archs = configs.ARCH_NAMES if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]

    results, failures = [], []
    for arch in archs:
        for shape in shapes:
            if not supports_cell(arch, shape):
                print(f"SKIP  {arch:24s} {shape:12s} "
                      f"(full-attention arch, O(N^2) at 500k)")
                continue
            for mp in meshes:
                tag = f"{arch} {shape} {'multi' if mp else 'single'}"
                try:
                    rec = run_cell(arch, shape, mp, outdir,
                                   args.grad_accum)
                    r = rec["roofline"]
                    step = max(r["compute_s"], r["memory_s"],
                               r["collective_s"])
                    print(f"OK    {tag:52s} "
                          f"trace={rec['trace_s']:6.1f}s "
                          f"bound={r['bound']:10s} step={step:.4f}s "
                          f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}"
                          f"GiB", flush=True)
                    results.append(rec)
                except Exception as e:
                    print(f"FAIL  {tag}: {e}", flush=True)
                    traceback.print_exc()
                    failures.append((tag, str(e)))
    print(f"\n{len(results)} cells passed, {len(failures)} failed")
    if failures:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
