#!/usr/bin/env python3
"""How far float32 rounding alone moves the gradients of ``chip_smoke.py``
phase 15b's problem (qwen3-1.7b at full width, depth 2, float32, batch
2 x 128, seed 0, the CPU's seeded weights).

    python3 tools/train_hold_probe.py [--device cpu]

Each evaluation is ``repro_torch.train.value_and_grad`` on the same
weights and batch; each line compares two of them, leaf by leaf, as
the largest |difference| over the first one's largest |value|, and
prints the three worst leaves:

* ``float32 vs float64`` — the CPU step against the CPU step in float64
  (``chip_smoke._float64_models``);
* ``1 thread vs N threads`` — the CPU step with one intra-op thread
  against the default (other summation orders in the GEMMs);
* ``one ulp, seed S`` — the CPU step after every weight moved by -1, 0
  or +1 ulp at random: the problem's own sensitivity to its rounding;
* with ``--device cuda`` (the default) ``card vs float64`` and ``card
  vs card``, the second card step against the first.

The last line is one JSON object of every comparison's leaves.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.data import make_dataset
    from repro_torch.device import resolve_device
    from repro_torch.models import build
    from repro_torch.optim import tree_map
    from repro_torch.train import value_and_grad

    device = resolve_device(args.device)
    h = cs.TRAIN_HOLD
    cfg = dataclasses.replace(configs.get_config(cs.TRAIN["arch"]),
                              n_layers=h["layers"], dtype="float32")
    model = build(cfg)
    cpu = model.init(cs.TRAIN["seed"], device="cpu")
    b = next(make_dataset(cfg, seq_len=h["seq"], global_batch=h["batch"],
                          seed=cs.TRAIN["seed"]))

    def step(params, dev="cpu"):
        p = tree_map(lambda x: x.detach().to(dev).clone(), params)
        _, _, g = value_and_grad(model, p, {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        return {k: v.detach().cpu().double()
                for k, v in cs._leaf_items(g)}

    def one_ulp(seed):
        gen = torch.Generator().manual_seed(seed)

        def bump(x):
            s = torch.randint(-1, 2, x.shape, generator=gen)
            up = torch.nextafter(x, torch.full_like(x, float("inf")))
            down = torch.nextafter(x, torch.full_like(x, -float("inf")))
            return torch.where(s > 0, up, torch.where(s < 0, down, x))
        return tree_map(bump, cpu)

    runs = {"float32": step(cpu)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs["1 thread"] = step(cpu)
    torch.set_num_threads(threads)
    with cs._float64_models(torch):
        runs["float64"] = step(tree_map(lambda x: x.double(), cpu))
    for seed in (1, 2):
        runs[f"one ulp, seed {seed}"] = step(one_ulp(seed))
    pairs = [("float32", "float64"), ("1 thread", "float32")]
    pairs += [(f"one ulp, seed {s}", "float32") for s in (1, 2)]
    if device.type == "cuda":
        runs["card"] = step(cpu, "cuda")
        runs["card again"] = step(cpu, "cuda")
        pairs += [("card", "float64"), ("card again", "card")]
    out = {}
    for a, b_ in pairs:
        ref = runs[b_]
        errs = {k: float((runs[a][k] - v).abs().max())
                / (float(v.abs().max()) or 1.0) for k, v in ref.items()}
        out[f"{a} vs {b_}"] = errs
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        print(f"{a} vs {b_} ({threads} threads): "
              + ", ".join(f"{k} {v:.3e}" for k, v in top))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
