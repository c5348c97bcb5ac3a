#!/usr/bin/env python3
"""Device times of one kernel's calls, for one or more checkouts of the
repository, on one CUDA card.

    python3 tools/tree_times.py MEASUREMENT [TREE ...] [--splits N]

For each TREE (a checkout; by default the one holding this script), in
its own process and in the order given (name a tree twice to interleave,
e.g. ``old new new old``), this builds that tree's kernels and takes one
of these measurements, each time the median of 20 calls between CUDA
events with the L2 flushed before each (``chip_smoke.time_ms``):

* ``decode_split`` — one ``mha_decode`` call at the flash_decode
  family's production problem (32 rows, 8 query heads over 1 KV head, a
  cache of 8192 x 128, bf16, kv_len 8192) with ``--splits`` spans (16
  by default): ``call_ms``, the whole validated call, host time the card
  waits for included; ``kernel_ms`` and ``combine_ms``, device time per
  call of the split kernel and of the merge of the partials, from
  ``torch.profiler`` (``chip_smoke.decode_parts_ms``);
* ``gemm`` — ``matmul`` at the GEMM family's production problem (8192^3
  bf16) with the agent loop's usual best config,
  ``gemm[512x1024x128]+stagger`` (``gemm_best_ms``), and with the
  family's default config, ``gemm[128x128x128]`` (``gemm_baseline_ms``);
* ``ragged`` — ``ragged_prefill`` in bf16 at the serving phase's packed
  tick (``chip_smoke._prefill_case``: 8 chunks of up to 256 queries
  against prefixes up to 768), at qwen3-1.7b's heads (16/8 x 128) and
  granite-moe-3b-a800m's (24/8 x 64): ``ragged_{qwen3,granite}_ms``,
  beside the largest |kernel - plain| and the share of the real rows'
  outputs that differ from the plain version's (``_err`` and ``_share``).

It prints one JSON line per tree with the card's name and power limit
as ``nvidia-smi`` reports them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def decode_split(torch, args) -> dict:
    from chip_smoke import decode_parts_ms, time_ms
    from repro_torch.core.families.flash_decode import FlashDecodeConfig
    from repro_torch.kernels.flash_attention import mha_decode
    B, Hq, Hkv, S, D = 32, 8, 1, 8192, 128
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(*shape, generator=g, device="cuda")
               .to(torch.bfloat16)
               for shape in ((B, Hq, 1, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    kl = torch.tensor(S, dtype=torch.int32, device="cuda")
    cfg = FlashDecodeConfig(kv_splits=args.splits)

    def call():
        return mha_decode(q, k, v, kl, cfg=cfg)
    kernel_ms, combine_ms = decode_parts_ms(torch, call)
    return dict(splits=args.splits, call_ms=time_ms(torch, call),
                kernel_ms=kernel_ms, combine_ms=combine_ms)


def gemm(torch, args) -> dict:
    from chip_smoke import time_ms
    from repro_torch.core.families.gemm import GemmConfig
    from repro_torch.kernels.gemm import matmul
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(8192, 8192, generator=g, device="cuda").bfloat16()
    b = torch.randn(8192, 8192, generator=g, device="cuda").bfloat16()
    out = {}
    for name, cfg in (("best", GemmConfig(512, 1024, 128, 1, True)),
                      ("baseline", GemmConfig())):
        out[f"gemm_{name}_ms"] = time_ms(torch, lambda: matmul(a, b, cfg=cfg))
    return out


def ragged(torch, args) -> dict:
    from chip_smoke import GRANITE_HEADS, QWEN_HEADS, _prefill_case, time_ms
    from repro_torch.kernels.ragged_prefill import (default_config,
                                                    ragged_prefill_ref)
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill
    out = {}
    for name, heads in (("qwen3", QWEN_HEADS), ("granite", GRANITE_HEADS)):
        (q, k, v, sq, pq, sk, pk), _ = _prefill_case(torch, "bfloat16",
                                                     heads=heads)
        cfg = default_config(q.shape[1], k.shape[1])
        got = ragged_prefill(q, k, v, sq, pq, sk, pk, cfg=cfg)
        want = ragged_prefill_ref(q, k, v, sq, pq, sk, pk)
        real = sq >= 0
        out[f"ragged_{name}_err"] = float(
            (got.float() - want.float()).abs().max())
        out[f"ragged_{name}_share"] = float(
            (got[:, real] != want[:, real]).float().mean())
        out[f"ragged_{name}_ms"] = time_ms(
            torch, lambda: ragged_prefill(q, k, v, sq, pq, sk, pk, cfg=cfg))
    return out


MEASUREMENTS = {"decode_split": decode_split, "gemm": gemm,
                "ragged": ragged}


def measure(tree: Path, args) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    return dict(tree=str(tree), measurement=args.measurement,
                card=torch.cuda.get_device_name(0),
                **MEASUREMENTS[args.measurement](torch, args))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("measurement", choices=sorted(MEASUREMENTS))
    ap.add_argument("trees", nargs="*", type=Path, default=[ROOT])
    ap.add_argument("--splits", type=int, default=16,
                    help="decode_split: the config's kv_splits")
    ap.add_argument("--one", action="store_true",
                    help="measure the single tree given, in this process")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.trees[0].resolve(), args)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for tree in args.trees:
        res = subprocess.run(
            [sys.executable, __file__, args.measurement, str(tree), "--one",
             "--splits", str(args.splits)], capture_output=True, text=True,
            timeout=600)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["nvidia_smi"] = card
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
