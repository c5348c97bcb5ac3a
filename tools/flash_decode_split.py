#!/usr/bin/env python3
"""Where the time of one ``mha_decode`` call goes, for one or more
checkouts of the repository, on one CUDA card.

    python3 tools/flash_decode_split.py [TREE ...]

For each TREE (a checkout; by default the one holding this script), in
its own process and in the order given (name a tree twice to interleave,
e.g. ``old new new old``), this builds that tree's flash-decode kernel
and, at the flash_decode family's production problem (32 rows, 8 query
heads over 1 KV head, a cache of 8192 x 128, bf16, kv_len 8192) with
``--splits`` spans (16 by default, the loop's best config of the parent
of the in-kernel combine), measures:

* ``call_ms`` — the whole validated ``mha_decode`` call: the median of
  20 calls between CUDA events, the L2 flushed before each
  (``chip_smoke.time_ms``), host time the card waits for included;
* ``kernel_ms`` and ``combine_ms`` — device time per call of the split
  kernel and of the merge of the partials (the combine kernel, or the
  tensor ops an older wrapper ran after its kernel), from
  ``torch.profiler`` (``chip_smoke.decode_parts_ms``).

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


def measure(tree: Path, splits: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    from chip_smoke import decode_parts_ms, time_ms
    from repro_torch.core.families.flash_decode import FlashDecodeConfig
    from repro_torch.kernels.flash_attention import mha_decode
    B, Hq, Hkv, S, D = 32, 8, 1, 8192, 128
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(*shape, generator=g, device="cuda")
               .to(torch.bfloat16)
               for shape in ((B, Hq, 1, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    kl = torch.tensor(S, dtype=torch.int32, device="cuda")
    cfg = FlashDecodeConfig(kv_splits=splits)

    def call():
        return mha_decode(q, k, v, kl, cfg=cfg)
    kernel_ms, combine_ms = decode_parts_ms(torch, call)
    return dict(tree=str(tree), splits=splits, call_ms=time_ms(torch, call),
                kernel_ms=kernel_ms, combine_ms=combine_ms,
                card=torch.cuda.get_device_name(0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path, default=[ROOT])
    ap.add_argument("--splits", type=int, default=16)
    ap.add_argument("--one", action="store_true",
                    help="measure the single tree given, in this process")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.trees[0].resolve(), args.splits)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for tree in args.trees:
        res = subprocess.run(
            [sys.executable, __file__, "--one", "--splits",
             str(args.splits), str(tree)], capture_output=True, text=True,
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
