#!/usr/bin/env python3
"""How ``torch.profiler``'s device times of a decode call go wrong, when
they do, over many profiled windows in one process on one CUDA card.

    python3 tools/profiler_probe.py [--windows 300]

Builds the kernels, then takes ``--windows`` profiled windows of
``mha_decode`` at the flash_decode family's 2048-token sweep problem
(128 rows, 8 query heads over 1 KV head, 2048 x 128, bf16, kv_len 2048,
the family example's config), the L2 flushed before each call, as
``chip_smoke.decode_parts_ms`` does.  Windows alternate between 20 calls
and 3.  Each window is read raw: for the split kernel, the combine and
the flush, the number of device events recorded and their mean length;
and the span of all device events, first start to last end, over the
same window between two CUDA events (``ratio``; the CUDA events also
hold the host's delay before the window's first launch, so it runs well
below 1 and is no check of the profiler's clock).  A split faster than
HBM's peak allows for the K and V it reads, and a window whose counts
are not one event a call each, are flagged.  Prints one JSON summary line
(the card's name and power limit as ``nvidia-smi`` reports them, the
range of each reading, every flagged window) and writes every window to
``chiprun_out/profiler_probe.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))


def window(torch, call, buf, n):
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import FLUSH_KERNEL, device_events
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0.record()
        for _ in range(n):
            buf.zero_()
            call()
        t1.record()
        torch.cuda.synchronize()
    events = device_events(prof)
    row = dict(n=n, events=len(events))
    if not events:
        return row
    cuda_us = t0.elapsed_time(t1) * 1e3
    span = max(e for _, _, e in events) - min(s for _, s, _ in events)
    row.update(cuda_us=cuda_us, span_us=span, ratio=span / cuda_us)
    for part, pred in (("split", lambda k: "decode_" in k),
                       ("flush", lambda k: FLUSH_KERNEL in k),
                       ("combine", lambda k: "combine" in k)):
        durs = [e - s for k, s, e in events if pred(k)]
        row[f"{part}_count"] = len(durs)
        row[f"{part}_mean_us"] = statistics.fmean(durs) if durs else None
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=300)
    args = ap.parse_args(argv)
    import torch

    from chip_smoke import HBM_BYTES_PER_S, _fa_inputs
    from repro_torch.core.families import get_family
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import mha_decode
    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    B, Hq, Hkv, S, D = 128, 8, 1, 2048, 128
    q, k, v = _fa_inputs(torch, B, Hq, Hkv, 1, S, D, "bfloat16", 7)
    kl = torch.tensor(S, dtype=torch.int32, device="cuda")
    cfg = get_family("flash_decode").example()[0]
    call = lambda: mha_decode(q, k, v, kl, cfg=cfg)
    floor_us = (k.numel() + v.numel()) * 2 / HBM_BYTES_PER_S * 1e6
    buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    call()
    torch.cuda.synchronize()
    rows = [window(torch, call, buf, 20 if i % 2 == 0 else 3)
            for i in range(args.windows)]
    for r in rows:
        r["fast"] = bool(r.get("split_mean_us") is not None
                         and r["split_mean_us"] < 0.9 * floor_us)
        r["whole"] = (r.get("split_count") == r.get("flush_count")
                      == r.get("combine_count") == r["n"])
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profiler_probe.json").write_text(json.dumps(rows, indent=0))

    def rng(key):
        vals = [r[key] for r in rows if r.get(key) is not None]
        return [min(vals), statistics.median(vals), max(vals)] if vals \
            else None
    flagged = [dict(i=i, **r) for i, r in enumerate(rows)
               if r["fast"] or not r["whole"] or r.get("ratio") is None
               or abs(r["ratio"] - 1) > 0.1]
    print(json.dumps(dict(
        nvidia_smi=card, cfg=cfg.name(), windows=len(rows),
        split_floor_us=floor_us, ratio=rng("ratio"),
        split_us=rng("split_mean_us"), flush_us=rng("flush_mean_us"),
        combine_us=rng("combine_mean_us"),
        fast=sum(r["fast"] for r in rows),
        not_whole=sum(not r["whole"] for r in rows),
        flagged=flagged[:40])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
