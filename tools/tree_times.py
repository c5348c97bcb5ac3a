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
  ``torch.profiler`` with the L2 flushed before each call (each
  kernel's mean over its launches, ``chip_smoke.decode_parts_ms``, as
  for every decode split below);
* ``gemm`` — ``matmul`` at the GEMM family's production problem (8192^3
  bf16) with the agent loop's usual best config,
  ``gemm[512x1024x128]+stagger`` (``gemm_best_ms``), and with the
  family's default config, ``gemm[128x128x128]`` (``gemm_baseline_ms``);
* ``ragged`` — ``ragged_prefill`` in bf16 at the serving phase's packed
  tick (``chip_smoke._prefill_case``: 8 chunks of up to 256 queries
  against prefixes up to 768), at qwen3-1.7b's heads (16/8 x 128) and
  granite-moe-3b-a800m's (24/8 x 64): ``ragged_{qwen3,granite}_ms``,
  beside the largest |kernel - plain| and the share of the real rows'
  outputs that differ from the plain version's (``_err`` and ``_share``);
* ``paged`` — ``paged_decode`` in bf16 at the serving phase's decode
  batch (``chip_smoke._decode_case``: 8 rows of 0 to 2048 positions in
  16-token pages) at qwen3-1.7b's heads and granite-moe-3b-a800m's
  (``paged_{qwen3,granite}_ms``, the whole call; ``_device_ms``, its
  kernels' device time from ``torch.profiler``; ``_err`` and ``_share``
  as for ``ragged``), and at the family's production problem (32 rows x
  8/1 heads x 8192 positions in 128-token pages,
  ``chip_smoke.decode_production_case``): ``paged_production_ms`` and
  ``_device_ms``, null where the tree's wrapper refuses 128-token pages;
* ``flavours`` — both serving kernels in bf16 at stablelm-3b's heads
  (32/32 x 80) and gemma-7b's (16/16 x 256), at the shapes of
  ``ragged`` and ``paged`` (``chip_smoke.FLAVOUR_HEADS``):
  ``ragged_{stablelm,gemma}_ms``, ``paged_{stablelm,gemma}_ms`` (the
  whole call) with ``_split_ms`` and ``_combine_ms`` (each launch's
  device time from ``torch.profiler``), and ``_err`` and ``_share`` as
  for ``ragged``;
* ``moe`` — ``grouped_ffn`` at the MoE family's production problem
  (16,384 tokens, top-8 of 32 experts, 7168 x 2048, bf16, the capacity
  rows of ``chip_smoke._moe_inputs``) with ``moe[128x512]+fusedgate``
  and ``moe[64x512]+fusedgate`` (``moe_{128,64}x512_ms``, 5 calls each),
  beside each one's largest |kernel - plain| over two experts and the
  device time of its gate/up and down launches (``_up_ms``,
  ``_down_ms``, ``torch.profiler`` over 3 calls);
* ``quant`` — ``quant_matmul`` at the quantized GEMM family's production
  problem (8192^3 int8, group 128, inputs of
  ``chip_smoke._quant_inputs``) with ``qgemm[128x128x128]`` and
  ``qgemm[128x128x32]`` (``quant_{128,32}_ms``), beside the device time
  of the call's transpose of B and of its GEMM kernel
  (``_transpose_ms``, ``_gemm_ms``: each kernel's mean over its launches
  in 5 calls under ``torch.profiler``; a tree without the transpose has
  none), the largest |kernel - plain| (``quant_err``), and the 2048 x
  8192 x 8192 sweep problem (``quant_2048_ms``);
* ``ssd`` — ``ssd`` at the SSD family's production problem (64 x 8192 x
  P 64 x N 128, float32, inputs of ``chip_smoke._ssd_inputs``) with
  chunks 64, 128 and 256 (``ssd_q{64,128,256}_ms``, 5 calls each),
  beside each one's device time by launch (``_state_ms``, ``_pass_ms``,
  ``_scan_ms``, or ``_kernel_ms`` for a tree with one kernel; each
  kernel's mean over its launches in 3 calls under ``torch.profiler``)
  and the largest |kernel - plain| at chunk 128 (``ssd_err``), and
  mamba2-780m's layer shape (192 x 2048 x 64 x 128, chunk 256:
  ``ssd_layer_ms``);
* ``widths`` — the instances a kernel compiled for one head_dim runs
  against those that read head_dim at run time: ``flash_attention`` at
  the family's 2048-token sweep problem (32 x 8/1 x 2048^2, head_dim
  128, causal, bf16) with the family example ``fa[8x128]`` (its 16-row
  ``mma.sync`` tile) and ``fa[128x128]+skip`` (``wgmma``), and in
  float32 at 1 x 8/2 x 1024^2 with block_q 64 (``fa_{example,best,
  f32}_ms``); ``mha_decode``'s split kernel and combine on the device at
  the decode family's production problem, 8 spans
  (``fd_split_ms``, ``fd_combine_ms``); the float32 CUDA-core
  instances of both serving kernels at the shapes of ``ragged`` and
  ``paged``, at qwen3-1.7b's heads (16/8 x 128), stablelm-3b's (32/32 x
  80) and gemma-7b's (16/16 x 256): ``ragged_f32_{qwen3,stablelm,gemma}
  _ms`` and the decode split's device time
  ``paged_f32_{qwen3,stablelm,gemma}_split_ms``.

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


def paged(torch, args) -> dict:
    from chip_smoke import (GRANITE_HEADS, QWEN_HEADS, _decode_case,
                            decode_parts_ms, decode_production_case,
                            time_ms)
    from repro_torch.kernels.paged_attention import paged_decode_ref
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    out = {}
    for name, heads in (("qwen3", QWEN_HEADS), ("granite", GRANITE_HEADS)):
        (q, kp, vp, table, lens), _, _, _ = _decode_case(
            torch, "bfloat16", heads=heads)
        call = lambda: paged_decode(q, kp, vp, table, lens)
        got, want = call(), paged_decode_ref(q, kp, vp, table, lens)
        live = lens > 0
        out[f"paged_{name}_err"] = float(
            (got.float() - want.float()).abs().max())
        out[f"paged_{name}_share"] = float(
            (got[live] != want[live]).float().mean())
        out[f"paged_{name}_ms"] = time_ms(torch, call)
        out[f"paged_{name}_device_ms"] = sum(decode_parts_ms(torch, call))
    _, (q, kp, vp, table, lens) = decode_production_case(torch)
    call = lambda: paged_decode(q, kp, vp, table, lens)
    try:
        call()
    except ValueError:           # a tree whose kernel refuses the pages
        out["paged_production_ms"] = out["paged_production_device_ms"] = None
        return out
    out["paged_production_ms"] = time_ms(torch, call)
    out["paged_production_device_ms"] = sum(decode_parts_ms(torch, call))
    return out


def moe(torch, args) -> dict:
    from chip_smoke import _moe_inputs, device_parts_ms, time_ms
    from repro_torch.core.families import get_family
    from repro_torch.core.families.moe import MoEConfig
    from repro_torch.kernels.moe import (capacity_for, grouped_ffn,
                                         grouped_ffn_ref, moe_error)
    prob = get_family("moe").example()[1]
    E, DM, DF = prob.n_experts, prob.d_model, prob.d_ff
    C = capacity_for(prob.tokens, prob.top_k, E, 128)
    x, ws, gates = _moe_inputs(torch, E, C, DM, DF, "bfloat16", 99)
    want = grouped_ffn_ref(x[:2], *(w[:2] for w in ws), gates[:2])
    out = {}
    for bt in (128, 64):
        cfg = MoEConfig(bt, 512)
        got = grouped_ffn(x, *ws, gates, cfg=cfg)
        out[f"moe_{bt}x512_err"] = moe_error(got[:2], want)[0]
        call = lambda: grouped_ffn(x, *ws, gates, cfg=cfg)
        out[f"moe_{bt}x512_ms"] = time_ms(torch, call, iters=5, warmup=1)
        # the launches' kernels are templated on the launch: <..., true>
        # is gate/up, <..., false> down
        parts = device_parts_ms(torch, call, lambda k: (
            None if "ffn" not in k else "up" if "true>" in k else "down"),
            n=3)
        out[f"moe_{bt}x512_up_ms"] = parts.get("up")
        out[f"moe_{bt}x512_down_ms"] = parts.get("down")
    return out


def quant(torch, args) -> dict:
    from chip_smoke import _quant_inputs, quant_parts_ms, time_ms
    from repro_torch.core.families.quant_gemm import QuantGemmConfig
    from repro_torch.kernels.quant_gemm import (quant_error, quant_gemm_ref,
                                                quant_matmul)
    aq, bq, sa, sb = _quant_inputs(torch, 8192, 8192, 8192, 128, 8192)
    out = {}
    for bk in (128, 32):
        cfg = QuantGemmConfig(128, 128, bk)
        call = lambda: quant_matmul(aq, bq, sa, sb, group=128, cfg=cfg)
        if bk == 128:
            out["quant_err"] = quant_error(
                call(), quant_gemm_ref(aq, bq, sa, sb, group=128))[0]
        out[f"quant_{bk}_ms"] = time_ms(torch, call)
        parts = quant_parts_ms(torch, call, n=5)
        out[f"quant_{bk}_transpose_ms"] = parts.get("transpose")
        out[f"quant_{bk}_gemm_ms"] = parts.get("gemm")
    del aq, bq, sa, sb
    aq, bq, sa, sb = _quant_inputs(torch, 2048, 8192, 8192, 128, 2048)
    cfg = QuantGemmConfig()
    out["quant_2048_ms"] = time_ms(
        torch, lambda: quant_matmul(aq, bq, sa, sb, group=128, cfg=cfg))
    return out


def ssd(torch, args) -> dict:
    from chip_smoke import _ssd_inputs, device_parts_ms, time_ms
    from repro_torch.core.families.ssd import SSDConfig
    from repro_torch.kernels.ssd import ssd as ssd_call
    from repro_torch.kernels.ssd import ssd_error, ssd_ref
    x, da, B, C = _ssd_inputs(torch, 64, 8192, 64, 128, "float32", 8192)
    out = {}
    for q in (64, 128, 256):
        cfg = SSDConfig(q)
        call = lambda: ssd_call(x, da, B, C, cfg=cfg)
        if q == 128:
            out["ssd_err"] = ssd_error(call(), ssd_ref(x, da, B, C, q)[0])[0]
        out[f"ssd_q{q}_ms"] = time_ms(torch, call, iters=5, warmup=1)
        # each launch's kernel once a call; a tree with one SSD kernel
        # reports it as "kernel"
        parts = device_parts_ms(torch, call, lambda k: next(
            (n for n in ("state", "pass", "scan") if f"ssd_{n}_kernel" in k),
            "kernel" if "ssd" in k else None), n=3, per_launch=True)
        for name, ms in parts.items():
            out[f"ssd_q{q}_{name}_ms"] = ms
    del x, da, B, C
    x, da, B, C = _ssd_inputs(torch, 192, 2048, 64, 128, "float32", 2048)
    out["ssd_layer_ms"] = time_ms(
        torch, lambda: ssd_call(x, da, B, C, cfg=SSDConfig(256)), iters=5,
        warmup=1)
    return out


def flavours(torch, args) -> dict:
    from chip_smoke import (FLAVOUR_HEADS, _decode_case, _prefill_case,
                            decode_parts_ms, time_ms)
    from repro_torch.kernels.paged_attention import paged_decode_ref
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    from repro_torch.kernels.ragged_prefill import (default_config,
                                                    ragged_prefill_ref)
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill
    out = {}
    for name, arch in (("stablelm", "stablelm-3b"), ("gemma", "gemma-7b")):
        heads = FLAVOUR_HEADS[arch]
        (q, k, v, sq, pq, sk, pk), _ = _prefill_case(torch, "bfloat16",
                                                     heads=heads)
        cfg = default_config(q.shape[1], k.shape[1])
        call = lambda: ragged_prefill(q, k, v, sq, pq, sk, pk, cfg=cfg)
        got, want = call(), ragged_prefill_ref(q, k, v, sq, pq, sk, pk)
        real = sq >= 0
        out[f"ragged_{name}_err"] = float(
            (got.float() - want.float()).abs().max())
        out[f"ragged_{name}_share"] = float(
            (got[:, real] != want[:, real]).float().mean())
        out[f"ragged_{name}_ms"] = time_ms(torch, call)
        del q, k, v, got, want
        (q, kp, vp, table, lens), _, _, _ = _decode_case(
            torch, "bfloat16", heads=heads)
        call = lambda: paged_decode(q, kp, vp, table, lens)
        got, want = call(), paged_decode_ref(q, kp, vp, table, lens)
        live = lens > 0
        out[f"paged_{name}_err"] = float(
            (got.float() - want.float()).abs().max())
        out[f"paged_{name}_share"] = float(
            (got[live] != want[live]).float().mean())
        out[f"paged_{name}_ms"] = time_ms(torch, call)
        split, combine = decode_parts_ms(torch, call)
        out[f"paged_{name}_split_ms"] = split
        out[f"paged_{name}_combine_ms"] = combine
    return out


def widths(torch, args) -> dict:
    from chip_smoke import (FLAVOUR_HEADS, QWEN_HEADS, _decode_case,
                            _fa_inputs, _prefill_case, decode_parts_ms,
                            time_ms)
    from repro_torch.core.families.flash_attention import \
        FlashAttentionConfig
    from repro_torch.core.families.flash_decode import FlashDecodeConfig
    from repro_torch.kernels.flash_attention import mha, mha_decode
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    from repro_torch.kernels.ragged_prefill import default_config
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill
    out = {}
    q, k, v = _fa_inputs(torch, 32, 8, 1, 2048, 2048, 128, "bfloat16", 7)
    for name, cfg in (("example", FlashAttentionConfig(8, 128)),
                      ("best", FlashAttentionConfig(128, 128))):
        out[f"fa_{name}_ms"] = time_ms(
            torch, lambda: mha(q, k, v, cfg=cfg, causal=True), iters=5,
            warmup=1)
    q, k, v = _fa_inputs(torch, 1, 8, 2, 1024, 1024, 128, "float32", 8)
    out["fa_f32_ms"] = time_ms(torch, lambda: mha(
        q, k, v, cfg=FlashAttentionConfig(64, 64), causal=True))
    q, k, v = _fa_inputs(torch, 32, 8, 1, 1, 8192, 128, "bfloat16", 9)
    kl = torch.tensor(8192, dtype=torch.int32, device="cuda")
    split, combine = decode_parts_ms(torch, lambda: mha_decode(
        q, k, v, kl, cfg=FlashDecodeConfig(kv_splits=8)))
    out["fd_split_ms"], out["fd_combine_ms"] = split, combine
    del q, k, v
    for name, heads in (("qwen3", QWEN_HEADS),
                        ("stablelm", FLAVOUR_HEADS["stablelm-3b"]),
                        ("gemma", FLAVOUR_HEADS["gemma-7b"])):
        (q, k, v, sq, pq, sk, pk), _ = _prefill_case(torch, "float32",
                                                     heads=heads)
        cfg = default_config(q.shape[1], k.shape[1])
        out[f"ragged_f32_{name}_ms"] = time_ms(
            torch, lambda: ragged_prefill(q, k, v, sq, pq, sk, pk, cfg=cfg))
        del q, k, v
        (q, kp, vp, table, lens), _, _, _ = _decode_case(
            torch, "float32", heads=heads)
        out[f"paged_f32_{name}_split_ms"] = decode_parts_ms(
            torch, lambda: paged_decode(q, kp, vp, table, lens))[0]
    return out


MEASUREMENTS = {"decode_split": decode_split, "gemm": gemm,
                "ragged": ragged, "paged": paged, "flavours": flavours,
                "moe": moe, "quant": quant, "ssd": ssd, "widths": widths}


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
