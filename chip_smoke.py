#!/usr/bin/env python3
"""End-to-end check of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from a checkout of the repository (it imports ``src/repro_torch``;
nothing of JAX or of the JAX package ``repro``).  It needs one CUDA card
and ``nvcc``, and exits non-zero, without printing a result, when either
is missing or any phase fails.  Phases:

1. card — name and power limit as ``nvidia-smi`` reports them;
2. build — the eight CUDA kernels from the repository's sources, one
   ``nvcc`` per source, started together; ptxas's registers, shared
   memory and spills for each instance (a spill fails the run), and for
   the gemm, ragged-prefill,
   grouped-FFN, paged-decode and two flash libraries the HGMMA (wgmma),
   HMMA (mma.sync), UTMALDG (TMA) and UBLKCP (bulk copy) instructions of
   each instance in ``cuobjdump -sass``: gemm, ragged_prefill,
   flash_attention and grouped_ffn have wgmma instances, which must show
   HGMMA and UTMALDG, quant_gemm an int8 wgmma instance, which must show
   IGMMA and UTMALDG, the bf16 decode kernels (flash_decode's, and
   paged_decode's tensor-core instance) HMMA and UTMALDG, and the SSD
   chunk-state and chunk-scan kernels (f32 and bf16) HMMA (TF32); the
   four attention kernels must have a bf16 tensor-core instance at each
   tile width (64, 128, 256 columns: ``kernelspec.TILE_WIDTHS``; a
   head_dim runs in the least width at or above it) showing HGMMA
   (ragged_prefill, flash_attention's 128-row tile) or HMMA
   (paged_decode, flash_decode) and UTMALDG; the panel route's instances
   (``kernels/csrc/panel_attention.cuh``: any other head_dim) are built
   beside them, spill-free like every instance;
3. kernels against their plain PyTorch versions at the serving path's
   shapes (qwen3-1.7b: 16 query heads, 8 KV heads, head_dim 128, page
   size 16), in bfloat16 and float32 (ragged prefill's bf16 case on its
   wgmma instance, float32 on its CUDA-core one; paged decode's bf16 on
   its tensor-core split walk, float32 on CUDA cores; each case names
   its instance), including poisoned pages and segments that must not
   move the output by a bit, a zero-length row that must give zeros,
   and on both kernels' bf16 tensor-core instances the share of outputs
   that differ from the plain version's bf16 value (at most
   ``P_SPLIT_MISMATCH``: the sign that p kept float32 accuracy through
   P·V); each kernel's time, its plain version's time, the least time
   the card could take (``bound_ms``) and, for ragged prefill, one
   ``scaled_dot_product_attention`` call as a yardstick, the two also
   over 20 calls launched back to back (a call of ~0.1 ms makes the
   card wait for its host time); for paged decode the whole call beside
   its split kernel's and its combine's device time
   (``decode_parts_ms``), a 125-page table in spans and in one span a
   row, and the family's production problem (32 rows x 8/1 heads x
   8192 tokens in 128-token pages, a pool of 2304, bf16) held to the
   plain version and timed beside the dense flash_decode kernel at the
   same bytes;
4. serve — qwen3-1.7b at full width and depth (28 layers, random
   weights from a seeded ``torch.Generator``) behind
   ``PagedServingEngine(decode_path="kernel", prefill_path="kernel")``
   replaying a seeded Poisson trace of 16 requests; every tick that
   decoded or prefilled must have gone through the two kernels, whose
   launch counters are zeroed just before this phase and read just
   after; then a profiled prefill tick and six decode ticks show where
   a tick's time goes; then ``SERVE_HEAD_DIMS``: qwen3-1.7b at full width
   with head_dim 100 and 320 (two layers, 8 requests), every tick on
   the two kernels' panel route, the counters zeroed before each run and
   read after it;
5. the kernel paths against the gather paths, in float32 at depth 2:
   identical tokens;
6. gemm — the ARGUS gate and agent loop on the GEMM family:
   (b) the GEMM kernel against its plain version in bfloat16 and
   float32 over the default config, split_k 2 and 4, stagger_k, a tile
   above 128, bm = 8, ragged shapes (on the 128 x 256 wgmma instance
   too) and the production problem 8192^3 bf16 at the default config,
   each case naming the instance it ran on (wgmma 128 x 128 or
   128 x 256, or mma.sync / FMA); (c) the paper's loop, ``optimize_kernel`` at 8192^3
   bf16 with ``Validator(run_kernels=True)``, its launch counter zeroed
   just before and read just after: every unit test of the loop must
   have launched the kernel once; (d) the baseline and the loop's best
   config timed at the production problem and the two sweep problems,
   beside the bound, the plain version, one bf16 ``torch.matmul``
   (cuBLAS) and the port's cost-model estimate, each timed config's
   output held to the plain version at the stated tolerance; (e) an invalid config
   (split_k = 5 on 3 K blocks) must raise before any launch;
7. flash — the paper's second family on the card: (a) the
   flash-attention prefill kernel and the split-KV decode kernel
   against their plain versions in bfloat16 and float32, over the
   default and family-example configs, block_q and block_kv 16 to 256
   (block_q 128 and 64 on the wgmma CTAs at head_dim 64 and 128),
   causal and not, causal_block_skip and v_transposed_staging on and
   off, GQA groups 1, 2, 4 and 8, head_dim 64 and 128, Sq != Skv (1000
   x 1500, and Skv < Sq), kv_splits 1 to 32 with kv_len < S, kv_len 0
   (held to zeros, the TPU kernel's output there) and spans shorter
   than a tile, within the tolerance
   stated beside ``flash_error`` (``kernels/flash_attention/ref.py``:
   each element, and each query row's error norm against the row's
   norm); (b) the agent loop on each family at its production
   problem with ``Validator(run_kernels=True)`` (the selector and steps
   of phase 6c), each kernel's launch counter zeroed just before and
   read just after: every unit test must have launched its kernel;
   (c) the example config and the loop's best, each first held to the
   plain version at that tolerance, timed at the production
   problem and both sweep problems, beside the bound, the plain version
   (one batch row at a time — one head at a time at 16384 — since its
   materialised scores would not fit the card), one
   ``scaled_dot_product_attention`` call and the cost model's estimate;
   for decode, beside the whole ``mha_decode`` call, the device time of
   its split kernel and of its combine kernel (``torch.profiler``);
8. moe — the paper's third family on the card: (a) the grouped-FFN
   kernel against its plain version in bfloat16 and float32 over the
   default config and the family example (block_t 8), block_t 16 to 256
   and block_f 8 to 2048, fuse_gate off and gates None, one expert,
   d_model 1536 and 96 and empty capacity rows, the wgmma instance's 64-
   and 128-row CTAs with gates None and fuse off, rows off the 16-byte
   grain (d_model 100, d_ff 60, block_f 20; d_model 50: element copies;
   also timed at 40 experts x 256 rows beside bound, plain version and
   the bmm yardstick, ``MOE_OFF_GRAIN``), and the production
   problem (16,384 tokens, top-8 of 32 experts, 7168 x 2048, bf16),
   each case naming its instance (wgmma, mma.sync or fma),
   within the tolerance stated beside ``moe_error``
   (``kernels/moe/ref.py``); (b) ``moe_ffn`` end to end at
   granite-moe-3b-a800m's layer against the dense oracle through the
   keep mask, with dropped pairs; (c) the agent loop at the production
   problem with ``Validator(run_kernels=True)`` (the selector and steps
   of phase 6c), the launch counters zeroed just before and read just
   after: every unit test must have launched the kernel; (d) the
   example config and the loop's best, each first held to the plain
   version, timed at the production problem and both sweep problems,
   beside the bound (the capacity rows the kernel computes), the
   family's ``moe_sol`` (routed rows only), the plain version (expert by
   expert), a yardstick of three ``torch.bmm`` calls plus the
   elementwise SwiGLU and gate, and the cost model's estimate;
9. serve-moe — granite-moe-3b-a800m: the two serving kernels against
   their plain versions at its shapes (24/8 heads, head_dim 64); phase
   4 at full width and depth (32 layers, random weights from a seeded
   ``torch.Generator``, the same trace and engine), every prefill and
   decode tick through the two kernels; phase 5 at depth 2 with a
   drop-free capacity factor (E / top_k);
10. quant_gemm — the quantized GEMM family on the card: (a) the int8
   kernel against its plain version (``quant_gemm_ref``) on inputs
   quantised by ``quantize_per_group`` from seeded normals, output f32
   and bf16, over the default config and the family example, bm and bn
   32 to 256, bk 32/64/128 with group 128 and group 64, ragged m, n and
   k on the byte and the 16-byte paths, and the production problem
   8192^3 int8 group 128, within the tolerance stated beside
   ``quant_error`` (``kernels/quant_gemm/ref.py``), each case naming its
   instance (int8 wgmma 128 x 128 or mma.sync), and every wgmma case
   (the default 2048^3 and 8192^3, group 64 at bk 64 and 32, bf16 out,
   m = 40) bit-identical to the mma.sync instance at the same bk on the
   same inputs; (b) the agent loop at
   the production problem with ``Validator(run_kernels=True)`` (phase
   6c's selector and steps), the launch counters zeroed just before and
   read just after: every unit test must have launched the kernel; (c)
   the example config and the loop's best, each first held to the plain
   version, timed at the production problem and both sweep problems —
   the call, and the device time of its transpose of B and of its GEMM
   kernel — beside the bound, the plain version, the cost model's
   estimate and a yardstick of one ``torch._int_mm`` with B row-major and
   column-major (int32, no group scales: another function); (d) a bk
   that does not divide the group must raise before any launch;
11. ssd — the SSD family and mamba2-780m: (a) the chunk-scan kernel
   against its plain version (``ssd_ref``) in float32 and bfloat16 over
   chunks 32 to 512 (and 96), P 9 to 128, N 7 to 256 (130 and 256 in
   state panels of 128), BH 1 and 64, one chunk and many, and the
   production problem (64 x 8192 x 64 x 128) in both types, within the
   tolerance stated beside ``ssd_error`` (``kernels/ssd/ref.py``) of the
   plain version summed in float64 (as in 11c), and
   d_state 130 and 256 timed at mamba2's layer shape (``SSD_PANELS``)
   beside bound and plain version; (b) the agent loop at the production
   problem, launches counted as in 10b; (c) the example config (chunk
   64) and the best timed at the three sweep problems — the call, the
   device time of each of its three launches and the scratch it
   allocates — beside the bound (3xTF32's 165 TFLOP/s against the
   bytes), the plain version and the cost model (no library call
   computes the scan); (d) mamba2-780m at full width and depth (48
   layers, random weights): ``SSMLM.apply`` over 4 x 2,048 tokens, timed
   and profiled; the SSD core of its first layer on that layer's own
   inputs through ``ssd_via_kernel`` (the CUDA kernel, counted) against
   ``ssd_chunked``, both timed; at depth 2 in float32, 16
   ``decode_step`` tokens against ``apply``'s logits;
12. tune — the fleet tuner on qwen3-1.7b's serving geometries: (a) one
   ``make_job`` per (family, problem) that phase 4's gate verified, each
   started from the smallest config phase 4 ran in the problem's shape
   bucket; (b) ``run_fleet(jobs, workers=1, run_kernels=True,
   device="cuda")`` into ``chiprun_out/fleet/w1`` (successive halving,
   2 to 8 steps), the launch counters zeroed just before and read just
   after: every unit test must have launched its kernel, and nothing
   else may launch; (c) the same jobs on two spawn workers, sync and
   async, must write a byte-identical ``dispatch_table.json``, and
   re-invoking (b) must run 0 items; (d) phase 4's trace at full width
   and depth without a table and with (b)'s installed
   (``PagedServingEngine(dispatch_table=...)``), in turns (untuned,
   tuned, tuned, untuned): every decode and
   prefill tick through the two kernels, each geometry's config source
   (table or default) and table hit, decode tokens/s and p50 tick beside
   phase 4's, the share of tokens identical to phase 4's (bf16, no
   limit); at depth 2 in float32 (phase 5's setup) the kernel path's
   problems tuned into a table of their own, and the tokens served with
   it identical to those without; (e) each table entry at its exact
   problem, the kernel at the table's and at the default config, each
   held to the plain version, timed beside the cost model's estimate and
   the family's bound.  The table is uninstalled when the phase ends;
13. serve-flavours — the other decoder-only architectures: (a) both
   serving kernels against their plain versions at stablelm-3b's heads
   (32/32, head_dim 80), gemma-7b's (16/16, head_dim 256), codeqwen1.5-
   7b's (32/32, 128: group 1) and chameleon-34b's (64/8, 128: group 8),
   bf16 and float32, with phase 3's poisoned pages and zero-length row,
   each case naming its instance (every bf16 case on the tensor-core /
   wgmma instance, held to ``P_SPLIT_MISMATCH``), timed beside its bound
   and, for ragged prefill, one SDPA call; (b) phase 4's trace and engine
   at full width and depth on codeqwen1.5-7b, gemma-7b and stablelm-3b,
   every prefill and decode tick through the two kernels, the launch
   counters zeroed just before each run and read just after, and each
   profiled window's device time of the two kernels by instance (only
   the tensor-core ones may run); (c) the same on
   chameleon-34b at 16 of its 48 layers (all 48 do not fit one card
   beside the pool); (d) deepseek-v2-lite-16b at full width and depth,
   every tick on the gather paths (its MLA cache has no heads axis, as
   in the JAX engine), neither kernel launched; (e) phase 5 for each at
   depth 2 in float32 — for deepseek-v2-lite-16b the dense engine
   against the paged one — identical tokens;
14. hybrid and encoder-decoder — no kernel on these paths, in the JAX
   package neither: (a) recurrentgemma-2b at full width and depth (26
   layers, seed-0 random weights) in bf16, one forward over 2 x 4,096
   tokens (past its 2,048-token window, on the KV-block scan of
   ``sdpa``), finite logits, wall time, time between CUDA events and
   peak memory; (b) at depth 3 in float32 a 2,100-token
   ``decode_step`` replay against the forward's last position (within
   1e-4 of each logit plus 1e-4 of the largest), and ``rglru_scan`` at
   2 x 4,096 x 2,560 against a sequential float32 loop (1e-5); (c) the
   dense ``ServingEngine`` on (a)'s model over phase 4's trace (8
   slots, max_len 2,048): decode tokens/s and the p50 tick, every
   request decoding from the zeroed state its prefill returns, as in
   the JAX engine; (d) seamless-m4t-large-v2 at full width and depth
   (24 + 24 layers) in bf16: encode 4 x 1,024 seeded-normal frame
   embeddings, a teacher-forced ``apply`` over 4 x 256 tokens,
   ``prefill`` and 32 greedy ``decode_step`` ticks; at 2 + 2 layers in
   float32 64 teacher tokens through ``decode_step`` against ``apply``
   (phase (b)'s tolerance); (e) every launch counter zeroed before (a)
   and read after (d) must read 0;
15. train — no kernel on this path, in the JAX package neither: (a)
   qwen3-1.7b at full width and depth (28 layers, d_model 2048, vocab
   151,936, bf16 layers, the float32 embedding table, seed-0 weights,
   the synthetic data pipeline) trained with ``make_train_step`` (AdamW,
   clipping, the cosine schedule, per-layer recomputation) over batches
   of 8 x 1,024 tokens: 5 steps with grad_accum 1, then 2 with
   grad_accum 2; each step's loss, gradient norm, rate, time between
   CUDA events, tokens/s and peak memory, every metric finite; one more
   step under the profiler (busy share, largest device items, device
   time by kernel kind) and ``adamw_update`` alone on the full state;
   (b) at depth 2 in float32, 2 x 128 tokens, on the same weights, the
   card's step and the port's float32 CPU step each against the port's
   CPU step in float64: the loss within 1e-5 of its value, each
   gradient leaf within 1e-4 of its largest |value| (the card against
   the float32 CPU step logged, and the card's step repeated); (c) at depth 2 in bf16
   under ``torch.use_deterministic_algorithms``: 6 steps uninterrupted
   against 3 steps, a checkpoint, a restore into fresh tensors and 3
   more steps — losses, parameters and moments bit-identical; (d)
   ``examples/quickstart_torch.py``'s run through ``launch.train``
   (reduced qwen3, 200 steps of 8 x 128): the loss drops by more than
   0.3; (e) every launch counter zeroed before (a) and read after (d)
   must read 0;
16. dist — no kernel on these paths, in the JAX package neither, each
   part in a process of its own: (a) ``repro_torch.launch.train`` under
   ``torch.distributed.run`` at one rank (NCCL, mesh (1, 1)) on phase
   15's model and batch (qwen3-1.7b at full width and depth, 8 x 1,024
   tokens, 3 steps), against the same launcher run in one process:
   losses and final parameters within phase 15(b)'s bounds (bit-identity
   logged), each step's time and tokens/s beside the unsharded ones, the
   peak memory, and one more step under the dry-run's counter (FLOPs,
   collectives by kind); (b) ``launch.dryrun.run_cell`` at (a)'s
   configuration on a fake (1, 1) mesh: its peak within 10% of (a)'s
   ``max_memory_allocated``, its FLOPs equal to (a)'s counted step, its
   roofline step time beside the measured one; (c) qwen3-1.7b's
   train_4k, prefill_32k and decode_32k cells on both production meshes
   over the fake backend (256 and 512 ranks): bound, the three terms,
   collective bytes by kind, peak GiB a device against the card's 80 GB,
   trace seconds (the other architectures' cells are the dry-run CLI's,
   ``--all --mesh both``); (d) every launch counter of (a)-(c) reads 0;
17. geometries — the four attention kernels at the heads of widely
   served public decoders (``PUBLIC_HEADS``: phi-3-mini 32/32 x 96,
   starcoder2-15b 48/4 x 128, glm-4-9b 32/2 x 128, falcon-7b 71/1 x 64),
   bf16 and float32, at phase 3's shapes (``_decode_case``,
   ``_prefill_case``; flash_attention causal over 2,048 tokens, its
   default config; flash_decode 8 rows x 8,192 positions, kv_len 8,000,
   8 splits), paged_decode also at 2-, 24- and 512-token pages and in
   bf16 at head_dim 8, 16 and 32: each held to its plain version (TOL,
   or ``flash_error``) with its poisoned positions and a zero length,
   timed (CUDA events, L2 flushed; the decode kernels' split and
   combine on the device) beside the bound of its inputs, the family's
   ``*_sol``, the plain version and a library call where one computes
   the function, naming the instance that ran; the four kernels on
   their panel route at ``PANEL_GEOMETRIES`` (qwen3's 16/8 heads, bf16
   head_dim 33, 100, 300, 320 and 512, float32 50 and 320), held, timed
   and named the same way (each must name a "panel" instance); then
   paged_decode must refuse a 1-token page (as the JAX gate does) with
   ValueError and no launch; then the example twins
   (``examples/serve_demo_torch.py``, ``figure1_dsl_torch.py``) on the
   card;
18. the kernels line (JSON, all eight kernels; paged_decode's and
   ragged_prefill's entries list phase 13a's instances with their
   launches in phase 13's runs, and the four attention kernels phase
   17's cases under ``geometries``), then the final line
   ``{"ok": true, "device": {...}}``.

Phases 4 and 9 also report the ARGUS gate's verify calls on the serving
path (one per batch geometry and per packed prefill geometry).  With a
table installed (phase 12d) a geometry is verified by ``configured`` at
the table's config and by the op at the config it resolved, so the
count read there is of distinct (family, config, problem) triples: the
same triple at most twice, at most two configs a geometry.

A summary of every number also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense peak rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12,
              # float32-accurate tensor-core products: three TF32
              # products a pair (3xTF32), a third of the 495 TFLOP/s
              "tf32x3": 495e12 / 3}

SERVE = dict(arch="qwen3-1.7b", max_batch=8, max_len=2048, page_size=16,
             prefill_chunk=256, requests=16, prompt_lens=(64, 1024),
             max_new=(16, 32), mean_gap=2.0, seed=0, tag="serve")
# phase 9: the serve phase's trace and engine on granite-moe-3b-a800m
SERVE_MOE = dict(SERVE, arch="granite-moe-3b-a800m", tag="serve-moe")
# phase 4 also serves qwen3-1.7b at full width with head_dim 100 (bf16
# rows off the 16-byte grain) and 320 (above 256), two layers, a short
# trace: every tick on the two serving kernels' panel route
SERVE_HEAD_DIMS = [dict(SERVE, head_dim=D, n_layers=2, requests=8,
                        prompt_lens=(64, 512), max_new=(8, 16),
                        profile=False, tag=f"serve/head_dim {D}")
                   for D in (100, 320)]

# Tolerances of a kernel against its plain version on the same inputs:
# float32 — the two sum the same products in another order (up to 2048
# terms here), far below 1e-4 for outputs of size ~1; bfloat16 — each
# rounds its float32 result to bfloat16 once and may land on the other
# neighbour: one bfloat16 step at |x| < 2 is 2^-7, so 1e-2.
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
POISON = 1e6

class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# -- timing ------------------------------------------------------------------

def time_ms(torch, fn, iters=20, warmup=3):
    """Median device time of ``fn`` (CUDA events around each call), the
    L2 cache flushed before each call: on the serving path every layer
    reads its own weights and pool leaf, so a kernel finds them cold."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        times.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def back_to_back_ms(torch, fn, n=20):
    """Time per call of ``fn`` over ``n`` calls launched back to back
    between two CUDA events (after a warm-up call): the card runs one
    call after another while the host enqueues the next, so a short
    call's host time drops out; nothing is flushed, so the L2 holds
    what the previous call left."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def bound_ms(n_bytes, flops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# -- phase 1 -----------------------------------------------------------------

def phase_card(torch):
    from repro_torch.device import resolve_device
    resolve_device("cuda")        # also pins TF32 off for float32 matmuls
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    log(line)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability "
        f"{torch.cuda.get_device_capability(0)}, "
        f"{torch.cuda.device_count()} visible")
    return line


# -- phase 2 -----------------------------------------------------------------

def phase_build():
    """Build every kernel; log ptxas's registers, shared memory and
    spills for each instance and, for the libraries with tensor-core
    instances, the tensor-core and copy instructions of each instance in
    the SASS: HGMMA (wgmma), IGMMA (int8 wgmma), HMMA (mma.sync, TF32
    included), IMMA (int8 mma.sync), UTMALDG (TMA tensor loads), UBLKCP
    (bulk copies).  A spill in any instance fails the run."""
    import re
    from repro_torch.core.kernelspec import TILE_WIDTHS
    from repro_torch.kernels import ALL_KERNELS, build_all
    t0 = time.perf_counter()
    logs = build_all(ALL_KERNELS)
    secs = time.perf_counter() - t0
    log(f"[build] {len(ALL_KERNELS)} kernels in {secs:.1f} s")
    spills = []
    for name, text in logs.items():
        entry = ""
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                entry = _instance(ln)
            elif "registers" in ln or "spill" in ln or "bytes smem" in ln:
                log(f"[build] {name}{entry}: {ln.strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", ln)
                if m and (int(m.group(1)) or int(m.group(2))):
                    spills.append(f"{name}{entry}")
    check(not spills, f"ptxas spilled registers in {spills}")
    sass = {}
    for k in ALL_KERNELS:
        if k.name not in WGMMA_LIBS + ("flash_decode", "paged_decode",
                                       "ssd_chunk_scan"):
            continue
        for fn, counts in _sass_counts(k._lib_path()).items():
            inst = f"{k.name}{_instance(fn)}"
            sass[inst] = counts
            log(f"[build] sass {inst}: " + ", ".join(
                f"{op} {n}" for op, n in counts.items()))
    for inst, c in sass.items():
        if "int8 wgmma" in inst:
            check(c["IGMMA"] > 0 and c["UTMALDG"] > 0,
                  f"{inst}: no int8 wgmma or no TMA load in its SASS: {c}")
        elif "wgmma" in inst:
            check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
                  f"{inst}: no wgmma or no TMA load in its SASS: {c}")
        if " state " in inst or " scan " in inst:
            check(c["HMMA"] > 0, f"{inst}: no TF32 tensor-core product in "
                  f"its SASS: {c}")
        if "decode bf16" in inst or "tensor cores" in inst:
            check(c["HMMA"] > 0 and c["UTMALDG"] > 0,
                  f"{inst}: no tensor-core product or no TMA load: {c}")
    for name in WGMMA_LIBS:
        check(any(i.startswith(name + " ") and "wgmma" in i for i in sass),
              f"{name}: no wgmma instance in its SASS")
    check(any(i.startswith("paged_decode ") and "tensor cores" in i
              for i in sass), "paged_decode: no tensor-core instance in "
          "its SASS")
    # the bf16 tensor-core instances of the four attention kernels at
    # each tile width (every head_dim runs in one of them)
    for W in TILE_WIDTHS:
        for inst, ops in ((f"ragged_prefill bf16 wgmma W={W}", "HGMMA"),
                          (f"paged_decode tensor cores bf16 W={W}", "HMMA"),
                          (f"flash_decode decode bf16 W={W}", "HMMA"),
                          (f"flash_attention bf16 wgmma W={W} tile=128",
                           "HGMMA")):
            c = sass.get(inst)
            check(c is not None and c[ops] > 0 and c["UTMALDG"] > 0,
                  f"{inst}: missing, or no {ops} or no TMA load in its "
                  f"SASS: {c}")
    for part in ("state", "scan"):
        check(sum(i.startswith(f"ssd_chunk_scan {part} ") for i in sass)
              == 2, f"ssd_chunk_scan: no f32 and bf16 {part} kernels in "
              f"its SASS")
    # the panel route of the four attention kernels: bf16 on mma.sync at
    # both panel widths, prefill in flash_attention and ragged_prefill,
    # decode in paged_decode and flash_decode
    for name, kind in (("flash_attention", "prefill"),
                       ("ragged_prefill", "prefill"),
                       ("paged_decode", "decode"), ("flash_decode", "decode")):
        for pw in (64, 256):
            c = sass.get(f"{name} panel bf16 {kind} PW={pw}")
            check(c is not None and c["HMMA"] > 0,
                  f"{name}: no bf16 panel {kind} at PW={pw} on mma.sync "
                  f"in its SASS: {c}")
    return dict(seconds=secs, sass=sass)


SASS_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA", "UTMALDG", "UBLKCP")
# the libraries with instances on wgmma fed by TMA
WGMMA_LIBS = ("gemm", "ragged_prefill", "flash_attention", "grouped_ffn",
              "quant_gemm")


def _sass_counts(lib):
    """{kernel function: {op: count}} over SASS_OPS, from
    ``cuobjdump -sass`` of a built library."""
    import re
    from repro_torch.kernels._build import nvcc_path
    tool = Path(nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {lib.name}: "
          f"{out.stderr.strip()[-2000:]}")
    counts, fn = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", ln):
                    counts[fn][op] += 1
    return counts


def _instance(ptxas_line):
    """' <type> <template arguments>' for a template instance of the
    GEMM or flash kernels (from its mangled name), else ''.  An attention
    kernel's instance compiled for head_dim = W ends in " D=W"."""
    import re
    full = lambda m: " D=W" if m.group(m.lastindex) == "1" else ""
    # the attention kernels' panel route (panel_attention.cuh), and the
    # SSD scan over state panels
    m = re.search(r"(prefill|decode)_(bf16|f32)_panelILi(\d+)E", ptxas_line)
    if m:
        return f" panel {m.group(2)} {m.group(1)} PW={m.group(3)}"
    m = re.search(r"combine_panelsI(t|f)E", ptxas_line)
    if m:
        return f" panel combine {'bf16' if m.group(1) == 't' else 'f32'}"
    m = re.search(r"ssd_scan_panel_kernelI(13__nv_bfloat16|f)E", ptxas_line)
    if m:
        return f" panel scan {'bf16' if m.group(1) != 'f' else 'f32'}"
    m = re.search(r"gemm_wgmma_kernelILi(\d+)E", ptxas_line)
    if m:
        return f" bf16 wgmma 128x{m.group(1)}"
    m = re.search(r"ragged_wgmma_kernelILi(\d+)ELb([01])E", ptxas_line)
    if m:
        return f" bf16 wgmma W={m.group(1)}{full(m)}"
    m = re.search(r"ragged_prefill_kernelILi(\d+)ELb([01])E", ptxas_line)
    if m:
        return f" f32 W={m.group(1)}{full(m)}"
    m = re.search(r"gemm_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E",
                  ptxas_line)
    if m:
        dtype = "bf16" if m.group(1) != "f" else "f32"
        return f" {dtype} {m.group(2)}x{m.group(3)}"
    m = re.search(r"fa_(bf16|f32)_kernelILi(\d+)ELi(\d+)ELb([01])E",
                  ptxas_line)
    if m:
        rows = int(m.group(3)) * (16 if m.group(1) == "bf16" else 1)
        return f" {m.group(1)} W={m.group(2)} tile={rows}{full(m)}"
    m = re.search(r"fa_wgmma_kernelILi(\d+)ELi(\d+)ELb([01])E", ptxas_line)
    if m:
        return (f" bf16 wgmma W={m.group(1)} tile={64 * int(m.group(2))}"
                f"{full(m)}")
    m = re.search(r"paged_decode_bf16_kernelILi(\d+)ELb([01])E",
                  ptxas_line)
    if m:
        return f" tensor cores bf16 W={m.group(1)}{full(m)}"
    m = re.search(r"paged_decode_f32_kernelILi(\d+)ELb([01])E", ptxas_line)
    if m:
        return f" cuda cores f32 W={m.group(1)}{full(m)}"
    m = re.search(r"paged_combine_kernelI(13__nv_bfloat16|f)E", ptxas_line)
    if m:
        return f" combine {'bf16' if m.group(1) != 'f' else 'f32'}"
    m = re.search(r"ffn_wgmma_kernelILi(\d+)ELb([01])E", ptxas_line)
    if m:
        launch = "gate/up" if m.group(2) == "1" else "down"
        return f" bf16 wgmma {launch} BM={m.group(1)}"
    m = re.search(r"decode_(bf16|f32)_kernelILi(\d+)E(?:Lb([01])E)?",
                  ptxas_line)
    if m:
        return f" decode {m.group(1)} W={m.group(2)}" + (
            full(m) if m.group(3) else "")
    m = re.search(r"combine_kernelI(13__nv_bfloat16|f)E", ptxas_line)
    if m:
        return f" combine {'bf16' if m.group(1) != 'f' else 'f32'}"
    m = re.search(r"ffn_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELb([01])E",
                  ptxas_line)
    if m:
        dtype = "bf16" if m.group(1) != "f" else "f32"
        launch = "gate/up" if m.group(4) == "1" else "down"
        return f" {dtype} {launch} {m.group(2)}x{m.group(3)}"
    m = re.search(r"quant_gemm_kernelILi(\d+)ELi(\d+)E", ptxas_line)
    if m:
        return f" mma.sync {m.group(1)}x{m.group(2)}"
    if "quant_wgmma_kernel" in ptxas_line:
        return " int8 wgmma 128x128"
    if "transpose_kernel" in ptxas_line:
        return " transpose"
    m = re.search(r"ssd_(state|scan)_kernelI(13__nv_bfloat16|f)E",
                  ptxas_line)
    if m:
        return f" {m.group(1)} {'bf16' if m.group(2) != 'f' else 'f32'}"
    if "ssd_pass_kernel" in ptxas_line:
        return " pass"
    return ""


# -- phase 3 -----------------------------------------------------------------

QWEN_HEADS = (16, 8, 128)       # (query heads, KV heads, head_dim)
GRANITE_HEADS = (24, 8, 64)


def _decode_case(torch, dtype, seed=0, NP=None,
                 lengths=(0, 1, 17, 256, 300, 777, 1040, 2048),
                 heads=QWEN_HEADS, PS=16):
    """Main-path decode shapes: batch 8, 16/8 heads, head_dim 128 (or
    ``heads``), 16-token pages (or ``PS``), 128 pages per sequence
    (max_len 2048; at other page sizes as many as 2048 tokens take), a
    768-page pool (at other page sizes the same bytes, or the pages the
    rows map and 64 more)."""
    (Hq, Hkv, D), B = heads, 8
    NP = NP or -(-2048 // PS)
    P = max(sum(-(-n // PS) for n in lengths) + 64, 768 * 16 // PS)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, 1, D, generator=g, device="cuda").to(dt)
    kp = torch.randn(P, Hkv, PS, D, generator=g, device="cuda").to(dt)
    vp = torch.randn(P, Hkv, PS, D, generator=g, device="cuda").to(dt)
    kp[0] = 0
    vp[0] = 0
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
    table = torch.zeros(B, NP, dtype=torch.int32, device="cuda")
    used, mapped = 0, set()
    for b, n in enumerate(lengths):
        npg = -(-n // PS)
        table[b, :npg] = perm[used:used + npg].to(torch.int32)
        mapped.update(perm[used:used + npg].tolist())
        used += npg
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    # poison: the null page, every page no row maps, and each row's tail
    # beyond its length inside its last page
    kp2, vp2 = kp.clone(), vp.clone()
    unmapped = [p for p in range(P) if p not in mapped]
    kp2[unmapped] = POISON
    vp2[unmapped] = POISON
    for b, n in enumerate(lengths):
        if n % PS:
            last = int(table[b, n // PS])
            kp2[last, :, n % PS:] = POISON
            vp2[last, :, n % PS:] = POISON
    return (q, kp, vp, table, lens), (kp2, vp2), lengths, (Hq, Hkv, D)


def phase_decode_kernel(torch, dtype, heads=QWEN_HEADS, PS=16):
    from repro_torch.core.families.paged_attention import (
        PagedAttentionProblem, instance_name, paged_attention_sol)
    from repro_torch.kernels.paged_attention import paged_decode_ref
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    from repro_torch.kernels.paged_attention.ref import (P_SPLIT_MISMATCH,
                                                         mismatch_share)
    (q, kp, vp, table, lens), (kp2, vp2), lengths, (Hq, Hkv, D) = \
        _decode_case(torch, dtype, heads=heads, PS=PS)
    # bf16 splits p (p_hi + p_lo) on the tensor-core instance and on the
    # panel route alike
    tc = q.element_size() == 2
    got = paged_decode(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    want = paged_decode_ref(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(err <= TOL[dtype], f"paged_decode {dtype}: max |kernel - plain| "
          f"{err} > {TOL[dtype]}")
    share = None
    if tc:
        # p at float32 accuracy (p_hi + p_lo): the bf16 output is the
        # plain version's almost everywhere
        share = mismatch_share(got, want, lens)
        check(share <= P_SPLIT_MISMATCH, f"paged_decode {dtype}: {share} "
              f"of the outputs differ from the plain version's (> "
              f"{P_SPLIT_MISMATCH}): p lost float32 accuracy")
    check(float(got[0].abs().max()) == 0.0,
          "paged_decode: a zero-length row must give zeros")
    poisoned = paged_decode(q, kp2, vp2, table, lens)
    torch.cuda.synchronize()
    check(torch.equal(got, poisoned), f"paged_decode {dtype}: poisoned "
          "foreign/null/tail pages moved the output")
    call = lambda: paged_decode(q, kp, vp, table, lens)
    elt = q.element_size()
    tokens = sum(lengths)
    kv_bytes = tokens * Hkv * D * 2 * elt
    ms = time_ms(torch, call)
    split_ms, combine_ms = decode_parts_ms(torch, call, kv_bytes=kv_bytes)
    plain = time_ms(torch, lambda: paged_decode_ref(q, kp, vp, table, lens))
    n_bytes = (kv_bytes + 2 * q.numel() * elt
               + table.numel() * 4 + lens.numel() * 4)
    flops = 4 * Hq * D * tokens
    bms, by = bound_ms(n_bytes, flops, dtype)
    B, NP, P = q.shape[0], table.shape[1], kp.shape[0]
    sol = paged_attention_sol(PagedAttentionProblem(
        B, Hq, Hkv, NP * PS, PS, P, D, SHORT[dtype])).time_s * 1e3
    log(f"[kernels] paged_decode {dtype} {Hq}/{Hkv}x{D}, {PS}-token pages, "
        f"on its {instance_name(D, elt)} instance: max_abs_err {err:.3g} "
        f"(tol {TOL[dtype]}), outputs "
        f"differing from the plain version {share} (limit "
        f"{P_SPLIT_MISMATCH} in bf16), poisoned run bit-identical; "
        f"{ms:.4f} ms a call (device: split {_ms_or(split_ms)}, combine "
        f"{_ms_or(combine_ms)}), plain {plain:.4f} ms, bound {bms:.4f} ms "
        f"({by}; the family's paged_attention_sol over every page of the "
        f"table {sol:.4f} ms), library: none")
    out = dict(max_abs_err=err, mismatch_share=share, ms=ms,
               decode_parts_ms=dict(split=split_ms, combine=combine_ms),
               plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
               sol_ms=sol, bytes=n_bytes, flops=flops, heads=list(heads),
               page_size=PS,
               instance_name=instance_name(D, elt))
    if heads == QWEN_HEADS and PS == 16:
        out["width_125"] = _decode_width_125(torch, dtype)
        if dtype == "bfloat16":
            out["production"] = _decode_production(torch)
    return out


def _decode_width_125(torch, dtype):
    """A table width the tile's page count does not divide: 125 pages
    (max_len 2000) walk as 31 tiles of four pages and one of one (bf16;
    f32 tiles hold two), in the spans the wrapper derives from the
    shapes, the last span shorter.  Beside it, the same kernel with the
    whole row in one span (no split walk)."""
    from repro_torch.core.families.paged_attention import (pages_per_step,
                                                           span_pages)
    from repro_torch.kernels._build import ptr, stream_handle
    from repro_torch.kernels.paged_attention import KERNEL, paged_decode_ref
    from repro_torch.kernels.paged_attention.paged_attention import \
        PagedAttentionConfig, paged_decode
    (q, kp, vp, table, lens), _, _, (Hq, Hkv, D) = _decode_case(
        torch, dtype, NP=125, lengths=(0, 1, 17, 256, 300, 777, 1040, 2000))
    want = paged_decode_ref(q, kp, vp, table, lens)
    B, P, PS, NP = q.shape[0], kp.shape[0], kp.shape[2], table.shape[1]
    elt = q.element_size()
    step = pages_per_step(PS, D, elt)
    out = torch.empty_like(q)
    one_span = -(-NP // step) * step
    o_part = torch.empty(B * Hq, 1, D, dtype=torch.float32, device=q.device)
    ml = torch.empty(2, B * Hq, 1, dtype=torch.float32, device=q.device)

    def whole_row():
        KERNEL.launch(ptr(q), ptr(kp), ptr(vp), ptr(table), ptr(lens),
                      ptr(o_part), ptr(ml[0]), ptr(ml[1]), ptr(out), B, Hq,
                      Hkv, P, D, PS, NP, one_span, D ** -0.5, int(elt == 2),
                      stream_handle(q.device))
        return out

    res = {}
    cfg = PagedAttentionConfig(block_pages=1)     # divides 125
    for name, fn in (("spans", lambda: paged_decode(q, kp, vp, table, lens,
                                                    cfg=cfg)),
                     ("one_span", whole_row)):
        err = float((fn().float() - want.float()).abs().max())
        check(err <= TOL[dtype], f"paged_decode {dtype} at 125 pages, "
              f"{name}: max |kernel - plain| {err} > {TOL[dtype]}")
        res[name] = dict(max_abs_err=err, ms=time_ms(torch, fn))
    sp = span_pages(B, Hkv, NP, PS, D, elt, Hq // Hkv)
    log(f"[kernels] paged_decode {dtype} at 125 pages: {step}-page tiles "
        f"(the last shorter), spans of {sp} pages "
        f"{res['spans']['ms']:.4f} ms, the whole row in one span "
        f"{res['one_span']['ms']:.4f} ms; max_abs_err "
        f"{res['spans']['max_abs_err']:.3g} / "
        f"{res['one_span']['max_abs_err']:.3g}")
    return res


def decode_production_case(torch):
    """The paged family's production problem and its inputs on the card:
    every row at its full length, its pages drawn without repeats from
    the pool (page 0, the null page, left out)."""
    from repro_torch.core.families import get_family
    prob = get_family("paged_attention").example()[1]
    B, Hq, Hkv, S = prob.batch, prob.q_heads, prob.kv_heads, prob.seq_kv
    PS, P, D = prob.page_size, prob.pool_pages, prob.head_dim
    NP = S // PS
    g = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn(B, Hq, 1, D, generator=g, device="cuda").bfloat16()
    kp = torch.randn(P, Hkv, PS, D, generator=g, device="cuda").bfloat16()
    vp = torch.randn(P, Hkv, PS, D, generator=g, device="cuda").bfloat16()
    table = (torch.randperm(P - 1, generator=g, device="cuda")[:B * NP] + 1
             ).reshape(B, NP).to(torch.int32)
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    return prob, (q, kp, vp, table, lens)


def _decode_production(torch):
    """The family's production problem (``paged_attention`` example: 32
    rows of 8192 positions, 8 query heads over 1 KV head, head_dim 128,
    128-token pages, a pool of 2304, bf16), held to the plain version and
    timed: the whole call, its split kernel and combine on the device,
    the plain version, the bound, and beside them the port's dense
    split-KV decode (``mha_decode``, the flash_decode kernel at its best
    config, 8 spans) on the same positions gathered into a dense cache:
    the same bytes, read without a table."""
    from repro_torch.core.families.flash_decode import FlashDecodeConfig
    from repro_torch.core.families.paged_attention import (instance_name,
                                                           n_spans)
    from repro_torch.kernels.flash_attention import mha_decode
    from repro_torch.kernels.paged_attention import (gather_cache,
                                                     paged_decode_ref)
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    from repro_torch.kernels.paged_attention.ref import (P_SPLIT_MISMATCH,
                                                         mismatch_share)
    prob, (q, kp, vp, table, lens) = decode_production_case(torch)
    B, Hq, Hkv, S = prob.batch, prob.q_heads, prob.kv_heads, prob.seq_kv
    PS, P, D = prob.page_size, prob.pool_pages, prob.head_dim
    call = lambda: paged_decode(q, kp, vp, table, lens)
    got = call()
    want = paged_decode_ref(q, kp, vp, table, lens)
    err = float((got.float() - want.float()).abs().max())
    check(err <= TOL["bfloat16"], f"paged_decode at the production "
          f"problem: max |kernel - plain| {err} > {TOL['bfloat16']}")
    share = mismatch_share(got, want, lens)
    check(share <= P_SPLIT_MISMATCH, f"paged_decode at the production "
          f"problem: {share} of the outputs differ from the plain version")
    kv_bytes = 2 * B * Hkv * S * D * 2
    ms = time_ms(torch, call)
    split_ms, combine_ms = decode_parts_ms(torch, call, kv_bytes=kv_bytes)
    plain = time_ms(torch, lambda: paged_decode_ref(q, kp, vp, table, lens),
                    iters=5, warmup=1)
    kd, vd = gather_cache(kp, table), gather_cache(vp, table)
    kv_len = torch.tensor(S, dtype=torch.int32, device="cuda")
    dense = lambda: mha_decode(q, kd, vd, kv_len,
                               cfg=FlashDecodeConfig(kv_splits=8))
    dense_ms = time_ms(torch, dense)
    dense_split, dense_combine = decode_parts_ms(torch, dense,
                                                 kv_bytes=kv_bytes)
    n_bytes = (kv_bytes + 2 * q.numel() * 2
               + table.numel() * 4 + lens.numel() * 4)
    flops = 4 * Hq * D * S * B
    bms, by = bound_ms(n_bytes, flops, "bfloat16")
    ns = n_spans(prob)
    log(f"[kernels] paged_decode at the family's production problem ({B} "
        f"x {Hq}/{Hkv} x {S}, {PS}-token pages, pool {P}, bf16) on its "
        f"{instance_name(D, 2)} instance, {ns} spans a row: max_abs_err "
        f"{err:.3g}, outputs differing from the plain version {share:.4f}; "
        f"{ms:.4f} ms a call (device: split {_ms_or(split_ms)}, combine "
        f"{_ms_or(combine_ms)}), plain {plain:.4f} ms, bound {bms:.4f} ms "
        f"({by}); the dense flash_decode kernel at the same bytes "
        f"{dense_ms:.4f} ms a call (device: split {_ms_or(dense_split)}, "
        f"combine {_ms_or(dense_combine)})")
    del kp, vp, kd, vd, want
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, mismatch_share=share, ms=ms,
                decode_parts_ms=dict(split=split_ms, combine=combine_ms),
                plain_ms=plain, bound_ms=bms, bound_by=by, bytes=n_bytes,
                spans=ns, dense_flash_decode_ms=dense_ms,
                dense_flash_decode_parts_ms=dict(split=dense_split,
                                                 combine=dense_combine))


def _prefill_case(torch, dtype, seed=1, heads=QWEN_HEADS):
    """Main-path prefill shapes: one tick packing 8 prompt chunks of up
    to 256 tokens against their prefixes (up to 768 earlier tokens),
    both buffers padded to 64 (as the engine packs them)."""
    Hq, Hkv, D = heads
    chunks = [256, 256, 256, 256, 256, 256, 256, 200]
    prefixes = [0, 256, 512, 768, 0, 256, 512, 768]
    pad = lambda t: -(-t // 64) * 64
    TQ = pad(sum(chunks))
    TK = pad(sum(p + n for p, n in zip(prefixes, chunks)))
    seg_q = torch.full((TQ,), -1, dtype=torch.int32)
    pos_q = torch.zeros(TQ, dtype=torch.int32)
    seg_k = torch.full((TK,), -1, dtype=torch.int32)
    pos_k = torch.zeros(TK, dtype=torch.int32)
    qt = kt = 0
    pairs = 0
    for j, (p, n) in enumerate(zip(prefixes, chunks)):
        seg_q[qt:qt + n] = j
        pos_q[qt:qt + n] = torch.arange(p, p + n)
        seg_k[kt:kt + p + n] = j
        pos_k[kt:kt + p + n] = torch.arange(p + n)
        pairs += n * p + n * (n + 1) // 2
        qt += n
        kt += p + n
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(Hq, TQ, D, generator=g, device="cuda").to(dt)
    k = torch.randn(Hkv, TK, D, generator=g, device="cuda").to(dt)
    v = torch.randn(Hkv, TK, D, generator=g, device="cuda").to(dt)
    meta = [t.cuda() for t in (seg_q, pos_q, seg_k, pos_k)]
    return (q, k, v, *meta), pairs


def phase_prefill_kernel(torch, dtype, heads=QWEN_HEADS):
    import torch.nn.functional as F
    from repro_torch.kernels.ragged_prefill import (default_config,
                                                    ragged_prefill_ref)
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill
    from repro_torch.kernels.ragged_prefill.ref import (P_SPLIT_MISMATCH,
                                                        admit_mask,
                                                        mismatch_share)
    from repro_torch.core.families.ragged_prefill import (
        RaggedPrefillProblem, instance_name, ragged_prefill_sol)
    (q, k, v, sq, pq, sk, pk), pairs = _prefill_case(torch, dtype,
                                                     heads=heads)
    Hq, TQ, D = q.shape
    Hkv, TK, _ = k.shape
    cfg = default_config(TQ, TK)
    prob = RaggedPrefillProblem(8, TK, Hq, Hkv, D, SHORT[dtype])
    # bf16 splits p (p_hi + p_lo) on wgmma and on the panel route alike
    wg = q.element_size() == 2
    got = ragged_prefill(q, k, v, sq, pq, sk, pk, cfg=cfg)
    torch.cuda.synchronize()
    want = ragged_prefill_ref(q, k, v, sq, pq, sk, pk)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(err <= TOL[dtype], f"ragged_prefill {dtype}: max |kernel - "
          f"plain| {err} > {TOL[dtype]}")
    share = None
    if wg:
        # p at float32 accuracy (p_hi + p_lo): the bf16 output is the
        # plain version's almost everywhere; p rounded alone moves ~37%
        share = mismatch_share(got, want, sq)
        check(share <= P_SPLIT_MISMATCH, f"ragged_prefill {dtype}: "
              f"{share} of the outputs differ from the plain version's "
              f"(> {P_SPLIT_MISMATCH}): p lost float32 accuracy")
    check(float(got[:, sq < 0].abs().max()) == 0.0,
          "ragged_prefill: padding queries must give zeros")
    # poison one foreign segment (3) and the padding keys
    k2, v2 = k.clone(), v.clone()
    foreign = (sk == 3) | (sk < 0)
    k2[:, foreign] = POISON
    v2[:, foreign] = POISON
    poisoned = ragged_prefill(q, k2, v2, sq, pq, sk, pk, cfg=cfg)
    torch.cuda.synchronize()
    keep = sq != 3
    check(torch.equal(got[:, keep], poisoned[:, keep]),
          f"ragged_prefill {dtype}: a poisoned foreign segment leaked")
    ms = time_ms(torch, lambda: ragged_prefill(q, k, v, sq, pq, sk, pk,
                                               cfg=cfg))
    plain = time_ms(torch, lambda: ragged_prefill_ref(q, k, v, sq, pq, sk,
                                                      pk))
    mask = admit_mask(sq, pq, sk, pk)[None, None]
    sdpa = lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], attn_mask=mask, enable_gqa=True)
    lib = time_ms(torch, sdpa)
    dev = back_to_back_ms(torch, lambda: ragged_prefill(q, k, v, sq, pq, sk,
                                                        pk, cfg=cfg))
    lib_dev = back_to_back_ms(torch, sdpa)
    elt = q.element_size()
    n_bytes = ((2 * q.numel() + k.numel() + v.numel()) * elt
               + 4 * 2 * (TQ + TK))
    flops = 4 * Hq * D * pairs
    bms, by = bound_ms(n_bytes, flops, dtype)
    sol = ragged_prefill_sol(prob).time_s * 1e3
    log(f"[kernels] ragged_prefill {dtype} {Hq}/{Hkv}x{D} on its "
        f"{instance_name(prob)} instance: TQ {TQ}, TK {TK}, {pairs} "
        f"admitted pairs per head; max_abs_err {err:.3g} (tol "
        f"{TOL[dtype]}), outputs differing from the plain version "
        f"{share} (limit {P_SPLIT_MISMATCH} in bf16), poisoned segment "
        f"bit-identical; {ms:.4f} ms "
        f"(back to back {dev:.4f}), plain {plain:.4f} ms, bound {bms:.4f} "
        f"ms ({by}; the family's ragged_prefill_sol {sol:.4f} ms), library "
        f"(sdpa, masked, enable_gqa) {lib:.4f} ms (back to back "
        f"{lib_dev:.4f})")
    return dict(max_abs_err=err, mismatch_share=share, ms=ms,
                plain_ms=plain, bound_ms=bms, sol_ms=sol,
                bound_by=by, library_ms=lib, bytes=n_bytes, flops=flops,
                TQ=TQ, TK=TK, pairs=pairs, heads=list(heads),
                instance_name=instance_name(prob),
                back_to_back_ms=dev, library_back_to_back_ms=lib_dev)


# -- phase 4 -----------------------------------------------------------------

def drive(engine, trace, torch):
    """Replay ``trace`` tick by tick (as serve.trace.replay does),
    recording per tick whether it decoded and prefilled, which path it
    took, and its wall time (each step ends in a device-to-host copy of
    the sampled tokens, so the host clock covers the device work)."""
    pending = sorted(trace, key=lambda a: (a.tick, a.rid))
    ticks = []
    t = 0
    c = engine.metrics.counters
    while True:
        while pending and pending[0].tick <= t:
            engine.submit(pending.pop(0).request())
        before = dict(c)
        t0 = time.perf_counter()
        engine.step()
        dt = time.perf_counter() - t0
        d = {k: c[k] - before[k] for k in c}
        ticks.append(dict(seconds=dt, decoded=d["decode_tokens"] > 0,
                          prefilled=d["prefill_tokens"] > 0,
                          kernel_decode=d["kernel_decode_ticks"],
                          kernel_prefill=d["kernel_prefill_ticks"],
                          decode_tokens=d["decode_tokens"],
                          prefill_tokens=d["prefill_tokens"]))
        if not pending and not engine.queue and not engine.active:
            break
        t += 1
        check(t < 10_000, "serving did not drain")
    torch.cuda.synchronize()
    return ticks


def _pool_pages(s):
    return s["max_batch"] * s["max_len"] // s["page_size"] * 3 // 4


def _serve_engine(model, params, s, **kw):
    """The serve phase's engine: both kernel paths, ``s``'s geometry."""
    from repro_torch.serve import PagedServingEngine
    return PagedServingEngine(
        model, params, pool_pages=_pool_pages(s), page_size=s["page_size"],
        max_batch=s["max_batch"], max_len=s["max_len"],
        prefill_chunk=s["prefill_chunk"], eos_id=-1, decode_path="kernel",
        prefill_path="kernel", device="cuda", **kw)


def _serve_trace(cfg, s):
    from repro_torch.serve.trace import poisson_trace
    return poisson_trace(seed=s["seed"], n_requests=s["requests"],
                         mean_gap=s["mean_gap"], prompt_lens=s["prompt_lens"],
                         max_new=s["max_new"], vocab=cfg.vocab)


def _serve_run(torch, eng, trace, cfg, s, tag, path="kernel"):
    """Replay ``trace`` through ``eng`` (the serve phase's engine) with
    the launch counters zeroed just before and read just after and the
    gate's verify calls recorded; checks that every request finished
    with its tokens and that every tick that decoded or prefilled went
    through the two kernels (``path="gather"``: that none did, and that
    neither kernel launched — an MLA cache).  Returns the run's numbers,
    its tokens, the gate calls and (under ``verified``) the recorded
    (family, config, problem) triples."""
    from repro_torch.kernels import ALL_KERNELS
    torch.cuda.reset_peak_memory_stats()
    gate, verified = _record_gate()
    for k in ALL_KERNELS:                      # count the main path only
        k.launches = 0
    t0 = time.perf_counter()
    try:
        ticks = drive(eng, trace, torch)
    finally:
        del gate.verify                        # the engine's own method
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ALL_KERNELS}
    fams = sorted({f for f, *_ in verified})
    # an MLA cache has no heads axis: its gate applies the concrete
    # block-table checks only, no family is verified
    check(fams == (["paged_attention", "ragged_prefill"] if path == "kernel"
                   else []),
          f"gate calls on the serving path: {len(verified)}, families "
          f"{fams}")

    c = eng.metrics.counters
    done = eng.finished
    check(len(done) == s["requests"], f"{len(done)} of {s['requests']} "
          "requests finished")
    check(all(r.error is None for r in done), "a request failed: " + str(
        [r.error for r in done if r.error]))
    by_rid = {a.rid: a for a in trace}
    for r in done:
        check(len(r.output) == by_rid[r.rid].max_new_tokens,
              f"rid {r.rid}: {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.output),
              f"rid {r.rid}: token outside the vocabulary")
    n_dec = sum(t["decoded"] for t in ticks)
    n_pre = sum(t["prefilled"] for t in ticks)
    L = cfg.n_layers
    if path == "kernel":
        check(all(t["kernel_decode"] == t["decoded"] for t in ticks),
              "a decode tick did not go through the paged-decode kernel")
        check(all(t["kernel_prefill"] == t["prefilled"] for t in ticks),
              "a prefill tick did not go through the ragged-prefill kernel")
        check(c["kernel_decode_ticks"] == n_dec and
              c["kernel_prefill_ticks"] == n_pre, "kernel tick counters")
        check(c["gather_bytes"] == 0, "kernel decode gathered a dense view")
        check(launches["paged_decode"] >= L * c["kernel_decode_ticks"],
              f"paged_decode launched {launches['paged_decode']} times for "
              f"{c['kernel_decode_ticks']} ticks x {L} layers")
        check(launches["ragged_prefill"] >= L * c["kernel_prefill_ticks"],
              f"ragged_prefill launched {launches['ragged_prefill']} times "
              f"for {c['kernel_prefill_ticks']} ticks x {L} layers")
        # the null page (page 0) of every layer's pool stays unwritten
        for leaf in eng.kv.storage["blocks"].values():
            check(float(leaf[:, 0].abs().max()) == 0,
                  "the null page was written")
    else:
        check(c["kernel_decode_ticks"] == c["kernel_prefill_ticks"] == 0,
              "a tick of the gather path went through a kernel")
        check(launches["paged_decode"] == launches["ragged_prefill"] == 0,
              f"the gather path launched a serving kernel: {launches}")
        check(c["gather_bytes"] > 0 and n_dec > 0 and n_pre > 0,
              "the gather path gathered nothing")
    dec_ticks = [t for t in ticks if t["decoded"] and not t["prefilled"]]
    step_ms = sorted(t["seconds"] * 1e3 for t in ticks)
    dec_tok = c["decode_tokens"]
    out = dict(
        requests=len(done), ticks=len(ticks), decode_ticks=n_dec,
        prefill_ticks=n_pre, decode_tokens=dec_tok,
        prefill_tokens=c["prefill_tokens"], wall_s=wall,
        decode_tokens_per_s=dec_tok / wall,
        tokens_per_s=(dec_tok + c["prefill_tokens"]) / wall,
        p50_step_ms=statistics.median(step_ms),
        p50_decode_only_step_ms=(statistics.median(
            t["seconds"] * 1e3 for t in dec_ticks) if dec_ticks else None),
        p50_prefill_step_ms=statistics.median(
            t["seconds"] * 1e3 for t in ticks if t["prefilled"]),
        launches=launches, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        pool_pages=eng.alloc.n_pages, preempted=c["preempted"],
        gate_verify_calls=len(verified),
        gate_geometries={f: sum(g == f for g, *_ in verified)
                         for f in ("paged_attention", "ragged_prefill")},
        gate_calls=[dict(family=f, config=dataclasses.asdict(cf),
                         problem=dataclasses.asdict(pb))
                    for f, cf, pb in verified],
        outputs={r.rid: list(r.output) for r in done})
    log(f"[{tag}] {len(done)} requests, {len(ticks)} ticks ({n_pre} "
        f"prefill, {n_dec} decode), all through the "
        f"{'kernels' if path == 'kernel' else 'gather paths'}; "
        f"{c['prefill_tokens']} prompt + {dec_tok} generated tokens in "
        f"{wall:.2f} s: decode {out['decode_tokens_per_s']:.1f} tok/s, "
        f"p50 step {out['p50_step_ms']:.1f} ms (decode-only ticks "
        f"{out['p50_decode_only_step_ms']:.1f} ms, prefill ticks "
        f"{out['p50_prefill_step_ms']:.1f} ms), launches {launches}, peak "
        f"memory {out['peak_gb']:.2f} GB, preempted {c['preempted']}")
    out["verified"] = verified
    return out


def phase_serve(torch, s=SERVE):
    """``s``'s trace through its engine at full width; ``s`` may cut the
    depth (``n_layers``), name the path every tick must take (``path``,
    default "kernel") and skip the profiled windows (``profile``)."""
    import gc
    from repro_torch import configs
    from repro_torch.models import build
    tag = s["tag"]
    cfg = configs.get_config(s["arch"])
    if s.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=s["n_layers"])
    if s.get("head_dim"):
        cfg = dataclasses.replace(cfg, head_dim=s["head_dim"])
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(s["seed"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pool_pages = _pool_pages(s)
    eng = _serve_engine(model, params, s)
    trace = _serve_trace(cfg, s)
    weights_gb = sum(p.numel() * p.element_size() for k, v in params.items()
                     if k != "embed" for p in _leaves(v)) / 1e9
    embed_gb = sum(p.numel() * 4 for p in _leaves(params["embed"])) / 1e9
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, "
        f"{model.n_params / 1e9:.3f} B params (layers {weights_gb:.2f} GB "
        f"bf16, embedding{'s' if not cfg.tie_embeddings else ''} "
        f"{embed_gb:.2f} GB f32), KV pool {pool_pages} pages = "
        f"{eng.kv.nbytes / 1e9:.2f} GB; init {init_s:.1f} s")
    out = _serve_run(torch, eng, trace, cfg, s, tag,
                     path=s.get("path", "kernel"))
    verified = out.pop("verified")
    check(len(verified) == len(set(verified)),
          "the serving path verified a geometry twice")
    log(f"[{tag}] ARGUS gate: {len(verified)} verify calls, one per "
        f"geometry ({out['gate_geometries']})")
    out.update(arch=cfg.name, n_layers=cfg.n_layers, init_s=init_s,
               weights_gb=weights_gb, embed_gb=embed_gb,
               pool_gb=eng.kv.nbytes / 1e9)
    del eng
    if s.get("profile", True):
        out["profile"] = phase_profile(torch, model, params, pool_pages, s)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _record_gate():
    """Wrap the shared verification engine's ``verify`` so the serve
    phase can count its calls by (family, config, problem); ``del
    engine.verify`` restores it."""
    from repro_torch.core.verify_engine import default_engine
    gate = default_engine()
    calls = []
    real = gate.verify

    def verify(family, cfg, prob, **kw):
        calls.append((family, cfg, prob))
        return real(family, cfg, prob, **kw)
    gate.verify = verify
    return gate, calls


def _profile_window(torch, engine, n_steps):
    """Run ``n_steps`` engine ticks under ``torch.profiler`` (see
    :func:`_profile`)."""
    def run():
        for _ in range(n_steps):
            engine.step()
    out = _profile(torch, run)
    out["ticks"] = n_steps
    return out


def _profile(torch, fn, kinds=None):
    """Run ``fn`` under ``torch.profiler``; returns the window's wall
    time, device time by kernel (largest first) and the device's busy
    share (kernel time over wall time; kernels overlap little on one
    stream, so the share is an upper bound).  ``kinds``: (label,
    predicate on the kernel's name) pairs; each kernel's time is also
    summed under the first label whose predicate holds
    (``by_kind_ms``, "other" for none)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern, launches = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us and "cuda" in str(getattr(e, "device_type", "")).lower():
            kern[e.key] = kern.get(e.key, 0.0) + us / 1e3
            launches += e.count
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:12]
    # the port's own kernels: each a *_kernel in an anonymous namespace
    # of its .cu
    ours = {}
    for k, v in kern.items():
        if k.startswith("void (anonymous namespace)::"):
            name = k.split("::")[1].split("<")[0].split("(")[0]
            if name.endswith("_kernel"):
                ours[name] = ours.get(name, 0.0) + v
    out = dict(wall_ms=wall * 1e3, device_ms=busy,
               device_launches=launches,
               busy_share=(busy / (wall * 1e3)) if kern else None,
               top_kernels_ms=[[k[:90], v] for k, v in top],
               port_kernels_ms=ours)
    if kinds is not None:
        by = {}
        for k, v in kern.items():
            label = next((lab for lab, pred in kinds if pred(k)), "other")
            by[label] = by.get(label, 0.0) + v
        out["by_kind_ms"] = dict(sorted(by.items(), key=lambda kv: -kv[1]))
    return out


def phase_profile(torch, model, params, pool_pages, s=SERVE):
    """Where a tick's time goes at full width: one tick that prefills 8
    prompts of 256 tokens (and decodes their first tokens), then 6
    decode-only ticks of the 8 rows, each window under the profiler."""
    import numpy as np
    from repro_torch.serve import PagedServingEngine, Request
    eng = PagedServingEngine(
        model, params, pool_pages=pool_pages, page_size=s["page_size"],
        max_batch=s["max_batch"], max_len=s["max_len"],
        prefill_chunk=s["prefill_chunk"], eos_id=-1, decode_path="kernel",
        prefill_path="kernel", device="cuda")
    rng = np.random.default_rng(5)
    for rid in range(s["max_batch"]):
        eng.submit(Request(rid, rng.integers(2, model.cfg.vocab,
                                             size=256).tolist(),
                           max_new_tokens=8))
    out = {"prefill_tick": _profile_window(torch, eng, 1),
           "decode_ticks_6": _profile_window(torch, eng, 6)}
    for name, w in out.items():
        share = ("not measured" if w["busy_share"] is None
                 else f"{w['busy_share']:.3f}")
        log(f"[{s['tag']}/profile] {name}: wall {w['wall_ms']:.1f} ms, device "
            f"{w['device_ms']:.1f} ms, busy share {share}, "
            f"{w['device_launches']} device kernels; top: " + "; ".join(
                f"{k[:48]} {v:.2f}" for k, v in w["top_kernels_ms"][:6])
            + "; the port's kernels: " + "; ".join(
                f"{k} {v:.3f}" for k, v in w["port_kernels_ms"].items()))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# -- phase 5 -----------------------------------------------------------------

def _paths_setup(s=SERVE, moe=None):
    """Phase 5's model (float32, depth 2, full width), weights and trace,
    and a maker of its engine on a path."""
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.serve import PagedServingEngine
    from repro_torch.serve.trace import poisson_trace
    cfg = dataclasses.replace(configs.get_config(s["arch"]), n_layers=2,
                              dtype="float32")
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    model = build(cfg)
    params = model.init(1, device="cuda")
    trace = poisson_trace(seed=3, n_requests=6, mean_gap=1.0,
                          prompt_lens=(64, 600), max_new=(4, 8),
                          vocab=cfg.vocab)

    def engine(path, **kw):
        return PagedServingEngine(
            model, params, pool_pages=768, page_size=s["page_size"],
            max_batch=s["max_batch"], max_len=s["max_len"],
            prefill_chunk=s["prefill_chunk"], eos_id=-1, decode_path=path,
            prefill_path=path, device="cuda", **kw)
    return cfg, trace, engine


def phase_paths(torch, s=SERVE, moe=None):
    """Kernel and gather paths in float32 at depth 2, full width:
    identical tokens.  ``moe``: fields of the MoE spec to replace."""
    from repro_torch.serve.trace import replay
    cfg, trace, engine = _paths_setup(s, moe)
    outs, counters = {}, {}
    for path in ("kernel", "gather"):
        eng = engine(path)
        res = replay(eng, trace)
        outs[path] = res["outputs"]
        counters[path] = res["metrics"]["counters"]
    check(outs["kernel"] == outs["gather"],
          "float32 kernel-path tokens differ from the gather path's")
    ck, cg = counters["kernel"], counters["gather"]
    check(ck["gather_bytes"] == 0 and ck["kernel_decode_ticks"] > 0
          and ck["kernel_prefill_ticks"] > 0, "kernel engine counters")
    check(cg["kernel_decode_ticks"] == cg["kernel_prefill_ticks"] == 0,
          "gather engine counters")
    n_tok = sum(len(o) for o in outs["kernel"].values())
    log(f"[{s['tag']}/paths] {cfg.name} float32, 2 layers, full width"
        f"{', capacity factor %g' % cfg.moe.capacity_factor if moe else ''}"
        f": kernel and gather paths give identical tokens ({len(outs['kernel'])} requests, {n_tok} "
        f"tokens)")
    return dict(requests=len(outs["kernel"]), tokens=n_tok)


# -- phase 6 -----------------------------------------------------------------

# Tolerance of the GEMM kernel against its plain version (the same
# products summed in another order, in float32): a float32 output within
# 1e-5 of the largest |output| (the rounding is of partial sums of the
# output's scale); a bfloat16 output within one bfloat16 step of each
# value plus that bound (both round a float32 sum to bfloat16 once).
GEMM_REL = 1e-5
SHORT = {"bfloat16": "bf16", "float32": "f32"}
GEMM_CASES = [
    # (label, m, n, k, cfg fields)
    ("default", 2048, 2048, 2048, {}),
    ("split_k=2", 2048, 2048, 2048, dict(split_k=2)),
    ("split_k=4", 1024, 1024, 4096, dict(split_k=4)),
    ("stagger_k", 2048, 2048, 2048, dict(stagger_k=True)),
    ("tile 512x256", 2048, 2048, 2048, dict(bm=512, bn=256, bk=256)),
    ("bm=8", 512, 2048, 2048, dict(bm=8)),
    ("ragged default", 1000, 777, 1500, {}),
    ("ragged bk=64 stagger", 1000, 777, 1500, dict(bm=64, bn=64, bk=64,
                                                   stagger_k=True)),
    ("ragged 128x256", 1000, 800, 1000, dict(bm=128, bn=256, bk=128)),
    ("production", 8192, 8192, 8192, {}),
]


def gemm_instance(cfg, m, n, k, dtype):
    """The instance the GEMM kernel runs ``cfg`` on (``families/gemm.py``:
    the wgmma design's CTA tile, or the mma.sync / FMA design's)."""
    from repro_torch.core.families.gemm import (GemmProblem, cta_tile,
                                                is_wgmma)
    prob = GemmProblem(m, n, k, SHORT[dtype])
    tm, tn = cta_tile(cfg, prob)
    kind = "wgmma" if is_wgmma(cfg, prob) else (
        "mma.sync" if dtype == "bfloat16" else "fma")
    return f"{kind} {tm}x{tn}"


def gemm_error(torch, got, want):
    """(max abs error, within the stated tolerance)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = GEMM_REL * float(w.abs().max())
    if got.dtype == torch.bfloat16:
        step = torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(2.0 ** -126))) - 7)
        ok = bool((err <= step + bound).all())
    else:
        ok = float(err.max()) <= bound
    return float(err.max()), ok


def phase_gemm_kernel(torch):
    from repro_torch.core.families.gemm import GemmConfig
    from repro_torch.kernels.gemm import default_config, matmul, matmul_ref
    out = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for label, m, n, k, fields in GEMM_CASES:
            if label.startswith("production") and dtype == "float32":
                continue                  # the production problem is bf16
            g = torch.Generator(device="cuda").manual_seed(m + n + k)
            a = torch.randn(m, k, generator=g, device="cuda").to(dt)
            b = torch.randn(k, n, generator=g, device="cuda").to(dt)
            cfg = GemmConfig(**fields) if fields else None
            inst = gemm_instance(cfg or default_config(m, n, k), m, n, k,
                                 dtype)
            got = matmul(a, b, cfg=cfg)
            torch.cuda.synchronize()
            want = matmul_ref(a, b)
            torch.cuda.synchronize()
            err, ok = gemm_error(torch, got, want)
            check(ok, f"gemm {dtype} {label} {m}x{n}x{k}: max |kernel - "
                      f"plain| {err} beyond the stated tolerance")
            check(bool(torch.isfinite(got).all()), f"gemm {label}: "
                  "non-finite output")
            out.append(dict(label=label, dtype=dtype, m=m, n=n, k=k,
                            cfg=fields, instance=inst, max_abs_err=err,
                            max_abs_out=float(want.float().abs().max())))
            del a, b, got, want
    torch.cuda.empty_cache()
    log(f"[gemm] kernel against its plain version: {len(out)} cases "
        f"(bf16 and f32; default, split_k 2/4, stagger_k, tile 512x256, "
        f"bm=8, ragged 1000x777x1500 and 1000x800x1000, 8192^3 bf16), all "
        f"within the stated tolerance; instance and max abs err " +
        ", ".join(f"{SHORT[c['dtype']]}/{c['label']} [{c['instance']}] "
                  f"{c['max_abs_err']:.3g}" for c in out))
    return out


def _loop(prob, validator):
    from repro_torch.core.families.gemm import GemmConfig
    from repro_torch.core.harness import (KernelState, Planner, Selector,
                                          optimize_kernel)
    state = KernelState("gemm", GemmConfig(), prob).refresh()
    return optimize_kernel(state, planner=Planner(),
                           selector=Selector(temperature=0.15, seed=0),
                           validator=validator, iterations=24)


def phase_gemm_loop(torch):
    """The paper's workflow at the family's production size: the agent
    loop, whose validator runs the CUDA kernel for every candidate that
    passes the gate.  Only this loop runs between the counters' reset
    and their reading."""
    from repro_torch.core.families.gemm import GemmProblem
    from repro_torch.core.harness import Validator
    from repro_torch.kernels import ALL_KERNELS
    prob = GemmProblem(8192, 8192, 8192, "bf16")
    validator = Validator(run_kernels=True)
    for k in ALL_KERNELS:                      # count the main path only
        k.launches = 0
    t0 = time.perf_counter()
    res = _loop(prob, validator)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ALL_KERNELS}
    runs = validator.reference_runs
    check(runs > 0, "the loop ran no unit test on the card")
    check(launches["gemm"] == runs, f"gemm launched {launches['gemm']} "
          f"times for {runs} unit tests")
    check(launches["paged_decode"] == launches["ragged_prefill"] == 0,
          "the loop launched a serving kernel")
    check(res.speedup > 1.0, f"the loop found no faster config "
          f"(speedup {res.speedup})")
    history = [dict(skill=r.skill, context=r.context, accepted=r.accepted,
                    ok=r.verdict.ok, caught_stage=r.verdict.caught_stage,
                    est_ms=r.time_s * 1e3) for r in res.history]
    best = dataclasses.asdict(res.best_state.cfg)
    log(f"[gemm] optimize_kernel 8192^3 bf16, 24 steps in {wall:.2f} s: "
        f"{runs} unit tests on the card ({validator.reference_refusals} "
        f"refused by a precondition), gemm launches {launches['gemm']}; "
        f"best {res.best_state.cfg.name()}, modelled speedup "
        f"{res.speedup:.3f}; verify stats {res.verify_stats}")
    mark = lambda h: "+" if h["accepted"] else (
        "" if h["ok"] else " x" + h["caught_stage"])
    log("[gemm] steps (+ accepted, x rejected at a stage): " + "; ".join(
        f"{h['skill']}[{h['context']}]{mark(h)}" for h in history))
    return dict(launches=launches, unit_tests=runs,
                refusals=validator.reference_refusals, wall_s=wall,
                speedup_model=res.speedup, best_cfg=best,
                best_name=res.best_state.cfg.name(), history=history,
                verify_stats=res.verify_stats), res.best_state.cfg


def phase_gemm_time(torch, best_cfg):
    """Baseline and best config at the production problem and the two
    sweep problems, each held to the plain version at the stated
    tolerance, beside the bound, the plain version, one bf16
    ``torch.matmul`` and the cost model's estimate (a model, not a
    measurement)."""
    from repro_torch.core.families import get_family
    from repro_torch.core.families.gemm import GemmConfig, gemm_cost
    from repro_torch.core.verify_engine import default_engine
    from repro_torch.kernels.gemm import matmul, matmul_ref
    fam = get_family("gemm")
    rows = []
    for prob in fam.sweep_problems():
        m, n, k = prob.m, prob.n, prob.k
        g = torch.Generator(device="cuda").manual_seed(m ^ n ^ k)
        a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        b = torch.randn(k, n, generator=g, device="cuda").bfloat16()
        plain = time_ms(torch, lambda: matmul_ref(a, b), iters=10)
        want = matmul_ref(a, b)
        lib = time_ms(torch, lambda: torch.matmul(a, b))
        bms, by = bound_ms((m * k + k * n + m * n) * 2, 2.0 * m * n * k,
                           "bfloat16")
        for which, cfg in (("baseline", GemmConfig()), ("best", best_cfg)):
            if not default_engine().verify("gemm", cfg, prob).hard_ok:
                rows.append(dict(problem=[m, n, k], config=which,
                                 cfg=cfg.name(), rejected=True))
                continue
            inst = gemm_instance(cfg, m, n, k, "bfloat16")
            got = matmul(a, b, cfg=cfg)
            torch.cuda.synchronize()
            err, ok = gemm_error(torch, got, want)
            check(ok, f"gemm {which} {cfg.name()} {m}x{n}x{k} bf16: max "
                      f"|kernel - plain| {err} beyond the stated tolerance")
            del got
            ms = time_ms(torch, lambda: matmul(a, b, cfg=cfg))
            est = gemm_cost(cfg, prob).time_s * 1e3
            rows.append(dict(problem=[m, n, k], config=which,
                             cfg=cfg.name(), instance=inst, ms=ms,
                             max_abs_err=err, bound_ms=bms,
                             bound_by=by, plain_ms=plain, library_ms=lib,
                             model_ms=est, model_over_measured=est / ms,
                             tflops=2.0 * m * n * k / ms / 1e9))
            log(f"[gemm] {m}x{n}x{k} bf16 {which} {cfg.name()} [{inst}]: "
                f"max abs err {err:.3g}, "
                f"{ms:.4f} ms ({rows[-1]['tflops']:.1f} TFLOP/s), "
                f"bound {bms:.4f} ms ({by}), plain {plain:.4f} ms, "
                f"torch.matmul {lib:.4f} ms; cost model (H100 model, not "
                f"measured) {est:.4f} ms = {est / ms:.3f} x measured")
        del a, b, want
        torch.cuda.empty_cache()
    return rows


def phase_gemm_refuse(torch):
    from repro_torch.core.families.gemm import GemmConfig
    from repro_torch.kernels.gemm import KERNEL, InvariantViolation, matmul
    a = torch.randn(128, 384, device="cuda")
    b = torch.randn(384, 128, device="cuda")
    before = KERNEL.launches
    try:
        matmul(a, b, cfg=GemmConfig(split_k=5))
    except InvariantViolation as e:
        torch.cuda.synchronize()
        check(KERNEL.launches == before, "an invalid config launched")
        first = str(e).splitlines()
        log(f"[gemm] split_k=5 on 3 K blocks: InvariantViolation before any "
            f"launch ({first[0]} / {first[1].strip()})")
        return str(e)
    raise SmokeFailure("an invalid gemm config was not refused")


def phase_gemm(torch):
    out = {"kernel": phase_gemm_kernel(torch)}
    out["loop"], best = phase_gemm_loop(torch)
    out["time"] = phase_gemm_time(torch, best)
    out["refused"] = phase_gemm_refuse(torch)
    return out


# -- phase 7 -----------------------------------------------------------------

FA_CASES = [
    # (label, B, Hq, Hkv, Sq, Skv, D, causal, cfg fields or None)
    ("default", 2, 8, 1, 1024, 1024, 128, True, None),
    ("example bq=8 no skip", 1, 8, 1, 512, 512, 128, True,
     dict(block_q=8, causal_block_skip=False)),
    ("1000x1500 G=2", 1, 4, 2, 1000, 1500, 64, True,
     dict(block_q=64, block_kv=128)),
    ("1000x1500 non-causal", 1, 4, 2, 1000, 1500, 128, False,
     dict(block_q=128, block_kv=64)),
    ("G=1 transv", 2, 4, 4, 333, 333, 64, True,
     dict(block_q=16, block_kv=256, v_transposed_staging=True)),
    ("G=8 skip off", 1, 8, 1, 700, 500, 128, True,
     dict(block_q=256, block_kv=16, causal_block_skip=False)),
    ("non-causal transv", 1, 8, 1, 300, 900, 64, False,
     dict(block_q=64, block_kv=64, v_transposed_staging=True)),
    # the wgmma instances (128- and 64-row CTAs) at D 64 and 128, ragged
    # against the 128-key tile, Skv < Sq, a key edge inside the first tile
    ("wgmma bq=128 D=128", 2, 8, 1, 1024, 1024, 128, True,
     dict(block_q=128)),
    ("wgmma bq=64 D=64", 2, 8, 2, 1024, 1024, 64, True, dict(block_q=64)),
    ("wgmma bq=128 D=64 non-causal", 1, 8, 1, 640, 896, 64, False,
     dict(block_q=128)),
    ("wgmma bq=64 D=128 non-causal", 1, 4, 1, 500, 700, 128, False,
     dict(block_q=64)),
    ("wgmma 1000x1500 bq=128", 1, 8, 2, 1000, 1500, 128, True,
     dict(block_q=128)),
    ("wgmma Skv<Sq bq=128", 1, 8, 1, 1000, 333, 128, True,
     dict(block_q=128)),
    ("wgmma Skv=77 bq=128", 1, 2, 1, 300, 77, 64, True, dict(block_q=128)),
] + [(f"bq={bq} bkv={bkv}", 1, 4, 2, 300, 400, 64, True,
      dict(block_q=bq, block_kv=bkv))
     for bq in (16, 64, 128, 256) for bkv in (16, 64, 128, 256)]
DEC_CASES = [
    # (label, B, Hq, Hkv, S, kv_len, D, kv_splits): a tile is 64 positions
    # at D = 128 and 128 at D = 64 in bf16
    ("splits=1", 4, 8, 1, 2048, 2048, 128, 1),
    ("splits=2 G=1", 4, 4, 4, 2048, 1500, 64, 2),
    ("splits=8 kv_len<S", 8, 8, 1, 4096, 3001, 128, 8),
    ("splits=16 short", 2, 8, 1, 4096, 100, 128, 16),
    ("splits=8 G=1", 2, 2, 2, 1024, 1000, 128, 8),
    ("default splits", 2, 8, 1, 8192, 5000, 64, None),
    ("G=2", 4, 8, 4, 2048, 1999, 128, 4),
    ("G=4 D=64", 4, 8, 2, 2048, 2000, 64, 8),
    ("kv_len=0", 2, 8, 1, 1024, 0, 128, 4),
    ("span < tile", 2, 8, 1, 1024, 1000, 128, 32),
    ("span < tile D=64", 2, 8, 1, 1024, 1024, 64, 16),
]


def _fa_inputs(torch, B, Hq, Hkv, Sq, Skv, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    return (torch.randn(B, Hq, Sq, D, generator=g, device="cuda").to(dt),
            torch.randn(B, Hkv, Skv, D, generator=g, device="cuda").to(dt),
            torch.randn(B, Hkv, Skv, D, generator=g, device="cuda").to(dt))


def _rowwise(fn, q, k, v, heads=False):
    """The plain version one batch row (and one head) at a time: its
    materialised (Hq, Sq, Skv) float32 scores for a whole batch would
    not fit the card at the production problems."""
    import torch
    out = torch.empty_like(q)
    G = q.shape[1] // k.shape[1]
    for b in range(q.shape[0]):
        if not heads:
            out[b:b + 1] = fn(q[b:b + 1], k[b:b + 1], v[b:b + 1])
            continue
        for h in range(q.shape[1]):
            hk = h // G
            out[b:b + 1, h:h + 1] = fn(q[b:b + 1, h:h + 1],
                                       k[b:b + 1, hk:hk + 1],
                                       v[b:b + 1, hk:hk + 1])
    return out


def _causal_pairs(Sq, Skv, causal):
    if not causal:
        return Sq * Skv
    n = min(Sq, Skv)
    return n * (n + 1) // 2 + max(Sq - Skv, 0) * Skv


def phase_flash_kernels(torch):
    from repro_torch.core.families.flash_attention import \
        FlashAttentionConfig
    from repro_torch.core.families.flash_decode import FlashDecodeConfig
    from repro_torch.kernels.flash_attention import (DECODE_KERNEL, KERNEL,
                                                     flash_error, mha,
                                                     mha_decode, mha_ref)
    out = []
    for dtype in ("bfloat16", "float32"):
        for i, (label, B, Hq, Hkv, Sq, Skv, D, causal, f) in \
                enumerate(FA_CASES):
            q, k, v = _fa_inputs(torch, B, Hq, Hkv, Sq, Skv, D, dtype, i)
            cfg = FlashAttentionConfig(**f) if f else None
            n0 = KERNEL.launches
            got = mha(q, k, v, cfg=cfg, causal=causal)
            torch.cuda.synchronize()
            check(KERNEL.launches == n0 + 1, f"flash {label}: no launch")
            want = mha_ref(q, k, v, causal=causal)
            err, row, ok = flash_error(got, want)
            check(ok, f"flash_attention {dtype} {label}: max |kernel - "
                  f"plain| {err}, worst row {row}: beyond the tolerance")
            out.append(dict(kernel="flash_attention", label=label,
                            dtype=dtype, max_abs_err=err, row_err=row))
        for i, (label, B, Hq, Hkv, S, kv_len, D, ns) in enumerate(DEC_CASES):
            q, k, v = _fa_inputs(torch, B, Hq, Hkv, 1, S, D, dtype, 50 + i)
            kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
            cfg = FlashDecodeConfig(ns) if ns else None
            n0 = DECODE_KERNEL.launches
            got = mha_decode(q, k, v, kl, cfg=cfg)
            torch.cuda.synchronize()
            check(DECODE_KERNEL.launches == n0 + 1, f"decode {label}: no "
                  "launch")
            # at kv_len 0 every span has l = 0 and the kernel writes
            # zeros, as the TPU kernel does (mha_ref would average V)
            want = (torch.zeros_like(q) if kv_len == 0 else
                    mha_ref(q, k, v, causal=False, kv_len=kv_len))
            err, row, ok = flash_error(got, want)
            check(ok, f"flash_decode {dtype} {label}: max |kernel - "
                  f"plain| {err}, worst row {row}: beyond the tolerance")
            out.append(dict(kernel="flash_decode", label=label, dtype=dtype,
                            max_abs_err=err, row_err=row))
    # each production problem is checked in phase 7c, at the configs
    # timed there
    worst = {}
    for c in out:
        key = (c["kernel"], c["dtype"])
        e, r = worst.get(key, (0.0, 0.0))
        worst[key] = (max(e, c["max_abs_err"]), max(r, c["row_err"]))
    log(f"[flash] kernels against their plain versions: {len(out)} cases "
        f"(bf16 and f32; default, example bq=8, bq x bkv 16..256, causal "
        f"and not, skip and transv on/off, G 1/2/4/8, D 64/128, 1000x1500, "
        f"Skv < Sq, the wgmma tiles 128 and 64; decode kv_splits 1..32, "
        f"kv_len < S and 0, spans shorter than a tile), all within "
        f"f32 1e-4, rows 1e-3; bf16 1e-2 + 2^-7 |o|, rows 2^-6; worst "
        f"(max abs, row) " + ", ".join(
            f"{n}/{SHORT[d]} {e:.3g} {r:.3g}" for (n, d), (e, r)
            in worst.items()))
    return dict(cases=out)


def phase_loop(torch, family):
    """The paper's loop on one family at its production problem:
    ``Validator(run_kernels=True)``, the selector and steps of phase
    6c.  Only this loop runs between the counters' reset and their
    reading; every unit test must have launched the family's kernel."""
    from repro_torch.core.families import get_family
    from repro_torch.core.harness import (KernelState, Planner, Selector,
                                          Validator, optimize_kernel)
    from repro_torch.kernels import ALL_KERNELS
    fam = get_family(family)
    kernel = fam.kernel
    cfg, prob = fam.example()
    validator = Validator(run_kernels=True)
    state = KernelState(family, cfg, prob).refresh()
    for k in ALL_KERNELS:                      # count the main path only
        k.launches = 0
    t0 = time.perf_counter()
    res = optimize_kernel(state, planner=Planner(),
                          selector=Selector(temperature=0.15, seed=0),
                          validator=validator, iterations=24)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ALL_KERNELS}
    runs = validator.reference_runs
    check(runs > 0, f"the {family} loop ran no unit test on the card")
    check(launches[kernel] == runs, f"{kernel} launched "
          f"{launches[kernel]} times for {runs} unit tests")
    check(all(n == 0 for name, n in launches.items() if name != kernel),
          f"the {family} loop launched another kernel: {launches}")
    history = [dict(skill=r.skill, context=r.context, accepted=r.accepted,
                    ok=r.verdict.ok, caught_stage=r.verdict.caught_stage,
                    est_ms=r.time_s * 1e3) for r in res.history]
    log(f"[{family}] optimize_kernel {prob}, 24 steps in {wall:.2f} s: "
        f"{runs} unit tests on the card ({validator.reference_refusals} "
        f"refused by a precondition), {kernel} launches "
        f"{launches[kernel]}; best {res.best_state.cfg.name()}, modelled "
        f"speedup {res.speedup:.3f}; verify stats {res.verify_stats}")
    return dict(launches=launches, unit_tests=runs,
                refusals=validator.reference_refusals, wall_s=wall,
                speedup_model=res.speedup,
                best_cfg=dataclasses.asdict(res.best_state.cfg),
                best_name=res.best_state.cfg.name(), history=history,
                verify_stats=res.verify_stats), res.best_state.cfg


def phase_flash_time(torch, family, best_cfg):
    """The family example's config and the loop's best at the production
    problem and both sweep problems, each held to the plain version and
    then timed beside the bound, the plain version (row by row), one
    ``scaled_dot_product_attention`` call and the cost model's estimate
    (a model, not a measurement)."""
    from repro_torch.core.families import get_family
    from repro_torch.core.verify_engine import default_engine
    from repro_torch.kernels.flash_attention import (flash_error, mha,
                                                     mha_decode, mha_ref)
    fam = get_family(family)
    cfg0 = fam.example()[0]
    rows = []
    for prob in fam.sweep_problems():
        p = prob
        sq = getattr(p, "seq_q", 1)
        q, k, v = _fa_inputs(torch, p.batch, p.q_heads, p.kv_heads, sq,
                             p.seq_kv, p.head_dim, "bfloat16", 7)
        elt = 2
        if family == "flash_attention":
            causal = p.causal
            pairs = _causal_pairs(sq, p.seq_kv, causal)
            flops = 4.0 * p.batch * p.q_heads * pairs * p.head_dim
            heads = p.seq_kv > 8192
            plain_fn = lambda: _rowwise(
                lambda a, b, c: mha_ref(a, b, c, causal=causal), q, k, v,
                heads=heads)
            plain = time_ms(torch, plain_fn, iters=3, warmup=1)
            run = lambda c: (lambda: mha(q, k, v, cfg=c, causal=causal))
        else:
            heads, causal = False, False
            flops = 4.0 * p.batch * p.q_heads * p.seq_kv * p.head_dim
            plain_fn = lambda: mha_ref(q, k, v, causal=False)
            plain = time_ms(torch, plain_fn, iters=5, warmup=1)
            kl = torch.tensor(p.seq_kv, dtype=torch.int32, device="cuda")
            run = lambda c: (lambda: mha_decode(q, k, v, kl, cfg=c))
        lib = _sdpa_ms(torch, q, k, v, causal)
        want = plain_fn()
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * elt
        bms, by = bound_ms(n_bytes, flops, "bfloat16")
        for which, cfg in (("example", cfg0), ("best", best_cfg)):
            if not default_engine().verify(family, cfg, prob).hard_ok:
                rows.append(dict(problem=dataclasses.astuple(prob),
                                 config=which, cfg=cfg.name(),
                                 rejected=True))
                continue
            err, row, ok = flash_error(run(cfg)(), want)
            check(ok, f"{family} {dataclasses.astuple(prob)[:6]} "
                  f"{cfg.name()}: max |kernel - plain| {err}, worst row "
                  f"{row}: beyond the tolerance")
            slow = family == "flash_attention" and cfg.block_q < 16
            ms = time_ms(torch, run(cfg), iters=3 if slow else 10,
                         warmup=1 if slow else 3)
            parts = ""
            if family == "flash_decode":
                k_ms, c_ms = decode_parts_ms(
                    torch, run(cfg), kv_bytes=(k.numel() + v.numel()) * elt)
                parts = (f" (device: split kernel {_ms_or(k_ms)}, combine "
                         f"{_ms_or(c_ms)}; the rest host time)")
            est = fam.cost(cfg, prob).time_s * 1e3
            rows.append(dict(problem=dataclasses.astuple(prob),
                             config=which, cfg=cfg.name(), ms=ms,
                             bound_ms=bms, bound_by=by, plain_ms=plain,
                             plain_by="row" if not heads else "head",
                             library_ms=lib, max_abs_err=err,
                             row_err=row, model_ms=est,
                             model_over_measured=est / ms,
                             tflops=flops / ms / 1e9,
                             gbps=n_bytes / ms / 1e6))
            if family == "flash_decode":
                rows[-1].update(kernel_ms=k_ms, combine_ms=c_ms)
            log(f"[flash] {family} {dataclasses.astuple(prob)[:6]} {which} "
                f"{cfg.name()}: {ms:.4f} ms{parts} ("
                f"{rows[-1]['tflops']:.1f} "
                f"TFLOP/s, {rows[-1]['gbps']:.0f} GB/s), bound {bms:.4f} ms "
                f"({by}), plain {plain:.4f} ms ("
                f"{'one head' if heads else 'one batch row'} at a time), "
                f"sdpa {lib:.4f} ms; cost model (H100 model, not measured) "
                f"{est:.4f} ms = {est / ms:.3f} x measured; against the "
                f"plain version max abs {err:.3g}, worst row {row:.3g}")
        del q, k, v, want
        torch.cuda.empty_cache()
    return rows


# the kernel of the L2 flush before each call of a flushed profiled window
# (a fill of bytes, which no kernel under test launches)
FLUSH_KERNEL = "FillFunctor<unsigned char>"
# a decode split read faster than HBM's peak by more than this share, with
# the L2 flushed before each call, was mismeasured
SPLIT_NOISE = 0.1


# each window device_parts_ms took: each kernel's launches recorded, the
# profiler's time a call over the same calls' time between CUDA events
# (``clock``, flushed windows), and whether it was kept (the summary's
# ``profiler_windows``)
PROFILER_WINDOWS = []
# the bounds on ``clock`` a flushed window is read within: the CUDA
# events also hold a few microseconds of launch gaps a call; a window
# misread like the one in the docstring below comes to 0.6 or less
CLOCK_BOUNDS = (0.75, 1.15)
# cycles of ``torch.cuda._sleep`` (about 20 ms on an H100) that hold
# the stream while the host enqueues the calls timed behind it
SPIN_CYCLES = 40_000_000


def device_events(prof):
    """(name, start, end) in microseconds of each device event in a
    ``torch.profiler`` window."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if "cuda" in str(getattr(e, "device_type", "")).lower()]


def device_parts_ms(torch, call, part_of, n=20, per_launch=False,
                    flush=False):
    """Device time per call of ``call``, from ``torch.profiler`` over
    ``n`` calls, summed by ``part_of(kernel name)`` (a part's name, or
    None to leave the kernel out).  With ``per_launch`` (each kernel
    launched once a call) a part's time is the sum over its kernels of
    each one's median launch among the last n recorded, else their total
    over the calls.  With ``flush`` the L2 is flushed before each call,
    as ``time_ms`` does (the flush's kernel left out); else nothing is
    flushed between the calls.

    The window runs n + 1 calls: the profiler drops device events, the
    first call's first kernels in most windows and, late in a long
    process, most of a window's (PERF.md §6), so a median is read
    over the launches it kept.  A window where a kernel launched once a
    call has more launches than calls is taken again (at most three
    windows).  A flushed window (the decode splits) is also held to the
    card's own clock: the same n calls, queued behind a spin kernel so
    no host time falls between them, are timed between CUDA events, and
    the profiler's flush and parts a call must come to within
    ``CLOCK_BOUNDS`` of that (an H100 run read a decode split at 0.0269
    ms in a window of whole counts, faster than HBM allows)."""
    from torch.profiler import ProfilerActivity, profile
    buf = (torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
           if flush else None)
    call()
    torch.cuda.synchronize()
    ref = None
    if flush:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        t0.record()
        for _ in range(n):
            buf.zero_()
            call()
        t1.record()
        torch.cuda.synchronize()
        ref = t0.elapsed_time(t1) / n
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n + 1):
                if flush:
                    buf.zero_()
                call()
            torch.cuda.synchronize()
        by_name = {}
        for name, s0, s1 in sorted(device_events(prof),
                                   key=lambda e: e[1]):
            by_name.setdefault(name, []).append(s1 - s0)
        parts, counts, flushes = {}, {}, []
        for name, durs in by_name.items():
            if flush and FLUSH_KERNEL in name:
                flushes = durs[-n:]
                counts["flush"] = len(durs)
                continue
            part = part_of(name)
            if part is None:
                continue
            counts[name[:60]] = len(durs)
            parts[part] = parts.get(part, 0.0) + (
                statistics.median(durs[-n:]) if per_launch
                else sum(durs) / (n + 1)) / 1e3
        over = per_launch and any(c > n + 1 for c in counts.values())
        clock = None
        if flush and flushes and parts:
            clock = (statistics.median(flushes) / 1e3
                     + sum(parts.values())) / ref
        kept = (bool(parts) and not over and (
            not flush or CLOCK_BOUNDS[0] <= (clock or 0) <= CLOCK_BOUNDS[1]))
        PROFILER_WINDOWS.append(dict(n=n, counts=counts, clock=clock,
                                     kept=kept))
        if kept:
            return parts
        log(f"[profiler] a window taken again: {n + 1} calls, kernels "
            f"recorded {counts}, parts {parts} ms"
            + (f", {clock:.3f} of the {ref:.4f} ms a call between CUDA "
               f"events" if clock else ""))
    log("[profiler] three windows failed their checks: the breakdown by "
        "kernel is not measured")
    return {}


def decode_parts_ms(torch, call, n=20, kv_bytes=None):
    """Device time per call of a split decode (``mha_decode`` or
    ``paged_decode``, ``call``), the L2 flushed before each call: the
    split kernel (the kernel whose name holds ``decode_``) and the merge
    of the spans' partials (every other kernel: the combine kernel, or
    the tensor ops that an older wrapper ran after its kernel), each
    kernel's median launch (each launches once a call; the window's
    checks are ``device_parts_ms``'s).  With
    ``kv_bytes`` (the K and V bytes the split must read) a split faster
    than HBM's peak allows for them, beyond ``SPLIT_NOISE``, fails the
    run.  (None, None) where the profiler recorded no device event."""
    parts = device_parts_ms(
        torch, call, lambda k: "split" if "decode_" in k else "merge", n,
        per_launch=True, flush=True)
    if not parts:
        return None, None
    check(parts.get("split", 0.0) > 0,
          "the profiler saw no decode kernel on the card")
    if kv_bytes:
        floor = kv_bytes / HBM_BYTES_PER_S * 1e3
        check(parts["split"] >= (1 - SPLIT_NOISE) * floor,
              f"a decode split read {kv_bytes} bytes in "
              f"{parts['split']:.4f} ms, faster than HBM's peak allows "
              f"({floor:.4f} ms) with the L2 flushed: mismeasured")
    return parts["split"], parts.get("merge", 0.0)


def _sdpa_ms(torch, q, k, v, causal):
    """One ``scaled_dot_product_attention(..., is_causal, enable_gqa)``
    call, the library yardstick, with PyTorch's fused backends only (its
    math backend would materialise the scores)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    with sdpa_kernel(fused):
        return time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), iters=10)


def phase_flash(torch):
    out = {"kernels": phase_flash_kernels(torch)}
    for family in ("flash_attention", "flash_decode"):
        loop, best = phase_loop(torch, family)
        out[family] = dict(loop=loop,
                           time=phase_flash_time(torch, family, best))
    return out


# -- phase 8 -----------------------------------------------------------------

MOE_CASES = [
    # (label, E, C, DM, DF, cfg fields (None: the default config), gates)
    ("default", 8, 512, 1024, 1024, None, True),
    ("example bt=8", 4, 256, 1024, 2048, dict(block_t=8), True),
    ("bt=16 bf=64", 4, 256, 512, 512, dict(block_t=16, block_f=64), True),
    ("bt=32 bf=128 unfused", 4, 256, 512, 512,
     dict(block_t=32, block_f=128, fuse_gate=False), True),
    ("bt=128 bf=256 gates None", 4, 512, 1024, 1024,
     dict(block_t=128, block_f=256), False),
    ("bt=256 bf=2048", 2, 512, 512, 2048, dict(block_t=256, block_f=2048),
     True),
    ("E=1", 1, 256, 512, 512, dict(block_t=64, block_f=128), True),
    ("d_model 1536 (granite)", 40, 128, 1536, 512, None, True),
    ("d_model 96 bf=8", 2, 64, 96, 64, dict(block_t=8, block_f=8), True),
    # the wgmma instance's 64- and 128-row CTAs (bf16; f32 runs these
    # configs on FMAs), gates None and fuse off, 192 rows an expert (the
    # last 128-row block half past the edge at bt 64)
    ("wgmma bt=64 bf=128 gates None", 4, 192, 512, 512,
     dict(block_t=64, block_f=128), False),
    ("wgmma bt=128 bf=256 unfused", 4, 256, 1024, 512,
     dict(block_t=128, block_f=256, fuse_gate=False), True),
    # rows off the 16-byte grain, staged element by element: d_model 100,
    # d_ff 60 and block_f 20 (off in bf16; d_model on it in f32), d_model
    # 50 (off in both)
    ("off grain dm100 df60 bf20", 4, 64, 100, 60,
     dict(block_t=16, block_f=20), True),
    ("off grain dm50", 4, 64, 50, 64, dict(block_t=8, block_f=32), True),
]
# the off-grain rows timed at a granite-sized expert batch (phase 8)
MOE_OFF_GRAIN = [("bfloat16", 100, 60, dict(block_t=64, block_f=20)),
                 ("float32", 50, 64, dict(block_t=64, block_f=32))]


def moe_instance(cfg, x, wg):
    """The instance ``grouped_ffn`` runs ``cfg`` on for these tensors
    (rows off the 16-byte grain: its element copies)."""
    from repro_torch.core.families.moe import is_wgmma
    from repro_torch.kernels.moe.moe import instance_problem
    if is_wgmma(cfg, instance_problem(x, wg)):
        return "wgmma"
    vec = 16 // x.element_size()
    narrow = (x.shape[-1] % vec or wg.shape[-1] % vec
              or cfg.block_f % vec)
    kind = "mma.sync" if x.element_size() == 2 else "fma"
    return f"{kind} element copies" if narrow else kind


def _moe_inputs(torch, E, C, DM, DF, dtype, seed):
    """x ~ N(0, 1) with two empty capacity rows an expert (1 and C-1),
    weights scaled by 1/sqrt(fan-in) (outputs of order one), gates in
    [0.2, 1), all made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    x = torch.randn(E, C, DM, generator=g, device="cuda").to(dt)
    x[:, 1] = 0
    x[:, -1] = 0
    ws = [(torch.randn(*sh, generator=g, device="cuda") * sh[1] ** -0.5
           ).to(dt) for sh in ((E, DM, DF), (E, DM, DF), (E, DF, DM))]
    gates = torch.rand(E, C, 1, generator=g, device="cuda") * 0.8 + 0.2
    return x, ws, gates


def _by_expert(fn, x, ws, gates):
    """The plain version one expert at a time: its float32 copies of a
    whole problem's activations and weights would take tens of GB."""
    out = x.new_empty(x.shape)
    for e in range(x.shape[0]):
        out[e:e + 1] = fn(x[e:e + 1], *(w[e:e + 1] for w in ws),
                          None if gates is None else gates[e:e + 1])
    return out


def _moe_bound(E, C, DM, DF, elt, gated):
    """x, the three weight sets, y and the gates cross memory once; the
    products of every capacity row (what the kernel computes)."""
    n_bytes = (2 * E * C * DM + 3 * E * DM * DF) * elt + \
        (4 * E * C if gated else 0)
    return n_bytes, 6.0 * E * C * DM * DF


def _bmm_yardstick(torch, x, ws, gates):
    """Three cuBLAS ``torch.bmm`` calls plus the elementwise SwiGLU and
    gate, in x's dtype: a yardstick of speed, not one call, and never
    called by the port."""
    import torch.nn.functional as F
    wg, wu, wd = ws

    def run():
        act = F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)
        y = torch.bmm(act, wd)
        return y * gates.to(y.dtype)
    return run


def phase_moe_kernels(torch):
    from repro_torch.core.families.moe import MoEConfig
    from repro_torch.kernels.moe import (KERNEL, default_config,
                                         grouped_ffn, grouped_ffn_ref,
                                         moe_error)
    out = []
    for dtype in ("bfloat16", "float32"):
        for i, (label, E, C, DM, DF, f, gated) in enumerate(MOE_CASES):
            x, ws, gates = _moe_inputs(torch, E, C, DM, DF, dtype, i)
            gates = gates if gated else None
            cfg = MoEConfig(**f) if f else default_config(DM, DF)
            n0 = KERNEL.launches
            got = grouped_ffn(x, *ws, gates, cfg=cfg)
            torch.cuda.synchronize()
            check(KERNEL.launches == n0 + 1, f"grouped_ffn {label}: no "
                  "launch")
            want = grouped_ffn_ref(x, *ws, gates if cfg.fuse_gate else None)
            err, ok = moe_error(got, want)
            check(ok, f"grouped_ffn {dtype} {label}: max |kernel - plain| "
                  f"{err} beyond the tolerance")
            check(not got[:, 1].any() and not got[:, -1].any(),
                  f"grouped_ffn {dtype} {label}: an empty row gave "
                  "non-zeros")
            out.append(dict(label=label, dtype=dtype, cfg=cfg.name(),
                            instance=moe_instance(cfg, x, ws[0]),
                            max_abs_err=err,
                            max_abs_out=float(want.float().abs().max())))
    out.append(_moe_production_check(torch))
    check(any(c["instance"] == "wgmma" for c in out),
          "grouped_ffn: no case ran on the wgmma instance")
    check(sum("element copies" in c["instance"] for c in out) >= 3,
          "grouped_ffn: the off-grain cases did not take element copies")
    log(f"[moe] grouped_ffn against its plain version: {len(out)} cases "
        f"(bf16 and f32; default, example bt=8, bt 16..256, bf 8..2048, "
        f"fuse_gate off, gates None, E=1, d_model 1536 and 96, empty rows; "
        f"the production problem in bf16), all within the tolerance "
        f"beside moe_error; max abs err " + ", ".join(
            f"{SHORT[c['dtype']]}/{c['label']} ({c['instance']}) "
            f"{c['max_abs_err']:.3g}" for c in out))
    return out


def _moe_off_grain_times(torch):
    """grouped_ffn at rows off the 16-byte grain (MOE_OFF_GRAIN: bf16
    d_model 100, d_ff 60, block_f 20; float32 d_model 50) over 40 experts
    x 256 capacity rows (granite-moe's expert count), each held to its
    plain version and timed (CUDA events, L2 flushed) beside its bound,
    the plain version and the three-bmm yardstick; no single PyTorch call
    computes the function (library none)."""
    from repro_torch.core.families.moe import MoEConfig
    from repro_torch.kernels.moe import (KERNEL, grouped_ffn,
                                         grouped_ffn_ref, moe_error)
    out = []
    E, C = 40, 256
    for dtype, DM, DF, f in MOE_OFF_GRAIN:
        x, ws, gates = _moe_inputs(torch, E, C, DM, DF, dtype, DM)
        cfg = MoEConfig(**f)
        call = lambda: grouped_ffn(x, *ws, gates, cfg=cfg)
        n0 = KERNEL.launches
        got = call()
        torch.cuda.synchronize()
        check(KERNEL.launches == n0 + 1, f"grouped_ffn off grain {DM}: "
              "no launch")
        want = grouped_ffn_ref(x, *ws, gates)
        err, ok = moe_error(got, want)
        check(ok, f"grouped_ffn {dtype} off grain d_model {DM}: max |kernel"
              f" - plain| {err} beyond the tolerance")
        ms = time_ms(torch, call)
        plain = time_ms(torch, lambda: grouped_ffn_ref(x, *ws, gates),
                        iters=5, warmup=1)
        yard = time_ms(torch, _bmm_yardstick(torch, x, ws, gates))
        n_bytes, flops = _moe_bound(E, C, DM, DF, x.element_size(), True)
        bms, by = bound_ms(n_bytes, flops, dtype)
        r = dict(dtype=dtype, problem=[E, C, DM, DF], cfg=cfg.name(),
                 instance=moe_instance(cfg, x, ws[0]), max_abs_err=err,
                 ms=ms, plain_ms=plain, yardstick_ms=yard, bound_ms=bms,
                 bound_by=by, library_ms=None, launches=1)
        log(f"[moe] grouped_ffn {dtype} off the grain {E}x{C}x{DM}x{DF} "
            f"{cfg.name()} on {r['instance']}: err {err:.3g}, {ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), plain {plain:.4f} ms, bmm "
            f"yardstick {yard:.4f} ms, library none")
        out.append(r)
    return out


def _moe_production_check(torch):
    """The default config at the family's production problem (16,384
    tokens, top-8 of 32 experts, 7168 x 2048, bf16), held to the plain
    version expert by expert."""
    from repro_torch.core.families import get_family
    from repro_torch.kernels.moe import (capacity_for, default_config,
                                         grouped_ffn, grouped_ffn_ref,
                                         moe_error)
    prob = get_family("moe").example()[1]
    E, DM, DF = prob.n_experts, prob.d_model, prob.d_ff
    cfg = default_config(DM, DF)
    C = capacity_for(prob.tokens, prob.top_k, E, cfg.block_t)
    x, ws, gates = _moe_inputs(torch, E, C, DM, DF, "bfloat16", 99)
    got = grouped_ffn(x, *ws, gates, cfg=cfg)
    want = _by_expert(grouped_ffn_ref, x, ws, gates)
    err, ok = moe_error(got, want)
    check(ok, f"grouped_ffn at the production problem: max |kernel - "
          f"plain| {err} beyond the tolerance")
    inst = moe_instance(cfg, x, ws[0])
    del x, ws, gates, got, want
    torch.cuda.empty_cache()
    return dict(label="production", dtype="bfloat16", cfg=cfg.name(),
                instance=inst, max_abs_err=err, E=E, C=C)


def phase_moe_ffn(torch):
    """``moe_ffn`` end to end (gate, dispatch, the kernel, combine) at
    granite-moe-3b-a800m's layer (4,096 tokens, top-8 of 40 experts,
    1536 x 512), a router skewed so that capacity 1.25 drops pairs,
    against the dense oracle ``moe_ffn_ref`` through the keep mask."""
    from repro_torch.kernels.moe import (KERNEL, capacity_for,
                                         compute_dispatch, default_config,
                                         moe_error, moe_ffn, moe_ffn_ref)
    T, E, K, DM, DF = 4096, 40, 8, 1536, 512
    out = []
    for dtype in ("bfloat16", "float32"):
        x = _moe_inputs(torch, 1, T, DM, DF, dtype, 7)[0][0]
        ws = _moe_inputs(torch, E, 8, DM, DF, dtype, 9)[1]
        g = torch.Generator(device="cuda").manual_seed(8)
        logits = torch.randn(T, E, generator=g, device="cuda") \
            - 2 * torch.arange(E, device="cuda") / E
        gates, idx = torch.topk(torch.softmax(logits, -1), K)
        gates = gates / gates.sum(-1, keepdim=True)
        idx = idx.int()
        n0 = KERNEL.launches
        got = moe_ffn(x, gates, idx, *ws)
        torch.cuda.synchronize()
        check(KERNEL.launches == n0 + 1, "moe_ffn did not launch the kernel")
        C = capacity_for(T, K, E, default_config(DM, DF).block_t)
        _, keep = compute_dispatch(idx, E, C)
        dropped = int((~keep).sum())
        check(dropped > 0, "the skewed router dropped no pair")
        want = moe_ffn_ref(x, gates * keep, idx, *ws)
        err, ok = moe_error(got, want)
        check(ok, f"moe_ffn {dtype}: max |op - dense oracle| {err} beyond "
              "the tolerance")
        out.append(dict(dtype=dtype, max_abs_err=err, dropped=dropped,
                        pairs=T * K))
    log("[moe] moe_ffn at granite's layer (4096 tokens, top-8 of 40, "
        "1536 x 512) against moe_ffn_ref through the keep mask: " +
        ", ".join(f"{SHORT[c['dtype']]} max abs {c['max_abs_err']:.3g} "
                  f"({c['dropped']} of {c['pairs']} pairs dropped)"
                  for c in out))
    return out


def phase_moe_time(torch, best_cfg):
    """The family example's config and the loop's best at the production
    problem and both sweep problems, each held to the plain version and
    then timed beside the bound (the capacity rows the kernel computes),
    the family's ``moe_sol`` (routed rows only), the plain version
    (expert by expert), the bmm yardstick and the cost model's estimate
    (a model, not a measurement)."""
    from repro_torch.core.families import get_family
    from repro_torch.core.verify_engine import default_engine
    from repro_torch.kernels.moe import (capacity_for, grouped_ffn,
                                         grouped_ffn_ref, moe_error)
    fam = get_family("moe")
    cfg0 = fam.example()[0]
    rows = []
    for prob in fam.sweep_problems():
        E, DM, DF = prob.n_experts, prob.d_model, prob.d_ff
        sol = fam.sol_bound(prob).time_s * 1e3
        inputs = {}
        for which, cfg in (("example", cfg0), ("best", best_cfg)):
            if not default_engine().verify("moe", cfg, prob).hard_ok:
                rows.append(dict(problem=dataclasses.astuple(prob),
                                 config=which, cfg=cfg.name(),
                                 rejected=True))
                continue
            C = capacity_for(prob.tokens, prob.top_k, E, cfg.block_t)
            if C not in inputs:
                inputs.clear()
                torch.cuda.empty_cache()
                x, ws, gates = _moe_inputs(torch, E, C, DM, DF, "bfloat16",
                                           prob.tokens)
                want = _by_expert(grouped_ffn_ref, x, ws, gates)
                plain = time_ms(torch, lambda: _by_expert(
                    grouped_ffn_ref, x, ws, gates), iters=3, warmup=1)
                bmm = time_ms(torch, _bmm_yardstick(torch, x, ws, gates),
                              iters=10)
                inputs[C] = (x, ws, gates, want, plain, bmm)
            x, ws, gates, want, plain, bmm = inputs[C]
            err, ok = moe_error(grouped_ffn(x, *ws, gates, cfg=cfg), want)
            check(ok, f"grouped_ffn {dataclasses.astuple(prob)[:5]} "
                  f"{cfg.name()}: max |kernel - plain| {err} beyond the "
                  "tolerance")
            est = fam.cost(cfg, prob).time_s * 1e3
            slow = est > 100.0
            ms = time_ms(torch, lambda: grouped_ffn(x, *ws, gates, cfg=cfg),
                         iters=3 if slow else 10, warmup=1 if slow else 3)
            n_bytes, flops = _moe_bound(E, C, DM, DF, 2, cfg.fuse_gate)
            bms, by = bound_ms(n_bytes, flops, "bfloat16")
            rows.append(dict(problem=dataclasses.astuple(prob),
                             config=which, cfg=cfg.name(),
                             instance=moe_instance(cfg, x, ws[0]),
                             rows=E * C, ms=ms, bound_ms=bms, bound_by=by,
                             sol_routed_ms=sol, plain_ms=plain,
                             plain_by="expert", library_ms=None,
                             yardstick_ms=bmm, max_abs_err=err,
                             model_ms=est, model_over_measured=est / ms,
                             tflops=flops / ms / 1e9))
            log(f"[moe] {dataclasses.astuple(prob)[:5]} {which} "
                f"{cfg.name()} on {rows[-1]['instance']}: {ms:.3f} ms "
                f"({rows[-1]['tflops']:.1f} "
                f"TFLOP/s over {E * C} capacity rows), bound {bms:.3f} ms "
                f"({by}; moe_sol over the routed rows {sol:.3f} ms), plain "
                f"{plain:.3f} ms (expert by expert), yardstick (3 bmm + "
                f"SwiGLU + gate) {bmm:.3f} ms; cost model (H100 model, not "
                f"measured) {est:.3f} ms = {est / ms:.3f} x measured; "
                f"against the plain version max abs {err:.3g}")
        inputs.clear()
        torch.cuda.empty_cache()
    return rows


def phase_moe(torch):
    out = {"kernel": phase_moe_kernels(torch),
           "off_grain": _moe_off_grain_times(torch),
           "moe_ffn": phase_moe_ffn(torch)}
    out["loop"], best = phase_loop(torch, "moe")
    out["time"] = phase_moe_time(torch, best)
    return out


# -- phase 9 -----------------------------------------------------------------

def phase_serve_moe(torch):
    """granite-moe-3b-a800m: the two serving kernels against their plain
    versions at its shapes (24 query heads, 8 KV heads, head_dim 64), the
    serve phase at full width and depth (32 layers), and the kernel
    paths against the gather paths in float32 at depth 2 with a
    drop-free capacity factor: E / top_k = 5, at which each expert has a
    slot for every token of a chunk (a token picks an expert once), so
    a token's experts do not depend on which tokens share its chunk (at
    1.25 a packed prefill chunk and a per-sequence one may drop
    different pairs, and the two paths may rightly differ)."""
    from repro_torch import configs
    kern = {"paged_decode": phase_decode_kernel(torch, "bfloat16",
                                                heads=GRANITE_HEADS),
            "ragged_prefill": phase_prefill_kernel(torch, "bfloat16",
                                                   heads=GRANITE_HEADS)}
    m = configs.get_config(SERVE_MOE["arch"]).moe
    return dict(kernels=kern, serve=phase_serve(torch, SERVE_MOE),
                paths=phase_paths(torch, SERVE_MOE, moe=dict(
                    capacity_factor=m.n_experts / m.top_k)))


# -- phase 10 ----------------------------------------------------------------

QUANT_CASES = [
    # (label, m, n, k, group, cfg fields (None: the default config)); the
    # default config, the example and bk 64 / 32 with 128-wide configs run
    # on the wgmma instance, the rest on mma.sync (``instance_name``)
    ("default", 2048, 2048, 2048, 128, None),
    ("default m=40", 40, 1024, 1024, 128, None),
    ("example 128x128x128", 1024, 1024, 1024, 128, {}),
    ("32x32x32", 512, 512, 1024, 128, dict(bm=32, bn=32, bk=32)),
    ("64x64x64", 512, 512, 1024, 128, dict(bm=64, bn=64, bk=64)),
    ("256x256x128", 1024, 1024, 1024, 128, dict(bm=256, bn=256, bk=128)),
    ("256x32x64", 1024, 512, 1024, 128, dict(bm=256, bn=32, bk=64)),
    ("32x256x128", 512, 1024, 1024, 128, dict(bm=32, bn=256, bk=128)),
    ("group 64 bk=64", 1024, 1024, 1024, 64, dict(bk=64)),
    ("group 64 bk=32", 1024, 1024, 1024, 64, dict(bm=64, bn=64, bk=32)),
    ("ragged byte path", 1000, 777, 1500, 128, dict(bm=64, bn=64, bk=64)),
    ("ragged 16-byte path", 1000, 784, 1552, 128, None),
    # wgmma: group 64 at bk 32, rows masked by TMA's zero fill (m = 40,
    # 1000), columns and depth ragged against the 128 x 128 x 128 stage
    ("wgmma group 64 bk=32", 1024, 1024, 1024, 64, dict(bk=32)),
    ("wgmma m=40", 40, 1024, 1024, 128, dict(bm=128)),
    ("wgmma ragged 128x256x64", 1000, 784, 1552, 128,
     dict(bm=128, bn=256, bk=64)),
]


def _quant_inputs(torch, m, n, k, group, seed):
    """int8 A and B quantised per group (the port's
    ``quantize_per_group``) from seeded normals made on the card."""
    from repro_torch.kernels.quant_gemm import quantize_per_group
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(m, k, generator=g, device="cuda")
    b = torch.randn(k, n, generator=g, device="cuda")
    aq, sa = quantize_per_group(a, group, axis=1)
    bq, sb = quantize_per_group(b, group, axis=0)
    return aq, bq, sa, sb


def phase_quant_kernel(torch):
    """Each case against the plain version within ``quant_error``, named
    by its instance; a wgmma case also against the mma.sync instance at
    the same bk (64 x 64 CTA tiles) on the same inputs, which must give
    the same bits: the two promote each block with one expression, in K
    order."""
    from repro_torch.core.families.quant_gemm import (QuantGemmConfig,
                                                      QuantGemmProblem,
                                                      instance_name,
                                                      is_wgmma)
    from repro_torch.kernels.quant_gemm import (KERNEL, default_config,
                                                quant_error, quant_gemm_ref,
                                                quant_matmul)
    out = []
    cases = QUANT_CASES + [("production", 8192, 8192, 8192, 128, None)]
    for label, m, n, k, group, f in cases:
        aq, bq, sa, sb = _quant_inputs(torch, m, n, k, group, m + n + k)
        cfg = (QuantGemmConfig(**f) if f is not None
               else default_config(m, n, k, group))
        prob = QuantGemmProblem(m, n, k, group)
        inst = instance_name(cfg, prob)
        outs = ("float32",) if label == "production" else ("float32",
                                                          "bfloat16")
        for od in outs:
            dt = getattr(torch, od)
            n0 = KERNEL.launches
            got = quant_matmul(aq, bq, sa, sb, group=group, cfg=cfg,
                               out_dtype=dt)
            torch.cuda.synchronize()
            check(KERNEL.launches == n0 + 1, f"quant_gemm {label}: no launch")
            want = quant_gemm_ref(aq, bq, sa, sb, group=group, out_dtype=dt)
            err, ok = quant_error(got, want)
            check(ok, f"quant_gemm {label} ({inst}) out {od}: max |kernel - "
                      f"plain| {err} beyond the tolerance beside quant_error")
            check(bool(torch.isfinite(got).all()), f"quant_gemm {label}: "
                  "non-finite output")
            row = dict(label=label, instance=inst, out=od, m=m, n=n, k=k,
                       group=group, cfg=cfg.name(), max_abs_err=err,
                       max_abs_out=float(want.float().abs().max()))
            if is_wgmma(cfg, prob):
                ref_cfg = QuantGemmConfig(64, 64, cfg.bk)
                other = quant_matmul(aq, bq, sa, sb, group=group,
                                     cfg=ref_cfg, out_dtype=dt)
                check(not is_wgmma(ref_cfg, prob) and
                      bool(torch.equal(got, other)),
                      f"quant_gemm {label} out {od}: the wgmma instance "
                      f"and the mma.sync instance at bk {cfg.bk} differ in "
                      f"{int((got != other).sum())} outputs")
                row["bit_identical_to"] = ref_cfg.name()
                del other
            out.append(row)
        del aq, bq, sa, sb, got, want
    torch.cuda.empty_cache()
    same = [c for c in out if "bit_identical_to" in c]
    log(f"[quant_gemm] kernel against its plain version: {len(out)} cases "
        f"(out f32 and bf16; default and example configs, bm and bn 32 to "
        f"256, bk 32/64/128 with group 128 and group 64, ragged m, n, k on "
        f"the byte and 16-byte paths, 8192^3 int8 group 128), all within "
        f"the tolerance beside quant_error; {len(same)} on the int8 wgmma "
        f"instance, each bit-identical to the mma.sync instance at its bk; "
        f"max abs err " + ", ".join(
            f"{SHORT[c['out']]}/{c['label']} [{c['instance']}] "
            f"{c['max_abs_err']:.3g}" for c in out))
    return out


def quant_parts_ms(torch, call, n=10):
    """Device time per call of a ``quant_matmul`` call: the transpose of
    B into scratch (the wgmma instance) and the GEMM kernel."""
    return device_parts_ms(torch, call, lambda k: (
        "transpose" if "transpose_kernel" in k else
        "gemm" if "quant" in k else None), n, per_launch=True)


def phase_quant_time(torch, best_cfg):
    """The family example's config and the loop's best at the production
    problem and both sweep problems, each held to the plain version and
    then timed (the whole call, and the device time of its transpose of
    B and of its GEMM kernel) beside the bound, the plain version, the
    cost model's estimate (a model, not a measurement) and a yardstick:
    one ``torch._int_mm`` over the whole K (cuBLASLt int8 -> int32), with
    B row-major and column-major, which applies no group scale and so
    computes another function; the port never calls it."""
    from repro_torch.core.families import get_family
    from repro_torch.core.families.quant_gemm import instance_name
    from repro_torch.core.verify_engine import default_engine
    from repro_torch.kernels.quant_gemm import (quant_error, quant_gemm_ref,
                                                quant_matmul)
    fam = get_family("quant_gemm")
    cfg0 = fam.example()[0]
    rows = []
    for prob in fam.sweep_problems():
        m, n, k, group = prob.m, prob.n, prob.k, prob.group
        aq, bq, sa, sb = _quant_inputs(torch, m, n, k, group, m ^ n ^ k)
        want = quant_gemm_ref(aq, bq, sa, sb, group=group)
        plain = time_ms(torch, lambda: quant_gemm_ref(aq, bq, sa, sb,
                                                      group=group), iters=10)
        yard = _int_mm_ms(torch, aq, bq)
        # the same product with B stored column-major (copied beforehand,
        # outside the timing): cuBLASLt's preferred int8 layout
        bq_cm = bq.t().contiguous().t()
        yard_cm = _int_mm_ms(torch, aq, bq_cm)
        del bq_cm
        # the operations and bytes the function needs: the family's sol
        sol = fam.sol_bound(prob)
        ops = sol.flops
        bms, by = bound_ms(sol.hbm_bytes, ops, "int8")
        for which, cfg in (("example", cfg0), ("best", best_cfg)):
            if not default_engine().verify("quant_gemm", cfg, prob).hard_ok:
                rows.append(dict(problem=[m, n, k, group], config=which,
                                 cfg=cfg.name(), rejected=True))
                continue
            err, ok = quant_error(quant_matmul(aq, bq, sa, sb, group=group,
                                               cfg=cfg), want)
            check(ok, f"quant_gemm {m}x{n}x{k} {cfg.name()}: max |kernel - "
                      f"plain| {err} beyond the tolerance")
            call = lambda: quant_matmul(aq, bq, sa, sb, group=group,
                                        cfg=cfg)
            ms = time_ms(torch, call)
            parts = quant_parts_ms(torch, call)
            est = fam.cost(cfg, prob).time_s * 1e3
            rows.append(dict(problem=[m, n, k, group], config=which,
                             cfg=cfg.name(),
                             instance=instance_name(cfg, prob), ms=ms,
                             transpose_ms=parts.get("transpose"),
                             gemm_ms=parts.get("gemm"), bound_ms=bms,
                             bound_by=by, plain_ms=plain, library_ms=None,
                             yardstick_ms=yard,
                             yardstick_colmajor_b_ms=yard_cm,
                             max_abs_err=err,
                             model_ms=est, model_over_measured=est / ms,
                             tops=ops / ms / 1e9))
            log(f"[quant_gemm] {m}x{n}x{k} int8 group {group} {which} "
                f"{cfg.name()} [{rows[-1]['instance']}]: {ms:.4f} ms "
                f"({rows[-1]['tops']:.1f} TOP/s; device: transpose of B "
                f"{_ms_or(parts.get('transpose'))}, GEMM kernel "
                f"{_ms_or(parts.get('gemm'))}), "
                f"bound {bms:.4f} ms ({by}), plain {plain:.4f} ms, "
                f"yardstick torch._int_mm (int32, no scales) "
                f"{_ms_or(yard)} (B column-major {_ms_or(yard_cm)}); "
                f"cost model (H100 model, not measured) {est:.4f} ms = "
                f"{est / ms:.3f} x measured; against the plain version max "
                f"abs {err:.3g}")
        del aq, bq, sa, sb, want
        torch.cuda.empty_cache()
    return rows


def _ms_or(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _parts_or(parts):
    """A breakdown from :func:`device_parts_ms`, or "not measured"."""
    return ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()) or \
        "not measured"


def _int_mm_ms(torch, aq, bq):
    """One ``torch._int_mm`` (cuBLASLt int8 x int8 -> int32) over the
    whole K, or None (logged) if this PyTorch refuses the operands."""
    try:
        return time_ms(torch, lambda: torch._int_mm(aq, bq))
    except RuntimeError as e:
        log(f"[quant_gemm] torch._int_mm refused: {str(e)[:200]}")
        return None


def phase_quant_refuse(torch):
    from repro_torch.core.families.quant_gemm import QuantGemmConfig
    from repro_torch.kernels.quant_gemm import (KERNEL, InvariantViolation,
                                                quant_matmul)
    aq, bq, sa, sb = _quant_inputs(torch, 256, 256, 512, 128, 5)
    before = KERNEL.launches
    try:
        quant_matmul(aq, bq, sa, sb, group=128, cfg=QuantGemmConfig(bk=96))
    except InvariantViolation as e:
        torch.cuda.synchronize()
        check(KERNEL.launches == before, "an invalid config launched")
        first = str(e).splitlines()
        log(f"[quant_gemm] bk=96 with group 128: InvariantViolation before "
            f"any launch ({first[0]} / {first[1].strip()})")
        return str(e)
    raise SmokeFailure("a bk that does not divide the group was not refused")


def phase_quant(torch):
    out = {"kernel": phase_quant_kernel(torch)}
    out["loop"], best = phase_loop(torch, "quant_gemm")
    out["time"] = phase_quant_time(torch, best)
    out["refused"] = phase_quant_refuse(torch)
    return out


# -- phase 11 ----------------------------------------------------------------

SSD_CASES = [
    # (label, BH, S, P, N, chunk (None: the default, min(128, S)))
    ("chunk 32", 4, 1024, 64, 128, 32),
    ("chunk 64", 4, 1024, 64, 128, 64),
    ("chunk 128 P16 N16", 2, 1024, 16, 16, 128),
    ("chunk 256", 4, 2048, 64, 128, 256),
    ("chunk 512 P128", 2, 2048, 128, 128, 512),
    ("one chunk BH1", 1, 512, 64, 128, 512),
    ("one chunk BH64", 64, 256, 64, 16, 256),
    ("BH64 many chunks", 64, 2048, 64, 128, 128),
    ("chunk 96 P24 N12", 3, 480, 24, 12, 96),
    # N·P not a multiple of 4: the state pass one element a thread
    ("chunk 64 P9 N7", 2, 256, 9, 7, 64),
    # state panels of 128: d_state 130 (136: panels of 128 and 8) and 256
    ("d_state 130", 4, 1024, 64, 130, 128),
    ("d_state 256", 4, 1024, 64, 256, 128),
]
# the state panels timed at mamba2's layer shape (48 heads x 2048 tokens,
# P 64), d_state 130 and 256 (phase 11)
SSD_PANELS = [(48, 2048, 64, 130, 128), (48, 2048, 64, 256, 128)]


def _ssd_inputs(torch, BH, S, P, N, dtype, seed):
    """x ~ N(0, 1), da = -|N(0, 1)|·0.1 (float32), B and C ~
    0.3·N(0, 1), as the JAX tests make them, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    x = torch.randn(BH, S, P, generator=g, device="cuda").to(dt)
    da = -torch.randn(BH, S, generator=g, device="cuda").abs() * .1
    B = (torch.randn(BH, S, N, generator=g, device="cuda") * .3).to(dt)
    C = (torch.randn(BH, S, N, generator=g, device="cuda") * .3).to(dt)
    return x, da, B, C


def phase_ssd_kernel(torch):
    from repro_torch.core.families.ssd import SSDConfig
    from repro_torch.kernels.ssd import KERNEL, ssd, ssd_error, ssd_ref
    out = []
    cases = SSD_CASES + [("production", 64, 8192, 64, 128, None)]
    for i, (label, BH, S, P, N, q) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            x, da, B, C = _ssd_inputs(torch, BH, S, P, N, dtype, i)
            cfg = SSDConfig(q) if q else None
            n0 = KERNEL.launches
            got = ssd(x, da, B, C, cfg=cfg)
            torch.cuda.synchronize()
            check(KERNEL.launches == n0 + 1, f"ssd {label}: no launch")
            want, _ = ssd_ref(x, da, B, C, q or min(128, S),
                              acc=torch.float64)
            err, row, ok = ssd_error(got, want)
            check(ok, f"ssd {dtype} {label}: max |kernel - plain| {err}, "
                      f"worst row {row}: beyond the tolerance")
            out.append(dict(label=label, dtype=dtype, max_abs_err=err,
                            row_err=row,
                            max_abs_out=float(want.float().abs().max())))
            del x, da, B, C, got, want
    torch.cuda.empty_cache()
    worst = {}
    for c in out:
        e, r = worst.get(c["dtype"], (0.0, 0.0))
        worst[c["dtype"]] = (max(e, c["max_abs_err"]), max(r, c["row_err"]))
    log(f"[ssd] kernel against its plain version: {len(out)} cases (f32 and "
        f"bf16; chunks 32 to 512 and 96, P 9/16/24/64/128, N 7/12/16/128, "
        f"BH 1 and 64, one chunk and many, the production problem 64 x "
        f"8192 x 64 x 128 f32 and bf16), all within the tolerance beside "
        f"ssd_error; worst "
        f"(max abs, row) " + ", ".join(
            f"{SHORT[d]} {e:.3g} {r:.3g}" for d, (e, r) in worst.items())
        + "; each case " + ", ".join(
            f"{SHORT[c['dtype']]}/{c['label']} {c['max_abs_err']:.3g}"
            for c in out))
    return out


def _ssd_panel_times(torch):
    """ssd_chunk_scan at d_state above one panel (SSD_PANELS), float32
    and bf16: held to its plain version, timed (CUDA events, L2 flushed)
    beside its bound (the family's sol at the 3xTF32 rate; a bf16
    operand is exact in TF32, so the bf16 run issues fewer products than
    that rate counts) and the plain version; no single PyTorch call
    computes it."""
    from repro_torch.core.families import get_family
    from repro_torch.core.families.ssd import (SSDConfig, SSDProblem,
                                               kernel_flops)
    from repro_torch.kernels.ssd import KERNEL, ssd, ssd_error, ssd_ref
    out = []
    for BH, S, P, N, q in SSD_PANELS:
        for dtype in ("float32", "bfloat16"):
            x, da, B, C = _ssd_inputs(torch, BH, S, P, N, dtype, N)
            cfg = SSDConfig(q)
            call = lambda: ssd(x, da, B, C, cfg=cfg)
            n0 = KERNEL.launches
            got = call()
            torch.cuda.synchronize()
            check(KERNEL.launches == n0 + 1, f"ssd d_state {N}: no launch")
            # held to the plain version summed in float64 (ssd_error's
            # note on rows whose terms cancel); the float32 plain
            # version's own distance from it is reported beside
            want, _ = ssd_ref(x, da, B, C, q, acc=torch.float64)
            err, row, ok = ssd_error(got, want)
            check(ok, f"ssd {dtype} d_state {N}: max |kernel - plain| "
                  f"{err}, worst row {row}: beyond the tolerance")
            err32, row32, _ = ssd_error(ssd_ref(x, da, B, C, q)[0], want)
            ms = time_ms(torch, call)
            plain = time_ms(torch, lambda: ssd_ref(x, da, B, C, q),
                            iters=3, warmup=1)
            # the family's sol (the operands once; the causal triangle
            # of each chunk at the chunk that needs the fewest
            # operations) at the float32-accurate tensor-core rate, as
            # phase 11c bounds the production problem
            sol = get_family("ssd").sol_bound(SSDProblem(BH, S, P, N,
                                                         SHORT[dtype]))
            bms, by = bound_ms(sol.hbm_bytes, sol.flops, "tf32x3")
            r = dict(dtype=dtype, problem=[BH, S, P, N], cfg=cfg.name(),
                     instance="3xTF32 mma.sync, state panels of 128",
                     max_abs_err=err, row_err=row,
                     plain_f32_err=err32, plain_f32_row_err=row32,
                     ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None,
                     kernel_flops=kernel_flops(cfg, SSDProblem(
                         BH, S, P, N, SHORT[dtype])), launches=1)
            log(f"[ssd] d_state {N} {dtype} {BH}x{S}x{P}x{N} chunk {q}: "
                f"err {err:.3g} (row {row:.3g}; the float32 plain version "
                f"{err32:.3g}, row {row32:.3g}), {ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by}), plain {plain:.4f} ms, library none")
            out.append(r)
            del x, da, B, C, got, want
    torch.cuda.empty_cache()
    return out


def phase_ssd_time(torch, best_cfg):
    """The family example's config (chunk 64) and the loop's best at the
    production problem and both sweep problems, each held to the plain
    version and then timed — the whole call, and the device time of each
    of its three launches (chunk states, the pass over them, the chunk
    scan), with the scratch it allocates — beside the bound, the plain
    version (at the config's chunk) and the cost model's estimate (a
    model, not a measurement).  No single PyTorch call computes the
    scan."""
    from repro_torch.core.families import get_family
    from repro_torch.core.families.ssd import scratch_bytes
    from repro_torch.core.verify_engine import default_engine
    from repro_torch.kernels.ssd import ssd, ssd_error, ssd_ref
    fam = get_family("ssd")
    cfg0 = fam.example()[0]
    rows = []
    for prob in fam.sweep_problems():
        BH, S, P, N = prob.batch_heads, prob.seq, prob.head_dim, prob.d_state
        x, da, B, C = _ssd_inputs(torch, BH, S, P, N, "float32", S)
        # the family's sol: the causal triangle of each chunk, at the
        # chunk that needs the fewest operations, at the rate of
        # float32-accurate tensor-core products
        sol = fam.sol_bound(prob)
        ops = sol.flops
        bms, by = bound_ms(sol.hbm_bytes, ops, "tf32x3")
        for which, cfg in (("example", cfg0), ("best", best_cfg)):
            if not default_engine().verify("ssd", cfg, prob).hard_ok:
                rows.append(dict(problem=dataclasses.astuple(prob),
                                 config=which, cfg=cfg.name(),
                                 rejected=True))
                continue
            want, _ = ssd_ref(x, da, B, C, cfg.chunk, acc=torch.float64)
            err, row, ok = ssd_error(ssd(x, da, B, C, cfg=cfg), want)
            check(ok, f"ssd {dataclasses.astuple(prob)[:4]} {cfg.name()}: "
                      f"max |kernel - plain| {err}, worst row {row}")
            del want
            plain = time_ms(torch, lambda: ssd_ref(x, da, B, C, cfg.chunk),
                            iters=3, warmup=1)
            call = lambda: ssd(x, da, B, C, cfg=cfg)
            ms = time_ms(torch, call, iters=5, warmup=1)
            parts = ssd_parts_ms(torch, call)
            est = fam.cost(cfg, prob).time_s * 1e3
            rows.append(dict(problem=dataclasses.astuple(prob),
                             config=which, cfg=cfg.name(), ms=ms,
                             parts_ms=parts,
                             scratch_bytes=scratch_bytes(cfg, prob),
                             bound_ms=bms, bound_by=by, plain_ms=plain,
                             library_ms=None, max_abs_err=err, row_err=row,
                             model_ms=est, model_over_measured=est / ms,
                             tflops=ops / ms / 1e9))
            log(f"[ssd] {dataclasses.astuple(prob)[:4]} f32 {which} "
                f"{cfg.name()}: {ms:.4f} ms ({rows[-1]['tflops']:.2f} TFLOP/s "
                f"of the algorithmic work; device: " + _parts_or(parts)
                + f"; scratch {rows[-1]['scratch_bytes'] / 1e6:.1f} MB), "
                f"bound {bms:.4f} ms ({by}), plain "
                f"{plain:.4f} ms, library: none; cost model (H100 model, not "
                f"measured) {est:.4f} ms = {est / ms:.3f} x measured; "
                f"against the plain version max abs {err:.3g}, worst row "
                f"{row:.3g}")
            torch.cuda.empty_cache()
        del x, da, B, C
        torch.cuda.empty_cache()
    return rows


def ssd_parts_ms(torch, call, n=3):
    """Device time per call of an ``ssd`` call, by launch: the chunk
    states, the pass over them in chunk order, the chunk scan."""
    return device_parts_ms(torch, call, lambda k: next(
        (n for n in ("state", "pass", "scan") if f"ssd_{n}_kernel" in k),
        None), n, per_launch=True)


# float32 decode replay against the full forward: |step - full| within
# 1e-4 of each logit plus 1e-4 of the largest |logit| (the two compute
# the same recurrence in float32 in another order: the chunked scan
# against one state update a token)
REPLAY_REL = 1e-4


def _replay_check(torch, got, want, what, rel=REPLAY_REL):
    """Logits within ``rel`` of each plus ``rel`` of the largest; returns
    the largest difference and its share of (|logit| + the largest)."""
    d = (got - want).abs()
    big = float(want.abs().max())
    check(bool((d <= rel * want.abs() + rel * big).all()),
          f"{what}: max |step - full| {float(d.max())} beyond {rel:g} of "
          f"each logit plus {rel:g} of the largest ({big})")
    return float(d.max()), float((d / (want.abs() + big)).max())


def phase_mamba2(torch):
    """mamba2-780m at full width and depth (48 layers, bf16 blocks,
    random weights from a seeded ``torch.Generator``): ``SSMLM.apply``
    over 4 x 2,048 tokens, timed and profiled; then the SSD core of its
    first layer at that width, on the layer's own inputs, through
    ``ssd_via_kernel`` (the CUDA kernel; the counters zeroed just before
    and read just after) against the plain ``ssd_chunked``; then, at
    depth 2 in float32, a stepwise ``decode_step`` replay of 16 tokens
    against ``apply``'s logits."""
    from repro_torch import configs
    from repro_torch.core.families import get_family
    from repro_torch.core.families.ssd import SSDProblem
    from repro_torch.kernels import ALL_KERNELS
    from repro_torch.kernels.ssd import ssd_error
    from repro_torch.models import build
    from repro_torch.models.components import apply_norm, embed
    from repro_torch.models.ssm import (ssd_chunked, ssd_operands,
                                        ssd_via_kernel)
    from repro_torch.models.transformer import layer_slice
    cfg = configs.get_config("mamba2-780m")
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B_, S = 4, 2048
    g = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(2, cfg.vocab, (B_, S), generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    logits, _ = model.apply(params, toks)
    torch.cuda.synchronize()
    check(tuple(logits.shape) == (B_, S, cfg.padded_vocab),
          f"mamba2 logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "mamba2: non-finite logits")
    del logits
    fwd = []
    for _ in range(2):
        t0 = time.perf_counter()
        model.apply(params, toks)
        torch.cuda.synchronize()
        fwd.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile(torch, lambda: model.apply(params, toks))
    log(f"[mamba2] {cfg.name}: {model.n_params / 1e9:.3f} B params, init "
        f"{init_s:.1f} s; apply over {B_} x {S} tokens (48 layers, bf16 "
        f"blocks, the SSD core by ssd_chunked as in the JAX package): "
        f"{min(fwd):.1f} ms (host clock, synchronised; runs "
        f"{', '.join(f'{t:.1f}' for t in fwd)}), peak memory {peak:.2f} "
        f"GB; profiled {prof['wall_ms']:.1f} ms wall, device "
        f"{prof['device_ms']:.1f} ms, {prof['device_launches']} device "
        f"kernels; top: " + "; ".join(
            f"{k[:48]} {v:.2f}" for k, v in prof["top_kernels_ms"][:6]))

    # the SSD core of layer 0 on its own inputs
    p0 = layer_slice(params["blocks"], 0)
    h = apply_norm(p0["ln"], embed(params["embed"], toks, cfg), cfg)
    _, xh, da, Bh, Ch, _ = ssd_operands(p0["ssm"], h, cfg)
    q = cfg.ssm.chunk
    H, P, N = xh.shape[2], xh.shape[3], Bh.shape[3]
    for k in ALL_KERNELS:                      # count the main path only
        k.launches = 0
    got = ssd_via_kernel(xh, da, Bh, Ch, q)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in ALL_KERNELS}
    check(launches["ssd_chunk_scan"] == 1 and sum(launches.values()) == 1,
          f"ssd_via_kernel launches {launches}")
    want, _ = ssd_chunked(xh, da, Bh, Ch, q)
    err, row, ok = ssd_error(got, want)
    check(ok, f"ssd_via_kernel at mamba2's layer: max |kernel - "
              f"ssd_chunked| {err}, worst row {row}: beyond the tolerance")
    call = lambda: ssd_via_kernel(xh, da, Bh, Ch, q)
    ms = time_ms(torch, call, iters=5)
    parts = ssd_parts_ms(torch, call)
    plain = time_ms(torch, lambda: ssd_chunked(xh, da, Bh, Ch, q), iters=5)
    sol = get_family("ssd").sol_bound(SSDProblem(B_ * H, S, P, N, "f32"))
    bms, by = bound_ms(sol.hbm_bytes, sol.flops, "tf32x3")
    layer = dict(bh=B_ * H, seq=S, head_dim=P, d_state=N, chunk=q,
                 launches=launches["ssd_chunk_scan"], max_abs_err=err,
                 row_err=row, max_abs_out=float(want.abs().max()),
                 ms=ms, parts_ms=parts, plain_ms=plain, bound_ms=bms,
                 bound_by=by)
    log(f"[mamba2] SSD core of layer 0 (BH {B_ * H}, S {S}, P {P}, N {N}, "
        f"chunk {q}) through ssd_via_kernel: 1 ssd_chunk_scan launch, "
        f"against ssd_chunked max abs {err:.3g} (|y| up to "
        f"{layer['max_abs_out']:.3g}), worst row {row:.3g}; "
        f"{ms:.4f} ms (with the fold to (BH, S, P); device: "
        + _parts_or(parts) + "), "
        f"ssd_chunked {plain:.4f} ms, bound {bms:.4f} ms ({by})")
    del params, toks, h, xh, da, Bh, Ch, got, want
    torch.cuda.empty_cache()

    # depth 2, float32: stepwise decode against the full forward
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    m2 = build(cfg2)
    p2 = m2.init(1, device="cuda")
    t2 = torch.randint(2, cfg.vocab, (2, 17), generator=g, device="cuda")
    full, _ = m2.apply(p2, t2)
    cache = m2.init_cache(2, 32, device="cuda")
    V, worst = cfg.vocab, 0.0
    for t in range(16):
        step, cache = m2.decode_step(p2, cache, t2[:, t:t + 1], t)
        worst = max(worst, _replay_check(torch, step[:, 0, :V],
                                         full[:, t, :V],
                                         f"mamba2 decode step {t}")[0])
    log(f"[mamba2] depth 2 float32: 16 decode_step tokens against apply's "
        f"logits, max |step - full| {worst:.3g} (within 1e-4 of each logit "
        f"plus 1e-4 of the largest)")
    return dict(forward_ms=min(fwd), forward_runs_ms=fwd, peak_gb=peak,
                profile=prof, layer=layer, replay_max_abs=worst,
                tokens=[B_, S])


def phase_ssd(torch):
    out = {"kernel": phase_ssd_kernel(torch),
           "panels": _ssd_panel_times(torch)}
    out["loop"], best = phase_loop(torch, "ssd")
    out["time"] = phase_ssd_time(torch, best)
    out["mamba2"] = phase_mamba2(torch)
    return out


# -- phase 12 ----------------------------------------------------------------

# the fleet's successive-halving ladder: rungs of 2, 4 and 8 steps
FLEET = dict(base_budget=2, max_budget=8)
FLEET_DIR = ROOT / "chiprun_out" / "fleet"


def _gate_jobs(calls):
    """One tuning job per (family, problem) among ``calls`` (a serve
    run's gate calls: family, config and problem as dicts), each started
    from the smallest config (by its fields, in order) that the run
    verified in the problem's shape bucket.  The H100 cost model reads
    no block size of the two serving kernels (their tiles are fixed), so
    the loop keeps its start unless it finds a config it prices lower;
    a bucket's entry then tiles every packed geometry the run put in
    that bucket.  (An entry passes ``configured`` at a neighbour's exact
    problem, whose ``total_tokens`` is the KV extent; if its ``block_q``
    did not tile that neighbour's packed queries, ``verified_config``
    would give None and the tick would take the gather path, as in the
    JAX package.)"""
    from repro_torch.core.families import get_family
    from repro_torch.core.tuning import make_job
    from repro_torch.core.tuning.dispatch import shape_bucket
    bucket_of, start = {}, {}
    for c in calls:
        fam = get_family(c["family"])
        prob = fam.problem_cls(**c["problem"])
        cfg = fam.config_cls(**c["config"])
        key = (fam.name, shape_bucket(prob))
        if key not in start or (dataclasses.astuple(cfg)
                                < dataclasses.astuple(start[key])):
            start[key] = cfg
        bucket_of[(fam.name, prob)] = key
    return [make_job(f, prob, start[key])
            for (f, prob), key in bucket_of.items()]


def _fleet_run(torch, jobs, name, **kw):
    """``run_fleet`` into ``FLEET_DIR / name`` with the unit tests on the
    card; returns its report, its table's bytes and a summary."""
    from repro_torch.core.tuning import run_fleet
    from repro_torch.core.tuning.pool import TABLE_NAME
    t0 = time.perf_counter()
    rep = run_fleet(jobs, out_dir=FLEET_DIR / name, run_kernels=True,
                    device="cuda", **FLEET, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    table = (FLEET_DIR / name / TABLE_NAME).read_bytes()
    return rep, table, dict(
        dir=name, path=str(FLEET_DIR / name / TABLE_NAME),
        workers=kw.get("workers", 1),
        async_mode=kw.get("async_mode", False), wall_s=wall,
        ran=rep.ran, resumed=rep.skipped, rungs=rep.rungs,
        solver_discharges=rep.stats.get("solver_discharges", 0),
        verify_calls=rep.stats.get("verify_calls", 0),
        constraint_hits=rep.stats.get("constraint_hits", 0))


def _count_unit_tests(families):
    """Wrap each family's ``reference_check`` in the registry so every
    unit test records how many launches of the family's kernel it made
    (a precondition refusal raises before any launch and is counted
    apart, as the validator counts it).  Returns (tests, refusals,
    restore)."""
    from repro_torch.core.families import base
    from repro_torch.core.verify_engine import InvariantViolation
    from repro_torch.kernels import ALL_KERNELS
    kernels = {k.name: k for k in ALL_KERNELS}
    tests = {f: [] for f in families}
    refusals = dict.fromkeys(families, 0)
    saved = {f: base.get_family(f) for f in families}

    def wrap(fam):
        k = kernels[fam.kernel]

        def counted(cfg, prob, device="cuda"):
            before = k.launches
            try:
                ok = fam.reference_check(cfg, prob, device)
            except (ValueError, InvariantViolation):
                refusals[fam.name] += 1
                raise
            tests[fam.name].append(k.launches - before)
            return ok
        return counted
    for f, fam in saved.items():
        base._REGISTRY[f] = dataclasses.replace(
            fam, reference_check=wrap(fam))

    def restore():
        base._REGISTRY.update(saved)
    return tests, refusals, restore


def phase_tune_fleet(torch, serve):
    """(a) one job per serving problem of phase 4, (b) ``run_fleet`` on
    one in-process worker with the unit tests on the card, the launch
    counters zeroed just before and read just after, (c) the table
    byte-identical on two spawn workers, sync and async, and a resume
    that runs nothing."""
    import shutil
    from repro_torch.core.families import get_family
    from repro_torch.kernels import ALL_KERNELS
    jobs = _gate_jobs(serve["gate_calls"])
    check(sorted({j.family for j in jobs})
          == ["paged_attention", "ragged_prefill"],
          f"tune jobs: {[j.job_id for j in jobs]}")
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    fams = ("paged_attention", "ragged_prefill")
    tests, refusals, restore = _count_unit_tests(fams)
    for k in ALL_KERNELS:                      # count the main path only
        k.launches = 0
    try:
        rep, table, run1 = _fleet_run(torch, jobs, "w1")
    finally:
        restore()
    launches = {k.name: k.launches for k in ALL_KERNELS}
    unit = {f: len(tests[f]) for f in fams}
    check(rep.ran > 0 and sum(unit.values()) > 0,
          f"the fleet ran {rep.ran} items, unit tests {unit}")
    for f in fams:
        kern = get_family(f).kernel
        check(all(n > 0 for n in tests[f]),
              f"a {f} unit test launched no {kern}: {tests[f]}")
        check(launches[kern] == sum(tests[f]),
              f"{kern} launched {launches[kern]} times, its unit tests "
              f"{sum(tests[f])}")
    check(all(n == 0 for name, n in launches.items()
              if name not in ("paged_decode", "ragged_prefill")),
          f"the fleet launched another kernel: {launches}")
    runs = [run1]
    for name, kw in (("w2", dict(workers=2)),
                     ("w2_async", dict(workers=2, async_mode=True))):
        _, other, run = _fleet_run(torch, jobs, name, **kw)
        check(other == table, f"dispatch_table.json of {name} differs from "
              f"the one-worker run's")
        runs.append(run)
    again, same, run = _fleet_run(torch, jobs, "w1")
    check(again.ran == 0 and again.skipped == rep.ran and same == table,
          f"resume ran {again.ran} items ({again.skipped} from the "
          f"journal), table {'same' if same == table else 'changed'}")
    runs.append(run)
    entries = {f: {b: dict(config=e["config"], speedup=e["speedup"],
                           est_ms=e["est_ms"], job=e["provenance"]["job"])
                   for b, e in buckets.items()}
               for f, buckets in rep.table.entries.items()}
    log(f"[tune] {len(jobs)} jobs from phase 4's gate calls "
        f"({', '.join(j.job_id for j in jobs)}); ladder {FLEET}")
    for r in runs:
        log(f"[tune] fleet {r['dir']}: {r['workers']} worker(s), "
            f"{'async' if r['async_mode'] else 'sync'}, {r['ran']} items "
            f"ran, {r['resumed']} resumed, {r['rungs']} rungs, "
            f"{r['solver_discharges']} solver discharges, {r['verify_calls']} "
            f"verify calls, wall {r['wall_s']:.2f} s")
    log(f"[tune] unit tests on the card: {unit} ({refusals} refused by a "
        f"precondition), launches paged_decode {launches['paged_decode']} "
        f"(two passes a test), ragged_prefill {launches['ragged_prefill']}; "
        f"tables byte-identical over workers 1/2 and sync/async, the "
        f"resume ran 0 items; {rep.table.summary()}: " + "; ".join(
            f"{f} {b}: {e['config']} (modelled speedup {e['speedup']:.3f})"
            for f, bs in entries.items() for b, e in bs.items()))
    return dict(jobs=[j.job_id for j in jobs], runs=runs, unit_tests=unit,
                refusals=refusals, launches=launches, entries=entries,
                table_bytes=len(table)), run1["path"]



def _geometries(eng, table):
    """Each kernel geometry the engine resolved a config for: the family
    problem, the table's entry for its bucket, whether ``configured``
    took it (a hit: it passes at the exact problem), the config that ran
    (None: the gather path) and the default's."""
    from repro_torch.core.families.paged_attention import \
        PagedAttentionProblem
    from repro_torch.core.families.ragged_prefill import \
        RaggedPrefillProblem
    from repro_torch.core.tuning import dispatch
    from repro_torch.kernels.paged_attention.ops import \
        default_config as paged_default
    from repro_torch.kernels.ragged_prefill.ops import \
        default_config as ragged_default
    mc = eng.model.cfg
    dt = eng._pool_dtype
    heads = (mc.n_heads, mc.n_kv_heads)
    out = []
    # the engine's memo of each geometry's config (decode: one batch
    # geometry; prefill: each packed (TQ, TK, segments))
    if eng._kernel_sig is not None:
        prob = PagedAttentionProblem(
            eng.max_batch, *heads, eng.pages_per_seq * eng.page_size,
            eng.page_size, eng.alloc.n_pages, mc.resolved_head_dim, dt)
        out.append(("paged_attention", prob, eng._kernel_cfg,
                    paged_default(eng.pages_per_seq),
                    dict(batch=eng.max_batch)))
    for (tq, tk, n), ran in sorted(eng._prefill_cfgs.items()):
        prob = RaggedPrefillProblem(n, tk, *heads, mc.resolved_head_dim, dt)
        out.append(("ragged_prefill", prob, ran, ragged_default(tq, tk),
                    dict(TQ=tq, TK=tk)))
    rows = []
    for family, prob, ran, default, where in out:
        entry = table.config_for(family, prob) if table else None
        hit = dispatch.configured(family, prob)
        source = ("gather" if ran is None else "table"
                  if hit is not None and ran == hit else "default"
                  if ran == default else "other")
        rows.append(dict(
            family=family, problem=dataclasses.asdict(prob), **where,
            entry=None if entry is None else dataclasses.asdict(entry),
            hit=hit is not None,
            ran=None if ran is None else dataclasses.asdict(ran),
            default=dataclasses.asdict(default), source=source))
    return rows


def _same_share(a, b):
    same = total = 0
    for rid, toks in a.items():
        other = b.get(rid, [])
        total += len(toks)
        same += sum(x == y for x, y in zip(toks, other))
    return same / max(total, 1)


def phase_tune_serve(torch, serve, table_path):
    """(d) phase 4's trace at full width and depth, without a table and
    with the fleet's, in turns (untuned, tuned, tuned, untuned: the
    rates are the host's and spread between runs): every tick on the
    two kernels, each geometry's config source and table hit, the rates
    beside phase 4's and the share of tokens identical to phase 4's
    (bf16, no limit)."""
    from repro_torch import configs
    from repro_torch.core.tuning import dispatch
    from repro_torch.core.verify_engine import default_engine
    from repro_torch.models import build
    s = SERVE
    cfg = configs.get_config(s["arch"])
    model = build(cfg)
    params = model.init(s["seed"], device="cuda")
    trace = _serve_trace(cfg, s)
    table = dispatch.load(table_path)
    out = {"untuned": [], "tuned": []}
    for name in ("untuned", "tuned", "tuned", "untuned"):
        t = table if name == "tuned" else None
        dispatch.install(None)
        eng = _serve_engine(model, params, s, dispatch_table=t)
        check((dispatch.active() is not None) == (t is not None),
              f"{name}: the engine's table is not the installed one")
        before = default_engine().stats().get("solver_discharges", 0)
        run = _serve_run(torch, eng, trace, cfg, s, f"tune/{name}")
        verified = run.pop("verified")
        geoms = _geometries(eng, t)
        check(all(g["source"] != "gather" for g in geoms),
              f"{name}: a geometry fell back to the gather path: "
              f"{[g for g in geoms if g['source'] == 'gather']}")
        if t is None:
            check(len(verified) == len(set(verified)) and all(
                g["source"] == "default" for g in geoms),
                "untuned: a geometry verified twice or not at its default")
        else:
            # with a table, a geometry is verified by ``configured`` at
            # the table's config and by the op at the config it resolved:
            # the same (family, config, problem) twice on a hit, two
            # configs once each on a miss with an entry
            per_triple, per_geom = {}, {}
            for f, c, p in verified:
                per_triple[(f, c, p)] = per_triple.get((f, c, p), 0) + 1
                per_geom.setdefault((f, p), set()).add(c)
            check(max(per_triple.values()) <= 2
                  and max(len(v) for v in per_geom.values()) <= 2,
                  f"tuned: the gate verified a geometry more than the "
                  f"table's config and the op's: {per_triple}")
            run["distinct_verifies"] = len(per_triple)
        run["solver_discharges"] = (default_engine().stats().get(
            "solver_discharges", 0) - before)
        run["geometries"] = geoms
        run["table_hits"] = sum(g["hit"] for g in geoms)
        run["table_misses"] = len(geoms) - run["table_hits"]
        run["same_tokens_as_phase4"] = _same_share(run["outputs"],
                                                   serve["outputs"])
        del run["outputs"], run["gate_calls"]
        out[name].append(run)
        del eng
    dispatch.install(None)
    tu = out["tuned"][0]
    rates = lambda k, f: ", ".join(f"{r[k]:{f}}" for r in
                                   out["tuned"]) + " / " + ", ".join(
        f"{r[k]:{f}}" for r in out["untuned"])
    log("[tune/serve] tuned geometries: " + "; ".join(
        f"{g['family']} {g.get('TQ', '')}{'x' if 'TQ' in g else ''}"
        f"{g.get('TK', g.get('batch'))}: {g['source']} "
        f"{'hit' if g['hit'] else 'miss'} ran {g['ran']}"
        for g in tu["geometries"]))
    log(f"[tune/serve] table hits {tu['table_hits']}, misses "
        f"{tu['table_misses']}; gate: {tu['gate_verify_calls']} verify "
        f"calls ({tu['distinct_verifies']} distinct (family, config, "
        f"problem)), {tu['solver_discharges']} solver discharges; decode "
        f"tok/s tuned / untuned: {rates('decode_tokens_per_s', '.1f')}, "
        f"phase 4 {serve['decode_tokens_per_s']:.1f}; p50 tick ms: "
        f"{rates('p50_step_ms', '.1f')}, phase 4 "
        f"{serve['p50_step_ms']:.1f}; tokens identical to phase 4's: "
        f"{rates('same_tokens_as_phase4', '.4f')} (bf16, no limit)")
    del params
    torch.cuda.empty_cache()
    return out


def phase_tune_paths(torch):
    """Phase 5's setup (float32, depth 2, full width): the kernel path's
    problems tuned into a table of their own, then the same trace served
    with it — tokens identical to those without it."""
    from repro_torch.core.tuning import dispatch, run_fleet
    from repro_torch.serve.trace import replay
    dispatch.install(None)
    cfg, trace, engine = _paths_setup()
    gate, verified = _record_gate()
    try:
        plain = replay(engine("kernel"), trace)
    finally:
        del gate.verify
    calls = [dict(family=f, config=dataclasses.asdict(c),
                  problem=dataclasses.asdict(p)) for f, c, p in verified]
    jobs = _gate_jobs(calls)
    rep = run_fleet(jobs, out_dir=FLEET_DIR / "f32", run_kernels=True,
                    device="cuda", fresh=True, **FLEET)
    eng = engine("kernel", dispatch_table=rep.table)
    tuned = replay(eng, trace)
    geoms = _geometries(eng, rep.table)
    dispatch.install(None)
    check(tuned["outputs"] == plain["outputs"],
          "float32 tokens with the table differ from those without it")
    ct = tuned["metrics"]["counters"]
    check(ct["gather_bytes"] == 0 and ct["kernel_decode_ticks"]
          == plain["metrics"]["counters"]["kernel_decode_ticks"] > 0
          and ct["kernel_prefill_ticks"]
          == plain["metrics"]["counters"]["kernel_prefill_ticks"] > 0,
          "float32 tuned engine counters")
    hits = sum(g["hit"] for g in geoms)
    n_tok = sum(len(o) for o in tuned["outputs"].values())
    log(f"[tune/paths] {cfg.name} float32, 2 layers: {len(jobs)} jobs, "
        f"{rep.ran} items; with the table {hits} of {len(geoms)} "
        f"geometries hit, tokens identical to those without it "
        f"({len(tuned['outputs'])} requests, {n_tok} tokens)")
    return dict(jobs=len(jobs), ran=rep.ran, geometries=geoms, hits=hits,
                tokens=n_tok)


def _entry_case(torch, family, prob):
    """Inputs at an entry's exact problem: a call of the validated op at
    a config, a call of the kernel wrapper the serving model runs (the
    engine resolved and verified the config already), the plain
    version's output, and the default config.
    paged_attention: every row full with as many pages as the pool holds
    (pool - 1 pages over the rows, at most the table width); ragged
    prefill: ``n_seqs`` equal segments packed over ``total_tokens``
    (the family's packed self-attention)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[prob.dtype]
    rand = lambda *shape: torch.randn(*shape, generator=g,
                                      device="cuda").to(dt)
    if family == "paged_attention":
        from repro_torch.kernels.paged_attention import (paged_decode,
                                                         paged_decode_ref)
        from repro_torch.kernels.paged_attention.ops import default_config
        from repro_torch.kernels.paged_attention.paged_attention import \
            paged_decode as kernel
        B, PS, P, NP = (prob.batch, prob.page_size, prob.pool_pages,
                        prob.pages_per_seq)
        n = min(NP, (P - 1) // B)
        q = rand(B, prob.q_heads, 1, prob.head_dim)
        kp = rand(P, prob.kv_heads, PS, prob.head_dim)
        vp = rand(P, prob.kv_heads, PS, prob.head_dim)
        perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
        table = torch.zeros(B, NP, dtype=torch.int32, device="cuda")
        table[:, :n] = perm[:B * n].reshape(B, n).to(torch.int32)
        lens = torch.full((B,), n * PS, dtype=torch.int32, device="cuda")
        args = (q, kp, vp, table, lens)
        return (lambda c: paged_decode(*args, cfg=c),
                lambda c: kernel(*args, cfg=c),
                paged_decode_ref(*args), default_config(NP))
    from repro_torch.kernels.ragged_prefill import (ragged_prefill_attend,
                                                    ragged_prefill_ref)
    from repro_torch.kernels.ragged_prefill.ops import default_config
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill as kernel
    T, n = prob.total_tokens, prob.n_seqs
    seg = torch.arange(T, device="cuda") * n // T
    start = torch.searchsorted(seg, torch.arange(n, device="cuda"))
    pos = torch.arange(T, device="cuda") - start[seg]
    seg, pos = seg.to(torch.int32), pos.to(torch.int32)
    q = rand(prob.q_heads, T, prob.head_dim)
    k = rand(prob.kv_heads, T, prob.head_dim)
    v = rand(prob.kv_heads, T, prob.head_dim)
    args = (q, k, v, seg, pos, seg, pos)
    return (lambda c: ragged_prefill_attend(*args, cfg=c),
            lambda c: kernel(*args, cfg=c),
            ragged_prefill_ref(*args), default_config(T, T))


def phase_tune_time(torch, table_path):
    """(e) each table entry at its exact problem: the kernel at the
    table's config and at the default, each first held to the plain
    version through the validated op, then the kernel wrapper the
    serving model calls timed in turns (table, default, default, table;
    CUDA events, L2 flushed, and over 20 calls back to back) beside the
    cost model's estimate of each and the family's bound.  Nothing is
    re-ranked."""
    from repro_torch.core.families import get_family
    from repro_torch.core.tuning import dispatch
    table = dispatch.load(table_path)
    rows = []
    for family, buckets in sorted(table.entries.items()):
        fam = get_family(family)
        for bucket, e in sorted(buckets.items()):
            prob = fam.problem_cls(**e["problem"])
            call, kernel, want, default = _entry_case(torch, family, prob)
            dtype = {"bf16": "bfloat16", "f32": "float32"}[prob.dtype]
            sol = fam.sol_bound(prob)
            bms, by = bound_ms(sol.hbm_bytes, sol.flops, dtype)
            row = dict(family=family, bucket=bucket,
                       problem=dataclasses.asdict(prob), bound_ms=bms,
                       bound_by=by, sol_model_ms=sol.time_s * 1e3)
            cfgs = {"table": fam.config_cls(**e["config"]),
                    "default": default}
            for name, c in cfgs.items():
                got = call(c)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                check(err <= TOL[dtype], f"{family} {prob} at {c.name()}: "
                      f"max |kernel - plain| {err} > {TOL[dtype]}")
                row[name] = dict(cfg=dataclasses.asdict(c), name=c.name(),
                                 max_abs_err=err, runs_ms=[],
                                 back_to_back_ms=[],
                                 model_ms=fam.cost(c, prob).time_s * 1e3)
            for name in ("table", "default", "default", "table"):
                c = cfgs[name]
                row[name]["runs_ms"].append(time_ms(torch,
                                                    lambda: kernel(c)))
                row[name]["back_to_back_ms"].append(back_to_back_ms(
                    torch, lambda: kernel(c)))
            for name in cfgs:
                row[name]["ms"] = statistics.mean(row[name]["runs_ms"])
            rows.append(row)
            t, d = row["table"], row["default"]
            runs = lambda r: ", ".join(f"{x:.4f}" for x in r["runs_ms"])
            b2b = lambda r: ", ".join(f"{x:.4f}"
                                      for x in r["back_to_back_ms"])
            log(f"[tune/time] {family} {prob}: table {t['name']} "
                f"{t['ms']:.4f} ms ({runs(t)}; back to back {b2b(t)}; "
                f"model {t['model_ms']:.4f}), default {d['name']} "
                f"{d['ms']:.4f} ms ({runs(d)}; back to back {b2b(d)}; "
                f"model {d['model_ms']:.4f}); bound {bms:.4f} ms ({by}), "
                f"the family's SoL model {row['sol_model_ms']:.4f} ms; "
                f"max_abs_err {t['max_abs_err']:.3g} / "
                f"{d['max_abs_err']:.3g}")
    return rows


def phase_tune(torch, serve):
    """Phase 12: tune qwen3-1.7b's serving geometries with the fleet,
    build the table, serve through it.  The table is uninstalled at the
    end, whatever happens."""
    from repro_torch.core.tuning import dispatch
    t0 = time.perf_counter()
    try:
        out = {}
        out["fleet"], table_path = phase_tune_fleet(torch, serve)
        out["serve"] = phase_tune_serve(torch, serve, table_path)
        out["paths"] = phase_tune_paths(torch)
        out["time"] = phase_tune_time(torch, table_path)
    finally:
        dispatch.install(None)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[tune] phase wall {out['wall_s']:.1f} s")
    return out


# -- phase 13 ----------------------------------------------------------------

# (query heads, KV heads, head_dim) of the other GQA architectures: head
# dims 80 (stablelm-3b: D = 128's tiles, zero-filled past 80) and 256
# (gemma-7b: 64-key prefill tiles, 32-position decode tiles) on the bf16
# tensor-core instances, and group sizes 1 and 8 at 128 (codeqwen1.5-7b,
# chameleon-34b)
FLAVOUR_HEADS = {"stablelm-3b": (32, 32, 80), "gemma-7b": (16, 16, 256),
                 "codeqwen1.5-7b": (32, 32, 128),
                 "chameleon-34b": (64, 8, 128)}
# the serve phase's trace and engine on each of the other decoder-only
# architectures: (b) at full depth; (c) chameleon-34b at 16 of its 48
# layers (all 48 take 66.4 GB of bf16 weights and 4.3 GB of float32
# embeddings, which with the pool and a tick's activations do not fit one
# 80 GB card); (d) deepseek-v2-lite-16b at full depth, whose MLA cache
# serves on the gather paths, as in the JAX engine
SERVE_FLAVOURS = [
    dict(SERVE, arch="codeqwen1.5-7b", tag="serve-flavours/codeqwen"),
    dict(SERVE, arch="gemma-7b", tag="serve-flavours/gemma"),
    dict(SERVE, arch="stablelm-3b", tag="serve-flavours/stablelm"),
    dict(SERVE, arch="chameleon-34b", n_layers=16, profile=False,
         tag="serve-flavours/chameleon"),
    dict(SERVE, arch="deepseek-v2-lite-16b", path="gather", profile=False,
         tag="serve-flavours/deepseek"),
]


def phase_paths_dense(torch, s, moe=None):
    """deepseek-v2-lite-16b in float32 at depth 2 (its dense front layer
    and one MoE layer), full width, a drop-free capacity factor: the
    dense slot engine against the paged engine, whose ticks all take the
    gather paths (an MLA cache); identical tokens."""
    from repro_torch.serve import ServingEngine
    from repro_torch.serve.trace import replay
    cfg, trace, engine = _paths_setup(s, moe)
    paged = engine("kernel")
    res = replay(paged, trace)
    c = res["metrics"]["counters"]
    check(c["kernel_decode_ticks"] == c["kernel_prefill_ticks"] == 0
          and c["gather_bytes"] > 0, f"{cfg.name}: a paged tick did not "
          "take the gather path")
    dense = ServingEngine(paged.model, paged.params, n_slots=s["max_batch"],
                          max_len=s["max_len"], eos_id=-1, device="cuda")
    want = replay(dense, trace)["outputs"]
    check(res["outputs"] == want, f"{cfg.name} float32: the paged engine's "
          "tokens differ from the dense engine's")
    n_tok = sum(len(o) for o in want.values())
    log(f"[{s['tag']}/paths] {cfg.name} float32, 2 layers, full width, "
        f"capacity factor {cfg.moe.capacity_factor:g}: the paged engine "
        f"(gather paths) and the dense engine give identical tokens "
        f"({len(want)} requests, {n_tok} tokens)")
    return dict(requests=len(want), tokens=n_tok, compared="dense vs paged")


# the device kernels of each serving kernel's bf16 instances: the
# tensor-core (wgmma) design, the CUDA-core one
SERVING_INSTANCES = {
    "ragged_prefill": ("ragged_wgmma_kernel", "ragged_prefill_kernel"),
    "paged_decode": ("paged_decode_bf16_kernel", "paged_decode_f32_kernel")}


def _window_instances(profile, tag):
    """Each serving kernel's device time in a bf16 architecture's profiled
    windows (phase 4's profile), by instance; fails if a tick ran a
    CUDA-core instance or none at all (every bf16 head_dim of a full-size
    architecture has a tensor-core one).  "not measured" where the
    profiler recorded no device event."""
    windows = {"ragged_prefill": profile["prefill_tick"],
               "paged_decode": profile["decode_ticks_6"]}
    out = {}
    for name, w in windows.items():
        ours = w["port_kernels_ms"]
        if not ours:
            out[name] = "not measured"
            continue
        tc, cc = SERVING_INSTANCES[name]
        check(ours.get(tc, 0.0) > 0 and cc not in ours,
              f"{tag}: {name}'s window ran {sorted(ours)}, not its "
              f"tensor-core instance alone")
        out[name] = {tc: ours[tc]}
        log(f"[{tag}/profile] {name}: {tc} {ours[tc]:.3f} ms of device "
            f"time in the window, no CUDA-core launch")
    return out


def phase_serve_flavours(torch):
    """(a) both serving kernels against their plain versions at each
    architecture's heads (FLAVOUR_HEADS), bf16 and float32, 16-token
    pages, with phase 3's poisoned pages and zero-length row, each case
    naming its instance, timed beside its bound (and, for ragged
    prefill, one SDPA call); (b)-(d) the serve phase on each of
    SERVE_FLAVOURS, the launch counters zeroed just before and read just
    after each run; (e) phase 5 for each at depth 2 in float32 (for
    deepseek-v2-lite-16b, the dense engine against the paged one)."""
    from repro_torch import configs
    kern = {}
    for arch, heads in FLAVOUR_HEADS.items():
        for dtype in ("bfloat16", "float32"):
            kern[f"{arch}/paged_decode/{dtype}"] = phase_decode_kernel(
                torch, dtype, heads=heads)
            kern[f"{arch}/ragged_prefill/{dtype}"] = phase_prefill_kernel(
                torch, dtype, heads=heads)
    serve, paths = {}, {}
    for s in SERVE_FLAVOURS:
        out = phase_serve(torch, s)
        serve[s["arch"]] = out
        if s["arch"] in FLAVOUR_HEADS and s.get("profile", True):
            out["profile_instances"] = _window_instances(out["profile"],
                                                         s["tag"])
        log(f"[{s['tag']}] {out['arch']} at {out['n_layers']} layers: "
            f"decode {out['decode_tokens_per_s']:.1f} tok/s, p50 tick "
            f"{out['p50_step_ms']:.1f} ms, {out['gate_verify_calls']} gate "
            f"calls; ticks on the kernels: {out['prefill_ticks']} prefill "
            f"and {out['decode_ticks']} decode "
            f"({'none' if s.get('path') == 'gather' else 'all'}), on the "
            f"gather paths: "
            f"{'all' if s.get('path') == 'gather' else 'none'}")
    for s in SERVE_FLAVOURS:
        cfg = configs.get_config(s["arch"])
        if cfg.attn_type == "mla":
            m = cfg.moe
            paths[s["arch"]] = phase_paths_dense(
                torch, s, moe=dict(capacity_factor=m.n_experts / m.top_k))
        else:
            paths[s["arch"]] = phase_paths(torch, s)
    return dict(kernels=kern, serve=serve, paths=paths)


# -- phase 14 ----------------------------------------------------------------

# (a) recurrentgemma-2b: 2 rows of 4,096 tokens, past its 2,048-token
# window, so the window mask and the KV-block scan (1,024 or more query
# tokens) both shape the output
HYBRID_TOKENS = (2, 4096)
# (b) its float32 replay at depth 3, one (rec, rec, attn) group: past the
# window the ring is full, so the reference's position-0 slots no longer
# enter (ROADMAP section C), and with attention last no diluted output
# feeds a recurrence
HYBRID_REPLAY = 2100
# (d) seamless-m4t-large-v2: rows of seeded-normal frame embeddings (the
# JAX package's frontend stub), teacher-forced tokens, greedy decode
# ticks; the float32 replay at 2 + 2 layers over ``replay`` tokens
SEAMLESS = dict(rows=4, frames=1024, tokens=256, ticks=32, replay=64)
# seamless's float32 replay tolerance, of each logit and of the largest:
# at full width the seeded init's attention is peaked (q and k entries of
# tens, near-ties between keys), so the float32 rounding of the decode
# path's one-row matmuls and the teacher-forced path's 64-row ones grows
# with the steps to ~2e-3 of that sum; a wrong mask or position moves
# logits by their own size
SEAMLESS_REPLAY_REL = 5e-3


def _events_ms(torch, fn):
    """(fn's result, host wall ms, ms between two CUDA events around it)
    of one synchronised call."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, s.elapsed_time(e)


def _prof_line(prof):
    """One log fragment of a ``_profile`` window."""
    if prof["busy_share"] is None:
        return "device time not measured (the profiler saw no kernel)"
    return (f"profiled {prof['wall_ms']:.1f} ms wall, device "
            f"{prof['device_ms']:.1f} ms (busy {prof['busy_share']:.3f}), "
            f"{prof['device_launches']} device kernels; top: " + "; ".join(
                f"{k[:48]} {v:.2f}" for k, v in prof["top_kernels_ms"][:5]))


def _init(torch, model, seed):
    t0 = time.perf_counter()
    params = model.init(seed, device="cuda")
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def _hybrid_forward(torch, model, params):
    """(a) one bf16 forward over HYBRID_TOKENS at full width and depth."""
    cfg = model.cfg
    B, S = HYBRID_TOKENS
    g = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(2, cfg.vocab, (B, S), generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    logits, wall0, dev0 = _events_ms(torch, lambda: model.apply(params,
                                                                toks)[0])
    check(tuple(logits.shape) == (B, S, cfg.padded_vocab),
          f"recurrentgemma logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "recurrentgemma: non-finite logits")
    del logits
    runs = [_events_ms(torch, lambda: model.apply(params, toks)[0])[1:]
            for _ in range(2)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile(torch, lambda: model.apply(params, toks))
    out = dict(tokens=[B, S], first_wall_ms=wall0, first_device_ms=dev0,
               wall_ms=min(w for w, _ in runs),
               device_ms=min(d for _, d in runs), runs_ms=runs,
               peak_gb=peak, profile=prof)
    log(f"[hybrid] {cfg.name} apply over {B} x {S} tokens ({cfg.n_layers} "
        f"layers, bf16, window {cfg.recurrent.window}, the KV-block scan): "
        f"{out['wall_ms']:.1f} ms wall, {out['device_ms']:.1f} ms between "
        f"CUDA events (runs " + ", ".join(f"{w:.1f}/{d:.1f}"
                                          for w, d in runs)
        + f"; first call {wall0:.1f}/{dev0:.1f}), finite logits, peak "
        f"memory {peak:.2f} GB; " + _prof_line(prof))
    return out


def _hybrid_serve(torch, model, params):
    """(c) phase 4's trace through the dense ServingEngine, then 6
    profiled decode ticks of 8 rows."""
    import numpy as np
    from repro_torch.serve import ServingEngine
    cfg, s = model.cfg, SERVE
    eng = ServingEngine(model, params, n_slots=s["max_batch"],
                        max_len=s["max_len"], eos_id=-1, device="cuda")
    trace = _serve_trace(cfg, s)
    pending = sorted(trace, key=lambda a: (a.tick, a.rid))
    c, ticks, t = eng.metrics.counters, [], 0
    t0 = time.perf_counter()
    while True:
        while pending and pending[0].tick <= t:
            eng.submit(pending.pop(0).request())
        dec = c["decode_tokens"]
        t1 = time.perf_counter()
        eng.step()
        ticks.append(((time.perf_counter() - t1) * 1e3,
                      c["decode_tokens"] - dec))
        if not pending and not eng.queue and all(
                sl.req is None for sl in eng.slots):
            break
        t += 1
        check(t < 10_000, "serving did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = eng.finished
    check(len(done) == s["requests"], f"{len(done)} of {s['requests']} "
          "requests finished")
    by_rid = {a.rid: a for a in trace}
    for r in done:
        check(len(r.output) == by_rid[r.rid].max_new_tokens
              and all(0 <= x < cfg.vocab for x in r.output),
              f"rid {r.rid}: {len(r.output)} tokens or one outside the "
              "vocabulary")
    out = dict(requests=len(done), ticks=len(ticks),
               prefill_tokens=c["prefill_tokens"],
               decode_tokens=c["decode_tokens"], wall_s=wall,
               decode_tokens_per_s=c["decode_tokens"] / wall,
               p50_step_ms=statistics.median(ms for ms, _ in ticks),
               p50_decode_only_step_ms=statistics.median(
                   [ms for ms, n in ticks if n] or [0.0]))
    # where a decode tick's time goes: 8 fresh rows admitted, then 6
    # decode-only ticks under the profiler
    from repro_torch.serve import Request
    rng = np.random.default_rng(5)
    for rid in range(s["max_batch"]):
        eng.submit(Request(1000 + rid, rng.integers(
            2, cfg.vocab, size=64).tolist(), max_new_tokens=16))
    eng.step()
    out["profile"] = prof = _profile_window(torch, eng, 6)
    log(f"[hybrid/serve] {cfg.name} on the dense ServingEngine "
        f"({s['max_batch']} slots, max_len {s['max_len']}), phase 4's "
        f"trace: {out['requests']} requests, {out['ticks']} ticks, "
        f"{out['prefill_tokens']} prompt + {out['decode_tokens']} generated "
        f"tokens in {wall:.2f} s: decode "
        f"{out['decode_tokens_per_s']:.1f} tok/s, p50 tick "
        f"{out['p50_step_ms']:.1f} ms — decodes from the zeroed state, as "
        "the JAX engine does (ROADMAP C); 6 decode ticks of 8 rows: "
        + _prof_line(prof))
    return out


def _hybrid_replay(torch):
    """(b) float32, depth 3, full width: a stepwise replay of
    HYBRID_REPLAY tokens against the forward's last position, and
    ``rglru_scan`` at the full width over 4,096 steps against a
    sequential float32 loop."""
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.models.recurrent import C_EXP, rglru_scan
    cfg = dataclasses.replace(configs.get_config("recurrentgemma-2b"),
                              n_layers=3, dtype="float32")
    model = build(cfg)
    params, _ = _init(torch, model, 1)
    g = torch.Generator(device="cuda").manual_seed(1)
    S, V = HYBRID_REPLAY, cfg.vocab
    toks = torch.randint(2, V, (1, S), generator=g, device="cuda")
    want = model.apply(params, toks, last_only=True)[0][0, 0, :V]
    cache = model.init_cache(1, S, device="cuda")
    t0 = time.perf_counter()
    for t in range(S):
        step, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    err, _ = _replay_check(torch, step[0, 0, :V], want,
                           f"recurrentgemma depth 3 float32, position "
                           f"{S - 1}")
    del params, cache
    torch.cuda.empty_cache()

    W, T = cfg.recurrent.lru_width, 4096
    lam = torch.randn(W, generator=g, device="cuda")
    r = torch.rand(2, T, W, generator=g, device="cuda")
    a = torch.exp(C_EXP * r * F.logsigmoid(lam))
    bx = torch.sqrt(1 - a * a) * torch.randn(2, T, W, generator=g,
                                             device="cuda")
    h = rglru_scan(a, bx)
    ref = torch.empty_like(bx)
    hc = torch.zeros(2, W, device="cuda")
    for t in range(T):
        hc = a[:, t] * hc + bx[:, t]
        ref[:, t] = hc
    d = (h - ref).abs()
    scan_err = float(d.max())
    check(bool((d <= 1e-5 * ref.abs() + 1e-5 * float(ref.abs().max()))
               .all()), f"rglru_scan at W {W}, S {T}: max |scan - loop| "
          f"{scan_err} beyond 1e-5")
    ms = time_ms(torch, lambda: rglru_scan(a, bx), iters=5)
    bms, by = bound_ms(3 * a.numel() * 4, 2 * a.numel(), "float32")
    log(f"[hybrid/f32] depth 3 (rec, rec, attn), full width, float32: "
        f"{S} decode_step tokens ({replay_s:.1f} s) against apply's last "
        f"position, max |step - full| {err:.3g} (largest |logit| "
        f"{float(want.abs().max()):.3g}; within 1e-4 of each plus 1e-4 of "
        f"the largest); rglru_scan at 2 x {T} x {W} against a sequential "
        f"float32 loop max abs {scan_err:.3g}, {ms:.3f} ms (bound {bms:.3f} "
        f"ms, {by})")
    return dict(replay_tokens=S, replay_max_abs=err, replay_s=replay_s,
                scan_max_abs=scan_err, scan_ms=ms, scan_bound_ms=bms)


def _seamless(torch):
    """(d) seamless-m4t-large-v2 at full width and depth in bf16: encode,
    a teacher-forced apply, prefill and greedy decode ticks; then at
    2 + 2 layers in float32 a stepwise replay against ``apply``."""
    from repro_torch import configs
    from repro_torch.models import build
    cfg = configs.get_config("seamless-m4t-large-v2")
    model = build(cfg)
    params, init_s = _init(torch, model, 0)
    R, Fr, S, T = (SEAMLESS[k] for k in ("rows", "frames", "tokens",
                                          "ticks"))
    V = cfg.vocab
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randn(R, Fr, cfg.d_model, generator=g,
                         device="cuda").to(torch.bfloat16)
    toks = torch.randint(2, V, (R, S), generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    enc = model.encode(params, frames)
    check(tuple(enc.shape) == (R, Fr, cfg.d_model)
          and bool(torch.isfinite(enc).all()), "seamless: encoder output")
    logits = model.apply(params, toks, enc_embeds=frames)[0]
    check(tuple(logits.shape) == (R, S, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :V]).all()),
          f"seamless: logits {tuple(logits.shape)} or non-finite")
    del enc, logits
    # timed after the checked first calls, which pay the library warm-up
    _, enc_wall, enc_dev = _events_ms(torch, lambda: model.encode(
        params, frames))
    _, app_wall, app_dev = _events_ms(torch, lambda: model.apply(
        params, toks, enc_embeds=frames)[0])
    cache, pre_wall, pre_dev = _events_ms(torch, lambda: model.prefill(
        params, frames, T))
    tok, out_toks = toks[:, :1], []
    t0 = time.perf_counter()
    for i in range(T):
        step, cache = model.decode_step(params, cache, tok, i)
        tok = step[:, -1, :V].argmax(-1, keepdim=True)
        out_toks.append(tok)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    gen = torch.cat(out_toks, 1)
    check(bool(((gen >= 0) & (gen < V)).all()), "seamless: a token outside "
          "the vocabulary")
    peak = torch.cuda.max_memory_allocated() / 1e9
    cache = model.prefill(params, frames, 6)

    def ticks():
        tok = toks[:, :1]
        for i in range(6):
            step, _ = model.decode_step(params, cache, tok, i)
            tok = step[:, -1, :V].argmax(-1, keepdim=True)
    prof = _profile(torch, ticks)
    out = dict(n_params=model.n_params, init_s=init_s, rows=R, frames=Fr,
               tokens=S, encode_wall_ms=enc_wall, encode_device_ms=enc_dev,
               apply_wall_ms=app_wall, apply_device_ms=app_dev,
               prefill_wall_ms=pre_wall, prefill_device_ms=pre_dev,
               decode_ticks=T, decode_s=dec_s,
               decode_tokens_per_s=R * T / dec_s, peak_gb=peak,
               profile=prof)
    log(f"[seamless] {cfg.name}: {cfg.enc_layers} + {cfg.n_layers} layers, "
        f"{model.n_params / 1e9:.3f} B params, init {init_s:.1f} s; bf16 "
        f"encode of {R} x {Fr} frame embeddings {enc_wall:.1f} ms wall "
        f"({enc_dev:.1f} between CUDA events), teacher-forced apply over "
        f"{R} x {S} tokens {app_wall:.1f} ms ({app_dev:.1f}), prefill "
        f"(encode + cross K/V) {pre_wall:.1f} ms ({pre_dev:.1f}); {T} greedy "
        f"decode_step ticks over {R} rows in {dec_s:.2f} s: "
        f"{out['decode_tokens_per_s']:.1f} tok/s; finite, peak memory "
        f"{peak:.2f} GB; 6 decode ticks: " + _prof_line(prof))
    del params, cache
    torch.cuda.empty_cache()

    n = SEAMLESS["replay"]
    cfg2 = dataclasses.replace(cfg, n_layers=2, enc_layers=2,
                               dtype="float32")
    m2 = build(cfg2)
    p2, _ = _init(torch, m2, 1)
    fr2, t2 = frames.float(), toks[:, :n]
    full = m2.apply(p2, t2, enc_embeds=fr2)[0][..., :V]
    cache = m2.prefill(p2, fr2, n)
    errs = []
    for t in range(n):
        step, cache = m2.decode_step(p2, cache, t2[:, t:t + 1], t)
        errs.append(_replay_check(
            torch, step[:, 0, :V], full[:, t],
            f"seamless 2 + 2 layers float32, decode step {t}",
            rel=SEAMLESS_REPLAY_REL))
    worst = max(e for e, _ in errs)
    share = max(r for _, r in errs)
    log(f"[seamless/f32] 2 + 2 layers, full width, float32: {n} teacher "
        f"tokens through decode_step against apply, max |step - full| "
        f"{worst:.3g}, at most {share:.3g} of (|logit| + the largest) "
        f"(limit {SEAMLESS_REPLAY_REL:g}); by step: "
        + ", ".join(f"{e:.2g}" for e, _ in errs[::8]))
    out.update(replay_max_abs=worst, replay_share=share,
               replay_by_step=[e for e, _ in errs])
    return out


def phase_hybrid_encdec(torch):
    """Phase 14: (a)-(c) recurrentgemma-2b, (d) seamless-m4t-large-v2;
    (e) every launch counter zeroed before (a) and read after (d): these
    paths reach no kernel (in the JAX package neither)."""
    import gc
    from repro_torch import configs
    from repro_torch.kernels import ALL_KERNELS
    from repro_torch.models import build
    t0 = time.perf_counter()
    for k in ALL_KERNELS:
        k.launches = 0
    cfg = configs.get_config("recurrentgemma-2b")
    model = build(cfg)
    params, init_s = _init(torch, model, 0)
    weights_gb = sum(p.numel() * p.element_size() for k, v in params.items()
                     if k != "embed" for p in _leaves(v)) / 1e9
    log(f"[hybrid] {cfg.name}: {cfg.n_layers} layers, "
        f"{model.n_params / 1e9:.3f} B params (layers {weights_gb:.2f} GB "
        f"bf16, embedding {sum(p.numel() for p in _leaves(params['embed'])) * 4 / 1e9:.2f} GB f32), init {init_s:.1f} s")
    out = dict(n_params=model.n_params, init_s=init_s,
               weights_gb=weights_gb)
    out["forward"] = _hybrid_forward(torch, model, params)
    out["serve"] = _hybrid_serve(torch, model, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["f32"] = _hybrid_replay(torch)
    out["seamless"] = _seamless(torch)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k.name: k.launches for k in ALL_KERNELS}
    check(not any(launches.values()), f"phase 14 launched a kernel: "
          f"{launches}")
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    log(f"[hybrid] no kernel launched in (a)-(d) ({launches}); phase wall "
        f"{out['wall_s']:.1f} s")
    return out


# -- phase 15: train -----------------------------------------------------------

# (a) qwen3-1.7b at full width and depth: batch x seq, steps with
# grad_accum 1 then with grad_accum 2
TRAIN = dict(arch="qwen3-1.7b", batch=8, seq=1024, steps=5, accum_steps=2,
             seed=0, peak_lr=3e-4)
# kernel kinds of a training step's profile, by name: cuBLAS's float32
# GEMMs (the float32 unembed and sdpa's float32 score and P.V products,
# TF32 off), its other GEMMs (the bf16 layers), then the rest
TRAIN_KINDS = (
    ("float32 GEMM", lambda k: "f32f32" in k or "sgemm" in k),
    ("bf16 GEMM", lambda k: any(w in k for w in ("gemm", "nvjet", "xmma",
                                                 "cutlass"))),
    ("softmax", lambda k: "softmax" in k.lower()),
    ("reduction", lambda k: "reduce" in k.lower()),
    ("index and scatter", lambda k: any(w in k.lower() for w in (
        "index", "scatter", "gather"))),
    ("copy and cast", lambda k: "copy" in k.lower()),
    ("elementwise", lambda k: "elementwise" in k.lower()),
)
# (b) the card's float32 step and the port's float32 CPU step, each held
# to the port's CPU step computed in float64 on the same weights and batch
# (full width, depth 2): the loss within 1e-5 of the reference's, each
# gradient leaf within 1e-4 of the reference leaf's largest |value|.  Two
# float32 evaluations that each keep that bound differ by at most twice
# it; their difference is logged.  tools/train_hold_probe.py measures how
# far float32 rounding alone moves these gradients.
TRAIN_HOLD = dict(layers=2, batch=2, seq=128, loss_rel=1e-5, grad_rel=1e-4)
# (c) resume at depth 2, bf16, deterministic algorithms: bit-identical
TRAIN_RESUME = dict(layers=2, batch=2, seq=128, steps=6, split=3)
# (d) examples/quickstart_torch.py's run: reduced qwen3, 200 steps, 8 x 128
QUICKSTART = dict(steps=200, batch=8, seq=128, min_drop=0.3)


def _train_batch(torch, ds):
    return {k: torch.from_numpy(v).to("cuda") for k, v in next(ds).items()}


def _train_full(torch):
    """(a) qwen3-1.7b at full width and depth, seed-0 weights, the
    synthetic data pipeline: ``TRAIN['steps']`` steps with grad_accum 1,
    then ``TRAIN['accum_steps']`` with grad_accum 2; each step's loss,
    gradient norm, rate, time between CUDA events, tokens/s and the peak
    memory; then one more grad_accum-1 step under the profiler."""
    import gc
    import math
    from repro_torch import configs
    from repro_torch.data import make_dataset
    from repro_torch.models import build
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.train import make_train_step
    t = TRAIN
    cfg = configs.get_config(t["arch"])
    model = build(cfg)
    params, init_s = _init(torch, model, t["seed"])
    opt = adamw_init(params)
    ds = make_dataset(cfg, seq_len=t["seq"], global_batch=t["batch"],
                      seed=t["seed"])
    lr_fn = lambda s: cosine_schedule(s, peak_lr=t["peak_lr"], warmup=20,
                                      total=100)
    steps = {1: make_train_step(model, lr_fn=lr_fn),
             2: make_train_step(model, lr_fn=lr_fn, grad_accum=2)}
    tokens = t["batch"] * t["seq"]
    rows = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(t["steps"] + t["accum_steps"]):
        accum = 1 if i < t["steps"] else 2
        batch = _train_batch(torch, ds)
        (params, opt, met), wall, dev = _events_ms(
            torch, lambda: steps[accum](params, opt, batch))
        row = dict(step=i, grad_accum=accum, wall_ms=wall, device_ms=dev,
                   tokens_per_s=tokens / (dev / 1e3),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   **{k: float(v) for k, v in met.items()})
        check(all(math.isfinite(row[k]) for k in
                  ("loss", "ce", "aux", "gnorm", "lr")),
              f"train step {i}: a metric is not finite: {row}")
        rows.append(row)
        log(f"[train] {cfg.name} step {i} (grad_accum {accum}, "
            f"{t['batch']} x {t['seq']}): loss {row['loss']:.4f} gnorm "
            f"{row['gnorm']:.3f} lr {row['lr']:.3e}; {dev:.1f} ms between "
            f"CUDA events ({wall:.1f} wall), {row['tokens_per_s']:.0f} "
            f"tokens/s, peak {row['peak_gb']:.2f} GB")
    batch = _train_batch(torch, ds)
    box = {}

    def profiled():
        box["out"] = steps[1](params, opt, batch)
    prof = _profile(torch, profiled, kinds=TRAIN_KINDS)
    params, opt, _ = box.pop("out")
    log(f"[train] one profiled step: " + _prof_line(prof) + "; by kind: "
        + "; ".join(f"{k} {v:.1f}" for k, v in prof.get(
            "by_kind_ms", {}).items()))
    # the optimizer alone, on the full state (zero gradients)
    from repro_torch.optim import adamw_update, tree_map
    zeros = tree_map(torch.zeros_like, params)
    _, _, adamw_ms = _events_ms(torch, lambda: adamw_update(
        zeros, opt, params, lr=lr_fn(opt.step)))
    del zeros
    log(f"[train] adamw_update over {model.n_params / 1e9:.2f} B params: "
        f"{adamw_ms:.1f} ms between CUDA events")
    out = dict(arch=cfg.name, n_params=model.n_params, init_s=init_s,
               batch=t["batch"], seq=t["seq"], steps=rows, profile=prof,
               peak_gb=max(r["peak_gb"] for r in rows), adamw_ms=adamw_ms)
    del params, opt, steps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaf_items(tree, prefix=""):
    """(path, leaf) of nested dicts in ``tree_leaves``' sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], f"{prefix}/{k}" if prefix
                                   else str(k))
    else:
        yield prefix, tree


@contextlib.contextmanager
def _float64_models(torch):
    """The port's model code computes in float64 where it names float32
    (``F32`` and ``dtype_of("float32")`` of every ``repro_torch.models``
    module), for a reference of the float32 model's function."""
    import importlib
    import pkgutil
    import repro_torch.models as pkg
    saved = []
    for info in pkgutil.iter_modules(pkg.__path__):
        m = importlib.import_module(f"{pkg.__name__}.{info.name}")
        if getattr(m, "F32", None) is torch.float32:
            saved.append((m, "F32", m.F32))
            m.F32 = torch.float64
        if hasattr(m, "dtype_of"):
            saved.append((m, "dtype_of", m.dtype_of))
            m.dtype_of = (lambda name, f=m.dtype_of: torch.float64
                          if name == "float32" else f(name))
    try:
        yield
    finally:
        for m, attr, v in saved:
            setattr(m, attr, v)


def _leaf_items(tree, prefix=""):
    """(path, leaf) of nested dicts in ``tree_leaves``' sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], f"{prefix}/{k}" if prefix
                                   else str(k))
    else:
        yield prefix, tree


def _train_hold(torch):
    """(b) the card's float32 loss and gradients, and the port's float32
    CPU step's, against the port's CPU step in float64 on the same
    weights (initialised on the CPU in float32, copied over) and the same
    batch, full width at depth 2."""
    from repro_torch import configs
    from repro_torch.data import make_dataset
    from repro_torch.models import build
    from repro_torch.optim import tree_map
    from repro_torch.train import value_and_grad
    h = TRAIN_HOLD
    cfg = dataclasses.replace(configs.get_config(TRAIN["arch"]),
                              n_layers=h["layers"], dtype="float32")
    model = build(cfg)
    cpu = model.init(TRAIN["seed"], device="cpu")
    b = next(make_dataset(cfg, seq_len=h["seq"], global_batch=h["batch"],
                          seed=TRAIN["seed"]))

    def step(params, device):
        loss, _, g = value_and_grad(model, params, {
            k: torch.from_numpy(v).to(device) for k, v in b.items()})
        return float(loss), {k: v.detach().cpu().double()
                             for k, v in _leaf_items(g)}
    t0 = time.perf_counter()
    runs = {"cpu": step(cpu, "cpu")}
    cpu_s = time.perf_counter() - t0
    with _float64_models(torch):
        runs["float64"] = step(tree_map(lambda x: x.double(), cpu), "cpu")
    for name in ("card", "card again"):
        runs[name] = step(tree_map(lambda x: x.to("cuda"), cpu), "cuda")
    ref_loss, ref = runs["float64"]
    scale = {k: float(v.abs().max()) or 1.0 for k, v in ref.items()}

    def off(a, b):
        """(loss rel, {leaf: max |a - b| / the reference leaf's largest})"""
        (la, ga), (lb, gb) = runs[a], runs[b]
        return abs(la - lb) / abs(ref_loss), {
            k: float((ga[k] - gb[k]).abs().max()) / scale[k] for k in ref}

    def worst(errs, n=3):
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:n]
        return ", ".join(f"{k} {v:.2e}" for k, v in top)
    out = dict(cpu_s=cpu_s, n_leaves=len(ref), loss_float64=ref_loss,
               loss_card=runs["card"][0], loss_cpu=runs["cpu"][0])
    for a, b_ in (("card", "float64"), ("cpu", "float64"), ("card", "cpu")):
        loss_rel, errs = off(a, b_)
        out[f"{a} vs {b_}"] = dict(loss_rel=loss_rel, grad_rel=errs,
                                   grad_worst_rel=max(errs.values()))
        log(f"[train] hold, float32, {h['layers']} layers at full width, "
            f"{h['batch']} x {h['seq']}, {a} against {b_}: loss rel "
            f"{loss_rel:.2e}; gradient leaves off by, of their largest: "
            f"{worst(errs)}")
    again = all(torch.equal(runs["card"][1][k], runs["card again"][1][k])
                for k in ref)
    out["card_repeat_identical"] = again
    log(f"[train] hold: loss float64 {ref_loss:.6f} card "
        f"{runs['card'][0]:.6f} cpu {runs['cpu'][0]:.6f}; bounds "
        f"{h['loss_rel']} (loss) and {h['grad_rel']} (gradients) against "
        f"float64; the card's second step bit-identical: {again}; CPU step "
        f"{cpu_s:.1f} s")
    for a in ("card", "cpu"):
        r = out[f"{a} vs float64"]
        check(r["loss_rel"] <= h["loss_rel"],
              f"train hold: the {a}'s loss off by {r['loss_rel']}")
        check(r["grad_worst_rel"] <= h["grad_rel"],
              f"train hold: the {a}'s gradient leaves off by, of their "
              f"largest: {worst(r['grad_rel'])} (the card against the "
              f"float32 CPU step: {worst(out['card vs cpu']['grad_rel'])})")
    return out


def _train_resume(torch, scratch):
    """(c) at depth 2 in bf16 under deterministic algorithms: 6 steps
    uninterrupted against 3 steps, a checkpoint (params, optimizer and
    data state; the async writer), a restore into fresh tensors and 3
    more steps.  The losses and every parameter and moment must be
    bit-identical: the float32 scatter-add of the embedding's gradient
    and the gather of the target logits take their deterministic
    kernels."""
    import shutil
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import make_dataset
    from repro_torch.models import build
    from repro_torch.optim import adamw_init, cosine_schedule, tree_leaves
    from repro_torch.train import make_train_step
    r = TRAIN_RESUME
    cfg = dataclasses.replace(configs.get_config(TRAIN["arch"]),
                              n_layers=r["layers"])
    model = build(cfg)
    step = make_train_step(model, lr_fn=lambda s: cosine_schedule(
        s, peak_lr=1e-3, warmup=2, total=10))
    fresh = lambda: model.init(TRAIN["seed"], device="cuda")
    data = lambda: make_dataset(cfg, seq_len=r["seq"],
                                global_batch=r["batch"], seed=1)
    ck = scratch / "train_resume"
    shutil.rmtree(ck, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    try:
        p, ds = fresh(), data()
        o = adamw_init(p)
        whole = []
        for _ in range(r["steps"]):
            p, o, m = step(p, o, _train_batch(torch, ds))
            whole.append(float(m["loss"]))
        ref = (p, o)
        p, ds = fresh(), data()
        o = adamw_init(p)
        part = []
        for _ in range(r["split"]):
            p, o, m = step(p, o, _train_batch(torch, ds))
            part.append(float(m["loss"]))
        mgr = CheckpointManager(ck, keep=2)
        mgr.save(r["split"], {"params": p, "opt": o, "data": ds.state(),
                              "meta": {"step": r["split"]}})
        mgr.wait()
        p2 = fresh()
        state = mgr.restore({"params": p2, "opt": adamw_init(p2),
                             "data": data().state()}, device="cuda")
        p, o, ds = state["params"], state["opt"], data()
        ds.restore({k: int(v) for k, v in state["data"].items()})
        for _ in range(r["steps"] - r["split"]):
            p, o, m = step(p, o, _train_batch(torch, ds))
            part.append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(p) + tree_leaves(o.mu) + tree_leaves(o.nu),
        tree_leaves(ref[0]) + tree_leaves(ref[1].mu)
        + tree_leaves(ref[1].nu)))
    log(f"[train] resume, bf16, {r['layers']} layers at full width: "
        f"uninterrupted losses {[round(x, 6) for x in whole]}, resumed "
        f"{[round(x, 6) for x in part]}; params and moments identical: "
        f"{same}")
    check(part == whole, "train resume: losses differ")
    check(same, "train resume: params or moments differ")
    check(int(o.step) == r["steps"], f"train resume: step {int(o.step)}")
    shutil.rmtree(ck, ignore_errors=True)
    return dict(whole=whole, resumed=part, identical=same,
                deterministic=True)


def _train_quickstart(torch, scratch):
    """(d) examples/quickstart_torch.py's run through the launcher: the
    loss must drop by more than ``QUICKSTART['min_drop']``."""
    import contextlib
    import io
    import shutil
    from repro_torch.launch import train as train_mod
    q = QUICKSTART
    ck = scratch / "train_quickstart"
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        losses = train_mod.main([
            "--arch", TRAIN["arch"], "--reduced", "--steps", str(q["steps"]),
            "--batch", str(q["batch"]), "--seq", str(q["seq"]),
            "--ckpt-dir", str(ck), "--ckpt-every", "100",
            "--device", "cuda"])
    wall = time.perf_counter() - t0
    drop = losses[0] - losses[-1]
    log(f"[train] quickstart (reduced {TRAIN['arch']}, {q['steps']} steps "
        f"of {q['batch']} x {q['seq']}): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (drop {drop:.3f}), {wall:.1f} s "
        f"({wall / q['steps'] * 1e3:.1f} ms a step with the launcher's "
        f"logging and two checkpoints); launcher: "
        + buf.getvalue().strip().splitlines()[-1])
    check(drop > q["min_drop"], f"quickstart: the loss dropped {drop}")
    shutil.rmtree(ck, ignore_errors=True)
    return dict(first=losses[0], last=losses[-1], drop=drop, wall_s=wall)


def phase_train(torch):
    """Phase 15: (a) qwen3-1.7b trained at full width and depth; (b) the
    card's gradients held to the CPU step; (c) resume; (d) the
    quickstart; (e) every launch counter zeroed before (a) and read after
    (d): the training path reaches no kernel (in the JAX package
    neither)."""
    from repro_torch.kernels import ALL_KERNELS
    # checkpoints go beside the built kernels (gitignored), and are
    # removed when their check has passed
    scratch = ROOT / "build" / "train"
    scratch.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for k in ALL_KERNELS:
        k.launches = 0
    out = dict(full=_train_full(torch))
    out["hold"] = _train_hold(torch)
    out["resume"] = _train_resume(torch, scratch)
    out["quickstart"] = _train_quickstart(torch, scratch)
    launches = {k.name: k.launches for k in ALL_KERNELS}
    check(not any(launches.values()), f"phase 15 launched a kernel: "
          f"{launches}")
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    log(f"[train] no kernel launched in (a)-(d) ({launches}); phase wall "
        f"{out['wall_s']:.1f} s")
    return out


# -- phase 16: distribution and the dry-run -----------------------------------

# (a) the launcher under torch.distributed.run at one rank (NCCL, mesh
# (1, 1)) on phase 15's model and batch; the unsharded run is the same
# launcher in one process.  Bounds: phase 15(b)'s (each loss within 1e-5
# of the unsharded one, each parameter leaf within 1e-4 of its largest
# |value|; bit-identical is expected).  (b) the dry-run's peak within 10%
# of (a)'s max_memory_allocated, its FLOPs equal to (a)'s step counted by
# the same counter.  (c) qwen3-1.7b's production-mesh cells.
DIST = dict(arch="qwen3-1.7b", batch=8, seq=1024, steps=3, loss_rel=1e-5,
            param_rel=1e-4, peak_rel=0.10)
DIST_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
CARD_BYTES = 80e9


def _dist_args(lt, ck):
    d = DIST
    return lt.parse_args(["--arch", d["arch"], "--batch", str(d["batch"]),
                          "--seq", str(d["seq"]), "--steps",
                          str(d["steps"]), "--log-every", "1",
                          "--ckpt-every", str(10 ** 9), "--ckpt-dir", ck])


def _launches():
    from repro_torch.kernels import ALL_KERNELS
    return {k.name: k.launches for k in ALL_KERNELS}


def dist_train_child(out_path):
    """Phase 16(a), one rank of ``torch.distributed.run``: the unsharded
    launcher run (WORLD_SIZE hidden from it), then the distributed one,
    then one more step of the distributed run under the dry-run's
    counter."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ALL_KERNELS
    from repro_torch.launch import trace_analysis, train as lt
    from repro_torch.parallel import full_tensor
    for k in ALL_KERNELS:
        k.launches = 0
    args = _dist_args(lt, str(ROOT / "build" / "dist" / "ck"))
    hidden = os.environ.pop("WORLD_SIZE")
    ref = lt.run(args)
    os.environ["WORLD_SIZE"] = hidden
    ref_params = {p: t.detach().cpu() for p, t in _leaf_items(ref.params)}
    out = dict(ref_losses=ref.losses, ref_step_ms=ref.step_ms,
               ref_peak_bytes=ref.peak_bytes)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    run = lt.run(args)
    full = dict(_leaf_items(full_tensor(run.params)))
    diffs = {}
    for p, want in ref_params.items():
        got = full[p].detach().cpu()
        diffs[p] = dict(
            max_abs=float((got.float() - want.float()).abs().max()),
            scale=float(want.float().abs().max()),
            identical=bool(torch.equal(got, want)))
    del full
    batch = run.put_batch({k: torch.from_numpy(v).to(run.device)
                           for k, v in next(run.ds).items()})
    counter = trace_analysis.TraceCounter()
    counter.track([run.params, run.opt, batch])
    torch.cuda.synchronize()
    with counter:
        stepped = run.step_fn(run.params, run.opt, batch)
        torch.cuda.synchronize()
    del stepped
    out.update(
        losses=run.losses, step_ms=run.step_ms, peak_bytes=run.peak_bytes,
        mesh=list(run.mesh.shape), backend=dist.get_backend(),
        param_diffs=diffs, counted=dict(
            flops=counter.flops, hbm_bytes=counter.hbm_bytes,
            coll_bytes_by_kind=counter.coll.bytes_by_kind,
            coll_count_by_kind=counter.coll.count_by_kind,
            n_ops=counter.n_ops),
        launches=_launches())
    Path(out_path).write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def dist_dryrun_child(out_path, what):
    """Phase 16(b) or (c), in a process of its own (the fake process
    group): (b) the dry-run at (a)'s configuration on a (1, 1) mesh; (c)
    qwen3-1.7b's production-mesh cells."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    d = DIST
    if what == "b":
        cell = ShapeCell(f"train_{d['batch']}x{d['seq']}", d["seq"],
                         d["batch"], "train")
        rec = dryrun.run_cell(d["arch"], cell, False, None,
                              mesh_axes=((1, 1), ("data", "model")))
        out = dict(rec=rec)
    else:
        out = dict(recs=[dryrun.run_cell(d["arch"], shape, multi, None)
                         for shape in DIST_SHAPES
                         for multi in (False, True)])
    out["launches"] = _launches()
    Path(out_path).write_text(json.dumps(out))
    return 0


def _child(cmd, what, timeout):
    """Run a child of phase 16; fails the phase on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"[dist {what}] {line}")
    check(res.returncode == 0, f"phase 16 {what} exited "
          f"{res.returncode}: {res.stderr[-3000:]}")
    return wall


def _gib(b):
    return b / 2 ** 30


def phase_dist(torch):
    """Phase 16: (a) the launcher's distributed path on the card, (b) the
    dry-run's prediction of (a), (c) production-mesh cells, (d) no
    kernel launched in any of them."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    scratch = ROOT / "build" / "dist"
    scratch.mkdir(parents=True, exist_ok=True)
    me = str(Path(__file__).resolve())
    d = DIST
    tokens = d["batch"] * d["seq"]

    # (a)
    a_path = scratch / "a.json"
    wall_a = _child([sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc-per-node", "1", me,
                     "--phase16-train", str(a_path)], "a", 900)
    a = json.loads(a_path.read_text())
    check(a["backend"] == "nccl" and a["mesh"] == [1, 1],
          f"phase 16a ran on {a['backend']} {a['mesh']}")
    for i, (x, y) in enumerate(zip(a["losses"], a["ref_losses"])):
        check(abs(x - y) <= d["loss_rel"] * abs(y),
              f"dist step {i}: loss {x} against the unsharded {y}")
    bad = [p for p, v in a["param_diffs"].items()
           if v["max_abs"] > d["param_rel"] * max(v["scale"], 1e-30)]
    check(not bad, f"dist: parameters off the unsharded run: {bad}")
    worst = max(a["param_diffs"].items(), key=lambda kv: kv[1]["max_abs"])
    identical = all(v["identical"] for v in a["param_diffs"].values())
    log(f"[dist] (a) {d['arch']} {d['batch']} x {d['seq']}, "
        f"{d['steps']} steps, torch.distributed.run, 1 rank, nccl, mesh "
        f"(1, 1): losses {a['losses']} against the unsharded "
        f"{a['ref_losses']}; parameters bit-identical: {identical} "
        f"(largest difference {worst[1]['max_abs']} in {worst[0]})")
    for i, (ms, rms) in enumerate(zip(a["step_ms"], a["ref_step_ms"])):
        log(f"[dist] (a) step {i}: DTensor {ms:.1f} ms "
            f"({tokens / ms * 1e3:.0f} tokens/s), unsharded {rms:.1f} ms "
            f"({tokens / rms * 1e3:.0f} tokens/s)")
    c = a["counted"]
    log(f"[dist] (a) one more step under the counter: {c['flops']:.6e} "
        f"FLOPs, {c['hbm_bytes']:.6e} HBM bytes, {c['n_ops']} ops, "
        f"collectives {c['coll_count_by_kind']} "
        f"({c['coll_bytes_by_kind']} bytes); peak "
        f"{a['peak_bytes'] / 1e9:.2f} GB (unsharded "
        f"{a['ref_peak_bytes'] / 1e9:.2f} GB)")

    # (b)
    b_path = scratch / "b.json"
    wall_b = _child([sys.executable, me, "--phase16-dryrun", str(b_path),
                     "b"], "b", 600)
    b = json.loads(b_path.read_text())["rec"]
    pred_peak, meas_peak = b["memory"]["peak_bytes"], a["peak_bytes"]
    err = abs(pred_peak - meas_peak) / meas_peak
    check(err <= d["peak_rel"], f"dry-run peak {pred_peak} against the "
          f"card's {meas_peak} ({err:.3f})")
    check(b["roofline"]["flops"] == c["flops"], f"dry-run FLOPs "
          f"{b['roofline']['flops']} against the card's step "
          f"{c['flops']}")
    step_s = max(b["roofline"][k] for k in ("compute_s", "memory_s",
                                             "collective_s"))
    meas_s = statistics.median(a["step_ms"]) / 1e3
    log(f"[dist] (b) dry-run at (a)'s configuration, (1, 1) fake mesh: "
        f"peak {pred_peak / 1e9:.3f} GB against {meas_peak / 1e9:.3f} GB "
        f"on the card ({err * 100:.2f}% off); FLOPs "
        f"{b['roofline']['flops']:.6e} = the card's count; roofline "
        f"step {step_s:.4f} s ({b['roofline']['bound']}) against "
        f"{meas_s:.4f} s measured (median): the card at "
        f"{step_s / meas_s:.3f} of the roofline; trace {b['trace_s']} s")

    # (c)
    c_path = scratch / "c.json"
    wall_c = _child([sys.executable, me, "--phase16-dryrun", str(c_path),
                     "c"], "c", 1200)
    cells = json.loads(c_path.read_text())
    want = {(d["arch"], s, m) for s in DIST_SHAPES
            for m in ("16x16", "2x16x16")}
    got = {(r["arch"], r["shape"], r["mesh"]) for r in cells["recs"]}
    check(want <= got, f"phase 16c traced {sorted(got)}")
    for r in cells["recs"]:
        rf = r["roofline"]
        log(f"[dist] (c) {r['arch']} {r['shape']} {r['mesh']}: bound "
            f"{rf['bound']}, compute {rf['compute_s']:.4f} s, memory "
            f"{rf['memory_s']:.4f} s, collective {rf['collective_s']:.4f} "
            f"s; collective bytes {r['collectives']['bytes_by_kind']}; "
            f"peak {_gib(r['memory']['peak_bytes']):.2f} GiB a device "
            f"(card {_gib(CARD_BYTES):.1f} GiB), argument "
            f"{_gib(r['memory']['argument_bytes']):.2f} GiB; useful "
            f"FLOPs {rf['useful_flops_frac']:.3f}; trace {r['trace_s']} s")

    # (d)
    launches = {}
    for part in (a, json.loads(b_path.read_text()), cells):
        for k, n in part["launches"].items():
            launches[k] = launches.get(k, 0) + n
    check(not any(launches.values()), f"phase 16 launched a kernel: "
          f"{launches}")
    wall = time.time() - t0
    log(f"[dist] (d) no kernel launched in (a)-(c) ({launches}); phase "
        f"wall {wall:.1f} s (a {wall_a:.1f}, b {wall_b:.1f}, c "
        f"{wall_c:.1f})")
    return dict(train=a, dryrun=b, cells=cells, launches=launches,
                wall_s=wall, parts_s=dict(a=wall_a, b=wall_b, c=wall_c))


# -- main --------------------------------------------------------------------

# -- phase 17 ----------------------------------------------------------------

# the query and KV heads x head_dim of widely served public decoders that
# the attention kernels take since they read head_dim and the group at
# run time: head_dim 96, and groups 12, 16 and 71 (multi-query)
PUBLIC_HEADS = {"phi-3-mini": (32, 32, 96), "starcoder2-15b": (48, 4, 128),
                "glm-4-9b": (32, 2, 128), "falcon-7b": (71, 1, 64)}
# paged decode also at pages of 2, 24 and 512 tokens (qwen3's heads), and
# bf16 at head_dim 8, 16 and 32 (the reduced configurations' widths)
PAGE_SIZES = (2, 24, 512)
SMALL_HEAD_DIMS = (8, 16, 32)
# the panel route, at qwen3's 16 query / 8 KV heads: bf16 head_dim 33
# (odd: 2-byte copies), 100 and 300 (rows off the 16-byte grain; 300 also
# above 256), 320 and 512 (above 256), float32 50 (off the grain) and 320
PANEL_GEOMETRIES = [(33, "bfloat16"), (100, "bfloat16"), (300, "bfloat16"),
                    (320, "bfloat16"), (512, "bfloat16"), (50, "float32"),
                    (320, "float32")]
FA_GEOMETRY = dict(B=1, S=2048)            # causal prefill, Sq = Skv
FD_GEOMETRY = dict(B=8, S=8192, kv_len=8000, kv_splits=8)


def _flash_prefill_geometry(torch, dtype, heads):
    """flash_attention at ``heads`` over FA_GEOMETRY, causal, its default
    config: held to the plain version within ``flash_error``, the rows
    before a poisoned second half of the keys bit-identical, timed beside
    the bound, the family's sol, the plain version and one SDPA call."""
    import torch.nn.functional as F
    from repro_torch.core.families.flash_attention import (
        FlashAttentionProblem, flash_attention_sol, instance_name,
        route_tile)
    from repro_torch.kernels.flash_attention import (KERNEL, default_config,
                                                     flash_error, mha,
                                                     mha_ref)
    Hq, Hkv, D = heads
    B, S = FA_GEOMETRY["B"], FA_GEOMETRY["S"]
    q, k, v = _fa_inputs(torch, B, Hq, Hkv, S, S, D, dtype, 17)
    prob = FlashAttentionProblem(B, Hq, Hkv, S, S, D, True, SHORT[dtype])
    cfg = default_config(S, S, D)
    n0 = KERNEL.launches
    got = mha(q, k, v, cfg=cfg, causal=True)
    torch.cuda.synchronize()
    check(KERNEL.launches == n0 + 1, f"flash_attention {heads}: no launch")
    want = mha_ref(q, k, v, causal=True)
    err, row, ok = flash_error(got, want)
    check(ok, f"flash_attention {dtype} {heads}: max |kernel - plain| "
          f"{err}, worst row {row}: beyond the tolerance")
    k2, v2 = k.clone(), v.clone()
    k2[:, :, S // 2:] = POISON
    v2[:, :, S // 2:] = POISON
    poisoned = mha(q, k2, v2, cfg=cfg, causal=True)
    torch.cuda.synchronize()
    check(torch.equal(got[:, :, :S // 2], poisoned[:, :, :S // 2]),
          f"flash_attention {dtype} {heads}: keys after the rows moved them")
    ms = time_ms(torch, lambda: mha(q, k, v, cfg=cfg, causal=True))
    plain = time_ms(torch, lambda: mha_ref(q, k, v, causal=True), iters=3,
                    warmup=1)
    # one SDPA call, on whichever backend PyTorch picks (no fused one
    # takes float32 with grouped heads)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=10)
    elt = q.element_size()
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * elt
    flops = 4.0 * B * Hq * _causal_pairs(S, S, True) * D
    bms, by = bound_ms(n_bytes, flops, dtype)
    sol = flash_attention_sol(prob).time_s * 1e3
    inst = instance_name(route_tile(min(cfg.block_q, S), D, SHORT[dtype]),
                         D, SHORT[dtype])
    return dict(max_abs_err=err, row_err=row, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, sol_ms=sol, library_ms=lib,
                instance_name=inst, cfg=cfg.name(),
                launches=KERNEL.launches - n0)


def _flash_decode_geometry(torch, dtype, heads):
    """flash_decode at ``heads`` over FD_GEOMETRY: held to the plain
    version, zeros at kv_len 0, positions past kv_len poisoned leave it
    bit-identical, timed beside the bound, the family's sol, the plain
    version and one SDPA call on the valid positions."""
    import torch.nn.functional as F
    from repro_torch.core.families.flash_decode import (
        FlashDecodeConfig, FlashDecodeProblem, flash_decode_sol,
        instance_name)
    from repro_torch.kernels.flash_attention import (DECODE_KERNEL,
                                                     flash_error, mha_decode,
                                                     mha_ref)
    Hq, Hkv, D = heads
    B, S, L = FD_GEOMETRY["B"], FD_GEOMETRY["S"], FD_GEOMETRY["kv_len"]
    q, k, v = _fa_inputs(torch, B, Hq, Hkv, 1, S, D, dtype, 18)
    cfg = FlashDecodeConfig(FD_GEOMETRY["kv_splits"])
    kl = torch.tensor(L, dtype=torch.int32, device="cuda")
    n0 = DECODE_KERNEL.launches
    call = lambda: mha_decode(q, k, v, kl, cfg=cfg)
    got = call()
    torch.cuda.synchronize()
    want = mha_ref(q, k, v, causal=False, kv_len=L)
    err, row, ok = flash_error(got, want)
    check(ok, f"flash_decode {dtype} {heads}: max |kernel - plain| {err}, "
          f"worst row {row}: beyond the tolerance")
    zero = mha_decode(q, k, v, torch.zeros_like(kl), cfg=cfg)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, L:] = POISON
    v2[:, :, L:] = POISON
    poisoned = mha_decode(q, k2, v2, kl, cfg=cfg)
    torch.cuda.synchronize()
    check(not zero.any(), f"flash_decode {dtype} {heads}: kv_len 0 must "
          "give zeros")
    check(torch.equal(got, poisoned), f"flash_decode {dtype} {heads}: "
          "positions past kv_len moved the output")
    launches = DECODE_KERNEL.launches - n0
    elt = q.element_size()
    kv_bytes = 2 * B * Hkv * L * D * elt
    ms = time_ms(torch, call)
    split_ms, combine_ms = decode_parts_ms(torch, call, kv_bytes=kv_bytes)
    plain = time_ms(torch, lambda: mha_ref(q, k, v, causal=False,
                                           kv_len=L), iters=5, warmup=1)
    kv, vv = k[:, :, :L], v[:, :, :L]
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, kv, vv, enable_gqa=True), iters=10)
    n_bytes = kv_bytes + 2 * q.numel() * elt
    bms, by = bound_ms(n_bytes, 4.0 * B * Hq * L * D, dtype)
    sol = flash_decode_sol(FlashDecodeProblem(
        B, Hq, Hkv, S, D, SHORT[dtype])).time_s * 1e3
    return dict(max_abs_err=err, row_err=row, ms=ms, plain_ms=plain,
                decode_parts_ms=dict(split=split_ms, combine=combine_ms),
                bound_ms=bms, bound_by=by, sol_ms=sol, library_ms=lib,
                instance_name=instance_name(D, elt), cfg=cfg.name(),
                launches=launches)


def _refusals(torch):
    """The one geometry still refused, as the JAX gate refuses it: a
    page of one token.  paged_decode raises ValueError on the card with
    no launch."""
    from repro_torch.kernels.paged_attention import KERNEL as PD
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    z = lambda *shape: torch.zeros(*shape, device="cuda",
                                   dtype=torch.bfloat16)
    i32 = lambda *shape: torch.zeros(*shape, device="cuda",
                                     dtype=torch.int32)
    n0 = PD.launches
    try:
        paged_decode(z(2, 8, 1, 128), z(4, 2, 1, 128), z(4, 2, 1, 128),
                     i32(2, 2), i32(2))
    except ValueError as e:
        check("pages of at least" in str(e), f"paged_decode at PS=1: {e}")
    else:
        check(False, "paged_decode took a page of one token")
    check(PD.launches == n0, "a refused page launched a kernel")
    log("[geometries] paged_decode refuses a 1-token page with no launch "
        "(as the JAX gate does); every head_dim runs")
    return ["paged_decode PS=1"]


def phase_geometries(torch):
    """The four attention kernels at the public geometries
    (PUBLIC_HEADS), bf16 and float32, each held to its plain version
    within TOL (the flash pair within ``flash_error``) with its poisoned
    positions and its zero-length row, timed (CUDA events, L2 flushed)
    beside the bound of this run's inputs, the family's ``*_sol`` and a
    library call where one computes the function, naming the instance
    that ran; paged decode also at 2-, 24- and 512-token pages and in
    bf16 at head_dim 8, 16 and 32; the four kernels on the panel route
    at PANEL_GEOMETRIES (qwen3's heads); then the 1-token page's
    refusal."""
    from repro_torch.kernels.flash_attention import DECODE_KERNEL
    from repro_torch.kernels.flash_attention import KERNEL as FA
    from repro_torch.kernels.paged_attention import KERNEL as PD
    from repro_torch.kernels.ragged_prefill import KERNEL as RP
    out = {n: [] for n in ("paged_decode", "ragged_prefill",
                           "flash_attention", "flash_decode")}

    def add(name, counter, tag, dtype, heads, fn, **kw):
        n0 = counter.launches
        r = fn()
        r.update(kw, arch=tag, dtype=dtype, heads=list(heads),
                 launches=counter.launches - n0)
        out[name].append(r)
        log(f"[geometries] {name} {tag} {SHORT[dtype]} "
            f"{heads[0]}/{heads[1]}x{heads[2]}"
            + (f" ps{kw['page_size']}" if "page_size" in kw else "")
            + f" on {r['instance_name']}: err {r['max_abs_err']:.3g}, "
            f"{r['ms']:.4f} ms"
            + (f" (device: split {_ms_or(r['decode_parts_ms']['split'])}, "
               f"combine {_ms_or(r['decode_parts_ms']['combine'])})"
               if "decode_parts_ms" in r else "")
            + f", bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), sol {r['sol_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library "
            + (f"{r['library_ms']:.4f} ms" if r["library_ms"] else "none"))

    for tag, heads in PUBLIC_HEADS.items():
        for dtype in ("bfloat16", "float32"):
            add("paged_decode", PD, tag, dtype, heads,
                lambda: phase_decode_kernel(torch, dtype, heads=heads),
                page_size=16)
            add("ragged_prefill", RP, tag, dtype, heads,
                lambda: phase_prefill_kernel(torch, dtype, heads=heads))
            add("flash_attention", FA, tag, dtype, heads,
                lambda: _flash_prefill_geometry(torch, dtype, heads))
            add("flash_decode", DECODE_KERNEL, tag, dtype, heads,
                lambda: _flash_decode_geometry(torch, dtype, heads))
    for PS in PAGE_SIZES:
        for dtype in ("bfloat16", "float32"):
            add("paged_decode", PD, "qwen3-1.7b", dtype, QWEN_HEADS,
                lambda: phase_decode_kernel(torch, dtype, PS=PS),
                page_size=PS)
    for D in SMALL_HEAD_DIMS:
        heads = (QWEN_HEADS[0], QWEN_HEADS[1], D)
        add("paged_decode", PD, "qwen3-1.7b", "bfloat16", heads,
            lambda: phase_decode_kernel(torch, "bfloat16", heads=heads),
            page_size=16)
    for D, dtype in PANEL_GEOMETRIES:
        heads = (QWEN_HEADS[0], QWEN_HEADS[1], D)
        tag = f"qwen3-1.7b heads, head_dim {D}"
        add("paged_decode", PD, tag, dtype, heads,
            lambda: phase_decode_kernel(torch, dtype, heads=heads),
            page_size=16)
        add("ragged_prefill", RP, tag, dtype, heads,
            lambda: phase_prefill_kernel(torch, dtype, heads=heads))
        add("flash_attention", FA, tag, dtype, heads,
            lambda: _flash_prefill_geometry(torch, dtype, heads))
        add("flash_decode", DECODE_KERNEL, tag, dtype, heads,
            lambda: _flash_decode_geometry(torch, dtype, heads))
        for name in out:
            check(out[name][-1]["instance_name"].startswith("panel "),
                  f"{name} at head_dim {D}: ran on "
                  f"{out[name][-1]['instance_name']}, not the panel route")
        torch.cuda.empty_cache()
    return dict(cases=out, refused=_refusals(torch))


# -- the example twins -------------------------------------------------------

def phase_twins(torch):
    """``examples/serve_demo_torch.py`` and ``figure1_dsl_torch.py`` on
    the card, as a user runs them (their default device): 12 requests
    served with their token budgets, the Figure-1 program valid and its
    mis-lowering caught."""
    import importlib.util
    import io
    out = {}
    for name in ("serve_demo_torch", "figure1_dsl_torch"):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main([])
        text = buf.getvalue().strip().splitlines()
        check(text and text[-1].endswith("OK"), f"{name}: {text[-1:]}")
        out[name] = dict(seconds=time.perf_counter() - t0,
                         last_line=text[-1], lines=len(text))
        log(f"[twins] {name} on the card: {len(text)} lines, "
            f"{text[-1]!r}, {out[name]['seconds']:.1f} s")
    return out


def main():
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # phase 15c runs under deterministic algorithms, whose cuBLAS check
    # reads this; it is the H100's default workspace (4 MiB x 8) anyway
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # phase 16's children, each a process of its own
    if len(sys.argv) > 2 and sys.argv[1] == "--phase16-train":
        return dist_train_child(sys.argv[2])
    if len(sys.argv) > 3 and sys.argv[1] == "--phase16-dryrun":
        return dist_dryrun_child(sys.argv[2], sys.argv[3])
    summary = {}
    try:
        summary["card"] = phase_card(torch)
        summary["build"] = phase_build()
        kern = {}
        for dtype in ("bfloat16", "float32"):
            kern[("paged_decode", dtype)] = phase_decode_kernel(torch, dtype)
            kern[("ragged_prefill", dtype)] = phase_prefill_kernel(torch,
                                                                   dtype)
        summary["kernels"] = {f"{n}/{d}": v for (n, d), v in kern.items()}
        serve = phase_serve(torch)
        summary["serve"] = serve
        summary["serve_head_dims"] = hd = [phase_serve(torch, s)
                                           for s in SERVE_HEAD_DIMS]
        summary["paths"] = phase_paths(torch)
        summary["gemm"] = gemm = phase_gemm(torch)
        summary["flash"] = flash = phase_flash(torch)
        summary["moe"] = moe = phase_moe(torch)
        summary["serve_moe"] = phase_serve_moe(torch)
        summary["quant_gemm"] = quant = phase_quant(torch)
        summary["ssd"] = ssd = phase_ssd(torch)
        summary["tune"] = phase_tune(torch, serve)
        summary["serve_flavours"] = flav = phase_serve_flavours(torch)
        summary["hybrid_encdec"] = phase_hybrid_encdec(torch)
        summary["train"] = phase_train(torch)
        summary["dist"] = phase_dist(torch)
        summary["geometries"] = geo = phase_geometries(torch)
        summary["twins"] = phase_twins(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    sources = {
        "paged_decode": (
            "src/repro_torch/kernels/paged_attention/csrc/paged_decode.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:89"),
        "ragged_prefill": (
            "src/repro_torch/kernels/ragged_prefill/csrc/ragged_prefill.cu",
            "src/repro/kernels/ragged_prefill/ragged_prefill.py:89"),
    }
    line = []
    for name, (src, replaces) in sources.items():
        k = kern[(name, "bfloat16")]       # the serving path's dtype
        line.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=serve["launches"][name], max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            ported=True, dtype="bfloat16", instance=k["instance_name"]))
        # the other architectures' instances (phase 13a), and the
        # kernel's launches in each of their serving runs (13b-c)
        line[-1]["instances"] = [dict(
            arch=arch, dtype=dtype, heads=v["heads"],
            instance=v["instance_name"], max_abs_err=v["max_abs_err"],
            ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
            bound_by=v["bound_by"], library_ms=v["library_ms"],
            launches=flav["serve"][arch]["launches"][name])
            for key, v in flav["kernels"].items()
            for arch, kname, dtype in [key.split("/")] if kname == name]
        # phase 4's short runs at head_dim 100 and 320 (the panel route)
        line[-1]["head_dim_runs"] = [dict(
            head_dim=s["head_dim"], n_layers=r["n_layers"],
            launches=r["launches"][name], ticks=r["ticks"])
            for s, r in zip(SERVE_HEAD_DIMS, hd)]
        if name == "paged_decode":
            prod = k["production"]
            line[-1].update(
                decode_parts_ms=k["decode_parts_ms"],
                mismatch_share=k["mismatch_share"],
                production=dict(
                    ms=prod["ms"], decode_parts_ms=prod["decode_parts_ms"],
                    bound_ms=prod["bound_ms"], plain_ms=prod["plain_ms"],
                    max_abs_err=prod["max_abs_err"],
                    dense_flash_decode_ms=prod["dense_flash_decode_ms"]))
    # gemm: the loop's best config at the production problem, 8192^3 bf16
    best = next(r for r in gemm["time"] if r["config"] == "best"
                and r["problem"] == [8192, 8192, 8192])
    line.append(dict(
        name="gemm", route="cuda",
        source="src/repro_torch/kernels/gemm/csrc/gemm.cu",
        replaces="src/repro/kernels/gemm/gemm.py:60",
        launches=gemm["loop"]["launches"]["gemm"],
        max_abs_err=best["max_abs_err"], ms=best["ms"],
        plain_ms=best["plain_ms"], bound_ms=best["bound_ms"],
        bound_by=best["bound_by"], library_ms=best["library_ms"],
        ported=True, dtype="bfloat16", cfg=best["cfg"],
        instance=best["instance"]))
    # flash: the loop's best config at each family's production problem
    for name, src, replaces in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:96"),
            ("flash_decode", "flash_decode.cu",
             "src/repro/kernels/flash_attention/decode.py:56")):
        fl = flash[name]
        best = next(r for r in fl["time"] if r["config"] == "best")
        check(not best.get("rejected"), f"{name}: best config rejected")
        line.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/flash_attention/csrc/{src}",
            replaces=replaces, launches=fl["loop"]["launches"][name],
            max_abs_err=best["max_abs_err"],
            ms=best["ms"], plain_ms=best["plain_ms"],
            bound_ms=best["bound_ms"], bound_by=best["bound_by"],
            library_ms=best["library_ms"], ported=True, dtype="bfloat16",
            cfg=best["cfg"]))
    # grouped_ffn: the loop's best config at the production problem; no
    # single PyTorch call computes it (library_ms null), the bmm
    # yardstick is three calls and the elementwise passes
    best = next(r for r in moe["time"] if r["config"] == "best"
                and r["problem"][0] == 16384)
    check(not best.get("rejected"), "moe: best config rejected")
    line.append(dict(
        name="grouped_ffn", route="cuda",
        source="src/repro_torch/kernels/moe/csrc/grouped_ffn.cu",
        replaces="src/repro/kernels/moe/moe.py:63",
        launches=moe["loop"]["launches"]["grouped_ffn"],
        max_abs_err=best["max_abs_err"], ms=best["ms"],
        plain_ms=best["plain_ms"], bound_ms=best["bound_ms"],
        bound_by=best["bound_by"], library_ms=None,
        yardstick_ms=best["yardstick_ms"],
        yardstick="3 torch.bmm (cuBLAS) + elementwise SwiGLU and gate",
        ported=True, dtype="bfloat16", cfg=best["cfg"],
        instance=best["instance"],
        # rows off the 16-byte grain: the element-copy instance (phase 8)
        off_grain=moe["off_grain"]))
    # quant_gemm: the loop's best config at the production problem; no
    # single PyTorch call computes it (library_ms null); the torch._int_mm
    # yardstick applies no group scale
    best = next(r for r in quant["time"] if r["config"] == "best"
                and r["problem"][:3] == [8192, 8192, 8192])
    check(not best.get("rejected"), "quant_gemm: best config rejected")
    line.append(dict(
        name="quant_gemm", route="cuda",
        source="src/repro_torch/kernels/quant_gemm/csrc/quant_gemm.cu",
        replaces="src/repro/kernels/quant_gemm/quant_gemm.py:58",
        launches=quant["loop"]["launches"]["quant_gemm"],
        max_abs_err=best["max_abs_err"], ms=best["ms"],
        plain_ms=best["plain_ms"], bound_ms=best["bound_ms"],
        bound_by=best["bound_by"], library_ms=None,
        yardstick_ms=best["yardstick_ms"],
        yardstick_colmajor_b_ms=best["yardstick_colmajor_b_ms"],
        yardstick="torch._int_mm (cuBLASLt int8 -> int32, no group scales)",
        ported=True, dtype="int8", cfg=best["cfg"],
        instance=best["instance"], transpose_ms=best["transpose_ms"],
        gemm_ms=best["gemm_ms"]))
    # ssd_chunk_scan: the loop's best config at the production problem
    # (its launches: the loop's unit tests; the mamba2 layer's one launch
    # through ssd_via_kernel is in phase 11's summary)
    best = next(r for r in ssd["time"] if r["config"] == "best"
                and r["problem"][1] == 8192)
    check(not best.get("rejected"), "ssd: best config rejected")
    line.append(dict(
        name="ssd_chunk_scan", route="cuda",
        source="src/repro_torch/kernels/ssd/csrc/ssd_chunk_scan.cu",
        replaces="src/repro/kernels/ssd/ssd.py:65",
        launches=ssd["loop"]["launches"]["ssd_chunk_scan"],
        max_abs_err=best["max_abs_err"], ms=best["ms"],
        plain_ms=best["plain_ms"], bound_ms=best["bound_ms"],
        bound_by=best["bound_by"], library_ms=None, ported=True,
        dtype="float32", cfg=best["cfg"],
        instance="3xTF32 mma.sync, chunk-parallel (3 launches)",
        parts_ms=best["parts_ms"], scratch_bytes=best["scratch_bytes"],
        # d_state above 128: the state panels (phase 11)
        state_panels=ssd["panels"],
        mamba2_layer=dict(
            launches=ssd["mamba2"]["layer"]["launches"],
            ms=ssd["mamba2"]["layer"]["ms"],
            ssd_chunked_ms=ssd["mamba2"]["layer"]["plain_ms"],
            bound_ms=ssd["mamba2"]["layer"]["bound_ms"],
            max_abs_err=ssd["mamba2"]["layer"]["max_abs_err"])))
    check(len(line) == 8, f"the kernels line lists {len(line)} kernels")
    # the attention kernels' instances at the public geometries, the page
    # sizes and the small head dims (phase 17), each case's launches its
    # own (no serving run reaches these geometries); the family's sol, a
    # cost model's figure, stays in the log
    keys = ("arch", "dtype", "heads", "page_size", "instance_name",
            "max_abs_err", "ms", "decode_parts_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "launches")
    for entry in line:
        if entry["name"] in geo["cases"]:
            entry["geometries"] = [{k: c[k] for k in keys if k in c}
                                   for c in geo["cases"][entry["name"]]]
            entry["refused"] = [r for r in geo["refused"]
                                if r.startswith(entry["name"] + " ")]
    summary["kernels_line"] = line
    clocks = [w["clock"] for w in PROFILER_WINDOWS if w["kept"]
              and w["clock"]]
    summary["profiler_windows"] = dict(
        taken=len(PROFILER_WINDOWS),
        short=sum(any(c < w["n"] for c in w["counts"].values())
                  for w in PROFILER_WINDOWS),
        clock_kept=[min(clocks), max(clocks)] if clocks else None,
        failed=[w for w in PROFILER_WINDOWS if not w["kept"]])
    pw = summary["profiler_windows"]
    log(f"[profiler] windows taken {pw['taken']}, with launches lost "
        f"{pw['short']}, failed {len(pw['failed'])}; kept flushed "
        f"windows' clock {pw['clock_kept']}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(summary, indent=1, sort_keys=True) + "\n")
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
