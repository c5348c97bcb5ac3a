#!/usr/bin/env python3
"""End-to-end check of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from a checkout of the repository (it imports ``src/repro_torch``;
nothing of JAX or of the JAX package ``repro``).  It needs one CUDA card
and ``nvcc``, and exits non-zero, without printing a result, when either
is missing or any phase fails.  Phases:

1. card — name and power limit as ``nvidia-smi`` reports them;
2. build — the three CUDA kernels from the repository's sources, one
   ``nvcc`` per source, started together;
3. kernels against their plain PyTorch versions at the serving path's
   shapes (qwen3-1.7b: 16 query heads, 8 KV heads, head_dim 128, page
   size 16), in bfloat16 and float32, including poisoned pages and
   segments that must not move the output by a bit; each kernel's time,
   its plain version's time, the least time the card could take
   (``bound_ms``) and, for ragged prefill, one
   ``scaled_dot_product_attention`` call as a yardstick;
4. serve — qwen3-1.7b at full width and depth (28 layers, random
   weights from a seeded ``torch.Generator``) behind
   ``PagedServingEngine(decode_path="kernel", prefill_path="kernel")``
   replaying a seeded Poisson trace of 16 requests; every tick that
   decoded or prefilled must have gone through the two kernels, whose
   launch counters are zeroed just before this phase and read just
   after; then a profiled prefill tick and six decode ticks show where
   a tick's time goes;
5. the kernel paths against the gather paths, in float32 at depth 2:
   identical tokens;
6. gemm — the ARGUS gate and agent loop on the GEMM family:
   (b) the GEMM kernel against its plain version in bfloat16 and
   float32 over the default config, split_k 2 and 4, stagger_k, a tile
   above 128, bm = 8, ragged shapes and the production problem
   8192^3 bf16; (c) the paper's loop, ``optimize_kernel`` at 8192^3
   bf16 with ``Validator(run_kernels=True)``, its launch counter zeroed
   just before and read just after: every unit test of the loop must
   have launched the kernel once; (d) the baseline and the loop's best
   config timed at the production problem and the two sweep problems,
   beside the bound, the plain version, one bf16 ``torch.matmul``
   (cuBLAS) and the port's cost-model estimate; (e) an invalid config
   (split_k = 5 on 3 K blocks) must raise before any launch;
7. the kernels line (JSON), then the final line
   ``{"ok": true, "device": {...}}``.

A summary of every number also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense peak rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SERVE = dict(arch="qwen3-1.7b", max_batch=8, max_len=2048, page_size=16,
             prefill_chunk=256, requests=16, prompt_lens=(64, 1024),
             max_new=(16, 32), mean_gap=2.0, seed=0)

# Tolerances of a kernel against its plain version on the same inputs:
# float32 — the two sum the same products in another order (up to 2048
# terms here), far below 1e-4 for outputs of size ~1; bfloat16 — each
# rounds its float32 result to bfloat16 once and may land on the other
# neighbour: one bfloat16 step at |x| < 2 is 2^-7, so 1e-2.
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
POISON = 1e6

TPU_KERNELS_NOT_PORTED = [
    ("flash_attention",
     "src/repro/kernels/flash_attention/flash_attention.py:96"),
    ("flash_decode", "src/repro/kernels/flash_attention/decode.py:56"),
    ("grouped_ffn", "src/repro/kernels/moe/moe.py:63"),
    ("quant_gemm", "src/repro/kernels/quant_gemm/quant_gemm.py:58"),
    ("ssd_chunk_scan", "src/repro/kernels/ssd/ssd.py:65"),
]


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
    from repro_torch.kernels import ALL_KERNELS, build_all
    t0 = time.perf_counter()
    logs = build_all(ALL_KERNELS)
    secs = time.perf_counter() - t0
    log(f"[build] {len(ALL_KERNELS)} kernels in {secs:.1f} s")
    for name, text in logs.items():
        entry = ""
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                entry = _instance(ln)
            elif "registers" in ln or "spill" in ln or "bytes smem" in ln:
                log(f"[build] {name}{entry}: {ln.strip()}")
    return secs


def _instance(ptxas_line):
    """' <type> <TM>x<TN>' for a template instance of the GEMM kernel
    (from its mangled name), else ''."""
    import re
    m = re.search(r"gemm_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E",
                  ptxas_line)
    if not m:
        return ""
    dtype = "bf16" if m.group(1) != "f" else "f32"
    return f" {dtype} {m.group(2)}x{m.group(3)}"


# -- phase 3 -----------------------------------------------------------------

def _decode_case(torch, dtype, seed=0):
    """Main-path decode shapes: batch 8, 16/8 heads, head_dim 128, 16-token
    pages, 128 pages per sequence (max_len 2048), a 768-page pool."""
    B, Hq, Hkv, D, PS, NP, P = 8, 16, 8, 128, 16, 128, 768
    lengths = [0, 1, 17, 256, 300, 777, 1040, 2048]
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


def phase_decode_kernel(torch, dtype):
    from repro_torch.kernels.paged_attention import paged_decode_ref
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_decode
    (q, kp, vp, table, lens), (kp2, vp2), lengths, (Hq, Hkv, D) = \
        _decode_case(torch, dtype)
    got = paged_decode(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    want = paged_decode_ref(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(err <= TOL[dtype], f"paged_decode {dtype}: max |kernel - plain| "
          f"{err} > {TOL[dtype]}")
    check(float(got[0].abs().max()) == 0.0,
          "paged_decode: a zero-length row must give zeros")
    poisoned = paged_decode(q, kp2, vp2, table, lens)
    torch.cuda.synchronize()
    check(torch.equal(got, poisoned), f"paged_decode {dtype}: poisoned "
          "foreign/null/tail pages moved the output")
    ms = time_ms(torch, lambda: paged_decode(q, kp, vp, table, lens))
    plain = time_ms(torch, lambda: paged_decode_ref(q, kp, vp, table, lens))
    elt = q.element_size()
    tokens = sum(lengths)
    n_bytes = (tokens * Hkv * D * 2 * elt + 2 * q.numel() * elt
               + table.numel() * 4 + lens.numel() * 4)
    flops = 4 * Hq * D * tokens
    bms, by = bound_ms(n_bytes, flops, dtype)
    log(f"[kernels] paged_decode {dtype}: max_abs_err {err:.3g} (tol "
        f"{TOL[dtype]}), poisoned run bit-identical; {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bms:.4f} ms ({by}), library: none")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None, bytes=n_bytes, flops=flops)


def _prefill_case(torch, dtype, seed=1):
    """Main-path prefill shapes: one tick packing 8 prompt chunks of up
    to 256 tokens against their prefixes (up to 768 earlier tokens),
    both buffers padded to 64 (as the engine packs them)."""
    Hq, Hkv, D = 16, 8, 128
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


def phase_prefill_kernel(torch, dtype):
    import torch.nn.functional as F
    from repro_torch.kernels.ragged_prefill import (default_config,
                                                    ragged_prefill_ref)
    from repro_torch.kernels.ragged_prefill.ragged_prefill import \
        ragged_prefill
    from repro_torch.kernels.ragged_prefill.ref import admit_mask
    (q, k, v, sq, pq, sk, pk), pairs = _prefill_case(torch, dtype)
    Hq, TQ, D = q.shape
    Hkv, TK, _ = k.shape
    cfg = default_config(TQ, TK)
    got = ragged_prefill(q, k, v, sq, pq, sk, pk, cfg=cfg)
    torch.cuda.synchronize()
    want = ragged_prefill_ref(q, k, v, sq, pq, sk, pk)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(err <= TOL[dtype], f"ragged_prefill {dtype}: max |kernel - "
          f"plain| {err} > {TOL[dtype]}")
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
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], attn_mask=mask, enable_gqa=True))
    elt = q.element_size()
    n_bytes = ((2 * q.numel() + k.numel() + v.numel()) * elt
               + 4 * 2 * (TQ + TK))
    flops = 4 * Hq * D * pairs
    bms, by = bound_ms(n_bytes, flops, dtype)
    log(f"[kernels] ragged_prefill {dtype}: TQ {TQ}, TK {TK}, {pairs} "
        f"admitted pairs per head; max_abs_err {err:.3g} (tol "
        f"{TOL[dtype]}), poisoned segment bit-identical; {ms:.4f} ms, "
        f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), library "
        f"(sdpa, masked, enable_gqa) {lib:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, bytes=n_bytes, flops=flops,
                TQ=TQ, TK=TK, pairs=pairs)


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


def phase_serve(torch):
    from repro_torch import configs
    from repro_torch.kernels import ALL_KERNELS
    from repro_torch.models import build
    from repro_torch.serve import PagedServingEngine
    from repro_torch.serve.trace import poisson_trace
    s = SERVE
    cfg = configs.get_config(s["arch"])
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(s["seed"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pool_pages = s["max_batch"] * s["max_len"] // s["page_size"] * 3 // 4
    eng = PagedServingEngine(
        model, params, pool_pages=pool_pages, page_size=s["page_size"],
        max_batch=s["max_batch"], max_len=s["max_len"],
        prefill_chunk=s["prefill_chunk"], eos_id=-1, decode_path="kernel",
        prefill_path="kernel", device="cuda")
    trace = poisson_trace(seed=s["seed"], n_requests=s["requests"],
                          mean_gap=s["mean_gap"],
                          prompt_lens=s["prompt_lens"],
                          max_new=s["max_new"], vocab=cfg.vocab)
    weights_gb = sum(p.numel() * p.element_size()
                     for p in _leaves(params["blocks"])) / 1e9
    embed_gb = params["embed"]["tok"].numel() * 4 / 1e9
    log(f"[serve] {cfg.name}: {model.n_params / 1e9:.3f} B params "
        f"(blocks {weights_gb:.2f} GB bf16, embedding {embed_gb:.2f} GB "
        f"f32), KV pool {pool_pages} pages = {eng.kv.nbytes / 1e9:.2f} GB; "
        f"init {init_s:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    for k in ALL_KERNELS:                      # count the main path only
        k.launches = 0
    t0 = time.perf_counter()
    ticks = drive(eng, trace, torch)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ALL_KERNELS}

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
    check(all(t["kernel_decode"] == t["decoded"] for t in ticks),
          "a decode tick did not go through the paged-decode kernel")
    check(all(t["kernel_prefill"] == t["prefilled"] for t in ticks),
          "a prefill tick did not go through the ragged-prefill kernel")
    check(c["kernel_decode_ticks"] == n_dec and
          c["kernel_prefill_ticks"] == n_pre, "kernel tick counters")
    check(c["gather_bytes"] == 0, "kernel decode gathered a dense view")
    L = cfg.n_layers
    check(launches["paged_decode"] >= L * c["kernel_decode_ticks"],
          f"paged_decode launched {launches['paged_decode']} times for "
          f"{c['kernel_decode_ticks']} ticks x {L} layers")
    check(launches["ragged_prefill"] >= L * c["kernel_prefill_ticks"],
          f"ragged_prefill launched {launches['ragged_prefill']} times "
          f"for {c['kernel_prefill_ticks']} ticks x {L} layers")
    for leaf in ("k", "v"):
        check(float(eng.kv.storage["blocks"][leaf][:, 0].abs().max()) == 0,
              "the null page was written")
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
        pool_pages=pool_pages, preempted=c["preempted"])
    log(f"[serve] {len(done)} requests, {len(ticks)} ticks ({n_pre} "
        f"prefill, {n_dec} decode), all through the kernels; "
        f"{c['prefill_tokens']} prompt + {dec_tok} generated tokens in "
        f"{wall:.2f} s: decode {out['decode_tokens_per_s']:.1f} tok/s, "
        f"p50 step {out['p50_step_ms']:.1f} ms (decode-only ticks "
        f"{out['p50_decode_only_step_ms']:.1f} ms, prefill ticks "
        f"{out['p50_prefill_step_ms']:.1f} ms), launches {launches}, peak "
        f"memory {out['peak_gb']:.2f} GB, preempted {c['preempted']}")
    del eng
    out["profile"] = phase_profile(torch, model, params, pool_pages)
    del params
    torch.cuda.empty_cache()
    return out


def _profile_window(torch, engine, n_steps):
    """Run ``n_steps`` engine ticks under ``torch.profiler``; returns the
    window's wall time, device time by kernel (largest first) and the
    device's busy share (kernel time over wall time; kernels overlap
    little on one stream, so the share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
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
    return dict(wall_ms=wall * 1e3, device_ms=busy, ticks=n_steps,
                device_launches=launches,
                busy_share=(busy / (wall * 1e3)) if kern else None,
                top_kernels_ms=[[k[:90], v] for k, v in top])


def phase_profile(torch, model, params, pool_pages):
    """Where a tick's time goes at full width: one tick that prefills 8
    prompts of 256 tokens (and decodes their first tokens), then 6
    decode-only ticks of the 8 rows, each window under the profiler."""
    import numpy as np
    from repro_torch.serve import PagedServingEngine, Request
    s = SERVE
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
        log(f"[profile] {name}: wall {w['wall_ms']:.1f} ms, device "
            f"{w['device_ms']:.1f} ms, busy share {share}, "
            f"{w['device_launches']} device kernels; top: " + "; ".join(
                f"{k[:48]} {v:.2f}" for k, v in w["top_kernels_ms"][:6]))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# -- phase 5 -----------------------------------------------------------------

def phase_paths(torch):
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.serve import PagedServingEngine
    from repro_torch.serve.trace import poisson_trace, replay
    s = SERVE
    cfg = dataclasses.replace(configs.get_config(s["arch"]), n_layers=2,
                              dtype="float32")
    model = build(cfg)
    params = model.init(1, device="cuda")
    trace = poisson_trace(seed=3, n_requests=6, mean_gap=1.0,
                          prompt_lens=(64, 600), max_new=(4, 8),
                          vocab=cfg.vocab)
    outs, counters = {}, {}
    for path in ("kernel", "gather"):
        eng = PagedServingEngine(
            model, params, pool_pages=768, page_size=s["page_size"],
            max_batch=s["max_batch"], max_len=s["max_len"],
            prefill_chunk=s["prefill_chunk"], eos_id=-1, decode_path=path,
            prefill_path=path, device="cuda")
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
    log(f"[paths] float32, 2 layers, full width: kernel and gather paths "
        f"give identical tokens ({len(outs['kernel'])} requests, {n_tok} "
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
    ("production", 8192, 8192, 8192, {}),
]


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
    from repro_torch.kernels.gemm import matmul, matmul_ref
    out = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for label, m, n, k, fields in GEMM_CASES:
            if label == "production" and dtype == "float32":
                continue                  # the production problem is bf16
            g = torch.Generator(device="cuda").manual_seed(m + n + k)
            a = torch.randn(m, k, generator=g, device="cuda").to(dt)
            b = torch.randn(k, n, generator=g, device="cuda").to(dt)
            cfg = GemmConfig(**fields) if fields else None
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
                            cfg=fields, max_abs_err=err,
                            max_abs_out=float(want.float().abs().max())))
            del a, b, got, want
    torch.cuda.empty_cache()
    log(f"[gemm] kernel against its plain version: {len(out)} cases "
        f"(bf16 and f32; default, split_k 2/4, stagger_k, tile 512x256, "
        f"bm=8, ragged 1000x777x1500, 8192^3 bf16), all within the stated "
        f"tolerance; max abs err " + ", ".join(
            f"{SHORT[c['dtype']]}/{c['label']} {c['max_abs_err']:.3g}"
            for c in out))
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
    sweep problems, beside the bound, the plain version, one bf16
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
        lib = time_ms(torch, lambda: torch.matmul(a, b))
        bms, by = bound_ms((m * k + k * n + m * n) * 2, 2.0 * m * n * k,
                           "bfloat16")
        for which, cfg in (("baseline", GemmConfig()), ("best", best_cfg)):
            if not default_engine().verify("gemm", cfg, prob).hard_ok:
                rows.append(dict(problem=[m, n, k], config=which,
                                 cfg=cfg.name(), rejected=True))
                continue
            ms = time_ms(torch, lambda: matmul(a, b, cfg=cfg))
            est = gemm_cost(cfg, prob).time_s * 1e3
            rows.append(dict(problem=[m, n, k], config=which,
                             cfg=cfg.name(), ms=ms, bound_ms=bms,
                             bound_by=by, plain_ms=plain, library_ms=lib,
                             model_ms=est, model_over_measured=est / ms,
                             tflops=2.0 * m * n * k / ms / 1e9))
            log(f"[gemm] {m}x{n}x{k} bf16 {which} {cfg.name()}: "
                f"{ms:.3f} ms ({rows[-1]['tflops']:.1f} TFLOP/s), bound "
                f"{bms:.3f} ms ({by}), plain {plain:.3f} ms, torch.matmul "
                f"{lib:.3f} ms; cost model (H100 model, not measured) "
                f"{est:.3f} ms = {est / ms:.3f} x measured")
        del a, b
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


# -- main --------------------------------------------------------------------

def main():
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    summary = {}
    try:
        summary["card"] = phase_card(torch)
        summary["build_s"] = phase_build()
        kern = {}
        for dtype in ("bfloat16", "float32"):
            kern[("paged_decode", dtype)] = phase_decode_kernel(torch, dtype)
            kern[("ragged_prefill", dtype)] = phase_prefill_kernel(torch,
                                                                   dtype)
        summary["kernels"] = {f"{n}/{d}": v for (n, d), v in kern.items()}
        serve = phase_serve(torch)
        summary["serve"] = serve
        summary["paths"] = phase_paths(torch)
        summary["gemm"] = gemm = phase_gemm(torch)
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
            ported=True, dtype="bfloat16"))
    # gemm: the loop's best config at the production problem, 8192^3 bf16
    prod = next(c for c in gemm["kernel"] if c["label"] == "production")
    best = next(r for r in gemm["time"] if r["config"] == "best"
                and r["problem"] == [8192, 8192, 8192])
    line.append(dict(
        name="gemm", route="cuda",
        source="src/repro_torch/kernels/gemm/csrc/gemm.cu",
        replaces="src/repro/kernels/gemm/gemm.py:60",
        launches=gemm["loop"]["launches"]["gemm"],
        max_abs_err=prod["max_abs_err"], ms=best["ms"],
        plain_ms=best["plain_ms"], bound_ms=best["bound_ms"],
        bound_by=best["bound_by"], library_ms=best["library_ms"],
        ported=True, dtype="bfloat16", cfg=best["cfg"]))
    summary["kernels_line"] = line
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(summary, indent=1, sort_keys=True) + "\n")
    log(json.dumps({"tpu_kernels_not_ported": [
        {"name": n, "replaces": r, "ported": False}
        for n, r in TPU_KERNELS_NOT_PORTED]}))
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
