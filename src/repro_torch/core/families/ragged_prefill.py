"""Ragged-prefill attention family — packed variable-length prefill,
verified at the blocks the CUDA kernel runs.

The port of the JAX package's ``core/families/ragged_prefill.py``: the
tile program (:func:`tile_program`), its invariants, skills, injectable
bugs and bug signatures are copied unchanged — offset-bound (cu_seqlens
stays inside the packed buffer, an analysis-stage catch), GQA head
mapping, no cross-sequence leakage (the segment/causal gate's provenance
conforms with the weight it gates), tail masking, packed coverage and
carried-output stability.

**Which decomposition is verified.**  The CUDA kernel
(``repro_torch/kernels/ragged_prefill/csrc/ragged_prefill.cu``) runs, in
bf16 (:func:`is_wgmma`), one CTA per (query head, 128 packed queries)
over 128-key tiles (64-key at a head_dim above 128) on ``wgmma``, and in
float32 one CTA per (query head, 64 packed queries) over 32-key blocks
on the CUDA cores, whatever the config's ``block_q`` / ``block_kv`` are.
:func:`kernel_config` gives the program that step: ``128 x 128``,
``128 x 64`` or ``64 x 32`` wherever they tile the packed buffer.  The
serving engine pads
both extents to 64 tokens, so the wgmma step is 128 on a buffer of a
multiple of 128 tokens and 64 on the others.  On a buffer the kernel's
blocks do not tile (the kernel then masks its last CTA's rows and its
last tile's keys) the program takes the largest power-of-two blocks below
them that do — the same rows and keys, each read once.  The
config's blocks stay the precondition they are in the JAX family: they
must tile the buffer.  Verdicts, findings and counterexamples are the
JAX gate's at those blocks.  A head_dim whose rows are not whole 16-byte
vectors, or above 256, runs on the panel route (:func:`is_panel`): 64
packed queries over 64-key chunks on ``mma.sync`` in bf16, 32 x 32 on
the CUDA cores in float32, one CTA per output panel of 64 or 256
columns, each recomputing S.

The structural and cost hooks are a Hopper model of that kernel; the
oracle (``reference_check``) runs the port's ``ragged_prefill_attend``
on the validator's device against its plain version.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from .. import dsl
from ..costs import (CostEstimate, HBM_BW, L2_BW, MMA_SYNC_DERATE,
                     PEAK_FLOPS, peak_flops, sol_estimate, wave_eff)
from ..kernelspec import (DTYPE_BYTES, StructuralIssue, cdiv, check_smem,
                          ctas_per_sm, n_panels, on_grain, panel_issues,
                          panel_width, tile_width)
from ..tags import Expr, app, make_tag
from .base import (BugSignature, KernelFamily, generic_skill,
                   reference_setup, register)

@dataclass(frozen=True)
class RaggedPrefillProblem:
    n_seqs: int               # packed segments (sequences) per batch
    total_tokens: int         # packed buffer length T (padding included)
    q_heads: int
    kv_heads: int
    head_dim: int
    dtype: str = "bf16"

    @property
    def group(self) -> int:
        return self.q_heads // self.kv_heads

    @property
    def avg_len(self) -> float:
        return self.total_tokens / max(self.n_seqs, 1)


@dataclass(frozen=True)
class RaggedPrefillConfig:
    """Tunable knobs (the harness' action space for this family)."""

    block_q: int = 128        # packed query rows per grid step
    block_kv: int = 128       # packed kv columns per sequential step

    def name(self) -> str:
        return f"ragged[bq={self.block_q},bkv={self.block_kv}]"


# -- the CUDA kernel's decomposition -----------------------------------------

KERNEL_BQ = 64                 # packed queries per CTA (CUDA cores)
KERNEL_BK = 32                 # packed keys per block (CUDA cores)
KERNEL_THREADS = 256
WGMMA_BQ = 128                 # packed queries per CTA: two warpgroups
WGMMA_BK = 128                 # packed keys per TMA tile (64 at head_dim 256)
WGMMA_STAGES = 2               # K/V ring depth
WGMMA_THREADS = 384
CONSUMER_REGS = 232            # setmaxnreg, consumer warpgroups
# static shared arrays beside the dynamic block: on wgmma the four 32-row
# summaries (5 ints), a masked tile's (seg, pos) pairs for each consumer
# warpgroup and the live-tile count; on the CUDA cores the seg/pos of the
# query and key blocks, three ints of query metadata and a flag a thread
WGMMA_STATIC_SMEM = 4 * 5 * 4 + 2 * WGMMA_BK * 8 + 4
KERNEL_STATIC_SMEM = (2 * KERNEL_BQ + 2 * KERNEL_BK + 3) * 4 + KERNEL_THREADS


PANEL_BLOCKS = {"bf16": (64, 64), "f32": (32, 32)}


def is_panel(prob: RaggedPrefillProblem) -> bool:
    """The kernel runs ``prob`` on the panel route: a head_dim off the
    16-byte grain, or above 256."""
    return not on_grain(prob.head_dim, DTYPE_BYTES.get(prob.dtype, 2))


def is_wgmma(prob: RaggedPrefillProblem) -> bool:
    """The kernel runs ``prob`` on its wgmma design: bf16 at every
    head_dim of whole 16-byte rows up to 256 (float32 stays on the CUDA
    cores; the panel route on mma.sync)."""
    return prob.dtype == "bf16" and not is_panel(prob)


def instance_name(prob: RaggedPrefillProblem) -> str:
    """The instance that runs ``prob``: "wgmma W=128" (bf16 at head_dim
    65..128), "cuda cores" (float32); on the panel route its panels,
    "panel mma.sync 2x256" (bf16 at 320)."""
    if is_panel(prob):
        kind = "mma.sync" if prob.dtype == "bf16" else "cuda cores"
        return (f"panel {kind} {n_panels(prob.head_dim)}x"
                f"{panel_width(prob.head_dim)}")
    if is_wgmma(prob):
        return f"wgmma W={tile_width(prob.head_dim)}"
    return "cuda cores"


def kernel_blocks(prob: RaggedPrefillProblem):
    """(packed queries per CTA, keys per step) of the design that runs
    ``prob``: 128 x 128 on wgmma (128 x 64 at width 256, where Q and a
    two-stage ring of 128-key tiles would not fit), on the panel route 64
    x 64 in bf16 and 32 x 32 in float32, else 64 x 32."""
    if is_panel(prob):
        return PANEL_BLOCKS.get(prob.dtype, PANEL_BLOCKS["bf16"])
    if not is_wgmma(prob):
        return KERNEL_BQ, KERNEL_BK
    wide = tile_width(prob.head_dim) == 256
    return WGMMA_BQ, WGMMA_BK // 2 if wide else WGMMA_BK


def kernel_config(cfg: RaggedPrefillConfig,
                  prob: RaggedPrefillProblem) -> RaggedPrefillConfig:
    """The config whose program is the decomposition the kernel runs:
    the kernel's blocks (:func:`kernel_blocks`: 128 x 128 on wgmma, 128 x
    64 at width 256, else 64 x 32), or the largest power-of-two blocks
    below them that tile the buffer.  Raises ``ValueError`` where the JAX
    program would: the config's blocks must tile the buffer."""
    T = prob.total_tokens
    if T % cfg.block_q or T % cfg.block_kv:
        raise ValueError(
            f"block_q {cfg.block_q} and block_kv {cfg.block_kv} must tile "
            f"the packed buffer ({T} tokens)")
    bq0, bk0 = kernel_blocks(prob)
    pow2 = lambda top: next(b for b in (128, 64, 32, 16, 8, 4, 2, 1)
                            if b <= top and T % b == 0)
    return RaggedPrefillConfig(block_q=pow2(bq0), block_kv=pow2(bk0))


def _kernel_config_or_cfg(cfg, prob):
    try:
        return kernel_config(cfg, prob)
    except ValueError:
        return cfg


def tile_program(cfg: RaggedPrefillConfig,
                                 prob: RaggedPrefillProblem,
                                 *, inject_bug: Optional[str] = None
                                 ) -> dsl.TileProgram:
    """Packed self-attention masked by segment identity and causality.

    ``inject_bug`` deliberately mis-lowers one aspect (the fault model's
    menu; every entry must be caught).  Supported:
    "cu_oob"           — cu_seqlens declared with a result range past the
                         packed buffer (caught at the analysis stage by
                         the interval check, pre-solver);
    "wrong_kv_head"    — KV read for head h instead of h // group;
    "cross_seq_leak"   — the segment/causal gate's query segment id is
                         hoisted to the query block's first row, so a
                         block straddling a sequence boundary attends
                         across it;
    "causal_off_by_one"— the gate admits kv position pos_q + 1
                         (<= instead of <, shifted);
    "wrong_cu_base"    — the gate's positions are computed from the
                         *next* segment's cu_seqlens entry (a 1-based /
                         0-based confusion on the offset vector);
    "segment_skip"     — the sequential kv grid is one block short;
    "segment_replay"   — the kv block offset is dropped, so every step
                         re-reads the first packed block;
    "mask_dropped_tail"— the padding-tail gate is applied at block
                         granularity (its provenance is the block's
                         first column), so a partial trailing block
                         admits padding tokens past cu(S);
    "acc_depends_kv"   — the carried output tagged with the kv axis.
    """
    T, S, D = prob.total_tokens, prob.n_seqs, prob.head_dim
    H, HK, G = prob.q_heads, prob.kv_heads, prob.group
    bq, bkv = cfg.block_q, cfg.block_kv
    if T % bq or T % bkv:
        raise ValueError(
            f"block_q {bq} and block_kv {bkv} must tile the packed "
            f"buffer ({T} tokens)")
    nq = T // bq
    nk = T // bkv
    if inject_bug == "segment_skip":
        nk = max(1, nk - 1)
    if inject_bug == "wrong_kv_head" and H == HK:
        raise ValueError("wrong_kv_head requires GQA")

    p = dsl.TileProgram(cfg.name())
    hq = p.add_grid("hq", H, "parallel")
    qb = p.add_grid("qb", nq, "parallel")
    kb = p.add_grid("kb", nk, "arbitrary")

    p.tensor("Q", (H, T, D), prob.dtype,
             tag_fn=lambda h, t, c: make_tag(h // G, t, c))
    p.tensor("K", (HK, T, D), prob.dtype)
    p.tensor("V", (HK, T, D), prob.dtype)
    # read-marker: the packed kv rows this (hq, qb, kb) step consumed
    p.tensor("KV_READ", (H * nq, T, D), prob.dtype, kind="output")
    p.tensor("O", (H, T, D), "f32", kind="output")

    hk = hq if inject_bug == "wrong_kv_head" else hq // G

    # the packing metadata: segment ids and cu_seqlens offsets are
    # runtime routing data (like paged attention's block table), modeled
    # as uninterpreted applications.  An out-of-range offset vector
    # models packing metadata that can point past the buffer.
    cu_extent = T + 2 if inject_bug == "cu_oob" else T + 1
    sg = lambda t: app("seg_id", t, S)
    cu = lambda s: app("cu_seqlens", s, cu_extent)
    pos = lambda t: t - cu(sg(t))
    # total valid tokens: everything at or past cu(S) is packing padding
    cu_total = cu(Expr.of(S))

    tq0, tk0 = qb * bq, kb * bkv
    if inject_bug == "segment_replay":
        tk0 = kb * 0             # block offset dropped: block 0 again

    # invariant 1 — offset-bound: every segment offset the mask consumes
    # stays inside the packed buffer (interval verdict: analysis stage)
    p.assert_in_range(cu(sg(tq0)), T + 1, "segment offset (q)")
    p.assert_in_range(cu(sg(tk0)), T + 1, "segment offset (kv)")
    p.assert_in_range(cu_total, T + 1, "segment offset (total)")

    q = p.squeeze(p.load("Q", (hq, tq0, 0), (1, bq, D)))
    k = p.squeeze(p.load("K", (hk, tk0, 0), (1, bkv, D)))
    v = p.squeeze(p.load("V", (hk, tk0, 0), (1, bkv, D)))

    # invariant 2 — GQA head mapping (q's kv-group == loaded kv head)
    p.assert_conform(q, k, bind=((1, 1),), components=((0,), (0,)))

    # relabel packed tiles with their (segment, position) provenance —
    # the tags the leakage mask consumes; identity components stay
    # asserted (packed row and channel)
    q_seg = p.elementwise(
        "seg_relabel", q,
        retag=lambda i, c, _o=tq0: make_tag(
            hq // G, sg(_o + i), pos(_o + i), c))
    p.assert_conform(q, q_seg, bind=((0, 0), (1, 1)),
                     components=((0, 2), (0, 3)))
    k_seg = p.elementwise(
        "seg_relabel", k,
        retag=lambda j, c, _o=tk0: make_tag(
            hk, sg(_o + j), pos(_o + j), c))
    p.assert_conform(k, k_seg, bind=((0, 0), (1, 1)),
                     components=((0, 2), (0, 3)))
    v_seg = p.elementwise(
        "seg_relabel", v,
        retag=lambda j, c, _o=tk0: make_tag(
            hk, sg(_o + j), pos(_o + j), c))

    # invariant 5 — packed coverage: across (hq, qb, kb) the packed kv
    # range is read exactly once per (head, query block)
    p.store("KV_READ", k_seg, (hq * nq + qb, tk0, 0))

    st_tag = lambda i, j, _q=tq0, _k=tk0: make_tag(
        sg(_q + i), sg(_k + j), pos(_q + i), pos(_k + j))
    st = p.matmul(q_seg, p.transpose(k_seg), retag=st_tag)
    # invariant 3 — position honesty: the score's declared kv
    # (segment, position) is that of the key it was computed from
    p.assert_conform(st, k_seg, bind=((1, 0),),
                     components=((1, 3), (1, 2)))

    pt = p.elementwise("exp_sub_m", st, retag=st_tag)
    # the weighted value consumes the same (segment, position) pairs
    p.assert_conform(pt, v_seg, bind=((1, 0),),
                     components=((1, 3), (1, 2)))

    # invariant 4 — leakage-gate conformity: the segment/causal gate
    # admits a score only when the kv element belongs to the query's
    # sequence (seg_q == seg_k) at a position not past the query's
    # (pos_k <= pos_q).  The gate's tag carries the exact
    # (seg_q, seg_k, pos_q, pos_k) quadruple it gated, and the weight
    # entering the accumulator must conform with it — so cross-sequence
    # reads, off-by-one causality and mis-based offsets are all
    # solver-refutable, not silent.
    if inject_bug == "cross_seq_leak":
        # query segment id hoisted to the block's first row: rows past
        # a sequence boundary inside the block leak across it
        gate_tag = lambda i, j, _q=tq0, _k=tk0: make_tag(
            sg(_q), sg(_k + j), pos(_q + i), pos(_k + j))
    elif inject_bug == "causal_off_by_one":
        # gate admits kv position pos_q + 1 (<= instead of <, shifted)
        gate_tag = lambda i, j, _q=tq0, _k=tk0: make_tag(
            sg(_q + i), sg(_k + j), pos(_q + i) + 1, pos(_k + j))
    elif inject_bug == "wrong_cu_base":
        # positions measured from the NEXT segment's start offset
        wpos = lambda t: t - cu(sg(t) + 1)
        gate_tag = lambda i, j, _q=tq0, _k=tk0: make_tag(
            sg(_q + i), sg(_k + j), wpos(_q + i), wpos(_k + j))
    else:
        gate_tag = st_tag
    gate = p.elementwise("seg_causal_gate", st, retag=gate_tag)
    ptg = p.elementwise("apply_seg_gate", pt, gate, retag=st_tag)
    p.assert_conform(ptg, gate, bind=((0, 0), (1, 1)),
                     components=((0, 1, 2, 3), (0, 1, 2, 3)))

    # invariant 4b — tail gate: packed positions at or past cu(S) are
    # padding and must die before the accumulator.  Its provenance is
    # (packed kv position, total): a gate applied at block granularity
    # carries the block's first column instead and fails to conform.
    if inject_bug == "mask_dropped_tail":
        tail_tag = lambda i, j, _k=tk0: make_tag(_k, cu_total)
    else:
        tail_tag = lambda i, j, _k=tk0: make_tag(_k + j, cu_total)
    tail = p.elementwise("tail_gate", st, retag=tail_tag)
    pt2 = p.elementwise(
        "apply_tail_gate", ptg, tail,
        retag=lambda i, j, _k=tk0: make_tag(_k + j, cu_total))
    p.assert_conform(pt2, tail, bind=((0, 0), (1, 1)),
                     components=((0, 1), (0, 1)))

    o_part = p.matmul(pt2, v_seg,
                      retag=lambda i, c, _q=tq0: make_tag(hq, _q + i, c))
    acc = p.alloc((bq, D), "f32")
    if inject_bug == "acc_depends_kv":
        acc_tag = lambda i, c, _q=tq0: make_tag(hq, _q + i, Expr.of(kb), c)
    else:
        acc_tag = lambda i, c, _q=tq0: make_tag(hq, _q + i, c)
    p.update(acc, o_part, fn="flash_acc", retag=acc_tag)

    # invariant 6 — online-softmax carry is stable across the kv axis
    p.assert_stable(acc, "kb")
    p.assert_disjoint_writes("KV_READ", axes=("hq", "qb", "kb"))
    p.assert_coverage("KV_READ")

    p.store("O", acc, (hq, tq0, 0))
    p.assert_disjoint_writes("O", axes=("hq", "qb"))
    p.assert_coverage("O")
    return p


def build_ragged_prefill_program(cfg: RaggedPrefillConfig,
                                 prob: RaggedPrefillProblem,
                                 *, inject_bug: Optional[str] = None
                                 ) -> dsl.TileProgram:
    """The JAX family's program at the kernel's blocks
    (:func:`kernel_config`); the config's blocks are a precondition."""
    return tile_program(kernel_config(cfg, prob), prob,
                        inject_bug=inject_bug)


def _smem_bytes(prob: RaggedPrefillProblem) -> int:
    """The kernel's shared memory for ``prob``, static arrays included:
    on wgmma 1024 bytes of alignment slack, the Q tile, a two-stage ring
    of K and V tiles (128-byte swizzle, rows of ``tile_width``), the
    mbarriers, and a flag byte and a 2-byte list entry a key tile;
    otherwise Q, K, V and the weights as float32, rows of the same width
    padded by one word.  The panel route: a 64-column chunk of Q and of
    K, the chunk's V rows at the panel's width (rows padded by 16 bytes;
    in f32 the weights too) and the seg/pos of its rows and keys."""
    D = prob.head_dim
    if is_panel(prob):
        bq, bk = kernel_blocks(prob)
        pw = panel_width(D)
        if prob.dtype == "f32":
            dyn = ((bq + bk) * 68 + bk * (pw + 4) + bq * (bk + 1)) * 4
        else:
            dyn = ((bq + bk) * 72 + bk * (pw + 8)) * 2
        return dyn + (4 * 64 + 4) * 4
    if is_wgmma(prob):
        _, bk = kernel_blocks(prob)
        W = tile_width(D)
        n_tiles = cdiv(prob.total_tokens, bk)
        return (1024 + WGMMA_BQ * W * 2 + 2 * WGMMA_STAGES * bk * W * 2
                + 8 * (1 + 4 * WGMMA_STAGES) + 2 * cdiv(n_tiles, 2)
                + 2 * n_tiles + WGMMA_STATIC_SMEM)
    # the CUDA-core kernel stages rows at the same widths, zero past D
    return ((KERNEL_BQ + 2 * KERNEL_BK) * (tile_width(D) + 1)
            + KERNEL_BQ * (KERNEL_BK + 1)) * 4 + KERNEL_STATIC_SMEM


def structural_ragged_prefill(cfg: RaggedPrefillConfig,
                              prob: RaggedPrefillProblem):
    """Hopper model of ``ragged_prefill.cu``: blocks that do not tile the
    buffer, more segments than tokens, its shared memory per CTA, and on
    the panel route its narrow copies and output panels."""
    issues = []
    if prob.total_tokens % cfg.block_q or prob.total_tokens % cfg.block_kv:
        issues.append(StructuralIssue(
            "masking", f"blocks ({cfg.block_q}, {cfg.block_kv}) do not "
                       f"tile the packed buffer ({prob.total_tokens} "
                       f"tokens) — pad before packing"))
    if prob.n_seqs > prob.total_tokens:
        issues.append(StructuralIssue(
            "capacity", f"{prob.n_seqs} segments cannot pack into "
                        f"{prob.total_tokens} tokens"))
    issues += check_smem("CTA", _smem_bytes(prob))
    if is_panel(prob):
        issues += panel_issues("Q/K/V", prob.head_dim, prob.dtype)
    return issues


def ragged_prefill_cost(cfg: RaggedPrefillConfig,
                        prob: RaggedPrefillProblem) -> CostEstimate:
    """H100 model of ``ragged_prefill.cu``: one CTA per (query head,
    block of packed queries) visits only the key tiles that share a
    segment with its rows and are not causally past them (about the
    segment's prefix, plus the query block's own span).  On wgmma
    (:func:`is_wgmma`) it issues S = Q·Kᵀ over the 16-column k-steps that
    hold real columns and P·V twice over ``tile_width`` (p split into
    two bf16 terms) at the
    tensor cores' peak, one CTA an SM; otherwise
    float32 FMAs on the CUDA cores.  Q, K, V and O cross HBM once and the
    KV re-reads of the CTAs of one head hit L2.  The config's blocks
    change nothing the kernel does."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    T, D = prob.total_tokens, prob.head_dim
    H, HK = prob.q_heads, prob.kv_heads
    bq, _ = kernel_blocks(prob)
    nq = cdiv(T, bq)
    # causal within each segment: ~half the full packed score rectangle
    flops = 4.0 * H * T * (prob.avg_len / 2.0) * D
    q_bytes = 2 * H * T * D * sz                      # Q in, O out
    kv_bytes = 2 * HK * T * D * sz
    meta_bytes = (prob.n_seqs + 1) * 4 + 2 * T * 4    # cu + seg/pos ids
    walked = prob.avg_len / 2.0 + bq                  # keys a query tile
    kv_reread = 2 * H * nq * walked * D * sz
    n_ctas = H * nq
    hbm = q_bytes + kv_bytes + meta_bytes
    if is_panel(prob):
        # one CTA a panel, each repeating S and re-reading Q and K
        panels = n_panels(D)
        n_ctas *= panels
        kv_reread *= panels
        issued = 2.0 * H * T * walked * (panels * cdiv(D, 16) * 16
                                         + 2 * cdiv(D, 16) * 16)
        per_sm = ctas_per_sm(128, 128, _smem_bytes(prob))
        rate = (peak_flops("bf16") * MMA_SYNC_DERATE
                if prob.dtype == "bf16" else PEAK_FLOPS["f32"])
        compute_s = issued / (rate * wave_eff(n_ctas, per_sm))
    elif is_wgmma(prob):
        # S, then P·V twice
        issued = 2.0 * H * T * walked * (cdiv(D, 16) * 16
                                         + 2 * tile_width(D))
        per_sm = ctas_per_sm(WGMMA_THREADS, CONSUMER_REGS, _smem_bytes(prob))
        compute_s = issued / (peak_flops("bf16") * wave_eff(n_ctas, per_sm))
    else:
        per_sm = ctas_per_sm(KERNEL_THREADS, 64, _smem_bytes(prob))
        compute_s = flops / (PEAK_FLOPS["f32"] * wave_eff(n_ctas, per_sm))
    return CostEstimate(
        compute_s=compute_s,
        memory_s=hbm / HBM_BW + kv_reread / L2_BW,
        flops=flops, hbm_bytes=hbm)


def ragged_prefill_sol(prob: RaggedPrefillProblem) -> CostEstimate:
    """Speed of light: one dense-rate pass over the packed Q/KV/O plus
    the packing metadata, against the admitted products at the dtype's
    peak."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    T, D = prob.total_tokens, prob.head_dim
    H, HK = prob.q_heads, prob.kv_heads
    flops = 4.0 * H * T * (prob.avg_len / 2.0) * D
    traffic = (2 * H * T * D + 2 * HK * T * D) * sz \
        + (prob.n_seqs + 1) * 4 + 2 * T * 4
    return sol_estimate(flops, traffic, prob.dtype)


def _block_steps(cfg: RaggedPrefillConfig, prob: RaggedPrefillProblem):
    out = []
    for field in ("block_q", "block_kv"):
        cur = getattr(cfg, field)
        for nxt in (cur * 2, cur // 2):
            if 8 <= nxt <= 512 and prob.total_tokens % nxt == 0:
                out.append((f"{field}={nxt}",
                            replace(cfg, **{field: nxt})))
    return out


SKILLS = (
    generic_skill("retile", "ragged_prefill", _block_steps),
    generic_skill("software_pipelining", "ragged_prefill"),
    generic_skill("vectorized_io", "ragged_prefill"),
    generic_skill("f32_vmem_accumulate", "ragged_prefill"),
)


INJECTABLE_BUGS = ("cu_oob", "wrong_kv_head", "cross_seq_leak",
                   "causal_off_by_one", "wrong_cu_base", "segment_skip",
                   "segment_replay", "mask_dropped_tail",
                   "acc_depends_kv")


def compatible_bugs(cfg: RaggedPrefillConfig,
                    prob: RaggedPrefillProblem):
    """The JAX family's menu for the program that is verified: the one
    at the kernel's blocks."""
    return _jax_compatible_bugs(_kernel_config_or_cfg(cfg, prob), prob)


def _jax_compatible_bugs(cfg: RaggedPrefillConfig,
                    prob: RaggedPrefillProblem):
    menu = list(INJECTABLE_BUGS)
    if prob.q_heads == prob.kv_heads:
        menu.remove("wrong_kv_head")
    if cfg.block_q < 2:
        menu.remove("cross_seq_leak")   # one row per block: no hoist
    if cfg.block_kv < 2:
        menu.remove("mask_dropped_tail")  # no partial-block tail
    if prob.total_tokens // cfg.block_kv < 2:
        menu.remove("segment_skip")     # one block IS the whole range
        menu.remove("segment_replay")   # nothing to replay into
    return menu


# Ground truth (tests/test_families.py checks it against live feedback).
# segment_replay additionally under-covers the packed KV range, but only
# the disjointness pattern is *its* fingerprint.
BUG_SIGNATURES = (
    BugSignature("cu_oob", ("analysis",),
                 ("assert_in_range(segment offset",)),
    BugSignature("wrong_kv_head", ("solver",),
                 ("assert_conform(sq_1,sq_3)",)),
    BugSignature("cross_seq_leak", ("solver",),
                 ("assert_conform(e_13,e_12)",)),
    BugSignature("causal_off_by_one", ("solver",),
                 ("assert_conform(e_13,e_12)",)),
    BugSignature("wrong_cu_base", ("solver",),
                 ("assert_conform(e_13,e_12)",)),
    BugSignature("segment_skip", ("solver",),
                 ("assert_coverage(KV_READ)",)),
    BugSignature("segment_replay", ("solver",),
                 ("assert_disjoint(KV_READ)",)),
    BugSignature("mask_dropped_tail", ("solver",),
                 ("assert_conform(e_15,e_14)",)),
    BugSignature("acc_depends_kv", ("analysis",), ("assert_stable(",)),
)


# -- reference execution (the kernel against its plain version) ------------

def reference_check(cfg: RaggedPrefillConfig,
                    prob: RaggedPrefillProblem, device="cuda") -> bool:
    """Run the port's validated ``ragged_prefill_attend`` with the
    config's blocks (at most 64) on ``device`` (the CUDA kernel on the
    card, the plain version on the CPU) against the plain version, in the
    problem's dtype, on the JAX check's packing: three segments with a
    deliberately partial tail (~25% padding) and an empty one, within
    ``REF_TOL``.  Precondition errors propagate to the validator."""
    import numpy as np
    import torch
    from repro_torch.kernels.ragged_prefill import (ragged_prefill_attend,
                                                    ragged_prefill_ref)
    from repro_torch.kernels.ragged_prefill.packing import (cu_seqlens,
                                                            ragged_metadata)
    make, dev, tol = reference_setup("ragged_prefill", prob.dtype, device)
    HK, D = max(prob.kv_heads, 1), min(prob.head_dim, 64)
    H = HK * min(prob.group, 4)
    bq, bkv = min(cfg.block_q, 64), min(cfg.block_kv, 64)
    scfg = RaggedPrefillConfig(block_q=bq, block_kv=bkv)
    T = 4 * max(bq, bkv)
    seg, pos = (torch.from_numpy(np.asarray(a, np.int32)).to(dev)
                for a in ragged_metadata(cu_seqlens([T // 4, 0, T // 2]), T))
    q, k, v = make((H, T, D)), make((HK, T, D)), make((HK, T, D))
    o = ragged_prefill_attend(q, k, v, seg, pos, seg, pos, cfg=scfg)
    w = ragged_prefill_ref(q, k, v, seg, pos, seg, pos)
    return bool(torch.allclose(o.float(), w.float(), rtol=tol, atol=tol))


def _lower():
    from repro_torch.kernels import ragged_prefill
    return ragged_prefill


def _example():
    # a chunked-prefill serving tick: 8 pending prompts packed into a
    # 2k buffer, GQA 8:1 (the reduced serving arch's head geometry)
    return (RaggedPrefillConfig(block_q=128, block_kv=128),
            RaggedPrefillProblem(8, 2048, 8, 1, 128, "bf16"))


def _sweep():
    # pow2 bucket grid: the serving point plus a many-short-sequences
    # and a few-long-sequences point
    return [RaggedPrefillProblem(8, 2048, 8, 1, 128, "bf16"),
            RaggedPrefillProblem(32, 8192, 8, 1, 128, "bf16"),
            RaggedPrefillProblem(4, 512, 8, 1, 128, "bf16")]


FAMILY = register(KernelFamily(
    name="ragged_prefill",
    config_cls=RaggedPrefillConfig,
    problem_cls=RaggedPrefillProblem,
    build_program=build_ragged_prefill_program,
    structural=structural_ragged_prefill,
    cost=ragged_prefill_cost,
    skills=SKILLS,
    injectable_bugs=INJECTABLE_BUGS,
    bug_signatures=BUG_SIGNATURES,
    compatible_bugs=compatible_bugs,
    reference_check=reference_check,
    kernel="ragged_prefill",
    lower=_lower,
    example=_example,
    sweep_problems=_sweep,
    sol_bound=ragged_prefill_sol,
))


def verify_ragged_prefill(cfg: RaggedPrefillConfig,
                          prob: RaggedPrefillProblem,
                          *, inject_bug: Optional[str] = None):
    return FAMILY.verify(cfg, prob, inject_bug=inject_bug)

