"""Paged-attention decode family — serving decode over a block-table-
indexed KV cache, verified at the step the CUDA kernel runs.

The port of the JAX package's ``core/families/paged_attention.py``: the
tile program (:func:`tile_program`), its invariants, skills, injectable
bugs and bug signatures are copied unchanged — page-bound (the table
stays inside the pool, an analysis-stage catch), one table for both
operands, GQA head mapping, logical coverage of the sequence's pages,
position honesty, length-gate conformity and carried-output stability.

**Which decomposition is verified.**  The CUDA kernel
(``repro_torch/kernels/paged_attention/csrc/paged_decode.cu``) cuts each
row's pages into spans of :func:`span_pages` pages, a number fixed by
the shapes alone, one CTA per (span, KV head, block of up to 8 query
heads, row), and merges the spans' partials by log-sum-exp in a second
kernel.  Each span walks its pages in tiles of :func:`tile_tokens` rows
(16 KB of K and of V at the instance's ``tile_width``: 128 rows in bf16
at width 64, 64 at 128, 32 at 256; 64, 32 or 16 in f32), a tile holding
:func:`pages_per_step` whole pages (each in a slot of
:func:`page_slot` rows, the rest of the tile masked), or a chunk of one
page longer than a tile; a span is a whole number of tiles, the last
span shorter where that count does not divide the table width.
:func:`build_paged_attention_program` builds the JAX program at
``block_pages = gcd(step, width)`` (:func:`kernel_config`): every kernel
tile, the short last one included, is a whole run of consecutive
program steps (six 16-token pages at four pages a bf16 tile: the kernel
walks 4 + 2 pages, the program 2 + 2 + 2), or a part of one step where a
page spans several tiles, and every span is a run of whole program
steps, so the program each span walks is the JAX program over the
span's pages.  ``block_pages`` stays the precondition it is in the JAX
family: it must divide the table width.  A geometry the kernel cannot
run (a head_dim that is not whole 16-byte vectors or is above 256, a
page of one token) is a build error.  Verdicts, findings and
counterexamples are the JAX gate's at that step.

The structural and cost hooks are a Hopper model of that kernel
(:mod:`repro_torch.core.kernelspec`, :mod:`repro_torch.core.costs`); the
oracle (``reference_check``) runs the port's ``paged_decode`` on the
validator's device against its plain version.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

from .. import dsl
from ..costs import (CostEstimate, HBM_BW, L2_BW, MMA_SYNC_DERATE,
                     PEAK_FLOPS, sol_estimate, stream_eff, wave_eff)
from ..kernelspec import (DTYPE_BYTES, GROUP_BLOCK, MAX_HEAD_DIM, N_SMS,
                          VECTOR_BYTES, StructuralIssue, cdiv,
                          check_vector_alignment, ctas_per_sm, head_blocks,
                          head_dim_ok, tile_width)
from ..tags import Expr, app, make_tag
from .base import (BugSignature, KernelFamily, generic_skill,
                   reference_setup, register)

@dataclass(frozen=True)
class PagedAttentionProblem:
    batch: int
    q_heads: int
    kv_heads: int
    seq_kv: int               # logical tokens per sequence
    page_size: int            # tokens per physical page
    pool_pages: int           # physical pages in the KV pool
    head_dim: int
    dtype: str = "bf16"

    @property
    def group(self) -> int:
        return self.q_heads // self.kv_heads

    @property
    def pages_per_seq(self) -> int:
        return cdiv(self.seq_kv, self.page_size)


@dataclass(frozen=True)
class PagedAttentionConfig:
    """Tunable knobs (the harness' action space for this family)."""

    block_pages: int = 2      # logical pages gathered per sequential step

    def name(self) -> str:
        return f"paged[bp={self.block_pages}]"


# -- the CUDA kernel's decomposition -----------------------------------------

MIN_PAGE = 2                   # page sizes (tokens) the kernel takes: >= 2
TILE_BYTES = 16384             # one K (or V) tile
STAGES = 3                     # TMA ring depth of the tensor-core instance
KERNEL_THREADS = 128           # the CUDA-core instance
TC_THREADS = 160               # four consumer warps (two at 256), a producer
# CTAs the span split aims for: four for each SM (two resident at a time)
SPAN_TARGET_CTAS = 4 * N_SMS


def tensor_cores(head_dim: int, itemsize: int) -> bool:
    """The instance that runs: bf16 on the tensor cores fed by TMA at
    every head_dim it takes; float32 on CUDA-core FMAs."""
    return itemsize == 2 and head_dim_ok(head_dim, itemsize)


def instance_name(head_dim: int, itemsize: int) -> str:
    """The instance that runs, with its tile width (``tile_width``):
    "tensor cores W=128" (bf16 at head_dim 65..128), "cuda cores W=64"
    (float32 up to 64)."""
    kind = ("tensor cores" if tensor_cores(head_dim, itemsize)
            else "cuda cores")
    return f"{kind} W={tile_width(head_dim)}"


def tile_tokens(head_dim: int, itemsize: int) -> int:
    """Rows of K (and of V) in one tile of the walk: 16 KB on the tensor
    cores (128 positions at width 64, 64 at 128, 32 at 256); on the
    CUDA-core instance the largest power of two that fits 16 KB at its
    width, at most 64 (64 at width 64, 32 at 128, 16 at 256)."""
    w = tile_width(head_dim)
    if tensor_cores(head_dim, itemsize):
        return TILE_BYTES // (w * itemsize)
    fit = min(64, TILE_BYTES // (w * itemsize))
    return 1 << (fit.bit_length() - 1)


def page_slot(page_size: int, head_dim: int, itemsize: int) -> int:
    """Rows a page of at most one tile takes in it: on the tensor cores
    the page size rounded up to 8 (each TMA box starts 1024-byte aligned
    in the 128-byte-swizzled tile), on the CUDA cores the page size."""
    if tensor_cores(head_dim, itemsize):
        return -(-page_size // 8) * 8
    return page_size


def pages_per_step(page_size: int, head_dim: int, itemsize: int) -> int:
    """Pages one tile of the walk holds: the whole pages that fit it
    (tile // page slot), or 1 where a page is longer than a tile and is
    walked in tile-sized chunks (its last one short where the tile does
    not divide it); 0 where the kernel cannot run the geometry: a
    head_dim that is not whole 16-byte vectors or is above 256, or a page
    of fewer than 2 tokens."""
    if not head_dim_ok(head_dim, itemsize) or page_size < MIN_PAGE:
        return 0
    tile = tile_tokens(head_dim, itemsize)
    if page_size <= tile:
        return tile // page_slot(page_size, head_dim, itemsize)
    return 1


def span_pages(batch: int, kv_heads: int, pages_per_seq: int,
               page_size: int, head_dim: int, itemsize: int,
               group: int = 1) -> int:
    """Pages of one span of a row's walk, from the shapes alone (never
    the lengths, so the grid is fixed for a decode geometry): whole
    tiles (whole pages where a page spans tiles), as few as give
    ``batch x kv_heads x head_blocks(group) x spans`` about
    ``SPAN_TARGET_CTAS`` CTAs."""
    step = pages_per_step(page_size, head_dim, itemsize)
    if not step:
        raise ValueError(f"the CUDA kernel cannot walk {page_size}-token "
                         f"pages at head_dim {head_dim}")
    units = cdiv(pages_per_seq, step)
    want = cdiv(SPAN_TARGET_CTAS,
                max(batch * kv_heads * head_blocks(group), 1))
    return cdiv(units, min(units, want)) * step


def n_spans(prob: PagedAttentionProblem) -> int:
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    sp = span_pages(prob.batch, prob.kv_heads, prob.pages_per_seq,
                    prob.page_size, prob.head_dim, sz, prob.group)
    return cdiv(prob.pages_per_seq, sp)


def _refusal(prob: PagedAttentionProblem) -> str:
    return (f"the CUDA kernel takes head_dim up to {MAX_HEAD_DIM} in rows "
            f"of whole {VECTOR_BYTES}-byte vectors and pages of at least "
            f"{MIN_PAGE} tokens; got head_dim {prob.head_dim} in "
            f"{prob.dtype}, page_size {prob.page_size}")


def kernel_config(cfg: PagedAttentionConfig,
                  prob: PagedAttentionProblem) -> PagedAttentionConfig:
    """The config whose program the kernel's tiles and spans are made of
    for ``cfg`` on ``prob``: ``block_pages`` = gcd(the pages of a tile,
    the table width).  Raises ``ValueError`` where the JAX program would
    (the preconditions on ``page_size`` and ``block_pages``) and where
    the kernel cannot run."""
    if prob.seq_kv % prob.page_size != 0:
        raise ValueError("page_size must tile seq_kv")
    NP = prob.pages_per_seq
    if NP % cfg.block_pages != 0:
        raise ValueError(
            f"block_pages {cfg.block_pages} must divide the "
            f"{NP} pages per sequence")
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    step = pages_per_step(prob.page_size, prob.head_dim, sz)
    if not step:
        raise ValueError(_refusal(prob))
    return PagedAttentionConfig(block_pages=math.gcd(step, NP))


def _kernel_config_or_cfg(cfg, prob):
    try:
        return kernel_config(cfg, prob)
    except ValueError:
        return cfg


def tile_program(cfg: PagedAttentionConfig,
                                  prob: PagedAttentionProblem,
                                  *, inject_bug: Optional[str] = None
                                  ) -> dsl.TileProgram:
    """Decode attention gathered through the block table.

    ``inject_bug`` deliberately mis-lowers one aspect (the fault model's
    menu; every entry must be caught).  Supported:
    "page_oob"         — table declared with a result range larger than
                         the pool (caught at the analysis stage by the
                         interval check, pre-solver);
    "v_stale_table"    — V gathered through a different (stale) table;
    "wrong_kv_head"    — KV gathered for head h instead of h // group;
    "page_skip"        — the sequential page grid is one block short;
    "page_replay"      — the intra-block page offset is dropped, so each
                         step re-gathers its first page;
    "pos_from_physical"— score positions computed from the physical page
                         index instead of the logical one;
    "mask_off_by_one"  — the length gate admits one position past the
                         sequence's logical length (<= len instead of
                         < len);
    "null_page_leak"   — the length gate is computed once per page block
                         (hoisted to the block's first page), so the
                         block's trailing pages — exactly where the null
                         pages sit — are gated with the wrong bound and
                         leak into the accumulator;
    "acc_depends_page" — the carried output tagged with the page axis.
    """
    if prob.seq_kv % prob.page_size != 0:
        raise ValueError("page_size must tile seq_kv")
    NP = prob.pages_per_seq
    if NP % cfg.block_pages != 0:
        raise ValueError(
            f"block_pages {cfg.block_pages} must divide the "
            f"{NP} pages per sequence")
    p = dsl.TileProgram(cfg.name())
    B, H, HK = prob.batch, prob.q_heads, prob.kv_heads
    S, D, PS = prob.seq_kv, prob.head_dim, prob.page_size
    P, G = prob.pool_pages, prob.group
    nblk = NP // cfg.block_pages
    if inject_bug == "page_skip":
        nblk = max(1, nblk - 1)

    bh = p.add_grid("bh", B * H, "parallel")
    pg = p.add_grid("pg", nblk, "arbitrary")

    p.tensor("Q", (B, H, 1, D), prob.dtype,
             tag_fn=lambda b, h, r, c: make_tag(b, h // G, r, c))
    # physical page pools: identity tags (page, kv head, row, col)
    p.tensor("KP", (P, HK, PS, D), prob.dtype)
    p.tensor("VP", (P, HK, PS, D), prob.dtype)
    # read-marker: the logical cache rows this (bh, pg) step consumed
    p.tensor("KV_READ", (B * H, S, D), prob.dtype, kind="output")
    p.tensor("O", (B * H, 1, D), "f32", kind="output")

    b = bh // H
    h = bh % H
    hk = h if inject_bug == "wrong_kv_head" else h // G
    if inject_bug == "wrong_kv_head" and H == HK:
        raise ValueError("wrong_kv_head requires GQA")

    # the block table: logical page -> physical page, per sequence.  An
    # out-of-range table models a mapping that can point past the pool.
    bt_extent = P + 3 if inject_bug == "page_oob" else P
    bt = lambda lp: app("bt", b * NP + lp, bt_extent)
    vbt = (lambda lp: app("bt_stale", b * NP + lp, P)) \
        if inject_bug == "v_stale_table" else bt
    # the per-sequence logical length: runtime routing data like the
    # table itself, modeled as an uninterpreted application in [0, S]
    ln = app("seq_len", b, S + 1)

    q = p.squeeze(p.load("Q", (b, h, 0, 0), (1, 1, 1, D)), keep=(2,))

    acc = p.alloc((1, D), "f32")
    for u in range(cfg.block_pages):
        if inject_bug == "page_replay":
            lp = pg * cfg.block_pages + 0   # offset dropped: page 0 again
        else:
            lp = pg * cfg.block_pages + u
        phys = bt(lp)
        # invariant 1 — page-bound: the indirection stays inside the pool
        # (interval verdict: analysis stage, no solver)
        p.assert_in_range(phys, P, f"physical page (u={u})")

        k = p.squeeze(p.load("KP", (phys, hk, 0, 0), (1, 1, PS, D)))
        v = p.squeeze(p.load("VP", (vbt(lp), hk, 0, 0), (1, 1, PS, D)))

        # invariant 2 — GQA head mapping (q's kv-group == gathered head)
        p.assert_conform(q, k, bind=((1, 1),), components=((1,), (1,)))
        # invariant 3 — K and V come through the SAME table entry
        p.assert_conform(k, v, bind=((0, 0), (1, 1)),
                         components=((0, 1), (0, 1)))

        # relabel the gathered tile with its logical position (the tag
        # the mask/RoPE consume); identity components stay asserted
        pos0 = lp * PS
        k_log = p.elementwise(
            "page_relabel", k,
            retag=lambda r, c, _p=phys, _o=pos0: make_tag(_p, hk, _o + r, c))
        p.assert_conform(k, k_log, bind=((0, 0), (1, 1)),
                         components=((0, 1, 3), (0, 1, 3)))
        v_log = p.elementwise(
            "page_relabel", v,
            retag=lambda r, c, _p=phys, _o=pos0: make_tag(_p, hk, _o + r, c))

        # invariant 4 — logical coverage: the gathered pages must tile
        # [0, S) exactly once across (bh, pg)
        p.store("KV_READ", k_log, (bh, pos0, 0))

        if inject_bug == "pos_from_physical":
            st_pos = lambda i, j, _p=phys: make_tag(b, hk, _p * PS + j)
        else:
            st_pos = lambda i, j, _o=pos0: make_tag(b, hk, _o + j)
        st = p.matmul(q, p.transpose(k_log), retag=st_pos)
        # invariant 5 — position honesty: the score's declared position
        # is the logical position of the key it was computed from
        p.assert_conform(st, k_log, bind=((1, 0),),
                         components=((2,), (2,)))

        pt = p.elementwise("exp_sub_m", st, retag=st_pos)
        # the weighted value consumes the same logical positions
        p.assert_conform(pt, v_log, bind=((1, 0),),
                         components=((1, 2), (1, 2)))

        # invariant 6 — length-gate conformity: the softmax weight that
        # reaches the accumulator carries (position, length) provenance
        # and must conform with the gate that zeroed it.  Positions at or
        # beyond seq_len(b) — every null-page position included — are
        # provably gated before the accumulator sees them.
        if inject_bug == "mask_off_by_one":
            # gate admits position len(b) itself (<= instead of <)
            gate_pos = lambda i, j, _o=pos0: make_tag(b, _o + j + 1, ln)
        else:
            gate_pos = lambda i, j, _o=pos0: make_tag(b, _o + j, ln)
        if inject_bug == "null_page_leak" and u > 0:
            gate = hoisted_gate      # block's first-page gate reused
        else:
            gate = p.elementwise("len_gate", st, retag=gate_pos)
            hoisted_gate = gate
        ptg = p.elementwise(
            "apply_len_gate", pt, gate,
            retag=lambda i, j, _o=pos0: make_tag(b, hk, _o + j, ln))
        p.assert_conform(ptg, gate, bind=((0, 0), (1, 1)),
                         components=((0, 2, 3), (0, 1, 2)))
        o_part = p.matmul(ptg, v_log,
                          retag=lambda i, c: make_tag(bh, c))
        if inject_bug == "acc_depends_page":
            acc_tag = lambda i, c: make_tag(bh, Expr.of(pg), c)
        else:
            acc_tag = lambda i, c: make_tag(bh, c)
        p.update(acc, o_part, fn="flash_acc", retag=acc_tag)

    # invariant 6 — online-softmax carry is stable across the page axis
    p.assert_stable(acc, "pg")
    p.assert_disjoint_writes("KV_READ", axes=("bh", "pg"))
    p.assert_coverage("KV_READ")

    p.store("O", acc, (bh, 0, 0))
    p.assert_disjoint_writes("O", axes=("bh",))
    p.assert_coverage("O")
    return p


def build_paged_attention_program(cfg: PagedAttentionConfig,
                                  prob: PagedAttentionProblem,
                                  *, inject_bug: Optional[str] = None
                                  ) -> dsl.TileProgram:
    """The JAX family's program at the kernel's step
    (:func:`kernel_config`); ``cfg.block_pages`` is a precondition."""
    return tile_program(kernel_config(cfg, prob), prob,
                        inject_bug=inject_bug)


def structural_paged_attention(cfg: PagedAttentionConfig,
                               prob: PagedAttentionProblem):
    """Hopper model of ``paged_decode.cu``: a tail page, a pool too small
    for the batch, a geometry the kernel does not take, rows that
    are not 16-byte aligned (the kernel copies rows in 16-byte vectors
    or TMA boxes)."""
    issues = []
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    if prob.seq_kv % prob.page_size != 0:
        issues.append(StructuralIssue(
            "masking", f"page_size {prob.page_size} does not tile seq_kv "
                       f"({prob.seq_kv}) — tail page must be masked"))
    if prob.pool_pages < prob.batch * prob.pages_per_seq:
        issues.append(StructuralIssue(
            "capacity", f"pool of {prob.pool_pages} pages cannot back "
                        f"{prob.batch} sequences × {prob.pages_per_seq} "
                        f"pages"))
    if not pages_per_step(prob.page_size, prob.head_dim, sz):
        issues.append(StructuralIssue("unsupported", _refusal(prob)))
    issues += check_vector_alignment("KP rows",
                                     (("head_dim", prob.head_dim),),
                                     prob.dtype)
    return issues


def _smem_bytes(head_dim: int, itemsize: int) -> int:
    """Shared memory of one CTA: on the tensor-core instance 1024 bytes of
    alignment slack, the ring of K and V tiles and two mbarriers a stage;
    on the CUDA-core one a K and a V tile at its width, the block's
    queries and weights and the tile's page numbers."""
    if tensor_cores(head_dim, itemsize):
        return 1024 + STAGES * (2 * TILE_BYTES + 16)
    tt, w = tile_tokens(head_dim, itemsize), tile_width(head_dim)
    return (2 * tt * w * itemsize + GROUP_BLOCK * (w + tt + 3) * 4
            + tt // MIN_PAGE * 4)


def paged_attention_cost(cfg: PagedAttentionConfig,
                         prob: PagedAttentionProblem) -> CostEstimate:
    """H100 model of ``paged_decode.cu``: one CTA per (span, KV head,
    head block, row) streams its span's live pages, each resident CTA
    keeping its ring (tensor-core instance) or one tile of K and V
    (CUDA-core instance) in flight per round trip; the K and V of a
    (span, KV head) cross HBM once and are read again from L2 by the
    other head blocks of a group above 8; the spans' float32 partials
    are written and read back by the combine.  The products run on
    mma.sync (the P·V product twice, for the split p, on an 8-head
    n-tile per head block, over the 16-column steps that hold real
    columns) or as FMAs.  ``block_pages`` changes nothing the kernel
    does, so the model does not read it."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    B, H, HK = prob.batch, prob.q_heads, prob.kv_heads
    S, D = prob.seq_kv, prob.head_dim
    nhb = head_blocks(prob.group)
    flops = 4.0 * B * H * S * D
    kv_bytes = 2 * B * HK * S * D * sz
    table_bytes = B * prob.pages_per_seq * 4
    # a geometry the kernel refuses is priced as one span a row
    ns = n_spans(prob) if pages_per_step(prob.page_size, D, sz) else 1
    part_bytes = 2 * B * H * ns * (D + 2) * 4 + B * H * D * sz
    n_ctas = B * HK * nhb * ns
    tile = tile_tokens(D, sz) * tile_width(D) * sz
    if tensor_cores(D, sz):
        per_sm = ctas_per_sm(TC_THREADS, 64, _smem_bytes(D, sz))
        in_flight = STAGES * 2 * tile
        issued = 1.5 * 4.0 * B * HK * nhb * GROUP_BLOCK * S * cdiv(D, 16) * 16
        compute_s = issued / (PEAK_FLOPS["bf16"] * MMA_SYNC_DERATE
                              * wave_eff(n_ctas, per_sm))
    else:
        per_sm = ctas_per_sm(KERNEL_THREADS, 64, _smem_bytes(D, sz))
        in_flight = 2 * tile
        compute_s = flops / (PEAK_FLOPS["f32"] * wave_eff(n_ctas, per_sm))
    eff = stream_eff(min(n_ctas, N_SMS * per_sm), in_flight)
    hbm = kv_bytes + table_bytes + part_bytes
    return CostEstimate(compute_s=compute_s,
                        memory_s=hbm / (HBM_BW * eff)
                        + (nhb - 1) * kv_bytes / L2_BW,
                        flops=flops, hbm_bytes=hbm)


def paged_attention_sol(prob: PagedAttentionProblem) -> CostEstimate:
    """Speed of light: one dense-rate pass over the live KV pages plus
    the block table, against the products at the dtype's peak."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    B, H, HK = prob.batch, prob.q_heads, prob.kv_heads
    S, D = prob.seq_kv, prob.head_dim
    flops = 4.0 * B * H * S * D
    traffic = 2 * B * HK * S * D * sz + B * prob.pages_per_seq * 4
    return sol_estimate(flops, traffic, prob.dtype)


def _page_block_steps(cfg: PagedAttentionConfig,
                      prob: PagedAttentionProblem):
    out = []
    for nxt in (cfg.block_pages * 2, cfg.block_pages // 2):
        if 1 <= nxt <= 16 and prob.pages_per_seq % nxt == 0:
            out.append((f"block_pages={nxt}", replace(cfg, block_pages=nxt)))
    return out


SKILLS = (
    generic_skill("retile", "paged_attention", _page_block_steps),
    generic_skill("software_pipelining", "paged_attention"),
    generic_skill("vectorized_io", "paged_attention"),
    generic_skill("f32_vmem_accumulate", "paged_attention"),
)


INJECTABLE_BUGS = ("page_oob", "v_stale_table", "wrong_kv_head",
                   "page_skip", "page_replay", "pos_from_physical",
                   "mask_off_by_one", "null_page_leak",
                   "acc_depends_page")


def compatible_bugs(cfg: PagedAttentionConfig,
                    prob: PagedAttentionProblem):
    """The JAX family's menu for the program that is verified: the one
    at the kernel's step."""
    return _jax_compatible_bugs(_kernel_config_or_cfg(cfg, prob), prob)


def _jax_compatible_bugs(cfg: PagedAttentionConfig,
                    prob: PagedAttentionProblem):
    menu = list(INJECTABLE_BUGS)
    if prob.q_heads == prob.kv_heads:
        menu.remove("wrong_kv_head")
    if cfg.block_pages < 2:
        menu.remove("page_replay")   # a single page per step cannot replay
        menu.remove("null_page_leak")  # no trailing page to mis-gate
    if prob.pages_per_seq // cfg.block_pages < 2:
        menu.remove("page_skip")     # one block IS the whole range
    return menu


# Ground truth (tests/test_families.py checks it against live feedback).
# page_replay additionally under-covers the logical KV range, but only
# the disjointness pattern is *its* fingerprint — a bare coverage
# counterexample then implicates page_skip exactly and page_replay at
# stage level only.
BUG_SIGNATURES = (
    BugSignature("page_oob", ("analysis",),
                 ("assert_in_range(physical page",)),
    BugSignature("v_stale_table", ("solver",),
                 ("assert_conform(sq_4,sq_6)",
                  "assert_conform(sq_16,sq_18)")),
    BugSignature("wrong_kv_head", ("solver",),
                 ("assert_conform(sq_1,sq_4)",
                  "assert_conform(sq_1,sq_16)")),
    BugSignature("page_skip", ("solver",),
                 ("assert_coverage(KV_READ)",)),
    BugSignature("page_replay", ("solver",),
                 ("assert_disjoint(KV_READ)",)),
    BugSignature("pos_from_physical", ("solver",),
                 ("assert_conform(mm_10,e_7)", "assert_conform(e_11,e_8)",
                  "assert_conform(mm_22,e_19)",
                  "assert_conform(e_23,e_20)")),
    # the off-by-one gate fails the gate conformity at *every* page of
    # the block; the hoisted (null-page-leak) gate only at pages u>0 —
    # and the hoisting removes iteration-u gate ops, so the trailing
    # conform pairs the u>0 weight with the *first* page's gate tile
    BugSignature("mask_off_by_one", ("solver",),
                 ("assert_conform(e_13,e_12)",
                  "assert_conform(e_25,e_24)")),
    BugSignature("null_page_leak", ("solver",),
                 ("assert_conform(e_24,e_12)",)),
    BugSignature("acc_depends_page", ("analysis",), ("assert_stable(",)),
)


# -- reference execution (the kernel against its plain version) ------------

def reference_check(cfg: PagedAttentionConfig,
                    prob: PagedAttentionProblem, device="cuda") -> bool:
    """Run the port's validated ``paged_decode`` with ``cfg`` on
    ``device`` (the CUDA kernel on the card, the plain version on the
    CPU) against the plain version, in the problem's dtype, at the JAX
    check's small shapes: a full-span pass and a ragged one (an empty,
    a mid-page and a full sequence), within ``REF_TOL``.  Precondition
    errors propagate to the validator."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import (paged_decode,
                                                     paged_decode_ref)
    make, dev, tol = reference_setup("paged_decode", prob.dtype, device)
    B, HK, D = 2, max(prob.kv_heads, 1), min(prob.head_dim, 64)
    H = HK * min(prob.group, 4)
    PS = min(prob.page_size, 64)
    NP = max(2 * cfg.block_pages, 4)
    P = B * NP + 2
    q, kp, vp = make((B, H, 1, D)), make((P, HK, PS, D)), make((P, HK, PS, D))
    table = torch.from_numpy(np.random.default_rng(0).permutation(P)[
        :B * NP].reshape(B, NP).astype(np.int32)).to(dev)
    full = torch.full((B,), NP * PS, dtype=torch.int32, device=dev)
    ragged = torch.tensor(([0, NP * PS // 2 + 1] + [NP * PS] * B)[:B],
                          dtype=torch.int32, device=dev)
    for lens in (full, ragged):
        o = paged_decode(q, kp, vp, table, lens, cfg=cfg)
        w = paged_decode_ref(q, kp, vp, table, lens)
        if not torch.allclose(o.float(), w.float(), rtol=tol, atol=tol):
            return False
    return True


def _lower():
    from repro_torch.kernels import paged_attention
    return paged_attention


def _example():
    # 32-way serving batch, GQA 8:1, 8k context in 128-token pages
    return (PagedAttentionConfig(block_pages=2),
            PagedAttentionProblem(32, 8, 1, 8192, 128, 2304, 128, "bf16"))


def _sweep():
    # pow2 bucket grid: the 8k serving point plus a large-batch /
    # short-context and a small-batch / long-context point (pool sized
    # to batch × pages-per-sequence plus free-list slack, as in prod)
    return [PagedAttentionProblem(32, 8, 1, 8192, 128, 2304, 128,
                                  "bf16"),
            PagedAttentionProblem(128, 8, 1, 2048, 128, 2304, 128,
                                  "bf16"),
            PagedAttentionProblem(8, 8, 1, 32768, 128, 2304, 128,
                                  "bf16")]


FAMILY = register(KernelFamily(
    name="paged_attention",
    config_cls=PagedAttentionConfig,
    problem_cls=PagedAttentionProblem,
    build_program=build_paged_attention_program,
    structural=structural_paged_attention,
    cost=paged_attention_cost,
    skills=SKILLS,
    injectable_bugs=INJECTABLE_BUGS,
    bug_signatures=BUG_SIGNATURES,
    compatible_bugs=compatible_bugs,
    reference_check=reference_check,
    kernel="paged_decode",
    lower=_lower,
    example=_example,
    sweep_problems=_sweep,
    # identity projection: every config knob shapes the traced program,
    # declared so the engine's trace memo still keys on the projection
    trace_fields=("block_pages",),
    sol_bound=paged_attention_sol,
))


def verify_paged_attention(cfg: PagedAttentionConfig,
                           prob: PagedAttentionProblem,
                           *, inject_bug: Optional[str] = None):
    return FAMILY.verify(cfg, prob, inject_bug=inject_bug)

