"""Flash-attention kernel family (GQA, causal, online softmax).

The port of the JAX package's ``core/families/flash_attention.py``.  The
tile program (:func:`build_flash_attention_program`: steps
``(bh, qi, kv)``), the skills, the injectable bugs and their signatures
are copied unchanged, so the port's gate gives the JAX gate's verdicts,
findings and counterexamples.  Tag functions fold the GQA head-group
mapping; invariants cover QKᵀ/PV pairing conformity, retag honesty,
online-softmax running-stat stability across the KV axis, and
disjoint/covering output writes.

The structural, cost and speed-of-light hooks are a Hopper model of the
CUDA kernel that runs the family
(``repro_torch/kernels/flash_attention/csrc/flash_attention.cu``), as
``families/gemm.py`` describes gemm: the config's ``block_q`` runs on
CTAs of the largest compiled tile of 128, 64, 32 or 16 query rows that
divides it (:func:`cta_tile`; 16 with masked rows when none does), a
larger block on several CTAs; each CTA walks the keys in tiles, stopping
after its last query row under ``causal_block_skip``.  In bf16 the 128-
and 64-row tiles are the Hopper kernel: a producer warpgroup loads
128-key K and V tiles by TMA into a two-stage ring, and one or two
consumer warpgroups of 64 rows run both products on ``wgmma``; the 32-
and 16-row tiles run ``mma.sync`` over 64-key chunks, and f32 runs
CUDA-core FMAs over 32-key chunks.  So one program step (bh, qi, kv) is
run by ``cdiv(block_q, tile)`` CTAs, each doing the kv axis itself in
its own tiles; ``block_kv`` and ``v_transposed_staging`` select nothing
in the kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from .. import dsl
from ..costs import (CostEstimate, HBM_BW, L2_BW, MMA_SYNC_DERATE,
                     peak_flops, sol_estimate, wave_eff)
from ..kernelspec import (DTYPE_BYTES, MAX_HEAD_DIM, StructuralIssue, cdiv,
                          check_cta_split, check_smem,
                          check_vector_alignment, ctas_per_sm, head_dim_ok,
                          tile_width)
from ..tags import make_tag
from .base import (BugSignature, KernelFamily, Skill, generic_skill,
                   reference_setup, register)

@dataclass(frozen=True)
class FlashAttentionProblem:
    batch: int
    q_heads: int
    kv_heads: int
    seq_q: int
    seq_kv: int
    head_dim: int
    causal: bool = True
    dtype: str = "bf16"

    @property
    def group(self) -> int:
        return self.q_heads // self.kv_heads


@dataclass(frozen=True)
class FlashAttentionConfig:
    block_q: int = 256
    block_kv: int = 128
    v_transposed_staging: bool = False   # paper's TransV analogue
    causal_block_skip: bool = True       # skip fully-masked kv blocks
    applies_mask: bool = True            # in-kernel causal mask present

    def name(self) -> str:
        s = f"fa[{self.block_q}x{self.block_kv}]"
        if self.v_transposed_staging:
            s += "+transv"
        if self.causal_block_skip:
            s += "+skip"
        return s


def build_flash_attention_program(cfg: FlashAttentionConfig,
                                  prob: FlashAttentionProblem,
                                  *, inject_bug: Optional[str] = None
                                  ) -> dsl.TileProgram:
    """O = softmax(QKᵀ)·V — the paper's Figure-1 program on TPU tiles.

    Tag functions (paper §4, adapted):
      T_Q(r, c) = (batch, kv_group_of_head, q_pos, c)
      T_K(r, c) = (batch, kv_head,          kv_pos, c)
      T_V(r, c) = (batch, kv_head,          kv_pos, c)
    Injectable bugs: "wrong_kv_head" (load K with the raw q-head index),
    "missing_transpose" (staged-transposed V consumed untransposed),
    "m_depends_kv" (running max tagged with the kv step),
    "q_block_offset" (off-by-one-block Q origin).
    """
    # program name = the trace-relevant projection only (trace_fields):
    # configs that share one traced program must label its assertions
    # identically, so causal_block_skip — cost-model-only — stays out
    pname = f"fa[{cfg.block_q}x{cfg.block_kv}]"
    if cfg.v_transposed_staging:
        pname += "+transv"
    p = dsl.TileProgram(pname)
    B, H, HK = prob.batch, prob.q_heads, prob.kv_heads
    SQ, SKV, D = prob.seq_q, prob.seq_kv, prob.head_dim
    G = prob.group
    bq, bkv = cfg.block_q, cfg.block_kv

    bh = p.add_grid("bh", B * H, "parallel")
    qi = p.add_grid("qi", cdiv(SQ, bq), "parallel")
    kv = p.add_grid("kv", cdiv(SKV, bkv), "arbitrary")

    # logical rank-4 operands; tag functions per the paper (T_Q folds the
    # GQA head-group mapping, like the paper's h_q/gqa component):
    def tag_q(b_, h_, r, c):
        return make_tag(b_, h_ // G, r, c)

    p.tensor("Q", (B, H, SQ, D), prob.dtype, tag_fn=tag_q)
    p.tensor("K", (B, HK, SKV, D), prob.dtype)   # identity tags
    p.tensor("V", (B, HK, SKV, D), prob.dtype)
    p.tensor("O", (B, H, SQ, D), prob.dtype, kind="output")

    b = bh // H
    h = bh % H
    hk = (bh % H) // G if inject_bug != "wrong_kv_head" else (bh % H)
    if inject_bug == "wrong_kv_head" and H == HK:
        raise ValueError("wrong_kv_head bug requires GQA (H != HK)")

    q_pos = (qi + (1 if inject_bug == "q_block_offset" else 0)) * bq

    q = p.squeeze(p.load("Q", (b, h, q_pos, 0), (1, 1, bq, D)))
    k = p.squeeze(p.load("K", (b, hk, kv * bkv, 0), (1, 1, bkv, D)))

    # S = Q Kᵀ : contraction over the head dim (bind Q.1 with K.1 — Kᵀ),
    # conformity on (batch, kv-head-group, head-dim coordinate).
    p.assert_conform(q, k, bind=((1, 1),), components=((0, 1, 3), (0, 1, 3)))
    s_tag = lambda li, lj: make_tag(b, hk, qi * bq + li, kv * bkv + lj)
    s = p.matmul(q, p.transpose(k), retag=s_tag)
    # retag honesty: the declared S coordinates must match the operands'
    # actual positions (catches off-by-one-block origins)
    p.assert_conform(q, s, bind=((0, 0),), components=((2,), (2,)))
    p.assert_conform(k, s, bind=((0, 1),), components=((2,), (3,)))

    if prob.causal and cfg.applies_mask:
        s = p.elementwise("causal_mask", s, retag=s_tag)

    # online softmax running stats (carried scratch)
    m_tag = ((lambda li: make_tag(b, hk, qi * bq + li, kv))
             if inject_bug == "m_depends_kv"
             else (lambda li: make_tag(b, hk, qi * bq + li)))
    m_new = p.reduce(s, axis=1, kind="max", retag=m_tag)
    m_acc = p.alloc((bq,), "f32")
    p.update(m_acc, m_new, fn="max", retag=m_tag)
    p.assert_stable(m_acc, "kv")

    pt = p.elementwise("exp_sub_m", s, retag=s_tag)
    l_new = p.reduce(pt, axis=1, kind="sum",
                     retag=lambda li: make_tag(b, hk, qi * bq + li))
    l_acc = p.alloc((bq,), "f32")
    p.update(l_acc, l_new, fn="rescale_add",
             retag=lambda li: make_tag(b, hk, qi * bq + li))
    p.assert_stable(l_acc, "kv")

    v = p.squeeze(p.load("V", (b, hk, kv * bkv, 0), (1, 1, bkv, D)))
    if cfg.v_transposed_staging:
        vt = p.transpose(v)           # staged (D, bkv), the TransV analogue
        v_used = vt if inject_bug == "missing_transpose" else p.transpose(vt)
        if inject_bug == "missing_transpose" and D != bkv:
            raise ValueError("missing_transpose bug requires D == block_kv")
    else:
        v_used = v

    # O += P·V : contraction over kv positions; conformity on
    # (batch, kv-head, kv position).
    p.assert_conform(pt, v_used, bind=((1, 0),),
                     components=((0, 1, 3), (0, 1, 2)))
    o_tag = lambda li, lc: make_tag(b, hk, qi * bq + li, lc)
    acc_o = p.alloc((bq, D), "f32")
    p.update(acc_o, fn="rescale", retag=o_tag)   # exp(m_old - m_new) scale
    p.matmul(pt, v_used, accumulate=True, acc=acc_o, retag=o_tag)
    p.assert_stable(acc_o, "kv")

    p.store("O", acc_o, (b, h, qi * bq, 0))
    p.assert_disjoint_writes("O")
    p.assert_coverage("O")
    return p


# -- the CUDA kernel's decomposition -----------------------------------------

CTA_TILES = (128, 64, 32, 16)  # query rows per CTA (compiled instances)
WGMMA_TILES = (128, 64)        # bf16 tiles on wgmma: 64 rows a warpgroup
KEY_TILE = 128                 # keys per TMA tile of the wgmma instances
STAGES = 2                     # K/V ring depth of the wgmma instances
CHUNK = {"bf16": 64, "f32": 32}  # keys per chunk of the other instances
CONSUMER_REGS, PRODUCER_REGS = 232, 40   # setmaxnreg, wgmma instances


def cta_tile(block_q: int) -> int:
    """The CTA tile (query rows) the kernel runs a ``block_q`` block on:
    the largest compiled tile that divides it, else the smallest (with
    the rows past the block masked)."""
    return next((t for t in CTA_TILES if block_q % t == 0), CTA_TILES[-1])


def is_wgmma(tile: int, dtype: str) -> bool:
    return dtype != "f32" and tile in WGMMA_TILES


def instance_name(tile: int, head_dim: int, dtype: str) -> str:
    """The instance that runs: its design, CTA rows and width, e.g.
    "wgmma 128 rows W=128", "mma.sync 16 rows W=64", "fma 64 rows W=256"."""
    kind = ("fma" if dtype == "f32" else
            "wgmma" if is_wgmma(tile, dtype) else "mma.sync")
    return f"{kind} {tile} rows W={tile_width(head_dim)}"


def key_tile(tile: int, dtype: str, head_dim: int = 128) -> int:
    """Keys per step of a CTA's walk (its running max's unit): 128 on the
    wgmma tiles (64 at width 256), else the chunk."""
    if is_wgmma(tile, dtype):
        return KEY_TILE // 2 if tile_width(head_dim) == 256 else KEY_TILE
    return CHUNK.get(dtype, 64)


def smem_bytes(tile: int, head_dim: int, dtype: str) -> int:
    """Shared memory of one CTA (the kernel's layout): bf16 wgmma — 1024
    bytes of alignment slack, the Q tile and a two-stage ring of K and V
    tiles (128-byte swizzle, rows of the width, no padding) and the
    mbarriers; bf16 mma.sync — the Q tile and two buffers each of a
    64-key K and V chunk, rows of the width padded by 16 bytes; f32 — Q,
    one 32-key K and V chunk and the weights, rows of the width padded by
    one word."""
    w = tile_width(head_dim)
    if dtype == "f32":
        kc = CHUNK["f32"]
        return ((tile + 2 * kc) * (w + 1) + tile * (kc + 1)) * 4
    if is_wgmma(tile, dtype):
        kt = key_tile(tile, dtype, head_dim)
        return (1024 + tile * w * 2 + 2 * STAGES * kt * w * 2
                + 8 * (1 + 4 * STAGES))
    return (tile + 4 * CHUNK["bf16"]) * (w + 8) * 2


def threads(tile: int, dtype: str) -> int:
    """bf16 wgmma: a consumer warpgroup per 64 rows and one producer
    warpgroup; bf16 mma.sync: one warp per 16 query rows; f32: four
    threads per row."""
    if dtype == "f32":
        return 4 * tile
    if is_wgmma(tile, dtype):
        return 128 * (tile // 64 + 1)
    return 2 * tile


def _regs(tile: int, head_dim: int, dtype: str) -> int:
    """Registers per thread (model): wgmma — the CTA's mean after
    setmaxnreg (consumers 232, the producer warpgroup 40); otherwise the
    accumulator at the width and the score chunk (bf16; Q's fragments
    are read from shared memory at each k-step), plus 40 beside them."""
    w = tile_width(head_dim)
    if dtype == "f32":
        return 4 * w // 16 + 8 + 40
    if is_wgmma(tile, dtype):
        n_c = tile // 64
        return (n_c * CONSUMER_REGS + PRODUCER_REGS) // (n_c + 1)
    return w // 2 + CHUNK["bf16"] // 2 + 40


def structural_flash_attention(cfg: FlashAttentionConfig,
                               prob: FlashAttentionProblem):
    """Hopper model of ``flash_attention.cu``: a head_dim it does not
    take, its shared memory per CTA, a block_q off the CTA tile
    (masked rows) or beyond it (several CTAs), rows that are not 16-byte
    aligned for the copies, and the two semantic masking checks of the
    JAX family."""
    D = prob.head_dim
    tile = cta_tile(cfg.block_q)
    issues = []
    if not head_dim_ok(D, DTYPE_BYTES.get(prob.dtype, 2)):
        issues.append(StructuralIssue(
            "unsupported", f"the kernel takes head_dim up to {MAX_HEAD_DIM} "
                           f"in rows of whole 16-byte vectors, not {D} in "
                           f"{prob.dtype}"))
    issues += check_smem("CTA", smem_bytes(tile, D, prob.dtype))
    if cfg.block_q % tile:
        issues.append(StructuralIssue(
            "grain", f"O: block_q {cfg.block_q} is not a multiple of the "
                     f"{tile}-row CTA tile: masked rows in every CTA"))
    issues += check_cta_split("O", (cfg.block_q, D), (tile, D))
    issues += check_vector_alignment("Q/K/V rows", (("head_dim", D),),
                                     prob.dtype)
    if prob.causal and not cfg.applies_mask:
        issues.append(StructuralIssue(
            "masking", "causal problem lowered without an in-kernel mask"))
    if cfg.causal_block_skip and not prob.causal:
        issues.append(StructuralIssue(
            "masking", "causal block-skip enabled on a non-causal problem"))
    return issues


def flash_attention_cost(cfg: FlashAttentionConfig,
                         prob: FlashAttentionProblem) -> CostEstimate:
    """H100 model of ``flash_attention.cu``: the products issued (the
    causal half under the skip, masked rows of a block below the CTA
    tile included) at the dtype's peak — half of it on the ``mma.sync``
    instances — quantised in waves over the 132 SMs; Q, K, V and O cross
    HBM once, and every CTA streams its (b, KV head)'s K and V — 4 MB at
    8192 x 128 in bf16, which L2 holds for the G query heads that share
    it — at the L2 rate."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    B, H, HK = prob.batch, prob.q_heads, prob.kv_heads
    SQ, SKV, D = prob.seq_q, prob.seq_kv, prob.head_dim
    bq = min(cfg.block_q, max(SQ, 8))       # the wrapper's clamp
    tile = cta_tile(bq)
    cps = cdiv(bq, tile)
    n_ctas = B * H * cdiv(SQ, bq) * cps
    causal_frac = 0.5 if (prob.causal and cfg.causal_block_skip) else 1.0
    flops = 4.0 * B * H * SQ * SKV * D * causal_frac
    grain = bq / (cps * tile)
    per_sm = ctas_per_sm(threads(tile, prob.dtype),
                         _regs(tile, D, prob.dtype),
                         smem_bytes(tile, D, prob.dtype))
    rate = 1.0 if (prob.dtype == "f32" or is_wgmma(tile, prob.dtype)) \
        else MMA_SYNC_DERATE
    util = grain * wave_eff(n_ctas, per_sm) * rate
    hbm = (2 * B * H * SQ * D + 2 * B * HK * SKV * D) * sz
    l2 = n_ctas * 2 * SKV * D * sz * causal_frac
    return CostEstimate(
        compute_s=flops / (peak_flops(prob.dtype) * util),
        memory_s=hbm / HBM_BW + l2 / L2_BW,
        flops=flops, hbm_bytes=hbm)


def flash_attention_sol(prob: FlashAttentionProblem) -> CostEstimate:
    """Speed of light: the causal-skipped score/PV operation count at the
    dtype's peak vs Q, K, V, O each crossing HBM exactly once."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    B, H, HK = prob.batch, prob.q_heads, prob.kv_heads
    SQ, SKV, D = prob.seq_q, prob.seq_kv, prob.head_dim
    flops = 4.0 * B * H * SQ * SKV * D * (0.5 if prob.causal else 1.0)
    traffic = 2 * B * H * SQ * D * sz + 2 * B * HK * SKV * D * sz
    return sol_estimate(flops, traffic, prob.dtype)


def _block_steps(cfg: FlashAttentionConfig, prob):
    out = []
    for field, cur in (("block_q", cfg.block_q), ("block_kv",
                                                  cfg.block_kv)):
        for nxt in (cur * 2, cur // 2):
            if 16 <= nxt <= 2048:
                out.append((f"{field}={nxt}", replace(cfg, **{field: nxt})))
    return out


def _skip(cfg: FlashAttentionConfig, prob):
    if not prob.causal:
        return []
    return [(f"causal_block_skip={not cfg.causal_block_skip}",
             replace(cfg, causal_block_skip=not cfg.causal_block_skip))]


def _transv(cfg: FlashAttentionConfig, prob):
    return [(f"v_transposed_staging={not cfg.v_transposed_staging}",
             replace(cfg, v_transposed_staging=not cfg.v_transposed_staging
                     ))]


SKILLS = (
    generic_skill("retile", "flash_attention", _block_steps),
    generic_skill("software_pipelining", "flash_attention"),
    Skill("transpose_v_staging", "global", ("flash_attention",),
          "Stage V transposed during the copy so the PV matmul reads "
          "lane-aligned operands (paper's TransV).",
          "PV pairing conformity through the transpose", _transv),
    Skill("causal_block_skip", "local", ("flash_attention",),
          "Skip fully-masked KV blocks in the causal triangle.",
          "skipped blocks provably fully masked (structural)", _skip),
    generic_skill("vectorized_io", "flash_attention"),
    generic_skill("oob_guarded_loads", "flash_attention"),
)


INJECTABLE_BUGS = ("wrong_kv_head", "m_depends_kv", "q_block_offset")


def compatible_bugs(cfg: FlashAttentionConfig, prob: FlashAttentionProblem):
    menu = list(INJECTABLE_BUGS)
    if prob.q_heads == prob.kv_heads:
        menu.remove("wrong_kv_head")
    return menu


# Ground truth (tests/test_families.py checks it against live feedback).
# assert_stable patterns stay tile-name-free: masking/staging config flags
# shift the local-tile numbering, and fa carries three stable assertions
# of which only the running-max one is bug-reachable.
BUG_SIGNATURES = (
    BugSignature("wrong_kv_head", ("solver",),
                 ("assert_conform(sq_1,sq_3)",)),
    BugSignature("m_depends_kv", ("analysis",), ("assert_stable(",)),
    BugSignature("q_block_offset", ("solver",),
                 ("assert_conform(sq_1,mm_5)",)),
)


# -- reference execution (the kernel against its plain version) ------------

def reference_check(cfg: FlashAttentionConfig,
                    prob: FlashAttentionProblem, device="cuda") -> bool:
    """Run the port's validated ``mha`` with ``cfg`` on ``device`` (the
    CUDA kernel on the card, the plain version on the CPU) against the
    plain version ``mha_ref``, at the JAX check's small shapes (2 query
    heads on 1 KV head, ``sq = min(2·block_q, 256)``,
    ``skv = min(2·block_kv, 256)``, ``d = min(head_dim, 64)``) in the
    problem's dtype, so that on the card a bf16 problem runs the
    tensor-core path, within ``REF_TOL`` (the kernel rounds p to bf16,
    the plain version does not).  Precondition errors of the config
    (``ValueError``, ``InvariantViolation``) propagate to the validator,
    which counts them as a failed test; so do build and launch errors,
    which it does not catch."""
    import torch
    from repro_torch.kernels.flash_attention import mha, mha_ref
    make, _, tol = reference_setup("flash_attention", prob.dtype, device)
    sq = min(2 * cfg.block_q, 256)
    skv = min(2 * cfg.block_kv, 256)
    d = min(prob.head_dim, 64)
    q, k, v = make((1, 2, sq, d)), make((1, 1, skv, d)), make((1, 1, skv, d))
    o = mha(q, k, v, cfg=cfg, causal=prob.causal)
    w = mha_ref(q, k, v, causal=prob.causal)
    return bool(torch.allclose(o.float(), w.float(), rtol=tol, atol=tol))


def _lower():
    from repro_torch.kernels import flash_attention
    return flash_attention


def _example():
    return (FlashAttentionConfig(block_q=8, causal_block_skip=False),
            FlashAttentionProblem(16, 8, 1, 8192, 8192, 128, True, "bf16"))


def _sweep():
    # pow2 bucket grid: the 8k prefill plus a short-context / larger
    # batch point and a long-context point, same GQA ratio
    return [FlashAttentionProblem(16, 8, 1, 8192, 8192, 128, True,
                                  "bf16"),
            FlashAttentionProblem(32, 8, 1, 2048, 2048, 128, True,
                                  "bf16"),
            FlashAttentionProblem(4, 8, 1, 16384, 16384, 128, True,
                                  "bf16")]


FAMILY = register(KernelFamily(
    name="flash_attention",
    config_cls=FlashAttentionConfig,
    problem_cls=FlashAttentionProblem,
    build_program=build_flash_attention_program,
    structural=structural_flash_attention,
    cost=flash_attention_cost,
    skills=SKILLS,
    injectable_bugs=INJECTABLE_BUGS,
    bug_signatures=BUG_SIGNATURES,
    compatible_bugs=compatible_bugs,
    reference_check=reference_check,
    kernel="flash_attention",
    lower=_lower,
    example=_example,
    sweep_problems=_sweep,
    # causal_block_skip never enters the traced data flow (it only
    # shifts the cost model and the structural hints), so configs that
    # differ only there share one traced program
    trace_fields=("block_q", "block_kv", "v_transposed_staging",
                  "applies_mask"),
    sol_bound=flash_attention_sol,
))


def verify_flash_attention(cfg: FlashAttentionConfig,
                           prob: FlashAttentionProblem,
                           *, inject_bug: Optional[str] = None):
    return FAMILY.verify(cfg, prob, inject_bug=inject_bug)

