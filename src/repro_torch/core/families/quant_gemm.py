"""Quantized (int8/fp8) GEMM kernel family — serving-shaped matmul with
per-group dequantization scales and *scale-provenance* invariants.

The port of the JAX package's ``core/families/quant_gemm.py``.  The tile
program (:func:`build_quant_gemm_program`), the skills, the injectable
bugs, ``compatible_bugs`` and the bug signatures are copied unchanged,
so the port's gate gives the JAX gate's verdicts, findings and
counterexamples.

C = dequant(Aq @ Bq) where Aq, Bq are narrow-dtype (i8/fp8) and each
K-group of ``prob.group`` contraction coordinates carries its own f32
scale: SA[r, g] scales A's rows over K-group g, SB[g, c] scales B's
columns.  The correctness hazard specific to quantized kernels is not the
contraction itself but the *bookkeeping around the scales*: a scale
applied to the wrong K-slice (or the wrong row/column) produces a kernel
that is numerically plausible and silently wrong.  The family therefore
tags the int8 product tile with the K-group it was computed from and
asserts that every scale entering the dequant epilogue carries exactly
that (row/column, K-group) provenance — a mismatched scale yields a
concrete counterexample naming the grid step and the two group indices.

Invariants:
  * K-group pairing — A's and B's contraction coordinates fall in the
    same scale group (subsumes the classic swapped-operand-index bug);
  * scale provenance — SA's (row, group) and SB's (column, group) tags
    must equal the product tile's declared (row/column, group) tag;
  * dequant-before-accumulate — the f32 accumulator's tag must be stable
    across the K axis (per-group scaling cannot be deferred to an
    epilogue after the reduction has already merged groups);
  * disjoint + covering output writes.

The structural, cost and speed-of-light hooks are a Hopper model of the
CUDA kernel that runs the family
(``repro_torch/kernels/quant_gemm/csrc/quant_gemm.cu``), which has two
instances, chosen by :func:`is_wgmma` from the config and the problem:

* int8 ``wgmma`` fed by TMA (bm and bn multiples of 128, bk 32, 64 or
  128, k and n multiples of 16): the call first writes Bᵀ (n, k) into
  scratch (wgmma takes 8-bit operands K-major only), then a persistent
  grid walks 128 x 128 CTA tiles; a producer warp streams 128-deep
  stages of A, Bᵀ and sb by TMA into a ring of six, and two consumer
  warpgroups take turns issuing a block's ``m64n128k32`` products into
  their int32 partial, one promoting its partial into the float32 sum
  while the other's products run — two accumulators a thread, 128
  registers;
* otherwise ``mma.sync``: one CTA of 128 threads per CTA tile, the
  largest compiled instance dividing the config tile (:func:`mma_tile`:
  rows 128/64/32/16, columns 64/32), a larger config tile on several
  CTAs launched one after another; the K walk staged through shared
  memory in 32-deep int8 chunks (one ``mma.sync.m16n8k32`` step), two
  stages deep.  Two accumulators (int32 and f32) are why its column tile
  stops at 64: 128 x 64 is 128 registers a thread.

Both build each ``bk`` block's int32 partial and add ``f32(partial) · sa ·
sb`` into a float32 accumulator at the block's end — the TPU kernel's
rounding point, which the program's ``acc_depends_k`` invariant is
about — with the same expression, so at one bk their outputs are
bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from .. import dsl
from ..costs import (CostEstimate, HBM_BW, L2_BW, MMA_SYNC_DERATE,
                     SCALAR_PATH_DERATE, grain_util, peak_flops,
                     sol_estimate, wave_eff)
from ..kernelspec import (CTA_THREADS, DTYPE_BYTES, K_CHUNK, REG_OVERHEAD,
                          STAGES, VECTOR_BYTES, StructuralIssue, cdiv,
                          check_cta_split, check_grain, check_masking,
                          check_registers, check_smem,
                          check_vector_alignment, ctas_per_sm, work_ctas)
from ..tags import Expr, make_tag
from .base import (BugSignature, KernelFamily, Skill, generic_skill,
                   register)


@dataclass(frozen=True)
class QuantGemmProblem:
    m: int
    n: int
    k: int
    group: int = 128          # K coordinates sharing one dequant scale
    dtype: str = "i8"         # narrow operand dtype ("i8" | "fp8")

    @property
    def n_groups(self) -> int:
        return cdiv(self.k, self.group)


@dataclass(frozen=True)
class QuantGemmConfig:
    """Tunable knobs (the harness' action space for this family)."""

    bm: int = 128
    bn: int = 128
    bk: int = 128             # must divide the scale group
    precision: str = "f32"    # dequantized accumulator type

    def name(self) -> str:
        return f"qgemm[{self.bm}x{self.bn}x{self.bk}]"


def build_quant_gemm_program(cfg: QuantGemmConfig, prob: QuantGemmProblem,
                             *, inject_bug: Optional[str] = None
                             ) -> dsl.TileProgram:
    """Dequantizing GEMM with scale-provenance invariants.

    ``inject_bug`` deliberately mis-lowers one aspect (the fault model's
    menu; every entry must be caught).  Supported:
    "swap_b_index"        — B loaded with (j·bk, k·bn) origin;
    "a_scale_wrong_kslice"— SA read at the *next* K-group;
    "a_scale_row_offset"  — SA read from row 0 instead of this i-block;
    "b_scale_stale"       — SB pinned to group 0 (stale first group);
    "acc_depends_k"       — product accumulated before dequant with a
                            group-dependent tag (deferred-dequant bug);
    "grid_short"          — M grid one block short;
    "missing_init"        — accumulator never zero-initialized.
    """
    if prob.group % cfg.bk != 0:
        raise ValueError(
            f"bk {cfg.bk} must divide the scale group {prob.group} "
            f"(each K tile needs a single dequant scale)")
    p = dsl.TileProgram(cfg.name())
    gk = prob.group // cfg.bk            # K tiles per scale group
    mi = cdiv(prob.m, cfg.bm)
    nj = cdiv(prob.n, cfg.bn)
    nk = cdiv(prob.k, cfg.bk)
    ng = prob.n_groups

    if inject_bug == "grid_short":
        mi = max(1, mi - 1)

    i = p.add_grid("i", mi, "parallel")
    j = p.add_grid("j", nj, "parallel")
    k = p.add_grid("k", nk, "arbitrary")

    # narrow operands tag their elements with (row/col, K-group): the
    # group component is what the scale-provenance assertions compare
    p.tensor("A", (prob.m, prob.k), prob.dtype,
             tag_fn=lambda r, c: make_tag(r, c // prob.group))
    p.tensor("B", (prob.k, prob.n), prob.dtype,
             tag_fn=lambda r, c: make_tag(r // prob.group, c))
    p.tensor("SA", (prob.m, ng), "f32")          # per (row, K-group)
    p.tensor("SB", (ng, prob.n), "f32")          # per (K-group, col)
    p.tensor("C", (prob.m, prob.n), "bf16", kind="output")

    g = Expr.of(k) // gk                 # this K tile's scale group

    a = p.load("A", (i * cfg.bm, k * cfg.bk), (cfg.bm, cfg.bk))
    if inject_bug == "swap_b_index":
        b = p.load("B", (j * cfg.bk, k * cfg.bn), (cfg.bk, cfg.bn))
    else:
        b = p.load("B", (k * cfg.bk, j * cfg.bn), (cfg.bk, cfg.bn))

    # invariant 1 — K-group pairing: both operands' contraction
    # coordinates fall in the same scale group
    p.assert_contraction(a, b, components=((1,), (0,)))

    # the int8 partial product carries its K-group provenance (component 2)
    st = p.matmul(a, b, retag=lambda li, lj: make_tag(
        i * cfg.bm + li, j * cfg.bn + lj, g))
    # retag honesty: the declared group equals the loaded data's group,
    # and the declared output column equals B's loaded column
    p.assert_conform(a, st, bind=((0, 0),), components=((1,), (2,)))
    p.assert_conform(b, st, bind=((1, 1),), components=((1,), (1,)))

    ga = (g + 1) % ng if inject_bug == "a_scale_wrong_kslice" else g
    row0 = Expr.of(0) if inject_bug == "a_scale_row_offset" else i * cfg.bm
    gb = Expr.of(0) if inject_bug == "b_scale_stale" else g
    sa = p.load("SA", (row0, ga), (cfg.bm, 1))
    sb = p.load("SB", (gb, j * cfg.bn), (1, cfg.bn))

    # invariant 2 — scale provenance: the dequant scales entering this
    # product must carry the product's own (row/col, K-group) coordinates
    p.assert_conform(st, sa, bind=((0, 0),), components=((0, 2), (0, 1)))
    p.assert_conform(st, sb, bind=((1, 1),), components=((1, 2), (1, 0)))

    acc = p.alloc((cfg.bm, cfg.bn), cfg.precision,
                  zero_init=(inject_bug != "missing_init"))
    if inject_bug == "acc_depends_k":
        # deferred dequant: the group-tagged product is accumulated raw
        out_tag = lambda li, lj: make_tag(i * cfg.bm + li,
                                          j * cfg.bn + lj, g)
    else:
        # dequant-before-accumulate: scales absorb the group component
        out_tag = lambda li, lj: make_tag(i * cfg.bm + li, j * cfg.bn + lj)
    p.update(acc, st, fn="dequant_acc", retag=out_tag)

    # invariant 3 — accumulator stability across the reduction axis: a
    # group-dependent carried tag (deferred dequant) collapses to ⊤ here
    p.assert_stable(acc, "k")
    p.assert_conform(acc, acc, bind=((0, 0), (1, 1)))

    p.store("C", acc, (i * cfg.bm, j * cfg.bn))
    # invariants 4/5 — no clobber across parallel steps; full coverage
    p.assert_disjoint_writes("C")
    p.assert_coverage("C")
    return p


# -- the CUDA kernel's decomposition -----------------------------------------

CTA_ROWS = (128, 64, 32, 16)   # rows per CTA of the mma.sync instance
CTA_COLS = (64, 32)            # its columns per CTA: two accumulators
# the wgmma instance: 128 x 128 CTA tiles (two consumer warpgroups of 64
# rows, an int32 partial and a float32 sum each), 128-deep stages (one
# 128-byte row of int8) in a ring of six, each stage A and Bᵀ tiles and
# four rows of sb, beside a producer warp
WGMMA_ROWS, WGMMA_COLS = 128, 128
WGMMA_DEPTH, WGMMA_STAGES = 128, 6
WGMMA_BK = (32, 64, 128)       # |partial| <= bk·128·128 stays exact
WGMMA_SB_ROWS = 4              # scale groups one stage may span
CONSUMER_REGS = 232           # a consumer thread's registers (setmaxnreg)
OUT_BYTES = 4                  # the kernel's default output: float32
# FP32-pipe instructions a promoted value takes on the wgmma instance
# (subtract, multiply, FMA; the integer add runs on the INT32 pipe), each
# at half the float32 FLOP rate (which counts an FMA as two)
PROMOTE_INSTRUCTIONS = 3


def is_wgmma(cfg: QuantGemmConfig, prob: QuantGemmProblem) -> bool:
    """Whether ``cfg`` runs on the wgmma instance: int8, bm and bn
    multiples of 128, bk of 32, 64 or 128, and k and n multiples of 16
    (TMA's 16-byte rows; the wrapper also needs 16-byte-aligned A, B and
    sb).  The wrapper, the structural model and the cost model all route
    by this."""
    return (prob.dtype == "i8" and cfg.bm % WGMMA_ROWS == 0
            and cfg.bn % WGMMA_COLS == 0 and cfg.bk in WGMMA_BK
            and prob.k % 16 == 0 and prob.n % 16 == 0)


def mma_tile(cfg: QuantGemmConfig):
    """The CTA tile (rows, cols) of the mma.sync instance for ``cfg``:
    the largest compiled instance dividing the config tile, else the
    smallest (the config tile's edge masked)."""
    tm = next((t for t in CTA_ROWS if cfg.bm % t == 0), CTA_ROWS[-1])
    tn = next((t for t in CTA_COLS if cfg.bn % t == 0), CTA_COLS[-1])
    return tm, tn


def cta_tile(cfg: QuantGemmConfig, prob: Optional[QuantGemmProblem] = None):
    """The CTA tile (rows, cols) the kernel runs ``cfg`` on: 128 x 128
    on the wgmma instance, else :func:`mma_tile` (also with no problem
    given).  A config tile larger than the CTA tile is covered by
    several CTAs."""
    if prob is not None and is_wgmma(cfg, prob):
        return WGMMA_ROWS, WGMMA_COLS
    return mma_tile(cfg)


def acc_registers(tm: int, tn: int, wgmma: bool = False) -> int:
    """Accumulator registers a thread holds: the int32 partial of the
    current K block and the float32 running sum, over the CTA's 128
    threads (mma.sync) or over a consumer warpgroup's 128 threads and its
    64 rows x tn columns (wgmma)."""
    if wgmma:
        return 2 * 64 * tn // 128
    return 2 * tm * tn // CTA_THREADS


def smem_bytes(tm: int, tn: int, wgmma: bool = False) -> int:
    """Shared memory one CTA stages (the kernel's layouts).  wgmma: 1024
    bytes of alignment slack and a ring of 128-deep stages, each an A
    tile (tm x 128 bytes), a Bᵀ tile (tn x 128) and four rows of sb (tn
    float32), with two mbarriers a stage.  mma.sync: ``STAGES`` buffers
    of an int8 A chunk (tm x 32) and B chunk (32 x tn), each row padded
    by 16 bytes."""
    if wgmma:
        stage = (tm + tn) * WGMMA_DEPTH + WGMMA_SB_ROWS * tn * 4
        return 1024 + WGMMA_STAGES * (stage + 16)
    return STAGES * (tm * (K_CHUNK + VECTOR_BYTES)
                     + K_CHUNK * (tn + VECTOR_BYTES))


def vector_path(cfg: QuantGemmConfig, prob: QuantGemmProblem) -> bool:
    """True when every int8 operand row and block start is 16-byte
    aligned, so the mma.sync instance stages tiles with 16-byte
    ``cp.async`` copies; otherwise it loads byte by byte, masked."""
    return all(x % VECTOR_BYTES == 0 for x in (prob.k, prob.n, cfg.bk,
                                               cfg.bn))


def instance_name(cfg: QuantGemmConfig, prob: QuantGemmProblem) -> str:
    """The instance ``cfg`` runs on, as the logs name it."""
    tm, tn = cta_tile(cfg, prob)
    return f"{'wgmma' if is_wgmma(cfg, prob) else 'mma.sync'} {tm}x{tn}"


def structural_quant_gemm(cfg: QuantGemmConfig, prob: QuantGemmProblem):
    """Hopper model of ``quant_gemm.cu``: an operand type it does not
    take (int8 only: the TPU kernel and its oracle take no fp8 either),
    shared memory and accumulator registers of the instance's CTA (no
    compiled tile spills: :data:`CTA_COLS`; a wgmma consumer's two
    accumulators against the 232 registers setmaxnreg gives it), the
    tensor-core grain of the config tile (masked rows and columns,
    zero-filled depth), 16-byte alignment of the int8 rows, a config
    tile on several CTAs, and the JAX family's masking check."""
    wg = is_wgmma(cfg, prob)
    tm, tn = cta_tile(cfg, prob)
    issues = []
    if prob.dtype != "i8":
        issues.append(StructuralIssue(
            "unsupported", f"operands of {prob.dtype}: the kernel takes "
                           f"int8 only; its wrapper raises"))
    issues += check_smem("CTA", smem_bytes(tm, tn, wg))
    if wg:
        acc = acc_registers(tm, tn, True)
        if acc + REG_OVERHEAD > CONSUMER_REGS:
            issues.append(StructuralIssue(
                "registers", f"CTA: {acc} accumulator registers per "
                             f"consumer thread (+{REG_OVERHEAD}) exceed "
                             f"the {CONSUMER_REGS} setmaxnreg gives it"))
    else:
        issues += check_registers("CTA", acc_registers(tm, tn))
    issues += check_grain("C", (cfg.bm, cfg.bn, cfg.bk), (tm, tn))
    issues += check_vector_alignment(
        "A/B rows", (("k", prob.k), ("n", prob.n), ("bk", cfg.bk),
                     ("bn", cfg.bn)), "i8")
    issues += check_cta_split("C", (cfg.bm, cfg.bn), (tm, tn))
    issues += check_masking("A", (prob.m, prob.k), (cfg.bm, cfg.bk),
                            masked_dims=(0, 1))
    return issues


def quant_gemm_cost(cfg: QuantGemmConfig,
                    prob: QuantGemmProblem) -> CostEstimate:
    """H100 model of ``quant_gemm.cu`` on the instance that runs
    (:func:`is_wgmma`).  The int8 products at the tensor cores' int8 rate
    (``peak_flops("i8")``; ``MMA_SYNC_DERATE`` of it on the mma.sync
    instance) at the grain of the CTA tile and quantised in waves over
    the 132 SMs, and the promotion of every ``bk`` block's partial on
    the CUDA cores (``PROMOTE_INSTRUCTIONS`` a value on the wgmma
    instance, where one warpgroup's promotion overlaps the other's
    products, so the larger of the two counts; three float32 operations
    on the mma.sync instance, where it does not, so they add) — a short
    ``bk`` costs more.  The operands, scales and
    output cross HBM once, the wgmma call's transpose of B reads and
    writes B once more before the GEMM, and every CTA streams its A
    rows, B panel and scales through L2."""
    sz = DTYPE_BYTES.get(prob.dtype, 1)
    m, n, k = prob.m, prob.n, prob.k
    ng = prob.n_groups
    nk = cdiv(k, cfg.bk)
    flops = 2.0 * m * n * k
    wg = is_wgmma(cfg, prob)
    tm, tn = cta_tile(cfg, prob)
    n_ctas = work_ctas(m, cfg.bm, tm) * work_ctas(n, cfg.bn, tn)
    hbm = (m * k + k * n) * sz + (m + n) * ng * 4 + m * n * OUT_BYTES
    l2 = n_ctas * ((tm + tn) * k * sz + (tm + tn) * ng * 4)
    if wg:
        # persistent: one CTA an SM walks the tiles
        wave = wave_eff(n_ctas, 1)
        util = grain_util((cfg.bm, cfg.bn, cfg.bk), (tm, tn), K_CHUNK) \
            * wave
        tensor = flops / (peak_flops(prob.dtype) * util)
        promote = (PROMOTE_INSTRUCTIONS * m * n * nk
                   / (peak_flops("f32") / 2 * wave))
        transpose = 2 * k * n * sz
        return CostEstimate(
            compute_s=max(tensor, promote) + transpose / HBM_BW,
            memory_s=(hbm + transpose) / HBM_BW + l2 / L2_BW,
            flops=flops, hbm_bytes=hbm + transpose)
    per_sm = ctas_per_sm(CTA_THREADS, acc_registers(tm, tn) + REG_OVERHEAD,
                         smem_bytes(tm, tn))
    util = grain_util((cfg.bm, cfg.bn, cfg.bk), (tm, tn), K_CHUNK) \
        * wave_eff(n_ctas, per_sm) * MMA_SYNC_DERATE
    if not vector_path(cfg, prob):
        util *= SCALAR_PATH_DERATE
    epi_flops = 3.0 * m * n * nk
    return CostEstimate(
        compute_s=flops / (peak_flops(prob.dtype) * util)
        + epi_flops / (peak_flops("f32") * wave_eff(n_ctas, per_sm)),
        memory_s=hbm / HBM_BW + l2 / L2_BW,
        flops=flops, hbm_bytes=hbm)


def quant_gemm_sol(prob: QuantGemmProblem) -> CostEstimate:
    """Speed of light: 2mnk operations at the narrow dtype's tensor-core
    rate vs a single pass over the narrow operands, the f32 scale
    streams and the float32 output."""
    sz = DTYPE_BYTES.get(prob.dtype, 1)
    m, n, k = prob.m, prob.n, prob.k
    traffic = ((m * k + k * n) * sz
               + (m + n) * prob.n_groups * 4
               + m * n * OUT_BYTES)
    return sol_estimate(2.0 * m * n * k, traffic, dtype=prob.dtype)


# -- skills -----------------------------------------------------------------

def _block_steps(cfg: QuantGemmConfig, prob: QuantGemmProblem):
    out = []
    for field, cur in (("bm", cfg.bm), ("bn", cfg.bn)):
        for nxt in (cur * 2, cur // 2):
            if 32 <= nxt <= 1024:
                out.append((f"{field}={nxt}", replace(cfg, **{field: nxt})))
    for nxt in (cfg.bk * 2, cfg.bk // 2):
        if 32 <= nxt <= prob.group and prob.group % nxt == 0:
            out.append((f"bk={nxt}", replace(cfg, bk=nxt)))
    return out


def _widen_k_per_scale(cfg: QuantGemmConfig, prob: QuantGemmProblem):
    """Grow bk toward the full scale group: fewer dequant epilogues per
    output tile (the group bound keeps one scale per K tile)."""
    if cfg.bk < prob.group and prob.group % (cfg.bk * 2) == 0:
        return [(f"bk={cfg.bk * 2}", replace(cfg, bk=cfg.bk * 2))]
    return []


SKILLS = (
    generic_skill("retile", "quant_gemm", _block_steps),
    Skill("group_aligned_k", "global", ("quant_gemm",),
          "Widen the K tile toward the scale-group width so each tile "
          "dequantizes with a single (SA row, SB col) scale pair.",
          "scale provenance re-proven per retile; bk | group precondition",
          _widen_k_per_scale),
    generic_skill("software_pipelining", "quant_gemm"),
    generic_skill("vectorized_io", "quant_gemm"),
    generic_skill("f32_vmem_accumulate", "quant_gemm"),
    generic_skill("oob_guarded_loads", "quant_gemm"),
)


# -- fault model ------------------------------------------------------------

INJECTABLE_BUGS = ("swap_b_index", "a_scale_wrong_kslice",
                   "a_scale_row_offset", "b_scale_stale", "acc_depends_k",
                   "grid_short", "missing_init")


def compatible_bugs(cfg: QuantGemmConfig, prob: QuantGemmProblem):
    menu = list(INJECTABLE_BUGS)
    if prob.n_groups < 2:
        # single-group scales make "wrong group" unexpressible
        menu.remove("a_scale_wrong_kslice")
        menu.remove("b_scale_stale")
    if cdiv(prob.m, cfg.bm) < 2:
        menu.remove("a_scale_row_offset")   # row 0 IS the only row block
        menu.remove("grid_short")
    if cdiv(prob.k, cfg.bk) < 2 and cdiv(prob.n, cfg.bn) < 2:
        menu.remove("swap_b_index")         # swapped origin coincides
    return menu


# Ground truth (tests/test_families.py checks it against live feedback).
BUG_SIGNATURES = (
    BugSignature("swap_b_index", ("solver",),
                 ("assert_conform(t_A_0,t_B_1)",
                  "assert_conform(t_B_1,mm_2)")),
    BugSignature("a_scale_wrong_kslice", ("solver",),
                 ("assert_conform(mm_2,t_SA_3)",)),
    BugSignature("a_scale_row_offset", ("solver",),
                 ("assert_conform(mm_2,t_SA_3)",)),
    BugSignature("b_scale_stale", ("solver",),
                 ("assert_conform(mm_2,t_SB_4)",)),
    BugSignature("acc_depends_k", ("analysis",),
                 ("assert_stable(", "assert_conform(s_5,s_5)")),
    BugSignature("missing_init", ("analysis",),
                 ("assert_stable(", "assert_conform(s_5,s_5)")),
    BugSignature("grid_short", ("solver",), ("assert_coverage(C)",)),
)


# -- reference execution (the kernel against its plain version) ------------

def reference_check(cfg: QuantGemmConfig, prob: QuantGemmProblem,
                    device="cuda") -> bool:
    """Run the port's validated ``quant_matmul`` with ``cfg`` on
    ``device`` (the CUDA kernel on the card, the plain version on the
    CPU) against the plain version ``quant_gemm_ref``, at the JAX check's
    small shapes (``group = min(group, 128)``, the config's tiles capped
    at 128 and bk at the group, m and n up to 256, k two groups), on
    inputs quantised by ``quantize_per_group`` from seeded normals,
    within ``quant_error``'s tolerance.  An fp8 problem fails the check:
    the kernel and its oracle take int8 only.  Precondition errors of
    the config (``ValueError``, ``InvariantViolation``) propagate to the
    validator, which counts them as a failed test; so do build and
    launch errors, which it does not catch."""
    import numpy as np
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels.quant_gemm import (quant_error, quant_gemm_ref,
                                                quant_matmul,
                                                quantize_per_group)
    dev = resolve_device(device)
    if prob.dtype != "i8":
        return False
    rng = np.random.default_rng(0)
    group = min(prob.group, 128)
    small = QuantGemmConfig(bm=min(cfg.bm, 128), bn=min(cfg.bn, 128),
                            bk=min(cfg.bk, group))
    m, n, k = min(prob.m, 256), min(prob.n, 256), min(prob.k, 2 * group)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    aq, sa = (t.to(dev) for t in quantize_per_group(a, group, axis=1))
    bq, sb = (t.to(dev) for t in quantize_per_group(b, group, axis=0))
    o = quant_matmul(aq, bq, sa, sb, group=group, cfg=small)
    w = quant_gemm_ref(aq, bq, sa, sb, group=group)
    return quant_error(o, w)[1]


def _lower():
    from repro_torch.kernels import quant_gemm
    return quant_gemm


def _example():
    return (QuantGemmConfig(),
            QuantGemmProblem(8192, 8192, 8192, group=128, dtype="i8"))


def _sweep():
    # pow2 bucket grid: the production int8 matmul plus the small-batch
    # decode regime and a short-K projection, same 128-wide scale groups
    return [QuantGemmProblem(8192, 8192, 8192, group=128, dtype="i8"),
            QuantGemmProblem(2048, 8192, 8192, group=128, dtype="i8"),
            QuantGemmProblem(8192, 8192, 2048, group=128, dtype="i8")]


FAMILY = register(KernelFamily(
    name="quant_gemm",
    config_cls=QuantGemmConfig,
    problem_cls=QuantGemmProblem,
    build_program=build_quant_gemm_program,
    structural=structural_quant_gemm,
    cost=quant_gemm_cost,
    skills=SKILLS,
    injectable_bugs=INJECTABLE_BUGS,
    bug_signatures=BUG_SIGNATURES,
    compatible_bugs=compatible_bugs,
    reference_check=reference_check,
    kernel="quant_gemm",
    lower=_lower,
    example=_example,
    sweep_problems=_sweep,
    sol_bound=quant_gemm_sol,
))


def verify_quant_gemm(cfg: QuantGemmConfig, prob: QuantGemmProblem,
                      *, inject_bug: Optional[str] = None):
    return FAMILY.verify(cfg, prob, inject_bug=inject_bug)
