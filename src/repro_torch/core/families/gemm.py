"""GEMM kernel family (paper §6): invariants, cost hooks, skills, bugs.

C = A @ B on the tensor cores with retiling, split-K and stagger-K
policies.  The invariant templates record what must hold after every
rewrite: operand pairing (contraction coordinates agree), reduction
completeness (stagger-K stays a bijection of the K range), accumulator
stability across the reduction axis, and disjoint/covering output writes.

The tile program models what the CUDA kernel
(``repro_torch/kernels/gemm/csrc/gemm.cu``) does: one step per output
tile (i, j[, s]) with the K walk inside it.  The structural model and
the cost model read how the kernel runs a config (:func:`is_wgmma`,
:func:`cta_tile`): bf16 configs whose rows meet TMA's 16-byte rule, whose
K block is a multiple of 64 and whose tile holds whole 128 x 128 (or
128 x 256) CTA tiles run on ``wgmma`` fed by TMA, 64-deep stages in a
192 KB ring; every other config runs on the ``mma.sync`` / FMA design,
each bm x bn config tile on CTAs of the largest compiled CTA tile that
divides it, the K walk staged in 32-deep chunks, and operand rows that
are not 16-byte aligned on the masked scalar load path
(:func:`vector_path`).  Either way the config tile's blocks keep their
meaning (the K order, the split), so the program is built at the
config's blocks.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from .. import dsl
from ..costs import (CostEstimate, HBM_BW, MMA_SYNC_DERATE,
                     SCALAR_PATH_DERATE, STAGGER_DERATE, grain_util,
                     peak_flops, sol_estimate, wave_eff)
from ..kernelspec import (CTA_THREADS, DTYPE_BYTES, K_CHUNK, REG_OVERHEAD,
                          STAGES, VECTOR_BYTES, StructuralIssue, cdiv,
                          check_cta_split, check_grain, check_masking,
                          check_registers, check_smem,
                          check_vector_alignment, ctas_per_sm, work_ctas)
from ..tags import Expr, make_tag
from .base import (BugSignature, KernelFamily, Skill, generic_skill,
                   register)


@dataclass(frozen=True)
class GemmProblem:
    m: int
    n: int
    k: int
    dtype: str = "bf16"


@dataclass(frozen=True)
class GemmConfig:
    """Tunable knobs (the harness' action space for this family)."""

    bm: int = 128
    bn: int = 128
    bk: int = 128
    split_k: int = 1          # >1: partition K across parallel grid steps
    stagger_k: bool = False   # rotate K start per (i,j) to spread HBM load
    precision: str = "f32"    # accumulator type

    def name(self) -> str:
        s = f"gemm[{self.bm}x{self.bn}x{self.bk}]"
        if self.split_k > 1:
            s += f"+splitk{self.split_k}"
        if self.stagger_k:
            s += "+stagger"
        return s


def build_gemm_program(cfg: GemmConfig, prob: GemmProblem,
                       *, inject_bug: Optional[str] = None
                       ) -> dsl.TileProgram:
    """C = A @ B with the family invariants.

    ``inject_bug`` deliberately mis-lowers one aspect; used by tests and the
    Table-3 benchmark to measure the analysis' bug-catching power.
    Supported: "swap_b_index", "stagger_mismatch", "acc_depends_k",
    "grid_short", "missing_init".
    """
    p = dsl.TileProgram(cfg.name())
    mi = cdiv(prob.m, cfg.bm)
    nj = cdiv(prob.n, cfg.bn)
    nk_total = cdiv(prob.k, cfg.bk)
    if cfg.split_k > 1 and nk_total % cfg.split_k != 0:
        raise ValueError("split_k must divide the K block count")
    nk = nk_total // cfg.split_k

    if inject_bug == "grid_short":
        mi = max(1, mi - 1)

    i = p.add_grid("i", mi, "parallel")
    j = p.add_grid("j", nj, "parallel")
    s = p.add_grid("s", cfg.split_k, "parallel") if cfg.split_k > 1 else None
    k = p.add_grid("k", nk, "arbitrary")

    p.tensor("A", (prob.m, prob.k), prob.dtype)
    p.tensor("B", (prob.k, prob.n), prob.dtype)
    out_rows = prob.m * (cfg.split_k if cfg.split_k > 1 else 1)
    p.tensor("C", (out_rows, prob.n), prob.dtype, kind="output")

    k_base = (Expr.of(s) * nk + k) if s is not None else Expr.of(k)
    if cfg.stagger_k:
        k_idx = (k_base + i + j) % nk_total
        if inject_bug == "stagger_mismatch":
            k_idx_b = (k_base + i) % nk_total   # phase mismatch on B's path
        else:
            k_idx_b = k_idx
    else:
        k_idx = k_idx_b = k_base

    a = p.load("A", (i * cfg.bm, k_idx * cfg.bk), (cfg.bm, cfg.bk))
    if inject_bug == "swap_b_index":
        b = p.load("B", (j * cfg.bk, k_idx_b * cfg.bn), (cfg.bk, cfg.bn))
    else:
        b = p.load("B", (k_idx_b * cfg.bk, j * cfg.bn), (cfg.bk, cfg.bn))

    # invariant 1 — operand pairing: contraction coordinates must agree
    p.assert_contraction(a, b, components=((1,), (0,)))
    # invariant 1b — reduction completeness: each K block consumed once
    # (stagger-K must remain a bijection of the reduction range)
    p.assert_injective(k_idx, ("k",) if s is None else ("k", "s"))

    acc = p.alloc((cfg.bm, cfg.bn), cfg.precision,
                  zero_init=(inject_bug != "missing_init"))
    if inject_bug == "acc_depends_k":
        retag = lambda li, lj: make_tag(k_idx * cfg.bk + li, j * cfg.bn + lj)
    else:
        retag = lambda li, lj: make_tag(i * cfg.bm + li, j * cfg.bn + lj)
    p.matmul(a, b, accumulate=True, acc=acc, retag=retag)

    # invariant 2 — accumulator consistency across the reduction axis
    p.assert_stable(acc, "k")
    # invariant 2b — a never-initialized accumulator is ⊤ from the start
    p.assert_conform(acc, acc, bind=((0, 0), (1, 1)))

    row0 = (s * prob.m + i * cfg.bm) if s is not None else i * cfg.bm
    p.store("C", acc, (row0, j * cfg.bn))
    # invariants 3/4 — no clobber across parallel steps; full coverage
    p.assert_disjoint_writes("C")
    p.assert_coverage("C")
    return p


# CTA tiles of the mma.sync / FMA design (template instances): rows,
# then columns, largest first.  Four warps per CTA; a 16-row CTA puts
# its warps side by side, a taller one in a 2 x 2 grid.
CTA_ROWS = (128, 64, 32, 16)
CTA_COLS = (128, 64, 32)
# the wgmma design: 128-row CTA tiles (two consumer warpgroups of 64
# rows and a producer warpgroup), 256 or 128 columns, 64-deep stages
WGMMA_ROWS = 128
WGMMA_COLS = (256, 128)
WGMMA_DEPTH = 64
WGMMA_STAGES = {256: 4, 128: 6}
WGMMA_THREADS = 384
CONSUMER_REGS, PRODUCER_REGS = 232, 40   # setmaxnreg


def vector_path(cfg: GemmConfig, prob: GemmProblem) -> bool:
    """True when every operand row and block start is 16-byte aligned, so
    the kernel stages tiles with 16-byte copies (TMA or ``cp.async``);
    otherwise it loads element by element, masked."""
    q = VECTOR_BYTES // DTYPE_BYTES.get(prob.dtype, 2)
    return all(x % q == 0 for x in (prob.k, prob.n, cfg.bk, cfg.bn))


def is_wgmma(cfg: GemmConfig, prob: GemmProblem) -> bool:
    """The kernel runs ``cfg`` on its wgmma design: bf16 operands, rows
    that meet TMA's 16-byte rule (:func:`vector_path`; the wrapper also
    needs 16-byte-aligned base pointers), K blocks of whole 64-deep
    stages, and a config tile of whole 128 x 128 CTA tiles."""
    return (prob.dtype == "bf16" and vector_path(cfg, prob)
            and cfg.bk % WGMMA_DEPTH == 0 and cfg.bm % WGMMA_ROWS == 0
            and cfg.bn % WGMMA_COLS[-1] == 0)


def mma_tile(cfg: GemmConfig):
    """The CTA tile (rows, cols) of the mma.sync / FMA design for
    ``cfg``: the largest compiled instance that divides the config tile,
    else the smallest (with the config tile's edge masked)."""
    tm = next((t for t in CTA_ROWS if cfg.bm % t == 0), CTA_ROWS[-1])
    tn = next((t for t in CTA_COLS if cfg.bn % t == 0), CTA_COLS[-1])
    return tm, tn


def cta_tile(cfg: GemmConfig, prob: GemmProblem):
    """The CTA tile (rows, cols) the kernel runs ``cfg`` on: on the wgmma
    design 128 x 256 where bn allows it, else 128 x 128; otherwise
    :func:`mma_tile`.  A config tile larger than the CTA tile is covered
    by several CTAs."""
    if is_wgmma(cfg, prob):
        return WGMMA_ROWS, next(t for t in WGMMA_COLS if cfg.bn % t == 0)
    return mma_tile(cfg)


def smem_bytes(tm: int, tn: int, dtype: str, wgmma: bool = False) -> int:
    """Shared memory one CTA stages (the kernel's layouts, ``gemm.cu``):
    on the wgmma design 1024 bytes of alignment slack, a ring of 64-deep
    stages of an A tile (128 x 64) and a B tile (64 x tn), 128-byte
    swizzled, and two mbarriers a stage; otherwise ``STAGES`` buffers of
    an A chunk (tm x 32) and a B chunk (32 x tn), each row padded by 16
    bytes."""
    sz = DTYPE_BYTES.get(dtype, 2)
    if wgmma:
        stage = (tm + tn) * WGMMA_DEPTH * sz
        return 1024 + WGMMA_STAGES[tn] * (stage + 16)
    pad = VECTOR_BYTES // sz
    return STAGES * (tm * (K_CHUNK + pad) + K_CHUNK * (tn + pad)) * sz


def _acc_regs(tm: int, tn: int, wgmma: bool) -> int:
    """f32 accumulator registers per thread: a consumer warpgroup holds
    64 x tn, the mma.sync design's 128 threads the whole tile."""
    return 64 * tn // 128 if wgmma else tm * tn // CTA_THREADS


def structural_gemm(cfg: GemmConfig, prob: GemmProblem):
    wg = is_wgmma(cfg, prob)
    tm, tn = cta_tile(cfg, prob)
    issues = []
    issues += check_smem("CTA", smem_bytes(tm, tn, prob.dtype, wg))
    acc = _acc_regs(tm, tn, wg)
    if wg and acc + REG_OVERHEAD > CONSUMER_REGS:
        issues.append(StructuralIssue(
            "registers", f"CTA: {acc} accumulator registers per consumer "
                         f"thread (+{REG_OVERHEAD}) exceed the "
                         f"{CONSUMER_REGS} setmaxnreg gives it"))
    elif not wg:
        issues += check_registers("CTA", acc)
    issues += check_grain("C", (cfg.bm, cfg.bn, cfg.bk), (tm, tn))
    issues += check_vector_alignment(
        "A/B rows", (("k", prob.k), ("n", prob.n), ("bk", cfg.bk),
                     ("bn", cfg.bn)), prob.dtype)
    issues += check_cta_split("C", (cfg.bm, cfg.bn), (tm, tn))
    issues += check_masking("A", (prob.m, prob.k), (cfg.bm, cfg.bk),
                            masked_dims=(0, 1))
    return issues


def gemm_cost(cfg: GemmConfig, prob: GemmProblem) -> CostEstimate:
    """H100 model of the CUDA kernel: block-revisit traffic of the config
    tiles (the CTAs of one config tile run one after another and share
    its operand panels in L2) over HBM bandwidth, against the useful
    tensor-core work at the grain of the instance that runs
    (:func:`is_wgmma`: the card's peak on wgmma, half of it on
    mma.sync), quantised in waves over the 132 SMs."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    m, n, k = prob.m, prob.n, prob.k
    mi, nj = cdiv(m, cfg.bm), cdiv(n, cfg.bn)
    flops = 2.0 * m * n * k
    # block revisit traffic
    a_bytes = nj * m * k * sz
    b_bytes = mi * k * n * sz
    c_bytes = m * n * sz
    if cfg.split_k > 1:
        c_bytes = (2 * cfg.split_k + 1) * m * n * 4   # partials f32 w+r
    bw = HBM_BW if (cfg.stagger_k or nj * mi < 8) else HBM_BW * \
        STAGGER_DERATE
    wg = is_wgmma(cfg, prob)
    tm, tn = cta_tile(cfg, prob)
    n_ctas = work_ctas(m, cfg.bm, tm) * work_ctas(n, cfg.bn, tn) \
        * max(cfg.split_k, 1)
    if wg:
        per_sm = ctas_per_sm(WGMMA_THREADS, CONSUMER_REGS,
                             smem_bytes(tm, tn, prob.dtype, True))
        util = grain_util((cfg.bm, cfg.bn, cfg.bk), (tm, tn), WGMMA_DEPTH)
    else:
        per_sm = ctas_per_sm(CTA_THREADS, _acc_regs(tm, tn, False)
                             + REG_OVERHEAD,
                             smem_bytes(tm, tn, prob.dtype))
        util = grain_util((cfg.bm, cfg.bn, cfg.bk), (tm, tn), K_CHUNK)
        if prob.dtype != "f32":
            util *= MMA_SYNC_DERATE
    util *= wave_eff(n_ctas, per_sm)
    if not vector_path(cfg, prob):
        util *= SCALAR_PATH_DERATE
    return CostEstimate(
        compute_s=flops / (peak_flops(prob.dtype) * util),
        memory_s=(a_bytes + b_bytes + c_bytes) / bw,
        flops=flops, hbm_bytes=a_bytes + b_bytes + c_bytes)


def gemm_sol(prob: GemmProblem) -> CostEstimate:
    """Speed of light: ideal 2mnk MACs at the dtype's peak rate vs each
    operand streamed from HBM exactly once (no block revisits, no
    partials)."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    m, n, k = prob.m, prob.n, prob.k
    return sol_estimate(2.0 * m * n * k,
                        (m * k + k * n + m * n) * sz, prob.dtype)


# -- skills -----------------------------------------------------------------

def _block_steps(cfg: GemmConfig, prob: GemmProblem):
    out = []
    for field, cur in (("bm", cfg.bm), ("bn", cfg.bn), ("bk", cfg.bk)):
        for nxt in (cur * 2, cur // 2):
            if 8 <= nxt <= 1024:
                out.append((f"{field}={nxt}",
                            replace(cfg, **{field: nxt})))
    return out


def _split_k(cfg: GemmConfig, prob: GemmProblem):
    if cfg.split_k > 1:
        return [("split_k=1", replace(cfg, split_k=1))]
    out = []
    nk = max(prob.k // cfg.bk, 1)
    for s in (2, 4, 8):
        if nk % s == 0:
            out.append((f"split_k={s}", replace(cfg, split_k=s,
                                                stagger_k=False)))
    return out


def _stagger(cfg: GemmConfig, prob: GemmProblem):
    if cfg.split_k > 1:
        return []
    return [(f"stagger_k={not cfg.stagger_k}",
             replace(cfg, stagger_k=not cfg.stagger_k))]


SKILLS = (
    generic_skill("retile", "gemm", _block_steps),
    Skill("split_k", "global", ("gemm",),
          "Partition the reduction across parallel grid steps with an "
          "f32 partial-sum epilogue; recovers occupancy for skinny C.",
          "disjoint partial writes; reduction completeness", _split_k),
    Skill("stagger_k", "global", ("gemm",),
          "Rotate each (i,j) block's K start so concurrent CTAs stream "
          "different HBM stripes (controller hotspot mitigation).",
          "reduction-completeness bijection (assert_injective)", _stagger),
    generic_skill("software_pipelining", "gemm"),
    generic_skill("vectorized_io", "gemm"),
    generic_skill("f32_vmem_accumulate", "gemm"),
    generic_skill("oob_guarded_loads", "gemm"),
)


# -- fault model ------------------------------------------------------------

INJECTABLE_BUGS = ("swap_b_index", "acc_depends_k", "grid_short",
                   "missing_init", "stagger_mismatch")


def compatible_bugs(cfg: GemmConfig, prob: GemmProblem):
    menu = list(INJECTABLE_BUGS)
    if not cfg.stagger_k:
        menu.remove("stagger_mismatch")
    return menu


# Ground truth: which assertions each injected bug trips (checked against
# the live feedback by tests/test_families.py).  swap_b_index and
# stagger_mismatch both surface as operand-pairing counterexamples; the two
# accumulator bugs share the ⊤-carry fingerprint — targeted repair then
# disambiguates within the matched candidate set.
BUG_SIGNATURES = (
    BugSignature("swap_b_index", ("solver",),
                 ("assert_conform(t_A_0,t_B_1)",)),
    BugSignature("stagger_mismatch", ("solver",),
                 ("assert_conform(t_A_0,t_B_1)",)),
    BugSignature("acc_depends_k", ("analysis",),
                 ("assert_stable(", "assert_conform(s_2,s_2)")),
    BugSignature("missing_init", ("analysis",),
                 ("assert_stable(", "assert_conform(s_2,s_2)")),
    BugSignature("grid_short", ("solver",), ("assert_coverage(C)",)),
)


# -- reference execution (the kernel against its plain version) ------------

def reference_check(cfg: GemmConfig, prob: GemmProblem,
                    device="cuda") -> bool:
    """Run the port's validated ``matmul`` with ``cfg`` on ``device`` (the
    CUDA kernel on the card, the plain version on the CPU) against the
    plain version, at a small problem of the config's own tiling, in the
    problem's dtype with a float32 output.  Precondition errors of the
    config (``ValueError``, ``InvariantViolation``) propagate to the
    validator, which counts them as a failed test; so do build and
    launch errors, which it does not catch."""
    import numpy as np
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels.gemm import matmul, matmul_ref
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}.get(prob.dtype)
    if dt is None:
        raise ValueError(f"gemm kernel takes bf16 or f32, not {prob.dtype}")
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    m = min(2 * cfg.bm, 512)
    n = min(2 * cfg.bn, 512)
    k = min(2 * cfg.bk * max(cfg.split_k, 1), 1024)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    a, b = a.to(dev, dt), b.to(dev, dt)
    o = matmul(a, b, cfg=cfg, out_dtype=torch.float32)
    w = matmul_ref(a, b, out_dtype=torch.float32)
    return bool(torch.allclose(o, w, rtol=1e-3, atol=1e-3))


def _lower():
    from repro_torch.kernels import gemm
    return gemm


def _example():
    return GemmConfig(), GemmProblem(8192, 8192, 8192, "bf16")


def _sweep():
    # pow2 bucket grid: the square production GEMM plus the skinny-M
    # (serving MLP) and short-K (LoRA/projection) regimes, each in its
    # own dispatch bucket
    return [GemmProblem(8192, 8192, 8192, "bf16"),
            GemmProblem(2048, 8192, 8192, "bf16"),
            GemmProblem(8192, 8192, 2048, "bf16")]


FAMILY = register(KernelFamily(
    name="gemm",
    config_cls=GemmConfig,
    problem_cls=GemmProblem,
    build_program=build_gemm_program,
    structural=structural_gemm,
    cost=gemm_cost,
    skills=SKILLS,
    injectable_bugs=INJECTABLE_BUGS,
    bug_signatures=BUG_SIGNATURES,
    compatible_bugs=compatible_bugs,
    reference_check=reference_check,
    kernel="gemm",
    lower=_lower,
    example=_example,
    sweep_problems=_sweep,
    sol_bound=gemm_sol,
    # the traced program's structure and Exprs depend on the tile/grid
    # knobs only: ``precision`` enters the scratch alloc dtype (ignored
    # by tag propagation) — so configs differing only in precision
    # re-bind the same traced program
    trace_fields=("bm", "bn", "bk", "split_k", "stagger_k"),
))


def verify_gemm(cfg: GemmConfig, prob: GemmProblem,
                *, inject_bug: Optional[str] = None):
    return FAMILY.verify(cfg, prob, inject_bug=inject_bug)
