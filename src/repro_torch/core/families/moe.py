"""Fused-MoE kernel family (dispatch → grouped GEMM ×2 + SwiGLU → combine).

The port of the JAX package's ``core/families/moe.py``.  The tile
program (:func:`build_moe_program`: steps ``(t, f)`` over sorted
token blocks and d_ff blocks, with uninterpreted routing tables), the
skills, the injectable bugs and their signatures are copied unchanged,
so the port's gate gives the JAX gate's verdicts, findings and
counterexamples.  Invariants: dispatch/combine identity (gather and
scatter compose to the identity on routed rows), expert-weight pairing
(both GEMMs use grp(t), never the raw block index), d_model/d_ff
contraction conformity, and down-proj accumulator stability across
f-blocks.

The structural, cost and speed-of-light hooks are a Hopper model of the
CUDA kernel that runs the family
(``repro_torch/kernels/moe/csrc/grouped_ffn.cu``), and that kernel
departs from the program's schedule in one place: the program (like the
TPU kernel) keeps a (block_t, d_model) float32 accumulator on chip
across the whole d_ff walk, 3.7 MB at the production problem, which no
SM holds.  So the CUDA kernel runs two launches:

* gate/up: ``act = round_x(silu(x·wg) * (x·wu))`` per expert, written
  to device memory as (E, C, d_ff) in x's dtype — exactly the program's
  rounding point, so nothing changes numerically;
* down: ``y = (act·wd)_f32 * gate`` per expert, each CTA owning a
  (rows, d_model columns) output tile and walking d_ff in order, its
  accumulator in registers.

Two instances run them, chosen by :func:`is_wgmma` from the config and
the problem alone.  On the wgmma instance (bf16, ``block_t`` a multiple
of 64, ``block_f`` of 128, d_model of 64) a CTA owns 128 rows of one
expert (64 where ``block_t`` is no multiple of 128) and 128 d_ff columns
of wg and of wu (gate/up) or 256 d_model columns (down), on a persistent
grid whose work list runs expert by expert, config tile by config tile.
Otherwise a config's ``block_t`` x ``block_f`` tile of the gate/up
launch runs on CTAs of the largest mma.sync / FMA tile that divides it
(:func:`cta_tiles`: rows 128/64/32/16, d_ff columns 64/32; 16 rows with
the rest masked when none divides, as for ``block_t`` 8), a larger tile
on several CTAs launched one after another; the down launch takes the
same rows.  The program's ``f`` axis is the down launch's d_ff walk, in
the same order, on both.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from .. import dsl
from ..costs import (CostEstimate, HBM_BW, L2_BW, MMA_SYNC_DERATE,
                     grain_util, peak_flops, sol_estimate, wave_eff)
from ..kernelspec import (CTA_THREADS, DTYPE_BYTES, K_CHUNK, REG_OVERHEAD,
                          STAGES, VECTOR_BYTES, StructuralIssue, cdiv,
                          check_cta_split, check_grain, check_masking,
                          check_registers, check_smem, ctas_per_sm)
from ..tags import Expr, app, make_tag
from .base import (BugSignature, KernelFamily, Skill, generic_skill,
                   reference_setup, register)


@dataclass(frozen=True)
class MoEProblem:
    tokens: int               # tokens reaching the layer (B·S)
    d_model: int
    d_ff: int                 # per-expert hidden width
    n_experts: int
    top_k: int
    dtype: str = "bf16"

    @property
    def routed_rows(self) -> int:
        return self.tokens * self.top_k


@dataclass(frozen=True)
class MoEConfig:
    block_t: int = 128        # token-block rows per grid step
    block_f: int = 512        # d_ff block (reduction axis of down-proj)
    fuse_gate: bool = True    # apply router gate inside the kernel

    def name(self) -> str:
        return f"moe[{self.block_t}x{self.block_f}]" + \
            ("+fusedgate" if self.fuse_gate else "")


def build_moe_program(cfg: MoEConfig, prob: MoEProblem,
                      *, inject_bug: Optional[str] = None
                      ) -> dsl.TileProgram:
    """Sort-based fused MoE (megablocks-style grouped GEMM).

    Uninterpreted tables (runtime routing data, paper §9.1):
      perm(r)  — routed slot (token·top_k + slot) of sorted row r
      grp(t)   — expert owning token-block t (group map from the sort)

    Invariants: dispatch/combine identity (gather and scatter compose to the
    identity on routed rows), expert-weight pairing (both GEMMs use grp(t),
    never the raw block index), d_model/d_ff contraction conformity, and
    down-proj accumulator stability across f-blocks.
    Injectable bugs: "w_by_block_index", "combine_other_table",
    "gate_unpermuted", "down_f_offset", "y_depends_f".
    """
    p = dsl.TileProgram(cfg.name())
    R = prob.routed_rows
    E, DM, DF = prob.n_experts, prob.d_model, prob.d_ff
    bt, bf = cfg.block_t, cfg.block_f
    nt = cdiv(R, bt)
    nf = cdiv(DF, bf)

    t = p.add_grid("t", nt, "parallel")
    f = p.add_grid("f", nf, "arbitrary")

    # X is the *unsorted* token activation buffer (routed slots):
    p.tensor("X", (R, DM), prob.dtype)
    p.tensor("Wg", (E * DM, DF), prob.dtype)   # gate proj, flattened experts
    p.tensor("Wu", (E * DM, DF), prob.dtype)   # up proj
    p.tensor("Wd", (E * DF, DM), prob.dtype)   # down proj
    p.tensor("G", (R, 1), "f32")               # router gate per routed slot
    p.tensor("Y", (R, DM), prob.dtype, kind="output")

    grp = lambda blk: app("grp", blk, E)
    perm = lambda r: app("perm", r, R)
    perm_bad = lambda r: app("perm2", r, R)

    # up/gate weight tag fn: (within-expert row, expert, col)
    def w_up_tag(r, c):
        return make_tag(r % DM, r // DM, c)
    p.tensors["Wg"].tag_fn = w_up_tag
    p.tensors["Wu"].tag_fn = w_up_tag

    # dispatch: gather sorted rows through perm.  The retag declares the
    # sort precondition (tokens of block t belong to expert grp(t)) as the
    # tile's semantics: (routed slot, expert group, d_model coordinate).
    x = p.gather_rows(
        "X", lambda lr: perm(t * bt + lr), 0, bt, DM,
        retag=lambda lr, lc: make_tag(perm(t * bt + lr), grp(t), lc))

    # expert weights for this block's group
    g_of_t = Expr.of(t) if inject_bug == "w_by_block_index" else grp(t)
    wg = p.load("Wg", (g_of_t * DM, f * bf), (DM, bf))
    wu = p.load("Wu", (g_of_t * DM, f * bf), (DM, bf))

    # contraction + expert pairing over d_model:
    # X's (d_model coord, expert) must match W's (within-expert row, expert)
    p.assert_contraction(x, wg, components=((2, 1), (0, 1)))
    p.assert_contraction(x, wu, components=((2, 1), (0, 1)))

    h_tag = lambda lr, lc: make_tag(perm(t * bt + lr), grp(t), f * bf + lc)
    hg = p.matmul(x, wg, retag=h_tag)
    hu = p.matmul(x, wu, retag=h_tag)
    act = p.elementwise("swiglu", hg, hu)       # tags merge (equal) -> keep

    # expert pairing of the down projection
    f_row = (f * bf + bf // 2) if inject_bug == "down_f_offset" else f * bf
    wd = p.load("Wd", (grp(t) * DF + f_row, 0), (bf, DM))
    # bind act's f coordinate with Wd's within-expert row; compare the
    # (f coordinate, expert) pair — catches both offset and group bugs.
    def wd_tag(r, c):  # explicit tag fn: (within-expert row, expert, col)
        return make_tag(r % DF, r // DF, c)
    p.tensors["Wd"].tag_fn = wd_tag
    p.assert_conform(act, wd, bind=((1, 0),),
                     components=((2, 1), (0, 1)))

    if inject_bug == "y_depends_f":
        y_tag = lambda lr, lc: make_tag(perm(t * bt + lr), Expr.of(f), lc)
    else:
        y_tag = lambda lr, lc: make_tag(perm(t * bt + lr), lc)
    y = p.alloc((bt, DM), "f32")
    p.matmul(act, wd, accumulate=True, acc=y, retag=y_tag)
    p.assert_stable(y, "f")

    if cfg.fuse_gate:
        gperm = perm_bad if inject_bug == "gate_unpermuted" else perm
        gt = p.gather_rows("G", lambda lr: gperm(t * bt + lr), 0, bt, 1,
                           dtype="f32")
        # gate row must be the same routed slot as the activation row
        p.assert_conform(gt, y, bind=((0, 0),), components=((0,), (0,)))
        p.update(y, gt, fn="scale_by_gate", retag=y_tag)

    # combine: scatter back through the SAME permutation; component 0 of the
    # value's tag must equal the destination row (identity invariant)
    out_perm = perm_bad if inject_bug == "combine_other_table" else perm
    p.scatter_rows("Y", y, lambda lr: out_perm(t * bt + lr), 0,
                   conform_component=0)
    return p


# -- the CUDA kernel's decomposition -----------------------------------------

CTA_ROWS = (128, 64, 32, 16)  # expert rows per CTA (compiled instances)
UP_COLS = (64, 32)            # d_ff columns per CTA of the gate/up launch
DOWN_COLS = (128, 64)         # d_model columns per CTA of the down launch
# the wgmma instance: 128- or 64-row CTAs, 128 d_ff columns of wg and of
# wu (gate/up) or 256 d_model columns (down), 64-deep stages in a ring of
# four, two consumer warpgroups beside a producer warp
WGMMA_ROWS = (128, 64)
WGMMA_UP_COLS, WGMMA_DOWN_COLS = 128, 256
WGMMA_DEPTH, WGMMA_STAGES = 64, 4
WGMMA_THREADS, CONSUMER_REGS = 384, 232


def capacity_for(tokens: int, top_k: int, n_experts: int, block_t: int,
                 capacity_factor: float = 1.25) -> int:
    """Rows per expert (the JAX package's ``kernels/moe/ops.py`` rule):
    the routed rows' fair share times the capacity factor, rounded up to
    a whole number of ``block_t`` blocks."""
    cap = int(tokens * top_k * capacity_factor / n_experts)
    return max(block_t, cdiv(cap, block_t) * block_t)


def is_wgmma(cfg: MoEConfig, prob: MoEProblem) -> bool:
    """Whether ``cfg`` runs on the wgmma instance: bf16, ``block_t`` a
    multiple of 64, ``block_f`` of 128 and d_model of 64 (whole 64-column
    TMA panels, 16-byte rows).  The wrapper, the structural model and the
    cost model all route by this."""
    return (prob.dtype == "bf16" and cfg.block_t % 64 == 0
            and cfg.block_f % WGMMA_UP_COLS == 0 and prob.d_model % 64 == 0)


def cta_tiles(cfg: MoEConfig, d_model: int, wgmma: bool = False):
    """(rows, gate/up columns, down columns) of the CTAs that run
    ``cfg``.  On the wgmma instance: 128 rows (64 where ``block_t`` is no
    multiple of 128), 128 d_ff columns of wg and of wu, 256 d_model
    columns.  Otherwise the largest compiled row tile dividing
    ``block_t`` (else 16, rows past the block masked), the largest d_ff
    tile dividing ``block_f`` (else 32, masked), and 128 d_model columns
    (64 where d_model is no multiple of 128); that gate/up tile keeps two
    accumulators, so it stops at 64 columns: 128 x 64 is 128 float32
    registers a thread, as is the down launch's 128 x 128."""
    if wgmma:
        tm = next(t for t in WGMMA_ROWS if cfg.block_t % t == 0)
        return tm, WGMMA_UP_COLS, WGMMA_DOWN_COLS
    tm = next((t for t in CTA_ROWS if cfg.block_t % t == 0), CTA_ROWS[-1])
    tu = next((t for t in UP_COLS if cfg.block_f % t == 0), UP_COLS[-1])
    td = DOWN_COLS[0] if d_model % DOWN_COLS[0] == 0 else DOWN_COLS[1]
    return tm, tu, td


def smem_bytes(tm: int, tn: int, n_b: int, dtype: str,
               wgmma: bool = False) -> int:
    """Shared memory one CTA stages (the kernel's layouts).  wgmma: 1024
    bytes of alignment slack, a ring of 64-deep stages of an A tile
    (tm x 64) and four 64 x 64 B panels (wg | wu, or wd), 128-byte
    swizzled, and two mbarriers a stage.  Otherwise ``STAGES`` buffers of
    an A chunk (tm x 32) and ``n_b`` B chunks (32 x tn; two in the
    gate/up launch, wg and wu), each row padded by 16 bytes."""
    sz = DTYPE_BYTES.get(dtype, 2)
    if wgmma:
        stage = (tm + 4 * 64) * WGMMA_DEPTH * sz
        return 1024 + WGMMA_STAGES * (stage + 16)
    pad = VECTOR_BYTES // sz
    return STAGES * (tm * (K_CHUNK + pad) + n_b * K_CHUNK * (tn + pad)) * sz


def _consumer_regs(tm: int) -> int:
    """f32 accumulator registers of a wgmma consumer thread: 64 rows x 256
    columns (tm 128) or 64 x 128 (tm 64) over its warpgroup's 128
    threads."""
    return 64 * (256 if tm == 128 else 128) // 128


def structural_moe(cfg: MoEConfig, prob: MoEProblem):
    """Hopper model of ``grouped_ffn.cu``: rows off the 16-byte grain
    (d_model, d_ff or block_f not a multiple of 16 bytes: copied element
    by element, ``grain``), shared memory and accumulator
    registers of each launch's CTA (on the wgmma instance, a consumer's
    against the 232 that setmaxnreg gives it), the tensor-core grain of
    the config tile (masked rows and columns, zero-filled depth), a
    config tile on several CTAs, and the JAX family's masking check."""
    DM, DF, bt, bf = prob.d_model, prob.d_ff, cfg.block_t, cfg.block_f
    wg = is_wgmma(cfg, prob)
    tm, tu, td = cta_tiles(cfg, prob.d_model, wg)
    issues = []
    q = VECTOR_BYTES // DTYPE_BYTES.get(prob.dtype, 2)
    bad = [f"{n}={v}" for n, v in (("d_model", DM), ("d_ff", DF),
                                   ("block_f", bf)) if v % q]
    if bad:
        issues.append(StructuralIssue(
            "grain", f"rows of {', '.join(bad)} {prob.dtype} elements are "
                     f"not a multiple of {VECTOR_BYTES} bytes: staged "
                     f"element by element, the tail columns masked"))
    if wg:
        issues += check_smem("CTA", smem_bytes(tm, 0, 0, prob.dtype, True))
        acc = _consumer_regs(tm)
        if acc + REG_OVERHEAD > CONSUMER_REGS:
            issues.append(StructuralIssue(
                "registers", f"CTA: {acc} accumulator registers per "
                             f"consumer thread (+{REG_OVERHEAD}) exceed "
                             f"the {CONSUMER_REGS} setmaxnreg gives it"))
        issues += check_grain("Y", (bt, DM, DF), (tm, td))
    else:
        issues += check_smem("gate/up CTA",
                             smem_bytes(tm, tu, 2, prob.dtype))
        issues += check_smem("down CTA", smem_bytes(tm, td, 1, prob.dtype))
        issues += check_registers("gate/up CTA", 2 * tm * tu // CTA_THREADS)
        issues += check_registers("down CTA", tm * td // CTA_THREADS)
        issues += check_grain("act", (bt, bf, DM), (tm, tu))
        issues += check_grain("Y", (bt, DM, DF), (tm, td))
    issues += check_cta_split("act", (bt, bf), (tm, tu))
    issues += check_masking("routed", (prob.routed_rows,),
                            (cfg.block_t,), masked_dims=(0,))
    return issues


def moe_cost(cfg: MoEConfig, prob: MoEProblem) -> CostEstimate:
    """H100 model of ``grouped_ffn.cu``, with the terms of the GEMM
    model and the L2 term of the flash model.  The kernel computes every
    capacity row, E x ``capacity_for`` (1.25 x the routed rows, rounded
    up to ``block_t``), not the routed rows alone: the two launches'
    products at the grain of their CTA tiles and quantised in waves over
    the 132 SMs, on the instance that runs (:func:`is_wgmma`: wgmma at
    the card's peak, mma.sync at ``MMA_SYNC_DERATE`` of it, f32 FMAs at
    the f32 peak); x, the three weight sets, act (written and read back),
    y and the gates cross HBM once, and every CTA streams its A rows and
    B panels through L2."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    E, DM, DF = prob.n_experts, prob.d_model, prob.d_ff
    bt, bf = cfg.block_t, cfg.block_f
    C = capacity_for(prob.tokens, prob.top_k, E, bt)
    M = E * C
    wg = is_wgmma(cfg, prob)
    tm, tu, td = cta_tiles(cfg, prob.d_model, wg)
    row_ctas = E * cdiv(C, bt) * cdiv(bt, tm)
    ctas_up = row_ctas * cdiv(DF, bf) * cdiv(bf, tu)
    ctas_dn = row_ctas * cdiv(DM, td)
    if wg:
        per_up = per_dn = ctas_per_sm(WGMMA_THREADS, CONSUMER_REGS,
                                      smem_bytes(tm, 0, 0, prob.dtype, True))
        depth, derate = WGMMA_DEPTH, 1.0
        # a consumer's 64 rows against the CTA's columns: a 64-row CTA
        # halves the columns each warpgroup takes, not the B panels staged
    else:
        per_up = ctas_per_sm(CTA_THREADS, 2 * tm * tu // CTA_THREADS
                             + REG_OVERHEAD,
                             smem_bytes(tm, tu, 2, prob.dtype))
        per_dn = ctas_per_sm(CTA_THREADS, tm * td // CTA_THREADS
                             + REG_OVERHEAD,
                             smem_bytes(tm, td, 1, prob.dtype))
        depth = K_CHUNK
        derate = MMA_SYNC_DERATE if prob.dtype != "f32" else 1.0
    util_up = grain_util((bt, bf, DM), (tm, tu), depth) \
        * wave_eff(ctas_up, per_up) * derate
    util_dn = grain_util((bt, DM, DF), (tm, td), depth) \
        * wave_eff(ctas_dn, per_dn) * derate
    flops_up, flops_dn = 4.0 * M * DM * DF, 2.0 * M * DF * DM
    peak = peak_flops(prob.dtype)
    hbm = (2 * M * DM + 3 * E * DM * DF + 2 * M * DF) * sz \
        + (4 * M if cfg.fuse_gate else 0)
    l2 = (ctas_up * (tm * DM + 2 * DM * tu)
          + ctas_dn * (tm * DF + DF * td)) * sz
    return CostEstimate(
        compute_s=flops_up / (peak * util_up) + flops_dn / (peak * util_dn),
        memory_s=hbm / HBM_BW + l2 / L2_BW,
        flops=flops_up + flops_dn, hbm_bytes=hbm)


def moe_sol(prob: MoEProblem) -> CostEstimate:
    """Speed of light: the grouped-GEMM operation count over the routed
    rows (gate+up+down) at the dtype's peak vs the routed activations in
    and out once and every expert's three weight matrices streamed
    exactly once.  The kernel's capacity rows (1.25 x as many at the
    default capacity factor) are work the card does, and the cost model
    counts them; this bound does not."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    R, DM, DF, E = prob.routed_rows, prob.d_model, prob.d_ff, prob.n_experts
    flops = 6.0 * R * DM * DF
    traffic = 2 * R * DM * sz + 3 * E * DM * DF * sz
    return sol_estimate(flops, traffic, prob.dtype)


# -- skills -----------------------------------------------------------------

def _block_steps(cfg: MoEConfig, prob: MoEProblem):
    out = []
    for field, cur in (("block_t", cfg.block_t), ("block_f", cfg.block_f)):
        for nxt in (cur * 2, cur // 2):
            if 8 <= nxt <= 4096 and (field != "block_f"
                                     or prob.d_ff % nxt == 0):
                out.append((f"{field}={nxt}", replace(cfg, **{field: nxt})))
    return out


def _fuse_gate(cfg: MoEConfig, prob):
    return [(f"fuse_gate={not cfg.fuse_gate}",
             replace(cfg, fuse_gate=not cfg.fuse_gate))]


SKILLS = (
    generic_skill("retile", "moe", _block_steps),
    generic_skill("software_pipelining", "moe"),
    Skill("fused_gate_epilogue", "local", ("moe",),
          "Apply the router gate inside the kernel epilogue instead of a "
          "separate combine pass.",
          "gate-row/activation-row conformity via the shared perm table",
          _fuse_gate),
    generic_skill("vectorized_io", "moe"),
    generic_skill("f32_vmem_accumulate", "moe"),
    generic_skill("oob_guarded_loads", "moe"),
)


# -- fault model ------------------------------------------------------------

INJECTABLE_BUGS = ("w_by_block_index", "combine_other_table",
                   "gate_unpermuted", "down_f_offset", "y_depends_f")


def compatible_bugs(cfg: MoEConfig, prob: MoEProblem):
    menu = list(INJECTABLE_BUGS)
    if not cfg.fuse_gate:
        menu.remove("gate_unpermuted")
    return menu


# Ground truth (tests/test_families.py checks it against live feedback).
# y_depends_f collapses the carried Y scratch to ⊤, so its analysis-stage
# fingerprint spans the stability assertion plus the downstream gate/
# scatter conformity sites the ⊤ poisons.
BUG_SIGNATURES = (
    BugSignature("w_by_block_index", ("solver",),
                 ("assert_conform(g_X_0,t_Wg_1)",
                  "assert_conform(g_X_0,t_Wu_2)")),
    BugSignature("combine_other_table", ("solver",), ("scatter Y",)),
    BugSignature("gate_unpermuted", ("solver",),
                 ("assert_conform(g_G_8,s_7)",)),
    BugSignature("down_f_offset", ("solver",),
                 ("assert_conform(e_5,t_Wd_6)",)),
    BugSignature("y_depends_f", ("analysis",),
                 ("assert_stable(s_7)", "assert_conform(g_G_8,s_7)",
                  "scatter Y")),
)


# -- reference execution (the kernel against its plain version) ------------

def reference_check(cfg: MoEConfig, prob: MoEProblem,
                    device="cuda") -> bool:
    """Run the port's ``grouped_ffn`` with ``cfg`` on ``device`` (the CUDA
    kernel on the card, the plain version on the CPU) against the plain
    version ``grouped_ffn_ref``, at the JAX check's small shapes (2
    experts, ``C = max(block_t, 8)`` rows each, d_model 64,
    ``d_ff = max(block_f, 64)``) in the problem's dtype, so that on the
    card a bf16 problem runs the tensor-core path; with the router gate
    in the epilogue when ``fuse_gate`` is set, and the last row of each
    expert empty (it must come out zero).  Within ``moe_error``'s
    tolerance.  Precondition errors of the config (``ValueError``,
    ``InvariantViolation``) propagate to the validator, which counts
    them as a failed test; so do build and launch errors, which it does
    not catch."""
    from repro_torch.kernels.moe import grouped_ffn, grouped_ffn_ref, \
        moe_error
    make, _, _ = reference_setup("moe", prob.dtype, device)
    E, C = 2, max(cfg.block_t, 8)
    DM, DF = 64, max(cfg.block_f, 64)
    x = make((E, C, DM))
    x[:, -1] = 0
    wg, wu = make((E, DM, DF)) * .05, make((E, DM, DF)) * .05
    wd = make((E, DF, DM)) * .05
    gates = make((E, C, 1)).float().abs() if cfg.fuse_gate else None
    o = grouped_ffn(x, wg, wu, wd, gates, cfg=cfg)
    w = grouped_ffn_ref(x, wg, wu, wd, gates)
    return moe_error(o, w)[1] and not bool(o[:, -1].any())


def _lower():
    from repro_torch.kernels import moe
    return moe


def _example():
    return (MoEConfig(block_t=8),
            MoEProblem(16384, 7168, 2048, 32, 8, "bf16"))


def _sweep():
    # pow2 bucket grid: the production token load plus a light-traffic
    # and a peak-traffic point, same expert topology
    return [MoEProblem(16384, 7168, 2048, 32, 8, "bf16"),
            MoEProblem(4096, 7168, 2048, 32, 8, "bf16"),
            MoEProblem(32768, 7168, 2048, 32, 8, "bf16")]


FAMILY = register(KernelFamily(
    name="moe",
    config_cls=MoEConfig,
    problem_cls=MoEProblem,
    build_program=build_moe_program,
    structural=structural_moe,
    cost=moe_cost,
    skills=SKILLS,
    injectable_bugs=INJECTABLE_BUGS,
    bug_signatures=BUG_SIGNATURES,
    compatible_bugs=compatible_bugs,
    reference_check=reference_check,
    kernel="grouped_ffn",
    lower=_lower,
    example=_example,
    sweep_problems=_sweep,
    sol_bound=moe_sol,
))


def verify_moe(cfg: MoEConfig, prob: MoEProblem,
               *, inject_bug: Optional[str] = None):
    return FAMILY.verify(cfg, prob, inject_bug=inject_bug)
